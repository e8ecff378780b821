"""bert4rec [arXiv:1904.06690], as repro.configs.bert4rec defines it.

embed_dim 64, 2 transformer blocks of 2 heads, sequences of 200 items,
bidirectional self-attention, the masked-item (cloze) objective; an
item vocab of 2^20 (at least the 1M candidates of retrieval_cand; the
table adds MASK and PAD and is padded to a multiple of 16, 1,048,592
rows), adam. A full softmax over 2^20 items at batch 65536 would be
5.5e16 bytes of logits, so training uses the sampled softmax: 20 masked
positions a sequence, 127 uniform negatives a position (index 0 the true
item).

`tp_lookup` is set, as in the reference: on a mesh (`--dist`) the item
table's rows shard over the model axis, the sequence lookup is
`tp_embedding_lookup` and the sampled logits are psummed over the model
axis (`tp_sampled_scores`). Nothing is cut: at the train_batch shape (65536) each block's
attention scores (B, 2, 200, 200) f32 are 21 GB by their shape and the
gathered candidates (B, 20, 128, 64) f32 43 GB, so the driver takes 8
microbatches (`--microbatches 8`, peak 36.7 GB on an NVIDIA H100 80GB
HBM3 at 700.00 W; 4 peak at 71.5 GB, PERF.md).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, RecsysConfig

MODEL = RecsysConfig(
    name="bert4rec", interaction="bidir-seq",
    embed_dim=64, n_blocks=2, n_heads=2, seq_len=200, n_items=1 << 20,
    vocab_sizes=(1 << 20,),
    n_mask=20, n_negatives=127,
    tp_lookup=True,
    reduced=(),
)

ARCH = ArchSpec(
    arch_id="bert4rec", family="recsys", model=MODEL, shapes=RECSYS_SHAPES,
    source="arXiv:1904.06690", optimizer="adam",
)
