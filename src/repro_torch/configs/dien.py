"""dien [arXiv:1809.03672], as repro.configs.dien defines it.

embed_dim 18, behaviour sequences of 100 items, a GRU interest
extractor of width 108, AUGRU interest evolution, MLP 200-80, 8 dense
features; the item vocab hashed to 2^20 rows (one (2^20, 18) table),
adam. Nothing is cut: at the train_batch shape (65536) the driver
needs no microbatching (its peak 53.4 GB on an NVIDIA H100 80GB HBM3 at
700.00 W, PERF.md).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, RecsysConfig

ROWS = 1 << 20

MODEL = RecsysConfig(
    name="dien", interaction="augru",
    embed_dim=18, seq_len=100, gru_dim=108, mlp_dims=(200, 80), n_dense=8,
    vocab_sizes=(ROWS,), multi_hot=1,
    reduced=(),
)

ARCH = ArchSpec(
    arch_id="dien", family="recsys", model=MODEL, shapes=RECSYS_SHAPES,
    source="arXiv:1809.03672", optimizer="adam",
)
