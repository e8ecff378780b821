"""wide-deep [arXiv:1606.07792], as repro.configs.wide_deep defines it.

40 sparse features, embed_dim 32, deep MLP 1024-512-256, 13 dense
features, concat interaction, a wide linear arm over the same hashed
features; 2^20 hashed rows per feature (stacked tables 40 x 2^20 x 32,
1.34e9 f32 parameters), multi_hot 4 (the paper's multivalent features),
row-wise adagrad. Nothing is cut: at the train_batch shape (65536) the
tables (5.37 GB), their dense gradient (5.37 GB), the row-wise
accumulator (0.17 GB), the wide table with its gradient (0.34 GB) and
the activations fit one 80 GB card, so the JAX config's row sharding is
not needed.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, RecsysConfig

ROWS = 1 << 20

MODEL = RecsysConfig(
    name="wide-deep", interaction="concat",
    n_sparse=40, embed_dim=32, mlp_dims=(1024, 512, 256), n_dense=13,
    vocab_sizes=(ROWS,) * 40, multi_hot=4,
    reduced=(),
)

ARCH = ArchSpec(
    arch_id="wide-deep", family="recsys", model=MODEL, shapes=RECSYS_SHAPES,
    source="arXiv:1606.07792", optimizer="rowwise_adagrad",
)
