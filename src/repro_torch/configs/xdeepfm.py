"""xdeepfm [arXiv:1803.05170], as repro.configs.xdeepfm defines it.

39 sparse features (Criteo: 26 categorical + 13 bucketized dense),
embed_dim 10, CIN layers 200-200-200, DNN 400-400, a linear arm over
the same hashed features; 2^20 hashed rows per feature (stacked tables
39 x 2^20 x 10 and the (39, 2^20) linear table, 0.45e9 f32
parameters), bags of 1, adagrad. Nothing is cut: at the train_batch
shape (65536) the CIN's per-layer interaction tensor (B, 200, 39, 10)
f32 is 20.4 GB by its shape, and the driver's `--microbatches` (gradient
accumulation, the reference's own `make_train_step` argument) keeps the
activations of one microbatch on the card while the optimizer still
takes one step over the whole batch: 2 microbatches peak at 47.6 GB on
an NVIDIA H100 80GB HBM3 at 700.00 W, and 1 does not fit (PERF.md).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, RecsysConfig

ROWS = 1 << 20

MODEL = RecsysConfig(
    name="xdeepfm", interaction="cin",
    n_sparse=39, embed_dim=10, mlp_dims=(400, 400), n_dense=13,
    vocab_sizes=(ROWS,) * 39, multi_hot=1, cin_dims=(200, 200, 200),
    reduced=(),
)

ARCH = ArchSpec(
    arch_id="xdeepfm", family="recsys", model=MODEL, shapes=RECSYS_SHAPES,
    source="arXiv:1803.05170", optimizer="adagrad",
)
