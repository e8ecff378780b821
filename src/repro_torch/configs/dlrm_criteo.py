"""dlrm-criteo-1m: the paper's Criteo DLRM at its published widths, on
one H100.

Widths are those of repro.configs.dlrm_criteo (InTune paper §5, Meta
DLRM arXiv:1906.00091): 26 sparse + 13 dense features, embed_dim 128,
bottom MLP 512-256-128, top MLP 1024-1024-512-256-1. The variant is the
paper-faithful fp32 + adagrad baseline of benchmarks/perf_hillclimb.py,
on one device (no sharding).
"""
from repro_torch.configs.base import DLRMConfig

ROWS = 1 << 20

MODEL = DLRMConfig(
    name="dlrm-criteo-1m",
    n_sparse=26, n_dense=13, embed_dim=128,
    vocab_sizes=(ROWS,) * 26,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    param_dtype="float32",
    reduced=(
        "rows per table 2^23 -> 2^20, for device memory: at 2^20 the "
        "tables are 26 x 2^20 x 128 = 3.49e9 f32 = 13.96 GB, and the "
        "dense table gradient and the adagrad accumulator are as large "
        "again, 41.9 GB in all; at 2^21 the three come to 83.8 GB and at "
        "2^23 the tables alone are 111.7 GB, over the 80 GB of one H100",
    ),
)
