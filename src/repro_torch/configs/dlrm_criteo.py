"""The paper's Criteo DLRM (InTune paper §5, Meta DLRM arXiv:1906.00091)
on one H100, in the two configurations the port runs.

Widths are those of repro.configs.dlrm_criteo: 26 sparse + 13 dense
features, embed_dim 128, bottom MLP 512-256-128, top MLP
1024-1024-512-256-1, bags of 1.

- `MODEL`, dlrm-criteo-1m: the closed loop's
  (repro_torch.launch.train_dlrm_criteo), the paper-faithful fp32 +
  adagrad baseline of benchmarks/perf_hillclimb.py, 2^20 rows a table.
- `ARCH`, dlrm-criteo: the reference's own configuration for the generic
  driver (`--arch dlrm-criteo`): bf16 tables and MLPs, row-wise adagrad,
  2^22 rows a table. On a mesh (`--dist`) its tables' rows shard over
  every axis and the lookup is the row-sharded `tp_multifeature_bag`
  (`tp_lookup`, `sharding_overrides`), as the JAX config sets.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, DLRMConfig

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

REFERENCE_ROWS = 1 << 22

ARCH = ArchSpec(
    arch_id="dlrm-criteo", family="dlrm",
    model=DLRMConfig(
        name="dlrm-criteo",
        n_sparse=26, n_dense=13, embed_dim=128,
        vocab_sizes=(REFERENCE_ROWS,) * 26,
        bottom_mlp=(512, 256, 128),
        top_mlp=(1024, 1024, 512, 256, 1),
        multi_hot=1,
        param_dtype="bfloat16",
        tp_lookup=True,
        sharding_overrides=(("table_rows", ("pod", "data", "model")),),
        reduced=(
            "rows per table 2^23 -> 2^22, for device memory: at 2^22 the "
            "bf16 tables are 26 x 2^22 x 128 x 2 B = 27.9 GB, their dense "
            "bf16 gradient as large again and the row-wise adagrad "
            "accumulator 0.44 GB, about 56 GB; at 2^23 the tables and "
            "their gradient are 111.7 GB, over the 80 GB of one H100",
        ),
    ),
    shapes=RECSYS_SHAPES,
    source="InTune paper §5 / arXiv:1906.00091",
    optimizer="rowwise_adagrad",
)
