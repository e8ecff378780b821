"""Cells cut to a size the CPU runs in seconds, for the tests."""
from perfbench.lib import harness

TINY = {
    "dlrm": dict(rows=4096, n_sparse=8, embed_dim=16, bottom_mlp=[32, 16],
                 top_mlp=[64, 32, 1]),
    "wide_deep": dict(rows=4096, n_sparse=6, embed_dim=8, mlp=[64, 32]),
}


def cell(name: str, batch: int = 256, **cfg) -> harness.Cell:
    c = harness.Cell(name)
    c.cfg.update(TINY[c.cfg["model"]], **cfg)
    c.mix.update(batch=batch, n_batches=4)
    if "pin_cpus" in c.mix:
        c.mix["pin_cpus"] = 2
    return c
