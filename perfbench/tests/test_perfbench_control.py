"""The control comes out not correct: the reference computed in the
precision below the configuration's (the config's `control_precision`:
int8 for bf16, TF32 for f32), put in the program's place, reads over a
limit of its cell on every seed. On the CPU at a tiny size, where the
program reads under the control on that number; the `gpu` test runs at
the cell's own size on the card, where the program reads under every
limit and every planted fault of `lib/faults.py` over one."""
import math

import pytest
import torch

from perfbench import control
from perfbench.lib import harness
from perfbench.tests import tiny

CELLS = ["dlrm-criteo.train-resident", "wide-deep.train-resident",
         "dlrm-criteo.train-uniform", "dlrm-criteo.serve-bulk"]


def _readings(c, seeds, device):
    rows = []
    fn = control.train_readings if c.mix["mode"] == "train" \
        else control.serve_readings
    fn(c, seeds, len(seeds), device, rows.append)
    return rows


def _fails(c, r) -> bool:
    return any(r[k] > v for k, v in c.limits.items() if k in r)


def _passes(c, r) -> bool:
    return all(r[k] <= v for k, v in c.limits.items() if k in r)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = tiny.cell(name, batch=16384)
    rows = _readings(c, [2**31 + 1, 2**31 + 2, 2**31 + 3], "cpu")
    prog = {r["seed"]: r for r in rows if r["kind"] == "program"}
    for r in rows:
        if r["kind"] == "control":
            assert _fails(c, r), r
            assert any(prog[r["seed"]][k] < r[k] <= math.inf
                       for k, v in c.limits.items() if r.get(k, 0) > v), r


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.Cell(name)
    rows = _readings(c, [3_500_000_001, 3_500_000_002, 3_500_000_003],
                     "cuda")
    for r in rows:
        if r["kind"] != "program":
            assert _fails(c, r), r
        if r["kind"] == "program":
            assert _passes(c, r), r
