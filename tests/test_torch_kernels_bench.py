"""The port's kernel benchmark and roofline on the CPU:
`torch_kernels_bench --device cpu` times the plain versions and the
oracles alone and writes its JSON; `torch_roofline` over a fixture steps
JSON gives benchmarks/analytic.py's closed-form counts to the bit at the
measured batch, divides them by the H100's ceilings, and carries no TPU
constant."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks import analytic  # noqa: E402
from benchmarks import torch_analytic, torch_common  # noqa: E402
from benchmarks import torch_kernels_bench, torch_roofline  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402

# a steps file as chip_smoke.py's driver phases write it (the numbers are
# a fixture, not a measurement)
FIXTURE = [
    {"arch": "gemma2-2b", "shape": "train_4k", "kind": "train", "batch": 4,
     "seq_len": 4096, "microbatches": 4, "steps": 4, "step_s": 4.0,
     "dtype": "bfloat16", "device": "fixture card", "reduced": []},
    {"arch": "smollm-135m", "shape": "train_4k", "kind": "train", "batch": 8,
     "seq_len": 4096, "microbatches": 1, "steps": 4, "step_s": 3.0,
     "dtype": "bfloat16", "device": "fixture card", "reduced": []},
    {"arch": "dlrm-criteo", "shape": "train_batch", "kind": "train",
     "batch": 65536, "seq_len": None, "microbatches": 1, "steps": 20,
     "step_s": 0.4, "dtype": "bfloat16", "device": "fixture card",
     "reduced": []},
    {"arch": "wide-deep", "shape": "train_batch", "kind": "train",
     "batch": 65536, "seq_len": None, "microbatches": 1, "steps": 5,
     "step_s": 0.1, "dtype": "float32", "device": "cpu", "reduced": []},
]


@pytest.fixture
def out_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_common, "OUT_DIR", str(tmp_path))
    return tmp_path


def test_kernel_bench_on_the_cpu_times_plain_versions_and_oracles(out_dir):
    torch.set_num_threads(1)
    rows = torch_kernels_bench.run("cpu", quiet=True)
    assert [r["kernel"] for r in rows] == [
        "embedding_bag", "embedding_bag_fused", "dot_interact",
        "sage_aggregate"]
    for r in rows:
        assert r["device"] == "cpu" and r["kernel_ms"] is None
        assert r["plain_ms"] > 0 and r["oracle_ms"] > 0
        assert r["bound_ms"] > 0 and r["checked_against"] == "oracle"
    assert json.loads((out_dir / "torch_kernels.json").read_text()) == rows
    # the bound: every row moves more bytes (over 3.35 TB/s) than it has
    # f32 operations (over 67 TFLOP/s); the aggregate's bytes are its
    # neigh, w and out in f32
    assert {r["bound_by"] for r in rows} == {"bytes"}
    assert rows[3]["bound_ms"] == pytest.approx(
        4 * (1024 * 15 * 602 + 602 * 128 + 1024 * 128) / 3.35e12 * 1e3)


def test_kernel_bench_refuses_cuda_without_a_card(out_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_kernels_bench.run("cuda")


@pytest.mark.parametrize("rec", FIXTURE[:3], ids=lambda r: r["arch"])
def test_roofline_counts_are_the_references_at_h100_ceilings(rec, out_dir):
    path = out_dir / "torch_steps.json"
    path.write_text(json.dumps(FIXTURE))
    rows = {(r["arch"], r["shape"]): r for r in torch_roofline.run(str(path))}
    assert ("wide-deep", "train_batch") not in rows      # a CPU record
    row = rows[(rec["arch"], rec["shape"])]
    jarch = j_get_arch(rec["arch"])
    jshape = dataclasses.replace(jarch.shape(rec["shape"]),
                                 batch=rec["batch"])
    fam = {"lm": lambda: analytic.lm_cell(jarch.model, jshape, 1),
           "dlrm": lambda: analytic.dlrm_cell(jarch.model, jshape, 1)}
    want = fam[jarch.family]()
    got = torch_analytic.model_cell(
        get_arch(rec["arch"]),
        torch_roofline.measured_shape(get_arch(rec["arch"]), rec), 1)
    assert got == want                                    # to the bit
    assert row["model_flops"] == want["model_flops"]
    assert row["compute_s"] == want["model_flops"] / 989e12
    assert row["memory_s"] == want["mem_bytes_per_dev"] / 3.35e12
    assert row["roofline_fraction"] == max(row["compute_s"],
                                           row["memory_s"]) / rec["step_s"]
    assert row["mfu"] == want["model_flops"] / (989e12 * rec["step_s"])
    picks = torch_roofline.pick_hillclimb_cells(list(rows.values()))
    assert picks["paper_representative"] == "dlrm-criteo/train_batch"
    assert set(picks) == {"paper_representative", "worst_fraction",
                          "most_memory_bound"}


def test_the_port_benchmarks_carry_no_tpu_constant():
    assert torch_analytic.PEAK_FLOPS == {"bfloat16": 989e12, "tf32": 495e12,
                                         "float32": 67e12}
    assert torch_analytic.HBM_BW == 3.35e12
    for mod in (torch_analytic, torch_roofline, torch_kernels_bench):
        text = open(mod.__file__).read()
        for tpu in ("197e12", "819e9", "50e9", "197 TFLOP", "819 GB",
                    "ICI_BW", "VMEM"):
            assert tpu not in text, (mod.__name__, tpu)
