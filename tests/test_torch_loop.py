"""The port's closed training loop on the CPU, and the port's isolation:
repro_torch imports neither jax nor the JAX package, statically (AST) or
at run time (a fresh interpreter running the loop)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

SMOKE = """
import json, math, sys
from types import SimpleNamespace
import repro_torch
from repro_torch.configs.base import DLRMConfig
from repro_torch.launch.train_dlrm_criteo import run_proc
cfg = DLRMConfig(name="tiny", n_sparse=4, n_dense=13, embed_dim=16,
                 vocab_sizes=(64,) * 4, bottom_mlp=(32, 16),
                 top_mlp=(32, 16, 1))
res = run_proc(SimpleNamespace(steps=6, batch=64, tune_every=2,
                               finetune_ticks=90, device="cpu", seed=0), cfg)
import torch
from repro_torch.configs.graphsage_reddit import ARCH
from repro_torch.launch import train
from repro_torch.models.embedding import hash_ids, ragged_embedding_bag
from repro_torch.train.optim import make_optimizer
gnn = {name: train.run("graphsage-reddit", steps=2, shape=ARCH.shape(name),
                       device="cpu")["losses"]
       for name in ("full_graph_sm", "molecule")}
ids = hash_ids(torch.arange(-3, 9), 5)
bag = ragged_embedding_bag(torch.ones(5, 2), ids, torch.arange(12) // 4, 3,
                           combiner="mean")
opt = make_optimizer("sgd", grad_clip=1.0)
print(json.dumps({
    "gnn": gnn, "bag": bag.tolist(), "opt": opt.name,
    "losses": res["losses"], "idle": res["device_idle_trace"],
    "workers": res["workers"], "teardown": res["teardown"],
    "jax": sorted(m for m in sys.modules if m.split(".")[0] == "jax"),
    "repro": sorted(m for m in sys.modules if m.split(".")[0] == "repro"),
}))
"""


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            if node.module == "benchmarks":
                yield from (f"benchmarks.{a.name}" for a in node.names)


def test_port_never_imports_jax_or_the_jax_package():
    """Nor do the port's benchmarks, which import no benchmark module of
    the JAX package's (benchmarks/common.py imports repro)."""
    benches = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    assert len(benches) >= 2
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + benches
    assert len(files) > 20
    # slice 12's modules among them
    assert {PORT / "models" / "segment.py", PORT / "data" / "graphs.py",
            PORT / "models" / "embedding.py"} <= set(files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")
           or (m.startswith("benchmarks.")
               and not m.startswith("benchmarks.torch_"))]
    assert not bad, bad


def test_cpu_closed_loop_runs_without_jax_or_repro():
    """~6 train steps at batch 64 on a tiny model: a real ProcessPipeline
    featurizes, FeedBackend + Session.step tune it; then 2 steps of the
    GNN driver at full_graph_sm and at molecule, a hashed ragged bag and
    sgd; and neither jax nor repro is ever imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SMOKE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["repro"] == []
    assert all(len(v) == 2 and all(0.0 < x < 10.0 for x in v)
               for v in res["gnn"].values()), res["gnn"]
    assert res["bag"] == [[1.0, 1.0]] * 3 and res["opt"] == "sgd"
    assert len(res["losses"]) == 6
    assert all(0.0 < x < 5.0 for x in res["losses"])
    assert len(res["idle"]) == 3
    assert all(0.0 <= x <= 1.0 for x in res["idle"])
    assert len(res["workers"]) == 5 and min(res["workers"]) >= 1
    assert res["teardown"]["all_joined"] is True
    assert res["teardown"]["dropped_batches"] == 0
