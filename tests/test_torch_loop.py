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
from repro_torch.api import tune
from repro_torch.data.fleet import demo_cluster
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.simulator import MachineSpec
sim = tune(criteo_pipeline(), MachineSpec(64), optimizer="oracle",
           backend="sim", ticks=20)
fleet = tune(demo_cluster(60), optimizer="fleet_oracle", ticks=30)
print(json.dumps({
    "tune": [min(sim.throughput), min(fleet.throughput), fleet.oom_count],
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
            if node.module in ("benchmarks", "examples"):
                yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_never_imports_jax_or_the_jax_package():
    """Nor do the port's benchmarks and examples, which import no
    benchmark or example module of the JAX package's
    (benchmarks/common.py imports repro)."""
    benches = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(benches) >= 2 and len(examples) >= 5
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        benches + examples
    assert len(files) > 20
    # slice 12's, 13's and 14's modules among them
    assert {PORT / "models" / "segment.py", PORT / "data" / "graphs.py",
            PORT / "models" / "embedding.py", PORT / "api" / "registry.py",
            PORT / "core" / "fleet_coordinator.py",
            PORT / "core" / "optimizer.py", PORT / "data" / "fleet.py",
            PORT / "data" / "live_fleet.py", PORT / "data" / "calibrate.py",
            ROOT / "benchmarks" / "torch_fig7_fleet.py"} <= set(files)
    assert {ROOT / "benchmarks" / f"torch_{name}.py" for name in (
        "fig5_static", "fig7_rescale", "fig8_scaling", "fig_market",
        "fig_stream", "proc_calibration", "debug_feed_replay", "run",
        "kernels_bench", "analytic", "roofline")} <= set(files)
    # slice 15's LM family
    assert {PORT / "models" / f"{name}.py" for name in (
        "layers", "moe", "transformer")} | {
        PORT / "configs" / f"{name}.py" for name in (
            "smollm_135m", "gemma2_2b", "qwen2_moe_a2_7b", "qwen2_5_32b",
            "kimi_k2_1t_a32b")} <= set(files)
    assert {ROOT / "examples" / f"torch_{name}.py" for name in (
        "quickstart", "process_pipeline", "multisource_dlrm",
        "fleet_tuning", "live_fleet", "elastic_rescale")} <= set(files)
    # slice 16's distribution modules
    assert {PORT / "common" / "shardlib.py", PORT / "launch" / "mesh.py",
            PORT / "launch" / "programs.py",
            PORT / "train" / "collectives.py",
            PORT / "train" / "elastic.py"} <= set(files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")
           or (m.startswith("benchmarks.")
               and not m.startswith("benchmarks.torch_"))
           or (m.startswith("examples.")
               and not m.startswith("examples.torch_"))]
    assert not bad, bad


def test_cpu_closed_loop_runs_without_jax_or_repro():
    """~6 train steps at batch 64 on a tiny model: a real ProcessPipeline
    featurizes, FeedBackend + Session.step tune it; then 2 steps of the
    GNN driver at full_graph_sm and at molecule, a hashed ragged bag and
    sgd; `tune` on the single-machine and the fleet sim planes; and
    neither jax nor repro is ever imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SMOKE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["jax"] == [] and res["repro"] == []
    assert all(len(v) == 2 and all(0.0 < x < 10.0 for x in v)
               for v in res["gnn"].values()), res["gnn"]
    assert res["bag"] == [[1.0, 1.0]] * 3 and res["opt"] == "sgd"
    assert res["tune"][0] > 0.0 and res["tune"][1] > 0.0, res["tune"]
    assert res["tune"][2] == 0
    assert len(res["losses"]) == 6
    assert all(0.0 < x < 5.0 for x in res["losses"])
    assert len(res["idle"]) == 3
    assert all(0.0 <= x <= 1.0 for x in res["idle"])
    assert len(res["workers"]) == 5 and min(res["workers"]) >= 1
    assert res["teardown"]["all_joined"] is True
    assert res["teardown"]["dropped_batches"] == 0
