"""Fig. 8 drilldowns on the PyTorch port (the port of
benchmarks/fig8_scaling.py): performance scaling vs (A) pipeline
complexity, (B) CPU count, (C) batch size. All normalized to the
AUTOTUNE-like baseline on the same pipeline, constant model latency 0
(paper §5.2).

Host only. Panel (A) needs the 3- and 4-stage agents: the first run
pretrains them into benchmarks/torch_common.py's cache. Writes
torch_fig8_scaling.json under build/bench/.

    PYTHONPATH=src python -m benchmarks.torch_fig8_scaling
"""
from __future__ import annotations

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import ControllerBackend, Session
from repro_torch.core import baselines as B
from repro_torch.data.pipeline import PipelineSpec, StageSpec, criteo_pipeline
from repro_torch.data.simulator import MachineSpec, PipelineSim


def _pipeline_of_complexity(n: int, with_udf: bool,
                            batch_mb: float = 256.0) -> PipelineSpec:
    """3..5-stage pipelines; the UDF appears at n>=5 (paper: complexity is
    adjusted by adding stages, with a spike when UDFs are introduced)."""
    stages = [StageSpec("disk_load", "source", cost=0.30, serial_frac=0.12,
                        est_bias=0.7, mem_per_worker_mb=96)]
    if n >= 4:
        stages.append(StageSpec("shuffle", "shuffle", cost=0.08,
                                serial_frac=0.30, mem_per_worker_mb=48))
    if with_udf and n >= 5:
        stages.append(StageSpec("feature_udf", "udf", cost=0.42,
                                serial_frac=0.15, est_bias=0.15,
                                mem_per_worker_mb=64))
    stages.append(StageSpec("batch", "batch", cost=0.12, serial_frac=0.25,
                            mem_per_worker_mb=32))
    stages.append(StageSpec("prefetch", "prefetch", cost=0.08,
                            serial_frac=0.05, mem_per_worker_mb=16,
                            mem_per_item_mb=batch_mb))
    stages = stages[:n] if len(stages) > n else stages
    return PipelineSpec(f"cx{n}", tuple(stages), batch_mb=batch_mb,
                        target_rate=31.0)


def _autotune_mean(spec, machine, seeds=15):
    t = []
    for s in range(seeds):
        sim = PipelineSim(spec, machine)
        t.append(sim.apply(B.autotune_like(spec, machine, s))["throughput"])
    return float(np.mean(t))


def _intune_steady(spec, machine, ticks=500):
    tuner = common.make_tuner(spec, machine, seed=0)
    r = Session(ControllerBackend(tuner)).run(ticks)
    return float(np.mean(r.throughput[-100:]))


def run(quiet: bool = False) -> dict:
    machine = MachineSpec(n_cpus=128, mem_mb=65536)
    out = {"complexity": [], "cpus": [], "batch": []}

    # (A) pipeline complexity: 3, 4 stages (no UDF) then 5 (UDF appears)
    for n, udf in [(3, False), (4, False), (5, True)]:
        spec = _pipeline_of_complexity(n, with_udf=udf)
        ratio = _intune_steady(spec, machine) / max(
            _autotune_mean(spec, machine), 1e-9)
        out["complexity"].append(
            {"stages": n, "udf": udf, "intune_vs_autotune": ratio})

    # (B) machine size: 8 -> 128 CPUs
    spec = criteo_pipeline()
    for n in (8, 16, 32, 64, 96, 128):
        m = MachineSpec(n_cpus=n, mem_mb=65536)
        ratio = _intune_steady(spec, m) / max(_autotune_mean(spec, m), 1e-9)
        out["cpus"].append({"n_cpus": n, "intune_vs_autotune": ratio})

    # (C) batch size: per-batch cost and memory scale with batch size;
    # report per-SAMPLE throughput (paper: sample throughput maintained)
    base_bs = 24096
    for mult in (0.25, 0.5, 1.0, 2.0, 4.0):
        bs = int(base_bs * mult)
        spec = criteo_pipeline(batch_mb=256.0 * mult)
        spec = spec.replace(stages=tuple(
            s.__class__(**{**s.__dict__, "cost": s.cost * mult})
            for s in spec.stages), target_rate=31.0 / mult)
        intune_sps = _intune_steady(spec, machine) * bs
        auto_sps = _autotune_mean(spec, machine) * bs
        out["batch"].append({"batch_size": bs,
                             "intune_samples_per_s": intune_sps,
                             "autotune_samples_per_s": auto_sps,
                             "ratio": intune_sps / max(auto_sps, 1e-9)})

    if not quiet:
        print("\n== Fig8(A) pipeline complexity (InTune/AUTOTUNE) "
              "[paper: grows with stages, spike at UDF] ==")
        for r in out["complexity"]:
            print(f"  {r['stages']} stages (udf={r['udf']}): "
                  f"{r['intune_vs_autotune']:.2f}x")
        print("== Fig8(B) CPU count [paper: grows then flattens ~1.2x] ==")
        for r in out["cpus"]:
            print(f"  {r['n_cpus']:4d} CPUs: {r['intune_vs_autotune']:.2f}x")
        print("== Fig8(C) batch size [paper: sample tput maintained] ==")
        for r in out["batch"]:
            print(f"  batch {r['batch_size']:6d}: InTune "
                  f"{r['intune_samples_per_s']:9.0f} samp/s "
                  f"({r['ratio']:.2f}x autotune)")
    common.save_json("torch_fig8_scaling.json", out)
    return out


if __name__ == "__main__":
    run()
