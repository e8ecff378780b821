"""Fig. 7 on the PyTorch port (the port of benchmarks/fig7_rescale.py):
throughput + utilization over time under machine rescaling.

Protocol (paper §5 Hardware Setup): CPU cap follows 32 -> 64 -> 128 -> 64
-> 32 at regular intervals. Baselines other than InTune adapt only by
manual checkpoint+relaunch (*-Adaptive, paying a relaunch window);
plain AUTOTUNE keeps its initial 32-CPU configuration throughout.
Headline paper numbers: 2.05x (custom) / 2.29x (criteo) mean throughput
vs plain AUTOTUNE; 10-20% over the human-intervention alternatives.

Host only. Writes torch_fig7_{pipeline}.json under build/bench/ (the
reference's summary and timelines).

    PYTHONPATH=src python -m benchmarks.torch_fig7_rescale
"""
from __future__ import annotations

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import (ControllerBackend, DeadWindow, RELAUNCH_TICKS,
                       Session, SimBackend, resize_events)
from repro_torch.core import baselines as B
from repro_torch.data.pipeline import criteo_pipeline, custom_pipeline
from repro_torch.data.simulator import MachineSpec, resize_schedule


def run(pipeline: str = "criteo", ticks: int = 1500,
        quiet: bool = False) -> dict:
    spec = criteo_pipeline() if pipeline == "criteo" else custom_pipeline()
    machine = MachineSpec(n_cpus=32, mem_mb=65536)
    resizes = resize_schedule(ticks)               # [(tick, cap), ...]
    out = {}

    def static(name, fn, readapt):
        alloc = fn(spec, MachineSpec(n_cpus=32, mem_mb=65536), 0) \
            if fn in (B.autotune_like, B.plumber_like) \
            else fn(spec, MachineSpec(n_cpus=32, mem_mb=65536))
        # *-Adaptive policies re-profile at every scheduled resize and pay
        # the checkpoint+relaunch window for it (explicit DeadWindows);
        # frozen policies just ride the ResizeEvents
        events = resize_events(resizes)
        if readapt is not None:
            events += [DeadWindow(t, RELAUNCH_TICKS) for t, _ in resizes]
        opt = common.ReadaptPolicy(alloc, readapt, seed=0,
                                   resize_ticks=[t for t, _ in resizes])
        out[name] = Session(SimBackend(spec, machine, seed=0), opt).run(
            ticks, events=events)

    static("unoptimized", B.unoptimized, None)
    static("autotune", B.autotune_like, None)          # never adapts
    static("autotune_adaptive", B.autotune_like,
           lambda s, m, seed: B.autotune_like(s, m, seed))
    static("plumber_adaptive", B.plumber_like,
           lambda s, m, seed: B.plumber_like(s, m, seed))
    static("heuristic_adaptive", B.heuristic_even,
           lambda s, m, seed: B.heuristic_even(s, m))
    tuner = common.make_tuner(spec, machine, seed=0, finetune_ticks=150)
    res = Session(ControllerBackend(tuner)).run(
        ticks, events=resize_events(resizes))
    out["intune"] = {k: res[k] for k in
                     ("throughput", "used_cpus", "oom_count")}

    summary = {}
    for name, r in out.items():
        tp = np.asarray(r["throughput"])
        # utilization: active-CPU fraction (paper Fig 7B) and model-fed
        # fraction (GPU util proxy, Fig 7C)
        caps = []
        cap = 32
        rmap = dict(resizes)
        for t in range(ticks):
            cap = rmap.get(t, cap)
            caps.append(cap)
        used = np.minimum(np.asarray(r["used_cpus"]), caps)
        summary[name] = {
            "mean_tput": float(tp.mean()),
            "mean_tput_pct_target": float(tp.mean() / spec.target_rate
                                          * 100),
            "cpu_util_pct": float((used / np.asarray(caps)).mean() * 100),
            "gpu_util_pct": float(np.minimum(
                tp / spec.target_rate, 1.0).mean() * 100),
            "oom_count": int(r["oom_count"]),
        }
    vs_auto = summary["intune"]["mean_tput"] / \
        max(summary["autotune"]["mean_tput"], 1e-9)
    vs_human = summary["intune"]["mean_tput"] / max(
        summary["heuristic_adaptive"]["mean_tput"],
        summary["plumber_adaptive"]["mean_tput"], 1e-9)
    summary["_speedups"] = {"vs_autotune": float(vs_auto),
                            "vs_best_human": float(vs_human)}
    if not quiet:
        print(f"\n== Fig7 rescale timeline ({pipeline}) "
              f"[paper: 2.05-2.29x vs AUTOTUNE, 1.1-1.2x vs human] ==")
        for name, s in summary.items():
            if name.startswith("_"):
                continue
            print(f"  {name:20s} mean {s['mean_tput_pct_target']:5.1f}% "
                  f"of target | cpu-util {s['cpu_util_pct']:5.1f}% | "
                  f"gpu-util {s['gpu_util_pct']:5.1f}% | "
                  f"OOMs {s['oom_count']}")
        print(f"  InTune vs AUTOTUNE: {vs_auto:.2f}x; "
              f"vs best human baseline: {vs_human:.2f}x")
    common.save_json(f"torch_fig7_{pipeline}.json",
                     {"summary": summary,
                      "timelines": {k: v["throughput"]
                                    for k, v in out.items()
                                    if "throughput" in v}})
    return summary


if __name__ == "__main__":
    run("criteo")
    run("custom")
