"""ProcessPipeline on the PyTorch port (the port of
examples/process_pipeline.py): tune a REAL process-based pipeline, then
calibrate it.

Three escalating views of the process plane (DESIGN.md §9):

  1. `tune(..., backend="proc")` — the same one-liner as every other
     substrate, now driving one OS-process pool per stage: worker
     processes burn real CPU (true contention), memory is measured
     resident bytes from /proc, and the OOM judge fires on what the
     kernel reports, not on an accounting model.
  2. The measured-RSS OOM judge: shrink the machine's memory below the
     pipeline's real footprint and watch the kill + dead window +
     relaunch lifecycle fire on measured bytes.
  3. Live serial_frac calibration (`repro_torch.data.calibrate`): sweep a
     stage's worker pool, fit Amdahl's law to the measured service
     curve, and hand the calibrated StageGraph straight back to the
     analytic simulator — the measured closure of the sim <-> live loop.

    PYTHONPATH=src python examples/torch_process_pipeline.py
"""
import time

import numpy as np

from repro_torch.api import make_backend, tune
from repro_torch.data.calibrate import calibrate_stagegraph
from repro_torch.data.pipeline import StageGraph, StageSpec
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim


def demo_pipeline() -> StageGraph:
    stages = (
        StageSpec("src", "source", cost=0.005, serial_frac=0.0,
                  mem_per_worker_mb=24),
        StageSpec("feature_udf", "udf", cost=0.06, serial_frac=0.0,
                  mem_per_worker_mb=48, inputs=("src",)),
    )
    return StageGraph("proc_example", stages, batch_mb=1.0)


def part1_tune_on_processes():
    print("== 1. tune() on a real process-based pipeline ==")
    spec = demo_pipeline()
    machine = MachineSpec(n_cpus=4, mem_mb=4096.0)
    res = tune(spec, machine, optimizer="oracle", backend="proc",
               ticks=8, seed=0, backend_kw={"window_s": 0.3})
    live = res.extras["live"]
    print(f"  measured {float(np.mean(res.throughput[2:])):.1f} b/s "
          f"over {res.ticks} windows | OOMs {res.oom_count} | "
          f"processes joined: {live['all_joined']}")
    return {"throughput": res.throughput, "oom_count": res.oom_count,
            "live": live}


def part2_measured_oom():
    print("== 2. the OOM judge fires on MEASURED resident bytes ==")
    spec = demo_pipeline()
    # the two workers' touched ballast (24 + 48 MB of private pages)
    # exceeds a 48 MB machine: the verdict comes from the kernel
    be = make_backend("proc", spec, MachineSpec(n_cpus=4, mem_mb=48.0),
                      window_s=0.05, ballast=True)
    alloc = Allocation(np.ones(2, dtype=int), prefetch_mb=8.0)
    try:
        time.sleep(1.2)                       # calibrate + touch ballast
        tel = be.apply(alloc)
        print(f"  measured RSS {tel.mem_mb:.0f} MB > 48 MB cap -> "
              f"oom={tel.oom} (kill + dead window + relaunch)")
        out = {"mem_mb": tel.mem_mb, "oom": tel.oom}
        tel = be.apply(alloc)
        print(f"  next tick: restarting={tel.restarting} "
              f"(dead window, {be.restart_left} ticks left)")
        out.update(restarting=tel.restarting, restart_left=be.restart_left)
    finally:
        be.shutdown()
    return out


def part3_calibration():
    print("== 3. live serial_frac calibration (sim <-> live closure) ==")
    spec = StageGraph("cal_example", (
        StageSpec("udf", "udf", cost=0.1, serial_frac=0.35,
                  mem_per_worker_mb=16),), batch_mb=1.0)
    t0 = time.monotonic()
    cal, report = calibrate_stagegraph(spec, workers=(1, 2, 3),
                                       window_s=1.2)
    r = report["udf"]
    print(f"  designed cost {r['spec_cost']:.3f} / serial_frac "
          f"{r['spec_serial_frac']:.2f}")
    print(f"  fitted   cost {r['cost']:.3f} / serial_frac "
          f"{r['serial_frac']:.2f}  "
          f"({time.monotonic() - t0:.1f}s sweep)")
    sim = PipelineSim(cal, MachineSpec(n_cpus=8, mem_mb=4096.0))
    best, tput = sim.best_allocation(8)
    print(f"  oracle on the CALIBRATED spec: workers "
          f"{best.workers.tolist()} -> {tput:.1f} b/s predicted")
    return {"report": r, "best": best.workers.tolist(), "tput": tput}


if __name__ == "__main__":
    part1_tune_on_processes()
    part2_measured_oom()
    part3_calibration()
