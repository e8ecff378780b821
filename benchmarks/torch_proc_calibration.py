"""Sim-predicted vs proc-measured on the PyTorch port (the port of
benchmarks/proc_calibration.py): the measured closure of the loop.

Fig8-style drilldown for the process plane, two phases:

  (A) CALIBRATION (repro_torch.data.calibrate): sweep each stage of a
      designed pipeline on real OS processes, fit the Amdahl curve,
      and report designed vs fitted cost/serial_frac per stage — the
      serial-fraction recovery the sleep-based plane cannot do at all.
  (B) RANKING TRANSFER: rank candidate allocations three ways —
      PipelineSim on the DESIGNED spec, PipelineSim on the CALIBRATED
      spec, and measured on the real ProcessPipeline (interleaved
      windows, true CPU contention) — and report whether the analytic
      rankings transfer to measured physics (the paper's sim-to-real
      claim, scored on processes instead of sleep threads).

The two phases use different specs on purpose: calibration wants every
burn portion above the CPU-clock tick guard (slow, heavy stages), while
rank transfer on a small host needs candidates whose total CPU demand
stays near the machine's real capacity — a bottleneck-dominant chain
where the contrast is "waste a worker on the cheap stage" vs "fix the
bottleneck" (see DESIGN.md §9, "measurement design on small hosts").

Host only. Writes torch_proc_calibration.json under build/bench/.

    PYTHONPATH=src python -m benchmarks.torch_proc_calibration
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import make_backend
from repro_torch.data.calibrate import calibrate_stagegraph
from repro_torch.data.pipeline import StageGraph, StageSpec
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim


def proc_demo_pipeline() -> StageGraph:
    """Calibration subject: every burn portion >= the CPU-clock tick
    guard, one stage with a real serial fraction (the fit's target),
    UDF-dominant per Fig. 3."""
    stages = (
        StageSpec("src", "source", cost=0.05, serial_frac=0.0,
                  mem_per_worker_mb=16),
        StageSpec("feature_udf", "udf", cost=0.12, serial_frac=0.4,
                  mem_per_worker_mb=24, inputs=("src",)),
        StageSpec("batch", "batch", cost=0.04, serial_frac=0.0,
                  mem_per_worker_mb=16, inputs=("feature_udf",)),
    )
    return StageGraph("proc_demo", stages, batch_mb=1.0)


def ranking_pipeline() -> StageGraph:
    """Rank-transfer subject: bottleneck-dominant, serial-free, cheap
    enough that the winning candidate's CPU demand stays realizable."""
    stages = (
        StageSpec("src", "source", cost=0.005, serial_frac=0.0,
                  mem_per_worker_mb=8),
        StageSpec("feature_udf", "udf", cost=0.06, serial_frac=0.0,
                  mem_per_worker_mb=16, inputs=("src",)),
    )
    return StageGraph("proc_rank", stages, batch_mb=1.0)


CANDIDATES = (
    (1, 1),          # floor
    (2, 1),          # waste on the cheap source
    (1, 2),          # fix the UDF bottleneck
)


def measure_rankings(spec: StageGraph, reps: int = 3,
                     window_s: float = 0.4) -> list:
    """Measured throughput per candidate on a real ProcessPipeline,
    interleaved across repetitions so host-speed drift hits every
    candidate symmetrically."""
    be = make_backend("proc", spec, MachineSpec(n_cpus=8, mem_mb=8192.0),
                      window_s=window_s, ballast=False)
    sums = [0.0] * len(CANDIDATES)
    try:
        time.sleep(1.0)                       # worker spin calibration
        for _ in range(reps):
            for i, w in enumerate(CANDIDATES):
                alloc = Allocation(np.asarray(w, dtype=int),
                                   prefetch_mb=16.0)
                be.apply(alloc)               # settle: resize + warm
                time.sleep(0.5)
                sums[i] += float(np.mean(
                    [be.apply(alloc).throughput for _ in range(2)]))
    finally:
        be.shutdown()
    return [s / reps for s in sums]


def run(quiet: bool = False) -> dict:
    # ---- (A) live calibration: designed vs fitted per stage ----------
    cal_subject = proc_demo_pipeline()
    _, report = calibrate_stagegraph(cal_subject, workers=(1, 2, 3),
                                     window_s=1.5)
    calibration = {
        name: {"designed_cost": r["spec_cost"],
               "fitted_cost": r["cost"],
               "designed_serial_frac": r["spec_serial_frac"],
               "fitted_serial_frac": r["serial_frac"],
               "rates": r["rate"], "percpu": r["percpu"]}
        for name, r in report.items()}

    # ---- (B) rankings: designed sim, calibrated sim, measured proc ---
    rank_spec = ranking_pipeline()
    cal_rank_spec, _ = calibrate_stagegraph(rank_spec, workers=(1, 2),
                                            window_s=1.0)
    big = MachineSpec(n_cpus=64, mem_mb=65536.0)
    predicted = [PipelineSim(rank_spec, big).throughput(
        Allocation(np.asarray(w))) for w in CANDIDATES]
    predicted_cal = [PipelineSim(cal_rank_spec, big).throughput(
        Allocation(np.asarray(w))) for w in CANDIDATES]
    measured = measure_rankings(rank_spec)

    def transfers(pred, meas, tol=1.05):
        """Tie-aware rank transfer: every pair the sim predicts as
        STRICTLY separated (beyond `tol`) must measure in that order;
        predicted ties constrain nothing."""
        return all(meas[i] < meas[j]
                   for i in range(len(pred)) for j in range(len(pred))
                   if pred[i] * tol < pred[j])

    out = {
        "candidates": [list(w) for w in CANDIDATES],
        "predicted_designed": predicted,
        "predicted_calibrated": predicted_cal,
        "measured_proc": measured,
        "rank_match_designed": transfers(predicted, measured),
        "rank_match_calibrated": transfers(predicted_cal, measured),
        "calibration": calibration,
    }
    if not quiet:
        print("== proc calibration: designed vs fitted ==")
        for name, c in calibration.items():
            print(f"  {name:12s} cost {c['designed_cost']:.3f} -> "
                  f"{c['fitted_cost']:.3f}   serial_frac "
                  f"{c['designed_serial_frac']:.2f} -> "
                  f"{c['fitted_serial_frac']:.2f}")
        print("== allocation rankings (sim-predicted vs proc-measured) ==")
        for w, p, pc, m in zip(CANDIDATES, predicted, predicted_cal,
                               measured):
            print(f"  {str(list(w)):8s} sim {p:7.1f}  cal-sim {pc:7.1f}  "
                  f"proc {m:7.1f} b/s")
        print(f"  rankings transfer: designed={out['rank_match_designed']} "
              f"calibrated={out['rank_match_calibrated']}")
    common.save_json("torch_proc_calibration.json", out)
    return out


if __name__ == "__main__":
    run()
