"""Live serial_frac calibration: fit the Amdahl curve to measured rates.

The analytic plane (`PipelineSim`, the oracle, the RL agent's pretrain
environment) models every stage with two numbers — true cost and Amdahl
serial fraction — that, until this module, were DECLARED in the spec.
This is the gap tf.data-style autotuners fall into: when the analytic
model diverges from measured behavior, the planner optimizes the wrong
pipeline (InTune §3.2; Plumber). Calibration closes the loop with
measurement:

  1. For each stage, run its work function standalone in a
     `ProcessPipeline` (one single-stage graph per stage: isolation, so
     one stage's CPU demand cannot contend with another's measurement)
     and sweep the worker pool 1..k, reading the delivered-item count
     and the pool's CPU-clock delta (`/proc/<pid>/stat`) over each
     window.
  2. Fit on the CPU-NORMALIZED service curve `rate_hat(a) =
     a / (cpu_delta / items)`, not on wall rates. Wall rates on a
     shared or virtualized host swing with hypervisor steal and
     burstable-CPU throttling (2x second-to-second swings observed);
     per-item CPU is stable because the spin work functions burn
     against the SAME kernel cputime clock the measurement reads
     (`proc_executor._burn`), so designed cycle and measured cycle
     share one unit by construction. Worker idle (lock waits, queue
     waits) is excluded automatically — CPU clocks only advance while
     a worker runs. Raw wall rates are the fallback where the host
     exposes no per-process CPU clock.
  3. Fit `rate(a) = 1 / (cost * (s + (1 - s) / a))`. The fit is a
     linear regression in disguise: `1/rate` is linear in `1/a` with
     intercept `cost * s` and slope `cost * (1 - s)`, so the estimator
     is closed-form, and per-item constant overheads (queue IPC,
     cputime tick overshoot) land in the slope — biasing `s` slightly
     low but never inventing a serial fraction.
  4. Emit a calibrated `StageGraph` (same topology, measured cost +
     serial_frac) that the simulator and oracle consume — the first
     measured sim <-> live closure (benchmarks/proc_calibration.py
     scores how well sim rankings on the calibrated spec match
     proc-measured rankings).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.data.pipeline import StageGraph, StageSpec
from repro_torch.data.proc_executor import ProcessPipeline, SpinWork
from repro_torch.data.simulator import MachineSpec


def fit_amdahl(workers: Sequence[int], rates: Sequence[float]
               ) -> Tuple[float, float]:
    """Least-squares fit of `rate(a) = 1/(cost * (s + (1-s)/a))` over
    (worker count, measured rate) points; returns (cost, serial_frac).

    Closed form via the linearization y = 1/rate, x = 1/a:
    y = cost*s + cost*(1-s)*x, so slope+intercept = cost and
    intercept/(slope+intercept) = s. With a single point the curve is
    underdetermined: cost = 1/rate and serial_frac = 0 are returned.
    """
    pts = [(1.0 / a, 1.0 / r) for a, r in zip(workers, rates)
           if a > 0 and r > 0]
    if not pts:
        raise ValueError("fit_amdahl needs at least one (a>0, rate>0) point")
    if len(pts) == 1 or len({x for x, _ in pts}) == 1:
        return pts[0][1], 0.0   # underdetermined: treat 1/rate as cost
    n = len(pts)
    mx = sum(x for x, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    slope = sxy / sxx                       # cost * (1 - s)
    intercept = my - slope * mx             # cost * s
    cost = slope + intercept
    if cost <= 0:
        return max(my, 1e-9), 0.0
    serial = min(1.0, max(0.0, intercept / cost))
    return cost, serial


def _slope(xs: Sequence[float], ys: Sequence[float]) -> Optional[float]:
    """Least-squares slope of ys over xs (None when xs has no spread)."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx <= 0:
        return None
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx


def _drain(pipe: ProcessPipeline):
    """Empty the output queue without blocking (between sweep points)."""
    while True:
        try:
            pipe.get_batch(timeout=0.01)
        except Exception:
            return


def _standalone_graph(st: StageSpec, batch_mb: float) -> StageGraph:
    """One-stage graph isolating `st` as an infinite source (calibration
    measures the stage's own service curve, not the graph's)."""
    solo = dataclasses.replace(st, inputs=())
    return StageGraph(f"cal_{st.name}", (solo,), batch_mb=batch_mb)


def measure_stage_curve(st: StageSpec, workers: Sequence[int], *,
                        window_s: float = 1.2, warmup_s: float = 0.5,
                        ballast: bool = False, machine=None,
                        work: str = "spin") -> Dict[str, List]:
    """Measured service curve of one stage, standalone.

    Runs the stage's work fn as a single-stage ProcessPipeline and, for
    each pool size in `workers`, reads the delivered-counter delta over
    `window_s` plus the pool's CPU-clock delta. Returns
    {"workers", "rate", "occupancy", "percpu"}; `percpu` is the
    measured CPU-seconds consumed per delivered item (None when the
    host exposes no per-process CPU clock), and `rate` is the raw wall
    window rate. The fit should consume `corrected_rates(curve)`.

    `work` picks the unit under measurement: `"spin"` = SpinWork burns,
    `"real"` = the actual featurization transforms (data/featurize.py,
    run standalone with a cached self-generated input so upstream
    transform cost never leaks into this stage's curve). Both realize
    the same clock-disciplined Amdahl contract, so the CPU-normalized
    fit recovers cost/serial_frac from either.
    """
    if machine is None:
        machine = MachineSpec(n_cpus=max(workers), mem_mb=1 << 20)
    spec = _standalone_graph(st, batch_mb=1.0)
    if work == "real":
        from repro_torch.data.featurize import featurize_work_for
        fn = featurize_work_for(st, ballast=ballast, kind="source")
    else:
        fn = SpinWork(st.cost, st.serial_frac,
                      ballast_mb=st.mem_per_worker_mb if ballast else 0.0,
                      kind="source")
    pipe = ProcessPipeline(spec, fns={spec.stages[0].name: fn},
                           queue_depth=8, item_mb=1.0, machine=machine)
    # open the prefetch gate far beyond what a window can deliver: the
    # parent then SLEEPS through the measurement instead of busy-draining
    # — on a small host a polling parent would co-spin with the workers
    # and pollute every point with its own contention
    headroom = max(64.0, 4.0 * (window_s + warmup_s) * max(workers)
                   / max(st.cost, 1e-4))
    out: Dict[str, List] = {"workers": [], "rate": [], "occupancy": [],
                            "percpu": []}
    try:
        for a in workers:
            pool = pipe.pools[0]
            pipe.set_allocation([a], prefetch_mb=headroom)
            time.sleep(warmup_s)                  # settle the new pool
            # sample (delivered, cpu) pairs through the window; the
            # regression slope is the per-item CPU with partial-item
            # boundary noise averaged out (a single end-to-end delta
            # carries up to one in-flight item's CPU per endpoint)
            items_s: List[float] = []
            cpu_s: List[float] = []
            t_s: List[float] = []
            t_end = time.monotonic() + window_s
            while True:
                c = pipe.counters()
                items_s.append(float(c["delivered"]))
                cpu_s.append(pool.cpu_s())
                t_s.append(c["time"])
                now = time.monotonic()
                if now >= t_end:
                    break
                time.sleep(max(0.0, min(window_s / 12.0, t_end - now)))
            _drain(pipe)                          # empty between points
            items = items_s[-1] - items_s[0]
            dt = max(t_s[-1] - t_s[0], 1e-9)
            dcpu = cpu_s[-1] - cpu_s[0]
            percpu = _slope(items_s, cpu_s) if items > 0 and dcpu > 0 \
                else None
            out["workers"].append(int(a))
            out["rate"].append(items / dt)
            out["occupancy"].append(
                min(1.0, dcpu / (a * dt)) if dcpu > 0 else 0.0)
            out["percpu"].append(percpu if percpu and percpu > 0
                                 else None)
    finally:
        pipe.shutdown(drain=False, timeout=5.0)
    return out


def corrected_rates(curve: Dict[str, List]) -> List[float]:
    """The host-noise-free service curve `fit_amdahl` should consume:
    `rate_hat(a) = a / percpu(a)` — per-item CPU is measured in the
    same kernel cputime unit the spin work burns against, so the curve
    is invariant to wall-speed drift, steal, and core contention. Falls
    back to the raw wall rate where no CPU clock was available."""
    return [a / p if p else r
            for a, p, r in zip(curve["workers"], curve["percpu"],
                               curve["rate"])]


def default_sweep(k: Optional[int] = None) -> Tuple[int, ...]:
    """Worker counts to sweep: 1..k (default 3, capped at 4). The
    CPU-normalized fit stays valid past the host's core count — extra
    workers contend on wall time, not on per-item CPU — so the cap is
    about sweep runtime, not about `os.cpu_count()`."""
    k = max(2, min(k if k is not None else 3, 4))
    return tuple(range(1, k + 1))


def calibrate_stagegraph(spec: StageGraph, *,
                         workers: Optional[Sequence[int]] = None,
                         window_s: float = 1.2, warmup_s: float = 0.5,
                         ) -> Tuple[StageGraph, Dict[str, dict]]:
    """Measure every stage's service curve and emit a calibrated
    StageGraph (same topology and memory model; measured cost and
    serial_frac) plus a per-stage report:

        {"workers", "rate", "occupancy", "percpu", "corrected",
         "cost", "serial_frac",               # fitted
         "spec_cost", "spec_serial_frac"}     # declared, for comparison

    For a stable serial_frac fit the stage's serial and parallel burn
    portions should each be >= proc_executor._TICK_GUARD (20ms) — below
    that the burns ride the iteration calibration instead of the CPU
    clock and the fit inherits host-speed drift.

    The calibrated graph is what the simulator/oracle should consume —
    planning then happens against measured dynamics, not declared ones.
    """
    sweep = tuple(workers) if workers is not None else default_sweep()
    report: Dict[str, dict] = {}
    stages = []
    work = getattr(spec, "work", "spin")
    for st in spec.stages:
        curve = measure_stage_curve(st, sweep, window_s=window_s,
                                    warmup_s=warmup_s, work=work)
        corrected = corrected_rates(curve)
        cost, serial = fit_amdahl(curve["workers"], corrected)
        report[st.name] = dict(curve, corrected=corrected, cost=cost,
                               serial_frac=serial, spec_cost=st.cost,
                               spec_serial_frac=st.serial_frac)
        stages.append(dataclasses.replace(st, cost=cost,
                                          serial_frac=serial))
    return spec.replace(name=f"{spec.name}_calibrated",
                        stages=tuple(stages)), report
