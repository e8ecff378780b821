"""Fig Stream on the PyTorch port (the port of benchmarks/fig_stream.py):
flash-crowd re-adaptation on a streaming source.

The headline scenario for the streaming plane: a recommendation logging
stream with a diurnal cycle takes a 10x flash crowd mid-run. Three
policies face it, identical except for who places the workers:

  even         `heuristic_even` frozen — provisioned for the mean. When
               the spike lands its capacity sits below the arrival rate
               and it STARVES THE TRAINER for the entire spike window.
  static_best  the sim oracle's placement, frozen. On the sim arm it
               is the plan for the BASE rate: cheapest in the troughs —
               and when the spike lands, un-ingested arrivals accumulate
               as backlog whose buffer memory grows without bound: it
               OOMs, pays the restart dead window, relaunches into the
               same traffic, and crash-loops. On the proc arm it is the
               water-filled plan for the DECLARED machine: the 1-core
               host turns that overplacement into physical contention
               (per-worker cycle cost*(a*s+1-s)) and its measured
               capacity lands BELOW the spike demand.
  intune       `common.make_tuner` + streaming telemetry. It launches
               from the sim plan for the observed base rate (the
               conservative feed-boundary placement) and re-tunes live:
               the staleness trigger (level + progress guard — reopen
               only when stale AND not improving since serving began)
               catches an incumbent that cannot keep up, the
               downward-drift trigger catches the trough and sheds
               workers, and the freshness-aware reward (which charges
               staleness GROWTH, stationary across the spike) crowns an
               allocation that keeps up. On the proc arm proposals are
               held for 2 windows (`HeldTuner`) so a live resize's own
               disruption never pollutes the window that scores it.

Scored on TIME-TO-READAPT: the offset into the spike of the first run
of consecutive caught-up ticks after the arm first fell behind (sim: 5
ticks with throughput >= 95% of the arrival rate; proc: 3 windows where
the exact backlog counter did not grow — window throughput is whole-
batch quantized, backlog deltas are not). 0 if the arm never fell
behind; None if it never recovers. Acceptance, on BOTH planes: intune
re-adapts within HALF of the best frozen arm's sustained-starvation
window, with zero OOMs, while both frozen arms starve (DESIGN.md §11
records the sim-vs-proc gaps and the scoring rationale).

Host only: the analytic simulator, a ProcessPipeline's processes and
the DQN on the CPU. Writes BENCH_torch_stream.json under build/bench/.

    PYTHONPATH=src python -m benchmarks.torch_fig_stream [--quick]
        [--backend sim|proc|both] [--seed N] [--no-assert]
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import FrozenPolicy, Session, make_backend
from repro_torch.core.baselines import heuristic_even
from repro_torch.data.pipeline import (StageGraph, StageSpec,
                                       stream_dlrm_pipeline)
from repro_torch.data.simulator import MachineSpec, PipelineSim
from repro_torch.data.stream import flash_crowd_arrivals

# ----------------------------------------------------------- sim scenario --
# Tick = 1 simulated second. The spike lands inside the diurnal dip, so
# demand peaks near 19 batches/s — reachable from heuristic_even by one
# clamped +5 move on feature_udf within the 64-CPU machine, which is
# exactly the re-adaptation the frozen arms cannot make.
SIM_BASE = 2.0           # batches/s at the diurnal mean
SIM_SPIKE_AT = 300.0
SIM_SPIKE_LEN = 150.0
SIM_SPIKE_GAIN = 10.0
SIM_TICKS = 600


def sim_scenario():
    arr = flash_crowd_arrivals(
        SIM_BASE, spike_at_s=SIM_SPIKE_AT, spike_len_s=SIM_SPIKE_LEN,
        spike_gain=SIM_SPIKE_GAIN, diurnal_amp=0.1, diurnal_period_s=600.0,
        buffer_mb_per_batch=6.0, seed=0)
    spec = stream_dlrm_pipeline(arr, cost_scale=1.25)
    machine = MachineSpec(n_cpus=64, mem_mb=16384.0)
    return spec, machine


# ---------------------------------------------------------- proc scenario --
# Wall-clock arrivals on real OS processes. Elevated serial fractions
# make overplacement melt on the 1-core host: the sim oracle, told to
# water-fill the DECLARED 25-CPU machine, piles 21 workers on
# feature_udf and its measured capacity drops BELOW the spike demand —
# the sim-to-proc gap the differential arm exists to show.
PROC_BASE = 1.5          # batches/s at the diurnal mean
PROC_SPIKE_AT = 15.0     # wall seconds after pipeline launch
PROC_SPIKE_LEN = 60.0
PROC_SPIKE_GAIN = 4.0
PROC_WINDOW_S = 1.0      # whole-batch quantization: +-1 b/s at 1 s windows
PROC_TICKS = 95
PROC_GROW_BATCHES = 1.0  # "behind" = backlog grew > this over one window


def proc_stream_pipeline(arrival) -> StageGraph:
    stages = (
        StageSpec("ingest", "stream", cost=0.008, serial_frac=0.70,
                  mem_per_worker_mb=8, arrival=arrival),
        StageSpec("decode", "udf", cost=0.010, serial_frac=0.70,
                  mem_per_worker_mb=8, inputs=("ingest",)),
        StageSpec("feature_udf", "udf", cost=0.040, serial_frac=0.70,
                  mem_per_worker_mb=8, inputs=("decode",)),
        StageSpec("batch", "batch", cost=0.010, serial_frac=0.70,
                  mem_per_worker_mb=8, inputs=("feature_udf",)),
        StageSpec("prefetch", "prefetch", cost=0.006, serial_frac=0.70,
                  mem_per_worker_mb=8, inputs=("batch",)),
    )
    return StageGraph("proc_stream", stages, batch_mb=1.0,
                      target_rate=arrival.batches_per_sec(0.0))


def proc_scenario():
    arr = flash_crowd_arrivals(
        PROC_BASE, spike_at_s=PROC_SPIKE_AT, spike_len_s=PROC_SPIKE_LEN,
        spike_gain=PROC_SPIKE_GAIN, diurnal_amp=0.0, seed=0)
    spec = proc_stream_pipeline(arr)
    machine = MachineSpec(n_cpus=25, mem_mb=16384.0)
    return spec, machine


# ---------------------------------------------------------------- scoring --
def score_spike(rows, *, behind, consecutive: int):
    """rows: per-tick dicts (tput / arr / stale / in_spike); `behind(r)`
    decides whether one tick is starving/lagging. Returns (starve_ticks,
    spike_ticks, time_to_readapt): tta is the offset (in ticks) into the
    spike of the first run of `consecutive` caught-up ticks; None if the
    arm never re-adapts, 0 if it was never behind."""
    spike = [r for r in rows if r["in_spike"]]
    flags = [behind(r) for r in spike]
    starve = sum(flags)
    if starve == 0:
        return 0, len(spike), 0        # never behind: nothing to re-adapt
    tta = None
    ok_run = 0
    fell_behind = False
    for i, lag in enumerate(flags):
        if lag:
            fell_behind = True
            ok_run = 0
            continue
        # only a recovery counts: caught-up ticks BEFORE the arm first
        # fell behind are the backlog ramp, not a re-adaptation
        ok_run = ok_run + 1 if fell_behind else 0
        if ok_run == consecutive:
            tta = i - (consecutive - 1)
            break
    return starve, len(spike), tta


def sim_behind(r) -> bool:
    """Analytic plane: the tick's throughput is exact, so compare it to
    the arrival rate directly."""
    return r["tput"] < 0.95 * r["arr"]


def proc_behind(r) -> bool:
    """Process plane: window throughput is whole-batch quantized and a
    resize disturbs the very window that measures it, so per-window
    tput-vs-arrival is noise. Backlog is EXACT (arrival integral minus
    the source's token counter): the arm is behind when backlog GREW
    over the window — service rate below the arrival rate — and caught
    up the moment it re-matches, without charging the drain tail the
    way a staleness threshold would."""
    return (r["bl_delta"] or 0.0) > PROC_GROW_BATCHES


class HeldTuner:
    """Tune every `hold` windows. A live resize disturbs the very window
    that measures it (fresh workers fork + self-calibrate on an already
    saturated core), so each proposal is held for `hold` windows and only
    the LAST — settled — window of the hold is shown to the learner: the
    Session.run analog of fig_train_feed's tune-every-k-steps protocol.
    Frozen arms never resize, so they need no hold."""

    name = "intune"

    def __init__(self, inner, hold: int = 2):
        self.inner = inner
        self.hold = max(1, int(hold))
        self._alloc = None
        self._i = 0

    def propose(self, spec, machine, stats=None):
        if self._i % self.hold == 0:
            self._alloc = self.inner.propose(spec, machine, stats)
        return self._alloc

    def observe(self, tel) -> None:
        if self._i % self.hold == self.hold - 1:
            self.inner.observe(tel)
        self._i += 1


def run_arm(backend, opt, ticks: int, *, spike_rate: float):
    """Drive one policy through the scenario; a tick is in the spike
    when the measured arrival rate sits above twice the base (the proc
    plane's windows don't align with the wall-clock spike edges, so the
    tick's own arrival_rate is the only honest marker on both planes)."""
    rows = []
    prev_bl = [0.0]

    def collect(t, tel):
        ex = tel.extras or {}
        bl = tel.backlog_items
        delta = None if bl is None else bl - prev_bl[0]
        if bl is not None:
            prev_bl[0] = bl
        rows.append({
            "t": t,
            "tput": float(tel.throughput),
            "arr": float(ex.get("arrival_rate", 0.0)),
            "in_spike": float(ex.get("arrival_rate", 0.0)) > spike_rate,
            "stale": tel.batch_staleness_s,
            "backlog": bl,
            "bl_delta": delta,
            "workers": int(tel.used_cpus),
            "shed": float(ex.get("shed_batches", 0.0) or 0.0),
        })

    with Session(backend, opt) as session:
        res = session.run(ticks, collect=collect)
    return rows, res


def summarize(label, rows, res, *, behind, consecutive):
    starve, spike_ticks, tta = score_spike(rows, behind=behind,
                                           consecutive=consecutive)
    tail = [r["workers"] for r in rows[-ticks_tail(rows):]]
    spike = [r for r in rows if r["in_spike"]]
    out = {
        "spike_mean_tput": float(np.mean([r["tput"] for r in spike]))
        if spike else 0.0,
        "spike_max_stale_s": float(max((r["stale"] or 0.0)
                                       for r in spike)) if spike else 0.0,
        "policy": label,
        "oom_count": int(res.oom_count),
        "starve_ticks": int(starve),
        "spike_ticks": int(spike_ticks),
        "time_to_readapt": tta,
        "shed_total": float(rows[-1].get("shed", 0.0) or 0.0),
        "end_backlog": float(rows[-1]["backlog"] or 0.0),
        "end_staleness_s": float(rows[-1]["stale"] or 0.0),
        "trough_mean_workers": float(np.mean(tail)) if tail else 0.0,
    }
    print(f"  {label:12s} ooms={out['oom_count']:2d} "
          f"starve={out['starve_ticks']:3d}/{out['spike_ticks']} "
          f"tta={tta} end_backlog={out['end_backlog']:.0f} "
          f"trough_workers={out['trough_mean_workers']:.0f}")
    return out


def ticks_tail(rows, frac: float = 0.15):
    return max(1, int(len(rows) * frac))


# ------------------------------------------------------------------- arms --
def run_sim(seed: int = 0) -> dict:
    spec, machine = sim_scenario()
    even = heuristic_even(spec, machine)
    oracle = PipelineSim(spec, machine,
                         model_latency=1.0 / (1.2 * SIM_BASE)) \
        .best_allocation()[0]
    spike_rate = 2.0 * SIM_BASE
    print(f"[sim] even={even.workers.tolist()} "
          f"static_best={oracle.workers.tolist()}")

    arms = {}
    for label, opt_fn in (
            ("even", lambda s, m: FrozenPolicy(even)),
            ("static_best", lambda s, m: FrozenPolicy(oracle)),
            ("intune", lambda s, m: common.make_tuner(
                s, m, seed=seed, finetune_ticks=60,
                explore_restart_every=12))):
        spec, machine = sim_scenario()     # fresh arrival state per arm
        backend = make_backend("sim", spec, machine, seed=seed)
        rows, res = run_arm(backend, opt_fn(spec, machine), SIM_TICKS,
                            spike_rate=spike_rate)
        arms[label] = summarize(label, rows, res, behind=sim_behind,
                                consecutive=5)

    frozen_starve = min(arms["even"]["starve_ticks"],
                        arms["static_best"]["starve_ticks"])
    bar = frozen_starve / 2.0
    tta = arms["intune"]["time_to_readapt"]
    return {
        "scenario": {"base": SIM_BASE, "spike_at": SIM_SPIKE_AT,
                     "spike_len": SIM_SPIKE_LEN, "gain": SIM_SPIKE_GAIN,
                     "ticks": SIM_TICKS, "seed": seed},
        "arms": arms,
        "readapt_bar_ticks": bar,
        "pass": {
            "intune_readapts": tta is not None and tta <= bar,
            "intune_no_oom": arms["intune"]["oom_count"] == 0,
            "frozen_fails": (arms["even"]["starve_ticks"] >= bar * 2
                             or arms["even"]["oom_count"] > 0)
            and (arms["static_best"]["starve_ticks"] >= bar * 2
                 or arms["static_best"]["oom_count"] > 0),
        },
    }


def run_proc(seed: int = 0) -> dict:
    import time as _time

    spec, machine = proc_scenario()
    even = heuristic_even(spec, machine)
    # "provision for peak": the sim's water-filled best placement for
    # the DECLARED 25-CPU machine. In the simulator extra workers look
    # free; on the 1-core host every one of them multiplies the Amdahl
    # cycle and the measured capacity lands BELOW the spike demand —
    # the sim-to-proc gap this arm exists to exhibit.
    oracle = PipelineSim(spec, machine).best_allocation()[0]
    # intune's launch placement: the sim plan for the observed BASE
    # rate — the controller's conservative-launch convention for a
    # feed boundary on a shared host (minimal workers, scaled only as
    # live measurements justify). The contrast with static_best is the
    # tentpole claim: plan for base + adapt live vs freeze the peak
    # plan and melt the core.
    base_plan = PipelineSim(
        spec, machine,
        model_latency=1.0 / (1.2 * PROC_BASE)).best_allocation()[0]
    spike_rate = 2.0 * PROC_BASE
    print(f"[proc] even={even.workers.tolist()} "
          f"static_best={oracle.workers.tolist()} "
          f"intune_init={base_plan.workers.tolist()}")

    arms = {}
    for label, opt_fn in (
            ("even", lambda s, m: FrozenPolicy(even)),
            ("static_best", lambda s, m: FrozenPolicy(oracle)),
            ("intune", lambda s, m: HeldTuner(common.make_tuner(
                s, m, seed=seed, finetune_ticks=4,
                explore_restart_every=3, finetune_eps=0.7,
                lcb_coef=0.3, switch_margin=0.2, init_alloc=base_plan,
                readapt_stale_s=2.0, stale_scale=2.0), hold=2))):
        spec, machine = proc_scenario()    # fresh stream epoch per arm
        backend = make_backend("proc", spec, machine, seed=seed,
                               window_s=PROC_WINDOW_S, ballast=False)
        _time.sleep(1.0)                   # worker spin calibration
        rows, res = run_arm(backend, opt_fn(spec, machine), PROC_TICKS,
                            spike_rate=spike_rate)
        arms[label] = summarize(label, rows, res, behind=proc_behind,
                                consecutive=3)

    # differential claim, with margins sized for a noisy shared host:
    # both frozen arms spend most of the spike with a GROWING backlog
    # (service rate below arrivals); intune re-adapts — a run of
    # windows where the exact backlog counter stops growing — within
    # half of their sustained-starvation window and never OOMs.
    frac = lambda a: a["starve_ticks"] / max(1, a["spike_ticks"])
    frozen_starve = min(arms["even"]["starve_ticks"],
                        arms["static_best"]["starve_ticks"])
    bar = frozen_starve / 2.0
    tta = arms["intune"]["time_to_readapt"]
    return {
        "scenario": {"base": PROC_BASE, "spike_at": PROC_SPIKE_AT,
                     "spike_len": PROC_SPIKE_LEN,
                     "gain": PROC_SPIKE_GAIN, "window_s": PROC_WINDOW_S,
                     "ticks": PROC_TICKS,
                     "grow_batches": PROC_GROW_BATCHES,
                     "seed": seed},
        "arms": arms,
        "readapt_bar_ticks": bar,
        "pass": {
            "frozen_arms_starve": frac(arms["even"]) >= 0.5
            and frac(arms["static_best"]) >= 0.5,
            "intune_readapts": tta is not None and tta <= bar,
            "intune_no_oom": arms["intune"]["oom_count"] == 0,
        },
    }


# ------------------------------------------------------------------- main --
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="sim arm only (CI): skip the wall-clock proc arm")
    ap.add_argument("--backend", choices=("sim", "proc", "both"),
                    default="both")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-assert", action="store_true",
                    help="report only, never fail")
    args = ap.parse_args()

    payload = {}
    if args.backend in ("sim", "both"):
        payload["sim"] = run_sim(seed=args.seed)
    if args.backend in ("proc", "both") and not args.quick:
        payload["proc"] = run_proc(seed=args.seed)

    common.save_json("BENCH_torch_stream.json", payload)
    failures = [f"{plane}.{name}"
                for plane, rep in payload.items()
                for name, ok in rep["pass"].items() if not ok]
    if failures:
        print("FAIL:", ", ".join(failures))
        return 0 if args.no_assert else 1
    print("PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
