"""Pool market at cluster scale on the PyTorch port (the port of
benchmarks/fig_market.py): multi-job arbitration of shared CPU.

Zhao et al.'s DSI setting — many concurrent training jobs drawing on one
ingestion substrate — meets the InTune fleet plane here. The 32-machine
heterogeneous cluster (repro_torch.data.fleet.big_cluster: core-count and
socket-speed skew per Kalamkar et al., three pipeline shapes, varied
model demand, memory-tight stragglers, churn on every axis) is
partitioned into weighted jobs bidding for the shared elastic pool, and
every policy runs through the same Session propose -> apply -> observe
loop:

  fleet_even           every machine gets the same pool share; memory-
                       blind even placement (no job awareness at all)
  market_local_oracle  per-JOB local oracle: even pool split across
                       jobs, perfect water-filling within each — what
                       perfect per-job tuning buys with nobody pricing
                       the pool across jobs
  fleet_oracle         per-trainer greedy marginal-throughput water-
                       filling, ignoring job weights — the throughput
                       reference every policy is scored against
  market_oracle        the weighted cross-job auction + per-machine
                       oracle placement (the market's static reference)
  market               PoolMarket over per-job FleetCoordinators: the
                       auction prices the pool across jobs, one
                       pretrained InTune DQN per trainer tunes each
                       machine, OOM quarantine forces re-auction

Acceptance: the coordinator + market ("market") holds >= 90%
of the fleet oracle on the 32-machine multi-job cluster with churn.

The proc arm (`--proc`, included in `--quick`) scores the market against
fleet_even on a small REAL process fleet (ProcFleet: one ProcessPipeline
per trainer, physical CPU contention) — measured batch-counter rates,
zero leaked processes, clean teardown accounting.

Host only: FleetSim, ProcFleet's processes and the DQNs on the CPU.
`main` writes BENCH_torch_market.json under build/bench/.

    PYTHONPATH=src python -m benchmarks.torch_fig_market [--quick]
                                                        [--no-proc]
"""
from __future__ import annotations

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import FleetSimBackend, Session, tune
from repro_torch.core.optimizer import make_fleet_optimizer
from repro_torch.data.fleet import (JobSpec, MarketSpec, TrainerSpec,
                                    big_cluster)

STEADY_FRAC = 0.3     # last 30% of the run counts as steady state


def run(ticks: int = 600, n_machines: int = 32, seed: int = 0,
        quiet: bool = False) -> dict:
    market = big_cluster(n_machines, ticks=ticks, seed=seed)
    policies = ["fleet_even", "market_local_oracle", "fleet_oracle",
                "market_oracle", "market"]
    runs, job_tput = {}, {}
    member_job = {t: j.name for j in market.jobs for t in j.trainers}
    for name in policies:
        if name == "market":
            # short per-machine windows: the warm-start anchor is
            # measured (PoolMarket inners), so serve-best never sits
            # below the planner's point and long eps-walks only wander
            opt = common.make_pool_market(market, seed=seed,
                                          finetune_ticks=20)
            dead = 0            # re-tunes live, like the coordinator
        else:
            opt = make_fleet_optimizer(name, cluster=market, seed=seed)
            # ideal references pay nothing; deployable static splits
            # adapt to churn by checkpoint + relaunch
            dead = 0 if name in ("fleet_oracle", "market_oracle") \
                else common.RELAUNCH_TICKS
        per_job: dict = {j.name: 0.0 for j in market.jobs}

        def collect(t, m, per_job=per_job):
            per = m.get("per_trainer")
            if per is None:
                return
            for n, pm in per.items():
                per_job[member_job[n]] += pm["throughput"]

        runs[name] = Session(FleetSimBackend(market, seed=seed), opt).run(
            ticks, relaunch_dead=dead, collect=collect)
        job_tput[name] = {j: v / ticks for j, v in per_job.items()}

    steady_from = int((1 - STEADY_FRAC) * ticks)
    summary = {}
    for name, r in runs.items():
        tp = np.asarray(r["throughput"])
        summary[name] = {
            "mean_tput": float(tp.mean()),
            "steady_tput": float(tp[steady_from:].mean()),
            "oom_count": int(r["oom_count"]),
            "job_tput": job_tput[name],
        }
    oracle = summary["fleet_oracle"]["mean_tput"]
    for name in summary:
        summary[name]["pct_of_oracle"] = float(
            summary[name]["mean_tput"] / oracle * 100)
    summary["_speedups"] = {
        "market_vs_even": float(
            summary["market"]["mean_tput"]
            / max(summary["fleet_even"]["mean_tput"], 1e-9)),
        "market_vs_job_local": float(
            summary["market"]["mean_tput"]
            / max(summary["market_local_oracle"]["mean_tput"], 1e-9)),
    }
    if not quiet:
        print(f"\n== Pool market ({market.name}, {ticks} ticks, "
              f"pool {market.shared_pool}, "
              f"{len(market.jobs)} jobs) ==")
        for name in policies:
            s = summary[name]
            jt = " ".join(f"{j}:{v:6.1f}" for j, v in s["job_tput"].items())
            print(f"  {name:20s} mean {s['mean_tput']:7.2f} b/s "
                  f"({s['pct_of_oracle']:5.1f}% of oracle) | "
                  f"OOMs {s['oom_count']:3d} | per-job {jt}")
        sp = summary["_speedups"]
        print(f"  market vs fleet-even: {sp['market_vs_even']:.2f}x; "
              f"vs per-job local oracle: {sp['market_vs_job_local']:.2f}x")
    return summary


# ---------------------------------------------------------------------------
# Proc arm: the market on a REAL process fleet (measured, not modeled).
# ---------------------------------------------------------------------------

def proc_market(pool: int = 4) -> MarketSpec:
    """Small 3-trainer, 2-job market for the proc arm: spin-work stage
    costs sized so a measurement window catches tens of batches on a
    couple of cores."""
    from repro_torch.data.pipeline import StageGraph, StageSpec

    def pipe(name, work_cost):
        return StageGraph(name, (
            StageSpec("src", "source", cost=0.002, serial_frac=0.0,
                      mem_per_worker_mb=16),
            StageSpec("work", "udf", cost=work_cost, serial_frac=0.0,
                      mem_per_worker_mb=16, inputs=("src",)),
        ), batch_mb=1.0)

    from repro_torch.data.simulator import MachineSpec
    trainers = (
        TrainerSpec("a0", pipe("pa0", 0.02), MachineSpec(2, 4096.0)),
        TrainerSpec("a1", pipe("pa1", 0.03), MachineSpec(2, 4096.0)),
        TrainerSpec("b0", pipe("pb0", 0.02), MachineSpec(2, 4096.0)),
    )
    jobs = (JobSpec("jobA", ("a0", "a1"), weight=2.0, floor=1),
            JobSpec("jobB", ("b0",), weight=1.0))
    return MarketSpec("proc_market3", trainers, shared_pool=pool, jobs=jobs)


def run_proc(ticks: int = 40, window_s: float = 0.2, seed: int = 0,
             quiet: bool = False) -> dict:
    market = proc_market()
    runs = {}
    for name in ("fleet_even", "market"):
        opt = make_fleet_optimizer(name, cluster=market, seed=seed)
        runs[name] = tune(market, optimizer=opt, backend="proc",
                          ticks=ticks, seed=seed,
                          backend_kw={"window_s": window_s,
                                      "ballast": False})
    summary = {}
    for name, r in runs.items():
        tp = np.asarray(r["throughput"])
        summary[name] = {
            "mean_tput": float(tp.mean()),
            "oom_count": int(r["oom_count"]),
            "dropped_batches": int(r["live"]["dropped_batches"]),
            "all_joined": bool(r["live"]["all_joined"]),
        }
    summary["_speedups"] = {
        "market_vs_even": float(
            summary["market"]["mean_tput"]
            / max(summary["fleet_even"]["mean_tput"], 1e-9))}
    if not quiet:
        print(f"\n== Pool market PROC ({market.name}, {ticks} ticks x "
              f"{window_s}s windows, pool {market.shared_pool}) ==")
        for name in ("fleet_even", "market"):
            s = summary[name]
            print(f"  {name:12s} measured {s['mean_tput']:7.1f} b/s | "
                  f"OOMs {s['oom_count']:2d} | dropped "
                  f"{s['dropped_batches']} | joined {s['all_joined']}")
        print(f"  market vs fleet-even (measured): "
              f"{summary['_speedups']['market_vs_even']:.2f}x")
    return summary


def main(quick: bool = False, ticks: int = None, proc: bool = None,
         seed: int = 0) -> dict:
    sim_ticks = ticks or (240 if quick else 600)
    out = {"sim": run(ticks=sim_ticks, seed=seed)}
    if proc or proc is None:
        out["proc"] = run_proc(ticks=20 if quick else 40, seed=seed)
    common.save_json("BENCH_torch_market.json", out)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="short sim run + short proc arm (CI smoke)")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--no-proc", action="store_true",
                    help="skip the measured ProcFleet arm")
    args = ap.parse_args()
    main(quick=args.quick, ticks=args.ticks,
         proc=False if args.no_proc else None)
