"""Fig. 7 at fleet scale on the PyTorch port (the port of
benchmarks/fig7_fleet.py): co-tuning a multi-trainer cluster under churn.

The paper's headline (2.29x ingestion throughput, better CPU & GPU
utilization) is a cluster-level outcome: many trainer machines, tuned
per-machine, sharing elastically provisioned CPU. This driver runs the
canonical 4-machine heterogeneous fleet (repro_torch.data.fleet.demo_cluster —
two linear DLRM chains + the multi-source join DAG, 6-64 GB hosts, a
shared elastic pool, and join/shrink/leave churn) under every fleet
policy, all through the same `repro_torch.api.Session` propose -> apply ->
observe loop used for single machines:

  fleet_even / fleet_proportional    static pool splits + memory-blind
                                     per-machine placement; adapt to churn
                                     only by relaunch (dead window)
  fleet_local_oracle                 perfect per-machine tuning, nobody
                                     arbitrates the pool (no coordination)
  fleet_oracle                       true-cost global water-filling — the
                                     reference every policy is scored on
  fleet_intune                       the FleetCoordinator: one pretrained
                                     InTune DQN per trainer + marginal-
                                     throughput pool arbitration, OOM
                                     admission control and quarantine

Acceptance targets: coordinator >= 90% of the fleet oracle, >= 1.3x
fleet-even, zero steady-state OOMs.

`--live` swaps the authoritative backend for LiveFleet: the
3-trainer live cluster (repro_torch.data.live_fleet.live_demo_cluster) runs
one REAL ThreadedPipeline per trainer through the same driver loop, and
the coordinator is scored against fleet_even on MEASURED aggregate
throughput under churn — zero coordinator OOMs, zero dropped batches,
every thread joined.

The fleet plane runs on the host (each live trainer is a consumer thread
that sleeps its model latency per batch) and the DQN runs on the CPU, so
this benchmark touches no device. It writes BENCH_torch_fig7_fleet.json
(and BENCH_torch_fig7_fleet_live.json) under build/bench/, with the
reference's summary keys; the pretrained agents are cached under
build/agents/ (benchmarks/torch_common.py).

    PYTHONPATH=src python -m benchmarks.torch_fig7_fleet [--live] [--ticks N]
"""
from __future__ import annotations

import numpy as np

from benchmarks import torch_common as common
from repro_torch.api import FleetSimBackend, Session, tune
from repro_torch.core.optimizer import make_fleet_optimizer
from repro_torch.data.fleet import demo_cluster

STEADY_FRAC = 0.3     # last 30% of the run counts as steady state


def _collector(store: dict):
    last_active: list = []

    def collect(t, m):
        per = m.get("per_trainer")
        if per is None:
            # fleet-wide relaunch dead window: every machine that was up
            # last tick is down now — charge 0 used CPUs, not "no data",
            # so static policies' utilization pays for their relaunches
            for name in last_active:
                s = store[name]
                s["used"].append(0)
                s["eff"].append(s["eff"][-1])
                s["tput"].append(0.0)
            return
        last_active[:] = list(per)
        for name, pm in per.items():
            s = store.setdefault(name, {"used": [], "eff": [], "tput": [],
                                        "oom_ticks": []})
            # a machine mid OOM-restart is down, not busy
            s["used"].append(0 if pm["restarting"]
                             else min(pm["used_cpus"], pm["eff_cpus"]))
            s["eff"].append(pm["eff_cpus"])
            s["tput"].append(pm["throughput"])
            if pm["oom"]:
                s["oom_ticks"].append(t)
    return collect


def run(ticks: int = 1200, seed: int = 0, quiet: bool = False) -> dict:
    cluster = demo_cluster(ticks)
    runs, per_machine = {}, {}
    policies = ["fleet_even", "fleet_proportional", "fleet_local_oracle",
                "fleet_oracle", "fleet_intune"]
    for name in policies:
        if name == "fleet_intune":
            opt = common.make_fleet_coordinator(cluster, seed=seed)
            dead = 0            # re-tunes live, like single-machine InTune
        else:
            opt = make_fleet_optimizer(name, cluster, seed=seed)
            # the ideal reference pays nothing; real static deployments
            # adapt to churn by checkpoint + relaunch
            dead = 0 if name == "fleet_oracle" else common.RELAUNCH_TICKS
        store: dict = {}
        r = Session(FleetSimBackend(cluster, seed=seed), opt).run(
            ticks, relaunch_dead=dead, collect=_collector(store))
        runs[name] = r
        per_machine[name] = store

    steady_from = int((1 - STEADY_FRAC) * ticks)
    summary = {}
    for name, r in runs.items():
        tp = np.asarray(r["throughput"])
        store = per_machine[name]
        util = {
            m: float(np.sum(s["used"]) / max(np.sum(s["eff"]), 1) * 100)
            for m, s in store.items()}
        ooms_steady = sum(
            1 for s in store.values()
            for t in s["oom_ticks"] if t >= steady_from)
        summary[name] = {
            "mean_tput": float(tp.mean()),
            "steady_tput": float(tp[steady_from:].mean()),
            "cpu_util_pct": util,
            "oom_count": int(r["oom_count"]),
            "ooms_steady": int(ooms_steady),
        }
    oracle = summary["fleet_oracle"]["mean_tput"]
    for name in summary:
        summary[name]["pct_of_oracle"] = float(
            summary[name]["mean_tput"] / oracle * 100)
    summary["_speedups"] = {
        "intune_vs_even": float(summary["fleet_intune"]["mean_tput"]
                                / max(summary["fleet_even"]["mean_tput"],
                                      1e-9)),
        "intune_vs_local_oracle": float(
            summary["fleet_intune"]["mean_tput"]
            / max(summary["fleet_local_oracle"]["mean_tput"], 1e-9)),
    }
    if not quiet:
        print(f"\n== Fig7 fleet ({cluster.name}, {ticks} ticks, "
              f"pool {cluster.shared_pool}) ==")
        for name in policies:
            s = summary[name]
            util = " ".join(f"{m}:{u:3.0f}%"
                            for m, u in s["cpu_util_pct"].items())
            print(f"  {name:20s} mean {s['mean_tput']:6.2f} b/s "
                  f"({s['pct_of_oracle']:5.1f}% of oracle) | "
                  f"OOMs {s['oom_count']:3d} (steady {s['ooms_steady']}) | "
                  f"util {util}")
        sp = summary["_speedups"]
        print(f"  coordinator vs fleet-even: {sp['intune_vs_even']:.2f}x; "
              f"vs uncoordinated per-machine oracle: "
              f"{sp['intune_vs_local_oracle']:.2f}x")
    common.save_json("BENCH_torch_fig7_fleet.json", {
        "summary": summary,
        "timelines": {k: r["throughput"] for k, r in runs.items()}})
    return summary


def run_live(ticks: int = 160, window_s: float = 0.12, seed: int = 0,
             quiet: bool = False) -> dict:
    """Coordinator vs fleet_even on real executors (LiveFleet backend).

    Scores are MEASURED batch-counter rates, not analytic predictions.
    The relaunch dead window for the static policy is scaled to the
    (shorter) live run so churn adaptation costs stay proportional to
    the sim benchmark's 20/1200.
    """
    from repro_torch.data.live_fleet import live_demo_cluster
    cluster = live_demo_cluster(ticks)
    # same share of the run as the sim benchmark's 20/1200 per relaunch,
    # so the static baseline's churn-adaptation cost is comparable
    dead_ticks = max(2, round(ticks * common.RELAUNCH_TICKS / 1200))
    runs = {}
    for name in ("fleet_even", "fleet_intune"):
        if name == "fleet_intune":
            opt = common.make_fleet_coordinator(cluster, seed=seed,
                                                finetune_ticks=40)
            dead = 0            # re-tunes live, like single-machine InTune
        else:
            opt = make_fleet_optimizer(name, cluster, seed=seed)
            dead = dead_ticks
        runs[name] = tune(cluster, optimizer=opt, backend="live",
                          ticks=ticks, seed=seed, relaunch_dead=dead,
                          backend_kw={"window_s": window_s})

    summary = {}
    for name, r in runs.items():
        tp = np.asarray(r["throughput"])
        summary[name] = {
            "mean_tput": float(tp.mean()),
            "oom_count": int(r["oom_count"]),
            "dropped_batches": int(r["live"]["dropped_batches"]),
            "crash_lost": int(r["live"]["crash_lost"]),
            "all_joined": bool(r["live"]["all_joined"]),
        }
    summary["_speedups"] = {
        "intune_vs_even": float(
            summary["fleet_intune"]["mean_tput"]
            / max(summary["fleet_even"]["mean_tput"], 1e-9))}
    if not quiet:
        print(f"\n== Fig7 fleet LIVE ({cluster.name}, {ticks} ticks x "
              f"{window_s}s windows, pool {cluster.shared_pool}) ==")
        for name in ("fleet_even", "fleet_intune"):
            s = summary[name]
            print(f"  {name:14s} measured {s['mean_tput']:7.1f} b/s | "
                  f"OOMs {s['oom_count']:2d} | dropped "
                  f"{s['dropped_batches']} | joined {s['all_joined']}")
        print(f"  coordinator vs fleet-even (measured): "
              f"{summary['_speedups']['intune_vs_even']:.2f}x")
    common.save_json("BENCH_torch_fig7_fleet_live.json", {
        "summary": summary,
        "timelines": {k: r["throughput"] for k, r in runs.items()}})
    return summary


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--live", action="store_true",
                    help="score policies on real ThreadedPipeline "
                         "executors (LiveFleet) instead of FleetSim")
    ap.add_argument("--ticks", type=int, default=None)
    args = ap.parse_args()
    if args.live:
        run_live(**({"ticks": args.ticks} if args.ticks else {}))
    else:
        run(**({"ticks": args.ticks} if args.ticks else {}))
