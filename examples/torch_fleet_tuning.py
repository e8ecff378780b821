"""Fleet co-tuning on the PyTorch port (the port of
examples/fleet_tuning.py): InTune agents per trainer + a cluster
coordinator.

Walks the fleet plane end to end on the canonical 4-machine heterogeneous
cluster (repro_torch.data.fleet.demo_cluster):

  1. the ClusterSpec — machines, shared elastic pool, churn schedule,
  2. what the static fleet policies propose (pool grants per machine),
  3. the FleetCoordinator driving one pretrained InTune DQN per trainer
     through the unified Optimizer protocol against a FleetSim, riding
     out a machine join, a mid-run shrink, and a machine leave — while
     its admission control keeps the memory-tight hosts from OOMing.

    PYTHONPATH=src python examples/torch_fleet_tuning.py
"""
import numpy as np

from repro_torch.api import FleetSimBackend, Session
from repro_torch.core import baselines as B
from repro_torch.core.fleet_coordinator import FleetCoordinator
from repro_torch.core.pretrain import pretrain
from repro_torch.data.fleet import FleetSim, demo_cluster


def show_cluster(cluster):
    print(f"ClusterSpec {cluster.name!r}: shared pool "
          f"{cluster.shared_pool} CPUs")
    for t in cluster.trainers:
        cap = "unbounded" if t.model_latency == 0 \
            else f"{1 / t.model_latency:.1f} b/s"
        print(f"  {t.name:6s} {t.pipeline.name:16s} "
              f"{t.machine.n_cpus:3d} CPUs {t.machine.mem_mb / 1024:4.0f} GB"
              f"  model demand {cap}"
              f"{'' if t.start_active else '  (joins mid-run)'}")
    for ev in cluster.events:
        print(f"  churn @{ev.tick:4d}: {ev.kind} {ev.trainer} "
              f"{ev.n_cpus if ev.kind in ('resize', 'pool') else ''}")


def show_static_policies(cluster):
    state = FleetSim(cluster, seed=0).machine
    print("\nstatic fleet policies (pool grants per machine):")
    for name, fn in B.FLEET_BASELINES.items():
        fa = fn(cluster, state, 0)
        sim = FleetSim(cluster, seed=0)
        m = sim.apply(fa)
        grants = " ".join(f"{k}:+{v}" for k, v in fa.grants.items()) or "-"
        print(f"  {name:20s} {m['throughput']:6.2f} b/s   grants {grants}")


def run_coordinator(cluster, ticks, episodes: int = 30,
                    pretrain_ticks: int = 250):
    print("\npretraining agents offline (short pass; benchmarks use the "
          "cached full pass)...")
    lengths = sorted({t.pipeline.n_stages for t in cluster.trainers})
    pretrained = {n: pretrain(n, episodes=episodes, ticks=pretrain_ticks,
                              verbose=False, head="factored").state_dict()
                  for n in lengths}
    coord = FleetCoordinator(cluster, pretrained=pretrained, seed=0)
    backend = FleetSimBackend(cluster, seed=0)
    win = ticks // 6
    tputs = []

    def report(t, tel):
        tputs.append(tel.throughput)
        if (t + 1) % win == 0:
            grants = " ".join(f"{k}:+{v}" for k, v in coord.grants.items())
            print(f"  ticks {t + 1 - win:4d}-{t + 1:4d}: "
                  f"mean {np.mean(tputs[-win:]):6.2f} b/s "
                  f"over {tel['n_active']} machines | grants {grants}")

    res = Session(backend, coord).run(ticks, collect=report)
    # score against the ideal fleet (per-tick oracle, no churn cost)
    ref = FleetSim(cluster, seed=0)
    oracle = np.mean([
        ref.apply(B.fleet_oracle(cluster, ref.machine))["throughput"]
        for _ in range(ticks)])
    mean = float(np.mean(res.throughput))
    print(f"\ncoordinator mean {mean:.2f} b/s = "
          f"{100 * mean / oracle:.0f}% of fleet oracle "
          f"(OOMs: {res.oom_count})")
    return {"mean": mean, "oracle": float(oracle),
            "oom_count": res.oom_count}


if __name__ == "__main__":
    ticks = 600
    cluster = demo_cluster(ticks)
    show_cluster(cluster)
    show_static_policies(cluster)
    run_coordinator(cluster, ticks)
