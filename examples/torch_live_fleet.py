"""Drive the FleetCoordinator on REAL executors on the PyTorch port (the
port of examples/live_fleet.py): a 60-tick live fleet.

The same `repro_torch.api.Session` loop as examples/torch_fleet_tuning.py,
but the authoritative backend is LiveFleet — one ThreadedPipeline per
trainer, measured (not simulated) throughput. Runs in ~10s.

    PYTHONPATH=src python examples/torch_live_fleet.py
"""
from repro_torch.api import LiveFleetBackend, Session
from repro_torch.core.fleet_coordinator import FleetCoordinator
from repro_torch.data.live_fleet import live_demo_cluster


def main(ticks: int = 60, window_s: float = 0.1):
    cluster = live_demo_cluster(ticks)
    coord = FleetCoordinator(cluster, seed=0, finetune_ticks=20)

    def report(t, tel):
        if t % 10 == 0:
            per = " ".join(
                f"{n}:{m['throughput']:6.1f}"
                for n, m in tel["per_trainer"].items())
            print(f"tick {t:3d} | active {tel['n_active']} | "
                  f"measured {tel.throughput:7.1f} b/s | {per}")

    with Session(LiveFleetBackend(cluster, window_s=window_s),
                 coord) as session:
        session.run(ticks, collect=report)
        acct = session.close()
    print(f"\nmeasured fleet run done: OOMs {acct['oom_count']}, "
          f"dropped batches {acct['dropped_batches']}, "
          f"all threads joined: {acct['all_joined']}")
    return acct


if __name__ == "__main__":
    main()
