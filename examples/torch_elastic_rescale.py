"""Elastic rescale demo on the PyTorch port (the port of
examples/elastic_rescale.py): the paper's Fig. 5C scenario end to end.

A job starts on a 32-CPU machine; the cluster scheduler grows it
32 -> 64 -> 128, then shrinks back. InTune adapts with zero relaunches;
the AUTOTUNE-like baseline is shown frozen (never adapts). Also
demonstrates the compute-side elastic path: mesh re-planning
(`repro_torch.train.elastic.ElasticCoordinator`; `reshard` places a
checkpoint onto the new mesh's ranks, tests/test_torch_dist_models.py).

    PYTHONPATH=src python examples/torch_elastic_rescale.py
"""
import numpy as np

from repro_torch.api import (ControllerBackend, FrozenPolicy, Session,
                             SimBackend, resize_events)
from repro_torch.core import baselines as B
from repro_torch.core.controller import InTune
from repro_torch.core.pretrain import pretrain
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.simulator import MachineSpec, resize_schedule
from repro_torch.train.elastic import ElasticCoordinator


def main(ticks: int = 1000, episodes: int = 30, pretrain_ticks: int = 250):
    """Prints the run; returns the two throughput traces and the
    recovery plans (the tests run it at fewer ticks)."""
    spec = criteo_pipeline()
    resizes = resize_schedule(ticks)
    events = resize_events(resizes)
    print("resize schedule:", resizes)

    print("\npretraining agent (offline simulator pass)...")
    agent = pretrain(5, episodes=episodes, ticks=pretrain_ticks,
                     verbose=False, head="factored")

    # InTune rides the ResizeEvents live (zero relaunches): the
    # self-driving paper protocol behind the unified Session driver
    tuner = InTune(spec, MachineSpec(n_cpus=32), seed=0, head="factored",
                   pretrained=agent.state_dict(), finetune_ticks=100)
    intune_t = Session(ControllerBackend(tuner)).run(
        ticks, events=events).throughput

    # frozen AUTOTUNE (configured once for 32 CPUs), same event stream
    alloc = B.autotune_like(spec, MachineSpec(n_cpus=32), 0)
    auto_t = Session(SimBackend(spec, MachineSpec(n_cpus=32)),
                     FrozenPolicy(alloc)).run(ticks,
                                              events=events).throughput

    seg = ticks // len(resizes)
    print(f"\n{'window':>10s} {'cap':>5s} {'InTune':>8s} {'AUTOTUNE':>9s} "
          f"{'ratio':>6s}")
    for i, (t0, cap) in enumerate(resizes):
        t1 = t0 + seg
        a = np.mean(intune_t[t0:t1])
        b = np.mean(auto_t[t0:t1])
        print(f"{t0:5d}-{t1:4d} {cap:5d} {a:8.2f} {b:9.2f} "
              f"{a / max(b, 1e-9):5.2f}x")
    print(f"\noverall: InTune {np.mean(intune_t):.2f} vs frozen AUTOTUNE "
          f"{np.mean(auto_t):.2f} "
          f"({np.mean(intune_t)/max(np.mean(auto_t),1e-9):.2f}x) — "
          f"the paper's 2x-class gain comes from exactly these windows")

    # ---- compute-side elasticity: mesh re-planning ---------------------
    print("\ncompute-side recovery plans (ElasticCoordinator):")
    coord = ElasticCoordinator(n_devices=256, model_parallel=16)
    plans = []
    for survivors in (256, 192, 128, 60, 16):
        plan = coord.recovery_plan(survivors)
        plans.append(plan)
        print(f"  {survivors:4d} survivors -> mesh {plan['mesh_shape']}, "
              f"{plan['devices_idle']} idle")
    return intune_t, auto_t, plans


if __name__ == "__main__":
    main()
