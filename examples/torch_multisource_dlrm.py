"""Multi-source DLRM ingestion on the PyTorch port (the port of
examples/multisource_dlrm.py): InTune tunes a non-linear StageGraph.

Production DLRM pipelines are DAGs, not chains (Zhao et al.): dense,
sparse, and label streams come from separate storage and are joined
before the feature transforms. This example runs that shape end to end,
twice:

  1. REAL execution — a ThreadedPipeline over the 3-source join graph
     (one bounded queue per edge, an aligned gather at the join),
     feeding actual numpy batches out of the sink.
  2. RL tuning at scale — the analytic simulator models the 128-CPU
     machine and the InTune DQN agent drives allocations through the
     unified Optimizer protocol (propose -> apply -> observe), landing
     within a few percent of the true-cost oracle.

    PYTHONPATH=src python examples/torch_multisource_dlrm.py
"""
import numpy as np

from repro_torch.api import Session, SimBackend
from repro_torch.core.controller import InTune
from repro_torch.core.optimizer import make_optimizer
from repro_torch.core.pretrain import pretrain
from repro_torch.data.executor import ThreadedPipeline
from repro_torch.data.pipeline import multisource_dlrm_pipeline
from repro_torch.data.simulator import MachineSpec, PipelineSim


def run_real_executor(spec, n_items: int = 24):
    """Drive the join DAG with real threads and real (tiny) arrays."""
    counts = {"dense": 0, "sparse": 0, "label": 0}
    # each source runs in its own worker thread: one RandomState apiece
    rngs = {k: np.random.RandomState(i)
            for i, k in enumerate(("dense", "sparse", "label"))}

    def source(key, make):
        def fn():
            if counts[key] >= n_items:
                return None
            i = counts[key]
            counts[key] += 1
            return {"row": i, key: make(i)}
        return fn

    fns = {
        "dense_source": source(
            "dense", lambda i: rngs["dense"].randn(32, 4).astype("f4")),
        "sparse_source": source(
            "sparse", lambda i: rngs["sparse"].randint(0, 1024, (32, 8))),
        "label_source": source(
            "label", lambda i: rngs["label"].randint(0, 2, (32,))),
        # the join pairs one item from each parent stream, in spec order
        "join": lambda d, s, l: {**d, **s, **l},
        "feature_udf": lambda b: {**b, "dense": np.log1p(np.abs(b["dense"]))},
        "batch": lambda b: b,
        "prefetch": lambda b: b,
    }
    pipe = ThreadedPipeline(spec, fns=fns, queue_depth=4, item_mb=1.0,
                            machine=MachineSpec(n_cpus=8, mem_mb=8192))
    got = 0
    try:
        while True:
            b = pipe.get_batch(timeout=10)
            assert b["dense"].shape == (32, 4) and b["label"].shape == (32,)
            got += 1
    except StopIteration:
        pass
    finally:
        pipe.stop()
    stats = pipe.stats()
    print(f"executor: {got} joined batches through "
          f"{len(spec.edges)} edges; workers {stats['workers']}, "
          f"free_cpus {stats['free_cpus']}")
    return {"batches": got, "stats": stats}


def run_rl_tuning(spec, ticks: int = 300, episodes: int = 30,
                  pretrain_ticks: int = 250):
    machine = MachineSpec(n_cpus=128, mem_mb=65536)
    sim = PipelineSim(spec, machine)
    oracle = make_optimizer("oracle", spec, machine)
    oracle_tput = sim.throughput(oracle.propose(spec, machine))
    print(f"oracle: {oracle_tput:.2f} batches/s "
          f"({100 * oracle_tput / spec.target_rate:.0f}% of target)")

    print("pretraining a 7-stage agent offline (short pass)...")
    agent = pretrain(spec.n_stages, episodes=episodes, ticks=pretrain_ticks,
                     verbose=False, head="factored")
    tuner = InTune(spec, machine, seed=0, head="factored",
                   pretrained=agent.state_dict(), finetune_ticks=250)

    # the unified Session loop every driver uses (repro_torch.api)
    backend = SimBackend(spec, machine, seed=0)

    def report(t, tel):
        if (t + 1) % 75 == 0:
            print(f"  tick {t + 1:3d}: {tel.throughput:.2f} b/s "
                  f"workers {tuner.allocation.workers}")

    Session(backend, tuner).run(ticks, collect=report)
    final = backend.sim.apply(tuner.allocation)["throughput"]
    print(f"InTune after {ticks} ticks: {final:.2f} batches/s = "
          f"{100 * final / oracle_tput:.0f}% of oracle "
          f"(OOMs: {backend.oom_count})")
    return {"oracle": oracle_tput, "final": final,
            "oom_count": backend.oom_count}


if __name__ == "__main__":
    spec = multisource_dlrm_pipeline()
    names = " -> ".join(spec.stages[i].name for i in spec.topo_order)
    print(f"StageGraph {spec.name!r}: {spec.n_stages} stages, "
          f"{len(spec.edges)} edges, topo {names}")
    run_real_executor(spec)
    run_rl_tuning(spec)
