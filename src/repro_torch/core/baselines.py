"""Baseline data-pipeline optimizers (paper §5, Baselines 1-5).

  unoptimized        1 CPU per stage, no parallelism
  heuristic          even division (also InTune's initial state)
  autotune_like      greedy latency-driven hill-climber over its ESTIMATED
                     cost model. Two paper-documented flaws are modeled
                     faithfully: (a) black-box UDF/source costs are under-
                     estimated (StageSpec.est_bias), so UDF stages are
                     starved; (b) it maximizes prefetch buffering without a
                     memory-pressure signal -> OOMs (Fig. 5B).
  plumber_like       LP/water-filling on MEASURED stage rates (Plumber's
                     MILP reduces to proportional allocation for a linear-
                     scaling model); correct costs, but assumes perfect
                     linear scaling and only re-plans when relaunched.
  oracle             true-cost greedy water-filling (the "human expert").

Static optimizers return an Allocation once; `*-Adaptive` behavior is a
relaunch on resize, orchestrated by the benchmark loop. Each of these
plain functions also runs behind the unified Optimizer protocol via
`repro.core.optimizer.make_optimizer(name, ...)` (wrapped in a
StaticOptimizer), so benchmarks drive baselines and InTune identically.

All of them water-fill over the StageGraph bottleneck: with a single
sink, the DAG's sustained rate is the min over every stage's service
rate (simulator.sustained_rates), so the same per-stage greedy /
proportional placement is optimal for linear chains and join DAGs alike.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim

PipelineSpec = StageGraph   # pre-DAG alias, kept for imports

def unoptimized(spec: PipelineSpec, machine: MachineSpec) -> Allocation:
    return Allocation(np.ones(spec.n_stages, dtype=int),
                      prefetch_mb=spec.batch_mb)


def heuristic_even(spec: PipelineSpec, machine: MachineSpec) -> Allocation:
    per = max(1, machine.n_cpus // spec.n_stages)
    return Allocation(np.full(spec.n_stages, per, dtype=int),
                      prefetch_mb=2 * spec.batch_mb)


def autotune_like(spec: PipelineSpec, machine: MachineSpec,
                  seed: int = 0) -> Allocation:
    """Greedy: hand each CPU to the stage with the highest *estimated*
    latency; then maximize prefetch depth 'for performance' (no memory-
    pressure feedback — the documented OOM source: its one-shot estimate of
    the in-flight batch footprint varies run to run, and a heavy tail of
    runs lands past the physical memory line; ~8% in the paper's Fig. 5B).
    """
    rng = np.random.RandomState(seed)
    workers = np.ones(spec.n_stages, dtype=int)
    est_costs = np.array([s.est_cost() for s in spec.stages])
    for _ in range(machine.n_cpus - spec.n_stages):
        # estimated latency with current workers (its own linear model)
        est_lat = est_costs / workers
        workers[int(np.argmax(est_lat))] += 1
    # prefetch maximization: fills what it believes is available memory,
    # with a noisy one-shot estimate of the per-batch footprint.
    est_batch_mb = spec.batch_mb * float(rng.lognormal(0.0, 0.12))
    headroom = machine.mem_mb - 2048.0 \
        - sum(s.mem_per_worker_mb * w for s, w in zip(spec.stages, workers))
    depth = max(1, int(0.85 * headroom / max(est_batch_mb, 1.0)))
    return Allocation(workers, prefetch_mb=depth * spec.batch_mb)


def plumber_like(spec: PipelineSpec, machine: MachineSpec,
                 seed: int = 0) -> Allocation:
    """Proportional (LP) allocation on measured single-worker rates.

    Plumber measures per-stage rates once (a short profiling window — the
    one-shot measurement carries noise), then solves max-min throughput
    assuming rate_i(a) = a / cost_i (linear). The LP optimum is
    a_i = N * cost_i / sum(costs). Integerized by largest remainder.
    Its two gaps vs InTune: the linear-scaling assumption (no Amdahl
    saturation) and no live feedback (only relaunch adapts it)."""
    rng = np.random.RandomState(seed)
    costs = np.array([s.cost for s in spec.stages])
    costs = costs * rng.lognormal(0.0, 0.25, size=len(costs))
    n = machine.n_cpus
    frac = n * costs / costs.sum()
    workers = np.maximum(1, np.floor(frac).astype(int))
    rem = n - workers.sum()
    if rem > 0:
        order = np.argsort(-(frac - np.floor(frac)))
        for i in order[:rem]:
            workers[i] += 1
    while workers.sum() > n:
        workers[int(np.argmax(workers))] -= 1
    return Allocation(workers, prefetch_mb=2 * spec.batch_mb)


def oracle(spec: PipelineSpec, machine: MachineSpec,
           model_latency: float = 0.0) -> Allocation:
    sim = PipelineSim(spec, machine, model_latency)
    alloc, _ = sim.best_allocation()
    return alloc


BASELINES = {
    "unoptimized": unoptimized,
    "heuristic": heuristic_even,
    "autotune": autotune_like,
    "plumber": plumber_like,
    "oracle": oracle,
}
