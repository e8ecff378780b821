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

from functools import lru_cache

import numpy as np

from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim

PipelineSpec = StageGraph   # pre-DAG alias, kept for imports

# one-shot optimizers whose run-to-run profiling noise is part of the
# model (each launch re-profiles); benchmarks sweep their seed
SEEDED = frozenset({"autotune", "plumber"})


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


# ---------------------------------------------------------------------------
# Fleet baselines (cluster plane). Each is fn(cluster, state, seed) ->
# FleetAllocation: a pool-grant split across the active machines plus a
# per-machine allocation at the granted cap. They run behind
# FleetStaticOptimizer (repro.core.optimizer.make_fleet_optimizer), which
# re-proposes whenever churn changes the FleetState — the fleet analog of
# the single-machine *-Adaptive relaunch behavior.
# ---------------------------------------------------------------------------

def _eff_machine(trainer, cap: int) -> MachineSpec:
    import dataclasses
    return dataclasses.replace(trainer.machine, n_cpus=int(cap))


@lru_cache(maxsize=4096)
def _oracle_cached(pipeline: StageGraph, mem_mb: float,
                   model_latency: float, cap: int):
    """Memoized per-machine oracle point: (Allocation, throughput) of
    true-cost water-filling at `cap` CPUs. Hashable StageGraph keys it."""
    machine = MachineSpec(n_cpus=int(cap), mem_mb=mem_mb)
    sim = PipelineSim(pipeline, machine, model_latency)
    return sim.best_allocation()


def _oracle_point(trainer, cap: int):
    alloc, tput = _oracle_cached(trainer.pipeline, trainer.machine.mem_mb,
                                 trainer.model_latency, int(cap))
    return alloc.copy(), tput   # never hand out the cached (mutable) alloc


def _even_grants(pool: int, names) -> dict:
    """Pool split evenly over active machines, remainder round-robin."""
    names = list(names)
    if not names:
        return {}
    base, rem = divmod(int(pool), len(names))
    return {n: base + (1 if i < rem else 0) for i, n in enumerate(names)}


def fleet_even(cluster, state, seed: int = 0):
    """Fleet-even: every active machine gets the same pool share, then the
    single-machine even heuristic places workers — blind to machine size,
    pipeline shape, and model demand."""
    from repro_torch.data.fleet import FleetAllocation
    grants = _even_grants(state.pool, state.active)
    allocs = {n: heuristic_even(
        cluster.trainer(n).pipeline,
        _eff_machine(cluster.trainer(n), state.base(n) + grants[n]))
        for n in state.active}
    return FleetAllocation(allocs, grants)


def fleet_proportional(cluster, state, seed: int = 0):
    """Fleet-proportional: pool shares proportional to each machine's total
    true pipeline cost (a demand proxy), per-machine Plumber-style LP
    placement. Better informed than even, but no model-demand awareness:
    a machine whose model is already saturated still draws its share."""
    from repro_torch.data.fleet import FleetAllocation
    names = list(state.active)
    grants = {n: 0 for n in names}
    if names and state.pool:
        costs = np.array([sum(s.cost for s in
                              cluster.trainer(n).pipeline.stages)
                          for n in names])
        frac = state.pool * costs / costs.sum()
        floor = np.floor(frac).astype(int)
        order = np.argsort(-(frac - floor))
        rem = int(state.pool - floor.sum())
        for k in order[:rem]:
            floor[k] += 1
        grants = {n: int(g) for n, g in zip(names, floor)}
    allocs = {n: plumber_like(
        cluster.trainer(n).pipeline,
        _eff_machine(cluster.trainer(n), state.base(n) + grants[n]), seed)
        for n in state.active}
    return FleetAllocation(allocs, grants)


def fleet_local_oracle(cluster, state, seed: int = 0):
    """Per-machine oracle, no coordination: each machine water-fills its
    OWN CPUs perfectly but nobody arbitrates the shared pool, so it sits
    idle — the upper bound on what uncoordinated per-machine tuning buys."""
    from repro_torch.data.fleet import FleetAllocation
    allocs = {n: _oracle_point(cluster.trainer(n), state.base(n))[0]
              for n in state.active}
    return FleetAllocation(allocs, {})


def fleet_oracle(cluster, state, seed: int = 0):
    """Fleet oracle: greedy marginal-throughput water-filling of the shared
    pool (each pool CPU goes to the machine whose oracle throughput gains
    most from +1 cap; per-machine rates are concave so greedy is optimal),
    then the per-machine oracle at the granted cap. The cluster-level
    reference every fleet policy is scored against."""
    from repro_torch.data.fleet import FleetAllocation
    grants = {n: 0 for n in state.active}
    for _ in range(int(state.pool)):
        best_gain, best_name = 1e-12, None
        for n in state.active:
            t = cluster.trainer(n)
            cap = state.base(n) + grants[n]
            gain = _oracle_point(t, cap + 1)[1] - _oracle_point(t, cap)[1]
            if gain > best_gain:
                best_gain, best_name = gain, n
        if best_name is None:
            break               # every machine saturated: leave pool idle
        grants[best_name] += 1
    allocs = {n: _oracle_point(cluster.trainer(n),
                               state.base(n) + grants[n])[0]
              for n in state.active}
    return FleetAllocation(allocs, grants)


# ---------------------------------------------------------------------------
# Market layer (multi-job pool auction). A MarketSpec partitions the
# trainers into jobs with bid weights and anti-starvation floors; the
# auction below is the pricing rule PoolMarket
# (repro.core.fleet_coordinator) and the market baselines share.
# ---------------------------------------------------------------------------

def _job_partition(cluster, state):
    """[(job name, weight, floor, [active member names])] for every job
    with at least one active member, in spec (jobs) order. A plain
    ClusterSpec — or a MarketSpec with `jobs=()` — makes every trainer
    its own weight-1, floor-0 job, under which the market degrades to
    exactly the per-trainer greedy arbiter (`fleet_oracle`)."""
    jobs = getattr(cluster, "jobs", ()) or ()
    if not jobs:
        return [(n, 1.0, 0, [n]) for n in state.active]
    out = []
    for j in jobs:
        members = [n for n in state.active if n in set(j.trainers)]
        if members:
            out.append((j.name, j.weight, j.floor, members))
    return out


def market_grants(cluster, state) -> dict:
    """Cross-job marginal-throughput pricing: per-trainer pool grants.

    Two passes. FLOORS first: every active job is owed min(floor,
    remaining pool) cores unconditionally (anti-starvation), each core
    placed at the job's own best-marginal member. Then the AUCTION: each
    remaining core goes to the job with the highest bid
    `weight * (best member's marginal oracle throughput for +1 cap)`,
    granted to that member. Per-member rates are concave, so within a
    job the greedy placement is optimal; across jobs the weights price
    priority. Deterministic: jobs bid in spec order, members in active
    order, strict > to dethrone — so equal bids resolve to the earlier
    job/member and a re-run of the same state reproduces the same grants
    (the re-auction idempotence the property suite pins)."""
    jobs = _job_partition(cluster, state)
    grants = {n: 0 for n in state.active}

    def best_marginal(members):
        best_gain, best_name = -1.0, None
        for n in members:
            t = cluster.trainer(n)
            cap = state.base(n) + grants[n]
            gain = _oracle_point(t, cap + 1)[1] - _oracle_point(t, cap)[1]
            if gain > best_gain:
                best_gain, best_name = gain, n
        return best_gain, best_name

    pool = int(state.pool)
    for _, _, floor, members in jobs:
        for _ in range(min(int(floor), pool)):
            _, name = best_marginal(members)
            grants[name] += 1
            pool -= 1
    while pool > 0:
        best_bid, winner = 1e-12, None
        for _, weight, _, members in jobs:
            gain, name = best_marginal(members)
            bid = weight * gain
            if bid > best_bid:
                best_bid, winner = bid, name
        if winner is None:
            break               # every job saturated: leave pool idle
        grants[winner] += 1
        pool -= 1
    return grants


def market_local_oracle(cluster, state, seed: int = 0):
    """Per-JOB local oracle, no cross-job arbitration: the pool is split
    evenly across active jobs (blind to weights, floors, and demand),
    then each job water-fills its share over its own members perfectly.
    The market analog of `fleet_local_oracle` — what perfect per-job
    tuning buys when nobody prices the pool across jobs."""
    from repro_torch.data.fleet import FleetAllocation
    jobs = _job_partition(cluster, state)
    grants = {n: 0 for n in state.active}
    shares = _even_grants(state.pool, [j[0] for j in jobs])
    for jname, _, _, members in jobs:
        for _ in range(shares.get(jname, 0)):
            best_gain, best = 1e-12, None
            for n in members:
                t = cluster.trainer(n)
                cap = state.base(n) + grants[n]
                gain = _oracle_point(t, cap + 1)[1] \
                    - _oracle_point(t, cap)[1]
                if gain > best_gain:
                    best_gain, best = gain, n
            if best is None:
                break           # job saturated: its share goes unused
            grants[best] += 1
    allocs = {n: _oracle_point(cluster.trainer(n),
                               state.base(n) + grants[n])[0]
              for n in state.active}
    return FleetAllocation(allocs, grants)


def market_oracle(cluster, state, seed: int = 0):
    """The market reference: weighted cross-job auction grants + the
    per-machine oracle placement at each granted cap. On a spec without
    jobs (or uniform weights, zero floors, one job) this reproduces
    `fleet_oracle` exactly."""
    from repro_torch.data.fleet import FleetAllocation
    grants = market_grants(cluster, state)
    allocs = {n: _oracle_point(cluster.trainer(n),
                               state.base(n) + grants[n])[0]
              for n in state.active}
    return FleetAllocation(allocs, grants)


FLEET_BASELINES = {
    "fleet_even": fleet_even,
    "fleet_proportional": fleet_proportional,
    "fleet_local_oracle": fleet_local_oracle,
    "fleet_oracle": fleet_oracle,
    "market_local_oracle": market_local_oracle,
    "market_oracle": market_oracle,
}
