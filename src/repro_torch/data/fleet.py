"""Fleet-scale cluster simulator: the plane above the data plane.

The paper's setting is a Netflix compute cluster of many trainer machines
whose ingestion pipelines are tuned independently; its headline numbers
(aggregate ingestion throughput, CPU & GPU utilization) are cluster-level
outcomes. Zhao et al.'s DSI characterization shows production DLRM
ingestion is provisioned fleet-wide, with machines joining and leaving
jobs. This module models that fleet:

  - a ClusterSpec of N heterogeneous TrainerSpecs (each its own
    StageGraph pipeline, MachineSpec, and model demand),
  - a shared elastic CPU pool the cluster plane can grant to machines on
    top of their owned CPUs (sum of grants <= pool),
  - a churn schedule of FleetEvents — machines join, leave, and shrink
    mid-run, and the pool itself can be re-capped — generalizing the
    single-machine `resize_schedule`.

FleetSim runs one PipelineSim per trainer and speaks the same driver
dialect as PipelineSim (`machine` / `apply` / `resize` / `oom_count`), so
`repro.api.Session` drives a fleet policy with the exact
propose -> apply -> observe loop used for single machines. Policies see
the FleetState (active set, per-machine owned CPUs, pool) and answer with
a FleetAllocation (per-trainer Allocation + pool grants).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import Allocation, MachineSpec, PipelineSim

EVENT_KINDS = ("join", "leave", "resize", "pool")


@dataclass(frozen=True)
class TrainerSpec:
    """One trainer machine in the fleet: its pipeline, hardware, and the
    rate its model consumes batches (1/model_latency caps throughput)."""
    name: str
    pipeline: StageGraph
    machine: MachineSpec
    model_latency: float = 0.0
    start_active: bool = True


@dataclass(frozen=True)
class FleetEvent:
    """A churn event: at `tick`, `trainer` joins/leaves the job, its
    machine is resized to `n_cpus`, or (kind="pool") the shared pool is
    re-capped to `n_cpus`."""
    tick: int
    kind: str                    # "join" | "leave" | "resize" | "pool"
    trainer: str = ""            # unused for kind="pool"
    n_cpus: int = 0              # new cap for "resize" / "pool"


@dataclass(frozen=True)
class ClusterSpec:
    """The fleet: trainers + shared elastic CPU pool + churn schedule."""
    name: str
    trainers: Tuple[TrainerSpec, ...]
    shared_pool: int = 0
    events: Tuple[FleetEvent, ...] = ()

    def __post_init__(self):
        names = [t.name for t in self.trainers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate trainer names in {names}")
        if self.shared_pool < 0:
            raise ValueError("shared_pool must be >= 0")
        for ev in self.events:
            if ev.kind not in EVENT_KINDS:
                raise ValueError(f"unknown event kind {ev.kind!r}; "
                                 f"known: {EVENT_KINDS}")
            if ev.kind != "pool" and ev.trainer not in names:
                raise ValueError(
                    f"event {ev.kind!r}@{ev.tick} targets unknown trainer "
                    f"{ev.trainer!r}")
            if ev.kind in ("resize", "pool") and ev.n_cpus < 0:
                raise ValueError(f"event {ev.kind!r}@{ev.tick}: n_cpus < 0")

    def trainer(self, name: str) -> TrainerSpec:
        for t in self.trainers:
            if t.name == name:
                return t
        raise KeyError(name)


@dataclass(frozen=True)
class FleetState:
    """The cluster plane's dynamic view: what a fleet policy proposes
    against. `base_cpus` is each ACTIVE machine's owned CPUs (after any
    resize churn); the pool is granted on top of those."""
    tick: int
    pool: int
    active: Tuple[str, ...]                    # spec order
    base_cpus: Tuple[Tuple[str, int], ...]     # (name, owned cpus), active

    def key(self):
        """Cache key for static policies: everything but the tick."""
        return (self.pool, self.active, self.base_cpus)

    def base(self, name: str) -> int:
        return dict(self.base_cpus)[name]

    @property
    def n_cpus(self) -> int:
        """Total CPUs the fleet can place right now (owned + pool)."""
        return sum(c for _, c in self.base_cpus) + self.pool


@dataclass
class FleetAllocation:
    """Per-trainer pipeline allocations + shared-pool grants.

    The `workers` / `prefetch_mb` views flatten the fleet into the shape
    single-machine drivers compare on (Session's changed-proposal
    check), so the same driver loop serves both planes.
    """
    allocs: Dict[str, Allocation]
    grants: Dict[str, int] = field(default_factory=dict)

    @property
    def workers(self) -> np.ndarray:
        if not self.allocs:
            return np.zeros(0, dtype=int)
        parts = [self.allocs[n].workers for n in sorted(self.allocs)]
        grants = [int(self.grants.get(n, 0)) for n in sorted(self.allocs)]
        return np.concatenate(parts + [np.asarray(grants, dtype=int)])

    @property
    def prefetch_mb(self) -> float:
        return float(sum(a.prefetch_mb for a in self.allocs.values()))

    def copy(self) -> "FleetAllocation":
        return FleetAllocation({n: a.copy() for n, a in self.allocs.items()},
                               dict(self.grants))


class FleetBackend:
    """Shared churn/state machinery for fleet backends.

    Every backend that runs a cluster — the analytic `FleetSim` below and
    the live-executor `repro.data.live_fleet.LiveFleet` — shares this
    base: the owned-CPU / active-set / pool bookkeeping, the event cursor
    (idempotent: it only moves forward), and the driver dialect surface
    (`machine` / `resize` / grant validation). Subclasses hook churn via
    `_on_join` / `_on_leave` (called AFTER the state flip, so the hook
    sees the post-event active set) and implement `apply`.
    """

    def __init__(self, cluster: ClusterSpec):
        self.cluster = cluster
        self.time = 0
        self.pool = cluster.shared_pool
        self._base = {t.name: t.machine.n_cpus for t in cluster.trainers}
        self._active = {t.name: t.start_active for t in cluster.trainers}
        self._events = sorted(cluster.events, key=lambda e: e.tick)
        self._next_event = 0

    # ----------------------------------------------------------- churn ----
    def _on_join(self, name: str):
        pass

    def _on_leave(self, name: str):
        pass

    def _advance_events(self):
        """Apply every event due at or before the current tick (idempotent:
        the cursor only moves forward)."""
        while self._next_event < len(self._events) \
                and self._events[self._next_event].tick <= self.time:
            ev = self._events[self._next_event]
            self._next_event += 1
            if ev.kind == "join":
                self._active[ev.trainer] = True
                self._on_join(ev.trainer)
            elif ev.kind == "leave":
                self._active[ev.trainer] = False
                self._on_leave(ev.trainer)
            elif ev.kind == "resize":
                self._base[ev.trainer] = int(ev.n_cpus)
            elif ev.kind == "pool":
                self.pool = int(ev.n_cpus)

    def inject_event(self, ev: FleetEvent):
        """Dynamically add a churn event to the pending schedule (the
        `repro.api` ChurnEvent injection path). Events already applied
        stay applied; the new event is merged into the not-yet-applied
        tail in tick order (stable, so same-tick events keep their
        injection order). An event whose tick is already past fires on
        the next state read."""
        if ev.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {ev.kind!r}; "
                             f"known: {EVENT_KINDS}")
        if ev.kind != "pool" \
                and not any(t.name == ev.trainer for t in self.cluster.trainers):
            raise ValueError(f"event {ev.kind!r}@{ev.tick} targets unknown "
                             f"trainer {ev.trainer!r}")
        pending = self._events[self._next_event:] + [ev]
        pending.sort(key=lambda e: e.tick)
        self._events = self._events[:self._next_event] + pending

    @property
    def machine(self) -> FleetState:
        self._advance_events()
        active = tuple(t.name for t in self.cluster.trainers
                       if self._active[t.name])
        return FleetState(tick=self.time, pool=self.pool, active=active,
                          base_cpus=tuple((n, self._base[n]) for n in active))

    def resize(self, pool: int):
        self.pool = int(pool)

    def _check_falloc(self, falloc: FleetAllocation, state: FleetState):
        """The grant contract every backend enforces identically."""
        unknown = [n for n in falloc.grants
                   if not any(t.name == n for t in self.cluster.trainers)]
        if unknown:
            raise ValueError(f"grants name unknown trainers {unknown}")
        # grants to inactive trainers consume nothing (stale keys after a
        # leave event are harmless); only active grants draw on the pool
        granted = sum(int(falloc.grants.get(n, 0)) for n in state.active)
        if granted > self.pool:
            raise ValueError(
                f"grants total {granted} exceed shared pool {self.pool}")


class FleetSim(FleetBackend):
    """N per-trainer PipelineSims under a shared pool and churn schedule.

    Speaks the single-machine driver dialect:
      machine   -> FleetState (events due at the current tick are applied
                   first, so policies propose against the post-churn view)
      apply     -> one tick for every active trainer; aggregate metrics
                   plus a "per_trainer" breakdown
      resize(n) -> re-caps the shared pool (the fleet-level analog of a
                   machine resize; per-machine churn goes via events)
    """

    def __init__(self, cluster: ClusterSpec, seed: int = 0,
                 obs_noise: float = 0.02):
        super().__init__(cluster)
        self.sims: Dict[str, PipelineSim] = {
            t.name: PipelineSim(t.pipeline, t.machine, t.model_latency,
                                seed=seed + i, obs_noise=obs_noise)
            for i, t in enumerate(cluster.trainers)}

    def _on_join(self, name: str):
        # a (re)joining machine is a fresh process: no restart debt
        self.sims[name].restart_left = 0

    @property
    def oom_count(self) -> int:
        return sum(s.oom_count for s in self.sims.values())

    # ------------------------------------------------------------ tick ----
    def apply(self, falloc: FleetAllocation) -> dict:
        self._advance_events()
        state = self.machine
        self._check_falloc(falloc, state)
        per: Dict[str, dict] = {}
        tput = mem = used = 0.0
        any_oom = any_restart = False
        for name in state.active:
            sim = self.sims[name]
            eff = self._base[name] + int(falloc.grants.get(name, 0))
            if sim.machine.n_cpus != eff:
                sim.resize(eff)
            if name not in falloc.allocs:
                raise KeyError(
                    f"no allocation proposed for active trainer {name!r}")
            m = sim.apply(falloc.allocs[name])
            m["eff_cpus"] = eff
            per[name] = m
            tput += m["throughput"]
            mem += m["mem_mb"]
            used += min(m["used_cpus"], eff)
            any_oom = any_oom or m["oom"]
            any_restart = any_restart or m["restarting"]
        self.time += 1
        return {"throughput": tput, "mem_mb": mem, "used_cpus": int(used),
                "oom": any_oom, "restarting": any_restart,
                "n_active": len(state.active), "pool": self.pool,
                "per_trainer": per}


@dataclass(frozen=True)
class JobSpec:
    """One training job bidding in the pool market: a named set of
    member trainers, a bid weight (its marginal throughput is scaled by
    `weight` at auction — priority pricing), and an anti-starvation
    `floor` of pool cores it is owed whenever it has an active member."""
    name: str
    trainers: Tuple[str, ...]
    weight: float = 1.0
    floor: int = 0


@dataclass(frozen=True)
class MarketSpec(ClusterSpec):
    """A ClusterSpec whose trainers are partitioned into concurrent
    JOBS competing for the one shared elastic pool (Zhao et al.'s DSI
    setting: many training jobs, one ingestion substrate). With
    `jobs=()` it degrades to a plain ClusterSpec; with jobs, every
    trainer must belong to exactly one job. `isinstance(spec,
    ClusterSpec)` holds, so every fleet backend runs a MarketSpec
    unchanged — jobs only matter to the optimizer layer (PoolMarket)."""
    jobs: Tuple[JobSpec, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        names = {t.name for t in self.trainers}
        jnames = [j.name for j in self.jobs]
        if len(set(jnames)) != len(jnames):
            raise ValueError(f"duplicate job names in {jnames}")
        seen: Dict[str, str] = {}
        for j in self.jobs:
            if j.weight <= 0:
                raise ValueError(f"job {j.name!r}: weight must be > 0")
            if j.floor < 0:
                raise ValueError(f"job {j.name!r}: floor must be >= 0")
            for t in j.trainers:
                if t not in names:
                    raise ValueError(
                        f"job {j.name!r} names unknown trainer {t!r}")
                if t in seen:
                    raise ValueError(
                        f"trainer {t!r} in jobs {seen[t]!r} and {j.name!r}")
                seen[t] = j.name
        if self.jobs and len(seen) != len(names):
            missing = sorted(names - set(seen))
            raise ValueError(f"trainers belong to no job: {missing}")
        if sum(j.floor for j in self.jobs) > self.shared_pool:
            raise ValueError("job floors exceed the shared pool")

    def job(self, name: str) -> JobSpec:
        for j in self.jobs:
            if j.name == name:
                return j
        raise KeyError(name)

    def job_of(self, trainer: str) -> Optional[JobSpec]:
        for j in self.jobs:
            if trainer in j.trainers:
                return j
        return None


def job_events(market: MarketSpec, tick: int, kind: str,
               job: str) -> Tuple[FleetEvent, ...]:
    """Expand JOB-level churn — a whole job joining or leaving the
    cluster — into one FleetEvent per member trainer at `tick` (the
    member events fire in spec order within the tick)."""
    if kind not in ("join", "leave"):
        raise ValueError(
            f"job-level churn is join/leave only, got {kind!r}")
    return tuple(FleetEvent(tick=tick, kind=kind, trainer=t)
                 for t in market.job(job).trainers)


def churn_schedule(total_ticks: int,
                   events: Sequence[Tuple[float, str, str, int]]
                   ) -> Tuple[FleetEvent, ...]:
    """Fleet analog of `resize_schedule`: events placed at fractions of the
    run. Each entry is (frac, kind, trainer, n_cpus); frac in [0, 1)."""
    return tuple(FleetEvent(tick=int(frac * total_ticks), kind=kind,
                            trainer=trainer, n_cpus=n_cpus)
                 for frac, kind, trainer, n_cpus in events)


def demo_cluster(ticks: int = 1200, pool: int = 80) -> ClusterSpec:
    """The canonical 4-machine heterogeneous fleet with churn used by the
    fig7_fleet benchmark, the fleet example, and the acceptance tests.

    Heterogeneity axes: machine size (24-96 owned CPUs), memory (6-64 GB),
    pipeline shape (two linear chains + the multi-source join DAG), and
    model demand (1/model_latency b/s). Two machines carry the production
    pathologies memory-blind policies die on: "small" saturates its model
    with a handful of CPUs (pool grants parked there are pure waste) and
    both "small" and "late" are memory-tight (6 GB), so an even split of
    the pool pushes their per-worker footprint past the physical memory
    line — the Fig. 5B OOM crash-loop, now at fleet scale. Churn: "late"
    joins a third of the way in, "big" shrinks mid-run, "small" leaves
    near the end.
    """
    from repro_torch.data.pipeline import (criteo_pipeline, custom_pipeline,
                                           multisource_dlrm_pipeline)
    trainers = (
        TrainerSpec("big", criteo_pipeline(),
                    MachineSpec(n_cpus=96, mem_mb=65536.0),
                    model_latency=0.02),
        TrainerSpec("mid", custom_pipeline(),
                    MachineSpec(n_cpus=48, mem_mb=32768.0),
                    model_latency=0.04),
        TrainerSpec("small", multisource_dlrm_pipeline(),
                    MachineSpec(n_cpus=24, mem_mb=6144.0),
                    model_latency=0.2),
        TrainerSpec("late", criteo_pipeline(),
                    MachineSpec(n_cpus=64, mem_mb=6144.0),
                    model_latency=0.025, start_active=False),
    )
    events = churn_schedule(ticks, [
        (1 / 3, "join", "late", 0),
        (0.55, "resize", "big", 48),
        (0.80, "leave", "small", 0),
    ])
    return ClusterSpec("demo_fleet4", trainers, shared_pool=pool,
                       events=events)


def big_cluster(n_machines: int = 32, ticks: int = 1200,
                pool: Optional[int] = None, n_jobs: int = 3,
                seed: int = 0) -> MarketSpec:
    """A 32+ machine heterogeneous multi-job cluster (the fig_market
    scale target): per-machine core-count and socket-speed skew à la
    NUMA heterogeneity (Kalamkar et al.), three pipeline shapes, varied
    model demand, memory-tight stragglers, and churn on every axis.
    Deterministic in `seed` — the spec feeds golden-trace tests.

    Speed skew is realized by scaling every stage's true cost by a
    per-machine factor in [0.6, 1.5] (a slow socket makes the SAME
    pipeline more expensive), which also gives each trainer a distinct
    StageGraph identity for the oracle's cache. Trainers are
    partitioned round-robin into `n_jobs` jobs with skewed weights
    (2.0 / 1.0 / 0.5) and small anti-starvation floors.
    """
    from repro_torch.data.pipeline import (criteo_pipeline, custom_pipeline,
                                           multisource_dlrm_pipeline)
    if n_machines < n_jobs:
        raise ValueError("need at least one machine per job")
    rng = np.random.RandomState(seed)
    makers = (criteo_pipeline, custom_pipeline, multisource_dlrm_pipeline)
    core_classes = (16, 24, 32, 48, 64, 96)
    mem_classes = (6144.0, 16384.0, 32768.0, 65536.0)
    latencies = (0.02, 0.025, 0.04, 0.1, 0.2)
    trainers = []
    for i in range(n_machines):
        base = makers[int(rng.randint(len(makers)))]()
        speed = float(0.6 + 0.9 * rng.rand())
        stages = tuple(dataclasses.replace(s, cost=float(s.cost * speed))
                       for s in base.stages)
        pipe = base.replace(name=f"{base.name}@m{i:02d}", stages=stages)
        trainers.append(TrainerSpec(
            name=f"m{i:02d}", pipeline=pipe,
            machine=MachineSpec(
                n_cpus=int(core_classes[rng.randint(len(core_classes))]),
                mem_mb=float(mem_classes[rng.randint(len(mem_classes))])),
            model_latency=float(latencies[rng.randint(len(latencies))]),
            start_active=bool(rng.rand() > 0.15)))
    owned = sum(t.machine.n_cpus for t in trainers)
    if pool is None:
        pool = int(0.25 * owned)
    jobs = tuple(
        JobSpec(name=f"job{j}",
                trainers=tuple(t.name for k, t in enumerate(trainers)
                               if k % n_jobs == j),
                weight=float((2.0, 1.0, 0.5)[j % 3]),
                floor=int((4, 2, 0)[j % 3]))
        for j in range(n_jobs))
    sched = []
    for t in trainers:                      # late joiners arrive mid-run
        if not t.start_active:
            sched.append((float(0.15 + 0.5 * rng.rand()), "join",
                          t.name, 0))
    active = [t for t in trainers if t.start_active]
    for t in [active[int(i)] for i in
              rng.choice(len(active), size=min(3, len(active)),
                         replace=False)]:
        sched.append((float(0.30 + 0.40 * rng.rand()), "resize", t.name,
                      max(8, t.machine.n_cpus // 2)))
    for t in [active[int(i)] for i in
              rng.choice(len(active), size=min(3, len(active)),
                         replace=False)]:
        sched.append((float(0.55 + 0.35 * rng.rand()), "leave", t.name, 0))
    sched.append((0.5, "pool", "", int(pool * 0.75)))
    events = churn_schedule(ticks, sched)
    return MarketSpec(name=f"big_fleet{n_machines}",
                      trainers=tuple(trainers), shared_pool=int(pool),
                      events=events, jobs=jobs)
