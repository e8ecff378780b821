"""FleetCoordinator: InTune at cluster granularity.

One InTune DQN agent per trainer (reusing the per-length pretrained
weights), with a coordinator arbitrating the shared elastic CPU pool
above them. It speaks the Optimizer protocol against any fleet backend
(`repro.api.Session` drives it over FleetSimBackend or LiveFleetBackend):

    falloc = coord.propose(cluster, fleet_state)   # FleetAllocation
    telemetry = backend.apply(falloc)
    coord.observe(telemetry)                        # routes per-trainer

Coordinator responsibilities (the cluster plane; each InTune keeps owning
its machine's per-stage placement):

  - POOL ARBITRATION: greedy marginal-throughput exchange — pool CPUs are
    water-filled to the machines whose analytic oracle curve gains most
    from +1 cap (the same model InTune's own env uses for reward
    scaling). Grants are re-fit on churn and every `rebalance_every`
    ticks, but only applied when the plan beats the current split by
    `rebalance_tol` — a granted-cap change re-opens that trainer's
    exploration window (InTune's resize behavior), so flapping is worse
    than a slightly stale split.
  - CHURN RE-TUNING: a FleetState change (join / leave / machine resize /
    pool re-cap) re-plans grants; affected trainers see a new effective
    cap and re-open their tuning windows (the controller's serve-best /
    reopen logic), while untouched trainers keep serving their best.
  - OOM PROTECTION: admission control clamps any proposal whose analytic
    memory footprint exceeds `mem_headroom` of the machine (prefetch
    shrinks first, then workers shed from the most-replicated stage), and
    an observed OOM quarantines the trainer — it serves the safe oracle
    allocation with exploration frozen for `quarantine_ticks`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np

from repro_torch.core import baselines as B
from repro_torch.core.controller import InTune
from repro_torch.data.fleet import ClusterSpec, FleetAllocation, FleetState
from repro_torch.data.simulator import Allocation, graph_memory_mb

if TYPE_CHECKING:   # annotation-only: keep the core plane below repro.api
    from repro_torch.api.telemetry import Telemetry


def clamp_to_memory(pipeline, alloc: Allocation, mem_mb: float,
                    headroom: float = 0.9) -> Allocation:
    """Admission control: shrink an allocation until its analytic memory
    footprint fits within headroom * mem_mb. Prefetch gives first (down
    to one batch, or its current value if already below that), then
    workers shed from the most-replicated stage (never below 1 per
    stage). If even the minimal allocation exceeds the budget the
    machine fundamentally cannot run within headroom — the minimal
    allocation is returned; there is nothing left to shed."""
    budget = headroom * mem_mb

    def used(workers, prefetch):
        # the simulator's own memory model: the guard and the OOM judge
        # share one definition and cannot diverge
        return graph_memory_mb(pipeline, workers, prefetch)

    workers = alloc.workers.copy()
    prefetch = alloc.prefetch_mb
    if used(workers, prefetch) <= budget:
        return alloc
    need = used(workers, prefetch) - budget
    # the floor never raises prefetch above what the proposal asked for
    prefetch = max(min(prefetch, pipeline.batch_mb), prefetch - need)
    while used(workers, prefetch) > budget and workers.max() > 1:
        workers[int(np.argmax(workers))] -= 1
    return Allocation(workers, prefetch)


class FleetCoordinator:
    """Cluster-granularity Optimizer: per-trainer InTune + pool arbitration.

    `pretrained` maps pipeline length -> agent state_dict (the cached
    offline-pretrained weights; see benchmarks.common.get_agent_state).
    A length with no entry starts that trainer's agent from scratch.
    """

    name = "fleet_intune"

    def __init__(self, cluster: ClusterSpec,
                 pretrained: Optional[Dict[int, dict]] = None,
                 seed: int = 0, head: str = "factored",
                 finetune_ticks: int = 150,
                 rebalance_every: int = 100, rebalance_tol: float = 1.02,
                 mem_headroom: float = 0.95, mem_guard: bool = True,
                 quarantine_ticks: int = 40,
                 measure_anchor: bool = False):
        self.cluster = cluster
        self.pretrained = pretrained or {}
        self.seed = seed
        self.head = head
        self.finetune_ticks = finetune_ticks
        self.rebalance_every = rebalance_every
        self.rebalance_tol = rebalance_tol
        self.mem_headroom = mem_headroom
        self.mem_guard = mem_guard
        self.quarantine_ticks = quarantine_ticks
        self.measure_anchor = measure_anchor
        self.tuners: Dict[str, InTune] = {}
        self.grants: Dict[str, int] = {}
        self.quarantine: Dict[str, int] = {}
        self.history: list = []
        self._last_key = None
        self._tick = 0
        self._last_active: tuple = ()

    # ------------------------------------------------------ arbitration ---
    def _plan_grants(self, state: FleetState) -> Dict[str, int]:
        """Greedy marginal-throughput water-filling of the pool over the
        active machines' analytic oracle curves."""
        plan = B.fleet_oracle(self.cluster, state)
        return plan.grants

    def _planned_tput(self, state: FleetState, grants: Dict[str, int]) -> float:
        return sum(B._oracle_point(self.cluster.trainer(n),
                                   state.base(n) + grants.get(n, 0))[1]
                   for n in state.active)

    def _arbitrate(self, state: FleetState):
        """Re-fit pool grants. Mandatory on churn (the active set or caps
        changed — stale grants may not even fit the pool); on periodic
        checks the new split must clear `rebalance_tol` to be applied."""
        churned = state.key() != self._last_key
        periodic = (self.rebalance_every > 0
                    and self._tick % self.rebalance_every == 0)
        if not (churned or periodic or not self.grants):
            return
        plan = self._plan_grants(state)
        if not churned and self.grants:
            cur = {n: self.grants.get(n, 0) for n in state.active}
            if self._planned_tput(state, plan) \
                    < self.rebalance_tol * self._planned_tput(state, cur):
                return          # not worth re-opening tuning windows
        self.grants = plan
        self._last_key = state.key()

    def _warm_start(self, name: str, tuner: InTune, trainer, eff: int):
        """Anchor a tuner's exploration at the planner's (memory-clamped)
        oracle point for its current effective cap. The DQN still owns the
        walk from there — the warm start just means re-tuning starts from
        the arbitration model's best guess instead of an even split, the
        same way the controller's serve-best snaps exploration back to the
        incumbent best."""
        safe = clamp_to_memory(trainer.pipeline,
                               B._oracle_point(trainer, eff)[0],
                               trainer.machine.mem_mb, self.mem_headroom)
        tuner.env.set_allocation(safe)
        tuner.obs = tuner.env.observe()
        if self.measure_anchor:
            # measure the anchor ITSELF before the eps-walk moves off
            # it: serve-best picks from MEASURED allocations only, so
            # without this the planner's point can never be served even
            # when the walk finds nothing better (the controller's own
            # launch-tick hold, re-armed for every re-anchor). Off by
            # default — it shifts the exploration trajectory, and the
            # single-job coordinator's published runs (fig7) are pinned
            # on the unheld one; the market turns it on for its per-job
            # inners, where every budget move re-anchors a machine and
            # an unmeasured anchor systematically starves serve-best.
            tuner._hold_first = True

    # --------------------------------------------------------- protocol ---
    def propose(self, cluster: ClusterSpec = None,
                state: FleetState = None,
                stats: Optional[dict] = None) -> FleetAllocation:
        if cluster is not None and cluster is not self.cluster \
                and cluster != self.cluster:
            raise ValueError("FleetCoordinator was built for cluster "
                             f"{self.cluster.name!r}")
        assert state is not None, "propose needs the FleetState"
        self._arbitrate(state)
        allocs: Dict[str, Allocation] = {}
        grants = {n: int(self.grants.get(n, 0)) for n in state.active}
        for name in state.active:
            trainer = self.cluster.trainer(name)
            eff = state.base(name) + grants[name]
            machine = dataclasses.replace(trainer.machine, n_cpus=eff)
            tuner = self.tuners.get(name)
            if tuner is None:
                tuner = InTune(
                    trainer.pipeline, machine, trainer.model_latency,
                    seed=self.seed + len(self.tuners), head=self.head,
                    pretrained=self.pretrained.get(
                        trainer.pipeline.n_stages),
                    finetune_ticks=self.finetune_ticks)
                self.tuners[name] = tuner
                self._warm_start(name, tuner, trainer, eff)
            elif eff != tuner.env.sim.machine.n_cpus:
                # churn / re-arbitration changed this machine's effective
                # cap: re-open its tuning window anchored at the planner's
                # point for the new cap (serve-best/reopen, coordinated)
                tuner.resize(eff)
                self._warm_start(name, tuner, trainer, eff)
            if self.quarantine.get(name, 0) > 0:
                # quarantined: serve the safe oracle allocation, keep the
                # agent frozen (no pending transition -> observe no-ops)
                self.quarantine[name] -= 1
                if self.quarantine[name] == 0:
                    # re-admission next tick: force a pool re-arbitration
                    # so the returning trainer's grant is re-fit against
                    # the machines that absorbed the pool meanwhile
                    self._last_key = None
                safe = clamp_to_memory(
                    trainer.pipeline, B._oracle_point(trainer, eff)[0],
                    trainer.machine.mem_mb, self.mem_headroom)
                tuner.env.alloc = safe.copy()
                tuner._pending = None
                allocs[name] = safe
                continue
            alloc = tuner.propose(trainer.pipeline, machine)
            if self.mem_guard:
                clamped = clamp_to_memory(trainer.pipeline, alloc,
                                          trainer.machine.mem_mb,
                                          self.mem_headroom)
                if clamped is not alloc:
                    # keep the tuner's notion of "what ran" consistent
                    tuner.env.alloc = clamped.copy()
                    alloc = clamped
            allocs[name] = alloc
        self._tick += 1
        self._last_active = state.active
        return FleetAllocation(allocs, grants)

    def observe(self, metrics: Telemetry) -> None:
        per = metrics.get("per_trainer")
        if per is None:
            return              # fleet-wide dead window: nothing ran
        for name, m in per.items():
            tuner = self.tuners.get(name)
            if tuner is None:
                continue
            # the tuner always sees the outcome first — an OOM tick is the
            # paper's strongest learning signal (reward collapses to 0) —
            # then the coordinator quarantines the machine
            tuner.observe(m)
            if m.get("oom"):
                self.quarantine[name] = self.quarantine_ticks
        self.history.append({
            "throughput": metrics["throughput"],
            "n_active": metrics.get("n_active", len(per)),
            "oom": metrics.get("oom", False),
            "grants": dict(self.grants)})

    # ------------------------------------------------------ persistence ---
    def state_dict(self) -> dict:
        return {"grants": dict(self.grants),
                "tuners": {n: t.state_dict()
                           for n, t in self.tuners.items()}}

    def load_state_dict(self, state: dict):
        self.grants = dict(state["grants"])
        for name, s in state["tuners"].items():
            if name in self.tuners:
                self.tuners[name].load_state_dict(s)


class _JobOracle:
    """Deterministic static per-job inner optimizer: serves the fleet
    oracle for the job's sub-state, re-fit only when the sub-state
    churns. The PoolMarket default — cheap (lru-cached oracle curves),
    seedless, and byte-stable, which is what the golden-trace and
    property suites want under the market."""

    name = "job_oracle"

    def __init__(self, cluster: ClusterSpec, seed: int = 0):
        self.cluster = cluster
        self._key = None
        self._cached: Optional[FleetAllocation] = None

    def propose(self, cluster=None, state: FleetState = None,
                stats=None) -> FleetAllocation:
        if self._cached is None or state.key() != self._key:
            self._cached = B.fleet_oracle(self.cluster, state)
            self._key = state.key()
        return self._cached.copy()

    def observe(self, metrics) -> None:
        pass


class PoolMarket:
    """The market layer: multiple concurrent training jobs bidding for
    one shared elastic CPU pool.

    The per-trainer greedy arbiter (`fleet_oracle`) already computes
    marginal-throughput prices; this lifts it across jobs — each pool
    core is auctioned to the job with the highest
    `weight * best-member-marginal` bid (after anti-starvation floors
    are honored), then each job's budget is handed to that job's OWN
    inner optimizer as its sub-fleet pool. The inner water-fills (or
    RL-tunes, with `inner="fleet_intune"`) within the budget, so
    conservation holds by construction: merged grants never exceed the
    auctioned budgets, which never exceed the pool.

    Re-auction is churn-safe: budgets are cached on `state.key()` — the
    auction only re-runs when the fleet state actually changes (job
    member join/leave, machine resize, pool re-cap) or when a member
    OOMs (its quarantine reshapes the job's real demand, so the pool is
    re-priced). Under no churn the auction is idempotent — same state,
    same grants, no flapping (re-opening a tuning window costs more
    than a slightly stale split, same reasoning as the coordinator's
    `rebalance_tol`).

    Speaks the fleet Optimizer protocol, so Session + any fleet backend
    (FleetSim / LiveFleet / ProcFleet) drive it unchanged.
    """

    name = "market"

    def __init__(self, market: ClusterSpec, inner: str = "job_oracle",
                 pretrained: Optional[Dict[int, dict]] = None,
                 seed: int = 0, **inner_kw):
        from repro_torch.data.fleet import JobSpec
        self.market = market
        jobs = tuple(getattr(market, "jobs", ()) or ())
        if not jobs:
            # a job-less spec: every trainer is its own weight-1 job,
            # and the market degrades to the per-trainer greedy arbiter
            jobs = tuple(JobSpec(t.name, (t.name,))
                         for t in market.trainers)
        self.jobs = jobs
        self.inner: Dict[str, object] = {}
        for i, j in enumerate(jobs):
            sub = ClusterSpec(
                name=f"{market.name}/{j.name}",
                trainers=tuple(market.trainer(n) for n in j.trainers),
                shared_pool=market.shared_pool)
            if inner == "fleet_intune":
                # per-job coordinators measure their warm-start anchors:
                # every auction budget move re-anchors machines, and a
                # never-measured anchor can't be served (see _warm_start)
                kw = dict(inner_kw)
                kw.setdefault("measure_anchor", True)
                self.inner[j.name] = FleetCoordinator(
                    sub, pretrained=pretrained, seed=seed + i, **kw)
            elif inner == "job_oracle":
                self.inner[j.name] = _JobOracle(sub, seed=seed + i)
            else:
                raise ValueError(f"unknown inner optimizer {inner!r}; "
                                 "known: job_oracle, fleet_intune")
        self.budgets: Dict[str, int] = {}
        self.history: list = []
        self._last_key = None
        self._force_reauction = False

    # ---------------------------------------------------------- auction ---
    def _auction(self, state: FleetState) -> Dict[str, int]:
        """Per-job pool budgets from the weighted marginal-throughput
        auction; cached on state.key() (see class docstring)."""
        if (not self.budgets or self._force_reauction
                or state.key() != self._last_key):
            grants = B.market_grants(self.market, state)
            self.budgets = {
                j.name: sum(grants.get(n, 0) for n in j.trainers)
                for j in self.jobs}
            self._last_key = state.key()
            self._force_reauction = False
        return self.budgets

    # --------------------------------------------------------- protocol ---
    def propose(self, cluster: ClusterSpec = None,
                state: FleetState = None,
                stats: Optional[dict] = None) -> FleetAllocation:
        if cluster is not None and cluster is not self.market \
                and cluster != self.market:
            raise ValueError("PoolMarket was built for cluster "
                             f"{self.market.name!r}")
        assert state is not None, "propose needs the FleetState"
        budgets = self._auction(state)
        allocs: Dict[str, Allocation] = {}
        grants: Dict[str, int] = {}
        for j in self.jobs:
            members = tuple(n for n in state.active if n in set(j.trainers))
            if not members:
                continue
            sub_state = FleetState(
                tick=state.tick, pool=int(budgets.get(j.name, 0)),
                active=members,
                base_cpus=tuple((n, state.base(n)) for n in members))
            fa = self.inner[j.name].propose(None, sub_state, stats)
            allocs.update(fa.allocs)
            for n in members:
                grants[n] = int(fa.grants.get(n, 0))
        return FleetAllocation(allocs, grants)

    def observe(self, metrics) -> None:
        per = metrics.get("per_trainer")
        if per is None:
            return              # fleet-wide dead window: nothing ran
        any_oom = False
        for j in self.jobs:
            members = set(j.trainers)
            sub = {n: m for n, m in per.items() if n in members}
            if not sub:
                continue
            oom = any(m.get("oom") for m in sub.values())
            any_oom = any_oom or oom
            self.inner[j.name].observe({
                "per_trainer": sub,
                "throughput": sum(m["throughput"] for m in sub.values()),
                "n_active": len(sub),
                "oom": oom})
        if any_oom:
            # OOM-quarantine churn: the killed member's job will serve a
            # clamped safe point for a while — re-price the pool against
            # the fleet's real demand next tick
            self._force_reauction = True
        self.history.append({
            "throughput": metrics["throughput"],
            "oom": metrics.get("oom", False),
            "budgets": dict(self.budgets)})

    # ------------------------------------------------------ persistence ---
    def state_dict(self) -> dict:
        return {"budgets": dict(self.budgets),
                "inner": {name: opt.state_dict()
                          for name, opt in self.inner.items()
                          if hasattr(opt, "state_dict")}}

    def load_state_dict(self, state: dict):
        self.budgets = dict(state["budgets"])
        for name, s in state.get("inner", {}).items():
            if name in self.inner and hasattr(self.inner[name],
                                              "load_state_dict"):
                self.inner[name].load_state_dict(s)
