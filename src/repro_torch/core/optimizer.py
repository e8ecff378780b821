"""The Optimizer protocol: one interface for every allocation policy.

Before this module, the five baselines were bare functions
`fn(spec, machine[, seed]) -> Allocation` while InTune was a stateful
class with its own tick loop, and every benchmark special-cased the two.
Now everything that places CPUs over a StageGraph speaks one protocol:

    propose(spec, machine, stats=None) -> Allocation
        The allocation the policy wants next. `stats` carries live
        measurements (the executor's stats() dict or a simulator
        observation); one-shot policies ignore it.
    observe(telemetry) -> None
        Feedback for the proposal just applied: the backend's typed
        `repro.api.Telemetry` (mapping-compatible, so policies written
        against the legacy metrics-dict dialect keep working). Learning
        policies train on it; static ones no-op.

The one driver is `repro.api.Session`: it loops propose -> apply ->
observe against any Backend without knowing which policy runs. Static
baselines re-propose on a machine resize (the paper's *-Adaptive
relaunch behavior is the driver charging a dead window for that).
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Callable, Optional, Protocol, 
                    runtime_checkable)

from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import Allocation, MachineSpec

if TYPE_CHECKING:   # annotation-only: keep the core plane below repro.api
    from repro_torch.api.telemetry import Telemetry


@runtime_checkable
class Optimizer(Protocol):
    name: str

    def propose(self, spec: StageGraph, machine: MachineSpec,
                stats: Optional[dict] = None) -> Allocation:
        ...

    def observe(self, metrics: Telemetry) -> None:
        ...


class StaticOptimizer:
    """Adapts a one-shot baseline fn to the protocol.

    Proposes once and caches the Allocation; a machine change invalidates
    the cache (the relaunch-to-adapt behavior). Seeded policies re-profile
    on each such relaunch — the seed advances so every launch carries
    fresh one-shot measurement noise, which is part of their model.
    """

    def __init__(self, name: str, fn: Callable, *, seeded: bool = False,
                 seed: int = 0):
        self.name = name
        self._fn = fn
        self._seeded = seeded
        self._seed = seed
        self._key = None
        self._alloc: Optional[Allocation] = None

    def propose(self, spec: StageGraph, machine: MachineSpec,
                stats: Optional[dict] = None) -> Allocation:
        # spec is hashable (frozen dataclass): a changed spec with the
        # same name still invalidates the cache
        key = (spec, machine.n_cpus, machine.mem_mb)
        if self._alloc is None or key != self._key:
            self._key = key
            if self._seeded:
                self._alloc = self._fn(spec, machine, self._seed)
                self._seed += 1  # each (re)launch is a fresh one-shot run
            else:
                self._alloc = self._fn(spec, machine)
        return self._alloc

    def observe(self, metrics: Telemetry) -> None:
        pass


def make_optimizer(name: str, spec: StageGraph, machine: MachineSpec,
                   seed: int = 0, **kw) -> Optimizer:
    """Build any registered optimizer by name ("intune" or a baseline)."""
    if name == "intune":
        from repro_torch.core.controller import InTune
        return InTune(spec, machine, seed=seed, **kw)
    from repro_torch.core import baselines as B
    if name not in B.BASELINES:
        known = ["intune"] + sorted(B.BASELINES)
        raise KeyError(f"unknown optimizer {name!r}; known: {known}")
    return StaticOptimizer(name, B.BASELINES[name],
                           seeded=name in B.SEEDED, seed=seed)


# ---------------------------------------------------------------------------
# Cluster granularity: the same protocol, one level up. A fleet policy's
# propose(cluster, fleet_state) answers with a FleetAllocation and its
# observe gets the fleet backend's aggregate Telemetry — so
# repro.api.Session drives a whole fleet with the identical
# propose -> apply -> observe loop.
# ---------------------------------------------------------------------------

class FleetStaticOptimizer:
    """Adapts a one-shot fleet baseline fn(cluster, state, seed) to the
    protocol. The cache is keyed on FleetState.key(): any churn (join /
    leave / machine resize / pool re-cap) invalidates it, so static fleet
    policies re-propose exactly when a real deployment would relaunch —
    the driver charges that relaunch window via `relaunch_dead`."""

    def __init__(self, name: str, fn: Callable, *, seed: int = 0):
        self.name = name
        self._fn = fn
        self._seed = seed
        self._key = None
        self._falloc = None

    def propose(self, cluster, state, stats: Optional[dict] = None):
        if self._falloc is None or state.key() != self._key:
            self._key = state.key()
            self._falloc = self._fn(cluster, state, self._seed)
            self._seed += 1     # each relaunch is a fresh one-shot run
        return self._falloc

    def observe(self, metrics: Telemetry) -> None:
        pass


def make_fleet_optimizer(name: str, cluster, seed: int = 0, **kw):
    """Build any registered fleet policy: "fleet_intune" (the
    FleetCoordinator), "market" (the cross-job PoolMarket; pass
    `inner="fleet_intune"` for RL-tuned jobs), or a fleet baseline from
    B.FLEET_BASELINES."""
    if name == "fleet_intune":
        from repro_torch.core.fleet_coordinator import FleetCoordinator
        return FleetCoordinator(cluster, seed=seed, **kw)
    if name in ("market", "pool_market"):
        from repro_torch.core.fleet_coordinator import PoolMarket
        return PoolMarket(cluster, seed=seed, **kw)
    from repro_torch.core import baselines as B
    if name not in B.FLEET_BASELINES:
        known = ["fleet_intune", "market"] + sorted(B.FLEET_BASELINES)
        raise KeyError(f"unknown fleet optimizer {name!r}; known: {known}")
    return FleetStaticOptimizer(name, B.FLEET_BASELINES[name], seed=seed)
