"""String-keyed registries + the one-liner: `repro_torch.api.tune(...)`.

    from repro_torch.api import tune
    from repro_torch.data.pipeline import criteo_pipeline
    from repro_torch.data.simulator import MachineSpec

    res = tune(criteo_pipeline(), MachineSpec(n_cpus=64),
               optimizer="intune", backend="sim", ticks=300)

The backend name picks the substrate KIND; the spec type picks the
plane: a StageGraph runs on PipelineSim ("sim") or a real
ThreadedPipeline ("live"/"executor"); a ClusterSpec runs on FleetSim
("sim") or LiveFleet ("live"). Optimizer names come from the existing
registries (`make_optimizer` / `make_fleet_optimizer`): "intune",
"oracle", "autotune", ... and "fleet_intune", "fleet_even", ... — or
pass a constructed Optimizer instance directly.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

from repro_torch.api.backend import Backend
from repro_torch.api.backends import (ExecutorBackend, FleetSimBackend,
                                      LiveFleetBackend, ProcessBackend,
                                      ProcFleetBackend, SimBackend)
from repro_torch.api.session import Session
from repro_torch.api.telemetry import RunResult
from repro_torch.data.fleet import ClusterSpec

# (plane, name) -> adapter class. "executor" is an alias for "live" on
# both planes; registering here is all a new substrate needs to be
# reachable from tune().
BACKENDS = {
    ("single", "sim"): SimBackend,
    ("single", "live"): ExecutorBackend,
    ("single", "proc"): ProcessBackend,
    ("fleet", "sim"): FleetSimBackend,
    ("fleet", "live"): LiveFleetBackend,
    ("fleet", "proc"): ProcFleetBackend,
}
_ALIASES = {"executor": "live", "process": "proc"}


def make_backend(name: str, spec: Any, machine: Any = None, *,
                 seed: int = 0, **kw: Any) -> Backend:
    """Build a registered backend for `spec` (StageGraph or ClusterSpec).
    Extra keyword args go to the adapter (window_s, obs_noise, ...)."""
    plane = "fleet" if isinstance(spec, ClusterSpec) else "single"
    key = (plane, _ALIASES.get(name, name))
    if key not in BACKENDS:
        known = sorted({n for p, n in BACKENDS if p == plane}
                       | {a for a, t in _ALIASES.items()
                          if (plane, t) in BACKENDS})
        raise KeyError(f"unknown {plane} backend {name!r}; known: {known}")
    cls = BACKENDS[key]
    if plane == "fleet":
        if machine is not None:
            raise TypeError(
                f"backend {name!r} over a ClusterSpec carries its own "
                f"per-trainer machines; machine={machine!r} would be "
                f"silently ignored — drop it")
        return cls(spec, seed=seed, **kw)
    if machine is None:
        raise TypeError(
            f"backend {name!r} over a StageGraph needs a MachineSpec "
            f"(got machine=None); only ClusterSpec backends carry their "
            f"own machines")
    return cls(spec, machine, seed=seed, **kw)


def tune(spec: Any, machine: Any = None, *,
         optimizer: Union[str, Any] = "intune", backend: str = "sim",
         ticks: int = 600, seed: int = 0,
         events: Optional[Sequence[Any]] = None,
         relaunch_dead: int = 0,
         collect: Optional[Callable[..., None]] = None,
         optimizer_kw: Optional[dict] = None,
         backend_kw: Optional[dict] = None) -> RunResult:
    """One line from spec to tuned run: build the backend and the
    optimizer by name, drive them through a Session, tear down, and
    return the RunResult (live accounting under `extras["live"]`, the
    optimizer instance under `extras["optimizer"]`)."""
    # resolve the optimizer FIRST: a bad name/kw must fail before a live
    # backend spawns threads it would then leak
    if isinstance(optimizer, str):
        if isinstance(spec, ClusterSpec):
            from repro_torch.core.optimizer import make_fleet_optimizer
            opt = make_fleet_optimizer(optimizer, spec, seed=seed,
                                       **(optimizer_kw or {}))
        else:
            from repro_torch.core.optimizer import make_optimizer
            opt = make_optimizer(optimizer, spec, machine, seed=seed,
                                 **(optimizer_kw or {}))
    else:
        opt = optimizer
    be = make_backend(backend, spec, machine, seed=seed,
                      **(backend_kw or {}))
    try:
        res = Session(be, opt, spec=spec).run(
            ticks, events=events, relaunch_dead=relaunch_dead,
            collect=collect)
    finally:
        acct = be.shutdown()
    if acct:
        res.extras["live"] = acct
    return res
