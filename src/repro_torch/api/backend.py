"""The Backend protocol: one runtime surface for every substrate.

EVERY substrate the package can run — the analytic `PipelineSim`, the
threaded executor, the process pipeline, the analytic `FleetSim`, the
live fleets, the train-loop feed — is driven through this one protocol
via a thin adapter (repro_torch.api.backends), and `Session` is the only
driver loop:

    apply(alloc) -> Telemetry   advance one tick under the allocation
    inject(event)               ResizeEvent / ChurnEvent (fleet only)
    skip_tick() -> Telemetry    advance the clock through a dead window
                                (the process is down; nothing runs)
    snapshot() -> dict          deterministic state summary (seeded
                                backends: byte-stable across same-seed
                                replays; live backends: best-effort)
    shutdown() -> dict          idempotent teardown; live backends return
                                their drop/leak accounting
    machine                     what proposals are made against
                                (MachineSpec or FleetState)
    capacity                    total CPUs placeable right now
    oom_count                   cumulative OOM kills

`BackendBase` supplies the shared behavior: dead-tick telemetry,
shutdown idempotence (the first teardown's accounting is cached and
returned on every later call), and the default event dispatch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, runtime_checkable

from repro_torch.api.events import ChurnEvent, Event, ResizeEvent
from repro_torch.api.telemetry import Telemetry


class UnsupportedEventError(TypeError):
    """The backend cannot realize this event kind (e.g. ChurnEvent on a
    single-machine backend)."""


@runtime_checkable
class Backend(Protocol):
    """What `Session` drives. See module docstring for the contract."""

    def apply(self, alloc: Any) -> Telemetry: ...

    def inject(self, event: Event) -> None: ...

    def stats(self) -> Optional[Dict[str, Any]]: ...

    def skip_tick(self) -> Telemetry: ...

    def snapshot(self) -> Dict[str, Any]: ...

    def shutdown(self) -> Dict[str, Any]: ...

    @property
    def machine(self) -> Any: ...

    @property
    def capacity(self) -> int: ...

    @property
    def oom_count(self) -> int: ...


class BackendBase:
    """Shared adapter behavior: idempotent shutdown, dead ticks, event
    dispatch. Subclasses implement `apply`, `_resize`, `_advance_clock`,
    `snapshot`, and the three properties; fleet-capable ones override
    `_churn`."""

    def __init__(self) -> None:
        self._shutdown_acct: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ events --
    def inject(self, event: Event) -> None:
        if isinstance(event, ResizeEvent):
            self._resize(int(event.n_cpus))
        elif isinstance(event, ChurnEvent):
            self._churn(event)
        else:
            raise UnsupportedEventError(
                f"{type(self).__name__} cannot inject "
                f"{type(event).__name__} (DeadWindow events are handled "
                f"by the Session, not the backend)")

    def _resize(self, n_cpus: int) -> None:
        raise NotImplementedError

    def _churn(self, event: ChurnEvent) -> None:
        raise UnsupportedEventError(
            f"{type(self).__name__} is a single-machine backend; "
            f"ChurnEvent ({event.kind!r}) needs a fleet backend")

    # ------------------------------------------------------ observations --
    def stats(self) -> Optional[Dict[str, Any]]:
        """Live measurement stats for the optimizer's `propose(...,
        stats=...)` hook (the executor stats() contract). Analytic
        backends return None — policies then observe through their own
        model, which is the legacy sim-path behavior."""
        return None

    # ------------------------------------------------------- dead window --
    def skip_tick(self) -> Telemetry:
        """One tick with the pipeline process down: the clock advances
        (churn schedules keep firing on time) but nothing is applied."""
        self._advance_clock()
        return Telemetry.dead_tick()

    def _advance_clock(self) -> None:
        raise NotImplementedError

    # ---------------------------------------------------------- teardown --
    def shutdown(self) -> Dict[str, Any]:
        """Idempotent: the first call tears down and caches its
        accounting; every later call returns the same dict."""
        if self._shutdown_acct is None:
            self._shutdown_acct = self._do_shutdown()
        return self._shutdown_acct

    def _check_open(self) -> None:
        """Adapters call this at the top of apply(): running a torn-down
        backend is a named error on every substrate, not an
        AttributeError from whichever resource happened to be freed."""
        if self._shutdown_acct is not None:
            raise RuntimeError(
                f"{type(self).__name__} is shut down; build a fresh "
                f"backend to run again")

    def _do_shutdown(self) -> Dict[str, Any]:
        return {}

    def __enter__(self) -> "BackendBase":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()
