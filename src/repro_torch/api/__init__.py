"""repro_torch.api — the single public runtime API (the port of
repro.api, DESIGN.md §8).

One protocol (`Backend`), one driver (`Session`), one event stream
(`ResizeEvent` / `ChurnEvent` / `DeadWindow`), typed per-tick
(`Telemetry`) and per-run (`RunResult`) results, and a string-keyed
one-liner (`tune`). Every substrate — analytic sim, threaded executor,
fleet sim, live fleet — sits behind a thin adapter; nothing above this
package speaks a substrate dialect directly.
"""
from repro_torch.api.backend import Backend, BackendBase, UnsupportedEventError
from repro_torch.api.backends import (ControllerBackend, DialectBackend,
                                      ExecutorBackend, FeedBackend,
                                      FleetSimBackend, LiveFleetBackend,
                                      ProcessBackend, ProcFleetBackend,
                                      SimBackend, as_backend)
from repro_torch.api.constants import OOM_RESTART_TICKS, RELAUNCH_TICKS
from repro_torch.api.events import (ChurnEvent, DeadWindow, Event,
                                    ResizeEvent, churn_events,
                                    job_churn_events, resize_events)
from repro_torch.api.registry import BACKENDS, make_backend, tune
from repro_torch.api.session import FrozenPolicy, Session
from repro_torch.api.telemetry import RunResult, Telemetry
from repro_torch.api.validation import (AllocationError, validate_allocation,
                                        validate_fleet_allocation)

__all__ = [
    "Backend", "BackendBase", "UnsupportedEventError",
    "ControllerBackend", "DialectBackend", "ExecutorBackend",
    "FeedBackend", "FleetSimBackend", "LiveFleetBackend", "ProcessBackend",
    "ProcFleetBackend", "SimBackend", "as_backend",
    "OOM_RESTART_TICKS", "RELAUNCH_TICKS",
    "ChurnEvent", "DeadWindow", "Event", "ResizeEvent",
    "churn_events", "job_churn_events", "resize_events",
    "BACKENDS", "make_backend", "tune",
    "FrozenPolicy", "Session", "RunResult", "Telemetry",
    "AllocationError", "validate_allocation", "validate_fleet_allocation",
]
