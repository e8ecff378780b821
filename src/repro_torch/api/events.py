"""Runtime events a backend can be sent (`BackendBase.inject`):

  ResizeEvent(tick, n_cpus)   re-cap the machine's CPUs (FeedBackend
                              re-pins the pipeline's workers).
  ChurnEvent(tick, kind, trainer, n_cpus)
                              fleet membership churn (join / leave /
                              resize / pool); a single-machine backend
                              refuses it with UnsupportedEventError.

Events are plain frozen dataclasses with no backend imports, so schedules
can be built (and serialized) without touching the data plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True)
class ResizeEvent:
    """At `tick`, re-cap the backend's CPU capacity to `n_cpus` (the
    machine cap for single-machine backends, the shared pool for fleet
    backends)."""
    tick: int
    n_cpus: int


@dataclass(frozen=True)
class ChurnEvent:
    """At `tick`, fleet membership churn: `trainer` joins/leaves the job,
    its machine is resized to `n_cpus`, or (kind="pool") the shared pool
    is re-capped. Mirrors `repro.data.fleet.FleetEvent` — backends convert
    via the adapter so this module stays import-free."""
    tick: int
    kind: str                  # "join" | "leave" | "resize" | "pool"
    trainer: str = ""
    n_cpus: int = 0


Event = Union[ResizeEvent, ChurnEvent]
