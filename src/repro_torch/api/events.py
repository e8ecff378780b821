"""The unified runtime event stream.

Before this package, mid-run disturbances spoke two dialects: the
single-machine `resize_schedule` ([(tick, n_cpus), ...] threaded through
`run_static`/`run_optimizer`) and the fleet plane's `FleetEvent` churn
schedule baked into a ClusterSpec. `Session.run(events=...)` accepts ONE
stream for every backend:

  ResizeEvent(tick, n_cpus)   re-cap the machine (single-machine backends)
                              or the shared elastic pool (fleet backends) —
                              exactly what the dialect's `resize(n)` did.
  ChurnEvent(tick, kind, trainer, n_cpus)
                              fleet membership churn (join / leave /
                              resize / pool), injected into the backend's
                              pending event queue. Fleet backends only.
  DeadWindow(tick, ticks)     the pipeline process is down for `ticks`
                              ticks starting at `tick` (checkpoint +
                              relaunch, the paper's manual-intervention
                              cost). Handled by the Session itself: the
                              backend's clock advances but nothing runs.

Events are plain frozen dataclasses with no backend imports, so schedules
can be built (and serialized) without touching the data plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Sequence, Tuple, Union


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


@dataclass(frozen=True)
class DeadWindow:
    """At `tick`, the pipeline process goes down for `ticks` ticks — the
    checkpoint + relaunch window static policies pay to adapt. The
    Session zeroes those ticks without calling the backend's apply."""
    tick: int
    ticks: int


Event = Union[ResizeEvent, ChurnEvent, DeadWindow]


def resize_events(schedule: Iterable[Tuple[int, int]]) -> List[ResizeEvent]:
    """Lift a legacy `resize_schedule` [(tick, n_cpus), ...] into the
    unified event stream."""
    return [ResizeEvent(int(t), int(n)) for t, n in schedule]


def churn_events(events: Sequence) -> List[ChurnEvent]:
    """Lift `repro.data.fleet.FleetEvent`s (e.g. a ClusterSpec's churn
    schedule) into injectable ChurnEvents."""
    return [ChurnEvent(ev.tick, ev.kind, ev.trainer, ev.n_cpus)
            for ev in events]


def job_churn_events(market: Any,
                     schedule: Iterable[Tuple[int, str, str]]
                     ) -> List[ChurnEvent]:
    """JOB-level churn for a MarketSpec: each (tick, kind, job) entry —
    a whole training job joining or leaving the cluster — expands to one
    ChurnEvent per member trainer (spec order within the tick). `market`
    is duck-typed: anything with `job(name).trainers` works, so this
    module stays free of data-plane imports."""
    out: List[ChurnEvent] = []
    for tick, kind, job in schedule:
        if kind not in ("join", "leave"):
            raise ValueError(
                f"job-level churn is join/leave only, got {kind!r}")
        for t in market.job(job).trainers:
            out.append(ChurnEvent(int(tick), kind, t))
    return out
