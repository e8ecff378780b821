"""Typed telemetry: what a backend reports per tick, and what a run returns.

Every backend used to answer `apply` with an ad-hoc metrics dict whose
keys each consumer grep'd for; `Telemetry` names the five fields every
backend must report and parks backend-specific extras (per-trainer
breakdowns, pool state, rewards) in `extras`. `RunResult` replaces the
`{"throughput": [...], ...}` dicts the benchmark loops returned.

Both are mapping-compatible (`tel["mem_mb"]`, `tel.get("per_trainer")`,
`dict(tel)`), so optimizer `observe` hooks and collectors written against
the dict dialect keep working verbatim while new code gets attributes and
types.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

_CORE = ("throughput", "mem_mb", "used_cpus", "oom", "restarting")

# Feed-boundary fields: reported only by backends that sit at
# a host->device feed (FeedBackend). None means "this backend has no
# feed boundary" and the field is omitted from the mapping dialect, so
# dict-shaped consumers of sim/executor telemetry see no new keys.
_FEED = ("device_idle_frac", "step_time_s", "feed_stall_s")

# Freshness fields: reported only when the graph has a
# streaming source (kind="stream"). Same None-means-absent contract as
# _FEED, so fig5/fig7 goldens stay byte-identical.
_STREAM = ("backlog_items", "batch_staleness_s", "p99_queue_delay_s")

# Every optional (hidden-when-None) field.
_OPTIONAL = _FEED + _STREAM


class _DictCompat:
    """The dict-dialect shim shared by Telemetry and RunResult: typed
    fields named in `_FIELDS` read first, everything else through
    `extras`. One implementation, so the two mapping dialects cannot
    diverge."""

    _FIELDS: tuple = ()
    extras: Dict[str, Any]

    def keys(self) -> List[str]:
        return list(self._FIELDS) + list(self.extras)

    def __getitem__(self, key: str) -> Any:
        if key in self._FIELDS:
            return getattr(self, key)
        return self.extras[key]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        return key in self._FIELDS or key in self.extras

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def items(self) -> List[Tuple[str, Any]]:
        return [(k, self[k]) for k in self.keys()]

    def values(self) -> List[Any]:
        return [self[k] for k in self.keys()]

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self._FIELDS}
        d.update(self.extras)
        return d


@dataclass
class Telemetry(_DictCompat):
    """One tick's outcome, the `Backend.apply` return contract.

    throughput  sustained (sim) or measured (live) batches/s this tick
    mem_mb      the allocation's memory footprint (graph_memory_mb model)
    used_cpus   workers the allocation placed (uncapped; drivers clamp)
    oom         this tick crossed the memory line (process killed)
    restarting  the pipeline is inside a dead/restart window
    extras      backend-specific breakdowns (per_trainer, pool, reward...)

    Feed-boundary fields (None unless the backend sits at a host->device
    feed — see api/backends.FeedBackend and data/device_feed.MeteredFeed):

    device_idle_frac  fraction of the window's wall time the consumer
                      spent blocked waiting on `next(feed)` — the
                      paper's headline metric (accelerator starvation)
    step_time_s       mean wall seconds per train step over the window
    feed_stall_s      total blocked-on-feed seconds over the window

    Freshness fields (None unless the graph has a streaming source —
    see data/stream.ArrivalProcess):

    backlog_items       batches arrived but not yet drained
    batch_staleness_s   age of the batch now leaving the pipeline — the
                        backlog's drain time at the current throughput
    p99_queue_delay_s   p99 of staleness over a sliding window of ticks
    """
    throughput: float = 0.0
    mem_mb: float = 0.0
    used_cpus: int = 0
    oom: bool = False
    restarting: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)
    device_idle_frac: Optional[float] = None
    step_time_s: Optional[float] = None
    feed_stall_s: Optional[float] = None
    backlog_items: Optional[float] = None
    batch_staleness_s: Optional[float] = None
    p99_queue_delay_s: Optional[float] = None

    # Positional construction (`Telemetry(tput, rss, used, False, False,
    # extras)`) is load-bearing across backends and tests, so the feed +
    # stream fields live AFTER extras. The mapping dialect hides them
    # when None.
    _FIELDS = _CORE + _FEED + _STREAM

    def keys(self) -> List[str]:
        return ([k for k in self._FIELDS
                 if k not in _OPTIONAL or getattr(self, k) is not None]
                + list(self.extras))

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self._FIELDS
             if k not in _OPTIONAL or getattr(self, k) is not None}
        d.update(self.extras)
        return d

    @classmethod
    def from_metrics(cls, metrics: Dict[str, Any]) -> "Telemetry":
        """Lift a dialect metrics dict; unknown keys land in extras."""
        if isinstance(metrics, Telemetry):
            return metrics
        extras = {k: v for k, v in metrics.items()
                  if k not in _CORE and k not in _OPTIONAL}
        return cls(throughput=metrics.get("throughput", 0.0),
                   mem_mb=metrics.get("mem_mb", 0.0),
                   used_cpus=metrics.get("used_cpus", 0),
                   oom=bool(metrics.get("oom", False)),
                   restarting=bool(metrics.get("restarting", False)),
                   extras=extras,
                   device_idle_frac=metrics.get("device_idle_frac"),
                   step_time_s=metrics.get("step_time_s"),
                   feed_stall_s=metrics.get("feed_stall_s"),
                   backlog_items=metrics.get("backlog_items"),
                   batch_staleness_s=metrics.get("batch_staleness_s"),
                   p99_queue_delay_s=metrics.get("p99_queue_delay_s"))

    @classmethod
    def dead_tick(cls) -> "Telemetry":
        """The zero tick charged inside a dead/relaunch window."""
        return cls(restarting=True)


@dataclass
class RunResult(_DictCompat):
    """A Session run's timeline + terminal accounting.

    The per-tick series align index-for-index with the run's ticks;
    `used_cpus` is clamped to the capacity each proposal was made
    against (the legacy loops' contract). `extras` carries run-level
    artifacts: the live backend's teardown accounting under "live", the
    driving optimizer under "optimizer", legacy fields like "caps".
    """
    throughput: List[float] = field(default_factory=list)
    used_cpus: List[int] = field(default_factory=list)
    mem_mb: List[float] = field(default_factory=list)
    oom_count: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)

    _FIELDS = ("throughput", "used_cpus", "mem_mb", "oom_count")

    @property
    def ticks(self) -> int:
        return len(self.throughput)
