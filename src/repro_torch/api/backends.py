"""The Backend adapter the closed training loop runs: `FeedBackend`, a
user-owned ProcessPipeline feeding a real train loop through
`data/device_feed.MeteredFeed`. No sleep windows: the train loop owns
the clock and the backend reports device-idle telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.backend import BackendBase
from repro_torch.api.telemetry import Telemetry
from repro_torch.api.validation import validate_allocation
from repro_torch.data.simulator import MachineSpec


class FeedBackend(BackendBase):
    """A user-owned ProcessPipeline feeding a REAL train loop, metered at
    the host->device boundary (the proc->device bridge).

    Every other live backend owns the clock: `apply` sleeps through a
    measurement window while a synthetic consumer drains the pipe. Here
    the TRAIN LOOP owns the clock — it pulls batches through a
    `MeteredFeed` (data/device_feed.make_train_feed) between ticks — so
    the backend never sleeps. `measure()` differences the pipe and feed
    counters since the previous call and charges the window that the
    training actually ran:

      throughput        consumed-batch delta / wall delta
      device_idle_frac  the paper's accelerator-starvation metric.
                        With `device_step_s` given (the uncontended
                        per-step device time, measured at warmup):
                        1 - busy*device_step_s / wall, where busy is
                        the batch delta CAPPED at the pipe's produced
                        delta — every wall second beyond pure device
                        compute is charged to ingestion, which is the
                        right accounting when trainer and pipeline
                        share host cores (the feed steals silicon
                        instead of letting the consumer block), and a
                        window that merely drains buffered inventory
                        earns no idle credit for its allocation.
                        Without it: feed stall delta / wall
                        delta (blocked-in-next time), the right metric
                        when the train step runs on a real accelerator
                        the pipeline cannot contend with.
      step_time_s       wall delta / batches stepped
      feed_stall_s      the raw blocked-in-next seconds

    `apply(alloc)` only retargets the pipeline (`set_allocation`) and
    returns the last measured window — there is nothing new to measure
    until the train loop has run more steps. `apply(None)` measures.
    OOM is REPORTED, not enforced (measured RSS over budget counts one
    oom per entry into the over-budget state): the backend cannot kill
    and relaunch a pipeline whose consumer is user code mid-step.
    `Session.step()` drives this backend one train-step window at a time.
    """

    def __init__(self, pipe: Any, feed: Any, *,
                 machine: Optional[MachineSpec] = None,
                 device_step_s: Optional[float] = None) -> None:
        super().__init__()
        self.pipe = pipe
        self.feed = feed
        self.device_step_s = device_step_s
        self.spec = pipe.spec
        self._machine = machine if machine is not None else pipe.machine
        self.time = 0
        self._oom_count = 0
        self._over_budget = False
        self._settle = 0
        self._mark_pipe = pipe.counters()
        self._mark_feed = feed.counters()
        self._last_tel = Telemetry(extras={"pending": True})

    # ------------------------------------------------------------- tick ---
    def measure(self) -> Telemetry:
        """Close the window opened by the previous measure(): difference
        the counters, judge OOM, cache + return the Telemetry."""
        self._check_open()
        self.time += 1
        now_p = self.pipe.counters()
        now_f = self.feed.counters()
        wall = max(now_f["time"] - self._mark_feed["time"], 1e-9)
        batches = now_f["batches"] - self._mark_feed["batches"]
        stall = now_f["stall_s"] - self._mark_feed["stall_s"]
        consumed = now_p["consumed"] - self._mark_pipe["consumed"]
        produced = now_p["delivered"] - self._mark_pipe["delivered"]
        prev_pipe_t = self._mark_pipe["time"]
        self._mark_pipe, self._mark_feed = now_p, now_f
        rss = self.pipe.rss_mb()
        over = rss > self._machine.mem_mb
        if over and not self._over_budget:
            self._oom_count += 1
        self._over_budget = over
        stats = self.pipe.stats()
        # stats-minus-throughput in extras: the "stage_latency" key is
        # what flips learning observers (InTune._live_obs) onto their
        # measured branch, same as the other live backends
        extras = {k: v for k, v in stats.items() if k != "throughput"}
        # raw window deltas for callers that need raw attribution data
        extras["produced"] = produced
        extras["consumed"] = consumed
        # THE settling flag (centralizes the per-driver
        # `produced == 0` heuristics): the first window after a worker
        # resize is flagged — fresh workers spend ~0.2s self-calibrating
        # before producing — and the flag holds while the pipe stays
        # unproductive, up to a bound so a genuinely starved allocation
        # is eventually charged honestly
        resize_at = now_p.get("last_resize_at", 0.0)
        if resize_at > prev_pipe_t:
            self._settle = 1
        elif self._settle and produced <= 0 and self._settle < 4:
            self._settle += 1
        else:
            self._settle = 0
        extras["settling"] = bool(self._settle)
        if self.device_step_s is not None:
            # busy credit is capped at what the pipeline PRODUCED this
            # window: a window that drains buffered inventory can step
            # the device at full speed for a moment under any
            # allocation, and crediting that would hand best-tracking
            # optimizers transient idle~0 windows unrelated to the
            # allocation under test. Long-run averages are unchanged
            # (buffers are finite); only short-window attribution is.
            sustained = min(batches, max(produced, 0.0))
            idle = 1.0 - sustained * self.device_step_s / wall
        else:
            idle = stall / wall
        self._last_tel = Telemetry(
            consumed / wall, rss,
            int(np.sum(stats.get("workers", []))), over, False, extras,
            device_idle_frac=min(1.0, max(0.0, idle)),
            step_time_s=(wall / batches) if batches > 0 else None,
            feed_stall_s=stall)
        return self._last_tel

    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        if alloc is None:
            return self.measure()
        validate_allocation(self.spec, alloc)
        self.pipe.set_allocation(list(alloc.workers), alloc.prefetch_mb)
        return self._last_tel

    # ---------------------------------------------------------- protocol --
    def stats(self) -> Optional[Dict[str, Any]]:
        return self.pipe.stats()

    def _resize(self, n_cpus: int) -> None:
        self._machine = dataclasses.replace(self._machine, n_cpus=n_cpus)
        self.pipe.machine = dataclasses.replace(self.pipe.machine,
                                                n_cpus=n_cpus)
        self.pipe.apply_cpu_cap()

    def _advance_clock(self) -> None:
        self.time += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"time": self.time, "oom_count": self._oom_count,
                "n_cpus": self._machine.n_cpus}

    def _do_shutdown(self) -> Dict[str, Any]:
        # stop the feed's producer thread FIRST: a prefetcher still
        # pulling get_batch during pipe teardown races the queue close
        close = getattr(self.feed, "close", None)
        if close is not None:
            close()
        acct = self.pipe.shutdown(drain=False, timeout=10.0)
        return {"dropped_batches": int(acct.get("dropped", 0)),
                "all_joined": bool(acct.get("joined", False)),
                "oom_count": self._oom_count}

    @property
    def machine(self) -> MachineSpec:
        return self._machine

    @property
    def capacity(self) -> int:
        return self._machine.n_cpus

    @property
    def oom_count(self) -> int:
        return self._oom_count
