"""Thin adapters putting every substrate behind the Backend protocol.

One adapter per substrate — none of them reimplements dynamics; they
translate the protocol onto the substrate's existing surface and lift
metric dicts into `Telemetry`:

  SimBackend         PipelineSim (analytic single machine)
  ExecutorBackend    ThreadedPipeline (real threads, measured throughput,
                     budget-enforced OOM — the single-machine LiveFleet)
  ProcessBackend     ProcessPipeline (real processes: true CPU
                     contention, RSS-measured OOM, real serial sections)
  FeedBackend        a user-owned ProcessPipeline feeding a REAL train
                     loop through data/device_feed.MeteredFeed — no
                     sleep windows; the train loop owns the clock and
                     the backend reports device-idle telemetry
  FleetSimBackend    FleetSim (N analytic trainers + pool + churn)
  LiveFleetBackend   LiveFleet (N real ThreadedPipelines)
  ControllerBackend  the legacy paper-protocol path: the InTune
                     controller's own env simulator is authoritative and
                     the Session just clocks `tuner.tick()` (used with
                     optimizer=None; this is what keeps the published
                     fig5/fig7 linear-chain numbers byte-identical)

`as_backend` wraps an already-constructed substrate (or any object
speaking the legacy machine/apply/resize dialect) for the deprecation
shims in benchmarks.common.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.backend import BackendBase
from repro_torch.api.events import ChurnEvent
from repro_torch.api.telemetry import Telemetry
from repro_torch.api.validation import (validate_allocation,
                                        validate_fleet_allocation)
from repro_torch.data.executor import ThreadedPipeline
from repro_torch.data.fleet import (ClusterSpec, FleetBackend, FleetEvent,
                                    FleetSim, TrainerSpec)
from repro_torch.data.live_fleet import RigSlot, _TrainerRig
from repro_torch.data.simulator import (MachineSpec, OOM_RESTART_TICKS,
                                        PipelineSim, graph_memory_mb)


class SimBackend(BackendBase):
    """The analytic `PipelineSim` behind the protocol."""

    def __init__(self, spec: Any = None,
                 machine: Optional[MachineSpec] = None,
                 *, model_latency: float = 0.0, seed: int = 0,
                 obs_noise: float = 0.02,
                 sim: Optional[PipelineSim] = None) -> None:
        super().__init__()
        self.sim = sim if sim is not None else PipelineSim(
            spec, machine, model_latency, seed=seed, obs_noise=obs_noise)
        self.spec = self.sim.spec

    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        validate_allocation(self.spec, alloc)
        return Telemetry.from_metrics(self.sim.apply(alloc))

    def _resize(self, n_cpus: int) -> None:
        self.sim.resize(n_cpus)

    def _advance_clock(self) -> None:
        self.sim.time += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"time": self.sim.time, "oom_count": self.sim.oom_count,
                "restart_left": self.sim.restart_left,
                "n_cpus": self.sim.machine.n_cpus}

    @property
    def machine(self) -> MachineSpec:
        return self.sim.machine

    @property
    def capacity(self) -> int:
        return self.sim.machine.n_cpus

    @property
    def oom_count(self) -> int:
        return self.sim.oom_count


class _SingleRigBackend(BackendBase):
    """Shared plumbing for the single-machine live backends (threaded
    ExecutorBackend, process-based ProcessBackend): one `RigSlot` holds
    the rig + OOM lifecycle; this base owns everything around it —
    protocol properties, snapshot, resize, the measurement window, and
    teardown accounting — so only each plane's `apply` judge differs."""

    def __init__(self, window_s: float, queue_depth: int) -> None:
        super().__init__()
        self.window_s = float(window_s)
        self.queue_depth = queue_depth
        self.time = 0

    def _launch(self, eff_cpus: Optional[int] = None) -> Any:
        raise NotImplementedError

    def _measure_window(self, cap: int, alloc: Any) -> float:
        """Apply the allocation, sleep one window, return the measured
        consumed-batch rate (the live-throughput contract)."""
        self._slot.prepare(cap, alloc)
        before = self._slot.rig.counters()
        time.sleep(self.window_s)
        return ThreadedPipeline.window_rate(before,
                                            self._slot.rig.counters())

    def _rig_extras(self) -> Dict[str, Any]:
        """The measured stats() carried in Telemetry.extras, so learning
        observers take their live branch — the next-state comes from the
        same measurement source the agent acted on."""
        return {k: v for k, v in self._slot.rig.pipe.stats().items()
                if k != "throughput"}

    def stats(self) -> Optional[Dict[str, Any]]:
        """The live stats() observation for propose(..., stats=...);
        None while the process is down (OOM restart window)."""
        return self._slot.rig.pipe.stats() if self._slot.live else None

    # ---------------------------------------------------------- protocol --
    def _resize(self, n_cpus: int) -> None:
        self._machine = dataclasses.replace(self._machine, n_cpus=n_cpus)
        if self._slot.live:
            self._slot.rig.set_eff_cpus(n_cpus)

    def _advance_clock(self) -> None:
        self.time += 1

    @property
    def restart_left(self) -> int:
        return self._slot.restart_left

    @property
    def crash_lost(self) -> int:
        return self._slot.crash_lost

    @property
    def all_joined(self) -> bool:
        return self._slot.all_joined

    def snapshot(self) -> Dict[str, Any]:
        return {"time": self.time, "oom_count": self._slot.oom_count,
                "restart_left": self._slot.restart_left,
                "n_cpus": self._machine.n_cpus}

    def _do_shutdown(self) -> Dict[str, Any]:
        dropped = self._slot.close(drain=True)
        return {"dropped_batches": dropped,
                "crash_lost": self._slot.crash_lost,
                "all_joined": self._slot.all_joined,
                "oom_count": self._slot.oom_count}

    @property
    def machine(self) -> MachineSpec:
        return self._machine

    @property
    def capacity(self) -> int:
        return self._machine.n_cpus

    @property
    def oom_count(self) -> int:
        return self._slot.oom_count


class ExecutorBackend(_SingleRigBackend):
    """A REAL ThreadedPipeline behind the protocol: the single-machine
    live backend.

    Two modes:
      - owned (default): builds a `_TrainerRig` — sleep-based stage fns
        realizing the spec's true costs plus a consumer thread modeling
        `1/model_latency` demand — and enforces the simulator's contract:
        measured window throughput, budget-based OOM (over-budget kill +
        OOM_RESTART_TICKS dead window + relaunch), over-subscription
        charged in accounting.
      - `ExecutorBackend.wrap(pipe)`: adopts a user-constructed pipeline
        (real stage fns, the training loop consuming via get_batch).
        Throughput is still the measured consumed-counter delta; OOM is
        REPORTED (the oom flag) but not enforced — the backend cannot
        relaunch user code it did not build.
    """

    def __init__(self, spec: Any = None,
                 machine: Optional[MachineSpec] = None,
                 *, model_latency: float = 0.0, window_s: float = 0.05,
                 queue_depth: int = 8, seed: int = 0,
                 pipe: Optional[ThreadedPipeline] = None) -> None:
        # seed is accepted for factory-signature parity with SimBackend
        # (thread scheduling is the noise source here, not an RNG)
        super().__init__(window_s, queue_depth)
        self._over_budget = False
        if pipe is not None:
            self.spec = pipe.spec
            self._machine = pipe.machine
            self._trainer = None
            self._slot = RigSlot(self._launch, rig=_ExternalRig(pipe))
            self._enforce_oom = False
        else:
            self.spec = spec
            self._machine = machine
            self._trainer = TrainerSpec(spec.name, spec, machine,
                                        model_latency)
            self._slot = RigSlot(self._launch)
            self._slot.rig = self._launch(machine.n_cpus)
            self._enforce_oom = True

    @classmethod
    def wrap(cls, pipe: ThreadedPipeline, *,
             window_s: float = 0.05) -> "ExecutorBackend":
        """Adopt an existing user pipeline (external consumer)."""
        return cls(pipe=pipe, window_s=window_s)

    def _launch(self, eff_cpus: Optional[int] = None) -> _TrainerRig:
        if eff_cpus is None:
            eff_cpus = self._machine.n_cpus
        return _TrainerRig(self._trainer, eff_cpus, self.queue_depth)

    # ------------------------------------------------------------- tick ---
    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        validate_allocation(self.spec, alloc)
        mem = graph_memory_mb(self.spec, alloc.workers, alloc.prefetch_mb)
        used = int(np.sum(alloc.workers))
        cap = self._machine.n_cpus
        self.time += 1
        # the shared RigSlot lifecycle: dead-window countdown + relaunch,
        # budget-OOM kill (the simulator's judge verbatim), crash-loss
        # accounting — one implementation with LiveFleet's per-trainer tick
        if self._slot.tick_dead_window(cap):
            return Telemetry(0.0, mem, used, False, True)
        if self._enforce_oom and mem > self._machine.mem_mb:
            self._slot.kill()
            return Telemetry(0.0, mem, used, True, True)
        tput = self._measure_window(cap, alloc)
        if self._enforce_oom:
            # owned rigs only: sleeps don't contend like real CPUs, so
            # charge the simulator's proportional over-subscription
            # slowdown in accounting. A wrapped user pipeline runs real
            # stage fns whose contention the measured rate already shows.
            tput = RigSlot.discount(tput, used, cap)
        # wrap mode reports (but cannot enforce) OOM: count each ENTRY
        # into the over-budget state so oom_count stays meaningful even
        # though the user-owned process is never killed
        oom_flag = (not self._enforce_oom) and mem > self._machine.mem_mb
        if oom_flag and not self._over_budget:
            self._slot.oom_count += 1
        self._over_budget = oom_flag
        return Telemetry(tput, mem, used, oom_flag, False,
                         self._rig_extras())


class _ExternalRig:
    """Rig-shaped shim over a user-owned ThreadedPipeline (no consumer
    thread — the user's training loop is the consumer)."""

    def __init__(self, pipe: ThreadedPipeline) -> None:
        self.pipe = pipe

    def set_allocation(self, alloc: Any) -> None:
        self.pipe.set_allocation(alloc.workers, alloc.prefetch_mb)

    def set_eff_cpus(self, n: int) -> None:
        self.pipe.machine = dataclasses.replace(self.pipe.machine,
                                                n_cpus=int(n))

    def counters(self) -> dict:
        return self.pipe.counters()

    def teardown(self, drain: bool = True, timeout: float = 5.0) -> dict:
        return self.pipe.shutdown(drain=drain, timeout=timeout)


class ProcessBackend(_SingleRigBackend):
    """A REAL ProcessPipeline behind the protocol: one OS-process pool
    per stage (registered as "proc" in `repro.api.registry.BACKENDS`).

    Everything the threaded backend charges in accounting is physics
    here:

      - throughput is the measured consumed-counter delta over a
        `window_s` window, with TRUE CPU contention — there is no
        over-subscription discount; over-placing workers slows the
        measured rate because cores actually run out;
      - memory is MEASURED: the OOM judge fires on the pipeline's
        sampled resident bytes (`ProcessPipeline.rss_mb`: each worker's
        private growth since spawn, from /proc) against
        `machine.mem_mb`, then pays the same
        kill + OOM_RESTART_TICKS dead window + relaunch lifecycle as
        every other plane (the shared `RigSlot`). The spec's
        `mem_per_worker_mb` is physically allocated per worker
        (SpinWork ballast), so the memory knob moves real pages;
      - `serial_frac` is realized by a real per-stage cross-process
        serialized section (calibratable live: `repro.data.calibrate`).
    """

    def __init__(self, spec: Any = None,
                 machine: Optional[MachineSpec] = None,
                 *, model_latency: float = 0.0, window_s: float = 0.1,
                 queue_depth: int = 8, seed: int = 0, ballast: bool = True,
                 rss_interval: float = 0.2) -> None:
        # seed: factory-signature parity (OS scheduling is the noise)
        super().__init__(window_s, queue_depth)
        self.ballast = ballast
        self.rss_interval = rss_interval
        self.spec = spec
        self._machine = machine
        self._trainer = TrainerSpec(spec.name, spec, machine, model_latency)
        self._slot = RigSlot(self._launch)
        self._slot.rig = self._launch(machine.n_cpus)
        # freshness accounting for streaming graphs (inert otherwise)
        self._stale = 0.0
        self._delay_win: deque = deque(maxlen=100)

    def _launch(self, eff_cpus: Optional[int] = None) -> _TrainerRig:
        from repro_torch.data.proc_executor import (ProcessPipeline,
                                                    stage_fns_for)
        if eff_cpus is None:
            eff_cpus = self._machine.n_cpus

        def make_pipe(trainer: TrainerSpec, eff: int,
                      queue_depth: int) -> "ProcessPipeline":
            return ProcessPipeline(
                trainer.pipeline,
                fns=stage_fns_for(trainer.pipeline, ballast=self.ballast),
                queue_depth=queue_depth,
                machine=dataclasses.replace(trainer.machine, n_cpus=eff),
                rss_interval=self.rss_interval)

        return _TrainerRig(self._trainer, eff_cpus, self.queue_depth,
                           make_pipe=make_pipe)

    # ------------------------------------------------------------- tick ---
    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        validate_allocation(self.spec, alloc)
        used = int(np.sum(alloc.workers))
        cap = self._machine.n_cpus
        self.time += 1
        if self._slot.tick_dead_window(cap):
            # process is down: nothing resident to measure (unlike the
            # threaded plane there is no accounting model to report)
            return Telemetry(0.0, 0.0, used, False, True)
        tput = self._measure_window(cap, alloc)
        rss = self._slot.rig.pipe.rss_mb()
        if rss > self._machine.mem_mb:
            # the measured-RSS OOM judge: same kill + dead window +
            # relaunch lifecycle, but the verdict comes from /proc, not
            # from the graph_memory_mb declaration
            self._slot.kill()
            return Telemetry(0.0, rss, used, True, True)
        # NO over-subscription discount: the contention is physical and
        # already inside the measured rate
        extras = self._rig_extras()
        stream = self._stream_fields(tput)
        if stream:
            extras.pop("backlog_items", None)   # promoted to typed field
        return Telemetry(tput, rss, used, False, False, extras, **stream)

    def _stream_fields(self, tput: float) -> Dict[str, Any]:
        """Freshness fields from the pipe's exact stream accounting
        (arrivals - emitted); {} for non-stream graphs. Staleness is the
        backlog's drain time at the measured rate; while fully stalled
        with work queued it ages by the wall window instead. A relaunch
        after an RSS OOM RESUMES the stream epoch (RigSlot carries
        `stream_epoch()` across the kill and the fresh pipe adopts it),
        so backlog keeps accruing through the dead window exactly as the
        sim retains it across its restart window."""
        state = getattr(self._slot.rig.pipe, "stream_state", lambda: None)()
        if state is None:
            return {}
        backlog = float(state["backlog"])
        if tput > 1e-9:
            self._stale = backlog / tput
        elif backlog > 1e-9:
            self._stale += self.window_s
        else:
            self._stale = 0.0
        self._delay_win.append(self._stale)
        return {"backlog_items": backlog,
                "batch_staleness_s": self._stale,
                "p99_queue_delay_s": float(np.percentile(self._delay_win,
                                                         99.0))}


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
        # (the idle reading below is a function of these four)
        extras["produced"] = produced
        extras["consumed"] = consumed
        extras["batches"] = batches
        extras["wall_s"] = wall
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


class _FleetAdapter(BackendBase):
    """Shared fleet adaptation: both fleet substrates subclass
    `repro.data.fleet.FleetBackend`, so the protocol mapping is
    identical — only construction and teardown differ."""

    inner: FleetBackend

    def __init__(self, inner: FleetBackend) -> None:
        super().__init__()
        self.inner = inner
        self.spec = inner.cluster

    def apply(self, falloc: Any) -> Telemetry:
        self._check_open()
        validate_fleet_allocation(self.spec, falloc)
        m = dict(self.inner.apply(falloc))
        per = m.get("per_trainer")
        if per is not None:
            m["per_trainer"] = {n: Telemetry.from_metrics(d)
                                for n, d in per.items()}
        return Telemetry.from_metrics(m)

    def _resize(self, n_cpus: int) -> None:
        self.inner.resize(n_cpus)         # fleet dialect: pool re-cap

    def _churn(self, event: ChurnEvent) -> None:
        self.inner.inject_event(FleetEvent(
            tick=event.tick, kind=event.kind, trainer=event.trainer,
            n_cpus=event.n_cpus))

    def _advance_clock(self) -> None:
        self.inner.time += 1

    def snapshot(self) -> Dict[str, Any]:
        state = self.inner.machine
        return {"time": self.inner.time, "pool": self.inner.pool,
                "active": state.active, "base_cpus": state.base_cpus,
                "oom_count": self.inner.oom_count}

    @property
    def machine(self) -> Any:
        return self.inner.machine         # FleetState

    @property
    def capacity(self) -> int:
        return self.inner.machine.n_cpus

    @property
    def oom_count(self) -> int:
        return self.inner.oom_count


class FleetSimBackend(_FleetAdapter):
    """The analytic FleetSim behind the protocol."""

    def __init__(self, cluster: Optional[ClusterSpec] = None, *,
                 seed: int = 0, obs_noise: float = 0.02,
                 sim: Optional[FleetSim] = None) -> None:
        super().__init__(sim if sim is not None
                         else FleetSim(cluster, seed=seed,
                                       obs_noise=obs_noise))

    def snapshot(self) -> Dict[str, Any]:
        snap = super().snapshot()
        snap["trainers"] = {
            n: {"time": s.time, "oom_count": s.oom_count,
                "restart_left": s.restart_left,
                "n_cpus": s.machine.n_cpus}
            for n, s in sorted(self.inner.sims.items())}
        return snap


class LiveFleetBackend(_FleetAdapter):
    """The live-executor LiveFleet behind the protocol; `shutdown()`
    returns its drop/leak accounting."""

    def __init__(self, cluster: Optional[ClusterSpec] = None, *,
                 seed: int = 0, window_s: float = 0.1,
                 queue_depth: int = 8, fleet: Any = None) -> None:
        if fleet is None:
            from repro_torch.data.live_fleet import LiveFleet
            fleet = LiveFleet(cluster, seed=seed, window_s=window_s,
                              queue_depth=queue_depth)
        super().__init__(fleet)

    def _do_shutdown(self) -> Dict[str, Any]:
        return self.inner.close()


class ProcFleetBackend(_FleetAdapter):
    """The process-plane fleet (ProcFleet: one ProcessPipeline per
    trainer, real CPU contention, measured-RSS OOM) behind the protocol;
    `shutdown()` returns its drop/leak accounting."""

    def __init__(self, cluster: Optional[ClusterSpec] = None, *,
                 seed: int = 0, window_s: float = 0.1,
                 queue_depth: int = 8, ballast: bool = True,
                 rss_interval: float = 0.2, fleet: Any = None) -> None:
        if fleet is None:
            from repro_torch.data.live_fleet import ProcFleet
            fleet = ProcFleet(cluster, seed=seed, window_s=window_s,
                              queue_depth=queue_depth, ballast=ballast,
                              rss_interval=rss_interval)
        super().__init__(fleet)

    def _do_shutdown(self) -> Dict[str, Any]:
        return self.inner.close()


class ControllerBackend(BackendBase):
    """The legacy paper-protocol path behind the protocol: the InTune
    controller's internal env simulator is authoritative and each apply
    is one self-driving `tuner.tick()`. Use with `Session(backend)` and
    no optimizer — the published fig5/fig7 linear-chain benchmarks run
    through exactly this, keeping their golden JSONs byte-identical."""

    def __init__(self, tuner: Any) -> None:
        super().__init__()
        self.tuner = tuner
        self.spec = tuner.spec

    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        if alloc is not None:
            raise TypeError(
                "ControllerBackend is self-driving: run it with "
                "Session(backend) and no optimizer (the controller "
                "ignores external proposals)")
        return Telemetry.from_metrics(self.tuner.tick())

    def _resize(self, n_cpus: int) -> None:
        self.tuner.resize(n_cpus)

    def _advance_clock(self) -> None:
        self.tuner.env.sim.time += 1

    def snapshot(self) -> Dict[str, Any]:
        sim = self.tuner.env.sim
        return {"time": sim.time, "oom_count": sim.oom_count,
                "restart_left": sim.restart_left,
                "n_cpus": sim.machine.n_cpus}

    @property
    def machine(self) -> MachineSpec:
        return self.tuner.env.sim.machine

    @property
    def capacity(self) -> int:
        return self.tuner.env.sim.machine.n_cpus

    @property
    def oom_count(self) -> int:
        return self.tuner.env.sim.oom_count


def as_backend(obj: Any) -> BackendBase:
    """Wrap an already-constructed substrate. Known substrates get their
    typed adapter; anything else speaking the legacy machine/apply/resize
    dialect gets `DialectBackend` (no validation — the shim of last
    resort for custom sim_factory objects)."""
    if isinstance(obj, BackendBase):
        return obj
    if isinstance(obj, PipelineSim):
        return SimBackend(sim=obj)
    if isinstance(obj, FleetSim):
        return FleetSimBackend(sim=obj)
    from repro_torch.data.live_fleet import LiveFleet
    if isinstance(obj, LiveFleet):
        return LiveFleetBackend(fleet=obj)
    if isinstance(obj, ThreadedPipeline):
        return ExecutorBackend.wrap(obj)
    return DialectBackend(obj)


class DialectBackend(BackendBase):
    """Adapter of last resort over the legacy driver dialect
    (`machine` / `apply(alloc) -> dict` / `resize(n)` / `time` /
    `oom_count`)."""

    def __init__(self, inner: Any) -> None:
        super().__init__()
        self.inner = inner
        self.spec = getattr(inner, "spec", getattr(inner, "cluster", None))

    def apply(self, alloc: Any) -> Telemetry:
        self._check_open()
        return Telemetry.from_metrics(self.inner.apply(alloc))

    def _resize(self, n_cpus: int) -> None:
        self.inner.resize(n_cpus)

    def _advance_clock(self) -> None:
        self.inner.time += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"time": getattr(self.inner, "time", None),
                "oom_count": getattr(self.inner, "oom_count", 0)}

    @property
    def machine(self) -> Any:
        return self.inner.machine

    @property
    def capacity(self) -> int:
        return self.inner.machine.n_cpus

    @property
    def oom_count(self) -> int:
        return getattr(self.inner, "oom_count", 0)
