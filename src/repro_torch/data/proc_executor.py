"""Process-based StageGraph executor: real CPU contention, measured RSS.

`ThreadedPipeline` (data/executor.py) proves the control plumbing but
emulates stage cost with `time.sleep` under the GIL — sleeps don't
contend for cores, memory is budget accounting, and a serialized
section can't realize Amdahl scaling. `ProcessPipeline` speaks the
exact same contract (`set_allocation`, `stats()`, `counters()` /
`window_rate`, soft/hard `shutdown(drain=)` with dropped-batch
accounting, `get_batch`) but runs one OS-process pool per stage over
`multiprocessing` queues:

  - WORK IS REAL: `SpinWork` burns actual CPU seconds (measured with
    `time.process_time`, so the burn is contention-invariant CPU work,
    not wall time). Over-subscribing the host's cores physically slows
    every worker down — the simulator's proportional-slowdown model is
    now an emergent measurement, not an accounting charge.
  - SERIAL SECTIONS ARE REAL: `serial_frac * cost` of every item burns
    under a per-stage cross-process lock, and the parallel remainder
    carries the Amdahl coordination penalty (`SpinWork` docstring), so
    a stage's measured service rate follows the analytic curve
    `stage_throughput` predicts while the lock serializes for real —
    it saturates the stage at `1 / (serial_frac * cost)`, exactly the
    model's asymptote.
  - MEMORY IS MEASURED: a sampler thread reads each worker process's
    private resident memory from `/proc` (psutil fallback) and charges
    its GROWTH since spawn — kernels disagree on how a forked child's
    inherited copy-on-write image shows up in per-process accounting,
    but growth over the spawn baseline is the pipeline's own footprint
    on all of them. `SpinWork` allocates `mem_per_worker_mb` of touched
    ballast pages per worker, so the spec's memory knob is physically
    resident and the OOM judge (`repro.api.ProcessBackend`) fires on
    *measured* bytes against `MachineSpec.mem_mb`, not on the
    `graph_memory_mb` declaration.
  - THE CPU CAP IS PHYSICAL where the host allows: worker processes are
    pinned (`os.sched_setaffinity`, best-effort) to the first
    `min(machine.n_cpus, host cores)` cores, so a resize event shrinks
    the silicon the pipeline may touch.

Known gap vs the model (DESIGN.md §9): on a host with fewer cores than
`machine.n_cpus` the physical cores bind first, so absolute rates read
low; rankings transfer (tests/test_proc_executor.py) because candidates
share the same per-item CPU totals. `repro.data.calibrate` closes the
loop the other way: it fits the Amdahl curve to *measured* window rates
and emits a calibrated StageGraph the simulator consumes.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.data.executor import _RateMeter, ThreadedPipeline
from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import MachineSpec

_MB = 1024 * 1024
_OUT_QUEUE_CAP = 32768     # hard bound; the live prefetch gate is _out_depth
try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE = 4096


class _Stop:
    """End-of-stream sentinel. Crosses process boundaries by pickle, so
    identity checks don't survive — compare with isinstance."""


class _Skip:
    """Worker-local "nothing to emit this cycle" sentinel (a rate-limited
    stream source polling ahead of the arrival curve). Never crosses a
    process boundary: the worker loop consumes it in place."""


_SKIP = _Skip()


def read_rss_mb(pid: int) -> Optional[float]:
    """Measured private resident memory of one process in MB (USS:
    private clean + private dirty), best effort.

    Preference order: smaps_rollup Private_* -> smaps Private_*
    (pre-4.14 kernels) -> psutil USS/RSS -> statm (resident minus
    file-backed shared); None when the process is gone. NOTE: kernels
    disagree on whether a forked child's inherited copy-on-write anon
    pages count as private (a 4.4 kernel reports the whole parent heap
    as the child's private pages), so absolute readings are
    host-dependent — `_RssSampler` charges each worker's GROWTH over
    its spawn-time baseline, which is the pipeline's own footprint
    everywhere.
    """
    # smaps_rollup (kernel >= 4.14) is one read; plain smaps (any
    # kernel) is the same Private_* accounting summed over VMAs
    for name in ("smaps_rollup", "smaps"):
        try:
            private = 0
            seen = False
            with open(f"/proc/{pid}/{name}", "rb") as f:
                for line in f:
                    if line.startswith((b"Private_Clean:",
                                        b"Private_Dirty:")):
                        private += int(line.split()[1])
                        seen = True
            if seen:
                return private / 1024.0
        except (OSError, ValueError, IndexError):
            continue
    try:
        import psutil
        proc = psutil.Process(pid)
        try:
            return proc.memory_full_info().uss / _MB
        except Exception:
            return proc.memory_info().rss / _MB
    except Exception:
        pass
    # last resort: resident minus file-backed shared (over-counts a
    # forked worker's inherited anonymous pages — better than nothing)
    try:
        with open(f"/proc/{pid}/statm", "rb") as f:
            fields = f.read().split()
        return max(0, int(fields[1]) - int(fields[2])) * _PAGE / _MB
    except (OSError, ValueError, IndexError):
        return None


try:
    _CLK_TCK = os.sysconf("SC_CLK_TCK")
except (AttributeError, ValueError, OSError):
    _CLK_TCK = 100


def read_cpu_s(pid: int) -> Optional[float]:
    """Cumulative CPU seconds (utime + stime) one process has consumed,
    from `/proc/<pid>/stat` (psutil fallback). Contention-invariant —
    the calibrator uses deltas of this to normalize measured window
    rates by worker occupancy, so the Amdahl fit survives a host with
    fewer cores than the sweep demands."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # comm may contain spaces: fields start after the last ')'
        fields = data[data.rindex(b")") + 2:].split()
        return (int(fields[11]) + int(fields[12])) / _CLK_TCK
    except (OSError, ValueError, IndexError):
        pass
    try:
        import psutil
        t = psutil.Process(pid).cpu_times()
        return float(t.user + t.system)
    except Exception:
        return None


def _spin_iters(n: int) -> float:
    """The unit of CPU work: a pure-python arithmetic loop. Iterations
    advance only while the process is scheduled, so a fixed iteration
    count is contention-invariant CPU work."""
    x = 1.0
    for _ in range(n):
        x = x * 1.0000001 + 1e-9
    return x


_iters_per_sec: Optional[float] = None


def spin_rate(min_cpu_s: float = 0.12) -> float:
    """Iterations of `_spin_iters` this process executes per CPU-second,
    calibrated against `time.process_time` over a window long enough to
    swamp its tick granularity (~10ms on older kernels — which is also
    why the burn itself can't just poll process_time: ms-scale burns
    would quantize to whole ticks). Two passes: a short probe sizes one
    measured run of >= `min_cpu_s` CPU. Cached per process; workers
    whose stages have sub-tick burns recalibrate once at
    `SpinWork.bind` (their CPU can run a different effective speed than
    the parent's)."""
    global _iters_per_sec
    if _iters_per_sec is None:
        probe = 500_000
        t0 = time.process_time()
        _spin_iters(probe)
        dt = max(time.process_time() - t0, 0.01)
        n = max(probe, int(probe * min_cpu_s / dt))
        t0 = time.process_time()
        _spin_iters(n)
        dt = max(time.process_time() - t0, 1e-3)
        _iters_per_sec = n / dt
    return _iters_per_sec


# burns at least this long poll the kernel CPU clock directly (2 ticks
# of the ~10ms cputime granularity found on older kernels/VMs)
_TICK_GUARD = 0.02
# cumulative overshoot of clock-polled burns (per process; see _burn)
_burn_debt = 0.0


def _burn(cpu_s: float, quantum: Optional[Callable] = None,
          qrate: Optional[float] = None):
    """Burn `cpu_s` seconds of CPU *work*, not wall time: under core
    contention the wall duration stretches, which is exactly the physics
    the sleep-based executor cannot realize.

    Burns >= _TICK_GUARD poll `time.process_time` — the SAME kernel
    cputime accounting `/proc/<pid>/stat` reports — so a measured
    per-item CPU equals the designed cycle by construction, immune to
    host-speed drift and hypervisor steal (this is what makes
    calibration's Amdahl fit stable on virtualized runners). Shorter
    burns would quantize to whole cputime ticks, so they spin a
    calibrated iteration count instead: still real contention-visible
    work, but their effective cost rides the per-worker calibration and
    can drift a few percent with host speed — fine for the rank-based
    differential suites, which never assert absolute rates.

    `quantum` swaps the unit of work: instead of `_spin_iters`, the
    clock-polled loop repeats the given zero-arg callable (real
    featurization ops — see data/featurize.py), with `qrate` (quanta
    per CPU-second, measured at worker bind) sizing the sub-tick path
    the way `spin_rate` sizes the spin path. The clock discipline — and
    therefore the designed-cost == measured-CPU identity calibration
    relies on — is identical for both units."""
    global _burn_debt
    if cpu_s <= 0:
        return
    if cpu_s >= _TICK_GUARD:
        # error feedback: each burn overshoots by up to one cputime tick
        # (the clock only moves in ticks) plus up to one quantum, which
        # would bias every measured per-item CPU high by a constant —
        # carry the overshoot as debt and shave it off subsequent burns,
        # so the long-run average burn equals the requested cost exactly
        target = cpu_s - _burn_debt
        if target <= 0:
            _burn_debt -= cpu_s
            return
        t0 = time.process_time()
        while True:
            elapsed = time.process_time() - t0
            if elapsed >= target:
                break
            if quantum is not None:
                quantum()
            else:
                _spin_iters(2000)
        _burn_debt += elapsed - cpu_s
        return
    if quantum is not None and qrate:
        for _ in range(max(1, int(cpu_s * qrate))):
            quantum()
        return
    _spin_iters(max(1, int(cpu_s * spin_rate())))


class SpinWork:
    """Picklable per-stage work function burning real CPU.

    Per item at pool size `a`: `serial_frac * cost` CPU-seconds under
    the stage's cross-process lock (a REAL serialized section, constant
    per item) plus `(1 - serial_frac) * cost + (a-1) * serial_frac *
    cost` outside it — the coordination penalty the Amdahl curve
    attributes to the serial fraction, growing with the pool. The
    per-worker cycle is then `cost * (a * s + 1 - s)`, so the stage's
    measured service rate is `a / cycle = 1 / (cost * (s + (1-s)/a))` —
    exactly the analytic `stage_throughput` curve — while the lock's
    utilization `a*s / (a*s + 1 - s)` approaches 1 from below: the
    serialized section really saturates the stage at
    `1 / (serial_frac * cost)`, Amdahl's asymptote. Physical core
    contention stacks on top when the host runs out of CPUs.

    `ballast_mb` of touched pages is allocated once per worker process
    (`bind`), making the spec's per-worker memory footprint resident so
    the RSS sampler measures it.

    kind: "source" emits an infinite stream (training never hits EOS);
    "join" pairs one item per input; "map" forwards its input.
    """

    def __init__(self, cost: float, serial_frac: float = 0.0,
                 ballast_mb: float = 0.0, kind: str = "map"):
        self.cost = float(cost)
        self.serial_frac = float(serial_frac)
        self.ballast_mb = float(ballast_mb)
        self.kind = kind
        self._lock = None
        self._workers = None
        self._ballast = None

    def bind(self, serial_lock, nworkers):
        """Called once inside each worker process before the first item:
        attach the stage's shared lock + live pool size, recalibrate the
        spin clock if this stage has sub-tick burns (a worker's CPU can
        run a different effective speed than the parent's), and make the
        ballast resident (every page touched).

        Stages whose burn portions all take the CPU-clock path skip the
        recalibration entirely — it costs ~0.1s of CPU at spawn, which
        would pollute a measurement window that opens right after a
        resize-up (calibration sweeps hit exactly that)."""
        global _iters_per_sec
        serial = self.serial_frac * self.cost
        par = self.cost - serial
        if 0 < serial < _TICK_GUARD or 0 < par < _TICK_GUARD:
            _iters_per_sec = None      # drop the inherited calibration
            spin_rate()
        self._lock = serial_lock
        self._workers = nworkers
        self._touch_ballast()

    def _touch_ballast(self):
        if self.ballast_mb > 0 and self._ballast is None:
            buf = bytearray(int(self.ballast_mb * _MB))
            step = _PAGE
            buf[::step] = b"\x01" * len(buf[::step])
            self._ballast = buf

    def release(self):
        """Drop worker-side memory before exit. A retiring worker whose
        exit flush is stuck behind a full downstream queue can linger for
        the rest of the run (the queue stays full at steady state); with
        the ballast freed it lingers as a bare interpreter instead of
        pinning tens of MB per ghost on an already-small host."""
        self._ballast = None

    def _do_burn(self, cpu_s: float):
        """The burn unit — subclasses swap in a real-work quantum
        (data/featurize.py) without touching the contract math."""
        _burn(cpu_s)

    def _produce(self, items):
        """The item flowing downstream; real-work subclasses return
        actual record blocks and their CPU is charged to the parallel
        portion by __call__."""
        if self.kind == "source":
            return 1
        if self.kind == "join":
            return items
        return items[0] if items else 1

    def __call__(self, *items):
        a = max(1, self._workers.value) if self._workers is not None else 1
        serial = self.serial_frac * self.cost
        par = (self.cost - serial) + (a - 1) * serial
        t0 = time.process_time()
        out = self._produce(items)
        spent = max(0.0, time.process_time() - t0)   # real transform CPU
        if serial > 0:
            if self._lock is not None:
                with self._lock:
                    self._do_burn(serial)
            else:
                self._do_burn(serial)
        self._do_burn(max(0.0, par - spent))
        return out


class StreamSourceWork(SpinWork):
    """A rate-limited source: emits batch k only once the shared arrival
    curve says k batches have arrived — the process-plane realization of
    the sim's `min(arrival_rate(t), amdahl_rate)` service cap.

    The token bucket is a shared counter (`emitted`) claimed under its
    lock against `arrival.batches_before(now)`, where `now` is stream
    time measured from the pipeline's shared start stamp (`t0`,
    CLOCK_MONOTONIC is system-wide, so every worker reads the same
    clock). A worker that finds no token sleeps briefly and returns
    `_SKIP`; one that claims a token pays the stage's full SpinWork cost
    (serialized section included), so capacity still follows the Amdahl
    curve when arrivals outpace it.

    Until `attach_stream` is called the work degrades to a plain
    unthrottled source (so the fns dict stays usable outside
    ProcessPipeline)."""

    def __init__(self, cost: float, serial_frac: float = 0.0,
                 ballast_mb: float = 0.0, arrival=None):
        super().__init__(cost, serial_frac, ballast_mb, kind="source")
        self.arrival = arrival
        self._emitted = None
        self._t0 = None

    def attach_stream(self, emitted, t0):
        """Parent-side wiring before fork/spawn: the shared token counter
        and the pipeline's stream-epoch stamp."""
        self._emitted = emitted
        self._t0 = t0

    def __call__(self, *items):
        if self.arrival is None or self._emitted is None:
            return super().__call__(*items)
        now = time.monotonic() - self._t0.value
        with self._emitted.get_lock():
            if self._emitted.value < self.arrival.batches_before(now):
                self._emitted.value += 1
                claimed = True
            else:
                claimed = False
        if not claimed:
            time.sleep(0.005)     # ahead of the world: wait for arrivals
            return _SKIP
        return super().__call__(*items)


def spin_stage_fns(spec: StageGraph, *, ballast: bool = True
                   ) -> Dict[str, SpinWork]:
    """SpinWork per stage realizing the spec's true cost, serial_frac,
    and (with `ballast`) per-worker memory footprint — the process-plane
    analog of `live_fleet.synthetic_stage_fns`, with physics instead of
    sleeps. A stage carrying an `arrival` model becomes a rate-limited
    StreamSourceWork."""
    fns: Dict[str, SpinWork] = {}
    for st in spec.stages:
        mem = st.mem_per_worker_mb if ballast else 0.0
        if getattr(st, "arrival", None) is not None:
            fns[st.name] = StreamSourceWork(
                st.cost, st.serial_frac, ballast_mb=mem, arrival=st.arrival)
            continue
        kind = "source" if not st.inputs \
            else ("join" if len(st.inputs) > 1 else "map")
        fns[st.name] = SpinWork(
            st.cost, st.serial_frac, ballast_mb=mem, kind=kind)
    return fns


def stage_fns_for(spec: StageGraph, *, ballast: bool = True
                  ) -> Dict[str, Callable]:
    """Work fns matching the spec's `work` mode: `"spin"` (default) gets
    `spin_stage_fns`; `"real"` gets `featurize_stage_fns` — actual
    hashing/pooling/padding/collation over synthetic Criteo records
    (data/featurize.py), same Amdahl contract. Lazy import keeps the
    spin path free of the featurize module."""
    if getattr(spec, "work", "spin") == "real":
        from repro_torch.data.featurize import featurize_stage_fns
        return featurize_stage_fns(spec, ballast=ballast)
    return spin_stage_fns(spec, ballast=ballast)


# ---------------------------------------------------------------------------
# worker process plumbing
# ---------------------------------------------------------------------------

def _q_put(q, item, hard, gate=None, deadline=None) -> bool:
    while not hard.is_set():
        if deadline is not None and time.monotonic() >= deadline:
            return False
        if gate is not None:
            try:
                if q.qsize() >= max(1, gate.value):
                    time.sleep(0.002)    # live prefetch bound (re-boundable)
                    continue
            except NotImplementedError:  # platforms without qsize: ungated
                gate = None
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _q_get(q, soft, hard, stop_sent, committed: bool = False):
    """One item or None. A soft-stopped worker exits *between* items,
    but a gather that already holds items (`committed`) keeps waiting so
    the aligned join streams lose nothing on resize-down."""
    while not hard.is_set() and not stop_sent.is_set():
        if not committed and soft.is_set():
            return None
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            continue
    return None


def _gather(in_qs, soft, hard, stop_sent, gather_lock):
    """One item from each input queue (aligned for joins): the arg list,
    a _Stop at end of stream, or None if told to stop."""
    if gather_lock is None:
        item = _q_get(in_qs[0], soft, hard, stop_sent)
        if item is None:
            return None
        if isinstance(item, _Stop):
            return item
        return [item]
    # the lock is acquired with a timeout so siblings parked on it can
    # still honor a stop instead of blocking in acquire forever
    while not gather_lock.acquire(timeout=0.05):
        if hard.is_set() or stop_sent.is_set() or soft.is_set():
            return None
    try:
        items: List = []
        for q in in_qs:
            item = _q_get(q, soft, hard, stop_sent,
                          committed=bool(items))
            if item is None:
                return None
            if isinstance(item, _Stop):
                return item
            items.append(item)
        return items
    finally:
        gather_lock.release()


def _send_stop(stop_sent, out_qs, hard, gate):
    if not stop_sent.is_set():
        stop_sent.set()
        for q in out_qs:
            _q_put(q, _Stop(), hard, gate)


def _worker_main(fn, in_qs, out_qs, soft, hard, stop_sent, gather_lock,
                 serial_lock, nworkers, counter, gate, dropped, busy):
    """One stage worker process. Soft stop (resize-down / teardown)
    delivers the in-flight item if it can COMMIT it within a short
    grace; an uncommitted item is dropped (counted in `dropped`) so the
    worker exits promptly. Without the grace bound, a resize-down to a
    lean allocation would leave every retired worker alive and blocked
    on a full downstream queue that drains at consumer speed — tens of
    seconds of ghost processes stealing the very CPU the resize-down
    was meant to return. Only the hard stop aborts a committed
    delivery (an item already placed on one fan-out edge is pushed to
    the remaining edges unconditionally, keeping join streams
    aligned)."""
    # a forked worker shares the parent's heap copy-on-write; a gen-2 gc
    # pass would traverse (and dirty) every inherited object page,
    # turning shared memory private and blowing up the measured USS the
    # OOM judge scores. Workers allocate no reference cycles, so plain
    # refcounting is enough.
    import gc
    gc.disable()
    if hasattr(fn, "bind"):
        fn.bind(serial_lock, nworkers)
    try:
        _worker_loop(fn, in_qs, out_qs, soft, hard, stop_sent, gather_lock,
                     counter, gate, dropped, busy)
    finally:
        if hasattr(fn, "release"):
            fn.release()
    # NOTE: a retiring worker may still linger in its interpreter-exit
    # queue-feeder flush (items it already committed must cross the OS
    # pipe, which can take as long as the downstream backlog takes to
    # drain). That wait is blocked-in-write — no CPU — and must NOT be
    # short-circuited with cancel_join_thread(): killing a feeder that
    # holds the queue write lock mid-write orphans the lock and wedges
    # every other writer on that queue permanently. `fn.release()` above
    # frees the ballast first so the ghost holds no pipeline memory.


def _add(value, x: float):
    with value.get_lock():
        value.value += x


def _worker_loop(fn, in_qs, out_qs, soft, hard, stop_sent, gather_lock,
                 counter, gate, dropped, busy):
    """Serve items until stopped. `busy` gains the wall seconds spent
    inside `fn` (skipped and filtered items too): the stage's service
    time, with no queue wait in it."""
    while not soft.is_set() and not hard.is_set():
        if not in_qs:                       # source stage
            if stop_sent.is_set():          # a sibling hit EOS
                return
            t0 = time.monotonic()
            out = fn()
            _add(busy, time.monotonic() - t0)
            if isinstance(out, _Skip):      # rate-limited: no arrival yet
                continue
            if out is None:
                _send_stop(stop_sent, out_qs, hard, gate)
                return
        else:
            got = _gather(in_qs, soft, hard, stop_sent, gather_lock)
            if got is None:
                if stop_sent.is_set():
                    return
                continue
            if isinstance(got, _Stop):
                _send_stop(stop_sent, out_qs, hard, gate)
                return
            t0 = time.monotonic()
            out = fn(*got)
            _add(busy, time.monotonic() - t0)
            if out is None:                 # filtered item
                continue
        delivered = True
        committed = False
        for q in out_qs:
            grace = time.monotonic() + 0.25 \
                if soft.is_set() and not committed else None
            ok = _q_put(q, out, hard, gate, deadline=grace)
            if not ok and grace is not None and not hard.is_set():
                # retiring, and the item landed nowhere: drop it and go
                _add(dropped, 1)
                break
            committed = committed or ok
            delivered = ok and delivered
        else:
            if delivered:
                _add(counter, 1)
            continue
        return


class _ProcStagePool:
    """Resizable worker-process pool for one graph stage (the process
    analog of executor._StagePool: same soft/hard stop split, same
    retired-handle accounting for the teardown leak check)."""

    def __init__(self, name: str, fn: Callable, in_qs: Sequence,
                 out_qs: Sequence, ctx, hard_stop, workers: int = 1,
                 out_gate=None, on_spawn: Optional[Callable] = None):
        self.name = name
        self.fn = fn
        self.in_qs = list(in_qs)
        self.out_qs = list(out_qs)
        self._ctx = ctx
        self._hard = hard_stop
        self.stop_sent = ctx.Event()
        self.counter = ctx.Value("L", 0)            # delivered items
        self.dropped_ct = ctx.Value("L", 0)         # fast-retire drops
        self.busy = ctx.Value("d", 0.0)             # s inside the stage fn
        self.nworkers_val = ctx.Value("i", 1, lock=False)
        self.serial_lock = ctx.Lock()
        self.gather_lock = ctx.Lock() if len(self.in_qs) > 1 else None
        self.out_gate = out_gate
        self._on_spawn = on_spawn
        self.meter = _RateMeter()                   # parent-side, counter-fed
        self.procs: List = []
        self._soft_flags: List = []
        self._retired: List = []
        self.resize(workers)

    # ---------------------------------------------------------- control ---
    def resize(self, n: int):
        n = max(1, int(n))
        while len(self.procs) < n:
            soft = self._ctx.Event()
            p = self._ctx.Process(
                target=_worker_main,
                args=(self.fn, self.in_qs, self.out_qs, soft, self._hard,
                      self.stop_sent, self.gather_lock, self.serial_lock,
                      self.nworkers_val, self.counter, self.out_gate,
                      self.dropped_ct, self.busy),
                daemon=True)
            p.start()
            if self._on_spawn is not None:
                self._on_spawn(p.pid)
            self.procs.append(p)
            self._soft_flags.append(soft)
        while len(self.procs) > n:
            self._retired = [p for p in self._retired if p.is_alive()]
            self._soft_flags.pop().set()            # soft stop: delivers
            self._retired.append(self.procs.pop())
        # SpinWork reads this to size the Amdahl coordination penalty:
        # the service curve tracks the live pool size
        self.nworkers_val.value = n

    @property
    def n_workers(self) -> int:
        return len(self.procs)

    def delivered(self) -> int:
        return int(self.counter.value)

    def dropped(self) -> int:
        """Items dropped by retiring workers that could not commit
        their in-flight delivery within the fast-retire grace."""
        return int(self.dropped_ct.value)

    def busy_s(self) -> float:
        """Wall seconds the pool's workers have spent inside the stage
        function, summed over workers (`_worker_loop`)."""
        return float(self.busy.value)

    def sync_meter(self):
        """Feed the shared-counter delta into the EWMA meter (decays on
        read like the thread meters — satellite of the stale-rate fix)."""
        self.meter.mark_many(self.delivered() - self.meter.count)

    def pids(self) -> List[int]:
        return [p.pid for p in self.procs + self._retired if p.is_alive()]

    def cpu_s(self) -> float:
        """Cumulative CPU seconds consumed by the pool's live workers
        (calibration reads deltas of this across a measurement window)."""
        return sum(filter(None, (read_cpu_s(pid) for pid in self.pids())))

    def stop(self):
        for f in self._soft_flags:
            f.set()

    def join(self, timeout: float = 2.0) -> bool:
        """Join every process this pool ever started. Returns True when
        all exited within the deadline; stragglers are then terminated
        (and as a last resort killed) so OS processes can never leak."""
        deadline = time.monotonic() + timeout
        ok = True
        for p in self.procs + self._retired:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            ok = ok and not p.is_alive()
        for p in self.procs + self._retired:
            if p.is_alive():
                p.terminate()
                p.join(0.5)
            if p.is_alive():
                p.kill()
                p.join(0.5)
        return ok


class _RssSampler(threading.Thread):
    """Parent-side thread summing measured resident MB over the worker
    processes every `interval` seconds (`sample()` also runs one
    synchronous pass, so stats() reads are never stale).

    Each worker is charged its GROWTH since spawn (`baselines`: pid ->
    reading taken right after fork): kernels differ on how much of a
    forked child's inherited copy-on-write image leaks into per-process
    private/Pss accounting (this repo has seen a 4.4 kernel report the
    whole parent heap as the child's private pages), and none of that
    memory is the pipeline's. What the pipeline ALLOCATES — ballast,
    queue buffers, interpreter arenas — is growth over the baseline on
    every kernel.
    """

    def __init__(self, pids_fn: Callable[[], List[int]],
                 baselines: Dict[int, float], interval: float = 0.05):
        super().__init__(daemon=True)
        self._pids_fn = pids_fn
        self._baselines = baselines
        self.interval = interval
        self.rss_mb = 0.0
        self.peak_mb = 0.0
        self._halt = threading.Event()

    def sample(self) -> float:
        total, got = 0.0, False
        for pid in self._pids_fn():
            mb = read_rss_mb(pid)
            if mb is not None:
                total += max(0.0, mb - self._baselines.get(pid, 0.0))
                got = True
        if got:
            self.rss_mb = total
            self.peak_mb = max(self.peak_mb, total)
        return self.rss_mb

    def run(self):
        while not self._halt.is_set():
            t0 = time.monotonic()
            self.sample()
            cost = time.monotonic() - t0
            # bound the sampler's duty cycle at ~10% of one core: a pass
            # walks /proc smaps for every live worker pid IN THE PARENT
            # (trainer) process, and during a resize-down the pid set
            # transiently includes every retiring worker — at a fixed
            # interval that scan competes with the very device step the
            # resize was meant to unblock
            self._halt.wait(max(self.interval, 9.0 * cost))

    def stop(self):
        self._halt.set()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class ProcessPipeline:
    """Runs a StageGraph with one OS-process pool per stage;
    `get_batch()` feeds the trainer. ThreadedPipeline's exact contract
    (DESIGN.md §9 has the side-by-side table); differences are physics:
    measured RSS instead of budget accounting, real core contention,
    real serialized sections.

    `fns` default to `spin_stage_fns(spec)`. Custom fns must be
    picklable under the chosen start method ("fork" where available, so
    closures work on Linux; pass `ctx=multiprocessing.get_context(...)`
    to override).
    """

    def __init__(self, spec: StageGraph, *,
                 fns: Optional[Dict[str, Callable]] = None,
                 queue_depth: int = 16, item_mb: Optional[float] = None,
                 machine: Optional[MachineSpec] = None, ctx=None,
                 rss_interval: float = 0.2,
                 pin_cpus: Optional[int] = None):
        if fns is None:
            fns = stage_fns_for(spec)
        missing = [s.name for s in spec.stages if s.name not in fns]
        assert not missing, f"missing stage fns: {missing}"
        self.spec = spec
        self.item_mb = item_mb if item_mb is not None else spec.batch_mb
        self.machine = machine if machine is not None else MachineSpec()
        # feed-bridge knob: cap worker affinity to this many host cores
        # regardless of machine.n_cpus, reserving the rest for a trainer
        # process sharing the host (examples/train_dlrm_criteo.py pins
        # the feed pipeline to 1 core so JAX keeps the others)
        self.pin_cpus = pin_cpus
        self.prefetch_mb = 2 * self.item_mb
        if ctx is None:
            method = "fork" if "fork" in mp.get_all_start_methods() \
                else "spawn"
            ctx = mp.get_context(method)
        self._ctx = ctx
        # calibrate the spin-work clock BEFORE forking, so every worker
        # inherits one shared iterations/CPU-second figure (once per
        # interpreter; spawned workers recalibrate on bind)
        spin_rate()
        self.edge_queues: Dict[tuple, object] = {
            e: ctx.Queue(maxsize=queue_depth) for e in spec.edges}
        self.out_q = ctx.Queue(maxsize=_OUT_QUEUE_CAP)
        # the agent's prefetch knob: sink workers gate their puts on this
        # shared depth, so set_allocation re-bounds the output live
        self._out_depth = ctx.Value("i", self._prefetch_depth(), lock=False)
        self._eos = False
        self._hard_stop = ctx.Event()
        self._rss_baseline: Dict[int, float] = {}
        self._last_resize_at = 0.0
        # streaming source wiring: shared token counter + stream epoch,
        # attached parent-side so every forked/spawned worker claims
        # against the same arrival curve
        self._stream_arrival = None
        self._stream_emitted = None
        self._stream_t0 = None
        for st in spec.stages:
            fn = fns[st.name]
            if getattr(st, "arrival", None) is not None \
                    and hasattr(fn, "attach_stream"):
                self._stream_arrival = st.arrival
                self._stream_emitted = ctx.Value("L", 0)
                self._stream_t0 = ctx.Value("d", time.monotonic())
                fn.attach_stream(self._stream_emitted, self._stream_t0)
                break                       # StageGraph enforces <= 1
        self.pools: List[_ProcStagePool] = []
        for i, st in enumerate(spec.stages):
            in_qs = [self.edge_queues[(p, i)] for p in spec.parents(i)]
            out_qs = [self.edge_queues[(i, c)] for c in spec.children(i)]
            gate = None
            if i == spec.sink:
                out_qs = [self.out_q]
                gate = self._out_depth
            self.pools.append(_ProcStagePool(
                st.name, fns[st.name], in_qs, out_qs, ctx, self._hard_stop,
                workers=1, out_gate=gate, on_spawn=self._on_spawn))
        self.out_meter = _RateMeter()
        self._sampler = _RssSampler(self._worker_pids, self._rss_baseline,
                                    interval=rss_interval)
        self._sampler.sample()
        self._sampler.start()

    def _prefetch_depth(self) -> int:
        return max(1, int(self.prefetch_mb / max(self.item_mb, 1e-6)))

    def _worker_pids(self) -> List[int]:
        return [pid for p in self.pools for pid in p.pids()]

    # ----------------------------------------------------- physical caps --
    def _on_spawn(self, pid: int):
        """Per-worker spawn hook: record the memory baseline (the
        sampler charges growth since spawn, not the inherited image —
        see _RssSampler) and pin the worker to the capped core set."""
        self._rss_baseline[pid] = read_rss_mb(pid) or 0.0
        self._pin_worker(pid)

    def _pin_worker(self, pid: int):
        """Best-effort: pin the worker to the first min(machine cap, host
        cores) cores, so a resize event shrinks the silicon the pipeline
        may touch (the physical realization of the sim's CPU cap)."""
        if not hasattr(os, "sched_setaffinity"):
            return
        host = os.cpu_count() or 1
        cap = int(self.pin_cpus) if self.pin_cpus is not None \
            else int(self.machine.n_cpus)
        try:
            os.sched_setaffinity(pid, range(max(1, min(cap, host))))
        except OSError:
            pass

    def apply_cpu_cap(self):
        """Re-pin every live worker after a machine resize."""
        for pid in self._worker_pids():
            self._pin_worker(pid)

    # ----------------------------------------------------------- control --
    def worker_counts(self) -> List[int]:
        return [p.n_workers for p in self.pools]

    def set_allocation(self, workers, prefetch_mb: float):
        before = self.worker_counts()
        for pool, w in zip(self.pools, workers):
            pool.resize(int(w))
        self.prefetch_mb = float(prefetch_mb)
        self._out_depth.value = self._prefetch_depth()
        if self.worker_counts() != before:
            # fresh workers self-calibrate for ~0.2s before producing;
            # measure() uses this stamp to flag the settling window
            self._last_resize_at = time.monotonic()

    @property
    def prefetch_depth(self) -> int:
        return self._out_depth.value

    def rss_mb(self) -> float:
        """Measured resident MB summed over the worker processes, now."""
        return self._sampler.sample()

    def stream_state(self) -> Optional[dict]:
        """Exact stream accounting, or None for non-stream graphs:
        arrivals is the arrival curve's integral at stream time `t`,
        emitted the tokens claimed by source workers, backlog their gap
        (batches that have arrived but not yet entered the pipeline)."""
        if self._stream_arrival is None:
            return None
        t = time.monotonic() - self._stream_t0.value
        arrivals = self._stream_arrival.batches_before(t)
        emitted = float(self._stream_emitted.value)
        return {"t": t, "arrivals": arrivals, "emitted": emitted,
                "backlog": max(0.0, arrivals - emitted),
                "arrival_rate": self._stream_arrival.batches_per_sec(t)}

    def stream_epoch(self) -> Optional[dict]:
        """The stream's persistent identity: the monotonic t0 anchoring
        its arrival curve plus the tokens already emitted against it.
        None for non-stream graphs. A relaunch that adopts this epoch
        RESUMES the curve — stream time keeps running through the dead
        window, so backlog accrues while the process is down (the
        simulator's "the world does not pause for an OOM" contract)."""
        if self._stream_arrival is None:
            return None
        return {"emitted": int(self._stream_emitted.value),
                "t0": float(self._stream_t0.value)}

    def adopt_stream_epoch(self, epoch: Optional[dict]):
        """Resume a predecessor's arrival curve instead of starting a
        fresh one. Must be called before the first tokens are claimed
        (RigSlot adopts immediately after relaunch). No-op for
        non-stream graphs or a None epoch."""
        if self._stream_arrival is None or not epoch:
            return
        with self._stream_emitted.get_lock():
            self._stream_emitted.value = int(epoch["emitted"])
        # ctx.Value mutations are visible to already-forked workers:
        # both fields live in shared memory
        self._stream_t0.value = float(epoch["t0"])

    def stats(self) -> dict:
        for p in self.pools:
            p.sync_meter()
        rates = [p.meter.rate for p in self.pools]
        lat = [1.0 / r if r > 0 else 10.0 for r in rates]

        def _qs(q):
            try:
                return q.qsize()
            except NotImplementedError:
                return 0

        edge_sizes = [_qs(q) for q in self.edge_queues.values()]
        # the sampler's cached reading (at most rss_interval stale): a
        # synchronous re-scan here would walk /proc smaps a second time
        # per tick on the driver's hot path — the OOM judge calls
        # rss_mb() when it needs a fresh verdict
        rss = self._sampler.rss_mb
        stream = self.stream_state()
        extra = {} if stream is None else {
            "backlog_items": stream["backlog"],
            "arrival_rate": stream["arrival_rate"]}
        return {
            **extra,
            "throughput": self.out_meter.rate,
            "stage_rate": rates,
            "stage_latency": lat,
            "queue_sizes": edge_sizes + [_qs(self.out_q)],
            "workers": self.worker_counts(),
            "prefetch_mb": self.prefetch_mb,
            # MEASURED, not declared: the sampler's resident bytes
            "mem_frac": rss / self.machine.mem_mb,
            "free_cpus": max(0, self.machine.n_cpus
                             - sum(self.worker_counts())),
            "counts": [p.meter.count for p in self.pools],
            "rss_mb": rss,
        }

    # ------------------------------------------------------ measurement --
    def counters(self) -> dict:
        """Monotonic batch counters + timestamp (ThreadedPipeline's
        measured-window contract; `delivered` reads the sink pool's
        shared cross-process counter). `stage_busy_s` is each stage's
        summed service time (`_ProcStagePool.busy_s`), in `spec.stages`
        order, and `workers` the pools' sizes: over a window, a stage is
        busy delta(stage_busy_s) / (workers x delta(time)) of the time."""
        return {"delivered": self.pools[self.spec.sink].delivered(),
                "consumed": self.out_meter.count,
                "time": time.monotonic(),
                "last_resize_at": self._last_resize_at,
                "stage_busy_s": [p.busy_s() for p in self.pools],
                "workers": self.worker_counts()}

    window_rate = staticmethod(ThreadedPipeline.window_rate)

    # ----------------------------------------------------------- teardown --
    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> dict:
        """Graceful teardown honoring the soft/hard stop split (the
        ThreadedPipeline contract: soft-stop, drain, hard-stop, join —
        with `dropped` accounting; drain=False models an OOM kill)."""
        deadline = time.monotonic() + timeout
        for p in self.pools:
            p.stop()
        drained = 0
        sink_pool = self.pools[self.spec.sink]
        if drain:
            while time.monotonic() < deadline:
                try:
                    if not isinstance(self.out_q.get_nowait(), _Stop):
                        drained += 1
                except queue.Empty:
                    if not any(pr.is_alive() for pr in sink_pool.procs):
                        break
                    time.sleep(0.005)
        self._hard_stop.set()
        # pump every queue while workers exit: a worker whose interpreter
        # is flushing buffered queue items at exit blocks on a full pipe
        # until a reader empties it. The spin plane's int-sized items
        # never fill the 64KB pipe buffer; real-work record blocks
        # (data/featurize.py) overflow it at depth 1, so without this
        # pump every mid-chain worker would hang in its exit flush and
        # eat the whole join deadline before being terminated.
        def _alive():
            return any(pr.is_alive() for pool in self.pools
                       for pr in pool.procs + pool._retired)

        pump_end = max(deadline - 0.5, time.monotonic() + 0.05)
        while _alive() and time.monotonic() < pump_end:
            for q in self.edge_queues.values():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            try:
                while True:
                    if not isinstance(self.out_q.get_nowait(), _Stop) \
                            and drain:
                        drained += 1
            except queue.Empty:
                pass
            time.sleep(0.01)
        joined = True
        for p in self.pools:
            joined = p.join(max(0.1, deadline - time.monotonic())) and joined
        if drain:
            # final sweep with a short grace: a queue item written just
            # before the writer exited can land a moment after the join
            grace = time.monotonic() + 0.25
            while True:
                try:
                    if not isinstance(self.out_q.get(timeout=0.05), _Stop):
                        drained += 1
                except queue.Empty:
                    if time.monotonic() > grace:
                        break
        self._sampler.stop()
        delivered = sink_pool.delivered()
        consumed = self.out_meter.count
        for q in list(self.edge_queues.values()) + [self.out_q]:
            # lint: allow[no-cancel-join-thread] -- parent-side only, after every worker was joined/terminated/killed above; a straggler terminated mid-write leaves the queue's write lock orphaned, and without this the PARENT's feeder thread blocks forever on it at close(). The only parent data at risk here is the re-put _Stop sentinel.
            q.cancel_join_thread()
            q.close()
        return {"delivered": delivered, "consumed": consumed,
                "drained": drained, "joined": joined,
                "dropped": (max(0, delivered - consumed - drained)
                            if drain else 0),
                "dropped_inflight": sum(p.dropped() for p in self.pools)}

    # ------------------------------------------------------------ output --
    def get_batch(self, timeout: float = 10.0):
        if self._eos and self.out_q.empty():
            raise StopIteration
        item = self.out_q.get(timeout=timeout)
        if isinstance(item, _Stop):
            self._eos = True
            try:
                self.out_q.put_nowait(item)     # for sibling consumers
            except queue.Full:
                pass
            raise StopIteration
        self.out_meter.mark()
        return item

    def stop(self):
        self._hard_stop.set()
        for p in self.pools:
            p.stop()
        self._sampler.stop()
