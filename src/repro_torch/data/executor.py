"""Threaded StageGraph executor: the REAL data path InTune tunes live.

Per-stage worker pools over one bounded queue per graph edge (tf.data-
isomorphic knob surface: workers per stage, prefetch buffer MB). Source
stages (no inputs) pull from their source fn; join stages (several
inputs) gather one item from EACH input edge — the gather is serialized
per stage so multi-worker joins keep the input streams aligned — and
fan-out stages broadcast their output onto every outgoing edge. The sink
stage feeds a dedicated output queue whose bound realizes the prefetch
budget (`set_allocation` re-bounds it live). Pools resize on the fly —
`set_allocation` is what the controller's live_tick drives. Rate meters
(EWMA batches/s per stage) provide the Table-2 observations.

On this 1-CPU container the executor proves correctness and the control
plumbing (quickstart example + tests); the throughput *numbers* for the
paper's figures come from the calibrated simulator (DESIGN.md §3).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence


from repro_torch.data.pipeline import StageGraph
from repro_torch.data.simulator import MachineSpec

_STOP = object()


def _set_maxsize(q: "queue.Queue", n: int):
    """Re-bound a live queue: maxsize is only read under q.mutex at
    put/get time, so adjusting it there is race-free."""
    with q.mutex:
        q.maxsize = n
        q.not_full.notify_all()


class _RateMeter:
    """EWMA batches/s meter shared by the thread and process planes.

    `mark()` feeds it one event (threaded workers); `mark_many(n)` feeds
    a counter delta (the process plane syncs shared delivered-counters
    into the same meter). `rate` is decayed ON READ: a meter whose EWMA
    only updated at mark time would report its last healthy rate forever
    once the stage starved or died, going stale exactly when the
    Table-2 observation matters most — so a read caps the EWMA at
    `1 / (time since the last mark)`, which is a no-op while marks are
    on schedule and falls toward 0 for a stalled stage.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._ewma = 0.0
        self._last: Optional[float] = None
        self.count = 0
        self._lock = threading.Lock()

    def mark(self):
        self.mark_many(1)

    def mark_many(self, n: int, now: Optional[float] = None):
        """Record `n` events since the previous mark (n=1 is a plain
        mark; the process plane passes shared-counter deltas)."""
        if n <= 0:
            return
        if now is None:
            now = time.monotonic()
        with self._lock:
            self.count += n
            if self._last is not None:
                dt = max(now - self._last, 1e-6)
                inst = n / dt
                self._ewma = (1 - self.alpha) * self._ewma \
                    + self.alpha * inst
            self._last = now

    @property
    def rate(self) -> float:
        with self._lock:
            if self._last is None:
                return 0.0
            overdue = time.monotonic() - self._last
            if overdue <= 1e-9:
                return self._ewma
            # while healthy the gap since the last mark is < 1/rate, so
            # the cap is inert; a starved/dead stage decays as 1/overdue
            return min(self._ewma, 1.0 / overdue)


class _StagePool:
    """Resizable worker pool for one graph stage.

    in_qs == []   : source — fn() -> item, None = end of stream.
    len(in_qs) 1+ : fn(*items) -> item; None output = filtered (dropped).
    Output is broadcast to every out queue (fan-out edges).

    EOS caveat: with a multi-worker source over a finite stream, a sibling
    mid-produce when another worker observes EOS may enqueue its item
    after the _STOP sentinel — up to workers-1 trailing items can be
    dropped at end of stream (infinite training streams never hit this).
    """

    def __init__(self, name: str, fn: Callable, in_qs: Sequence,
                 out_qs: Sequence, workers: int = 1,
                 hard_stop: Optional[threading.Event] = None):
        self.name = name
        self.fn = fn
        self.in_qs = list(in_qs)
        self.out_qs = list(out_qs)
        self.meter = _RateMeter()
        self.threads: List[threading.Thread] = []
        self._stop_flags: List[threading.Event] = []
        # pipeline-wide teardown. A worker's own flag is a SOFT stop
        # (resize-down): it still delivers its in-flight item so nothing
        # is lost mid-stream. Only the hard stop aborts blocked puts.
        self._hard_stop = hard_stop if hard_stop is not None \
            else threading.Event()
        # joins gather one item per input under this lock so concurrent
        # workers can't interleave (item i of stream A with item j of B);
        # _partial stashes a gather interrupted by a worker stop (resize-
        # down) so the next worker resumes it instead of dropping items
        self._gather_lock = threading.Lock() if len(self.in_qs) > 1 else None
        self._partial: List = []
        self._stop_sent = threading.Event()
        self._retired: List[threading.Thread] = []
        self.resize(workers)

    # --------------------------------------------------------- plumbing ---
    def _send_stop(self):
        if not self._stop_sent.is_set():
            self._stop_sent.set()
            for q in self.out_qs:
                self._put(q, _STOP)

    def _get(self, q, stop: threading.Event):
        while not stop.is_set() and not self._stop_sent.is_set() \
                and not self._hard_stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _put(self, q, item):
        while not self._hard_stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _gather(self, stop: threading.Event):
        """One item from each input queue (aligned for joins). Returns the
        arg list, _STOP at end of stream, or None if told to stop."""
        # No _STOP re-put for siblings here: _send_stop sets _stop_sent,
        # which every sibling's _get polls, so they exit on their own — a
        # blocking re-put into a full queue would wedge the stage instead.
        if self._gather_lock is None:
            item = self._get(self.in_qs[0], stop)
            if item is None:
                return None
            if item is _STOP:
                return _STOP
            return [item]
        with self._gather_lock:
            items = self._partial
            for q in self.in_qs[len(items):]:
                item = self._get(q, stop)
                if item is None:
                    self._partial = items   # resume here next gather
                    return None
                if item is _STOP:
                    return _STOP
                items.append(item)
            self._partial = []
            return items

    def _worker(self, stop: threading.Event):
        while not stop.is_set() and not self._hard_stop.is_set():
            if not self.in_qs:                      # source stage
                if self._stop_sent.is_set():        # a sibling hit EOS
                    return
                out = self.fn()
                if out is None:
                    self._send_stop()
                    return
            else:
                got = self._gather(stop)
                if got is None:
                    if self._stop_sent.is_set():
                        return
                    continue
                if got is _STOP:
                    self._send_stop()
                    return
                out = self.fn(*got)
                if out is None:                     # filtered item
                    continue
            delivered = True
            for q in self.out_qs:
                delivered = self._put(q, out) and delivered
            if delivered:
                self.meter.mark()

    # ---------------------------------------------------------- control ---
    def resize(self, n: int):
        n = max(1, int(n))
        while len(self.threads) < n:
            stop = threading.Event()
            t = threading.Thread(target=self._worker, args=(stop,),
                                 daemon=True)
            t.start()
            self.threads.append(t)
            self._stop_flags.append(stop)
        while len(self.threads) > n:
            # SOFT stop: the worker delivers its in-flight item, then
            # exits; keep the handle so teardown can join it (leak
            # check). Handles that already exited need no join — prune
            # them so per-tick re-allocation can't grow this unboundedly.
            self._retired = [t for t in self._retired if t.is_alive()]
            self._stop_flags.pop().set()
            self._retired.append(self.threads.pop())

    @property
    def n_workers(self) -> int:
        return len(self.threads)

    def stop(self):
        for f in self._stop_flags:
            f.set()

    def join(self, timeout: float = 2.0) -> bool:
        """Join every thread this pool ever started (live + retired).
        Returns True when all of them exited within the deadline."""
        deadline = time.monotonic() + timeout
        ok = True
        for t in self.threads + self._retired:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            ok = ok and not t.is_alive()
        return ok


class ThreadedPipeline:
    """Runs a StageGraph with real threads; get_batch() feeds the trainer.

    Two construction forms:
      - DAG form: ThreadedPipeline(spec, fns={stage_name: fn}) — source
        fns take no args, a join stage's fn takes one arg per input (in
        spec order), every other fn takes one.
      - legacy linear form: ThreadedPipeline(spec, source_fn, stage_fns)
        with one fn per non-source stage of a linear chain.

    `machine` sizes the stats() observation contract (mem_frac, free_cpus)
    the same way PipelineEnv.observe sizes the simulator's.
    """

    def __init__(self, spec: StageGraph, source_fn: Optional[Callable] = None,
                 stage_fns: Optional[Sequence[Callable]] = None,
                 queue_depth: int = 16, item_mb: Optional[float] = None,
                 *, fns: Optional[Dict[str, Callable]] = None,
                 machine: Optional[MachineSpec] = None):
        if fns is None:
            assert spec.is_linear, \
                "positional (source_fn, stage_fns) form is for linear " \
                "chains; pass fns={stage_name: fn} for a DAG"
            assert source_fn is not None and stage_fns is not None
            assert len(stage_fns) == spec.n_stages - 1, \
                "one fn per non-source stage"
            fns = {spec.stages[0].name: source_fn}
            fns.update({s.name: fn
                        for s, fn in zip(spec.stages[1:], stage_fns)})
        missing = [s.name for s in spec.stages if s.name not in fns]
        assert not missing, f"missing stage fns: {missing}"
        self.spec = spec
        self.item_mb = item_mb if item_mb is not None else spec.batch_mb
        self.machine = machine if machine is not None else MachineSpec()
        self.prefetch_mb = 2 * self.item_mb
        # one bounded queue per graph edge + the sink's output queue,
        # whose bound realizes the prefetch budget
        self.edge_queues: Dict[tuple, queue.Queue] = {
            e: queue.Queue(maxsize=queue_depth) for e in spec.edges}
        # the output bound IS the prefetch budget, from construction on
        self.out_q = queue.Queue(maxsize=self._prefetch_depth())
        self._eos = False
        self._hard_stop = threading.Event()
        self.pools: List[_StagePool] = []
        for i, st in enumerate(spec.stages):
            in_qs = [self.edge_queues[(p, i)] for p in spec.parents(i)]
            out_qs = [self.edge_queues[(i, c)] for c in spec.children(i)]
            if i == spec.sink:
                out_qs = [self.out_q]
            self.pools.append(_StagePool(st.name, fns[st.name], in_qs,
                                         out_qs, workers=1,
                                         hard_stop=self._hard_stop))
        self.out_meter = _RateMeter()

    def _prefetch_depth(self) -> int:
        return max(1, int(self.prefetch_mb / max(self.item_mb, 1e-6)))

    # ----------------------------------------------------------- control --
    def worker_counts(self) -> List[int]:
        return [p.n_workers for p in self.pools]

    def set_allocation(self, workers, prefetch_mb: float):
        for pool, w in zip(self.pools, workers):
            pool.resize(int(w))
        self.prefetch_mb = float(prefetch_mb)
        # the agent's prefetch knob IS the output queue bound: re-bound it
        # live so a shrunk budget back-pressures the sink immediately
        _set_maxsize(self.out_q, self._prefetch_depth())

    @property
    def prefetch_depth(self) -> int:
        return self.out_q.maxsize

    def stats(self) -> dict:
        rates = [p.meter.rate for p in self.pools]
        lat = [1.0 / r if r > 0 else 10.0 for r in rates]
        edge_sizes = [q.qsize() for q in self.edge_queues.values()]
        qsizes = edge_sizes + [self.out_q.qsize()]
        # prefetch budget charged once (the simulator's contract); items
        # sitting in the output queue live inside that budget
        mem_mb = sum(edge_sizes) * self.item_mb + self.prefetch_mb
        return {
            "throughput": self.out_meter.rate,
            "stage_rate": rates,
            "stage_latency": lat,
            "queue_sizes": qsizes,
            "workers": self.worker_counts(),
            "prefetch_mb": self.prefetch_mb,
            "mem_frac": mem_mb / self.machine.mem_mb,
            "free_cpus": max(0, self.machine.n_cpus
                             - sum(self.worker_counts())),
            "counts": [p.meter.count for p in self.pools],
        }

    # ------------------------------------------------------ measurement --
    def counters(self) -> dict:
        """Monotonic batch counters + timestamp for measured-throughput
        windows. A window rate is a counter DELTA over the measured
        elapsed between two snapshots — free of the EWMA meters' wall-
        clock decay state, so it stays rank-stable under CI scheduler
        contention. `delivered` counts batches the sink stage put into
        the output queue; `consumed` counts batches handed to the
        trainer via get_batch()."""
        return {"delivered": self.pools[self.spec.sink].meter.count,
                "consumed": self.out_meter.count,
                "time": time.monotonic()}

    @staticmethod
    def window_rate(before: dict, after: dict, key: str = "consumed") -> float:
        """Batches/s between two counters() snapshots."""
        dt = max(after["time"] - before["time"], 1e-9)
        return (after[key] - before[key]) / dt

    # ----------------------------------------------------------- teardown --
    def shutdown(self, drain: bool = True, timeout: float = 5.0) -> dict:
        """Graceful teardown honoring the soft/hard stop split.

        Soft-stops every pool first (each worker delivers its in-flight
        item — a churn-driven leave/resize must not lose batches mid-
        stream), drains batches still parked in the output queue so the
        sink workers can flush, then hard-stops and joins every thread
        this pipeline ever started. Returns the accounting a clean leave
        is judged on: `dropped` = delivered - consumed - drained is 0
        when no sink-delivered batch was lost. `drain=False` models a
        crash (OOM kill): no drain pass, in-flight batches are lost.
        """
        deadline = time.monotonic() + timeout
        for p in self.pools:
            p.stop()
        drained = 0
        sink_pool = self.pools[self.spec.sink]
        if drain:
            # keep emptying the output queue until the sink workers have
            # flushed their in-flight items and exited — a full queue
            # would otherwise wedge their final (soft-stopped) delivery
            while time.monotonic() < deadline:
                try:
                    if self.out_q.get_nowait() is not _STOP:
                        drained += 1
                except queue.Empty:
                    if not any(t.is_alive() for t in sink_pool.threads):
                        break
                    time.sleep(0.005)
        self._hard_stop.set()
        # join BEFORE the final sweep: a worker still blocked in a put
        # could land one more item the moment the sweep makes room
        joined = True
        for p in self.pools:
            joined = p.join(max(0.1, deadline - time.monotonic())) and joined
        while True:
            try:
                if self.out_q.get_nowait() is not _STOP:
                    drained += 1
            except queue.Empty:
                break
        delivered = sink_pool.meter.count
        consumed = self.out_meter.count
        return {"delivered": delivered, "consumed": consumed,
                "drained": drained, "joined": joined,
                "dropped": (max(0, delivered - consumed - drained)
                            if drain else 0)}

    # ------------------------------------------------------------ output --
    def get_batch(self, timeout: float = 10.0):
        if self._eos and self.out_q.empty():
            raise StopIteration
        item = self.out_q.get(timeout=timeout)
        if item is _STOP:
            self._eos = True
            try:
                self.out_q.put_nowait(_STOP)   # for sibling consumers
            except queue.Full:
                pass
            raise StopIteration
        self.out_meter.mark()
        return item

    def stop(self):
        self._hard_stop.set()
        for p in self.pools:
            p.stop()
