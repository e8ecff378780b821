"""Double-buffered host->device feed: overlap ingestion with compute.

Port of repro/data/device_feed.py. Wraps any iterator of batches (dicts
of numpy arrays or tensors); while the model runs step t, batch t+1 is
already crossing to the device. On a pod, each host feeds only its shard
of the global batch (`shard_slice`). This is the "prefetch to
accelerator" stage of the paper's pipeline, realized for PyTorch.

The prefetcher is a background producer THREAD feeding a bounded buffer,
so `depth` batches are genuinely in flight and a stall only accrues when
the buffer is empty — i.e. the pipeline fell behind by more than the
prefetch budget.

On CUDA the producer copies each batch into pinned host memory and on to
the device with `non_blocking=True` on a side stream, and records an
event after the copies; the consumer makes its current stream wait on
that event and marks every tensor with `record_stream`, so the caching
allocator never recycles a batch the train step is still reading. On the
CPU batches pass straight through (`torch.as_tensor`, no copy).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import torch


class ShardError(ValueError):
    """A global batch cannot be split evenly across hosts."""


_SENTINEL = object()


class DevicePrefetcher:
    """Iterator of device-resident batches with `depth` genuinely in
    flight: a daemon producer thread pulls from `it`, copies each batch
    to `device` (asynchronously on CUDA — the copy overlaps compute),
    and parks results in a buffer. A counting semaphore of `depth`
    permits bounds the in-flight set: the producer acquires a permit per
    pull, the consumer releases one per yield, so at most `depth`
    batches sit between the upstream iterator and the consumer.

    Shutdown: upstream exhaustion or error lands a sentinel in the
    buffer (the error re-raises on the consumer's stack); `close()`
    stops the producer and joins it. Iterating to StopIteration also
    joins the thread, so the common full-drain path needs no explicit
    close.
    """

    def __init__(self, it: Iterator, depth: int = 2, device="cuda",
                 on_close: Optional[Callable[[], None]] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._it = it
        self._device = torch.device(device)
        self._copy_stream = torch.cuda.Stream(device=self._device) \
            if self._device.type == "cuda" else None
        self._on_close = on_close
        self._q: "queue.Queue" = queue.Queue()
        self._sem = threading.Semaphore(depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, batch):
        """(device batch, copy-done event or None)."""
        if self._copy_stream is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._copy_stream):
            out = {k: torch.as_tensor(v).pin_memory().to(
                       self._device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _produce(self):
        try:
            while not self._stop.is_set():
                # bounded in-flight: wait for a free permit, but keep
                # checking for close() so shutdown never deadlocks
                if not self._sem.acquire(timeout=0.1):
                    continue
                if self._stop.is_set():
                    break
                try:
                    batch = next(self._it)
                except StopIteration:
                    break
                self._q.put(self._put(batch))
        except BaseException as e:  # surface on the consumer's stack
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        # blocks ONLY when the buffer is genuinely empty — the stall
        # MeteredFeed should charge to ingestion
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        self._sem.release()
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self, timeout: float = 2.0):
        """Stop the producer and join it. Idempotent."""
        if self._on_close is not None:
            self._on_close()
        self._stop.set()
        self._sem.release()  # unblock a producer waiting on a permit
        self._thread.join(timeout)


def device_prefetch(it: Iterator, depth: int = 2, device="cuda"):
    """Yields device-resident batches, keeping `depth` in flight —
    production happens on a background thread (see DevicePrefetcher)."""
    return DevicePrefetcher(it, depth=depth, device=device)


class MeteredFeed:
    """Iterator wrapper that times how long the consumer blocks in
    `next()` — the host->device boundary where accelerator idle is born.

    Clock discipline: the stall clock runs ONLY inside `__next__`, on
    `time.monotonic`. Everything outside — the train step, the
    optimizer tick, checkpointing — is by definition device/driver time
    and never pollutes the stall number. Because `device_prefetch` keeps
    `depth` batches in flight, a stall here means the pipeline fell
    behind by more than the prefetch buffer: exactly the starvation the
    paper's device-idle metric charges to ingestion. CUDA work is
    asynchronous, so a train loop closes its step window with
    `torch.cuda.synchronize()` before reading these counters.

    `counters()` returns monotonically increasing totals
    (`batches`, `stall_s`, plus a `time` timestamp); consumers
    (FeedBackend.measure) difference two snapshots to get a window.
    """

    def __init__(self, it: Iterator):
        self._it = it
        self.batches = 0
        self.stall_s = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.monotonic()
        try:
            out = next(self._it)
        finally:
            self.stall_s += time.monotonic() - t0
        self.batches += 1
        return out

    def counters(self) -> Dict[str, float]:
        return {"batches": float(self.batches),
                "stall_s": float(self.stall_s),
                "time": time.monotonic()}

    def close(self, timeout: float = 2.0):
        close = getattr(self._it, "close", None)
        if close is not None:
            close(timeout)


def make_train_feed(pipe, *, depth: int = 2, device="cuda",
                    timeout: float = 60.0) -> MeteredFeed:
    """The proc->device bridge: compose `pipe.get_batch()` (model-ready
    numpy batches out of the tuned ProcessPipeline) through
    `device_prefetch` (depth batches resident on `device`, transfer
    overlapped with compute) into a `MeteredFeed` (stall accounting at
    the boundary). The returned iterator is what the train loop consumes
    and what FeedBackend meters; `feed.close()` stops the producer
    thread cleanly (call it before `pipe.shutdown()`)."""
    stop = threading.Event()

    def batches():
        waited = 0.0
        while not stop.is_set():
            try:
                # short poll so close() can interrupt a blocked pull;
                # StopIteration from an EOS pipe must not leak out of a
                # generator (PEP 479) — translate it to a clean return
                yield pipe.get_batch(timeout=0.25)
                waited = 0.0
            except queue.Empty:
                waited += 0.25
                if waited >= timeout:
                    raise
            except StopIteration:
                return

    feed = MeteredFeed(DevicePrefetcher(batches(), depth=depth,
                                        device=device, on_close=stop.set))
    return feed


def shard_slice(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Host's slice of a global batch (leading dim split).

    Raises ShardError when the batch cannot be split exactly — a silent
    remainder drop (or an empty slice when n < n_hosts) corrupts global
    batch size downstream where nothing is positioned to notice.
    """
    if not 0 <= host_id < n_hosts:
        raise ShardError(
            f"host_id {host_id} out of range for {n_hosts} hosts")

    def sl(k, x):
        n = x.shape[0]
        if n < n_hosts:
            raise ShardError(
                f"batch field {k!r} has {n} rows < {n_hosts} hosts: "
                "every host would receive an empty slice")
        if n % n_hosts != 0:
            raise ShardError(
                f"batch field {k!r} has {n} rows, not divisible by "
                f"{n_hosts} hosts: {n % n_hosts} rows would be dropped")
        per = n // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: sl(k, v) for k, v in batch.items()}
