"""The numpy modules repro_torch copies (data plane, env, baselines,
actions) are bitwise the reference on the same seeds; the port's
host->device feed keeps the reference's semantics on the CPU."""
import dataclasses
import queue
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import actions as j_actions  # noqa: E402
from repro.core import baselines as j_baselines  # noqa: E402
from repro.data import featurize as j_featurize  # noqa: E402
from repro.data import pipeline as j_pipeline  # noqa: E402
from repro.data import simulator as j_simulator  # noqa: E402
from repro_torch.api import FeedBackend, Telemetry  # noqa: E402
from repro_torch.api.validation import (AllocationError,  # noqa: E402
                                        validate_allocation)
from repro_torch.core import actions, baselines  # noqa: E402
from repro_torch.data import featurize, pipeline, simulator  # noqa: E402
from repro_torch.data.device_feed import (MeteredFeed, ShardError,  # noqa: E402
                                          device_prefetch, make_train_feed,
                                          shard_slice)


@pytest.mark.parametrize("seed", [0, 7])
def test_featurize_block_is_bitwise_the_reference(seed):
    kw = dict(batch=64, n_sparse=26, n_dense=13, vocab=1 << 20)
    rs, jrs = featurize.RecordSpec(**kw), j_featurize.RecordSpec(**kw)
    got = featurize.featurize_block(
        featurize.raw_block(np.random.RandomState(seed), rs), rs)
    want = j_featurize.featurize_block(
        j_featurize.raw_block(np.random.RandomState(seed), jrs), jrs)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("step_time", [0.01, 0.25])
def test_train_feed_pipeline_is_the_reference(step_time):
    got = pipeline.train_feed_pipeline(step_time_s=step_time)
    want = j_pipeline.train_feed_pipeline(step_time_s=step_time)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.edges == want.edges and got.sink == want.sink


@pytest.mark.parametrize("name", ["unoptimized", "heuristic", "autotune",
                                  "plumber", "oracle"])
def test_baselines_are_bitwise_the_reference(name):
    spec = pipeline.train_feed_pipeline(step_time_s=0.05)
    jspec = j_pipeline.train_feed_pipeline(step_time_s=0.05)
    for n_cpus in (5, 12, 64):
        got = baselines.BASELINES[name](spec, simulator.MachineSpec(n_cpus))
        want = j_baselines.BASELINES[name](jspec,
                                           j_simulator.MachineSpec(n_cpus))
        assert np.array_equal(got.workers, want.workers)
        assert got.prefetch_mb == want.prefetch_mb


def test_pipeline_sim_trace_is_bitwise_the_reference():
    spec = pipeline.train_feed_pipeline(step_time_s=0.05)
    jspec = j_pipeline.train_feed_pipeline(step_time_s=0.05)
    sim = simulator.PipelineSim(spec, simulator.MachineSpec(16, mem_mb=2600),
                                seed=3)
    jsim = j_simulator.PipelineSim(jspec,
                                   j_simulator.MachineSpec(16, mem_mb=2600),
                                   seed=3)
    rng = np.random.RandomState(0)
    workers, pf = np.ones(5, dtype=int), 64.0
    for tick in range(60):
        choices = rng.randint(0, 5, 5)
        got_w, got_pf = actions.next_allocation(
            choices, workers, pf, prefetch_idx=4, max_workers=16)
        want_w, want_pf = j_actions.next_allocation(
            choices, workers, pf, prefetch_idx=4, max_workers=16)
        assert np.array_equal(got_w, want_w) and got_pf == want_pf
        workers, pf = got_w, got_pf
        got = sim.apply(simulator.Allocation(workers, pf))
        want = jsim.apply(j_simulator.Allocation(workers, pf))
        assert got == want, tick
        assert np.array_equal(
            sim.measured_latencies(simulator.Allocation(workers, pf)),
            jsim.measured_latencies(j_simulator.Allocation(workers, pf)))
    assert sim.oom_count == jsim.oom_count
    assert sim.best_allocation()[1] == jsim.best_allocation()[1]


def test_validate_allocation_names_the_mistake():
    spec = pipeline.train_feed_pipeline()
    validate_allocation(spec, simulator.Allocation(np.ones(5, dtype=int)))
    with pytest.raises(AllocationError, match="worker counts"):
        validate_allocation(spec, simulator.Allocation(np.ones(4, dtype=int)))
    with pytest.raises(AllocationError, match="negative worker"):
        validate_allocation(spec, simulator.Allocation(
            np.array([1, -1, 1, 1, 1])))


# ------------------------------------------------------------ device feed --

def _wait_until(pred, deadline_s=2.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > deadline_s:
            return False
        time.sleep(0.005)
    return True


def test_prefetch_on_cpu_passes_batches_through_in_order():
    src = [{"x": np.full(3, i, np.float32)} for i in range(6)]
    out = list(device_prefetch(iter(src), depth=2, device="cpu"))
    assert [int(b["x"][0]) for b in out] == list(range(6))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    # zero-copy on the CPU: the tensor shares the numpy buffer
    assert out[0]["x"].data_ptr() == src[0]["x"].ctypes.data


def test_prefetch_keeps_depth_in_flight_and_closes():
    pulled = []

    def src():
        for i in range(8):
            pulled.append(i)
            yield {"x": np.zeros(1)}

    it = device_prefetch(src(), depth=3, device="cpu")
    next(it)
    assert _wait_until(lambda: len(pulled) == 4)
    time.sleep(0.05)
    assert len(pulled) == 4
    it.close()
    assert not it._thread.is_alive()


def test_prefetch_reraises_upstream_errors_on_the_consumer():
    def src():
        yield {"x": np.zeros(1)}
        raise RuntimeError("upstream broke")

    it = device_prefetch(src(), depth=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="upstream broke"):
        next(it)


def test_metered_feed_charges_only_blocked_time():
    def slow():
        for _ in range(3):
            time.sleep(0.05)
            yield {"x": np.zeros(1)}

    feed = MeteredFeed(device_prefetch(slow(), depth=1, device="cpu"))
    for _ in feed:
        pass
    c = feed.counters()
    assert c["batches"] == 3.0
    assert 0.05 <= c["stall_s"] < 1.0


class _FakePipe:
    """get_batch/counters/stats of a ProcessPipeline, no processes."""

    def __init__(self, n):
        self.spec = pipeline.train_feed_pipeline()
        self.machine = simulator.MachineSpec(n_cpus=4, mem_mb=4096)
        self._items = queue.Queue()
        for i in range(n):
            self._items.put({"x": np.full(2, i, np.float32)})
        self.consumed = 0
        self.alloc = None
        self.shut = threading.Event()

    def get_batch(self, timeout=10.0):
        try:
            item = self._items.get(timeout=timeout)
        except queue.Empty:
            raise StopIteration
        self.consumed += 1
        return item

    def counters(self):
        return {"delivered": self.consumed, "consumed": self.consumed,
                "time": time.monotonic(), "last_resize_at": 0.0}

    def stats(self):
        return {"throughput": 1.0, "stage_latency": [1.0] * 5,
                "workers": [1] * 5, "prefetch_mb": 32.0, "mem_frac": 0.1,
                "free_cpus": 0}

    def rss_mb(self):
        return 10.0

    def set_allocation(self, workers, prefetch_mb):
        self.alloc = (list(workers), prefetch_mb)

    def shutdown(self, drain=True, timeout=10.0):
        self.shut.set()
        return {"dropped": 0, "joined": True}


def test_make_train_feed_and_feed_backend_on_cpu():
    pipe = _FakePipe(5)
    feed = make_train_feed(pipe, depth=2, device="cpu", timeout=1.0)
    backend = FeedBackend(pipe, feed, device_step_s=0.001)
    for _ in range(3):
        assert isinstance(next(feed)["x"], torch.Tensor)
    tel = backend.measure()
    assert isinstance(tel, Telemetry)
    assert 0.0 <= tel.device_idle_frac <= 1.0
    assert tel.step_time_s is not None
    backend.apply(simulator.Allocation(np.array([1, 2, 1, 1, 1]), 64.0))
    assert pipe.alloc == ([1, 2, 1, 1, 1], 64.0)
    acct = backend.shutdown()
    assert acct == {"dropped_batches": 0, "all_joined": True,
                    "oom_count": 0}
    assert pipe.shut.is_set()


def test_shard_slice_refuses_uneven_splits():
    batch = {"x": np.arange(8)}
    assert list(shard_slice(batch, 1, 4)["x"]) == [2, 3]
    with pytest.raises(ShardError, match="not divisible"):
        shard_slice(batch, 0, 3)
    with pytest.raises(ShardError, match="empty slice"):
        shard_slice(batch, 0, 16)
    with pytest.raises(ShardError, match="out of range"):
        shard_slice(batch, 4, 4)
