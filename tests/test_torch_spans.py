"""The port's profiler spans (`repro_torch.common.spans`) and the process
pipeline's stage busy counters, on the CPU: which spans a train step and
the device feed open under `torch.profiler`, in what order, that no
span is entered without a profile, that spans leave a step's results as
they were, and that a stage's busy seconds hold its service time."""
import ast
import queue
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.common import spans  # noqa: E402
from repro_torch.data.device_feed import make_train_feed  # noqa: E402
from repro_torch.data.pipeline import StageGraph, StageSpec  # noqa: E402
from repro_torch.data.proc_executor import ProcessPipeline  # noqa: E402
from repro_torch.data.simulator import MachineSpec  # noqa: E402
from repro_torch.train.optim import constant_lr, sgd  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _step(microbatches=1):
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 1))

    def loss_fn(m, batch):
        loss = ((m(batch["x"]) - batch["y"]) ** 2).mean()
        return loss, {"mse": loss}
    opt = sgd(constant_lr(0.1))
    state = opt.init(dict(model.named_parameters()))
    return model, state, make_train_step(loss_fn, opt,
                                         microbatches=microbatches)


def _batch():
    g = torch.Generator().manual_seed(1)
    return {"x": torch.randn(8, 4, generator=g),
            "y": torch.randn(8, 1, generator=g)}


def _opened(prof):
    """The program's spans in the profile, in the order they opened."""
    evs = sorted((e for e in prof.events() if e.name in spans.SPANS),
                 key=lambda e: e.time_range.start)
    return [e.name for e in evs]


@pytest.mark.parametrize("microbatches,expected", [
    (1, ["step.forward", "step.backward", "step.optim"]),
    (2, ["step.forward", "step.backward"] * 2 + ["step.optim"]),
])
def test_a_train_step_opens_forward_backward_optim(microbatches, expected):
    model, state, step = _step(microbatches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, state, 0, _batch())
    assert _opened(prof) == expected
    # a function-scope range, not a user annotation: the profiler puts
    # no copy of it on the device's timeline
    for e in prof.events():
        if e.name in spans.SPANS:
            assert not getattr(e, "is_user_annotation", False), e.name


def test_a_span_is_entered_only_while_a_profile_records(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_RecordFunctionFast", Counting)
    model, state, step = _step()
    step(model, state, 0, _batch())
    assert entered == []
    assert spans.span("step.forward") is spans._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        step(model, state, 1, _batch())
    assert entered == ["step.forward", "step.backward", "step.optim"]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_spans_leave_the_step_as_it_was(microbatches):
    plain_model, plain_state, plain = _step(microbatches)
    traced_model, traced_state, traced = _step(microbatches)
    for k in range(3):
        _, _, m0 = plain(plain_model, plain_state, k, _batch())
        with profile(activities=[ProfilerActivity.CPU]):
            _, _, m1 = traced(traced_model, traced_state, k, _batch())
        assert torch.equal(m0["loss"], m1["loss"])
    for (k, a), (_, b) in zip(plain_model.named_parameters(),
                              traced_model.named_parameters()):
        assert torch.equal(a, b), k


class _Pipe:
    """A pipe's get_batch over `n` numpy batches, then the end."""

    def __init__(self, n):
        self._items = queue.Queue()
        for i in range(n):
            self._items.put({"x": np.full(4, i, np.float32)})

    def get_batch(self, timeout=10.0):
        try:
            return self._items.get(timeout=min(timeout, 0.05))
        except queue.Empty:
            raise StopIteration


def test_the_feed_opens_feed_wait_once_a_batch():
    n = 5
    feed = make_train_feed(_Pipe(n), depth=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [b["x"][0].item() for b in feed]
    assert got == [float(i) for i in range(n)]
    # a wait a batch and the one that met the end; the producer thread,
    # started before the profile, records nothing
    assert _opened(prof) == ["feed.wait"] * (n + 1)
    assert feed.counters()["batches"] == n


def test_spans_lists_every_name_the_program_opens():
    opened = set()
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and getattr(node.func, "id", None) == "span":
                assert isinstance(node.args[0], ast.Constant), path
                opened.add(node.args[0].value)
    assert opened == set(spans.SPANS)
    assert len(spans.SPANS) == len(set(spans.SPANS))


class _Sleep:
    """A stage of known service time: sleeps `cost` s an item."""

    def __init__(self, cost):
        self.cost = cost

    def __call__(self, *items):
        time.sleep(self.cost)
        return items[0] if items else np.zeros(1)


def test_stage_busy_seconds_hold_the_service_time():
    cost = 0.02
    spec = StageGraph("busy2", (
        StageSpec("src", "udf", cost=0.001, mem_per_worker_mb=4.0),
        StageSpec("work", "udf", cost=cost, mem_per_worker_mb=4.0,
                  inputs=("src",))), batch_mb=1.0)
    t0 = time.monotonic()
    pipe = ProcessPipeline(spec, fns={"src": _Sleep(0.001),
                                      "work": _Sleep(cost)},
                           machine=MachineSpec(n_cpus=2, mem_mb=4096.0),
                           item_mb=1.0)
    try:
        pipe.set_allocation([1, 1], prefetch_mb=2.0)
        for _ in range(8):
            assert pipe.get_batch(timeout=30.0) is not None
        c = pipe.counters()
    finally:
        pipe.shutdown(drain=False)
    assert c["workers"] == [1, 1]
    assert len(c["stage_busy_s"]) == len(spec.stages)
    src, work = c["stage_busy_s"]
    assert work >= c["delivered"] * cost
    # service time, not queue waits: one worker is busy at most the wall,
    # and the source, ahead of the slow stage, mostly waits
    assert work <= c["time"] - t0
    assert 0.0 < src < work
