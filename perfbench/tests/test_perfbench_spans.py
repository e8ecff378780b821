"""`lib/spans.py` over stub profiler events: each device event goes to
the program span whose host interval holds its launch, a launch from a
followed span-less thread to the `step.*` span that holds it, one from
a thread the profile does not follow to none, a span's device
time is the union of its events' intervals in the window, and an idle
gap is named by the innermost span. The accepted reduction
(`lib/trace.py`) reads the same with the program's spans as without
them: they are CPU ranges with no copy on the device's timeline."""
from types import SimpleNamespace as NS

import pytest

from perfbench.lib import spans, trace

MAIN, AUTOGRAD, PRODUCER = 1, 2, 99


def ev(name, a, b, dev="CPU", cid=0, thread=MAIN):
    """A profiler event; a CPU event's resource id is its system thread,
    and `thread` puts the runtime calls of a thread the profile does not
    follow on the main thread's number, as the profiler does."""
    return NS(name=name, device_type=NS(name=dev),
              time_range=NS(start=a, end=b), id=cid,
              thread=MAIN if thread == PRODUCER else thread,
              device_resource_id=7 if dev == "CUDA" else thread)


def kernel(name, a, b, cid):
    return ev(name, a, b, "CUDA", cid)


def launch(a, cid, thread=MAIN):
    return ev("cudaLaunchKernel", a, a + 2, "CPU", cid, thread)


def step_events(with_spans: bool):
    """One train step between two reference spins: a forward kernel, a
    backward kernel launched from autograd's thread, two optimizer
    kernels with an idle gap between them, a copy from the feed's
    producer thread, and the harness's `train_step` (with its device
    copy)."""
    evs = [kernel(trace.SPIN, 0, 100, 900), launch(0, 900),
           ev("train_step", 100, 1000), kernel("train_step", 110, 990, 901),
           launch(110, 1), kernel("fwd_kernel", 120, 200, 1),
           ev("autograd::engine", 290, 410, thread=AUTOGRAD),
           launch(300, 2, AUTOGRAD), kernel("bwd_kernel", 320, 400, 2),
           launch(500, 3), kernel("adagrad_kernel", 510, 600, 3),
           launch(610, 4), kernel("adagrad_kernel", 700, 800, 4),
           launch(515, 5, PRODUCER), kernel("Memcpy HtoD", 560, 580, 5),
           kernel(trace.SPIN, 1000, 1100, 902), launch(990, 902)]
    if with_spans:
        evs += [ev("step.forward", 105, 250), ev("step.backward", 260, 420),
                ev("step.optim", 490, 820)]
    return evs


def prof(evs):
    return NS(events=lambda: evs)


def test_the_accepted_reduction_is_blind_to_the_program_spans():
    a = trace._reduce(prof(step_events(False)), 1)
    b = trace._reduce(prof(step_events(True)), 1)
    assert (a.t0, a.t1) == (b.t0, b.t1) == (100, 1000)
    assert a.busy_s == b.busy_s
    assert a.device_ops() == b.device_ops()
    assert a.idle_gaps() == b.idle_gaps()


def test_a_launch_goes_to_the_innermost_span_on_its_thread():
    device, runtime, pspans, followed = spans.split(
        step_events(True), skip=set(trace.SPANS) | {trace.SPIN})
    owners = dict(zip((d[3] for d in device),
                      spans.attribute(device, runtime, pspans, followed)))
    assert owners[1] == "step.forward"
    assert owners[2] == "step.backward"     # autograd's thread, no span
    assert owners[3] == owners[4] == "step.optim"
    # the feed's producer, which the profile does not follow, launched
    # inside step.optim: nobody's
    assert PRODUCER not in followed and owners[5] is None
    assert "train_step" not in {d[0] for d in device}


def test_a_span_less_launch_inside_a_step_span_goes_there():
    pspans = [("step.backward", MAIN, 100, 200),
              ("feed.wait", MAIN, 150, 160)]
    followed = {MAIN, AUTOGRAD}
    assert spans.owner(AUTOGRAD, 155, pspans, followed) == "step.backward"
    assert spans.owner(MAIN, 155, pspans, followed) == "feed.wait"
    assert spans.owner(AUTOGRAD, 250, pspans, followed) is None
    assert spans.owner(PRODUCER, 155, pspans, followed) is None


def test_device_seconds_are_the_union_inside_the_window():
    device = [("k", 0, 50, 1), ("k", 40, 80, 2), ("k", 90, 120, 3),
              ("k", 200, 300, 4)]
    owners = ["step.optim", "step.optim", "step.forward", None]
    got = spans.device_s(device, owners, (10, 110))
    assert got == pytest.approx({"step.optim": 70e-6,
                                 "step.forward": 20e-6})


def test_a_device_copy_named_like_a_program_span_is_not_work():
    evs = step_events(True) + [kernel("step.optim", 490, 830, 3)]
    device, _, _, _ = spans.split(evs, skip=trace.SPANS)
    assert "step.optim" not in {d[0] for d in device}


def test_a_gap_is_named_by_the_innermost_span():
    host = [("train_step", 100, 1000), ("step.optim", 490, 820)]
    assert spans.gap_name(650, host) == "step.optim"
    assert spans.gap_name(450, host) == "train_step"
    assert spans.gap_name(1050, host) == "host.other"
    st = trace._reduce(prof(step_events(True)), 1)
    assert st.idle_gaps()[0][0] == "train_step"     # the accepted naming


def test_the_frozen_names_are_the_programs():
    from repro_torch.common.spans import SPANS
    assert spans.PROGRAM_SPANS == SPANS
