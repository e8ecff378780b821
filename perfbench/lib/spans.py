"""The program's own spans (`repro_torch.common.spans`) in a traced
stretch: which span launched each kernel, copy and fill, the device time
of each span, and the span the host was in during an idle gap.

The program opens its spans as plain CPU ranges (function scope), so
they put nothing on the device's timeline and `lib/trace.py`'s busy and
idle readings do not see them. A device event is put down to a span by
its launch: the runtime call (`cudaLaunchKernel`, `cudaMemcpyAsync`,
...) that the profiler gives the same correlation id. The launch belongs
to the innermost program span on its own thread that holds it. A launch
from a thread that the profile follows (it records the thread's ops)
but that opened no such span, as autograd's device thread running the
backward while the caller waits in `step.backward`, belongs to the
innermost `step.*` span that holds it. A launch from a thread the
profile does not follow (the device feed's producer, started before the
profile) belongs to none. A thread is the system thread id that the
profiler gives a CPU event as its resource id: its `thread` field puts
an unfollowed thread's runtime calls on the main thread's number.
Everything here takes plain tuples, so it is tested on stub events.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from perfbench.lib.trace import _union

# the program's span names, frozen here: the benchmark reads the names
# it was written against (a CPU test holds them to the program's SPANS)
PROGRAM_SPANS = ("step.forward", "step.backward", "step.optim", "feed.wait")
STEP = "step."

Span = Tuple[str, int, float, float]          # name, thread, start, end


def split(events, skip: Iterable[str] = ()):
    """From a profile's `events()`: the device events [(name, start, end,
    correlation id)] but those named in `skip` (the harness's own spans'
    device-side copies) or like a program span, the runtime calls
    {correlation id: (thread, start)}, the program spans [(name, thread,
    start, end)] and the threads whose ops the profile recorded."""
    skip = set(skip)
    device, runtime, spans, followed = [], {}, [], set()
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type.name == "CUDA":
            if e.name not in skip and e.name not in PROGRAM_SPANS:
                device.append((e.name, a, b, e.id))
            continue
        tid = e.device_resource_id
        if e.name in PROGRAM_SPANS:
            spans.append((e.name, tid, a, b))
        elif e.name.startswith("cu"):
            runtime[e.id] = (tid, a)
        else:
            followed.add(tid)
    return device, runtime, spans, followed


def owner(thread: int, t: float, spans: Sequence[Span],
          followed: Set[int]) -> Optional[str]:
    """The span a launch at host time `t` on `thread` belongs to."""
    own = [(e - s, n) for n, th, s, e in spans
           if th == thread and s <= t <= e]
    if own:
        return min(own)[1]
    if thread not in followed:
        return None
    step = [(e - s, n) for n, _, s, e in spans
            if n.startswith(STEP) and s <= t <= e]
    return min(step)[1] if step else None


def attribute(device, runtime, spans, followed) -> List[Optional[str]]:
    """Each device event's span, or None (no recorded launch, or none of
    the rules above gives one)."""
    out = []
    for _, _, _, cid in device:
        launch = runtime.get(cid)
        out.append(None if launch is None
                   else owner(launch[0], launch[1], spans, followed))
    return out


def device_s(device, owners, window) -> Dict[str, float]:
    """Each span's device seconds: the union of its events' intervals
    inside `window` (start, end in us)."""
    t0, t1 = window
    by: Dict[str, list] = {}
    for (_, a, b, _), name in zip(device, owners):
        if name is not None and b > t0 and a < t1:
            by.setdefault(name, []).append((max(a, t0), min(b, t1)))
    return {n: sum(b - a for a, b in _union(iv)) / 1e6
            for n, iv in by.items()}


def gap_name(mid: float, spans: Sequence[Tuple[str, float, float]]
             ) -> str:
    """The innermost of `spans` [(name, start, end)] (harness and program
    spans alike) that holds host time `mid`."""
    inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
    return min(inside)[1] if inside else "host.other"
