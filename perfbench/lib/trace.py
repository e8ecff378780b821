"""The traced stretch of a `--trace 1` run: torch.profiler (CPU and CUDA)
over a few steady steps of the window, reduced to device intervals by
name, the harness's own host spans, busy and window seconds.

The stretch is opened and closed by a reference spin on the card
(`torch.cuda._sleep`), whose device time is first read from CUDA events.
A stretch whose profiler clock reads either spin more than CLOCK_TOL off
that time, or that lost a launch the step's kernels must make, is traced
again, up to TRIES times; the last one taken says why it was refused.
The window is the device timeline from the end of the first spin to the
start of the second; busy is the union of every kernel, copy and fill in
it.
"""
from __future__ import annotations

import math
import re
import time
from typing import Callable, Dict, List, Optional

import torch

REF_CYCLES = 400_000
CLOCK_TOL = 0.08
TRIES = 3
SPIN = "spin_kernel"
SPANS = ("feed.next", "train_step", "score_step")


def spin_ms() -> float:
    """One reference spin's device time by CUDA events, the least of 3,
    while a spin twice as long holds the card."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = math.inf
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(2 * REF_CYCLES)
        start.record()
        torch.cuda._sleep(REF_CYCLES)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _named(pattern: str):
    return re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(pattern)
                      + r"([^A-Za-z0-9_]|$)")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return n.split("(")[0].strip()[:160] or name[:160]


class Stretch:
    """One traced stretch, reduced."""

    def __init__(self, steps: int, kernels, spans, window, clock):
        self.steps = steps
        self.kernels = kernels        # [(name, start us, end us)]
        self.spans = spans            # [(name, start us, end us)] host
        self.t0, self.t1 = window     # us
        self.clock = clock            # the spins' reading / event time
        busy = _union([(max(a, self.t0), min(b, self.t1))
                       for _, a, b in kernels if b > self.t0 and a < self.t1])
        self.busy_intervals = busy
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.window_s = (self.t1 - self.t0) / 1e6

    def launches(self, kernel: str) -> List[float]:
        """Durations (s) of the launches of `kernel` in the window."""
        pat = _named(kernel)
        return [(b - a) / 1e6 for n, a, b in self.kernels
                if pat.search(n) and a >= self.t0 and b <= self.t1]

    def device_ops(self, top: int = 10) -> list:
        by: Dict[str, float] = {}
        for n, a, b in self.kernels:
            if a >= self.t0 and b <= self.t1:
                k = _short(n)
                by[k] = by.get(k, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps with no device work, each named by the
        harness span the host was in at its middle."""
        edges = [self.t0] + [x for iv in self.busy_intervals for x in iv] \
            + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            inside = [(e - s, n) for n, s, e in self.spans if s <= mid <= e]
            name = min(inside)[1] if inside else "host.other"
            out.append([name, (b - a) / 1e6])
        return sorted(out, key=lambda kv: -kv[1])[:top]


def _reduce(prof, steps: int) -> Optional[Stretch]:
    kernels, spans, spins = [], [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type.name == "CUDA":
            if e.name in SPANS:
                continue
            if SPIN in e.name:
                spins.append((a, b))
            else:
                kernels.append((e.name, a, b))
        elif e.name in SPANS:
            spans.append((e.name, a, b))
    long = sorted(spins, key=lambda iv: iv[1] - iv[0])[-2:]
    if len(long) < 2:
        return None
    long.sort()
    return Stretch(steps, kernels, spans, (long[0][1], long[1][0]),
                   [(b - a) for a, b in long])


def trace_stretch(run_steps: Callable[[int], None], steps: int,
                  expected: Dict[str, int]):
    """Trace `run_steps(steps)` between two reference spins; returns
    (Stretch, why it was refused or None). `expected` {kernel: launches}
    is what the steps must show."""
    from torch.profiler import ProfilerActivity, profile
    ref_us = spin_ms() * 1e3
    why = None
    for _ in range(TRIES):
        torch.cuda.synchronize()
        time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(REF_CYCLES)
            run_steps(steps)
            torch.cuda._sleep(REF_CYCLES)
            torch.cuda.synchronize()
        st = _reduce(prof, steps)
        if st is None:
            why = "the profiler recorded no reference spin"
            continue
        st.clock = [d / ref_us for d in st.clock]
        if not all(abs(c - 1) <= CLOCK_TOL for c in st.clock):
            why = f"the profiler's clock read the spins at {st.clock}"
            continue
        short = {k: (len(st.launches(k)), n) for k, n in expected.items()
                 if len(st.launches(k)) != n}
        if short:
            why = f"launches (seen, expected) {short}"
            continue
        return st, None
    return st, why
