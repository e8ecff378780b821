"""Named host ranges around the train step's layers and the feed's wait,
for `torch.profiler`.

`span(name)` opens a profiler range only while a profile is recording
(the module flag `torch.autograd.profiler._is_profiler_enabled`); with
no profiler it is a bare no-op, so an untraced step pays a flag read.
The range is a plain CPU range (the profiler's function scope, as an
ATen op's), not a user annotation: the profiler then puts no copy of it
on the device's timeline, and a reduction that counts every device-side
event as work counts only the kernels, copies and fills. Which span
launched a kernel is read from the profiler's correlation of the kernel
with its launch on the host.

The spans, all on the thread that calls the step and the feed:

- `step.forward`: the loss, in `train/train_step` (once a microbatch);
- `step.backward`: the gradients, and with microbatches their sum into
  the accumulator (autograd's device thread launches the kernels while
  the caller waits in this span);
- `step.optim`: `optimizer.update`;
- `feed.wait`: the consumer's wait in `data/device_feed.MeteredFeed`,
  the interval its `stall_s` counts.

`torch.profiler` records ranges only on the thread that entered the
profile and on the threads that inherit it (autograd's), so the device
feed's producer thread, started before any profile, opens none: its
copies to the device are found on the trace by the thread that launched
them.
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler

SPANS = ("step.forward", "step.backward", "step.optim", "feed.wait")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range `name` while a profile
    records, else nothing."""
    if profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF
