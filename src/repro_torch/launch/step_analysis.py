"""What one step does, counted at dispatch: the counterpart of
repro/launch/hlo_analysis.py.

The reference reads its two roofline inputs, dot FLOPs and collective
bytes a device, from the SPMD module's HLO text, and has to scale each
op by the trip counts of the while loops around it, because XLA's
cost_analysis counts a scanned loop's body once (hlo_analysis.py:1-17).
The port has no HLO: its step is eager, so running it once runs every
layer, every microbatch and every recompute of a checkpoint, and a
count taken as the ops dispatch needs no trip scaling. `analyze(fn,
*args)` runs fn(*args) once under a `TorchDispatchMode` that gives

- `dot_flops`: the aten ops' FLOPs by the formulas of
  `torch.utils.flop_counter` (its `FlopCounterMode`'s registry: mm,
  bmm, addmm, baddbmm, convolutions, attention), plus each hand-written
  kernel's dot FLOPs, which its launch reports (`kernels.ops`, the
  formulas of `kernels.costs`);
- `collectives`: by op, {count, bytes} of the operands, and their
  total, from the one function every collective goes through
  (`train.collectives._collective`), and `collective_calls`, the same
  by (op, group size, shape, dtype, call site), for the perf probe;
- `resident_bytes`: the bytes of the tensors in args (the parameters,
  the optimizer state and the inputs; the reference's
  argument_size_in_bytes), each storage once;
- `peak_bytes`: resident_bytes plus the most bytes of the storages the
  step made that were alive at once (each output's new storage added
  as it is made, rounded up to the CUDA caching allocator's 512-byte
  blocks, and taken off when a finalizer on it fires), and `temp_bytes`,
  their difference;
- `launches` and `kernels`: each kernel's launches (`ops.launch_counts`)
  with its dot FLOPs and bytes.

On meta tensors (the dry run's) nothing is allocated and no value is
read; on CUDA tensors the same counters run beside the real step, so
that the card's counts can be held against the plan's.
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Callable, Dict, Iterable

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.train import collectives as coll

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
# the CUDA caching allocator's block (c10/cuda/CUDACachingAllocator.cpp)
BLOCK = 512


def _blocks(n: int) -> int:
    return max(BLOCK, -(-n // BLOCK) * BLOCK) if n else 0


def tensors_of(*trees) -> Iterable[torch.Tensor]:
    """Every tensor in trees of modules (parameters and buffers), dicts,
    lists and tuples."""
    for tree in trees:
        if isinstance(tree, nn.Module):
            yield from tree.parameters()
            yield from tree.buffers()
        elif isinstance(tree, dict):
            yield from tensors_of(*tree.values())
        elif isinstance(tree, (list, tuple)):
            yield from tensors_of(*tree)
        elif torch.is_tensor(tree):
            yield tree
        elif hasattr(tree, "_fields"):          # a NamedTuple (a plan)
            yield from tensors_of(*tree)


def storage_bytes(*trees) -> int:
    """numel x element_size summed over the tensors in trees, a storage
    (a tensor and its views) once."""
    seen, total = set(), 0
    for t in tensors_of(*trees):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


class _Counters(TorchDispatchMode):
    def __init__(self, resident_keys: set):
        super().__init__()
        self.resident = resident_keys
        self.aten_flops = 0
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.active = True

    def _free(self, key: int) -> None:
        if self.active:
            self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            # an `out_dtype` overload (bmm.dtype) counts as its packet
            shapes = tuple(a for a in args if not isinstance(a, torch.dtype))
            self.aten_flops += count(*shapes, **kwargs, out_val=out)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.resident:
                continue
            n = _blocks(st.nbytes())
            self.live[key] = n
            self.live_bytes += n
            self.peak = max(self.peak, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return out


def analyze(fn: Callable, *args) -> dict:
    """Run fn(*args) once and return what it did (see the module
    docstring); fn's own result is under "out"."""
    resident = set()
    for t in tensors_of(*args):
        resident.add(t.untyped_storage()._cdata)
    resident_bytes = storage_bytes(*args)
    kernels = collections.defaultdict(lambda: {"flops": 0.0, "bytes": 0.0})
    calls = collections.Counter()

    def on_kernel(name, flops, nbytes):
        kernels[name]["flops"] += flops
        kernels[name]["bytes"] += nbytes

    def on_collective(op, size, x, site):
        calls[(op, size, tuple(x.shape), str(x.dtype).replace("torch.", ""),
               site)] += 1

    before = ops.launch_counts()
    prev_k = ops.set_kernel_recorder(on_kernel)
    prev_c = coll.set_recorder(on_collective)
    mode = _Counters(resident)
    try:
        with mode:
            out = fn(*args)
    finally:
        mode.active = False
        ops.set_kernel_recorder(prev_k)
        coll.set_recorder(prev_c)
    after = ops.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    colls = {op: {"count": 0, "bytes": 0} for op in COLLECTIVE_OPS}
    call_rows = []
    for (op, size, shape, dtype, site), n in sorted(calls.items()):
        nbytes = n * math.prod(shape) * getattr(torch, dtype).itemsize
        colls[op]["count"] += n
        colls[op]["bytes"] += nbytes
        call_rows.append({"op": op, "group": size, "shape": list(shape),
                          "dtype": dtype, "site": site, "count": n,
                          "bytes": nbytes})
    colls["total_bytes"] = sum(colls[op]["bytes"] for op in COLLECTIVE_OPS)
    kernel_flops = sum(v["flops"] for v in kernels.values())
    return {
        "dot_flops": float(mode.aten_flops) + kernel_flops,
        "aten_dot_flops": float(mode.aten_flops),
        "kernel_dot_flops": kernel_flops,
        "collectives": colls,
        "collective_bytes": colls["total_bytes"],
        "collective_calls": call_rows,
        "resident_bytes": resident_bytes,
        "temp_bytes": mode.peak,
        "peak_bytes": resident_bytes + mode.peak,
        "launches": launches,
        "kernels": {k: {"launches": launches.get(k, 0), **v}
                    for k, v in sorted(kernels.items())},
        "out": out,
    }
