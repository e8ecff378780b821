"""Explicit collectives, port of repro/train/collectives.py: the
data-parallel gradient all-reduce with optional compression, and the
differentiable collectives of the sharded lookups, the partitioned full
graph and the MoE's expert parallelism.

`psum_tree` all-reduces a gradient tree over a process group:

  "none" : the gradients' own dtype, summed as they are
  "bf16" : f32 gradients cast to bf16 before the all-reduce (half the
           bytes; the sum accumulates in bf16 on the wire, as the
           reference's psum in bf16 does on gloo and NCCL alike)
  "int8" : per-tensor symmetric int8 quantization, an all-gather of each
           rank's int8 tensor and its scale, and a local dequantized sum
           in f32 in rank order (a quarter of the bytes a hop)

and divides by the group's size for `mean`. Rounding follows the
reference: `torch.round` rounds half to even, as `jnp.round` does.

The autograd Functions below run one collective each way. Which
backward a forward collective takes depends on how its result is used:
a sum whose result every rank of the group then uses alike (a psum over
the model axis) passes its gradient through unchanged (`psum_same`); an
all-gather whose result each rank uses for its own part of the work
(the partitioned graph's hidden state) reduce-scatters the gradients
back (`all_gather_sum`); an all-gather whose result every rank uses
alike takes its own slice of the gradient (`all_gather_same`), a
slice of a tensor every rank holds alike all-gathers it (`split_same`),
and a tensor every rank holds alike that each rank then uses for its
own part of a sum (the hidden state against this rank's vocab shard)
sums its gradient over the group (`same_to_parts`: Megatron's "f",
whose pair `psum_same` is its "g"). Each takes a `dim` along which it
gathers or slices (0 by default). `reduce_scatter_sum` is
`all_gather_sum`'s pair: its backward all-gathers, so that sequence
parallelism's gather before a block and reduce-scatter after it are each
other's gradients, and FSDP's weight gather over the data axes
reduce-scatters the weight's gradient back into its shard.
`torch.distributed`'s collectives have no gradients of their own.

Every collective the port issues goes through `_collective`, which tells
an active recorder (`set_recorder`: launch/step_analysis's) the op, the
group's size, the operand and the call site; with none active it checks
one global and moves on. A plan mesh (launch/mesh.make_plan_mesh) marks
the process as planning (`set_plan_only`): its process group moves
nothing, so `_collective` then refuses any tensor that is not on the
meta device, and a real step cannot run on it.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch
import torch.distributed as dist

# the active recorder: recorder(op, group size, operand, call site)
_RECORDER: Optional[Callable] = None
# set while the default process group is a plan mesh's (moves nothing)
_PLAN_ONLY = False
_HERE = os.path.abspath(__file__)
_PKG = os.path.dirname(os.path.dirname(_HERE))


def set_recorder(recorder: Optional[Callable]) -> Optional[Callable]:
    """Make `recorder` the active one (None: none); returns the one it
    replaces."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, recorder
    return prev


def set_plan_only(on: bool) -> None:
    """Refuse (on) or take again (off) tensors off the meta device."""
    global _PLAN_ONLY
    _PLAN_ONLY = bool(on)


def _call_site() -> str:
    """file:line (function) of the first frame outside this module, the
    file relative to the package's root."""
    f = sys._getframe(2)
    while f is not None and os.path.abspath(f.f_code.co_filename) == _HERE:
        f = f.f_back
    if f is None:
        return "?"
    path = os.path.abspath(f.f_code.co_filename)
    if path.startswith(_PKG + os.sep):
        path = os.path.relpath(path, os.path.dirname(_PKG))
    return f"{path}:{f.f_lineno} ({f.f_code.co_name})"


def _collective(kind: str, x: torch.Tensor, group, fn, *args, **kw
                ) -> None:
    """Issue fn(*args, group=group, **kw), the collective `kind`
    ("all-reduce", "all-gather", "reduce-scatter" or "all-to-all") of
    operand x over `group`, through the recorder (see the module
    docstring)."""
    if _PLAN_ONLY and x.device.type != "meta":
        raise ValueError(f"a plan mesh moves nothing: {kind} of a tensor "
                         f"on {x.device}, where only meta tensors may pass")
    if _RECORDER is not None:
        _RECORDER(kind, group_size(group), x, _call_site())
    fn(*args, group=group, **kw)


def ieee_div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as an IEEE division on every device (a Python divisor lets
    CUDA multiply by a rounded reciprocal)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def ieee_div_(x: torch.Tensor, n: int) -> torch.Tensor:
    """`ieee_div` in place."""
    return x.div_(torch.full((), n, dtype=x.dtype, device=x.device))


def _quantize_int8(x: torch.Tensor):
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = ieee_div(amax, 127)        # IEEE on the card too, as jnp divides
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def group_size(group) -> int:
    """The size of a process group; None (this rank alone) is 1."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, out of place (x itself for None)."""
    if group is None:
        return x
    out = x.clone()
    _collective("all-reduce", out, group, dist.all_reduce, out)
    return out


def all_gather(x: torch.Tensor, group, *, tiled: bool = True
               ) -> torch.Tensor:
    """Each rank's x, in group-rank order: concatenated along dim 0
    (`tiled`) or stacked on a new leading dim (a group of one still
    calls the collective; None does not)."""
    if group is None:
        return x if tiled else x[None]
    n = group_size(group)
    part = (x if tiled else x[None]).contiguous()
    out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _collective("all-gather", part, group, dist.all_gather_into_tensor, out,
                part)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, this rank's slice of dim 0 (group-rank
    order)."""
    if group is None:
        return x
    n = group_size(group)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _collective("reduce-scatter", x, group, dist.reduce_scatter_tensor, out,
                x)
    return out


def _my_slice(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    k = x.shape[0] // n
    r = dist.get_rank(group)
    return x[r * k:(r + 1) * k]


def _along(fn, x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """fn (a dim-0 collective) applied along `dim`."""
    if group is None:
        return x
    if dim == 0:
        return fn(x, group)
    return fn(x.movedim(dim, 0).contiguous(), group).movedim(0, dim)


def gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Each rank's x concatenated along `dim`, in group-rank order."""
    return _along(all_gather, x, group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
    """x summed over `group`, this rank's block of `dim`."""
    return _along(reduce_scatter, x, group, dim)


def slice_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of `dim` (no communication)."""
    return _along(_my_slice, x, group, dim)


def data_slice(x: torch.Tensor, chunks: int, mesh):
    """(this data rank's contiguous slice of x's rows, the data group to
    gather its results over, None for none); x's rows must divide over
    the data ranks and then into `chunks` (a retrieval's candidates)."""
    c = x.shape[0]
    dp = mesh.size(mesh.data_axes) if mesh is not None else 1
    if c % (dp * chunks):
        raise ValueError(f"{c} candidates do not split into {chunks} chunks "
                         f"on each of {dp} data ranks")
    if dp == 1:
        return x, None
    k, n = mesh.index(mesh.data_axes), c // dp
    return x[k * n:(k + 1) * n], mesh.data_group


def gather_slices(x: torch.Tensor, group) -> torch.Tensor:
    """Each data rank's rows of `data_slice`'s results, in order."""
    if group is None:
        return x
    return all_gather(x.contiguous(), group)


class _PsumSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SameToParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _GradScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """x itself, its gradient scaled by `scale` (a value every rank of a
    group computes alike takes a 1 / size share of its gradient on
    each)."""
    return _GradScaled.apply(x, scale)


class _AllGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _ReduceScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


class _AllGatherSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return slice_dim(g, ctx.group, ctx.dim), None, None


class _SplitSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return slice_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.group, ctx.dim), None, None


def psum_same(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group`; every rank then uses the sum alike, so the
    gradient passes through."""
    return _PsumSame.apply(x, group)


def same_to_parts(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; each rank of `group` holds it alike and uses it for its
    own part of a sum, so the backward sums its gradients over the
    group."""
    return _SameToParts.apply(x, group)


def all_gather_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim`; each rank uses the result for its own
    work, so the backward reduce-scatters (sums) the gradients (FSDP's
    weight gather over the data axes, sequence parallelism's gather of
    the residual stream)."""
    return _AllGatherSum.apply(x, group, dim)


def reduce_scatter_sum(x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
    """Reduce-scatter along `dim` of each rank's partial sum; the
    backward all-gathers the blocks' gradients (sequence parallelism's
    return to the residual stream)."""
    return _ReduceScatterSum.apply(x, group, dim)


def all_gather_same(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along `dim`; every rank uses the result alike, so the
    backward keeps this rank's slice of the gradient."""
    return _AllGatherSame.apply(x, group, dim)


def split_same(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice of `dim` of a tensor every rank holds alike; the
    backward all-gathers the slices' gradients."""
    return _SplitSame.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over `group`, out of place, no gradient."""
    if group is None:
        return x
    out = x.detach().clone()
    _collective("all-reduce", out, group, dist.all_reduce, out,
                op=dist.ReduceOp.MAX)
    return out


def _reduce_leaf(g: torch.Tensor, group, n: int, compress: str,
                 mean: bool) -> torch.Tensor:
    if compress == "bf16" and g.dtype == torch.float32:
        r = all_reduce(g.to(torch.bfloat16), group).float()
    elif compress == "int8":
        q, scale = _quantize_int8(g.float())
        qs = all_gather(q, group, tiled=False)           # (n, ...)
        ss = all_gather(scale.reshape(1), group)         # (n,)
        r = qs[0].float() * ss[0]
        for k in range(1, qs.shape[0]):
            r = r + qs[k].float() * ss[k]
    else:
        r = all_reduce(g, group)
    return ieee_div(r, n) if mean else r


def psum_tree(tree, group, *, compress: str = "none", mean: bool = True):
    """All-reduce a gradient tree (tensors in dicts, lists and tuples)
    over `group` (None: this rank alone); see the module docstring."""
    if compress not in ("none", "bf16", "int8"):
        raise ValueError(f"compress must be 'none', 'bf16' or 'int8', got "
                         f"{compress!r}")
    n = group_size(group)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _reduce_leaf(node, group, n, compress, mean)
    return walk(tree)
