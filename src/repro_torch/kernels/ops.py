"""Public differentiable ops over the kernels: the port of the dispatch
layer repro/kernels/ops.py.

Where the JAX package picks compiled or interpret mode, the port picks
by the tensor's device: a CUDA tensor launches the hand-written kernel
(forward and backward), a CPU tensor takes the kernel's plain PyTorch
version (repro_torch.kernels.ref), a meta tensor (the dry run's) takes
the CUDA wrapper too, which counts the launch and makes none, and any
other device raises. There is no other fallback: a CUDA kernel that
fails to build or launch raises. A launch on the card or on meta
reports its kernel's dot FLOPs and bytes (`kernels.costs`) to the
active recorder (`set_kernel_recorder`: launch/step_analysis's), if
any.

The forwards take f32 or bf16 inputs, as the TPU kernels do. The
DLRM's two backward kernels (the TPU kernels have none) write a bf16
input's gradient in bf16, as the reference's gradient of a bf16
parameter is, with no f32 copy of it: the scatter reads the forward's
f32 d_out into a bf16 table gradient (the vocab shard's take, `local_take`,
stays in the table's dtype both ways), and the interaction's backward
reads bf16 d_out and feats. `sage_aggregate`'s backward kernel is f32: a
bf16 input's backward hands it d_out and w in f32 and casts the
gradients back to the inputs' dtypes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import costs
from repro_torch.kernels import dot_interact as _di
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import ref
from repro_torch.kernels import sage_aggregate as _sa


def _on_cuda(t: torch.Tensor) -> bool:
    """Whether t takes the CUDA wrappers: a CUDA tensor or a meta one;
    a CPU tensor takes the plain version; any other device raises."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# the active recorder: recorder(kernel name, dot FLOPs, bytes)
_KERNEL_RECORDER: Optional[Callable] = None


def set_kernel_recorder(recorder: Optional[Callable]) -> Optional[Callable]:
    """Make `recorder` the active one (None: none); returns the one it
    replaces."""
    global _KERNEL_RECORDER
    prev, _KERNEL_RECORDER = _KERNEL_RECORDER, recorder
    return prev


def _cost(name: str, cost_fn, *args) -> None:
    """Report kernel `name`'s dot FLOPs and bytes, of cost_fn(*args), to
    the active recorder; with none, compute nothing."""
    if _KERNEL_RECORDER is not None:
        c = cost_fn(*args)
        _KERNEL_RECORDER(name, c.dot_flops, c.bytes)


def _bag(tables: torch.Tensor, ids: torch.Tensor) -> tuple:
    """A stacked bag's (b, f, bag, v, d, elem), the costs' arguments."""
    f, v, d = tables.shape
    return ids.shape[0], f, ids.shape[-1], v, d, tables.element_size()


# the reference's dispatch limits (repro/kernels/embedding_bag.py:86-88):
# the fused kernel runs when one feature's table is at most 8 MiB and a
# bag at most 16 ids (re-derived for the H100 in
# csrc/embedding_bag_fused.cu)
FUSED_MAX_TABLE_BYTES = 8 * 1024 * 1024
FUSED_MAX_BAG = _eb.FUSED_MAX_BAG


def fused_fires(tables: torch.Tensor, bag: int) -> bool:
    """Whether `embedding_bag_fused` takes its resident-table kernel for
    stacked tables (F, V, D) and bags of `bag` ids (else the row kernel
    `embedding_bag_fwd`), as the reference function decides per table."""
    _, v, d = tables.shape
    return (v * d * tables.element_size() <= FUSED_MAX_TABLE_BYTES
            and bag <= FUSED_MAX_BAG)


def _save_bag(ctx, tables, ids, combiner):
    ctx.save_for_backward(ids)
    ctx.combiner = combiner
    ctx.num_rows = tables.shape[1]
    ctx.table_dtype = tables.dtype


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, ids, combiner):
        _save_bag(ctx, tables, ids, combiner)
        if not _on_cuda(tables):
            return ref.embedding_bag_ref(tables, ids, combiner=combiner)
        _cost("embedding_bag_fwd", costs.bag_fwd, *_bag(tables, ids))
        return _eb.embedding_bag_fwd(tables, ids, combiner)

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        d_out = d_out.contiguous()
        if not _on_cuda(d_out):
            grad = ref.embedding_bag_bwd_ref(d_out, ids, ctx.num_rows,
                                             combiner=ctx.combiner,
                                             dtype=ctx.table_dtype)
        else:
            b, f, bag = ids.shape
            _cost("embedding_bag_bwd", costs.bag_bwd, b, f, bag,
                  ctx.num_rows, d_out.shape[-1], ctx.table_dtype.itemsize)
            grad = _eb.embedding_bag_bwd(d_out, ids, ctx.num_rows,
                                         ctx.combiner, dtype=ctx.table_dtype)
        return grad, None, None


class _EmbeddingBagFused(_EmbeddingBag):
    """The fused function's forward; its backward is `_EmbeddingBag`'s
    scatter (the TPU kernel has none, and the fused function's gradient
    is `embedding_bag`'s)."""

    @staticmethod
    def forward(ctx, tables, ids, combiner):
        _save_bag(ctx, tables, ids, combiner)
        if not _on_cuda(tables):
            return ref.embedding_bag_fused_ref(tables, ids,
                                               combiner=combiner)
        if fused_fires(tables, ids.shape[-1]):
            _cost("embedding_bag_fused_fwd", costs.bag_fwd,
                  *_bag(tables, ids))
            return _eb.embedding_bag_fused_fwd(tables, ids, combiner)
        _cost("embedding_bag_fwd", costs.bag_fwd, *_bag(tables, ids))
        return _eb.embedding_bag_fwd(tables, ids, combiner)


class _DotInteract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        if not _on_cuda(feats):
            return ref.dot_interact_ref(feats)
        _cost("dot_interact_fwd", costs.dot_fwd, *feats.shape,
              feats.element_size())
        return _di.dot_interact_fwd(feats)

    @staticmethod
    def backward(ctx, d_out):
        (feats,) = ctx.saved_tensors
        d_out = d_out.contiguous()
        if not _on_cuda(d_out):
            return ref.dot_interact_bwd_ref(d_out, feats)
        _cost("dot_interact_bwd", costs.dot_bwd, *feats.shape,
              feats.element_size())
        return _di.dot_interact_bwd(d_out, feats)


class _SageAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, neigh, w):
        # d_w = agg^T d_out: the forward keeps the (B, D) aggregate only
        # when w needs a gradient
        save_agg = ctx.needs_input_grad[1]
        if _on_cuda(neigh):
            if w.dtype == torch.bfloat16:
                _cost("sage_widen_w", costs.widen, *w.shape)
            _cost("sage_aggregate_fwd", costs.sage_fwd, *neigh.shape,
                  w.shape[1], neigh.element_size(), save_agg)
            out, agg = _sa.sage_aggregate_fwd(neigh, w, save_agg)
        else:
            agg = ref.sage_mean_ref(neigh)
            out = (agg @ w.float()).to(neigh.dtype)
            agg = agg if save_agg else None
        ctx.save_for_backward(agg, w)
        ctx.f = neigh.shape[1]
        ctx.neigh_dtype = neigh.dtype
        return out

    @staticmethod
    def backward(ctx, d_out):
        agg, w = ctx.saved_tensors
        need_neigh, need_w = ctx.needs_input_grad
        if not (need_neigh or need_w):
            return None, None
        d_out = d_out.contiguous()
        if _on_cuda(d_out):
            d_out, w32 = d_out.float(), w.float()
            (b, h), d = d_out.shape, w.shape[0]
            _cost("sage_aggregate_bwd", costs.sage_bwd, b, ctx.f, d, h,
                  agg is not None, need_neigh)
            d_neigh, d_w = _sa.sage_aggregate_bwd(d_out, w32, agg, ctx.f,
                                                  need_neigh)
        else:
            d_neigh, d_w = ref.sage_aggregate_bwd_ref(
                d_out, w, agg, ctx.f, need_neigh=need_neigh)
        if d_neigh is not None:
            d_neigh = d_neigh.to(ctx.neigh_dtype)
        if d_w is not None:
            d_w = d_w.to(w.dtype)
        return d_neigh, d_w


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor, *,
                  combiner: str = "sum") -> torch.Tensor:
    """Stacked multi-feature bag: tables (F, V, D) f32 or bf16, ids (B, F,
    bag) -> (B, F, D) f32, differentiable in `tables` (the gradient in
    the tables' dtype)."""
    return _EmbeddingBag.apply(tables, ids, combiner)


def embedding_bag_fused(tables: torch.Tensor, ids: torch.Tensor, *,
                        combiner: str = "sum") -> torch.Tensor:
    """`embedding_bag` through the fused kernel where `fused_fires` (one
    feature's table at most 8 MiB, bag at most 16), through the row
    kernel otherwise: tables (F, V, D), ids (B, F, bag) -> (B, F, D)
    f32, bit-equal either way, differentiable in `tables`."""
    return _EmbeddingBagFused.apply(tables, ids, combiner)


def embedding_bag_local(tables: torch.Tensor, ids: torch.Tensor,
                        row0: int) -> torch.Tensor:
    """The local-rows lookup of one rank's row shard, no autograd (the
    sharded lookup's autograd Function, models/embedding.py, calls it):
    tables (F, v_loc, D) f32 or bf16, rows [row0, row0 + v_loc) of each
    feature's table; ids (B, F, bag) -> (B, F, D) f32, the bag's rows in
    the shard summed (an id outside it reads 0)."""
    if not _on_cuda(tables):
        return ref.embedding_bag_local_ref(tables, ids, row0)
    _cost("embedding_bag_fwd_local", costs.bag_fwd, *_bag(tables, ids))
    return _eb.embedding_bag_fwd(tables, ids, "sum", row0=row0)


def embedding_bag_local_bwd(d_out: torch.Tensor, ids: torch.Tensor,
                            row0: int, v_loc: int,
                            dtype: torch.dtype) -> torch.Tensor:
    """The local-rows scatter: d_out (B, F, D) f32 into the gradient
    (F, v_loc, D) in `dtype` of rows [row0, row0 + v_loc); ids outside
    them add nothing."""
    d_out = d_out.contiguous()
    if not _on_cuda(d_out):
        return ref.embedding_bag_local_bwd_ref(d_out, ids, row0, v_loc,
                                               dtype=dtype)
    b, f, bag = ids.shape
    _cost("embedding_bag_bwd_local", costs.bag_bwd, b, f, bag, v_loc,
          d_out.shape[-1], dtype.itemsize)
    return _eb.embedding_bag_bwd(d_out, ids, v_loc, "sum", dtype=dtype,
                                 row0=row0)


def local_take(table: torch.Tensor, ids: torch.Tensor,
               row0: int) -> torch.Tensor:
    """The masked take of one rank's vocab shard, no autograd (the
    sharded lookup's autograd Function, models/embedding.py, calls it):
    table (v_loc, D) f32 or bf16, rows [row0, row0 + v_loc); ids (N,)
    int32 -> (N, D) in the table's dtype (zeros for an id outside)."""
    if not _on_cuda(table):
        return ref.embedding_take_local_ref(table, ids, row0)
    if ids.shape[0] and table.shape[1]:
        _cost("embedding_take_fwd_local", costs.take_fwd, ids.shape[0],
              *table.shape, table.element_size())
    return _eb.embedding_take_fwd_local(table, ids, row0)


def local_take_bwd(d_out: torch.Tensor, ids: torch.Tensor, row0: int,
                   v_loc: int) -> torch.Tensor:
    """The masked take's gradient: d_out (N, D) in the table's dtype ->
    the shard's gradient (v_loc, D) in that dtype, each row's slots
    summed in f32 and rounded once; ids outside add nothing."""
    d_out = d_out.contiguous()
    if not _on_cuda(d_out):
        return ref.embedding_take_local_bwd_ref(d_out, ids, row0, v_loc)
    if d_out.numel() and v_loc:
        n, d = d_out.shape
        _cost("embedding_take_bwd_local", costs.take_bwd, n, v_loc, d,
              d_out.element_size())
    return _eb.embedding_take_bwd_local(d_out, ids, row0, v_loc)


def dot_interact(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) f32 or bf16 -> (B, F(F-1)/2) lower-triangle
    pairwise dots summed in f32, in feats' dtype, differentiable (the
    gradient in feats' dtype, summed in f32 and rounded once)."""
    return _DotInteract.apply(feats)


def sage_aggregate(neigh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """GraphSAGE's neighbour term: neigh (B, F, D), w (D, H), each f32 or
    bf16 -> mean over F, then @ w, in f32: (B, H) in neigh's dtype,
    differentiable in both. The backward writes
    d_neigh only when neigh needs a gradient."""
    return _SageAggregate.apply(neigh, w)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel in this process, by kernel name."""
    return {**_eb.LAUNCHES, **_di.LAUNCHES, **_sa.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_eb.LAUNCHES, _di.LAUNCHES, _sa.LAUNCHES):
        for name in counts:
            counts[name] = 0
