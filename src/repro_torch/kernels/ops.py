"""Public differentiable ops over the kernels: the port of the dispatch
layer repro/kernels/ops.py.

Where the JAX package picks compiled or interpret mode, the port picks
by the tensor's device: a CUDA tensor launches the hand-written kernel
(forward and backward), a CPU tensor takes the kernel's plain PyTorch
version (repro_torch.kernels.ref), and any other device raises. There
is no other fallback: a CUDA kernel that fails to build or launch
raises.

The forwards take f32 or bf16 inputs, as the TPU kernels do. The
DLRM's two backward kernels (the TPU kernels have none) write a bf16
input's gradient in bf16, as the reference's gradient of a bf16
parameter is, with no f32 copy of it: the scatter reads the forward's
f32 d_out into a bf16 table gradient, and the interaction's backward
reads bf16 d_out and feats. `sage_aggregate`'s backward kernel is f32: a
bf16 input's backward hands it d_out and w in f32 and casts the
gradients back to the inputs' dtypes.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import dot_interact as _di
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import ref
from repro_torch.kernels import sage_aggregate as _sa


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


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
        if _on_cuda(tables):
            return _eb.embedding_bag_fwd(tables, ids, combiner)
        return ref.embedding_bag_ref(tables, ids, combiner=combiner)

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (ids,) = ctx.saved_tensors
        d_out = d_out.contiguous()
        if _on_cuda(d_out):
            grad = _eb.embedding_bag_bwd(d_out, ids, ctx.num_rows,
                                         ctx.combiner, dtype=ctx.table_dtype)
        else:
            grad = ref.embedding_bag_bwd_ref(d_out, ids, ctx.num_rows,
                                             combiner=ctx.combiner,
                                             dtype=ctx.table_dtype)
        return grad, None, None


class _EmbeddingBagFused(_EmbeddingBag):
    """The fused function's forward; its backward is `_EmbeddingBag`'s
    scatter (the TPU kernel has none, and the fused function's gradient
    is `embedding_bag`'s)."""

    @staticmethod
    def forward(ctx, tables, ids, combiner):
        _save_bag(ctx, tables, ids, combiner)
        if _on_cuda(tables):
            if fused_fires(tables, ids.shape[-1]):
                return _eb.embedding_bag_fused_fwd(tables, ids, combiner)
            return _eb.embedding_bag_fwd(tables, ids, combiner)
        return ref.embedding_bag_fused_ref(tables, ids, combiner=combiner)


class _DotInteract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        if _on_cuda(feats):
            return _di.dot_interact_fwd(feats)
        return ref.dot_interact_ref(feats)

    @staticmethod
    def backward(ctx, d_out):
        (feats,) = ctx.saved_tensors
        d_out = d_out.contiguous()
        if _on_cuda(d_out):
            return _di.dot_interact_bwd(d_out, feats)
        return ref.dot_interact_bwd_ref(d_out, feats)


class _SageAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, neigh, w):
        # d_w = agg^T d_out: the forward keeps the (B, D) aggregate only
        # when w needs a gradient
        save_agg = ctx.needs_input_grad[1]
        if _on_cuda(neigh):
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
            d_neigh, d_w = _sa.sage_aggregate_bwd(
                d_out.float(), w.float(), agg, ctx.f, need_neigh)
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
    if _on_cuda(tables):
        return _eb.embedding_bag_fwd(tables, ids, "sum", row0=row0)
    return ref.embedding_bag_local_ref(tables, ids, row0)


def embedding_bag_local_bwd(d_out: torch.Tensor, ids: torch.Tensor,
                            row0: int, v_loc: int,
                            dtype: torch.dtype) -> torch.Tensor:
    """The local-rows scatter: d_out (B, F, D) f32 into the gradient
    (F, v_loc, D) in `dtype` of rows [row0, row0 + v_loc); ids outside
    them add nothing."""
    d_out = d_out.contiguous()
    if _on_cuda(d_out):
        return _eb.embedding_bag_bwd(d_out, ids, v_loc, "sum", dtype=dtype,
                                     row0=row0)
    return ref.embedding_bag_local_bwd_ref(d_out, ids, row0, v_loc,
                                           dtype=dtype)


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
