"""Public differentiable ops over the kernels: the port of the dispatch
layer repro/kernels/ops.py.

Where the JAX package picks compiled or interpret mode, the port picks
by the tensor's device: a CUDA tensor launches the hand-written kernel
(forward and backward), a CPU tensor takes the kernel's plain PyTorch
version (repro_torch.kernels.ref), and any other device raises. There
is no other fallback: a CUDA kernel that fails to build or launch
raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import dot_interact as _di
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, ids, combiner):
        ctx.save_for_backward(ids)
        ctx.combiner = combiner
        ctx.num_rows = tables.shape[1]
        ctx.table_dtype = tables.dtype
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
                                         ctx.combiner)
        else:
            grad = ref.embedding_bag_bwd_ref(d_out, ids, ctx.num_rows,
                                             combiner=ctx.combiner)
        return grad.to(ctx.table_dtype), None, None


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


def embedding_bag(tables: torch.Tensor, ids: torch.Tensor, *,
                  combiner: str = "sum") -> torch.Tensor:
    """Stacked multi-feature bag: tables (F, V, D), ids (B, F, bag) ->
    (B, F, D) f32, differentiable in `tables`."""
    return _EmbeddingBag.apply(tables, ids, combiner)


def dot_interact(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) -> (B, F(F-1)/2) lower-triangle pairwise dots,
    differentiable."""
    return _DotInteract.apply(feats)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel in this process, by kernel name."""
    return {**_eb.LAUNCHES, **_di.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_eb.LAUNCHES, _di.LAUNCHES):
        for name in counts:
            counts[name] = 0
