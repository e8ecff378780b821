"""CUDA wrappers of the stacked embedding-bag kernels (csrc/embedding_bag.cu).

Replaces the Pallas TPU kernel `repro/kernels/embedding_bag.py::
embedding_bag` (pallas_call at :75) and adds the backward the TPU kernel
lacks. See the source for the design; it is bound by bytes.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
`torch.empty` / `torch.zeros`, launches on the current stream, raises if
the launch was refused, and counts the launch in `LAUNCHES`. The CPU
path lives in repro_torch.kernels.ops, which picks the plain version
for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARIES

LAUNCHES = {"embedding_bag_fwd": 0, "embedding_bag_bwd": 0}

_COMBINERS = {"sum": 0, "mean": 1}


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _mean_flag(combiner: str) -> int:
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    return _COMBINERS[combiner]


def _status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    LAUNCHES[name] += 1


def embedding_bag_fwd(tables: torch.Tensor, ids: torch.Tensor,
                      combiner: str = "sum") -> torch.Tensor:
    """tables (F, V, D) f32, ids (B, F, bag) int32 -> (B, F, D) f32."""
    mean = _mean_flag(combiner)
    _check(tables, "tables", torch.float32, 3)
    _check(ids, "ids", torch.int32, 3)
    f, v, d = tables.shape
    b, f_ids, bag = ids.shape
    if f_ids != f or bag < 1 or ids.device != tables.device:
        raise ValueError(f"ids {tuple(ids.shape)} on {ids.device} do not "
                         f"index tables {tuple(tables.shape)} on "
                         f"{tables.device}")
    out = torch.empty((b, f, d), dtype=torch.float32, device=tables.device)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_bag_fwd", LIBRARIES.get("embedding_bag")
                .embedding_bag_fwd(tables.data_ptr(), ids.data_ptr(),
                                   out.data_ptr(), b, f, v, d, bag, mean,
                                   stream))
    return out


def embedding_bag_scatter(d_out: torch.Tensor, ids: torch.Tensor,
                          grad: torch.Tensor, combiner: str = "sum"):
    """Scatter-add d_out (B, F, D) f32 into grad (F, V, D) f32 in place,
    at the rows ids (B, F, bag) int32 name (divided by bag for mean)."""
    mean = _mean_flag(combiner)
    _check(d_out, "d_out", torch.float32, 3)
    _check(ids, "ids", torch.int32, 3)
    _check(grad, "grad", torch.float32, 3)
    b, f, bag = ids.shape
    f_g, v, d = grad.shape
    if d_out.shape != (b, f, d) or f_g != f or bag < 1 \
            or not (d_out.device == ids.device == grad.device):
        raise ValueError(f"d_out {tuple(d_out.shape)}, ids "
                         f"{tuple(ids.shape)} and grad {tuple(grad.shape)} "
                         f"do not match")
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_bag_bwd", LIBRARIES.get("embedding_bag")
                .embedding_bag_bwd(d_out.data_ptr(), ids.data_ptr(),
                                   grad.data_ptr(), b, f, v, d, bag, mean,
                                   stream))
    return grad


def embedding_bag_bwd(d_out: torch.Tensor, ids: torch.Tensor, num_rows: int,
                      combiner: str = "sum") -> torch.Tensor:
    """The dense table gradient (F, num_rows, D) f32. Its zero fill is
    the allocation's (`torch.zeros`), not the kernel's."""
    grad = torch.zeros((ids.shape[1], num_rows, d_out.shape[-1]),
                       dtype=torch.float32, device=d_out.device)
    return embedding_bag_scatter(d_out, ids, grad, combiner)
