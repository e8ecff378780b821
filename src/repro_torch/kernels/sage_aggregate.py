"""CUDA wrappers of the GraphSAGE aggregation kernels
(csrc/sage_aggregate.cu).

Replaces the Pallas TPU kernel `repro/kernels/sage_aggregate.py::
sage_aggregate` (pallas_call at :32) and adds the backward the TPU kernel
lacks. See the source for the design; it is bound by bytes.

Same wrapper contract as repro_torch.kernels.embedding_bag: CUDA f32
contiguous tensors only, outputs and scratch from `torch.empty`, launch
on the current stream, raise on a refused launch, count it in
`LAUNCHES`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.embedding_bag import _check

LAUNCHES = {"sage_aggregate_fwd": 0, "sage_aggregate_bwd": 0}

# d_w's reduction over rows is split into at most 2 x 132 blocks (two
# waves on an H100's 132 SMs: the kernel's 205 registers a thread leave
# room for one 256-thread block an SM), each over at least 64 rows; the
# kernel's d_w tile is 128 x 128
_TARGET_BLOCKS = 2 * 132
_DW_TILE = 128
_DW_MIN_ROWS = 64
# the forward stages the aggregate of 8 rows, (D rounded up to 32) x 12
# floats, and a 32 x 128 slice of w in the 227 KB of shared memory a
# block can have
_MAX_D = 4480


def _status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    LAUNCHES[name] += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dw_splits(rows: int, d: int, h: int) -> int:
    """Ranges of rows the d_w reduction is split into (one block each per
    128 x 128 tile of d_w); their partials are summed in range order."""
    tiles = _cdiv(d, _DW_TILE) * _cdiv(h, _DW_TILE)
    # rounded down: one block past a full wave would run alone
    return max(1, min(_TARGET_BLOCKS // tiles, _cdiv(rows, _DW_MIN_ROWS)))


def _check_pair(neigh: torch.Tensor, w: torch.Tensor):
    _check(neigh, "neigh", torch.float32, 3)
    _check(w, "w", torch.float32, 2)
    if w.shape[0] != neigh.shape[2] or w.device != neigh.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not project "
                         f"neigh {tuple(neigh.shape)} on {neigh.device}")
    if neigh.shape[1] < 1 or neigh.shape[2] < 1:
        raise ValueError(f"neigh {tuple(neigh.shape)}: the mean needs F >= 1 "
                         f"and D >= 1")
    if neigh.shape[2] > _MAX_D:
        raise ValueError(f"sage_aggregate_fwd takes D <= {_MAX_D} (its "
                         f"aggregate tile in shared memory), got "
                         f"{neigh.shape[2]}")


def sage_aggregate_fwd(neigh: torch.Tensor, w: torch.Tensor,
                       save_agg: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """neigh (B, F, D) f32, w (D, H) f32 -> (out (B, H) f32, the aggregate
    mean_f(neigh) (B, D) f32 if `save_agg`, else None)."""
    _check_pair(neigh, w)
    b, f, d = neigh.shape
    h = w.shape[1]
    out = torch.empty((b, h), dtype=torch.float32, device=neigh.device)
    agg = (torch.empty((b, d), dtype=torch.float32, device=neigh.device)
           if save_agg else None)
    with torch.cuda.device(neigh.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("sage_aggregate_fwd", LIBRARIES.get("sage_aggregate")
                .sage_aggregate_fwd(neigh.data_ptr(), w.data_ptr(),
                                    out.data_ptr(),
                                    None if agg is None else agg.data_ptr(),
                                    b, f, d, h, stream))
    return out, agg


def sage_aggregate_bwd(d_out: torch.Tensor, w: torch.Tensor,
                       agg: Optional[torch.Tensor], f: int,
                       need_neigh: bool
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """d_out (B, H) f32, w (D, H) f32, agg (B, D) f32 or None ->
    (d_neigh (B, F, D) if `need_neigh` else None, d_w (D, H) if `agg` is
    given else None)."""
    _check(d_out, "d_out", torch.float32, 2)
    _check(w, "w", torch.float32, 2)
    b, h = d_out.shape
    d = w.shape[0]
    if w.shape[1] != h or w.device != d_out.device or f < 1 or d < 1:
        raise ValueError(f"d_out {tuple(d_out.shape)} on {d_out.device} and "
                         f"w {tuple(w.shape)} on {w.device} (F = {f}) do not "
                         f"match")
    if agg is not None:
        _check(agg, "agg", torch.float32, 2)
        if agg.shape != (b, d) or agg.device != d_out.device:
            raise ValueError(f"agg {tuple(agg.shape)} does not match d_out "
                             f"{tuple(d_out.shape)} and w {tuple(w.shape)}")
    dev = d_out.device
    splits = dw_splits(b, d, h)
    d_w = partial = d_neigh = None
    if agg is not None:
        d_w = torch.empty((d, h), dtype=torch.float32, device=dev)
        partial = torch.empty((splits, d, h), dtype=torch.float32,
                              device=dev)
    if need_neigh:
        d_neigh = torch.empty((b, f, d), dtype=torch.float32, device=dev)
    if d_w is None and d_neigh is None:
        return None, None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _status("sage_aggregate_bwd", LIBRARIES.get("sage_aggregate")
                .sage_aggregate_bwd(
                    d_out.data_ptr(), w.data_ptr(),
                    None if agg is None else agg.data_ptr(),
                    None if d_w is None else d_w.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    None if d_neigh is None else d_neigh.data_ptr(),
                    b, f, d, h, splits, stream))
    return d_neigh, d_w
