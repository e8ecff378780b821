"""CUDA wrappers of the DLRM dot-interaction kernels (csrc/dot_interact.cu).

Replaces the Pallas TPU kernel `repro/kernels/dot_interact.py::
dot_interact` (pallas_call at :51) and adds the backward the TPU kernel
lacks. See the source for the design; it is bound by bytes.

Same wrapper contract as repro_torch.kernels.embedding_bag: CUDA f32
contiguous tensors only, outputs from `torch.empty`, launch on the
current stream, raise on a refused launch, count it in `LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.embedding_bag import _check

LAUNCHES = {"dot_interact_fwd": 0, "dot_interact_bwd": 0}

# the kernels stage their tile in the 48 KB shared-memory window; the
# backward gives each warp 4 rows, in at most 32 warps
_MAX_SHARED_BYTES = 48 * 1024
_MAX_BWD_FEATURES = 4 * 32


def _status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    LAUNCHES[name] += 1


def _check_tile(f: int, d: int, extra: int = 0):
    if 4 * (f * d + extra) > _MAX_SHARED_BYTES:
        raise ValueError(f"a ({f}, {d}) feature tile does not fit the "
                         f"{_MAX_SHARED_BYTES} B shared-memory window")


def dot_interact_fwd(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) f32 -> (B, F(F-1)/2) f32."""
    _check(feats, "feats", torch.float32, 3)
    b, f, d = feats.shape
    _check_tile(f, d + 4)                   # rows padded by up to 4 floats
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32,
                      device=feats.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("dot_interact_fwd", LIBRARIES.get("dot_interact")
                .dot_interact_fwd(feats.data_ptr(), out.data_ptr(), b, f, d,
                                  stream))
    return out


def dot_interact_bwd(d_out: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """d_out (B, F(F-1)/2) f32, feats (B, F, D) f32 -> dFeats (B, F, D)."""
    _check(feats, "feats", torch.float32, 3)
    _check(d_out, "d_out", torch.float32, 2)
    b, f, d = feats.shape
    if d_out.shape != (b, f * (f - 1) // 2) or d_out.device != feats.device:
        raise ValueError(f"d_out {tuple(d_out.shape)} does not match feats "
                         f"{tuple(feats.shape)}")
    _check_tile(f, d, extra=f * f)
    if f > _MAX_BWD_FEATURES:
        raise ValueError(f"dot_interact_bwd takes at most "
                         f"{_MAX_BWD_FEATURES} features, got {f}")
    out = torch.empty_like(feats)
    if out.numel() == 0:
        return out
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("dot_interact_bwd", LIBRARIES.get("dot_interact")
                .dot_interact_bwd(d_out.data_ptr(), feats.data_ptr(),
                                  out.data_ptr(), b, f, d, stream))
    return out
