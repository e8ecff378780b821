"""CUDA wrappers of the DLRM dot-interaction kernels (csrc/dot_interact.cu).

Replaces the Pallas TPU kernel `repro/kernels/dot_interact.py::
dot_interact` (pallas_call at :51) and adds the backward the TPU kernel
lacks. See the source for the design; both are bound by bytes. The
forward takes f32 or bf16 feats, as the TPU kernel does, and returns
the input's dtype; the backward takes d_out and feats in one dtype, f32
or bf16, and returns d_feats in it.

Both launches are plans computed here, in plain Python that the CPU
tests reach (`fwd_plan`: the width of its copies, persistent warps, CTAs,
shared memory; `bwd_plan`: float4 math, the width of its copies, warps a
CTA, persistent CTAs, shared memory).

Same wrapper contract as repro_torch.kernels.embedding_bag: CUDA
contiguous tensors only, outputs from `torch.empty`, launch on the
current stream, raise on a refused launch, count it in `LAUNCHES`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.embedding_bag import _check
from repro_torch.kernels.sage_aggregate import SMEM, SMS

LAUNCHES = {"dot_interact_fwd": 0, "dot_interact_bwd": 0}

# the wrappers take the (F, D) whose f32 tile (and, for the backward, F x
# F coefficients) fits the 48 KB shared-memory window; the backward takes
# at most 128 features
_MAX_SHARED_BYTES = 48 * 1024
_MAX_BWD_FEATURES = 128

# the backward (csrc/dot_interact.cu): 7 rows of dFeats a warp, 8
# coefficient slots; about 4 persistent CTAs an SM of an H100, within its
# threads and shared memory (228 KB an SM, 1 KB of it reserved a block;
# SMEM, 227 KB, a block)
BWD_ROWS, BWD_SLOTS = 7, 8
BWD_CTAS_PER_SM = 4
SM_SHARED_BYTES = 233472
SM_THREADS = 2048
SM_CTAS = 32


def _round4(n: int) -> int:
    return -(-n // 4) * 4


# the forward (csrc/dot_interact.cu): 4 x 4 blocks of the triangle, a lane
# a block; persistent warps, at most FWD_MAX_WARPS a CTA, each with two
# stages of a sample in shared memory
FWD_BLOCK = 4
FWD_MAX_WARPS = 8


def fwd_ld(d: int) -> int:
    """Floats between the slots of the forward's f32 tile (as csrc's
    fwd_ld): ld / 4 odd for float4 reads (D % 4 == 0), else ld odd."""
    return 4 * ((d // 4) | 1) if d % 4 == 0 else d | 1


def fwd_slot(r: int, f: int) -> int:
    """The tile's slot of feature row r (as csrc's fwd_slot)."""
    nb = -(-f // FWD_BLOCK)
    return (r % FWD_BLOCK) * nb + r // FWD_BLOCK


def fwd_slots(f: int) -> int:
    """Slots of the forward's tile: up to the last row's (as csrc's
    fwd_slots)."""
    nb = -(-f // FWD_BLOCK)
    return max(a * nb + (f - 1 - a) // FWD_BLOCK
               for a in range(min(FWD_BLOCK, f))) + 1


def fwd_warp_smem(f: int, d: int, elem: int = 4) -> int:
    """Bytes of shared memory of one forward warp (as csrc's
    fwd_warp_smem): two f32 tiles, or, for bf16, two raw stages of the
    sample (rounded up to 16 bytes) and one f32 tile."""
    tile = _round4(fwd_slots(f) * fwd_ld(d))
    if elem == 2:
        return 2 * (-(-2 * f * d // 16) * 16) + 4 * tile
    return 8 * tile


def fwd_blocks(f: int):
    """The forward's 4 x 4 blocks (I, J), I >= J, in the order lanes take
    them: block t = I (I + 1) / 2 + J."""
    nb = -(-f // FWD_BLOCK)
    return [(i, j) for i in range(nb) for j in range(i + 1)]


@dataclass(frozen=True)
class FwdPlan:
    copy: int         # bytes a cp.async: 16 or 4; 0 loads lane by lane
    warps: int        # persistent warps a CTA
    ctas: int         # CTAs; warp w of the grid takes samples w, w + W, ...
    smem: int         # shared-memory bytes a CTA

    @property
    def workers(self) -> int:
        return self.warps * self.ctas


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, f: int, d: int, elem: int = 4, ptr: int = 0
             ) -> FwdPlan:
    """The forward's launch for feats (b, f, d) of `elem`-byte elements at
    address `ptr`: 16-byte copies where each sample starts 16-byte
    aligned (and, for f32, every row: D % 4 == 0), else 4-byte ones (for
    bf16 where F D is even and `ptr` 4-byte aligned), else none (a bf16
    feats only 2-byte aligned); of 1 to FWD_MAX_WARPS warps a CTA (within
    a block's shared memory), the fewest that put the most warps on an SM
    (8 at the DLRM shape: more were faster, PERF.md); as many CTAs as the
    SMs hold, at most enough for one sample a warp."""
    if elem == 4:
        copy = 16 if d % 4 == 0 and ptr % 16 == 0 else 4
    else:
        copy = (16 if f * d % 8 == 0 and ptr % 16 == 0 else
                4 if f * d % 2 == 0 and ptr % 4 == 0 else 0)
    per_warp = fwd_warp_smem(f, d, elem)
    warps, per_sm = 1, 1
    for w in range(1, min(FWD_MAX_WARPS, SMEM // per_warp) + 1):
        n = min(SM_SHARED_BYTES // (w * per_warp + 1024), SM_CTAS,
                SM_THREADS // (32 * w))
        if w * n > warps * per_sm:
            warps, per_sm = w, n
    return FwdPlan(copy, warps, max(1, min(-(-b // warps), SMS * per_sm)),
                   warps * per_warp)


def bwd_smem(f: int, d: int, warps: int, elem: int = 4) -> int:
    """Bytes of shared memory of a backward CTA (as csrc's bwd_smem): two
    stages and the (F, 8 x warps) f32 coefficients. An f32 stage holds
    the feats tile and the dOut row, each rounded up to 4 floats; a bf16
    one the raw feats (rounded up to 16 bytes) and the 4-byte words of
    the dOut row (P + 3 half words, rounded up to 8)."""
    if elem == 2:
        stage = -(-2 * f * d // 16) * 16 + 2 * (-(-(f * (f - 1) // 2 + 3)
                                                 // 8) * 8)
    else:
        stage = 4 * (_round4(f * d) + _round4(f * (f - 1) // 2))
    return 2 * stage + 4 * f * BWD_SLOTS * warps


@dataclass(frozen=True)
class BwdPlan:
    vec: int          # floats an FMA step: 4 or 1
    warps: int        # warps a CTA, 7 rows each
    ctas: int         # persistent CTAs, each walking every ctas-th sample
    smem: int         # shared-memory bytes a CTA
    copy: int = 16    # bytes a cp.async of the feats: 16, 4; 0 (bf16) none


def bwd_plan(b: int, f: int, d: int, ptr: int = 0, elem: int = 4
             ) -> BwdPlan:
    """The backward's launch for feats (b, f, d) of `elem`-byte elements,
    `ptr` the feats' address or'd with dFeats': float4 FMAs where D % 4
    == 0 and, for f32, `ptr` is 16-byte aligned (then 16-byte copies, else
    4-byte ones), for bf16 8-byte aligned; a bf16 feats copied 16 bytes
    at a time where F D % 8 == 0 and `ptr` is 16-byte aligned, else 4
    where F D is even and `ptr` 4-byte aligned, else loaded element by
    element; ceil(f / 7) warps; BWD_CTAS_PER_SM CTAs an SM, or as many as
    the SM's threads and shared memory hold, at most b."""
    warps = max(1, -(-f // BWD_ROWS))
    smem = bwd_smem(f, d, warps, elem)
    per_sm = max(1, min(BWD_CTAS_PER_SM, SM_THREADS // (32 * warps),
                        SM_SHARED_BYTES // (smem + 1024)))
    if elem == 2:
        vec = 4 if d % 4 == 0 and ptr % 8 == 0 else 1
        copy = (16 if f * d % 8 == 0 and ptr % 16 == 0 else
                4 if f * d % 2 == 0 and ptr % 4 == 0 else 0)
    else:
        vec = 4 if d % 4 == 0 and ptr % 16 == 0 else 1
        copy = 16 if vec == 4 else 4
    return BwdPlan(vec, warps, max(1, min(b, SMS * per_sm)), smem, copy)


def _status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    LAUNCHES[name] += 1


def _check_tile(f: int, d: int, extra: int = 0):
    if 4 * (f * d + extra) > _MAX_SHARED_BYTES:
        raise ValueError(f"a ({f}, {d}) feature tile does not fit the "
                         f"{_MAX_SHARED_BYTES} B shared-memory window")


def dot_interact_fwd(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) f32 or bf16 -> (B, F(F-1)/2) in feats' dtype, the
    dots summed in f32 (a bf16 out rounded to nearest even)."""
    _check(feats, "feats", (torch.float32, torch.bfloat16), 3)
    b, f, d = feats.shape
    _check_tile(f, d + 4)                   # rows padded by up to 4 floats
    out = torch.empty((b, f * (f - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:
        return out
    plan = fwd_plan(b, f, d, feats.element_size(), feats.data_ptr() % 16)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("dot_interact_fwd", LIBRARIES.get("dot_interact")
                .dot_interact_fwd(feats.data_ptr(), out.data_ptr(), b, f, d,
                                  int(feats.dtype == torch.bfloat16),
                                  plan.copy, plan.warps, plan.ctas,
                                  plan.smem, stream))
    return out


def dot_interact_bwd(d_out: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """d_out (B, F(F-1)/2), feats (B, F, D), both f32 or both bf16 ->
    dFeats (B, F, D) in their dtype, summed in f32 (a bf16 out rounded to
    nearest even once). A bf16 d_out that does not start on a 4-byte
    boundary is copied to one that does (the kernel reads its rows in
    4-byte words)."""
    _check(feats, "feats", (torch.float32, torch.bfloat16), 3)
    _check(d_out, "d_out", feats.dtype, 2)
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
    bf16 = feats.dtype == torch.bfloat16
    if bf16 and d_out.data_ptr() % 4:
        d_out = d_out.clone()
    # either pointer unaligned leaves their OR unaligned
    plan = bwd_plan(b, f, d, feats.data_ptr() | out.data_ptr(),
                    feats.element_size())
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("dot_interact_bwd", LIBRARIES.get("dot_interact")
                .dot_interact_bwd(d_out.data_ptr(), feats.data_ptr(),
                                  out.data_ptr(), b, f, d, int(bf16),
                                  plan.copy, int(plan.vec == 4), plan.warps,
                                  plan.ctas, plan.smem, stream))
    return out
