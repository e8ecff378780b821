"""CUDA wrappers of the GraphSAGE aggregation kernels
(csrc/sage_aggregate.cu).

Replaces the Pallas TPU kernel `repro/kernels/sage_aggregate.py::
sage_aggregate` (pallas_call at :32) and adds the backward the TPU kernel
lacks. See the source for the design: the forward is bound by bytes,
d_w by f32 operations. The forward takes f32 or bf16 neigh and w (each
either), as the TPU kernel does, sums and multiplies in f32 and returns
neigh's dtype; the saved aggregate is f32, and the backward is f32. A
bf16 w is widened to f32 by a kernel of its own first (`widen_w`,
counted apart as `sage_widen_w`).

The host side of each launch is a plan computed here, in plain Python
that the CPU tests reach: `fwd_plan` (rows a tile and its buffers, persistent
CTAs, slices of w in the ring, the width in bytes of the loads of neigh),
`agg_stride` (the saved aggregate's padded rows) and `dw_plan` (the
ranges of rows a d_w tile is split into, and their clusters; on the
card it asks the occupancy query how many clusters fit).

Same wrapper contract as repro_torch.kernels.embedding_bag: CUDA tensors
only (contiguous, except the saved aggregate, whose rows may be
padded), outputs and scratch from `torch.empty`, launch on the current
stream, raise on a refused launch, count it in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import LIBRARIES
from repro_torch.kernels.embedding_bag import _check

LAUNCHES = {"sage_aggregate_fwd": 0, "sage_aggregate_bwd": 0,
            "sage_widen_w": 0}

SMS = 132                     # an H100's SMs
SMEM = 232448                 # shared memory a block can opt into

# the forward (csrc/sage_aggregate.cu): tiles of 32 rows (8 where a CTA has
# fewer) x 128 columns in one or two buffers of the aggregate, the
# multipliers' partial tiles at 8 rows, and a ring of slices of 32 rows of
# w (one piece and 128 floats more when H <= 128, else rows of 128 floats)
_COLS, _W_ROWS = 128, 32
_MIN_STAGES, _FEW_STAGES, _MAX_STAGES = 3, 2, 8
# d_w: 128 x 128 tiles, at least 32 rows a range, clusters of up to 8
_DW_TILE = 128
_DW_MIN_ROWS = 32


def _status(name: str, status: int):
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
    LAUNCHES[name] += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_smem(rows: int, bufs: int, d: int, h: int, stages: int) -> int:
    """Bytes of shared memory of a forward CTA (as csrc's fwd_smem)."""
    lda = _cdiv(d, _W_ROWS) * _W_ROWS + 4
    slot = (_cdiv(_W_ROWS * h, 4) * 4 + _COLS if h <= _COLS
            else _W_ROWS * _COLS)
    return 4 * (bufs * rows * lda + (4 * 8 * _COLS if rows == 8 else 0)
                + stages * slot)


@dataclass(frozen=True)
class FwdPlan:
    rows: int         # rows of a tile: 32, or 8 where a CTA has fewer
    bufs: int         # tiles of the aggregate: 2 lets the next one stream
    ctas: int         # persistent CTAs along the rows, a column tile each
    col_tiles: int    # tiles of 128 output columns
    stages: int       # slices of w in the ring
    vec: int          # elements a load of neigh: 16, 8 or 4 bytes of f32
                      # (4, 2, 1), 16, 4 or 2 bytes of bf16 (8, 2, 1)


def load_width(d: int, elem: int, ptr: int) -> int:
    """Elements a load of neigh's rows of d elements of `elem` bytes from
    address `ptr`: the widest of 16, 8 and 4 bytes (f32) or 16, 4 and 2
    bytes (bf16) that divides both a row and `ptr`."""
    for width in ((16, 8, 4) if elem == 4 else (16, 4, 2)):
        n = width // elem
        if d % n == 0 and ptr % width == 0:
            return n
    raise ValueError(f"neigh at {ptr:#x} is not aligned to its "
                     f"{elem}-byte elements")


def fwd_plan(b: int, f: int, d: int, h: int, ptr: int = 0, elem: int = 4
             ) -> FwdPlan:
    """The forward's launch for neigh (b, f, d) of `elem`-byte elements at
    address `ptr` and w (d, h): one CTA an SM (at most b), shared by the
    column tiles, each walking its ~b / 132 rows in tiles of 32 rows (8
    where it has fewer), in two buffers where shared memory holds them and
    a ring of at least 3 slices of w (so that the next tile streams in
    while this one is multiplied), else one; loads of neigh as wide as
    both a row and `ptr` allow (`load_width`). The shared memory is the
    same for either dtype: the tiles and the ring hold f32."""
    if f < 1 or d < 1:
        raise ValueError(f"the mean needs F >= 1 and D >= 1, got {f}, {d}")
    col_tiles = max(1, _cdiv(h, _COLS))
    ctas = max(1, min(b, SMS // col_tiles))
    rows = 32 if _cdiv(b, ctas) >= 32 else 8
    choice = None
    for least in (_MIN_STAGES, _FEW_STAGES):
        for r, bufs in dict.fromkeys(((rows, 2), (8, 2), (rows, 1), (8, 1))):
            fixed = fwd_smem(r, bufs, d, h, 0)
            stages = min(_MAX_STAGES, (SMEM - fixed) //
                         (fwd_smem(r, bufs, d, h, 1) - fixed))
            if stages >= least:
                choice = (r, bufs, stages)
                break
        if choice:
            break
    if choice is None:
        raise ValueError(f"sage_aggregate_fwd takes D that fits its shared "
                         f"memory (an 8-row tile of the aggregate and "
                         f"{_FEW_STAGES} slices of w); D = {d}, F = {f} do "
                         f"not")
    rows, bufs, stages = choice
    return FwdPlan(rows, bufs, ctas, col_tiles, stages,
                   load_width(d, elem, ptr))


def agg_stride(d: int) -> int:
    """Floats between the saved aggregate's rows: d rounded up to a
    multiple of 4, so that every row starts 16-byte aligned."""
    return _cdiv(d, 4) * 4


@dataclass(frozen=True)
class DwPlan:
    cluster: int      # CTAs of a cluster: consecutive ranges of one tile
    clusters: int     # clusters a tile; > 1 sums them in a second pass

    @property
    def splits(self) -> int:
        return self.cluster * self.clusters


def dw_plan(rows: int, d: int, h: int,
            max_clusters: Callable[[int], int] = lambda c: SMS // c
            ) -> DwPlan:
    """How d_w = agg^T d_out over `rows` rows is split: each 128 x 128
    tile's rows into cluster x clusters ranges of at least 32 rows, one CTA
    each. Of clusters of 1, 2, 4 and 8, the one that runs the most CTAs at
    once (`max_clusters(cluster)` clusters fit on the card), the larger on
    a tie, so that most partials meet in distributed shared memory."""
    tiles = _cdiv(d, _DW_TILE) * _cdiv(h, _DW_TILE)
    ranges = max(1, _cdiv(rows, _DW_MIN_ROWS))
    best = DwPlan(1, 1)
    for cluster in (1, 2, 4, 8):
        if cluster > ranges:
            break
        clusters = max(1, min(max_clusters(cluster) // tiles,
                              ranges // cluster))
        if cluster * clusters >= best.splits:
            best = DwPlan(cluster, clusters)
    return best


_DW_ACTIVE: Dict[Tuple[int, int], int] = {}


def dw_active_clusters(device: torch.device, cluster: int) -> int:
    """Clusters of `cluster` d_w CTAs that fit the card at once (the
    occupancy query, asked once a device and size)."""
    key = (device.index or 0, cluster)
    if key not in _DW_ACTIVE:
        n = ctypes.c_int32(0)
        with torch.cuda.device(device):
            status = LIBRARIES.get("sage_aggregate").sage_dw_max_clusters(
                cluster, ctypes.addressof(n))
        if status != 0 or n.value < 1:
            raise RuntimeError(f"occupancy query for clusters of {cluster} "
                               f"failed: CUDA error {status}, {n.value}")
        _DW_ACTIVE[key] = n.value
    return _DW_ACTIVE[key]


# the forward's input dtypes: the TPU kernel's f32 and bf16
FWD_DTYPES = (torch.float32, torch.bfloat16)


def _check_pair(neigh: torch.Tensor, w: torch.Tensor):
    _check(neigh, "neigh", FWD_DTYPES, 3)
    _check(w, "w", FWD_DTYPES, 2)
    if w.shape[0] != neigh.shape[2] or w.device != neigh.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} does not project "
                         f"neigh {tuple(neigh.shape)} on {neigh.device}")
    if neigh.shape[1] < 1 or neigh.shape[2] < 1:
        raise ValueError(f"neigh {tuple(neigh.shape)}: the mean needs F >= 1 "
                         f"and D >= 1")


def widen_w(w: torch.Tensor) -> torch.Tensor:
    """w (D, H) bf16 -> the same values in f32, by the widening kernel."""
    _check(w, "w", torch.bfloat16, 2)
    w32 = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        _status("sage_widen_w", LIBRARIES.get("sage_aggregate").sage_widen_w(
            w.data_ptr(), w32.data_ptr(), w.numel(),
            torch.cuda.current_stream().cuda_stream))
    return w32


def sage_aggregate_fwd(neigh: torch.Tensor, w: torch.Tensor,
                       save_agg: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """neigh (B, F, D) f32 or bf16, w (D, H) f32 or bf16 -> (out (B, H) in
    neigh's dtype, the aggregate mean_f(neigh) (B, D) f32 if `save_agg`,
    else None). The aggregate is a view of rows `agg_stride(D)` floats
    apart. A bf16 w takes two launches: `widen_w`, then the forward."""
    _check_pair(neigh, w)
    if w.dtype == torch.bfloat16:
        w = widen_w(w)
    b, f, d = neigh.shape
    h = w.shape[1]
    plan = fwd_plan(b, f, d, h, neigh.data_ptr(), neigh.element_size())
    out = torch.empty((b, h), dtype=neigh.dtype, device=neigh.device)
    ld = agg_stride(d)
    agg = (torch.empty((b, ld), dtype=torch.float32, device=neigh.device)
           if save_agg else None)
    with torch.cuda.device(neigh.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("sage_aggregate_fwd", LIBRARIES.get("sage_aggregate")
                .sage_aggregate_fwd(neigh.data_ptr(), w.data_ptr(),
                                    out.data_ptr(),
                                    None if agg is None else agg.data_ptr(),
                                    b, f, d, h, ld, plan.rows, plan.bufs,
                                    plan.ctas, plan.stages, plan.vec,
                                    int(neigh.dtype == torch.bfloat16),
                                    stream))
    return out, None if agg is None else agg[:, :d]


def _check_agg(agg: torch.Tensor, b: int, d: int, dev: torch.device):
    """The saved aggregate: (B, D) f32 on `dev` with unit column stride and
    rows at least D floats apart (the forward pads them)."""
    if agg.device != dev or agg.dtype != torch.float32 \
            or tuple(agg.shape) != (b, d):
        raise ValueError(f"agg {tuple(agg.shape)} {agg.dtype} on "
                         f"{agg.device} is not the ({b}, {d}) f32 aggregate "
                         f"on {dev}")
    if b > 0 and (agg.stride(1) != 1 or agg.stride(0) < d):
        raise ValueError(f"agg's rows must be at least {d} contiguous "
                         f"floats apart, got strides {agg.stride()}")


def sage_aggregate_bwd(d_out: torch.Tensor, w: torch.Tensor,
                       agg: Optional[torch.Tensor], f: int,
                       need_neigh: bool
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """d_out (B, H) f32, w (D, H) f32, agg (B, D) f32 (rows may be padded)
    or None -> (d_neigh (B, F, D) if `need_neigh` else None, d_w (D, H) if
    `agg` is given else None)."""
    _check(d_out, "d_out", torch.float32, 2)
    _check(w, "w", torch.float32, 2)
    b, h = d_out.shape
    d = w.shape[0]
    if w.shape[1] != h or w.device != d_out.device or f < 1 or d < 1:
        raise ValueError(f"d_out {tuple(d_out.shape)} on {d_out.device} and "
                         f"w {tuple(w.shape)} on {w.device} (F = {f}) do not "
                         f"match")
    dev = d_out.device
    if agg is not None:
        _check_agg(agg, b, d, dev)
    plan = dw_plan(b, d, h, lambda c: dw_active_clusters(dev, c))
    d_w = scratch = d_neigh = None
    if agg is not None:
        d_w = torch.empty((d, h), dtype=torch.float32, device=dev)
        if plan.clusters > 1:
            scratch = torch.empty((plan.clusters, d, h), dtype=torch.float32,
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
                    d if agg is None else max(d, agg.stride(0)),
                    None if d_w is None else d_w.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    None if d_neigh is None else d_neigh.data_ptr(),
                    b, f, d, h, plan.splits, plan.cluster, stream))
    return d_neigh, d_w
