"""CUDA wrappers of the stacked embedding-bag kernels.

`embedding_bag_fwd` / `embedding_bag_bwd` (csrc/embedding_bag.cu) replace
the Pallas TPU kernel `repro/kernels/embedding_bag.py::embedding_bag`
(pallas_call at :75) and add the backward the TPU kernel lacks.
`embedding_bag_fused_fwd` (csrc/embedding_bag_fused.cu) replaces
`embedding_bag_fused` (pallas_call at :135), the resident-table variant
for small tables and bags. See the sources for the designs; all are
bound by bytes. The row kernel's local-rows mode (`row0` given) takes one
rank's row shard of row-sharded tables, as the reference's
`tp_multifeature_bag` does (an id outside the shard reads 0 and adds
nothing); its launches count under `embedding_bag_fwd_local` and
`embedding_bag_bwd_local`. The forwards take f32 or bf16 tables, as the TPU
kernels do, and return f32; the backward reads an f32 d_out and writes
the gradient in the tables' dtype, f32 or bf16.

The launches are plans computed here, in plain Python that the CPU
tests reach (`fwd_plan`: elements a load, threads a row or the flat
walk's divisors, blocks; `fused_plan`: the same and the feature groups
of its walk; `bwd_plan`: columns an atomic word, threads a row or the
flat walk's divisor, the feature groups of its walk).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
`torch.empty` / `torch.zeros`, launches on the current stream, raises if
the launch was refused, and counts the launch in `LAUNCHES`. The CPU
path lives in repro_torch.kernels.ops, which picks the plain version
for CPU tensors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.kernels.build import LIBRARIES

LAUNCHES = {"embedding_bag_fwd": 0, "embedding_bag_bwd": 0,
            "embedding_bag_fused_fwd": 0, "embedding_bag_fwd_local": 0,
            "embedding_bag_bwd_local": 0}

# the fused kernel's unroll bound (csrc/embedding_bag_fused.cu, kMaxBag)
FUSED_MAX_BAG = 16

_COMBINERS = {"sum": 0, "mean": 1}

# the backward (csrc/embedding_bag.cu): blocks of 256 threads; a feature
# group's gradient slices fit 8 MiB of the H100's 50 MB L2 (at D = 1, of
# groups of 1, 2, 4, 8 and 40 features, 2 was the fastest on the card:
# PERF.md); the grid's y dimension (one feature group each) is at most
# 65535
BWD_THREADS = 256
BWD_L2_BYTES = 8 * 2 ** 20
_MAX_GROUPS = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Div(NamedTuple):
    """The flat walk's divisor of d: n // d = (n * magic) >> shift for
    every 0 <= n < 2^31; magic 0 where the walk has indices of 2^31 or
    more, which the kernel divides in 64 bits."""
    magic: int
    shift: int


NO_DIV = Div(0, 0)


def divisor(d: int, threads: int) -> Div:
    """The divisor of d for a walk of `threads` indices (0 .. threads -
    1): Granlund and Montgomery's round-up method, shift = 31 + ceil(log2
    d) and magic = ceil(2^shift / d) < 2^32, exact for every n < 2^31
    since (2^31 - 1) (magic d - 2^shift) < 2^shift; NO_DIV (the 64-bit
    division) for a walk of more than 2^31 indices."""
    if threads > 2 ** 31:
        return NO_DIV
    shift = 31 + (d - 1).bit_length()
    return Div(_cdiv(1 << shift, d), shift)


@dataclass(frozen=True)
class BwdPlan:
    vec: int          # columns a word: 4 or 2 (f32) or 8 (bf16), or 1
    lanes: int        # threads a (b, f) row, a power of two <= 32; 0: the
                      # flat walk, a thread a word
    group: int        # features a group of the walk
    groups: int       # feature groups: the grid's y
    blocks: int       # blocks a group: the grid's x
    per_row: Div = NO_DIV     # the flat walk: a word's row, // (d // vec)

    @property
    def lanes_log2(self) -> int:
        return self.lanes.bit_length() - 1


def bwd_plan(b: int, f: int, v: int, d: int, ptr: int = 0,
             elem: int = 4) -> BwdPlan:
    """The scatter's launch for d_out (b, f, d) f32 into grad (f, v, d) of
    `elem`-byte elements, both at addresses or'd into `ptr`: words of 16
    bytes of d_out (float4 atomics into an f32 grad, four bf16x2 atomics
    of 8 columns into a bf16 one) where D is a multiple of the word and
    ptr 16-byte aligned; into an f32 grad next 8 bytes (float2 atomics)
    where D is even and ptr 8-byte aligned; else one column. Feature
    groups of as many features as have gradient slices (v x d x elem
    bytes) within BWD_L2_BYTES, at least 1 (and few enough groups for the
    grid). An f32 grad's narrower words take the flat walk (lanes 0): a
    thread a word, blocks enough for a group's words, and the divisor of
    a row's words (at D = 1 a thread a row). The rest take the lane walk:
    lanes the power of two covering a row's words, at most 32, and blocks
    enough for b rows of a group's features (a bf16 grad's single columns
    keep it: no model takes them)."""
    if elem == 4:
        vec = load_width(d, 4, ptr, (16, 8))
    else:
        vec = 8 if d % 8 == 0 and ptr % 16 == 0 else 1
    words = d // vec
    group = max(1, min(f, BWD_L2_BYTES // max(1, elem * v * d)),
                _cdiv(f, _MAX_GROUPS))
    rows = b * min(group, f)
    if elem == 4 and vec < 4:
        blocks = _cdiv(rows * words, BWD_THREADS)
        return BwdPlan(vec, 0, group, _cdiv(f, group), blocks,
                       divisor(words, blocks * BWD_THREADS))
    lanes = 1
    while lanes < 32 and lanes < words:
        lanes *= 2
    return BwdPlan(vec, lanes, group, _cdiv(f, group),
                   _cdiv(rows * lanes, BWD_THREADS))


# the forward (csrc/embedding_bag.cu): blocks of 128 threads (about 1%
# faster than 256 on the card, 512 slower: PERF.md); its words: 16 bytes,
# then 8 for f32 tables and 4 for bf16 ones; 2 words a thread on the flat
# walk (kFlatWords)
FWD_THREADS = 128
FWD_WIDTHS = {4: (16, 8), 2: (16, 4)}
FLAT_WORDS = 2


@dataclass(frozen=True)
class FwdPlan:
    vec: int          # elements a word: 4, 2 or 1 (f32); 8, 2 or 1 (bf16)
    lanes: int        # threads a (b, f) row, a power of two <= 32; 0: the
                      # flat walk, FLAT_WORDS words a thread
    blocks: int       # blocks of FWD_THREADS
    per_row: Div = NO_DIV     # the flat walk: a word's row, // (d // vec)
    per_feat: Div = NO_DIV    # and the row's feature, row % f

    @property
    def lanes_log2(self) -> int:
        return self.lanes.bit_length() - 1


@functools.lru_cache(maxsize=None)
def fwd_plan(b: int, f: int, d: int, elem: int = 4, ptr: int = 0
             ) -> FwdPlan:
    """The forward's launch for ids (b, f, bag) into tables (f, v, d) of
    `elem`-byte elements at address `ptr` (or'd with the output's): words
    as wide as `load_width` allows of FWD_WIDTHS. An f32 table's narrower
    words take the flat walk (lanes 0): words of the flattened output,
    blocks enough for every word, and the divisors of a row's words and
    of f. The rest take the lane walk: lanes
    the power of two covering a row's words, at most 32, and blocks enough
    for every row (a bf16 table's 4- and 2-byte words keep it: no model
    takes them). Both walk the rows in memory order; the flat walk's
    thread t takes words t + k S, k < FLAT_WORDS, of the grid's S
    threads, and its divisors cover the FLAT_WORDS S word indices."""
    vec = load_width(d, elem, ptr, FWD_WIDTHS[elem])
    words = d // vec
    if elem == 4 and vec < 4:
        blocks = _cdiv(b * f * words, FWD_THREADS * FLAT_WORDS)
        threads = blocks * FWD_THREADS * FLAT_WORDS
        return FwdPlan(vec, 0, blocks, divisor(words, threads),
                       divisor(f, threads))
    lanes = 1
    while lanes < 32 and lanes < words:
        lanes *= 2
    return FwdPlan(vec, lanes, _cdiv(b * f * lanes, FWD_THREADS))


# the fused forward (csrc/embedding_bag_fused.cu): blocks of 256 threads;
# the walk in groups of features whose tables fit 16 MiB of the 50 MB L2
# (at the wide arm, of groups of 2, 4, 8 and 16 features 4 was the
# fastest with f32 tables, 4 MiB each, and 8 with bf16 ones, 2 MiB each:
# PERF.md)
FUSED_THREADS = 256
FUSED_L2_BYTES = 16 * 2 ** 20


@dataclass(frozen=True)
class FusedPlan:
    vec: int          # elements a load: 4 or 1 (f32); 8, 2 or 1 (bf16)
    lanes: int        # threads a (b, f) row, a power of two <= 32
    group: int        # features a group of the walk
    blocks: int       # blocks of FUSED_THREADS

    @property
    def lanes_log2(self) -> int:
        return self.lanes.bit_length() - 1


def load_width(d: int, elem: int, ptr: int, widths=(16, 4)) -> int:
    """Elements a load of a row of d elements of `elem` bytes at address
    `ptr` (and every row after it): the first of `widths` bytes, widest
    first, that d and ptr allow; else one element. The fused forward's
    are 16 bytes, then 4 (for bf16; one f32 element)."""
    for width in widths:
        n = width // elem
        if d % n == 0 and ptr % width == 0:
            return n
    return 1


@functools.lru_cache(maxsize=None)
def fused_plan(b: int, f: int, v: int, d: int, bag: int, elem: int = 4,
               ptr: int = 0) -> FusedPlan:
    """The fused forward's launch for ids (b, f, bag) into tables (f, v,
    d) of `elem`-byte elements at address `ptr` (or'd with the output's):
    loads as wide as `load_width` allows; lanes the power of two covering
    a row's loads, at most 32; feature groups of as many features as have
    tables within FUSED_L2_BYTES (at least 1, at most f); blocks enough
    for every row."""
    vec = load_width(d, elem, ptr)
    lanes = 1
    while lanes < 32 and lanes * vec < d:
        lanes *= 2
    group = max(1, min(f, FUSED_L2_BYTES // max(1, v * d * elem)))
    return FusedPlan(vec, lanes, group,
                     _cdiv(b * f * lanes, FUSED_THREADS))


def _check(t: torch.Tensor, name: str, dtype, ndim: int):
    """`dtype` is one dtype or a tuple of the dtypes taken."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
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


# the forwards' table dtypes: the TPU kernels' "f32/bf16"
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _check_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Checks a forward's inputs; returns its (B, F, D) f32 output."""
    _check(tables, "tables", TABLE_DTYPES, 3)
    _check(ids, "ids", torch.int32, 3)
    f, v, d = tables.shape
    b, f_ids, bag = ids.shape
    if f_ids != f or bag < 1 or ids.device != tables.device:
        raise ValueError(f"ids {tuple(ids.shape)} on {ids.device} do not "
                         f"index tables {tuple(tables.shape)} on "
                         f"{tables.device}")
    return torch.empty((b, f, d), dtype=torch.float32, device=tables.device)


def _local(row0) -> tuple:
    """The kernels' (row0, local) arguments, and the launch's name suffix."""
    if row0 is None:
        return 0, 0, ""
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    return int(row0), 1, "_local"


def embedding_bag_fwd(tables: torch.Tensor, ids: torch.Tensor,
                      combiner: str = "sum", row0=None) -> torch.Tensor:
    """tables (F, V, D) f32 or bf16, ids (B, F, bag) int32 -> (B, F, D)
    f32, summed in f32. With `row0` the tables are rows [row0, row0 + V)
    of each feature's table (the local-rows mode): an id outside them
    reads 0."""
    mean = _mean_flag(combiner)
    row0, local, suffix = _local(row0)
    out = _check_lookup(tables, ids)
    f, v, d = tables.shape
    b, _, bag = ids.shape
    plan = fwd_plan(b, f, d, tables.element_size(),
                    (tables.data_ptr() | out.data_ptr()) % 16)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_bag_fwd" + suffix, LIBRARIES.get("embedding_bag")
                .embedding_bag_fwd(tables.data_ptr(), ids.data_ptr(),
                                   out.data_ptr(), b, f, v, d, bag, mean,
                                   int(tables.dtype == torch.bfloat16),
                                   plan.vec, plan.lanes_log2, plan.blocks,
                                   *plan.per_row, *plan.per_feat, row0,
                                   local, stream))
    return out


def embedding_bag_fused_fwd(tables: torch.Tensor, ids: torch.Tensor,
                            combiner: str = "sum") -> torch.Tensor:
    """tables (F, V, D) f32 or bf16, ids (B, F, bag <= 16) int32 -> (B, F,
    D) f32, bit-equal to `embedding_bag_fwd`. The kernel refuses (and
    this raises) a walk of more than 2^31 - 1 threads or rows
    (csrc/embedding_bag_fused.cu)."""
    mean = _mean_flag(combiner)
    out = _check_lookup(tables, ids)
    f, v, d = tables.shape
    b, _, bag = ids.shape
    if bag > FUSED_MAX_BAG:
        raise ValueError(f"embedding_bag_fused_fwd takes bags of at most "
                         f"{FUSED_MAX_BAG} ids, got {bag}")
    plan = fused_plan(b, f, v, d, bag, tables.element_size(),
                      (tables.data_ptr() | out.data_ptr()) % 16)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_bag_fused_fwd",
                LIBRARIES.get("embedding_bag_fused").embedding_bag_fused_fwd(
                    tables.data_ptr(), ids.data_ptr(), out.data_ptr(), b, f,
                    v, d, bag, mean, int(tables.dtype == torch.bfloat16),
                    plan.vec, plan.lanes_log2, plan.group, plan.blocks,
                    stream))
    return out


def embedding_bag_scatter(d_out: torch.Tensor, ids: torch.Tensor,
                          grad: torch.Tensor, combiner: str = "sum",
                          row0=None):
    """Scatter-add d_out (B, F, D) f32 into grad (F, V, D) f32 or bf16 in
    place, at the rows ids (B, F, bag) int32 name (divided by bag for
    mean); a bf16 grad takes each addend rounded once, by bf16 atomics.
    With `row0`, grad is of rows [row0, row0 + V) and ids outside them
    add nothing."""
    mean = _mean_flag(combiner)
    row0, local, suffix = _local(row0)
    _check(d_out, "d_out", torch.float32, 3)
    _check(ids, "ids", torch.int32, 3)
    _check(grad, "grad", TABLE_DTYPES, 3)
    b, f, bag = ids.shape
    f_g, v, d = grad.shape
    if d_out.shape != (b, f, d) or f_g != f or bag < 1 \
            or not (d_out.device == ids.device == grad.device):
        raise ValueError(f"d_out {tuple(d_out.shape)}, ids "
                         f"{tuple(ids.shape)} and grad {tuple(grad.shape)} "
                         f"do not match")
    plan = bwd_plan(b, f, v, d, (d_out.data_ptr() | grad.data_ptr()) % 16,
                    grad.element_size())
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_bag_bwd" + suffix, LIBRARIES.get("embedding_bag")
                .embedding_bag_bwd(d_out.data_ptr(), ids.data_ptr(),
                                   grad.data_ptr(), b, f, v, d, bag, mean,
                                   int(grad.dtype == torch.bfloat16),
                                   plan.vec, plan.lanes_log2, plan.group,
                                   plan.blocks, plan.groups, *plan.per_row,
                                   row0, local, stream))
    return grad


def embedding_bag_bwd(d_out: torch.Tensor, ids: torch.Tensor, num_rows: int,
                      combiner: str = "sum",
                      dtype: torch.dtype = torch.float32,
                      row0=None) -> torch.Tensor:
    """The dense table gradient (F, num_rows, D) in `dtype`, the tables'
    (f32 or bf16); with `row0`, of rows [row0, row0 + num_rows) alone.
    Its zero fill is the allocation's (`torch.zeros`), not the
    kernel's."""
    grad = torch.zeros((ids.shape[1], num_rows, d_out.shape[-1]),
                       dtype=dtype, device=d_out.device)
    return embedding_bag_scatter(d_out, ids, grad, combiner, row0)
