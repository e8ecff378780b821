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

`embedding_take_fwd_local` / `embedding_take_bwd_local`
(csrc/embedding_take.cu) are the single-hot take from one rank's row
shard, the vocab-sharded lookup's (the reference's `tp_embedding_lookup`
and `tp_sampled_scores`): a table (v_loc, D) and ids (N,) -> (N, D) in
the table's dtype, and its gradient from d_out in that dtype, each named
row written once by its owner (no atomics, the same bits run to run).

The launches are plans computed here, in plain Python that the CPU
tests reach (`fwd_plan`: elements a load, threads a row or the flat
walk's divisors, blocks; `fused_plan`: the same and the feature groups
of its walk; `bwd_plan`: columns an atomic word, threads a row or the
flat walk's divisor, the feature groups of its walk; `take_fwd_plan`:
bytes a word, blocks, the divisor of a row's words; `take_bwd_plan`: the
sort's passes and tiles, columns a word, the sum's scratch).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else, allocates its outputs with
`torch.empty` / `torch.zeros`, launches on the current stream, raises if
the launch was refused, and counts the launch in `LAUNCHES`. The CPU
path lives in repro_torch.kernels.ops, which picks the plain version
for CPU tensors. A meta tensor (the dry run's: shapes, no values) takes
the same wrapper as far as the launch: the same checks, plans, outputs
and scratch, and the launch counted (`planned`) but not made. The C
entries' own refusals, of a plan that does not fit its call, are not
asked there: the plans are the card's.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.kernels.build import LIBRARIES

LAUNCHES = {"embedding_bag_fwd": 0, "embedding_bag_bwd": 0,
            "embedding_bag_fused_fwd": 0, "embedding_bag_fwd_local": 0,
            "embedding_bag_bwd_local": 0, "embedding_take_fwd_local": 0,
            "embedding_take_bwd_local": 0}

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
    """`dtype` is one dtype or a tuple of the dtypes taken; a meta tensor
    passes as a CUDA one."""
    if t.device.type not in ("cuda", "meta"):
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


def planned(launches: dict, name: str, t: torch.Tensor) -> bool:
    """Whether `t`, a wrapper's output, is a meta tensor: then the launch
    is counted in `launches` under `name` and not made, the outputs and
    scratch the wrapper allocated being all it does there."""
    if t.device.type != "meta":
        return False
    launches[name] += 1
    return True


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
    if planned(LAUNCHES, "embedding_bag_fwd" + suffix, out):
        return out
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
    D) f32, bit-equal to `embedding_bag_fwd`. This refuses a walk of
    more than 2^31 - 1 threads, as the kernel does
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
    if b * f > (2 ** 31 - 1) >> plan.lanes_log2:
        raise ValueError(f"embedding_bag_fused_fwd walks at most 2^31 - 1 "
                         f"threads, got {b * f} rows of {plan.lanes}")
    if planned(LAUNCHES, "embedding_bag_fused_fwd", out):
        return out
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
    if planned(LAUNCHES, "embedding_bag_bwd" + suffix, grad):
        return grad
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


# the single-hot take (csrc/embedding_take.cu): the forward's blocks of
# 256 threads, 4 words a thread in flight a round (kFwdWords; one round
# of blocks was as fast as a grid capped at 528-2112 blocks walking more:
# kernel_probes.py take); its words 16, 4 or 2 bytes
TAKE_THREADS = 256
TAKE_WORDS = 4
TAKE_WIDTHS = (16, 4, 2)
# the backward's radix sort: blocks of 256 threads, tiles of 256 kpt
# positions (kpt 1, 2, 4 or 8, the fewest that keep the tiles within 4 an
# SM of the H100's 132), digits of at most 10 bits; its segmented sum's
# chunks of 64 positions at level 1 (kChunk), of 16 partials after
# (kChunkUp)
SORT_THREADS = 256
SORT_MAX_BITS = 10
SORT_TILES = 4 * 132
TAKE_CHUNK = 64
TAKE_CHUNK_UP = 16


@dataclass(frozen=True)
class TakeFwdPlan:
    word: int         # bytes a word: 16, 4 or 2
    blocks: int       # blocks of TAKE_THREADS, TAKE_WORDS words a thread
                      # a round
    per_row: Div      # a word's row: // (row bytes // word)


def take_fwd_span(words: int, blocks: int) -> int:
    """The forward walk's indices lie below this: its words and one round
    of the grid past them."""
    return words + blocks * TAKE_THREADS * TAKE_WORDS


@functools.lru_cache(maxsize=None)
def take_fwd_plan(n: int, row_bytes: int, ptr: int = 0) -> TakeFwdPlan:
    """The forward's launch for n rows of `row_bytes` bytes, table and
    output at addresses or'd into `ptr`: the widest of TAKE_WIDTHS that
    divides a row and aligns both, blocks enough for every word in one
    round of TAKE_WORDS a thread, and the divisor of a row's words over
    the walk's span."""
    word = next((w for w in TAKE_WIDTHS if row_bytes % w == 0
                 and ptr % w == 0), 0)
    if word == 0:
        raise ValueError(f"a row of {row_bytes} bytes at {ptr:#x} takes no "
                         f"word of {TAKE_WIDTHS} bytes")
    words = n * (row_bytes // word)
    blocks = max(1, _cdiv(words, TAKE_THREADS * TAKE_WORDS))
    return TakeFwdPlan(word, blocks, divisor(
        max(1, row_bytes // word), take_fwd_span(words, blocks)))


@dataclass(frozen=True)
class TakeBwdPlan:
    vec: int          # columns a word: 8 (bf16) or 4 (f32), else 1
    passes: int       # radix passes, of
    radix_bits: int   # bits a digit, covering the keys [0, v_loc]
    kpt: int          # positions a thread of a sort tile
    tiles: int        # sort tiles: SORT_THREADS kpt positions each
    part_a: int       # rows of D floats for levels 2, 4, ... of the sum
    part_b: int       # and for levels 3, 5, ...

    @property
    def radix(self) -> int:
        return 1 << self.radix_bits


def take_levels(n: int) -> list:
    """The segmented sum's levels: the elements each takes, n at level 1
    (chunks of TAKE_CHUNK), then twice the chunks of the one before (in
    chunks of TAKE_CHUNK_UP), until a level of one chunk."""
    sizes = [n]
    chunk = TAKE_CHUNK
    while _cdiv(sizes[-1], chunk) > 1:
        sizes.append(2 * _cdiv(sizes[-1], chunk))
        chunk = TAKE_CHUNK_UP
    return sizes


@functools.lru_cache(maxsize=None)
def take_bwd_plan(n: int, v_loc: int, d: int, elem: int = 4,
                  ptr: int = 0) -> TakeBwdPlan:
    """The backward's launch for d_out (n, d) into a gradient (v_loc, d)
    of `elem`-byte elements, both at addresses or'd into `ptr`: 16-byte
    words where d and ptr allow, else one column; the sort's keys [0,
    v_loc] in the fewest passes of at most SORT_MAX_BITS bits, spread
    evenly; tiles of the fewest positions a thread (1, 2, 4 or 8) that
    keep them within SORT_TILES; the partials of every level after the
    first, in two buffers taken in turns."""
    vec = 16 // elem if d % (16 // elem) == 0 and ptr % 16 == 0 else 1
    bits = max(1, v_loc.bit_length())
    passes = _cdiv(bits, SORT_MAX_BITS)
    kpt = 1
    while kpt < 8 and _cdiv(n, SORT_THREADS * kpt) > SORT_TILES:
        kpt *= 2
    levels = take_levels(n)[1:]
    return TakeBwdPlan(vec, passes, _cdiv(bits, passes), kpt,
                       max(1, _cdiv(n, SORT_THREADS * kpt)),
                       max(levels[0::2], default=0),
                       max(levels[1::2], default=0))


def _check_take(table: torch.Tensor, ids: torch.Tensor, row0):
    _check(table, "table", TABLE_DTYPES, 2)
    _check(ids, "ids", torch.int32, 1)
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")


def _check_d_out(d_out: torch.Tensor, ids: torch.Tensor, shape, dtype,
                 device):
    """d_out (N, D) of the take's gradient (shape (v_loc, D), `dtype`, on
    `device`), ids (N,)."""
    _check(d_out, "d_out", TABLE_DTYPES, 2)
    if ids.shape[0] != d_out.shape[0] or shape[1] != d_out.shape[1] \
            or dtype != d_out.dtype \
            or not (d_out.device == ids.device == device):
        raise ValueError(f"d_out {tuple(d_out.shape)} {d_out.dtype}, ids "
                         f"{tuple(ids.shape)} and grad {tuple(shape)} "
                         f"{dtype} do not match")


def embedding_take_fwd_local(table: torch.Tensor, ids: torch.Tensor,
                             row0: int) -> torch.Tensor:
    """table (v_loc, D) f32 or bf16, rows [row0, row0 + v_loc) of a
    row-sharded table; ids (N,) int32 -> (N, D) in the table's dtype: row
    id - row0 for an id in the shard, zeros for any other (the masked
    take), a copy bit for bit."""
    _check_take(table, ids, row0)
    v_loc, d = table.shape
    n = ids.shape[0]
    out = torch.empty((n, d), dtype=table.dtype, device=table.device)
    row_bytes = d * table.element_size()
    if n == 0 or row_bytes == 0:
        return out
    plan = take_fwd_plan(n, row_bytes,
                         (table.data_ptr() | out.data_ptr()) % 16)
    if planned(LAUNCHES, "embedding_take_fwd_local", out):
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_take_fwd_local", LIBRARIES.get("embedding_take")
                .embedding_take_fwd(table.data_ptr(), ids.data_ptr(),
                                    out.data_ptr(), n, v_loc, row_bytes,
                                    plan.word, plan.blocks, *plan.per_row,
                                    int(row0), stream))
    return out


def embedding_take_scatter(d_out: torch.Tensor, ids: torch.Tensor,
                           grad: torch.Tensor, row0: int) -> torch.Tensor:
    """The take's gradient into grad (v_loc, D), zeroed by the caller, of
    rows [row0, row0 + v_loc): each row that ids (N,) int32 name in the
    shard gets the f32 sum of its slots' rows of d_out (N, D), in
    ascending slot order within a chunk of 64 sorted slots and in a fixed
    tree across chunks, rounded once to grad's dtype, d_out's; every other
    row is left as it is. Each row is written once, by its owner; the
    sort and the partials take scratch from `torch.empty`."""
    _check_take(grad, ids, row0)
    _check_d_out(d_out, ids, grad.shape, grad.dtype, grad.device)
    n, d = d_out.shape
    v_loc = grad.shape[0]
    if n == 0 or d == 0 or v_loc == 0:
        return grad
    if max(n, v_loc) >= 2 ** 31 - 1:
        raise ValueError(f"{n} ids into {v_loc} rows: the sort's keys and "
                         f"slots are int32")
    plan = take_bwd_plan(n, v_loc, d, grad.element_size(),
                         (d_out.data_ptr() | grad.data_ptr()) % 16)
    dev = grad.device
    # the scratch in two allocations: the ints (the sort's keys and slots
    # in two buffers, the digit counts and totals, the levels' keys) and
    # the levels' f32 partials (part_a's rows, then part_b's: 16-byte
    # aligned rows wherever the words are 16 bytes)
    sizes = (n, n, n, n, plan.radix * plan.tiles, plan.radix, plan.part_a,
             plan.part_b)
    ints = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    floats = torch.empty((plan.part_a + plan.part_b) * d,
                         dtype=torch.float32, device=dev)
    at, ptrs = 0, []
    for k in sizes:
        ptrs.append(ints.data_ptr() + 4 * at)
        at += k
    keys_a, slots_a, keys_b, slots_b, counts, totals, pkeys_a, pkeys_b = ptrs
    part_a, part_b = floats.data_ptr(), floats.data_ptr() + 4 * plan.part_a * d
    if planned(LAUNCHES, "embedding_take_bwd_local", grad):
        return grad
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _status("embedding_take_bwd_local", LIBRARIES.get("embedding_take")
                .embedding_take_bwd(
                    d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), n,
                    v_loc, d, int(row0), int(grad.dtype == torch.bfloat16),
                    plan.vec, plan.passes, plan.radix_bits, plan.kpt,
                    plan.tiles, keys_a, slots_a, keys_b, slots_b, counts,
                    totals, part_a, pkeys_a, plan.part_a, part_b, pkeys_b,
                    plan.part_b, stream))
    return grad


def embedding_take_bwd_local(d_out: torch.Tensor, ids: torch.Tensor,
                             row0: int, v_loc: int) -> torch.Tensor:
    """The shard's gradient (v_loc, D) in d_out's dtype (the table's):
    `embedding_take_scatter` into a tensor whose zero fill is the
    allocation's (`torch.zeros`), not the kernel's."""
    shape = (v_loc, d_out.shape[-1])
    _check_d_out(d_out, ids, shape, d_out.dtype, d_out.device)
    _check(ids, "ids", torch.int32, 1)
    grad = torch.zeros(shape, dtype=d_out.dtype, device=d_out.device)
    return embedding_take_scatter(d_out, ids, grad, row0)
