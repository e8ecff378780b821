"""Each kernel's work: the terms of its bound, in one place.

A cost is what one launch must do at the least: the bytes it moves
(each input read once, each output written once) and the operations it
does, of which `dot_flops` are the products of dots and their sums (2 a
multiply-add). `chip_smoke.py` divides `bytes` and `ops` by the card's
rates for the kernel table's bounds (PERF.md §6); `kernels.ops` reports
each launch's `dot_flops` and `bytes` to the active step analysis
(launch/step_analysis), on the card and on meta alike, so that a count
taken on the card matches the dry run's plan.

Where the work depends on the ids, the caller may give what its data
touches: `uniq`, the distinct rows read or written over all features;
for a rank's row shard, `inside`, the ids in the shard, and for the
bag's scatter `bags_in`, the bags with one there. From shapes alone (the
plan's) each is its most: min(slots, rows) a feature, every id and
every bag.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class Cost(NamedTuple):
    dot_flops: float
    ops: float
    bytes: float


def _uniq(slots: int, rows: int, features: int,
          uniq: Optional[int]) -> int:
    return features * min(slots, rows) if uniq is None else uniq


def bag_fwd(b: int, f: int, bag: int, v: int, d: int, elem: int,
            uniq: Optional[int] = None, inside: Optional[int] = None
            ) -> Cost:
    """A stacked bag's forward (row, fused or local-rows) of ids (b, f,
    bag) into tables (f, v, d) of `elem`-byte elements: the ids, the rows
    read, the f32 output; an add an id (in the shard)."""
    u = _uniq(b * bag, v, f, uniq)
    k = b * f * bag if inside is None else inside
    return Cost(0.0, float(k * d),
                float(b * f * bag * 4 + u * d * elem + b * f * d * 4))


def bag_bwd(b: int, f: int, bag: int, v: int, d: int, elem: int,
            uniq: Optional[int] = None, inside: Optional[int] = None,
            bags_in: Optional[int] = None) -> Cost:
    """Its scatter of the f32 d_out into a gradient of `elem`-byte
    elements: d_out's rows (of the bags with an id in the shard), the
    ids, each touched gradient row read and written (the adds land on
    the zero fill, which is the allocation's); an add an id."""
    u = _uniq(b * bag, v, f, uniq)
    k = b * f * bag if inside is None else inside
    rows = b * f if bags_in is None else bags_in
    return Cost(0.0, float(k * d),
                float(rows * d * 4 + b * f * bag * 4 + 2 * u * d * elem))


def take_fwd(n: int, v: int, d: int, elem: int,
             uniq: Optional[int] = None) -> Cost:
    """The single-hot take of n ids from a shard (v, d): the ids, the
    rows read, the output."""
    u = _uniq(n, v, 1, uniq)
    return Cost(0.0, 0.0, float(n * 4 + u * d * elem + n * d * elem))


def take_bwd(n: int, v: int, d: int, elem: int, uniq: Optional[int] = None,
             inside: Optional[int] = None) -> Cost:
    """Its scatter: d_out's rows of the ids in the shard and the ids
    read, each touched row written once (the zero fill is the
    allocation's); their adds."""
    u = _uniq(n, v, 1, uniq)
    k = n if inside is None else inside
    return Cost(0.0, float(k * d),
                float(k * d * elem + n * 4 + u * d * elem))


def dot_fwd(b: int, f: int, d: int, elem: int) -> Cost:
    """The lower-triangle dots of feats (b, f, d): feats and the
    (b, f(f-1)/2) output."""
    p = f * (f - 1) // 2
    flops = float(2 * b * p * d)
    return Cost(flops, flops, float(b * f * d * elem + b * p * elem))


def dot_bwd(b: int, f: int, d: int, elem: int) -> Cost:
    """d_feats[i] += d_out[ij] feats[j] and d_feats[j] += d_out[ij]
    feats[i]: two products a pair; d_out and feats read, d_feats
    written."""
    p = f * (f - 1) // 2
    flops = float(4 * b * p * d)
    return Cost(flops, flops, float(b * p * elem + 2 * b * f * d * elem))


def widen(d: int, h: int) -> Cost:
    """A bf16 w (d, h) widened to f32."""
    return Cost(0.0, 0.0, float(d * h * (2 + 4)))


def sage_fwd(b: int, f: int, d: int, h: int, elem: int, save_agg: bool,
             w_elem: int = 4) -> Cost:
    """The mean over f of neigh (b, f, d) of `elem`-byte elements and its
    product with w (d, h) of `w_elem`-byte ones (the kernel's: f32, a
    bf16 w's widened copy): neigh, w, the output and the saved f32
    aggregate; the mean's adds and the product."""
    flops = float(2 * b * d * h)
    return Cost(flops, flops + b * f * d,
                float(b * f * d * elem + d * h * w_elem + b * h * elem
                      + (b * d * 4 if save_agg else 0)))


def sage_bwd(b: int, f: int, d: int, h: int, d_w: bool,
             need_neigh: bool) -> Cost:
    """f32 throughout: d_w = agg^T d_out reads the aggregate and writes
    d_w; d_neigh = (d_out w^T) / f over f reads w and writes d_neigh;
    both read d_out."""
    flops, n = 0, b * h
    if d_w:
        flops += 2 * b * d * h
        n += b * d + d * h
    if need_neigh:
        flops += 2 * b * d * h
        n += d * h + b * f * d
    return Cost(float(flops), float(flops), float(4 * n))
