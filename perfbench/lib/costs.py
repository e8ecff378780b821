"""Each kernel's least work, frozen: the bag and interaction terms of
the port's `kernels/costs.py` as the benchmark first read them, so that a
later change to the program's own counts cannot move a roofline share.

A cost is what one launch must do at the least: the bytes it moves (each
input read once, each output written once) and the operations it does,
of which `dot_flops` are the products of dots and their sums (2 a
multiply-add). `uniq` is the distinct rows a launch touches over all its
features; without it, the most the shapes allow.
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
