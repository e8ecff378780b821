"""Sparse-embedding lookups, port of the single-device parts of
repro/models/embedding.py.

`embedding_bag` and `multifeature_bag` are the DLRM's: the tables are
stacked (F, V, D), one per sparse feature with a shared vocab size, and
every lookup goes through `repro_torch.kernels.ops.embedding_bag` (the
CUDA kernel on the card, its plain version on the CPU).
`ragged_embedding_bag` (flat ids and segment ids) is the reference's
`jnp.take` + segment-op formulation, through models/segment.py's chunked
gather-and-segment-reduce, which the full-graph GraphSAGE shares;
`hash_ids` is the reference's multiplicative hash, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import segment

# 2654435761 (Knuth's multiplicative constant) in 16-bit halves, so that
# the uint32 product wraps in int64 arithmetic without overflowing it
_HASH_HI, _HASH_LO = divmod(2654435761, 1 << 16)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  combiner: str = "sum",
                  bag_fn: Optional[Callable] = None) -> torch.Tensor:
    """EmbeddingBag over the last axis of ids.

    table: (V, D); ids: (..., bag) int32 -> (..., D). combiner: "sum" |
    "mean" (the kernel's two combiners). `bag_fn(tables, ids, combiner=)`
    replaces `ops.embedding_bag` (a comparison against the plain version
    on the card uses it)."""
    lead, bag = ids.shape[:-1], ids.shape[-1]
    out = (bag_fn or ops.embedding_bag)(table[None], ids.reshape(-1, 1, bag),
                                        combiner=combiner)
    return out.reshape(*lead, table.shape[-1])


def multifeature_bag(tables: torch.Tensor, ids: torch.Tensor, *,
                     combiner: str = "sum") -> torch.Tensor:
    """Stacked-table multi-hot lookup.

    tables: (F, V, D); ids: (B, F, bag) int32 (already hashed mod V).
    Returns (B, F, D): feature f reads its own table."""
    return ops.embedding_bag(tables, ids, combiner=combiner)


def ragged_embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                         segment_ids: torch.Tensor, n_segments: int, *,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag: flat ids + segment ids (torch-EmbeddingBag
    shape), as the reference computes it.

    table: (V, D); ids: (N,) int; segment_ids: (N,) int. Returns
    (n_segments, D): "sum" and "max" in table's dtype (an empty segment
    0 and -inf), "mean" divided by an f32 count (at least 1), so a bf16
    table's mean is f32. Ids follow JAX's rules (models/segment.py): a
    segment id outside [0, n_segments) is dropped, an id outside the
    table reads NaN."""
    plan = segment.segment_plan(ids, segment_ids, n_segments,
                                table.shape[0])
    if combiner == "max":
        return segment.segment_max(table, plan)
    out = segment.segment_sum(table, plan)
    if combiner == "mean":
        return out / torch.clamp(plan.count, min=1.0)[:, None]
    if combiner != "sum":
        raise ValueError(combiner)
    return out


def hash_ids(raw_ids: torch.Tensor, rows: int) -> torch.Tensor:
    """Cheap multiplicative hash into the table row space (mod rows):
    (uint32(raw) * 2654435761 mod 2^32) mod rows, as int32, bit for bit
    the reference's uint32 arithmetic (a negative id wraps as
    `astype(uint32)` wraps it)."""
    x = raw_ids.to(torch.int64) & 0xFFFFFFFF
    h = (x * _HASH_LO + (((x * _HASH_HI) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (h % rows).to(torch.int32)
