"""Sparse-embedding lookups, port of repro/models/embedding.py.

`embedding_bag` and `multifeature_bag` are the DLRM's: the tables are
stacked (F, V, D), one per sparse feature with a shared vocab size, and
every lookup goes through `repro_torch.kernels.ops.embedding_bag` (the
CUDA kernel on the card, its plain version on the CPU).
`ragged_embedding_bag` (flat ids and segment ids) is the reference's
`jnp.take` + segment-op formulation, through models/segment.py's chunked
gather-and-segment-reduce, which the full-graph GraphSAGE shares;
`hash_ids` is the reference's multiplicative hash, bit for bit.

The row-sharded lookups on a mesh (`launch.mesh.Mesh`) are the
reference's two shard_map functions, each rank running the body of the
shard_map on its own shard with the same collectives:
`tp_embedding_lookup` (a masked take from this rank's vocab shard by the
take kernels, in the table's dtype, and a sum over the model axis; its
gradient lands in the local shard only)
and `tp_multifeature_bag` (stacked tables row-sharded over every axis:
the ids all-gathered over the data axes, the whole batch looked up in
the local rows by the `embedding_bag` kernel's local-rows mode, a
reduce-scatter over the data axes and a sum over the model axis; its
backward all-gathers d_out in the table dtype and scatters locally, so
the gradient stays sharded). Each takes `rows`, the tables' global row
count, with this rank's shard, and falls back to the unsharded lookup
of whole tables exactly where the reference does: no mesh or no model
axis, one shard, rows that do not divide over the shards, or no `rows`;
at one shard, a mesh made with `exchange_one_shard` (the driver's) takes
the exchange instead, so that a world of one rank runs every collective
and the local-rows kernels (for ids in [0, rows) the values are the
fallback's, in the tables' dtype).
Each rank passes its own data rank's slice of the batch; a global batch
that does not divide over the data ranks (the reference's other
fallback) is refused by the driver, which makes the slices.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import segment
from repro_torch.train import collectives as coll

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


class _LocalTake(torch.autograd.Function):
    """The masked take of a vocab shard through the take kernels: table
    (v_loc, D) rows [row0, row0 + v_loc); ids (N,) int32 -> (N, D) in the
    table's dtype (an id outside reads 0); the gradient, from d_out in
    that dtype, lands in the shard."""

    @staticmethod
    def forward(ctx, table, ids, row0):
        ctx.save_for_backward(ids)
        ctx.cfg = (row0, table.shape[0])
        return ops.local_take(table, ids, row0)

    @staticmethod
    def backward(ctx, d_out):
        (ids,) = ctx.saved_tensors
        row0, v_loc = ctx.cfg
        return ops.local_take_bwd(d_out, ids, row0, v_loc), None, None


def local_rows_take(table: torch.Tensor, ids: torch.Tensor,
                    row0: int) -> torch.Tensor:
    """The masked gather of a vocab shard: table (v_loc, D), rows [row0,
    row0 + v_loc); ids (...) int32 -> (..., D) in the table's dtype, 0 for
    an id outside the shard; the gradient lands in the shard (the take
    kernels on the card, `embedding_take_fwd_local` and
    `embedding_take_bwd_local`)."""
    # a column of a token matrix (a decode step's) is strided
    out = _LocalTake.apply(table, ids.reshape(-1).to(torch.int32)
                           .contiguous(), row0)
    return out.reshape(*ids.shape, table.shape[-1])


def tp_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh, *,
                        rows: Optional[int] = None) -> torch.Tensor:
    """Vocab-sharded single-hot lookup: table (rows / tp, D), this rank's
    shard of the (rows, D) table split over the model axis; ids (...)
    int32, this rank's -> (..., D) in the table's dtype. Each model rank
    takes the ids it owns through `local_rows_take` (an id outside its
    shard reads 0), in the table's dtype as the reference's masked take
    is, and the sum over the model axis completes the rows; every model
    rank then uses them alike, so the gradient passes through the sum and
    scatters, in the table's dtype, into the local shard only. Falls back
    to `F.embedding` of a whole table (see the module docstring)."""
    names = mesh.axis_names if mesh is not None else ()
    if "model" not in names or rows is None:
        return F.embedding(ids.long(), table)
    tp = mesh.shape["model"]
    if (tp == 1 and not mesh.exchange_one_shard) or rows % tp != 0:
        return F.embedding(ids.long(), table)
    v_loc = rows // tp
    _check_shard(table.shape[0], v_loc)
    e = local_rows_take(table, ids, mesh.index("model") * v_loc)
    return coll.psum_same(e, mesh.group("model"))


def _check_shard(got: int, v_loc: int):
    if got != v_loc:
        raise ValueError(f"a row shard of {v_loc} rows was expected, the "
                         f"table passed has {got}")


class _TpMultifeatureBag(torch.autograd.Function):
    """The reference's custom-VJP shard_map pair (`fwd_local` and
    `bwd_local`), one rank's part."""

    @staticmethod
    def forward(ctx, tables, ids, data_group, model_group, row0, dp,
                combiner):
        ids_full = coll.all_gather(ids.contiguous(), data_group) \
            if dp > 1 else ids                             # (B, F, hot)
        out = ops.embedding_bag_local(tables, ids_full, row0) \
            .to(tables.dtype)                              # (B, F, D) part
        if dp > 1:
            out = coll.reduce_scatter(out, data_group)     # (B_loc, F, D)
        out = coll.all_reduce(out, model_group)
        hot = ids.shape[-1]
        if combiner == "mean":
            out = coll.ieee_div(out, hot)
        ctx.save_for_backward(ids_full)
        ctx.cfg = (data_group, row0, dp, combiner, hot, tables.shape[1],
                   tables.dtype)
        return out

    @staticmethod
    def backward(ctx, d_out):
        (ids_full,) = ctx.saved_tensors
        data_group, row0, dp, combiner, hot, v_loc, dtype = ctx.cfg
        # the table dtype before the wire, as the reference casts
        g = d_out.to(dtype)
        if combiner == "mean":
            g = coll.ieee_div(g, hot)
        if dp > 1:
            g = coll.all_gather(g.contiguous(), data_group)
        grad = ops.embedding_bag_local_bwd(g.float(), ids_full, row0, v_loc,
                                           dtype)
        return grad, None, None, None, None, None, None


def tp_multifeature_bag(tables: torch.Tensor, ids: torch.Tensor, mesh, *,
                        combiner: str = "sum", rows: Optional[int] = None
                        ) -> torch.Tensor:
    """Fully row-sharded stacked-table lookup: tables (F, rows / n, D),
    this rank's row shard of the (F, rows, D) tables split over every
    mesh axis (n ranks, rows [k rows / n, (k + 1) rows / n) on the rank
    at flat position k of (pod, data, model), major to minor); ids
    (B_loc, F, hot), this data rank's slice of the batch -> (B_loc, F, D)
    in the tables' dtype (see the module docstring for the exchange)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(combiner)
    names = mesh.axis_names if mesh is not None else ()
    if "model" not in names or rows is None:
        return multifeature_bag(tables, ids, combiner=combiner)
    n_shards = mesh.size(names)
    if (n_shards == 1 and not mesh.exchange_one_shard) \
            or rows % n_shards != 0:
        return multifeature_bag(tables, ids, combiner=combiner)
    v_loc = rows // n_shards
    _check_shard(tables.shape[1], v_loc)
    return _TpMultifeatureBag.apply(
        tables, ids, mesh.data_group, mesh.group("model"),
        mesh.index(names) * v_loc, mesh.size(mesh.data_axes), combiner)


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
