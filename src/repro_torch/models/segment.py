"""Gather-and-segment-reduce: out[s] = reduce over the pairs (g, s) of
table[g], the `jnp.take` + `jax.ops.segment_sum` / `segment_max` body that
repro/models/embedding.py's `ragged_embedding_bag` (`:103-120`) and
repro/models/gnn.py's full-graph aggregate (`:60-69`) share.

The pairs are walked in chunks of `CHUNK_PAIRS`, with `index_select` into
one reused (chunk, D) buffer and `index_add_` (or `index_reduce_`'s
amax) into the segment-sized output, so no (pairs, D) message tensor is
ever built: at ogbn-products size one would be 24.7 GB at D = 100 and
31.7 GB at D = 128 in f32. The backward walks the same chunks, gathering
d_out[s] and adding it into d_table at g, and runs only when the table
needs a gradient. The JAX package computes this in XLA, outside any
Pallas kernel; so does the port, in plain PyTorch.

The ids follow JAX's rules (`segment_plan`):

  - a segment id outside [0, n_segments) drops its pair, as JAX's
    segment ops drop it (`index_add_` would raise, and a device-side
    assert on the card would end the process);
  - a gather id in [-rows, 0) counts from the end, as `jnp.take` wraps
    it; one outside [-rows, rows) reads a row of NaN, as `jnp.take`'s
    default fill mode does: its segment comes out NaN (the pair still
    counts for a mean), and its gradient is dropped;
  - `segment_max` of an empty segment is -inf, and a NaN message makes
    its (segment, column) NaN whatever the order of the pairs (the
    card's atomic amax and the CPU's each keep the other operand when a
    NaN arrives second); tied maxima share their gradient equally, as
    in JAX.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import torch

# pairs a chunk: at ogbn-products size chunks of 2^20 to 2^23 pairs run
# within 0.6% of each other and 2^24 23% slower at D = 128 (an NVIDIA
# H100 80GB HBM3 at 700 W; kernel_probes.py segment); a (2^22, 128) f32
# buffer is 2.1 GB
CHUNK_PAIRS = 1 << 22


class SegmentPlan(NamedTuple):
    """The kept pairs of a gather-and-segment-reduce, built once per graph
    or bag layout and reused by every layer and step."""
    gather: torch.Tensor        # (P,) row ids in [0, rows)
    segment: torch.Tensor       # (P,) segment ids in [0, n_segments)
    n_segments: int
    count: torch.Tensor         # (n_segments,) f32: pairs a segment
    nan_segments: torch.Tensor  # (k,) int64: segments a pair of which
    #                             reads no row


def segment_plan(gather_ids: torch.Tensor, segment_ids: torch.Tensor,
                 n_segments: int, rows: int) -> SegmentPlan:
    """The pairs (gather_ids[i], segment_ids[i]) of a table of `rows`
    rows, under JAX's rules (see the module docstring). The boolean
    compaction waits for the device once."""
    keep = (segment_ids >= 0) & (segment_ids < n_segments)
    g, s = gather_ids[keep], segment_ids[keep]
    count = torch.bincount(s, minlength=n_segments).float()
    g = torch.where(g < 0, g + rows, g)
    bad = (g < 0) | (g >= rows)
    if not bool(bad.any()):
        return SegmentPlan(g, s, n_segments, count, s[:0].long())
    return SegmentPlan(g[~bad], s[~bad], n_segments, count,
                       s[bad].long())


def _gathered(table: torch.Tensor, index: torch.Tensor, other: torch.Tensor,
              chunk: int) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]]:
    """(table[index[c]], index[c], other[c]) for each chunk c of the
    pairs, the rows gathered into one buffer (valid until the next
    chunk)."""
    buf = table.new_empty((min(chunk, index.numel()),) + table.shape[1:])
    for i in range(0, index.numel(), chunk):
        idx = index[i:i + chunk]
        rows = buf[:idx.numel()]
        torch.index_select(table, 0, idx, out=rows)
        yield rows, idx, other[i:i + chunk]


def _nan_filled(out: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    if plan.nan_segments.numel():
        out.index_fill_(0, plan.nan_segments, float("nan"))
    return out


def _amax(table: torch.Tensor, plan: SegmentPlan, chunk: int):
    out = table.new_full((plan.n_segments,) + table.shape[1:], -float("inf"))
    for msg, _, s in _gathered(table, plan.gather, plan.segment, chunk):
        out.index_reduce_(0, s, msg, "amax", include_self=True)
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan, chunk):
        ctx.plan, ctx.chunk, ctx.rows = plan, chunk, table.shape[0]
        out = table.new_zeros((plan.n_segments,) + table.shape[1:])
        for msg, _, s in _gathered(table, plan.gather, plan.segment, chunk):
            out.index_add_(0, s, msg)
        return _nan_filled(out, plan)

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        plan = ctx.plan
        d_out = d_out.contiguous()
        d_table = d_out.new_zeros((ctx.rows,) + d_out.shape[1:])
        for d_msg, _, g in _gathered(d_out, plan.segment, plan.gather,
                                     ctx.chunk):
            d_table.index_add_(0, g, d_msg)
        return d_table, None, None


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan, chunk):
        out = _amax(table, plan, chunk)
        nan = torch.isnan(table)
        if bool(nan.any()):
            out.masked_fill_(_amax(nan.to(table.dtype), plan, chunk) > 0,
                             float("nan"))
        ctx.plan, ctx.chunk = plan, chunk
        out = _nan_filled(out, plan)
        ctx.save_for_backward(table, out)
        return out

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        table, out = ctx.saved_tensors
        plan, chunk = ctx.plan, ctx.chunk
        # how many pairs reach each (segment, column)'s maximum, then
        # each one's share of d_out
        ties = torch.zeros_like(out)
        for msg, _, s in _gathered(table, plan.gather, plan.segment, chunk):
            ties.index_add_(0, s, (msg == out.index_select(0, s))
                            .to(out.dtype))
        share = d_out / torch.clamp(ties, min=1.0)
        d_table = torch.zeros_like(table)
        for msg, g, s in _gathered(table, plan.gather, plan.segment, chunk):
            at_max = msg == out.index_select(0, s)
            d_table.index_add_(0, g, share.index_select(0, s)
                               .masked_fill_(~at_max, 0.0))
        return d_table, None, None


def segment_sum(table: torch.Tensor, plan: SegmentPlan, *,
                chunk: int = CHUNK_PAIRS) -> torch.Tensor:
    """(n_segments, ...) sums of table's rows over the plan's pairs, in
    table's dtype; differentiable in table."""
    return _SegmentSum.apply(table, plan, chunk)


def segment_max(table: torch.Tensor, plan: SegmentPlan, *,
                chunk: int = CHUNK_PAIRS) -> torch.Tensor:
    """(n_segments, ...) maxima of table's rows over the plan's pairs
    (-inf where a segment has none); differentiable in table."""
    return _SegmentMax.apply(table, plan, chunk)
