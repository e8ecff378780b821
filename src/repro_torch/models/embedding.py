"""Sparse-embedding lookups of the DLRM, over the hand-written kernel.

Port of the single-device parts of repro/models/embedding.py that the
closed training loop runs. The tables are stacked (F, V, D), one per
sparse feature with a shared vocab size, and every lookup goes through
`repro_torch.kernels.ops.embedding_bag` (the CUDA kernel on the card,
its plain version on the CPU).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import ops


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
