"""GNN neighbor sampler (copied from repro.data.sampler; bit for bit the
same blocks from the same seed).

CSR-backed uniform fanout sampling producing the dense-block format
models/gnn.py consumes: x0 (B, d), neigh1 (B, F1, d), neigh2 (B, F1, F2, d).
Sampling-with-replacement per GraphSAGE; isolated nodes self-loop.
This runs as the pipeline's "UDF" stage for the GNN family — the most
irregular, adaptive-allocation-friendly stage in the assignment
(DESIGN.md §4).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class CSRGraph:
    def __init__(self, n_nodes: int, edge_src: np.ndarray,
                 edge_dst: np.ndarray):
        self.n_nodes = n_nodes
        order = np.argsort(edge_dst, kind="stable")
        self.nbr = edge_src[order].astype(np.int64)
        counts = np.bincount(edge_dst, minlength=n_nodes)
        self.offsets = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self.offsets[1:])

    @classmethod
    def random(cls, n_nodes: int, n_edges: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.RandomState(seed)
        src = rng.randint(0, n_nodes, size=n_edges)
        dst = rng.randint(0, n_nodes, size=n_edges)
        return cls(n_nodes, src, dst)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.RandomState) -> np.ndarray:
        """(N,) -> (N, fanout) uniform with replacement; self-loop if
        isolated."""
        start = self.offsets[nodes]
        deg = self.offsets[nodes + 1] - start
        pick = rng.randint(0, np.maximum(deg, 1)[:, None],
                           size=(len(nodes), fanout))
        idx = start[:, None] + pick
        out = self.nbr[np.minimum(idx, len(self.nbr) - 1)]
        return np.where(deg[:, None] > 0, out, nodes[:, None])


class NeighborSampler:
    """Two-hop dense-fanout sampler -> model-ready blocks."""

    def __init__(self, graph: CSRGraph, features: np.ndarray,
                 labels: np.ndarray, fanout: Tuple[int, int] = (15, 10),
                 seed: int = 0):
        self.g = graph
        self.x = features
        self.y = labels
        self.fanout = fanout
        self.rng = np.random.RandomState(seed)

    def sample(self, batch_nodes: int) -> dict:
        f1, f2 = self.fanout
        seeds = self.rng.randint(0, self.g.n_nodes, size=batch_nodes)
        n1 = self.g.sample_neighbors(seeds, f1, self.rng)       # (B, F1)
        n2 = self.g.sample_neighbors(n1.reshape(-1), f2, self.rng)
        n2 = n2.reshape(batch_nodes, f1, f2)                    # (B, F1, F2)
        return {
            "x0": self.x[seeds].astype(np.float32),
            "neigh1": self.x[n1].astype(np.float32),
            "neigh2": self.x[n2].astype(np.float32),
            "labels": self.y[seeds].astype(np.int32),
        }
