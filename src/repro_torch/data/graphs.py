"""Synthetic batches of the full-graph and batched-small-graph GNN shapes,
as numpy arrays in the layout repro/launch/programs.py's
`gnn_input_specs` gives them (`:186-216`), and the dst-partitioned
layout of a full graph (`partition_edges`, the layout of
`gnn_partitioned_input_specs`, `:218-240`).

The JAX package has no such generator: it builds these shapes only as
abstract programs and, at toy sizes, in its tests. The port's driver
needs real data to run them, so it makes it here from a seed, as it
makes the minibatch shape's graph (`CSRGraph.random`); the port's tests
hand both packages the same numpy batch from these functions.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GNNShape
from repro_torch.data.sampler import CSRGraph


def padded_edges(n_edges: int, multiple: int = 512) -> int:
    """Edge counts pad up so the edge axis shards evenly over any mesh
    (pad edges carry dst == n_nodes, dropped by segment_sum); copied
    from repro/launch/programs.py:180-183."""
    return -(-n_edges // multiple) * multiple


def full_graph_batch(shape: GNNShape, n_classes: int,
                     rng: np.random.RandomState) -> dict:
    """The graph of a full-graph shape: `CSRGraph.random(n_nodes,
    n_edges, seed=0)`'s edges sorted by dst, padded to `padded_edges`
    with pad edges n_nodes -> n_nodes; standard-normal features and
    uniform labels in [0, n_classes) from `rng`.

    Returns x (N, d_feat) f32, edge_src and edge_dst (E_pad,) int32,
    labels (N,) int32."""
    n, e = shape.n_nodes, shape.n_edges
    g = CSRGraph.random(n, e, seed=0)
    src = np.full(padded_edges(e), n, np.int32)
    dst = np.full(padded_edges(e), n, np.int32)
    src[:e] = g.nbr
    dst[:e] = np.repeat(np.arange(n, dtype=np.int32), np.diff(g.offsets))
    x = rng.randn(n, shape.d_feat).astype(np.float32)
    labels = rng.randint(0, n_classes, n).astype(np.int32)
    return {"x": x, "edge_src": src, "edge_dst": dst, "labels": labels}


def partition_sizes(n_nodes: int, n_edges: int, n_shards: int,
                    slack: float = 1.25):
    """(n_pad, e_loc) of the dst-partitioned layout: nodes padded to a
    multiple of 512 (which divides both production meshes), e_loc the
    edges a shard with `slack` headroom for skew, rounded up to 8
    (repro/launch/programs.py:218-240)."""
    n_pad = -(-n_nodes // 512) * 512
    e_loc = -(-int(n_edges * slack) // n_shards)
    return n_pad, -(-e_loc // 8) * 8


def partition_edges(edge_src: np.ndarray, edge_dst: np.ndarray,
                    n_nodes: int, n_shards: int, slack: float = 1.25):
    """A full graph's edges bucketed by dst into `n_shards` node ranges of
    n_pad / n_shards nodes: (n_pad, edge_src, edge_dst), the edge arrays
    (n_shards, e_loc) int32, shard k's row holding the edges whose dst
    lies in its range in their input order, padded with src = dst = -1.
    Edges whose dst lies outside [0, n_nodes) (the unpartitioned layout's
    pad edges) are dropped; e_loc is sized by `partition_sizes` from the
    edges kept, and a shard with more than e_loc edges raises."""
    keep = (edge_dst >= 0) & (edge_dst < n_nodes)
    src, dst = edge_src[keep], edge_dst[keep]
    n_pad, e_loc = partition_sizes(n_nodes, len(dst), n_shards, slack)
    shard = dst // (n_pad // n_shards)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    if counts.max(initial=0) > e_loc:
        raise ValueError(f"a shard holds {counts.max()} edges, over its "
                         f"{e_loc} (slack {slack})")
    out_src = np.full((n_shards, e_loc), -1, np.int32)
    out_dst = np.full((n_shards, e_loc), -1, np.int32)
    slot = np.arange(len(dst)) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    out_src[shard[order], slot] = src[order]
    out_dst[shard[order], slot] = dst[order]
    return n_pad, out_src, out_dst


def partitioned_batch(batch: dict, n_shards: int,
                      slack: float = 1.25) -> dict:
    """A full-graph batch (x (N, d), edge_src / edge_dst (E,), labels
    (N,)) in the dst-partitioned layout: x padded with zero rows and
    labels with -1 to n_pad, the edges `partition_edges`'."""
    n = batch["x"].shape[0]
    n_pad, src, dst = partition_edges(batch["edge_src"], batch["edge_dst"],
                                      n, n_shards, slack)
    x = np.zeros((n_pad,) + batch["x"].shape[1:], batch["x"].dtype)
    x[:n] = batch["x"]
    labels = np.full((n_pad,), -1, np.int32)
    labels[:n] = batch["labels"]
    return {"x": x, "edge_src": src, "edge_dst": dst, "labels": labels}


def molecule_batch(shape: GNNShape, n_classes: int,
                   rng: np.random.RandomState, n_graphs: int = 0) -> dict:
    """A batch of `n_graphs` (default the shape's) small graphs of
    shape.n_nodes node slots and shape.n_edges edge slots, drawn from
    `rng`: each graph has a count of real nodes in [N // 2, N] (node_mask
    1 on them, features 0 on the rest), a count of real edges in
    [E // 2, E] with both ends among its real nodes, its other edge
    slots pad edges 0 -> 0 (the reference's convention), and a label in
    [0, n_classes).

    Returns x (G, N, d_feat) f32, edge_src and edge_dst (G, E) int32,
    node_mask (G, N) f32, labels (G,) int32."""
    g = n_graphs or shape.n_graphs
    n, e = shape.n_nodes, shape.n_edges
    n_real = rng.randint(n // 2, n + 1, size=g)
    e_real = rng.randint(e // 2, e + 1, size=g)
    node_mask = (np.arange(n)[None] < n_real[:, None]).astype(np.float32)
    real_edge = np.arange(e)[None] < e_real[:, None]
    src = np.where(real_edge, rng.randint(0, n_real[:, None], (g, e)), 0)
    dst = np.where(real_edge, rng.randint(0, n_real[:, None], (g, e)), 0)
    x = rng.randn(g, n, shape.d_feat).astype(np.float32) \
        * node_mask[..., None]
    labels = rng.randint(0, n_classes, g).astype(np.int32)
    return {"x": x, "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32), "node_mask": node_mask,
            "labels": labels}
