"""Config dataclasses of the port (copied from repro.configs.base, with
the fields of regimes the port does not run dropped: sharding overrides,
lookup and partitioning knobs, skipped cells).

Frozen so configs are hashable. `reduced` lists every cut a config
makes against its published source, each with its reason.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_sparse: int = 26
    n_dense: int = 13
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = ()
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    multi_hot: int = 1                  # lookups per sparse feature (bag size)
    param_dtype: str = "float32"
    reduced: Tuple[str, ...] = ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------- GNN -----
@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    n_classes: int = 47
    aggregator: str = "mean"
    sample_sizes: Tuple[int, ...] = (25, 10)
    param_dtype: str = "float32"

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str                  # "full_graph" | "minibatch" | "batched_small"
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0          # batched_small: graphs per batch


GNN_SHAPES = (
    GNNShape("full_graph_sm", "full_graph", n_nodes=2708, n_edges=10556,
             d_feat=1433),
    GNNShape("minibatch_lg", "minibatch", n_nodes=232965, n_edges=114615892,
             d_feat=602, batch_nodes=1024, fanout=(15, 10)),
    GNNShape("ogb_products", "full_graph", n_nodes=2449029, n_edges=61859140,
             d_feat=100),
    GNNShape("molecule", "batched_small", n_nodes=30, n_edges=64, d_feat=32,
             n_graphs=128),
)


# -------------------------------------------------------------- recsys -----
@dataclass(frozen=True)
class RecsysConfig:
    """repro.configs.base.RecsysConfig without `tp_lookup` and
    `sharding_overrides` (the port runs on one device, unsharded, as its
    DLRMConfig does), with `reduced` added."""
    name: str
    interaction: str                    # "concat" | "cin" | "augru" | "bidir-seq" | "dot"
    n_sparse: int = 0
    embed_dim: int = 32
    mlp_dims: Tuple[int, ...] = ()
    n_dense: int = 13
    # per-table vocab sizes (hashed); len == n_sparse
    vocab_sizes: Tuple[int, ...] = ()
    multi_hot: int = 1                  # lookups per sparse feature (bag size)
    # xDeepFM
    cin_dims: Tuple[int, ...] = ()
    # DIEN / BERT4Rec sequence settings
    seq_len: int = 0
    gru_dim: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    n_items: int = 0                    # item vocab for sequence models
    n_mask: int = 0                     # BERT4Rec: masked positions per seq
    n_negatives: int = 0                # BERT4Rec: sampled-softmax negatives
    param_dtype: str = "float32"
    reduced: Tuple[str, ...] = ()

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str            # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", "train", 65536),
    RecsysShape("serve_p99", "serve", 512),
    RecsysShape("serve_bulk", "serve", 262144),
    RecsysShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)


# ------------------------------------------------------------- registry ----
@dataclass(frozen=True)
class ArchSpec:
    """One architecture: model config + its shape set + metadata."""
    arch_id: str
    family: str                     # "lm" | "gnn" | "recsys" | "dlrm"
    model: object                   # one of the configs above
    shapes: Tuple[object, ...]
    source: str = ""
    optimizer: str = "adam"

    def shape(self, name: str):
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r} "
                       f"(have {[s.name for s in self.shapes]})")
