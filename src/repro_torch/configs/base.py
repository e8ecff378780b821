"""Config dataclasses of the port (copied from repro.configs.base, the
skipped cells with their reasons among them, which the dry run records;
`TransformerConfig` keeps its
`sharding_overrides` and `moe_impl` as data the port does not read yet,
so that the five LM configs read as the JAX package's do; the recsys,
DLRM and GNN sharding knobs are read by the driver on a mesh).

Frozen so configs are hashable. `reduced` lists every cut a config
makes against its published source, each with its reason.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ------------------------------------------------------------------ LM -----
@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MoE (n_experts == 0 -> dense MLP)
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk_prob: bool = True
    # attention / block details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0            # 0 = full attention
    local_global_alternating: bool = False  # gemma2: even layers local
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norm: bool = False            # gemma2 post-block norms
    scale_embed: bool = False          # gemma multiplies embed by sqrt(d)
    act: str = "silu"
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # execution
    attn_chunk: int = 512
    remat: str = "full"                # "none" | "full" | "dots"
    scan_layers: bool = True
    scan_block: int = 1                # layers per scan group (2 for gemma2)
    param_dtype: str = "bfloat16"
    moe_impl: str = "shardmap_ep"      # inert on one device: local dispatch
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
    reduced: Tuple[str, ...] = ()

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_experts_padded(self, tp: int) -> int:
        """Experts padded up so the expert axis divides the TP degree."""
        if not self.is_moe:
            return 0
        return -(-self.n_experts // tp) * tp

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LMShape:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    batch: int


LM_SHAPES = (
    LMShape("train_4k", "train", 4096, 256),
    LMShape("prefill_32k", "prefill", 32768, 32),
    LMShape("decode_32k", "decode", 32768, 128),
    LMShape("long_500k", "decode", 524288, 1),
)


# ----------------------------------------------------------------- DLRM ----
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
    # the row-sharded lookup (models/embedding.tp_multifeature_bag) where
    # the driver runs on a mesh
    tp_lookup: bool = False
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
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
    # per-shard edge padding headroom for dst-partition skew (a full graph
    # on a mesh, models/gnn.full_graph_partitioned_loss; the reference's
    # `partitioned` knob, which chooses that layout over GSPMD's
    # edge-sharded program, has no counterpart: the port has no other)
    partition_slack: float = 1.25

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
    """repro.configs.base.RecsysConfig with `reduced` added."""
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
    # the row-sharded lookups and the sampled-logit psum (models/recsys)
    # where the driver runs on a mesh
    tp_lookup: bool = False
    param_dtype: str = "float32"
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
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
    # cells skipped per assignment rules, with the reason
    skipped_shapes: Tuple[Tuple[str, str], ...] = ()

    def shape(self, name: str):
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r} "
                       f"(have {[s.name for s in self.shapes]})")

    def is_skipped(self, shape_name: str) -> Optional[str]:
        for name, reason in self.skipped_shapes:
            if name == shape_name:
                return reason
        return None
