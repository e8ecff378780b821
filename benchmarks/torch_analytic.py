"""Analytic per-cell FLOPs / bytes model of the port's roofline
(benchmarks/torch_roofline.py): the closed forms of
benchmarks/analytic.py (`lm_cell`, `gnn_cell`, `recsys_cell`,
`dlrm_cell`, `model_cell`), copied, over the port's ArchSpec, at the
H100's ceilings.

MODEL_FLOPS = the *useful* work of the cell (6·N_active·D convention for LM
training, matmul+interaction flops for recsys/GNN, fwd-only for serving).
MEM_BYTES = napkin per-device HBM traffic per step (weights/optimizer
passes + residual-stream activations + caches). Both are deliberately
simple closed forms from the configs.

Hardware ceilings (NVIDIA H100 SXM data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 and 495 TF32 on the tensor cores, 67 TFLOP/s
f32 outside them, 3.35 TB/s of HBM3. A measured step is one device's:
no collective term. The dry run's plans (`plan_terms`) have one: a
rank's collective bytes over NET_BW.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BW = 3.35e12
# a GPU's share of the network between nodes: one 400 Gb/s ConnectX-7
# port a GPU in an NVIDIA DGX H100 (eight ports for its eight GPUs; DGX
# H100 user guide), in bytes a second. Each 16-rank axis of the production
# meshes spans two or more nodes of 8, so its collectives cross that
# network
NET_BW = 400e9 / 8


# ------------------------------------------------------------ LM family ----
def lm_matmul_params(cfg, active: bool):
    """Matmul params per token-pass. active=True: MoE experts at top_k/E."""
    L, D = cfg.n_layers, cfg.d_model
    attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * D
    if cfg.is_moe:
        routed = 3 * D * cfg.d_expert * cfg.n_experts
        if active:
            routed = 3 * D * cfg.d_expert * cfg.top_k
        shared = 3 * D * (cfg.n_shared_experts * cfg.d_expert)
        router = D * cfg.n_experts
        ffn = routed + shared + router
    else:
        ffn = 3 * D * cfg.d_ff
    head = D * cfg.vocab_size
    return L * (attn + ffn) + head


def lm_param_bytes(cfg) -> int:
    """Total stored param bytes (bf16) incl. embeddings."""
    n = lm_matmul_params(cfg, active=False) + cfg.vocab_size * cfg.d_model
    return n * 2


def lm_cell(cfg, shape, n_chips: int) -> dict:
    B, S = shape.batch, shape.seq_len
    n_active = lm_matmul_params(cfg, active=True)
    if shape.kind == "train":
        tokens = B * S
        attn_fl = 3 * 2 * B * cfg.n_heads * S * S * cfg.head_dim  # causal x2
        model_fl = 6 * n_active * tokens + attn_fl
        toks_loc = tokens / n_chips
        # weights: fwd read + bwd read (bf16) + optimizer read/write (f32-ish)
        w_traffic = 6 * lm_param_bytes(cfg) / n_chips
        act = 24 * cfg.n_layers * toks_loc * cfg.d_model * 2
        mem = w_traffic + act
    elif shape.kind == "prefill":
        tokens = B * S
        attn_fl = 2 * B * cfg.n_heads * S * S * cfg.head_dim
        model_fl = 2 * n_active * tokens + attn_fl
        mem = lm_param_bytes(cfg) / n_chips \
            + 12 * cfg.n_layers * tokens / n_chips * cfg.d_model * 2 \
            + 2 * cfg.n_layers * tokens * cfg.n_kv_heads * cfg.head_dim * 2 \
            / n_chips
    else:  # decode: one token for the whole batch over an S-entry cache
        model_fl = 2 * n_active * B \
            + 2 * 2 * B * cfg.n_heads * S * cfg.head_dim
        cache = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2
        mem = lm_param_bytes(cfg) / n_chips + cache / n_chips
    return {"model_flops": model_fl, "mem_bytes_per_dev": mem}


# ----------------------------------------------------------------- GNN -----
def gnn_cell(cfg, shape, n_chips: int, d_feat: int) -> dict:
    h, c = cfg.d_hidden, cfg.n_classes
    if shape.kind == "full_graph":
        n, e = shape.n_nodes, shape.n_edges
        mm = 2 * n * (2 * d_feat * h + 2 * h * c)       # w_self + w_neigh
        agg = e * (d_feat + h)                           # segment sums
        model_fl = 3 * (mm + agg)                        # train
        mem = (e * 8 + n * d_feat * 4) / n_chips * 3 \
            + (e / n_chips) * (d_feat + h) * 4 * 2
    elif shape.kind == "minibatch":
        b, (f1, f2) = shape.batch_nodes, shape.fanout
        mm = 2 * b * (1 + f1) * 2 * d_feat * h + 2 * b * 2 * h * c
        agg = b * f1 * f2 * d_feat + b * f1 * d_feat + b * h * f1
        model_fl = 3 * (mm + agg)
        mem = (b * f1 * f2 * d_feat * 4) / n_chips * 3
    else:  # batched small graphs
        g, n, e = shape.n_graphs, shape.n_nodes, shape.n_edges
        mm = 2 * g * n * (2 * d_feat * h + 2 * h * c)
        model_fl = 3 * (mm + g * e * (d_feat + h))
        mem = g * n * d_feat * 4 / n_chips * 3
    return {"model_flops": model_fl, "mem_bytes_per_dev": mem}


# -------------------------------------------------------------- recsys -----
def _mlp_flops(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def recsys_cell(cfg, shape, n_chips: int) -> dict:
    name = cfg.name
    b = shape.batch if shape.kind != "retrieval" else shape.n_candidates
    if name == "wide-deep":
        per = _mlp_flops((cfg.n_sparse * cfg.embed_dim + cfg.n_dense,)
                         + cfg.mlp_dims + (1,))
        lookup_bytes = cfg.n_sparse * cfg.multi_hot * cfg.embed_dim * 4
    elif name == "xdeepfm":
        per = _mlp_flops((cfg.n_sparse * cfg.embed_dim + cfg.n_dense,)
                         + cfg.mlp_dims + (1,))
        hk = cfg.n_sparse
        for hnext in cfg.cin_dims:
            per += 2 * hnext * hk * cfg.n_sparse * cfg.embed_dim
            hk = hnext
        lookup_bytes = cfg.n_sparse * cfg.embed_dim * 4
    elif name == "dien":
        gru = 2 * 3 * cfg.gru_dim * (cfg.embed_dim + cfg.gru_dim)
        per = 2 * cfg.seq_len * gru \
            + _mlp_flops((cfg.gru_dim + cfg.embed_dim + cfg.n_dense,)
                         + cfg.mlp_dims + (1,))
        lookup_bytes = cfg.seq_len * cfg.embed_dim * 4
    else:  # bert4rec
        d, s = cfg.embed_dim, cfg.seq_len
        blk = 2 * s * (4 * d * d + 8 * d * d) + 2 * 2 * s * s * d
        per = cfg.n_blocks * blk
        if shape.kind == "train":
            per += 2 * cfg.n_mask * (1 + cfg.n_negatives) * d
        lookup_bytes = s * d * 4
    mult = 3 if shape.kind == "train" else 1
    model_fl = mult * per * b
    mem = b / n_chips * lookup_bytes * mult \
        + min(1.0, b / n_chips) * 2 * sum(
            v * cfg.embed_dim for v in cfg.vocab_sizes) * 4 / n_chips
    return {"model_flops": model_fl, "mem_bytes_per_dev": mem}


def dlrm_cell(cfg, shape, n_chips: int) -> dict:
    b = shape.batch if shape.kind != "retrieval" else shape.n_candidates
    f = cfg.n_sparse + 1
    per = _mlp_flops((cfg.n_dense,) + cfg.bottom_mlp) \
        + 2 * f * f * cfg.embed_dim \
        + _mlp_flops((f * (f - 1) // 2 + cfg.bottom_mlp[-1],) + cfg.top_mlp)
    mult = 3 if shape.kind == "train" else 1
    lookup_bytes = cfg.n_sparse * cfg.multi_hot * cfg.embed_dim * 4
    model_fl = mult * per * b
    mem = b / n_chips * lookup_bytes * mult
    if shape.kind == "train":   # adagrad touches gathered rows r/w
        mem += 2 * b / n_chips * lookup_bytes
    return {"model_flops": model_fl, "mem_bytes_per_dev": mem}


# -------------------------------------------------------------- roofline ---
def model_cell(arch, shape, n_chips: int = 1) -> dict:
    """The cell of `arch` at `shape`, one of its shapes (at the batch
    that was run)."""
    if arch.family == "lm":
        return lm_cell(arch.model, shape, n_chips)
    if arch.family == "gnn":
        return gnn_cell(arch.model, shape, n_chips, d_feat=shape.d_feat)
    if arch.family == "recsys":
        return recsys_cell(arch.model, shape, n_chips)
    return dlrm_cell(arch.model, shape, n_chips)


def roofline_terms(model_flops: float, mem_bytes: float, measured_s: float,
                   dtype: str) -> dict:
    """The two terms of one device's roofline for a step that took
    `measured_s`: compute (model FLOPs over the dtype's peak) and memory
    (bytes over HBM), the dominant one, roofline_fraction = the larger
    over the measured seconds, and mfu = model FLOPs over the dtype's peak
    and the measured seconds."""
    peak = PEAK_FLOPS[dtype]
    compute_s = model_flops / peak
    memory_s = mem_bytes / HBM_BW
    return {"compute_s": compute_s, "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "model_flops": model_flops, "peak_flops": peak,
            "roofline_fraction": max(compute_s, memory_s) / measured_s,
            "mfu": model_flops / (peak * measured_s)}


def plan_terms(model_flops: float, dot_flops: float, mem_bytes: float,
               coll_bytes: float, chips: int, dtype: str) -> dict:
    """The three terms of one rank's roofline for a dry-run plan (the
    reference's `roofline_terms`, benchmarks/analytic.py:169-185):
    compute (the plan's dot FLOPs a rank over the dtype's peak), memory
    (the analytic bytes a rank over HBM), collective (the plan's operand
    bytes a rank over NET_BW), the dominant one, useful_ratio = model
    FLOPs a rank over the plan's dot FLOPs, and roofline_fraction = the
    useful compute's seconds over the largest term."""
    peak = PEAK_FLOPS[dtype]
    compute_s = dot_flops / peak
    memory_s = mem_bytes / HBM_BW
    collective_s = coll_bytes / NET_BW
    bound = max(compute_s, memory_s, collective_s, 1e-12)
    dominant = ("compute" if bound == compute_s else
                "memory" if bound == memory_s else "collective")
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "model_flops": model_flops, "dot_flops": dot_flops,
            "peak_flops": peak,
            "useful_ratio": (model_flops / chips) / max(dot_flops, 1.0),
            "roofline_fraction": model_flops / chips / peak / bound}


def plan_dtype(arch) -> str:
    """The dtype whose peak a plan's FLOPs take: the config's."""
    return getattr(arch.model, "param_dtype", "float32")
