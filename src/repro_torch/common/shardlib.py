"""Logical-axis sharding rules, port of repro/common/shardlib.py.

Every model annotates each parameter and activation dimension with a
*logical* axis name ("vocab", "table_rows", "batch", ...). A rules
table maps logical names to physical mesh axes, so one model definition
runs on the one-pod (data, model) mesh, the two-pod (pod, data, model)
mesh and the one-rank mesh without touching model code.

A spec is the port's own tuple with one entry a dimension: None
(replicated), a mesh-axis name, or a tuple of names (the dimension split
over their product, major to minor): entry for entry the JAX
`PartitionSpec` that the reference's `to_pspec` and `sanitized_pspec`
build. `placements` turns a spec into the per-mesh-dimension layout of a
torch `DeviceMesh` (`Shard(d)` / `Replicate()`).

The LM's logical axes live here too (`lm_param_logical`,
`lm_cache_logical`, and `lm_rules`): those of the reference's
transformer parameters (repro/models/transformer.py:45-117), its MoE's
(repro/models/moe.py:47-66) and its KV cache's; and every optimizer's
state's (`opt_logical`, `opt_shape`: repro/train/optim.py:312-342), so
that the port's placements (launch/programs.Placement and LMPlacement)
store every leaf as the block the reference's `sanitized_pspec` gives
it.

`compat_shard_map`, `pspec_tree`, `sharding_tree` and `constrain` are JAX
plumbing and have no counterpart: the port's explicit collectives name
their process groups themselves (`launch.mesh.Mesh`).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# Default physical mapping. "fsdp" is the weight-sharding (ZeRO-3) axis;
# "batch"/"edges"/"tokens" are activation data axes. "pod" composes with
# "data" so the two-pod mesh gets hierarchical data parallelism.
DEFAULT_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    # Megatron-style sequence parallelism of the residual stream between
    # blocks (norms and adds local; the LM gathers it before attention
    # and the FFN and reduce-scatters after)
    "act_seq": "model",
    "act_embed": "model",
    "act_vocab": "model",
    # attention activations (q/k/v/scores)
    "act_q_seq": None,
    "act_kv_seq": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_head_dim": None,
    "edges": ("pod", "data"),
    "nodes": None,
    "candidates": ("pod", "data"),
    # batch over every axis, for ops whose weight dims cannot shard
    "act_all_batch": ("pod", "data", "model"),
    # weights
    "fsdp": ("pod", "data"),
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_mlp": None,
    "table_rows": "model",
    "table_dim": None,
    "layers": None,
    "stages": None,
    # KV cache
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_kv_heads": "model",
    "cache_head_dim": None,
}

# Logical dims that are "data-like": sharding them when the dim is smaller
# than the mesh axis product would pad (batch 1 over 32 ranks): dropped.
DATA_DIMS = frozenset({"batch", "cache_batch", "candidates", "edges"})


def make_rules(overrides: Optional[Mapping[str, Axis]] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def _filter_axis(axis: Axis, mesh_axis_names: Sequence[str]) -> Axis:
    """Drop mesh axes that do not exist on this mesh ('pod' on one pod)."""
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in mesh_axis_names else None
    kept = tuple(a for a in axis if a in mesh_axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def to_pspec(logical: Sequence[Optional[str]], rules: Mapping[str, Axis],
             mesh_axis_names: Sequence[str]) -> Spec:
    """Map a tuple of logical axis names to a spec. A mesh axis is used
    at most once a spec; later dims lose it."""
    out, used = [], set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axis = _filter_axis(rules.get(name), mesh_axis_names)
        if axis is None:
            out.append(None)
        elif isinstance(axis, str):
            if axis in used:
                out.append(None)
            else:
                used.add(axis)
                out.append(axis)
        else:
            kept = tuple(a for a in axis if a not in used)
            if not kept:
                out.append(None)
            else:
                used.update(kept)
                out.append(kept if len(kept) > 1 else kept[0])
    return tuple(out)


def axes_prod(axis: Axis, mesh) -> int:
    """The product of the sizes of `axis`'s mesh axes (1 for None or an
    axis the mesh lacks). `mesh` is anything with a `shape` mapping of
    axis names to sizes."""
    if axis is None:
        return 1
    axes = (axis,) if isinstance(axis, str) else axis
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def sanitized_pspec(shape, logical, rules: Mapping[str, Axis], mesh) -> Spec:
    """The spec of a concrete shape: a dim is sharded iff it divides its
    mesh axes' product (never padded, never uneven), and each mesh axis
    is used at most once a spec; other dims replicate. `mesh` has
    `axis_names` and a `shape` mapping."""
    names = mesh.axis_names
    out, used = [], set()
    for dim, name in zip(shape, tuple(logical)):
        axis = None
        if name is not None:
            axis = _filter_axis(rules.get(name), names)
        if axis is not None:
            ax_tuple = (axis,) if isinstance(axis, str) else tuple(axis)
            if any(a in used for a in ax_tuple):
                axis = None
            elif dim % axes_prod(axis, mesh) != 0:
                axis = None
            else:
                used.update(ax_tuple)
        out.append(axis)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in the spec's order."""
    axes = []
    for entry in spec or ():
        if entry is not None:
            axes += [entry] if isinstance(entry, str) else list(entry)
    return tuple(axes)


def placements(spec: Spec, mesh) -> tuple:
    """The per-mesh-dimension layout of `spec` on `mesh` (a
    `launch.mesh.Mesh` or anything with `axis_names`): for each mesh
    axis, `Shard(d)` where tensor dim d is split over it, else
    `Replicate()`. A dim split over several axes is sharded over each,
    major to minor, as a DTensor lays it out."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.axis_names)


# ------------------------------------------------------------------- LM ----
def lm_param_logical(cfg) -> dict:
    """{dotted parameter name: logical axes} of a TransformerConfig, the
    reference's tree (transformer.init_params, moe.init_moe_params) by
    the port's names (models/transformer.param_shapes)."""
    att = {"wq": ("layers", "fsdp", "heads", "head_dim"),
           "wk": ("layers", "fsdp", "kv_heads", "head_dim"),
           "wv": ("layers", "fsdp", "kv_heads", "head_dim"),
           "wo": ("layers", "heads", "head_dim", "fsdp")}
    lg = {"embed.table": ("vocab", "embed"),
          "blocks.ln1": ("layers", "embed"),
          "blocks.ln2": ("layers", "embed")}
    lg.update({f"blocks.attn.{k}": v for k, v in att.items()})
    if cfg.qkv_bias:
        lg.update({"blocks.attn.bq": ("layers", "heads", "head_dim"),
                   "blocks.attn.bk": ("layers", "kv_heads", "head_dim"),
                   "blocks.attn.bv": ("layers", "kv_heads", "head_dim")})
    if cfg.post_norm:
        lg.update({"blocks.ln1_post": ("layers", "embed"),
                   "blocks.ln2_post": ("layers", "embed")})
    mlp = {"wi": ("layers", "fsdp", "mlp"), "wg": ("layers", "fsdp", "mlp"),
           "wo": ("layers", "mlp", "fsdp")}
    if cfg.is_moe:
        lg.update({"blocks.moe.router": ("layers", "embed", None),
                   "blocks.moe.wi": ("layers", "expert", "fsdp",
                                     "expert_mlp"),
                   "blocks.moe.wg": ("layers", "expert", "fsdp",
                                     "expert_mlp"),
                   "blocks.moe.wo": ("layers", "expert", "expert_mlp",
                                     "fsdp")})
        if cfg.n_shared_experts:
            lg.update({f"blocks.moe.shared.{k}": v for k, v in mlp.items()})
    else:
        lg.update({f"blocks.mlp.{k}": v for k, v in mlp.items()})
    lg["final_ln"] = ("embed",)
    if not cfg.tie_embeddings:
        lg["lm_head"] = ("embed", "vocab")
    return lg


def adafactor_factored(shape, min_dim_factored: int = 128) -> bool:
    """Whether adafactor keeps a parameter of global `shape` factored."""
    return len(shape) >= 2 and shape[-1] >= min_dim_factored \
        and shape[-2] >= min_dim_factored


# row-wise adagrad keeps one accumulator a row of a tensor of two or more
# axes and more than this many elements (repro/train/optim.py)
ROWWISE_MIN_ELEMS = 1 << 24


def rowwise_rows(shape) -> bool:
    """Whether row-wise adagrad keeps one accumulator a row (over the last
    axis) of a parameter of global `shape`."""
    n = 1
    for s in shape:
        n *= s
    return len(shape) >= 2 and n > ROWWISE_MIN_ELEMS


def opt_logical(optimizer: str, logical: Sequence, shape) -> dict:
    """{state key: logical axes} of one parameter's optimizer state
    (repro/train/optim.opt_logical_axes): adam's m and v take the
    parameter's axes; adafactor's row mean vr `lg[:-1]` and column mean
    vc `lg[:-2] + lg[-1:]` where it factors (a full v otherwise); sgd's
    mu and adagrad's acc the parameter's; row-wise adagrad's acc
    `lg[:-1]` where it keeps one a row (`rowwise_rows` of the global
    shape), else the parameter's."""
    lg = tuple(logical)
    if optimizer == "adam":
        return {"m": lg, "v": lg}
    if optimizer == "adafactor":
        if adafactor_factored(shape):
            return {"vr": lg[:-1], "vc": lg[:-2] + lg[-1:]}
        return {"v": lg}
    if optimizer == "rowwise_adagrad":
        return {"acc": lg[:-1] if rowwise_rows(shape) else lg}
    if optimizer in ("sgd", "adagrad"):
        return {"mu" if optimizer == "sgd" else "acc": lg}
    raise ValueError(f"no optimizer state for {optimizer!r}")


def opt_shape(optimizer: str, key: str, shape) -> tuple:
    """The global shape of optimizer-state tensor `key` of a parameter of
    `shape`: vr drops the last dim, vc the one before it, a row-wise
    accumulator the last."""
    shape = tuple(shape)
    if key == "vr":
        return shape[:-1]
    if key == "vc":
        return shape[:-2] + shape[-1:]
    if optimizer == "rowwise_adagrad" and rowwise_rows(shape):
        return shape[:-1]
    return shape


def lm_cache_logical() -> Tuple[str, ...]:
    """The KV cache's axes, (L, B, S, K, hd) (transformer.cache_logical_axes)."""
    return ("layers", "cache_batch", "cache_seq", "cache_kv_heads",
            "cache_head_dim")


def lm_rules(cfg, kind: str = "train", batch: Optional[int] = None) -> dict:
    """The reference's `_lm_rules` (repro/launch/programs.py:99-106): the
    config's sharding overrides, and for a decode batch under 8 the cache
    seq over the data axes."""
    overrides = dict(cfg.sharding_overrides)
    if kind == "decode" and batch is not None and batch < 8:
        overrides.setdefault("cache_seq", ("pod", "data"))
    return make_rules(overrides)


class ShardCtx:
    """Carries (mesh, rules, placement) through the recsys and DLRM model
    code: `placement` (launch/programs.Placement, whose `mesh` it is)
    holds each parameter's spec and the fetch of a weight's blocks, and
    the model's explicit collectives read it. A no-arg ShardCtx() runs
    model code on one device unchanged.

    It has no `cs`: the reference's activation constraints are GSPMD's
    (`with_sharding_constraint`), and the port moves activations between
    ranks explicitly instead. The LM takes its placement
    (launch/programs.LMPlacement) in place of a ShardCtx, and its layers
    gather, reduce-scatter and all-reduce where the placement says."""

    def __init__(self, mesh=None, rules: Optional[Mapping[str, Axis]] = None,
                 placement=None):
        self.mesh = placement.mesh if placement is not None else mesh
        self.rules = dict(rules) if rules else dict(DEFAULT_RULES)
        self.placement = placement
