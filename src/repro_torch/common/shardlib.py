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
    # blocks (the LM's placements; read by the next slice's LM program)
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


class ShardCtx:
    """Carries (mesh, rules) through model code.

    Its `cs` (the activation sharding constraint) is the identity in the
    port: those constraints are GSPMD's, and the LM placements that need
    them (sequence parallelism, head sharding) wait for the next slice
    (ROADMAP queue 1, item 9). The explicit collectives read `mesh`. A
    no-arg ShardCtx() runs model code on one device unchanged."""


    def __init__(self, mesh=None, rules: Optional[Mapping[str, Axis]] = None):
        self.mesh = mesh
        self.rules = dict(rules) if rules else dict(DEFAULT_RULES)

    def cs(self, x, *logical):
        return x
