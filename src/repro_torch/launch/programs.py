"""The driver's placements on a mesh: port of the per-arch parts of
repro/launch/programs.py that the explicit collectives need
(`build_lm_program` :99-178, `build_gnn_program` :242-275,
`build_recsys_program` :324-385, `build_dlrm_program` :407-455). XLA's
lowering and GSPMD's implicit placements have no counterpart: every
parameter and optimizer-state tensor is this rank's block of
`sanitized_pspec(global shape, the reference's logical axes, its
rules)`, so that per-rank shapes and bytes are the reference's leaf for
leaf, and the model code moves activations and gradients itself, over
`torch.distributed`.

`Placement` is the recsys, DLRM and GNN programs': each leaf's logical
axes are the reference's init functions', which each model declares by
the port's parameter names (its `param_logical()`; an `nn.Linear`
weight is the reference's `w` transposed), under
`make_rules(cfg.sharding_overrides)`: the dense
layers' `fsdp` over the data axes and `mlp` over the model axis, the
tables' rows over `table_rows` (the model axis by default: xDeepFM's
tables and linear arm, DIEN's and BERT4Rec's items; every axis where the
config's overrides say so: the DLRM's and wide-deep's tables and wide
arm), the CIN filters' `mlp`, BERT4Rec's heads over the model axis, and
everything whose dim does not divide replicated. `LMPlacement` is the
LM family's (its rules `lm_rules`, its KV cache's spec too).

How activations move (the models' code): a weight's blocks over the data
axes are all-gathered where it is used (FSDP: `fetch`, whose backward
reduce-scatters the gradient into the block); a layer split over the
model axis computes this rank's output columns or heads (the dense
stacks gather the columns over the model axis before the next layer,
BERT4Rec's attention and FFN sum their partial outputs over it); a
row-sharded table is read by the row-sharded lookups
(models/embedding.py); xDeepFM's CIN takes this model rank's rows of its
data rank's batch (the reference's `act_all_batch`); the full graph's
edges are split over the data axes (models/gnn.py).

Gradients follow one convention, the LM's, for every leaf: the global
loss is the sum over the data ranks of each rank's share (a recsys or
DLRM data rank's loss, the mean over its rows, divided by the data
ranks' count; the LM's tokens' summed loss over the global count; the
partitioned graph's loss, whose parts each rank already holds), and
every model rank of a data rank computes that share alike. After the
backward each rank's gradient of a leaf is its share of the global
loss's: where every model rank uses a weight alike (a replicated weight
read whole) its fetch scales its gradient by 1 / tp; where each model
rank uses it for its own part of the work (its rows, its columns, its
node range) the gradient is that part's. `reduce_grads` then sums a
gradient over the ranks its leaf is replicated on: over the model axis
(`all_reduce`) and over the data axes (`psum_tree`, `--compress`); one
sharded over the data axes has had its sum from its gather's
reduce-scatter, or from the row-sharded lookup's all-gather.

On a mesh made with `exchange_one_shard` (the driver's), `Placement`
takes its collectives at an axis of one rank too, where the reference's
would move nothing: a world of one then runs the placed fetch, the
row-sharded lookups and the edge-sharded sum (the card's one-rank
phases). `rank_bytes` is the per-rank byte plan of an LM's parameters,
optimizer state and cache from shapes alone, the counterpart of the
reference dry run's `memory_analysis`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.common import shardlib
from repro_torch.data.graphs import padded_edges, partition_sizes
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.launch.step_analysis import storage_bytes
from repro_torch.models.transformer import param_shapes
from repro_torch.train import collectives as coll
from repro_torch.train.elastic import local_slice


def axes_group(mesh, axes):
    """The process group over `axes` of `mesh`: one axis, the data axes
    or every axis."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if set(axes) == set(mesh.axis_names):
        return mesh.all_group
    if set(axes) == set(mesh.data_axes):
        return mesh.data_group
    if len(axes) == 1:
        return mesh.group(axes[0])
    raise ValueError(f"no process group over {axes} of {mesh.axis_names}")


def gather_full(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor of this rank's block x under `spec`: an
    all-gather along each sharded dim, in group-rank order."""
    for d, entry in reversed(list(enumerate(spec or ()))):
        if entry is None:
            continue
        g = coll.all_gather(x.movedim(d, 0).contiguous(),
                            axes_group(mesh, entry))
        x = g.movedim(0, d)
    return x.contiguous()


def _entry_axes(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


class _Placed:
    """What the two placements share: the mesh's groups, each leaf's
    block, the weight fetch, the gradient reduction of the module
    docstring's convention, the norm groups and the gathers and specs
    of a checkpoint. A subclass sets `mesh`, `shapes`, `logical`,
    `specs` (each parameter's spec), `rules`, `optimizer` and `exchange`
    (collectives at an axis of one rank too), then calls `_groups`."""

    partitioned = False

    def _groups(self) -> None:
        mesh, names = self.mesh, self.mesh.axis_names
        self.tp = mesh.shape["model"] if "model" in names else 1
        self.dp = mesh.size(mesh.data_axes)
        self.m = mesh.index("model") if "model" in names else 0
        self.d = mesh.index(mesh.data_axes)
        self.tpg = mesh.group("model") if "model" in names and (
            self.tp > 1 or self.exchange) else None
        self.dpg = mesh.data_group if mesh.data_axes and (
            self.dp > 1 or self.exchange) else None

    # ---------------------------------------------------------- layout --
    def split(self, entry) -> int:
        """The number of blocks a spec entry cuts its dim into."""
        return self.mesh.size(_entry_axes(entry)) if entry else 1

    def group_of(self, entry):
        """The process group of a spec entry's axes (None: one rank, where
        the placement takes no collective there)."""
        if not entry or (self.split(entry) == 1 and not self.exchange):
            return None
        return axes_group(self.mesh, _entry_axes(entry))

    def on_model(self, spec, d: int) -> bool:
        """Whether dim d of `spec` is split over the model axis (its
        collectives taken: more than one rank, or `exchange`)."""
        return self.tpg is not None and spec[d] == "model"

    def state_spec(self, name: str, key: str) -> tuple:
        """The spec of optimizer-state tensor `key` of parameter `name`."""
        shape = self.shapes[name]
        lg = shardlib.opt_logical(self.optimizer, self.logical[name],
                                  shape)[key]
        return shardlib.sanitized_pspec(
            shardlib.opt_shape(self.optimizer, key, shape), lg, self.rules,
            self.mesh)

    def blocks(self) -> dict:
        """{name: ((start, size) of each dim)} of this rank's block of
        every parameter, for `transformer.init_params(blocks=)`, which
        draws each block without the whole tensor."""
        out = {}
        for name, spec in self.specs.items():
            dims = []
            for n, entry in zip(self.shapes[name], spec):
                k = self.split(entry)
                size = n // k
                dims.append((self.mesh.index(entry) * size if k > 1 else 0,
                             size))
            out[name] = tuple(dims)
        return out

    def shard_model(self, model: nn.Module) -> None:
        """Replace each parameter of a whole model by this rank's block of
        it (a copy, so that the whole tensor is freed; a block that is the
        whole keeps its storage)."""
        for name, spec in self.specs.items():
            *path, leaf = name.split(".")
            mod = model
            for part in path:
                mod = getattr(mod, part)
            whole = getattr(mod, leaf)
            part = local_slice(whole.detach(), spec, self.mesh)
            if part.shape != whole.shape:
                part = part.clone()
            setattr(mod, leaf, nn.Parameter(part,
                                            requires_grad=whole.requires_grad))
            del whole

    # ----------------------------------------------------- the weights --
    def fetch(self, w: torch.Tensor, spec, use: str = "keep"
              ) -> torch.Tensor:
        """A weight block (a layer's slice of a stacked parameter with
        `spec` its dims' entries) made whole over the data axes (FSDP:
        the backward reduce-scatters its gradient); over the model axis
        `use` "keep" leaves a model-split dim split, "parts" gathers it
        for this rank's own part of the work (backward: reduce-scatter),
        "same" gathers it for work every model rank does alike (backward:
        its own slice), and a weight replicated over the model ranks used
        alike takes a 1 / tp share of its gradient. A weight gathered
        along a dim other than its first comes back contiguous: the GEMM
        that reads it then takes the layout, and the rounding, it takes on
        one device (a world of one matches the unplaced step bit for
        bit)."""
        on_model, moved = False, False
        for d, entry in enumerate(spec):
            group = self.group_of(entry)
            if group is None:
                continue
            axes = _entry_axes(entry)
            if axes == ("model",):
                on_model = True
                if use == "keep":
                    continue
                gather = coll.all_gather_sum if use == "parts" \
                    else coll.all_gather_same
            elif set(axes) <= set(self.mesh.data_axes):
                gather = coll.all_gather_sum
            else:
                raise ValueError(f"no weight is fetched over {axes}")
            w = gather(w, group, d)
            moved |= d > 0
        if use == "same" and not on_model and self.tp > 1:
            w = coll.grad_scaled(w, 1.0 / self.tp)
        return w.contiguous() if moved else w

    def param(self, model: nn.Module, name: str, use: str = "same"
              ) -> torch.Tensor:
        """`fetch` of the model's parameter `name` (a dotted path) under
        its own spec."""
        w = model
        for part in name.split("."):
            w = getattr(w, part)
        return self.fetch(w, self.specs[name], use)

    # ------------------------------------------------------- gradients --
    def norm_groups(self) -> dict:
        """{name: group} of the parameters split over more than one rank:
        the group over which the squares of a gradient's block add up to
        its whole."""
        out = {}
        for name, spec in self.specs.items():
            axes = tuple(a for e in spec for a in _entry_axes(e)
                         if self.mesh.shape[a] > 1)
            if axes:
                out[name] = axes_group(self.mesh, axes)
        return out

    def reduce_grads(self, grads: dict, compress: str = "none") -> dict:
        """Each rank's gradient blocks -> the global loss's (the module
        docstring's convention): a gradient replicated over the model
        ranks summed over them, one replicated over the data axes summed
        over them by `psum_tree`."""
        out, dense = {}, {}
        for name, g in grads.items():
            axes = shardlib.spec_axes(self.specs[name])
            if self.tpg is not None and "model" not in axes:
                g = coll.all_reduce(g, self.tpg)
            if self.dpg is not None and not set(self.mesh.data_axes) & \
                    set(axes):
                dense[name] = g
            else:
                out[name] = g
        if dense:
            out.update(coll.psum_tree(dense, self.dpg, compress=compress,
                                      mean=False))
        return {k: out[k] for k in grads}

    # ----------------------------------------------------- checkpoints --
    def gather(self, named: dict) -> dict:
        """{name: this rank's block} of parameters -> {name: whole}."""
        return {k: gather_full(v, self.specs[k], self.mesh)
                for k, v in named.items()}

    def gather_state(self, name: str, x, key: Optional[str] = None):
        """Optimizer state of parameter `name` made whole: a tensor of
        state `key`, or adafactor's dict of vr / vc or v."""
        if isinstance(x, dict):
            return {k: gather_full(v, self.state_spec(name, k), self.mesh)
                    for k, v in x.items()}
        return gather_full(x, self.state_spec(name, key), self.mesh)

    def restore_specs(self, key: str, name: str, x):
        """The spec (or adafactor's dict of specs) of optimizer state
        `key` of parameter `name`."""
        if isinstance(x, dict):
            return {k: self.state_spec(name, k) for k in x}
        return self.state_spec(name, key)


class Placement(_Placed):
    """The recsys, DLRM and GNN programs' placement on `mesh` (see the
    module docstring): every leaf of `named_shapes` ({name: global
    shape}) and its `optimizer` state at the spec of its logical axes in
    `logical` ({name: axes}, the model's `param_logical()`; a leaf it
    does not name, or names at another rank, is refused) under `cfg`'s
    rules; `partitioned` a full graph's dst-partitioned loss. The model
    code reads `specs`, `shapes`, the groups (`tpg`, `dpg`: None where
    the placement takes no collective) and `fetch`."""

    def __init__(self, mesh, cfg, named_shapes: dict, logical: dict, *,
                 optimizer: str = "adam", partitioned: bool = False):
        self.mesh, self.optimizer = mesh, optimizer
        self.partitioned = partitioned
        self.exchange = bool(getattr(mesh, "exchange_one_shard", False))
        self.rules = shardlib.make_rules(dict(cfg.sharding_overrides))
        self.shapes = {k: tuple(s) for k, s in named_shapes.items()}
        self.logical = {}
        for k, s in self.shapes.items():
            if k not in logical or len(logical[k]) != len(s):
                raise ValueError(f"no logical axes of rank {len(s)} for "
                                 f"{k}: {logical.get(k)}")
            self.logical[k] = tuple(logical[k])
        self.specs = {k: shardlib.sanitized_pspec(s, self.logical[k],
                                                  self.rules, mesh)
                      for k, s in self.shapes.items()}
        self._groups()

    def global_numel(self) -> dict:
        return {name: int(torch.Size(shape).numel())
                for name, shape in self.shapes.items()}

    def rows_axes(self, name: str):
        """The mesh axes table `name`'s rows (its `table_rows` dim) are
        split over, None where they are not (the table then whole on
        every rank)."""
        entry = self.specs[name][self.logical[name].index("table_rows")]
        return entry if self.group_of(entry) is not None else None


# ------------------------------------------------------------------- LM ----
class LMPlacement(_Placed):
    """The LM family's placement on `mesh` (see the module docstring):
    `kind` and `batch` are the shape's (a decode batch under 8 puts the
    cache's positions on the data axes), `optimizer` the arch's. The
    model code reads `specs`, the model and data groups (`tpg`, `dpg`:
    None where the axis has one rank, so that a world of one rank runs
    the plain layers) and `fetch`."""

    def __init__(self, mesh, cfg, *, optimizer: str = "adam",
                 kind: str = "train", batch: Optional[int] = None,
                 cache_len: Optional[int] = None):
        self.mesh, self.cfg, self.optimizer = mesh, cfg, optimizer
        self.kind, self.batch, self.cache_len = kind, batch, cache_len
        self.exchange = False
        self.rules = shardlib.lm_rules(cfg, kind, batch)
        self.shapes = {k: tuple(v[0]) for k, v in param_shapes(cfg).items()}
        self.logical = shardlib.lm_param_logical(cfg)
        self.specs = {k: shardlib.sanitized_pspec(s, self.logical[k],
                                                  self.rules, mesh)
                      for k, s in self.shapes.items()}
        self._groups()

    def seq_split(self, seq: int) -> bool:
        """Whether the residual stream of `seq` positions is split over
        the model ranks (`act_seq`, where it divides)."""
        return self.tp > 1 and shardlib.sanitized_pspec(
            (seq,), ("act_seq",), self.rules, self.mesh)[0] == "model"

    def q_seq_split(self, seq: int) -> bool:
        """Whether the config sends the queries' positions over the
        model ranks (`act_q_seq`, where it divides)."""
        return self.tp > 1 and shardlib.sanitized_pspec(
            (seq,), ("act_q_seq",), self.rules, self.mesh)[0] == "model"

    def batch_rows(self, batch: int):
        """(first row, rows) of this rank's slice of a batch of `batch`:
        over the data axes where it divides, else all of it."""
        spec = shardlib.sanitized_pspec((batch,), ("batch",), self.rules,
                                        self.mesh)
        n = self.split(spec[0])
        return (self.d * (batch // n), batch // n) if n > 1 else (0, batch)

    def rows_split(self) -> bool:
        """Whether the batch's rows split over the data ranks: a train
        batch always does (the driver refuses one that does not divide),
        a serving batch where it divides."""
        if self.dp == 1:
            return False
        if self.kind == "train" or self.batch is None:
            return True
        return self.batch_rows(self.batch)[1] < self.batch

    def cache_spec(self, batch: int, seq: int) -> tuple:
        cfg = self.cfg
        return shardlib.sanitized_pspec(
            (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim),
            shardlib.lm_cache_logical(), self.rules, self.mesh)

    def dim_groups(self, name: str) -> tuple:
        """Each dim's group of parameter `name` (None: not split)."""
        return tuple(self.group_of(e) for e in self.specs[name])

    def adafactor_shards(self) -> dict:
        """adafactor's `shards`: {name: (global shape, each dim's group,
        the group of all its split axes, the group over which vc's last
        dim is split where the parameter's is not)} of the parameters
        split over more than one rank."""
        out, groups = {}, self.norm_groups()
        for name, spec in self.specs.items():
            if name not in groups:
                continue
            vcg = None
            if shardlib.adafactor_factored(self.shapes[name]):
                vc_last = self.state_spec(name, "vc")[-1]
                if self.split(spec[-1]) == 1 and self.split(vc_last) > 1:
                    vcg = self.group_of(vc_last)
            out[name] = (self.shapes[name], self.dim_groups(name),
                         groups[name], vcg)
        return out


class _ShapeMesh:
    """A mesh of sizes alone (`axis_names`, `shape`), for plans."""

    def __init__(self, mesh_shape):
        names = ("data", "model") if len(mesh_shape) == 2 \
            else ("pod", "data", "model")
        self.axis_names = names
        self.shape = dict(zip(names, mesh_shape))


def plan_bytes(cfg, optimizer: str, shape, mesh_shape) -> dict:
    """One rank's bytes of an LM config's parameters, its optimizer's f32
    state (train shapes) and its bf16 KV cache (decode shapes) on the
    mesh of `mesh_shape` ((data, model) or (pod, data, model)), from
    shapes alone: each leaf's block under the reference's rules."""
    mesh = _ShapeMesh(tuple(mesh_shape))
    rules = shardlib.lm_rules(cfg, shape.kind, shape.batch)
    logical = shardlib.lm_param_logical(cfg)

    def block_bytes(gshape, lg, itemsize):
        spec = shardlib.sanitized_pspec(gshape, lg, rules, mesh)
        n = 1
        for dim, entry in zip(gshape, spec):
            n *= dim // shardlib.axes_prod(entry, mesh)
        return n * itemsize

    out = {"params": 0, "opt_state": 0, "cache": 0}
    for name, (gshape, _, dtype) in param_shapes(cfg).items():
        item = torch.empty((), dtype=dtype).element_size()
        out["params"] += block_bytes(gshape, logical[name], item)
        if shape.kind == "train":
            for key, lg in shardlib.opt_logical(
                    optimizer, logical[name], gshape).items():
                out["opt_state"] += block_bytes(
                    shardlib.opt_shape(optimizer, key, gshape), lg, 4)
    if shape.kind == "decode":
        cshape = (cfg.n_layers, shape.batch, shape.seq_len, cfg.n_kv_heads,
                  cfg.head_dim)
        out["cache"] = 2 * block_bytes(cshape, shardlib.lm_cache_logical(), 2)
    out["total"] = out["params"] + out["opt_state"] + out["cache"]
    return out


def rank_bytes(arch_id: str, shape, mesh_shape=PRODUCTION_SHAPES[1][0]
               ) -> dict:
    """`plan_bytes` of an arch at its published widths: {"params",
    "opt_state", "cache", "total"} a rank. `shape` is an LMShape or the
    name of one of the arch's; the default mesh is the one-pod (16, 16)
    production mesh."""
    from repro_torch.configs.registry import get_arch
    arch = get_arch(arch_id)
    shape = arch.shape(shape) if isinstance(shape, str) else shape
    return plan_bytes(arch.model, arch.optimizer, shape, mesh_shape)


# ---------------------------------------------------------- input specs ----
class ArgSpec(NamedTuple):
    """One input of a cell: its global shape, dtype and each dim's
    logical axis (the reference's ShapeDtypeStruct and its logical
    axes)."""
    shape: tuple
    dtype: torch.dtype
    axes: tuple


f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32


def _arg(shape, dtype, axes) -> ArgSpec:
    return ArgSpec(tuple(shape), dtype, tuple(axes))


def lm_input_specs(arch, shape) -> dict:
    """repro/launch/programs.py:109-129."""
    cfg = arch.model
    b, s = shape.batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _arg((b, s), i32, ("batch", "seq")),
                "labels": _arg((b, s), i32, ("batch", "seq"))}
    if shape.kind == "prefill":
        return {"tokens": _arg((b, s), i32, ("batch", "seq"))}
    kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    lg = shardlib.lm_cache_logical()
    return {"cache": {"k": _arg(kv, bf16, lg), "v": _arg(kv, bf16, lg)},
            "tokens": _arg((b,), i32, ("batch",)), "pos": _arg((), i32, ())}


def gnn_input_specs(arch, shape) -> dict:
    """repro/launch/programs.py:188-216 (`padded_edges` of
    data/graphs.py)."""
    if shape.kind == "full_graph":
        e = padded_edges(shape.n_edges)
        return {"x": _arg((shape.n_nodes, shape.d_feat), f32,
                          ("nodes", None)),
                "edge_src": _arg((e,), i32, ("edges",)),
                "edge_dst": _arg((e,), i32, ("edges",)),
                "labels": _arg((shape.n_nodes,), i32, ("nodes",))}
    if shape.kind == "minibatch":
        b, (f1, f2), d = shape.batch_nodes, shape.fanout, shape.d_feat
        return {"x0": _arg((b, d), f32, ("batch", None)),
                "neigh1": _arg((b, f1, d), f32, ("batch", None, None)),
                "neigh2": _arg((b, f1, f2, d), f32,
                               ("batch", None, None, None)),
                "labels": _arg((b,), i32, ("batch",))}
    g, n, e, d = shape.n_graphs, shape.n_nodes, shape.n_edges, shape.d_feat
    return {"x": _arg((g, n, d), f32, ("batch", None, None)),
            "edge_src": _arg((g, e), i32, ("batch", None)),
            "edge_dst": _arg((g, e), i32, ("batch", None)),
            "node_mask": _arg((g, n), f32, ("batch", None)),
            "labels": _arg((g,), i32, ("batch",))}


def _recsys_batch_spec(name: str, cfg, batch: int, with_label: bool
                       ) -> dict:
    """repro/launch/programs.py:278-309 (`name` "dlrm" for the DLRM's
    batch, the CTR models')."""
    if name in ("wide-deep", "xdeepfm", "dlrm"):
        args = {"sparse_ids": _arg((batch, cfg.n_sparse, cfg.multi_hot), i32,
                                   ("batch", None, None)),
                "dense": _arg((batch, cfg.n_dense), f32, ("batch", None))}
    elif name == "dien":
        args = {"hist_ids": _arg((batch, cfg.seq_len), i32, ("batch", "seq")),
                "hist_mask": _arg((batch, cfg.seq_len), f32,
                                  ("batch", "seq")),
                "target_id": _arg((batch,), i32, ("batch",)),
                "dense": _arg((batch, cfg.n_dense), f32, ("batch", None))}
    elif name == "bert4rec":
        args = {"item_seq": _arg((batch, cfg.seq_len), i32,
                                 ("batch", "seq"))}
        if with_label:
            m = (batch, cfg.n_mask)
            args.update(
                mask_pos=_arg(m, i32, ("batch", None)),
                mask_labels=_arg(m, i32, ("batch", None)),
                neg_ids=_arg(m + (cfg.n_negatives,), i32,
                             ("batch", None, None)))
        return args
    else:
        raise ValueError(name)
    if with_label:
        args["label"] = _arg((batch,), f32, ("batch",))
    return args


def recsys_input_specs(arch, shape) -> dict:
    """repro/launch/programs.py:311-321 and :387-404 (the DLRM's are the
    CTR models')."""
    cfg = arch.model
    name = "dlrm" if arch.family == "dlrm" else cfg.name
    if shape.kind in ("train", "serve"):
        return _recsys_batch_spec(name, cfg, shape.batch,
                                  shape.kind == "train")
    return {"user": _recsys_batch_spec(name, cfg, 1, False),
            "cand_ids": _arg((shape.n_candidates,), i32, ("candidates",))}


_INPUT_SPECS = {"lm": lm_input_specs, "gnn": gnn_input_specs,
                "recsys": recsys_input_specs, "dlrm": recsys_input_specs}


def input_specs(arch, shape_name: str) -> dict:
    """The reference's `input_specs` (repro/launch/programs.py:461-467):
    every input of the cell as an ArgSpec (global shape, dtype, logical
    axes), in the reference's tree."""
    return _INPUT_SPECS[arch.family](arch, arch.shape(shape_name))


# ------------------------------------------------- the reference's specs ----
def replicated_leaves(placement: Placement, model: nn.Module) -> list:
    """The parameters of `model` whose local shape is not their block
    under the placement's spec: [(name, spec)]. `shard_model` stores
    every leaf as that block, so the list is empty; it stays as the check
    that no leaf was left whole. (Whether the specs are the reference's
    is what tests/test_torch_dryrun.py holds against the reference's own
    logical trees and in_shardings.)"""
    local = {k: tuple(p.shape) for k, p in model.named_parameters()}
    out = []
    for name, shape in placement.shapes.items():
        spec = placement.specs[name]
        block = tuple(n // placement.split(e) for n, e in zip(shape, spec))
        if local[name] != block:
            out.append((name, spec))
    return out


# ---------------------------------------------------------------- programs --
@dataclasses.dataclass
class Program:
    """One cell's placed step as rank `mesh.index` of `mesh` runs it (the
    reference's Program): `fn(*args)` runs it once; `model`,
    `opt_state` and `inputs` are this rank's, on the program's device.
    `memory` is their bytes {"params", "opt_state", "inputs", "cache"};
    `meta` holds the placement, the batch a rank and, for a recsys, DLRM
    or GNN model, `replicated`: the leaves not stored as their block
    (`replicated_leaves`; none)."""
    name: str
    kind: str
    fn: Callable
    model: nn.Module
    opt_state: Optional[dict]
    inputs: dict
    memory: dict
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def args(self) -> tuple:
        if self.opt_state is None:
            return (self.model, self.inputs)
        return (self.model, self.opt_state, self.inputs)


def _empty_inputs(specs, rows: dict, device) -> dict:
    """Tensors of the specs' shapes on `device` (meta: no values), each
    dim whose axis is in `rows` cut to that many."""
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        shape = tuple(rows.get(a, n) for n, a in zip(node.shape, node.axes))
        return torch.empty(shape, dtype=node.dtype, device=device)
    return make(specs)


def _meta_plan(n_pairs: int, n_segments: int, device):
    """A SegmentPlan of `n_pairs` kept pairs and no NaN segment, from
    shapes alone (the plan of a graph whose every edge is kept: the most
    pairs a plan has)."""
    from repro_torch.models.segment import SegmentPlan
    ids = torch.empty((n_pairs,), dtype=torch.int64, device=device)
    return SegmentPlan(ids, torch.empty_like(ids), n_segments,
                       torch.empty((n_segments,), dtype=f32, device=device),
                       torch.empty((0,), dtype=torch.int64, device=device))


def _data_rows(batch: int, mesh, always: bool) -> int:
    """A data rank's rows of a batch: its share over the data axes (a
    train batch always splits; a serving batch where it divides)."""
    dp = mesh.size(mesh.data_axes)
    if always or batch % dp == 0:
        if batch % dp:
            raise ValueError(f"a batch of {batch} does not split over {dp} "
                             f"data ranks")
        return batch // dp
    return batch


def build_program(arch, shape, mesh, device="meta", *, cfg=None,
                  batch: Optional[int] = None, microbatches: int = 1
                  ) -> Program:
    """The placed step of (arch, shape) on `mesh`, this rank's part (the
    reference's `build_program`, repro/launch/programs.py:454-459): the
    driver's placements and train step (launch/train.build_step) for
    `train`; the LM's prefill and decode under `LMPlacement`; the recsys
    and DLRM placed forward on this rank's rows for `serve`;
    `score_candidates(placement=)` for `retrieval`. `cfg`
    replaces the arch's config (a reduced one in the tests), `batch` the
    shape's batch (a run one card holds) and `microbatches` splits a
    train step. On `device` "meta" (the dry run's) nothing is allocated:
    the inputs are tensors of the reference's shapes (`input_specs`),
    this data rank's rows; elsewhere a train step's inputs are the
    driver's own batch (`make_batch_fn`) and a serving step's are drawn
    from seed 0."""
    from repro_torch.launch import train as train_lib
    cfg = cfg or arch.model
    if cfg is not arch.model:
        arch = dataclasses.replace(arch, model=cfg)
    if batch is not None and hasattr(shape, "batch"):
        shape = dataclasses.replace(shape, batch=batch)
    device = torch.device(device)
    name = f"{arch.arch_id}/{shape.name}"
    meta = {"mesh": dict(mesh.shape), "rank": mesh.index(mesh.axis_names),
            "microbatches": microbatches}
    kind = "train" if arch.family == "gnn" else shape.kind
    if kind == "train":
        model, opt_state, step_fn, placement, _ = train_lib.build_step(
            arch, cfg, shape, device, mesh=mesh,
            microbatches=microbatches)
        inputs = _train_inputs(arch, cfg, shape, mesh, device, placement,
                               microbatches)
        fn = lambda m, o, b: step_fn(m, o, 0, b)
        cache_bytes = 0
    elif arch.family == "lm":
        model, inputs, fn, placement = _lm_serving(cfg, shape, mesh, device)
        opt_state = None
        cache_bytes = storage_bytes(inputs.get("cache", {}))
    else:
        model = train_lib.init_params_for(arch, cfg, 0, shape=shape,
                                          device=device)
        placement = train_lib.model_placement(arch, cfg, shape, model, mesh)
        inputs, fn = _recsys_serving(arch, cfg, shape, placement, device)
        opt_state, cache_bytes = None, 0
    meta["placement"] = placement
    if isinstance(placement, Placement):
        meta["replicated"] = replicated_leaves(placement, model)
    memory = {"params": storage_bytes(model),
              "opt_state": storage_bytes(opt_state or {}),
              "cache": cache_bytes}
    memory["inputs"] = storage_bytes(inputs) - cache_bytes
    return Program(name, kind, fn, model, opt_state, inputs, memory, meta)


def _train_inputs(arch, cfg, shape, mesh, device, placement, microbatches):
    from repro_torch.launch import train as train_lib
    if device.type != "meta":
        fn = train_lib.make_batch_fn(
            arch, cfg, train_lib._batch_size(shape, None),
            np.random.RandomState(0), shape=shape, device=device, mesh=mesh,
            microbatches=microbatches,
            partitioned=bool(placement and placement.partitioned))
        return fn()
    specs = _INPUT_SPECS[arch.family](arch, shape)
    if arch.family == "gnn" and shape.kind == "full_graph" \
            and not placement.partitioned:
        # the edge-sharded layout: the nodes whole, this data rank's
        # slice of the padded edges as its plan
        e = specs["edge_src"].shape[0] // mesh.size(mesh.data_axes)
        return {"x": torch.empty(specs["x"].shape, dtype=f32, device=device),
                "labels": torch.empty(specs["labels"].shape, dtype=i32,
                                      device=device),
                "plan": _meta_plan(e, shape.n_nodes, device)}
    if arch.family == "gnn" and shape.kind == "full_graph":
        # the dst-partitioned layout the driver makes on a mesh: every
        # rank holds the whole graph and builds its own edges' plan
        n_shards = mesh.size(mesh.axis_names)
        n_pad, e_loc = partition_sizes(shape.n_nodes, shape.n_edges,
                                       n_shards, cfg.partition_slack)
        edges = (n_shards, e_loc)
        return {"x": torch.empty((n_pad, shape.d_feat), dtype=f32,
                                 device=device),
                "edge_src": torch.empty(edges, dtype=i32, device=device),
                "edge_dst": torch.empty(edges, dtype=i32, device=device),
                "labels": torch.empty((n_pad,), dtype=i32, device=device),
                "part_plan": _meta_plan(e_loc, n_pad // n_shards, device)}
    batch = next(iter(specs.values())).shape[0]
    inputs = _empty_inputs(specs, {"batch": _data_rows(batch, mesh, True)},
                           device)
    if arch.family == "gnn" and shape.kind == "batched_small":
        g = inputs["x"].shape[0]
        inputs["plan"] = _meta_plan(g * shape.n_edges, g * shape.n_nodes,
                                    device)
    return inputs


def _lm_serving(cfg, shape, mesh, device):
    """The LM's prefill or decode step on `mesh`: the model's blocks, the
    prompt or the cache block and the tokens of this data rank."""
    from repro_torch.models import transformer as tfm
    b, s = shape.batch, shape.seq_len
    pl = LMPlacement(mesh, cfg, kind=shape.kind, batch=b, cache_len=s)
    model = tfm.init_params(cfg, seed=0, device=device, blocks=pl.blocks())
    _, rows = pl.batch_rows(b)
    gen = torch.Generator().manual_seed(0)

    def tokens(shape_):
        if device.type == "meta":
            return torch.empty(shape_, dtype=i32, device=device)
        return torch.randint(0, cfg.vocab_size, shape_, generator=gen,
                             dtype=i32).to(device)
    if shape.kind == "prefill":
        fn = lambda m, inp: tfm.prefill(m, inp["tokens"], placement=pl)
        return model, {"tokens": tokens((rows, s))}, fn, pl
    spec = pl.cache_spec(b, s)
    full = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    block = tuple(n // pl.split(e) for n, e in zip(full, spec))
    cache = {k: torch.zeros(block, dtype=bf16, device=device)
             for k in ("k", "v")}
    pos = s - 1
    fn = lambda m, inp: tfm.decode_step(m, inp["cache"], inp["tokens"], pos,
                                        placement=pl)
    return model, {"cache": cache, "tokens": tokens((rows,))}, fn, pl


def _recsys_serving(arch, cfg, shape, placement, device):
    """A recsys or DLRM model's serve (its placed forward, this data
    rank's rows) or retrieval (`score_candidates` under the placement,
    25 chunks as the reference's) step."""
    from repro_torch.models import dlrm as dlrm_lib
    from repro_torch.models import recsys as recsys_lib
    mesh = placement.mesh
    ctx = shardlib.ShardCtx(placement=placement)
    specs = _INPUT_SPECS[arch.family](arch, shape)
    gen = torch.Generator().manual_seed(0)

    def draw(node, rows=None):
        if isinstance(node, dict):
            return {k: draw(v, rows) for k, v in node.items()}
        shp = tuple(rows if a == "batch" and rows else n
                    for n, a in zip(node.shape, node.axes))
        if device.type == "meta":
            return torch.empty(shp, dtype=node.dtype, device=device)
        if node.dtype == i32:
            hi = cfg.n_items if cfg.name == "bert4rec" else cfg.vocab_sizes[0]
            return torch.randint(0, hi, shp, generator=gen,
                                 dtype=i32).to(device)
        return torch.rand(shp, generator=gen).to(node.dtype).to(device)
    if shape.kind == "serve":
        inputs = draw(specs, _data_rows(shape.batch, mesh, False))
        if cfg.name == "bert4rec":
            fwd = lambda m, b: m.encode(b["item_seq"], ctx=ctx)
        else:
            fwd = lambda m, b: m(b, ctx=ctx)
        return inputs, torch.no_grad()(fwd)
    inputs = draw(specs)
    lib = dlrm_lib if arch.family == "dlrm" else recsys_lib
    fn = lambda m, inp: lib.score_candidates(m, inp["user"], inp["cand_ids"],
                                             chunks=25, placement=placement)
    return inputs, fn
