"""The driver's placements on a mesh: port of the per-arch parts of
repro/launch/programs.py that the explicit collectives need
(`build_dlrm_program` :407-455, `build_recsys_program` :324-385,
`build_gnn_program` :242-275). XLA's lowering and GSPMD's implicit
placements have no counterpart: each parameter here is either
row-sharded or replicated.

- Row-sharded: the tables the row-sharded lookups read, where the config
  sets `tp_lookup` (`ROW_SHARDED`): the DLRM's and wide-deep's stacked
  tables (and wide-deep's wide arm) over `table_rows`, which their
  sharding overrides map to every axis; BERT4Rec's items over
  `table_rows`, the model axis by the default rules. Each spec is
  `sanitized_pspec` of the global shape, so a table whose rows do not
  divide replicates, as the lookup then falls back.
- Replicated: everything else.

`Placement` holds the specs and does the rest: this rank's slices of
the parameters (the same seed on every rank makes the same whole
tensors), the gradient reduction (a replicated gradient, or one sharded
off the data axes, is averaged over the data axes by `psum_tree`; one
sharded over them already holds every data rank's share, summed by the
lookup's all-gather, and is divided by their count; the partitioned
graph's are summed over every rank), the groups over which a shard's
norm is summed, and the gather of a sharded state to whole arrays for a
checkpoint in the JAX layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.common import shardlib
from repro_torch.train import collectives as coll
from repro_torch.train.elastic import local_slice

# the logical axes of each row-sharded parameter, by model name
ROW_SHARDED = {
    "dlrm": {"tables": (None, "table_rows", "table_dim")},
    "wide-deep": {"tables": (None, "table_rows", "table_dim"),
                  "wide": (None, "table_rows")},
    "bert4rec": {"items": ("table_rows", "table_dim")},
}


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


class Placement:
    """The specs of one model's parameters on `mesh` (see the module
    docstring). `specs[name]` is None for a replicated parameter."""

    def __init__(self, mesh, model_name: str, cfg, named_shapes: dict,
                 *, partitioned: bool = False):
        self.mesh = mesh
        self.partitioned = partitioned
        sharded = ROW_SHARDED.get(model_name, {}) \
            if getattr(cfg, "tp_lookup", False) else {}
        rules = shardlib.make_rules(dict(cfg.sharding_overrides)) \
            if sharded else None
        self.shapes = {k: tuple(s) for k, s in named_shapes.items()}
        self.specs: Dict[str, Optional[tuple]] = {}
        for name, shape in self.shapes.items():
            spec = None
            if name in sharded:
                spec = shardlib.sanitized_pspec(shape, sharded[name], rules,
                                                mesh)
                if not shardlib.spec_axes(spec):
                    spec = None
            self.specs[name] = spec
        self.dp = mesh.size(mesh.data_axes)

    def shard_model(self, model: nn.Module) -> None:
        """Replace each row-sharded parameter by this rank's slice of it
        (a copy, so the whole tensor is freed; a slice that is the whole
        keeps its storage)."""
        for name, spec in self.specs.items():
            if spec is None:
                continue
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

    def norm_groups(self) -> dict:
        """{name: group} of the sharded parameters: the group over which
        the squares of a gradient's shard add up to its whole."""
        return {name: axes_group(self.mesh, shardlib.spec_axes(spec))
                for name, spec in self.specs.items() if spec is not None}

    def global_numel(self) -> dict:
        return {name: int(torch.Size(shape).numel())
                for name, shape in self.shapes.items()}

    def reduce_grads(self, grads: dict, compress: str = "none") -> dict:
        """The gradients of the global loss from this rank's (see the
        module docstring)."""
        mesh = self.mesh
        if self.partitioned:
            return coll.psum_tree(grads, mesh.all_group, compress=compress,
                                  mean=False)
        out, dense = {}, {}
        for name, g in grads.items():
            axes = shardlib.spec_axes(self.specs.get(name))
            on_data = [a for a in mesh.data_axes if a in axes]
            if not on_data:
                dense[name] = g
            elif len(on_data) == len(mesh.data_axes):
                # in place: a table's gradient is as large as the table
                out[name] = g if self.dp == 1 else coll.ieee_div_(g, self.dp)
            else:
                raise ValueError(f"{name} is sharded over part of the data "
                                 f"axes ({axes})")
        if dense:
            out.update(coll.psum_tree(dense, mesh.data_group,
                                      compress=compress, mean=True))
        return {k: out[k] for k in grads}

    def state_spec(self, name: str, shape) -> Optional[tuple]:
        """The spec of an optimizer-state tensor of parameter `name` with
        global `shape`: the parameter's where the shapes agree, its
        leading dims' where the state drops trailing ones (row-wise
        adagrad's accumulator), else replicated."""
        spec, pshape = self.specs.get(name), self.shapes[name]
        if spec is None:
            return None
        shape = tuple(shape)
        if shape == pshape[:len(shape)]:
            return spec[:len(shape)]
        return None

    def gather(self, named: dict) -> dict:
        """{name: this rank's tensor} of parameters -> {name: whole}."""
        return {k: gather_full(v, self.specs.get(k), self.mesh)
                for k, v in named.items()}

    def gather_state(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """An optimizer-state tensor of parameter `name` made whole."""
        spec = self.specs.get(name)
        if spec is None:
            return x
        # a state of the parameter's leading dims: its spec's
        return gather_full(x, spec[:x.dim()], self.mesh)
