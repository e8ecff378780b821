"""Device meshes over torch.distributed ranks, port of
repro/launch/mesh.py.

`Mesh` is a grid of ranks with named axes, ("data", "model") or ("pod",
"data", "model"), rank r at the row-major position of r (as JAX's mesh
places device r). It wraps the torch `DeviceMesh` of the same grid and
holds the process groups the explicit collectives use: each axis's, the
data axes' with "pod" folded into "data" (`data_group`), and all axes'
(`all_group`). Meshes are functions of the process group, never module
state: importing this module initialises nothing.

A backend follows from the device: NCCL for "cuda", gloo for "cpu";
`init_distributed` refuses NCCL without CUDA and never swaps one for
the other.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the reference's production meshes: (data, model) on one pod of 256
# chips, (pod, data, model) on two (repro/launch/mesh.py); kept as data,
# since one card's machine runs a world of one rank
PRODUCTION_SHAPES = {1: ((16, 16), ("data", "model")),
                     2: ((2, 16, 16), ("pod", "data", "model"))}
DATA_AXES = ("pod", "data")
AXIS_ORDER = ("pod", "data", "model")


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU; NCCL without CUDA
    raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA, and this "
                               "machine has no CUDA device")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the default process group, the backend by `device`. Rank and
    world size come from the arguments (`mp.spawn`) or from RANK and
    WORLD_SIZE as `torchrun` sets them; the rendezvous from
    `init_method` (a `file://` path in the tests) or torchrun's
    MASTER_ADDR / MASTER_PORT (`env://`). Returns this rank's device:
    cuda:LOCAL_RANK for NCCL. A second call returns the device alone."""
    backend = backend_for(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    dev = torch.device(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    return dev


class Mesh:
    """A grid of ranks with named axes (see the module docstring). Every
    rank of the default group constructs it, in the same order (its
    subgroups are made collectively)."""

    def __init__(self, device_mesh, *, exchange_one_shard: bool = False):
        self.device_mesh = device_mesh
        # the row-sharded lookups exchange at one shard too, where the
        # reference falls back (models/embedding.py)
        self.exchange_one_shard = exchange_one_shard
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.ranks = device_mesh.mesh.cpu().numpy()
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device_type = device_mesh.device_type
        self.data_axes = tuple(a for a in DATA_AXES if a in self.axis_names)
        self._groups = {a: device_mesh.get_group(a) for a in self.axis_names}
        self.data_group = self._folded(self.data_axes)
        self.all_group = self._folded(self.axis_names)

    def _folded(self, axes: Sequence[str]):
        """The group of ranks that differ only along `axes` (None: this
        rank alone)."""
        if not axes:
            return None
        if len(axes) == 1:
            return self._groups[axes[0]]
        if self.ranks.size == dist.get_world_size() \
                and len(axes) == len(self.axis_names):
            return dist.group.WORLD
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        moved = np.moveaxis(self.ranks, keep, list(range(len(keep))))
        lists = moved.reshape(-1, self.size(axes)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(lists)
        return group

    def size(self, axes) -> int:
        """The product of the sizes of `axes` (a name or names; axes the
        mesh lacks count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def index(self, axes) -> int:
        """This rank's coordinate along `axes`, flattened major to minor
        in the mesh's axis order (0 for axes the mesh lacks)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        flat = 0
        for a in self.axis_names:
            if a in axes:
                flat = flat * self.shape[a] + \
                    self.device_mesh.get_local_rank(a)
        return flat

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(dp: int, tp: int, device="cuda", *, pods: int = 1,
              exchange_one_shard: bool = False) -> Mesh:
    """The (data, model) mesh of dp x tp ranks, or (pod, data, model)
    with `pods` > 1, over the default process group (its world size must
    be the mesh's), through `init_device_mesh`. With `exchange_one_shard`
    the row-sharded lookups run their exchange at one shard too, where
    the reference falls back to the unsharded lookup (a world of one rank
    then runs every collective and the local-rows kernel)."""
    from torch.distributed.device_mesh import init_device_mesh
    if pods > 1:
        shape, names = (pods, dp, tp), AXIS_ORDER
    else:
        shape, names = (dp, tp), ("data", "model")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return Mesh(init_device_mesh(torch.device(device).type, shape,
                                 mesh_dim_names=names),
                exchange_one_shard=exchange_one_shard)


def make_host_mesh(device="cpu") -> Mesh:
    """The one-rank mesh with the same axis names (a world of one)."""
    return make_mesh(1, 1, device)


def dp_size(mesh) -> int:
    n = 1
    for a in DATA_AXES:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1
