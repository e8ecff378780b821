"""Elastic scaling: rebuild meshes from survivors, reshard state (port of
repro/train/elastic.py).

Failure model: a job starts on H hosts; some die or new ones arrive (the
paper's machine-resize scenario, Fig. 5C, applied to the compute side).
Recovery = pick the largest valid mesh from the survivor count, reshard
the checkpointed state onto it, re-split data-pipeline file shards, and
let each host's InTune controller re-tune its ingestion pipeline for the
new CPU pool (that last part is automatic: it is the paper's point).

The plans (`viable_mesh_shape`, `split_file_shards`,
`ElasticCoordinator`) are the reference's, bit for bit. A mesh is built
over process-group ranks (`make_mesh_from_devices`), and `reshard`
places a state held whole in numpy (a checkpoint in the JAX layout) onto
this rank's shards under a new mesh.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.exchange import from_numpy


def viable_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                      min_model: int = 1) -> Tuple[int, ...]:
    """Largest (data, model) grid using <= n_devices devices.

    Keeps the model axis as large as the parallelism plan allows (TP degree
    is a property of the param shapes), shrinking it only when too few
    devices survive; the data axis absorbs the rest (power of two).
    """
    tp = model_parallel
    while tp > min_model and tp > n_devices:
        tp //= 2
    dp = max(1, 2 ** int(np.log2(max(n_devices // tp, 1))))
    return (dp, tp)


def make_mesh_from_devices(ranks: Sequence[int], shape: Tuple[int, int],
                           axis_names=("data", "model"), device="cpu"):
    """The (data, model) mesh of the first dp x tp of `ranks` (ranks of
    the default process group), row-major. Every rank of the group
    constructs it."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import Mesh
    dp, tp = shape
    grid = torch.as_tensor(np.asarray(ranks[: dp * tp]).reshape(dp, tp))
    return Mesh(DeviceMesh(torch.device(device).type, grid,
                           mesh_dim_names=tuple(axis_names)))


def local_slice(x, spec, mesh):
    """This rank's block of a whole array x (numpy or tensor) under
    `spec` on `mesh`: each dim whose entry names mesh axes is cut into
    their product's equal blocks, this rank's coordinate along them
    (flattened major to minor) picking the block."""
    for d, entry in enumerate(spec or ()):
        if entry is None:
            continue
        n, k = mesh.size(entry), mesh.index(entry)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {entry} ({n})")
        size = x.shape[d] // n
        idx = [slice(None)] * x.ndim
        idx[d] = slice(k * size, (k + 1) * size)
        x = x[tuple(idx)]
    return x


def reshard(tree, specs_tree, new_mesh, *, device=None):
    """A state tree whose leaves are whole numpy arrays (or tensors), with
    a tree of specs of the same structure (a spec tuple at each leaf's
    place; None for a whole subtree replicated), as this rank's shards
    on `new_mesh`: tensors on `device` (the CPU if None)."""
    def place(x, spec):
        x = local_slice(x, spec, new_mesh)
        t = x if torch.is_tensor(x) else from_numpy(np.ascontiguousarray(x))
        return t.contiguous().to(device or "cpu")

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, None if spec is None else spec[k])
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            specs = [None] * len(node) if spec is None else spec
            return type(node)(walk(v, s) for v, s in zip(node, specs))
        return place(node, spec)
    return walk(tree, specs_tree)


def split_file_shards(files: Sequence[str], n_hosts: int,
                      host_id: int) -> list:
    """Deterministic re-split of dataset files over surviving hosts."""
    return [f for i, f in enumerate(sorted(files)) if i % n_hosts == host_id]


class ElasticCoordinator:
    """Tracks resize events and produces recovery plans.

    In a real deployment the resize signal comes from the cluster scheduler;
    here it is injected by tests/benchmarks (the paper injects it manually
    too: 32 -> 64 -> 128 -> 64 -> 32 CPUs).
    """

    def __init__(self, n_devices: int, model_parallel: int = 16):
        self.model_parallel = model_parallel
        self.history: list = []
        self.resize(n_devices)

    def resize(self, n_devices: int) -> Tuple[int, int]:
        shape = viable_mesh_shape(
            n_devices, model_parallel=self.model_parallel)
        self.current = shape
        self.history.append((n_devices, shape))
        return shape

    def recovery_plan(self, n_survivors: int) -> dict:
        shape = self.resize(n_survivors)
        return {
            "mesh_shape": shape,
            "devices_used": shape[0] * shape[1],
            "devices_idle": n_survivors - shape[0] * shape[1],
            "action": "restore latest checkpoint; reshard params/opt state;"
                      " re-split data files; InTune re-tunes pipelines",
        }
