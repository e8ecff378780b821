"""Fault-tolerant checkpointing: atomic shard files + JSON manifest (port
of repro/train/checkpoint.py, with the same on-disk layout: a checkpoint
written by either package restores in the other).

Leaves are torch tensors or numpy arrays: they go to the host before
they are saved, and `restore(ckpt_dir, device)` returns them as tensors
on `device`.

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json      step, timestamp, tree structure, mesh, extras
        shard_00000.npz    flattened path->array (host 0's slice set)
        ...
Writes go to `step_XXXX.tmp/` then a single atomic rename — a crash
mid-write never corrupts the latest-complete checkpoint, and `restore()`
always resolves the newest *complete* step. Arrays bigger than
`MAX_SHARD_BYTES` are split across shard files along axis 0, as the JAX
package splits them; restore reads split arrays from either package.
`extras` is a JSON dict written into the manifest as the JAX package
writes it: the closed-loop launcher keeps the InTune controller's
allocation and agent step count there (its Q-network rides in the tree),
so a restarted job resumes both model and pipeline tuning. A bf16 leaf is written as the JAX package
writes one: `np.savez` of a JAX bf16 array stores its 2-byte elements as
the void type `|V2`, and `np.load` gives them back as such; the port
writes and reads that encoding (`to_numpy` / `from_numpy` of
models/exchange.py), so bf16 checkpoints cross between the packages
both ways. The tree is the JAX package's: each model module maps its parameter names to it
(`tree_from_named` / `named_from_tree` of models/gnn.py, models/recsys.py
and models/dlrm.py), for the parameters and for the optimizer state
alike (adam's `m`/`v`, row-wise adagrad's `acc`).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.exchange import from_numpy, to_numpy


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    root: dict = {}
    for path, v in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("[") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:-1]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


MAX_SHARD_BYTES = 1 << 30


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def save(ckpt_dir: str, step: int, tree, *, extras: Optional[dict] = None,
         max_shard_bytes: int = MAX_SHARD_BYTES) -> str:
    """Atomic checkpoint write. Returns the final directory path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat = {k: to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
            for k, v in _flatten(tree).items()}
    shards: list[dict] = [{}]
    sizes = [0]
    index = {}   # path -> [(shard_id, axis0_start, axis0_end)]
    for path, arr in flat.items():
        if arr.nbytes > max_shard_bytes and arr.ndim >= 1 and arr.shape[0] > 1:
            n_chunks = -(-arr.nbytes // max_shard_bytes)
            rows = -(-arr.shape[0] // n_chunks)
            entries = []
            for s in range(0, arr.shape[0], rows):
                e = min(s + rows, arr.shape[0])
                shards.append({f"{path}@@{s}": arr[s:e]})
                sizes.append(arr[s:e].nbytes)
                entries.append([len(shards) - 1, s, e])
            index[path] = entries
        else:
            if sizes[-1] + arr.nbytes > max_shard_bytes and shards[-1]:
                shards.append({})
                sizes.append(0)
            shards[-1][path] = arr
            sizes[-1] += arr.nbytes
            index[path] = [[len(shards) - 1, -1, -1]]

    for i, shard in enumerate(shards):
        if shard:
            np.savez(os.path.join(tmp, f"shard_{i:05d}.npz"), **shard)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_shards": len(shards),
        "index": index,
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, name,
                                                "manifest.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, device, step: Optional[int] = None):
    """The checkpoint of `step` (the newest complete one if None) as
    (tree, manifest); the tree's leaves are torch tensors on `device`.
    Raises FileNotFoundError if nothing valid."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    shard_cache: dict[int, Any] = {}

    def load_shard(i):
        if i not in shard_cache:
            shard_cache[i] = np.load(
                os.path.join(d, f"shard_{i:05d}.npz"))
        return shard_cache[i]

    flat = {}
    for path, entries in manifest["index"].items():
        if len(entries) == 1 and entries[0][1] == -1:
            flat[path] = load_shard(entries[0][0])[path]
        else:
            parts = [load_shard(sid)[f"{path}@@{s}"]
                     for sid, s, _ in entries]
            flat[path] = np.concatenate(parts, axis=0)
    tree = _map_leaves(lambda a: from_numpy(a).to(device), _unflatten(flat))
    return tree, manifest
