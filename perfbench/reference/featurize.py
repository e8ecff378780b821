"""The featurization a raw click record must get, in plain NumPy and
PyTorch: each feature's raw value hashed onto its table's rows (the
xxhash32 finalizer over the low 32 bits, mod the rows), the first
`lengths` of a feature's raw values kept and the bag filled out to
`hot` with the first (cut at `hot`), the
dense features' log1p standardized over the block (mean and std, ddof 0,
+ 1e-6), the label as it is. Imports nothing of the program.

`compare` matches a delivered batch with a block row for row without
assuming their order: both are sorted by their ids, then label and
dense features.
"""
from __future__ import annotations

import numpy as np
import torch

_P2 = np.uint32(2246822519)
_P3 = np.uint32(3266489917)


def hash_ids(raw_ids, vocab: int) -> np.ndarray:
    x = np.asarray(raw_ids).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = x * _P2
    x = x ^ (x >> np.uint32(13))
    x = x * _P3
    x = x ^ (x >> np.uint32(16))
    return (x % np.uint32(vocab)).astype(np.int64)


def bags(ids: np.ndarray, lengths: np.ndarray, hot: int) -> np.ndarray:
    """Hashed ids (B, F, K) with their valid counts (B, F) -> (B, F, hot):
    position j holds the j-th id where j < min(length, hot), else the
    first."""
    b, f, k = ids.shape
    out = np.repeat(ids[..., :1], hot, axis=-1)
    n = np.minimum(np.clip(np.asarray(lengths), 1, None), min(k, hot))
    for j in range(1, min(k, hot)):
        keep = j < n
        out[..., j][keep] = ids[..., j][keep]
    return out


def featurize(block: dict, rows: int, precision: str = "f64",
              hot: int = 1) -> dict:
    """A raw block (numpy) -> {sparse_ids (B, F, hot), dense, label}, the
    dense transform in f64 (the reference) or bf16 (its control)."""
    ids = bags(hash_ids(block["raw_ids"], rows), block["lengths"], hot)
    x = torch.from_numpy(np.asarray(block["dense_raw"]))
    if precision == "f64":
        x = torch.log1p(x.double())
        dense = (x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-6)
    elif precision == "bf16":
        x = torch.log1p(x.bfloat16())
        dense = ((x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-6))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return {"sparse_ids": ids, "dense": dense.double().numpy(),
            "label": np.asarray(block["label"], np.float64)}


def _order(ids: np.ndarray, label: np.ndarray, dense: np.ndarray):
    keys = [dense[:, j] for j in range(dense.shape[1] - 1, -1, -1)]
    keys.append(label)
    flat = ids.reshape(ids.shape[0], -1)
    keys += [flat[:, j] for j in range(flat.shape[1] - 1, -1, -1)]
    return np.lexsort(keys)


def compare(delivered: dict, expected: dict):
    """(rows whose ids or label differ, widest dense gap, the delivered
    rows' order that lines them up with `expected`'s) of one delivered
    batch against the featurized block it came from."""
    d_ids = np.asarray(delivered["sparse_ids"]).astype(np.int64)
    d_label = np.asarray(delivered["label"], np.float64)
    d_dense = np.asarray(delivered["dense"], np.float64)
    od = _order(d_ids, d_label, d_dense)
    oe = _order(expected["sparse_ids"], expected["label"],
                expected["dense"])
    if d_ids.shape != expected["sparse_ids"].shape:
        return d_ids.shape[0], float("inf"), None
    bad = (d_ids[od].reshape(len(od), -1)
           != expected["sparse_ids"][oe].reshape(len(oe), -1)).any(1) \
        | (d_label[od] != expected["label"][oe])
    gap = float(np.abs(d_dense[od] - expected["dense"][oe]).max())
    # delivered row od[i] is expected row oe[i]
    inv = np.empty_like(oe)
    inv[od] = oe
    return int(bad.sum()), gap, inv


def block_key(ids: np.ndarray) -> tuple:
    """A block's signature that no shuffle changes: its ids' sum and sum
    of squares a feature."""
    flat = ids.reshape(ids.shape[0], -1).astype(np.int64)
    return tuple(flat.sum(0).tolist()) + tuple((flat * flat % 1000003)
                                               .sum(0).tolist())
