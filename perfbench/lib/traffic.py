"""The one generator of every traffic mix: click records from `--seed`.

A mix is a data file (`perfbench/traffic/<name>.json`) of parameters:
its mode (`perfbench/modes/<mode>.py`: `train` or `serve`), how batches
reach the program (`perfbench/feeds/<feed>.py`: `resident` on the
device, or `pipeline` through the port's process pipeline from raw
record files), the batch, the number of distinct batches, the id law
and, for the pipeline, its stages' placement. The configuration gives
the widths (features, rows, bag size, dense features). A raw mix may
name a raw record's values a feature, `k_raw` (1 where it names none),
which the pipeline pools to the configuration's bags. `zipf_s` 0 draws
the ids uniformly.

Ids: feature f draws ranks from a Zipf law of exponent `zipf_s` over the
table's rows and maps rank r to row perm_f[r], a seeded permutation, so
that hot rows lie scattered. A raw feed draws the same ranks over
distinct raw values (one seeded 31-bit value a rank), which the
program's hash maps onto rows, `k_raw` of them a feature, of which the
first `lengths` (uniform in 1..k_raw, drawn only where k_raw > 1) are
valid. Dense features are log-normal (raw) and
standardized a batch at a time (log1p, mean, std + 1e-6), labels are
drawn from a planted logistic signal, as the port's synthetic Criteo
records are. Every seed gives the same sizes; only the values change.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def sub_seed(seed: int, *parts: int) -> int:
    """A generator seed for one draw of the run `seed` (any size)."""
    x = int(seed) & ((1 << 64) - 1)
    for p in parts:
        x = (x * 6364136223846793005 + 1442695040888963407 + int(p)) \
            & ((1 << 64) - 1)
    return x & ((1 << 63) - 1)


def generator(device, seed: int, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def zipf_cdf(rows: int, s: float, device) -> torch.Tensor:
    """The cumulative law of ranks 0..rows-1, P(r) ~ (r + 1)^-s, f64."""
    w = torch.arange(1, rows + 1, device=device,
                     dtype=torch.float64).pow_(-s)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def zipf_ranks(cdf: torch.Tensor, n: int, gen: torch.Generator
               ) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def standardize(dense_raw: torch.Tensor) -> torch.Tensor:
    """log1p, then each column's mean and std (ddof 0) over the batch."""
    x = torch.log1p(dense_raw.float())
    return ((x - x.mean(0)) / (x.std(0, unbiased=False) + 1e-6)).float()


def planted_labels(dense_raw: torch.Tensor, first_raw: torch.Tensor,
                   seed: int, gen: torch.Generator) -> torch.Tensor:
    """Bernoulli(sigmoid(logit)) of the planted signal: the raw dense
    features against w_dense 0.1, and each feature's first raw value mod
    97 against w_sparse."""
    n_dense, n_sparse = dense_raw.shape[-1], first_raw.shape[-1]
    wg = generator(dense_raw.device, seed, 991)
    w_dense = torch.randn(n_dense, generator=wg, device=dense_raw.device,
                          dtype=torch.float64) * 0.5
    w_sparse = torch.randn(n_sparse, generator=wg, device=dense_raw.device,
                           dtype=torch.float64) * 0.3
    logit = dense_raw.double() @ w_dense * 0.1 \
        + ((first_raw % 97).double() / 97.0 - 0.5) @ w_sparse
    u = torch.rand(logit.shape, generator=gen, device=dense_raw.device,
                   dtype=torch.float64)
    return (u < torch.sigmoid(logit)).float()


def k_raw(mix: dict) -> int:
    """A raw record's values a feature."""
    return int(mix.get("k_raw", 1))


def make(cfg: dict, mix: dict, seed: int, device, raw: bool = False
         ) -> List[Dict[str, torch.Tensor]]:
    """The mix's `n_batches` distinct batches on `device`: model-ready
    (`sparse_ids` (B, F, hot) int32, `dense` (B, n_dense) f32, `label`
    (B,) f32), or with `raw` the records before featurization
    (`raw_ids` (B, F, k_raw) int64, `lengths` (B, F) int32, `dense_raw`
    (B, n_dense) f32, `label`)."""
    nb, b = int(mix["n_batches"]), int(mix["batch"])
    f, rows = int(cfg["n_sparse"]), int(cfg["rows"])
    hot = k_raw(mix) if raw else int(cfg.get("multi_hot", 1))
    cdf = zipf_cdf(rows, float(mix["zipf_s"]), device)
    ids = torch.empty((nb, b, f, hot), dtype=torch.int64, device=device)
    for j in range(f):
        g = generator(device, seed, 1, j)
        ranks = zipf_ranks(cdf, nb * b * hot, g).view(nb, b, hot)
        if raw:
            values = torch.randint(0, 1 << 31, (rows,), generator=g,
                                   device=device, dtype=torch.int64)
        else:
            values = torch.randperm(rows, generator=g, device=device)
        ids[:, :, j] = values[ranks]
        del ranks, values
    del cdf
    n_dense = int(cfg["n_dense"])
    out = []
    for k in range(nb):
        g = generator(device, seed, 2, k)
        dense_raw = torch.empty((b, n_dense), device=device).log_normal_(
            0.0, 1.0, generator=g)
        label = planted_labels(dense_raw, ids[k, :, :, 0], seed, g)
        if raw:
            lengths = torch.ones((b, f), dtype=torch.int32, device=device)
            if hot > 1:
                lengths = torch.randint(1, hot + 1, (b, f), generator=g,
                                        device=device, dtype=torch.int32)
            out.append({"raw_ids": ids[k], "lengths": lengths,
                        "dense_raw": dense_raw, "label": label})
        else:
            out.append({"sparse_ids": ids[k].to(torch.int32),
                        "dense": standardize(dense_raw), "label": label})
    return out


def write_raw_blocks(blocks, directory: str) -> List[str]:
    """Each raw block as one `.npz` file under `directory`; their paths."""
    paths = []
    for k, blk in enumerate(blocks):
        path = os.path.join(directory, f"block{k}.npz")
        np.savez(path, **{n: t.cpu().numpy() for n, t in blk.items()})
        paths.append(path)
    return paths
