"""Synthetic Criteo-like click records for the generic driver's recsys
family: the port's copy of `CriteoStream` from repro/data/synthetic.py
(numpy only, the same operations in the same order, so the same seed
gives the same bits).

`raw_block` draws un-hashed ids, log-normal dense values and labels
from a planted CTR signal; `feature_udf` is the online feature work
(hash ids into table rows, log1p and per-batch normalisation of the
dense features); `batch_udf` makes every array contiguous.
"""
from __future__ import annotations

import numpy as np


class CriteoStream:
    """Infinite synthetic click-log stream with a planted CTR signal."""

    def __init__(self, n_sparse: int = 26, n_dense: int = 13,
                 vocab: int = 1 << 20, multi_hot: int = 1, seed: int = 0):
        self.n_sparse, self.n_dense = n_sparse, n_dense
        self.vocab, self.multi_hot = vocab, multi_hot
        self.rng = np.random.RandomState(seed)
        # planted weights so training actually reduces loss
        self.w_dense = self.rng.randn(n_dense) * 0.5
        self.w_sparse = self.rng.randn(n_sparse) * 0.3

    def raw_block(self, n: int) -> dict:
        """Raw (pre-UDF) records: un-hashed ids + raw dense values."""
        raw_ids = self.rng.randint(0, 1 << 31,
                                   size=(n, self.n_sparse, self.multi_hot))
        dense_raw = self.rng.lognormal(0.0, 1.0, size=(n, self.n_dense))
        # CTR signal from a few planted features
        logit = dense_raw @ self.w_dense * 0.1 + \
            ((raw_ids[:, :, 0] % 97) / 97.0 - 0.5) @ self.w_sparse
        label = (self.rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(
            np.float32)
        return {"raw_ids": raw_ids.astype(np.int64),
                "dense_raw": dense_raw.astype(np.float32), "label": label}

    def feature_udf(self, block: dict) -> dict:
        """Hash ids into table rows; log1p + normalize dense features."""
        h = block["raw_ids"].astype(np.uint32) * np.uint32(2654435761)
        sparse_ids = (h % np.uint32(self.vocab)).astype(np.int32)
        dense = np.log1p(block["dense_raw"]).astype(np.float32)
        dense = (dense - dense.mean(0)) / (dense.std(0) + 1e-6)
        return {"sparse_ids": sparse_ids, "dense": dense,
                "label": block["label"]}

    @staticmethod
    def batch_udf(block: dict) -> dict:
        return {k: np.ascontiguousarray(v) for k, v in block.items()}
