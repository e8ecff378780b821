"""Synthetic records for the generic driver's recsys and LM families: the
port's copies of `CriteoStream`, `TokenStream`, `bert4rec_batch` and
`dien_batch` from
repro/data/synthetic.py (numpy only, the same operations in the same
order, so the same seed or `RandomState` gives the same bits).

`raw_block` draws un-hashed ids, log-normal dense values and labels
from a planted CTR signal; `shuffle_udf` permutes a block's records with
the caller's RandomState; `feature_udf` is the online feature work
(hash ids into table rows, log1p and per-batch normalisation of the
dense features); `batch_udf` makes every array contiguous.
`TokenStream` draws zipf-distributed token sequences.
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

    # --------------------------- pipeline stage UDFs (the online work) ----
    @staticmethod
    def shuffle_udf(block: dict, rng: np.random.RandomState) -> dict:
        """The block's records in the order of `rng.permutation`: the
        caller's seeded RandomState, never numpy's global one."""
        n = block["label"].shape[0]
        perm = rng.permutation(n)
        return {k: v[perm] for k, v in block.items()}

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


class TokenStream:
    """Synthetic LM token stream (zipf-ish unigram with local structure)."""

    def __init__(self, vocab: int, seq_len: int, seed: int = 0):
        self.vocab, self.seq_len = vocab, seq_len
        self.rng = np.random.RandomState(seed)

    def batch(self, n: int) -> dict:
        z = self.rng.zipf(1.3, size=(n, self.seq_len + 1))
        toks = (z % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def bert4rec_batch(rng, batch: int, seq_len: int, n_items: int,
                   n_mask: int, n_neg: int) -> dict:
    """Cloze-masked item sequences with uniform sampled-softmax negatives."""
    seq = rng.randint(0, n_items, size=(batch, seq_len)).astype(np.int32)
    pos = np.stack([rng.choice(seq_len, size=n_mask, replace=False)
                    for _ in range(batch)]).astype(np.int32)
    labels = np.take_along_axis(seq, pos, axis=1)
    masked = seq.copy()
    np.put_along_axis(masked, pos, n_items, axis=1)   # MASK token id
    negs = rng.randint(0, n_items,
                       size=(batch, n_mask, n_neg)).astype(np.int32)
    return {"item_seq": masked, "mask_pos": pos, "mask_labels": labels,
            "neg_ids": negs}


def dien_batch(rng, batch: int, seq_len: int, n_items: int,
               n_dense: int) -> dict:
    """Behaviour histories of seq_len // 4 to seq_len items (mask 1 on
    the valid prefix), a target item, dense features and a label planted
    on the target appearing in the history."""
    hist = rng.randint(0, n_items, size=(batch, seq_len)).astype(np.int32)
    lens = rng.randint(seq_len // 4, seq_len + 1, size=batch)
    mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype(np.float32)
    target = rng.randint(0, n_items, size=batch).astype(np.int32)
    dense = rng.randn(batch, n_dense).astype(np.float32)
    # label correlates with target appearing in history (planted signal)
    appears = (hist == target[:, None]).any(1)
    label = ((appears | (rng.rand(batch) < 0.2))).astype(np.float32)
    return {"hist_ids": hist, "hist_mask": mask, "target_id": target,
            "dense": dense, "label": label}
