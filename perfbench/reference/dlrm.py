"""The plain DLRM (Naumov et al., arXiv:1906.00091), in f32 PyTorch:
the bottom MLP on the dense features (relu after every layer), one sum
bag a sparse feature from its own table, the pairwise dots of the
bottom output and the bags over the strict lower triangle (row i > col
j, in np.tril_indices order), the top MLP on [dots, bottom output]
(relu between, none after the last), the logit. Imports nothing of the
program.

`params` maps a leaf's name to its parts: "tables" to one (rows, D)
tensor a feature, holding only the rows the batches read, which `ids`
index; every other leaf to [tensor], an MLP weight (out, in).
"""
from __future__ import annotations

import torch

from perfbench.reference.common import mlp, rnd


def leaves(cfg: dict) -> list:
    """(name, whole shape, init) of every leaf, in the program's order;
    init ("normal", scale) or ("zeros",)."""
    f, d = cfg["n_sparse"], cfg["embed_dim"]
    out = [("tables", (f, cfg["rows"], d), ("normal", d ** -0.5))]
    n_f = f + 1
    dims = {"bottom": [cfg["n_dense"]] + list(cfg["bottom_mlp"]),
            "top": [n_f * (n_f - 1) // 2 + cfg["bottom_mlp"][-1]]
            + list(cfg["top_mlp"])}
    for part in ("bottom", "top"):
        for i in range(len(dims[part]) - 1):
            fan_in, fan_out = dims[part][i], dims[part][i + 1]
            out.append((f"{part}.{i}.weight", (fan_out, fan_in),
                        ("normal", fan_in ** -0.5)))
            out.append((f"{part}.{i}.bias", (fan_out,), ("zeros",)))
    return out


def _layers(params: dict, part: str) -> list:
    n = sum(1 for k in params if k.startswith(part + ".")) // 2
    return [(params[f"{part}.{i}.weight"][0], params[f"{part}.{i}.bias"][0])
            for i in range(n)]


def bags(tables: list, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F, hot) into each feature's rows -> (B, F, D), summed."""
    return torch.stack([tables[f][ids[:, f]].sum(1)
                        for f in range(len(tables))], dim=1)


def forward(params: dict, batch: dict, precision: str = "f32",
            emb: torch.Tensor = None) -> torch.Tensor:
    """Logits (B,) of batch {"ids": (B, F, hot) into params' rows,
    "dense": (B, n_dense)}; `emb` (B, F, D) stands for the bags where
    given."""
    x = mlp(batch["dense"].float(), _layers(params, "bottom"), precision,
            final_act=True)
    if emb is None:
        emb = bags(params["tables"], batch["ids"])
    feats = rnd(torch.cat([x[:, None], emb.float()], dim=1), precision)
    gram = torch.bmm(feats, feats.transpose(1, 2))
    ii, jj = torch.tril_indices(feats.shape[1], feats.shape[1], offset=-1,
                                device=feats.device).unbind(0)
    top_in = torch.cat([gram[:, ii, jj], x], dim=-1)
    return mlp(top_in, _layers(params, "top"), precision,
               final_act=False)[:, 0]
