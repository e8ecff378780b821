"""The plain wide-and-deep model (Cheng et al., arXiv:1606.07792), in
f32 PyTorch: the deep arm's sum bags of every sparse feature from its
own (rows, D) table, concatenated with the dense features, through the
deep MLP (relu between, none after the last); the wide arm's scalar
weight a row summed over each bag and over the features, plus the dense
features against a (n_dense, 1) weight; the two arms' logits and a
scalar bias summed. Imports nothing of the program.

`params` maps a leaf's name to its parts: "tables" to one (rows, D) and
"wide" to one (rows,) tensor a feature, holding only the rows the
batches read, which `ids` index; every other leaf to [tensor].
"""
from __future__ import annotations

import torch

from perfbench.reference.common import mlp, rnd


def leaves(cfg: dict) -> list:
    """(name, whole shape, init) of every leaf, in the program's order."""
    f, d, rows = cfg["n_sparse"], cfg["embed_dim"], cfg["rows"]
    dims = [f * d + cfg["n_dense"]] + list(cfg["mlp"]) + [1]
    out = [("tables", (f, rows, d), ("normal", d ** -0.5)),
           ("wide", (f, rows), ("normal", 0.01))]
    for i in range(len(dims) - 1):
        out.append((f"mlp.{i}.weight", (dims[i + 1], dims[i]),
                    ("normal", dims[i] ** -0.5)))
        out.append((f"mlp.{i}.bias", (dims[i + 1],), ("zeros",)))
    out.append(("wide_dense", (cfg["n_dense"], 1), ("normal", 0.01)))
    out.append(("bias", (), ("zeros",)))
    return out


def forward(params: dict, batch: dict, precision: str = "f32",
            emb: torch.Tensor = None) -> torch.Tensor:
    """Logits (B,) of batch {"ids": (B, F, hot) into params' rows,
    "dense": (B, n_dense)}."""
    ids, dense = batch["ids"], batch["dense"].float()
    f = len(params["tables"])
    if emb is None:
        emb = torch.stack([params["tables"][j][ids[:, j]].sum(1)
                           for j in range(f)], dim=1)
    deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
    n = sum(1 for k in params if k.startswith("mlp.")) // 2
    layers = [(params[f"mlp.{i}.weight"][0], params[f"mlp.{i}.bias"][0])
              for i in range(n)]
    deep = mlp(deep_in, layers, precision, final_act=False)[:, 0]
    wide = torch.stack([params["wide"][j][ids[:, j]].sum(1)
                        for j in range(f)], dim=1).sum(1)
    wide = wide + (rnd(dense, precision)
                   @ rnd(params["wide_dense"][0], precision))[:, 0]
    return deep + wide + params["bias"][0]
