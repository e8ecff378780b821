"""Meta DLRM (Naumov et al.), the paper's Criteo workload, in PyTorch.

bottom-MLP(dense) -> embedding bags (one per sparse feature) -> pairwise
dot interaction -> top-MLP -> CTR logit. Port of repro/models/dlrm.py on
one device: the embedding bags and the interaction both run through the
hand-written kernels (repro_torch.kernels.ops), forward and backward,
in f32 or, as the reference configuration has them, bf16 (the bags sum
in f32 and are rounded to bf16 for the interaction). `score_candidates`
is the reference's retrieval scoring.

Parameters cross between the packages as numpy in the JAX layout,
`{"tables": (F, V, D), "bottom"/"top": ({"w": (in, out), "b": (out,)},
...)}`, through `params_from_numpy` / `params_to_numpy` (bf16 arrays as
2-byte elements, `models.exchange`); `nn.Linear` holds each
`w` transposed, and `tree_from_named` / `named_from_tree` map the
module's names to that tree and back (for parameters and optimizer state
alike).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import DLRMConfig
from repro_torch.kernels import ops
from repro_torch.models.embedding import multifeature_bag
from repro_torch.models.exchange import from_numpy, to_numpy, transpose
from repro_torch.models.recsys import apply_mlp, bce_loss, init_mlp


class DLRM(nn.Module):
    """Stacked (F, V, D) tables plus the bottom and top MLPs."""

    def __init__(self, cfg: DLRMConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        rows = cfg.vocab_sizes[0]
        tables = torch.empty((cfg.n_sparse, rows, cfg.embed_dim),
                             dtype=dtype, device=device)
        with torch.no_grad():
            tables.normal_(generator=generator).mul_(cfg.embed_dim ** -0.5)
        self.tables = nn.Parameter(tables)
        self.bottom = init_mlp((cfg.n_dense,) + cfg.bottom_mlp,
                               generator=generator, device=device,
                               dtype=dtype)
        n_f = cfg.n_sparse + 1                      # +1: bottom-MLP output
        top_in = n_f * (n_f - 1) // 2 + cfg.bottom_mlp[-1]
        self.top = init_mlp((top_in,) + cfg.top_mlp, generator=generator,
                            device=device, dtype=dtype)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None,
                interact_fn: Optional[Callable] = None) -> torch.Tensor:
        """batch: sparse_ids (B, F, hot) int32, dense (B, n_dense) ->
        logits (B,). `bag_fn` / `interact_fn` replace the kernel ops (a
        comparison against the plain versions on the card uses them)."""
        dense_out = apply_mlp(self.bottom,
                              batch["dense"].to(self.tables.dtype),
                              final_act=True)
        emb = (bag_fn or multifeature_bag)(self.tables, batch["sparse_ids"])
        feats = torch.cat([dense_out[:, None, :], emb.to(dense_out.dtype)],
                          dim=1)                            # (B, F+1, D)
        interact = (interact_fn or ops.dot_interact)(feats)
        top_in = torch.cat([interact, dense_out], dim=-1)
        return apply_mlp(self.top, top_in)[:, 0]


def init_params(cfg: DLRMConfig, *, seed: int = 0, device="cuda") -> DLRM:
    """A DLRM with random weights drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return DLRM(cfg, device=device, generator=gen)


def loss_fn(model: DLRM, batch: Dict[str, torch.Tensor], **kw):
    logit = model(batch, **kw)
    loss = bce_loss(logit, batch["label"].float())
    return loss, {"bce": loss}


@torch.no_grad()
def score_candidates(model: DLRM, user: Dict[str, torch.Tensor],
                     cand_ids: torch.Tensor, *, chunks: int = 25,
                     bag_fn: Optional[Callable] = None,
                     interact_fn: Optional[Callable] = None) -> torch.Tensor:
    """Retrieval scoring with the user side computed once (the reference's
    `score_candidates`): user dense (1, n_dense) and sparse_ids (1, F,
    hot), cand_ids (C,) -> scores (C,). Only feature 0, the item, varies
    between candidates: the user's bags and bottom MLP run once, and each
    of `chunks` chunks of C gathers its candidates' item rows from table
    0 (ids mod V, a plain row gather as the reference's `jnp.take`) and
    runs the interaction and the top MLP. C must divide by `chunks`.
    `bag_fn` / `interact_fn` replace the kernel ops, as in `forward`."""
    cfg = model.cfg
    interact_fn = interact_fn or ops.dot_interact
    c = cand_ids.shape[0]
    if c % chunks:
        raise ValueError(f"{c} candidates do not split into {chunks} chunks")
    dense_out = apply_mlp(model.bottom,
                          user["dense"].to(model.tables.dtype),
                          final_act=True)                         # (1, D)
    user_emb = (bag_fn or multifeature_bag)(model.tables,
                                            user["sparse_ids"]) \
        .to(dense_out.dtype)                                      # (1, F, D)
    d = cfg.embed_dim
    out = []
    for ids in cand_ids.reshape(chunks, c // chunks):
        cc = ids.shape[0]
        item = model.tables[0][ids.long() % cfg.vocab_sizes[0]]   # (cc, D)
        feats = torch.cat([dense_out.expand(cc, d)[:, None], item[:, None],
                           user_emb[:, 1:].expand(cc, cfg.n_sparse - 1, d)],
                          dim=1)                                # (cc, F+1, D)
        top_in = torch.cat([interact_fn(feats), dense_out.expand(cc, d)],
                           dim=-1)
        out.append(apply_mlp(model.top, top_in)[:, 0])
    return torch.cat(out)


# ------------------------------------------------------ numpy exchange ---
def tree_from_named(named: Dict[str, object]) -> dict:
    """{module name: x} -> the JAX layout (parameters and optimizer state
    alike): `bottom.<i>.weight` becomes `bottom[i]["w"]`, transposed, and
    so for `top`."""
    tree = {"tables": named["tables"]}
    for part in ("bottom", "top"):
        n = 1 + max(int(k.split(".")[1]) for k in named
                    if k.startswith(part + "."))
        tree[part] = tuple({"w": transpose(named[f"{part}.{i}.weight"]),
                            "b": named[f"{part}.{i}.bias"]}
                           for i in range(n))
    return tree


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named`."""
    named = {"tables": tree["tables"]}
    for part in ("bottom", "top"):
        for i, layer in enumerate(tree[part]):
            named[f"{part}.{i}.weight"] = transpose(layer["w"])
            named[f"{part}.{i}.bias"] = layer["b"]
    return named


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters, f32 or bf16 -> a `DLRM.state_dict()`
    (CPU tensors; `load_state_dict` copies them to the model's device)."""
    return {k: from_numpy(v) for k, v in named_from_tree(params).items()}


def params_to_numpy(model: DLRM) -> dict:
    """The model's parameters as JAX-layout numpy arrays (bf16 ones as
    2-byte void elements, `to_numpy`)."""
    return tree_from_named({k: to_numpy(p)
                            for k, p in model.named_parameters()})
