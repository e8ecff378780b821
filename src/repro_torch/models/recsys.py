"""The recsys family in PyTorch: the MLP helpers and the CTR loss shared
with the DLRM (port of repro/models/recsys.py:33-58), and wide-deep
(`init_wide_deep` as the `WideDeep` module, `wide_deep_forward` as its
`forward`, and `ctr_loss`: :62-103 and :394-397).

wide-deep's two lookups both run through `ops.embedding_bag_fused`: the
deep tables (F, V, D) and the wide arm, its (F, V) table viewed as
(F, V, 1) and summed over the bag. On the card the op takes the fused
kernel where a feature's table is at most 8 MiB (the wide arm's 4 MiB
at the published widths) and the row kernel `embedding_bag_fwd`
otherwise (the deep tables' 128 MiB); the backward of both is the
scatter kernel `embedding_bag_bwd`. xDeepFM, DIEN and BERT4Rec are not
ported yet (ROADMAP queue 1, item 7).

Parameters cross between the packages as numpy in the JAX layout,
`{"tables": (F, V, D), "wide": (F, V), "wide_dense": (n_dense, 1),
"mlp": ({"w": (in, out), "b": (out,)}, ...), "bias": ()}`, through
`params_from_numpy` / `params_to_numpy`; `nn.Linear` holds each `w`
transposed, and `tree_from_named` / `named_from_tree` map the module's
names to that tree and back (for parameters and optimizer state alike).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import ops
from repro_torch.models.exchange import transpose


def init_mlp(dims: Sequence[int], *, generator: Optional[torch.Generator],
             device="cuda", dtype=torch.float32) -> nn.ModuleList:
    """Dense stack dims[0] -> ... -> dims[-1]: weights ~ N(0, 1/fan_in),
    biases zero, as the JAX package initializes them. `nn.Linear` keeps
    its weight as (out, in), the transpose of the JAX layout."""
    layers = nn.ModuleList()
    for i in range(len(dims) - 1):
        lin = nn.Linear(dims[i], dims[i + 1], device="meta", dtype=dtype)
        lin = lin.to_empty(device=device)
        with torch.no_grad():
            lin.weight.normal_(generator=generator).mul_(dims[i] ** -0.5)
            lin.bias.zero_()
        layers.append(lin)
    return layers


def apply_mlp(layers: nn.ModuleList, x: torch.Tensor,
              act: Callable = torch.relu,
              final_act: bool = False) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = lin(x)
        if final_act or i < len(layers) - 1:
            x = act(x)
    return x


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable form."""
    logit = logit.float()
    loss = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    return loss.mean()


# =============================================================== wide-deep ==
class WideDeep(nn.Module):
    """Stacked (F, V, D) deep tables, the (F, V) wide table, the wide arm's
    dense weights (n_dense, 1), the deep MLP and a scalar bias."""

    def __init__(self, cfg: RecsysConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        rows = cfg.vocab_sizes[0]

        def normal(shape, scale):
            t = torch.empty(shape, dtype=dtype, device=device)
            with torch.no_grad():
                t.normal_(generator=generator).mul_(scale)
            return nn.Parameter(t)
        self.tables = normal((cfg.n_sparse, rows, cfg.embed_dim),
                             cfg.embed_dim ** -0.5)
        self.wide = normal((cfg.n_sparse, rows), 0.01)
        deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        self.mlp = init_mlp((deep_in,) + cfg.mlp_dims + (1,),
                            generator=generator, device=device, dtype=dtype)
        self.wide_dense = normal((cfg.n_dense, 1), 0.01)
        self.bias = nn.Parameter(torch.zeros((), dtype=dtype, device=device))

    def forward(self, batch: Dict[str, torch.Tensor], *,
                bag_fn: Optional[Callable] = None) -> torch.Tensor:
        """batch: sparse_ids (B, F, hot) int32, dense (B, n_dense) ->
        logits (B,). `bag_fn(tables, ids)` replaces the kernel op (a
        comparison against the plain version on the card uses it)."""
        bag_fn = bag_fn or ops.embedding_bag_fused
        ids = batch["sparse_ids"]
        emb = bag_fn(self.tables, ids)                          # (B, F, D)
        dense = batch["dense"].to(emb.dtype)
        deep_in = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=-1)
        deep_logit = apply_mlp(self.mlp, deep_in)[:, 0]
        # wide arm: per-feature scalar weights, multi-hot summed (the bag
        # in the lookup, then the features)
        wide_w = bag_fn(self.wide.unsqueeze(-1), ids)           # (B, F, 1)
        wide_logit = wide_w.sum(dim=(1, 2)) + (dense @ self.wide_dense)[:, 0]
        return deep_logit + wide_logit + self.bias


def init_wide_deep(cfg: RecsysConfig, *, seed: int = 0,
                   device="cuda") -> WideDeep:
    """A wide-deep model with random weights drawn on `device` from
    `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return WideDeep(cfg, device=device, generator=gen)


def ctr_loss(model: nn.Module, batch: Dict[str, torch.Tensor], **kw):
    logit = model(batch, **kw)
    loss = bce_loss(logit, batch["label"].float())
    return loss, {"bce": loss}


# ------------------------------------------------------ numpy exchange ---
_LEAVES = ("tables", "wide", "wide_dense", "bias")


def tree_from_named(named: Dict[str, object]) -> dict:
    """{module name: x} -> the JAX layout (parameters and optimizer state
    alike): `mlp.<i>.weight` becomes `mlp[i]["w"]`, transposed."""
    n_mlp = 1 + max(int(k.split(".")[1]) for k in named
                    if k.startswith("mlp."))
    tree = {k: named[k] for k in _LEAVES}
    tree["mlp"] = tuple({"w": transpose(named[f"mlp.{i}.weight"]),
                         "b": named[f"mlp.{i}.bias"]} for i in range(n_mlp))
    return tree


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named`."""
    named = {k: tree[k] for k in _LEAVES}
    for i, layer in enumerate(tree["mlp"]):
        named[f"mlp.{i}.weight"] = transpose(layer["w"])
        named[f"mlp.{i}.bias"] = layer["b"]
    return named


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters -> a `WideDeep.state_dict()` (CPU
    tensors; `load_state_dict` copies them to the model's device)."""
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in named_from_tree(params).items()}


def params_to_numpy(model: WideDeep) -> dict:
    """The model's parameters as JAX-layout numpy arrays."""
    return tree_from_named({k: p.detach().cpu().numpy()
                            for k, p in model.named_parameters()})
