"""Meta DLRM (Naumov et al.), the paper's Criteo workload, in PyTorch.

bottom-MLP(dense) -> embedding bags (one per sparse feature) -> pairwise
dot interaction -> top-MLP -> CTR logit. Port of repro/models/dlrm.py on
one device: the embedding bags and the interaction both run through the
hand-written kernels (repro_torch.kernels.ops), forward and backward.

Parameters cross between the packages as numpy in the JAX layout,
`{"tables": (F, V, D), "bottom"/"top": ({"w": (in, out), "b": (out,)},
...)}`, through `params_from_numpy` / `params_to_numpy`; `nn.Linear`
holds each `w` transposed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import DLRMConfig
from repro_torch.kernels import ops
from repro_torch.models.embedding import multifeature_bag
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


# ------------------------------------------------------ numpy exchange ---
def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameters -> a `DLRM.state_dict()` (CPU
    tensors; `load_state_dict` copies them to the model's device)."""
    out = {"tables": torch.from_numpy(np.require(params["tables"],
                                                 requirements="W"))}
    for part in ("bottom", "top"):
        for i, layer in enumerate(params[part]):
            out[f"{part}.{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(layer["w"]).T, order="C"))
            out[f"{part}.{i}.bias"] = torch.from_numpy(
                np.asarray(layer["b"]).copy())
    return out


def params_to_numpy(model: DLRM) -> dict:
    """The model's parameters as JAX-layout numpy arrays."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()
    return {"tables": host(model.tables),
            **{part: tuple({"w": np.ascontiguousarray(host(lin.weight).T),
                            "b": host(lin.bias)}
                           for lin in getattr(model, part))
               for part in ("bottom", "top")}}
