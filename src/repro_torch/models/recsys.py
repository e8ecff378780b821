"""MLP helpers and the CTR loss shared by the recsys models (port of
repro/models/recsys.py:33-58)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn


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
