"""The train step: loss -> gradients -> in-place optimizer update (port of
make_train_step in repro/train/train_step.py, without microbatching).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.train.optim import Optimizer


def make_train_step(loss_fn: Callable, optimizer: Optimizer):
    """loss_fn(model, batch) -> (loss, metrics dict).

    Returns train_step(model, opt_state, step, batch) ->
    (model, opt_state, metrics). The model's parameters and the optimizer
    state are updated in place; metrics hold device tensors (reading one
    waits for the step)."""
    def train_step(model: nn.Module, opt_state, step: int, batch):
        params = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _, opt_state, stats = optimizer.update(grads, opt_state, params,
                                               step)
        out = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
        out.update(stats)
        out["loss"] = loss.detach()
        return model, opt_state, out
    return train_step
