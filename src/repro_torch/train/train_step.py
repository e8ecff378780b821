"""Train and eval step builders (port of repro/train/train_step.py).

`make_train_step` wires loss -> gradients -> in-place optimizer update;
with `microbatches` > 1 it accumulates gradients over slices of the
batch (the reference's memory knob): the activations of one microbatch
are live at a time, and the optimizer still takes one step over the
whole batch.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.train.optim import Optimizer


def _split(batch: dict, microbatches: int) -> list:
    """The batch's leading axis in `microbatches` equal slices, in order."""
    out = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {k!r} of {b} does not split into "
                             f"{microbatches} microbatches")
        for mb, part in zip(out, x.split(b // microbatches)):
            mb[k] = part
    return out


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    microbatches: int = 1):
    """loss_fn(model, batch) -> (loss, metrics dict).

    Returns train_step(model, opt_state, step, batch) ->
    (model, opt_state, metrics). The model's parameters and the optimizer
    state are updated in place; metrics hold device tensors (reading one
    waits for the step). With microbatches > 1, the batch's leading axis
    is split, each slice's gradients are added as `g.float() /
    microbatches` into f32 zeros in slice order, and the loss and the
    metrics are the slices' means, as in the reference's scan."""
    def grads_of(model, params, batch):
        loss, metrics = loss_fn(model, batch)
        return loss, metrics, torch.autograd.grad(loss, list(params.values()))

    def train_step(model: nn.Module, opt_state, step: int, batch):
        params = dict(model.named_parameters())
        if microbatches == 1:
            loss, metrics, grads = grads_of(model, params, batch)
            grads = dict(zip(params, grads))
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss, parts = 0.0, []
            for mb in _split(batch, microbatches):
                mb_loss, mb_metrics, mb_grads = grads_of(model, params, mb)
                for acc, g in zip(grads.values(), mb_grads):
                    acc.add_(g.float() / microbatches)
                del mb_grads
                loss = loss + mb_loss.detach() / microbatches
                parts.append(mb_metrics)
            metrics = {k: torch.stack([m[k].detach() for m in parts]).mean()
                       for k in parts[0]}
        _, opt_state, stats = optimizer.update(grads, opt_state, params,
                                               step)
        out = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
        out.update(stats)
        out["loss"] = loss.detach()
        return model, opt_state, out
    return train_step


def make_eval_step(loss_fn: Callable):
    """eval_step(model, batch) -> the loss_fn's metrics and its `loss`,
    without gradients."""
    @torch.no_grad()
    def eval_step(model: nn.Module, batch):
        loss, metrics = loss_fn(model, batch)
        out = dict(metrics)
        out["loss"] = loss
        return out
    return eval_step
