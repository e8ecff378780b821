"""Train and eval step builders (port of repro/train/train_step.py).

`make_train_step` wires loss -> gradients -> in-place optimizer update;
with `microbatches` > 1 it accumulates gradients over slices of the
batch (the reference's memory knob): the activations of one microbatch
are live at a time, and the optimizer still takes one step over the
whole batch.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.common.spans import span
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
                    microbatches: int = 1,
                    grad_fn: Optional[Callable] = None):
    """loss_fn(model, batch) -> (loss, metrics dict). `grad_fn({name:
    gradient}) -> {name: gradient}`, where given, runs between the
    gradients and the update (on a mesh: their reduction over ranks).

    Returns train_step(model, opt_state, step, batch) ->
    (model, opt_state, metrics). The model's parameters and the optimizer
    state are updated in place; metrics hold device tensors (reading one
    waits for the step). With microbatches > 1, the batch's leading axis
    is split, each slice's gradients are added as `g.float() /
    microbatches` into f32 zeros in slice order, and the loss and the
    metrics are the slices' means, as in the reference's scan.

    Each microbatch's loss runs in the span `step.forward` and its
    gradients (and their sum into the accumulator) in `step.backward`;
    the update runs in `step.optim` (`common/spans`). `grad_fn` runs
    in none."""
    def grads_of(model, params, batch, acc=None):
        """(loss, metrics, gradients); with `acc`, the gradients are
        added into it as a microbatch's share and not returned."""
        with span("step.forward"):
            loss, metrics = loss_fn(model, batch)
        with span("step.backward"):
            grads = torch.autograd.grad(loss, list(params.values()))
            if acc is not None:
                for a, g in zip(acc.values(), grads):
                    a.add_(g.float() / microbatches)
                grads = None
        return loss, metrics, grads

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
                mb_loss, mb_metrics, _ = grads_of(model, params, mb, grads)
                loss = loss + mb_loss.detach() / microbatches
                parts.append(mb_metrics)
            metrics = {k: torch.stack([m[k].detach() for m in parts]).mean()
                       for k in parts[0]}
        if grad_fn is not None:
            grads = grad_fn(grads)
        with span("step.optim"):
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
