"""The reference's first training steps: loss, gradients and row-wise
adagrad on the rows the batches read, in plain PyTorch.

A leaf of two or more axes and more than `rowwise_min_elems` elements
keeps one accumulator a row over its last axis (the tables: a row of D;
wide-deep's (F, V) wide table: one a feature, over all V rows, touched
or not); every other leaf is elementwise. A table leaf's parts are one
tensor a feature of the rows read, so a row's accumulator is one
element of its part's and a wide feature's the whole part's.
"""
from __future__ import annotations

import torch

from perfbench.reference import common


def follow(forward, leaves, init: dict, batches: list, opt: dict,
           precision: str, store: torch.dtype, steps: int = 3,
           tables=(), dense=()) -> dict:
    """Train `steps` steps from `init` ({leaf: [f32 parts]}) on
    `batches` ({"ids", "dense", "label"}), the learning rates from step
    `opt["first_step"]` on. Returns the losses, the first step's
    gradient norm a leaf and the norm of each leaf's change over the
    steps; of each row, for the 3-d leaves named in `tables`; and of
    each element (the first gradient's magnitude and the change), for
    the leaves named in `dense`."""
    row_len, accs, params = {}, {}, {}
    for name, shape, _ in leaves:
        parts = [p.clone().requires_grad_(True) for p in init[name]]
        params[name] = parts
        if common.rowwise(shape, opt["rowwise_min_elems"]):
            row_len[name] = shape[-1]
            accs[name] = [torch.zeros(p.shape[:-1], device=p.device)
                          for p in parts]
        else:
            row_len[name] = 0
            accs[name] = [torch.zeros_like(p) for p in parts]
    names = [n for n, _, _ in leaves]
    flat = [p for n in names for p in params[n]]
    losses, grad_norms, row_grads, elem_grads = [], {}, {}, {}
    for s in range(steps):
        batch = batches[s]
        loss = common.bce(forward(params, batch, precision),
                          batch["label"].float())
        grads = torch.autograd.grad(loss, flat)
        losses.append(float(loss.detach()))
        lr = common.lr_at(opt["lr"], opt["warmup"], opt["total_steps"],
                          opt["first_step"] + s)
        i = 0
        for n in names:
            sq = 0.0
            for p, a in zip(params[n], accs[n]):
                g = grads[i]
                i += 1
                sq += float(g.double().square().sum())
                common.adagrad_update(p.data, g, a, lr, opt["eps"],
                                      row_len[n], store)
            if s == 0:
                grad_norms[n] = sq ** 0.5
                if n in tables:
                    row_grads[n] = [g.float().square().sum(-1).sqrt()
                                    for g in grads[i - len(params[n]):i]]
                if n in dense:
                    elem_grads[n] = grads[i - 1].float().abs()
        del grads
    deltas = {n: sum(float((p.detach() - q).double().square().sum())
                     for p, q in zip(params[n], init[n])) ** 0.5
              for n in names}
    row_deltas = {n: [(p.detach() - q).norm(dim=-1)
                      for p, q in zip(params[n], init[n])] for n in tables}
    elem_deltas = {n: params[n][0].detach() - init[n][0] for n in dense}
    return {"losses": losses, "grad_norms": grad_norms, "deltas": deltas,
            "row_grads": row_grads, "row_deltas": row_deltas,
            "elem_grads": elem_grads, "elem_deltas": elem_deltas}
