"""Adagrad, the classic DLRM embedding optimizer, in PyTorch (port of
the adagrad path of repro/train/optim.py).

API, as in the JAX package:

    opt = make_optimizer("adagrad", lr=0.02)
    state = opt.init(params)                      # params: {name: tensor}
    params, state, stats = opt.update(grads, state, params, step)

Unlike JAX, the update runs in place on the parameters and the state,
and consumes the gradients (they are overwritten), so the dense
(F, V, D) table, its gradient and its accumulator each exist once.
Tensors of more than 2^26 elements with three or more axes are updated
one slice of axis 0 at a time: at the DLRM-Criteo widths the transient
is one feature's (V, D) f32 slice, 537 MB, not 14 GB.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

_CHUNK_ELEMS = 1 << 26


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, step) -> (p, s, stats)


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Axis-0 slices of same-shaped tensors when they are huge stacked
    tensors, else the tensors themselves."""
    p = ts[0]
    if p.dim() < 3 or p.numel() <= _CHUNK_ELEMS:
        yield ts
        return
    for i in range(p.shape[0]):
        yield tuple(t[i] for t in ts)


# ------------------------------------------------------------ schedules ----
def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to base_lr, then cosine decay to min_frac*base_lr;
    computed in float32 as the JAX schedule is."""
    f32 = np.float32

    def lr_at(step) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(base_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(base_lr) * (f32(min_frac) + f32((1 - min_frac) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * frac)))
        return float(f32(cos))
    return lr_at


def constant_lr(base_lr: float) -> Callable[[int], float]:
    return lambda step: float(np.float32(base_lr))


# ------------------------------------------------------------- norms -------
def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every tensor (f32 accumulation, no full f32 copy)."""
    total = None
    for t in tensors:
        for (sl,) in _slices(t):
            sq = torch.linalg.vector_norm(sl, dtype=torch.float32).square()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


# -------------------------------------------------------------- adagrad ----
def adagrad(lr_fn: Callable[[int], float], eps: float = 1e-10) -> Optimizer:
    """p -= lr * g / (sqrt(acc + g^2) + eps), acc += g^2, elementwise."""
    def init(params: Dict[str, torch.Tensor]):
        return {"acc": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = global_norm(grads.values())
        lr = lr_fn(step)
        for k, p in params.items():
            for p_s, g_s, a_s in _slices(p, grads[k], state["acc"][k]):
                g32 = g_s.float()
                a_s.addcmul_(g32, g32)
                denom = a_s.sqrt().add_(eps)
                # (lr * g) / denom, the JAX evaluation order, in g's memory
                p_s.sub_(g32.mul_(lr).div_(denom))
        return params, state, {"lr": lr, "grad_norm": gn}
    return Optimizer("adagrad", init, update)


# -------------------------------------------------------------- factory ----
def make_optimizer(name: str, *, lr: float = 1e-3, total_steps: int = 10000,
                   warmup: int = 100, **kw) -> Optimizer:
    """The JAX factory's contract (warmup-cosine schedule); only adagrad,
    the closed loop's optimizer, is ported so far."""
    if name != "adagrad":
        raise ValueError(f"optimizer {name!r} is not ported to repro_torch; "
                         f"the port has 'adagrad'")
    return adagrad(warmup_cosine(lr, warmup, total_steps), **kw)
