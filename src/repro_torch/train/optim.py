"""SGD with momentum, Adagrad (the classic DLRM embedding optimizer),
row-wise adagrad and Adam(W), in PyTorch (port of repro/train/optim.py
but its Adafactor, which waits with the LLM family: ROADMAP.md queue 1,
item 8).

API, as in the JAX package:

    opt = make_optimizer("adagrad", lr=0.02)  # or "sgd", "adam", ...
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
    """Axis-0 slices of tensors that share axis 0 (a parameter, its
    gradient and its state, which may lack the last axis) when the first
    is a huge stacked tensor, else the tensors themselves."""
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


# ------------------------------------------------------------- clipping ----
@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)) in
    place, as the JAX package does (in f32, on the device: no host
    sync; a bf16 gradient's product rounded once). Returns (grads,
    global norm before clipping)."""
    gn = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, gn


def _clipped_norm(grads: Dict[str, torch.Tensor], grad_clip: float):
    """The global norm of the gradients before clipping, and the
    gradients clipped to `grad_clip` in place (0: not clipped)."""
    if grad_clip:
        return clip_by_global_norm(grads, grad_clip)[1]
    return global_norm(grads.values())


# ------------------------------------------------------------------ sgd ----
def sgd(lr_fn: Callable[[int], float], momentum: float = 0.9,
        grad_clip: float = 0.0) -> Optimizer:
    """mu = momentum mu + g, p -= lr mu, with f32 momentum `mu`; the
    gradients are clipped to `grad_clip` global norm first (0: off)."""
    def init(params: Dict[str, torch.Tensor]):
        return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _clipped_norm(grads, grad_clip)
        lr = lr_fn(step)
        for k, p in params.items():
            for p_s, g_s, m_s in _slices(p, grads[k], state["mu"][k]):
                m_s.mul_(momentum).add_(g_s.float())
                # p - lr * mu computed in f32, rounded once into p's dtype
                p_s.sub_(m_s * lr)
        return params, state, {"lr": lr, "grad_norm": gn}
    return Optimizer("sgd", init, update)


# -------------------------------------------------------------- adagrad ----
def adagrad(lr_fn: Callable[[int], float], eps: float = 1e-10,
            grad_clip: float = 0.0) -> Optimizer:
    """p -= lr * g / (sqrt(acc + g^2) + eps), acc += g^2, elementwise;
    the gradients are clipped to `grad_clip` global norm first (0:
    off)."""
    def init(params: Dict[str, torch.Tensor]):
        return {"acc": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _clipped_norm(grads, grad_clip)
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


# ------------------------------------------------------ rowwise adagrad ----
def rowwise_adagrad(lr_fn: Callable[[int], float], eps: float = 1e-10,
                    rowwise_min_elems: int = 1 << 24) -> Optimizer:
    """FBGEMM-style row-wise adagrad, as the JAX package has it: a tensor
    of two or more axes and more than `rowwise_min_elems` elements keeps
    one accumulator per row (over its last axis), acc += mean(g^2), and
    p -= lr * g * rsqrt(acc + eps); every other tensor is elementwise,
    acc += g^2, p -= lr * g * rsqrt(acc + eps).

    The rule goes by shape alone, quirk included: wide-deep's (F, V) wide
    table is "row-wise" over its vocab axis, one accumulator a feature.
    It reads each tensor in its own layout, so an `nn.Linear` weight,
    held (out, in), would take rows over the other axis than the JAX
    (in, out) weight; no linear layer of the ported models comes near
    2^24 elements (wide-deep's largest is 1293 x 1024).

    A bf16 parameter (the DLRM-Criteo reference's) takes its bf16
    gradient as the reference's leaf does: the update in f32 and one
    rounding into the parameter's dtype, a slice of axis 0 at a time for
    a stacked tensor, so that its f32 temporaries are one feature's."""
    def _rowwise(p: torch.Tensor) -> bool:
        return p.dim() >= 2 and p.numel() > rowwise_min_elems

    def init(params: Dict[str, torch.Tensor]):
        return {"acc": {k: torch.zeros(p.shape[:-1] if _rowwise(p)
                                       else p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = global_norm(grads.values())
        lr = lr_fn(step)
        for k, p in params.items():
            acc = state["acc"][k]
            rowwise = acc.shape != p.shape
            for p_s, g_s, a_s in _slices(p, grads[k], acc):
                g32 = g_s.float()
                if rowwise:
                    a_s.add_(g32.square().mean(dim=-1))
                    scale = torch.rsqrt(a_s + eps).unsqueeze(-1)
                else:
                    a_s.addcmul_(g32, g32)
                    scale = torch.rsqrt(a_s + eps)
                # (lr * g) * scale, the JAX evaluation order, in g's memory
                upd = g32.mul_(lr).mul_(scale)
                if p_s.dtype == torch.float32:
                    p_s.sub_(upd)
                else:
                    p_s.copy_(p_s.float().sub_(upd))
        return params, state, {"lr": lr, "grad_norm": gn}
    return Optimizer("rowwise_adagrad", init, update)


# ----------------------------------------------------------------- adam ----
def adam(lr_fn: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
         eps: float = 1e-8, weight_decay: float = 0.0,
         grad_clip: float = 1.0,
         state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with the JAX package's defaults and evaluation order:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / bc1) / (sqrt(v / bc2) + eps) [+ lr wd p], with the bias
    corrections bc = 1 - b^t, t = step + 1, computed in float32. The
    gradients are clipped to `grad_clip` global norm first (0: off). The
    update runs in place on the parameters and the state, and consumes
    the gradients. `state_dtype=torch.bfloat16` halves the state's
    memory (the reference's large-model knob): m and v are read into
    f32, updated and used there, and stored by rounding after the
    update."""
    f32 = np.float32

    def init(params: Dict[str, torch.Tensor]):
        return {"m": {k: torch.zeros_like(p, dtype=state_dtype)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=state_dtype)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _clipped_norm(grads, grad_clip)
        lr = lr_fn(step)
        t = f32(step) + f32(1.0)
        bc1 = float(f32(1.0) - f32(b1) ** t)
        bc2 = float(f32(1.0) - f32(b2) ** t)
        for k, p in params.items():
            for p_s, g_s, m_s, v_s in _slices(p, grads[k], state["m"][k],
                                              state["v"][k]):
                g32 = g_s.float()
                # f32 state is updated in place; other state through f32
                m32, v32 = m_s.float(), v_s.float()
                m32.mul_(b1).add_(g32 * (1 - b1))
                v32.mul_(b2).add_(g32.square_().mul_(1 - b2))
                denom = (v32 / bc2).sqrt_().add_(eps)
                upd = (m32 / bc1).mul_(lr).div_(denom)
                if weight_decay:
                    upd.add_(p_s.float() * (lr * weight_decay))
                # p - upd computed in f32, rounded once into p's dtype
                p_s.sub_(upd)
                if m32 is not m_s:
                    m_s.copy_(m32)
                    v_s.copy_(v32)
        return params, state, {"lr": lr, "grad_norm": gn}
    return Optimizer("adam", init, update)


# -------------------------------------------------------------- factory ----
def make_optimizer(name: str, *, lr: float = 1e-3, total_steps: int = 10000,
                   warmup: int = 100, **kw) -> Optimizer:
    """The JAX factory's contract (warmup-cosine schedule): sgd, adagrad
    (the closed loop's), rowwise_adagrad (wide-deep's and the DLRM's)
    and adam (GraphSAGE's and the sequence models')."""
    lr_fn = warmup_cosine(lr, warmup, total_steps)
    if name == "sgd":
        return sgd(lr_fn, **kw)
    if name == "adagrad":
        return adagrad(lr_fn, **kw)
    if name == "rowwise_adagrad":
        return rowwise_adagrad(lr_fn, **kw)
    if name == "adam":
        return adam(lr_fn, **kw)
    if name == "adafactor":
        raise ValueError("optimizer 'adafactor' is not ported to "
                         "repro_torch yet: ROADMAP.md queue 1, item 8 (LLM "
                         "family; only kimi-k2-1t-a32b uses it)")
    raise ValueError(f"unknown optimizer {name!r}; the port has 'sgd', "
                     f"'adagrad', 'rowwise_adagrad' and 'adam'")
