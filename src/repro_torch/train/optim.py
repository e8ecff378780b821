"""SGD with momentum, Adagrad (the classic DLRM embedding optimizer),
row-wise adagrad, Adam(W) and Adafactor (kimi-k2's: factored second
moments, O(rows + cols) state a matrix), in PyTorch (port of
repro/train/optim.py).

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

On a mesh each rank updates its own shards. `norm_groups` ({name:
process group}) names the sharded gradients, whose squares are summed
over their group so that the global norm (clipping, `grad_norm`) is the
whole gradient's on every rank; row-wise adagrad's `global_numel`
({name: elements}) decides row-wise or elementwise by the whole
tensor's size, as the reference's global arrays do.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train import collectives as coll

_CHUNK_ELEMS = 1 << 26


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, step) -> (p, s, stats)


def _slices(*ts: torch.Tensor, numel: Optional[int] = None
            ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Axis-0 slices of tensors that share axis 0 (a parameter, its
    gradient and its state, which may lack the last axis) when the first
    is a huge stacked tensor (`numel`: its whole size, where it is a
    shard), else the tensors themselves."""
    p = ts[0]
    if p.dim() < 3 or (p.numel() if numel is None else numel) \
            <= _CHUNK_ELEMS:
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
def global_norm(tensors, groups: Optional[dict] = None) -> torch.Tensor:
    """L2 norm over every tensor (f32 accumulation, no full f32 copy).
    `tensors` is an iterable, or a dict of named tensors; a name in
    `groups` is a shard, whose square is summed over its process group."""
    named = tensors.items() if isinstance(tensors, dict) \
        else ((None, t) for t in tensors)
    total = None
    for name, t in named:
        sq_t = None
        for (sl,) in _slices(t):
            sq = torch.linalg.vector_norm(sl, dtype=torch.float32).square()
            sq_t = sq if sq_t is None else sq_t + sq
        if groups and name in groups:
            sq_t = sq_t.clone()
            dist.all_reduce(sq_t, group=groups[name])
        total = sq_t if total is None else total + sq_t
    return torch.sqrt(total)


# ------------------------------------------------------------- clipping ----
@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        groups: Optional[dict] = None):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-9)) in
    place, as the JAX package does (in f32, on the device: no host
    sync; a bf16 gradient's product rounded once). Returns (grads,
    global norm before clipping)."""
    gn = global_norm(grads, groups)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, gn


def _clipped_norm(grads: Dict[str, torch.Tensor], grad_clip: float,
                  groups: Optional[dict] = None):
    """The global norm of the gradients before clipping, and the
    gradients clipped to `grad_clip` in place (0: not clipped)."""
    if grad_clip:
        return clip_by_global_norm(grads, grad_clip, groups)[1]
    return global_norm(grads, groups)


# ------------------------------------------------------------------ sgd ----
def sgd(lr_fn: Callable[[int], float], momentum: float = 0.9,
        grad_clip: float = 0.0,
        norm_groups: Optional[dict] = None) -> Optimizer:
    """mu = momentum mu + g, p -= lr mu, with f32 momentum `mu`; the
    gradients are clipped to `grad_clip` global norm first (0: off)."""
    def init(params: Dict[str, torch.Tensor]):
        return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _clipped_norm(grads, grad_clip, norm_groups)
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
            grad_clip: float = 0.0,
            norm_groups: Optional[dict] = None) -> Optimizer:
    """p -= lr * g / (sqrt(acc + g^2) + eps), acc += g^2, elementwise;
    the gradients are clipped to `grad_clip` global norm first (0:
    off)."""
    def init(params: Dict[str, torch.Tensor]):
        return {"acc": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _clipped_norm(grads, grad_clip, norm_groups)
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
                    rowwise_min_elems: int = 1 << 24,
                    norm_groups: Optional[dict] = None,
                    global_numel: Optional[dict] = None) -> Optimizer:
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
    def _rowwise(k: str, p: torch.Tensor) -> bool:
        n = (global_numel or {}).get(k, p.numel())
        return p.dim() >= 2 and n > rowwise_min_elems

    def init(params: Dict[str, torch.Tensor]):
        return {"acc": {k: torch.zeros(p.shape[:-1] if _rowwise(k, p)
                                       else p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = global_norm(grads, norm_groups)
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
         state_dtype: torch.dtype = torch.float32,
         norm_groups: Optional[dict] = None) -> Optimizer:
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
        gn = _clipped_norm(grads, grad_clip, norm_groups)
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


# ------------------------------------------------------------ adafactor ----
def _mean(x: torch.Tensor, dim: Optional[int], n: int, group):
    """The mean of x over `dim` (None: every element) of a tensor split
    over `group` along it, `n` the whole's count; x.mean where it is
    not split."""
    if group is None:
        return x.mean() if dim is None else x.mean(dim)
    part = x.sum() if dim is None else x.sum(dim)
    return coll.all_reduce(part, group) / n


def adafactor(lr_fn: Callable[[int], float], decay: float = 0.8,
              eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0,
              min_dim_factored: int = 128,
              norm_groups: Optional[dict] = None,
              shards: Optional[dict] = None) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) as the JAX package has it, with
    no first moment: a parameter whose last two dims are both at least
    `min_dim_factored` keeps factored second moments, a row mean `vr`
    (shape[:-1]) and a column mean `vc` (shape[:-2] + shape[-1:]); any
    other keeps a full `v`. The update is clipped to RMS
    `clip_threshold` and scaled by the parameter's RMS (at least eps2),
    each over the whole tensor, or over one slice of axis 0 for a huge
    stacked tensor (`_slices`, the reference's `_chunked`). On a mesh,
    `shards` (see the module docstring) names the parameters that are
    blocks of a whole, whose statistics are the whole's."""
    f32 = np.float32
    shards = shards or {}

    def _gshape(k: str, p: torch.Tensor) -> tuple:
        return tuple(shards[k][0]) if k in shards else tuple(p.shape)

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_factored \
            and shape[-2] >= min_dim_factored

    def init(params: Dict[str, torch.Tensor]):
        def per(k, p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(_gshape(k, p)):
                vc = p.shape[:-2] + p.shape[-1:]
                if k in shards and shards[k][3] is not None:
                    n = coll.group_size(shards[k][3])
                    vc = vc[:-1] + (vc[-1] // n,)
                return {"vr": z(p.shape[:-1]), "vc": z(vc)}
            return {"v": z(p.shape)}
        return {"f": {k: per(k, p) for k, p in params.items()}}

    def _apply(p_s, u, lr, n, group):
        # u / max(1, rms(u) / clip), then p - (lr * max(eps2, rms(p))) u,
        # in f32, rounded once into p's dtype
        rms_u = torch.sqrt(_mean(u.square(), None, n, group) + eps1)
        u.div_(torch.clamp(rms_u / clip_threshold, min=1.0))
        p32 = p_s.float()
        scale = torch.clamp(torch.sqrt(_mean(p32.square(), None, n, group)),
                            min=eps2)
        p_s.copy_(p32 - (lr * scale) * u)

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = global_norm(grads, norm_groups)
        lr = lr_fn(step)
        t = f32(step) + f32(1.0)
        beta = f32(1.0) - t ** f32(-decay)
        b, nb = float(beta), float(f32(1.0) - beta)
        for k, p in params.items():
            s = state["f"][k]
            gshape = _gshape(k, p)
            _, dg, allg, vcg = shards.get(k, (gshape, (None,) * p.dim(),
                                              None, None))
            numel = int(np.prod(gshape))
            st = (s["vr"], s["vc"]) if "vr" in s else (s["v"],)
            for sl in _slices(p, grads[k], *st, numel=numel):
                p_s, g_s = sl[:2]
                cut = p_s.dim() < p.dim()      # one slice of axis 0
                n = numel // gshape[0] if cut else numel
                g32 = g_s.float()
                if "vr" in s:
                    vr, vc = sl[2:]
                    g2 = g32.square() + eps1
                    vr.mul_(b).add_(_mean(g2, -1, gshape[-1], dg[-1]) * nb)
                    # vc in the parameter's layout: its last dim whole
                    # where vc splits it further
                    vcw = coll.gather_dim(vc, vcg, -1).mul_(b).add_(
                        _mean(g2, -2, gshape[-2], dg[-2]) * nb)
                    vc.copy_(coll.slice_dim(vcw, vcg, -1))
                    r = vr / torch.clamp(_mean(vr, -1, gshape[-2], dg[-2])
                                         .unsqueeze(-1), min=eps1)
                    u = g32 / (torch.sqrt(r)[..., None]
                               * torch.sqrt(vcw)[..., None, :] + eps1)
                else:
                    (v,) = sl[2:]
                    v.mul_(b).add_((g32.square() + eps1) * nb)
                    u = g32 / (torch.sqrt(v) + eps1)
                _apply(p_s, u, lr, n, allg)
        return params, state, {"lr": lr, "grad_norm": gn}
    return Optimizer("adafactor", init, update)


# -------------------------------------------------------------- factory ----
def make_optimizer(name: str, *, lr: float = 1e-3, total_steps: int = 10000,
                   warmup: int = 100, **kw) -> Optimizer:
    """The JAX factory's contract (warmup-cosine schedule): sgd, adagrad
    (the closed loop's), rowwise_adagrad (wide-deep's and the DLRM's),
    adam (GraphSAGE's, the sequence models' and the LMs') and adafactor
    (kimi-k2's)."""
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
        return adafactor(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}; the port has 'sgd', "
                     f"'adagrad', 'rowwise_adagrad', 'adam' and "
                     f"'adafactor'")
