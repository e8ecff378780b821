"""What the plain references share: the precision of a reading, the
loss, the learning-rate schedule and row-wise adagrad, in plain PyTorch.

Nothing here imports the program. The reference computes in f32 with
TF32 off. Its control computes the same in the nearest precision below
the configuration's: `precision="int8"` quantizes every operand of a
matrix product or dot to int8 with one symmetric scale a tensor, its
largest magnitude over 127 (for a bf16 configuration), `"tf32"` rounds
it to TF32's 10-bit mantissa (for an f32 one). The rounding is straight
through: the backward runs in f32 from the rounded forward values.
Parameters are stored in the configuration's dtype, each update worked
out in f32 and rounded once into it, as the configuration states.
"""
from __future__ import annotations

import numpy as np
import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest (ties away) at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as an operand of a product at `precision` ("f32", "int8",
    "tf32"), straight through."""
    if precision == "f32":
        return x
    if precision == "int8":
        scale = x.detach().abs().max().clamp(min=1e-30) / 127.0
        q = torch.round(x.detach() / scale).clamp(-127, 127) * scale
    elif precision == "tf32":
        q = _tf32(x.detach())
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return x + (q - x.detach())


def linear(x, w, b, precision: str):
    """x (n, in) @ w (out, in)^T + b at `precision`."""
    return rnd(x, precision) @ rnd(w, precision).t() + b


def mlp(x, layers, precision: str, final_act: bool):
    """A dense stack of (w, b) pairs, relu between and, where
    `final_act`, after the last."""
    for i, (w, b) in enumerate(layers):
        x = linear(x, w, b, precision)
        if final_act or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable form."""
    return (torch.clamp(logit, min=0) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit)))).mean()


def lr_at(base_lr: float, warmup: int, total: int, step: int,
          min_frac: float = 0.1) -> float:
    """Linear warm-up to base_lr, then cosine decay to min_frac * base_lr,
    in float32."""
    f32 = np.float32
    s = f32(step)
    if s < warmup:
        return float(f32(base_lr) * s / f32(max(warmup, 1)))
    frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(base_lr) * (f32(min_frac) + f32((1 - min_frac) * 0.5)
                          * (f32(1) + np.cos(f32(np.pi) * frac)))
    return float(f32(cos))


def rowwise(shape, min_elems: int) -> bool:
    """Row-wise adagrad's rule, by a leaf's whole shape: two or more axes
    and more than `min_elems` elements keep one accumulator a row over
    the last axis; any other leaf is elementwise."""
    return len(shape) >= 2 and int(np.prod(shape)) > min_elems


@torch.no_grad()
def adagrad_update(p: torch.Tensor, g: torch.Tensor, acc: torch.Tensor,
                   lr: float, eps: float, row_len: int,
                   store: torch.dtype) -> None:
    """One row-wise adagrad step in place on f32 `p` (held at `store`'s
    values) and `acc`. `row_len` 0: elementwise, acc += g^2; else acc (one
    a row of `p`'s leading axes, or a single one for the whole of `p`)
    += sum(g^2 over the row) / row_len, the row's mean over its whole
    length, touched or not. p -= (lr g) rsqrt(acc + eps), rounded once
    into `store`."""
    g = g.float()
    if row_len == 0:
        acc.add_(g * g)
        scale = torch.rsqrt(acc + eps)
    else:
        if acc.dim() == 0:
            acc.add_((g * g).sum() / row_len)
        else:
            acc.add_((g * g).sum(-1) / row_len)
        scale = torch.rsqrt(acc + eps)
        if acc.dim() > 0:
            scale = scale.unsqueeze(-1)
    p.copy_((p - (g * lr) * scale).to(store).float())
