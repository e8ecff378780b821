"""Plain PyTorch versions of every kernel, forward and backward.

The CPU path of the kernels' wrappers (repro_torch.kernels.ops) runs
these, the CPU tests hold them against the JAX package, and
`chip_smoke.py` holds each CUDA kernel against them on the card. They
repeat the kernels' arithmetic and are no yardstick of speed.
"""
from __future__ import annotations

import torch


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as an IEEE division on every device, as the kernels divide.
    (A Python-number divisor would let PyTorch's CUDA path multiply by a
    rounded reciprocal instead, one bit off for n = 3.)"""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def embedding_bag_ref(tables: torch.Tensor, ids: torch.Tensor, *,
                      combiner: str = "sum") -> torch.Tensor:
    """tables (F, V, D); ids (B, F, bag) -> (B, F, D) f32.

    Sums j in ascending order in an explicit left fold, in f32, then
    divides by `bag` for "mean": the f32 result is bit-equal to the CUDA
    kernel's. Ids must lie in [0, V) (out-of-range ids raise here)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    f = tables.shape[0]
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    rows = tables[feat, ids.long()]                     # (B, F, bag, D)
    out = rows[:, :, 0].float()
    for j in range(1, ids.shape[-1]):
        out = out + rows[:, :, j].float()
    if combiner == "mean":
        out = _div(out, ids.shape[-1])
    return out


def embedding_bag_bwd_ref(d_out: torch.Tensor, ids: torch.Tensor,
                          num_rows: int, *,
                          combiner: str = "sum") -> torch.Tensor:
    """d_out (B, F, D); ids (B, F, bag) -> the dense table gradient
    (F, num_rows, D) f32: each bag slot's row receives d_out[b, f]
    (divided by `bag` for "mean")."""
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    g = d_out.float()
    if combiner == "mean":
        g = _div(g, bag)
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    flat = (feat * num_rows + ids.long()).reshape(-1)
    upd = g[:, :, None, :].expand(b, f, bag, d).reshape(-1, d)
    grad = torch.zeros((f * num_rows, d), dtype=torch.float32,
                       device=d_out.device)
    grad.index_add_(0, flat, upd)
    return grad.view(f, num_rows, d)


def tril_pairs(f: int, device=None):
    """(ii, jj) of the strict lower triangle, np.tril_indices(f, -1)
    order: pair p = i(i-1)/2 + j for i > j."""
    return torch.tril_indices(f, f, offset=-1, device=device).unbind(0)


def dot_interact_ref(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) -> (B, F(F-1)/2) lower-triangle pairwise dots, f32
    accumulation, in the input dtype."""
    x = feats.float()
    gram = torch.bmm(x, x.transpose(1, 2))              # (B, F, F)
    ii, jj = tril_pairs(feats.shape[1], feats.device)
    return gram[:, ii, jj].to(feats.dtype)


def dot_interact_bwd_ref(d_out: torch.Tensor,
                         feats: torch.Tensor) -> torch.Tensor:
    """dFeats[b] = (S + S^T) feats[b], S scattering d_out[b] into the
    strict lower triangle; in the input dtype."""
    b, f, _ = feats.shape
    ii, jj = tril_pairs(f, feats.device)
    s = torch.zeros((b, f, f), dtype=torch.float32, device=feats.device)
    s[:, ii, jj] = d_out.float()
    return torch.bmm(s + s.transpose(1, 2), feats.float()).to(feats.dtype)
