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


# The fused kernel computes the same function with the same left fold
# over j (bit-equal to both CUDA forwards): its plain version is this one.
embedding_bag_fused_ref = embedding_bag_ref


def embedding_bag_bwd_ref(d_out: torch.Tensor, ids: torch.Tensor,
                          num_rows: int, *, combiner: str = "sum",
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """d_out (B, F, D); ids (B, F, bag) -> the dense table gradient
    (F, num_rows, D) in `dtype`, the tables' (f32 or bf16): each bag
    slot's row receives d_out[b, f] (divided by `bag` for "mean"), summed
    in f32 and rounded to `dtype` once. The sums are taken over the rows
    the ids touch only, so no f32 temporary of the table's size is made
    (a bf16 table of the DLRM-Criteo reference is 27.9 GB)."""
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    g = d_out.float()
    if combiner == "mean":
        g = _div(g, bag)
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    flat = (feat * num_rows + ids.long()).reshape(-1)
    upd = g[:, :, None, :].expand(b, f, bag, d).reshape(-1, d)
    rows, slot = torch.unique(flat, return_inverse=True)
    sums = torch.zeros((rows.numel(), d), dtype=torch.float32,
                       device=d_out.device)
    sums.index_add_(0, slot, upd)
    grad = torch.zeros((f * num_rows, d), dtype=dtype, device=d_out.device)
    grad[rows] = sums.to(dtype)
    return grad.view(f, num_rows, d)


def _shard(ids: torch.Tensor, row0: int, v_loc: int):
    """(ids moved into the shard [row0, row0 + v_loc), clamped into it;
    the mask of the ids that fall in it)."""
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v_loc)
    return lid.clamp(0, max(v_loc - 1, 0)), ok


def embedding_bag_local_ref(tables: torch.Tensor, ids: torch.Tensor,
                            row0: int) -> torch.Tensor:
    """The kernel's local-rows mode: tables (F, v_loc, D) are rows [row0,
    row0 + v_loc) of row-sharded tables; ids (B, F, bag) -> (B, F, D) f32,
    the bag's rows that fall in the shard summed in an explicit left fold
    (j ascending, from 0; an id outside reads 0), as the kernel sums."""
    f = tables.shape[0]
    lid, ok = _shard(ids, row0, tables.shape[1])
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    rows = tables[feat, lid].float()                    # (B, F, bag, D)
    rows = torch.where(ok[..., None], rows, torch.zeros((), device=rows.device))
    out = torch.zeros(rows.shape[:2] + rows.shape[3:], dtype=torch.float32,
                      device=rows.device)
    for j in range(ids.shape[-1]):
        out = out + rows[:, :, j]
    return out


def embedding_bag_local_bwd_ref(d_out: torch.Tensor, ids: torch.Tensor,
                                row0: int, v_loc: int, *,
                                dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """The local-rows scatter: d_out (B, F, D) -> the gradient of rows
    [row0, row0 + v_loc) (F, v_loc, D) in `dtype`, each slot whose id
    falls in the shard adding d_out[b, f] (the sum's gradient), summed in
    f32 and rounded once."""
    b, f, bag = ids.shape
    d = d_out.shape[-1]
    lid, ok = _shard(ids, row0, v_loc)
    feat = torch.arange(f, device=ids.device).view(1, f, 1)
    flat = (feat * v_loc + lid)[ok]
    upd = d_out.float()[:, :, None, :].expand(b, f, bag, d)[ok]
    rows, slot = torch.unique(flat, return_inverse=True)
    sums = torch.zeros((rows.numel(), d), dtype=torch.float32,
                       device=d_out.device)
    sums.index_add_(0, slot, upd)
    grad = torch.zeros((f * v_loc, d), dtype=dtype, device=d_out.device)
    grad[rows] = sums.to(dtype)
    return grad.view(f, v_loc, d)


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
    strict lower triangle: summed in f32 and rounded once to feats'
    dtype (f32 or bf16, d_out in the same), as the kernel rounds."""
    b, f, _ = feats.shape
    ii, jj = tril_pairs(f, feats.device)
    s = torch.zeros((b, f, f), dtype=torch.float32, device=feats.device)
    s[:, ii, jj] = d_out.float()
    return torch.bmm(s + s.transpose(1, 2), feats.float()).to(feats.dtype)


def sage_mean_ref(neigh: torch.Tensor) -> torch.Tensor:
    """neigh (B, F, D) -> mean over F (B, D) f32: an explicit left fold
    over f ascending, then an IEEE division by F, as the kernel does (the
    f32 aggregate is bit-equal to the CUDA kernel's)."""
    out = neigh[:, 0].float()
    for f in range(1, neigh.shape[1]):
        out = out + neigh[:, f].float()
    return _div(out, neigh.shape[1])


def sage_aggregate_ref(neigh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """neigh (B, F, D); w (D, H) -> mean over F, then an f32 product with
    w: (B, H) in neigh's dtype."""
    return (sage_mean_ref(neigh) @ w.float()).to(neigh.dtype)


def sage_aggregate_bwd_ref(d_out: torch.Tensor, w: torch.Tensor,
                           agg, f: int, *, need_neigh: bool = True):
    """Gradients of `sage_aggregate_ref` from d_out (B, H): (d_neigh
    (B, F, D) f32 = (d_out w^T) / F broadcast over f, or None unless
    `need_neigh`; d_w (D, H) f32 = agg^T d_out, or None when `agg`, the
    forward's (B, D) aggregate, is None)."""
    g = d_out.float()
    d_w = None if agg is None else agg.t() @ g
    d_neigh = None
    if need_neigh:
        d_agg = _div(g @ w.float().t(), f)
        d_neigh = d_agg[:, None, :].expand(
            d_agg.shape[0], f, d_agg.shape[1]).contiguous()
    return d_neigh, d_w
