"""Shared layers of the LM family in PyTorch (port of
repro/models/layers.py): norms, RoPE, activations, chunked attention.

No attention path materializes the S x S score matrix: training and
prefill run `chunked_attention`, a `torch.autograd.Function` whose
forward is an online softmax over KV blocks (the flash-attention
algorithm, the reference's `_flash_fwd`) and whose backward recomputes
each block's scores from the saved (q, k, v, f32 out, lse) (the
reference's `_flash_vjp_bwd`); decode runs `decode_attention`, whose
scores are (B, H, S): linear in the cache. The JAX package computes all
of this in plain jnp, with no Pallas kernel, and so does the port in
plain PyTorch (no `F.scaled_dot_product_attention`, which has no logit
softcap).

On a placement (launch/programs.LMPlacement) with the head dim split
over the model ranks, `chunked_attention(..., group=)` sums each block's
partial q.k scores over the group before the scale, the softcap and the
softmax (its backward sums the partial dO.V products and the
dO.out row sums likewise), and the value contraction leaves each rank
its own slice of the head dim; `decode_attention` with its groups attends
over a cache block split on kv heads, on the head dim (partial scores summed
over the model ranks) and on positions (each rank's running max, sum
and weighted values combined by a log-sum-exp over the data ranks);
`cross_entropy_parts` is the vocab-parallel loss: the max, the sum of
exponentials and the gold logit reduced over the model ranks, the
(B, S, V) logits never gathered.

Dtypes follow the reference: the score and PV products take their
operands in the input dtype and keep f32 results (`_mm_f32`), masks
write NEG_INF, a large finite number, so that no (-inf) - (-inf) is
ever taken.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.train import collectives as coll

NEG_INF = -1e30  # large-but-finite; avoids NaN from (-inf) - (-inf)


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype; plus_one=True gives
    the Gemma convention `x * (1 + w)`."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    w = weight.float()
    y = y * (1.0 + w) if plus_one else y * w
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ----------------------------------------------------------------- rope ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) int. Rotates
    the split halves (not interleaved pairs), in f32."""
    inv = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    ang = positions[..., None].float() * inv               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b, (N, m, k) x (N, k, n), with an f32 result: the
    reference's `preferred_element_type=float32`. bf16 operands on a
    CUDA device go to cuBLAS as they are, accumulating in f32 and
    writing f32 (and so on the meta device, whose dry run plans the
    CUDA route); elsewhere, or with mixed dtypes (JAX promotes to f32),
    the operands are widened to f32 first, which the products of bf16
    values survive exactly."""
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type in (
            "cuda", "meta"):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _block_kv(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, Skv, K, hd) -> (nblk, B * K, chunk, hd), zero-padded tail."""
    b, skv, n_kv, hd = x.shape
    nblk = -(-skv // chunk)
    pad = nblk * chunk - skv
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return (x.view(b, nblk, chunk, n_kv, hd).permute(1, 0, 3, 2, 4)
            .reshape(nblk, b * n_kv, chunk, hd))


def _block_mask(blk: int, chunk: int, skv: int, q_pos: torch.Tensor,
                causal: bool, window: int) -> torch.Tensor:
    """(Sq, chunk) validity mask of kv block `blk`."""
    kv_pos = blk * chunk + torch.arange(chunk, device=q_pos.device)
    valid = (kv_pos < skv)[None, :].expand(q_pos.shape[0], chunk)
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window:
        valid = valid & (q_pos[:, None] - kv_pos[None, :] < window)
    return valid


def _psum_(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` in place (None: x)."""
    if group is not None:
        torch.distributed.all_reduce(x, group=group)
    return x


def _scores(qg: torch.Tensor, kblk: torch.Tensor, shape, scale: float,
            logit_cap: float, invalid: torch.Tensor, group=None):
    """A block's scaled, capped and masked f32 scores (B, K, G, Sq, c):
    qg (B*K, G*Sq, hd), kblk (B*K, c, hd), invalid (Sq, c); with `group`
    the head dim is split over its ranks and the partial products are
    summed over it first."""
    s = _psum_(_mm_f32(qg, kblk.transpose(1, 2)), group).view(shape) \
        .mul_(scale)
    if logit_cap:
        s = softcap(s, logit_cap)
    return s.masked_fill_(invalid, NEG_INF)


class _Flash(torch.autograd.Function):
    """FlashAttention over KV blocks; the backward recomputes each
    block's scores from the saved (q, k, v, out_f32, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool, logit_cap: float,
                chunk: int, scale: float, q_offset: int, group):
        b, sq, h, hd = q.shape
        _, skv, n_kv, _ = k.shape
        g = h // n_kv
        # (B, Sq, K, G, hd) -> (B*K, G*Sq, hd): one GEMM a block
        qg = q.reshape(b, sq, n_kv, g, hd).permute(0, 2, 3, 1, 4) \
            .reshape(b * n_kv, g * sq, hd)
        kb, vb = _block_kv(k, chunk), _block_kv(v, chunk)
        q_pos = q_offset + torch.arange(sq, device=q.device)
        shape = (b, n_kv, g, sq, chunk)
        m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32,
                          device=q.device)
        for blk in range(kb.shape[0]):
            invalid = ~_block_mask(blk, chunk, skv, q_pos, causal, window)
            s = _scores(qg, kb[blk], shape, scale, logit_cap, invalid, group)
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            upd = _mm_f32(p.view(b * n_kv, g * sq, chunk).to(vb.dtype),
                          vb[blk]).view(b, n_kv, g, sq, hd)
            acc = acc.mul_(corr[..., None]).add_(upd)
            m = m_new
            del s, p, upd
        l_safe = torch.clamp(l, min=1e-30)
        out = acc.div_(l_safe[..., None])                 # (B, K, G, Sq, hd)
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, causal, logit_cap, chunk, scale, q_offset, group)
        return _ungroup(out, b, sq, h, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        window, causal, logit_cap, chunk, scale, q_offset, group = ctx.args
        b, sq, h, hd = q.shape
        _, skv, n_kv, _ = k.shape
        g = h // n_kv
        bk = b * n_kv
        qg = q.reshape(b, sq, n_kv, g, hd).permute(0, 2, 3, 1, 4) \
            .reshape(bk, g * sq, hd)
        qg32 = qg.float()        # dk's product is f32 x f32, as in JAX
        # (B, Sq, K, G, hd) -> (B, K, G, Sq, hd), f32
        dog = dout.reshape(b, sq, n_kv, g, hd).permute(0, 2, 3, 1, 4) \
            .float().contiguous()
        # D_i = sum_d dout_i * out_i, with out the saved f32 (pre-cast)
        dsum = _psum_((dog * out).sum(-1), group)         # (B, K, G, Sq)
        dog = dog.view(bk, g * sq, hd)
        kb, vb = _block_kv(k, chunk), _block_kv(v, chunk)
        nblk = kb.shape[0]
        q_pos = q_offset + torch.arange(sq, device=q.device)
        shape = (b, n_kv, g, sq, chunk)
        dq = torch.zeros((bk, g * sq, hd), dtype=torch.float32,
                         device=q.device)
        dk = torch.empty((nblk, bk, chunk, hd), dtype=torch.float32,
                         device=q.device)
        dv = torch.empty_like(dk)
        for blk in range(nblk):
            invalid = ~_block_mask(blk, chunk, skv, q_pos, causal, window)
            s = _scores(qg, kb[blk], shape, scale, logit_cap, invalid, group)
            p = torch.exp(s - lse[..., None])             # (B, K, G, Sq, c)
            dp = _psum_(_mm_f32(dog, vb[blk].transpose(1, 2)), group) \
                .view(shape)
            ds = dp.sub_(dsum[..., None]).mul_(p)
            if logit_cap:
                # d tanh: the capped (and masked) score, as the reference
                ds.mul_(1.0 - (s / logit_cap).square_())
            ds = ds.masked_fill_(invalid, 0.0).mul_(scale)
            ds = ds.view(bk, g * sq, chunk)
            dq.add_(_mm_f32(ds, kb[blk]))
            dk[blk] = _mm_f32(ds.transpose(1, 2), qg32)
            dv[blk] = _mm_f32(p.view(bk, g * sq, chunk).transpose(1, 2),
                              dog)
            del s, p, dp, ds
        dq = dq.view(b, n_kv, g, sq, hd)
        dq = _ungroup(dq, b, sq, h, hd).to(q.dtype)

        def unblock(xb):
            # (nblk, B*K, c, hd) -> (B, Skv, K, hd), the pad trimmed
            xb = xb.view(nblk, b, n_kv, chunk, hd).permute(1, 0, 3, 2, 4) \
                .reshape(b, nblk * chunk, n_kv, hd)
            return xb[:, :skv]
        return (dq, unblock(dk).to(k.dtype), unblock(dv).to(v.dtype),
                None, None, None, None, None, None, None)


def _ungroup(outg: torch.Tensor, b: int, sq: int, h: int,
             hd: int) -> torch.Tensor:
    """(B, K, G, Sq, hd) -> (B, Sq, H, hd)."""
    return outg.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, window: int = 0,
                      causal: bool = True, logit_cap: float = 0.0,
                      chunk: int = 512, scale: Optional[float] = None,
                      group=None) -> torch.Tensor:
    """FlashAttention in plain PyTorch, never materializing S x S.

    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with GQA groups G = H // K.
    `window` > 0 is a sliding window, 0 unbounded; q_offset is the
    absolute position of q[0] (a slice of query positions attends with
    its masks offset by its start). The KV tail is zero-padded to a
    whole chunk, and chunk = min(chunk, Skv). With `group`, q, k and v
    hold this rank's slice of the head dim (the same slice of each), the
    scores are summed over the group and the output is this rank's
    slice; `scale` must then be given (the whole head dim's)."""
    hd = q.shape[-1]
    if group is not None and scale is None:
        raise ValueError("a head dim split over ranks needs its scale")
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, k.shape[1])
    return _Flash.apply(q, k, v, int(window), bool(causal), float(logit_cap),
                        int(chunk), float(scale), int(q_offset), group)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos: int, window: int = 0, logit_cap: float = 0.0,
                     scale: Optional[float] = None, s0: int = 0,
                     dim_group=None, seq_group=None) -> torch.Tensor:
    """Single-token attention over a KV cache, or over this rank's block
    of one.

    q: (B, 1, H, hd); k, v: (B, S, K, hd), cache positions [s0, s0 + S);
    pos: the index of the token being decoded (cache entries > pos are
    unwritten). Scores are (B, K, G, S), softmaxed in f32. On a placement
    q holds the query heads of the block's kv heads; with `dim_group`
    the head dim is split over its ranks: the partial scores are summed
    over it, and the output is this rank's slice of the head dim. With
    `seq_group` the positions are split over its ranks: each takes the
    max, the sum of exponentials and the weighted values of its own
    positions, and a log-sum-exp over the group combines them (a rank
    whose positions are all masked adds nothing)."""
    b, sq, h, hd = q.shape
    assert sq == 1
    _, s, n_kv, _ = k.shape
    g = h // n_kv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b * n_kv, g, hd)                          # (B*K, G, hd)
    kt = k.permute(0, 2, 3, 1).reshape(b * n_kv, hd, s)
    sc = _psum_(_mm_f32(qg, kt), dim_group).view(b, n_kv, g, s) * scale
    sc = softcap(sc, logit_cap)
    kv_pos = s0 + torch.arange(s, device=q.device)
    valid = kv_pos <= pos
    if window:
        valid = valid & (pos - kv_pos < window)
    sc = sc.masked_fill(~valid, NEG_INF)
    vv = v.permute(0, 2, 1, 3).reshape(b * n_kv, s, hd)
    if seq_group is None:
        p = torch.softmax(sc, dim=-1)
        out = _mm_f32(p.view(b * n_kv, g, s).to(v.dtype), vv)
        return out.view(b, 1, h, hd).to(q.dtype)
    m = coll.all_reduce_max(sc.amax(-1), seq_group)          # (B, K, G)
    p = torch.exp(sc - m[..., None])
    l_sum = _psum_(p.sum(-1), seq_group)
    acc = _psum_(_mm_f32(p.view(b * n_kv, g, s).to(v.dtype), vv),
                 seq_group).view(b, n_kv, g, hd)
    out = acc / l_sum[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


# -------------------------------------------------------------- linears ----
def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


def mlp_block(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
              wo: torch.Tensor, act_name: str) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    h = activation(act_name)(dense(x, wg)) * dense(x, wi)
    return dense(h, wo)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       final_cap: float = 0.0,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < 0 are masked out."""
    total, count = cross_entropy_parts(logits, labels, final_cap=final_cap,
                                       z_loss=z_loss)
    return total / torch.clamp(count, min=1.0)


def cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor, *,
                        v0: int = 0, final_cap: float = 0.0,
                        z_loss: float = 0.0, group=None):
    """The unmasked tokens' summed cross-entropy in f32 and their count,
    of logits (..., V_loc) that are this rank's vocab shard [v0, v0 +
    V_loc) of the model ranks `group` (None: the whole vocab). The
    softcap is elementwise on the shard; the max, the sum of exponentials and the gold logit are
    reduced over the group (the max without a gradient, the sums passing
    theirs through), so every rank holds the same sum and the logits are
    never gathered. Returns (sum, count)."""
    logits = softcap(logits.float(), final_cap)
    mask = (labels >= 0).float()
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        v_loc = logits.shape[-1]
        m = coll.all_reduce_max(logits.detach().amax(-1), group)
        lse = m + torch.log(coll.psum_same(
            torch.exp(logits - m[..., None]).sum(-1), group))
        local = labels.long() - v0
        own = (local >= 0) & (local < v_loc)
        gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])
        gold = coll.psum_same(gold[..., 0] * own.float(), group)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return (nll * mask).sum(), mask.sum()

