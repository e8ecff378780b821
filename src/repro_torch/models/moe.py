"""Mixture-of-Experts FFN on one device (port of repro/models/moe.py's
local path: `moe_ffn` with no mesh).

Each token routes in f32 to its top-k experts; the token-choices are
dispatched to their experts by a sort -> gather (no dispatch-mask
einsum, no scatter in the forward), the expert GEMMs run batched over
the (padded) expert axis, and a scatter-add combines the weighted
outputs; shared experts add a dense gated MLP. Capacity: each expert
takes C = ceil(T * top_k * cf / E) token-choices (rounded up to a
multiple of 8, at least 8); the rest are dropped (GShard-style), their
combine weight never applied. The reference's shard_map expert
parallelism across a model axis waits on distribution (ROADMAP.md
queue 1, item 9).

Ties and order follow the reference: the top-k takes the lower expert
index first among equal probabilities (as `jax.lax.top_k` does), and
the dispatch sorts token-choices by expert stably (as `jnp.argsort`
does), so top-k indices and dispatch slots are the reference's bit for
bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import activation


def capacity_for(t_local: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(-(-t_local * top_k * cf // n_experts))
    return max(8, -(-c // 8) * 8)


def drop_free(cfg):
    """cfg with the capacity factor E / top_k, at which every expert can
    take all T tokens (C = T), so that no token-choice is dropped: a
    full forward then routes each token as a decode step of a few tokens
    does (at C = 8 >= B)."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def moe_param_shapes(n_layers: int, d_model: int, n_experts_padded: int,
                     d_expert: int, n_shared: int) -> Dict[str, tuple]:
    """{name: (shape, fan_in, is_f32)} of the stacked-over-layers MoE
    parameters, in the reference's layout: router (L, D, E) in f32,
    experts wi/wg (L, E, D, F) and wo (L, E, F, D), shared experts
    (L, D, n_shared * F) and (L, n_shared * F, D)."""
    e, d, f = n_experts_padded, d_model, d_expert
    shapes = {"router": ((n_layers, d, e), d, True),
              "wi": ((n_layers, e, d, f), d, False),
              "wg": ((n_layers, e, d, f), d, False),
              "wo": ((n_layers, e, f, d), f, False)}
    if n_shared:
        fs = n_shared * d_expert
        shapes.update({"shared.wi": ((n_layers, d, fs), d, False),
                       "shared.wg": ((n_layers, d, fs), d, False),
                       "shared.wo": ((n_layers, fs, d), fs, False)})
    return shapes


def _route(x: torch.Tensor, router_w: torch.Tensor, n_experts: int,
           top_k: int, norm_topk: bool):
    """Router in f32. Padded experts (columns >= n_experts) get -1e30
    logits before the softmax. Returns (probs (T, E_pad), top-k weights
    and indices (T, k), descending, the lower index first on ties)."""
    logits = x.float() @ router_w                           # (T, E_pad)
    e_pad = router_w.shape[-1]
    if e_pad > n_experts:
        pad = torch.arange(e_pad, device=x.device) >= n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :top_k], idx[:, :top_k]
    if norm_topk:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def _aux_loss(probs: torch.Tensor, topi: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss over the real (unpadded) experts."""
    t, k = topi.shape
    hits = torch.bincount(topi.reshape(-1), minlength=probs.shape[-1]).float()
    frac_routed = hits[:n_experts] / (t * k)
    frac_prob = probs[:, :n_experts].mean(0)
    return n_experts * (frac_routed * frac_prob).sum()


def _dispatch_local(x: torch.Tensor, flat_e: torch.Tensor,
                    flat_w: torch.Tensor, e_start: int, e_loc: int,
                    cap: int):
    """Sort -> gather dispatch of token-choices to the experts [e_start,
    e_start + e_loc). Returns xbuf (e_loc, cap, D), wbuf (e_loc, cap),
    tok (e_loc, cap): gathers in the forward (the backward scatter-adds)."""
    tk = flat_e.shape[0]
    dev = x.device
    tok_of = torch.arange(tk, device=dev) // (tk // x.shape[0])
    local_e = torch.where((flat_e >= e_start) & (flat_e < e_start + e_loc),
                          flat_e - e_start,
                          torch.full_like(flat_e, e_loc))  # overflow bin
    order = torch.argsort(local_e, stable=True)           # groups experts
    counts = torch.bincount(local_e, minlength=e_loc + 1)[:e_loc]
    starts = torch.cumsum(counts, 0) - counts            # exclusive
    slot_c = torch.arange(cap, device=dev)
    src = starts[:, None] + slot_c[None, :]               # (e_loc, cap)
    valid = slot_c[None, :] < torch.clamp(counts, max=cap)[:, None]
    entry = order[torch.clamp(src, max=tk - 1)]           # (e_loc, cap)
    tok = tok_of[entry]
    xbuf = x[tok] * valid[..., None].to(x.dtype)
    wbuf = torch.where(valid, flat_w[entry],
                       torch.zeros((), dtype=flat_w.dtype, device=dev))
    return xbuf, wbuf, tok


def _moe_local(x: torch.Tensor, p: Dict[str, torch.Tensor], *, cfg,
               e_start: int, e_loc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block over tokens x (T, D); p holds one layer's
    parameters by name ("router", "wi", ..., "shared.wo"). Returns
    (y, aux_loss)."""
    t, d = x.shape
    act = activation(cfg.act)
    probs, topw, topi = _route(x, p["router"], cfg.n_experts, cfg.top_k,
                               cfg.norm_topk_prob)
    aux = _aux_loss(probs, topi, cfg.n_experts)
    cap = capacity_for(t, cfg.top_k, max(cfg.n_experts, 1),
                       cfg.capacity_factor)
    xbuf, wbuf, tok = _dispatch_local(
        x, topi.reshape(-1), topw.reshape(-1).to(x.dtype), e_start, e_loc,
        cap)
    # expert GEMMs: (e, c, d) x (e, d, f) -> (e, c, f)
    h = act(torch.bmm(xbuf, p["wg"])) * torch.bmm(xbuf, p["wi"])
    out = torch.bmm(h, p["wo"]) * wbuf[..., None]          # (e, c, d)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device).index_add(
        0, tok.reshape(-1), out.reshape(-1, d))
    if "shared.wi" in p:
        hs = act(x @ p["shared.wg"]) * (x @ p["shared.wi"])
        y = y + hs @ p["shared.wo"]
    return y, aux


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
            e_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over tokens x: (B, S, D) or (T, D), every (padded) expert
    on this device. Returns (y, aux)."""
    y, aux = _moe_local(x.reshape(-1, x.shape[-1]), p, cfg=cfg, e_start=0,
                        e_loc=e_pad)
    return y.reshape(x.shape), aux
