"""Mixture-of-Experts FFN (port of repro/models/moe.py): the local
dispatch, and the expert parallelism of `moe_ffn` on a mesh.

Each token routes in f32 to its top-k experts; the token-choices are
dispatched to their experts by a sort -> gather (no dispatch-mask
einsum, no scatter in the forward), the expert GEMMs run batched over
the (padded) expert axis, and a scatter-add combines the weighted
outputs; shared experts add a dense gated MLP. Capacity: each expert
takes C = ceil(T * top_k * cf / E) token-choices (rounded up to a
multiple of 8, at least 8); the rest are dropped (GShard-style), their
combine weight never applied.

On a mesh (`launch.mesh.Mesh`, the reference's shard_map at :146-193),
each model rank holds the experts [e_start, e_start + E / tp) and a
column slice of the shared experts' wi and wg (rows of wo); its tokens'
choices of other experts fall into the overflow bin, and one sum over
the model axis adds the routed and the shared experts' outputs. The
tokens split over the data axes (each data rank routes and dispatches
its slice, its capacity counted from its own tokens) unless they do not
divide, where every rank takes them all; the aux loss is averaged over
the data axes. The caller holds the tokens, and every parameter, whole
on every rank (the transformer's other layers are replicated in this
slice): `moe_ffn` slices its own part and all-gathers the output over
the data axes. Gradients: x's is whole on every rank (summed over the
model axis, gathered over the data axes); each parameter's is this
rank's share (its tokens', and on the model axis its experts' and
columns', the aux loss's counted 1 / tp a model rank), so that summed
over every rank it is the whole.

Ties and order follow the reference: the top-k takes the lower expert
index first among equal probabilities (as `jax.lax.top_k` does), and
the dispatch sorts token-choices by expert stably (as `jnp.argsort`
does), so top-k indices and dispatch slots are the reference's bit for
bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.layers import activation
from repro_torch.models.segment import counts_of
from repro_torch.train import collectives as coll


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
    hits = counts_of(topi.reshape(-1), probs.shape[-1]).float()
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
    counts = counts_of(local_e, e_loc + 1)[:e_loc]
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
               e_start: int, e_loc: int, tp_group=None, dp_group=None,
               routing: Optional[List[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block over tokens x (T, D); p holds one layer's
    parameters by name ("router", "wi", ..., "shared.wo"), the experts
    [e_start, e_start + e_loc). With `tp_group` the output is summed
    over it, with `dp_group` the aux loss averaged over it. Appends the
    top-k expert indices (T, k) to `routing` where given. Returns (y,
    aux_loss)."""
    t, d = x.shape
    act = activation(cfg.act)
    probs, topw, topi = _route(x, p["router"], cfg.n_experts, cfg.top_k,
                               cfg.norm_topk_prob)
    if routing is not None:
        routing.append(topi)
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
    if "shared.wi" in p:   # tensor-parallel shared experts, same sum
        hs = act(x @ p["shared.wg"]) * (x @ p["shared.wi"])
        y = y + hs @ p["shared.wo"]
    if tp_group is not None:
        y = coll.psum_same(y, tp_group)
        # every model rank computes the same aux: a 1 / tp share of its
        # gradient each, the value unchanged
        aux = coll.grad_scaled(aux, 1.0 / coll.group_size(tp_group))
    if dp_group is not None:
        aux = coll.psum_same(aux, dp_group) / coll.group_size(dp_group)
    return y, aux


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, e_pad: int,
            *, mesh=None, routing: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over tokens x: (B, S, D) or (T, D). With no mesh (or
    `cfg.moe_impl == "local"`) every (padded) expert runs here; on a
    mesh, expert parallelism (see the module docstring). Appends each
    call's top-k indices (this rank's tokens', (T_loc, k)) to `routing`
    where given. Returns (y, aux)."""
    x2 = x.reshape(-1, x.shape[-1])
    if mesh is None or cfg.moe_impl == "local":
        y, aux = _moe_local(x2, p, cfg=cfg, e_start=0, e_loc=e_pad,
                            routing=routing)
        return y.reshape(x.shape), aux
    names = mesh.axis_names
    tp = mesh.shape["model"] if "model" in names else 1
    dp_axes = mesh.data_axes
    dp = mesh.size(dp_axes)
    if x2.shape[0] % max(dp, 1) != 0:   # e.g. decode batch 1: replicate
        dp_axes, dp = (), 1
    if e_pad % tp:
        raise ValueError(f"{e_pad} experts do not divide over {tp} ranks")
    e_loc = e_pad // tp
    e_start = mesh.index("model") * e_loc if tp > 1 else 0
    pl = {"router": p["router"],
          "wi": p["wi"][e_start:e_start + e_loc],
          "wg": p["wg"][e_start:e_start + e_loc],
          "wo": p["wo"][e_start:e_start + e_loc]}
    if "shared.wi" in p:
        fs = p["shared.wi"].shape[-1]
        if fs % tp:
            raise ValueError(f"shared experts of width {fs} do not divide "
                             f"over {tp} ranks")
        c0, c1 = (fs // tp) * mesh.index("model"), (fs // tp) * \
            (mesh.index("model") + 1)
        pl.update({"shared.wi": p["shared.wi"][:, c0:c1],
                   "shared.wg": p["shared.wg"][:, c0:c1],
                   "shared.wo": p["shared.wo"][c0:c1]})
    dp_group = mesh.data_group if dp_axes else None
    xl = coll.split_same(x2, dp_group) if dp_group is not None else x2
    if tp > 1:
        xl = coll.same_to_parts(xl, mesh.group("model"))
    y, aux = _moe_local(xl, pl, cfg=cfg, e_start=e_start, e_loc=e_loc,
                        tp_group=mesh.group("model") if tp > 1 else None,
                        dp_group=dp_group, routing=routing)
    if dp_group is not None:
        y = coll.all_gather_same(y, dp_group)
    return y.reshape(x.shape), aux
