"""Decoder-only transformer family covering the five LM archs, in
PyTorch (port of repro/models/transformer.py).

Features driven by TransformerConfig, as in the reference:
  - GQA attention (`layers.chunked_attention`: never materializes S x S,
    forward or backward), RoPE, optional QKV bias (Qwen), logit softcaps
    (Gemma-2),
  - local/global alternating sliding-window layers (Gemma-2): layer i
    takes window `windows[i % scan_block]`,
  - dense SwiGLU/GeGLU or MoE FFN (models/moe.py, local dispatch),
  - every weight stacked over layers on axis 0, with the layers looped
    in Python; `remat != "none"` checkpoints each group of scan_block
    layers (`torch.utils.checkpoint`: its activations are recomputed in
    the backward, as the reference's remat of its scan body; "dots"
    recomputes as "full" does),
  - tied or untied LM head,
  - a `placement` (launch/programs.LMPlacement), where given: every
    parameter is this rank's block under the reference's rules and the
    layers run on a mesh of ranks (below),
  - `routing`, where given, a list the MoE layers append their top-k
    expert indices to (layer by layer; the outputs do not change).

On a placement (the reference's build_lm_program, its GSPMD placements
made explicit): the tokens are this data rank's rows; the embedding is
`tp_embedding_lookup` with rows = V on the vocab shard, and the tied head
(or lm_head) computes this rank's vocab shard of the logits, which
`layers.cross_entropy_parts` reduces over the model ranks without
gathering them; the residual stream between blocks is split on seq over
the model ranks where it divides (`act_seq`: norms and adds local, an
all-gather before attention and the FFN whose backward reduce-scatters,
a reduce-scatter after whose backward all-gathers); each weight's fsdp
shard is all-gathered over the data axes a layer at a time (its backward
reduce-scatters the gradient), inside the remat region, so that the
backward's recompute gathers again. Attention runs in one of four
layouts, by the weights' placement and the sequence:
  - "heads": query heads split over the model ranks, each rank attending
    with its own heads (kv heads its own, or the ones its query heads
    read from the gathered whole);
  - "seq" (`act_q_seq`, where the heads do not divide and the config
    sends query positions to the model axis): each rank takes its slice
    of query positions against the whole K and V (the weights gathered
    over the model ranks), its causal and window masks offset by the
    slice's start; its output is its own slice of the residual stream;
  - "head_dim": q, k and v split on the head dim (RoPE, which pairs dim d
    with d + hd / 2, runs on the all-gathered whole and each rank keeps
    its slice); partial scores summed over the model ranks before the
    softcap and softmax (`chunked_attention(group=)`), the value
    contraction leaving each rank its slice of the head dim for wo;
  - "same": nothing split over the model ranks (or one model rank):
    every model rank computes all of it alike.
The dense MLP is Megatron's where `mlp` splits (column-split wi and wg,
row-split wo), else per token on the residual stream's slice; the MoE
runs `moe_lib._moe_local` on this rank's experts and shared-expert
columns over the whole sequence. Decode (`decode_step(placement=)`)
attends over the cache block the placement gives (`layers.
decode_attention` with its groups: kv heads or head dim over the model
ranks, and positions over the data ranks for a batch under 8), the new entry
written by the rank that owns `pos`; its projections' outputs are
gathered over the model ranks, which a token's few values make cheap.
Gradients follow launch/programs.py's convention: a parameter
replicated over the model ranks holds its rank's part (its sequence
slice's, its experts'), or a 1 / tp share where every model rank does
the same work, and LMPlacement.reduce_grads sums them.

Parameters keep the JAX tree's names and layout: `embed.table` (V, D),
`blocks.attn.wq` (L, D, H, hd), `blocks.moe.shared.wo` (L, n_shared * F,
D), ... (`param_shapes`). `tree_from_named` / `named_from_tree` map the
module's dotted names to the JAX tree and back (parameters and
optimizer state alike); `params_from_numpy` carries a JAX parameter
tree, as numpy, into the module, so that checkpoints of either package
restore in the other.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.embedding import tp_embedding_lookup
from repro_torch.models.exchange import from_numpy, to_numpy
from repro_torch.models.layers import (
    apply_rope, chunked_attention, cross_entropy_loss, cross_entropy_parts,
    decode_attention, mlp_block, rms_norm, softcap)
from repro_torch.train import collectives as coll

EXPERT_PAD_TO = 16  # the JAX package's model-axis degree (weights carry across)


def expert_pad(cfg: TransformerConfig) -> int:
    if not cfg.is_moe:
        return 0
    return -(-cfg.n_experts // EXPERT_PAD_TO) * EXPERT_PAD_TO


# ------------------------------------------------------------------ init ---
def param_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    """{dotted name: (shape, init, dtype)}: init is a fan-in (normal
    scaled by fan_in ** -0.5), "zeros" or "ones"; dtype the config's,
    or torch.float32 for the MoE router. Needs no allocation."""
    dtype = getattr(torch, cfg.param_dtype)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, K, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    ln = "zeros" if cfg.post_norm else "ones"     # gemma: (1 + w)
    s = {"embed.table": ((V, D), D, dtype),
         "blocks.ln1": ((L, D), ln, dtype),
         "blocks.ln2": ((L, D), ln, dtype),
         "blocks.attn.wq": ((L, D, H, hd), D, dtype),
         "blocks.attn.wk": ((L, D, K, hd), D, dtype),
         "blocks.attn.wv": ((L, D, K, hd), D, dtype),
         "blocks.attn.wo": ((L, H, hd, D), H * hd, dtype)}
    if cfg.qkv_bias:
        s.update({"blocks.attn.bq": ((L, H, hd), "zeros", dtype),
                  "blocks.attn.bk": ((L, K, hd), "zeros", dtype),
                  "blocks.attn.bv": ((L, K, hd), "zeros", dtype)})
    if cfg.post_norm:
        s.update({"blocks.ln1_post": ((L, D), ln, dtype),
                  "blocks.ln2_post": ((L, D), ln, dtype)})
    if cfg.is_moe:
        for name, (shape, fan_in, f32) in moe_lib.moe_param_shapes(
                L, D, expert_pad(cfg), cfg.d_expert,
                cfg.n_shared_experts).items():
            s[f"blocks.moe.{name}"] = (shape, fan_in,
                                       torch.float32 if f32 else dtype)
    else:
        s.update({"blocks.mlp.wi": ((L, D, Fd), D, dtype),
                  "blocks.mlp.wg": ((L, D, Fd), D, dtype),
                  "blocks.mlp.wo": ((L, Fd, D), Fd, dtype)})
    s["final_ln"] = ((D,), ln, dtype)
    if not cfg.tie_embeddings:
        s["lm_head"] = ((D, V), D, dtype)
    return s


# routed-expert weights (L, E, ...), drawn a layer's expert at a time
_EXPERT_STACKS = ("blocks.moe.wi", "blocks.moe.wg", "blocks.moe.wo")


def _unit_dims(name: str) -> int:
    """The leading dims of parameter `name` that index its units of
    random draws: a layer's expert of a routed-expert weight, a layer of
    any other stacked weight, the whole of an unstacked one."""
    if name in _EXPERT_STACKS:
        return 2
    return 1 if name.startswith("blocks.") else 0


def _unit_seed(seed: int, name: str, unit: int) -> int:
    digest = hashlib.blake2b(f"{seed}/{name}/{unit}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _draw(t: torch.Tensor, name: str, shape: tuple, block: tuple,
          fan_in: int, seed: int) -> None:
    """Fill t, the block of `shape` whose dims start and span as
    `block` ((start, size) a dim) says, with that block of the whole
    parameter's normal draw scaled by fan_in ** -0.5: each unit
    (`_unit_dims`) that the block meets is drawn whole from a generator
    of its own and cut to the block; a meta tensor (the dry run's)
    draws nothing."""
    if t.device.type == "meta":
        return
    nu = _unit_dims(name)
    lead = block[:nu]
    inner = tuple(slice(a, a + n) for a, n in block[nu:])
    for idx in itertools.product(*(range(a, a + n) for a, n in lead)):
        unit = 0
        for i, n in zip(idx, shape[:nu]):
            unit = unit * n + i
        gen = torch.Generator(device=t.device).manual_seed(
            _unit_seed(seed, name, unit))
        u = torch.empty(shape[nu:], dtype=t.dtype, device=t.device)
        u.normal_(generator=gen).mul_(fan_in ** -0.5)
        t[tuple(i - a for i, (a, _) in zip(idx, lead))] = u[inner]


class Transformer(nn.Module):
    """The parameters of `param_shapes`, registered under their dotted
    names (`named_parameters()` gives `blocks.attn.wq`, ...), drawn from
    `seed` (`_draw`). `blocks` ({name: (start, size) of each dim}, as
    LMPlacement.blocks gives them) makes each parameter named there that
    block of the whole, drawn without the whole tensor: the same values
    as the whole's slice."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 seed: int = 0, blocks: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        for name, (shape, init, dtype) in param_shapes(cfg).items():
            block = (blocks or {}).get(name) or tuple((0, n) for n in shape)
            t = torch.empty(tuple(n for _, n in block), dtype=dtype,
                            device=device)
            with torch.no_grad():
                if init == "zeros":
                    t.zero_()
                elif init == "ones":
                    t.fill_(1.0)
                else:
                    _draw(t, name, shape, block, init, seed)
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(t))


def init_params(cfg: TransformerConfig, *, seed: int = 0, device="cuda",
                blocks: Optional[dict] = None) -> Transformer:
    """A Transformer with random weights drawn on `device` from `seed`;
    with `blocks`, each parameter this rank's block of them."""
    return Transformer(cfg, device=device, seed=seed, blocks=blocks)


# -------------------------------------------------------------- helpers ----
def _group_windows(cfg: TransformerConfig) -> Tuple[int, ...]:
    """Per-sublayer windows within one scan group: Gemma-2 (scan_block
    2) (local W, global 0); the others (W,) or (0,)."""
    if cfg.local_global_alternating:
        assert cfg.scan_block == 2, "alternation needs scan_block=2"
        return (cfg.sliding_window, 0)
    return (cfg.sliding_window,) * cfg.scan_block


def _layers(model: Transformer):
    """(cfg, {name: param}, [{block name: layer i's slice}] for each
    layer). The stacked weights are unbound once, so that the backward
    stacks each weight's gradient once."""
    cfg = model.cfg
    assert cfg.n_layers % cfg.scan_block == 0, (cfg.n_layers, cfg.scan_block)
    named = dict(model.named_parameters())
    stacked = {k[len("blocks."):]: v.unbind(0) for k, v in named.items()
               if k.startswith("blocks.")}
    return cfg, named, [{k: v[i] for k, v in stacked.items()}
                        for i in range(cfg.n_layers)]


def _embed(cfg: TransformerConfig, table: torch.Tensor,
           tokens: torch.Tensor, mesh=None,
           rows: Optional[int] = None) -> torch.Tensor:
    """The rows of `tokens` in `table`, scaled where the config says; on a
    placement `table` is this rank's vocab shard of `rows` on `mesh`."""
    x = tp_embedding_lookup(table, tokens, mesh, rows=rows)
    if cfg.scale_embed:
        # sqrt(d) rounded to the activation dtype, as the reference
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _attn_proj(h: torch.Tensor, blk: dict, cfg: TransformerConfig):
    b, s, d = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ blk["attn.wq"].reshape(d, H * hd)).view(b, s, H, hd)
    k = (h @ blk["attn.wk"].reshape(d, K * hd)).view(b, s, K, hd)
    v = (h @ blk["attn.wv"].reshape(d, K * hd)).view(b, s, K, hd)
    if cfg.qkv_bias:
        q = q + blk["attn.bq"]
        k = k + blk["attn.bk"]
        v = v + blk["attn.bv"]
    return q, k, v


def _attn_out(o: torch.Tensor, blk: dict, cfg: TransformerConfig):
    b, s = o.shape[:2]
    wo = blk["attn.wo"]
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _ffn(h2: torch.Tensor, blk: dict, cfg: TransformerConfig,
         routing=None):
    """(m, aux) of the layer's MLP or MoE."""
    if cfg.is_moe:
        p = {k[len("moe."):]: v for k, v in blk.items()
             if k.startswith("moe.")}
        return moe_lib.moe_ffn(h2, p, cfg, expert_pad(cfg), routing=routing)
    m = mlp_block(h2, blk["mlp.wi"], blk["mlp.wg"], blk["mlp.wo"], cfg.act)
    return m, torch.zeros((), dtype=torch.float32, device=h2.device)


def _one_layer(x, blk: dict, window: int, positions, cfg: TransformerConfig,
               routing=None):
    plus1 = cfg.post_norm
    h = rms_norm(x, blk["ln1"], eps=cfg.norm_eps, plus_one=plus1)
    q, k, v = _attn_proj(h, blk, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, window=window, causal=True,
                          logit_cap=cfg.attn_logit_softcap,
                          chunk=cfg.attn_chunk, scale=cfg.head_dim ** -0.5)
    o = _attn_out(o, blk, cfg)
    if cfg.post_norm:
        o = rms_norm(o, blk["ln1_post"], eps=cfg.norm_eps, plus_one=True)
    x = x + o
    h2 = rms_norm(x, blk["ln2"], eps=cfg.norm_eps, plus_one=plus1)
    m, aux = _ffn(h2, blk, cfg, routing)
    if cfg.post_norm:
        m = rms_norm(m, blk["ln2_post"], eps=cfg.norm_eps, plus_one=True)
    return x + m, aux, (k, v)


def _logits(x: torch.Tensor, named: dict) -> torch.Tensor:
    head = named.get("lm_head")
    if head is None:
        return x @ named["embed.table"].t()
    return x @ head


# -------------------------------------------------------------- forward ----
def forward(model: Transformer, tokens: torch.Tensor, *,
            return_cache: bool = False, routing=None, placement=None):
    """Full-sequence forward. tokens: (B, S) int.

    Returns (logits (B, S, V) in the parameter dtype, aux) [, cache
    {"k", "v"}: (L, B, S, K, hd), the post-RoPE keys and the values].
    `routing` is filled only where the layers run outside a checkpoint
    (a recompute would append again). On a `placement` tokens are this
    data rank's rows, the logits this model rank's vocab shard and the
    cache this rank's block (`_placed_forward`)."""
    if placement is not None:
        return _placed_forward(model, tokens, placement,
                               return_cache=return_cache, routing=routing)
    cfg, named, layers = _layers(model)
    S = tokens.shape[1]
    x = _embed(cfg, named["embed.table"], tokens)
    positions = torch.arange(S, device=tokens.device)
    windows = _group_windows(cfg)
    blk_sz = cfg.scan_block
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []

    def group(x, aux_sum, g0: int, route=None):
        kvs = []
        for j in range(blk_sz):
            x, aux, kv = _one_layer(x, layers[g0 + j], windows[j], positions,
                                    cfg, route)
            aux_sum = aux_sum + aux
            kvs.append(kv)
        return x, aux_sum, kvs

    for g0 in range(0, cfg.n_layers, blk_sz):
        if cfg.remat != "none" and torch.is_grad_enabled():
            # g0 bound now: the backward's recompute calls this again
            x, aux_total = checkpoint(
                lambda x, a, g0=g0: group(x, a, g0)[:2], x, aux_total,
                use_reentrant=False)
        else:
            x, aux_total, kvs = group(x, aux_total, g0, routing)
            if return_cache:
                ks += [k for k, _ in kvs]
                vs += [v for _, v in kvs]

    x = rms_norm(x, named["final_ln"], eps=cfg.norm_eps,
                 plus_one=cfg.post_norm)
    logits = _logits(x, named)
    if return_cache:
        if len(ks) != cfg.n_layers:
            raise ValueError("return_cache needs the layers run outside "
                             "a checkpoint: under torch.no_grad(), or with "
                             "remat 'none'")
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}, \
            aux_total
    return logits, aux_total


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor], *,
            placement=None):
    """batch: {"tokens": (B, S), "labels": (B, S)}. Returns (loss,
    metrics). On a `placement` the batch is this data rank's rows and
    the loss this rank's share of the global batch's (its tokens' summed
    cross-entropy over the global count, plus the router aux loss, which
    the MoE already averages over the data ranks): summed over the data
    ranks the shares' gradients are the global loss's; the metrics hold
    the global values, "loss" among them."""
    cfg = model.cfg
    if placement is not None:
        return _placed_loss(model, batch, placement)
    logits, aux = forward(model, batch["tokens"])
    xent = cross_entropy_loss(logits, batch["labels"],
                              final_cap=cfg.final_logit_softcap)
    loss = xent + cfg.router_aux_coef * aux
    return loss, {"xent": xent, "router_aux": aux}


# -------------------------------------------------------------- serving ----
def init_cache(cfg: TransformerConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, *, routing=None,
            placement=None):
    """Forward over the prompt: (last-token logits (B, V), not
    softcapped, in the parameter dtype; cache (L, B, S, K, hd)). On a
    `placement` (a decode one: its `batch` and `cache_len`), tokens are
    this data rank's rows, the logits are gathered over the vocab, and
    the cache is this rank's block of a cache of `cache_len` positions,
    the prompt's written, the rest zero."""
    logits, cache, _ = forward(model, tokens, return_cache=True,
                               routing=routing, placement=placement)
    last = logits[:, -1]
    if placement is not None and _vocab_split(placement):
        last = coll.gather_dim(last.contiguous(), placement.tpg, -1)
    return last, cache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: int, *, routing=None,
                placement=None):
    """One decode step. tokens: (B,) int; pos: the position decoded, the
    same for the whole batch.

    Returns (logits (B, V), f32 and softcapped, cache). The cache's
    entries at `pos` are written in place (the reference returns a new
    cache; at full width a copy a step would double its memory). On a
    `placement` (a decode one), tokens are this data rank's rows and the
    cache this rank's block (`_placed_decode`)."""
    if placement is not None:
        return _placed_decode(model, cache, tokens, pos, placement,
                              routing=routing)
    cfg, named, layers = _layers(model)
    x = _embed(cfg, named["embed.table"], tokens)[:, None, :]
    windows = _group_windows(cfg)
    plus1 = cfg.post_norm
    pos_arr = torch.tensor([pos], device=tokens.device)
    for i, blk in enumerate(layers):
        h = rms_norm(x, blk["ln1"], eps=cfg.norm_eps, plus_one=plus1)
        q, k, v = _attn_proj(h, blk, cfg)
        q = apply_rope(q, pos_arr, cfg.rope_theta)
        k = apply_rope(k, pos_arr, cfg.rope_theta)
        cache["k"][i, :, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][i, :, pos] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q, cache["k"][i], cache["v"][i], pos=pos,
                             window=windows[i % cfg.scan_block],
                             logit_cap=cfg.attn_logit_softcap,
                             scale=cfg.head_dim ** -0.5)
        o = _attn_out(o.to(x.dtype), blk, cfg)
        if cfg.post_norm:
            o = rms_norm(o, blk["ln1_post"], eps=cfg.norm_eps, plus_one=True)
        x = x + o
        h2 = rms_norm(x, blk["ln2"], eps=cfg.norm_eps, plus_one=plus1)
        m, _ = _ffn(h2, blk, cfg, routing)
        if cfg.post_norm:
            m = rms_norm(m, blk["ln2_post"], eps=cfg.norm_eps, plus_one=True)
        x = x + m
    x = rms_norm(x, named["final_ln"], eps=cfg.norm_eps, plus_one=plus1)
    logits = softcap(_logits(x, named)[:, 0].float(),
                     cfg.final_logit_softcap)
    return logits, cache


# ------------------------------------------------------------- placed ----
def _lspec(pl, name: str) -> tuple:
    """A stacked block parameter's spec without its layer dim."""
    return pl.specs["blocks." + name][1:]


def _head(named: dict, pl):
    """(head weight, its spec, the vocab dim) of the tied table or the
    untied lm_head."""
    if "lm_head" in named:
        return named["lm_head"], pl.specs["lm_head"], 1
    return named["embed.table"], pl.specs["embed.table"], 0


def _vocab_split(pl) -> bool:
    name = "embed.table" if pl.cfg.tie_embeddings else "lm_head"
    return pl.on_model(pl.specs[name], 0 if name == "embed.table" else 1)


def attention_layout(pl, seq: int) -> str:
    """The attention layout of a placement at `seq` positions (see the
    module docstring): "heads", "seq", "head_dim" or "same"."""
    sq = _lspec(pl, "attn.wq")                      # (D, H, hd)
    if pl.on_model(sq, 1):
        return "heads"
    if pl.q_seq_split(seq) and pl.seq_split(seq):
        return "seq"
    if pl.on_model(sq, 2):
        return "head_dim"
    return "same"


def _proj(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """h (B, s, D) @ w (D, Hx, hdx) [+ b (Hx, hdx)] -> (B, s, Hx, hdx)."""
    bq, sl, d = h.shape
    y = (h @ w.reshape(d, -1)).view(bq, sl, w.shape[1], w.shape[2])
    return y + b if b is not None else y


def _fetch_attn(blk: dict, pl, names, use: str):
    """[(w, b or None)] of the attention weights `names` ("q", "k", "v")."""
    out = []
    for n in names:
        w = pl.fetch(blk[f"attn.w{n}"], _lspec(pl, f"attn.w{n}"), use)
        b = blk.get(f"attn.b{n}")
        if b is not None:
            b = pl.fetch(b, _lspec(pl, f"attn.b{n}"), use)
        out.append((w, b))
    return out


def _to_residual(y: torch.Tensor, pl, sp: bool, parts: bool):
    """A block's output (B, S, D) back into the residual stream: summed
    over the model ranks where each holds a part (`parts`), this rank's
    seq slice where the stream is split (`sp`)."""
    if parts:
        return coll.reduce_scatter_sum(y, pl.tpg, 1) if sp \
            else coll.psum_same(y, pl.tpg)
    return coll.split_same(y, pl.tpg, 1) if sp else y


def _from_residual(h: torch.Tensor, pl, sp: bool, parts: bool):
    """The whole sequence of a residual-stream tensor for work each model
    rank does its own part of (`parts`) or all of alike."""
    if sp:
        return coll.all_gather_sum(h, pl.tpg, 1) if parts \
            else coll.all_gather_same(h, pl.tpg, 1)
    return coll.same_to_parts(h, pl.tpg) if parts else h


def _kv_for_heads(k: torch.Tensor, pl, cfg) -> torch.Tensor:
    """The kv heads (B, S, K', hd) that this rank's query heads read,
    from all K."""
    hl, g = cfg.n_heads // pl.tp, cfg.n_heads // cfg.n_kv_heads
    if hl % g == 0:
        k0, kl = pl.m * hl // g, hl // g
    elif g % hl == 0:
        k0, kl = pl.m * hl // g, 1
    else:
        raise ValueError(f"{hl} query heads a rank do not group with "
                         f"{cfg.n_kv_heads} kv heads")
    return k[:, :, k0:k0 + kl]


def _hd_slice(x: torch.Tensor, pl) -> torch.Tensor:
    c = x.shape[-1] // pl.tp
    return x[..., pl.m * c:(pl.m + 1) * c]


def _placed_attention(h: torch.Tensor, blk: dict, window: int,
                      positions: torch.Tensor, cfg, pl, layout: str,
                      sp: bool, want_kv: bool):
    """The attention block of residual-stream h (normed) in `layout`.
    Returns (output in the residual stream, the whole post-RoPE (k, v)
    (B, S, K, hd) where `want_kv`, else None)."""
    scale = cfg.head_dim ** -0.5
    kw = dict(window=window, causal=True, logit_cap=cfg.attn_logit_softcap,
              chunk=cfg.attn_chunk, scale=scale)
    theta = cfg.rope_theta
    if layout == "same":
        h_all = _from_residual(h, pl, sp, parts=False)
        (wq, bq), (wk, bk), (wv, bv) = _fetch_attn(blk, pl, "qkv", "same")
        q = apply_rope(_proj(h_all, wq, bq), positions, theta)
        k = apply_rope(_proj(h_all, wk, bk), positions, theta)
        v = _proj(h_all, wv, bv)
        o = chunked_attention(q, k, v, **kw)
        wo = pl.fetch(blk["attn.wo"], _lspec(pl, "attn.wo"), "same")
        y = o.reshape(o.shape[0], o.shape[1], -1) @ \
            wo.reshape(-1, wo.shape[-1])
        return _to_residual(y, pl, sp, parts=False), \
            ((k, v) if want_kv else None)
    if layout == "seq":
        s_loc = h.shape[1]
        h_all = coll.all_gather_sum(h, pl.tpg, 1)
        (wq, bq), (wk, bk), (wv, bv) = _fetch_attn(blk, pl, "qkv", "parts")
        q0 = pl.m * s_loc
        q = apply_rope(_proj(h, wq, bq), positions[q0:q0 + s_loc], theta)
        k = apply_rope(_proj(h_all, wk, bk), positions, theta)
        v = _proj(h_all, wv, bv)
        o = chunked_attention(q, k, v, q_offset=q0, **kw)
        wo = pl.fetch(blk["attn.wo"], _lspec(pl, "attn.wo"), "parts")
        y = o.reshape(o.shape[0], s_loc, -1) @ wo.reshape(-1, wo.shape[-1])
        return y, ((k, v) if want_kv else None)
    h_all = _from_residual(h, pl, sp, parts=True)
    kv = None
    if layout == "heads":
        (wq, bq), = _fetch_attn(blk, pl, "q", "keep")
        q = apply_rope(_proj(h_all, wq, bq), positions, theta)
        if pl.on_model(_lspec(pl, "attn.wk"), 1):
            (wk, bk), (wv, bv) = _fetch_attn(blk, pl, "kv", "keep")
            k = apply_rope(_proj(h_all, wk, bk), positions, theta)
            v = _proj(h_all, wv, bv)
            if want_kv:
                kv = (coll.gather_dim(k, pl.tpg, 2),
                      coll.gather_dim(v, pl.tpg, 2))
        else:
            (wk, bk), (wv, bv) = _fetch_attn(blk, pl, "kv", "parts")
            k_all = apply_rope(_proj(h_all, wk, bk), positions, theta)
            v_all = _proj(h_all, wv, bv)
            kv = (k_all, v_all) if want_kv else None
            k, v = _kv_for_heads(k_all, pl, cfg), _kv_for_heads(v_all, pl,
                                                                  cfg)
        o = chunked_attention(q, k, v, **kw)
    elif layout == "head_dim":
        if not pl.on_model(_lspec(pl, "attn.wk"), 2):
            raise ValueError("a head dim split for q but not for k")
        (wq, bq), (wk, bk), (wv, bv) = _fetch_attn(blk, pl, "qkv", "keep")
        q = _hd_slice(apply_rope(coll.all_gather_sum(
            _proj(h_all, wq, bq), pl.tpg, -1), positions, theta), pl)
        k_all = apply_rope(coll.all_gather_sum(_proj(h_all, wk, bk), pl.tpg,
                                               -1), positions, theta)
        k = _hd_slice(k_all, pl)
        v = _proj(h_all, wv, bv)
        if want_kv:
            kv = (k_all, coll.gather_dim(v, pl.tpg, 3))
        o = chunked_attention(q, k, v, group=pl.tpg, **kw)
    else:
        raise ValueError(layout)
    wo = pl.fetch(blk["attn.wo"], _lspec(pl, "attn.wo"), "keep")
    y = o.reshape(o.shape[0], o.shape[1], -1) @ wo.reshape(-1, wo.shape[-1])
    return _to_residual(y, pl, sp, parts=True), kv


def _moe_params(blk: dict, pl, use_shared: str):
    p = {"router": blk["moe.router"]}
    for k in ("wi", "wg", "wo"):
        p[k] = pl.fetch(blk[f"moe.{k}"], _lspec(pl, f"moe.{k}"), "keep")
        if f"moe.shared.{k}" in blk:
            p[f"shared.{k}"] = pl.fetch(blk[f"moe.shared.{k}"],
                                        _lspec(pl, f"moe.shared.{k}"),
                                        use_shared)
    return p


def _placed_moe(h_all: torch.Tensor, blk: dict, cfg, pl, routing=None):
    """The MoE over the whole sequence of this data rank's tokens h_all
    (B, S, D), with this rank's experts and shared-expert columns: the
    output summed over the model ranks (alike on each), and the aux
    loss. Tokens split over the data ranks where the batch was not, as
    the reference's shard_map does where they divide."""
    e_pad = expert_pad(cfg)
    if pl.tp > 1:
        if not pl.on_model(_lspec(pl, "moe.wi"), 0):
            raise ValueError(f"{e_pad} experts do not split over "
                             f"{pl.tp} ranks")
        if "moe.shared.wi" in blk and not pl.on_model(
                _lspec(pl, "moe.shared.wi"), 1):
            raise ValueError("the shared experts' width does not split "
                             f"over {pl.tp} ranks")
    x2 = h_all.reshape(-1, h_all.shape[-1])
    e_loc = e_pad // pl.tp
    rows = pl.rows_split()
    split = pl.dpg is not None and not rows and x2.shape[0] % pl.dp == 0
    if split:     # the batch did not split over the data ranks, tokens do
        x2 = coll.split_same(x2, pl.dpg)
    y, aux = moe_lib._moe_local(
        x2, _moe_params(blk, pl, "keep"), cfg=cfg, e_start=pl.m * e_loc,
        e_loc=e_loc, tp_group=pl.tpg,
        dp_group=pl.dpg if (rows or split) else None, routing=routing)
    if split:
        y = coll.all_gather_same(y, pl.dpg)
    return y.reshape(h_all.shape), aux


def _placed_ffn(h2: torch.Tensor, blk: dict, cfg, pl, sp: bool,
                routing=None):
    """(the FFN's output in the residual stream, aux) of normed h2."""
    if cfg.is_moe:
        y, aux = _placed_moe(_from_residual(h2, pl, sp, parts=True), blk,
                             cfg, pl, routing)
        return _to_residual(y, pl, sp, parts=False), aux
    zero = torch.zeros((), dtype=torch.float32, device=h2.device)
    if pl.on_model(_lspec(pl, "mlp.wi"), 1):
        w = [pl.fetch(blk[f"mlp.{k}"], _lspec(pl, f"mlp.{k}"), "keep")
             for k in ("wi", "wg", "wo")]
        y = mlp_block(_from_residual(h2, pl, sp, parts=True), *w, cfg.act)
        return _to_residual(y, pl, sp, parts=True), zero
    # per token, on the residual stream's own slice
    use = "keep" if sp else "same"
    w = [pl.fetch(blk[f"mlp.{k}"], _lspec(pl, f"mlp.{k}"), use)
         for k in ("wi", "wg", "wo")]
    return mlp_block(h2, *w, cfg.act), zero


def _placed_layer(x, blk: dict, window: int, positions, cfg, pl,
                  layout: str, sp: bool, want_kv: bool, routing=None):
    plus1 = cfg.post_norm
    use = "keep" if sp else "same"     # norms: per token on the stream
    ln = lambda name: pl.fetch(blk[name], _lspec(pl, name), use)
    h = rms_norm(x, ln("ln1"), eps=cfg.norm_eps, plus_one=plus1)
    o, kv = _placed_attention(h, blk, window, positions, cfg, pl, layout,
                              sp, want_kv)
    if cfg.post_norm:
        o = rms_norm(o, ln("ln1_post"), eps=cfg.norm_eps, plus_one=True)
    x = x + o
    h2 = rms_norm(x, ln("ln2"), eps=cfg.norm_eps, plus_one=plus1)
    m, aux = _placed_ffn(h2, blk, cfg, pl, sp, routing)
    if cfg.post_norm:
        m = rms_norm(m, ln("ln2_post"), eps=cfg.norm_eps, plus_one=True)
    return x + m, aux, kv


def _placed_embed(cfg, named: dict, tokens: torch.Tensor, pl):
    """The rows of `tokens` (every model rank the same), through
    `tp_embedding_lookup` on the vocab shard."""
    table, spec = named["embed.table"], pl.specs["embed.table"]
    if spec[0] is None:         # the vocab does not split: every rank alike
        table = pl.fetch(table, spec, "same")
        return _embed(cfg, table, tokens)
    return _embed(cfg, table, tokens, pl.mesh, rows=cfg.vocab_size)


def _placed_logits(x: torch.Tensor, named: dict, pl, sp: bool):
    """(logits of this rank's vocab shard (B, S, V_loc), its first id)."""
    head, spec, vdim = _head(named, pl)
    split = pl.on_model(spec, vdim)
    h = _from_residual(x, pl, sp, parts=split)
    if not split:
        head = pl.fetch(head, spec, "same")
    w = head.t() if vdim == 0 else head
    return h @ w, (pl.m * w.shape[1] if split else 0)


def _cache_block(kv_all: torch.Tensor, pl, spec, cache_len: int):
    """This rank's block (B_c, S_loc, K_c, hd_c) of a cache of
    `cache_len` positions from the whole (B_loc, S, K, hd) of a prompt."""
    _, _, seq_e, k_e, hd_e = spec
    x = kv_all
    if pl.split(k_e) > 1:
        n = x.shape[2] // pl.tp
        x = x[:, :, pl.m * n:(pl.m + 1) * n]
    if pl.split(hd_e) > 1:
        x = _hd_slice(x, pl)
    n_s = pl.split(seq_e)
    s_loc = cache_len // n_s
    s0 = pl.mesh.index(seq_e) * s_loc if n_s > 1 else 0
    out = torch.zeros((x.shape[0], s_loc) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    end = min(s0 + s_loc, x.shape[1])
    if end > s0:
        out[:, :end - s0] = x[:, s0:end]
    return out


def _placed_forward(model: Transformer, tokens: torch.Tensor, pl, *,
                    return_cache: bool = False, routing=None):
    cfg, named, layers = _layers(model)
    S = tokens.shape[1]
    sp = pl.seq_split(S)
    layout = attention_layout(pl, S)
    x = _placed_embed(cfg, named, tokens, pl)
    if sp:
        x = coll.split_same(x, pl.tpg, 1)
    positions = torch.arange(S, device=tokens.device)
    windows = _group_windows(cfg)
    blk_sz = cfg.scan_block
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []

    def group(x, aux_sum, g0: int, route=None, want_kv=False):
        kvs = []
        for j in range(blk_sz):
            x, aux, kv = _placed_layer(x, layers[g0 + j], windows[j],
                                       positions, cfg, pl, layout, sp,
                                       want_kv, route)
            aux_sum = aux_sum + aux
            kvs.append(kv)
        return x, aux_sum, kvs

    for g0 in range(0, cfg.n_layers, blk_sz):
        if cfg.remat != "none" and torch.is_grad_enabled():
            x, aux_total = checkpoint(
                lambda x, a, g0=g0: group(x, a, g0)[:2], x, aux_total,
                use_reentrant=False)
        else:
            x, aux_total, kvs = group(x, aux_total, g0, routing,
                                      return_cache)
            if return_cache:
                ks += [k for k, _ in kvs]
                vs += [v for _, v in kvs]
    use = "keep" if sp else "same"
    x = rms_norm(x, pl.fetch(named["final_ln"], pl.specs["final_ln"], use),
                 eps=cfg.norm_eps, plus_one=cfg.post_norm)
    logits, _ = _placed_logits(x, named, pl, sp)
    if not return_cache:
        return logits, aux_total
    if len(ks) != cfg.n_layers:
        raise ValueError("return_cache needs the layers run outside a "
                         "checkpoint: under torch.no_grad(), or with remat "
                         "'none'")
    b_glob = pl.batch if pl.batch is not None else tokens.shape[0]
    c_len = pl.cache_len or S
    spec = pl.cache_spec(b_glob, c_len)
    cache = {"k": torch.stack([_cache_block(k, pl, spec, c_len)
                               for k in ks]),
             "v": torch.stack([_cache_block(v, pl, spec, c_len)
                               for v in vs])}
    return logits, cache, aux_total


def _placed_loss(model: Transformer, batch: Dict[str, torch.Tensor], pl):
    cfg = model.cfg
    logits, aux = _placed_forward(model, batch["tokens"], pl)
    total, count = cross_entropy_parts(
        logits, batch["labels"], v0=pl.m * logits.shape[-1]
        if _vocab_split(pl) else 0, final_cap=cfg.final_logit_softcap,
        group=pl.tpg if _vocab_split(pl) else None)
    count = coll.all_reduce(count, pl.dpg)
    xent = total / torch.clamp(count, min=1.0)
    loss = xent + cfg.router_aux_coef * aux
    xent_all = coll.all_reduce(xent.detach(), pl.dpg)
    return loss, {"xent": xent_all, "router_aux": aux.detach(),
                  "global_loss": xent_all + cfg.router_aux_coef *
                  aux.detach()}


def _decode_proj(h: torch.Tensor, blk: dict, pl, n: str) -> torch.Tensor:
    """The whole (B, 1, Hx, hd) projection `n` of a decode step: this
    rank's part, gathered over the model ranks."""
    (w, b), = _fetch_attn(blk, pl, n, "keep")
    y = _proj(h, w, b)
    spec = _lspec(pl, f"attn.w{n}")
    for d in (1, 2):
        if pl.on_model(spec, d):
            y = coll.gather_dim(y.contiguous(), pl.tpg, d + 1)
    return y


def _placed_decode(model: Transformer, cache: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, pos: int, pl, routing=None):
    cfg, named, layers = _layers(model)
    b_glob = pl.batch if pl.batch is not None else tokens.shape[0]
    spec = pl.cache_spec(b_glob, pl.cache_len or cache["k"].shape[2])
    _, _, seq_e, k_e, hd_e = spec
    n_s = pl.split(seq_e)
    s_loc = cache["k"].shape[2]
    s0 = pl.mesh.index(seq_e) * s_loc if n_s > 1 else 0
    g = cfg.n_heads // cfg.n_kv_heads
    kc = cache["k"].shape[3]
    k0 = pl.m * kc if pl.split(k_e) > 1 else 0
    hd_split = pl.split(hd_e) > 1
    x = _placed_embed(cfg, named, tokens, pl)[:, None, :]
    windows = _group_windows(cfg)
    plus1 = cfg.post_norm
    pos_arr = torch.tensor([pos], device=tokens.device)
    wo_spec = _lspec(pl, "attn.wo")
    for i, blk in enumerate(layers):
        h = rms_norm(x, blk["ln1"], eps=cfg.norm_eps, plus_one=plus1)
        q = apply_rope(_decode_proj(h, blk, pl, "q"), pos_arr,
                       cfg.rope_theta)
        k = apply_rope(_decode_proj(h, blk, pl, "k"), pos_arr,
                       cfg.rope_theta)
        v = _decode_proj(h, blk, pl, "v")
        # the query heads of this rank's kv heads
        q = q[:, :, k0 * g:(k0 + kc) * g]
        k, v = k[:, :, k0:k0 + kc], v[:, :, k0:k0 + kc]
        if hd_split:
            q, k, v = _hd_slice(q, pl), _hd_slice(k, pl), _hd_slice(v, pl)
        if s0 <= pos < s0 + s_loc:
            cache["k"][i, :, pos - s0] = k[:, 0].to(cache["k"].dtype)
            cache["v"][i, :, pos - s0] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(
            q, cache["k"][i], cache["v"][i], pos=pos, s0=s0,
            window=windows[i % cfg.scan_block],
            logit_cap=cfg.attn_logit_softcap, scale=cfg.head_dim ** -0.5,
            dim_group=pl.tpg if hd_split else None,
            seq_group=pl.group_of(seq_e) if n_s > 1 else None).to(x.dtype)
        if pl.split(k_e) > 1:
            o = coll.gather_dim(o.contiguous(), pl.tpg, 2)
        if hd_split:
            o = coll.gather_dim(o.contiguous(), pl.tpg, 3)
        if pl.on_model(wo_spec, 0):
            n = o.shape[2] // pl.tp
            o = o[:, :, pl.m * n:(pl.m + 1) * n]
        elif pl.on_model(wo_spec, 1):
            o = _hd_slice(o, pl)
        wo = pl.fetch(blk["attn.wo"], wo_spec, "keep")
        o = o.reshape(o.shape[0], 1, -1) @ wo.reshape(-1, wo.shape[-1])
        if pl.on_model(wo_spec, 0) or pl.on_model(wo_spec, 1):
            o = coll.all_reduce(o, pl.tpg)
        if cfg.post_norm:
            o = rms_norm(o, blk["ln1_post"], eps=cfg.norm_eps, plus_one=True)
        x = x + o
        h2 = rms_norm(x, blk["ln2"], eps=cfg.norm_eps, plus_one=plus1)
        if cfg.is_moe:
            m, _ = _placed_moe(h2, blk, cfg, pl, routing)
        elif pl.on_model(_lspec(pl, "mlp.wi"), 1):
            w = [pl.fetch(blk[f"mlp.{n}"], _lspec(pl, f"mlp.{n}"), "keep")
                 for n in ("wi", "wg", "wo")]
            m = coll.all_reduce(mlp_block(h2, *w, cfg.act), pl.tpg)
        else:
            w = [pl.fetch(blk[f"mlp.{n}"], _lspec(pl, f"mlp.{n}"), "keep")
                 for n in ("wi", "wg", "wo")]
            m = mlp_block(h2, *w, cfg.act)
        if cfg.post_norm:
            m = rms_norm(m, blk["ln2_post"], eps=cfg.norm_eps, plus_one=True)
        x = x + m
    x = rms_norm(x, named["final_ln"], eps=cfg.norm_eps, plus_one=plus1)
    head, hspec, vdim = _head(named, pl)
    logits = (x @ (head.t() if vdim == 0 else head))[:, 0]
    if pl.on_model(hspec, vdim):
        logits = coll.gather_dim(logits.contiguous(), pl.tpg, -1)
    return softcap(logits.float(), cfg.final_logit_softcap), cache


# ------------------------------------------------------ numpy exchange ---
# an optimizer state's leaf (adafactor's per-parameter dict) by its keys
_STATE_LEAF_KEYS = ({"v"}, {"vr", "vc"})


def tree_from_named(named: Dict[str, object]) -> dict:
    """{dotted name: x} -> the JAX tree (nested dicts), for parameters
    and optimizer state alike."""
    tree: dict = {}
    for name, x in named.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = x
    return tree


def named_from_tree(tree: dict) -> Dict[str, object]:
    """The inverse of `tree_from_named` (an adafactor state's
    per-parameter dicts stay whole)."""
    out: Dict[str, object] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict) and set(v) not in _STATE_LEAF_KEYS:
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v
    walk(tree, "")
    return out


def params_from_numpy(params: dict) -> Dict[str, torch.Tensor]:
    """A JAX-layout numpy parameter tree, f32 or bf16 -> a
    `Transformer.state_dict()` (CPU tensors; `load_state_dict` copies
    them to the model's device)."""
    return {k: from_numpy(v) for k, v in named_from_tree(params).items()}


def params_to_numpy(model: Transformer) -> dict:
    """The model's parameters as a JAX-layout numpy tree (bf16 ones as
    2-byte void elements, `to_numpy`)."""
    return tree_from_named({k: to_numpy(p)
                            for k, p in model.named_parameters()})
