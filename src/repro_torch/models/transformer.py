"""Decoder-only transformer family covering the five LM archs, in
PyTorch on one device (port of repro/models/transformer.py).

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
  - tied or untied LM head.

Parameters keep the JAX tree's names and layout: `embed.table` (V, D),
`blocks.attn.wq` (L, D, H, hd), `blocks.moe.shared.wo` (L, n_shared * F,
D), ... (`param_shapes`). `tree_from_named` / `named_from_tree` map the
module's dotted names to the JAX tree and back (parameters and
optimizer state alike); `params_from_numpy` carries a JAX parameter
tree, as numpy, into the module, so that checkpoints of either package
restore in the other.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.exchange import from_numpy, to_numpy
from repro_torch.models.layers import (
    apply_rope, chunked_attention, cross_entropy_loss, decode_attention,
    mlp_block, rms_norm, softcap)

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


class Transformer(nn.Module):
    """The parameters of `param_shapes`, registered under their dotted
    names (`named_parameters()` gives `blocks.attn.wq`, ...)."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for name, (shape, init, dtype) in param_shapes(cfg).items():
            t = torch.empty(shape, dtype=dtype, device=device)
            with torch.no_grad():
                if init == "zeros":
                    t.zero_()
                elif init == "ones":
                    t.fill_(1.0)
                else:
                    t.normal_(generator=generator).mul_(init ** -0.5)
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(t))


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device="cuda") -> Transformer:
    """A Transformer with random weights drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, device=device, generator=gen)


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
           tokens: torch.Tensor) -> torch.Tensor:
    x = F.embedding(tokens, table)
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


def _ffn(h2: torch.Tensor, blk: dict, cfg: TransformerConfig):
    """(m, aux) of the layer's MLP or MoE."""
    if cfg.is_moe:
        p = {k[len("moe."):]: v for k, v in blk.items()
             if k.startswith("moe.")}
        return moe_lib.moe_ffn(h2, p, cfg, expert_pad(cfg))
    m = mlp_block(h2, blk["mlp.wi"], blk["mlp.wg"], blk["mlp.wo"], cfg.act)
    return m, torch.zeros((), dtype=torch.float32, device=h2.device)


def _one_layer(x, blk: dict, window: int, positions, cfg: TransformerConfig):
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
    m, aux = _ffn(h2, blk, cfg)
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
            return_cache: bool = False):
    """Full-sequence forward. tokens: (B, S) int.

    Returns (logits (B, S, V) in the parameter dtype, aux) [, cache
    {"k", "v"}: (L, B, S, K, hd), the post-RoPE keys and the values]."""
    cfg, named, layers = _layers(model)
    S = tokens.shape[1]
    x = _embed(cfg, named["embed.table"], tokens)
    positions = torch.arange(S, device=tokens.device)
    windows = _group_windows(cfg)
    blk_sz = cfg.scan_block
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []

    def group(x, aux_sum, g0: int):
        kvs = []
        for j in range(blk_sz):
            x, aux, kv = _one_layer(x, layers[g0 + j], windows[j], positions,
                                    cfg)
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
            x, aux_total, kvs = group(x, aux_total, g0)
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


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]):
    """batch: {"tokens": (B, S), "labels": (B, S)}. Returns (loss,
    metrics)."""
    cfg = model.cfg
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
def prefill(model: Transformer, tokens: torch.Tensor):
    """Forward over the prompt: (last-token logits (B, V), not
    softcapped, in the parameter dtype; cache (L, B, S, K, hd))."""
    logits, cache, _ = forward(model, tokens, return_cache=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: int):
    """One decode step. tokens: (B,) int; pos: the position decoded, the
    same for the whole batch.

    Returns (logits (B, V), f32 and softcapped, cache). The cache's
    entries at `pos` are written in place (the reference returns a new
    cache; at full width a copy a step would double its memory)."""
    cfg, named, layers = _layers(model)
    x = _embed(cfg, named["embed.table"], tokens)[:, None, :]   # (B, 1, D)
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
        m, _ = _ffn(h2, blk, cfg)
        if cfg.post_norm:
            m = rms_norm(m, blk["ln2_post"], eps=cfg.norm_eps, plus_one=True)
        x = x + m
    x = rms_norm(x, named["final_ln"], eps=cfg.norm_eps, plus_one=plus1)
    logits = softcap(_logits(x, named)[:, 0].float(),
                     cfg.final_logit_softcap)
    return logits, cache


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
