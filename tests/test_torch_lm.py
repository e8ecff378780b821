"""repro_torch's LM family against the JAX package on the CPU: the five
configs and the registry, the layers (RMSNorm both ways, RoPE, softcap,
the masked cross-entropy), the chunked flash attention forward and
backward over tests/test_attention.py's grid of window, cap and chunk,
decode attention, the MoE's local dispatch (top-k indices and dispatch
slots bit for bit, with capacity drops), the transformer's forward,
loss, gradients, prefill and three decode steps for all five archs at
tests/test_arch_smoke.py's reduced configs (and kimi's through the
driver's `reduced_model`), `TokenStream` bit for bit, adafactor, and
the generic driver's `lm` family, all from the same numpy inputs and
parameters copied across.

Tolerances, stated before the comparison: losses rtol 1e-5; logits,
attention outputs and KV caches rtol 1e-4 / atol 1e-5 (f32 sums taken in
other orders through a few layers); each gradient leaf within 1e-4 of
its L2 norm (max abs difference / norm); optimizer updates rtol 1e-5
(atol 1e-7 for entries that cancel to near zero)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.configs.base import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro.configs.base import TransformerConfig as JTransformerConfig  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import LM_SHAPES, TransformerConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

LOSS_TOL = dict(rtol=1e-5)
OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-4
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
LM_ARCHS = ("gemma2-2b", "kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "qwen2.5-32b",
            "smollm-135m")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small GEMMs: one intra-op thread leaves the other cores to the
    tests that xdist runs beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=OUT_TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


def _grad_close(got, want, what=""):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= GRAD_REL * max(np.linalg.norm(want), 1e-30), \
        (what, err, np.linalg.norm(want))


# ----------------------------------------------------- configs, registry ---
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_configs_match_jax(arch_id):
    jarch, arch = j_get_arch(arch_id), registry.get_arch(arch_id)
    got = _fields(arch.model)
    assert got.pop("reduced") == ()
    assert got == _fields(jarch.model)
    for key in ("arch_id", "family", "source", "optimizer"):
        assert getattr(arch, key) == getattr(jarch, key), key
    assert [_fields(s) for s in LM_SHAPES] == \
        [_fields(s) for s in J_LM_SHAPES]
    assert arch.model.q_dim == jarch.model.q_dim
    assert arch.model.kv_dim == jarch.model.kv_dim
    assert arch.model.n_experts_padded(16) == jarch.model.n_experts_padded(16)
    assert tfm.expert_pad(arch.model) == jtfm.expert_pad(jarch.model)


def test_registry_resolves_every_arch_of_the_jax_registry():
    assert registry.list_archs() == j_list_archs()
    for arch_id in j_list_archs():
        assert registry.get_arch(arch_id).arch_id == arch_id


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_reduced_models_match_the_jax_driver(arch_id):
    got = _fields(train.reduced_model(registry.get_arch(arch_id)))
    assert "the JAX driver's reduced_model" in got.pop("reduced")[0]
    assert got == _fields(jtrain.reduced_model(j_get_arch(arch_id)))


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_param_shapes_match_the_jax_tree(arch_id):
    """`param_shapes` (no allocation) against the JAX tree's leaves at
    the published widths, by jax.eval_shape."""
    jcfg = j_get_arch(arch_id).model
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg)[0],
                            jax.random.PRNGKey(0))
    flat = tfm.named_from_tree(jax.tree_util.tree_map(lambda s: s.shape,
                                                      shapes))
    got = {k: shape for k, (shape, _, _) in
           tfm.param_shapes(registry.get_arch(arch_id).model).items()}
    assert got == {k: tuple(v) for k, v in flat.items()}


# ---------------------------------------------------------------- layers ---
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_matches_jax(plus_one):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 24).astype(np.float32) * 3
    w = rng.randn(24).astype(np.float32) * 0.1
    _close(layers.rms_norm(_t(x), _t(w), eps=1e-6, plus_one=plus_one),
           jlayers.rms_norm(x, w, eps=1e-6, plus_one=plus_one))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 37, 3, 16).astype(np.float32)
    pos = np.arange(37) + 1000
    _close(layers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(x, pos, theta))
    _close(layers.rope_freqs(16, theta), jlayers.rope_freqs(16, theta))


def test_softcap_and_activations_match_jax():
    x = np.linspace(-200, 200, 1001).astype(np.float32)
    _close(layers.softcap(_t(x), 30.0), jlayers.softcap(x, 30.0))
    t = _t(x)
    assert layers.softcap(t, 0.0) is t
    for name in ("silu", "gelu", "relu"):
        _close(layers.activation(name)(_t(x / 50)),
               jlayers.activation(name)(x / 50), what=name)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_entropy_with_masked_labels_matches_jax(cap):
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 50).astype(np.float32) * 20
    labels = rng.randint(0, 50, (2, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[1, 7] = -100
    want = jlayers.cross_entropy_loss(logits, labels, final_cap=cap)
    got = layers.cross_entropy_loss(_t(logits), _t(labels), final_cap=cap)
    _close(got, want, LOSS_TOL)
    # every label masked: the mean over max(count, 1) is 0
    none = np.full_like(labels, -1)
    assert float(layers.cross_entropy_loss(_t(logits), _t(none))) == 0.0


# tests/test_attention.py's grid (s, n_kv, g, hd, window, cap, chunk): each
# value of each axis at least once, a KV tail that is not a whole chunk,
# chunks larger than S (chunk = min(chunk, Skv))
ATTN_GRID = [
    (8, 1, 1, 8, 0, 0.0, 4),
    (17, 2, 2, 8, 4, 30.0, 7),
    (32, 3, 4, 16, 9, 0.0, 16),
    (48, 1, 4, 16, 0, 30.0, 64),
    (33, 2, 2, 8, 5, 50.0, 8),
    (17, 3, 1, 16, 9, 30.0, 4),
    (48, 2, 2, 8, 4, 0.0, 7),
    (32, 1, 2, 8, 0, 50.0, 16),
]


def _qkv(rng, b, sq, skv, n_kv, g, hd):
    return (rng.randn(b, sq, n_kv * g, hd).astype(np.float32),
            rng.randn(b, skv, n_kv, hd).astype(np.float32),
            rng.randn(b, skv, n_kv, hd).astype(np.float32))


@pytest.mark.parametrize("s,n_kv,g,hd,window,cap,chunk", ATTN_GRID)
def test_chunked_attention_and_its_gradients_match_jax(s, n_kv, g, hd, window,
                                                       cap, chunk):
    rng = np.random.RandomState(s * 7 + chunk)
    q, k, v = _qkv(rng, 2, s, s, n_kv, g, hd)
    w = np.cos(np.arange(hd)).astype(np.float32)
    kw = dict(window=window, logit_cap=cap, chunk=chunk)

    def jf(q, k, v):
        return jnp.sum(jnp.sin(jlayers.chunked_attention(q, k, v, **kw)) * w)
    want, jgrads = jax.jit(lambda q, k, v: (
        jlayers.chunked_attention(q, k, v, **kw),
        jax.grad(jf, argnums=(0, 1, 2))(q, k, v)))(q, k, v)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = layers.chunked_attention(qt, kt, vt, **kw)
    _close(out, want)
    (torch.sin(out) * _t(w)).sum().backward()
    for name, t, jg in zip("qkv", (qt, kt, vt), jgrads):
        _grad_close(t.grad, jg, name)


def test_chunked_attention_with_a_q_offset_matches_jax():
    """Queries at positions 20..31 over 32 keys (a prefill continuing a
    cache), windowed and capped."""
    rng = np.random.RandomState(5)
    q, k, v = _qkv(rng, 2, 12, 32, 2, 2, 8)
    kw = dict(q_offset=20, window=6, logit_cap=30.0, chunk=8)
    want, jg = jax.jit(lambda q, k, v: (
        jlayers.chunked_attention(q, k, v, **kw),
        jax.grad(lambda q, k, v: jnp.sum(jlayers.chunked_attention(
            q, k, v, **kw) ** 2), argnums=(0, 1, 2))(q, k, v)))(q, k, v)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = layers.chunked_attention(qt, kt, vt, **kw)
    _close(out, want)
    out.square().sum().backward()
    for name, t, g in zip("qkv", (qt, kt, vt), jg):
        _grad_close(t.grad, g, name)


def test_chunked_attention_builds_no_s_by_s_tensor(monkeypatch):
    """At S = 96 in chunks of 16, no tensor the attention makes, forward
    or backward, has a trailing (96, 96) pair: its scores are (.., 96,
    16) a block."""
    rng = np.random.RandomState(6)
    q, k, v = (_t(x).requires_grad_() for x in _qkv(rng, 1, 96, 96, 1, 2, 8))
    shapes = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.is_tensor(out):
                shapes.append(tuple(out.shape))
            return out
    with Spy():
        out = layers.chunked_attention(q, k, v, chunk=16)
        out.sum().backward()
    assert shapes and all(sh[-2:] != (96, 96) for sh in shapes)
    assert (1, 1, 2, 96, 16) in shapes


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 50.0), (0, 30.0)])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 3, 1, 24, 2, 3, 8)
    for pos in (0, 9, 23):
        _close(layers.decode_attention(_t(q), _t(k), _t(v), pos=pos,
                                       window=window, logit_cap=cap),
               jlayers.decode_attention(q, k, v, pos=pos, window=window,
                                        logit_cap=cap), what=str(pos))


# ------------------------------------------------------------------- moe ---
def _moe_cfgs(**kw):
    base = dict(name="moe-t", n_layers=1, d_model=32, n_heads=2,
                n_kv_heads=1, head_dim=16, d_ff=48, vocab_size=64,
                n_experts=12, n_shared_experts=2, top_k=3, d_expert=24,
                param_dtype="float32")
    base.update(kw)
    return JTransformerConfig(**base), TransformerConfig(**base)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_local_matches_jax_with_bitwise_routing_and_dispatch(cf):
    """12 experts padded to 16 (their router columns at -1e30), top-3,
    two shared experts, 40 tokens; at cf 0.5 the capacity (16) drops
    token-choices. The top-k indices and the dispatch slots (token of each
    slot, which slots are filled) are the reference's bit for bit; the
    combine weights, y and the aux loss within tolerance."""
    jcfg, cfg = _moe_cfgs(capacity_factor=cf)
    e_pad = 16
    params, _ = jmoe.init_moe_params(jax.random.PRNGKey(3), 1, 32, e_pad,
                                     24, 2, jnp.float32)
    p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv
                                                    in v.items()})
         for k, v in _np(params).items()}
    x = np.random.RandomState(8).randn(40, 32).astype(np.float32)
    pt = {k: _t(v) for k, v in tfm.named_from_tree(p).items()}

    jprobs, jw, ji = jax.jit(lambda x, r: jmoe._route(x, r, 12, 3, True))(
        x, p["router"])
    probs, w, i = moe._route(_t(x), pt["router"], 12, 3, True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(w, jw)
    assert float(probs[:, 12:].max()) == 0.0
    cap = moe.capacity_for(40, 3, 12, cf)
    assert cap == jmoe.capacity_for(40, 3, 12, cf)
    jx, jwb, jtok = jax.jit(lambda x, e, w: jmoe._dispatch_local(
        x, e, w, 0, e_pad, cap))(x, np.asarray(ji).reshape(-1),
                                 np.asarray(jw).reshape(-1))
    xb, wb, tok = moe._dispatch_local(_t(x), i.reshape(-1), w.reshape(-1),
                                      0, e_pad, cap)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal((wb != 0).numpy(), np.asarray(jwb) != 0)
    _close(xb, jx)
    _close(wb, jwb)
    filled = int((wb != 0).sum())
    if cf < 1:
        assert filled < 40 * 3          # drops
    else:
        assert filled == 40 * 3

    jy, jaux = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, jcfg, None, e_pad))(
        x, p)
    y, aux = moe.moe_ffn(_t(x), pt, cfg, e_pad)
    _close(y, jy)
    _close(aux, jaux, LOSS_TOL)


# ----------------------------------------------------------- transformer ---
# tests/test_arch_smoke.py's reduced configs (LM_REDUCED), and kimi's
# through the driver's reduced_model
LM_REDUCED = {
    "qwen2-moe-a2.7b": dict(
        name="qwen2-moe-r", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=96, vocab_size=512, n_experts=8,
        n_shared_experts=2, top_k=2, d_expert=48, qkv_bias=True,
        tie_embeddings=False, param_dtype="float32", attn_chunk=32),
    "kimi-k2-1t-a32b": dict(
        name="kimi-r", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=14, d_ff=48, vocab_size=512, n_experts=16,
        n_shared_experts=1, top_k=4, d_expert=48, tie_embeddings=False,
        param_dtype="float32", attn_chunk=32),
    "smollm-135m": dict(
        name="smollm-r", n_layers=3, d_model=48, n_heads=3, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512, tie_embeddings=True,
        param_dtype="float32", attn_chunk=32),
    "gemma2-2b": dict(
        name="gemma2-r", n_layers=4, d_model=48, n_heads=2, n_kv_heads=1,
        head_dim=24, d_ff=96, vocab_size=512, sliding_window=16,
        local_global_alternating=True, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, post_norm=True, scale_embed=True,
        act="gelu", scan_block=2, param_dtype="float32", attn_chunk=32),
    "qwen2.5-32b": dict(
        name="qwen25-r", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=512, qkv_bias=True,
        tie_embeddings=False, param_dtype="float32", attn_chunk=32),
}
MODEL_CASES = sorted(LM_REDUCED) + ["kimi-k2-1t-a32b/driver"]


def _model_cfgs(case):
    if case.endswith("/driver"):
        jcfg = jtrain.reduced_model(j_get_arch(case.split("/")[0]))
    else:
        jcfg = JTransformerConfig(**LM_REDUCED[case])
    return jcfg, TransformerConfig(**_fields(jcfg))


def _models(case, seed=0):
    """(JAX config, port config, numpy params, port model with them);
    biases and norm weights perturbed off their zeros and ones, so that
    every parameter reaches the outputs."""
    jcfg, cfg = _model_cfgs(case)
    params = _np(jtfm.init_params(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.RandomState(seed + 10)
    named = tfm.named_from_tree(params)
    for k, v in named.items():
        if "ln" in k or k.startswith("blocks.attn.b"):
            named[k] = (v + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
    params = tfm.tree_from_named(named)
    model = tfm.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(tfm.params_from_numpy(params))
    return jcfg, cfg, params, model


def _tokens(rng, b, s, vocab=512):
    return rng.randint(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_forward_loss_and_gradients_match_jax(case):
    """Sequences of 40 (a KV tail of 8 past chunks of 32; gemma's local
    layers mask at a window of 16), labels with masked positions."""
    jcfg, cfg, params, model = _models(case)
    rng = np.random.RandomState(11)
    batch = {"tokens": _tokens(rng, 2, 40), "labels": _tokens(rng, 2, 40)}
    batch["labels"][0, :5] = -1
    (jlogits, jaux), ((jloss, jm), jgrads) = jax.jit(lambda p, b: (
        jtfm.forward(p, jcfg, b["tokens"]),
        jax.value_and_grad(lambda p: jtfm.loss_fn(p, jcfg, b),
                           has_aux=True)(p)))(params, batch)
    with torch.no_grad():
        logits, aux = tfm.forward(model, _t(batch["tokens"]))
    _close(logits, jlogits)
    _close(aux, jaux, dict(rtol=1e-5, atol=1e-7))

    named = dict(model.named_parameters())
    loss, metrics = tfm.loss_fn(model, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()))
    _close(loss, jloss, LOSS_TOL)
    _close(metrics["xent"], jm["xent"], LOSS_TOL)
    jnamed = tfm.named_from_tree(_np(jgrads))
    assert set(jnamed) == set(named)
    for (k, _), g in zip(named.items(), grads):
        _grad_close(g, jnamed[k], k)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_prefill_and_three_decode_steps_match_jax(case):
    """Prefill of 37 tokens, then three decode steps at 37, 38, 39 over a
    cache of 40; the decode logits also equal the port's own full
    forward's softcapped logits at those positions (for the MoE archs
    from a prefill and a forward that drop no token-choice,
    `moe.drop_free`: at T = 80 tokens the published capacity drops some,
    at a decode step's 2 it drops none)."""
    jcfg, cfg, params, model = _models(case, seed=2)
    rng = np.random.RandomState(12)
    toks = _tokens(rng, 2, 40)
    s0 = 37
    jlast, jcache = jax.jit(lambda p, t: jtfm.prefill(p, jcfg, t))(
        params, toks[:, :s0])
    last, cache = tfm.prefill(model, _t(toks[:, :s0]))
    _close(last, jlast)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], what=name)

    jbig = jtfm.init_cache(jcfg, 2, 40, dtype=jnp.float32)
    jbig = {n: jbig[n].at[:, :, :s0].set(jcache[n]) for n in ("k", "v")}
    big = tfm.init_cache(cfg, 2, 40, dtype=torch.float32, device="cpu")
    for n in ("k", "v"):
        big[n][:, :, :s0] = cache[n]
    jdecode = jax.jit(lambda p, c, t, pos: jtfm.decode_step(p, jcfg, c, t,
                                                            pos))
    for pos in range(s0, 40):
        jl, jbig = jdecode(params, jbig, toks[:, pos], pos)
        got, big = tfm.decode_step(model, big, _t(toks[:, pos]), pos)
        _close(got, jl, what=f"decode {pos}")
    for n in ("k", "v"):
        _close(big[n], jbig[n], what=n)

    if cfg.is_moe:
        free = tfm.Transformer(moe.drop_free(cfg), device="cpu")
        free.load_state_dict(model.state_dict())
        model = free
        _, cache = tfm.prefill(model, _t(toks[:, :s0]))
        big = tfm.init_cache(cfg, 2, 40, dtype=torch.float32, device="cpu")
        for n in ("k", "v"):
            big[n][:, :, :s0] = cache[n]
    with torch.no_grad():
        full, _ = tfm.forward(model, _t(toks))
    full = layers.softcap(full.float(), cfg.final_logit_softcap)
    for pos in range(s0, 40):
        got, big = tfm.decode_step(model, big, _t(toks[:, pos]), pos)
        _close(got, full[:, pos], what=f"forward {pos}")


def test_remat_none_gives_the_same_gradients_as_full():
    _, cfg, _, model = _models("gemma2-2b")
    plain = tfm.init_params(cfg.replace(remat="none"), seed=1, device="cpu")
    plain.load_state_dict(model.state_dict())
    rng = np.random.RandomState(13)
    batch = {"tokens": _t(_tokens(rng, 2, 24)),
             "labels": _t(_tokens(rng, 2, 24))}
    ga = torch.autograd.grad(tfm.loss_fn(model, batch)[0],
                             list(model.parameters()))
    gb = torch.autograd.grad(tfm.loss_fn(plain, batch)[0],
                             list(plain.parameters()))
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ data, optim ---
def test_token_stream_is_bitwise_the_references():
    a = jsynthetic.TokenStream(49152, 65, seed=3)
    b = synthetic.TokenStream(49152, 65, seed=3)
    for n in (4, 1, 7):
        x, y = a.batch(n), b.batch(n)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_adafactor_matches_jax_over_three_steps():
    """A factored (256, 192) leaf, a factored stacked (2, 128, 160) leaf
    and a (7,) leaf with a full second moment, lr 1e-2 with no warmup;
    parameters and state after each of three steps."""
    rng = np.random.RandomState(14)
    params = {"w": rng.randn(256, 192).astype(np.float32) * 0.05,
              "s": rng.randn(2, 128, 160).astype(np.float32) * 0.05,
              "b": rng.randn(7).astype(np.float32)}
    jopt = joptim.make_optimizer("adafactor", lr=1e-2, warmup=0,
                                 total_steps=10)
    opt = optim.make_optimizer("adafactor", lr=1e-2, warmup=0,
                               total_steps=10)
    assert opt.name == "adafactor"
    jp, js = params, jopt.init(params)
    jupdate = jax.jit(jopt.update)
    p = {k: _t(v) for k, v in params.items()}
    s = opt.init(p)
    assert set(s["f"]["w"]) == {"vr", "vc"} and set(s["f"]["b"]) == {"v"}
    assert s["f"]["s"]["vc"].shape == (2, 160)
    for step in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
             params.items()}
        jp, js, jstats = jupdate(g, js, jp, step)
        p, s, stats = opt.update({k: _t(v) for k, v in g.items()}, s, p,
                                 step)
        for k in params:
            _close(p[k], jp[k], OPT_TOL, f"{k} step {step}")
            for name, st in s["f"][k].items():
                _close(st, js["f"][k][name], OPT_TOL, f"{k}.{name}")
        _close(stats["grad_norm"], jstats["grad_norm"], OPT_TOL)


# ---------------------------------------------------------------- driver ---
@pytest.mark.parametrize("arch_id", ["gemma2-2b", "kimi-k2-1t-a32b"])
def test_drivers_give_the_same_losses(monkeypatch, arch_id):
    """Five steps of both drivers' reduced runs (TokenStream sequences of
    64, batch 32; gemma's adam, kimi's adafactor, lr 1e-3 under
    warmup-cosine) from the same parameters: losses within rtol 1e-5."""
    steps = 5
    jarch = j_get_arch(arch_id)
    jcfg = jtrain.reduced_model(jarch)
    params = _np(jtrain.init_params_for(jarch, jcfg, jax.random.PRNGKey(0)))
    opt = joptim.make_optimizer(jarch.optimizer, lr=1e-3)
    p, s = params, opt.init(params)
    step_fn = jax.jit(j_make_train_step(jtrain.make_loss_fn(jarch, jcfg),
                                        opt))
    batch_fn = jtrain.make_batch_fn(jarch, jcfg, 32,
                                    np.random.RandomState(0))
    want = []
    for i in range(steps):
        p, s, metrics = step_fn(p, s, i, batch_fn())
        want.append(float(metrics["loss"]))
    port_init = train.init_params_for

    def init_from_jax(*a, **kw):
        model = port_init(*a, **kw)
        model.load_state_dict(tfm.params_from_numpy(params))
        return model
    monkeypatch.setattr(train, "init_params_for", init_from_jax)
    res = train.run(arch_id, steps=steps, device="cpu")
    assert res["steps"] == steps and res["batch"] == 32
    assert res["tokens_per_s"] > 0
    np.testing.assert_allclose(res["losses"], want, **LOSS_TOL)


def test_driver_cli_checkpoints_adafactor_and_resumes(tmp_path, capsys):
    """kimi's reduced run through the CLI: adafactor's factored and full
    state in the JAX layout, a resume, and the steps JSON."""
    d, steps_json = str(tmp_path / "ck"), str(tmp_path / "steps.json")
    first = train.main(["--arch", "kimi-k2-1t-a32b", "--steps", "3",
                        "--ckpt-dir", d, "--device", "cpu",
                        "--steps-json", steps_json])
    assert first["steps"] == 3 and ckpt.latest_step(d) == 2
    tree, _ = ckpt.restore(d, "cpu")
    # no leaf of the reduced widths has two dims of 128: every state is v
    state = tfm.named_from_tree(tree["opt_state"]["f"])
    assert set(state) == set(tfm.param_shapes(train.reduced_model(
        registry.get_arch("kimi-k2-1t-a32b"))))
    assert all(set(x) == {"v"} for x in state.values())
    jtree, _ = jckpt.restore(d)
    # 8 experts padded to 16
    assert jtree["opt_state"]["f"]["blocks"]["moe"]["wi"]["v"].shape == \
        (2, 16, 64, 48)
    second = train.main(["--arch", "kimi-k2-1t-a32b", "--steps", "5",
                         "--ckpt-dir", d, "--device", "cpu"])
    assert second["steps"] == 2 and ckpt.latest_step(d) == 4
    assert "resumed from step 2" in capsys.readouterr().out
    rows = json.loads(open(steps_json).read())
    assert [(r["arch"], r["shape"], r["batch"], r["seq_len"], r["device"])
            for r in rows] == [("kimi-k2-1t-a32b", "driver_small", 32, 64,
                                "cpu")]
    assert rows[0]["step_s"] > 0


@pytest.mark.parametrize("arch_id,fits", [
    ("smollm-135m", True), ("gemma2-2b", True), ("qwen2-moe-a2.7b", False),
    ("qwen2.5-32b", False), ("kimi-k2-1t-a32b", False)])
def test_full_width_training_is_refused_where_it_exceeds_one_device(arch_id,
                                                                    fits):
    arch = registry.get_arch(arch_id)
    need = train.lm_state_bytes(arch.model, arch.optimizer)
    assert (need <= train.DEVICE_BYTES) == fits, need
    if fits:
        train.check_fits_one_device(arch, arch.model)
    else:
        with pytest.raises(ValueError, match="queue 1, item 9"):
            train.run(arch_id, steps=1, full=True, device="meta")
