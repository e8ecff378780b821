"""The LM family's bf16 path against the JAX package on the CPU: the
five archs at tests/test_arch_smoke.py's reduced configs (as
tests/test_torch_lm.py takes them) with bf16 parameters, both packages'
forward, prefill and three decode steps from the same copied weights,
bf16 KV caches.

The logits are held within a tolerance stated here before the first
run: at every position (for the MoE archs, every position that no
routing difference reaches, below) the largest absolute difference at
most 0.25, the mean at most 0.04 and the cosine similarity at least
0.999 (bf16 rounds each activation to 8 bits, and the two packages sum
in other orders).

For the two MoE archs the top-k expert indices are compared position by
position, port against reference, on each path (forward, prefill, each
decode step); and each package's own decode-versus-forward flips (a
decode position whose top-k differs from the forward's at the same
position, the forward taken without capacity drops as a decode step of
two tokens has none) are counted side by side: the port may flip only
where the reference flips on the same inputs. A token is routed
otherwise where its set of top-k experts differs on some layer (the
order within the top-k, which swaps two near-equal weights, moves no
token). Such a token's hidden state differs from its layer on, and the
attention carries it to every later position of its sequence (through
the KV cache in decode), so a position is held only where no token at
or before it in its sequence was routed otherwise.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TransformerConfig as JTransformerConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs.base import TransformerConfig  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from test_torch_lm import LM_REDUCED  # noqa: E402

TOL = dict(max_abs=0.25, mean_abs=0.04, cos=0.999)
NEAR_TIE = 2.0 ** -5
CAP = 8
S0, S = 37, 40     # the prompt, then decode steps at 37, 38, 39


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch_id, **kw):
    d = dict(LM_REDUCED[arch_id], param_dtype="bfloat16", **kw)
    jcfg = JTransformerConfig(**d)
    return jcfg, TransformerConfig(**d)


def _models(arch_id, seed=3):
    jcfg, cfg = _cfgs(arch_id)
    params = jax.tree_util.tree_map(
        np.asarray, jtfm.init_params(jax.random.PRNGKey(seed), jcfg)[0])
    rng = np.random.RandomState(seed + 10)
    named = tfm.named_from_tree(params)
    for k, v in named.items():
        if "ln" in k or k.startswith("blocks.attn.b"):
            named[k] = (v.astype(np.float32)
                        + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
    params = tfm.tree_from_named(named)
    model = tfm.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(tfm.params_from_numpy(params))
    return jcfg, cfg, params, model


@contextlib.contextmanager
def _jax_routing(rec, probs_rec):
    """The reference's top-k indices and router probabilities, appended
    to `rec` and `probs_rec` in call order (layer by layer) through an
    ordered debug callback around its router (the JAX package is not
    edited)."""
    orig = jmoe._route

    def keep(t, p):
        rec.append(np.asarray(t))
        probs_rec.append(np.asarray(p))

    def route(*args):
        probs, topw, topi = orig(*args)
        jax.debug.callback(keep, topi, probs, ordered=True)
        return probs, topw, topi
    jmoe._route = route
    try:
        yield
    finally:
        jmoe._route = orig


def _f(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _stats(got, want):
    """Per position (rows of the last axis): max and mean |difference|
    and the cosine similarity."""
    g = _f(got).reshape(-1, got.shape[-1]).astype(np.float64)
    w = _f(want).reshape(-1, want.shape[-1]).astype(np.float64)
    diff = np.abs(g - w)
    cos = (g * w).sum(-1) / np.maximum(
        np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1), 1e-30)
    return diff.max(-1), diff.mean(-1), cos


def _hold(got, want, keep, what):
    mx, mean, cos = _stats(got, want)
    assert keep.any(), f"{what}: no position to hold"
    mx, mean, cos = mx[keep], mean[keep], cos[keep]
    assert mx.max() <= TOL["max_abs"] and mean.max() <= TOL["mean_abs"] \
        and cos.min() >= TOL["cos"], \
        (what, float(mx.max()), float(mean.max()), float(cos.min()))


def _experts(topi):
    """A token's set of top-k experts: its indices sorted (a swap of two
    near-equal weights within the top-k moves no token)."""
    return np.sort(np.asarray(topi), axis=-1)


def _agree(port, ref):
    """Per token: whether the top-k experts agree on every layer. port,
    ref: lists (one a layer) of (T, k)."""
    assert len(port) == len(ref)
    ok = np.ones(port[0].shape[0], bool)
    for p, r in zip(port, ref):
        ok &= (_experts(p) == _experts(r)).all(-1)
    return ok


def _jax_run(jcfg, params, toks):
    """The reference's forward logits, prefill, three decode steps, each
    with its routing and router probabilities; and its drop-free
    forward's."""
    rec, probs = {}, {}

    def _jax_routing_of(path):
        return _jax_routing(rec.setdefault(path, []),
                            probs.setdefault(path, []))
    with _jax_routing_of("forward"):
        logits, _ = jax.jit(lambda p, t: jtfm.forward(p, jcfg, t))(
            params, toks)
        jax.effects_barrier()
    with _jax_routing_of("prefill"):
        last, cache = jax.jit(lambda p, t: jtfm.prefill(p, jcfg, t))(
            params, toks[:, :S0])
        jax.effects_barrier()
    big = jtfm.init_cache(jcfg, toks.shape[0], S, dtype=jnp.bfloat16)
    big = {n: big[n].at[:, :, :S0].set(cache[n]) for n in ("k", "v")}
    decodes = []
    for pos in range(S0, S):
        with _jax_routing_of(f"decode {pos}"):
            lg, big = jax.jit(lambda p, c, t: jtfm.decode_step(
                p, jcfg, c, t, pos))(params, big, toks[:, pos])
            jax.effects_barrier()
        decodes.append(np.asarray(lg))
    if jcfg.n_experts:
        free = jcfg.replace(capacity_factor=jcfg.n_experts / jcfg.top_k)
        with _jax_routing_of("forward drop-free"):
            jax.jit(lambda p, t: jtfm.forward(p, free, t))(params, toks)
            jax.effects_barrier()
    return np.asarray(logits), np.asarray(last), decodes, rec, probs


def _port_run(cfg, model, toks):
    rec = {}
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits, _ = tfm.forward(model, t, routing=rec.setdefault(
            "forward", []))
    last, cache = tfm.prefill(model, t[:, :S0],
                              routing=rec.setdefault("prefill", []))
    big = tfm.init_cache(cfg, toks.shape[0], S, dtype=torch.bfloat16,
                         device="cpu")
    for n in ("k", "v"):
        big[n][:, :, :S0] = cache[n]
    decodes = []
    for pos in range(S0, S):
        lg, big = tfm.decode_step(model, big, t[:, pos], pos,
                                  routing=rec.setdefault(f"decode {pos}", []))
        decodes.append(lg)
    if cfg.is_moe:
        free = tfm.Transformer(moe.drop_free(cfg), device="cpu")
        free.load_state_dict(model.state_dict())
        with torch.no_grad():
            tfm.forward(free, t, routing=rec.setdefault(
                "forward drop-free", []))
    rec = {k: [r.numpy() for r in v] for k, v in rec.items()}
    return logits, last, decodes, rec


def _first_differences(port, ref, clean=None):
    """The (layer, token) routing differences whose router inputs both
    packages computed under the same routing: with `clean` None (a
    forward or prefill path, where tokens meet in attention and in the
    capacity drops) every difference at the lowest layer that has any;
    else (a decode step, its tokens apart) each token clean before the
    step at its lowest differing layer."""
    diff = [(_experts(p) != _experts(r)).any(-1) for p, r in zip(port, ref)]
    if clean is None:
        for layer, d in enumerate(diff):
            if d.any():
                return [(layer, int(t)) for t in np.flatnonzero(d)]
        return []
    out = []
    for t in np.flatnonzero(clean):
        for layer, d in enumerate(diff):
            if d[t]:
                out.append((layer, int(t)))
                break
    return out


def _near_tie(probs, top_k, layer, token):
    """ln(p_k / p_(k+1)) of the reference's router probabilities of
    `token` at `layer`: how near its k-th expert ties the next."""
    p = np.sort(probs[layer].reshape(-1, probs[layer].shape[-1])[token]
                .astype(np.float64))[::-1]
    return float(np.log(p[top_k - 1]) - np.log(p[top_k]))


def _flips(rec, b):
    """Decode-versus-forward flips: for each decode position, the tokens
    (of the batch of b) whose top-k differs from the drop-free
    forward's at that position on some layer: {pos: (b,) bool}."""
    fwd = [_experts(r).reshape(b, S, -1) for r in rec["forward drop-free"]]
    out = {}
    for pos in range(S0, S):
        dec = rec[f"decode {pos}"]
        flip = np.zeros(b, bool)
        for f, d in zip(fwd, dec):
            flip |= (f[:, pos] != _experts(d)).any(-1)
        out[pos] = flip
    return out


@pytest.mark.parametrize("arch_id", sorted(LM_REDUCED))
def test_bf16_forward_prefill_and_decode_match_jax(arch_id):
    jcfg, cfg, params, model = _models(arch_id)
    rng = np.random.RandomState(21)
    toks = rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jlogits, jlast, jdec, jrec, jprobs = _jax_run(jcfg, params, toks)
    logits, last, dec, rec = _port_run(cfg, model, toks)
    b = toks.shape[0]
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16

    if not cfg.is_moe:
        keep = {k: np.ones(b * (S if k == "forward" else 1), bool)
                for k in ("forward", "prefill")}
        keep.update({f"decode {p}": np.ones(b, bool) for p in range(S0, S)})
    else:
        # the routing of each path, port against reference, token by token
        keep = {}
        for path in jrec:
            keep[path] = _agree(rec[path], jrec[path])
            n_off = int((~keep[path]).sum())
            print(f"{arch_id} {path}: {n_off} of {keep[path].size} tokens "
                  f"routed otherwise than the reference")
            assert n_off <= -(-keep[path].size // CAP), (path, n_off)
        # each first difference sits at a near tie of the reference
        for path in jrec:
            before = None
            if path.startswith("decode"):
                before = keep["prefill"].reshape(b, S0).all(axis=1)
                for q in range(S0, int(path.split()[1])):
                    before = before & keep[f"decode {q}"]
            for layer, tok in _first_differences(rec[path], jrec[path],
                                                 before):
                gap = _near_tie(jprobs[path], cfg.top_k, layer, tok)
                print(f"{arch_id} {path}: token {tok} layer {layer} routed "
                      f"otherwise at ln(p_k / p_(k+1)) {gap:.3e}")
                assert gap <= NEAR_TIE, (path, layer, tok, gap)
        # causally: no token at or before the position routed otherwise
        keep["forward"] = np.logical_and.accumulate(
            keep["forward"].reshape(b, S), axis=1).reshape(-1)
        clean = keep["prefill"].reshape(b, S0).all(axis=1)
        keep["prefill"] = clean
        for pos in range(S0, S):
            clean = clean & keep[f"decode {pos}"]
            keep[f"decode {pos}"] = clean
        jflip, flip = _flips(jrec, b), _flips(rec, b)
        for pos in range(S0, S):
            print(f"{arch_id} decode {pos}: flips against the forward, "
                  f"port {flip[pos].tolist()}, reference "
                  f"{jflip[pos].tolist()}")
            assert not (flip[pos] & ~jflip[pos]).any(), \
                (pos, flip[pos], jflip[pos])

    _hold(logits, jlogits, keep["forward"], f"{arch_id} forward")
    _hold(last, jlast, keep["prefill"], f"{arch_id} prefill")
    for pos, got, want in zip(range(S0, S), dec, jdec):
        _hold(got, want, keep[f"decode {pos}"], f"{arch_id} decode {pos}")
    # the decode's logits are f32 and softcapped, as the forward's are
    # after `softcap`
    assert dec[0].dtype == torch.float32
    full = layers.softcap(logits.float(), cfg.final_logit_softcap)
    assert full.shape == (b, S, cfg.vocab_size)
