"""repro_torch's xDeepFM, DIEN and BERT4Rec against the JAX package on the
CPU: the configs, the registry and the driver's reduced configs, the
synthetic DIEN and BERT4Rec batches bit for bit, the parameter layout,
each model's forward, loss and every gradient, BERT4Rec's full-softmax
loss, the retrieval scoring of all four recsys archs, the microbatched
train step, the generic driver and a checkpoint both ways, all from the
same numpy inputs and parameters copied across.

Tolerances: f32 forwards and losses rtol 1e-5 / atol 1e-6 (the ports
sum the same products in other orders: einsum contractions, the
attention's and the GRU's GEMMs), BERT4Rec's logits atol 1e-5 (three
layer norms and two blocks of attention and GELU before a sum over d
= 64 put a few ulps of O(1) values on every logit); gradients rtol 1e-4
/ atol 1e-6 (sums over the batch and the sequence in other orders);
parameters after one step rtol 1e-4 / atol 1e-4 (1% of the step's lr
1e-2: adam's m / sqrt(v) turns a small gradient's rounding into a
visible share of a step); driver losses over five steps rtol 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import RecsysConfig as JRecsysConfig  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RecsysConfig  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: E402

ARCHS = ("xdeepfm", "dien", "bert4rec")
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = {"xdeepfm": FWD_TOL, "dien": FWD_TOL,
             "bert4rec": dict(rtol=1e-5, atol=1e-5)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _fields(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# small configs: the driver's reduced ones, and the published widths with a
# small vocab (xDeepFM's 39 features, CIN 200-200-200 and DNN 400-400;
# DIEN's sequences of 100, GRU 108; BERT4Rec's d 64, sequences of 200, 20
# masked positions and 127 negatives)
WIDE = {
    "xdeepfm": dict(vocab_sizes=(64,) * 39),
    "dien": dict(vocab_sizes=(128,)),
    "bert4rec": dict(n_items=256, vocab_sizes=(256,)),
}


def _configs(arch_id, size="reduced"):
    """(JAX config, port config) of arch_id: the drivers' reduced configs,
    or the published widths with the vocab of WIDE."""
    if size == "reduced":
        return (jtrain.reduced_model(j_get_arch(arch_id)),
                train.reduced_model(registry.get_arch(arch_id)))
    kw = _fields(j_get_arch(arch_id).model)
    kw.update(WIDE[arch_id])
    jcfg = JRecsysConfig(**kw)
    kw.pop("tp_lookup"), kw.pop("sharding_overrides")
    return jcfg, RecsysConfig(**kw)


def _jax_params(jcfg, seed=0):
    params, _ = jrecsys.INIT[jcfg.name](jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg, np_params):
    model = recsys.init_model(cfg, seed=1, device="cpu")
    model.load_state_dict(recsys.params_from_numpy(np_params))
    return model


def _batch(cfg, n, seed=0):
    """n synthetic records of cfg's arch, as the drivers make them."""
    rng = np.random.RandomState(seed)
    if cfg.name == "dien":
        return synthetic.dien_batch(rng, n, cfg.seq_len, cfg.vocab_sizes[0],
                                    cfg.n_dense)
    if cfg.name == "bert4rec":
        return synthetic.bert4rec_batch(rng, n, cfg.seq_len, cfg.n_items,
                                        cfg.n_mask, cfg.n_negatives)
    stream = synthetic.CriteoStream(n_sparse=cfg.n_sparse,
                                    n_dense=cfg.n_dense,
                                    vocab=cfg.vocab_sizes[0],
                                    multi_hot=cfg.multi_hot, seed=seed)
    return stream.feature_udf(stream.raw_block(n))


def _jax_loss_fn(jcfg):
    if jcfg.name == "bert4rec":
        return lambda p, b: jrecsys.bert4rec_loss(p, jcfg, b)
    return lambda p, b: jrecsys.ctr_loss(p, jcfg, b,
                                         jrecsys.FORWARD[jcfg.name])


def _jax_out(jcfg, jp, jb):
    if jcfg.name == "bert4rec":
        return jrecsys.bert4rec_sampled_logits(jp, jcfg, jb)
    return jrecsys.FORWARD[jcfg.name](jp, jcfg, jb)


def _port_out(model, tb):
    if isinstance(model, recsys.BERT4Rec):
        return model.sampled_logits(tb)
    return model(tb)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in batch.items()}


def _assert_trees_close(got, want, **tol):
    want, got = _flat(want), _flat(got)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ----------------------------------------------------- configs, registry ---
@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_match_jax(arch_id):
    arch, jarch = registry.get_arch(arch_id), j_get_arch(arch_id)
    got, want = _fields(arch.model), _fields(jarch.model)
    assert set(want) - set(got) == {"tp_lookup", "sharding_overrides"}
    assert got.pop("reduced") == ()
    assert got == {k: v for k, v in want.items() if k in got}
    for key in ("arch_id", "family", "source", "optimizer"):
        assert getattr(arch, key) == getattr(jarch, key), key
    assert [_fields(s) for s in arch.shapes] == \
        [_fields(s) for s in jarch.shapes]
    assert arch.shape("train_batch").batch == 65536
    assert arch.shape("retrieval_cand").n_candidates == 1_000_000


@pytest.mark.parametrize("arch_id", ARCHS)
def test_registry_resolves_the_new_archs(arch_id):
    arch = registry.get_arch(arch_id)
    assert arch.arch_id == arch_id and arch.family == "recsys"
    assert arch_id in registry.list_archs()
    assert arch.model.name == arch_id


@pytest.mark.parametrize("arch_id", ARCHS)
def test_reduced_model_matches_jax_driver(arch_id):
    got = _fields(train.reduced_model(registry.get_arch(arch_id)))
    want = _fields(jtrain.reduced_model(j_get_arch(arch_id)))
    assert got.pop("reduced")
    assert got == {k: v for k, v in want.items() if k in got}


# ------------------------------------------------------------- batches ----
@pytest.mark.parametrize("batch,seq_len,n_items,n_dense,seed", [
    (64, 100, 1 << 20, 8, 0), (33, 16, 512, 8, 3), (5, 7, 11, 2, 9)])
def test_dien_batch_matches_jax_bitwise(batch, seq_len, n_items, n_dense,
                                        seed):
    a_rng, b_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        a = jsynthetic.dien_batch(a_rng, batch, seq_len, n_items, n_dense)
        b = synthetic.dien_batch(b_rng, batch, seq_len, n_items, n_dense)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["hist_ids"].shape == (batch, seq_len)
    assert b["hist_ids"].dtype == np.int32
    assert (b["hist_mask"].sum(1) >= seq_len // 4).all()


@pytest.mark.parametrize("batch,seq_len,n_items,n_mask,n_neg,seed", [
    (16, 200, 1 << 20, 20, 127, 0), (32, 16, 512, 3, 7, 4),
    (3, 5, 9, 5, 1, 2)])
def test_bert4rec_batch_matches_jax_bitwise(batch, seq_len, n_items, n_mask,
                                            n_neg, seed):
    a_rng, b_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):
        a = jsynthetic.bert4rec_batch(a_rng, batch, seq_len, n_items,
                                      n_mask, n_neg)
        b = synthetic.bert4rec_batch(b_rng, batch, seq_len, n_items,
                                     n_mask, n_neg)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert b["neg_ids"].shape == (batch, n_mask, n_neg)
    rows = np.arange(batch)[:, None]
    assert (b["item_seq"][rows, b["mask_pos"]] == n_items).all()


# ---------------------------------------------------------- parameters ----
@pytest.mark.parametrize("arch_id", ARCHS)
def test_init_draws_the_jax_shapes_and_scales(arch_id):
    """Random init from a torch.Generator: the JAX tree's shapes, its
    zeros and ones, and the JAX scales of the item and feature tables."""
    jcfg, cfg = _configs(arch_id, "wide")
    model = recsys.init_model(cfg, seed=0, device="cpu")
    got = recsys.params_to_numpy(model)
    want = _flat(_jax_params(jcfg))
    assert {k: v.shape for k, v in _flat(got).items()} == \
        {k: v.shape for k, v in want.items()}
    if arch_id == "xdeepfm":
        assert got["tables"].std() == pytest.approx(10 ** -0.5, rel=0.05)
        assert got["linear"].std() == pytest.approx(0.01, rel=0.05)
        assert got["cin"][1].std() == pytest.approx((200 * 39) ** -0.5,
                                                    rel=0.05)
        assert float(got["bias"]) == 0.0
    if arch_id == "dien":
        assert got["items"].std() == pytest.approx(18 ** -0.5, rel=0.05)
        assert not got["gru1"]["b"].any() and not got["gru2"]["b"].any()
    if arch_id == "bert4rec":
        # n_items + MASK + PAD, padded to a multiple of 16
        assert got["items"].shape == (272, 64)
        assert got["items"].std() == pytest.approx(64 ** -0.5, rel=0.05)
        assert got["pos"].std() == pytest.approx(0.02, rel=0.05)
        assert (got["blocks"][0]["ln1"] == 1).all()
        assert got["blocks"][1]["wqkv"].shape == (64, 3, 2, 32)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_params_round_trip_bitwise(arch_id):
    jcfg, cfg = _configs(arch_id, "wide")
    np_params = _jax_params(jcfg)
    back = recsys.params_to_numpy(_port_model(cfg, np_params))
    a, b = _flat(np_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# --------------------------------------------------------------- models ---
@pytest.mark.parametrize("size", ["reduced", "wide"])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_loss_and_grads_match_jax(arch_id, size):
    """The logits (BERT4Rec's sampled ones), the loss and every
    parameter's gradient from the same parameters and batch."""
    jcfg, cfg = _configs(arch_id, size)
    np_params = _jax_params(jcfg)
    batch = _batch(cfg, 16 if size == "reduced" else 6)
    jp, jb = _to_jax(np_params), _to_jax(batch)
    j_out = jax.jit(lambda p, b: _jax_out(jcfg, p, b))(jp, jb)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jcfg), has_aux=True))(jp, jb)
    model = _port_model(cfg, np_params)
    tb = _to_torch(batch)
    out = _port_out(model, tb)
    assert out.shape == j_out.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **LOGIT_TOL[arch_id])
    loss, metrics = recsys.loss_fn(model, tb)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               **FWD_TOL)
    assert metrics[("xent" if arch_id == "bert4rec" else "bce")] is loss
    loss.backward()
    grads = recsys.tree_from_named({k: p.grad.numpy() for k, p in
                                    model.named_parameters()})
    _assert_trees_close(grads, j_grads, **GRAD_TOL)


@pytest.mark.parametrize("size", ["reduced", "wide"])
def test_bert4rec_full_softmax_matches_jax(size):
    """bert4rec_forward's full-vocab logits and the full-softmax cloze loss
    with its gradients (labels -1 off the masked positions)."""
    jcfg, cfg = _configs("bert4rec", size)
    np_params = _jax_params(jcfg)
    b = _batch(cfg, 4)
    labels = np.full(b["item_seq"].shape, -1, np.int32)
    np.put_along_axis(labels, b["mask_pos"], b["mask_labels"], axis=1)
    batch = {"item_seq": b["item_seq"], "labels": labels}
    jp, jb = _to_jax(np_params), _to_jax(batch)
    j_logits = jax.jit(lambda p: jrecsys.bert4rec_forward(p, jcfg, jb))(jp)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jrecsys.bert4rec_full_softmax_loss(p, jcfg, jb),
        has_aux=True))(jp)
    model = _port_model(cfg, np_params)
    tb = _to_torch(batch)
    logits = model(tb)
    assert logits.shape == (4, cfg.seq_len, model.items.shape[0])
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j_logits), **LOGIT_TOL["bert4rec"])
    loss, _ = recsys.bert4rec_full_softmax_loss(model, tb)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               **FWD_TOL)
    loss.backward()
    grads = recsys.tree_from_named({k: p.grad.numpy() for k, p in
                                    model.named_parameters()})
    _assert_trees_close(grads, j_grads, **GRAD_TOL)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_kernel_ops_and_plain_autograd_give_the_same_gradients(arch_id):
    """The model through the kernel ops (autograd.Functions with the
    scatter backward) and through the plain version differentiated by
    autograd, as chip_smoke.py compares them on the card."""
    jcfg, cfg = _configs(arch_id)
    np_params = _jax_params(jcfg)
    batch = _to_torch(_batch(cfg, 32, 1))
    out = []
    for bag_fn in (None, ref.embedding_bag_ref):
        model = _port_model(cfg, np_params)
        loss, _ = recsys.loss_fn(model, batch, bag_fn=bag_fn)
        out.append((float(loss.detach()), [g.numpy() for g in
                                           torch.autograd.grad(
                                               loss,
                                               list(model.parameters()))]))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert loss_a == loss_b
    for a, b in zip(grads_a, grads_b):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ retrieval ---
def _user(cfg, seed=3):
    b = _batch(cfg, 1, seed)
    return {k: v for k, v in b.items()
            if k not in ("label", "mask_pos", "mask_labels", "neg_ids")}


@pytest.mark.parametrize("arch_id", ["wide-deep"] + list(ARCHS))
def test_score_candidates_matches_jax(arch_id):
    """One user against 50 candidates (ids past the vocab for the CTR
    models, which take them mod V; item ids for the sequence models),
    unchunked and in 5 chunks: the port against the reference, chunked
    equal to unchunked, and the kernel ops equal to the plain versions."""
    jcfg, cfg = _configs(arch_id)
    np_params = _jax_params(jcfg)
    user = _user(cfg)
    cand = np.arange(0, 50 * 13, 13, dtype=np.int32)
    if arch_id in ("dien", "bert4rec"):
        cand %= cfg.n_items or cfg.vocab_sizes[0]
    want = np.asarray(jrecsys.score_candidates(
        _to_jax(np_params), jcfg, _to_jax(user), jnp.asarray(cand)))
    model = _port_model(cfg, np_params)
    tu, tc = _to_torch(user), torch.from_numpy(cand)
    got = recsys.score_candidates(model, tu, tc)
    assert got.shape == (50,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want,
                               **LOGIT_TOL.get(arch_id, FWD_TOL))
    chunked = recsys.score_candidates(model, tu, tc, chunks=5)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), **FWD_TOL)
    plain = recsys.score_candidates(model, tu, tc, chunks=5,
                                    bag_fn=ref.embedding_bag_ref)
    assert torch.equal(plain, chunked)
    with pytest.raises(ValueError, match="do not split"):
        recsys.score_candidates(model, tu, tc, chunks=3)


# ---------------------------------------------------------- train step ----
def _capture():
    """An optimizer that keeps the gradients it is handed and moves
    nothing."""
    seen = []

    def update(grads, state, params, step):
        seen.append({k: g.clone() for k, g in grads.items()})
        return params, state, {}
    return optim.Optimizer("capture", lambda p: {}, update), seen


@pytest.mark.parametrize("arch_id", ARCHS)
def test_microbatched_grads_match_full_batch(arch_id):
    """Gradients accumulated over 4 microbatches (f32, in order) against
    the full batch's, and the loss the microbatches' mean."""
    _, cfg = _configs(arch_id)
    model = recsys.init_model(cfg, seed=0, device="cpu")
    batch = _to_torch(_batch(cfg, 32, 2))
    opt, seen = _capture()
    out = [make_train_step(recsys.loss_fn, opt, microbatches=k)(
        model, {}, 0, batch)[2] for k in (1, 4)]
    np.testing.assert_allclose(float(out[1]["loss"]), float(out[0]["loss"]),
                               **FWD_TOL)
    key = "xent" if arch_id == "bert4rec" else "bce"
    np.testing.assert_allclose(float(out[1][key]), float(out[0][key]),
                               **FWD_TOL)
    full, acc = seen
    assert full.keys() == acc.keys()
    for k in full:
        assert acc[k].dtype == torch.float32
        np.testing.assert_allclose(acc[k].numpy(), full[k].numpy(),
                                   err_msg=k, **GRAD_TOL)
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(recsys.loss_fn, opt, microbatches=3)(
            model, {}, 0, batch)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_microbatched_step_matches_jax_step(arch_id):
    """One step of each package's make_train_step with 4 microbatches and
    the arch's optimizer (adagrad for xDeepFM, adam for the others), from
    the same parameters and batch: the loss, every parameter and every
    optimizer state leaf."""
    jcfg, cfg = _configs(arch_id)
    name = registry.get_arch(arch_id).optimizer
    np_params = _jax_params(jcfg)
    batch = _batch(cfg, 32, 5)
    jopt = joptim.make_optimizer(name, lr=1e-2, warmup=0)
    jp = _to_jax(np_params)
    jp2, js2, jm = jax.jit(j_make_train_step(_jax_loss_fn(jcfg), jopt,
                                             microbatches=4))(
        jp, jopt.init(jp), 0, _to_jax(batch))
    model = _port_model(cfg, np_params)
    topt = optim.make_optimizer(name, lr=1e-2, warmup=0)
    state = topt.init(dict(model.named_parameters()))
    _, state, m = make_train_step(recsys.loss_fn, topt, microbatches=4)(
        model, state, 0, _to_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **FWD_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _assert_trees_close(recsys.params_to_numpy(model), jp2, **STEP_TOL)
    for k, v in state.items():
        _assert_trees_close(recsys.tree_from_named(
            {n: t.numpy() for n, t in v.items()}), js2[k], **GRAD_TOL)


def test_eval_step_is_the_loss_without_gradients():
    _, cfg = _configs("dien")
    model = recsys.init_model(cfg, seed=0, device="cpu")
    batch = _to_torch(_batch(cfg, 8))
    out = make_eval_step(recsys.loss_fn)(model, batch)
    assert set(out) == {"bce", "loss"} and not out["loss"].requires_grad
    assert float(out["loss"]) == float(recsys.loss_fn(model, batch)[0]
                                       .detach())


# -------------------------------------------------------------- driver ----
@pytest.mark.parametrize("arch_id,microbatches", [
    ("xdeepfm", 1), ("dien", 1), ("bert4rec", 1), ("bert4rec", 2)])
def test_drivers_give_the_same_losses(monkeypatch, arch_id, microbatches):
    """Five steps of both drivers' reduced runs (batch 32; Criteo records
    for xDeepFM, the seed-0 RandomState's sequences for DIEN and
    BERT4Rec; each arch's optimizer at lr 1e-3 under warmup-cosine),
    from the same parameters, with the port's --microbatches against the
    reference's make_train_step argument: losses within rtol 1e-5."""
    steps = 5
    jarch = j_get_arch(arch_id)
    jcfg = jtrain.reduced_model(jarch)
    params = jax.tree_util.tree_map(np.asarray, jtrain.init_params_for(
        jarch, jcfg, jax.random.PRNGKey(0)))
    opt = joptim.make_optimizer(jarch.optimizer, lr=1e-3)
    p, s = params, opt.init(params)
    step_fn = jax.jit(j_make_train_step(jtrain.make_loss_fn(jarch, jcfg),
                                        opt, microbatches))
    batch_fn = jtrain.make_batch_fn(jarch, jcfg, 32,
                                    np.random.RandomState(0))
    want = []
    for i in range(steps):
        p, s, metrics = step_fn(p, s, i, batch_fn())
        want.append(float(metrics["loss"]))
    port_init = train.init_params_for

    def init_from_jax(*a, **kw):
        model = port_init(*a, **kw)
        model.load_state_dict(recsys.params_from_numpy(params))
        return model
    monkeypatch.setattr(train, "init_params_for", init_from_jax)
    res = train.run(arch_id, steps=steps, device="cpu",
                    microbatches=microbatches)
    assert res["steps"] == steps and res["batch"] == 32
    assert res["microbatches"] == microbatches
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_driver_cli_checkpoints_and_resumes(tmp_path, capsys):
    """DIEN through the CLI with --microbatches 2: adam's state in the
    JAX layout (the JAX package reads it), and a resume."""
    d = str(tmp_path)
    first = train.main(["--arch", "dien", "--steps", "4", "--ckpt-dir", d,
                        "--ckpt-every", "2", "--microbatches", "2",
                        "--device", "cpu"])
    assert first["steps"] == 4 and ckpt.latest_step(d) == 3
    tree, _ = jckpt.restore(d)
    assert tree["params"]["items"].shape == (512, 8)
    assert tree["params"]["gru1"]["u"].shape == (16, 48)
    assert set(tree["opt_state"]) == {"m", "v"}
    assert tree["opt_state"]["v"]["mlp"][0]["w"].shape == (16 + 8 + 8, 32)
    second = train.main(["--arch", "dien", "--steps", "6", "--ckpt-dir", d,
                         "--device", "cpu"])
    assert second["steps"] == 2 and ckpt.latest_step(d) == 5
    assert "resumed from step 3" in capsys.readouterr().out
    assert all(np.isfinite(first["losses"] + second["losses"]))


# ---------------------------------------------------------- checkpoint ----
def test_checkpoint_round_trip_jax_port_jax(tmp_path):
    """A JAX checkpoint of BERT4Rec's parameters (the 4-D wqkv, the 3-D
    wo) and adam state restores into the port, is saved by the port, and
    restores into JAX bit for bit."""
    jcfg, cfg = _configs("bert4rec", "wide")
    params = _jax_params(jcfg)
    state = joptim.make_optimizer("adam").init(params)
    state = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, state)
    jckpt.save(str(tmp_path / "a"), 3, {"params": params,
                                        "opt_state": state})
    tree, manifest = ckpt.restore(str(tmp_path / "a"), device="cpu")
    assert manifest["step"] == 3
    model = recsys.init_model(cfg, seed=2, device="cpu")
    model.load_state_dict(recsys.named_from_tree(tree["params"]))
    assert model.blocks[1].wqkv.shape == (64, 3, 2, 32)
    opt_state = {k: recsys.named_from_tree(v)
                 for k, v in tree["opt_state"].items()}
    assert opt_state["m"]["blocks.0.wo"].shape == (2, 32, 64)
    out = {"params": recsys.tree_from_named(dict(model.named_parameters())),
           "opt_state": {k: recsys.tree_from_named(v)
                         for k, v in opt_state.items()}}
    ckpt.save(str(tmp_path / "b"), 4, out)
    back, manifest = jckpt.restore(str(tmp_path / "b"))
    assert manifest["step"] == 4
    want = _flat({"params": params, "opt_state": state})
    got = _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------ kernel launches ---
@pytest.mark.parametrize("d,vec,lanes", [(10, 2, 0), (18, 2, 0),
                                         (64, 4, 16), (1, 1, 0)])
def test_embedding_plans_at_the_new_widths(d, vec, lanes):
    """The row kernel's and the scatter's launch plans at xDeepFM's D =
    10, DIEN's 18, BERT4Rec's 64 and the linear arm's 1, f32 and 16-byte
    aligned: 8-byte words on the flat walk (lanes 0) where D is even and
    not a multiple of 4, a float on it at D = 1, float4s on lanes the
    power of two covering a row at D = 64; and BERT4Rec's candidate gather at train_batch
    without microbatching (65536 x 20 x 128 rows) within the grid's
    2^31 - 1 blocks (the kernels index threads in 64 bits)."""
    from repro_torch.kernels import embedding_bag as eb
    rows = 8192 * 20 * 128
    fwd = eb.fwd_plan(rows, 1, d)
    assert (fwd.vec, fwd.lanes) == (vec, lanes)
    assert fwd.blocks * eb.FWD_THREADS * (1 if lanes else eb.FLAT_WORDS) \
        >= rows * (lanes or d // vec)
    bwd = eb.bwd_plan(rows, 1, 1048592, d)
    assert (bwd.vec, bwd.lanes, bwd.groups) == (vec, lanes, 1)
    full = eb.fwd_plan(65536 * 20 * 128, 1, d)
    assert full.blocks < 2 ** 31 - 1
    assert eb.bwd_plan(65536 * 20 * 128, 1, 1048592, d).blocks < 2 ** 31 - 1
