"""repro_torch's wide-deep slice against the JAX package on the CPU: the
synthetic Criteo stream bit for bit, the configs and the registry, the
model's forward, loss and gradients, row-wise adagrad, the checkpoint
layout and the generic driver, all from the same numpy inputs and
weights copied across."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import RECSYS_SHAPES as J_RECSYS_SHAPES  # noqa: E402
from repro.configs.base import RecsysConfig as JRecsysConfig  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig  # noqa: E402
from repro_torch.configs.wide_deep import ARCH  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402


def _fields(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------- stream -----
@pytest.mark.parametrize("n_sparse,n_dense,vocab,multi_hot,seed,n", [
    (40, 13, 1 << 20, 4, 0, 64),       # wide-deep's widths
    (6, 13, 256, 2, 3, 16),
    (26, 4, 512, 1, 7, 33),
])
def test_criteo_stream_matches_jax_bitwise(n_sparse, n_dense, vocab,
                                           multi_hot, seed, n):
    kw = dict(n_sparse=n_sparse, n_dense=n_dense, vocab=vocab,
              multi_hot=multi_hot, seed=seed)
    js, ts = jsynthetic.CriteoStream(**kw), synthetic.CriteoStream(**kw)
    for _ in range(3):
        raw_j, raw_t = js.raw_block(n), ts.raw_block(n)
        for a, b in ((raw_j, raw_t), (js.feature_udf(raw_j),
                                      ts.feature_udf(raw_t)),
                     (js.batch_udf(raw_j), ts.batch_udf(raw_t))):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = ts.feature_udf(ts.raw_block(n))
    assert out["sparse_ids"].shape == (n, n_sparse, multi_hot)
    assert out["sparse_ids"].dtype == np.int32
    assert 0 <= out["sparse_ids"].min() and out["sparse_ids"].max() < vocab


# ----------------------------------------------------- configs, registry ---
def test_recsys_configs_match_jax():
    assert [_fields(s) for s in RECSYS_SHAPES] == \
        [_fields(s) for s in J_RECSYS_SHAPES]
    jarch = j_get_arch("wide-deep")
    got = _fields(ARCH.model)
    want = _fields(jarch.model)
    assert set(want) - set(got) == set()
    assert got.pop("reduced") == ()
    assert got == {k: v for k, v in want.items() if k in got}
    for key in ("arch_id", "family", "source", "optimizer"):
        assert getattr(ARCH, key) == getattr(jarch, key), key
    assert ARCH.shape("train_batch").batch == 65536
    assert registry.get_arch("wide-deep") is ARCH


def test_reduced_model_matches_jax_driver():
    got = _fields(train.reduced_model(ARCH))
    want = _fields(jtrain.reduced_model(j_get_arch("wide-deep")))
    assert got.pop("reduced")
    assert got == {k: v for k, v in want.items() if k in got}
    assert (got["n_sparse"], got["embed_dim"], got["mlp_dims"]) == \
        (8, 8, (64, 32))
    assert got["vocab_sizes"] == (512,) * 8


# --------------------------------------------------------------- model ----
SMALL = dict(name="wide-deep", interaction="concat", n_sparse=6,
             embed_dim=8, mlp_dims=(16, 8), n_dense=13)


def _configs(rows, multi_hot):
    kw = dict(SMALL, vocab_sizes=(rows,) * SMALL["n_sparse"],
              multi_hot=multi_hot)
    return JRecsysConfig(**kw), RecsysConfig(**kw)


def _jax_params(jcfg, seed=0):
    params, _ = jrecsys.init_wide_deep(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg, np_params):
    model = recsys.init_model(cfg, seed=1, device="cpu")
    model.load_state_dict(recsys.params_from_numpy(np_params))
    return model


def _batch(cfg, n, seed=0):
    stream = synthetic.CriteoStream(n_sparse=cfg.n_sparse,
                                    n_dense=cfg.n_dense,
                                    vocab=cfg.vocab_sizes[0],
                                    multi_hot=cfg.multi_hot, seed=seed)
    return stream.feature_udf(stream.raw_block(n))


def test_params_round_trip_bitwise():
    jcfg, cfg = _configs(256, 2)
    np_params = _jax_params(jcfg)
    model = _port_model(cfg, np_params)
    assert model.wide.shape == (6, 256) and model.bias.shape == ()
    assert model.mlp[0].weight.shape == (16, 6 * 8 + 13)
    back = recsys.params_to_numpy(model)
    a, b = _flat(np_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_init_draws_the_jax_shapes_and_scales():
    """Random init from a torch.Generator: the JAX tree's shapes, zero
    biases, and the JAX scales (std D^-1/2 for the tables, 0.01 for the
    wide weights)."""
    jcfg, cfg = _configs(512, 4)
    model = recsys.init_model(cfg, seed=0, device="cpu")
    got = recsys.params_to_numpy(model)
    want = _flat(_jax_params(jcfg))
    assert {k: v.shape for k, v in _flat(got).items()} == \
        {k: v.shape for k, v in want.items()}
    assert float(got["bias"]) == 0.0
    assert all(not layer["b"].any() for layer in got["mlp"])
    assert got["tables"].std() == pytest.approx(8 ** -0.5, rel=0.05)
    assert got["wide"].std() == pytest.approx(0.01, rel=0.1)


@pytest.mark.parametrize("rows,multi_hot,n", [(256, 2, 16), (512, 4, 64)])
def test_wide_deep_forward_loss_and_grads_match_jax(rows, multi_hot, n):
    """rtol / atol 1e-5 on the logits, the loss and every gradient: the
    port sums the wide arm's bag in the lookup, then over the features,
    where JAX sums both axes in one jnp.sum, and the MLP products are
    summed in another order."""
    jcfg, cfg = _configs(rows, multi_hot)
    np_params = _jax_params(jcfg)
    batch = _batch(cfg, n)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_logit = jrecsys.wide_deep_forward(jp, jcfg, jb)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jrecsys.ctr_loss(p, jcfg, jb, jrecsys.wide_deep_forward),
        has_aux=True)(jp)
    model = _port_model(cfg, np_params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logit = model(tb)
    np.testing.assert_allclose(logit.detach().numpy(), np.asarray(j_logit),
                               rtol=1e-5, atol=1e-5)
    loss, metrics = recsys.ctr_loss(model, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5, atol=1e-5)
    assert metrics["bce"] is loss
    grads = recsys.tree_from_named({k: p.grad.numpy() for k, p in
                                    model.named_parameters()})
    want, got = _flat(j_grads), _flat(grads)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_kernel_op_and_plain_autograd_give_the_same_model_gradients():
    """The model through ops.embedding_bag_fused (the autograd.Function,
    its scatter backward) and through the plain version differentiated by
    autograd, as chip_smoke.py compares them on the card."""
    jcfg, cfg = _configs(256, 4)
    np_params = _jax_params(jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 32, 1).items()}
    out = []
    for bag_fn in (None, ref.embedding_bag_fused_ref):
        model = _port_model(cfg, np_params)
        loss, _ = recsys.ctr_loss(model, batch, bag_fn=bag_fn)
        out.append((float(loss.detach()), [g.numpy() for g in torch.autograd.grad(
            loss, list(model.parameters()))]))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert loss_a == loss_b
    for a, b in zip(grads_a, grads_b):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ rowwise adagrad ---
@pytest.mark.parametrize("rowwise_min_elems", [1 << 24, 100])
def test_rowwise_adagrad_matches_jax(rowwise_min_elems):
    """Three updates from the same parameters and gradients, rtol 1e-5 on
    parameters and state. With rowwise_min_elems 100 the (F, V, D) tables
    keep one accumulator a row and the 2-D (F, V) wide table one a
    feature (the mean of g^2 over its vocab axis), as in the JAX rule;
    at the default every tensor here is elementwise."""
    rng = np.random.RandomState(5)
    params = {"tables": rng.randn(6, 64, 8).astype(np.float32),
              "wide": rng.randn(6, 64).astype(np.float32),
              "w": rng.randn(10, 4).astype(np.float32),
              "bias": np.asarray(rng.randn(), np.float32)}
    grads = [{k: np.asarray(rng.randn(*v.shape) * 0.3, np.float32)
              for k, v in params.items()} for _ in range(3)]
    kw = dict(lr=1e-2, warmup=2, total_steps=10,
              rowwise_min_elems=rowwise_min_elems)
    jopt = joptim.make_optimizer("rowwise_adagrad", **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = optim.make_optimizer("rowwise_adagrad", **kw)
    tp = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in params.items()}
    ts = topt.init(tp)
    shapes = {k: tuple(a.shape) for k, a in ts["acc"].items()}
    assert shapes == {k: tuple(a.shape) for k, a in js["acc"].items()}
    if rowwise_min_elems == 100:
        assert shapes["tables"] == (6, 64) and shapes["wide"] == (6,)
    for step, g in enumerate(grads):
        jp, js, jstats = jopt.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, js, jp, step)
        tp, ts, tstats = topt.update({k: torch.from_numpy(
            np.array(v, copy=True)) for k, v in g.items()}, ts, tp, step)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert tstats["lr"] == pytest.approx(float(jstats["lr"]), rel=1e-7)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ts["acc"][k].numpy(),
                                       np.asarray(js["acc"][k]), rtol=1e-5,
                                       atol=1e-9, err_msg=k)


def test_rowwise_adagrad_updates_stacked_tables_a_slice_at_a_time(
        monkeypatch):
    """A stacked tensor over the chunk limit is updated one axis-0 slice
    at a time, its row-wise accumulator sliced with it; the result equals
    the whole-tensor update."""
    rng = np.random.RandomState(6)
    p = rng.randn(4, 32, 8).astype(np.float32)
    g = rng.randn(4, 32, 8).astype(np.float32)
    out = []
    for chunk in (1 << 26, 64):
        monkeypatch.setattr(optim, "_CHUNK_ELEMS", chunk)
        opt = optim.rowwise_adagrad(optim.constant_lr(0.1),
                                    rowwise_min_elems=10)
        tp = {"t": torch.from_numpy(p.copy())}
        state = opt.init(tp)
        opt.update({"t": torch.from_numpy(g.copy())}, state, tp, 0)
        out.append((tp["t"].numpy(), state["acc"]["t"].numpy()))
    assert out[0][1].shape == (4, 32)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- checkpoint ----
def test_checkpoint_round_trip_jax_port_jax(tmp_path):
    """A JAX checkpoint of wide-deep params and row-wise adagrad state
    (row-wise tables and wide arm) restores into the port, is saved by
    the port, and restores into JAX bit for bit."""
    jcfg, cfg = _configs(256, 2)
    params = _jax_params(jcfg)
    state = joptim.make_optimizer("rowwise_adagrad",
                                  rowwise_min_elems=1000).init(params)
    state = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, state)
    assert state["acc"]["wide"].shape == (6,)
    assert state["acc"]["tables"].shape == (6, 256)
    jckpt.save(str(tmp_path / "a"), 3, {"params": params,
                                        "opt_state": state})
    tree, manifest = ckpt.restore(str(tmp_path / "a"), device="cpu")
    assert manifest["step"] == 3
    model = recsys.init_model(cfg, seed=2, device="cpu")
    model.load_state_dict(recsys.named_from_tree(tree["params"]))
    acc = recsys.named_from_tree(tree["opt_state"]["acc"])
    assert acc["mlp.0.weight"].shape == model.mlp[0].weight.shape
    assert acc["mlp.0.weight"].is_contiguous()
    out = {"params": recsys.tree_from_named(dict(model.named_parameters())),
           "opt_state": {"acc": recsys.tree_from_named(acc)}}
    ckpt.save(str(tmp_path / "b"), 4, out)
    back, manifest = jckpt.restore(str(tmp_path / "b"))
    assert manifest["step"] == 4
    want = _flat({"params": params, "opt_state": state})
    got = _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- driver ----
def test_drivers_give_the_same_losses(monkeypatch):
    """Five steps of both drivers' reduced wide-deep runs (8 features,
    D 8, 512 rows, batch 32 of the seed-0 Criteo stream, row-wise adagrad
    lr 1e-3 under warmup-cosine), from the same parameters: losses
    within rtol 1e-5."""
    steps = 5
    jarch = j_get_arch("wide-deep")
    jcfg = jtrain.reduced_model(jarch)
    params = jax.tree_util.tree_map(np.asarray, jtrain.init_params_for(
        jarch, jcfg, jax.random.PRNGKey(0)))
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
        model.load_state_dict(recsys.params_from_numpy(params))
        return model
    monkeypatch.setattr(train, "init_params_for", init_from_jax)
    res = train.run("wide-deep", steps=steps, device="cpu")
    assert res["steps"] == steps and res["batch"] == 32
    assert res["samples_per_s"] > 0 and "seed_nodes_per_s" not in res
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_driver_cli_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path)
    first = train.main(["--arch", "wide-deep", "--steps", "4",
                        "--ckpt-dir", d, "--ckpt-every", "2",
                        "--device", "cpu"])
    assert first["steps"] == 4 and ckpt.latest_step(d) == 3
    tree, _ = jckpt.restore(d)          # the JAX package reads it
    assert tree["params"]["tables"].shape == (8, 512, 8)
    assert tree["params"]["mlp"][0]["w"].shape == (8 * 8 + 13, 64)
    assert set(tree["opt_state"]) == {"acc"}
    assert tree["opt_state"]["acc"]["mlp"][0]["w"].shape == (77, 64)
    second = train.main(["--arch", "wide-deep", "--steps", "6",
                         "--ckpt-dir", d, "--device", "cpu"])
    assert second["steps"] == 2 and ckpt.latest_step(d) == 5
    assert "resumed from step 3" in capsys.readouterr().out
    assert all(np.isfinite(first["losses"] + second["losses"]))


def test_driver_takes_only_train_shapes_for_recsys():
    with pytest.raises(KeyError, match="only the train regime"):
        train.main(["--arch", "wide-deep", "--shape", "serve_p99",
                    "--device", "cpu"])
