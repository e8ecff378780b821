"""repro_torch's DLRM, adagrad and train step against the JAX package on
the CPU: the same numpy parameters and batches through both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DLRMConfig as JConfig  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs.base import DLRMConfig  # noqa: E402
from repro_torch.data.featurize import (RecordSpec, featurize_block,  # noqa: E402
                                        raw_block)
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

WIDTHS = dict(n_sparse=4, n_dense=13, embed_dim=16, vocab_sizes=(64,) * 4,
              bottom_mlp=(32, 16), top_mlp=(32, 16, 1))


def _jax_params(seed=0):
    params, _ = jdlrm.init_params(jax.random.PRNGKey(seed),
                                  JConfig(name="tiny", **WIDTHS))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(np_params):
    model = dlrm.init_params(DLRMConfig(name="tiny", **WIDTHS), seed=1,
                             device="cpu")
    model.load_state_dict(dlrm.params_from_numpy(np_params))
    return model


def _batch(seed, batch=32):
    rec = RecordSpec(batch=batch, n_sparse=4, n_dense=13, vocab=64)
    return featurize_block(raw_block(np.random.RandomState(seed), rec), rec)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_params_round_trip_bitwise():
    np_params = _jax_params()
    back = dlrm.params_to_numpy(_port_model(np_params))
    a, b = _flat(np_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_forward_loss_and_every_gradient_match_jax():
    """Forward and loss at rtol 1e-5; gradients at rtol 1e-4 / atol 1e-5
    (f32 sums taken in another order on each side)."""
    np_params = _jax_params()
    batch = _batch(0)
    jcfg = JConfig(name="tiny", **WIDTHS)
    j_logit = jdlrm.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                            jcfg, batch)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jdlrm.loss_fn(p, jcfg, batch), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, np_params))

    model = _port_model(np_params)
    tb = _torch(batch)
    np.testing.assert_allclose(model(tb).detach().numpy(),
                               np.asarray(j_logit), rtol=1e-5, atol=1e-6)
    loss, _ = dlrm.loss_fn(model, tb)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = dict(zip(names, grads))
    want = dlrm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          j_grads))
    assert set(got) == set(want)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_three_adagrad_steps_match_jax():
    """Parameters and accumulators after 3 train steps, rtol 1e-4 / atol
    1e-5. Adagrad's first step moves every touched element by about
    lr*sign(g) whatever |g| is, so an element whose gradient rounds to
    opposite signs on the two sides would be 2*lr apart; none does here
    (untouched table rows have g = 0 exactly on both sides), and the
    accumulators sum g^2 in f32 the same way."""
    np_params = _jax_params()
    lr = 0.02
    j_opt = joptim.adagrad(joptim.constant_lr(lr))
    jcfg = JConfig(name="tiny", **WIDTHS)
    j_step = jax.jit(j_make_train_step(
        lambda p, b: jdlrm.loss_fn(p, jcfg, b), j_opt))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = j_opt.init(jp)

    t_opt = optim.adagrad(optim.constant_lr(lr))
    model = _port_model(np_params)
    ts = t_opt.init(dict(model.named_parameters()))
    t_step = make_train_step(dlrm.loss_fn, t_opt)
    for i in range(3):
        batch = _batch(10 + i)
        jp, js, jm = j_step(jp, js, i, batch)
        model, ts, tm = t_step(model, ts, i, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want_p = dlrm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    want_a = dlrm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            js["acc"]))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(ts["acc"][n].numpy(), want_a[n].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_sliced_update_equals_whole_tensor_update(monkeypatch):
    """The per-feature-slice update of huge stacked tensors is the same
    arithmetic as the whole-tensor update, bitwise."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(3, 8, 4).astype(np.float32)
    g0 = rng.randn(3, 8, 4).astype(np.float32)
    out = []
    for chunk in (1 << 26, 16):
        monkeypatch.setattr(optim, "_CHUNK_ELEMS", chunk)
        opt = optim.adagrad(optim.constant_lr(0.1))
        params = {"t": torch.from_numpy(p0.copy())}
        state = opt.init(params)
        for _ in range(2):
            opt.update({"t": torch.from_numpy(g0.copy())}, state, params, 0)
        out.append((params["t"].numpy(), state["acc"]["t"].numpy()))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999, 20000])
def test_warmup_cosine_matches_jax(step):
    got = optim.warmup_cosine(0.02, 100, 10000)(step)
    want = float(joptim.warmup_cosine(0.02, 100, 10000)(step))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_make_optimizer_is_adagrad_only():
    """adagrad (the closed loop's) and, since slices 2, 3, 12 and 15, adam
    (GraphSAGE's), rowwise_adagrad (wide-deep's), sgd and adafactor
    (kimi-k2's; tests/test_torch_lm.py holds it against the JAX package)
    are ported; an unknown name raises."""
    assert optim.make_optimizer("adagrad", lr=0.02).name == "adagrad"
    assert optim.make_optimizer("adam", lr=1e-3).name == "adam"
    assert optim.make_optimizer("rowwise_adagrad").name == "rowwise_adagrad"
    assert optim.make_optimizer("sgd").name == "sgd"
    assert optim.make_optimizer("adafactor").name == "adafactor"
    with pytest.raises(ValueError, match="'sgd', 'adagrad', "
                                         "'rowwise_adagrad', 'adam' and "
                                         "'adafactor'"):
        optim.make_optimizer("lamb")
