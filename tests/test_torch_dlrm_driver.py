"""repro_torch's DLRM at the reference configuration (bf16 tables and
MLPs, row-wise adagrad) through the generic driver, against the JAX
package on the CPU: the config and registry, the loss and every gradient
of one step (bf16, and f32 with param_dtype overridden), row-wise adagrad
on bf16 leaves, five driver steps, a bf16 checkpoint both ways,
retrieval scoring, the two bf16 backwards' plain versions, the
launcher's simulated backend and the agent's offline pretraining, all
from the same numpy parameters, weights and seeds.

Tolerances: f32 rtol 1e-5 (atol 1e-7 for gradients, whose sums run in
another order); bf16 in units of the bf16 ulp (2^-7 of a power of two):
a gradient within 4 ulps of its largest element (a bias gradient sums
the batch in f32 here, in bf16 steps in XLA), a loss rtol 1e-6 (the bf16
logits agree; the f32 mean may differ in its last bit)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.core import pretrain as jpretrain  # noqa: E402
from repro.core.agent import DQNAgent as JDQNAgent  # noqa: E402
from repro.core.agent import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.controller import InTune as JInTune  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.models import embedding as jembedding  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import DLRMConfig  # noqa: E402
from repro_torch.configs.dlrm_criteo import ARCH  # noqa: E402
from repro_torch.core import agent as tagent  # noqa: E402
from repro_torch.core import pretrain  # noqa: E402
from repro_torch.core.controller import InTune  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch import train_dlrm_criteo  # noqa: E402
from repro_torch.models import dlrm, exchange  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parents[1]


def _fields(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _f32(a) -> np.ndarray:
    """A bf16 (ml_dtypes or `|V2` bits), f32 numpy array or tensor as
    f32 values."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return exchange.from_numpy(a).float().numpy()
    return a.astype(np.float32)


def _bits(a) -> np.ndarray:
    """The 2-byte bits of a bf16 array (ml_dtypes or `|V2`)."""
    return np.asarray(a).view(np.int16)


def _ulp(x: np.ndarray) -> float:
    """The bf16 ulp at the largest magnitude of x (2^-7 of its power of
    two); the smallest normal's for an all-zero x."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _assert_within_ulps(got, want, ulps, name=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= ulps * _ulp(want), (name, err / _ulp(want))


# ----------------------------------------------------- configs, registry ---
def test_dlrm_criteo_config_is_the_reference_one_with_rows_cut():
    """Every field of the reference's dlrm-criteo but the sharding ones,
    rows a table 2^23 cut to 2^22 (listed in `reduced`), the arch's
    family, source, optimizer and shapes; the registry resolves it."""
    jarch = j_get_arch("dlrm-criteo")
    got, want = _fields(ARCH.model), _fields(jarch.model)
    assert set(want) - set(got) == {"tp_lookup", "sharding_overrides"}
    assert set(got) - set(want) == {"reduced"}
    reduced = got.pop("reduced")
    assert len(reduced) == 1 and "2^23 -> 2^22" in reduced[0]
    assert got.pop("vocab_sizes") == (1 << 22,) * 26
    assert want.pop("vocab_sizes") == (1 << 23,) * 26
    assert got == {k: v for k, v in want.items() if k in got}
    assert (got["param_dtype"], got["multi_hot"]) == ("bfloat16", 1)
    for key in ("arch_id", "family", "source", "optimizer"):
        assert getattr(ARCH, key) == getattr(jarch, key), key
    assert [_fields(s) for s in ARCH.shapes] == \
        [_fields(s) for s in jarch.shapes]
    assert registry.get_arch("dlrm-criteo") is ARCH
    assert "dlrm-criteo" in registry.list_archs()
    assert [f.name for f in dataclasses.fields(DLRMConfig)
            if f.name != "reduced"] == \
        [f.name for f in dataclasses.fields(type(jarch.model))
         if f.name not in ("tp_lookup", "sharding_overrides")]


def test_reduced_model_matches_jax_driver():
    got = _fields(train.reduced_model(ARCH))
    want = _fields(jtrain.reduced_model(j_get_arch("dlrm-criteo")))
    assert got.pop("reduced")
    assert got == {k: v for k, v in want.items() if k in got}
    assert (got["n_sparse"], got["embed_dim"], got["bottom_mlp"],
            got["top_mlp"], got["param_dtype"]) == \
        (8, 16, (32, 16), (64, 32, 1), "bfloat16")


# ------------------------------------------------------ model, one step ---
def _reduced(param_dtype):
    jcfg = jtrain.reduced_model(j_get_arch("dlrm-criteo")) \
        .replace(param_dtype=param_dtype)
    cfg = train.reduced_model(ARCH).replace(param_dtype=param_dtype)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    params, _ = jdlrm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg, np_params):
    model = dlrm.init_params(cfg, seed=1, device="cpu")
    model.load_state_dict(dlrm.params_from_numpy(np_params))
    return model


def _batch(cfg, n, seed=0):
    stream = synthetic.CriteoStream(n_sparse=cfg.n_sparse,
                                    n_dense=cfg.n_dense,
                                    vocab=cfg.vocab_sizes[0],
                                    multi_hot=cfg.multi_hot, seed=seed)
    return stream.feature_udf(stream.raw_block(n))


def test_bf16_params_cross_as_numpy_bit_for_bit():
    """JAX bf16 parameters (ml_dtypes) into the port and back (2-byte
    `|V2` elements): the same bits, the port's tensors bf16."""
    jcfg, cfg = _reduced("bfloat16")
    params = _jax_params(jcfg)
    model = _port_model(cfg, params)
    assert all(p.dtype == BF16 for p in model.parameters())
    back = dlrm.params_to_numpy(model)
    a, b = _flat(params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == np.dtype("V2"), k
        np.testing.assert_array_equal(_bits(b[k]), _bits(a[k]), err_msg=k)


@pytest.mark.parametrize("param_dtype,seed", [
    ("bfloat16", 0), ("bfloat16", 1), ("bfloat16", 2), ("float32", 0)])
def test_loss_and_every_gradient_of_one_step_match_jax(param_dtype, seed):
    """The reduced driver model's loss and all gradients, from the same
    numpy parameters and a batch of 64: bf16 (the reference's dtype, the
    gradients bf16 on both sides) within 4 bf16 ulps of each gradient's
    largest element, loss rtol 1e-6; f32 rtol 1e-5 / atol 1e-7."""
    jcfg, cfg = _reduced(param_dtype)
    params = _jax_params(jcfg, seed)
    batch = _batch(cfg, 64, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jdlrm.loss_fn(p, jcfg, jb), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params))
    model = _port_model(cfg, params)
    loss, _ = dlrm.loss_fn(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    dtype = getattr(torch, param_dtype)
    assert all(g.dtype == dtype for g in grads)
    got = _flat(dlrm.tree_from_named(
        {n: exchange.to_numpy(g) for n, g in zip(names, grads)}))
    want = _flat(j_grads)
    assert got.keys() == want.keys()
    if param_dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                                   rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        return
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-6)
    for k in want:
        _assert_within_ulps(got[k], want[k], 4, k)


def test_kernel_ops_and_plain_autograd_give_the_same_bf16_gradients():
    """The bf16 model through ops (the autograd.Functions, their plain
    versions on the CPU) and through the plain forwards differentiated by
    autograd: the same loss; the gradients within 1 bf16 ulp of each
    one's largest element (autograd's bf16 scatter of the bags rounds
    every add, the op's f32 sums round once)."""
    jcfg, cfg = _reduced("bfloat16")
    params = _jax_params(jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 64, 3).items()}
    out = []
    for kw in ({}, {"bag_fn": ref.embedding_bag_ref,
                    "interact_fn": ref.dot_interact_ref}):
        model = _port_model(cfg, params)
        loss, _ = dlrm.loss_fn(model, batch, **kw)
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))))
    (loss_a, grads_a), (loss_b, grads_b) = out
    assert loss_a == loss_b
    for a, b in zip(grads_a, grads_b):
        assert a.dtype == b.dtype == BF16
        _assert_within_ulps(a, b, 1)


# ------------------------------------------- the two bf16 backwards -------
def test_embedding_bag_bwd_plain_version_matches_jax_bf16_grad():
    """ref.embedding_bag_bwd_ref into a bf16 gradient (f32 sums, one
    rounding) against jax.grad of the reference's oracle on the bf16
    tables (f32 sums, the cotangent cast to bf16 once at the table):
    bitwise where a row is touched once, and within 1 bf16 ulp of the
    row's largest element where ids repeat; the reference DLRM's own
    bf16 lookup (multifeature_bag, bags of 1) bitwise at distinct ids."""
    rng = np.random.RandomState(8)
    f, v, d, b = 3, 40, 16, 24
    tables = jnp.asarray(rng.randn(f, v, d).astype(np.float32)) \
        .astype(jnp.bfloat16)
    cot = jnp.asarray(rng.randn(b, f, d).astype(np.float32)) \
        .astype(jnp.bfloat16).astype(jnp.float32)
    for bag, distinct in ((1, True), (4, False)):
        ids = (np.stack([rng.permutation(v)[:b] for _ in range(f)], 1)[
            ..., None] if distinct else rng.randint(0, v, (b, f, bag))) \
            .astype(np.int32)
        for combiner in ("sum", "mean"):
            def j_loss(t):
                return sum(jnp.sum(jref.embedding_bag_ref(
                    t[i].astype(jnp.float32), ids[:, i],
                    combiner=combiner) * cot[:, i]) for i in range(f))
            want = jax.grad(j_loss)(tables)
            assert want.dtype == jnp.bfloat16
            got = ref.embedding_bag_bwd_ref(
                torch.from_numpy(np.array(cot)), torch.from_numpy(ids), v,
                combiner=combiner, dtype=BF16)
            assert got.dtype == BF16
            if distinct:
                np.testing.assert_array_equal(
                    _bits(exchange.to_numpy(got)), _bits(np.asarray(want)))
            else:
                for i in range(f):
                    _assert_within_ulps(got[i], np.asarray(want)[i], 1)
        if distinct:
            want = jax.grad(lambda t: jnp.sum(
                jembedding.multifeature_bag(t, jnp.asarray(ids))
                .astype(jnp.float32) * cot))(tables)
            got = ref.embedding_bag_bwd_ref(
                torch.from_numpy(np.array(cot)), torch.from_numpy(ids), v,
                dtype=BF16)
            np.testing.assert_array_equal(_bits(exchange.to_numpy(got)),
                                          _bits(np.asarray(want)))


@pytest.mark.parametrize("b,f,d", [(6, 7, 16), (5, 27, 13), (3, 2, 8)])
def test_dot_interact_bwd_plain_version_matches_jax_bf16_grad(b, f, d):
    """ref.dot_interact_bwd_ref with bf16 d_out and feats (f32 sums, one
    rounding to bf16) against jax.grad of the reference's oracle taken in
    f32 on the same bf16 values and cast to bf16 at the input: within 1
    bf16 ulp of the gradient's largest element (the sums run in another
    order)."""
    rng = np.random.RandomState(b * f + d)
    feats = jnp.asarray(rng.randn(b, f, d).astype(np.float32)) \
        .astype(jnp.bfloat16)
    p = f * (f - 1) // 2
    cot = jnp.asarray(rng.randn(b, p).astype(np.float32)) \
        .astype(jnp.bfloat16)
    want = jax.grad(lambda x: jnp.sum(
        jref.dot_interact_ref(x.astype(jnp.float32))
        * cot.astype(jnp.float32)))(feats)
    assert want.dtype == jnp.bfloat16
    got = ref.dot_interact_bwd_ref(exchange.from_numpy(np.asarray(cot)),
                                   exchange.from_numpy(np.asarray(feats)))
    assert got.dtype == BF16
    _assert_within_ulps(got, np.asarray(want), 1)


def test_ops_hand_the_kernels_bf16_and_take_back_bf16(monkeypatch):
    """On a CUDA tensor (the kernels replaced by spies, the tensors on the
    CPU) the embedding bag's backward asks for a bf16 gradient of a bf16
    table, and the interaction's backward gets bf16 d_out and feats and
    returns what the kernel wrote: no f32 copy of a gradient is made."""
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    seen = []

    def bag_bwd(d_out, ids, num_rows, combiner, dtype):
        seen.append(("bag", d_out.dtype, dtype))
        return ref.embedding_bag_bwd_ref(d_out, ids, num_rows,
                                         combiner=combiner, dtype=dtype)

    def dot_bwd(d_out, feats):
        seen.append(("dot", d_out.dtype, feats.dtype))
        return ref.dot_interact_bwd_ref(d_out, feats)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(eb, "embedding_bag_fwd",
                        lambda t, i, c: ref.embedding_bag_ref(t, i,
                                                              combiner=c))
    monkeypatch.setattr(eb, "embedding_bag_bwd", bag_bwd)
    monkeypatch.setattr(di, "dot_interact_fwd", ref.dot_interact_ref)
    monkeypatch.setattr(di, "dot_interact_bwd", dot_bwd)
    tables = torch.randn((2, 16, 8)).to(BF16).requires_grad_(True)
    feats = torch.randn((4, 5, 8)).to(BF16).requires_grad_(True)
    ids = torch.randint(0, 16, (4, 2, 1), dtype=torch.int32)
    (ops.embedding_bag(tables, ids).sum()
     + ops.dot_interact(feats).float().sum()).backward()
    assert seen == [("dot", BF16, BF16), ("bag", torch.float32, BF16)] or \
        seen == [("bag", torch.float32, BF16), ("dot", BF16, BF16)]
    assert tables.grad.dtype == BF16 and feats.grad.dtype == BF16


# ------------------------------------------------------ rowwise adagrad ---
@pytest.mark.parametrize("rowwise_min_elems", [1 << 24, 100])
def test_rowwise_adagrad_on_bf16_leaves_matches_jax(rowwise_min_elems):
    """Three updates of bf16 parameters by bf16 gradients: the update in
    f32 and one rounding into bf16 on both sides, so the parameters agree
    within 1 bf16 ulp elementwise (rsqrt may differ in its last f32 bit)
    and the f32 accumulators rtol 1e-6. rowwise_min_elems 100 gives the
    stacked table one accumulator a row; at the default every leaf here
    is elementwise, as the reduced driver's (8 x 512 x 16) tables are.
    The table is updated a slice at a time (chunk limit lowered)."""
    rng = np.random.RandomState(9)
    shapes = {"tables": (4, 64, 16), "w": (13, 32), "b": (32,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in
              shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in
              shapes.items()} for _ in range(3)]

    def jbf(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    def tbf(a):
        return torch.from_numpy(a).to(BF16)
    kw = dict(lr=1e-2, warmup=2, total_steps=10,
              rowwise_min_elems=rowwise_min_elems)
    jopt = joptim.make_optimizer("rowwise_adagrad", **kw)
    jp = {k: jbf(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = optim.make_optimizer("rowwise_adagrad", **kw)
    tp = {k: tbf(v) for k, v in params.items()}
    ts = topt.init(tp)
    assert {k: tuple(a.shape) for k, a in ts["acc"].items()} == \
        {k: tuple(a.shape) for k, a in js["acc"].items()}
    old = optim._CHUNK_ELEMS
    optim._CHUNK_ELEMS = 1024
    try:
        for step, g in enumerate(grads):
            jp, js, _ = jopt.update({k: jbf(v) for k, v in g.items()}, js,
                                    jp, step)
            tp, ts, _ = topt.update({k: tbf(v) for k, v in g.items()}, ts,
                                    tp, step)
            for k in params:
                assert tp[k].dtype == BF16 and jp[k].dtype == jnp.bfloat16
                a, w = _f32(tp[k]), _f32(np.asarray(jp[k]))
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                          2.0 ** -126)))
                              - 7)
                assert np.all(np.abs(a - w) <= ulp), k
                np.testing.assert_allclose(ts["acc"][k].numpy(),
                                           np.asarray(js["acc"][k]),
                                           rtol=1e-6, err_msg=k)
    finally:
        optim._CHUNK_ELEMS = old


# ---------------------------------------------------------- checkpoint ----
def test_bf16_checkpoint_round_trip_jax_port_jax(tmp_path):
    """A JAX checkpoint of bf16 DLRM params and row-wise adagrad state
    restores into the port (bf16 tensors), is saved by the port, and
    restores into JAX with the same bytes in the same encoding (`|V2`,
    np.savez's for a bf16 array)."""
    jcfg, cfg = _reduced("bfloat16")
    params = _jax_params(jcfg)
    state = joptim.make_optimizer("rowwise_adagrad",
                                  rowwise_min_elems=10000).init(params)
    state = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, state)
    assert state["acc"]["tables"].shape == (8, 512)
    assert state["acc"]["top"][0]["w"].shape == (52, 64)
    jckpt.save(str(tmp_path / "a"), 3, {"params": params,
                                        "opt_state": state})
    tree, manifest = ckpt.restore(str(tmp_path / "a"), device="cpu")
    assert manifest["step"] == 3
    assert tree["params"]["tables"].dtype == BF16
    model = dlrm.init_params(cfg, seed=2, device="cpu")
    model.load_state_dict(dlrm.named_from_tree(tree["params"]))
    acc = dlrm.named_from_tree(tree["opt_state"]["acc"])
    assert acc["top.0.weight"].shape == model.top[0].weight.shape
    out = {"params": dlrm.tree_from_named(dict(model.named_parameters())),
           "opt_state": {"acc": dlrm.tree_from_named(acc)}}
    ckpt.save(str(tmp_path / "b"), 4, out)
    back, manifest = jckpt.restore(str(tmp_path / "b"))
    assert manifest["step"] == 4
    want = _flat(jckpt.restore(str(tmp_path / "a"))[0])
    got = _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        _bits(got["['params']['tables']"]), _bits(params["tables"]))


# -------------------------------------------------------------- driver ----
@pytest.mark.parametrize("param_dtype,rtol", [("bfloat16", 1e-4),
                                              ("float32", 1e-5)])
def test_drivers_give_the_same_losses(monkeypatch, param_dtype, rtol):
    """Five steps of both drivers' reduced DLRM runs (8 features, D 16,
    512 rows, batch 32 of the seed-0 Criteo stream, row-wise adagrad lr
    1e-3 under warmup-cosine), from the same parameters: in bf16, the
    reference's dtype, losses within rtol 1e-4 (a bias gradient differs
    by up to 4 bf16 ulps, so the updated parameters do by an ulp here and
    there; the loss moves by about 1e-2 a step); with param_dtype f32 in
    both drivers, rtol 1e-5."""
    steps = 5
    jarch = j_get_arch("dlrm-criteo")
    j_reduced, t_reduced = jtrain.reduced_model, train.reduced_model
    monkeypatch.setattr(jtrain, "reduced_model", lambda a: j_reduced(a)
                        .replace(param_dtype=param_dtype))
    monkeypatch.setattr(train, "reduced_model", lambda a: t_reduced(a)
                        .replace(param_dtype=param_dtype))
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
        model.load_state_dict(dlrm.params_from_numpy(params))
        return model
    monkeypatch.setattr(train, "init_params_for", init_from_jax)
    res = train.run("dlrm-criteo", steps=steps, device="cpu")
    assert res["steps"] == steps and res["batch"] == 32
    assert res["samples_per_s"] > 0
    np.testing.assert_allclose(res["losses"], want, rtol=rtol)


def test_driver_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """`--arch dlrm-criteo --device cpu`: the reduced bf16 DLRM with
    row-wise adagrad, checkpointed in the JAX layout (bf16 leaves as
    `|V2`); a second run with more steps resumes where the first ended."""
    d = str(tmp_path)
    first = train.main(["--arch", "dlrm-criteo", "--steps", "4",
                        "--ckpt-dir", d, "--ckpt-every", "2",
                        "--device", "cpu"])
    assert first["steps"] == 4 and ckpt.latest_step(d) == 3
    out = capsys.readouterr().out
    assert "family=dlrm" in out and "optimizer=rowwise_adagrad" in out
    tree, _ = jckpt.restore(d)          # the JAX package reads it
    assert tree["params"]["tables"].shape == (8, 512, 16)
    assert tree["params"]["tables"].dtype == np.dtype("V2")
    assert tree["params"]["top"][0]["w"].shape == (8 * 9 // 2 + 16, 64)
    assert tree["opt_state"]["acc"]["tables"].dtype == np.float32
    second = train.main(["--arch", "dlrm-criteo", "--steps", "6",
                         "--ckpt-dir", d, "--device", "cpu"])
    assert second["steps"] == 2 and ckpt.latest_step(d) == 5
    assert "resumed from step 3" in capsys.readouterr().out
    assert all(np.isfinite(first["losses"] + second["losses"]))


def test_driver_takes_train_shapes_and_full_for_dlrm():
    """`--shape` takes the DLRM's train shape and refuses the others;
    `--full` names the reference configuration."""
    with pytest.raises(KeyError, match="only the train regime"):
        train.main(["--arch", "dlrm-criteo", "--shape", "retrieval_cand",
                    "--device", "cpu"])
    assert ARCH.shape("train_batch").batch == 65536
    assert ARCH.model.vocab_sizes[0] == 1 << 22


# ----------------------------------------------------------- retrieval ----
@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c,chunks", [(40, 4), (30, 1)])
def test_score_candidates_matches_jax(param_dtype, c, chunks):
    """The reference's retrieval scoring at a small C in `chunks` chunks,
    from the same parameters and user, with candidate ids past V (taken
    mod V): f32 rtol 1e-5 / atol 1e-6; bf16 within 2 bf16 ulps of the
    largest score (its top MLP rounds in other places); and each score
    as the port's own forward gives it on that candidate's full batch (f32
    rtol 1e-6 / atol 1e-7, bf16 within 1 ulp: the MLPs' products of one
    user row and of C rows may sum in other orders)."""
    jcfg, cfg = _reduced(param_dtype)
    params = _jax_params(jcfg, 4)
    rng = np.random.RandomState(c)
    user = _batch(cfg, 1, 5)
    cand = rng.randint(0, 3 * cfg.vocab_sizes[0], c).astype(np.int32)
    want = jdlrm.score_candidates(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        {k: jnp.asarray(v) for k, v in user.items()}, jnp.asarray(cand),
        chunks=chunks)
    model = _port_model(cfg, params)
    tuser = {k: torch.from_numpy(v) for k, v in user.items()}
    got = dlrm.score_candidates(model, tuser, torch.from_numpy(cand),
                                chunks=chunks)
    assert got.shape == (c,) and got.dtype == getattr(torch, param_dtype)
    if param_dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-6)
    else:
        _assert_within_ulps(got, want, 2)
    ids = tuser["sparse_ids"].repeat(c, 1, 1)
    ids[:, 0, 0] = torch.from_numpy(cand % cfg.vocab_sizes[0])
    full = model({"dense": tuser["dense"].repeat(c, 1), "sparse_ids": ids})
    if param_dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(full), rtol=1e-6,
                                   atol=1e-7)
    else:
        _assert_within_ulps(got, full, 1)
    with pytest.raises(ValueError, match="chunks"):
        dlrm.score_candidates(model, tuser, torch.from_numpy(cand),
                              chunks=7)


# ------------------------------------------------- launcher, sim backend ---
def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_dlrm_criteo", ROOT / "examples" / "train_dlrm_criteo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_agent_state(n_stages, obs_dim, seed=3):
    cfg = JDQNConfig(obs_dim=obs_dim, n_stages=n_stages, head="factored")
    st = JDQNAgent(cfg, seed=seed).state_dict()
    return {"qnet": st["qnet"], "steps": 0}


def test_sim_backend_makes_the_reference_allocations(monkeypatch, tmp_path):
    """`--backend sim` on the CPU at a tiny DLRM: the InTune tuner of a
    simulated 128-CPU Criteo pipeline ticks once a train step; from the
    same pretrained agent weights its allocations over 30 ticks equal
    those of the JAX example's `run_sim` (its model cut to the same tiny
    size), and the losses are finite."""
    steps = 30
    tiny = dict(name="tiny", n_sparse=4, n_dense=13, embed_dim=8,
                vocab_sizes=(64,) * 4, bottom_mlp=(16, 8),
                top_mlp=(16, 1))
    state = _shared_agent_state(5, 16)
    jex = _jax_example()
    jcfg = jex.DLRMConfig(**tiny)

    def j_build_model(batch):
        params, _ = jdlrm.init_params(jax.random.PRNGKey(0), jcfg)
        opt = joptim.make_optimizer("adagrad", lr=0.02)
        step = jax.jit(j_make_train_step(
            lambda p, b: jdlrm.loss_fn(p, jcfg, b), opt))
        return jcfg, params, opt, step
    made = []

    def tuner(cls):
        def make(*a, **kw):
            made.append(cls(*a, pretrained=state, **kw))
            return made[-1]
        return make
    monkeypatch.setattr(jex, "build_model", j_build_model)
    monkeypatch.setattr(jex, "InTune", tuner(JInTune))
    monkeypatch.setattr(train_dlrm_criteo, "InTune", tuner(InTune))
    args = type("Args", (), dict(steps=steps, batch=16, ckpt_every=0,
                                 ckpt_dir=str(tmp_path / "jax"),
                                 device="cpu", seed=0))()
    jex.run_sim(args)
    want = [(list(map(int, h["workers"])), float(h["prefetch_mb"]))
            for h in made[0].history]
    # the port resumes from a checkpoint in its directory: start it fresh
    args.ckpt_dir = str(tmp_path / "port")
    res = train_dlrm_criteo.run_sim(args, DLRMConfig(**tiny))
    assert len(want) == steps and res["allocations"] == want
    assert all(np.isfinite(res["losses"])) and len(res["losses"]) == steps


def test_launcher_cli_takes_both_backends(monkeypatch):
    calls = []
    monkeypatch.setattr(train_dlrm_criteo, "run_proc",
                        lambda args: calls.append(("proc", args.steps)))
    monkeypatch.setattr(train_dlrm_criteo, "run_sim",
                        lambda args: calls.append(("sim", args.steps)))
    train_dlrm_criteo.main(["--steps", "3"])
    train_dlrm_criteo.main(["--steps", "4", "--backend", "sim"])
    assert calls == [("proc", 3), ("sim", 4)]
    with pytest.raises(SystemExit):
        train_dlrm_criteo.main(["--backend", "fleet"])


# ------------------------------------------------------------ pretrain ----
def test_pretrain_matches_jax_from_shared_weights(monkeypatch, tmp_path):
    """A few short pretraining episodes (4 stages, 2 episodes of 50
    ticks, seed 0) in both packages from the same npz weights (each
    package's DQNAgent patched, here only, to load them): the same steps
    and agent weights within rtol 1e-4 / atol 1e-6 after the 36 TD
    updates; then each package's saved npz loads into the other's agent
    bit for bit."""
    n_stages = 4
    state = _shared_agent_state(n_stages, 2 * n_stages + 6)
    path = tmp_path / "shared.npz"
    np.savez(path, steps=0, **{f"qnet/{layer}/{k}": v
                               for layer, p in state["qnet"].items()
                               for k, v in p.items()})

    def loading(cls, load):
        def make(cfg, seed=0):
            agent = cls(cfg, seed=seed)
            agent.load_state_dict(load(str(path)))
            return agent
        return make
    monkeypatch.setattr(jpretrain, "DQNAgent",
                        loading(JDQNAgent, jpretrain.load_agent_state))
    monkeypatch.setattr(pretrain, "DQNAgent",
                        loading(tagent.DQNAgent, pretrain.load_agent_state))
    kw = dict(episodes=2, ticks=50, seed=0, verbose=False, head="factored")
    j_agent = jpretrain.pretrain(n_stages, **kw)
    t_agent = pretrain.pretrain(n_stages, **kw)
    js, ts = j_agent.state_dict(), t_agent.state_dict()
    assert ts["steps"] == js["steps"] == 100
    for layer, p in js["qnet"].items():
        for k, v in p.items():
            np.testing.assert_allclose(ts["qnet"][layer][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{layer}/{k}")
    pretrain.save_agent(t_agent, str(tmp_path / "port" / "dqn_r4.npz"))
    jpretrain.save_agent(j_agent, str(tmp_path / "jax" / "dqn_r4.npz"))
    from_port = jpretrain.load_agent_state(str(tmp_path / "port" /
                                               "dqn_r4.npz"))
    from_jax = pretrain.load_agent_state(str(tmp_path / "jax" /
                                             "dqn_r4.npz"))
    assert from_port["steps"] == from_jax["steps"] == 100
    j2 = JDQNAgent(j_agent.cfg, seed=5)
    j2.load_state_dict(from_port)
    t2 = tagent.DQNAgent(t_agent.cfg, seed=5)
    t2.load_state_dict(from_jax)
    for layer, p in ts["qnet"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(j2.params[layer][k]), v)
    for layer, p in t2.state_dict()["qnet"].items():
        for k, v in p.items():
            np.testing.assert_array_equal(v, js["qnet"][layer][k])


def test_pretrain_cli_writes_the_agent(tmp_path, capsys):
    pretrain.main(["--stages", "3", "--episodes", "1", "--ticks", "20",
                   "--out", str(tmp_path)])
    st = pretrain.load_agent_state(str(tmp_path / "dqn_r3.npz"))
    assert st["steps"] == 20 and set(st["qnet"]) == {"l1", "l2", "l3"}
    assert "saved" in capsys.readouterr().out
    port = InTune(*_pipeline_and_machine(3), pretrained=st)
    assert port.agent.steps >= st["steps"]


def _pipeline_and_machine(n_stages):
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.data.simulator import MachineSpec
    return make_pipeline(n_stages, seed=1), MachineSpec(n_cpus=32)


def test_make_pipeline_matches_jax():
    from repro.data.pipeline import make_pipeline as j_make_pipeline
    from repro_torch.data.pipeline import make_pipeline
    for n, seed in ((3, 0), (5, 7), (8, 2)):
        a, b = j_make_pipeline(n, seed=seed), make_pipeline(n, seed=seed)
        assert a.name == b.name and a.batch_mb == b.batch_mb
        assert [dataclasses.asdict(s) for s in a.stages] == \
            [dataclasses.asdict(s) for s in b.stages]
