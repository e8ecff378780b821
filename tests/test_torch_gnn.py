"""repro_torch's GraphSAGE slice against the JAX package on the CPU: the
sampler bit for bit, the configs, the registry, the model's loss and
gradients, adam, the checkpoint layout and the generic driver, all from
the same numpy inputs."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_archs as j_list_archs  # noqa: E402
from repro.configs.base import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.configs.base import GNNConfig as JGNNConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import sampler as jsampler  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import GNN_SHAPES, GNNConfig  # noqa: E402
from repro_torch.configs.graphsage_reddit import ARCH  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data import sampler  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402


def _fields(dc):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


# ------------------------------------------------------------- sampler ----
@pytest.mark.parametrize("n_nodes,n_edges,fanout,batch,seed", [
    (512, 4096, (5, 3), 32, 0),
    (64, 20, (4, 2), 16, 3),           # sparse: isolated nodes self-loop
    (1000, 15000, (15, 10), 24, 7),
])
def test_sampler_matches_jax_bitwise(n_nodes, n_edges, fanout, batch, seed):
    jg = jsampler.CSRGraph.random(n_nodes, n_edges, seed=seed)
    tg = sampler.CSRGraph.random(n_nodes, n_edges, seed=seed)
    np.testing.assert_array_equal(tg.nbr, jg.nbr)
    np.testing.assert_array_equal(tg.offsets, jg.offsets)
    rng = np.random.RandomState(seed)
    x = rng.randn(n_nodes, 6).astype(np.float32)
    y = rng.randint(0, 47, n_nodes)
    js = jsampler.NeighborSampler(jg, x, y, fanout=fanout, seed=seed)
    ts = sampler.NeighborSampler(tg, x, y, fanout=fanout, seed=seed)
    for _ in range(3):
        a, b = js.sample(batch), ts.sample(batch)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------- configs, registry ---
def test_gnn_configs_match_jax():
    assert [_fields(s) for s in GNN_SHAPES] == \
        [_fields(s) for s in J_GNN_SHAPES]
    jarch = j_get_arch("graphsage-reddit")
    got = _fields(ARCH.model)
    want = {k: v for k, v in _fields(jarch.model).items() if k in got}
    assert got == want
    assert jarch.skipped_shapes == ()
    for key in ("arch_id", "family", "source", "optimizer"):
        assert getattr(ARCH, key) == getattr(jarch, key), key
    assert ARCH.shape("minibatch_lg").fanout == (15, 10)


@pytest.mark.parametrize("arch_id", j_list_archs())
def test_registry_runs_graphsage_and_names_the_roadmap_for_the_rest(arch_id):
    if arch_id == "graphsage-reddit":
        assert registry.get_arch(arch_id) is ARCH
        assert registry.list_archs() == ["bert4rec", "dien", "dlrm-criteo",
                                         arch_id, "wide-deep", "xdeepfm"]
        return
    # wide-deep: slice 3, tests/test_torch_recsys.py; dlrm-criteo: slice 8,
    # tests/test_torch_dlrm_driver.py; xdeepfm, dien, bert4rec: slice 9,
    # tests/test_torch_recsys_seq.py
    if arch_id in ("wide-deep", "dlrm-criteo", "xdeepfm", "dien",
                   "bert4rec"):
        assert registry.get_arch(arch_id).arch_id == arch_id
        return
    with pytest.raises(KeyError, match="ROADMAP.md queue 1, item"):
        registry.get_arch(arch_id)


# an arch of each ROADMAP queue 1 item that waits, with words of the
# item's heading there
@pytest.mark.parametrize("arch_id,item,heading", [
    ("gemma2-2b", 8, "LLM family"),
    ("qwen2.5-32b", 8, "LLM family"),
    ("smollm-135m", 8, "LLM family")])
def test_registry_names_the_roadmap_item_that_ports_each_arch(arch_id, item,
                                                              heading):
    with pytest.raises(KeyError, match=f"ROADMAP.md queue 1, item {item} "):
        registry.get_arch(arch_id)
    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md") \
        .read_text()
    queue1 = roadmap.split("### Queue 1")[1].split("### Queue 2")[0]
    items = dict(re.findall(r"^\s*(\d+)\. \*\*(.+?)\*\*", queue1, re.M))
    assert heading in items[str(item)], items


def test_registry_rejects_unknown_archs():
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("no-such-arch")


def test_criteo_pipeline_matches_jax():
    a, b = jpipeline.criteo_pipeline(), pipeline.criteo_pipeline()
    assert [_fields(s) for s in a.stages] == [_fields(s) for s in b.stages]
    for key in ("name", "batch_mb", "target_rate", "work"):
        assert getattr(a, key) == getattr(b, key), key


# --------------------------------------------------------------- model ----
SMALL = dict(d_feat=12, d_hidden=16, n_classes=7, batch=9, fanout=(4, 3))
WIDE = dict(d_feat=602, d_hidden=128, n_classes=47, batch=4, fanout=(15, 10))


def _jax_params(cfg, d_feat, seed=0):
    params, _ = jgnn.init_params(jax.random.PRNGKey(seed), cfg, d_feat)
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(d_hidden, n_classes):
    kw = dict(name="g", n_layers=2, d_hidden=d_hidden, n_classes=n_classes)
    return JGNNConfig(**kw), GNNConfig(**kw)


def _block(rng, batch, fanout, d_feat, n_classes):
    f1, f2 = fanout
    return {"x0": rng.randn(batch, d_feat).astype(np.float32),
            "neigh1": rng.randn(batch, f1, d_feat).astype(np.float32),
            "neigh2": rng.randn(batch, f1, f2, d_feat).astype(np.float32),
            "labels": rng.randint(0, n_classes, batch).astype(np.int32)}


def _port_model(cfg, d_feat, np_params):
    model = gnn.init_params(cfg, d_feat, seed=1, device="cpu")
    model.load_state_dict(gnn.params_from_numpy(np_params))
    return model


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_params_round_trip_bitwise():
    jcfg, cfg = _configs(16, 7)
    np_params = _jax_params(jcfg, 12)
    back = gnn.params_to_numpy(_port_model(cfg, 12, np_params))
    a, b = _flat(np_params), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("widths", [SMALL, WIDE], ids=["small", "wide"])
def test_minibatch_loss_and_grads_match_jax(widths):
    """rtol 1e-5 on the loss and every gradient (atol 1e-7: gradient
    entries near 0 carry the other summation order's rounding)."""
    jcfg, cfg = _configs(widths["d_hidden"], widths["n_classes"])
    np_params = _jax_params(jcfg, widths["d_feat"])
    block = _block(np.random.RandomState(0), widths["batch"],
                   widths["fanout"], widths["d_feat"], widths["n_classes"])
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jgnn.minibatch_loss(p, jcfg, block), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, np_params))
    model = _port_model(cfg, widths["d_feat"], np_params)
    batch = {k: torch.from_numpy(v) for k, v in block.items()}
    loss, _ = gnn.minibatch_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    grads = gnn.tree_from_named({k: p.grad.numpy() for k, p in
                                 model.named_parameters()})
    want, got = _flat(j_grads), _flat(grads)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_kernel_op_and_plain_autograd_give_the_same_model_gradients():
    """The model through ops.sage_aggregate (the autograd.Function) and
    through the plain version differentiated by autograd, as
    chip_smoke.py compares them on the card."""
    jcfg, cfg = _configs(16, 7)
    np_params = _jax_params(jcfg, 12)
    batch = {k: torch.from_numpy(v) for k, v in _block(
        np.random.RandomState(1), 9, (4, 3), 12, 7).items()}
    grads = []
    for agg_fn in (None, ref.sage_aggregate_ref):
        model = _port_model(cfg, 12, np_params)
        loss, _ = gnn.minibatch_loss(model, batch, agg_fn=agg_fn)
        grads.append([g.numpy() for g in torch.autograd.grad(
            loss, list(model.parameters()))])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- adam -----
@pytest.mark.parametrize("grad_clip,weight_decay", [
    (1.0, 0.0), (0.05, 0.0), (0.0, 0.0), (1.0, 0.01)])
def test_adam_matches_jax(grad_clip, weight_decay):
    """Three updates from the same parameters and gradients (the second
    case clips every step), rtol 1e-5 on parameters and state."""
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    kw = dict(lr=1e-2, warmup=2, total_steps=10, grad_clip=grad_clip,
              weight_decay=weight_decay)
    jopt = joptim.make_optimizer("adam", **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    topt = optim.make_optimizer("adam", **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        jp, js, jstats = jopt.update({k: jnp.asarray(v) for k, v in
                                      g.items()}, js, jp, step)
        tp, ts, tstats = topt.update({k: torch.from_numpy(v.copy())
                                      for k, v in g.items()}, ts, tp, step)
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
        assert tstats["lr"] == pytest.approx(float(jstats["lr"]), rel=1e-7)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)
            for s in ("m", "v"):
                np.testing.assert_allclose(ts[s][k].numpy(),
                                           np.asarray(js[s][k]), rtol=1e-5,
                                           atol=1e-9)


# ---------------------------------------------------------- checkpoint ----
def test_checkpoint_round_trip_jax_port_jax(tmp_path):
    """A JAX checkpoint of GNN params and adam state restores into the
    port (tensors on the given device), trains nowhere, is saved by the
    port, and restores into JAX bit for bit."""
    jcfg, cfg = _configs(16, 7)
    params = _jax_params(jcfg, 12)
    state = joptim.make_optimizer("adam").init(params)
    state = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, state)
    jckpt.save(str(tmp_path / "a"), 3, {"params": params,
                                        "opt_state": state})
    tree, manifest = ckpt.restore(str(tmp_path / "a"), device="cpu")
    assert manifest["step"] == 3
    model = gnn.init_params(cfg, 12, seed=2, device="cpu")
    model.load_state_dict(gnn.named_from_tree(tree["params"]))
    m = gnn.named_from_tree(tree["opt_state"]["m"])
    assert all(torch.is_tensor(t) and t.device.type == "cpu"
               for t in m.values())
    out = {"params": gnn.tree_from_named(dict(model.named_parameters())),
           "opt_state": {k: gnn.tree_from_named(gnn.named_from_tree(v))
                         for k, v in tree["opt_state"].items()}}
    ckpt.save(str(tmp_path / "b"), 4, out)
    back, manifest = jckpt.restore(str(tmp_path / "b"))
    assert manifest["step"] == 4 and jckpt.latest_step(str(tmp_path / "b")) \
        == 4
    want = _flat({"params": params, "opt_state": state})
    got = _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_restores_arrays_split_across_shards(tmp_path):
    """A JAX checkpoint whose arrays are split along axis 0 over several
    shard files restores whole into the port, dtypes kept, and the port
    writes the JAX layout's empty `extras`."""
    rng = np.random.RandomState(2)
    tree = {"w": rng.randn(40, 6).astype(np.float32),
            "ids": (np.arange(70, dtype=np.int32),)}
    jckpt.save(str(tmp_path / "j"), 7, tree, max_shard_bytes=256)
    got, manifest = ckpt.restore(str(tmp_path / "j"), "cpu")
    assert manifest["step"] == 7
    assert len(manifest["index"]["w"]) > 1
    assert len(manifest["index"]["ids/[0]"]) > 1
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    assert got["ids"][0].dtype == torch.int32
    np.testing.assert_array_equal(got["ids"][0].numpy(), tree["ids"][0])
    ckpt.save(str(tmp_path / "p"), 8, got)
    _, manifest = jckpt.restore(str(tmp_path / "p"))
    assert manifest["extras"] == {}


# -------------------------------------------------------------- driver ----
def test_drivers_give_the_same_losses(monkeypatch):
    """Five steps of both drivers' reduced GNN runs (the JAX driver's
    small graph, batch 32, adam lr 1e-3 under warmup-cosine), from the
    same parameters: the same sampled batches, losses within rtol 1e-5."""
    steps = 5
    jarch = j_get_arch("graphsage-reddit")
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
        model.load_state_dict(gnn.params_from_numpy(params))
        return model
    monkeypatch.setattr(train, "init_params_for", init_from_jax)
    res = train.run("graphsage-reddit", steps=steps, device="cpu")
    assert res["steps"] == steps and res["batch"] == 32
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)


def test_driver_cli_checkpoints_and_resumes(tmp_path, capsys):
    d = str(tmp_path)
    first = train.main(["--arch", "graphsage-reddit", "--steps", "4",
                        "--ckpt-dir", d, "--ckpt-every", "2",
                        "--device", "cpu"])
    assert first["steps"] == 4 and ckpt.latest_step(d) == 3
    tree, _ = jckpt.restore(d)          # the JAX package reads it
    assert tree["params"]["layers"][0]["w_self"].shape == (32, 16)
    assert set(tree["opt_state"]) == {"m", "v"}
    second = train.main(["--arch", "graphsage-reddit", "--steps", "6",
                         "--ckpt-dir", d, "--device", "cpu"])
    assert second["steps"] == 2 and ckpt.latest_step(d) == 5
    assert "resumed from step 3" in capsys.readouterr().out
    assert all(np.isfinite(second["losses"]))


@pytest.mark.parametrize("name,loss", [
    ("minibatch_lg", gnn.minibatch_loss),
    ("full_graph_sm", gnn.full_graph_loss),
    ("ogb_products", gnn.full_graph_loss),
    ("molecule", gnn.batched_graphs_loss),
    ("train_batch", None), ("no_such_shape", None)])
def test_driver_resolves_each_gnn_shape_to_its_loss(name, loss):
    """Every GNN shape resolves to its regime's loss, as
    repro/launch/programs.py:260-262 picks it; a recsys shape's name or
    an unknown name raises KeyError from the CLI."""
    if loss is None:
        with pytest.raises(KeyError, match=name):
            train.main(["--arch", "graphsage-reddit", "--shape", name,
                        "--device", "cpu"])
        return
    shape = train.resolve_shape(ARCH, name)
    assert train.make_loss_fn(ARCH, ARCH.model, shape) is loss
