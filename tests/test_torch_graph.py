"""repro_torch's GraphSAGE full-graph and batched-graph regimes, its
gather-and-segment-reduce, `ragged_embedding_bag`, `hash_ids` and the
optimizers sgd, adagrad with grad_clip and adam with bf16 state, against
the JAX package on the CPU, from the same numpy inputs and parameters;
and the generic driver at `full_graph_sm` and `molecule` against the JAX
train step, with checkpoints crossing between the packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import GNNConfig as JGNNConfig  # noqa: E402
from repro.models import embedding as jemb  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs.base import GNNConfig, GNNShape  # noqa: E402
from repro_torch.configs.graphsage_reddit import ARCH  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import embedding, gnn, segment  # noqa: E402
from repro_torch.models.exchange import from_numpy, to_numpy  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optim  # noqa: E402

BF16 = torch.bfloat16


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(aggregator="mean", d_hidden=16, n_classes=5):
    kw = dict(name="g", n_layers=2, d_hidden=d_hidden, n_classes=n_classes,
              aggregator=aggregator)
    return JGNNConfig(**kw), GNNConfig(**kw)


def _jax_params(jcfg, d_feat, seed=0):
    params, _ = jgnn.init_params(jax.random.PRNGKey(seed), jcfg, d_feat)
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg, d_feat, np_params):
    model = gnn.init_params(cfg, d_feat, seed=1, device="cpu")
    model.load_state_dict(gnn.params_from_numpy(np_params))
    return model


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _graph(n=60, e=150, d=12, n_classes=5, seed=0, isolated=True):
    """A graph with duplicate edges, labels of -1 and 6 pad edges
    n -> n; with `isolated`, 3 nodes receive no edge (a ring reaches
    every node otherwise)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n, e)
    if isolated:
        dst = np.where(dst < 3, dst + 3, dst)
    else:
        src = np.concatenate([src, np.arange(n)])
        dst = np.concatenate([dst, (np.arange(n) + 1) % n])
    src = np.concatenate([src, src[:20], np.full(6, n)]).astype(np.int32)
    dst = np.concatenate([dst, dst[:20], np.full(6, n)]).astype(np.int32)
    labels = rng.randint(0, n_classes, n).astype(np.int32)
    labels[::7] = -1
    return {"x": rng.randn(n, d).astype(np.float32), "edge_src": src,
            "edge_dst": dst, "labels": labels}


def _check_grads(model, j_grads, rtol, atol):
    got = gnn.tree_from_named({k: p.grad.numpy() for k, p in
                               model.named_parameters()})
    want, got = _flat(j_grads), _flat(got)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------- full graph ----
@pytest.mark.parametrize("aggregator,isolated", [
    ("mean", True), ("mean", False), ("max", False)])
def test_full_graph_loss_and_grads_match_jax(aggregator, isolated):
    """rtol 1e-5 / atol 1e-6 on the loss and every gradient. The graph
    has duplicate edges (tied maxima for max, which share their
    gradient), labels of -1 and pad edges n -> n; for mean also isolated
    nodes (max sends an isolated node's -inf into the projection: see
    the next test)."""
    jcfg, cfg = _configs(aggregator)
    np_params = _jax_params(jcfg, 12)
    batch = _graph(isolated=isolated)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jgnn.full_graph_loss(p, jcfg, batch), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, np_params))
    model = _port_model(cfg, 12, np_params)
    loss, _ = gnn.full_graph_loss(model, _torch(batch))
    loss.backward()
    assert np.isfinite(float(j_loss))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    _check_grads(model, j_grads, 1e-5, 1e-6)


def test_full_graph_max_forward_matches_jax_with_isolated_nodes():
    """An isolated node's max is -inf; the projection turns it into NaN,
    which layer 2's max sends on to the node's out-neighbours whatever
    the order of the pairs: equal_nan, rtol 1e-5 / atol 1e-6."""
    jcfg, cfg = _configs("max")
    np_params = _jax_params(jcfg, 12)
    batch = _graph(isolated=True)
    want = np.asarray(jgnn.full_graph_forward(
        np_params, jcfg, batch["x"], batch["edge_src"], batch["edge_dst"],
        60))
    t = _torch(batch)
    with torch.no_grad():
        got = gnn.full_graph_forward(
            _port_model(cfg, 12, np_params), t["x"],
            gnn.graph_plan(t["edge_src"], t["edge_dst"], 60)).numpy()
    assert np.isnan(want).any() and np.isfinite(want).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


# --------------------------------------------------- batched small graphs --
def test_batched_graphs_loss_and_grads_match_jax():
    """molecule-style batch: pad edges 0 -> 0 (real messages into node 0)
    and masked nodes; rtol 1e-5 / atol 1e-6."""
    jcfg, cfg = _configs()
    np_params = _jax_params(jcfg, 12)
    shape = GNNShape("m", "batched_small", n_nodes=10, n_edges=24,
                     d_feat=12, n_graphs=6)
    batch = graphs.molecule_batch(shape, 5, np.random.RandomState(3))
    assert (batch["node_mask"] == 0).any()
    assert ((batch["edge_src"] == 0) & (batch["edge_dst"] == 0)).any()
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jgnn.batched_graphs_loss(p, jcfg, batch), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, np_params))
    model = _port_model(cfg, 12, np_params)
    loss, _ = gnn.batched_graphs_loss(model, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    _check_grads(model, j_grads, 1e-5, 1e-6)


def test_molecule_batch_keeps_edges_among_real_nodes():
    shape = GNNShape("m", "batched_small", n_nodes=30, n_edges=64,
                     d_feat=4, n_graphs=50)
    b = graphs.molecule_batch(shape, 47, np.random.RandomState(0))
    n_real = b["node_mask"].sum(1)
    assert b["x"].shape == (50, 30, 4) and b["labels"].max() < 47
    assert (n_real >= 15).all() and (n_real <= 30).all()
    assert (b["edge_src"] < n_real[:, None]).all()
    assert (b["edge_dst"] < n_real[:, None]).all()
    assert not np.abs(b["x"][b["node_mask"] == 0]).any()


def test_full_graph_batch_is_sorted_by_dst_and_padded():
    shape = GNNShape("f", "full_graph", n_nodes=300, n_edges=1000, d_feat=5)
    b = graphs.full_graph_batch(shape, 7, np.random.RandomState(0))
    assert b["edge_src"].shape == (1024,) and b["x"].shape == (300, 5)
    assert (b["edge_dst"][1000:] == 300).all()
    assert (b["edge_src"][1000:] == 300).all()
    assert (np.diff(b["edge_dst"]) >= 0).all()
    assert graphs.padded_edges(61859140) - 61859140 == 188


# ---------------------------------------------- ragged bag and hash_ids ---
TABLE = np.random.RandomState(0).randn(64, 8).astype(np.float32)
# segment 3 and 5 empty; ids -1 (the last row) and 70 (no row: NaN in
# segment 4); segment ids -1 and 6 dropped
IDS = np.array([1, 2, 3, 10, 11, 40, 5, 9, 63, 1, -1, 70, 8], np.int32)
SEGS = np.array([0, 0, 0, 1, 1, 2, -1, 6, 2, 2, 1, 4, 4], np.int32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Elementwise bf16 ulp of x (2^-7 of its power of two)."""
    m = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_embedding_bag_matches_jax(combiner, dtype):
    """Empty segments (sum 0, max -inf), dropped segment ids, a wrapped
    -1 and an id past the table (its segment NaN); f32 at rtol 1e-6,
    bf16 tables within 2 bf16 ulps, and a bf16 table's mean in f32."""
    jt = jnp.asarray(TABLE, getattr(jnp, dtype))
    want = np.asarray(jemb.ragged_embedding_bag(
        jt, jnp.asarray(IDS), jnp.asarray(SEGS), 6, combiner=combiner))
    tt = torch.from_numpy(TABLE).to(getattr(torch, dtype))
    got = embedding.ragged_embedding_bag(
        tt, torch.from_numpy(IDS), torch.from_numpy(SEGS), 6,
        combiner=combiner)
    assert str(got.dtype).split(".")[1] == str(want.dtype), \
        (got.dtype, want.dtype)
    if combiner == "mean":
        assert got.dtype == torch.float32
    got, want = got.float().numpy(), want.astype(np.float32)
    assert np.isnan(want[4]).all() and np.isnan(got[4]).all()
    assert (want[3] == (-np.inf if combiner == "max" else 0)).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    else:
        ok = np.isfinite(want)
        np.testing.assert_array_equal(got[~ok], want[~ok])
        assert (np.abs(got[ok] - want[ok]) <= 2 * _bf16_ulp(want[ok])).all()


def test_ragged_embedding_bag_rejects_an_unknown_combiner():
    with pytest.raises(ValueError, match="median"):
        embedding.ragged_embedding_bag(torch.from_numpy(TABLE),
                                       torch.from_numpy(IDS),
                                       torch.from_numpy(SEGS), 6,
                                       combiner="median")


@pytest.mark.parametrize("rows", [7, 1000, 1 << 20, (1 << 31) - 1])
def test_hash_ids_is_bitwise_the_jax_hash(rows):
    rng = np.random.RandomState(rows % 1000)
    raw = np.concatenate([
        np.array([-1, 0, 1, (1 << 31) - 1, -(1 << 31), 2654435761 - (1 << 32)],
                 np.int64).astype(np.int32),
        rng.randint(-(1 << 31), (1 << 31) - 1, 500).astype(np.int32)])
    want = np.asarray(jemb.hash_ids(jnp.asarray(raw), rows))
    got = embedding.hash_ids(torch.from_numpy(raw), rows).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the chunked reduce ---
@pytest.mark.parametrize("chunk", [1, 7, 10_000])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_chunked_reduce_equals_one_shot(chunk, op):
    """segment_sum / segment_max walked in chunks of 1, 7 and more than
    the pairs, forward and table gradient, equal to one index_add_ (or
    amax) over every pair at once."""
    rng = np.random.RandomState(chunk)
    table = torch.from_numpy(rng.randn(50, 6).astype(np.float32))
    g = torch.from_numpy(rng.randint(0, 50, 400).astype(np.int32))
    s = torch.from_numpy(rng.randint(0, 40, 400).astype(np.int32))
    plan = segment.segment_plan(g, s, 40, 50)
    d_out = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    t = table.clone().requires_grad_()
    fn = segment.segment_sum if op == "sum" else segment.segment_max
    got = fn(t, plan, chunk=chunk)
    (d_got,) = torch.autograd.grad(got, t, d_out)
    t = table.clone().requires_grad_()
    if op == "sum":
        want = torch.zeros(40, 6).index_add(0, s, t[g.long()])
    else:
        want = torch.full((40, 6), -float("inf")).index_reduce(
            0, s, t[g.long()], "amax", include_self=True)
    (d_want,) = torch.autograd.grad(want, t, d_out)
    assert torch.equal(got, want)
    torch.testing.assert_close(d_got, d_want, rtol=0, atol=0)


def test_segment_sum_skips_the_backward_of_a_table_without_grad(
        monkeypatch):
    """Layer 1's x needs no gradient: the reduce walks its pairs once,
    for the forward, and the layer's weights still get theirs."""
    table = torch.randn(10, 3)
    w = torch.randn(3, 2, requires_grad=True)
    plan = segment.segment_plan(torch.tensor([1, 2, 3]),
                                torch.tensor([0, 0, 9]), 10, 10)
    calls = []
    walk = segment._gathered

    def counting(*a):
        calls.append(a[1].numel())
        return walk(*a)
    monkeypatch.setattr(segment, "_gathered", counting)
    (segment.segment_sum(table, plan) @ w).sum().backward()
    assert calls == [3] and w.grad is not None


# ---------------------------------------------------------- optimizers -----
def _opt_run(name, kw, dtype="float32", steps=10, seed=5):
    """`steps` updates of both packages' optimizer from the same params
    and gradients; returns [(jax params, jax state), (port ...)] as
    numpy, and each step's grad_norm pair."""
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    kw = dict(lr=1e-2, warmup=2, total_steps=12, **kw)
    jopt = joptim.make_optimizer(name, **{
        k: (jnp.bfloat16 if v is BF16 else v) for k, v in kw.items()})
    topt = optim.make_optimizer(name, **kw)
    jp = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    norms = []
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        jp, js, jstats = jopt.update(jg, js, jp, step)
        tp, ts, tstats = topt.update(tg, ts, tp, step)
        norms.append((float(jstats["grad_norm"]), float(tstats["grad_norm"])))
    j = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                               (jp, js))
    t = ({k: v.float().numpy() for k, v in tp.items()},
         {s: {k: v.float().numpy() for k, v in d.items()}
          for s, d in ts.items()})
    return j, t, norms


@pytest.mark.parametrize("name,kw,dtype", [
    ("sgd", {}, "float32"),
    ("sgd", {"grad_clip": 0.05}, "float32"),
    ("sgd", {"grad_clip": 0.05, "momentum": 0.5}, "bfloat16"),
    ("adagrad", {"grad_clip": 0.05}, "float32"),
    ("adam", {"grad_clip": 0.05}, "bfloat16")])
def test_optimizer_matches_jax(name, kw, dtype):
    """Ten updates from the same parameters and gradients: grad_norm
    (before clipping) rtol 1e-6, parameters and state rtol 1e-6. bf16
    parameters and gradients (sgd and adam, clipped) bitwise: the clip's
    product and the update in f32, each rounded once, as the reference
    rounds them (the port once rounded the clip scale, and adam's update,
    to bf16 first). The
    state's atol is 1e-8: sgd's mu sums terms of up to 0.3 of both
    signs, and the two packages' global norms, summed in other orders,
    may give clip scales an f32 ulp apart."""
    (jp, js), (tp, ts), norms = _opt_run(name, kw, dtype)
    for a, b in norms:
        np.testing.assert_allclose(b, a, rtol=1e-6)
    assert js.keys() == ts.keys() == {"sgd": {"mu"}, "adagrad": {"acc"},
                                      "adam": {"m", "v"}}[name]
    for k in jp:
        if dtype == "bfloat16":
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        else:
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        for s in js:
            np.testing.assert_allclose(ts[s][k], js[s][k], rtol=1e-6,
                                       atol=1e-8, err_msg=f"{s}/{k}")


def test_adam_bf16_state_matches_jax():
    """adam(state_dtype=bfloat16), ten updates: parameters rtol 1e-6, m
    and v (stored in bf16 after f32 math) within 1 bf16 ulp."""
    (jp, js), (tp, ts), _ = _opt_run("adam", {"state_dtype": BF16})
    opt = optim.make_optimizer("adam", state_dtype=BF16)
    assert opt.init({"a": torch.zeros(2)})["m"]["a"].dtype == BF16
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        for s in ("m", "v"):
            err = np.abs(ts[s][k] - js[s][k])
            assert (err <= _bf16_ulp(js[s][k])).all(), (s, k, err.max())


def test_adam_bf16_state_checkpoint_crosses_as_v2(tmp_path):
    """The port writes bf16 adam state as `|V2` (np.savez's encoding of a
    JAX bf16 array): the JAX package reads the same bits back, and the
    port restores them as bf16 tensors."""
    opt = optim.make_optimizer("adam", state_dtype=BF16)
    params = {"a": torch.randn(6, 4)}
    state = opt.init(params)
    opt.update({"a": torch.randn(6, 4)}, state, params, 0)
    ckpt.save(str(tmp_path), 0, {"opt_state": state})
    back, _ = jckpt.restore(str(tmp_path))
    m = back["opt_state"]["m"]["a"]
    assert m.dtype == np.dtype("V2")
    np.testing.assert_array_equal(m.view(np.int16),
                                  to_numpy(state["m"]["a"]).view(np.int16))
    tree, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert tree["opt_state"]["v"]["a"].dtype == BF16
    assert torch.equal(tree["opt_state"]["v"]["a"], state["v"]["a"])
    assert torch.equal(from_numpy(m), state["m"]["a"])


# -------------------------------------------------------------- driver ----
STEPS = 4


def _jax_losses(jcfg, loss, batches, np_params, start=0, state=None):
    """The JAX train step (adam lr 1e-3 under warmup-cosine, the driver's)
    over `batches` from `np_params` (and adam `state`, else fresh),
    numbered from `start`: (losses, params, state)."""
    opt = joptim.make_optimizer("adam", lr=1e-3)
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    s = opt.init(p) if state is None else state
    step = jax.jit(j_make_train_step(lambda q, b: loss(q, jcfg, b), opt))
    losses = []
    for i, b in enumerate(batches):
        p, s, metrics = step(p, s, start + i, b)
        losses.append(float(metrics["loss"]))
    return losses, p, s


def _from_jax(monkeypatch, np_params):
    port_init = train.init_params_for

    def init(*a, **kw):
        model = port_init(*a, **kw)
        model.load_state_dict(gnn.params_from_numpy(np_params))
        return model
    monkeypatch.setattr(train, "init_params_for", init)


def _driver_case(name):
    shape = ARCH.shape(name)
    jcfg = JGNNConfig(name="graphsage-reddit", d_hidden=16, n_classes=47)
    np_params = _jax_params(jcfg, shape.d_feat)
    rng = np.random.RandomState(0)
    if shape.kind == "full_graph":
        batch = graphs.full_graph_batch(shape, 47, rng)
        return shape, jcfg, np_params, jgnn.full_graph_loss, \
            [batch] * STEPS
    return shape, jcfg, np_params, jgnn.batched_graphs_loss, \
        [graphs.molecule_batch(shape, 47, rng) for _ in range(STEPS)]


@pytest.mark.parametrize("name", ["full_graph_sm", "molecule"])
def test_drivers_give_the_same_losses(monkeypatch, capsys, name):
    """The port's CLI at the shape (reduced widths: d_hidden 16, --device
    cpu) over 4 steps, against the JAX train step (full_graph_loss or
    batched_graphs_loss, adam) on the same parameters and batches: the
    losses within rtol 1e-5."""
    shape, jcfg, np_params, loss, batches = _driver_case(name)
    want, _, _ = _jax_losses(jcfg, loss, batches, np_params)
    _from_jax(monkeypatch, np_params)
    res = train.main(["--arch", "graphsage-reddit", "--shape", name,
                      "--steps", str(STEPS), "--device", "cpu"])
    rate = {"full_graph": "nodes_per_s", "batched_small": "graphs_per_s"}
    assert res[rate[shape.kind]] > 0 and res["steps"] == STEPS
    assert res["batch"] == (2708 if name == "full_graph_sm" else 128)
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5)
    assert f"{rate[shape.kind][:-6]}/s" in capsys.readouterr().out


def test_driver_checkpoints_cross_between_the_packages(monkeypatch,
                                                       tmp_path):
    """full_graph_sm, reduced widths: the port's driver saves at step 1;
    the JAX package restores that checkpoint and trains steps 2-3. The
    JAX package saves its own state at step 1; the port's driver resumes
    from it for steps 2-3. Both continue with the losses of an unbroken
    JAX run, rtol 1e-5."""
    shape, jcfg, np_params, loss, batches = _driver_case("full_graph_sm")
    want, p1, s1 = _jax_losses(jcfg, loss, batches[:2], np_params)
    want += _jax_losses(jcfg, loss, batches[2:], p1, 2, s1)[0]
    _from_jax(monkeypatch, np_params)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["--arch", "graphsage-reddit", "--shape", "full_graph_sm",
            "--device", "cpu"]
    first = train.main(args + ["--steps", "2", "--ckpt-dir", port_dir])
    np.testing.assert_allclose(first["losses"], want[:2], rtol=1e-5)
    tree, manifest = jckpt.restore(port_dir)
    assert manifest["step"] == 1 and set(tree["opt_state"]) == {"m", "v"}
    got = _jax_losses(jcfg, loss, batches[2:], tree["params"], 2,
                      jax.tree_util.tree_map(jnp.asarray,
                                             tree["opt_state"]))[0]
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)
    jckpt.save(jax_dir, 1, jax.tree_util.tree_map(
        np.asarray, {"params": p1, "opt_state": s1}))
    resumed = train.main(args + ["--steps", "4", "--ckpt-dir", jax_dir])
    assert resumed["steps"] == 2
    np.testing.assert_allclose(resumed["losses"], want[2:], rtol=1e-5)
