"""The port's pure distribution functions against the JAX package, bit
for bit: `to_pspec` and `sanitized_pspec` over tests/test_sharding.py's
hypothesis grid (entry for entry the reference's PartitionSpec), the
rules (`DEFAULT_RULES`, `make_rules`, `DATA_DIMS`, `axes_prod`), the
elastic plans (`viable_mesh_shape`, `ElasticCoordinator`,
`split_file_shards`), the production meshes' shapes, `placements` of a
spec on a mesh, the dst-partitioned layout of a graph (`partition_edges`
against the reference's padding rule), `local_slice`, and the row-shard
placements of the driver; one-rank process groups (gloo) for the mesh
and for `init_distributed`'s refusals.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.common import shardlib as jshard  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro_torch.common import shardlib  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import programs  # noqa: E402
from repro_torch.train import elastic  # noqa: E402


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
NAMES = ["batch", "vocab", "mlp", "fsdp", "heads", "table_rows",
         "act_all_batch", "edges", None]


def _same(spec, jspec):
    assert isinstance(spec, tuple) and len(spec) == len(jspec)
    assert tuple(spec) == tuple(jspec), (spec, jspec)


def test_rules_are_the_references():
    assert shardlib.DEFAULT_RULES == jshard.DEFAULT_RULES
    assert shardlib.DATA_DIMS == jshard.DATA_DIMS
    over = {"heads": None, "head_dim": "model",
            "table_rows": ("pod", "data", "model")}
    assert shardlib.make_rules(over) == jshard.make_rules(over)
    assert shardlib.make_rules() == jshard.make_rules()


@settings(max_examples=60, deadline=None)
@given(dims=st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       names=st.lists(st.sampled_from(NAMES), min_size=1, max_size=4),
       table_rows_all=st.booleans())
def test_specs_match_the_reference(dims, names, table_rows_all):
    n = min(len(dims), len(names))
    dims, names = dims[:n], names[:n]
    over = {"table_rows": ("pod", "data", "model")} if table_rows_all \
        else None
    rules, jrules = shardlib.make_rules(over), jshard.make_rules(over)
    for mesh in (MESH, MESH3):
        _same(shardlib.sanitized_pspec(dims, names, rules, mesh),
              jshard.sanitized_pspec(dims, names, jrules, mesh))
        _same(shardlib.to_pspec(names, rules, mesh.axis_names),
              jshard.to_pspec(names, jrules, mesh.axis_names))
        for name in names:
            axis = shardlib._filter_axis(rules.get(name), mesh.axis_names)
            assert axis == jshard._filter_axis(jrules.get(name),
                                               mesh.axis_names)
            assert shardlib.axes_prod(axis, mesh) == \
                jshard.axes_prod(axis, mesh)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 2048), tp=st.sampled_from([1, 2, 4, 8, 16]))
def test_viable_mesh_shape_is_the_references(n, tp):
    assert elastic.viable_mesh_shape(n, model_parallel=tp) == \
        jelastic.viable_mesh_shape(n, model_parallel=tp)


def test_elastic_coordinator_and_file_shards_are_the_references():
    a = elastic.ElasticCoordinator(n_devices=256, model_parallel=16)
    b = jelastic.ElasticCoordinator(n_devices=256, model_parallel=16)
    for n in (256, 200, 192, 128, 60, 16, 8, 1, 512):
        assert a.recovery_plan(n) == b.recovery_plan(n)
    assert a.history == b.history and a.current == b.current
    files = [f"part-{i:05d}" for i in (7, 3, 11, 0, 5, 9, 2)]
    for hosts in (1, 2, 3, 7):
        for host in range(hosts):
            assert elastic.split_file_shards(files, hosts, host) == \
                jelastic.split_file_shards(files, hosts, host)


def test_production_shapes_and_sizes():
    assert mesh_lib.PRODUCTION_SHAPES == {
        1: ((16, 16), ("data", "model")),
        2: ((2, 16, 16), ("pod", "data", "model"))}
    assert mesh_lib.dp_size(MESH3) == 32 and mesh_lib.tp_size(MESH3) == 16
    assert mesh_lib.dp_size(MESH) == 16 and mesh_lib.tp_size(MESH) == 16
    assert mesh_lib.tp_size(FakeMesh({"data": 4})) == 1


def test_placements_on_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    spec = (None, ("pod", "data", "model"), None)
    assert shardlib.placements(spec, MESH3) == (Shard(1), Shard(1), Shard(1))
    assert shardlib.placements(("model", None), MESH) == (Replicate(),
                                                          Shard(0))
    assert shardlib.placements((None, None), MESH) == (Replicate(),
                                                       Replicate())
    assert shardlib.spec_axes(spec) == ("pod", "data", "model")
    # the port moves activations explicitly: ShardCtx constrains nothing
    # and has no `cs` that would look as though it did
    assert not hasattr(shardlib.ShardCtx(), "cs")


@pytest.mark.parametrize("n,e,shards", [(50, 200, 1), (1500, 2000, 4),
                                        (3000, 9000, 2), (2708, 10556, 8)])
def test_partition_edges_layout(n, e, shards):
    """The reference's padding (programs.py:218-240: nodes to a multiple
    of 512, e_loc from the slack rounded to 8); each real edge once, in
    the row of its dst's range, in input order; pad edges -1."""
    rng = np.random.RandomState(n)
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    n_pad, ps, pd = graphs.partition_edges(src, dst, n, shards)
    assert n_pad == -(-n // 512) * 512
    e_loc = -(-int(e * 1.25) // shards)
    assert ps.shape == pd.shape == (shards, -(-e_loc // 8) * 8)
    n_loc = n_pad // shards
    got = []
    for k in range(shards):
        real = ps[k] >= 0
        assert (pd[k][~real] == -1).all() and (ps[k][~real] == -1).all()
        assert ((pd[k][real] // n_loc) == k).all()
        got += list(zip(ps[k][real], pd[k][real]))
    want = sorted(zip(src, dst), key=lambda sd: sd[1] // n_loc)
    assert got == want


def test_partitioned_batch_pads_nodes():
    b = {"x": np.ones((10, 3), np.float32),
         "edge_src": np.array([0, 1, 10], np.int32),
         "edge_dst": np.array([1, 2, 10], np.int32),
         "labels": np.arange(10, dtype=np.int32)}
    p = graphs.partitioned_batch(b, 2)
    assert p["x"].shape == (512, 3) and p["x"][10:].sum() == 0
    assert (p["labels"][10:] == -1).all()
    assert (p["edge_src"] >= 0).sum() == 2       # the pad edge 10 -> 10 gone


def test_local_slice_blocks():
    x = np.arange(4 * 8 * 2).reshape(4, 8, 2)
    mesh = FakeMesh({"data": 2, "model": 2})
    for d in range(2):
        for m in range(2):
            mesh.index = lambda axes, d=d, m=m: {
                ("data", "model"): d * 2 + m, ("model",): m,
                ("data",): d}[(axes,) if isinstance(axes, str)
                              else tuple(axes)]
            mesh.size = lambda axes: 4 if not isinstance(axes, str) else 2
            blk = elastic.local_slice(x, (None, ("data", "model"), None),
                                      mesh)
            k = d * 2 + m
            np.testing.assert_array_equal(blk, x[:, 2 * k:2 * k + 2])


def _reference_logical(arch_id: str, name: str) -> tuple:
    """The logical axes the reference's init function gives the leaf
    that the port names `name` (its reduced config, from shapes alone:
    `abstract_init`)."""
    from repro.launch import programs as jprograms
    from repro.launch.train import reduced_model
    from repro.models import dlrm as jdlrm, gnn as jgnn, recsys as jrecsys
    jarch = j_get_arch(arch_id)
    cfg, key = reduced_model(jarch), jax.random.PRNGKey(0)
    init = {"dlrm": lambda: jdlrm.init_params(key, cfg),
            "gnn": lambda: jgnn.init_params(key, cfg, d_feat=8)}.get(
        jarch.family, lambda: jrecsys.INIT[cfg.name](key, cfg))
    _, node = jprograms.abstract_init(init)
    parts = name.split(".")
    if parts[-1] in ("weight", "bias") and parts[-2].isdigit():
        parts[-1] = parts[-1][0]
    for part in parts:
        node = node[int(part)] if part.isdigit() else node[part]
    return tuple(node)


@pytest.mark.parametrize("arch_id,name,want", [
    ("dlrm-criteo", "tables", (None, ("data", "model"), None)),
    ("dlrm-criteo", "top.0.weight", ("model", "data")),
    ("wide-deep", "tables", (None, ("data", "model"), None)),
    ("wide-deep", "wide", (None, ("data", "model"))),
    ("bert4rec", "items", ("model", None)),
    ("bert4rec", "blocks.0.wqkv", ("data", None, "model", None)),
    ("xdeepfm", "tables", (None, "model", None)),
    ("xdeepfm", "cin.0", ("model", None, None)),
    ("dien", "gru1.w", ("data", "model")),
    ("graphsage-reddit", "layers.0.w_self", ("data", None))])
def test_row_sharded_placements(arch_id, name, want):
    """The driver's placement at (2, 2): each leaf at the reference's own
    spec of it (sanitized_pspec of the logical axes of the reference's
    init, which the port's model declares in `param_logical()`, with the
    config's overrides; an nn.Linear weight's transposed): the tables'
    rows over every axis where the config's overrides say so, over the
    model axis by the default rules (xDeepFM's, BERT4Rec's items), the
    dense weights' fsdp over the data axis and mlp over the model axis."""
    from repro_torch.launch import train
    arch, jarch = get_arch(arch_id), j_get_arch(arch_id)
    mesh = FakeMesh({"data": 2, "model": 2})
    mesh.data_axes = ("data",)
    mesh.size = lambda axes: 2 if isinstance(axes, str) else 4
    mesh.index = lambda axes: 0
    mesh.group = lambda axis: None
    mesh.data_group = mesh.all_group = None
    shape = {"tables": (4, 512, 8), "wide": (4, 512), "items": (528, 16),
             "top.0.weight": (64, 32), "blocks.0.wqkv": (16, 3, 2, 8),
             "cin.0": (12, 8, 8), "gru1.w": (8, 48),
             "layers.0.w_self": (32, 16)}[name]
    model = train.init_params_for(arch, train.reduced_model(arch), 0,
                                  device="meta")
    logical = model.param_logical()
    placement = programs.Placement(mesh, arch.model, {name: shape},
                                   logical)
    assert placement.specs[name] == want
    weight = name.endswith(".weight")
    jlogical = _reference_logical(arch_id, name)
    assert logical[name] == (jlogical[::-1] if weight else jlogical)
    jrules = jshard.make_rules(dict(jarch.model.sharding_overrides))
    jshape = shape[::-1] if weight else shape
    jspec = tuple(jshard.sanitized_pspec(jshape, jlogical, jrules, mesh))
    _same(want, jspec[::-1] if weight else jspec)
    with pytest.raises(ValueError, match="no logical axes"):
        programs.Placement(mesh, arch.model, {name + "_x": shape}, logical)
    with pytest.raises(ValueError, match="no logical axes"):
        programs.Placement(mesh, arch.model, {name: shape + (2,)}, logical)


def test_one_rank_mesh_and_backend_rules(tmp_path):
    import torch.distributed as dist
    with pytest.raises(ValueError, match="no process-group backend"):
        mesh_lib.backend_for("meta")
    assert mesh_lib.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
            mesh_lib.init_distributed("cuda", rank=0, world_size=1,
                                      init_method=f"file://{tmp_path}/x")
    assert not dist.is_initialized()
    dev = mesh_lib.init_distributed("cpu", rank=0, world_size=1,
                                    init_method=f"file://{tmp_path}/pg")
    try:
        mesh = mesh_lib.make_host_mesh()
        assert dev == torch.device("cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.index(("data", "model")) == 0
        assert mesh_lib.dp_size(mesh) == mesh_lib.tp_size(mesh) == 1
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_lib.make_mesh(2, 2, "cpu")
        # one shard: the reference's fallback (the unsharded lookup, f32
        # sums) unless the mesh asks for the exchange (the table's dtype,
        # an id outside the rows reading 0)
        from repro_torch.models.embedding import (tp_embedding_lookup,
                                                  tp_multifeature_bag)
        forced_mesh = mesh_lib.Mesh(mesh.device_mesh,
                                    exchange_one_shard=True)
        t = torch.randn(2, 8, 4).to(torch.bfloat16)
        ids = torch.tensor([[[1, 7], [0, 3]]], dtype=torch.int32)
        plain = tp_multifeature_bag(t, ids, mesh, rows=8)
        forced = tp_multifeature_bag(t, ids, forced_mesh, rows=8)
        assert plain.dtype == torch.float32
        assert forced.dtype == torch.bfloat16
        assert torch.equal(forced, plain.to(torch.bfloat16))
        assert torch.equal(tp_embedding_lookup(t[0], ids[0], forced_mesh,
                                               rows=8),
                           tp_embedding_lookup(t[0], ids[0], mesh, rows=8))
        ids[0, 0, 1] = 8
        assert torch.equal(tp_multifeature_bag(t, ids, forced_mesh,
                                               rows=8)[0, 0],
                           t[0, 1].float().to(torch.bfloat16))
        m2 = elastic.make_mesh_from_devices([0], (1, 1))
        assert m2.shape == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("bag,row0,v_loc", [(1, 0, 16), (3, 8, 8),
                                            (17, 12, 4)])
def test_local_rows_plain_versions(bag, row0, v_loc):
    """The local-rows mode's plain versions (the CPU path of the row-
    sharded lookup, and what the card holds the kernel against) against
    the reference's per-shard body in numpy: the forward sums a bag's
    rows in the shard (an id outside reads 0, not NaN; repeats counted),
    the scatter adds d_out to each in-shard slot's row, nothing else."""
    from repro_torch.kernels import ops, ref
    rng = np.random.RandomState(bag)
    tables = rng.randn(3, v_loc, 5).astype(np.float32)
    ids = rng.randint(-3, 24, (7, 3, bag)).astype(np.int32)
    lid = ids.astype(np.int64) - row0
    ok = (lid >= 0) & (lid < v_loc)
    want = np.zeros((7, 3, 5), np.float32)
    d_out = rng.randn(7, 3, 5).astype(np.float32)
    g_want = np.zeros((3, v_loc, 5), np.float32)
    for b in range(7):
        for f in range(3):
            for j in range(bag):
                if ok[b, f, j]:
                    want[b, f] += tables[f, lid[b, f, j]]
                    g_want[f, lid[b, f, j]] += d_out[b, f]
    got = ops.embedding_bag_local(torch.from_numpy(tables),
                                  torch.from_numpy(ids), row0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not bool(torch.isnan(got).any())
    g = ops.embedding_bag_local_bwd(torch.from_numpy(d_out),
                                    torch.from_numpy(ids), row0, v_loc,
                                    torch.float32)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-6, atol=1e-6)
    bf = ref.embedding_bag_local_bwd_ref(torch.from_numpy(d_out),
                                         torch.from_numpy(ids), row0, v_loc,
                                         dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.shape == (3, v_loc, 5)
