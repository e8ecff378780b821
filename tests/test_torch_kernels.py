"""repro_torch.kernels on the CPU: the plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, their autograd
gradients against jax.grad, the device dispatch of the ops, and the
build's contract. The CUDA kernels themselves run only on the card
(tests/test_torch_gpu.py; chip_smoke.py holds them against these plain
versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import embedding_bag as jeb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.embedding import multifeature_bag as j_multifeature_bag  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import dot_interact as di  # noqa: E402
from repro_torch.kernels import embedding_bag as eb  # noqa: E402
from repro_torch.kernels import sage_aggregate as sa  # noqa: E402
from repro_torch.models.embedding import embedding_bag as t_embedding_bag  # noqa: E402

BAG_CASES = [(64, 8, 4, 1), (512, 32, 16, 4), (1024, 128, 32, 8),
             (128, 10, 8, 3)]
DOT_CASES = [(64, 27, 16, 32), (32, 8, 8, 8), (48, 13, 32, 16)]
# the JAX package's sweep (tests/test_kernels.py), then a ragged case the
# TPU kernel's tiling does not take
SAGE_CASES = [(64, 15, 64, 128, 32), (128, 10, 602, 128, 64),
              (32, 25, 32, 16, 32), (37, 1, 5, 7, 37)]


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,bag", BAG_CASES)
def test_embedding_bag_plain_matches_pallas_and_ref(v, d, b, bag, combiner):
    """rtol 1e-6: the same f32 sum, j ascending, on both sides."""
    rng = np.random.RandomState(v + d)
    table = rng.randn(v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, bag)).astype(np.int32)
    got = t_embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          combiner=combiner).numpy()
    pallas = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                combiner=combiner, interpret=True)
    oracle = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                    combiner=combiner)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-6,
                               atol=1e-6)


# (F, V, D, B, bag): wide-deep's deep tables and wide arm (D = 1) at
# small widths, a ragged D, and the fused kernel's largest bag
FUSED_CASES = [(6, 256, 8, 16, 2), (6, 512, 1, 64, 4), (3, 300, 5, 37, 3),
               (2, 64, 4, 9, 16)]


def _jax_bags(fn, tables, ids, combiner, **kw):
    """A JAX per-table function over stacked tables: (B, F, D)."""
    return np.stack([np.asarray(fn(jnp.asarray(tables[f]),
                                   jnp.asarray(ids[:, f]),
                                   combiner=combiner, **kw))
                     for f in range(tables.shape[0])], axis=1)


def _check_fused(got, want, combiner):
    """Bit-equal for sum (the same left fold over j in f32 on both
    sides); within 1e-6 for mean, whose division XLA may compile as a
    multiplication by the reciprocal."""
    if combiner == "sum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("f,v,d,b,bag", FUSED_CASES)
def test_embedding_bag_fused_plain_matches_pallas_and_ref(f, v, d, b, bag,
                                                          combiner):
    """ops.embedding_bag_fused on the CPU (the plain version) against the
    JAX package's Pallas `embedding_bag` (interpret mode) and its oracle.
    (The reference's fused kernel itself does not run on the installed
    JAX: ROADMAP queue 3.)"""
    rng = np.random.RandomState(v + d + bag)
    tables = rng.randn(f, v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, f, bag)).astype(np.int32)
    got = ops.embedding_bag_fused(torch.from_numpy(tables),
                                  torch.from_numpy(ids),
                                  combiner=combiner).numpy()
    assert got.shape == (b, f, d) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, ref.embedding_bag_ref(torch.from_numpy(tables),
                                   torch.from_numpy(ids),
                                   combiner=combiner).numpy())
    _check_fused(got, _jax_bags(jops.embedding_bag, tables, ids, combiner,
                                interpret=True), combiner)
    _check_fused(got, _jax_bags(jref.embedding_bag_ref, tables, ids,
                                combiner), combiner)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("f,v,d,b,bag", [
    (2, 64, 4, 9, 17),                 # bag over 16
    (1, 65536, 33, 5, 2),              # one table of 8.65 MB, over 8 MiB
])
def test_embedding_bag_fused_matches_jax_fused_fallback(f, v, d, b, bag,
                                                        combiner):
    """Where the reference's `embedding_bag_fused` falls back to its row
    kernel (which runs on the installed JAX), the port's op equals it."""
    rng = np.random.RandomState(bag)
    tables = rng.randn(f, v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, f, bag)).astype(np.int32)
    t = torch.from_numpy(tables)
    assert not ops.fused_fires(t, bag)
    got = ops.embedding_bag_fused(t, torch.from_numpy(ids),
                                  combiner=combiner).numpy()
    _check_fused(got, _jax_bags(jops.embedding_bag_fused, tables, ids,
                                combiner, interpret=True), combiner)


def test_fused_fires_at_the_reference_limits():
    """Both sides of each limit of the reference's dispatch
    (repro/kernels/embedding_bag.py: _FUSED_MAX_TABLE_BYTES,
    _FUSED_MAX_BAG), for f32 tables."""
    limit, max_bag = jeb._FUSED_MAX_TABLE_BYTES, jeb._FUSED_MAX_BAG
    assert (ops.FUSED_MAX_TABLE_BYTES, ops.FUSED_MAX_BAG) == (limit, max_bag)
    rows_at_limit = limit // 4
    for v, d, bag in ((rows_at_limit, 1, 4), (rows_at_limit + 1, 1, 4),
                      (rows_at_limit // 32, 32, 4),
                      (rows_at_limit // 32 + 1, 32, 4),
                      (512, 8, max_bag), (512, 8, max_bag + 1),
                      (1 << 20, 1, 4), (1 << 20, 32, 4)):
        want = not (v * d * 4 > limit or bag > max_bag)
        tables = torch.empty((3, v, d), device="meta")
        assert ops.fused_fires(tables, bag) == want, (v, d, bag)
    # wide-deep at its published widths: the wide arm fires, the deep
    # tables do not
    assert ops.fused_fires(torch.empty((40, 1 << 20, 1), device="meta"), 4)
    assert not ops.fused_fires(torch.empty((40, 1 << 20, 32),
                                           device="meta"), 4)


def test_embedding_bag_fused_dispatches_like_the_reference(monkeypatch):
    """On a CUDA tensor the op launches the fused kernel where
    `fused_fires` and the row kernel otherwise (kernels replaced by spies
    here, the tensors on the CPU), and its backward is the scatter."""
    calls = []

    def spy(name):
        def fn(tables, ids, combiner, **kw):
            calls.append((name, tuple(tables.shape), combiner))
            return ref.embedding_bag_ref(tables, ids, combiner=combiner)
        return fn

    def bwd(d_out, ids, num_rows, combiner):
        calls.append(("bwd", num_rows, combiner))
        return ref.embedding_bag_bwd_ref(d_out, ids, num_rows,
                                         combiner=combiner)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(eb, "embedding_bag_fused_fwd",
                        spy("embedding_bag_fused_fwd"))
    monkeypatch.setattr(eb, "embedding_bag_fwd", spy("embedding_bag_fwd"))
    monkeypatch.setattr(eb, "embedding_bag_bwd", bwd)
    small = torch.zeros((2, 64, 4), requires_grad=True)
    ids = torch.zeros((3, 2, 4), dtype=torch.int32)
    ops.embedding_bag_fused(small, ids, combiner="mean").sum().backward()
    ops.embedding_bag_fused(small, torch.zeros((3, 2, 17),
                                               dtype=torch.int32))
    monkeypatch.setattr(ops, "FUSED_MAX_TABLE_BYTES", 64 * 4 * 4 - 1)
    ops.embedding_bag_fused(small, ids)
    assert calls == [("embedding_bag_fused_fwd", (2, 64, 4), "mean"),
                     ("bwd", 64, "mean"),
                     ("embedding_bag_fwd", (2, 64, 4), "sum"),
                     ("embedding_bag_fwd", (2, 64, 4), "sum")]


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_fused_grad_matches_jax(combiner):
    """The fused op's backward (the plain scatter on the CPU) against
    jax.grad of the oracle, at the wide arm's D = 1 and at D = 8,
    duplicate ids included."""
    rng = np.random.RandomState(3)
    for d in (1, 8):
        tables = rng.randn(3, 20, d).astype(np.float32)
        ids = rng.randint(0, 20, (16, 3, 4)).astype(np.int32)
        w = rng.randn(16, 3, d).astype(np.float32)

        def j_loss(t):
            out = jnp.stack([jref.embedding_bag_ref(t[f], ids[:, f],
                                                    combiner=combiner)
                             for f in range(3)], axis=1)
            return jnp.sum(out * w)

        want = jax.grad(j_loss)(jnp.asarray(tables))
        t = torch.from_numpy(tables).requires_grad_(True)
        (ops.embedding_bag_fused(t, torch.from_numpy(ids), combiner=combiner)
         * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_multifeature_bag_matches_jax_model():
    rng = np.random.RandomState(0)
    tables = rng.randn(5, 64, 16).astype(np.float32)
    ids = rng.randint(0, 64, (9, 5, 4)).astype(np.int32)
    got = ops.embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids))
    want = j_multifeature_bag(jnp.asarray(tables), jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("b,f,d,tile", DOT_CASES)
def test_dot_interact_plain_matches_pallas_and_ref(b, f, d, tile):
    """rtol 1e-6 with atol 1e-5: the dots are the same f32 products
    summed in another order, so entries near 0 are held absolutely."""
    rng = np.random.RandomState(b + f)
    feats = rng.randn(b, f, d).astype(np.float32)
    got = ops.dot_interact(torch.from_numpy(feats)).numpy()
    pallas = jops.dot_interact(jnp.asarray(feats), tile_b=tile,
                               interpret=True)
    oracle = jref.dot_interact_ref(jnp.asarray(feats))
    assert got.shape == (b, f * (f - 1) // 2)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_grad_matches_jax(combiner):
    """The autograd.Function's backward (plain scatter-add on the CPU)
    against jax.grad of the oracle, duplicate ids included."""
    rng = np.random.RandomState(1)
    tables = rng.randn(3, 20, 8).astype(np.float32)
    ids = rng.randint(0, 20, (16, 3, 4)).astype(np.int32)
    w = rng.randn(16, 3, 8).astype(np.float32)

    def j_loss(t):
        out = jnp.stack([jref.embedding_bag_ref(t[f], ids[:, f],
                                                combiner=combiner)
                         for f in range(3)], axis=1)
        return jnp.sum(out * w)

    want = jax.grad(j_loss)(jnp.asarray(tables))
    t = torch.from_numpy(tables).requires_grad_(True)
    (ops.embedding_bag(t, torch.from_numpy(ids), combiner=combiner)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_dot_interact_grad_matches_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(6, 7, 16).astype(np.float32)
    w = rng.randn(6, 21).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jref.dot_interact_ref(x) * w))(
        jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_(True)
    (ops.dot_interact(x) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,f,d,h,tile", SAGE_CASES)
def test_sage_aggregate_plain_matches_pallas_and_ref(b, f, d, h, tile):
    """rtol 1e-5 / atol 1e-5 in f32, the JAX package's own tolerance: the
    same f32 mean over F, then an f32 product summed in another order."""
    rng = np.random.RandomState(b)
    neigh = rng.randn(b, f, d).astype(np.float32)
    w = (rng.randn(d, h) * d ** -0.5).astype(np.float32)
    tn, tw = torch.from_numpy(neigh), torch.from_numpy(w)
    got = ops.sage_aggregate(tn, tw).numpy()
    plain = ref.sage_aggregate_ref(tn, tw).numpy()
    pallas = jops.sage_aggregate(jnp.asarray(neigh), jnp.asarray(w),
                                 tile_b=tile, interpret=True)
    oracle = jref.sage_aggregate_ref(jnp.asarray(neigh), jnp.asarray(w))
    assert got.shape == (b, h) and got.dtype == np.float32
    np.testing.assert_array_equal(got, plain)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b,f,d,h", [(16, 5, 12, 7), (37, 1, 5, 7),
                                     (8, 10, 602, 128)])
def test_sage_aggregate_grads_match_jax(b, f, d, h):
    """d_neigh and d_w of the autograd.Function (plain versions on the
    CPU) against jax.grad of the oracle."""
    rng = np.random.RandomState(d)
    neigh = rng.randn(b, f, d).astype(np.float32)
    w = (rng.randn(d, h) * d ** -0.5).astype(np.float32)
    cot = rng.randn(b, h).astype(np.float32)
    want_n, want_w = jax.grad(
        lambda n, w_: jnp.sum(jref.sage_aggregate_ref(n, w_) * cot),
        argnums=(0, 1))(jnp.asarray(neigh), jnp.asarray(w))
    x = torch.from_numpy(neigh).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (ops.sage_aggregate(x, tw) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_n),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)


def test_sage_aggregate_writes_d_neigh_only_when_needed(monkeypatch):
    """The backward asks for d_neigh only when neigh needs a gradient,
    and keeps the aggregate (for d_w) only when w does."""
    calls = []
    plain = ref.sage_aggregate_bwd_ref

    def spy(d_out, w, agg, f, *, need_neigh):
        calls.append((need_neigh, agg is not None))
        return plain(d_out, w, agg, f, need_neigh=need_neigh)
    monkeypatch.setattr(ref, "sage_aggregate_bwd_ref", spy)
    w = torch.randn(5, 2, requires_grad=True)
    ops.sage_aggregate(torch.randn(4, 3, 5), w).sum().backward()
    x = torch.randn(4, 3, 5, requires_grad=True)
    ops.sage_aggregate(x, w.detach()).sum().backward()
    assert calls == [(False, True), (True, False)]
    assert x.grad.shape == (4, 3, 5)


# the GNN train step's three calls (B, F, D, H): neigh2, neigh1, h1
SAGE_PATH = [(15360, 10, 602, 128), (1024, 15, 602, 128),
             (1024, 15, 128, 47)]
# ragged ones: tiles of 8 and 32 rows, two column tiles, B not a multiple
# of 4, F D = 2 mod 4, many neighbours (F 44; the sampler's default fanout
# 25), no rows, the widest features
SAGE_RAGGED = [(37, 1, 5, 7), (37, 3, 33, 130), (4225, 2, 33, 7),
               (1023, 15, 602, 128), (5, 43, 6, 47), (600, 10, 300, 130),
               (300, 44, 602, 128), (1024, 25, 602, 128), (0, 3, 4, 5),
               (2, 10, 4481, 5)]
# clusters of each size that fit at one d_w CTA an SM, as the occupancy
# query reports them on an NVIDIA H100 80GB HBM3 (chip_smoke.py prints it)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def test_sage_dw_splits_cover_the_card():
    # main path: d_w (602, 128) is 5 x 1 tiles of 128; clusters of 2
    # ranges, 13 a tile: 130 CTAs of 591 rows, one wave at one CTA an SM
    # (clusters of 8 would place 15 x 8 = 120); the 13 clusters' sums meet
    # in a (13, 602, 128) scratch, 4.0 MB instead of 52 partials' 16 MB
    plan = sa.dw_plan(15360, 602, 128, H100_CLUSTERS.get)
    assert (plan.cluster, plan.clusters, plan.splits) == (2, 13, 26)
    assert sa.dw_plan(1024, 602, 128, H100_CLUSTERS.get).splits == 26
    assert sa.dw_plan(1024, 128, 47, H100_CLUSTERS.get) == sa.DwPlan(8, 4)
    assert sa.dw_plan(37, 5, 7) == sa.DwPlan(2, 1)
    assert sa.dw_plan(0, 5, 7) == sa.DwPlan(1, 1)


@pytest.mark.parametrize("b,f,d,h", SAGE_PATH + SAGE_RAGGED)
def test_sage_dw_plan_fits_the_card(b, f, d, h):
    """Clusters of 1-8 CTAs (a power of 2), no more at once than fit the
    card unless the tiles alone are more, and at most one range of rows
    for each 32 rows of B."""
    plan = sa.dw_plan(b, d, h, H100_CLUSTERS.get)
    tiles = -(-d // 128) * -(-h // 128)
    assert plan.cluster in (1, 2, 4, 8) and plan.clusters >= 1
    assert tiles * plan.clusters <= max(H100_CLUSTERS[plan.cluster], tiles)
    assert plan.splits <= max(1, -(-b // 32))


@pytest.mark.parametrize("ptr", [0, 8, 4])
@pytest.mark.parametrize("b,f,d,h", SAGE_PATH + SAGE_RAGGED)
def test_sage_fwd_plan_aligns_every_load_and_fills_the_card(b, f, d, h, ptr):
    """Every load of `vec` floats of neigh, at every (row, f) and value of
    d a vector starts at, is aligned to its width; the CTAs' row ranges
    cover B once and differ by at most one row; the 1024-row calls give
    every SM a CTA; two buffers of the aggregate where they fit with a
    ring of at least 3 slices of w; shared memory fits."""
    plan = sa.fwd_plan(b, f, d, h, ptr)
    assert plan.vec in (1, 2, 4) and plan.rows in (8, 32)
    width = 4 * plan.vec
    for row in range(min(b, 9)):
        for ff in range(f):
            for j in range(0, d, plan.vec):
                assert (ptr + 4 * ((row * f + ff) * d + j)) % width == 0
    # each CTA's rows [begin, end), as the kernel splits B
    ranges = [(b * c // plan.ctas, b * (c + 1) // plan.ctas)
              for c in range(plan.ctas)]
    assert ranges[0][0] == 0 and ranges[-1][1] == b
    assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
    sizes = {e - s for s, e in ranges}
    assert max(sizes) - min(sizes) <= 1
    assert plan.ctas * plan.col_tiles <= sa.SMS or b == 0
    if b == 1024:
        assert plan.ctas >= 132
    assert plan.rows == 8 or b >= 32 * plan.ctas
    assert plan.bufs in (1, 2) and 2 <= plan.stages <= 8
    assert plan.bufs == 2 or d > 2000
    assert sa.fwd_smem(plan.rows, plan.bufs, d, h, plan.stages) <= sa.SMEM


def test_sage_fwd_plan_at_the_path_shapes():
    # neigh2: 32-row tiles in two buffers over 132 ranges of 116-117 rows,
    # a ring of 4 slices of w, 8-byte loads (602 floats a row); neigh1:
    # 8-row tiles, 8 slices; h1: 8-row tiles, 16-byte loads
    assert sa.fwd_plan(15360, 10, 602, 128) == sa.FwdPlan(32, 2, 132, 1, 4, 2)
    assert sa.fwd_plan(1024, 15, 602, 128) == sa.FwdPlan(8, 2, 132, 1, 8, 2)
    assert sa.fwd_plan(1024, 15, 128, 47) == sa.FwdPlan(8, 2, 132, 1, 8, 4)
    # a base 8- but not 16-byte aligned loads 8 bytes at a time
    assert sa.fwd_plan(1024, 15, 128, 47, ptr=8).vec == 2
    assert sa.agg_stride(602) == 604 and sa.agg_stride(128) == 128
    assert sa.agg_stride(5) == 8


def test_sage_aggregate_fwd_refuses_too_wide_features(monkeypatch):
    """A CTA keeps an 8-row tile of the aggregate and at least 2 slices of
    w in shared memory: wider features are refused before anything is
    built or launched. D = 4480 still fits, in one buffer."""
    monkeypatch.setattr(sa, "_check", lambda *a: None)   # device, dtype
    with pytest.raises(ValueError, match="D = 7000, F = 10 do not"):
        sa.sage_aggregate_fwd(torch.zeros(2, 10, 7000), torch.zeros(7000, 5))
    assert sa.fwd_plan(2, 10, 4480, 5).bufs == 1


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ops.launch_counts()
    ops.dot_interact(torch.zeros(2, 3, 4))
    ops.embedding_bag(torch.zeros(2, 5, 4), torch.zeros(3, 2, 1,
                                                        dtype=torch.int32))
    t = torch.zeros(2, 5, 1, requires_grad=True)
    ops.embedding_bag_fused(t, torch.zeros(3, 2, 4, dtype=torch.int32)) \
        .sum().backward()
    w = torch.zeros(4, 2, requires_grad=True)
    ops.sage_aggregate(torch.zeros(2, 3, 4), w).sum().backward()
    assert ops.launch_counts() == before
    assert set(before) == {"embedding_bag_fwd", "embedding_bag_bwd",
                           "embedding_bag_fused_fwd",
                           "dot_interact_fwd", "dot_interact_bwd",
                           "sage_aggregate_fwd", "sage_aggregate_bwd"}


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.dot_interact(torch.empty(2, 3, 4, device="meta"))


@pytest.mark.parametrize("call", [
    lambda: eb.embedding_bag_fwd(torch.zeros(2, 5, 4),
                                 torch.zeros(3, 2, 1, dtype=torch.int32)),
    lambda: eb.embedding_bag_fused_fwd(torch.zeros(2, 5, 1),
                                       torch.zeros(3, 2, 4,
                                                   dtype=torch.int32)),
    lambda: eb.embedding_bag_scatter(torch.zeros(3, 2, 4),
                                     torch.zeros(3, 2, 1, dtype=torch.int32),
                                     torch.zeros(2, 5, 4)),
    lambda: di.dot_interact_fwd(torch.zeros(2, 3, 4)),
    lambda: di.dot_interact_bwd(torch.zeros(2, 3), torch.zeros(2, 3, 4)),
    lambda: sa.sage_aggregate_fwd(torch.zeros(2, 3, 4), torch.zeros(4, 5)),
    lambda: sa.sage_aggregate_bwd(torch.zeros(2, 5), torch.zeros(4, 5),
                                  torch.zeros(2, 4), 3, True),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A CUDA wrapper checks its inputs before it builds or launches
    anything: a CPU tensor is an error there, never a silent CPU run."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


def test_embedding_bag_fused_fwd_refuses_bags_over_16(monkeypatch):
    monkeypatch.setattr(eb, "_check", lambda *a: None)   # device, dtype
    with pytest.raises(ValueError, match="at most 16 ids"):
        eb.embedding_bag_fused_fwd(torch.zeros(2, 5, 1),
                                   torch.zeros(3, 2, 17, dtype=torch.int32))


def test_build_targets_sm90a_and_fails_loudly_without_nvcc(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.SOURCES)
    assert set(build.SIGNATURES) == set(build.SOURCES)
    path = build.library_path("embedding_bag")
    assert path.parent == build.build_dir()
    assert path.name.startswith("libembedding_bag-")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
