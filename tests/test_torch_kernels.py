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

    def bwd(d_out, ids, num_rows, combiner, dtype):
        calls.append(("bwd", num_rows, combiner))
        return ref.embedding_bag_bwd_ref(d_out, ids, num_rows,
                                         combiner=combiner, dtype=dtype)
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


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("bag", [1, 3])
@pytest.mark.parametrize("d", [10, 18])
def test_embedding_bag_narrow_rows_match_jax(d, bag, combiner):
    """xDeepFM's D = 10 and DIEN's 18 (the rows the kernels walk flat,
    in 8-byte words), bags of 1 and 3 with a repeated id: the port's
    `ops.embedding_bag` against the reference's Pallas kernel in interpret
    mode (rtol 1e-6: the same f32 sum, j ascending) and its gradient
    against jax.grad of the reference's oracle (rtol 1e-6, atol 1e-6)."""
    rng = np.random.RandomState(d + bag)
    f, v, b = 3, 50, 24
    tables = rng.randn(f, v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, f, bag)).astype(np.int32)
    ids[0, :, -1] = ids[0, :, 0]
    w = rng.randn(b, f, d).astype(np.float32)
    t = torch.from_numpy(tables).requires_grad_(True)
    got = ops.embedding_bag(t, torch.from_numpy(ids), combiner=combiner)
    np.testing.assert_allclose(
        got.detach().numpy(), _jax_bags(jops.embedding_bag, tables, ids,
                                        combiner, interpret=True),
        rtol=1e-6, atol=0)
    (got * torch.from_numpy(w)).sum().backward()

    def j_loss(x):
        out = jnp.stack([jref.embedding_bag_ref(x[i], ids[:, i],
                                                combiner=combiner)
                         for i in range(f)], axis=1)
        return jnp.sum(out * w)

    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(jax.grad(j_loss)(
                                   jnp.asarray(tables))),
                               rtol=1e-6, atol=1e-6)


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


# the sage shapes chip_smoke.py holds the kernels at: the path, the ragged
# ones above, and neigh slices whose base is 8 or 4 bytes off 16
SAGE_CHIP = SAGE_PATH + SAGE_RAGGED + [(300, 15, 128, 47),
                                       (300, 10, 602, 128),
                                       (5000, 10, 602, 128)]


@pytest.mark.parametrize("b,f,d,h", SAGE_CHIP)
def test_sage_dneigh_plan_takes_every_chip_shape(b, f, d, h):
    """No shape is refused; 8-row tiles exactly where they put at least
    two CTAs on every SM, else 4-row ones; shared memory fits a CTA of
    either tile."""
    plan = sa.dneigh_plan(b, f, d, h)
    assert plan.rr in (1, 2) and plan.rows == 4 * plan.rr
    assert plan.ctas(b, d) * plan.rows * 32 >= b * d
    assert (plan.rows == 8) == (sa.DneighPlan(2).ctas(b, d) >= 2 * sa.SMS)
    for rr in (1, 2):
        assert sa.dn_smem(sa.DneighPlan(rr).rows, h) <= sa.SMEM


def test_sage_dneigh_plan_at_the_path_shapes():
    # h1, the one call that writes d_neigh, (1024, 15, 128): 8 x 32 tiles,
    # 512 CTAs, at least two on each of the 132 SMs
    plan = sa.dneigh_plan(1024, 15, 128, 47)
    assert plan == sa.DneighPlan(2) and plan.rows == 8
    assert plan.ctas(1024, 128) == 512 >= 2 * sa.SMS
    # its shared memory: the runs of w's 32 rows and d_out's 8 rows of 47
    # floats as they are copied in (up to 3 floats before each, rounded
    # up to 16 bytes)
    assert sa.dn_smem(8, 47) == 4 * (1508 + 380)
    # fewer rows: 4-row tiles; H even or above 128 is staged row by row,
    # the rows of a chunk padded to 4 mod 8 floats
    assert sa.dneigh_plan(300, 15, 128, 47) == sa.DneighPlan(1)
    assert sa.dn_smem(4, 130) == 4 * 36 * 132
    assert sa.dn_smem(4, 48) == 4 * 36 * 52
    with pytest.raises(ValueError):
        sa.dneigh_plan(4, 0, 5, 7)


# (b, f, v, d): the wide-deep arms and the DLRM at small batches, every D
# the card tests take, F not a multiple of the group, a feature group
# holding every feature, B = 1; the even widths that are not multiples of
# 4 (8-byte words): D = 6, xDeepFM's 10, DIEN's 18 and 34
EB_BWD_CASES = [(33, 40, 2 ** 20, 1), (5, 6, 2 ** 20, 32),
                (7, 26, 2 ** 16, 128), (37, 3, 1000, 10), (1, 7, 5, 132),
                (4, 7, 2 ** 20, 1), (16, 9, 2 ** 18, 1), (9, 5, 300, 2),
                (9, 5, 300, 3), (9, 5, 300, 5), (9, 5, 300, 8),
                (9, 5, 300, 6), (33, 3, 2 ** 16, 18), (5, 4, 700, 34)]


def _quotient(n, div: "eb.Div", d: int):
    """csrc/embedding_bag.cu's `quotient`, vectorized: (n * magic) >>
    shift in 64 bits, or n // d where the plan's magic is 0."""
    n = np.asarray(n, dtype=np.int64)
    if div.magic == 0:
        return n // d
    assert (n < 2 ** 31).all()
    return ((n.astype(np.uint64) * np.uint64(div.magic))
            >> np.uint64(div.shift)).astype(np.int64)


def _walk_words(plan, threads: int, rows: int, words: int,
                per_thread: int = 1):
    """(row, word) of each thread's words, as csrc/embedding_bag.cu walks
    the (rows, words) words with `threads` threads: the lane walk (thread
    t is lane t % lanes of row t // lanes, its words lane, lane + lanes,
    ...) or the flat walk (lanes 0: thread t takes the words t + k
    threads, k < per_thread)."""
    t = np.arange(threads, dtype=np.int64)
    if plan.lanes == 0:
        t = (t[None, :] + threads * np.arange(per_thread)[:, None]).ravel()
        row = _quotient(t, plan.per_row, words)
        live = row < rows
        return row[live], (t - row * words)[live]
    row, lane = t >> plan.lanes_log2, t & (plan.lanes - 1)
    live = row < rows
    row, lane = row[live], lane[live]
    rs, cs = [], []
    for k in range(-(-words // plan.lanes)):
        c = lane + k * plan.lanes
        rs.append(row[c < words])
        cs.append(c[c < words])
    return np.concatenate(rs), np.concatenate(cs)


def _check_walk(plan, words: int):
    """A plan's walk: the flat walk (lanes 0), with the divisor of a
    row's words for the plan's grid; or the lane walk, lanes the least
    power of two covering a row's words (or 32)."""
    if plan.lanes == 0:
        threads = plan.blocks * (eb.BWD_THREADS
                                 if isinstance(plan, eb.BwdPlan)
                                 else eb.FWD_THREADS * eb.FLAT_WORDS)
        assert plan.per_row == eb.divisor(words, threads)
    else:
        assert plan.lanes in (1, 2, 4, 8, 16, 32)
        assert plan.lanes >= words or plan.lanes == 32
        assert plan.lanes == 1 or plan.lanes < 2 * words
        assert plan.per_row == eb.NO_DIV


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,f,v,d", EB_BWD_CASES)
def test_embedding_bag_bwd_plan_covers_every_row_once(b, f, v, d, aligned):
    """The scatter's index map, simulated as csrc/embedding_bag.cu walks
    it, with d_out and grad 16-byte aligned or (not `aligned`) 8- and
    4-byte aligned: every (b, f, word) of d_out is taken by exactly one
    thread; float4 atomics only where D % 4 == 0 and 16-byte aligned,
    float2 ones only where D is even and 8-byte aligned, else one column;
    the flat walk (a thread a word, its row by the plan's divisor) for
    float2s and columns in rows of more than one word, the lane walk for
    the rest; a feature
    group's gradient slices fit the L2 budget unless the group is 1."""
    for ptr in ((0,) if aligned else (8, 4)):
        plan = eb.bwd_plan(b, f, v, d, ptr)
        assert plan.vec == (4 if d % 4 == 0 and ptr % 16 == 0 else
                            2 if d % 2 == 0 and ptr % 8 == 0 else 1)
        words = d // plan.vec
        assert (plan.lanes == 0) == (plan.vec < 4)
        _check_walk(plan, words)
        assert 1 <= plan.group <= f
        assert plan.group == 1 or plan.group * v * d * 4 <= eb.BWD_L2_BYTES
        assert plan.group == f or \
            (plan.group + 1) * v * d * 4 > eb.BWD_L2_BYTES
        seen = np.zeros((b, f, words), dtype=np.int64)
        assert plan.groups == -(-f // plan.group)
        for gy in range(plan.groups):
            f0 = gy * plan.group
            size = min(plan.group, f - f0)
            slot, c = _walk_words(plan, plan.blocks * eb.BWD_THREADS,
                                  b * size, words)
            np.add.at(seen, (slot // size, f0 + slot % size, c), 1)
        assert (seen == 1).all()


def test_embedding_bag_bwd_plan_at_the_path_shapes():
    # wide-deep's wide arm: the flat walk of a thread a row, groups of 2
    # features (8 MiB of its 4 MiB slices), 20 groups of 512 blocks; its
    # deep tables: 8 lanes (4 rows a warp), one feature a group (128 MiB
    # a slice); the DLRM's D = 128: a warp a row
    assert eb.bwd_plan(65536, 40, 2 ** 20, 1) == eb.BwdPlan(
        1, 0, 2, 20, 512, eb.Div(2 ** 31, 31))
    assert eb.bwd_plan(65536, 40, 2 ** 20, 32) == eb.BwdPlan(4, 8, 1, 40,
                                                             2048)
    assert eb.bwd_plan(2048, 26, 2 ** 20, 128) == eb.BwdPlan(4, 32, 1, 26,
                                                             256)
    # 4-byte aligned: scalar atomics on the flat walk, a thread a column
    unaligned = eb.bwd_plan(2048, 26, 2 ** 20, 128, 4)
    assert (unaligned.vec, unaligned.lanes, unaligned.blocks) == (1, 0, 1024)


def test_embedding_bag_narrow_plans_at_the_xdeepfm_and_dien_shapes():
    """The two narrow-row lookups of the sequence models at a driver
    microbatch, f32 and aligned: 8-byte words on the flat walk, 5 a row
    at xDeepFM's D = 10 and 9 at DIEN's 18, with 32-bit divisors (the
    walks are far below 2^31 threads); xDeepFM's linear arm (D = 1) a
    thread a row, in feature groups of 2."""
    # xDeepFM's tables, ids (32768, 39, 1) into (39, 2^20, 10)
    assert eb.fwd_plan(32768, 39, 10) == eb.FwdPlan(
        2, 0, 24960, eb.Div(3435973837, 34), eb.Div(3524075731, 37))
    assert eb.bwd_plan(32768, 39, 2 ** 20, 10) == eb.BwdPlan(
        2, 0, 1, 39, 640, eb.Div(3435973837, 34))
    # DIEN's history, ids (6553600, 1, 1) into (1, 2^20, 18)
    assert eb.fwd_plan(6553600, 1, 18) == eb.FwdPlan(
        2, 0, 230400, eb.Div(3817748708, 35), eb.Div(2 ** 31, 31))
    assert eb.bwd_plan(6553600, 1, 2 ** 20, 18) == eb.BwdPlan(
        2, 0, 1, 1, 230400, eb.Div(3817748708, 35))
    # xDeepFM's linear arm through the scatter
    assert eb.bwd_plan(32768, 39, 2 ** 20, 1) == eb.BwdPlan(
        1, 0, 2, 20, 256, eb.Div(2 ** 31, 31))
    # the same tables 4-byte aligned: 4-byte words, still flat
    fwd = eb.fwd_plan(32768, 39, 10, 4, 4)
    assert (fwd.vec, fwd.lanes, fwd.blocks) == (1, 0, 49920)
    bwd = eb.bwd_plan(6553600, 1, 2 ** 20, 18, 4)
    assert (bwd.vec, bwd.lanes, bwd.blocks) == (1, 0, 460800)


# d: every row width up to 40 and around powers of two; the divisors of
# the path's rows (5, 9 words; 39 features); the largest a row can have
_DIVISORS = list(range(1, 41)) + [63, 64, 65, 127, 128, 129, 1000, 4097,
                                  65535, 2 ** 20 + 1, 2 ** 31 - 1]


@pytest.mark.parametrize("d", _DIVISORS)
def test_flat_walk_divisor_is_exact_below_2_31(d):
    """`divisor(d, threads)`: for a walk of at most 2^31 threads, magic <
    2^32 and shift = 31 + ceil(log2 d) with (2^31 - 1) (magic d -
    2^shift) < 2^shift, which makes (n magic) >> shift == n // d for every
    0 <= n < 2^31 (the error n (magic d - 2^shift) / (d 2^shift) stays
    under 1 / d); checked against // at both ends of that range, around
    multiples of d across it and at random points. Above 2^31 threads the
    64-bit division takes over (NO_DIV)."""
    div = eb.divisor(d, 2 ** 31)
    assert 0 < div.magic < 2 ** 32 and div.shift == 31 + (d - 1).bit_length()
    eps = div.magic * d - 2 ** div.shift
    assert 0 <= eps and (2 ** 31 - 1) * eps < 2 ** div.shift
    rng = np.random.RandomState(d % 2 ** 31)
    k = np.concatenate([np.arange(1, 2 ** 12),
                        rng.randint(1, max(2, 2 ** 31 // d), 2 ** 14),
                        (2 ** 31 - 1) // d - np.arange(min(2 ** 12,
                                                           2 ** 31 // d))])
    n = np.concatenate([np.arange(2 ** 16), 2 ** 31 - 1 - np.arange(2 ** 16),
                        rng.randint(0, 2 ** 31, 2 ** 16),
                        (k * d)[k * d < 2 ** 31],
                        (k * d - 1)[(k * d - 1 < 2 ** 31) & (k * d >= 1)]])
    np.testing.assert_array_equal(_quotient(n, div, d), n // d)
    assert eb.divisor(d, 2 ** 31 + 1) == eb.NO_DIV
    assert eb.divisor(d, 2 ** 31) == div


def test_flat_walk_takes_64_bit_indices_above_2_31_threads():
    """A walk of more than 2^31 threads (2^28 bags at D = 18, 2.4e9
    words) gets no 32-bit divisor: the kernel divides in 64 bits; one
    just under keeps it."""
    big = eb.fwd_plan(2 ** 28, 1, 18)
    assert big.lanes == 0 and \
        big.blocks * eb.FWD_THREADS * eb.FLAT_WORDS > 2 ** 31
    assert big.per_row == eb.NO_DIV and big.per_feat == eb.NO_DIV
    assert eb.bwd_plan(2 ** 28, 1, 2 ** 20, 18).per_row == eb.NO_DIV
    rows = 2 ** 31 // 9 // eb.FWD_THREADS * eb.FWD_THREADS
    small = eb.fwd_plan(rows, 1, 18)
    assert small.blocks * eb.FWD_THREADS * eb.FLAT_WORDS <= 2 ** 31
    assert small.per_row == eb.divisor(9, 2 ** 31)


# (b, f, d, ptr): the DLRM shape and the card tests' (F, D) pairs, at B 1,
# 37 and 2048 + 3, 16- and 4-byte aligned
DOT_BWD_CASES = [(2048, 27, 128, 0), (2051, 27, 128, 4), (1, 2, 4, 0),
                 (37, 27, 10, 0), (2051, 60, 32, 0), (37, 60, 32, 4),
                 (1, 27, 128, 0), (300, 110, 1, 0), (5, 64, 128, 0)]


@pytest.mark.parametrize("b,f,d,ptr", DOT_BWD_CASES)
def test_dot_interact_bwd_plan_walks_every_sample_once(b, f, d, ptr):
    """The persistent CTAs' walk (CTA c takes samples c, c + ctas, ...)
    covers every sample once; the grid covers the SMs without exceeding
    B; every row of F has a warp (7 rows each, at most 640 threads); the
    CTAs an SM fit its threads and shared memory; 16-byte copies only
    where D % 4 == 0 and the pointer is aligned."""
    plan = di.bwd_plan(b, f, d, ptr)
    walked = sorted(s for c in range(plan.ctas)
                    for s in range(c, b, plan.ctas))
    assert walked == list(range(b))
    assert plan.ctas <= b and plan.ctas >= min(b, di.SMS)
    assert plan.warps * di.BWD_ROWS >= f > (plan.warps - 1) * di.BWD_ROWS
    assert 32 * plan.warps <= 640
    assert plan.smem == di.bwd_smem(f, d, plan.warps) <= di.SMEM
    per_sm = -(-plan.ctas // di.SMS)
    assert per_sm * (plan.smem + 1024) <= di.SM_SHARED_BYTES
    assert per_sm * 32 * plan.warps <= di.SM_THREADS
    assert plan.vec == (4 if d % 4 == 0 and ptr % 16 == 0 else 1)


def test_dot_interact_bwd_plan_takes_every_tile_the_wrapper_takes():
    """Every (F <= 128, D) that passes the wrapper's tile check has a plan
    whose shared memory fits a block (opted in above 48 KB); at the DLRM
    shape: 4 warps, 4 CTAs an SM, 33,920 bytes."""
    for f in range(1, 129):
        for d in range(1, 4097):
            try:
                di._check_tile(f, d, extra=f * f)
            except ValueError:
                break
            plan = di.bwd_plan(2048, f, d)
            assert plan.smem <= di.SMEM, (f, d)
    assert di.bwd_plan(2048, 27, 128) == di.BwdPlan(4, 4, 528, 33920)


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
    ids = torch.zeros(3, 2, 1, dtype=torch.int32)
    ops.embedding_bag_local(torch.zeros(2, 5, 4), ids, 5)
    ops.embedding_bag_local_bwd(torch.zeros(3, 2, 4), ids, 5, 5,
                                torch.float32)
    ops.local_take(torch.zeros(5, 4), ids.view(-1), 5)
    ops.local_take_bwd(torch.zeros(6, 4), ids.view(-1), 5, 5)
    assert ops.launch_counts() == before
    assert set(before) == {"embedding_bag_fwd", "embedding_bag_bwd",
                           "embedding_bag_fused_fwd",
                           "embedding_bag_fwd_local",
                           "embedding_bag_bwd_local",
                           "embedding_take_fwd_local",
                           "embedding_take_bwd_local",
                           "dot_interact_fwd", "dot_interact_bwd",
                           "sage_aggregate_fwd", "sage_aggregate_bwd",
                           "sage_widen_w"}


class _Elsewhere(torch.Tensor):
    """A CPU tensor that says it lies on a device with no route."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_raise():
    """A device that is neither CPU, CUDA nor meta (the dry run's, which
    takes the CUDA wrappers up to the launch) raises."""
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.dot_interact(torch.empty(2, 3, 4).as_subclass(_Elsewhere))
    assert ops.dot_interact(torch.empty(2, 3, 4, device="meta")).shape == \
        (2, 3)


@pytest.mark.parametrize("call", [
    lambda: eb.embedding_bag_fwd(torch.zeros(2, 5, 4),
                                 torch.zeros(3, 2, 1, dtype=torch.int32)),
    lambda: eb.embedding_bag_fused_fwd(torch.zeros(2, 5, 1),
                                       torch.zeros(3, 2, 4,
                                                   dtype=torch.int32)),
    lambda: eb.embedding_bag_scatter(torch.zeros(3, 2, 4),
                                     torch.zeros(3, 2, 1, dtype=torch.int32),
                                     torch.zeros(2, 5, 4)),
    lambda: eb.embedding_take_fwd_local(torch.zeros(5, 4),
                                        torch.zeros(3, dtype=torch.int32),
                                        0),
    lambda: eb.embedding_take_bwd_local(torch.zeros(3, 4),
                                        torch.zeros(3, dtype=torch.int32),
                                        0, 5),
    lambda: di.dot_interact_fwd(torch.zeros(2, 3, 4)),
    lambda: di.dot_interact_bwd(torch.zeros(2, 3), torch.zeros(2, 3, 4)),
    lambda: sa.sage_aggregate_fwd(torch.zeros(2, 3, 4), torch.zeros(4, 5)),
    lambda: sa.widen_w(torch.zeros(4, 5, dtype=torch.bfloat16)),
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


# ---- bf16 inputs, as the TPU kernels take them ------------------------

BF16 = torch.bfloat16
# a bf16 output against the reference's: within 2 bf16 ulps of the f32
# sums rounded on both sides (rtol 2^-7), and the f32 tests' atol for
# sums that cancel
BF16_RTOL = 2.0 ** -7


def _bf16(a: np.ndarray):
    """(the bf16 torch tensor, the same values as a bf16 jax array)."""
    t = torch.from_numpy(a).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("f,v,d,b,bag", FUSED_CASES + [(2, 64, 4, 9, 17)])
def test_embedding_bags_take_bf16_tables_as_the_reference(f, v, d, b, bag,
                                                          combiner):
    """ops.embedding_bag and ops.embedding_bag_fused with bf16 tables: f32
    out, bitwise the plain version, bitwise the JAX package's Pallas
    `embedding_bag` (interpret mode, bf16 table, f32 sums j ascending) for
    sum and within 1e-6 for mean (XLA may multiply by the reciprocal).
    (The reference's fused kernel does not run on the installed JAX:
    ROADMAP queue 3.)"""
    rng = np.random.RandomState(v + d + bag + 1)
    tables, jtables = _bf16(rng.randn(f, v, d).astype(np.float32))
    ids = rng.randint(0, v, (b, f, bag)).astype(np.int32)
    tids = torch.from_numpy(ids)
    plain = ref.embedding_bag_ref(tables, tids, combiner=combiner)
    want = np.stack([np.asarray(jops.embedding_bag(
        jtables[i], jnp.asarray(ids[:, i]), combiner=combiner,
        interpret=True)) for i in range(f)], axis=1)
    for op in (ops.embedding_bag, ops.embedding_bag_fused):
        got = op(tables, tids, combiner=combiner)
        assert got.dtype == torch.float32 and got.shape == (b, f, d)
        assert torch.equal(got, plain)
        _check_fused(got.numpy(), want, combiner)


@pytest.mark.parametrize("b,f,d,tile", DOT_CASES)
def test_dot_interact_takes_bf16_as_the_reference(b, f, d, tile):
    """ops.dot_interact with bf16 feats: bf16 out (the f32 dots rounded),
    against the JAX package's Pallas kernel (interpret mode) and oracle on
    the same bf16 values, within 2 bf16 ulps."""
    rng = np.random.RandomState(b + f + 1)
    feats, jfeats = _bf16(rng.randn(b, f, d).astype(np.float32))
    got = ops.dot_interact(feats)
    assert got.dtype == BF16 and got.shape == (b, f * (f - 1) // 2)
    assert torch.equal(got, ref.dot_interact_ref(feats))
    for want in (jops.dot_interact(jfeats, tile_b=tile, interpret=True),
                 jref.dot_interact_ref(jfeats)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_RTOL,
                                   atol=1e-5)


@pytest.mark.parametrize("dtypes", ["bb", "bf", "fb"])
@pytest.mark.parametrize("b,f,d,h,tile", SAGE_CASES)
def test_sage_aggregate_takes_bf16_as_the_reference(b, f, d, h, tile,
                                                    dtypes):
    """ops.sage_aggregate with neigh and w bf16 (or either alone): out in
    neigh's dtype, the f32 mean and product of the reference, against the
    JAX package's Pallas kernel (interpret mode) and oracle on the same
    values: within 2 bf16 ulps for a bf16 out, the f32 tolerance (rtol /
    atol 1e-5) for an f32 one."""
    rng = np.random.RandomState(b + 7)
    neigh = rng.randn(b, f, d).astype(np.float32)
    w = (rng.randn(d, h) * d ** -0.5).astype(np.float32)
    tn, jn = _bf16(neigh) if dtypes[0] == "b" else (
        torch.from_numpy(neigh), jnp.asarray(neigh))
    tw, jw = _bf16(w) if dtypes[1] == "b" else (
        torch.from_numpy(w), jnp.asarray(w))
    got = ops.sage_aggregate(tn, tw)
    assert got.dtype == tn.dtype and got.shape == (b, h)
    assert torch.equal(got, ref.sage_aggregate_ref(tn, tw))
    rtol, atol = (BF16_RTOL, 1e-5) if dtypes[0] == "b" else (1e-5, 1e-5)
    for want in (jops.sage_aggregate(jn, jw, tile_b=tile, interpret=True),
                 jref.sage_aggregate_ref(jn, jw)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_grad_of_bf16_tables_matches_jax(combiner, fused):
    """The backward of a bf16 table (the f32 scatter, cast to bf16) against
    jax.grad of the reference's f32 sums of the bf16 table, duplicate ids
    included: within 2 bf16 ulps."""
    rng = np.random.RandomState(5)
    tables, jtables = _bf16(rng.randn(3, 20, 8).astype(np.float32))
    ids = rng.randint(0, 20, (16, 3, 4)).astype(np.int32)
    w = rng.randn(16, 3, 8).astype(np.float32)

    def j_loss(t):
        out = jnp.stack([jref.embedding_bag_ref(t[f].astype(jnp.float32),
                                                ids[:, f],
                                                combiner=combiner)
                         for f in range(3)], axis=1)
        return jnp.sum(out * w)

    want = jax.grad(j_loss)(jtables)
    assert want.dtype == jnp.bfloat16
    t = tables.clone().requires_grad_(True)
    op = ops.embedding_bag_fused if fused else ops.embedding_bag
    (op(t, torch.from_numpy(ids), combiner=combiner)
     * torch.from_numpy(w)).sum().backward()
    assert t.grad.dtype == BF16
    np.testing.assert_allclose(_f32(t.grad), _f32(want), rtol=BF16_RTOL,
                               atol=1e-6)


def test_dot_interact_grad_of_bf16_matches_jax():
    """The backward of bf16 feats (the f32 (S + S^T) x, cast to bf16)
    against jax.grad of the reference taken in f32 on the same bf16
    values and cast to bf16 at the input: within 2 bf16 ulps. (jax.grad
    of the reference's bf16 einsum rounds each of the Gram product's two
    cotangent halves to bf16 before adding them, which loses up to a few
    percent where they cancel; the TPU kernel has no backward.) The
    weights are bf16 values, so the cotangent of the bf16 out is the same
    on both sides."""
    rng = np.random.RandomState(6)
    feats, jfeats = _bf16(rng.randn(6, 7, 16).astype(np.float32))
    w = _f32(_bf16(rng.randn(6, 21).astype(np.float32))[0])
    want = jax.grad(lambda x: jnp.sum(
        jref.dot_interact_ref(x.astype(jnp.float32)) * w))(jfeats)
    assert want.dtype == jnp.bfloat16
    x = feats.clone().requires_grad_(True)
    (ops.dot_interact(x).float() * torch.from_numpy(w)).sum().backward()
    assert x.grad.dtype == BF16
    np.testing.assert_allclose(_f32(x.grad), _f32(want), rtol=BF16_RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("b,f,d,h", [(16, 5, 12, 7), (8, 10, 602, 128)])
def test_sage_aggregate_grads_of_bf16_match_jax(b, f, d, h):
    """d_neigh and d_w of bf16 neigh and w (the f32 backward, cast to
    bf16) against jax.grad of the reference: within 2 bf16 ulps."""
    rng = np.random.RandomState(d + 1)
    neigh, jneigh = _bf16(rng.randn(b, f, d).astype(np.float32))
    w, jw = _bf16((rng.randn(d, h) * d ** -0.5).astype(np.float32))
    cot = rng.randn(b, h).astype(np.float32)
    want_n, want_w = jax.grad(
        lambda n, w_: jnp.sum(jref.sage_aggregate_ref(n, w_)
                              .astype(jnp.float32) * cot),
        argnums=(0, 1))(jneigh, jw)
    x = neigh.clone().requires_grad_(True)
    tw = w.clone().requires_grad_(True)
    (ops.sage_aggregate(x, tw).float() * torch.from_numpy(cot)).sum() \
        .backward()
    assert x.grad.dtype == BF16 and tw.grad.dtype == BF16
    np.testing.assert_allclose(_f32(x.grad), _f32(want_n), rtol=BF16_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(_f32(tw.grad), _f32(want_w), rtol=BF16_RTOL,
                               atol=1e-5)


def test_wrappers_take_bf16_and_refuse_other_dtypes(monkeypatch):
    """The forwards' dtype checks take f32 and bf16 (the TPU kernels') and
    refuse f16; the backward kernels take f32 only (ops hands them f32)."""
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda")))
    for dtype in (torch.float32, BF16):
        eb._check(torch.zeros(2, 3, 4, dtype=dtype), "tables",
                  eb.TABLE_DTYPES, 3)
        eb._check(torch.zeros(2, 3, 4, dtype=dtype), "neigh",
                  sa.FWD_DTYPES, 3)
    for dtypes in (eb.TABLE_DTYPES, sa.FWD_DTYPES, torch.float32):
        with pytest.raises(TypeError, match="must be"):
            eb._check(torch.zeros(2, 3, 4, dtype=torch.float16), "x",
                      dtypes, 3)


# ---- the redesigned forwards' host plans -------------------------------

def _tri_block(t: int):
    """(I, J) of triangle block t, as csrc/dot_interact.cu computes it: an
    f32 square root, then corrected."""
    i = int((np.sqrt(np.float32(8 * t + 1), dtype=np.float32)
             - np.float32(1)) * np.float32(0.5))
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


# (b, f, d, elem, ptr): the DLRM shape f32 and bf16, the card tests'
# (F, D) at B 1, 37 and 2051, 16-, 4- and 2-byte aligned feats
DOT_FWD_CASES = [(2048, 27, 128, 4, 0), (2048, 27, 128, 2, 0),
                 (2051, 27, 128, 2, 2), (37, 27, 128, 2, 4),
                 (1, 2, 4, 4, 0), (37, 5, 7, 4, 4), (37, 5, 7, 2, 0),
                 (2051, 60, 32, 4, 4), (37, 60, 32, 2, 0),
                 (37, 27, 10, 2, 4), (3, 110, 1, 4, 0), (5, 2, 6140, 2, 0)]


@pytest.mark.parametrize("b,f,d,elem,ptr", DOT_FWD_CASES)
def test_dot_interact_fwd_plan_walks_every_sample_and_pair_once(b, f, d,
                                                                elem, ptr):
    """The forward's index maps, simulated as csrc/dot_interact.cu walks
    them: warp w of the grid takes samples w, w + W, ..., every sample
    once; its lanes take the triangle's 4 x 4 blocks (I >= J) by the f32
    square-root formula, every block once, and the pairs they store
    (i = 4I + a < F, j = 4J + q < i) land on every output index i(i-1)/2
    + j once; the tile's slots are distinct and within the tile; the copy
    width follows D, F D and the pointer; shared memory fits a block and
    the CTAs an SM fit its shared memory, threads and CTA limit."""
    plan = di.fwd_plan(b, f, d, elem, ptr)
    walked = sorted(s for w in range(plan.workers)
                    for s in range(w, b, plan.workers))
    assert walked == list(range(b))
    blocks = [_tri_block(t) for t in range(len(di.fwd_blocks(f)))]
    assert blocks == di.fwd_blocks(f)
    stored = [i * (i - 1) // 2 + j for bi, bj in blocks
              for i in range(4 * bi, 4 * bi + 4)
              for j in range(4 * bj, 4 * bj + 4) if i < f and j < i]
    assert sorted(stored) == list(range(f * (f - 1) // 2))
    slots = [di.fwd_slot(r, f) for r in range(f)]
    assert len(set(slots)) == f and max(slots) < di.fwd_slots(f)
    assert di.fwd_slots(f) == max(slots) + 1
    if elem == 4:
        assert plan.copy == (16 if d % 4 == 0 and ptr % 16 == 0 else 4)
    else:
        assert plan.copy == (16 if f * d % 8 == 0 and ptr % 16 == 0 else
                             4 if f * d % 2 == 0 and ptr % 4 == 0 else 0)
    assert 1 <= plan.warps <= di.FWD_MAX_WARPS
    assert plan.smem == plan.warps * di.fwd_warp_smem(f, d, elem) <= di.SMEM
    per_sm = -(-plan.ctas // di.SMS)
    assert per_sm * (plan.smem + 1024) <= di.SM_SHARED_BYTES
    assert per_sm <= di.SM_CTAS and per_sm * plan.warps * 32 <= di.SM_THREADS
    assert plan.ctas <= max(1, -(-b // plan.warps))


def test_dot_interact_fwd_plan_at_the_dlrm_shape():
    """(2048, 27, 128): 27 slots of 132 floats (33 float4s, odd, so that
    neighbouring slots start in different banks), 28 blocks for the 351
    pairs, 8 warps an SM in f32 (2 a CTA, 4 CTAs an SM) and in bf16 (1 a
    CTA)."""
    assert di.fwd_ld(128) == 132 and di.fwd_slots(27) == 27
    assert len(di.fwd_blocks(27)) == 28
    banks = {(s * di.fwd_ld(128) // 4) % 8 for s in range(8)}
    assert banks == set(range(8))
    assert di.fwd_plan(2048, 27, 128) == di.FwdPlan(16, 2, 528, 57024)
    assert di.fwd_plan(2048, 27, 128, 2) == di.FwdPlan(16, 1, 1056, 28080)
    assert di.fwd_plan(2048, 27, 128, 2, ptr=2).copy == 0


def test_dot_interact_fwd_plan_takes_every_tile_the_wrapper_takes():
    """Every (F, D) that passes the wrapper's tile check has a forward
    plan whose shared memory fits a block, for f32 and bf16 feats: at each
    F, the widest D and the three below it."""
    for f in range(2, 2458):
        d_max = di._MAX_SHARED_BYTES // (4 * f) - 4
        for d in range(max(1, d_max - 3), d_max + 1):
            di._check_tile(f, d + 4)
            for elem in (4, 2):
                assert di.fwd_plan(2048, f, d, elem).smem <= di.SMEM, (f, d)
        with pytest.raises(ValueError):
            di._check_tile(f, d_max + 1 + 4)


def _place(slot, b, f, group):
    """csrc/embedding_bag_fused.cu's `place`, vectorized: (b, f) of each
    place of the walk in feature groups."""
    full = f // group
    g = np.minimum(slot // (b * group), full)
    size = np.where(g < full, group, f - full * group)
    rem = slot - g * (b * group)
    bb = rem // np.maximum(size, 1)
    return bb, g * group + rem - bb * size


# (b, f, v, d, bag, elem, ptr): the wide arm f32 and bf16, the reduced
# and deep tables, ragged D, 2- and 4-byte aligned bf16 tables, tables
# over the L2 budget (groups of 1), a ragged last feature group
FUSED_PLAN_CASES = [(300, 40, 2 ** 20, 1, 4, 4, 0),
                    (300, 40, 2 ** 20, 1, 4, 2, 0),
                    (37, 5, 2 ** 21, 1, 4, 4, 0),
                    (37, 6, 2 ** 21, 1, 4, 2, 0),
                    (33, 8, 512, 8, 4, 4, 0),
                    (33, 6, 256, 32, 3, 2, 2),
                    (37, 3, 1000, 5, 16, 2, 0),
                    (37, 3, 1000, 10, 4, 2, 4),
                    (37, 3, 1000, 33, 1, 4, 0),
                    (5, 3, 2 ** 23, 1, 4, 4, 0),
                    (301, 7, 2 ** 20, 1, 4, 4, 0),
                    (301, 7, 2 ** 20, 1, 3, 2, 0)]


@pytest.mark.parametrize("b,f,v,d,bag,elem,ptr", FUSED_PLAN_CASES)
def test_embedding_bag_fused_plan_covers_every_row_once(b, f, v, d, bag,
                                                        elem, ptr):
    """The fused forward's index map, simulated as
    csrc/embedding_bag_fused.cu walks it: every (b, f) row is taken by
    exactly `lanes` threads, lanes 0 .. lanes - 1 once each; the walk's
    places go group after group, feature groups of tables within the L2
    budget (at least 1); loads as wide as D and the pointer allow; lanes
    times the load cover D (or are 32)."""
    plan = eb.fused_plan(b, f, v, d, bag, elem, ptr)
    if elem == 4:
        assert plan.vec == (4 if d % 4 == 0 and ptr % 16 == 0 else 1)
    else:
        assert plan.vec == (8 if d % 8 == 0 and ptr % 16 == 0 else
                            2 if d % 2 == 0 and ptr % 4 == 0 else 1)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes * plan.vec >= d or plan.lanes == 32
    assert 1 <= plan.group <= f
    table = v * d * elem
    assert plan.group == 1 or plan.group * table <= eb.FUSED_L2_BYTES
    assert plan.group == f or (plan.group + 1) * table > eb.FUSED_L2_BYTES
    t = np.arange(plan.blocks * eb.FUSED_THREADS)
    lane = t & (plan.lanes - 1)
    slot = t >> plan.lanes_log2
    live = slot < b * f
    bb, ff = _place(slot[live], b, f, plan.group)
    seen = np.zeros((b, f, plan.lanes), dtype=np.int64)
    np.add.at(seen, (bb, ff, lane[live]), 1)
    assert (seen == 1).all()
    # group after group: a place's feature group never decreases
    groups = ff // plan.group
    assert (np.diff(groups[lane[live] == 0]) >= 0).all()
    # no more blocks than the rows need
    assert (plan.blocks - 1) * eb.FUSED_THREADS < b * f * plan.lanes


def test_embedding_bag_fused_plan_at_the_path_shapes():
    # wide-deep's wide arm: a thread a row, f32 tables of 4 MiB in groups
    # of 4, bf16 ones of 2 MiB in groups of 8; 10240 blocks of 256
    assert eb.fused_plan(65536, 40, 2 ** 20, 1, 4) == \
        eb.FusedPlan(1, 1, 4, 10240)
    assert eb.fused_plan(65536, 40, 2 ** 20, 1, 4, 2) == \
        eb.FusedPlan(1, 1, 8, 10240)


# ---- the forward's host plan (csrc/embedding_bag.cu) -------------------

# D: the models' (1, 32, 128) and around them, and the even widths that
# are not multiples of 4 (6, xDeepFM's 10, DIEN's 18, 34); (b, f): B 1,
# 37 and 65536
EB_FWD_DS = [1, 2, 3, 5, 6, 8, 10, 18, 32, 33, 34, 128, 132]
EB_FWD_BF = [(1, 5), (37, 5), (65536, 2)]


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("b,f", EB_FWD_BF)
@pytest.mark.parametrize("d", EB_FWD_DS)
def test_embedding_bag_fwd_plan_covers_every_load_once(d, b, f, elem):
    """The forward's index map, simulated as csrc/embedding_bag.cu walks
    it, at every pointer alignment a table of `elem`-byte elements can
    have: words as wide as D and the pointer allow (f32: 16 bytes where D
    % 4 == 0, 8 where D is even, both at their alignment; bf16: 16, then
    4 bytes); the flat walk (a thread a word, its row and feature by the
    plan's divisors) for an f32 table's 8- and 4-byte words in rows of
    more than one, the lane walk (lanes the least power of two covering a
    row's words, or 32) for the rest; every (b, f, word) taken by exactly
    one thread; a grid
    within CUDA's limits and no block more than the words need; the row's
    feature agrees with row % f; and each bag of 1, 3, 4, 16 or 17 ids is
    walked j ascending, each slot once, in chunks of the unroll bound
    (the plan does not depend on the bag)."""
    for ptr in ((0, 4, 8) if elem == 4 else (0, 2, 4)):
        plan = eb.fwd_plan(b, f, d, elem, ptr)
        assert plan.vec == eb.load_width(d, elem, ptr, eb.FWD_WIDTHS[elem])
        if elem == 4:
            assert plan.vec == (4 if d % 4 == 0 and ptr % 16 == 0 else
                                2 if d % 2 == 0 and ptr % 8 == 0 else 1)
        else:
            assert plan.vec == (8 if d % 8 == 0 and ptr % 16 == 0 else
                                2 if d % 2 == 0 and ptr % 4 == 0 else 1)
        words = d // plan.vec
        assert words * plan.vec == d
        assert (plan.lanes == 0) == (elem == 4 and plan.vec < 4)
        _check_walk(plan, words)
        # words a thread: FLAT_WORDS on the flat walk; threads a row: lanes
        k, per_row = (eb.FLAT_WORDS, words) if plan.lanes == 0 \
            else (1, plan.lanes)
        assert 1 <= plan.blocks <= 2 ** 31 - 1
        assert (plan.blocks - 1) * eb.FWD_THREADS * k < b * f * per_row \
            <= plan.blocks * eb.FWD_THREADS * k
        row, c = _walk_words(plan, plan.blocks * eb.FWD_THREADS, b * f,
                             words, k)
        assert b * f <= 2 ** 31 - 1
        if plan.lanes == 0:
            feat = row - _quotient(row, plan.per_feat, f) * f
            assert plan.per_feat == eb.divisor(f, plan.blocks * k
                                               * eb.FWD_THREADS)
        else:
            feat = row.astype(np.uint32) % np.uint32(f)
        assert (feat == row % f).all()
        seen = np.bincount(row * words + c, minlength=b * f * words)
        assert seen.size == b * f * words and (seen == 1).all()
    for bag in (1, 3, 4, 16, 17):
        unroll = 4 if bag <= 4 else 16
        walked = [j0 + j for j0 in range(0, bag, unroll)
                  for j in range(min(unroll, bag - j0))]
        assert walked == list(range(bag))


def test_embedding_bag_fwd_plan_at_the_path_shapes():
    # wide-deep's deep arm, D = 32: 8 lanes of float4 (4 rows a warp) in
    # f32, 4 lanes of 8 bf16 (8 rows a warp); the DLRM's D = 128: a warp
    # a row in f32, 16 lanes (2 rows a warp) in bf16; a 4-byte aligned
    # bf16 table takes 2 bf16 a load
    # (blocks of 128 threads)
    assert eb.fwd_plan(65536, 40, 32) == eb.FwdPlan(4, 8, 163840)
    assert eb.fwd_plan(65536, 40, 32, 2) == eb.FwdPlan(8, 4, 81920)
    assert eb.fwd_plan(2048, 26, 128) == eb.FwdPlan(4, 32, 13312)
    assert eb.fwd_plan(2048, 26, 128, 2) == eb.FwdPlan(8, 16, 6656)
    assert eb.fwd_plan(2048, 26, 128, 2, 4) == eb.FwdPlan(2, 32, 13312)
    # the wide arm through the row kernel (where the fused one does not
    # fire): the flat walk, 2 rows a thread
    assert eb.fwd_plan(65536, 40, 1) == eb.FwdPlan(
        1, 0, 10240, eb.Div(2 ** 31, 31), eb.divisor(40, 2 ** 21))
    # a 4-byte aligned f32 table at D = 32: 4-byte words on the flat walk
    # (a warp a row); an 8-byte aligned one: 8-byte words (2 rows a warp)
    plan = eb.fwd_plan(65536, 40, 32, 4, 4)
    assert (plan.vec, plan.lanes, plan.blocks) == (1, 0, 327680)
    plan = eb.fwd_plan(65536, 40, 32, 4, 8)
    assert (plan.vec, plan.lanes, plan.blocks) == (2, 0, 163840)


# ---- the vocab shard's take (csrc/embedding_take.cu) --------------------

def _jax_masked_take(tbl, idl, row0: int, v_loc: int):
    """The reference's masked take on one rank's shard, as
    src/repro/models/embedding.py:72-78 writes it inside its shard_map."""
    lid = idl - row0
    ok = (lid >= 0) & (lid < v_loc)
    e = jnp.take(tbl, jnp.clip(lid, 0, v_loc - 1), axis=0)
    return e * ok[..., None].astype(e.dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,v_loc,row0,d", [(40, 16, 0, 8), (300, 24, 20, 5),
                                            (64, 50, 7, 16)])
def test_take_plain_versions_match_the_reference_masked_take(n, v_loc, row0,
                                                             d, dtype):
    """The take's plain versions against the reference's masked take and
    its jax.vjp, from the same numpy inputs: ids repeated (a hot id a
    third of the slots) and outside the shard on both sides. The forward
    bitwise; the gradient bitwise in f32 (both add a row's slots in
    ascending order), in bf16 bitwise on rows one slot names and within n
    bf16 ulps of the sum of its terms' magnitudes on a row n slots name
    (XLA's bf16 scatter rounds each add, the plain version the f32 sum
    once)."""
    rng = np.random.RandomState(n + row0)
    table = rng.randn(v_loc, d).astype(np.float32)
    ids = rng.randint(row0 - 9, row0 + v_loc + 9, n).astype(np.int32)
    ids[rng.rand(n) < 1 / 3] = row0 + v_loc // 2
    cot = rng.randn(n, d).astype(np.float32)
    if dtype == "bf16":
        tt, jt = _bf16(table)
        tc, jc = _bf16(cot)
    else:
        tt, jt = torch.from_numpy(table), jnp.asarray(table)
        tc, jc = torch.from_numpy(cot), jnp.asarray(cot)
    tid = torch.from_numpy(ids)
    want, vjp = jax.vjp(lambda t: _jax_masked_take(t, jnp.asarray(ids), row0,
                                                   v_loc), jt)
    (want_g,) = vjp(jc)
    got = ref.embedding_take_local_ref(tt, tid, row0)
    assert got.dtype == tt.dtype and want.dtype == jt.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))
    got_g = ref.embedding_take_local_bwd_ref(tc, tid, row0, v_loc)
    assert got_g.dtype == tt.dtype and got_g.shape == (v_loc, d)
    if dtype == "f32":
        np.testing.assert_array_equal(_f32(got_g), _f32(want_g))
        return
    lid = ids.astype(np.int64) - row0
    count = np.bincount(lid[(lid >= 0) & (lid < v_loc)], minlength=v_loc)
    once = count == 1
    np.testing.assert_array_equal(_f32(got_g)[once], _f32(want_g)[once])
    mag = np.zeros((v_loc, d))
    for s, r in enumerate(lid):
        if 0 <= r < v_loc:
            mag[r] += np.abs(_f32(tc)[s])
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    err = np.abs(_f32(got_g) - _f32(want_g))
    assert (err <= np.maximum(count, 1)[:, None] * ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_local_rows_take_keeps_the_table_dtype(dtype):
    """On the CPU `local_rows_take` returns the table's dtype (no f32
    widening: the reference's masked take stays in it), takes any shape
    of ids (a strided column too) and writes its gradient in that dtype
    through the plain versions, launching nothing."""
    from repro_torch.models.embedding import local_rows_take
    g = torch.Generator().manual_seed(3)
    table = torch.randn((10, 6), generator=g).to(dtype).requires_grad_(True)
    ids = torch.randint(0, 30, (4, 5), generator=g, dtype=torch.int32)
    before = ops.launch_counts()
    out = local_rows_take(table, ids, 10)
    assert out.dtype == dtype and out.shape == (4, 5, 6)
    assert torch.equal(local_rows_take(table, ids[:, 1], 10), out[:, 1])
    lid = ids.long() - 10
    ok = (lid >= 0) & (lid < 10)
    assert torch.equal(out[ok], table.detach()[lid[ok]])
    assert not bool(out[~ok].any())
    out.sum().backward()
    assert table.grad.dtype == dtype
    want = torch.bincount(lid[ok], minlength=10).to(dtype)[:, None] \
        .expand(10, 6)
    assert torch.equal(table.grad, want)
    assert ops.launch_counts() == before


def test_take_wrappers_refuse_wrong_dtypes_and_shapes(monkeypatch):
    """The take's wrappers check dtype, rank, contiguity, row0 and the
    match of d_out, ids and grad before they build or launch anything."""
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda")))
    ids = torch.zeros(6, dtype=torch.int32)
    bad = [
        (TypeError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(5, 4, dtype=torch.float16), ids, 0)),
        (TypeError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(5, 4), ids.long(), 0)),
        (ValueError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(1, 5, 4), ids, 0)),
        (ValueError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(5, 4), ids.view(2, 3), 0)),
        (ValueError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(4, 5).t(), ids, 0)),
        (ValueError, lambda: eb.embedding_take_fwd_local(
            torch.zeros(5, 4), ids, -1)),
        (TypeError, lambda: eb.embedding_take_bwd_local(
            torch.zeros(6, 4, dtype=torch.float64), ids, 0, 5)),
        (ValueError, lambda: eb.embedding_take_bwd_local(
            torch.zeros(7, 4), ids, 0, 5)),
        (ValueError, lambda: eb.embedding_take_scatter(
            torch.zeros(6, 4), ids, torch.zeros(5, 4, dtype=BF16), 0)),
        (ValueError, lambda: eb.embedding_take_scatter(
            torch.zeros(6, 4), ids, torch.zeros(5, 3), 0)),
        (ValueError, lambda: eb.embedding_take_scatter(
            torch.zeros(6, 4), ids, torch.zeros(5, 4), -2)),
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    assert ops.launch_counts()["embedding_take_fwd_local"] == 0


@pytest.mark.parametrize("n,row_bytes,ptr", [
    (16384, 4608, 0), (16384, 4096, 0), (4, 4608, 0), (3, 14, 0),
    (37, 12, 0), (37, 12, 4), (5, 2, 0), (4194304, 256, 0)])
def test_take_fwd_plan_covers_every_word_once(n, row_bytes, ptr):
    """The forward's words: the widest of 16, 4 and 2 bytes that a row and
    the pointers allow; blocks enough for every word in one round of 4 a
    thread; the divisor exact over the walk's span (or the 64-bit
    division past 2^31)."""
    plan = eb.take_fwd_plan(n, row_bytes, ptr)
    assert row_bytes % plan.word == 0 and ptr % plan.word == 0
    assert all(row_bytes % w or ptr % w for w in eb.TAKE_WIDTHS
               if w > plan.word)
    words, threads = n * row_bytes // plan.word, \
        plan.blocks * eb.TAKE_THREADS * eb.TAKE_WORDS
    assert words <= threads < words + eb.TAKE_THREADS * eb.TAKE_WORDS \
        or plan.blocks == 1
    wpr = row_bytes // plan.word
    span = eb.take_fwd_span(words, plan.blocks)
    assert plan.per_row == eb.divisor(wpr, span)
    for w in {0, 1, wpr - 1, wpr, words - 1, span - 1}:
        assert (w * plan.per_row.magic) >> plan.per_row.shift == w // wpr
    with pytest.raises(ValueError, match="takes no word"):
        eb.take_fwd_plan(3, 7, 0)


@pytest.mark.parametrize("n,v_loc,d,elem,ptr", [
    (16384, 256000, 2304, 2, 0), (16384, 151936, 2048, 2, 0),
    (4194304, 262148, 64, 4, 0), (4, 256000, 2304, 2, 0),
    (777, 50, 7, 2, 0), (150000, 2000, 8, 4, 0), (64, 5, 8, 2, 8),
    (1, 1, 1, 4, 0)])
def test_take_bwd_plan_covers_every_key_and_level(n, v_loc, d, elem, ptr):
    """The backward's sort passes cover the keys [0, v_loc] in digits of
    at most 10 bits; its tiles cover the n slots, none empty, and keep to
    4 an SM where 8 slots a thread allow; its scratch holds every level
    of the sum (level 2 in part_a, 3 in part_b, in turns); its words are
    16 bytes where D and the pointers allow."""
    plan = eb.take_bwd_plan(n, v_loc, d, elem, ptr)
    assert plan.passes * plan.radix_bits >= v_loc.bit_length()
    assert plan.radix_bits <= eb.SORT_MAX_BITS
    assert (plan.passes - 1) * eb.SORT_MAX_BITS < v_loc.bit_length()
    tile = eb.SORT_THREADS * plan.kpt
    assert (plan.tiles - 1) * tile < n <= plan.tiles * tile
    assert plan.tiles <= eb.SORT_TILES or plan.kpt == 8
    assert plan.kpt == 1 or _cdiv_t(n, tile // 2) > eb.SORT_TILES
    levels = eb.take_levels(n)
    for i, m in enumerate(levels[1:]):
        assert m <= (plan.part_a, plan.part_b)[i % 2]
    assert _cdiv_t(levels[-1], eb.TAKE_CHUNK if len(levels) == 1
                   else eb.TAKE_CHUNK_UP) == 1
    vec = 16 // elem
    assert plan.vec == (vec if d % vec == 0 and ptr % 16 == 0 else 1)


def _cdiv_t(a: int, b: int) -> int:
    return -(-a // b)


def test_take_bwd_plan_at_the_lm_shapes():
    """gemma2-2b's 16,384 ids into its (256000, 2304) bf16 shard: two sort
    passes of 9 bits over 64 tiles of 256; 16-byte words; four levels of
    the sum (16,384 slots in chunks of 64, then 512, 64 and 8 partials in
    chunks of 16)."""
    assert eb.take_bwd_plan(16384, 256000, 2304, 2) == eb.TakeBwdPlan(
        8, 2, 9, 1, 64, 512, 64)
    assert eb.take_levels(16384) == [16384, 512, 64, 8]
    assert eb.take_fwd_plan(16384, 4608) == eb.TakeFwdPlan(
        16, 4608, eb.divisor(288, 16384 * 288 + 4608 * 1024))
