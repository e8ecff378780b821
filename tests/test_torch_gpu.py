"""The port's CUDA kernels against their plain versions on the card
(`gpu` marker; each test skips without a CUDA device). This file imports
torch alone, not jax, so that it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dot_interact as di  # noqa: E402
from repro_torch.kernels import embedding_bag as eb  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sage_aggregate as sa  # noqa: E402


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: every kernel against its plain version (embedding
    forward bitwise; backward and interaction allclose)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = torch.randn((3, 100, 12), device="cuda", generator=gen)
    ids = torch.randint(0, 100, (37, 3, 2), device="cuda", generator=gen,
                        dtype=torch.int32)
    for combiner in ("sum", "mean"):
        assert torch.equal(eb.embedding_bag_fwd(tables, ids, combiner),
                           ref.embedding_bag_ref(tables, ids,
                                                 combiner=combiner))
        g = torch.randn((37, 3, 12), device="cuda", generator=gen)
        torch.testing.assert_close(
            eb.embedding_bag_bwd(g, ids, 100, combiner),
            ref.embedding_bag_bwd_ref(g, ids, 100, combiner=combiner),
            rtol=1e-5, atol=1e-6)
    feats = torch.randn((37, 27, 16), device="cuda", generator=gen)
    torch.testing.assert_close(di.dot_interact_fwd(feats),
                               ref.dot_interact_ref(feats),
                               rtol=1e-5, atol=1e-4)
    d_out = torch.randn((37, 351), device="cuda", generator=gen)
    torch.testing.assert_close(di.dot_interact_bwd(d_out, feats),
                               ref.dot_interact_bwd_ref(d_out, feats),
                               rtol=1e-5, atol=1e-4)


def _check_scatter(d_out, ids, v, combiner):
    """embedding_bag_bwd against its plain version, feature by feature, at
    rtol 1e-5 / atol 1e-6 (atomic order and count x g for a repeated id
    vary the rounding); the call launches the kernel once."""
    before = eb.LAUNCHES["embedding_bag_bwd"]
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner)
    assert eb.LAUNCHES["embedding_bag_bwd"] == before + 1
    # an out-of-range id adds nothing: the plain version sends it to one
    # of two rows past V, which are then dropped
    ext = torch.where(ids < 0, v + 1, torch.where(ids >= v, v, ids))
    want = ref.embedding_bag_bwd_ref(d_out, ext, v + 2,
                                     combiner=combiner)[:, :v]
    for f in range(got.shape[0]):
        torch.testing.assert_close(got[f], want[f], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 32, 128, 132])
def test_cuda_embedding_bag_bwd_matches_plain_version(d):
    """At every D in use and around it: (5, 2^20 / D, D) tables, whose
    plan walks groups of 2 features, so 5 is not a multiple of the group,
    and (5, 50, D) tables, where most ids repeat across bags; B 1 and 300;
    bags of 1, 3, 4, 16 and 17 (the unrolled bounds and past them); sum
    and mean; bags whose ids all repeat, and bags padded by repeating
    their head id as the DLRM featurizer pads them. The gradients are
    non-negative: a row of the (5, 50) tables sums about a hundred of
    them, and with signs a row that nearly cancels differs between any
    two orders of f32 atomics (the plain version's index_add_ among them)
    by more than atol."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(d)
    for v in (2 ** 20 // d, 50):
        f = 5
        assert v == 50 or eb.bwd_plan(300, f, v, d).group == 2
        for b in (1, 300):
            for bag in (1, 3, 4, 16, 17):
                ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                    generator=gen, dtype=torch.int32)
                d_out = torch.randn((b, f, d), device="cuda",
                                    generator=gen).abs()
                same = ids[..., :1].expand(b, f, bag).contiguous()
                lengths = torch.randint(1, bag + 1, (b, f, 1), device="cuda",
                                        generator=gen)
                padded = torch.where(torch.arange(bag, device="cuda")
                                     < lengths, ids, ids[..., :1])
                for combiner in ("sum", "mean"):
                    for i in (ids, same, padded):
                        _check_scatter(d_out, i, v, combiner)


@pytest.mark.gpu
def test_cuda_embedding_bag_bwd_skips_out_of_range_ids():
    """An id of -1 or V adds nothing, with sum and mean, on the float4
    (D = 32) and scalar (D = 1, 5) paths, in bags of 4 and 17."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for d in (1, 5, 32):
        for bag in (4, 17):
            v = 1000
            ids = torch.randint(0, v, (37, 3, bag), device="cuda",
                                generator=gen, dtype=torch.int32)
            ids[5, 1, 0] = -1
            ids[9, 2, bag - 1] = v
            ids[20, 0, :] = v
            d_out = torch.randn((37, 3, d), device="cuda", generator=gen)
            for combiner in ("sum", "mean"):
                _check_scatter(d_out, ids, v, combiner)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [6, 10, 18, 34])
def test_cuda_embedding_bag_bwd_narrow_rows(d):
    """The scatter at the even widths that are not multiples of 4 (the
    flat walk: float2 atomics into a 16- or 8-byte aligned f32 gradient,
    one column into one 4-byte aligned, a slice 0, 2 or 1 elements into a
    buffer), over (5, 1000, D) and (5, 50, D) tables (ids repeat across
    bags), B 1 and 300, bags of 1, 3, 4 and 17, sum and mean: random ids,
    bags whose ids all repeat, and ids of -1 and V, which add nothing.
    Non-negative d_out, against the plain version at rtol 1e-5 / atol
    1e-6; the gradient's buffer outside the slice stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(300 + d)
    f = 5
    for v in (1000, 50):
        for b in (1, 300):
            for bag in (1, 3, 4, 17):
                ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                    generator=gen, dtype=torch.int32)
                bad = ids.clone()
                bad[0, f - 1, 0] = -1
                bad[b - 1, 0, bag - 1] = v
                same = ids[..., :1].expand(b, f, bag).contiguous()
                d_out = torch.rand((b, f, d), device="cuda", generator=gen)
                ext = torch.where(bad < 0, v + 1,
                                  torch.where(bad >= v, v, bad))
                for combiner in ("sum", "mean"):
                    for i in (ids, same, bad):
                        _check_scatter(d_out, i, v, combiner)
                    want = ref.embedding_bag_bwd_ref(
                        d_out, ext, v + 2, combiner=combiner)[:, :v]
                    for shift, vec in ((0, 2), (2, 2), (1, 1)):
                        buf = torch.zeros(f * v * d + 2, device="cuda")
                        grad = buf[shift:shift + f * v * d].view(f, v, d)
                        plan = eb.bwd_plan(b, f, v, d,
                                           grad.data_ptr() % 16)
                        assert (plan.vec, plan.lanes) == (vec, 0)
                        eb.embedding_bag_scatter(d_out, bad, grad, combiner)
                        torch.testing.assert_close(grad, want, rtol=1e-5,
                                                   atol=1e-6)
                        assert not buf[:shift].any()
                        assert not buf[shift + f * v * d:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("f,d", [(2, 4), (27, 128), (27, 10), (60, 32)])
def test_cuda_dot_interact_bwd_matches_plain_version(f, d):
    """dot_interact_bwd against its plain version (rtol 1e-5, atol 1e-4,
    against f32 cuBLAS with TF32 off) at B 1, 37 and 2048 + 3 (more
    samples than persistent CTAs, not a multiple of them), and with a
    feats that is a slice of a larger buffer at a 4-byte offset (4-byte
    copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(f + d)
    p = f * (f - 1) // 2
    for b in (1, 37, 2048 + 3):
        d_out = torch.randn((b, p), device="cuda", generator=gen)
        buf = torch.randn(b * f * d + 1, device="cuda", generator=gen)
        for feats in (buf[:-1].view(b, f, d), buf[1:].view(b, f, d)):
            before = di.LAUNCHES["dot_interact_bwd"]
            got = di.dot_interact_bwd(d_out, feats)
            assert di.LAUNCHES["dot_interact_bwd"] == before + 1
            torch.testing.assert_close(
                got, ref.dot_interact_bwd_ref(d_out, feats), rtol=1e-5,
                atol=1e-4)
        assert buf[1:].data_ptr() % 16 == 4


def _check_dneigh(d_neigh, want):
    """d_neigh within rtol / atol 1e-5 of the plain version (f32 FMAs in
    another order than cuBLAS's), and each of its F copies of a row
    bitwise equal to copy 0."""
    torch.testing.assert_close(d_neigh, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(d_neigh, d_neigh[:, :1].expand_as(d_neigh))


def _check_sage(neigh, w, gen):
    """sage_aggregate_fwd and _bwd against their plain versions: the saved
    aggregate (rows padded to a multiple of 4 floats) bitwise, out rtol /
    atol 1e-5 against f32 cuBLAS with TF32 off, d_neigh rtol / atol 1e-5,
    d_w within 1e-5 of max |d_w|; out without the saved aggregate, d_w
    without d_neigh and a second run of each bitwise equal."""
    b, f, d = neigh.shape
    h = w.shape[1]
    out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
    assert agg.shape == (b, d) and agg.stride() == (sa.agg_stride(d), 1)
    assert torch.equal(agg, ref.sage_mean_ref(neigh))
    torch.testing.assert_close(out, ref.sage_aggregate_ref(neigh, w),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(sa.sage_aggregate_fwd(neigh, w)[0], out)
    assert torch.equal(sa.sage_aggregate_fwd(neigh, w, save_agg=True)[0],
                       out)
    d_out = torch.randn((b, h), device="cuda", generator=gen)
    d_neigh, d_w = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    want_n, want_w = ref.sage_aggregate_bwd_ref(d_out, w, agg, f)
    _check_dneigh(d_neigh, want_n)
    torch.testing.assert_close(d_w, want_w, rtol=0,
                               atol=1e-5 * float(want_w.abs().max()))
    again, d_w1 = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
    assert torch.equal(again, d_neigh) and torch.equal(d_w1, d_w)
    none, d_w2 = sa.sage_aggregate_bwd(d_out, w, agg, f, False)
    assert none is None and torch.equal(d_w2, d_w)
    # a contiguous aggregate (rows not padded) gives the same d_w
    assert torch.equal(
        sa.sage_aggregate_bwd(d_out, w, agg.contiguous(), f, False)[1], d_w)


@pytest.mark.gpu
def test_cuda_sage_aggregate_matches_plain_version():
    """On the card, at ragged shapes and the GNN's hidden-layer shape:
    B 37 with F 1, D 5, H 7; H 130 over two column tiles; B 4225 (tiles
    of 32 rows) at D 33 (4-byte loads); B 1023 (not a multiple of 4) at F
    15, D 602 (F D = 2 mod 4: 8-byte loads, every other row 8- but not
    16-byte aligned) and H 128; F 43 at H 47; D 300 at H 130; F 44 at D
    602; and h1's (1024, 15, 128) x (128, 47) with 16-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, f, d, h in ((37, 1, 5, 7), (37, 3, 33, 130), (4225, 2, 33, 7),
                       (1023, 15, 602, 128), (5, 43, 6, 47),
                       (600, 10, 300, 130), (300, 44, 602, 128),
                       (1024, 15, 128, 47)):
        neigh = torch.randn((b, f, d), device="cuda", generator=gen)
        w = torch.randn((d, h), device="cuda", generator=gen) * d ** -0.5
        _check_sage(neigh, w, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 5, 33, 602])
def test_cuda_sage_dneigh_every_plan_gives_the_same_bits(d, monkeypatch):
    """sage_dneigh_kernel alone (no aggregate, so no d_w) at h1's (1024,
    15, d) from (1024, 47) x (d, 47)^T, D 128 and the ragged 5, 33 and
    602, with d_out and w contiguous and each sliced 4 bytes off a 16-byte
    boundary: under its plan and both tiles (8 and 4 rows), d_neigh within
    1e-5 of the plain version, its F copies of a row bitwise equal, two
    runs bitwise equal, and each tile bitwise equal to the plan's (each
    sum's order is fixed by H alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d)
    b, f, h = 1024, 15, 47
    plan_fn = sa.dneigh_plan
    for shift in (0, 1):
        gbuf = torch.randn(b * h + shift, device="cuda", generator=gen)
        wbuf = torch.randn(d * h + shift, device="cuda", generator=gen)
        d_out = gbuf[shift:].view(b, h)
        w = wbuf[shift:].view(d, h)
        assert d_out.data_ptr() % 16 == w.data_ptr() % 16 == 4 * shift
        want, _ = ref.sage_aggregate_bwd_ref(d_out, w, None, f)
        first, _ = sa.sage_aggregate_bwd(d_out, w, None, f, True)
        _check_dneigh(first, want)
        for rr in (2, 1):
            plan = sa.DneighPlan(rr)
            monkeypatch.setattr(sa, "dneigh_plan", lambda *a, p=plan: p)
            before = sa.LAUNCHES["sage_aggregate_bwd"]
            got, none = sa.sage_aggregate_bwd(d_out, w, None, f, True)
            assert sa.LAUNCHES["sage_aggregate_bwd"] == before + 1
            assert none is None
            assert torch.equal(got, first), plan
            assert torch.equal(sa.sage_aggregate_bwd(
                d_out, w, None, f, True)[0], got), plan
            monkeypatch.setattr(sa, "dneigh_plan", plan_fn)


@pytest.mark.gpu
def test_cuda_sage_aggregate_takes_neigh_at_any_alignment():
    """A neigh that is a slice of a larger buffer, 8- or 4- but not
    16-byte aligned, at D 128 (16-byte copies when aligned) and D 602:
    the plan narrows the copies and the results hold as in
    _check_sage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, f, d, h in ((300, 15, 128, 47), (300, 10, 602, 128)):
        for shift in (2, 1):
            buf = torch.randn(b * f * d + shift, device="cuda",
                              generator=gen)
            neigh = buf[shift:].view(b, f, d)
            assert neigh.data_ptr() % 16 != 0
            assert sa.fwd_plan(b, f, d, h, neigh.data_ptr()).vec == shift
            w = torch.randn((d, h), device="cuda", generator=gen) * d ** -0.5
            _check_sage(neigh, w, gen)


@pytest.mark.gpu
def test_cuda_embedding_bag_fused_matches_row_kernel_and_plain_version():
    """On the card: embedding_bag_fused_fwd bit-equal to embedding_bag_fwd
    and to the plain version at the wide arm's D = 1, the reduced
    tables' D = 8, a ragged D (scalar loads) and the deep tables' D = 32;
    F a multiple of its walk's group of 4 features and not (40, 8; 3, 6);
    bags 1, 4 and 16; sum and mean; and an out-of-range id poisons its
    row with NaN in both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for f, v, d, b, bag in ((40, 4096, 1, 300, 4), (8, 512, 8, 64, 4),
                            (3, 100, 5, 37, 16), (6, 256, 32, 33, 1)):
        tables = torch.randn((f, v, d), device="cuda", generator=gen)
        ids = torch.randint(0, v, (b, f, bag), device="cuda", generator=gen,
                            dtype=torch.int32)
        for combiner in ("sum", "mean"):
            row = eb.embedding_bag_fwd(tables, ids, combiner)
            assert torch.equal(row, ref.embedding_bag_fused_ref(
                tables, ids, combiner=combiner))
            got = eb.embedding_bag_fused_fwd(tables, ids, combiner)
            assert torch.equal(got, row), (f, v, d, bag, combiner)
        ids[b // 2, f - 1, bag - 1] = v
        got = eb.embedding_bag_fused_fwd(tables, ids)
        row = eb.embedding_bag_fwd(tables, ids)
        assert torch.isnan(got[b // 2, f - 1]).all()
        assert torch.isnan(row[b // 2, f - 1]).all()
        nan = torch.isnan(got)
        assert int(nan.sum()) == d
        assert torch.equal(got[~nan], row[~nan])


@pytest.mark.gpu
def test_cuda_embedding_bag_fused_refuses_more_than_int32_threads():
    """The fused kernel walks its output with 32-bit indices: a call of
    more than 2^31 - 1 threads (B * F rows, 32 threads a row at D = 33)
    is refused and raises, launching nothing; one row fewer fits. The
    wrapper refuses it before the launch (the kernel would too), so that
    a meta tensor's plan is refused alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lanes = 32
    rows = (2 ** 31 - 1) // lanes + 1            # 2^26
    tables = torch.ones((1, 1, 33), device="cuda")
    ids = torch.zeros((rows, 1, 1), dtype=torch.int32, device="cuda")
    before = eb.LAUNCHES["embedding_bag_fused_fwd"]
    with pytest.raises(ValueError, match="at most 2\\^31 - 1 threads"):
        eb.embedding_bag_fused_fwd(tables, ids)
    assert eb.LAUNCHES["embedding_bag_fused_fwd"] == before
    out = eb.embedding_bag_fused_fwd(tables, ids[1:])
    assert out.shape == (rows - 1, 1, 33) and bool((out == 1).all())


# SHA-256 of the f32 outputs of embedding_bag_fwd and sage_aggregate_fwd
# at one shape each, inputs made with numpy from a seed, as the kernels
# gave them before they took bf16 (NVIDIA H100 80GB HBM3): the f32
# instantiations must keep every bit
F32_DIGESTS = {
    "embedding_bag_fwd":
        "e58536944def53d1d954e19e0386b311ce2971cc43ab97257c8f9a9380633afd",
    "sage_aggregate_fwd":
        "da82b499cf69dba7ad19ebcb7bda5b2e21d0b4016326f44e12ab990f7373f302"}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


@pytest.mark.gpu
def test_cuda_f32_forwards_keep_their_bits():
    """embedding_bag_fwd at (5, 1000, 32) tables, ids (37, 5, 4), sum and
    mean; sage_aggregate_fwd at (4225, 10, 602) x (602, 128) (32-row
    tiles, 8-byte loads): the same bits as before the kernels took
    bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(16)
    tables = torch.from_numpy(rng.randn(5, 1000, 32).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 1000, (37, 5, 4)).astype(np.int32))
    bags = torch.cat([eb.embedding_bag_fwd(tables.cuda(), ids.cuda(), c)
                      for c in ("sum", "mean")])
    neigh = torch.from_numpy(rng.randn(4225, 10, 602).astype(np.float32))
    w = torch.from_numpy((rng.randn(602, 128) / 602 ** 0.5)
                         .astype(np.float32))
    out = sa.sage_aggregate_fwd(neigh.cuda(), w.cuda())[0]
    got = {"embedding_bag_fwd": _digest(bags),
           "sage_aggregate_fwd": _digest(out)}
    assert got == F32_DIGESTS, got


# ---- bf16 forwards and the redesigned kernels --------------------------

BF16 = torch.bfloat16
# a bf16 output against its plain version: within 2 bf16 ulps (rtol
# 2^-7) of two roundings of f32 sums taken in another order, with the f32
# checks' atol for sums that cancel
BF16_RTOL = 2.0 ** -7


def _slice(n, dtype, shift, gen):
    """n values of `dtype`, `shift` elements into a larger buffer."""
    buf = torch.randn(n + shift, device="cuda", generator=gen).to(dtype)
    return buf[shift:]


def _check_bags(tables, ids, fused):
    """embedding_bag_fwd (and embedding_bag_fused_fwd where `fused`)
    bitwise to the plain version, sum and mean; an out-of-range id makes
    exactly its own row NaN in both and leaves the rest equal."""
    for combiner in ("sum", "mean"):
        row = eb.embedding_bag_fwd(tables, ids, combiner)
        assert row.dtype == torch.float32
        assert torch.equal(row, ref.embedding_bag_ref(tables, ids,
                                                      combiner=combiner))
        if fused:
            assert torch.equal(eb.embedding_bag_fused_fwd(tables, ids,
                                                          combiner), row)
    b, f, bag = ids.shape
    bad = ids.clone()
    bad[b // 2, f - 1, bag - 1] = tables.shape[1]
    row = eb.embedding_bag_fwd(tables, bad)
    nan = torch.isnan(row)
    assert int(nan.sum()) == tables.shape[2] and nan[b // 2, f - 1].all()
    if fused:
        got = eb.embedding_bag_fused_fwd(tables, bad)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan], row[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 5, 8, 10, 32, 128])
def test_cuda_embedding_forwards_take_bf16_tables(d):
    """bf16 tables through both embedding forwards at every load width:
    16-byte (D % 8 == 0), 4-byte (D even) and 2-byte loads (odd D, or a
    table only 2-byte aligned: a slice 1 element into a buffer; 2
    elements: 4-byte aligned); B 1 and 37; bags 1, 4, 16 (both kernels)
    and 17 (the row kernel); 3 and 5 features; and the f32 tables of the
    same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(d)
    for f, v in ((3, 1000), (5, 300)):
        for shift in (0, 1, 2):
            tables = _slice(f * v * d, BF16, shift, gen).view(f, v, d)
            assert shift == 0 or tables.data_ptr() % 16 != 0
            for b in (1, 37):
                for bag in (1, 4, 16, 17):
                    ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                        generator=gen, dtype=torch.int32)
                    _check_bags(tables, ids, fused=bag <= 16)
                    if shift == 0:
                        _check_bags(tables.float(), ids, fused=bag <= 16)


@pytest.mark.gpu
def test_cuda_embedding_bag_fused_walks_feature_groups():
    """Tables of 8 MiB (f32) or 4 MiB (bf16) a feature: the fused plan
    walks groups of 2 or 4 features, 5 and 6 features leave a short last
    group; both kernels bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(7)
    v = 2 ** 21
    for dtype, group in ((torch.float32, 2), (BF16, 4)):
        for f in (5, 6):
            tables = torch.randn((f, v, 1), device="cuda", generator=gen) \
                .to(dtype)
            plan = eb.fused_plan(300, f, v, 1, 4, tables.element_size())
            assert plan.group == group and plan.lanes == 1
            ids = torch.randint(0, v, (300, f, 4), device="cuda",
                                generator=gen, dtype=torch.int32)
            _check_bags(tables, ids, fused=True)


@pytest.mark.gpu
@pytest.mark.parametrize("f,d", [(2, 4), (5, 7), (27, 128), (27, 10),
                                 (60, 32)])
def test_cuda_dot_interact_fwd_matches_plain_version(f, d):
    """The persistent-warp dot_interact_fwd against its plain version:
    f32 at rtol 1e-5 / atol 1e-4 (against f32 cuBLAS with TF32 off), bf16
    within 2 bf16 ulps; B 1, 37 and 2051 (more samples than warps, not a
    multiple of them); feats at an offset of 0, 1 and 2 elements into a
    buffer (f32: 16- or 4-byte copies; bf16: 16-byte copies, none (2-byte
    aligned) and 4-byte copies); one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(f * d)
    for b in (1, 37, 2048 + 3):
        for dtype, rtol in ((torch.float32, 1e-5), (BF16, BF16_RTOL)):
            for shift in (0, 1, 2):
                feats = _slice(b * f * d, dtype, shift, gen).view(b, f, d)
                before = di.LAUNCHES["dot_interact_fwd"]
                got = di.dot_interact_fwd(feats)
                assert di.LAUNCHES["dot_interact_fwd"] == before + 1
                assert got.dtype == dtype
                torch.testing.assert_close(
                    got.float(), ref.dot_interact_ref(feats).float(),
                    rtol=rtol, atol=1e-4)


@pytest.mark.gpu
def test_cuda_sage_aggregate_fwd_takes_bf16():
    """sage_aggregate_fwd with neigh and w bf16, or either alone: the f32
    aggregate bitwise to the plain version; out in neigh's dtype, within
    2 bf16 ulps when bf16, rtol / atol 1e-5 when f32; at D 602 (4-byte
    loads), 128 (16-byte), 5 and a neigh 2-byte aligned (2-byte), w whole
    (H 7, 47, 128) and in column tiles (H 130), tiles of 8 and 32 rows.
    A bf16 w's widening kernel gives w.float() bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    for b, f, d, h, shift in ((37, 1, 5, 7, 0), (37, 3, 33, 130, 0),
                              (1023, 15, 602, 128, 0), (4225, 2, 34, 7, 0),
                              (1024, 15, 128, 47, 0), (300, 10, 602, 128, 1),
                              (300, 15, 128, 47, 2)):
        for nd, wd in ((BF16, BF16), (BF16, torch.float32),
                       (torch.float32, BF16)):
            neigh = _slice(b * f * d, nd, shift if nd == BF16 else 0,
                           gen).view(b, f, d)
            w = (torch.randn((d, h), device="cuda", generator=gen)
                 * d ** -0.5).to(wd)
            if wd == BF16:
                assert torch.equal(sa.widen_w(w), w.float())
            out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
            assert out.dtype == nd and agg.dtype == torch.float32
            assert torch.equal(agg, ref.sage_mean_ref(neigh))
            rtol, atol = (BF16_RTOL, 1e-5) if nd == BF16 else (1e-5, 1e-5)
            torch.testing.assert_close(
                out.float(), ref.sage_aggregate_ref(neigh, w).float(),
                rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_cuda_ops_differentiate_bf16_inputs():
    """ops.dot_interact, ops.sage_aggregate and ops.embedding_bag on bf16
    inputs on the card: the kernels run forward and backward (the DLRM's
    two backward kernels write bf16 gradients, sage_aggregate_bwd's f32
    ones are cast to bf16), and the gradients are within 2 bf16 ulps of
    those of the plain versions on the card; the embedding bag's, whose
    bf16 atomics round every add, bitwise where one bag slot names a row
    and within the bound of _check_scatter_bf16 elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(12)

    def grads(fn, inputs, cot):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        (fn(*xs).float() * cot).sum().backward()
        return [x.grad for x in xs]

    feats = torch.randn((37, 27, 128), device="cuda", generator=gen).to(BF16)
    cot = torch.randn((37, 351), device="cuda", generator=gen).to(BF16) \
        .float()
    before = dict(ops.launch_counts())
    (got,) = grads(ops.dot_interact, [feats], cot)
    (want,) = grads(ref.dot_interact_ref, [feats], cot)
    neigh = torch.randn((300, 10, 602), device="cuda", generator=gen) \
        .to(BF16)
    w = (torch.randn((602, 128), device="cuda", generator=gen)
         * 602 ** -0.5).to(BF16)
    cot2 = torch.randn((300, 128), device="cuda", generator=gen).to(BF16) \
        .float()
    got2 = grads(ops.sage_aggregate, [neigh, w], cot2)
    want2 = grads(ref.sage_aggregate_ref, [neigh, w], cot2)
    tables = torch.randn((3, 100, 32), device="cuda", generator=gen).to(BF16)
    ids = torch.randint(0, 100, (37, 3, 4), device="cuda", generator=gen,
                        dtype=torch.int32)
    cot3 = torch.randn((37, 3, 32), device="cuda", generator=gen)
    (got3,) = grads(lambda t: ops.embedding_bag(t, ids), [tables], cot3)
    # the plain version's own backward on bf16 rows would accumulate the
    # repeated ids in bf16: its f32 form, cast back once, is the contract
    (want3,) = grads(lambda t: ref.embedding_bag_ref(t.float(), ids),
                     [tables], cot3)
    after = ops.launch_counts()
    for name in ("dot_interact_fwd", "dot_interact_bwd",
                 "sage_aggregate_fwd", "sage_aggregate_bwd",
                 "embedding_bag_fwd", "embedding_bag_bwd"):
        assert after[name] == before[name] + 1, name
    # the bf16 w is widened by its own kernel, once a forward
    assert after["sage_widen_w"] == before["sage_widen_w"] + 1
    for g, wnt in zip([got, *got2], [want, *want2]):
        assert g.dtype == BF16
        torch.testing.assert_close(g.float(), wnt.float(), rtol=BF16_RTOL,
                                   atol=1e-5)
    assert got3.dtype == want3.dtype == BF16
    _assert_scatter_bf16(got3, want3, cot3, ids, 100, "sum")


# ---- embedding_bag_fwd, lanes a row from its host plan -----------------

# D: the models' (1, 32, 128) and around them; every load width of both
# dtypes, lanes from 1 to 32, and rows of more loads than lanes (132 f32);
# the even widths that are not multiples of 4 (6, xDeepFM's 10, DIEN's 18,
# 34), which f32 tables walk flat in 8-byte words
EB_FWD_DS = [1, 2, 3, 5, 6, 8, 10, 18, 32, 33, 34, 128, 132]


@pytest.mark.gpu
@pytest.mark.parametrize("d", EB_FWD_DS)
def test_cuda_embedding_bag_fwd_is_bitwise_the_plain_version(d):
    """embedding_bag_fwd bit for bit (torch.equal and the same f32 bit
    patterns) against ref.embedding_bag_ref, sum and mean: f32 tables 16-,
    4- and 8-byte aligned and bf16 ones 16-, 2- and 4-byte aligned (a
    slice 0, 1 or 2 elements into a buffer: the f32 table at +1 element
    takes 4-byte words); B 1 and 37; bags 1, 3, 4, 16 and 17 (the unroll
    bounds and a bag walked in chunks); one launch a call. Ids of -1 and
    V make exactly their own rows NaN and leave every other row equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(100 + d)
    for f, v in ((3, 1000), (5, 300)):
        buf = torch.randn(f * v * d + 2, device="cuda", generator=gen)
        for dtype, shift in ((torch.float32, 0), (torch.float32, 1),
                             (torch.float32, 2), (BF16, 0), (BF16, 1),
                             (BF16, 2)):
            tables = buf.to(dtype)[shift:shift + f * v * d].view(f, v, d)
            align = tables.data_ptr() % 16
            assert align == shift * tables.element_size()
            if dtype == torch.float32 and shift == 1:
                assert eb.fwd_plan(37, f, d, 4, align).vec == 1
            for b in (1, 37):
                for bag in (1, 3, 4, 16, 17):
                    ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                        generator=gen, dtype=torch.int32)
                    for combiner in ("sum", "mean"):
                        before = eb.LAUNCHES["embedding_bag_fwd"]
                        got = eb.embedding_bag_fwd(tables, ids, combiner)
                        assert eb.LAUNCHES["embedding_bag_fwd"] == before + 1
                        want = ref.embedding_bag_ref(tables, ids,
                                                     combiner=combiner)
                        assert torch.equal(got, want), (dtype, shift, b, bag)
                        assert torch.equal(got.view(torch.int32),
                                           want.view(torch.int32))
                    bad = ids.clone()
                    bad[0, 0, 0] = -1
                    bad[b - 1, f - 1, bag - 1] = v
                    got = eb.embedding_bag_fwd(tables, bad)
                    nan_rows = torch.isnan(got).any(-1)
                    assert bool(torch.isnan(got[nan_rows]).all())
                    assert nan_rows[0, 0] and nan_rows[b - 1, f - 1]
                    assert int(nan_rows.sum()) == (1 if b == 1 and f == 1
                                                   else 2)
                    want = ref.embedding_bag_ref(tables, ids)
                    assert torch.equal(got[~nan_rows], want[~nan_rows])


# ---- bf16 backwards of the DLRM kernels --------------------------------

def _bf16_ulps(x):
    """Two bf16 ulps at |x| (2^-6 of its power of two), elementwise; the
    smallest normal's at 0."""
    x = x.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 6)


def _assert_scatter_bf16(got, want, d_out, ids, v, combiner):
    """A bf16 table gradient `got` against `want`, the plain version's (f32
    sums rounded once): bitwise on every row that one bag slot names; a
    row that n slots name within 2 bf16 ulps of the sum of its terms'
    magnitudes a slot, plus 2 (every bf16 atomic rounds the row's running
    sum, in an order that varies). Returns the rows named more than
    once."""
    mag = ref.embedding_bag_bwd_ref(d_out.abs(), ids, v, combiner=combiner)
    b, f, bag = ids.shape
    flat = (torch.arange(f, device=ids.device).view(1, f, 1) * v
            + ids.long()).reshape(-1)
    touches = torch.bincount(flat, minlength=f * v).view(f, v, 1)
    once = (touches == 1).expand_as(got)
    assert torch.equal(got[once], want[once])
    err = (got.float() - want.float()).abs()
    assert bool((err <= (touches + 1) * _bf16_ulps(mag)).all()), \
        float((err / _bf16_ulps(mag)).max())
    return int((touches > 1).sum())


def _check_scatter_bf16(d_out, ids, v, combiner):
    """embedding_bag_bwd into a bf16 gradient against its plain version
    (`_assert_scatter_bf16`); one launch a call."""
    before = eb.LAUNCHES["embedding_bag_bwd"]
    got = eb.embedding_bag_bwd(d_out, ids, v, combiner, dtype=BF16)
    assert eb.LAUNCHES["embedding_bag_bwd"] == before + 1
    assert got.dtype == BF16
    want = ref.embedding_bag_bwd_ref(d_out, ids, v, combiner=combiner,
                                     dtype=BF16)
    return _assert_scatter_bf16(got, want, d_out, ids, v, combiner)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 8, 32, 128, 132])
def test_cuda_embedding_bag_bwd_writes_bf16_gradients(d):
    """The scatter into a bf16 table gradient: 8 columns a word in bf16x2
    atomics where D % 8 == 0, one column at a time else (and from a d_out
    only 4-byte aligned); ids all distinct in a feature (every row bitwise
    the plain version), drawn from a small table (ids repeat across and
    within bags), and bags padded by repeating their head id; sum and
    mean, B 1 and 301, bags 1, 4 and 17. The f32 gradient is unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(200 + d)
    f = 3
    repeated = 0
    for b, bag in ((1, 1), (301, 1), (301, 4), (37, 17)):
        for v, distinct in ((4096, True), (29, False)):
            if distinct:
                ids = torch.stack([torch.randperm(v, device="cuda",
                                                  generator=gen)[:b * bag]
                                   for _ in range(f)], 1) \
                    .view(b, bag, f).transpose(1, 2).contiguous()
            else:
                ids = torch.randint(0, v, (b, f, bag), device="cuda",
                                    generator=gen)
                ids[..., bag // 2:] = ids[..., :1]
            ids = ids.to(torch.int32)
            for shift in (0, 1):
                buf = torch.randn(b * f * d + 1, device="cuda", generator=gen)
                d_out = buf[shift:shift + b * f * d].view(b, f, d)
                for combiner in ("sum", "mean"):
                    repeated += _check_scatter_bf16(d_out, ids, v, combiner)
    assert repeated > 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,d", [(37, 27, 128), (2051, 27, 128),
                                   (1, 2, 4), (37, 27, 10), (37, 27, 7),
                                   (3, 60, 32), (301, 5, 12)])
def test_cuda_dot_interact_bwd_takes_bf16(b, f, d):
    """dot_interact_bwd with bf16 d_out and feats into a bf16 d_feats,
    against its plain version on the same bf16 values (f32 sums rounded
    once): within 2 bf16 ulps (rtol 2^-7, atol 1e-5). Feats 16-, 2- and
    4-byte aligned (16-byte copies, loads element by element, 4-byte
    copies), d_out 4- and 2-byte aligned (copied to a 4-byte boundary),
    odd B with odd P (a row of d_out ends on half a word), D % 8 != 0.
    One launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(b + f + d)
    p = f * (f - 1) // 2
    for shift in (0, 1, 2):
        feats = _slice(b * f * d, BF16, shift, gen).view(b, f, d)
        for gshift in (0, 1):
            d_out = _slice(b * p, BF16, gshift, gen).view(b, p)
            before = di.LAUNCHES["dot_interact_bwd"]
            got = di.dot_interact_bwd(d_out, feats)
            assert di.LAUNCHES["dot_interact_bwd"] == before + 1
            assert got.dtype == BF16 and got.shape == (b, f, d)
            torch.testing.assert_close(
                got.float(), ref.dot_interact_bwd_ref(d_out, feats).float(),
                rtol=BF16_RTOL, atol=1e-5)


# SHA-256 of the f32 outputs of the two DLRM backward kernels as they were
# before they took bf16 (NVIDIA H100 80GB HBM3), at one input each made
# with numpy from a seed: dot_interact_bwd at (37, 27, 128) and (37, 27,
# 10); embedding_bag_bwd at ids that name every row once (no two atomics
# meet, so the order cannot move a bit)
F32_BWD_DIGESTS = {
    "dot_interact_bwd":
        "627e8c26f9669f83cf211dfadf6be79475578109b0bf4feb56117ab37cde6c1c",
    "embedding_bag_bwd":
        "a7d4e058b7102c649d8ef412bb3c48c0f3b094d6942629622684146f3465572e"}


def f32_bwd_outputs():
    """The two f32 backward outputs that F32_BWD_DIGESTS pins."""
    import numpy as np
    rng = np.random.RandomState(18)
    outs = []
    for d in (128, 10):
        feats = torch.from_numpy(rng.randn(37, 27, d).astype(np.float32))
        d_out = torch.from_numpy(rng.randn(37, 351).astype(np.float32))
        outs.append(di.dot_interact_bwd(d_out.cuda(), feats.cuda()))
    ids = torch.from_numpy(np.stack([rng.permutation(2000)[:37 * 4]
                                     for _ in range(5)], 1)
                           .reshape(37, 4, 5).transpose(0, 2, 1)
                           .astype(np.int32).copy())
    d_out = torch.from_numpy(rng.randn(37, 5, 32).astype(np.float32))
    bags = [eb.embedding_bag_bwd(d_out.cuda(), ids.cuda(), 2000, c)
            for c in ("sum", "mean")]
    return {"dot_interact_bwd": _digest(torch.cat([o.flatten()
                                                   for o in outs])),
            "embedding_bag_bwd": _digest(torch.cat(bags))}


@pytest.mark.gpu
def test_cuda_f32_backwards_keep_their_bits():
    """The f32 instantiations of the two DLRM backward kernels give the
    same bits as before the kernels took bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert f32_bwd_outputs() == F32_BWD_DIGESTS


@pytest.mark.gpu
@pytest.mark.parametrize("d", [10, 18, 64])
def test_cuda_embedding_kernels_at_the_sequence_models_widths(d):
    """xDeepFM's tables (D = 10), DIEN's items (D = 18) and BERT4Rec's (D
    = 64), f32, bags of one, as the models look them up: the forward
    bitwise the plain version at ragged batch sizes (1, 37, 4097) over
    one feature of 2^20 rows (as DIEN and BERT4Rec gather items) and 39
    features of 5000; the scatter with repeated ids (a 300-row table)
    and non-negative d_out against its plain version at rtol 1e-5 / atol
    1e-6, and writing nothing where no id points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(d)
    for f, v in ((1, 2 ** 20), (39, 5000), (1, 300)):
        tables = torch.randn((f, v, d), device="cuda", generator=gen)
        for b in (1, 37, 4097):
            ids = torch.randint(0, v, (b, f, 1), device="cuda",
                                generator=gen, dtype=torch.int32)
            assert torch.equal(eb.embedding_bag_fwd(tables, ids),
                               ref.embedding_bag_ref(tables, ids)), (f, v, b)
            d_out = torch.rand((b, f, d), device="cuda", generator=gen)
            got = eb.embedding_bag_bwd(d_out, ids, v)
            want = ref.embedding_bag_bwd_ref(d_out, ids, v)
            for i in range(f):
                torch.testing.assert_close(got[i], want[i], rtol=1e-5,
                                           atol=1e-6)
                hit = torch.zeros(v, dtype=torch.bool, device="cuda")
                hit[ids[:, i, 0].long()] = True
                assert not got[i][~hit].any()


@pytest.mark.gpu
def test_cuda_embedding_bag_fused_on_the_xdeepfm_linear_arm():
    """xDeepFM's linear arm, its (39, 2^20) f32 table viewed as (39,
    2^20, 1), 4 MiB a feature, read in bags of one: the fused kernel
    fires (ops.fused_fires) and is bitwise the row kernel and the plain
    version at ragged batch sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(39)
    linear = torch.randn((39, 2 ** 20, 1), device="cuda", generator=gen) \
        .mul_(0.01)
    assert ops.fused_fires(linear, 1)
    for b in (1, 37, 8192):
        ids = torch.randint(0, 2 ** 20, (b, 39, 1), device="cuda",
                            generator=gen, dtype=torch.int32)
        got = eb.embedding_bag_fused_fwd(linear, ids)
        assert torch.equal(got, eb.embedding_bag_fwd(linear, ids)), b
        assert torch.equal(got, ref.embedding_bag_fused_ref(linear, ids)), b


def _assert_sum_within_order_bound(got, rows, addends):
    """`got` against one index_add_ of `addends` into `rows`: a row of n
    addends within 2 n 2^-24 of the sum of their magnitudes, the most two
    f32 summation orders can differ by."""
    want = torch.zeros_like(got).index_add_(0, rows, addends)
    mag = torch.zeros_like(got).index_add_(0, rows, addends.abs())
    n = torch.bincount(rows.long(), minlength=got.shape[0]).to(got.dtype)
    bound = 2.0 * n[:, None] * 2.0 ** -24 * mag
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err / bound.clamp(
        min=torch.finfo(got.dtype).tiny)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7919, 1 << 23])
def test_cuda_chunked_segment_reduce_matches_one_shot(chunk):
    """models/segment.py on the card, walked in chunks, against one
    index_add_ (or amax) over every pair at once: the sum and its table
    gradient within 2 n 2^-24 of the sum of their addends' magnitudes, a
    row of n addends (each order's rounding is at most (n - 1) 2^-24 of
    that sum; the atomics add in another order), the max bitwise, a NaN
    row's NaN carried to its segments whatever the order of the
    atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import segment
    gen = torch.Generator(device="cuda").manual_seed(chunk % 1000)
    table = torch.randn((20000, 100), device="cuda", generator=gen)
    g = torch.randint(0, 20000, (300000,), device="cuda", generator=gen,
                      dtype=torch.int32)
    s = torch.randint(0, 15000, (300000,), device="cuda", generator=gen,
                      dtype=torch.int32)
    plan = segment.segment_plan(g, s, 15000, 20000)
    d_out = torch.randn((15000, 100), device="cuda", generator=gen)
    t = table.clone().requires_grad_()
    got = segment.segment_sum(t, plan, chunk=chunk)
    (d_got,) = torch.autograd.grad(got, t, d_out)
    msg = table.index_select(0, g)
    _assert_sum_within_order_bound(got, s, msg)
    _assert_sum_within_order_bound(d_got, g, d_out[s.long()])
    table[7, 3] = float("nan")
    got = segment.segment_max(table, plan, chunk=chunk)
    want = torch.full((15000, 100), -float("inf"), device="cuda") \
        .index_reduce_(0, s, table.index_select(0, g), "amax")
    hit = torch.zeros(15000, dtype=torch.bool, device="cuda")
    hit[s[g == 7].long()] = True
    assert bool(hit.any())
    assert torch.isnan(got[hit, 3]).all() and not torch.isnan(got[~hit]).any()
    # the card's amax keeps or drops the NaN by the order of its atomics:
    # the column the NaN row reaches is left out of the bitwise check
    got[hit, 3] = 0.0
    want[hit, 3] = 0.0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_full_graph_loss_and_grads_match_the_cpu():
    """graphsage-reddit at full_graph_sm (the Cora-sized synthetic graph,
    1,433 features, hidden 128) on the card against the CPU, same
    parameters and graph: loss rtol 1e-5, each gradient within 1e-4 of
    its L2 norm over the nodes that no ReLU flip between the two devices
    reaches (chip_smoke.py's gnn_full_model says why)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from repro_torch.configs.graphsage_reddit import ARCH
    from repro_torch.data.graphs import full_graph_batch
    from repro_torch.models import gnn, segment
    shape, cfg = ARCH.shape("full_graph_sm"), ARCH.model
    graph = full_graph_batch(shape, cfg.n_classes, np.random.RandomState(0))
    runs = []
    for dev in ("cpu", "cuda"):
        model = gnn.init_params(cfg, shape.d_feat, seed=0, device="cpu") \
            .to(dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in graph.items()}
        l1 = model.layers[0]
        plan = gnn.graph_plan(batch["edge_src"], batch["edge_dst"],
                              shape.n_nodes)
        with torch.no_grad():
            agg = segment.segment_sum(batch["x"], plan) \
                / plan.count.clamp(min=1.0)[:, None]
            pre = batch["x"] @ l1.w_self + agg @ l1.w_neigh + l1.b
        nll, mask = gnn.full_graph_nll(model, batch)
        runs.append((model, nll, mask, pre.cpu()))
    (m_c, nll_c, mask_c, pre_c), (m_g, nll_g, mask_g, pre_g) = runs
    flips = ((pre_c > 0) != (pre_g > 0)).any(dim=1)
    src = torch.from_numpy(graph["edge_src"]).long()
    dst = torch.from_numpy(graph["edge_dst"]).long()
    real = dst < shape.n_nodes
    hit = flips.clone()
    hit[dst[real][flips[src[real]]]] = True
    loss_c = (nll_c * mask_c).sum() / mask_c.sum()
    loss_g = (nll_g * mask_g).sum() / mask_g.sum()
    torch.testing.assert_close(loss_g.detach().cpu(), loss_c.detach(),
                               rtol=1e-5, atol=0.0)
    keep = mask_c * (~hit).float()
    grads_c = torch.autograd.grad((nll_c * keep).sum() / keep.sum(),
                                  list(m_c.parameters()))
    keep = keep.cuda()
    grads_g = torch.autograd.grad((nll_g * keep).sum() / keep.sum(),
                                  list(m_g.parameters()))
    for gc, gg in zip(grads_c, grads_g):
        assert float(torch.linalg.vector_norm(gg.cpu() - gc)
                     / torch.linalg.vector_norm(gc)) <= 1e-4


@pytest.mark.gpu
def test_local_rows_mode_matches_plain_versions():
    """The row kernels' local-rows mode (the row-sharded lookup's): tables
    of rows [row0, row0 + V); ids over a larger range, repeated, and
    negative; the lane walk (D 128, f32 and bf16), the flat walk (D 10
    and 1, f32) and bags of 1, 4 and 17 (the scatter's memory-compare
    branch): the forward bitwise its plain version (an id outside reads
    0, not NaN), the scatter with non-negative d_out within rtol 1e-5 /
    atol 1e-6 of its plain version, feature by feature; each launch
    counted under its `_local` name; row0 0 over the whole table is the
    unsharded kernel's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(16)
    for d, dtype in ((128, torch.float32), (128, torch.bfloat16),
                     (10, torch.float32), (1, torch.float32)):
        for bag in (1, 4, 17):
            for row0, v in ((0, 64), (48, 16)):
                tables = torch.randn((3, v, d), device="cuda",
                                     generator=gen).to(dtype)
                ids = torch.randint(-4, 80, (37, 3, bag), device="cuda",
                                    generator=gen, dtype=torch.int32)
                ids[..., bag // 2:] = ids[..., :1]
                before = dict(eb.LAUNCHES)
                got = eb.embedding_bag_fwd(tables, ids, row0=row0)
                assert torch.equal(got, ref.embedding_bag_local_ref(
                    tables, ids, row0)), (d, dtype, bag, row0)
                assert not bool(torch.isnan(got).any())
                g = torch.rand((37, 3, d), device="cuda", generator=gen)
                grad = eb.embedding_bag_bwd(g, ids, v, dtype=dtype,
                                            row0=row0)
                want = ref.embedding_bag_local_bwd_ref(g, ids, row0, v,
                                                       dtype=dtype)
                for f in range(3):
                    if dtype == torch.float32:
                        torch.testing.assert_close(grad[f], want[f],
                                                   rtol=1e-5, atol=1e-6)
                        continue
                    # bf16 atomics round every add: a row n slots name
                    # within 2 (n + 1) bf16 ulps of its (positive) sum
                    lid = ids[:, f].long().reshape(-1) - row0
                    n = torch.bincount(lid[(lid >= 0) & (lid < v)],
                                       minlength=v).float()[:, None]
                    w = want[f].float()
                    ulp = torch.exp2(torch.floor(torch.log2(
                        w.abs().clamp(min=2.0 ** -126))) - 7)
                    assert bool(((grad[f].float() - w).abs()
                                 <= 2 * (n + 1) * ulp).all())
                assert eb.LAUNCHES["embedding_bag_fwd_local"] == \
                    before["embedding_bag_fwd_local"] + 1
                assert eb.LAUNCHES["embedding_bag_bwd_local"] == \
                    before["embedding_bag_bwd_local"] + 1
                assert eb.LAUNCHES["embedding_bag_fwd"] == \
                    before["embedding_bag_fwd"]
    tables = torch.randn((3, 64, 32), device="cuda", generator=gen)
    ids = torch.randint(0, 64, (37, 3, 4), device="cuda", generator=gen,
                        dtype=torch.int32)
    assert torch.equal(eb.embedding_bag_fwd(tables, ids, row0=0),
                       eb.embedding_bag_fwd(tables, ids))
    with pytest.raises(ValueError, match="row0"):
        eb.embedding_bag_fwd(tables, ids, row0=-1)


# ---- the vocab shard's take (csrc/embedding_take.cu) --------------------

def check_take_bwd(grad, d_out, ids, row0, v):
    """The take's scatter against its plain version for non-negative
    d_out: rows one in-shard slot names bitwise; a row n slots name
    within 1 ulp of the gradient's dtype (0 for f32) plus 2 n 2^-24 of
    its exact sum (two orders of n non-negative f32 adds each lie within
    (n - 1) 2^-24 of it, relative); every other row exactly 0."""
    want = ref.embedding_take_local_bwd_ref(d_out, ids, row0, v)
    lid = ids.long() - row0
    ok = (lid >= 0) & (lid < v)
    n = torch.bincount(lid[ok], minlength=v).double()[:, None]
    exact = torch.zeros((v, d_out.shape[1]), dtype=torch.float64,
                        device=d_out.device)
    exact.index_add_(0, lid[ok], d_out[ok].double())
    once = n[:, 0] == 1
    assert torch.equal(grad[once], want[once])
    assert not bool(grad[n[:, 0] == 0].any())
    ulp = 0.0
    if grad.dtype == BF16:
        ulp = torch.exp2(torch.floor(torch.log2(
            exact.clamp(min=2.0 ** -126))) - 7)
    err = (grad.double() - want.double()).abs()
    assert bool((err <= ulp + 2 * n * 2.0 ** -24 * exact).all()), \
        float(err.max())


# (n, v_loc, row0, D, dtype, hot share): 16-byte words (bf16 D 40, f32 D
# 64), single columns (bf16 D 7: 2-byte forward words; f32 D 3: 4-byte
# ones), a row 30% of the slots name (over many chunks and three levels
# of the sum), a decode batch of 4, and 150,000 ids over 2,000 rows (two
# sort passes, tiles of 512)
TAKE_CASES = [(5000, 300, 100, 40, BF16, 0.3), (5000, 300, 0, 64,
                                                  torch.float32, 0.3),
              (4, 300, 100, 40, BF16, 0.0), (777, 50, 25, 7, BF16, 0.5),
              (777, 50, 25, 3, torch.float32, 0.0),
              (150_000, 2000, 1000, 8, torch.float32, 0.2)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,row0,d,dtype,hot", TAKE_CASES)
def test_take_kernels_match_plain_versions(n, v, row0, d, dtype, hot):
    """The take's forward bitwise its plain version (ids below, inside and
    past the shard, zeros outside it); its scatter within check_take_bwd's
    bounds, and bitwise the same over two runs; each wrapper's launch
    counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    table = torch.randn((v, d), device="cuda", generator=gen).to(dtype)
    ids = torch.randint(row0 - v // 2, row0 + v + v // 2, (n,),
                        device="cuda", generator=gen, dtype=torch.int32)
    hit = torch.rand((n,), device="cuda", generator=gen) < hot
    ids[hit] = row0 + v // 3
    before = dict(eb.LAUNCHES)
    got = eb.embedding_take_fwd_local(table, ids, row0)
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, ref.embedding_take_local_ref(table, ids, row0))
    d_out = torch.rand((n, d), device="cuda", generator=gen).to(dtype)
    grad = eb.embedding_take_bwd_local(d_out, ids, row0, v)
    assert grad.dtype == dtype and grad.shape == (v, d)
    check_take_bwd(grad, d_out, ids, row0, v)
    assert torch.equal(grad, eb.embedding_take_bwd_local(d_out, ids, row0,
                                                         v))
    torch.cuda.synchronize()
    for name, k in (("embedding_take_fwd_local", 1),
                    ("embedding_take_bwd_local", 2),
                    ("embedding_bag_fwd_local", 0),
                    ("embedding_bag_bwd_local", 0)):
        assert eb.LAUNCHES[name] == before[name] + k, name


@pytest.mark.gpu
def test_local_rows_take_launches_the_take_kernels():
    """On the card `local_rows_take` (the vocab-sharded lookup's) runs the
    take pair and not the bag's local-rows mode, in the table's dtype both
    ways, and agrees with its CPU path (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    from repro_torch.models.embedding import local_rows_take
    gen = torch.Generator(device="cuda").manual_seed(28)
    table = torch.randn((64, 48), device="cuda", generator=gen).to(BF16)
    ids = torch.randint(0, 200, (6, 9), device="cuda", generator=gen,
                        dtype=torch.int32)
    cot = torch.rand((6, 9, 48), device="cuda", generator=gen).to(BF16)
    before = dict(ops.launch_counts())
    t = table.clone().requires_grad_(True)
    out = local_rows_take(t, ids[:, 2], 64)        # a strided column
    out2 = local_rows_take(t, ids, 64)
    assert out.dtype == out2.dtype == BF16 and out2.shape == (6, 9, 48)
    (out2 * cot).sum().backward()
    after = ops.launch_counts()
    assert after["embedding_take_fwd_local"] == \
        before["embedding_take_fwd_local"] + 2
    assert after["embedding_take_bwd_local"] == \
        before["embedding_take_bwd_local"] + 1
    for name in ("embedding_bag_fwd_local", "embedding_bag_bwd_local"):
        assert after[name] == before[name], name
    assert t.grad.dtype == BF16
    tc = table.cpu().requires_grad_(True)
    want = local_rows_take(tc, ids.cpu(), 64)
    assert torch.equal(out2.cpu(), want)
    assert torch.equal(out.cpu(), want[:, 2])
    (want * cot.cpu()).sum().backward()
    check_take_bwd(t.grad, cot.reshape(-1, 48), ids.reshape(-1), 64, 64)
    check_take_bwd(tc.grad.cuda(), cot.reshape(-1, 48), ids.reshape(-1),
                   64, 64)


@pytest.mark.gpu
def test_take_refused_launch_raises(monkeypatch):
    """A plan that does not fit the call (a forward word of 8 bytes, which
    the kernel does not take; too few sort bits for the backward's keys)
    is refused by the kernel library: the wrapper raises and counts
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table = torch.zeros((3000, 16), device="cuda")
    ids = torch.zeros((5000,), dtype=torch.int32, device="cuda")
    before = dict(eb.LAUNCHES)
    monkeypatch.setattr(eb, "take_fwd_plan", lambda *a: eb.TakeFwdPlan(
        8, 1, eb.NO_DIV))
    with pytest.raises(RuntimeError, match="embedding_take_fwd_local "
                                           "launch failed"):
        eb.embedding_take_fwd_local(table, ids, 0)
    monkeypatch.setattr(eb, "take_bwd_plan", lambda *a: eb.TakeBwdPlan(
        4, 1, 4, 1, 20, 158, 6))
    with pytest.raises(RuntimeError, match="embedding_take_bwd_local "
                                           "launch failed"):
        eb.embedding_take_bwd_local(torch.zeros((5000, 16), device="cuda"),
                                    ids, 0, 3000)
    assert eb.LAUNCHES == before


# ------------------------------------------------------ slice 20: meta ---
def _meta_like(x):
    return torch.empty_like(x, device="meta")


@pytest.mark.gpu
def test_meta_route_gives_a_real_launch_output_shapes():
    """Each op of kernels/ops at one shape, on the card and on meta
    tensors of the same shapes: the same output shapes and dtypes (the
    saved aggregate's padded rows too) and one launch counted under the
    same name each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(20)
    bf16 = torch.bfloat16
    tables = torch.randn((3, 100, 16), device="cuda", generator=gen)
    ids = torch.randint(0, 100, (37, 3, 2), device="cuda", generator=gen,
                        dtype=torch.int32)
    d_bag = torch.randn((37, 3, 16), device="cuda", generator=gen)
    feats = torch.randn((37, 27, 16), device="cuda", generator=gen)
    d_dot = torch.randn((37, 351), device="cuda", generator=gen)
    neigh = torch.randn((64, 5, 32), device="cuda", generator=gen)
    w = torch.randn((32, 8), device="cuda", generator=gen)
    table = torch.randn((100, 16), device="cuda", generator=gen).to(bf16)
    flat = torch.randint(0, 200, (50,), device="cuda", generator=gen,
                         dtype=torch.int32)
    calls = [
        ("embedding_bag_fwd", lambda t, i: ops.embedding_bag(t, i),
         (tables, ids)),
        ("embedding_bag_fused_fwd", lambda t, i: ops.embedding_bag_fused(
            t, i), (tables, ids)),
        ("embedding_bag_fwd_local", lambda t, i: ops.embedding_bag_local(
            t, i, 50), (tables, ids)),
        ("embedding_bag_bwd_local", lambda g, i: ops.embedding_bag_local_bwd(
            g, i, 50, 100, bf16), (d_bag, ids)),
        ("embedding_take_fwd_local", lambda t, i: ops.local_take(t, i, 100),
         (table, flat)),
        ("embedding_take_bwd_local", lambda t, i: ops.local_take_bwd(
            ops.local_take(t, i, 0), i, 0, 100), (table, flat)),
        ("dot_interact_fwd", lambda f: ops.dot_interact(f), (feats,)),
        ("dot_interact_bwd", lambda g, f: ops._DotInteract.backward(
            type("C", (), {"saved_tensors": (f,)})(), g), (d_dot, feats)),
        ("sage_aggregate_fwd", lambda n, w_: ops.sage_aggregate(n, w_),
         (neigh, w)),
        ("sage_widen_w", lambda n, w_: ops.sage_aggregate(n, w_.to(bf16)),
         (neigh, w)),
    ]
    for name, fn, args in calls:
        outs = []
        for dev_args in (args, tuple(_meta_like(a) for a in args)):
            before = ops.launch_counts()[name]
            out = fn(*dev_args)
            outs.append((out.shape, out.dtype,
                         ops.launch_counts()[name] - before))
        assert outs[0] == outs[1] and outs[0][2] >= 1, (name, outs)
    # the backward pair: d_w, d_neigh and the embedding scatter
    for dev in ("cuda", "meta"):
        n = neigh if dev == "cuda" else _meta_like(neigh)
        wt = (w if dev == "cuda" else _meta_like(w)).requires_grad_(True)
        nt = n.clone().requires_grad_(True)
        tb = (tables if dev == "cuda" else _meta_like(tables)) \
            .requires_grad_(True)
        i = ids if dev == "cuda" else _meta_like(ids)
        before = ops.launch_counts()
        (ops.sage_aggregate(nt, wt).sum()
         + ops.embedding_bag(tb, i).sum()).backward()
        after = ops.launch_counts()
        got = (nt.grad.shape, wt.grad.shape, tb.grad.shape, tb.grad.dtype,
               after["sage_aggregate_bwd"] - before["sage_aggregate_bwd"],
               after["embedding_bag_bwd"] - before["embedding_bag_bwd"])
        if dev == "cuda":
            want = got
    assert got == want and want[-2:] == (1, 1), (got, want)


@pytest.mark.gpu
def test_step_analysis_counts_a_cuda_step_as_its_meta_plan():
    """One train step of the driver's reduced dlrm-criteo (bf16, through
    the four DLRM kernels) on the card and planned on meta tensors of the
    same shapes, each under launch/step_analysis: the same dot FLOPs
    (aten ops and the kernels' own), launches and resident bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from repro_torch.configs.dlrm_criteo import ARCH
    from repro_torch.launch import train
    from repro_torch.launch.step_analysis import analyze
    cfg = train.reduced_model(ARCH)
    shape = train.RECSYS_DRIVER_SHAPE
    res = {}
    for dev in ("cuda", "meta"):
        model, opt_state, step_fn, _, _ = train.build_step(
            ARCH, cfg, shape, dev)
        batch = train.make_batch_fn(ARCH, cfg, 32, np.random.RandomState(0),
                                    shape=shape, device="cuda")()
        if dev == "meta":
            batch = {k: _meta_like(v) for k, v in batch.items()}
        r = analyze(lambda m, o, b: step_fn(m, o, 0, b), model, opt_state,
                    batch)
        res[dev] = (r["dot_flops"], r["kernel_dot_flops"], r["launches"],
                    r["resident_bytes"])
    assert res["cuda"] == res["meta"], res
    assert res["cuda"][2] == {"embedding_bag_fwd": 1, "embedding_bag_bwd": 1,
                              "dot_interact_fwd": 1, "dot_interact_bwd": 1}
