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


@pytest.mark.gpu
def test_cuda_sage_aggregate_matches_plain_version():
    """On the card: sage_aggregate_fwd (aggregate bitwise, output rtol /
    atol 1e-5 against f32 cuBLAS with TF32 off) and sage_aggregate_bwd
    (d_neigh rtol / atol 1e-5; d_w within 1e-5 of max |d_w|) at a ragged
    shape and at the GNN's hidden-layer shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, f, d, h in ((37, 1, 5, 7), (1024, 15, 128, 47)):
        neigh = torch.randn((b, f, d), device="cuda", generator=gen)
        w = torch.randn((d, h), device="cuda", generator=gen) * d ** -0.5
        out, agg = sa.sage_aggregate_fwd(neigh, w, save_agg=True)
        assert torch.equal(agg, ref.sage_mean_ref(neigh))
        torch.testing.assert_close(out, ref.sage_aggregate_ref(neigh, w),
                                   rtol=1e-5, atol=1e-5)
        d_out = torch.randn((b, h), device="cuda", generator=gen)
        d_neigh, d_w = sa.sage_aggregate_bwd(d_out, w, agg, f, True)
        want_n, want_w = ref.sage_aggregate_bwd_ref(d_out, w, agg, f)
        torch.testing.assert_close(d_neigh, want_n, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d_w, want_w, rtol=0,
                                   atol=1e-5 * float(want_w.abs().max()))


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
    is refused and raises, launching nothing; one row fewer fits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lanes = 32
    rows = (2 ** 31 - 1) // lanes + 1            # 2^26
    tables = torch.ones((1, 1, 33), device="cuda")
    ids = torch.zeros((rows, 1, 1), dtype=torch.int32, device="cuda")
    before = eb.LAUNCHES["embedding_bag_fused_fwd"]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        eb.embedding_bag_fused_fwd(tables, ids)
    assert eb.LAUNCHES["embedding_bag_fused_fwd"] == before
    out = eb.embedding_bag_fused_fwd(tables, ids[1:])
    assert out.shape == (rows - 1, 1, 33) and bool((out == 1).all())
