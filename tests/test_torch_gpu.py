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
