"""repro_torch.kernels on the CPU: the plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, their autograd
gradients against jax.grad, the device dispatch of the ops, and the
build's contract. The CUDA kernels themselves run only on the card
(`gpu` marker; chip_smoke.py holds them against these plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.embedding import multifeature_bag as j_multifeature_bag  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import dot_interact as di  # noqa: E402
from repro_torch.kernels import embedding_bag as eb  # noqa: E402
from repro_torch.models.embedding import embedding_bag as t_embedding_bag  # noqa: E402

BAG_CASES = [(64, 8, 4, 1), (512, 32, 16, 4), (1024, 128, 32, 8),
             (128, 10, 8, 3)]
DOT_CASES = [(64, 27, 16, 32), (32, 8, 8, 8), (48, 13, 32, 16)]


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


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ops.launch_counts()
    ops.dot_interact(torch.zeros(2, 3, 4))
    ops.embedding_bag(torch.zeros(2, 5, 4), torch.zeros(3, 2, 1,
                                                        dtype=torch.int32))
    assert ops.launch_counts() == before
    assert set(before) == {"embedding_bag_fwd", "embedding_bag_bwd",
                           "dot_interact_fwd", "dot_interact_bwd"}


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.dot_interact(torch.empty(2, 3, 4, device="meta"))


@pytest.mark.parametrize("call", [
    lambda: eb.embedding_bag_fwd(torch.zeros(2, 5, 4),
                                 torch.zeros(3, 2, 1, dtype=torch.int32)),
    lambda: eb.embedding_bag_scatter(torch.zeros(3, 2, 4),
                                     torch.zeros(3, 2, 1, dtype=torch.int32),
                                     torch.zeros(2, 5, 4)),
    lambda: di.dot_interact_fwd(torch.zeros(2, 3, 4)),
    lambda: di.dot_interact_bwd(torch.zeros(2, 3), torch.zeros(2, 3, 4)),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A CUDA wrapper checks its inputs before it builds or launches
    anything: a CPU tensor is an error there, never a silent CPU run."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


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
