"""The LM family on a mesh of gloo ranks (launch/programs.LMPlacement and
the placed transformer) against the JAX package's own sharded programs
(its `build_lm_program`, four forced host devices) at the (data, model)
meshes (1, 2), (2, 1) and (2, 2), for five reduced LMs that reach every
placed path (tests/torch_dist_ranks.LM_DIST_CASES): heads split,
query positions split, the head dim split, heads reading a replicated
kv head, the MoE with shared experts, tied and untied heads, Gemma's
softcaps, windows and post-norms, and adafactor over 128 x 128
matrices. From one JAX init carried across as numpy and inputs from a
numpy seed, it holds:

  1. the loss and the whole gradients of loss_fn (the port's reduced
     over ranks and gathered) against the reference's loss_fn under its
     train program's in_shardings;
  2. one train step (adam with its clip; adafactor for kimi-like) at
     step 50: the gathered parameters and optimizer state;
  3. every parameter's, optimizer-state tensor's and cache tensor's
     local shape against the reference's shard shape on that mesh;
  4. prefill (13 tokens) and three decode steps over a cache of 16 at
     batches 4 and 2, and 1 for gemma-like and smollm-like (a batch that
     does not split over two data ranks: the cache's positions split over
     them instead): the logits and each rank's cache block;
  5. `rank_bytes` for the five LMs at full width on (16, 16) and
     (2, 16, 16) against the bytes of the reference's own
     `sanitized_pspec` blocks of its abstract trees;
  6. the driver (`run(..., dist_run=True)`) for an LM on gloo ranks: its
     losses against one device's, a checkpoint saved at (2, 2) restored
     at (1, 2) and by the JAX package's own `restore`, bit for bit; each
     rank's parameters drawn as its blocks, bitwise the whole init's;
     the driver's fit check on a mesh reckoned a rank's bytes, from
     shapes alone (qwen2.5-32b, kimi-k2 and qwen2-moe training pass on
     (16, 16), where one device refuses them).

Tolerances, stated before the first run: losses rtol 1e-5 (the F32 of
tests/test_torch_dist.py); gradients, the train step's parameters and
state, prefill and decode logits and caches rtol 1e-5, atol 1e-6 (that
F32), each array's error also allowed 1e-6 of its own largest
magnitude (the attention, the norms and the vocab-parallel loss sum in
other orders than XLA's: tests/test_torch_lm.py's scaling); shapes and
bytes exactly; the checkpoint bitwise. After the first run the
gradients and the train step are held at the F32 alone (they meet it);
prefill and decode keep the scaled term (at the F32 alone their logits
and caches miss by up to 2.5e-6 on values of a few units). The driver's losses on a mesh
against one device rtol 1e-4 where no MoE splits tokens over data ranks
(tests/test_torch_dist_models.py's), the MoE archs only at dp = 1 (a
data rank's capacity and aux loss are its own tokens', as in the
reference, so its losses differ from one device's by design).
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import (  # noqa: E402
    TransformerConfig as JTransformerConfig)
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.models.transformer import named_from_tree  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
MESH_IDS = [f"{dp}x{tp}" for dp, tp in ranks.MESHES]
CASES = list(ranks.LM_DIST_CASES)
LOSS = dict(rtol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-6)
SCALE = 1e-6


def _inputs() -> dict:
    inp = {}
    for i, (case, kw) in enumerate(ranks.LM_DIST_CASES.items()):
        jcfg = JTransformerConfig(**kw)
        params, _ = jtfm.init_params(jax.random.PRNGKey(i), jcfg)
        named = named_from_tree(jax.tree_util.tree_map(np.asarray, params))
        rng = np.random.RandomState(100 + i)
        for k, v in named.items():
            # norms and biases off their ones and zeros, so every
            # parameter reaches the outputs
            if "ln" in k or k.startswith("blocks.attn.b"):
                v = (v + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
            inp[f"{case}/p/{k}"] = v
        toks = rng.randint(0, kw["vocab_size"], (4, 16))
        labels = rng.randint(0, kw["vocab_size"], (4, 16))
        labels[0, :5] = -1
        labels[3, 7] = -1
        inp[f"{case}/tokens"] = toks.astype(np.int64)
        inp[f"{case}/labels"] = labels.astype(np.int64)
        inp[f"{case}/serve"] = rng.randint(
            0, kw["vocab_size"], (4, ranks.LM_SERVE["cache"])).astype(np.int64)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({mesh id: [each rank's results]}, the reference's results)."""
    work = str(tmp_path_factory.mktemp("lm_dist"))
    inp = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, os.pardir, "src"), env.get("PYTHONPATH", "")])
    ref = subprocess.run(
        [sys.executable, os.path.join(HERE, "jax_sharded_ref.py"), work,
         "lm"], env=env, capture_output=True, text=True, timeout=900)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    out = {}
    for mesh_id, shape in zip(MESH_IDS, ranks.MESHES):
        sub = os.path.join(work, mesh_id)
        os.makedirs(sub)
        np.savez(os.path.join(sub, "inputs.npz"), **inp)
        out[mesh_id] = ranks.spawn("lm_functions", shape, sub)
    return out, dict(np.load(os.path.join(work, "ref.npz")))


def _close(got, want, what, scale=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = F32["atol"] + scale * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=F32["rtol"], atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_loss_and_gradients_match_the_reference(runs, mesh_id, case):
    out, ref = runs
    pre = f"{mesh_id}/{case}/"
    keys = sorted(k[len(pre + "grad/"):] for k in ref
                  if k.startswith(pre + "grad/"))
    assert keys
    for r in out[mesh_id]:
        np.testing.assert_allclose(r[f"{case}/loss"], ref[pre + "loss"],
                                   **LOSS)
        assert sorted(k[len(case + "/grad/"):] for k in r
                      if k.startswith(case + "/grad/")) == keys
        for k in keys:
            _close(r[f"{case}/grad/{k}"], ref[f"{pre}grad/{k}"], k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_one_train_step_matches_the_reference(runs, mesh_id, case):
    out, ref = runs
    pre = f"{mesh_id}/{case}/"
    keys = sorted(k[len(pre):] for k in ref if k.startswith(pre + "step/"))
    assert any("/opt/" in k for k in keys)
    for r in out[mesh_id]:
        np.testing.assert_allclose(r[f"{case}/step_loss"],
                                   ref[pre + "step_loss"], **LOSS)
        np.testing.assert_allclose(r[f"{case}/grad_norm"],
                                   ref[pre + "grad_norm"], **LOSS)
        assert sorted(k[len(case) + 1:] for k in r
                      if k.startswith(case + "/step/")) == keys
        for k in keys:
            _close(r[f"{case}/{k}"], ref[pre + k], k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_per_rank_shapes_are_the_references_shards(runs, mesh_id, case):
    out, ref = runs
    pre = f"{mesh_id}/{case}/"
    keys = sorted(k[len(pre):] for k in ref if "shape/" in k
                  and k.startswith(pre))
    assert any(k.startswith("shape/opt/") for k in keys)
    assert any(k.endswith("shape/cache") for k in keys)
    for r in out[mesh_id]:
        got = sorted(k[len(case) + 1:] for k in r
                     if k.startswith(case + "/") and "shape/" in k)
        assert got == keys
        for k in keys:
            assert tuple(r[f"{case}/{k}"]) == tuple(ref[pre + k]), k


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_prefill_and_decode_match_the_reference(runs, mesh_id, case):
    out, ref = runs
    pre = f"{mesh_id}/{case}/"
    s0, c = ranks.LM_SERVE["prompt"], ranks.LM_SERVE["cache"]
    for bsz in ranks.lm_serve_batches(case):
        b = f"b{bsz}/"
        for rank, r in enumerate(out[mesh_id]):
            r0, n = r[f"{case}/{b}rows"]
            _close(r[f"{case}/{b}prefill"],
                   ref[pre + b + "prefill"][r0:r0 + n], f"{b}prefill",
                   SCALE)
            _close(r[f"{case}/{b}prefill_k"], ref[f"{pre}{b}prefill_k/{rank}"],
                   f"{b}prefill cache", SCALE)
            for pos in range(s0, c):
                _close(r[f"{case}/{b}decode{pos}"],
                       ref[f"{pre}{b}decode{pos}"][r0:r0 + n],
                       f"{b}decode {pos}", SCALE)
            for n_ in "kv":
                _close(r[f"{case}/{b}cache_{n_}"],
                       ref[f"{pre}{b}cache_{n_}/{rank}"], f"{b}cache {n_}",
                       SCALE)


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_factored_state_reshards_bitwise(runs, mesh_id):
    """kimi-like's adafactor state after its step (vr and vc of its
    128 x 128 matrices), gathered whole in the JAX layout (which the
    step test holds against the reference's) and `reshard`ed back onto
    the mesh: every rank's blocks bit for bit."""
    out, ref = runs
    for r in out[mesh_id]:
        assert int(r["kimi-like/n_factored"]) > 0
        assert bool(r["kimi-like/reshard_bitwise"])


# ------------------------------------------------------------ the plan ---
class _Mesh:
    """A production mesh's sizes alone (no 256 devices)."""

    def __init__(self, shape):
        self.axis_names = ("data", "model") if len(shape) == 2 \
            else ("pod", "data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _ref_bytes(arch_id, shape_name, mesh_shape):
    """The reference's per-rank bytes of the same leaves, from its own
    abstract trees and `sanitized_pspec`."""
    from repro.common.shardlib import axes_prod, sanitized_pspec
    from repro.configs.registry import get_arch as jget_arch
    from repro.launch.programs import _lm_rules, abstract_init, lm_input_specs
    from repro.train.optim import make_optimizer, opt_logical_axes
    arch = jget_arch(arch_id)
    shape = arch.shape(shape_name)
    mesh = _Mesh(mesh_shape)
    rules = _lm_rules(arch, shape, mesh)
    abs_p, lg = abstract_init(lambda: jtfm.init_params(
        jax.random.PRNGKey(0), arch.model))

    def total(abs_tree, lg_tree):
        leaves, treedef = jax.tree_util.tree_flatten(abs_tree)
        n = 0
        for leaf, names in zip(leaves, treedef.flatten_up_to(lg_tree)):
            spec = sanitized_pspec(leaf.shape, tuple(names), rules, mesh)
            blk = [d // axes_prod(e, mesh) for d, e in zip(leaf.shape, spec)]
            n += int(np.prod(blk)) * leaf.dtype.itemsize
        return n

    out = {"params": total(abs_p, lg), "opt_state": 0, "cache": 0}
    if shape.kind == "train":
        opt = make_optimizer(arch.optimizer)
        abs_o = jax.eval_shape(opt.init, abs_p)
        out["opt_state"] = total(abs_o, opt_logical_axes(
            arch.optimizer, lg, params=abs_p))
    if shape.kind == "decode":
        args, logical = lm_input_specs(arch, shape)
        out["cache"] = total(args["cache"], logical["cache"])
    out["total"] = out["params"] + out["opt_state"] + out["cache"]
    return out


@pytest.mark.parametrize("mesh_shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch_id", ["smollm-135m", "gemma2-2b",
                                     "qwen2-moe-a2.7b", "qwen2.5-32b",
                                     "kimi-k2-1t-a32b"])
def test_rank_bytes_are_the_references(arch_id, mesh_shape):
    from repro_torch.launch.programs import rank_bytes
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert rank_bytes(arch_id, shape, mesh_shape) == _ref_bytes(
            arch_id, shape, mesh_shape), shape


# ------------------------------------------------------------ the driver ---
@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """({mesh id: [each rank's results]}, one device's losses, the
    checkpoint directory saved at (2, 2))."""
    from repro_torch.launch import train
    work = str(tmp_path_factory.mktemp("lm_driver"))
    ckpt_dir = os.path.join(work, "ckpt")
    out = {}
    for mesh_id, shape in sorted(zip(MESH_IDS, ranks.MESHES),
                                 key=lambda m: m[0] != "2x2"):
        sub = os.path.join(work, mesh_id)
        os.makedirs(sub)
        out[mesh_id] = ranks.spawn(
            "lm_driver", shape, sub, ckpt_dir if mesh_id == "2x2" else "",
            ckpt_dir if mesh_id == "1x2" else "")
        if mesh_id == "2x2":
            shutil.copytree(ckpt_dir, ckpt_dir + "_saved")
    torch.set_num_threads(1)
    base = {a: train.run(a, steps=3, device="cpu", log_every=100)["losses"]
            for a in ranks.LM_DRIVER_ARCHS}
    base["gemma2-2b_mb2"] = train.run("gemma2-2b", steps=3, device="cpu",
                                      log_every=100,
                                      microbatches=2)["losses"]
    return out, base, ckpt_dir + "_saved"


@pytest.mark.parametrize("arch_id", ranks.LM_DRIVER_ARCHS)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_driver_trains_an_lm_on_a_mesh(driver_runs, mesh_id, arch_id):
    out, base, _ = driver_runs
    dp = int(mesh_id.split("x")[0])
    for r in out[mesh_id]:
        assert tuple(r[f"{arch_id}_mesh"]) == tuple(
            int(v) for v in mesh_id.split("x"))
        losses = r[f"{arch_id}_losses"]
        assert losses.shape == (3,) and np.isfinite(losses).all()
        if arch_id == "gemma2-2b" or dp == 1:
            np.testing.assert_allclose(losses, base[arch_id], rtol=1e-4)


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_driver_draws_each_ranks_blocks_of_the_whole_init(driver_runs,
                                                         mesh_id):
    """`init_params(blocks=LMPlacement.blocks())`, which the placed
    driver runs so that no rank holds a whole tensor, gives each rank
    the whole init's block of every parameter, bit for bit (gemma2-2b's
    and kimi-k2's reduced LMs; some blocks smaller than the whole)."""
    out, _, _ = driver_runs
    for r in out[mesh_id]:
        assert bool(r["init_blocks_bitwise"])


@pytest.mark.parametrize("arch_id", ["qwen2.5-32b", "kimi-k2-1t-a32b",
                                     "qwen2-moe-a2.7b"])
def test_full_width_dist_run_is_reckoned_a_rank(arch_id, tmp_path):
    """The placed driver's fit check reckons one rank's blocks
    (`plan_bytes`) from shapes alone: at full width on the (16, 16)
    production mesh it passes for the three trainings one device
    refuses; on a world of one (a (1, 1) mesh, gloo) `run(dist_run=True)`
    refuses before it allocates, naming that rank's bytes."""
    import torch.distributed as dist
    from repro_torch.configs.base import LMShape
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.programs import plan_bytes
    arch = get_arch(arch_id)
    with pytest.raises(ValueError, match="queue 1, item 9"):
        train.check_fits_one_device(arch, arch.model)
    train.check_fits_a_rank(arch, arch.model, (16, 16))
    one = plan_bytes(arch.model, arch.optimizer,
                     LMShape("train", "train", 1, 1), (1, 1))
    with pytest.raises(ValueError) as err:
        train.run(arch_id, steps=1, full=True, device="cpu", dist_run=True,
                  mesh_shape=(1, 1), rank=0, world_size=1,
                  init_method=f"file://{tmp_path}/pg")
    assert f"on the (1, 1) mesh holds {one['total'] / 1e9:.2f} GB a rank " \
        f"({one['params']} bytes of parameters" in str(err.value)
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_driver_microbatches_on_a_mesh(driver_runs, mesh_id):
    """gemma2-2b in 2 microbatches on the mesh (each data rank's rows its
    slices of the two, `train.data_rows`) against one device's 2
    microbatches: the same losses (rtol 1e-4, as above)."""
    out, base, _ = driver_runs
    for r in out[mesh_id]:
        np.testing.assert_allclose(r["gemma2-2b_mb2_losses"],
                                   base["gemma2-2b_mb2"], rtol=1e-4)


def test_lm_checkpoint_restores_on_another_mesh_and_in_jax_bitwise(
        driver_runs):
    """The (2, 2) run's checkpoint (kimi-k2's reduced LM with its
    adafactor state, gathered to rank 0; at the driver's d_model of 64 no
    matrix factors, so every state is a full v: the factored vr and vc
    cross meshes in `test_factored_state_reshards_bitwise`) placed onto
    (1, 2) by `reshard`: each block the saved array's, gathered back bit
    for bit, and trained on; the JAX package's own `restore` reads the
    same arrays bit for bit, at the reference's whole shapes."""
    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as ckpt
    out, _, saved = driver_runs
    for r in out["1x2"]:
        assert bool(r["restore_bitwise"]) and bool(r["restore_shards"])
        assert int(r["restore_n_state"]) > 0
        assert tuple(r["table_local_shape"]) == (256, 64)
        assert len(r["resumed_losses"]) == 2
        assert np.isfinite(r["resumed_losses"]).all()
    for r in out["2x2"]:
        np.testing.assert_array_equal(r["saved_losses"],
                                      r["kimi-k2-1t-a32b_losses"])
    jtree, jman = jckpt.restore(saved)
    tree, man = ckpt.restore(saved, device="cpu")
    assert jman["step"] == man["step"] == 2
    jflat = dict(jax.tree_util.tree_leaves_with_path(jtree))
    flat = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tree)))
    assert set(jflat) == set(flat) and len(flat) > 20
    assert any("'f'" in jax.tree_util.keystr(k) for k in flat)
    for k, v in flat.items():
        assert np.asarray(jflat[k]).shape == v.shape, k
        np.testing.assert_array_equal(np.asarray(jflat[k]), v)


def test_placed_lm_at_one_rank_is_the_unplaced_bitwise(tmp_path):
    """At a mesh of one rank the placed layers are the plain ones: the
    forward under no_grad and the loss and gradients with remat "none"
    (the layers outside a checkpoint) bit for bit the unplaced model's,
    gemma-like and qwen-moe-like."""
    import torch.distributed as dist
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    mesh_lib.init_distributed("cpu", rank=0, world_size=1,
                              init_method=f"file://{tmp_path}/pg")
    try:
        mesh = mesh_lib.make_mesh(1, 1, "cpu")
        for case in ("gemma-like", "qwen-moe-like"):
            cfg = TransformerConfig(**ranks.LM_DIST_CASES[case]).replace(
                remat="none")
            model = tfm.init_params(cfg, seed=4, device="cpu")
            pl = LMPlacement(mesh, cfg)
            gen = torch.Generator().manual_seed(5)
            batch = {k: torch.randint(0, cfg.vocab_size, (2, 16),
                                      generator=gen)
                     for k in ("tokens", "labels")}
            with torch.no_grad():
                assert torch.equal(
                    tfm.forward(model, batch["tokens"], placement=pl)[0],
                    tfm.forward(model, batch["tokens"])[0]), case
            params = list(model.parameters())
            got = tfm.loss_fn(model, batch, placement=pl)[0]
            want = tfm.loss_fn(model, batch)[0]
            assert torch.equal(got, want), case
            for a, b in zip(torch.autograd.grad(got, params),
                            torch.autograd.grad(want, params)):
                assert torch.equal(a, b), case
    finally:
        dist.destroy_process_group()
