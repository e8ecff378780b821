"""The port's driver on gloo ranks (`run(..., dist_run=True)`, the path
`torchrun ... -m repro_torch.launch.train --dist` takes): 5 steps of
dlrm-criteo, BERT4Rec and wide-deep at reduced widths, and of
graphsage-reddit's full_graph_sm through the partitioned loss, at the
(data, model) meshes (1, 2), (2, 1) and (2, 2), against the port's own
one-device runs (the same global batch, the same seed); dlrm-criteo's
replicated gradients all-reduced in bf16 and int8 too; a checkpoint
saved at (2, 2), gathered to rank 0 in the JAX layout, restored at (1, 2)
through `reshard` bit for bit and trained on; and
examples/torch_elastic_rescale.py, whose plans are the reference's.

Tolerances, stated before the first run: the f32 archs' losses rtol
1e-4 (each data rank's loss is over its slice, and the gradients are
averaged over the data ranks in another order); dlrm-criteo's (bf16
parameters: the averaged bf16 gradients round once more) rtol 1e-3, and
with bf16 or int8 compression rtol 1e-3 (the learning rate is in its
warm-up, 1e-5 a step, so a compressed gradient moves the loss by less).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.train import elastic as jelastic  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
import torch_dist_ranks as ranks  # noqa: E402

MESH_IDS = [f"{dp}x{tp}" for dp, tp in ranks.MESHES]
RTOL = {"dlrm-criteo": 1e-3, "bert4rec": 1e-4, "wide-deep": 1e-4,
        "graphsage-reddit": 1e-4, "graphsage-edges": 1e-4, "xdeepfm": 1e-4,
        "dien": 1e-4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({mesh id: [each rank's results]}, {arch: one-device losses, and
    "resumed": the one-device resume of the (2, 2) checkpoint})."""
    work = str(tmp_path_factory.mktemp("dist_models"))
    ckpt_dir = os.path.join(work, "ckpt")
    out = {}
    for mesh_id, shape in sorted(zip(MESH_IDS, ranks.MESHES),
                                 key=lambda m: m[0] != "2x2"):
        sub = os.path.join(work, mesh_id)
        os.makedirs(sub)
        out[mesh_id] = ranks.spawn(
            "driver", shape, sub, ckpt_dir if mesh_id == "2x2" else "",
            ckpt_dir if mesh_id == "1x2" else "")
        if mesh_id == "2x2":
            shutil.copytree(ckpt_dir, ckpt_dir + "_one")
    torch.set_num_threads(1)
    base = {}
    for case, arch_id, shape, _ in ranks.DRIVER_ARCHS:
        shape = get_arch(arch_id).shape(shape) if shape else None
        base[case] = train.run(arch_id, steps=5, shape=shape,
                               device="cpu", log_every=100)["losses"]
    base["resumed"] = train.run("dlrm-criteo", steps=5, device="cpu",
                                ckpt_dir=ckpt_dir + "_one",
                                log_every=100)["losses"]
    return out, base


@pytest.mark.parametrize("arch_id", [c for c, *_ in ranks.DRIVER_ARCHS])
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_driver_losses_match_one_device(runs, mesh_id, arch_id):
    """`arch_id` is the case: graphsage-reddit's full graph partitioned
    (`partitioned=True`), graphsage-edges the same graph edge-sharded
    (the reference's default program)."""
    out, base = runs
    for r in out[mesh_id]:
        assert tuple(r[f"{arch_id}_mesh"]) == tuple(
            int(v) for v in mesh_id.split("x"))
        np.testing.assert_allclose(r[f"{arch_id}_losses"], base[arch_id],
                                   rtol=RTOL[arch_id])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_driver_compressed_gradients(runs, mode):
    out, base = runs
    for r in out["2x2"]:
        np.testing.assert_allclose(r[f"dlrm-criteo_{mode}_losses"],
                                   base["dlrm-criteo"], rtol=1e-3)


def test_checkpoint_saved_at_2x2_restores_at_1x2_bitwise(runs):
    """The (2, 2) run's checkpoint (tables sharded four ways and the dense
    layers' blocks, gathered to rank 0) placed onto (1, 2) by `reshard`:
    each rank's tables are half the rows, the MLP weights whose output
    dim divides split over the model axis, each shard (and each
    accumulator's) the saved array's block, and gathered back every
    parameter and accumulator is the saved one bit for bit; the
    resumed run's two steps are the one-device resume's of the same
    checkpoint (a resumed driver draws its batches from the stream's
    start, on one device as on a mesh)."""
    out, base = runs
    cfg = train.reduced_model(get_arch("dlrm-criteo"))
    for r in out["1x2"]:
        assert bool(r["restore_bitwise"]) and bool(r["restore_shards"])
        assert int(r["dense_split"]) > 0
        assert tuple(r["tables_local_shape"]) == (
            cfg.n_sparse, cfg.vocab_sizes[0] // 2, cfg.embed_dim)
        assert len(r["resumed_losses"]) == 2
        np.testing.assert_allclose(r["resumed_losses"], base["resumed"],
                                   rtol=1e-3)
    for r in out["2x2"]:
        np.testing.assert_array_equal(r["saved_losses"],
                                      r["dlrm-criteo_losses"][:3])


def test_elastic_example_runs_and_plans_as_the_reference(capsys):
    from examples import torch_elastic_rescale
    intune, auto, plans = torch_elastic_rescale.main(
        ticks=100, episodes=1, pretrain_ticks=20)
    assert len(intune) == len(auto) == 100
    coord = jelastic.ElasticCoordinator(n_devices=256, model_parallel=16)
    assert plans == [coord.recovery_plan(s) for s in (256, 192, 128, 60, 16)]
    assert "survivors -> mesh" in capsys.readouterr().out
