"""The recsys, DLRM and GNN programs placed on a mesh (launch/programs.
Placement, the driver's `build_step` on gloo ranks) against the
reference's own sharded programs (its `build_program` under its
in_shardings on four host devices, tests/jax_sharded_ref.py WORKDIR
placed), at the (data, model) meshes (1, 2), (2, 1) and (2, 2): the
reduced dlrm-criteo, wide-deep, xDeepFM (its CIN on each model rank's
rows), DIEN, BERT4Rec and GraphSAGE (the full graph edge-sharded, and a
minibatch), each from the same numpy weights (the reference's init,
carried across by each model's `named_from_tree`) and the same global
batch.

Tolerances, stated before the first run: the f32 losses rtol 1e-5; the
gathered whole gradients and one step's parameters rtol 1e-4, atol 1e-6
(the data ranks' partial sums, the model ranks' column blocks and the
lookups' shards add up in another order than GSPMD's program). The bf16
dlrm-criteo: its loss rtol 1e-3; its bf16 gradients rtol 1e-2 and atol 4
bf16 ulps of the leaf's largest magnitude (each bf16 rounding is 2^-8
relative, and a sum that ends near 0 keeps the ulps of its terms). Every
leaf's shard shape, and its optimizer state's, is the reference's
exactly.

The step is held in f32, the DLRM's by the same config in f32
(`dlrm-criteo-f32`): the bf16 one's first row-wise adagrad step divides
each gradient by its own magnitude (g / sqrt(g^2 + 1e-10)), so an element
whose bf16 gradient cancels to a few ulps near 1e-5 (a bias gradient of
-3.05e-5 against the reference's -6.10e-5, both within the gradients'
tolerance) moves its update by several percent, which no bound on the
gradients' error carries over to the parameters.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data.graphs import full_graph_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import dlrm, gnn, recsys  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH_IDS = [f"{dp}x{tp}" for dp, tp in ranks.MESHES]
CASES = list(ranks.PLACED_CASES)
BF16 = {"dlrm-criteo"}


def _lib(arch_id):
    return {"dlrm": dlrm, "gnn": gnn}.get(get_arch(arch_id).family, recsys)


def _case_inputs(case):
    """(npz entries, {port name: the reference's key path}) of a case:
    the reference's init of its reduced config from a seed, in the
    reference's key paths ("j/") and the port's names ("t/"), and the
    driver's whole batch ("b/")."""
    arch_id = ranks.PLACED_CASES[case][0]
    arch, jarch = get_arch(arch_id), j_get_arch(arch_id)
    jcfg = ranks.placed_config(case, jtrain.reduced_model(jarch))
    cfg = ranks.placed_config(case, train.reduced_model(arch))
    shape = ranks.placed_shape(case, base)
    key = jax.random.PRNGKey(7)
    if arch.family == "dlrm":
        params, _ = jdlrm.init_params(key, jcfg)
    elif arch.family == "gnn":
        params, _ = jgnn.init_params(key, jcfg, d_feat=shape.d_feat)
    else:
        params, _ = jrecsys.INIT[jcfg.name](key, jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    keystr = jax.tree_util.keystr
    npz = {f"{case}/j/{keystr(p)}": v for p, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    lib = _lib(arch_id)
    npz.update({f"{case}/t/{k}": np.asarray(v)
                for k, v in lib.named_from_tree(params).items()})
    paths = jax.tree_util.tree_map_with_path(lambda p, _: keystr(p), params)
    # a transposed path is a 1-element array of the string
    names = {k: str(np.asarray(v).reshape(-1)[0])
             for k, v in lib.named_from_tree(paths).items()}
    rng = np.random.RandomState(0)
    if shape.kind == "full_graph":
        whole = full_graph_batch(shape, cfg.n_classes, rng)
    else:
        batch = shape.batch if shape.kind == "train" else shape.batch_nodes
        whole = {k: v.numpy() for k, v in train.make_batch_fn(
            arch, cfg, batch, rng, shape=shape, device="cpu")().items()}
    npz.update({f"{case}/b/{k}": v for k, v in whole.items()})
    return npz, names


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({mesh id: [each rank's results]}, the reference's results, {case:
    {port name: key path}})."""
    work = tmp_path_factory.mktemp("placed")
    npz, names = {}, {}
    for case in CASES:
        entries, names[case] = _case_inputs(case)
        npz.update(entries)
    np.savez(work / "inputs.npz", **npz)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_ref.py"),
         str(work), "placed"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    log = {}
    drain = threading.Thread(
        target=lambda: log.update(out=ref.communicate(timeout=600)[0]))
    drain.start()
    out = {}
    for mesh_id, mesh_shape in zip(MESH_IDS, ranks.MESHES):
        d = work / mesh_id
        d.mkdir()
        (d / "inputs.npz").symlink_to(work / "inputs.npz")
        out[mesh_id] = ranks.spawn("placed_functions", mesh_shape, str(d))
    drain.join()
    assert ref.returncode == 0, log["out"][-4000:]
    return out, dict(np.load(work / "ref.npz")), names


def _port_layout(name, a):
    """The reference's (in, out) layout of a port leaf: an nn.Linear
    weight (out, in) transposed."""
    return a.T if name.endswith(".weight") else a


def _close(case, got, want, name, f32_tol=(1e-4, 1e-6)):
    if case in BF16:
        atol = 4 * 2.0 ** -8 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=atol,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=f32_tol[0],
                                   atol=f32_tol[1], err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_placed_shard_shapes_equal_the_reference(runs, mesh_id, case):
    """Every parameter's block on every rank, and every optimizer-state
    tensor's, has the shape of the reference's shard of that leaf (an
    nn.Linear weight's transposed)."""
    out, ref, names = runs
    for r in out[mesh_id]:
        for name, path in names[case].items():
            got = tuple(r[f"{case}/shape/params/{name}"])
            want = tuple(ref[f"{mesh_id}/{case}/shape/params/{path}"])
            got = got[::-1] if name.endswith(".weight") else got
            assert got == want, name
            for sk in [k for k in r if k.startswith(f"{case}/shape/opt/")
                       and k.endswith(f"/{name}")]:
                key = sk[len(f"{case}/shape/opt/"):-len(name) - 1]
                got = tuple(r[sk])
                got = got[::-1] if name.endswith(".weight") and \
                    len(got) == 2 else got
                assert got == tuple(ref[f"{mesh_id}/{case}/shape/opt/"
                                        f"['{key}']{path}"]), (key, name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_placed_loss_equals_the_reference(runs, mesh_id, case):
    out, ref, _ = runs
    want = ref[f"{mesh_id}/{case}/loss"]
    for r in out[mesh_id]:
        np.testing.assert_allclose(r[f"{case}/loss"], want,
                                   rtol=1e-3 if case in BF16 else 1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_placed_gradients_equal_the_reference(runs, mesh_id, case):
    """The reduced gradients of every leaf, gathered whole on every rank,
    are the reference's gradient of the global loss."""
    out, ref, names = runs
    for r in out[mesh_id]:
        for name, path in names[case].items():
            _close(case, _port_layout(name, r[f"{case}/grad/{name}"]),
                   ref[f"{mesh_id}/{case}/grad/{path}"], name)


@pytest.mark.parametrize("case", [c for c in CASES if c not in BF16])
@pytest.mark.parametrize("mesh_id", MESH_IDS)
def test_placed_step_equals_the_reference(runs, mesh_id, case):
    """One train step (the arch's optimizer at the reference program's
    learning rate, step 50 of the warm-up): every parameter gathered
    whole is the reference's step's."""
    out, ref, names = runs
    for r in out[mesh_id]:
        for name, path in names[case].items():
            _close(case, _port_layout(name, r[f"{case}/step/{name}"]),
                   ref[f"{mesh_id}/{case}/step/{path}"], name)


def test_placed_profile_holds_the_placed_step_to_the_unplaced_one():
    """benchmarks/torch_placed_profile.py on the CPU (gloo, the reduced
    wide-deep at its train_batch): at a world of one the placed step's
    losses are the unplaced step's bit for bit, turn after turn (every
    collective a copy, the gathered operands contiguous as on one
    device), and only the placed step's profile holds collectives."""
    from benchmarks import torch_placed_profile as prof
    rec = prof.run("wide-deep", steps=2, top=5, device="cpu")
    placed, unplaced = rec["losses"]["placed"], rec["losses"]["unplaced"]
    assert len(placed) == 3 and np.isfinite(placed).all()
    assert placed == unplaced
    assert rec["placed"]["collectives"] and not rec["unplaced"]["collectives"]
    assert rec["reduced"]
