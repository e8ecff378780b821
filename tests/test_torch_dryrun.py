"""The dry run of the port (launch/dryrun.py, launch/step_analysis.py,
launch/programs.input_specs and build_program, the kernels on meta) against
the JAX package and against the port's own real runs.

Each plan runs in a fresh interpreter (a plan mesh is the process's
default process group): one subprocess plans every port cell below
(PLANS), one runs the reference's programs on four host devices
(tests/jax_sharded_ref.py WORKDIR dryrun), and gloo ranks run the same
placed steps for real (tests/torch_dist_ranks.dryrun_ranks), all started
together by the module's fixture.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.launch import programs as jprograms  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import dlrm as jdlrm  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro_torch.configs.registry import get_arch, list_archs  # noqa: E402
from repro_torch.kernels import embedding_bag as eb  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import programs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import dlrm, recsys  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
LM_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b")
MESHES = ranks.MESHES
C = 40          # retrieval candidates: C / (data ranks x chunks) whole

# the port's plans: the reduced LMs' bytes a rank, the reduced dlrm-criteo's
# leaves, the collective schedules, the reduced smollm's dot FLOPs on one
# device, smollm-135m's train_4k at full width on (16, 16), and the CLI
PLANS = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
from repro_torch.configs.base import LMShape
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, train
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.programs import build_program, rank_bytes
from repro_torch.launch.step_analysis import analyze, tensors_of
sys.path.insert(0, sys.argv[2])
from torch_dist_ranks import DRYRUN_TRAIN, dryrun_shape
out = {"lm": {}, "dlrm": {}, "sched": {}, "flops": {}}

def reduced(arch_id):
    arch = get_arch(arch_id)
    return dataclasses.replace(arch, model=train.reduced_model(arch))

for dp, tp in ((1, 1), (1, 2), (2, 1), (2, 2)):
    mesh = mesh_lib.make_plan_mesh((dp, tp))
    tag = f"{dp}x{tp}"
    if (dp, tp) == (1, 1):
        for kind in ("train", "prefill"):
            p = build_program(reduced("smollm-135m"),
                              LMShape("x", kind, 64, 8), mesh)
            out["flops"][kind] = analyze(p.fn, *p.args)["dot_flops"]
        mesh_lib.end_plan_mesh()
        continue
    for arch_id in ("smollm-135m", "qwen2-moe-a2.7b"):
        for kind, b in (("train", 8), ("decode", 4)):
            p = build_program(reduced(arch_id), LMShape("x", kind, 64, b),
                              mesh)
            out["lm"][f"{arch_id}/{kind}/{tag}"] = p.memory
    for arch_id, kind, b in DRYRUN_TRAIN:
        p = build_program(reduced(arch_id), dryrun_shape(kind, b), mesh)
        r = analyze(p.fn, *p.args)
        out["sched"][f"{arch_id}/{tag}"] = r["collective_calls"]
        if arch_id == "dlrm-criteo":
            out["dlrm"][tag] = {
                "params": {k: t.numel() * t.element_size()
                           for k, t in p.model.named_parameters()},
                "acc": {k: t.numel() * t.element_size()
                        for k, t in p.opt_state["acc"].items()},
                "replicated": [n for n, _ in p.meta["replicated"]],
                "memory": p.memory, "launches": r["launches"]}
    mesh_lib.end_plan_mesh()
arch = get_arch("smollm-135m")
mesh = mesh_lib.make_plan_mesh((16, 16))
p = build_program(arch, arch.shape("train_4k"), mesh)
r = analyze(p.fn, *p.args)
out["full"] = {"memory": p.memory, "peak": r["peak_bytes"],
               "rank_bytes": rank_bytes("smollm-135m", "train_4k")}
mesh_lib.end_plan_mesh()
out["cli"] = [dryrun.main(["--arch", "graphsage-reddit", "--mesh", "2,2",
                           "--out", sys.argv[1]]),
              dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                           "--mesh", "2,2", "--out", sys.argv[1]])]
print(json.dumps(out))
"""


# --------------------------------------------------------------- fixture ---
def _reduced_jax_params(arch_id):
    jarch = j_get_arch(arch_id)
    jcfg = jtrain.reduced_model(jarch)
    if arch_id == "dlrm-criteo":
        params, _ = jdlrm.init_params(jax.random.PRNGKey(3), jcfg)
        named = dlrm.named_from_tree(jax.tree_util.tree_map(np.asarray,
                                                            params))
    else:
        params, _ = jrecsys.INIT[jcfg.name](jax.random.PRNGKey(3), jcfg)
        named = recsys.named_from_tree(jax.tree_util.tree_map(np.asarray,
                                                              params))
    return jcfg, params, named


def _retrieval_inputs():
    """{arch: (jcfg, JAX params, user, candidates)}, and the npz entries
    the rank job reads."""
    npz, out = {}, {}
    rng = np.random.RandomState(30)
    for arch_id in ranks.DRYRUN_RETRIEVAL:
        jcfg, params, named = _reduced_jax_params(arch_id)
        cfg = train.reduced_model(get_arch(arch_id))
        stream = synthetic.CriteoStream(
            n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
            vocab=cfg.vocab_sizes[0], multi_hot=cfg.multi_hot, seed=5)
        user = stream.feature_udf(stream.raw_block(1))
        user = {k: v for k, v in user.items() if k != "label"}
        cand = rng.randint(0, 3 * cfg.vocab_sizes[0], C).astype(np.int32)
        npz.update({f"{arch_id}/p/{k}": np.asarray(v)
                    for k, v in named.items()})
        npz.update({f"{arch_id}/u/{k}": v for k, v in user.items()})
        npz[f"{arch_id}/cand"] = cand
        out[arch_id] = (jcfg, params, user, cand)
    return out, npz


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's plans, the reference's programs and the gloo ranks, run
    side by side."""
    work = tmp_path_factory.mktemp("dryrun")
    retrieval, npz = _retrieval_inputs()
    np.savez(work / "inputs.npz", **npz)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    plans = subprocess.Popen(
        [sys.executable, "-c", PLANS, str(work / "cli"),
         str(ROOT / "tests")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_sharded_ref.py"),
         str(work), "dryrun"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    outs = {}

    def drain(name, proc):
        outs[name] = proc.communicate(timeout=240)
    threads = [threading.Thread(target=drain, args=a)
               for a in (("plans", plans), ("ref", ref))]
    for t in threads:
        t.start()
    gloo = {}
    for mesh_shape in MESHES:
        d = work / f"ranks{mesh_shape[0]}x{mesh_shape[1]}"
        d.mkdir()
        (d / "inputs.npz").symlink_to(work / "inputs.npz")
        gloo[mesh_shape] = ranks.spawn("dryrun_ranks", mesh_shape, str(d))
    for t in threads:
        t.join()
    assert plans.returncode == 0, outs["plans"][1][-4000:]
    assert ref.returncode == 0, outs["ref"][0][-4000:]
    with open(work / "dryrun_ref.json") as f:
        jref = json.load(f)
    return {"plan": json.loads(outs["plans"][0].strip().splitlines()[-1]),
            "ref": jref, "gloo": gloo, "retrieval": retrieval,
            "cli": work / "cli"}


# ---------------------------------------------------------- input specs ---
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_input_specs_equal_the_reference(arch_id, shape):
    """Every cell's arguments: the reference's tree, shapes and dtypes."""
    want = jprograms.input_specs(j_get_arch(arch_id), shape)
    got = programs.input_specs(get_arch(arch_id), shape)

    def flat(node, prefix=""):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from flat(node[k], f"{prefix}/{k}")
        else:
            yield prefix, node
    w = [(k, tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat(want)]
    g = [(k, v.shape, str(v.dtype).replace("torch.", ""))
         for k, v in flat(got)]
    assert g == w
    assert all(len(v.axes) == len(v.shape) for _, v in flat(got))


def test_skipped_cells_and_reasons_equal_the_reference():
    got = {(a, s.name): get_arch(a).is_skipped(s.name) for a in list_archs()
           for s in get_arch(a).shapes}
    want = {(a, s.name): j_get_arch(a).is_skipped(s.name)
            for a in list_archs() for s in j_get_arch(a).shapes}
    assert got == want
    assert sum(r is not None for r in got.values()) == 4
    assert len(got) == 44


# ---------------------------------------------------------- bytes a rank ---
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_bytes_a_rank_equal_the_compiled_reference(runs, arch_id,
                                                      mesh_shape):
    """The reduced LM at train (seq 64, batch 8) and decode (batch 4,
    the cache's positions over the data axes): the plan's parameter,
    optimizer-state and cache bytes a rank against the reference's
    compiled argument_size_in_bytes less its input bytes (tokens and
    labels, or tokens and pos) and its step scalar. Neither package's
    adam keeps a step count in its state: there is no scalar to name."""
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    for kind in ("train", "decode"):
        key = f"{arch_id}/{kind}/{tag}"
        mem, want = runs["plan"]["lm"][key], runs["ref"]["lm"][key]
        groups = [sum(b for b, _ in g.values()) for g in want["groups"]]
        assert sum(groups) == want["argument_size_in_bytes"]
        if kind == "train":
            params, opt, step, inputs = groups
            assert step == 4 and inputs == mem["inputs"]
            assert (mem["params"], mem["opt_state"]) == (params, opt)
            assert mem["params"] + mem["opt_state"] == \
                want["argument_size_in_bytes"] - inputs - step
        else:
            params, cache, tokens, pos = groups
            assert pos == 4 and tokens == mem["inputs"]
            assert (mem["params"], mem["cache"]) == (params, cache)
            assert mem["params"] + mem["cache"] == \
                want["argument_size_in_bytes"] - tokens - pos


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_dlrm_table_bytes_a_rank_equal_the_reference(runs, mesh_shape):
    """The reduced dlrm-criteo with tp_lookup: its row-sharded tables and
    their row-wise adagrad state a rank equal the reference's shards;
    the dense layers, which the reference's rules shard over the model
    axis (`mlp`) and the data axes (`fsdp`), are the leaves the port
    replicates (Program.meta's `replicated`), and exactly those."""
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    plan, want = runs["plan"]["dlrm"][tag], runs["ref"]["dlrm"][tag]
    assert plan["params"]["tables"] == want["params"]["['tables']"][0]
    assert plan["acc"]["tables"] == \
        want["opt_state"]["['acc']['tables']"][0]
    assert want["params"]["['tables']"][1] == mesh_shape[0] * mesh_shape[1]
    # the reference's leaves split over more than one rank, by the port's
    # names (an nn.Linear's w transposed is its weight, b its bias)
    sharded = set()
    for path, (_, n) in want["params"].items():
        if n > 1 and path != "['tables']":
            part, i, leaf = path.strip("[]'").replace("']['", " ") \
                .replace("'][", " ").replace("]['", " ").split()
            sharded.add(f"{part}.{i}.{'weight' if leaf == 'w' else 'bias'}")
    assert set(plan["replicated"]) == sharded
    assert plan["launches"] == {"embedding_bag_fwd_local": 1,
                                "embedding_bag_bwd_local": 1,
                                "dot_interact_fwd": 1, "dot_interact_bwd": 1}


def test_full_width_smollm_plans_its_rank_bytes(runs):
    """smollm-135m at train_4k on the (16, 16) production mesh, at its
    published widths: the plan's parameter and adam bytes a rank are
    `rank_bytes`', its peak above them."""
    full = runs["plan"]["full"]
    want = full["rank_bytes"]
    assert full["memory"]["params"] == want["params"]
    assert full["memory"]["opt_state"] == want["opt_state"]
    assert full["peak"] > want["total"] + full["memory"]["inputs"]


# ------------------------------------------------------------- dot FLOPs ---
# the port's eager step against the reference's loop-aware HLO count: the
# same matmuls, remat's recompute included on both sides. The tolerance
# is 0: at this config they agree to the FLOP (PERF.md, ratio 1.0)
FLOPS_RTOL = 0.0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dot_flops_match_the_reference_hlo_count(runs, kind):
    """The reduced smollm-135m (train: seq 64, batch 8; prefill) on one
    device: the plan's dot FLOPs within FLOPS_RTOL of
    `hlo_analysis.analyze` of the reference's compiled module."""
    got, want = runs["plan"]["flops"][kind], runs["ref"]["hlo"][kind]
    assert abs(got - want) <= FLOPS_RTOL * want, got / want


# ---------------------------------------------------- collective schedule ---
def _multiset(calls):
    return sorted((c["op"], c["group"], tuple(c["shape"]), c["dtype"],
                   c["site"], c["count"], c["bytes"]) for c in calls)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch_id", [a for a, _, _ in ranks.DRYRUN_TRAIN])
def test_collective_schedule_equals_real_gloo_ranks(runs, arch_id,
                                                    mesh_shape):
    """The plan's collectives of one train step (op, group, operand shape
    and dtype, call site, count, bytes) equal what real gloo ranks record
    through the same hook, every rank alike; the plan has some."""
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    plan = _multiset(runs["plan"]["sched"][f"{arch_id}/{tag}"])
    real = [_multiset(json.loads(str(r[f"sched/{arch_id}"])))
            for r in runs["gloo"][mesh_shape]]
    assert plan and all(r == plan for r in real)
    ops_seen = {op for op, *_ in plan}
    assert ops_seen <= {"all-reduce", "all-gather", "reduce-scatter"}
    if arch_id == "dlrm-criteo" and mesh_shape[0] > 1:
        assert {"all-gather", "reduce-scatter"} <= ops_seen


# ------------------------------------------------------ placed retrieval ---
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch_id", ranks.DRYRUN_RETRIEVAL)
def test_placed_retrieval_equals_unplaced_and_the_reference(
        runs, arch_id, mesh_shape):
    """score_candidates(mesh=) on gloo ranks: every rank holds all C
    scores, equal to the unplaced scores of the same model (dlrm-criteo
    bitwise: its bags of one are copies of rows however the shards add
    up; wide-deep's bags of 4 ids sum over the shards in another order,
    rtol 1e-5 / atol 1e-6), and those equal the reference's
    score_candidates (its retrieval tests' tolerances: dlrm-criteo's bf16
    within 2 ulps of the largest score, wide-deep's f32 rtol 1e-5 / atol
    1e-6); the tables were this rank's shard."""
    jcfg, params, user, cand = runs["retrieval"][arch_id]
    lib = jdlrm if arch_id == "dlrm-criteo" else jrecsys
    want = np.asarray(lib.score_candidates(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        {k: jnp.asarray(v) for k, v in user.items()}, jnp.asarray(cand),
        chunks=ranks.DRYRUN_CHUNKS)).astype(np.float32)
    n = mesh_shape[0] * mesh_shape[1]
    for r in runs["gloo"][mesh_shape]:
        placed, plain = r[f"placed/{arch_id}"], r[f"unplaced/{arch_id}"]
        assert placed.shape == (C,)
        if arch_id == "dlrm-criteo":
            np.testing.assert_array_equal(placed, plain)
        else:
            np.testing.assert_allclose(placed, plain, rtol=1e-5, atol=1e-6)
        assert r[f"shard/{arch_id}"][1] * n == \
            train.reduced_model(get_arch(arch_id)).vocab_sizes[0]
        if arch_id == "dlrm-criteo":
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            assert np.abs(plain - want).max() <= 2 * ulp
        else:
            np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ meta route ---
BF16 = torch.bfloat16


def _meta(*ts):
    return tuple(torch.empty_like(t, device="meta") for t in ts)


def _case_inputs():
    g = torch.Generator().manual_seed(0)
    tables = torch.randn((3, 40, 16), generator=g)
    ids = torch.randint(0, 40, (9, 3, 2), generator=g, dtype=torch.int32)
    d_bag = torch.randn((9, 3, 16), generator=g)
    feats = torch.randn((9, 6, 8), generator=g)
    d_dot = torch.randn((9, 15), generator=g)
    neigh = torch.randn((12, 5, 8), generator=g)
    w = torch.randn((8, 3), generator=g)
    table = torch.randn((40, 16), generator=g).to(BF16)
    flat = torch.randint(0, 80, (30,), generator=g, dtype=torch.int32)
    return dict(tables=tables, ids=ids, d_bag=d_bag, feats=feats,
                d_dot=d_dot, neigh=neigh, w=w, table=table, flat=flat)


# (kernel, the op as the CPU and meta call it, the plain version, inputs)
META_CASES = {
    "embedding_bag_fwd": (lambda t, i: ops.embedding_bag(t, i),
                          ("tables", "ids")),
    "embedding_bag_fused_fwd": (lambda t, i: ops.embedding_bag_fused(t, i),
                                ("tables", "ids")),
    "embedding_bag_bwd": (lambda g, i: ops._EmbeddingBag.backward(
        type("C", (), dict(needs_input_grad=(True,), saved_tensors=(i,),
                           num_rows=40, combiner="sum",
                           table_dtype=BF16))(), g)[0],
        ("d_bag", "ids")),
    "embedding_bag_fwd_local": (lambda t, i: ops.embedding_bag_local(
        t, i, 20), ("tables", "ids")),
    "embedding_bag_bwd_local": (lambda g, i: ops.embedding_bag_local_bwd(
        g, i, 20, 40, BF16), ("d_bag", "ids")),
    "embedding_take_fwd_local": (lambda t, i: ops.local_take(t, i, 40),
                                 ("table", "flat")),
    "embedding_take_bwd_local": (lambda t, i: ops.local_take_bwd(
        torch.empty((i.shape[0], t.shape[1]), dtype=t.dtype,
                    device=t.device).fill_(1) if t.device.type == "cpu"
        else torch.empty((i.shape[0], t.shape[1]), dtype=t.dtype,
                         device=t.device), i, 40, 40), ("table", "flat")),
    "dot_interact_fwd": (lambda f: ops.dot_interact(f), ("feats",)),
    "dot_interact_bwd": (lambda g, f: ops._DotInteract.backward(
        type("C", (), {"saved_tensors": (f,)})(), g), ("d_dot", "feats")),
    "sage_aggregate_fwd": (lambda n, w: ops.sage_aggregate(n, w),
                           ("neigh", "w")),
    "sage_widen_w": (lambda n, w: ops.sage_aggregate(n, w.to(BF16)),
                     ("neigh", "w")),
}


@pytest.mark.parametrize("name", sorted(META_CASES))
def test_meta_route_gives_the_shapes_and_counts_a_launch(name):
    """Each op of kernels/ops on meta tensors: the output shape and dtype
    of the CUDA route (which are the plain version's on the CPU: held
    there), one launch counted under the kernel's name, and its cost
    reported to an active recorder."""
    fn, keys = META_CASES[name]
    inp = _case_inputs()
    args = tuple(inp[k] for k in keys)
    want = fn(*args)
    seen = []
    prev = ops.set_kernel_recorder(lambda k, f, b: seen.append((k, f, b)))
    try:
        before = ops.launch_counts()[name]
        got = fn(*_meta(*args))
        after = ops.launch_counts()[name]
    finally:
        ops.set_kernel_recorder(prev)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert after - before == 1
    assert name in {k for k, _, _ in seen}
    assert all(b > 0 and f >= 0 for _, f, b in seen)


def test_meta_route_backward_and_scratch():
    """The sage backward and the bag's scatter through autograd on meta:
    the gradients' shapes and dtypes, one launch each; the take scatter's
    sort and partials allocated as on the card (`take_bwd_plan`), and a
    device that is neither CPU, CUDA nor meta refused."""
    inp = _case_inputs()
    n, w, tb = (t.requires_grad_(True) for t in _meta(
        inp["neigh"], inp["w"], inp["tables"].to(BF16)))
    i, = _meta(inp["ids"])
    before = ops.launch_counts()
    (ops.sage_aggregate(n, w).float().sum()
     + ops.embedding_bag(tb, i).sum()).backward()
    after = ops.launch_counts()
    assert (n.grad.shape, w.grad.shape, tb.grad.dtype) == \
        ((12, 5, 8), (8, 3), BF16)
    assert after["sage_aggregate_bwd"] - before["sage_aggregate_bwd"] == 1
    assert after["embedding_bag_bwd"] - before["embedding_bag_bwd"] == 1
    from repro_torch.launch.step_analysis import analyze
    t, f = _meta(inp["table"], inp["flat"])
    d_out = torch.empty((30, 16), dtype=BF16, device="meta")
    res = analyze(lambda: ops.local_take_bwd(d_out, f, 0, 40))
    plan = eb.take_bwd_plan(30, 40, 16, 2)
    scratch = 4 * (4 * 30 + plan.radix * plan.tiles + plan.radix
                   + plan.part_a + plan.part_b) \
        + 4 * (plan.part_a + plan.part_b) * 16
    assert res["temp_bytes"] >= scratch
    assert res["launches"] == {"embedding_take_bwd_local": 1}
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._on_cuda(type("T", (), {"device": torch.device("xpu")})())


# a wrapper's refusal on the card is its refusal on meta: the same checks
META_REFUSALS = {
    "int64 ids": (lambda: ops.embedding_bag(
        torch.empty((3, 40, 16), device="meta"),
        torch.empty((9, 3, 2), dtype=torch.int64, device="meta")),
        TypeError, "ids must be torch.int32"),
    "strided feats": (lambda: ops.dot_interact(
        torch.empty((6, 9, 8), device="meta").transpose(0, 1)),
        ValueError, "must be contiguous"),
    "take of int64 ids": (lambda: ops.local_take(
        torch.empty((40, 16), device="meta"),
        torch.empty((30,), dtype=torch.int64, device="meta"), 0),
        TypeError, "ids must be torch.int32"),
    "fused walk over 2^31 threads": (lambda: ops.embedding_bag_fused(
        torch.empty((16, 64, 128), device="meta"),
        torch.empty((2 ** 26, 16, 1), dtype=torch.int32, device="meta")),
        ValueError, "at most 2\\^31 - 1 threads"),
}


@pytest.mark.parametrize("case", sorted(META_REFUSALS))
def test_meta_route_refuses_what_the_card_refuses(case):
    """On meta an op runs its CUDA wrapper up to the launch, so the
    wrapper's checks refuse there what they refuse on the card, and no
    launch is counted."""
    fn, err, match = META_REFUSALS[case]
    before = ops.launch_counts()
    with pytest.raises(err, match=match):
        fn()
    assert ops.launch_counts() == before


# -------------------------------------------------------------- the CLI ---
def test_dryrun_cli_writes_well_formed_records(runs):
    """`dryrun.main` for graphsage-reddit's four shapes and smollm-135m's
    skipped long_500k on a (2, 2) mesh: exit code 0, a record a cell
    under <out>/mesh2x2/, the ok ones with every field the roofline and
    the probe read, the skipped one with the config's reason."""
    assert runs["plan"]["cli"] == [0, 0]
    d = runs["cli"] / "mesh2x2"
    recs = {p.name: json.loads(p.read_text()) for p in d.glob("*.json")}
    assert len(recs) == 5
    skipped = recs["smollm-135m__long_500k.json"]
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == get_arch("smollm-135m").is_skipped(
        "long_500k")
    for name, rec in recs.items():
        if rec["status"] == "skipped":
            continue
        assert rec["status"] == "ok" and rec["kind"] == "train", name
        assert rec["n_devices"] == 4 and rec["plan_s"] >= 0
        mem = rec["memory"]
        assert mem["peak_bytes"] == mem["resident_bytes"] + mem["temp_bytes"]
        assert mem["resident_bytes"] >= mem["params"] + mem["opt_state"]
        assert set(rec["collectives"]) == {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "total_bytes"}
        assert rec["collective_bytes"] == rec["collectives"]["total_bytes"]
        assert rec["dot_flops"] > 0 and rec["fits"] is True
    mb = recs["graphsage-reddit__minibatch_lg.json"]
    assert mb["launches"] == {"sage_aggregate_fwd": 3,
                              "sage_aggregate_bwd": 3}
    from benchmarks import torch_roofline
    rows = torch_roofline.plan_table(str(d))
    assert {r["status"] for r in rows} == {"ok", "skipped"}
    assert all(r["dominant"] in ("compute", "memory", "collective")
               for r in rows if r["status"] == "ok")
