"""The JAX package's own sharded runs on four forced host devices, the
reference of tests/test_torch_dist.py. Run in a process of its own
(XLA_FLAGS must be set before jax is imported, and the test process's
jax already has one device):

    python tests/jax_sharded_ref.py WORKDIR [lm|dryrun]

reads WORKDIR/inputs.npz and writes WORKDIR/ref.npz, each result under
"<dp>x<tp>/<name>" for the (data, model) meshes (1, 2), (2, 1), (2, 2);
gradients are taken under jax.jit (eager jax.grad of a shard_map asks
for a mesh context). With `lm` it runs the LM cases of
tests/torch_dist_ranks.LM_DIST_CASES through the reference's own
`build_lm_program` on each mesh (tests/test_torch_lm_dist.py): the loss
and gradients of its ShardCtx'd loss_fn under its in_shardings, one
step of its train program, each leaf's shard shape, and its prefill and
decode programs, each device's cache shard kept by its rank. With
`dryrun` it writes WORKDIR/dryrun_ref.json for tests/test_torch_dryrun.py:
the reference's `build_program` of the driver's reduced LMs (DRYRUN_LMS)
at DRYRUN_SHAPES on each mesh, lowered and compiled, with its
`memory_analysis().argument_size_in_bytes` and each argument group's
bytes a device; the reduced dlrm-criteo's per-device bytes of each
parameter and optimizer-state leaf and its shard count; and the loop-aware
dot FLOPs (`hlo_analysis.analyze`) of the reduced smollm-135m's train
and prefill programs on one device.
"""
import os
import sys

# four host devices on one core's worth of threads: the test runs beside
# other test workers on the same machine
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.common.shardlib import ShardCtx, compat_shard_map  # noqa: E402
from repro.configs.base import GNNConfig, TransformerConfig  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.embedding import (tp_embedding_lookup,  # noqa: E402
                                    tp_multifeature_bag)
from repro.models.recsys import tp_sampled_scores  # noqa: E402
from repro.train.collectives import psum_tree  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_ranks import (LM_CFG, LM_DIST_CASES, LM_OPTIMIZER,  # noqa
                              LM_SERVE, LM_STEP, MESHES, MOE_CFG,
                              lm_inputs, lm_serve_batches)

f32 = jnp.float32


def gnn_params(inp):
    n = 1 + max(int(k.split(".")[1]) for k in inp if k.startswith("gnn/"))
    return {"layers": tuple(
        {key: inp[f"gnn/layers.{i}.{key}"] for key in ("w_self", "w_neigh",
                                                       "b")}
        for i in range(n))}


def moe_params(inp):
    p = {k: inp[f"moe/{k}"] for k in ("router", "wi", "wg", "wo")}
    p["shared"] = {k: inp[f"moe/shared.{k}"] for k in ("wi", "wg", "wo")}
    return p


def lm_params(inp):
    """The MoE LM's parameter tree from its dotted names."""
    tree = {}
    for name, v in inp.items():
        if name.startswith("lm/"):
            *path, leaf = name[len("lm/"):].split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    return tree


def run_mesh(inp, dp, tp):
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    out = {}
    ids, w = inp["eb_ids"], inp["eb_w"]
    for dt in ("f32", "bf16"):
        tables = jnp.asarray(inp["eb_tables"])
        if dt == "bf16":
            tables = tables.astype(jnp.bfloat16)
        for comb in ("sum", "mean"):
            fwd = lambda t: tp_multifeature_bag(t, ids, mesh, combiner=comb)
            out[f"eb_{dt}_{comb}_out"] = jax.jit(fwd)(tables)
            out[f"eb_{dt}_{comb}_grad"] = jax.jit(jax.grad(
                lambda t: jnp.sum(fwd(t).astype(f32) * w)))(tables)

    ids, w = inp["el_ids"], inp["el_w"]
    look = lambda t: tp_embedding_lookup(t, ids, mesh)
    out["el_out"] = jax.jit(look)(inp["el_table"])
    out["el_grad"] = jax.jit(jax.grad(lambda t: jnp.sum(look(t) * w)))(
        inp["el_table"])

    cand, w = inp["ss_cand"], inp["ss_w"]
    score = lambda t, h: tp_sampled_scores(t, h, cand, mesh)
    out["ss_out"] = jax.jit(score)(inp["ss_items"], inp["ss_h"])
    gi, gh = jax.jit(jax.grad(lambda t, h: jnp.sum(score(t, h) * w),
                              argnums=(0, 1)))(inp["ss_items"], inp["ss_h"])
    out["ss_grad_items"], out["ss_grad_h"] = gi, gh

    tree = {"a": inp["pt_a"][:dp].reshape((-1,) + inp["pt_a"].shape[2:]),
            "b": inp["pt_b"][:dp].reshape(-1),
            "c": jnp.asarray(inp["pt_c"][:dp].reshape(
                (-1,) + inp["pt_c"].shape[2:])).astype(jnp.bfloat16)}
    for mode in ("none", "bf16", "int8"):
        fn = compat_shard_map(
            lambda t: psum_tree(t, ("data",), compress=mode), mesh=mesh,
            in_specs=({k: P("data") for k in tree},),
            out_specs={k: P() for k in tree})
        for k, v in jax.jit(fn)(tree).items():
            out[f"pt_{mode}_{k}"] = v

    cfg = GNNConfig(name="sage", n_layers=2, d_hidden=16, n_classes=5)
    batch = {k: inp[f"gp{dp * tp}_{k}"] for k in ("x", "edge_src",
                                                   "edge_dst", "labels")}
    loss_fn = lambda p: jgnn.full_graph_partitioned_loss(p, cfg, batch,
                                                         mesh)[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(gnn_params(inp))
    out["gp_loss"] = loss
    for i, layer in enumerate(grads["layers"]):
        for key, g in layer.items():
            out[f"gp_grad/layers.{i}.{key}"] = g

    jcfg = TransformerConfig(**MOE_CFG)
    p = moe_params(inp)
    moe = lambda x, p: jmoe.moe_ffn(x, p, jcfg, mesh, p["wi"].shape[0])
    y, aux = jax.jit(moe)(inp["moe_x"], p)
    out["moe_y"], out["moe_aux"] = y, aux

    def moe_loss(x, p):
        y, aux = moe(x, p)
        return jnp.sum(y * inp["moe_w"]) + aux
    gx, gp = jax.jit(jax.grad(moe_loss, argnums=(0, 1)))(inp["moe_x"], p)
    out["moe_grad_x"] = gx
    for k, g in gp.items():
        for kk, gg in (g.items() if isinstance(g, dict) else [(None, g)]):
            out[f"moe_grad/{k}" + (f".{kk}" if kk else "")] = gg

    # the MoE LM's forward on the mesh (its ShardCtx's constraints ask
    # for the mesh as context), drop-free
    lcfg = TransformerConfig(**LM_CFG)
    lcfg = lcfg.replace(capacity_factor=lcfg.n_experts / lcfg.top_k)
    with jax.set_mesh(mesh):
        out["lm_out"] = jax.jit(lambda p, t: jtfm.forward(
            p, lcfg, t, ctx=ShardCtx(mesh))[0])(
                lm_params(inp), inp["lm_tokens"].astype(np.int32))
    return out


def _tree(named):
    """{dotted name: x} -> the nested tree."""
    tree = {}
    for name, v in named.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _dotted(tree, prefix=""):
    """The nested tree -> {dotted name: leaf}; a dict of optimizer-state
    leaves (vr / vc or v) stays whole."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not (set(v) <= {"vr", "vc", "v"} and
                                        not isinstance(v.get("v", 0), dict)):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _by_rank(arr, dp, tp):
    """{rank: this rank's shard} of a sharded array (rank r at row-major
    position r of the (dp, tp) device grid, as the port's mesh puts it)."""
    ids = [d.id for d in jax.devices()[:dp * tp]]
    return {ids.index(s.device.id): np.asarray(s.data)
            for s in arr.addressable_shards}


def lm_case(inp, case, dp, tp):
    from repro.configs.base import ArchSpec, LMShape
    from repro.launch.programs import build_lm_program
    from repro.train.optim import make_optimizer
    mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))
    jcfg = TransformerConfig(**LM_DIST_CASES[case])
    opt_name = LM_OPTIMIZER.get(case, "adam")
    arch = ArchSpec(arch_id=case, family="lm", model=jcfg, shapes=(),
                    optimizer=opt_name)
    named, batch, serve = lm_inputs(inp, case)
    params = _tree(named)
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    b, s = batch["tokens"].shape
    out = {}
    prog = build_lm_program(arch, LMShape("t", "train", s, b), mesh)
    p_shard, o_shard, _, a_shard = prog.in_shardings
    ctx = ShardCtx(mesh, prog.meta["rules"])
    with jax.set_mesh(mesh):
        dev_p = jax.device_put(params, p_shard)
        for k, v in _dotted(dev_p).items():
            out[f"shape/params/{k}"] = np.array(
                v.addressable_shards[0].data.shape)
        vg = jax.jit(jax.value_and_grad(
            lambda p, bb: jtfm.loss_fn(p, jcfg, bb, ctx=ctx), has_aux=True),
            in_shardings=(p_shard, a_shard))
        (loss, _), grads = vg(dev_p, batch)
        out["loss"] = loss
        for k, g in _dotted(grads).items():
            out[f"grad/{k}"] = g
        opt = make_optimizer(opt_name, lr=3e-4)
        state = jax.jit(opt.init, out_shardings=o_shard)(dev_p)
        new_p, new_s, metrics = jax.jit(
            prog.fn, in_shardings=prog.in_shardings,
            out_shardings=prog.out_shardings)(
                dev_p, state, jnp.int32(LM_STEP), batch)
        out["step_loss"] = metrics["loss"]
        out["grad_norm"] = metrics["grad_norm"]
        for k, v in _dotted(new_p).items():
            out[f"step/params/{k}"] = v
        for key, tree in new_s.items():
            for name, leaf in _dotted(tree).items():
                subs = leaf.items() if isinstance(leaf, dict) \
                    else [(key, leaf)]
                for sub, v in subs:
                    out[f"step/opt/{sub}/{name}"] = v
                    out[f"shape/opt/{sub}/{name}"] = np.array(
                        v.addressable_shards[0].data.shape)

        s0, c = LM_SERVE["prompt"], LM_SERVE["cache"]
        for bsz in lm_serve_batches(case):
            toks = serve[:bsz].astype(np.int32)
            pre = build_lm_program(arch, LMShape("p", "prefill", s0, bsz),
                                   mesh)
            last, cache = jax.jit(pre.fn, in_shardings=pre.in_shardings)(
                dev_p, {"tokens": toks[:, :s0]})
            out[f"b{bsz}/prefill"] = last
            dec = build_lm_program(arch, LMShape("d", "decode", c, bsz), mesh)
            c_shard = dec.in_shardings[1]
            big = {n: np.zeros((jcfg.n_layers, bsz, c, jcfg.n_kv_heads,
                                jcfg.head_dim), np.float32) for n in "kv"}
            for n in "kv":
                big[n][:, :, :s0] = np.asarray(cache[n], np.float32)
            big = jax.device_put(big, c_shard)
            for r, blk in _by_rank(big["k"], dp, tp).items():
                out[f"b{bsz}/prefill_k/{r}"] = blk
            out[f"b{bsz}/shape/cache"] = np.array(
                big["k"].addressable_shards[0].data.shape)
            step = jax.jit(dec.fn, in_shardings=dec.in_shardings,
                           out_shardings=dec.out_shardings)
            for pos in range(s0, c):
                logits, big = step(dev_p, big, toks[:, pos], jnp.int32(pos))
                out[f"b{bsz}/decode{pos}"] = logits
            for n in "kv":
                for r, blk in _by_rank(big[n], dp, tp).items():
                    out[f"b{bsz}/cache_{n}/{r}"] = blk
    return out


def main_lm(workdir):
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    res = {}
    for dp, tp in MESHES:
        for case in LM_DIST_CASES:
            for k, v in lm_case(inp, case, dp, tp).items():
                a = np.asarray(v)
                res[f"{dp}x{tp}/{case}/{k}"] = a.astype(np.float32) \
                    if a.dtype.kind in "fV" else a
    np.savez(os.path.join(workdir, "ref.npz"), **res)


def main(workdir):
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    res = {}
    for dp, tp in MESHES:
        for k, v in run_mesh(inp, dp, tp).items():
            res[f"{dp}x{tp}/{k}"] = np.asarray(jnp.asarray(v).astype(f32))
    jcfg = TransformerConfig(**MOE_CFG)
    _, _, topi = jmoe._route(jnp.asarray(inp["moe_x"]), inp["moe/router"],
                             jcfg.n_experts, jcfg.top_k, jcfg.norm_topk_prob)
    res["moe_topi"] = np.asarray(topi)
    np.savez(os.path.join(workdir, "ref.npz"), **res)


DRYRUN_LMS = ("smollm-135m", "qwen2-moe-a2.7b")
# the reduced LM's cells: (name, kind, seq_len, batch)
DRYRUN_SHAPES = (("t", "train", 64, 8), ("d", "decode", 64, 4),
                 ("p", "prefill", 64, 8))


def _shard_bytes(abstract, sharding) -> int:
    n = int(np.prod(sharding.shard_shape(abstract.shape), dtype=np.int64))
    return n * np.dtype(abstract.dtype).itemsize


def _group_bytes(abstract, shardings) -> dict:
    """{leaf path: (bytes a device, shards)} of an argument group."""
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    if len(shs) == 1 and len(flat) > 1:
        shs = shs * len(flat)
    out = {}
    for (path, leaf), sh in zip(flat, shs):
        n = int(np.prod(leaf.shape, dtype=np.int64)) if leaf.shape else 1
        per = _shard_bytes(leaf, sh)
        out[jax.tree_util.keystr(path)] = (
            per, n * np.dtype(leaf.dtype).itemsize // max(per, 1))
    return out


def main_dryrun(workdir):
    import json
    from repro.configs import get_arch
    from repro.configs.base import LMShape
    from repro.launch import hlo_analysis
    from repro.launch.programs import build_program
    from repro.launch.train import reduced_model
    res = {"lm": {}, "dlrm": {}, "hlo": {}}
    for dp, tp in ((1, 1),) + MESHES:
        mesh = Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                    ("data", "model"))
        for arch_id in DRYRUN_LMS:
            arch = get_arch(arch_id)
            arch = arch.__class__(**{**arch.__dict__,
                                     "model": reduced_model(arch)})
            for name, kind, seq, batch in DRYRUN_SHAPES:
                if (dp, tp) == (1, 1) and (arch_id != "smollm-135m"
                                           or kind == "decode"):
                    continue
                if (dp, tp) != (1, 1) and kind == "prefill":
                    continue
                prog = build_program(arch, LMShape(name, kind, seq, batch),
                                     mesh)
                with jax.set_mesh(mesh):
                    compiled = jax.jit(
                        prog.fn, in_shardings=prog.in_shardings,
                        out_shardings=prog.out_shardings,
                        donate_argnums=prog.donate_argnums).lower(
                            *prog.abstract_args).compile()
                if (dp, tp) == (1, 1):
                    res["hlo"][kind] = hlo_analysis.analyze(
                        compiled.as_text())["dot_flops"]
                    continue
                groups = [_group_bytes(a, s) for a, s in
                          zip(prog.abstract_args, prog.in_shardings)]
                res["lm"][f"{arch_id}/{kind}/{dp}x{tp}"] = {
                    "argument_size_in_bytes": int(
                        compiled.memory_analysis().argument_size_in_bytes),
                    "groups": groups}
        if (dp, tp) == (1, 1):
            continue
        arch = get_arch("dlrm-criteo")
        arch = arch.__class__(**{**arch.__dict__,
                                 "model": reduced_model(arch)})
        prog = build_program(arch, arch.shape("train_batch"), mesh)
        res["dlrm"][f"{dp}x{tp}"] = {
            "params": _group_bytes(prog.abstract_args[0],
                                   prog.in_shardings[0]),
            "opt_state": _group_bytes(prog.abstract_args[1],
                                      prog.in_shardings[1])}
    with open(os.path.join(workdir, "dryrun_ref.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    if sys.argv[2:] == ["lm"]:
        main_lm(sys.argv[1])
    elif sys.argv[2:] == ["dryrun"]:
        main_dryrun(sys.argv[1])
    else:
        main(sys.argv[1])
