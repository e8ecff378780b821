"""The JAX package's own sharded runs on four forced host devices, the
reference of tests/test_torch_dist.py. Run in a process of its own
(XLA_FLAGS must be set before jax is imported, and the test process's
jax already has one device):

    python tests/jax_sharded_ref.py WORKDIR

reads WORKDIR/inputs.npz and writes WORKDIR/ref.npz, each result under
"<dp>x<tp>/<name>" for the (data, model) meshes (1, 2), (2, 1), (2, 2);
gradients are taken under jax.jit (eager jax.grad of a shard_map asks
for a mesh context).
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
from torch_dist_ranks import LM_CFG, MESHES, MOE_CFG  # noqa: E402

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


if __name__ == "__main__":
    main(sys.argv[1])
