"""Rank programs for the port's multi-rank CPU tests (torch only; the
JAX reference runs in its own process, tests/jax_sharded_ref.py).

`spawn(job, world, workdir, *args)` starts `world` gloo ranks on this
machine (`torch.multiprocessing`, spawn start), joined through a file
rendezvous under `workdir` (no port to collide between test workers);
each rank runs the module function `job(rank, mesh_shape, workdir,
*args)` on one torch thread and writes what it returns (a dict of numpy
arrays) to `workdir/<job>_<rank>.npz`. The jobs read their inputs from
`workdir/inputs.npz`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

MESHES = ((1, 2), (2, 1), (2, 2))


def _entry(rank, job, world, mesh_shape, workdir, args):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_lib
    import torch.distributed as dist
    mesh_lib.init_distributed(
        "cpu", rank=rank, world_size=world,
        init_method="file://" + os.path.join(workdir, f"pg_{job}"))
    try:
        out = globals()[job](rank, tuple(mesh_shape), workdir, *args)
        np.savez(os.path.join(workdir, f"{job}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(job: str, mesh_shape, workdir: str, *args) -> list:
    """Run `job` on dp x tp gloo ranks; returns each rank's results."""
    import torch.multiprocessing as mp
    world = mesh_shape[0] * mesh_shape[1]
    mp.spawn(_entry, args=(job, world, tuple(mesh_shape), workdir, args),
             nprocs=world, join=True)
    return [dict(np.load(os.path.join(workdir, f"{job}_{r}.npz")))
            for r in range(world)]


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- functions ---
def functions(rank, mesh_shape, workdir):
    """tp_multifeature_bag, tp_embedding_lookup, tp_sampled_scores,
    psum_tree, full_graph_partitioned_loss and moe_ffn on this rank's
    shards of tests/test_torch_dist.py's inputs: the local outputs and
    gradients, with the rank's coordinates."""
    from repro_torch.configs.base import GNNConfig, TransformerConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import gnn, moe
    from repro_torch.models.embedding import (tp_embedding_lookup,
                                              tp_multifeature_bag)
    from repro_torch.models.recsys import tp_sampled_scores
    from repro_torch.train import collectives as coll
    from repro_torch.train.elastic import local_slice

    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    mesh = make_mesh(*mesh_shape, "cpu")
    dp, tp = mesh_shape
    d_idx, m_idx = mesh.index("data"), mesh.index("model")
    all_axes = mesh.axis_names
    out = {"data": np.int64(d_idx), "model": np.int64(m_idx),
           "flat": np.int64(mesh.index(all_axes))}

    def data_rows(a):
        n = a.shape[0] // dp
        return a[d_idx * n:(d_idx + 1) * n]

    # tp_multifeature_bag: rows over every axis, ids over data
    ids = torch.from_numpy(data_rows(inp["eb_ids"]))
    w = torch.from_numpy(data_rows(inp["eb_w"]))
    for dt in ("f32", "bf16"):
        whole = torch.from_numpy(inp["eb_tables"])
        if dt == "bf16":
            whole = whole.to(torch.bfloat16)
        for comb in ("sum", "mean"):
            t = local_slice(whole, (None, all_axes, None), mesh).clone() \
                .requires_grad_(True)
            o = tp_multifeature_bag(t, ids, mesh, combiner=comb,
                                    rows=whole.shape[1])
            (o.float() * w).sum().backward()
            out[f"eb_{dt}_{comb}_out"] = _np(o)
            out[f"eb_{dt}_{comb}_grad"] = _np(t.grad)
            out[f"eb_{dt}_{comb}_dtype"] = np.array(str(o.dtype))

    # tp_embedding_lookup: rows over model, ids over data; the shard's
    # gradient summed over the data ranks it is replicated on
    whole = torch.from_numpy(inp["el_table"])
    t = local_slice(whole, ("model", None), mesh).clone().requires_grad_(True)
    o = tp_embedding_lookup(t, torch.from_numpy(data_rows(inp["el_ids"])),
                            mesh, rows=whole.shape[0])
    (o * torch.from_numpy(data_rows(inp["el_w"]))).sum().backward()
    out["el_out"] = _np(o)
    out["el_grad"] = _np(coll.all_reduce(t.grad, mesh.data_group))

    # tp_sampled_scores
    whole = torch.from_numpy(inp["ss_items"])
    t = local_slice(whole, ("model", None), mesh).clone().requires_grad_(True)
    h = torch.from_numpy(data_rows(inp["ss_h"])).requires_grad_(True)
    o = tp_sampled_scores(t, h, torch.from_numpy(data_rows(inp["ss_cand"])),
                          mesh, rows=whole.shape[0])
    (o * torch.from_numpy(data_rows(inp["ss_w"]))).sum().backward()
    out["ss_out"] = _np(o)
    out["ss_grad_items"] = _np(coll.all_reduce(t.grad, mesh.data_group))
    out["ss_grad_h"] = _np(h.grad)

    # psum_tree over the data axes: data rank d holds slice d
    tree = {"a": torch.from_numpy(inp["pt_a"][d_idx]),
            "b": torch.from_numpy(inp["pt_b"][d_idx]),
            "c": _bf16(inp["pt_c"][d_idx])}
    for mode in ("none", "bf16", "int8"):
        r = coll.psum_tree(tree, mesh.data_group, compress=mode)
        for k, v in r.items():
            out[f"pt_{mode}_{k}"] = _np(v)
            out[f"pt_{mode}_{k}_dtype"] = np.array(str(v.dtype))

    # full_graph_partitioned_loss: the loss, and the parameters'
    # gradients summed over every rank
    cfg = GNNConfig(name="sage", n_layers=2, d_hidden=16, n_classes=5)
    n_shards = dp * tp
    model = gnn.GraphSAGE(cfg, inp[f"gp{n_shards}_x"].shape[1], device="cpu")
    model.load_state_dict({k[len("gnn/"):]: torch.from_numpy(v)
                           for k, v in inp.items() if k.startswith("gnn/")})
    batch = {k: torch.from_numpy(inp[f"gp{n_shards}_{k}"])
             for k in ("x", "edge_src", "edge_dst", "labels")}
    loss, _ = gnn.full_graph_partitioned_loss(model, batch, mesh)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    out["gp_loss"] = _np(loss)
    for k, g in zip(names, grads):
        out[f"gp_grad/{k}"] = _np(coll.all_reduce(g, mesh.all_group))

    # moe_ffn's expert parallelism, with each call's top-k indices
    mcfg = TransformerConfig(**MOE_CFG)
    p = {k[len("moe/"):]: torch.from_numpy(v).clone() for k, v in
         inp.items() if k.startswith("moe/")}
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(inp["moe_x"]).requires_grad_(True)
    rec = []
    y, aux = moe.moe_ffn(x, p, mcfg, p["wi"].shape[0], mesh=mesh,
                         routing=rec)
    out["moe_y"] = _np(y)
    out["moe_aux"] = _np(aux)
    out["moe_topi"] = rec[0].numpy()
    # its gradients: x's as this rank holds it, each parameter's summed
    # over the ranks, and this rank's own expert gradients
    names = sorted(p)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(inp["moe_w"])).sum() + aux,
        [x] + [p[k] for k in names])
    out["moe_grad_x"] = _np(grads[0])
    for k, g in zip(names, grads[1:]):
        out[f"moe_grad/{k}"] = _np(coll.all_reduce(g, mesh.all_group))
        if k in ("wi", "wg", "wo"):
            out[f"moe_grad_rank/{k}"] = _np(g)

    # the transformer with its mesh (the embedding lookup and the MoE's
    # expert parallelism; every other layer replicated), drop-free, so
    # that its tokens split over the data axis route and keep all their
    # choices as on one device
    from repro_torch.models import transformer as tfm
    lcfg = moe.drop_free(TransformerConfig(**LM_CFG))
    lm = tfm.init_params(lcfg, seed=3, device="cpu")
    lm.load_state_dict(tfm.params_from_numpy(tfm.tree_from_named(
        {k[len("lm/"):]: v for k, v in inp.items() if k.startswith("lm/")})))
    toks = torch.from_numpy(inp["lm_tokens"])
    with torch.no_grad():
        out["lm_mesh"] = _np(tfm.forward(lm, toks, mesh=mesh)[0])
        out["lm_one"] = _np(tfm.forward(lm, toks)[0])
    return out


LM_CFG = dict(name="lm-moe-t", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=48, vocab_size=64,
              n_experts=8, n_shared_experts=2, top_k=2, d_expert=24,
              param_dtype="float32", attn_chunk=16, remat="none")
MOE_CFG = dict(name="moe-t", n_layers=1, d_model=32, n_heads=2,
               n_kv_heads=1, head_dim=16, d_ff=48, vocab_size=64,
               n_experts=8, n_shared_experts=2, top_k=2, d_expert=24,
               param_dtype="float32")


# ---------------------------------------------------------------- driver ---
DRIVER_ARCHS = (("dlrm-criteo", None), ("bert4rec", None),
                ("wide-deep", None), ("graphsage-reddit", "full_graph_sm"))


def driver(rank, mesh_shape, workdir, save_dir="", restore_dir=""):
    """5 driver steps of each of DRIVER_ARCHS on this mesh (and of
    dlrm-criteo with bf16 and int8 gradient compression on (2, 2)); with
    `save_dir`, 3 steps of dlrm-criteo that checkpoint there; with
    `restore_dir`, that checkpoint restored onto this mesh (`reshard`)
    and gathered back, and the run resumed to 5 steps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    out = {}
    kw = dict(device="cpu", dist_run=True, mesh_shape=mesh_shape,
              log_every=100)
    for arch_id, shape in DRIVER_ARCHS:
        shape = get_arch(arch_id).shape(shape) if shape else None
        r = train.run(arch_id, steps=5, shape=shape, **kw)
        out[f"{arch_id}_losses"] = np.array(r["losses"])
        out[f"{arch_id}_mesh"] = np.array([r["mesh"]["data"],
                                           r["mesh"]["model"]])
    if tuple(mesh_shape) == (2, 2):
        for mode in ("bf16", "int8"):
            r = train.run("dlrm-criteo", steps=5, compress=mode, **kw)
            out[f"dlrm-criteo_{mode}_losses"] = np.array(r["losses"])
    if save_dir:
        r = train.run("dlrm-criteo", steps=3, ckpt_dir=save_dir,
                      ckpt_every=3, **kw)
        out["saved_losses"] = np.array(r["losses"])
    if restore_dir:
        out.update(_restore_check(mesh_shape, restore_dir))
        r = train.run("dlrm-criteo", steps=5, ckpt_dir=restore_dir,
                      ckpt_every=100, **kw)
        out["resumed_losses"] = np.array(r["losses"])
    return out


def _restore_check(mesh_shape, ckpt_dir):
    """The whole checkpoint restored onto this mesh and gathered back:
    bitwise the saved arrays, each shard the saved array's block."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import Placement
    from repro_torch.models import dlrm
    from repro_torch.models.exchange import to_numpy
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import local_slice
    arch = get_arch("dlrm-criteo")
    cfg = train.reduced_model(arch)
    mesh = make_mesh(*mesh_shape, "cpu")
    tree, _ = ckpt.restore(ckpt_dir, device="cpu")
    named = dlrm.named_from_tree(tree["params"])
    opt = {k: dlrm.named_from_tree(v) for k, v in tree["opt_state"].items()}
    placement = Placement(mesh, "dlrm", cfg,
                          {k: v.shape for k, v in named.items()})
    local, local_opt = train._restore_sharded(
        {"params": named, "opt_state": opt}, placement, "cpu")
    ok, shards = True, True
    for k, v in named.items():
        spec = placement.specs[k]
        shards &= bool(torch.equal(local[k], local_slice(v, spec, mesh)))
        whole = placement.gather({k: local[k]})[k]
        ok &= bool(np.array_equal(to_numpy(whole).view(np.uint8),
                                  to_numpy(v).view(np.uint8)))
    for name, state in opt.items():
        for k, v in state.items():
            whole = placement.gather_state(k, local_opt[name][k])
            ok &= bool(torch.equal(whole, v))
    return {"restore_bitwise": np.array(ok), "restore_shards": np.array(
        shards), "tables_local_shape": np.array(local["tables"].shape)}
