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

    # the transformer on its placement (LMPlacement: every parameter
    # this rank's block, the tokens this data rank's rows, the logits this
    # model rank's vocab shard, gathered whole here), drop-free, so that
    # its tokens split over the data axis route and keep all their
    # choices as on one device
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    lcfg = moe.drop_free(TransformerConfig(**LM_CFG))
    lm = tfm.init_params(lcfg, seed=3, device="cpu")
    lm.load_state_dict(tfm.params_from_numpy(tfm.tree_from_named(
        {k[len("lm/"):]: v for k, v in inp.items() if k.startswith("lm/")})))
    toks = torch.from_numpy(inp["lm_tokens"])
    pl = LMPlacement(mesh, lcfg)
    with torch.no_grad():
        out["lm_one"] = _np(tfm.forward(lm, toks)[0])
        pl.shard_model(lm)
        logits = tfm.forward(lm, torch.from_numpy(data_rows(
            inp["lm_tokens"])), placement=pl)[0]
        logits = coll.gather_dim(logits, pl.tpg, -1)
        out["lm_mesh"] = _np(coll.gather_dim(logits, pl.dpg, 0))
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


# ------------------------------------------------------------ LM on a mesh ---
_GEMMA_RULES = (("head_dim", "model"), ("act_q_seq", "model"),
                ("cache_head_dim", "model"))
# reduced LMs that reach every placed path at the meshes above: heads
# split (gemma-like: softcaps, local/global windows, post-norms, tied
# embeddings), query positions over the model ranks with the head dim
# split (smollm-like: 3 heads, 1 kv head), the head dim split in the
# attention itself (smollm-hd: no act_q_seq), heads with their kv heads
# split (qwen-moe-like: MoE with shared experts, qkv bias, untied head),
# heads reading one replicated kv head and adafactor over 128 x 128
# matrices (kimi-like)
LM_DIST_CASES = {
    "gemma-like": dict(
        name="gemma-like", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        head_dim=8, d_ff=64, vocab_size=64, sliding_window=8,
        local_global_alternating=True, scan_block=2,
        attn_logit_softcap=50.0, final_logit_softcap=30.0, post_norm=True,
        scale_embed=True, act="gelu", tie_embeddings=True, attn_chunk=8,
        param_dtype="float32", sharding_overrides=_GEMMA_RULES),
    "smollm-like": dict(
        name="smollm-like", n_layers=2, d_model=32, n_heads=3, n_kv_heads=1,
        head_dim=8, d_ff=64, vocab_size=64, tie_embeddings=True,
        attn_chunk=8, param_dtype="float32",
        sharding_overrides=_GEMMA_RULES),
    "smollm-hd": dict(
        name="smollm-hd", n_layers=2, d_model=32, n_heads=3, n_kv_heads=1,
        head_dim=8, d_ff=64, vocab_size=64, tie_embeddings=True,
        attn_chunk=8, param_dtype="float32",
        sharding_overrides=(("head_dim", "model"),
                            ("cache_head_dim", "model"))),
    "qwen-moe-like": dict(
        name="qwen-moe-like", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, head_dim=8, d_ff=64, vocab_size=64, n_experts=6,
        n_shared_experts=2, top_k=2, d_expert=16, qkv_bias=True,
        rope_theta=1_000_000.0, tie_embeddings=False, attn_chunk=8,
        param_dtype="float32"),
    "kimi-like": dict(
        name="kimi-like", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128, n_experts=4,
        n_shared_experts=1, top_k=2, d_expert=128, rope_theta=50_000.0,
        tie_embeddings=False, attn_chunk=8, param_dtype="float32",
        sharding_overrides=(("cache_head_dim", "model"),)),
}
LM_OPTIMIZER = {"kimi-like": "adafactor"}
# the train step's step number (the warm-up's learning rate is 0 at 0)
LM_STEP = 50
LM_SERVE = {"prompt": 13, "cache": 16}
LM_SERVE_BATCHES = {"gemma-like": (4, 2, 1), "smollm-like": (4, 2, 1)}


def lm_serve_batches(case):
    return LM_SERVE_BATCHES.get(case, (4, 2))


def lm_inputs(inp, case):
    """({dotted name: numpy} parameters, batch, serve tokens) of a case."""
    pre = f"{case}/p/"
    params = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    batch = {k: inp[f"{case}/{k}"] for k in ("tokens", "labels")}
    return params, batch, inp[f"{case}/serve"]


def lm_functions(rank, mesh_shape, workdir):
    """Each case of LM_DIST_CASES on this rank's blocks: the loss and
    the gradients (reduced, gathered whole), one train step (the
    parameters and the optimizer state gathered whole), every leaf's
    local shape, and prefill and three decode steps at each serving batch
    (this rank's rows of the logits, its cache block)."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.train_step import make_train_step

    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    mesh = make_mesh(*mesh_shape, "cpu")
    out = {}
    for case, kw in LM_DIST_CASES.items():
        cfg = TransformerConfig(**kw)
        params, batch, serve = lm_inputs(inp, case)
        opt_name = LM_OPTIMIZER.get(case, "adam")

        def placed(**pkw):
            model = tfm.init_params(cfg, seed=1, device="cpu")
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in params.items()})
            pl = LMPlacement(mesh, cfg, optimizer=opt_name, **pkw)
            pl.shard_model(model)
            return model, pl

        model, pl = placed()
        b = batch["tokens"].shape[0]
        r0, n = pl.batch_rows(b)
        local = {k: torch.from_numpy(v[r0:r0 + n]) for k, v in batch.items()}
        loss, metrics = tfm.loss_fn(model, local, placement=pl)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()])
        grads = pl.reduce_grads(dict(zip(names, grads)))
        out[f"{case}/loss"] = _np(metrics["global_loss"])
        for k, g in pl.gather(grads).items():
            out[f"{case}/grad/{k}"] = _np(g)
        for k, p in model.named_parameters():
            out[f"{case}/shape/params/{k}"] = np.array(p.shape)

        kw_opt = dict(norm_groups=pl.norm_groups())
        if opt_name == "adafactor":
            kw_opt["shards"] = pl.adafactor_shards()
        opt = make_optimizer(opt_name, lr=3e-4, **kw_opt)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(
            lambda m, bb: tfm.loss_fn(m, bb, placement=pl), opt,
            grad_fn=pl.reduce_grads)
        _, state, stats = step(model, state, LM_STEP, local)
        if opt_name == "adafactor":
            out.update(_state_reshard_check(case, model, state, pl))
        out[f"{case}/step_loss"] = _np(stats["global_loss"])
        out[f"{case}/grad_norm"] = _np(stats["grad_norm"])
        for k, p in pl.gather({k: p.detach() for k, p in
                               model.named_parameters()}).items():
            out[f"{case}/step/params/{k}"] = _np(p)
        for key, per in state.items():
            for name, t in per.items():
                whole = pl.gather_state(name, t, key=key)
                for sub, (w, loc) in ({key: (whole, t)}.items()
                                      if not isinstance(t, dict) else
                                      {s: (whole[s], t[s])
                                       for s in t}.items()):
                    out[f"{case}/step/opt/{sub}/{name}"] = _np(w)
                    out[f"{case}/shape/opt/{sub}/{name}"] = np.array(
                        loc.shape)

        for bsz in lm_serve_batches(case):
            model, pl = placed(kind="decode", batch=bsz,
                               cache_len=LM_SERVE["cache"])
            r0, n = pl.batch_rows(bsz)
            toks = torch.from_numpy(serve[r0:r0 + n].astype(np.int64))
            s0 = LM_SERVE["prompt"]
            last, cache = tfm.prefill(model, toks[:, :s0], placement=pl)
            out[f"{case}/b{bsz}/prefill"] = _np(last)
            # a copy: the decode steps write into the cache in place
            out[f"{case}/b{bsz}/prefill_k"] = _np(cache["k"]).copy()
            out[f"{case}/b{bsz}/shape/cache"] = np.array(cache["k"].shape)
            for pos in range(s0, LM_SERVE["cache"]):
                logits, cache = tfm.decode_step(model, cache, toks[:, pos],
                                                pos, placement=pl)
                out[f"{case}/b{bsz}/decode{pos}"] = _np(logits)
            out[f"{case}/b{bsz}/cache_k"] = _np(cache["k"])
            out[f"{case}/b{bsz}/cache_v"] = _np(cache["v"])
            out[f"{case}/b{bsz}/rows"] = np.array([r0, n])
    return out


def _state_reshard_check(case, model, state, pl):
    """The optimizer state gathered whole in the JAX layout (the driver's
    checkpoint tree) and `reshard`ed back: this rank's blocks bitwise."""
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    tree = train._state_tree(tfm, model, state, pl)
    opt = {k: tfm.named_from_tree(v) for k, v in tree["opt_state"].items()}
    named = tfm.named_from_tree(tree["params"])
    local, local_opt = train._restore_sharded(
        {"params": named, "opt_state": opt}, pl, "cpu")
    ok = all(torch.equal(local[k], p.detach())
             for k, p in model.named_parameters())
    n = 0
    for key, per in state.items():
        for name, t in per.items():
            for sub, v in t.items():
                n += sub in ("vr", "vc")
                ok &= bool(torch.equal(local_opt[key][name][sub], v))
    return {f"{case}/reshard_bitwise": np.array(ok),
            f"{case}/n_factored": np.array(n)}


LM_DRIVER_ARCHS = ("gemma2-2b", "kimi-k2-1t-a32b")


def lm_driver(rank, mesh_shape, workdir, save_dir="", restore_dir=""):
    """3 driver steps of each of LM_DRIVER_ARCHS (the reduced LMs) on this
    mesh, and of gemma2-2b in 2 microbatches; with `save_dir`, 3 steps of kimi-k2-1t-a32b (adafactor) that
    checkpoint there; with `restore_dir`, that checkpoint restored onto
    this mesh and gathered back, and the run resumed to 5 steps."""
    from repro_torch.launch import train
    out = {}
    kw = dict(device="cpu", dist_run=True, mesh_shape=mesh_shape,
              log_every=100)
    for arch_id in LM_DRIVER_ARCHS:
        r = train.run(arch_id, steps=3, **kw)
        out[f"{arch_id}_losses"] = np.array(r["losses"])
        out[f"{arch_id}_mesh"] = np.array([r["mesh"]["data"],
                                           r["mesh"]["model"]])
    out["init_blocks_bitwise"] = np.array(_init_blocks_bitwise(mesh_shape))
    # each data rank's rows are its slices of the 2 microbatches
    r = train.run("gemma2-2b", steps=3, microbatches=2, **kw)
    out["gemma2-2b_mb2_losses"] = np.array(r["losses"])
    if save_dir:
        r = train.run("kimi-k2-1t-a32b", steps=3, ckpt_dir=save_dir,
                      ckpt_every=3, **kw)
        out["saved_losses"] = np.array(r["losses"])
    if restore_dir:
        out.update(_lm_restore_check(mesh_shape, restore_dir))
        r = train.run("kimi-k2-1t-a32b", steps=5, ckpt_dir=restore_dir,
                      ckpt_every=100, **kw)
        out["resumed_losses"] = np.array(r["losses"])
    return out


def _init_blocks_bitwise(mesh_shape) -> bool:
    """Each parameter this rank draws as its block (the driver's
    `init_params(blocks=)`, for each of LM_DRIVER_ARCHS' reduced LMs)
    bitwise the block of the whole init, and every block but a
    replicated one smaller than the whole where the mesh has more than
    one rank."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import local_slice
    mesh = make_mesh(*mesh_shape, "cpu")
    ok, split = True, 0
    for arch_id in LM_DRIVER_ARCHS:
        arch = get_arch(arch_id)
        cfg = train.reduced_model(arch)
        pl = LMPlacement(mesh, cfg, optimizer=arch.optimizer)
        whole = dict(tfm.init_params(cfg, seed=0,
                                     device="cpu").named_parameters())
        for k, p in tfm.init_params(cfg, seed=0, device="cpu",
                                    blocks=pl.blocks()).named_parameters():
            want = local_slice(whole[k].detach(), pl.specs[k], mesh)
            ok &= bool(torch.equal(p.detach(), want))
            split += p.shape != whole[k].shape
    return ok and split > 0


def _lm_restore_check(mesh_shape, ckpt_dir):
    """The whole checkpoint (parameters and adafactor's vr / vc / v)
    restored onto this mesh's blocks and gathered back: bitwise the
    saved arrays, each block the saved array's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import LMPlacement
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import local_slice
    arch = get_arch("kimi-k2-1t-a32b")
    cfg = train.reduced_model(arch)
    mesh = make_mesh(*mesh_shape, "cpu")
    tree, _ = ckpt.restore(ckpt_dir, device="cpu")
    named = tfm.named_from_tree(tree["params"])
    opt = {k: tfm.named_from_tree(v) for k, v in tree["opt_state"].items()}
    pl = LMPlacement(mesh, cfg, optimizer=arch.optimizer)
    local, local_opt = train._restore_sharded(
        {"params": named, "opt_state": opt}, pl, "cpu")
    ok = shards = True
    for k, v in named.items():
        shards &= bool(torch.equal(local[k], local_slice(v, pl.specs[k],
                                                         mesh)))
        ok &= bool(torch.equal(pl.gather({k: local[k]})[k], v))
    n_state = 0
    for key, state in opt.items():
        for name, v in state.items():
            whole = pl.gather_state(name, local_opt[key][name], key=key)
            for sub in v:
                n_state += 1
                ok &= bool(torch.equal(whole[sub], v[sub]))
                shards &= bool(torch.equal(
                    local_opt[key][name][sub],
                    local_slice(v[sub], pl.state_spec(name, sub), mesh)))
    return {"restore_bitwise": np.array(ok),
            "restore_shards": np.array(shards),
            "restore_n_state": np.array(n_state),
            "table_local_shape": np.array(local["embed.table"].shape)}


# ---------------------------------------------------------------- dry run ---
# the placed steps whose collective schedule tests/test_torch_dryrun.py
# holds against the dry run's plan: (arch, the reduced config's shape)
DRYRUN_TRAIN = (("dlrm-criteo", "recsys", 32), ("gemma2-2b", "lm", 8))
DRYRUN_RETRIEVAL = ("dlrm-criteo", "wide-deep")
DRYRUN_CHUNKS = 2


def dryrun_shape(kind: str, batch: int):
    from repro_torch.configs.base import LMShape, RecsysShape
    if kind == "lm":
        return LMShape("t", "train", 64, batch)
    return RecsysShape("t", "train", batch)


def dryrun_ranks(rank, mesh_shape, workdir):
    """One train step of each of DRYRUN_TRAIN's reduced configs, placed on
    this mesh (launch/programs.build_program on the CPU), under
    launch/step_analysis: its collective schedule (a JSON row a distinct
    collective); and the placed retrieval (score_candidates(mesh=)) of
    DRYRUN_RETRIEVAL's reduced models, from inputs.npz's parameters, user
    and candidates, beside the unplaced scores of the same model."""
    import copy
    import json
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import build_program
    from repro_torch.launch.step_analysis import analyze
    from repro_torch.models import dlrm, recsys
    from repro_torch.models.exchange import from_numpy

    mesh = make_mesh(*mesh_shape, "cpu", exchange_one_shard=True)
    out = {}
    for arch_id, kind, batch in DRYRUN_TRAIN:
        arch = get_arch(arch_id)
        prog = build_program(arch, dryrun_shape(kind, batch), mesh, "cpu",
                             cfg=train.reduced_model(arch))
        calls = analyze(prog.fn, *prog.args)["collective_calls"]
        out[f"sched/{arch_id}"] = np.array(json.dumps(calls))
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    for arch_id in DRYRUN_RETRIEVAL:
        arch = get_arch(arch_id)
        cfg = train.reduced_model(arch)
        lib = dlrm if arch_id == "dlrm-criteo" else recsys
        model = train.init_params_for(arch, cfg, 1, device="cpu")
        model.load_state_dict({k[len(arch_id) + 3:]: from_numpy(v)
                               for k, v in inp.items()
                               if k.startswith(f"{arch_id}/p/")})
        placed = copy.deepcopy(model)
        train.model_placement(arch, cfg, arch.shape("retrieval_cand"),
                              placed, mesh)
        user = {k[len(arch_id) + 3:]: torch.from_numpy(v)
                for k, v in inp.items() if k.startswith(f"{arch_id}/u/")}
        cand = torch.from_numpy(inp[f"{arch_id}/cand"])
        out[f"placed/{arch_id}"] = _np(lib.score_candidates(
            placed, user, cand, chunks=DRYRUN_CHUNKS, mesh=mesh))
        out[f"unplaced/{arch_id}"] = _np(lib.score_candidates(
            model, user, cand, chunks=DRYRUN_CHUNKS))
        out[f"shard/{arch_id}"] = np.array(placed.tables.shape)
    return out
