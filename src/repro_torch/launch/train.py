"""Generic training driver of the port: --arch <id> on one device or a
mesh of ranks (port of repro/launch/train.py: the `lm`, `gnn`, `recsys`
and `dlrm` families, and the placements of repro/launch/programs.py).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        [--steps 50] [--full --shape train_4k [--batch N] \
        [--microbatches K]] [--steps-json build/bench/torch_steps.json] ...
    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit \
        [--steps 50] [--batch N] [--full] \
        [--shape minibatch_lg|full_graph_sm|ogb_products|molecule] \
        [--ckpt-dir DIR] [--ckpt-every 25] [--lr 1e-3] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep \
        [--full] [--shape train_batch] ...
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-criteo \
        [--full] [--shape train_batch] ...
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch {xdeepfm|dien|bert4rec} [--full] [--shape train_batch] \
        [--microbatches K] ...
    torchrun --nproc-per-node N -m repro_torch.launch.train --dist \
        [--mesh DP,TP] [--compress none|bf16|int8] --arch ... \
        (or python -m torch.distributed.run ...)
    OMP_NUM_THREADS=1 torchrun --nproc-per-node 4 -m \
        repro_torch.launch.train --dist --mesh 2,2 --arch smollm-135m \
        --device cpu --steps 5      # the reduced LM on gloo ranks

Runs real training steps on synthetic data, as the JAX driver does:
  - without `--full` it runs the family's small config, the JAX
    driver's `reduced_model` (the LMs: 2 layers, d_model 64, 4 heads of
    16, d_ff 128, a vocab of 512, chunks of 32, f32, 8 experts of 48
    for the MoE archs, a window of 16 for gemma2-2b, on `TokenStream`
    sequences of 64 tokens; GraphSAGE: d_hidden 16 on the JAX driver's
    small graph, 512 nodes, 4096 edges, 32 features, fanout 5-3;
    wide-deep: 8 features, embed_dim 8, MLP 64-32, 512 rows a table;
    xDeepFM: the same and CIN 12-12; DIEN: 512 items, sequences of 16,
    embed_dim 8, GRU 16, MLP 32-16; BERT4Rec: 512 items, sequences of 16,
    embed_dim 16, 3 masked positions and 7 negatives; dlrm-criteo: 8
    features, embed_dim 16, 512 rows a table, bottom MLP 32-16, top MLP
    64-32-1, still bf16) at the JAX driver's batch of 32, so that the two
    drivers can be held together on the CPU; `--full` uses the arch's
    published config and `--shape <name>` one of its shapes
    (the LMs: train_4k, sequences of 4096, at `--batch` (the shape's
    256 does not fit one device); an LM whose parameters and optimizer
    state exceed one device's 80 GB, kimi-k2-1t-a32b, qwen2.5-32b and
    qwen2-moe-a2.7b, is refused before anything is allocated, its
    message naming the per-rank bytes a production mesh gives it;
    graphsage-reddit: any GNN shape, minibatch_lg: 1024 seed nodes,
    fanout 15-10, 602 features on 232,965 nodes; full_graph_sm: the
    whole Cora-sized graph, 2,708 nodes, 10,556 edges, 1,433 features,
    each step; ogb_products: the whole ogbn-products-sized graph,
    2,449,029 nodes, 61,859,140 edges, 100 features; molecule: batches
    of 128 graphs of up to 30 nodes and 64 edges, 32 features; without
    `--full` the same graphs at d_hidden 16; the recsys archs and
    dlrm-criteo: a train shape, train_batch: 65536 samples: synthetic
    Criteo records, `data/synthetic.CriteoStream`, for wide-deep, xDeepFM
    and dlrm-criteo, `dien_batch` and `bert4rec_batch` from the driver's
    seed-0 `RandomState` for the other two);
  - a full graph (`data/graphs.full_graph_batch`) is one batch, copied
    to the device once with its edges' SegmentPlan and reused every
    step (full-batch training); molecule draws a new batch of graphs
    (`data/graphs.molecule_batch`) a step;
  - `--microbatches K` accumulates the gradients of K slices of each
    batch before the one optimizer step (the reference's
    `make_train_step(..., microbatches=)`): the memory knob that fits
    xDeepFM's CIN, BERT4Rec's attention and the LMs' logits on one card;
  - checkpoints every --ckpt-every steps in the JAX package's on-disk
    layout (atomic, resumable, restorable by either package);
  - `--steps-json PATH` records the run's train step seconds (a mean
    over the steps after the first) with its arch, shape, batch,
    microbatches, dtype and device in a JSON list, which
    `benchmarks/torch_roofline.py` reads;
  - an InTune controller tunes the (simulated-machine) ingestion pipeline
    alongside, as a per-host controller would in production.

On a CUDA device (`--device cuda`, the default) GraphSAGE's minibatch
neighbour aggregations run through the hand-written Hopper kernel
`sage_aggregate` (its full-graph and molecule regimes aggregate by
gather and segment sum, in PyTorch, as the JAX package does in XLA),
wide-deep's lookups through `embedding_bag_fused`
(its wide arm) and `embedding_bag` (its deep tables), xDeepFM's through
`embedding_bag` (its tables) and `embedding_bag_fused` (its linear arm),
DIEN's and BERT4Rec's item gathers through `embedding_bag` as bags of
one, all with the `embedding_bag` scatter as their backward, and the
DLRM's bags and
interaction through `embedding_bag` and `dot_interact`, forward and
backward, in bf16; `--device cpu` runs their plain PyTorch versions.
The LM family has no TPU kernel on its path: it runs in plain PyTorch
on either device (models/transformer.py).

`--dist` joins the process group `torchrun` describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT; NCCL on `cuda`, gloo
on `cpu`, never one for the other) and trains on the (data, model) mesh
`--mesh DP,TP` (default: every rank on the data axis). The parameters
are placed by `launch/programs.Placement`: the tables of the row-sharded
lookups (`tp_lookup`: the DLRM's and wide-deep's tables over every axis,
BERT4Rec's items over the model axis) are this rank's row shards, their
gradients and optimizer state stay local (row-wise adagrad on the
shard), and everything else is replicated, its gradients averaged over
the data axes by `psum_tree` (`--compress`). Each data rank takes its
slice of the global batch, so the global batch is the shape's; the
losses printed and returned are the global batch's. A full graph on a
mesh takes the dst-partitioned loss (`full_graph_partitioned_loss`; the
reference's `partitioned` knob chooses it over GSPMD's edge-sharded
program, which the port does not have). A checkpoint is
gathered whole to rank 0 in the JAX layout and restored onto any mesh
(`train/elastic.reshard`). The LM family is placed by
`launch/programs.LMPlacement`, the reference's build_lm_program: every
parameter and optimizer-state tensor is this rank's block under the
reference's rules (FSDP over the data axes; heads, kv heads, mlp, vocab
and experts over the model axis; head_dim where the config sends it);
each rank draws only its own blocks of the seed's parameters
(`transformer.init_params(blocks=)`), and the fit check reckons one
rank's bytes (`check_fits_a_rank`); the residual stream is split on seq over the model ranks, the loss is
the vocab-parallel cross-entropy, and each rank's gradients are its
share of the global loss's (LMPlacement.reduce_grads sums them; the
replicated ones' sum over the data axes takes `--compress`); adafactor's
row and column means are the whole matrix's. With `--microbatches K`
each data rank's rows are its slices of the reference's K microbatches,
so that microbatch k holds the global batch's rows of the k-th K-th, as
the reference's scan slices them. The tests run the same `run(...)` on
gloo ranks through `mp.spawn` (`rank`, `world_size`, `init_method`).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.shardlib import ShardCtx
from repro_torch.configs.base import ArchSpec, GNNShape, LMShape, RecsysShape
from repro_torch.configs.registry import ONE_DEVICE_LIMIT, get_arch
from repro_torch.core.controller import InTune
from repro_torch.data.graphs import (full_graph_batch, molecule_batch,
                                     partitioned_batch)
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.sampler import CSRGraph, NeighborSampler
from repro_torch.data.simulator import MachineSpec
from repro_torch.data.synthetic import (CriteoStream, TokenStream,
                                        bert4rec_batch, dien_batch)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.programs import (LMPlacement, Placement, plan_bytes,
                                        rank_bytes)
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import collectives as coll
from repro_torch.train.elastic import reshard
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step

# the JAX driver's graph for the gnn family (repro/launch/train.py:82-85)
DRIVER_SHAPE = GNNShape("driver_small", "minibatch", n_nodes=512,
                        n_edges=4096, d_feat=32, batch_nodes=32,
                        fanout=(5, 3))
# the JAX driver's default batch for the recsys family (--batch 32)
RECSYS_DRIVER_SHAPE = RecsysShape("driver_small", "train", 32)
# the JAX driver's LM run: TokenStream sequences of 64, batch 32
LM_DRIVER_SHAPE = LMShape("driver_small", "train", 64, 32)
# one device's memory, against which an LM's --full run is reckoned
DEVICE_BYTES = 80e9

# per family: the shape without --shape, the kinds --shape may name, and
# the model module that maps parameter names to the JAX tree
_FAMILIES = {
    "lm": (LM_DRIVER_SHAPE, ("train",), tfm),
    "gnn": (DRIVER_SHAPE, ("minibatch", "full_graph", "batched_small"),
            gnn_lib),
    "recsys": (RECSYS_DRIVER_SHAPE, ("train",), recsys_lib),
    "dlrm": (RECSYS_DRIVER_SHAPE, ("train",), dlrm_lib),
}
# per shape kind: the loss of the gnn family (repro/launch/programs.py
# :260-262) and the name of the driver's rate, which says what it counts
_GNN_LOSSES = {"minibatch": gnn_lib.minibatch_loss,
               "full_graph": gnn_lib.full_graph_loss,
               "batched_small": gnn_lib.batched_graphs_loss}
_RATES = {"minibatch": "seed_nodes_per_s", "full_graph": "nodes_per_s",
          "batched_small": "graphs_per_s", "train": "samples_per_s"}


def _family(arch: ArchSpec) -> str:
    if arch.family not in _FAMILIES:
        raise KeyError(f"family {arch.family!r} of {arch.arch_id!r} is not "
                       f"ported to repro_torch.launch.train")
    return arch.family


def resolve_shape(arch: ArchSpec, name: str):
    """The arch's shape `name`, if its family's driver runs that kind;
    KeyError for a name the arch lacks (a recsys shape's name given to
    the gnn arch among them)."""
    shape = arch.shape(name)
    kinds = _FAMILIES[_family(arch)][1]
    if shape.kind not in kinds:
        raise KeyError(f"shape {name!r} is {shape.kind}: only the "
                       f"{'/'.join(kinds)} regime of {arch.arch_id} is "
                       f"ported (ROADMAP.md queue 1)")
    return shape


# ------------------------------------------------------- reduced configs ---
def reduced_model(arch: ArchSpec):
    """The JAX driver's CPU-sized config of the arch's family
    (repro/launch/train.py:39-67)."""
    m = arch.model
    if _family(arch) == "lm":
        # n_kv_heads must divide the reduced 4-head count
        kw = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=512,
                  n_heads=4, n_kv_heads=2 if m.n_kv_heads > 1 else 1,
                  head_dim=16, attn_chunk=32, param_dtype="float32")
        why = ("2 layers, d_model 64, 4 heads of 16, d_ff 128, a vocab of "
               "512, chunks of 32, f32")
        if m.is_moe:
            kw.update(n_experts=8, n_shared_experts=min(m.n_shared_experts, 2),
                      top_k=min(m.top_k, 2), d_expert=48)
            why += ", 8 experts of 48, top-2"
        if m.local_global_alternating:
            kw.update(sliding_window=16, scan_block=2)
            why += ", a window of 16"
        return m.replace(**kw, reduced=(f"the JAX driver's reduced_model: "
                                        f"{why}, for a CPU run",))
    if _family(arch) == "gnn":
        return m.replace(d_hidden=16)
    if _family(arch) == "dlrm":
        return m.replace(n_sparse=8, embed_dim=16, vocab_sizes=(512,) * 8,
                         bottom_mlp=(32, 16), top_mlp=(64, 32, 1),
                         reduced=("the JAX driver's reduced_model: 8 sparse "
                                  "features, embed_dim 16, 512 rows a "
                                  "table, bottom MLP 32-16, top MLP "
                                  "64-32-1, for a CPU run",))
    kw = dict(vocab_sizes=(512,) * max(len(m.vocab_sizes), 1))
    if m.name == "bert4rec":
        kw.update(n_items=512, seq_len=16, n_mask=3, n_negatives=7,
                  embed_dim=16)
        why = ("512 items, sequences of 16, embed_dim 16, 3 masked "
               "positions and 7 negatives")
    elif m.name == "dien":
        kw.update(seq_len=16, embed_dim=8, gru_dim=16, mlp_dims=(32, 16))
        why = "512 items, sequences of 16, embed_dim 8, GRU 16, MLP 32-16"
    else:
        n = min(m.n_sparse, 8)
        kw.update(n_sparse=n, embed_dim=8, mlp_dims=(64, 32),
                  vocab_sizes=(512,) * n)
        why = "8 sparse features, embed_dim 8, MLP 64-32, 512 rows a table"
        if m.cin_dims:
            kw.update(cin_dims=(12, 12))
            why += ", CIN 12-12"
    return m.replace(**kw, reduced=(f"the JAX driver's reduced_model: "
                                    f"{why}, for a CPU run",))


# ------------------------------------------------------- batch factories ---
def make_sampler(cfg, shape: GNNShape,
                 rng: np.random.RandomState) -> NeighborSampler:
    """The synthetic graph of `shape` (random CSR edges from seed 0,
    standard-normal features and uniform labels from `rng`), as the JAX
    driver builds it."""
    g = CSRGraph.random(shape.n_nodes, shape.n_edges, seed=0)
    x = rng.randn(shape.n_nodes, shape.d_feat).astype(np.float32)
    y = rng.randint(0, cfg.n_classes, shape.n_nodes)
    return NeighborSampler(g, x, y, fanout=tuple(shape.fanout))


def make_batch_fn(arch: ArchSpec, cfg, batch: int, rng: np.random.RandomState,
                  *, shape=DRIVER_SHAPE, device="cuda",
                  sampler: Optional[NeighborSampler] = None,
                  graph: Optional[dict] = None, mesh=None,
                  partitioned: bool = False, microbatches: int = 1):
    """A function returning the next batch on `device`: a sampled block
    of `shape`'s graph (gnn minibatch), the whole graph (gnn full graph:
    `graph`, its numpy batch if prebuilt, copied once, the same tensors
    every call), `batch` small graphs (gnn batched_small), synthetic
    Criteo records from seed 0 through the online feature work (dlrm,
    wide-deep, xDeepFM), or DIEN's and BERT4Rec's synthetic sequences
    drawn from `rng`, as the JAX driver makes them. On a `mesh` every
    rank makes the global batch and keeps its data rank's rows
    (`data_rows`: its slice of each of the `microbatches`), or with
    `partitioned` (a full graph) the whole graph in the dst-partitioned
    layout, with its own rank's edge plan."""
    if mesh is not None and not partitioned:
        dp, k = mesh.size(mesh.data_axes), mesh.index(mesh.data_axes)
        whole_fn = make_batch_fn(arch, cfg, batch, rng, shape=shape,
                                 device=device, sampler=sampler, graph=graph)
        if dp == 1:
            return whole_fn
        rows = torch.as_tensor(data_rows(batch, dp, k, microbatches))
        return lambda: {key: v[rows.to(v.device)]
                        for key, v in whole_fn().items()}
    to_device = lambda b: {k: torch.from_numpy(v).to(device)
                           for k, v in b.items()}
    if _family(arch) == "lm":
        stream = TokenStream(cfg.vocab_size, shape.seq_len)
        return lambda: to_device(stream.batch(batch))
    if cfg.name == "dien":
        return lambda: to_device(dien_batch(
            rng, batch, cfg.seq_len, cfg.vocab_sizes[0], cfg.n_dense))
    if cfg.name == "bert4rec":
        return lambda: to_device(bert4rec_batch(
            rng, batch, cfg.seq_len, cfg.n_items, cfg.n_mask,
            cfg.n_negatives))
    if _family(arch) in ("recsys", "dlrm"):
        stream = CriteoStream(n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                              vocab=cfg.vocab_sizes[0],
                              multi_hot=cfg.multi_hot)
        return lambda: to_device(
            stream.feature_udf(stream.raw_block(batch)))
    if shape.kind == "batched_small":
        return lambda: to_device(molecule_batch(shape, cfg.n_classes, rng,
                                                batch))
    if shape.kind == "full_graph":
        g = graph if graph is not None \
            else full_graph_batch(shape, cfg.n_classes, rng)
        if partitioned:
            axes = mesh.axis_names
            n_shards, k = mesh.size(axes), mesh.index(axes)
            whole = to_device(partitioned_batch(g, n_shards,
                                                cfg.partition_slack))
            n_loc = whole["x"].shape[0] // n_shards
            whole["part_plan"] = gnn_lib.partition_plan(
                whole["edge_src"][k], whole["edge_dst"][k], k * n_loc,
                n_loc, whole["x"].shape[0])
            return lambda: whole
        whole = to_device(g)
        whole["plan"] = gnn_lib.graph_plan(whole.pop("edge_src"),
                                           whole.pop("edge_dst"),
                                           shape.n_nodes)
        return lambda: whole
    sampler = sampler if sampler is not None else make_sampler(cfg, shape,
                                                               rng)
    return lambda: to_device(sampler.sample(batch))


def data_rows(batch: int, dp: int, k: int, microbatches: int = 1):
    """The global batch's rows that data rank k of dp holds: its slice of
    each of the `microbatches` consecutive slices, in order, so that the
    train step's split of its rows gives each microbatch the reference's
    rows (its scan's k-th slice of the global batch, split over the data
    ranks)."""
    if batch % (dp * microbatches):
        raise ValueError(f"a batch of {batch} does not split over {dp} "
                         f"data ranks in {microbatches} microbatches")
    mb, n = batch // microbatches, batch // (dp * microbatches)
    return np.concatenate([np.arange(j * mb + k * n, j * mb + (k + 1) * n)
                           for j in range(microbatches)])


def make_loss_fn(arch: ArchSpec, cfg, shape=DRIVER_SHAPE,
                 placement: Optional[Placement] = None):
    """loss(model, batch) of the arch's family, and for the gnn family of
    the shape's kind; on a mesh (`placement`) the row-sharded lookups',
    the partitioned graph's and the placed LM's."""
    if _family(arch) == "lm":
        if placement is not None:
            return lambda model, b: tfm.loss_fn(model, b,
                                                placement=placement)
        return tfm.loss_fn
    ctx = ShardCtx(placement.mesh) if placement is not None else None
    if _family(arch) == "recsys":
        return lambda model, b: recsys_lib.loss_fn(model, b, ctx=ctx)
    if _family(arch) == "dlrm":
        return lambda model, b: dlrm_lib.loss_fn(model, b, ctx=ctx)
    if placement is not None and placement.partitioned:
        return lambda model, b: gnn_lib.full_graph_partitioned_loss(
            model, b, placement.mesh)
    return _GNN_LOSSES[shape.kind]


def init_params_for(arch: ArchSpec, cfg, seed: int, *,
                    shape=DRIVER_SHAPE, device="cuda"):
    if _family(arch) == "lm":
        return tfm.init_params(cfg, seed=seed, device=device)
    if _family(arch) == "recsys":
        return recsys_lib.init_model(cfg, seed=seed, device=device)
    if _family(arch) == "dlrm":
        return dlrm_lib.init_params(cfg, seed=seed, device=device)
    return gnn_lib.init_params(cfg, d_feat=shape.d_feat, seed=seed,
                               device=device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_tree(lib, model, opt_state,
                placement: Optional[Placement] = None) -> dict:
    """The JAX layout's {"params", "opt_state"} tree; on a mesh every
    rank joins the gathers of the sharded tensors, made whole."""
    named = {k: p.detach() for k, p in model.named_parameters()}
    state = opt_state
    if placement is not None:
        named = placement.gather(named)
        state = {k: {n: placement.gather_state(n, t, key=k)
                     for n, t in v.items()}
                 for k, v in opt_state.items()}
    return {"params": lib.tree_from_named(named),
            "opt_state": {k: lib.tree_from_named(v)
                          for k, v in state.items()}}


def _restore_sharded(tree: dict, placement: Placement, device):
    """A whole checkpoint tree's params and optimizer state ({name:
    tensor} each) as this rank's shards (`reshard`)."""
    params = tree["params"]
    named = reshard(params, {k: placement.specs.get(k) for k in params},
                    placement.mesh, device=device)
    opt = {}
    for k, v in tree["opt_state"].items():
        specs = {n: placement.restore_specs(k, n, t) for n, t in v.items()}
        opt[k] = reshard(v, specs, placement.mesh, device=device)
    return named, opt


def lm_state_bytes(cfg, optimizer: str) -> int:
    """Bytes of an LM's parameters and its optimizer's f32 state, from
    the config's shapes alone (adam keeps m and v; adafactor a row and a
    column mean for a matrix of two dims of at least 128, else a full
    v; the others one f32 tensor a parameter): the byte plan of a mesh
    of one rank."""
    return plan_bytes(cfg, optimizer, LMShape("train", "train", 1, 1),
                      (1, 1))["total"]


def check_fits_one_device(arch: ArchSpec, cfg) -> None:
    """Raise, before anything is allocated, if an LM's parameters and
    optimizer state exceed one device's DEVICE_BYTES; the message names
    the bytes a rank holds on the (16, 16) production mesh
    (`rank_bytes`)."""
    if _family(arch) != "lm":
        return
    need = lm_state_bytes(cfg, arch.optimizer)
    if need > DEVICE_BYTES:
        mesh_shape = mesh_lib.PRODUCTION_SHAPES[1][0]
        per = rank_bytes(arch.arch_id, LMShape("train", "train", 1, 1),
                         mesh_shape)
        raise ValueError(
            f"{arch.arch_id} at its published widths needs "
            f"{need / 1e9:.1f} GB of parameters and {arch.optimizer} "
            f"state, over one device's {DEVICE_BYTES / 1e9:.0f} GB; on "
            f"the {mesh_shape} production mesh a rank holds "
            f"{per['total'] / 1e9:.2f} GB ({per['params']} bytes of "
            f"parameters, {per['opt_state']} of optimizer state): it "
            f"needs {ONE_DEVICE_LIMIT}")


def check_fits_a_rank(arch: ArchSpec, cfg, mesh_shape: tuple) -> None:
    """Raise, before anything is allocated, if one rank's blocks of an
    LM's parameters and optimizer state on the mesh of `mesh_shape`
    ((data, model); `plan_bytes`, from shapes alone) exceed one device's
    DEVICE_BYTES."""
    if _family(arch) != "lm":
        return
    per = plan_bytes(cfg, arch.optimizer, LMShape("train", "train", 1, 1),
                     mesh_shape)
    if per["total"] > DEVICE_BYTES:
        raise ValueError(
            f"{arch.arch_id} on the {tuple(mesh_shape)} mesh holds "
            f"{per['total'] / 1e9:.2f} GB a rank ({per['params']} bytes of "
            f"parameters, {per['opt_state']} of {arch.optimizer} state), "
            f"over one device's {DEVICE_BYTES / 1e9:.0f} GB: it needs a "
            f"mesh of more ranks")


def record_step(path: str, rec: dict) -> None:
    """Write `rec` into the JSON list at `path`, in place of any record
    of the same arch and shape."""
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)
    rows = [r for r in rows if (r["arch"], r["shape"])
            != (rec["arch"], rec["shape"])] + [rec]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


# ---------------------------------------------------------------- driver ---
def model_placement(arch: ArchSpec, cfg, shape, model, mesh) -> Placement:
    """The recsys, DLRM or GNN model's placement on `mesh`, the model's
    row-sharded parameters replaced by this rank's shards (a full graph
    takes the dst-partitioned loss's)."""
    placement = Placement(
        mesh, "dlrm" if _family(arch) == "dlrm" else cfg.name, cfg,
        {k: p.shape for k, p in model.named_parameters()},
        partitioned=_family(arch) == "gnn" and shape.kind == "full_graph")
    placement.shard_model(model)
    return placement


def build_step(arch: ArchSpec, cfg, shape, device, *, mesh=None,
               lr: float = 1e-3, microbatches: int = 1,
               compress: str = "none"):
    """The driver's model (this rank's blocks or shards on `mesh`), its
    optimizer state and its train step of `shape` (see `run`); returns
    (model, opt_state, step_fn(model, opt_state, step, batch), placement
    or None, the whole model's parameter count). The dry run's
    programs (launch/programs.build_program) build their train steps
    here too."""
    family = _family(arch)
    placement, opt_kw, grad_fn = None, {}, None
    if mesh is not None and family == "lm":
        # each rank draws its own blocks: no rank holds a whole tensor
        placement = LMPlacement(mesh, cfg, optimizer=arch.optimizer)
        model = tfm.init_params(cfg, seed=0, device=device,
                                blocks=placement.blocks())
        n_params = sum(math.prod(s) for s, _, _ in
                       tfm.param_shapes(cfg).values())
        if arch.optimizer == "adafactor":
            opt_kw["shards"] = placement.adafactor_shards()
    else:
        model = init_params_for(arch, cfg, 0, shape=shape, device=device)
        n_params = sum(p.numel() for p in model.parameters())
        if mesh is not None:
            placement = model_placement(arch, cfg, shape, model, mesh)
            if arch.optimizer == "rowwise_adagrad":
                opt_kw["global_numel"] = placement.global_numel()
    if placement is not None:
        opt_kw["norm_groups"] = placement.norm_groups()
        grad_fn = lambda g: placement.reduce_grads(g, compress)
    opt = make_optimizer(arch.optimizer, lr=lr, **opt_kw)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(make_loss_fn(arch, cfg, shape, placement), opt,
                              microbatches, grad_fn=grad_fn)
    return model, opt_state, step_fn, placement, n_params


def _batch_size(shape, batch: Optional[int]) -> int:
    """Seed nodes, graphs or samples a step: `batch`, else the shape's; a
    full graph is one batch of all its nodes."""
    if shape.kind == "full_graph":
        if batch not in (None, shape.n_nodes):
            raise ValueError(f"{shape.name} is one batch of its "
                             f"{shape.n_nodes} nodes, not {batch}")
        return shape.n_nodes
    if batch:
        return batch
    if shape.kind == "minibatch":
        return shape.batch_nodes
    if shape.kind == "batched_small":
        return shape.n_graphs
    return shape.batch


def run(arch_id: str, *, steps: int, batch: Optional[int] = None,
        shape=None, full: bool = False, lr: float = 1e-3,
        device="cuda", ckpt_dir: Optional[str] = None,
        ckpt_every: int = 25, sampler: Optional[NeighborSampler] = None,
        graph: Optional[dict] = None, log_every: int = 10,
        microbatches: int = 1, steps_json: Optional[str] = None,
        dist_run: bool = False, mesh_shape: Optional[tuple] = None,
        compress: str = "none", rank: Optional[int] = None,
        world_size: Optional[int] = None,
        init_method: Optional[str] = None) -> dict:
    """Train `steps` steps of `arch_id` on `shape`'s synthetic data (the
    family's driver shape if None) and return what the run measured.
    `sampler` is a prebuilt graph of a GNN minibatch `shape` and `graph`
    the numpy batch of a full-graph `shape` (one built once can serve
    several runs); `microbatches` splits each batch for gradient
    accumulation (`make_train_step`; a full graph takes none);
    `steps_json` names a JSON list to record the train step seconds in
    (`record_step`). Parameters and data all come from seed 0, as in the
    JAX driver. `dist_run` trains on a mesh of ranks (see the module
    docstring): `mesh_shape` (DP, TP), `compress` the replicated
    gradients' all-reduce, and `rank` / `world_size` / `init_method`
    where no `torchrun` environment gives them; a process group this
    call starts it also ends."""
    arch = get_arch(arch_id)
    family = _family(arch)
    if not dist_run:
        return _run(arch, steps=steps, batch=batch, shape=shape, full=full,
                    lr=lr, device=device, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, sampler=sampler, graph=graph,
                    log_every=log_every, microbatches=microbatches,
                    steps_json=steps_json)
    started = not dist.is_initialized()
    dev = mesh_lib.init_distributed(device, rank=rank,
                                    world_size=world_size,
                                    init_method=init_method)
    try:
        world = dist.get_world_size()
        dp, tp = mesh_shape or (world, 1)
        mesh = mesh_lib.make_mesh(dp, tp, dev, exchange_one_shard=True)
        return _run(arch, steps=steps, batch=batch, shape=shape, full=full,
                    lr=lr, device=dev, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, sampler=sampler, graph=graph,
                    log_every=log_every, microbatches=microbatches,
                    steps_json=steps_json, mesh=mesh, compress=compress)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(arch: ArchSpec, *, steps, batch, shape, full, lr, device,
         ckpt_dir, ckpt_every, sampler, graph, log_every, microbatches,
         steps_json, mesh=None, compress: str = "none") -> dict:
    arch_id = arch.arch_id
    family = _family(arch)
    default_shape, _, lib = _FAMILIES[family]
    shape = shape or default_shape
    rate_key = "tokens_per_s" if family == "lm" else _RATES[shape.kind]
    if shape.kind == "full_graph" and microbatches != 1:
        raise ValueError("a full graph is one batch: it takes no "
                         "microbatches")
    cfg = arch.model if full else reduced_model(arch)
    lm_mesh = mesh is not None and family == "lm"
    if lm_mesh:
        check_fits_a_rank(arch, cfg, tuple(mesh.shape[a]
                                           for a in mesh.axis_names))
    else:
        check_fits_one_device(arch, cfg)
    device = torch.device(device)
    batch = _batch_size(shape, batch)
    rng = np.random.RandomState(0)
    lead = mesh is None or dist.get_rank() == 0
    model, opt_state, step_fn, placement, n_params = build_step(
        arch, cfg, shape, device, mesh=mesh, lr=lr,
        microbatches=microbatches, compress=compress)
    if lead:
        print(f"arch={arch_id} family={family} params={n_params/1e6:.2f}M "
              f"optimizer={arch.optimizer} shape={shape.name} batch={batch} "
              f"microbatches={microbatches} device={device}"
              + (f" mesh={dict(mesh.shape)} compress={compress}"
                 if mesh is not None else ""))

    batch_fn = make_batch_fn(arch, cfg, batch, rng, shape=shape,
                             device=device, sampler=sampler, graph=graph,
                             mesh=mesh, microbatches=microbatches,
                             partitioned=bool(placement
                                              and placement.partitioned))

    tuner = InTune(criteo_pipeline(), MachineSpec(n_cpus=128), seed=0,
                   head="factored", finetune_ticks=100)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        tree, manifest = ckpt.restore(ckpt_dir, device=device)
        named = lib.named_from_tree(tree["params"])
        opt_state = {k: lib.named_from_tree(v)
                     for k, v in tree["opt_state"].items()}
        if placement is not None:
            named, opt_state = _restore_sharded(
                {"params": named, "opt_state": opt_state}, placement, device)
        model.load_state_dict(named)
        start = manifest["step"] + 1
        if lead:
            print(f"resumed from step {start - 1}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, fetch_s, step_times = [], 0.0, []
    t0 = time.monotonic()
    for i in range(start, steps):
        t_a = time.monotonic()
        b = batch_fn()
        _sync(device)
        t_b = time.monotonic()
        model, opt_state, metrics = step_fn(model, opt_state, i, b)
        loss = metrics["loss"]
        if isinstance(placement, LMPlacement):
            loss = metrics["global_loss"]     # every rank holds it
        elif placement is not None and not placement.partitioned:
            # the global batch's: the mean of the data ranks' equal slices
            loss = coll.psum_tree(loss.float(), mesh.data_group)
        losses.append(float(loss))                   # waits for the step
        t_c = time.monotonic()
        fetch_s += t_b - t_a
        step_times.append(t_c - t_b)
        tuner.tick()
        if i % log_every == 0 and lead:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"pipeline {tuner.history[-1]['throughput']:.1f} b/s")
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            tree = _state_tree(lib, model, opt_state, placement)
            if lead:
                ckpt.save(ckpt_dir, i, tree)
            del tree
            if mesh is not None:
                dist.barrier()
    wall = time.monotonic() - t0
    n = len(losses)
    train_s = sum(step_times)
    if shape.kind == "full_graph":
        # labelled nodes per second of train step
        labelled = int((batch_fn()["labels"] >= 0).sum())
        rate = n * labelled / train_s if n else None
    elif family == "lm":
        rate = n * batch * shape.seq_len / wall if n else None
    else:
        rate = n * batch / wall if n else None
    res = {
        "arch": arch_id, "shape": shape.name, "batch": batch, "steps": n,
        "microbatches": microbatches, "losses": losses, rate_key: rate,
        "loop_step_s": wall / n if n else None,
        "fetch_step_s": fetch_s / n if n else None,
        "train_step_s": train_s / n if n else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "compress": compress if mesh is not None else None,
        "reduced": list(getattr(cfg, "reduced", ())) + (
            [f"batch {shape.batch} -> {batch} of {shape.name}, for one "
             f"device's memory"] if family == "lm" and batch != shape.batch
            else []),
        # the train step after the first (which warms up the allocator
        # and the libraries), the roofline's measured seconds
        "warm_step_s": (sum(step_times[1:]) / (n - 1) if n > 1
                        else (step_times[0] if n else None)),
    }
    if steps_json and n and lead:
        record_step(steps_json, {
            "arch": arch_id, "shape": shape.name, "kind": shape.kind,
            "batch": batch, "seq_len": getattr(shape, "seq_len", None),
            "microbatches": microbatches, "steps": n,
            "step_s": res["warm_step_s"], "dtype": cfg.param_dtype,
            "reduced": res["reduced"],
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")})
    if n and lead:
        unit = rate_key[:-len("_per_s")].replace("_", " ")
        print(f"done: {n} steps in {wall:.1f}s; loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-5:]):.4f}; {res[rate_key]:.1f} {unit}/s, "
              f"{res['loop_step_s']*1e3:.1f} ms/step (batch + copy "
              f"{res['fetch_step_s']*1e3:.1f} ms, train step "
              f"{res['train_step_s']*1e3:.1f} ms)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="seed nodes, graphs or samples per step "
                         "(default: the shape's; 32 without --shape; a "
                         "full graph is one batch of all its nodes)")
    ap.add_argument("--full", action="store_true",
                    help="use the published config")
    ap.add_argument("--shape", default=None,
                    help="an LM's train shape (train_4k), a GNN shape "
                         "(minibatch_lg, full_graph_sm, ogb_products, "
                         "molecule) or a train shape of a recsys model or "
                         "the DLRM (train_batch); default the JAX driver's "
                         "small run")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation over this many slices of "
                         "each batch (default 1: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps-json", default=None,
                    help="a JSON list to record the train step seconds in "
                         "(benchmarks/torch_roofline.py reads it)")
    ap.add_argument("--dist", action="store_true",
                    help="train on a mesh of ranks: the process group "
                         "torchrun describes (nccl on cuda, gloo on cpu)")
    ap.add_argument("--mesh", default=None,
                    help="DP,TP: the (data, model) mesh of --dist "
                         "(default: every rank on the data axis)")
    ap.add_argument("--compress", default="none",
                    choices=("none", "bf16", "int8"),
                    help="the replicated gradients' all-reduce under "
                         "--dist (train/collectives.psum_tree)")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh is not None:
        if not args.dist:
            ap.error("--mesh needs --dist")
        mesh_shape = tuple(int(v) for v in args.mesh.split(","))
        if len(mesh_shape) != 2:
            ap.error(f"--mesh takes DP,TP, got {args.mesh!r}")
    shape = None
    if args.shape is not None:
        shape = resolve_shape(get_arch(args.arch), args.shape)
    return run(args.arch, steps=args.steps, batch=args.batch, shape=shape,
               full=args.full, lr=args.lr, device=args.device,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               microbatches=args.microbatches, steps_json=args.steps_json,
               dist_run=args.dist, mesh_shape=mesh_shape,
               compress=args.compress)


if __name__ == "__main__":
    main()
