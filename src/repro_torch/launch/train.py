"""Generic training driver of the port: --arch <id> on one device (port of
repro/launch/train.py: the `lm`, `gnn`, `recsys` and `dlrm` families).

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
    qwen2-moe-a2.7b, is refused before anything is allocated;
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

from repro_torch.configs.base import ArchSpec, GNNShape, LMShape, RecsysShape
from repro_torch.configs.registry import ONE_DEVICE_LIMIT, get_arch
from repro_torch.core.controller import InTune
from repro_torch.data.graphs import full_graph_batch, molecule_batch
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.sampler import CSRGraph, NeighborSampler
from repro_torch.data.simulator import MachineSpec
from repro_torch.data.synthetic import (CriteoStream, TokenStream,
                                        bert4rec_batch, dien_batch)
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as ckpt
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
                  graph: Optional[dict] = None):
    """A function returning the next batch on `device`: a sampled block
    of `shape`'s graph (gnn minibatch), the whole graph (gnn full graph:
    `graph`, its numpy batch if prebuilt, copied once, the same tensors
    every call), `batch` small graphs (gnn batched_small), synthetic
    Criteo records from seed 0 through the online feature work (dlrm,
    wide-deep, xDeepFM), or DIEN's and BERT4Rec's synthetic sequences
    drawn from `rng`, as the JAX driver makes them."""
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
        whole = to_device(graph if graph is not None
                          else full_graph_batch(shape, cfg.n_classes, rng))
        whole["plan"] = gnn_lib.graph_plan(whole.pop("edge_src"),
                                           whole.pop("edge_dst"),
                                           shape.n_nodes)
        return lambda: whole
    sampler = sampler if sampler is not None else make_sampler(cfg, shape,
                                                               rng)
    return lambda: to_device(sampler.sample(batch))


def make_loss_fn(arch: ArchSpec, cfg, shape=DRIVER_SHAPE):
    """loss(model, batch) of the arch's family, and for the gnn family of
    the shape's kind."""
    if _family(arch) == "lm":
        return tfm.loss_fn
    if _family(arch) == "recsys":
        return lambda model, b: recsys_lib.loss_fn(model, b)
    if _family(arch) == "dlrm":
        return lambda model, b: dlrm_lib.loss_fn(model, b)
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


def _state_tree(lib, model, opt_state) -> dict:
    named = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": lib.tree_from_named(named),
            "opt_state": {k: lib.tree_from_named(v)
                          for k, v in opt_state.items()}}


def lm_state_bytes(cfg, optimizer: str) -> int:
    """Bytes of an LM's parameters and its optimizer's f32 state, from
    the config's shapes alone (adam keeps m and v; adafactor a row and a
    column mean for a matrix of two dims of at least 128, else a full
    v; the others one f32 tensor a parameter)."""
    total = 0
    for shape, _, dtype in tfm.param_shapes(cfg).values():
        n = math.prod(shape)
        total += n * torch.empty((), dtype=dtype).element_size()
        if optimizer == "adafactor" and len(shape) >= 2 \
                and min(shape[-2:]) >= 128:
            total += 4 * (n // shape[-1] + n // shape[-2])
        else:
            total += 4 * n * (2 if optimizer == "adam" else 1)
    return total


def check_fits_one_device(arch: ArchSpec, cfg) -> None:
    """Raise, before anything is allocated, if an LM's parameters and
    optimizer state exceed one device's DEVICE_BYTES."""
    if _family(arch) != "lm":
        return
    need = lm_state_bytes(cfg, arch.optimizer)
    if need > DEVICE_BYTES:
        raise ValueError(
            f"{arch.arch_id} at its published widths needs "
            f"{need / 1e9:.1f} GB of parameters and {arch.optimizer} "
            f"state, over one device's {DEVICE_BYTES / 1e9:.0f} GB: its "
            f"full-width training waits on {ONE_DEVICE_LIMIT}")


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
        microbatches: int = 1, steps_json: Optional[str] = None) -> dict:
    """Train `steps` steps of `arch_id` on `shape`'s synthetic data (the
    family's driver shape if None) and return what the run measured.
    `sampler` is a prebuilt graph of a GNN minibatch `shape` and `graph`
    the numpy batch of a full-graph `shape` (one built once can serve
    several runs); `microbatches` splits each batch for gradient
    accumulation (`make_train_step`; a full graph takes none);
    `steps_json` names a JSON list to record the train step seconds in
    (`record_step`). Parameters and data all come from seed 0, as in the
    JAX driver."""
    arch = get_arch(arch_id)
    family = _family(arch)
    default_shape, _, lib = _FAMILIES[family]
    shape = shape or default_shape
    rate_key = "tokens_per_s" if family == "lm" else _RATES[shape.kind]
    if shape.kind == "full_graph" and microbatches != 1:
        raise ValueError("a full graph is one batch: it takes no "
                         "microbatches")
    cfg = arch.model if full else reduced_model(arch)
    check_fits_one_device(arch, cfg)
    device = torch.device(device)
    batch = _batch_size(shape, batch)
    rng = np.random.RandomState(0)
    model = init_params_for(arch, cfg, 0, shape=shape, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={arch_id} family={family} params={n_params/1e6:.2f}M "
          f"optimizer={arch.optimizer} shape={shape.name} batch={batch} "
          f"microbatches={microbatches} device={device}")

    opt = make_optimizer(arch.optimizer, lr=lr)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(make_loss_fn(arch, cfg, shape), opt,
                              microbatches)
    batch_fn = make_batch_fn(arch, cfg, batch, rng, shape=shape,
                             device=device, sampler=sampler, graph=graph)

    tuner = InTune(criteo_pipeline(), MachineSpec(n_cpus=128), seed=0,
                   head="factored", finetune_ticks=100)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        tree, manifest = ckpt.restore(ckpt_dir, device=device)
        model.load_state_dict(lib.named_from_tree(tree["params"]))
        opt_state = {k: lib.named_from_tree(v)
                     for k, v in tree["opt_state"].items()}
        start = manifest["step"] + 1
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
        losses.append(float(metrics["loss"]))        # waits for the step
        t_c = time.monotonic()
        fetch_s += t_b - t_a
        step_times.append(t_c - t_b)
        tuner.tick()
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"pipeline {tuner.history[-1]['throughput']:.1f} b/s")
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            ckpt.save(ckpt_dir, i, _state_tree(lib, model, opt_state))
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
        "reduced": list(getattr(cfg, "reduced", ())) + (
            [f"batch {shape.batch} -> {batch} of {shape.name}, for one "
             f"device's memory"] if family == "lm" and batch != shape.batch
            else []),
        # the train step after the first (which warms up the allocator
        # and the libraries), the roofline's measured seconds
        "warm_step_s": (sum(step_times[1:]) / (n - 1) if n > 1
                        else (step_times[0] if n else None)),
    }
    if steps_json and n:
        record_step(steps_json, {
            "arch": arch_id, "shape": shape.name, "kind": shape.kind,
            "batch": batch, "seq_len": getattr(shape, "seq_len", None),
            "microbatches": microbatches, "steps": n,
            "step_s": res["warm_step_s"], "dtype": cfg.param_dtype,
            "reduced": res["reduced"],
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")})
    if n:
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
    args = ap.parse_args(argv)
    shape = None
    if args.shape is not None:
        shape = resolve_shape(get_arch(args.arch), args.shape)
    return run(args.arch, steps=args.steps, batch=args.batch, shape=shape,
               full=args.full, lr=args.lr, device=args.device,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               microbatches=args.microbatches, steps_json=args.steps_json)


if __name__ == "__main__":
    main()
