"""Generic training driver of the port: --arch <id> on one device (port of
repro/launch/train.py; the `gnn` family so far).

    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit \
        [--steps 50] [--batch 32] [--full] [--shape minibatch_lg] \
        [--ckpt-dir DIR] [--ckpt-every 25] [--lr 1e-3] [--device cuda]

Runs real training steps on synthetic data, as the JAX driver does:
  - without `--full` it runs the family's small config (d_hidden 16)
    on the JAX driver's small graph (512 nodes, 4096
    edges, 32 features, fanout 5-3), so that the two drivers can be held
    together on the CPU; `--full` uses the arch's published config and
    `--shape <name>` one of its minibatch shapes (minibatch_lg: 1024 seed
    nodes, fanout 15-10, 602 features on 232,965 nodes);
  - checkpoints every --ckpt-every steps in the JAX package's on-disk
    layout (atomic, resumable, restorable by either package);
  - an InTune controller tunes the (simulated-machine) ingestion pipeline
    alongside, as a per-host controller would in production.

The neighbour aggregations run through the hand-written Hopper kernel
`sage_aggregate` on a CUDA device (`--device cuda`, the default) and
through its plain PyTorch version with `--device cpu`. Archs the port
does not run yet raise KeyError naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, GNNShape
from repro_torch.configs.registry import get_arch
from repro_torch.core.controller import InTune
from repro_torch.data.pipeline import criteo_pipeline
from repro_torch.data.sampler import CSRGraph, NeighborSampler
from repro_torch.data.simulator import MachineSpec
from repro_torch.models import gnn as gnn_lib
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step

# the JAX driver's graph for the gnn family (repro/launch/train.py:82-85)
DRIVER_SHAPE = GNNShape("driver_small", "minibatch", n_nodes=512,
                        n_edges=4096, d_feat=32, batch_nodes=32,
                        fanout=(5, 3))


def _family(arch: ArchSpec):
    if arch.family != "gnn":
        raise KeyError(f"family {arch.family!r} of {arch.arch_id!r} is not "
                       f"ported to repro_torch.launch.train")


# ------------------------------------------------------- reduced configs ---
def reduced_model(arch: ArchSpec):
    _family(arch)
    return arch.model.replace(d_hidden=16)


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
                  *, shape: GNNShape = DRIVER_SHAPE, device="cuda",
                  sampler: Optional[NeighborSampler] = None):
    """A function returning the next sampled block on `device`."""
    _family(arch)
    sampler = sampler if sampler is not None else make_sampler(cfg, shape,
                                                               rng)
    return lambda: {k: torch.from_numpy(v).to(device)
                    for k, v in sampler.sample(batch).items()}


def make_loss_fn(arch: ArchSpec, cfg):
    _family(arch)
    return lambda model, b: gnn_lib.minibatch_loss(model, b)


def init_params_for(arch: ArchSpec, cfg, seed: int, *,
                    shape: GNNShape = DRIVER_SHAPE, device="cuda"):
    _family(arch)
    return gnn_lib.init_params(cfg, d_feat=shape.d_feat, seed=seed,
                               device=device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_tree(model, opt_state) -> dict:
    named = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": gnn_lib.tree_from_named(named),
            "opt_state": {k: gnn_lib.tree_from_named(v)
                          for k, v in opt_state.items()}}


# ---------------------------------------------------------------- driver ---
def run(arch_id: str, *, steps: int, batch: Optional[int] = None,
        shape: GNNShape = DRIVER_SHAPE, full: bool = False, lr: float = 1e-3,
        device="cuda", ckpt_dir: Optional[str] = None,
        ckpt_every: int = 25, sampler: Optional[NeighborSampler] = None,
        log_every: int = 10) -> dict:
    """Train `steps` steps of `arch_id` on `shape`'s synthetic graph and
    return what the run measured. `sampler` is a prebuilt graph of
    `shape` (one built once can serve several runs). Parameters,
    features, labels, the graph and the sampled neighbourhoods all come
    from seed 0, as in the JAX driver."""
    arch = get_arch(arch_id)
    cfg = arch.model if full else reduced_model(arch)
    device = torch.device(device)
    batch = batch or shape.batch_nodes
    rng = np.random.RandomState(0)
    model = init_params_for(arch, cfg, 0, shape=shape, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={arch_id} family={arch.family} params={n_params/1e6:.2f}M "
          f"optimizer={arch.optimizer} shape={shape.name} batch={batch} "
          f"device={device}")

    opt = make_optimizer(arch.optimizer, lr=lr)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(make_loss_fn(arch, cfg), opt)
    batch_fn = make_batch_fn(arch, cfg, batch, rng, shape=shape,
                             device=device, sampler=sampler)

    tuner = InTune(criteo_pipeline(), MachineSpec(n_cpus=128), seed=0,
                   head="factored", finetune_ticks=100)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        tree, manifest = ckpt.restore(ckpt_dir, device=device)
        model.load_state_dict(gnn_lib.named_from_tree(tree["params"]))
        opt_state = {k: gnn_lib.named_from_tree(v)
                     for k, v in tree["opt_state"].items()}
        start = manifest["step"] + 1
        print(f"resumed from step {start - 1}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, fetch_s, train_s = [], 0.0, 0.0
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
        train_s += t_c - t_b
        tuner.tick()
        if i % log_every == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"pipeline {tuner.history[-1]['throughput']:.1f} b/s")
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            ckpt.save(ckpt_dir, i, _state_tree(model, opt_state))
    wall = time.monotonic() - t0
    n = len(losses)
    res = {
        "arch": arch_id, "shape": shape.name, "batch": batch, "steps": n,
        "losses": losses,
        "seed_nodes_per_s": n * batch / wall if n else None,
        "loop_step_s": wall / n if n else None,
        "fetch_step_s": fetch_s / n if n else None,
        "train_step_s": train_s / n if n else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    if n:
        print(f"done: {n} steps in {wall:.1f}s; loss {losses[0]:.4f} -> "
              f"{np.mean(losses[-5:]):.4f}; {res['seed_nodes_per_s']:.1f} "
              f"seed nodes/s, {res['loop_step_s']*1e3:.1f} ms/step "
              f"(sampling + copy {res['fetch_step_s']*1e3:.1f} ms, train "
              f"step {res['train_step_s']*1e3:.1f} ms)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="seed nodes per step (default: the shape's; 32 "
                         "on the driver's small graph)")
    ap.add_argument("--full", action="store_true",
                    help="use the published config (d_hidden 128)")
    ap.add_argument("--shape", default=None,
                    help="a minibatch shape of the arch (minibatch_lg); "
                         "default the JAX driver's small graph")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shape = DRIVER_SHAPE
    if args.shape is not None:
        shape = get_arch(args.arch).shape(args.shape)
        if shape.kind != "minibatch":
            raise KeyError(f"shape {args.shape!r} is {shape.kind}: only the "
                           f"minibatch regime is ported (ROADMAP.md queue "
                           f"1, item 1)")
    return run(args.arch, steps=args.steps, batch=args.batch, shape=shape,
               full=args.full, lr=args.lr, device=args.device,
               ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
