"""The closed loop on the card: a tuned ProcessPipeline feeds a DLRM
adagrad train step, and InTune re-places the pipeline's workers from
the measured device idle time (port of `run_proc` in
examples/train_dlrm_criteo.py).

    python -m repro_torch.launch.train_dlrm_criteo [--steps 300]

A real ProcessPipeline runs the featurization stages (hashing / pooling
/ padding / collation, data/featurize.py) in worker processes; batches
cross to the device through `device_feed.make_train_feed` (pinned,
asynchronous copies + stall metering); the InTune controller tunes THIS
pipeline — the one the train step actually eats from — via `FeedBackend`
+ `Session.step`, observing measured `device_idle_frac` at the feed
boundary.

The model is `dlrm-criteo-1m` (repro_torch/configs/dlrm_criteo.py): the
paper's Criteo DLRM at its published widths, fp32 + adagrad, with 2^20
rows per table; its embedding bags and interaction run through the
hand-written Hopper kernels. Checkpointing and the simulated backend of
the JAX example are not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api import FeedBackend, Session
from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm_criteo import MODEL
from repro_torch.core.controller import InTune
from repro_torch.data.device_feed import make_train_feed
from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                        featurize_stage_fns, raw_block)
from repro_torch.data.pipeline import train_feed_pipeline
from repro_torch.data.proc_executor import ProcessPipeline
from repro_torch.data.simulator import Allocation, MachineSpec
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.train.optim import make_optimizer
from repro_torch.train.train_step import make_train_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(cfg: DLRMConfig, *, seed: int, device: torch.device):
    model = dlrm_lib.init_params(cfg, seed=seed, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {n_params/1e6:.1f}M params on {device}")
    opt = make_optimizer("adagrad", lr=0.02)
    step_fn = make_train_step(dlrm_lib.loss_fn, opt)
    return model, opt, step_fn


def run_proc(args, cfg: Optional[DLRMConfig] = None) -> dict:
    """The closed loop: tuned ProcessPipeline feeds the real train step.
    Returns what the run measured."""
    cfg = cfg if cfg is not None else MODEL
    device = torch.device(args.device)
    model, opt, step_fn = build_model(cfg, seed=args.seed, device=device)
    opt_state = opt.init(dict(model.named_parameters()))
    rec = RecordSpec(batch=args.batch, n_sparse=cfg.n_sparse,
                     n_dense=cfg.n_dense, vocab=cfg.vocab_sizes[0])

    # warm up + measure the raw device step time: the pipeline's CPU
    # budget (train_feed_pipeline cpu_share) is set relative to THIS,
    # so ingestion can keep up at a sane allocation but not at a bad one
    warm = {k: torch.as_tensor(v).to(device) for k, v in featurize_block(
        raw_block(np.random.RandomState(0), rec), rec).items()}
    model, opt_state, _ = step_fn(model, opt_state, 0, warm)
    _sync(device)
    t0 = time.monotonic()
    for k in range(3):
        model, opt_state, _ = step_fn(model, opt_state, k, warm)
    _sync(device)
    step_time = (time.monotonic() - t0) / 3
    print(f"measured device step time: {step_time*1e3:.1f} ms")

    spec = train_feed_pipeline(step_time_s=step_time, work="real")
    # n_cpus=12 bounds how far the tuner's exploration can over-place
    # workers; pin_cpus=1 leaves the host's remaining cores to the
    # trainer process, so the tuner's CPU headroom is contention-real
    machine = MachineSpec(n_cpus=12, mem_mb=4096)
    pipe = ProcessPipeline(spec, fns=featurize_stage_fns(spec, record=rec),
                           machine=machine, pin_cpus=1)
    pipe.set_allocation([1] * len(spec.stages), prefetch_mb=32.0)
    # timeout: a cold pipeline must push one batch through every stage
    # serially before anything reaches the sink
    feed = make_train_feed(pipe, depth=2, device=device,
                           timeout=max(120.0, 60.0 * step_time))
    # device_step_s: ingestion on a shared host steals silicon from the
    # trainer instead of letting it block, so device_idle_frac is scored
    # as 1 - device_busy/wall against the uncontended step time
    backend = FeedBackend(pipe, feed, device_step_s=step_time)
    # init_alloc: start the exploration walk where the pipe launched
    tuner = InTune(spec, machine, seed=args.seed, head="factored",
                   finetune_ticks=args.finetune_ticks,
                   init_alloc=Allocation(
                       np.ones(len(spec.stages), dtype=int),
                       prefetch_mb=32.0),
                   # live windows are noisy: visit-penalized incumbent
                   # tracking + switch hysteresis
                   lcb_coef=0.15, switch_margin=0.05)
    session = Session(backend, tuner)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, idle, idles = [], None, []
    t0 = time.monotonic()
    try:
        for i in range(args.steps):
            batch = next(feed)
            model, opt_state, metrics = step_fn(model, opt_state, i, batch)
            losses.append(float(metrics["loss"]))
            if i % args.tune_every == 0:
                _sync(device)  # close the step window
                tel = session.step()
                idle = tel.device_idle_frac
                idles.append(idle)
            if i % 25 == 0:
                rate = (i + 1) * args.batch / (time.monotonic() - t0)
                print(f"step {i:4d} loss {losses[-1]:.4f} "
                      f"({rate:,.0f} samples/s) device_idle "
                      f"{idle if idle is None else round(idle, 3)} "
                      f"workers {pipe.worker_counts()}")
        _sync(device)
        wall = time.monotonic() - t0
        workers = pipe.worker_counts()
    finally:
        acct = session.close()
        print(f"feed teardown: {acct}")
    print(f"final loss {np.mean(losses[-20:]):.4f} "
          f"(first-20 {np.mean(losses[:20]):.4f})")
    return {
        "steps": args.steps, "losses": losses,
        "samples_per_s": args.steps * args.batch / wall,
        "loop_step_s": wall / args.steps,
        "device_step_s": step_time,
        "device_idle_frac": idle, "device_idle_trace": idles,
        "workers": workers, "teardown": acct,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--tune-every", type=int, default=2,
                    help="train steps per tuning tick")
    ap.add_argument("--finetune-ticks", type=int, default=90,
                    help="InTune exploration budget before it serves its "
                         "incumbent best allocation")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return run_proc(ap.parse_args(argv))


if __name__ == "__main__":
    main()
