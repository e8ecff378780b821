"""The DLRM training loop with InTune on the card (port of
examples/train_dlrm_criteo.py), with the example's two backends.

    python -m repro_torch.launch.train_dlrm_criteo [--steps 300]
        [--backend proc|sim] [--ckpt-dir DIR] [--ckpt-every 100]

  --backend proc (default)  THE CLOSED LOOP (`run_proc`). A real
      ProcessPipeline runs the featurization stages (hashing / pooling /
      padding / collation, data/featurize.py) in worker processes;
      batches cross to the device through `device_feed.make_train_feed`
      (pinned, asynchronous copies + stall metering); the InTune
      controller tunes THIS pipeline — the one the train step actually
      eats from — via `FeedBackend` + `Session.step`, observing measured
      `device_idle_frac` at the feed boundary.

  --backend sim  (`run_sim`) the controller tunes a SIMULATED
      MachineSpec(n_cpus=128) Criteo pipeline, ticking once a train step,
      DETACHED from the data the model trains on: the batches come from
      an inline `data/synthetic.CriteoStream`, and nothing the tuner
      decides changes them. It demonstrates the controller loop, not a
      closed tuning loop.

The model is `dlrm-criteo-1m` (repro_torch/configs/dlrm_criteo.py): the
paper's Criteo DLRM at its published widths, fp32 + adagrad, with 2^20
rows per table; its embedding bags and interaction run through the
hand-written Hopper kernels.

With `--ckpt-dir`, both backends checkpoint as the example does: every
`--ckpt-every` steps and at the last step, the parameters, the adagrad
state and the InTune state (`save_step`), in the JAX package's layout
(train/checkpoint.py), so either launcher resumes the other's; a run
whose directory holds a checkpoint resumes after its step
(`restore_or_init`). Without it nothing is written: a checkpoint of
dlrm-criteo-1m is about 28 GB (tables and their adagrad state).
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
from repro_torch.data.pipeline import criteo_pipeline, train_feed_pipeline
from repro_torch.data.proc_executor import ProcessPipeline
from repro_torch.data.simulator import Allocation, MachineSpec
from repro_torch.data.synthetic import CriteoStream
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.train import checkpoint as ckpt
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


def restore_or_init(ckpt_dir: Optional[str], model, opt_state, tuner):
    """Resume from the newest checkpoint in `ckpt_dir`, if any: the
    parameters and optimizer state are copied into `model` and returned
    on its device, the tuner takes its saved agent and allocation.
    Returns (first step to run, model, opt_state)."""
    if not ckpt_dir or ckpt.latest_step(ckpt_dir) is None:
        return 0, model, opt_state
    device = next(model.parameters()).device
    tree, manifest = ckpt.restore(ckpt_dir, device)
    model.load_state_dict(dlrm_lib.named_from_tree(tree["params"]))
    opt_state = {k: dlrm_lib.named_from_tree(v)
                 for k, v in tree["opt_state"].items()}
    start = manifest["step"] + 1
    if "intune" in manifest["extras"]:
        ex = manifest["extras"]["intune"]
        qnet = {layer: {k: v.cpu().numpy() for k, v in p.items()}
                for layer, p in tree["intune_qnet"].items()}
        tuner.load_state_dict({
            "agent": {"qnet": qnet, "steps": ex["agent_steps"]},
            "workers": ex["workers"],
            "prefetch_mb": ex["prefetch_mb"]})
    print(f"resumed from step {start - 1}")
    return start, model, opt_state


def save_step(ckpt_dir: str, i: int, model, opt_state, tuner):
    """Checkpoint step `i`: the parameters and optimizer state in the JAX
    layout, the tuner's Q-network in the tree and its allocation and
    agent step count in `extras`, as the example writes them."""
    st = tuner.state_dict()
    named = {k: p.detach() for k, p in model.named_parameters()}
    ckpt.save(ckpt_dir, i,
              {"params": dlrm_lib.tree_from_named(named),
               "opt_state": {k: dlrm_lib.tree_from_named(v)
                             for k, v in opt_state.items()},
               "intune_qnet": st["agent"]["qnet"]},
              extras={"intune": {
                  "workers": st["workers"],
                  "prefetch_mb": st["prefetch_mb"],
                  "agent_steps": st["agent"]["steps"]}})


def _checkpoint_due(args, i: int) -> bool:
    every = getattr(args, "ckpt_every", 0)
    return bool(getattr(args, "ckpt_dir", None)) and (
        (every and (i + 1) % every == 0) or i == args.steps - 1)


def _window(i: int, tel) -> dict:
    """What one tuning window measured (FeedBackend's raw deltas): the
    idle reading is 1 - min(batches, produced) * device step / wall."""
    ex = tel.extras
    return {"step": i, "idle": tel.device_idle_frac,
            "produced": ex["produced"], "consumed": ex["consumed"],
            "batches": ex["batches"], "wall_s": ex["wall_s"],
            "settling": ex["settling"], "workers": list(ex["workers"]),
            "prefetch_mb": ex["prefetch_mb"],
            "out_queue": ex["queue_sizes"][-1]}


def run_proc(args, cfg: Optional[DLRMConfig] = None, *,
             policy=None) -> dict:
    """The closed loop: tuned ProcessPipeline feeds the real train step.
    `policy` (a FrozenPolicy, say) places the workers in the tuner's
    stead; the tuner is still built, checkpointed and resumed. Returns
    what the run measured, each tuning window's readings (`windows`),
    and the model, optimizer state and tuner as the run left them."""
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
    session = Session(backend, policy if policy is not None else tuner)

    start, model, opt_state = restore_or_init(
        getattr(args, "ckpt_dir", None), model, opt_state, tuner)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, idle, idles, windows = [], None, [], []
    t0 = time.monotonic()
    try:
        for i in range(start, args.steps):
            batch = next(feed)
            model, opt_state, metrics = step_fn(model, opt_state, i, batch)
            losses.append(float(metrics["loss"]))
            if i % args.tune_every == 0:
                _sync(device)  # close the step window
                tel = session.step()
                idle = tel.device_idle_frac
                idles.append(idle)
                windows.append(_window(i, tel))
            if i % 25 == 0:
                rate = (i - start + 1) * args.batch / (time.monotonic() - t0)
                print(f"step {i:4d} loss {losses[-1]:.4f} "
                      f"({rate:,.0f} samples/s) device_idle "
                      f"{idle if idle is None else round(idle, 3)} "
                      f"workers {pipe.worker_counts()}")
            if _checkpoint_due(args, i):
                save_step(args.ckpt_dir, i, model, opt_state, tuner)
        _sync(device)
        wall = time.monotonic() - t0
        workers = pipe.worker_counts()
    finally:
        acct = session.close()
        print(f"feed teardown: {acct}")
    n = len(losses)
    if n:
        print(f"final loss {np.mean(losses[-20:]):.4f} "
              f"(first-20 {np.mean(losses[:20]):.4f})")
    return {
        "start": start, "steps": args.steps, "losses": losses,
        "samples_per_s": n * args.batch / wall,
        "loop_step_s": wall / n if n else None,
        "device_step_s": step_time,
        "device_idle_frac": idle, "device_idle_trace": idles,
        "windows": windows, "workers": workers, "teardown": acct,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "model": model, "opt_state": opt_state, "tuner": tuner,
    }


def run_sim(args, cfg: Optional[DLRMConfig] = None) -> dict:
    """The tuner ticks a simulated 128-CPU machine once a train step; the
    batches fed to the model come from an inline CriteoStream and are
    unaffected by anything the tuner decides. Returns what the run
    measured, the tuner's allocation at each tick, and the model,
    optimizer state and tuner as the run left them."""
    cfg = cfg if cfg is not None else MODEL
    device = torch.device(args.device)
    model, opt, step_fn = build_model(cfg, seed=args.seed, device=device)
    opt_state = opt.init(dict(model.named_parameters()))
    stream = CriteoStream(n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                          vocab=cfg.vocab_sizes[0])
    tuner = InTune(criteo_pipeline(), MachineSpec(n_cpus=128), seed=0,
                   head="factored", finetune_ticks=150)
    start, model, opt_state = restore_or_init(
        getattr(args, "ckpt_dir", None), model, opt_state, tuner)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, allocations = [], []
    t0 = time.monotonic()
    for i in range(start, args.steps):
        batch = stream.feature_udf(stream.raw_block(args.batch))
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        model, opt_state, metrics = step_fn(model, opt_state, i, batch)
        # simulated-pipeline tuning in lockstep with the train steps; the
        # closed-loop form is `--backend proc` (FeedBackend + Session.step)
        tick = tuner.tick()
        allocations.append(([int(w) for w in tick["workers"]],
                            float(tick["prefetch_mb"])))
        losses.append(float(metrics["loss"]))
        if i % 25 == 0:
            rate = (i - start + 1) * args.batch / (time.monotonic() - t0)
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({rate:,.0f} samples/s) sim pipeline "
                  f"{tuner.history[-1]['throughput']:.1f} b/s")
        if _checkpoint_due(args, i):
            save_step(args.ckpt_dir, i, model, opt_state, tuner)
    _sync(device)
    wall = time.monotonic() - t0
    n = len(losses)
    if n:
        print(f"final loss {np.mean(losses[-20:]):.4f} "
              f"(first-20 {np.mean(losses[:20]):.4f})")
    return {
        "start": start, "steps": args.steps, "losses": losses,
        "allocations": allocations,
        "samples_per_s": n * args.batch / wall,
        "loop_step_s": wall / n if n else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "model": model, "opt_state": opt_state, "tuner": tuner,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--backend", choices=("proc", "sim"), default="proc",
                    help="proc = tuned ProcessPipeline actually feeds the "
                         "train step (closed loop); sim = tuner runs "
                         "against a simulated machine DETACHED from the "
                         "inline data the model trains on")
    ap.add_argument("--tune-every", type=int, default=2,
                    help="proc backend: train steps per tuning tick")
    ap.add_argument("--finetune-ticks", type=int, default=90,
                    help="proc backend: InTune exploration budget before "
                         "it serves its incumbent best allocation")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="checkpoint cadence in steps; 0 = final step only")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint and resume here (the JAX layout); "
                         "none by default: dlrm-criteo-1m's is about 28 GB")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return (run_proc if args.backend == "proc" else run_sim)(args)


if __name__ == "__main__":
    main()
