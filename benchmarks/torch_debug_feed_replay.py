"""Instrumented intune-arm replay for torch_fig_train_feed (diagnostic, not
CI; the port of benchmarks/debug_feed_replay.py).

Prints per-tick: measured idle, worker placement, retired-but-alive
worker counts per pool, and 1-min loadavg — to watch whether a
resize-down returns silicon promptly (fast-retire) or ghost processes
linger and degrade serving windows. The train step is the scorer's
(`torch_fig_train_feed.build_model` at the reference's demo DLRM) on
`--device`, the card unless asked for the CPU.

    PYTHONPATH=src python -m benchmarks.torch_debug_feed_replay \\
        [--device cpu] [--steps 80]
"""
import argparse
import os

import numpy as np
import torch

from benchmarks import torch_common as common
from benchmarks.torch_fig_train_feed import (DEMO, SEED, build_model,
                                             measure_step_time)
from repro_torch.api import FeedBackend, Session
from repro_torch.data.device_feed import make_train_feed
from repro_torch.data.featurize import RecordSpec, featurize_stage_fns
from repro_torch.data.pipeline import train_feed_pipeline
from repro_torch.data.proc_executor import ProcessPipeline
from repro_torch.data.simulator import Allocation, MachineSpec


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    steps, tune_every, warm_steps = args.steps, 2, 16
    post_warm = max(1, (steps - warm_steps) // tune_every)
    finetune = max(10, post_warm * 2 // 5)
    cfg = DEMO
    model, opt_state, step_fn = build_model(cfg, seed=SEED, device=device)
    rec = RecordSpec(batch=512, n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                     vocab=cfg.vocab_sizes[0])
    step_time = measure_step_time(step_fn, model, opt_state, rec, device)
    # measure_step_time trains the model: start the replay from the seed
    model, opt_state, _ = build_model(cfg, seed=SEED, device=device)
    print(f"step_time {step_time*1e3:.1f}ms finetune={finetune}")
    spec = train_feed_pipeline(step_time_s=step_time, work="real")
    machine = MachineSpec(n_cpus=30, mem_mb=4096)
    pipe = ProcessPipeline(spec, fns=featurize_stage_fns(spec, record=rec),
                           machine=machine, pin_cpus=1)
    optimizer = common.make_tuner(
        spec, machine, seed=0, finetune_ticks=finetune,
        init_alloc=Allocation(np.ones(spec.n_stages, dtype=int),
                              2.0 * spec.batch_mb),
        explore_restart_every=12)
    init = optimizer.propose(spec, machine, None)
    pipe.set_allocation(list(init.workers), init.prefetch_mb)
    feed = make_train_feed(pipe, depth=2, device=device,
                           timeout=max(120.0, 200.0 * step_time))
    backend = FeedBackend(pipe, feed, device_step_s=step_time)
    session = Session(backend, optimizer)
    losses = []
    try:
        for i in range(steps):
            batch = next(feed)
            model, opt_state, metrics = step_fn(model, opt_state, i, batch)
            losses.append(metrics["loss"].detach())
            if (i + 1) % tune_every == 0:
                _sync(device)
                retired = [sum(1 for p in pool._retired if p.is_alive())
                           for pool in pipe.pools]
                load = os.getloadavg()[0]
                rss = pipe.rss_mb()
                avail = 0
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemAvailable:"):
                            avail = int(line.split()[1]) // 1024
                            break
                if i < warm_steps:
                    m = backend.measure()
                    print(f"t{i:3d} WARM idle={m.get('device_idle_frac'):.3f}"
                          f" w={pipe.worker_counts()} ret={retired}"
                          f" load={load:.1f} rss={rss:.0f} avail={avail}")
                    continue
                m = backend.measure()
                if m.extras.get("settling"):
                    # centralized post-resize settle flag (FeedBackend)
                    print(f"t{i:3d} SETT idle={m.device_idle_frac:.3f}"
                          f" prod={m.extras.get('produced')}"
                          f" w={pipe.worker_counts()} ret={retired}"
                          f" load={load:.1f} rss={rss:.0f} avail={avail}")
                    continue
                before = (list(pipe.worker_counts()), pipe.prefetch_mb)
                tel = session.step(m)
                after = (list(pipe.worker_counts()), pipe.prefetch_mb)
                tag = "MOVE" if after != before else "tick"
                idle = tel.device_idle_frac
                print(f"t{i:3d} {tag} idle="
                      f"{idle if idle is None else round(idle, 3)}"
                      f" w={before[0]}->{after[0]} ret={retired}"
                      f" load={load:.1f} rss={rss:.0f} avail={avail}")
    finally:
        acct = session.close()
    print("teardown:", acct)
    best = getattr(optimizer, "best", None)
    print("best:", best)
    stats = getattr(optimizer, "_alloc_stats", {})
    for k, (n, mu) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
        print(f"  alloc {list(k[0])} pf={k[1]:.0f}: n={n} mean={mu:.3f}")
    return {"losses": [float(x) for x in losses], "teardown": acct}


if __name__ == "__main__":
    main()
