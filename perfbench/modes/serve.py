"""The `serve` mode: the model's forward under `no_grad` on the mix's
`n_batches` resident batches in a cycle, each batch's last scores kept
on the device; once the window has closed, every kept score against the
reference's."""
from __future__ import annotations

import sys
import time

import torch

from perfbench.lib import correct, harness, traffic, weights


def run(cell, seed, seconds, trace, dev, t_start, fault):
    cfg, mix, mod = cell.cfg, cell.mix, cell.model
    model, score = mod.build_serve(cfg, dev)
    if fault is not None:
        score = fault("score", score, mod)
    weights.fill(model, mod.leaves(cfg), mod.TABLES, seed)
    batches = traffic.make(cfg, mix, seed, dev)
    nb = len(batches)
    outs = [None] * nb

    def step(k):
        with torch.profiler.record_function("score_step"):
            outs[k % nb] = score(batches[k % nb])

    for k in range(mix["warm_steps"]):
        step(k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_window = time.time()
    expected = {name: len(v) for name, v in mod.kernels(
        cfg, mix["batch"], 0, False).items()}
    n, wall, iv, stretch, why, traced = harness.window(
        step, seconds, trace, mix, dev, expected)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = None
    if trace:
        if why:
            print(f"trace: {why}", file=sys.stderr)
        tb = [batches[i % nb]["sparse_ids"] for i in range(*traced)] \
            if traced else []
        ctx = harness.ctx(cell, stretch, tb, False, None, None, n)
    outs = [o.detach().float().clone() if o is not None else None
            for o in outs]
    del model, score, step
    harness.free()
    e2e = {"samples_per_s": n * mix["batch"] / wall,
           "step_ms_p90": harness.p90(iv),
           "setup_s": t_window - t_start}
    metrics = harness.metrics(cell, e2e, ctx, trace)
    refs = correct.reference_scores(mod, cfg, seed, batches, device=dev)
    numbers = {"score_gap": correct.score_gap(outs, refs)}
    return harness.result(cell, n, metrics, harness.device_info(dev, peak),
                          harness.checks(cell, numbers), stretch)
