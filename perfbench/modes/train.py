"""The `train` mode: the port's train step back to back on the batches
of the mix's feed (`perfbench/feeds/<feed>.py`). Set-up fills the
program's parameters from the seed, takes the first three steps through
the window's own call and feed (the checked steps, `correct.
checked_steps`), then `warm_steps` more. Once the window has closed and
the program's state is freed, the reference follows the checked steps."""
from __future__ import annotations

import sys
import time

import torch

from perfbench.lib import correct, harness, weights
from perfbench.lib.trace import TRIES


def run(cell, seed, seconds, trace, dev, t_start, fault):
    cfg, mix, mod = cell.cfg, cell.mix, cell.model
    model, opt_state, step_fn = mod.build_train(cfg, mix["batch"], dev)
    if fault is not None:
        step_fn = fault("step", step_fn, mod)
    weights.fill(model, mod.leaves(cfg), mod.TABLES, seed)
    feed = cell.part("feeds", mix["feed"]).make(cfg, mix, seed, dev)
    state = {"model": model, "opt": opt_state}
    step0 = cfg["optimizer"]["first_step"]

    def one(k, batch):
        with torch.profiler.record_function("train_step"):
            state["model"], state["opt"], m = step_fn(
                state["model"], state["opt"], step0 + k, batch)
        return m

    def fetch():
        with torch.profiler.record_function("feed.next"):
            return feed.next()

    first = [fetch() for _ in range(3)]
    obs = correct.checked_steps(one, state, first, cfg, mod)
    checked = [{k: v.clone() for k, v in b.items()} for b in first]
    del first
    k = 3
    for _ in range(mix["warm_steps"]):
        one(k, fetch())
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_window = time.time()
    c0 = feed.counters()
    traced_ids = {}     # the traced steps' ids, by step, for their kernels

    def step(n):
        b = fetch()
        one(k + n, b)
        if trace and mix["trace_after"] <= n \
                < mix["trace_after"] + TRIES * mix["trace_steps"]:
            traced_ids[n] = b["sparse_ids"]

    expected = {name: len(v) for name, v in mod.kernels(
        cfg, mix["batch"], 0, True).items()}
    n, wall, iv, stretch, why, traced = harness.window(
        step, seconds, trace, mix, dev, expected)
    c1 = feed.counters()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = None
    if trace:
        if why:
            print(f"trace: {why}", file=sys.stderr)
        tb = [traced_ids[i] for i in range(*traced)] if traced else []
        ctx = harness.ctx(cell, stretch, tb, True, c0, c1, n)
    del traced_ids
    feed.close()
    state.clear()
    del model, opt_state, step_fn, one, step
    harness.free()
    e2e = {"samples_per_s": n * mix["batch"] / wall,
           "step_ms_p90": harness.p90(iv),
           "setup_s": t_window - t_start}
    metrics = harness.metrics(cell, e2e, ctx, trace)
    numbers, ref_batches = feed.check(cfg, checked)
    ref = correct.reference_train(mod, cfg, seed, ref_batches, device=dev)
    numbers.update(correct.train_numbers(obs, ref))
    return harness.result(cell, n, metrics, harness.device_info(dev, peak),
                          harness.checks(cell, numbers), stretch)
