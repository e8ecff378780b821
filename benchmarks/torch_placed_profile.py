"""One placed train step against the unplaced one, profiled on the card:
what the placement (launch/programs.Placement) costs a step at a world
of one.

    PYTHONPATH=src python -m benchmarks.torch_placed_profile \
        [--arch wide-deep] [--steps 6] [--top 20] [--out PATH]

Builds the driver's step of `--arch` at its published widths and its
`train_batch` shape twice on one card (`launch/train.build_step`):
unplaced, and placed on a (1, 1) mesh with `exchange_one_shard` over a
process group of one NCCL rank, as `--dist --mesh 1,1` runs it; each
from seed 0, each on one batch of the driver's own (`make_batch_fn`),
drawn once. The two run in turns (unplaced, placed, placed, unplaced,
...), `--steps` timed steps each after one warm-up, each step timed with
CUDA events; then one step of each under torch.profiler. Prints each
variant's median step milliseconds and busy device milliseconds, its
kernels by self device time, the copies (`aten::copy_`, `aten::clone`,
`aten::contiguous` and their device time), the collectives, and the
kernels whose device time differs most between the two; writes the
record as JSON to `--out` (build/bench/torch_placed_profile.json).
`--device cpu` runs the same on the CPU over gloo at the driver's
reduced config (no device times: a check of the script alone).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import warnings

import numpy as np
import torch
import torch.distributed as dist

from benchmarks import torch_common
from repro_torch.configs.registry import get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train

OUT = os.path.join(torch_common.OUT_DIR, "torch_placed_profile.json")
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous")
COLLECTIVE_MARKS = ("nccl", "gloo", "c10d::", "record_param_comms")


def _dev_us(evt, self_only: bool) -> float:
    """An event's device microseconds (the profiler's name for them
    changed from cuda to device)."""
    for name in (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total",
                                    "cuda_time_total")):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_kernel(evt) -> bool:
    kind = getattr(evt, "device_type", None)
    return kind is not None and str(kind).endswith("CUDA")


def _variant(arch, cfg, shape, device, mesh):
    model, opt, step_fn, placement, _ = train.build_step(
        arch, cfg, shape, device, mesh=mesh)
    batch = train.make_batch_fn(
        arch, cfg, train._batch_size(shape, None), np.random.RandomState(0),
        shape=shape, device=device, mesh=mesh)()
    return {"model": model, "opt": opt, "fn": step_fn, "batch": batch,
            "step": 0, "ms": [], "placed": placement is not None}


def _step(v, device, timed: bool) -> float:
    """One step of variant v; its loss (waits for the step)."""
    cuda = device.type == "cuda"
    if cuda and timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
    v["model"], v["opt"], metrics = v["fn"](v["model"], v["opt"], v["step"],
                                            v["batch"])
    v["step"] += 1
    loss = float(metrics["loss"])
    if cuda and timed:
        end.record()
        torch.cuda.synchronize(device)
        v["ms"].append(start.elapsed_time(end))
    return loss


def _profile(v, device, top: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _step(v, device, timed=False)
    avgs = prof.key_averages()
    kernels = sorted(((e.key, e.count, _dev_us(e, True) / 1e3)
                      for e in avgs if _is_kernel(e)),
                     key=lambda r: -r[2])
    ops = {e.key: (e.count, _dev_us(e, False) / 1e3) for e in avgs
           if not _is_kernel(e)}
    return {
        "busy_ms": sum(ms for _, _, ms in kernels),
        "kernels": [{"name": k, "count": n, "ms": ms}
                    for k, n, ms in kernels],
        "top": [{"name": k, "count": n, "ms": ms}
                for k, n, ms in kernels[:top]],
        "copies": {k: {"count": n, "ms": ms} for k, (n, ms) in ops.items()
                   if k in COPY_OPS},
        "collectives": {k: {"count": n, "ms": ms}
                        for k, (n, ms) in ops.items()
                        if any(m in k for m in COLLECTIVE_MARKS)}}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run(arch_id: str = "wide-deep", steps: int = 6, top: int = 20,
        device: str = "cuda") -> dict:
    arch = get_arch(arch_id)
    shape = arch.shape("train_batch")
    cpu = device == "cpu"
    cfg = train.reduced_model(arch) if cpu else arch.model
    pg = tempfile.TemporaryDirectory(prefix="placed_profile_")
    dev = mesh_lib.init_distributed(device, rank=0, world_size=1,
                                    init_method=f"file://{pg.name}/pg")
    try:
        mesh = mesh_lib.make_mesh(1, 1, dev, exchange_one_shard=True)
        variants = {"unplaced": _variant(arch, cfg, shape, dev, None),
                    "placed": _variant(arch, cfg, shape, dev, mesh)}
        losses = {k: [_step(v, dev, timed=False)]
                  for k, v in variants.items()}
        order = ("unplaced", "placed", "placed", "unplaced")
        for i in range(steps * 2):
            k = order[i % 4]
            losses[k].append(_step(variants[k], dev, timed=True))
        prof = {k: _profile(v, dev, top) for k, v in variants.items()}
    finally:
        dist.destroy_process_group()
        pg.cleanup()
    rec = {"arch": arch_id, "shape": shape.name,
           "batch": train._batch_size(shape, None), "device": str(dev),
           "card": _card() if not cpu else "cpu",
           "reduced": list(cfg.reduced) if cpu else [],
           "losses": losses}
    for k, v in variants.items():
        rec[k] = {"step_ms": v["ms"],
                  "median_ms": statistics.median(v["ms"]) if v["ms"]
                  else None, **prof[k]}
    names = {r["name"] for k in variants for r in prof[k]["kernels"]}
    ms = {k: {r["name"]: r["ms"] for r in prof[k]["kernels"]}
          for k in variants}
    rec["diff"] = sorted(({"name": n, "placed_ms": ms["placed"].get(n, 0.0),
                           "unplaced_ms": ms["unplaced"].get(n, 0.0)}
                          for n in names),
                         key=lambda r: -abs(r["placed_ms"]
                                            - r["unplaced_ms"]))[:top]
    return rec


def report(rec: dict) -> None:
    print(f"== {rec['arch']}/{rec['shape']} batch {rec['batch']} on "
          f"{rec['card']} ==")
    for k in ("unplaced", "placed"):
        r = rec[k]
        print(f"{k}: median step {r['median_ms']} ms of {r['step_ms']}; "
              f"busy {r['busy_ms']:.3f} ms a profiled step")
        for t in r["top"]:
            print(f"  {t['ms']:10.3f} ms x{t['count']:4d} {t['name'][:100]}")
        print(f"  copies {json.dumps(r['copies'])}")
        print(f"  collectives {json.dumps(r['collectives'])}")
    print("placed - unplaced, by kernel (ms):")
    for d in rec["diff"]:
        print(f"  {d['placed_ms'] - d['unplaced_ms']:+10.3f} "
              f"({d['placed_ms']:.3f} vs {d['unplaced_ms']:.3f}) "
              f"{d['name'][:100]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wide-deep")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    rec = run(args.arch, args.steps, args.top, args.device)
    report(rec)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
