"""One run of one cell: set-up, the measured window, the check of what
the window's path produced, and the result line.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration's file (`configs[].file`), its mix
`perfbench/traffic/<traffic>.json`, its limits `perfbench/limits/<cell>
.json`, the configuration's model adapter `perfbench/models/<model>.py`,
the mix's mode `perfbench/modes/<mode>.py` (which runs the set-up, the
window and the check) and feed `perfbench/feeds/<feed>.py`, and each
per-layer metric's reader `perfbench/metrics/<metric>.py`. A later mix,
model or metric of another kind is a file of its own.

The window (`window`) runs steps until `--seconds` of host time have
passed and ends with `torch.cuda.synchronize()`. Nothing syncs inside
it. A CUDA event after each step gives the steps' intervals on the
device's clock. With `--trace 1` a stretch of `trace_steps` steps,
`trace_after` steps into the window, is traced (`lib/trace.py`) and the
per-layer metrics are read from it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch


ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
H100_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12


def process_start() -> Optional[float]:
    """This process's start on the wall clock (from /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Whole top-level names in sys.modules that the run may not hold."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json with everything it names, loaded."""

    def __init__(self, name: str, root: Path = ROOT,
                 bench: Optional[dict] = None):
        self.root = Path(root)
        pb = self.root / "perfbench"
        if bench is None:
            bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = json.loads((self.root / conf["file"]).read_text())
        self.mix = json.loads(
            (pb / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads(
            (pb / "limits" / f"{name}.json").read_text())
        self.model = _load_module(pb / "models" / f"{self.cfg['model']}.py",
                                  f"perfbench_model_{self.cfg['model']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def part(self, kind: str, name: str):
        """The module `perfbench/<kind>/<name>.py` of this checkout."""
        return _load_module(self.root / "perfbench" / kind / f"{name}.py",
                            f"perfbench_{kind}_{name}")

    def reader(self, metric: str):
        return self.part("metrics", metric)


class Clock:
    """A mark after each step: CUDA events on the card, the host clock
    (after the step, which the CPU runs synchronously) otherwise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m[:-1], m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m[:-1], m[1:])]


class Ctx:
    """What a per-layer metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def p90(values) -> float:
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


# ------------------------------------------------------------------- run --
def uniq_rows(batch: dict) -> int:
    """Distinct rows a batch's ids read, over all features."""
    ids = batch["sparse_ids"]
    return int(sum(torch.unique(ids[:, f]).numel()
                   for f in range(ids.shape[1])))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None,
        fault: Optional[Callable] = None) -> dict:
    """Run `cell` once; returns the result line (with `checks`).
    `fault(kind, fn, mod)`, where given, replaces the program's step
    ("step") or scoring ("score") function: a broken timed path
    (`lib/faults.py`)."""
    dev = torch.device(device)
    if t_start is None:
        t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mode = cell.part("modes", cell.mix["mode"])
    return mode.run(cell, seed, seconds, trace, dev, t_start, fault)


def window(step: Callable[[int], None], seconds: float, trace: bool,
           mix: dict, dev, expected: dict):
    """Steps until `seconds` have passed; (steps, wall s, intervals ms,
    stretch, why, first and last traced step)."""
    clock = Clock(dev)
    stretch, why, traced = None, None, None
    clock.mark()
    t0 = time.perf_counter()
    n = 0
    while True:
        step(n)
        clock.mark()
        n += 1
        if trace and n == mix["trace_after"] and dev.type == "cuda":
            from perfbench.lib.trace import trace_stretch
            def run_steps(k):
                nonlocal n
                for _ in range(k):
                    step(n)
                    n += 1
            stretch, why = trace_stretch(run_steps, mix["trace_steps"],
                                         {k: v * mix["trace_steps"]
                                          for k, v in expected.items()})
            traced = (n - mix["trace_steps"], n)    # the stretch kept
            clock.mark()
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return n, wall, clock.intervals_ms(), stretch, why, traced


def device_info(dev, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def free():
    """Return what the program held to the card before the reference."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak_flops(cfg: dict) -> float:
    if cfg["param_dtype"] in ("bfloat16", "float16"):
        return 989e12
    return 495e12 if torch.backends.cuda.matmul.allow_tf32 else F32_FLOPS_S


def metrics(cell: Cell, e2e: dict, ctx: Optional[Ctx], trace: bool):
    if not trace:
        return {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end if m["name"] in e2e}
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, n, metrics, device, checks, stretch=None):
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": bool(ok), "attempted": n, "failed": 0,
            "metrics": metrics, "device": device}
    if stretch is not None:
        line["device"]["busy_s"] = stretch.busy_s
        line["device"]["window_s"] = stretch.window_s
        line["breakdown"] = {"device_ops": stretch.device_ops(),
                             "idle_gaps": stretch.idle_gaps()}
    line["checks"] = checks
    return line


def checks(cell: Cell, numbers: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit; the
    others are printed as readings and not compared."""
    for k, v in numbers.items():
        if k not in cell.limits:
            print(f"reading {k} {float(v)!r} (not compared)",
                  file=sys.stderr)
    return {k: {"value": float(numbers[k]), "limit": float(cell.limits[k])}
            for k in cell.limits}


def ctx(cell, stretch, traced_ids, train, c0, c1, n):
    cfg, mix, mod = cell.cfg, cell.mix, cell.model
    costs = [mod.kernels(cfg, mix["batch"], uniq_rows({"sparse_ids": ids}),
                         train) for ids in traced_ids]
    feed = None
    if c0 is not None and c1 is not None and n:
        feed = {"stall_s": c1["stall_s"] - c0["stall_s"],
                "batches": c1["batches"] - c0["batches"], "steps": n}
    return Ctx(stretch=stretch, kernel_costs=costs,
               step_flops=mod.forward_flops(cfg) * mix["batch"]
               * (3 if train else 1),
               peak_flops=_peak_flops(cfg), bytes_s=H100_BYTES_S,
               ops_s=F32_FLOPS_S, feed=feed)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    start = process_start() or t_start
    line = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
               t_start=start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
