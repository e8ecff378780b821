"""Roofline of the cells the port has measured on one card (the port of
benchmarks/roofline.py).

    PYTHONPATH=src python -m benchmarks.torch_roofline [--steps build/bench/torch_steps.json]

Reads the step seconds that the generic driver records (`--steps-json`;
chip_smoke.py's LM train and dlrm-criteo driver phases write
build/bench/torch_steps.json: arch, shape, batch, microbatches, step
seconds, dtype, device) and, for each (arch, shape) measured on a card,
combines:
  compute term = the cell's model FLOPs (benchmarks/torch_analytic.py,
                 the reference's closed forms at the measured batch) /
                 the dtype's peak (989 TFLOP/s bf16, 67 f32)
  memory term  = the analytic HBM bytes of a step / 3.35 TB/s
and prints them, the dominant term, roofline_fraction = max(compute_s,
memory_s) / measured_s, and mfu = model FLOPs / (peak x measured_s).

The reference divides loop-aware HLO dot-FLOPs from its dry-run
(experiments/dryrun/), read from compiled XLA programs
(launch/hlo_analysis.py), by its accelerator's peak: the port compiles
no XLA program, so it has no HLO column and no useful-compute ratio, and
it has no collective term (one device). Records measured on the CPU are
left out: a CPU run gives no device time.

Also nominates the three hillclimb cells among the measured train cells
(worst roofline fraction, the next worst by memory share of the bound,
and dlrm-criteo/train_batch as the paper's own). Output: printed table +
build/bench/torch_roofline.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from benchmarks import torch_analytic, torch_common
from repro_torch.configs.registry import get_arch


def steps_json() -> str:
    """build/bench/torch_steps.json (torch_common.OUT_DIR's)."""
    return os.path.join(torch_common.OUT_DIR, "torch_steps.json")


def load_steps(path: Optional[str] = None) -> list:
    path = path or steps_json()
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def measured_shape(arch, rec: dict):
    """The arch's shape of the record at the batch that was measured."""
    shape = arch.shape(rec["shape"])
    return dataclasses.replace(shape, batch=rec["batch"])


def build_table(path: Optional[str] = None) -> list:
    rows = []
    for rec in load_steps(path):
        if rec["device"] == "cpu":
            continue
        arch = get_arch(rec["arch"])
        cell = torch_analytic.model_cell(arch, measured_shape(arch, rec), 1)
        terms = torch_analytic.roofline_terms(
            cell["model_flops"], cell["mem_bytes_per_dev"], rec["step_s"],
            rec["dtype"])
        rows.append({"arch": rec["arch"], "shape": rec["shape"],
                     "kind": rec["kind"], "batch": rec["batch"],
                     "microbatches": rec["microbatches"],
                     "dtype": rec["dtype"], "device": rec["device"],
                     "measured_s": rec["step_s"],
                     "mem_bytes": cell["mem_bytes_per_dev"], **terms})
    return rows


def pick_hillclimb_cells(rows: list) -> dict:
    ok = [r for r in rows if r["kind"] == "train"]
    rep = next((r for r in ok if r["arch"] == "dlrm-criteo"
                and r["shape"] == "train_batch"), None)
    rest = [r for r in ok if r is not rep]
    picks = {"paper_representative":
             None if rep is None else f"{rep['arch']}/{rep['shape']}"}
    if rest:
        worst = min(rest, key=lambda r: r["roofline_fraction"])
        picks["worst_fraction"] = f"{worst['arch']}/{worst['shape']}"
        rest2 = [r for r in rest if r is not worst]
        if rest2:
            mem = max(rest2, key=lambda r: r["memory_s"]
                      / max(r["compute_s"], 1e-12))
            picks["most_memory_bound"] = f"{mem['arch']}/{mem['shape']}"
    return picks


def run(path: Optional[str] = None, quiet: bool = False) -> list:
    rows = build_table(path)
    if not rows:
        print(f"no card measurement in {path or steps_json()}: run "
              f"chip_smoke.py on the card, or the driver with --steps-json "
              f"there")
        return rows
    if not quiet:
        print(f"\n== Roofline (one {rows[0]['device']}: 989 TFLOP/s bf16, "
              f"67 f32, 3.35 TB/s) ==")
        print(f"{'arch/shape':30s} {'batch':>6s} {'dom':8s} "
              f"{'compute_s':>10s} {'memory_s':>10s} {'measured_s':>10s} "
              f"{'roofline':>8s} {'mfu':>6s}")
        for r in rows:
            print(f"{r['arch'] + '/' + r['shape']:30s} {r['batch']:6d} "
                  f"{r['dominant']:8s} {r['compute_s']:10.3e} "
                  f"{r['memory_s']:10.3e} {r['measured_s']:10.3e} "
                  f"{r['roofline_fraction']:8.4f} {r['mfu']:6.4f}")
        print("\nhillclimb cells:", pick_hillclimb_cells(rows))
    torch_common.save_json("torch_roofline.json", rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default=None,
                    help="the steps JSON (default build/bench/"
                         "torch_steps.json)")
    return run(ap.parse_args(argv).steps)


if __name__ == "__main__":
    main()
