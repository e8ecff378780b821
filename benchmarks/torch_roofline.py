"""Roofline of the cells the port has measured on one card, and of the
dry run's plans (the port of benchmarks/roofline.py).

    PYTHONPATH=src python -m benchmarks.torch_roofline [--steps build/bench/torch_steps.json]
    PYTHONPATH=src python -m benchmarks.torch_roofline --dryrun build/dryrun/pod16x16

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

`--dryrun DIR` prints the reference's table instead, for the records of
one mesh of the dry run (launch/dryrun.py): per cell the three terms of
`torch_analytic.plan_terms` (the plan's dot FLOPs a rank over the
dtype's peak, the analytic HBM bytes a rank over 3.35 TB/s, the plan's
collective bytes a rank over a GPU's 50 GB/s between nodes), the
dominant one, the useful-compute ratio (model FLOPs a rank over the
plan's dot FLOPs) and the roofline fraction, and nominates the
reference's three hillclimb cells among the planned train cells (worst
fraction, most collective-bound, the paper's own). These are plans from
shapes, not device measurements. Output:
build/bench/torch_roofline_plan.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
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


# ------------------------------------------------------------- the plans --
def load_plan(mesh_dir: str) -> list:
    """The dry run's records of one mesh (<out>/<mesh>/*.json)."""
    recs = []
    for path in sorted(glob.glob(os.path.join(mesh_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def plan_table(mesh_dir: str) -> list:
    rows = []
    for rec in load_plan(mesh_dir):
        if rec.get("status") != "ok":
            if rec.get("status") == "skipped":
                rows.append({"arch": rec["arch"], "shape": rec["shape"],
                             "status": "skipped",
                             "reason": rec.get("reason", "")})
            continue
        arch = get_arch(rec["arch"])
        chips = rec["n_devices"]
        shape = arch.shape(rec["shape"])
        if rec.get("batch") is not None and hasattr(shape, "batch"):
            shape = dataclasses.replace(shape, batch=rec["batch"])
        cell = torch_analytic.model_cell(arch, shape, chips)
        terms = torch_analytic.plan_terms(
            cell["model_flops"], rec["dot_flops"], cell["mem_bytes_per_dev"],
            rec["collective_bytes"], chips, torch_analytic.plan_dtype(arch))
        mem = rec["memory"]
        rows.append({"arch": rec["arch"], "shape": rec["shape"],
                     "status": "ok", "kind": rec["kind"], "chips": chips,
                     "plan_dot_flops_per_dev": rec["dot_flops"],
                     "mem_bytes_per_dev": cell["mem_bytes_per_dev"],
                     "coll_bytes_per_dev": rec["collective_bytes"],
                     "resident_gib_per_dev": mem["resident_bytes"] / 2 ** 30,
                     "temp_gib_per_dev": mem["temp_bytes"] / 2 ** 30,
                     **terms})
    return rows


def pick_plan_cells(rows: list) -> dict:
    """The reference's three hillclimb cells among the planned train
    cells: the worst roofline fraction, the most collective-bound of the
    rest, and dlrm-criteo/train_batch."""
    ok = [r for r in rows if r["status"] == "ok" and r["kind"] == "train"]
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
            coll = max(rest2, key=lambda r: r["collective_s"]
                       / max(r["compute_s"], 1e-12))
            picks["most_collective_bound"] = f"{coll['arch']}/{coll['shape']}"
    return picks


def run_plan(mesh_dir: str, quiet: bool = False) -> list:
    rows = plan_table(mesh_dir)
    if not rows:
        print(f"no dry-run record in {mesh_dir}: run `python -m "
              f"repro_torch.launch.dryrun --mesh single` first")
        return rows
    if not quiet:
        chips = next((r["chips"] for r in rows if r["status"] == "ok"), 0)
        print(f"\n== Roofline of the dry run's plans ({chips} ranks; "
              f"H100: 989 TFLOP/s bf16, 67 f32, 3.35 TB/s, 50 GB/s between "
              f"nodes) ==")
        print(f"{'arch/shape':38s} {'dom':10s} {'compute_s':>10s} "
              f"{'memory_s':>10s} {'coll_s':>10s} {'useful':>7s} "
              f"{'roofline':>8s}")
        for r in rows:
            if r["status"] != "ok":
                print(f"{r['arch'] + '/' + r['shape']:38s} SKIPPED "
                      f"({r['reason'][:60]})")
                continue
            print(f"{r['arch'] + '/' + r['shape']:38s} "
                  f"{r['dominant']:10s} {r['compute_s']:10.2e} "
                  f"{r['memory_s']:10.2e} {r['collective_s']:10.2e} "
                  f"{r['useful_ratio']:7.2f} "
                  f"{r['roofline_fraction']:8.3f}")
        print("\nhillclimb cells:", pick_plan_cells(rows))
    torch_common.save_json("torch_roofline_plan.json", rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default=None,
                    help="the steps JSON (default build/bench/"
                         "torch_steps.json)")
    ap.add_argument("--dryrun", default=None,
                    help="a mesh's directory of dry-run records (build/"
                         "dryrun/pod16x16): the plans' roofline instead")
    args = ap.parse_args(argv)
    if args.dryrun:
        return run_plan(args.dryrun)
    return run(args.steps)


if __name__ == "__main__":
    main()
