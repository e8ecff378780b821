"""The hillclimb log over the dry run's plans: the port of
benchmarks/perf_hillclimb.py.

    PYTHONPATH=src python -m benchmarks.torch_perf_hillclimb \
        [--cell dlrm|bert4rec|gnn|wide-deep]

The reference's four cells and their variants (`dlrm_variants`,
`bert4rec_variants`, `gnn_variants`, `wide_deep_variants`), each planned
on the (16, 16) production mesh as rank 0 sees it (launch/programs.
build_program on meta tensors under launch/step_analysis), with its
roofline terms (benchmarks/torch_analytic.plan_terms). Writes
build/bench/torch_perf_iterations.json.

The port places every leaf at the reference's spec (launch/programs.
Placement), so each variant's parameters and optimizer state are the
reference's blocks. What it has no counterpart for is GSPMD's implicit
take of a row-sharded table (`tp_lookup` off): there the port's
row-sharded lookup over the axes the rows span stands in for it, or, for
BERT4Rec's candidates, the items gathered whole, as the variant's label
says. A variant the port's code refuses is logged with
the refusal, not planned in some other layout. The figures are plans
from shapes run on the host, not device measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings

from benchmarks import torch_analytic, torch_common
from repro_torch.configs.registry import get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.programs import build_program
from repro_torch.launch.step_analysis import analyze

OUT = os.path.join(torch_common.OUT_DIR, "torch_perf_iterations.json")
PORT_TAKE = " [port: the row-sharded lookup stands for GSPMD's take]"


def measure(arch, shape_name: str, mesh) -> dict:
    """One variant's plan and its roofline terms."""
    shape = arch.shape(shape_name)
    prog = build_program(arch, shape, mesh, "meta")
    res = analyze(prog.fn, *prog.args)
    chips = mesh.size(mesh.axis_names)
    cell = torch_analytic.model_cell(arch, shape, chips)
    terms = torch_analytic.plan_terms(
        cell["model_flops"], res["dot_flops"], cell["mem_bytes_per_dev"],
        res["collective_bytes"], chips, torch_analytic.plan_dtype(arch))
    return {"status": "ok",
            "dot_flops_per_dev": res["dot_flops"],
            "coll_gib_per_dev": res["collective_bytes"] / 2 ** 30,
            "temp_gib_per_dev": res["temp_bytes"] / 2 ** 30,
            "args_gib_per_dev": res["resident_bytes"] / 2 ** 30,
            "replicated": [n for n, _ in prog.meta.get("replicated", ())],
            **terms}


def _fmt(tag, m):
    if m["status"] != "ok":
        print(f"  {tag:60s} {m['status']}: {m['error']}")
        return
    print(f"  {tag:60s} compute {m['compute_s']:.3e}s  "
          f"mem {m['memory_s']:.3e}s  coll {m['collective_s']:.3e}s  "
          f"dom={m['dominant']}  roofline {m['roofline_fraction']:.4f}  "
          f"temp {m['temp_gib_per_dev']:.1f}GiB args "
          f"{m['args_gib_per_dev']:.1f}GiB")


def _model(arch, **kw):
    return dataclasses.replace(arch, model=arch.model.replace(**kw))


def dlrm_variants():
    opt = get_arch("dlrm-criteo")
    base = dataclasses.replace(
        _model(opt, tp_lookup=False, param_dtype="float32"),
        optimizer="adagrad")
    v1 = dataclasses.replace(
        _model(base, tp_lookup=True, param_dtype="bfloat16",
               sharding_overrides=(("table_rows", "model"),)),
        optimizer="rowwise_adagrad")
    return [("baseline (fp32, GSPMD take, adagrad)" + PORT_TAKE, base),
            ("iter1 REFUTED: rows over model only", v1),
            ("iter2: all-axis rows + ag-ids/psum-scatter", opt)]


def bert4rec_variants():
    base = get_arch("bert4rec")
    v0 = _model(base, sharding_overrides=(("table_rows", None),),
                tp_lookup=False)
    v_take = _model(base, tp_lookup=False)
    return [("iter0: replicated items (unscalable)", v0),
            ("baseline: row-sharded + GSPMD take [port: the sequence "
             "through the row-sharded lookup, the candidates from the items "
             "gathered whole]", v_take),
            ("iter1: shard_map lookup + sampled-logit psum", base)]


def gnn_variants():
    base = get_arch("graphsage-reddit")
    return [("baseline (edge-sharded, replicated nodes)", base),
            ("opt1: dst-partitioned edges, node-sharded outputs",
             _model(base, partitioned=True))]


def wide_deep_variants():
    opt = get_arch("wide-deep")
    base = dataclasses.replace(_model(opt, tp_lookup=False),
                               optimizer="adagrad")
    return [("baseline (GSPMD take, adagrad)" + PORT_TAKE, base),
            ("iter1: all-axis rows + ag-ids/psum-scatter", opt)]


CELLS = {
    "dlrm": ("train_batch", dlrm_variants),
    "bert4rec": ("train_batch", bert4rec_variants),
    "gnn": ("ogb_products", gnn_variants),
    "wide-deep": ("train_batch", wide_deep_variants),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    mesh = mesh_lib.make_plan_mesh(mesh_lib.PRODUCTION_SHAPES[1][0])
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    try:
        for cell, (shape_name, variants_fn) in CELLS.items():
            if args.cell and cell != args.cell:
                continue
            print(f"\n== hillclimb {cell} ({shape_name}), planned ==")
            rows = []
            for tag, arch in variants_fn():
                try:
                    m = measure(arch, shape_name, mesh)
                except Exception as e:  # noqa: BLE001 — logged, not planned
                    m = {"status": "refused", "error": repr(e)}
                _fmt(tag, m)
                rows.append({"variant": tag, **m})
            results[cell] = rows
    finally:
        mesh_lib.end_plan_mesh()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1, default=float)
    return results


if __name__ == "__main__":
    main()
