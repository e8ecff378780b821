"""Per-collective breakdown of one (arch, shape) cell's dry run: the port
of benchmarks/perf_probe.py.

    PYTHONPATH=src python -m benchmarks.torch_perf_probe --arch dlrm-criteo \
        --shape train_batch [--multi] [--top 18]

Plans the cell on the production mesh ((16, 16), or (2, 16, 16) with
`--multi`) as rank 0 sees it (launch/dryrun.run_cell: the placed step on
meta tensors under launch/step_analysis) and prints its dot FLOPs, its
collective GiB and its temp GiB a rank, then the top collectives by
bytes: each distinct (op, group size, operand shape and dtype, call
site) with its count and bytes in the step. The port's step is eager,
so every count is the step's own (the reference scales an HLO op by its
loops' trips). A plan from shapes, not a device measurement.
"""
from __future__ import annotations

import argparse
import warnings

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib


def report(rec: dict, top: int = 18) -> list:
    """Print `rec`'s (a dry-run record's) summary and top collectives;
    returns them, most bytes first."""
    rows = sorted(rec["collective_calls"], key=lambda r: -r["bytes"])
    mem = rec["memory"]
    print(f"\n== {rec['arch']}/{rec['shape']} ({rec['mesh']}) ==")
    print(f"dot flops/rank {rec['dot_flops']:.3e} | collective "
          f"{rec['collective_bytes'] / 2 ** 30:.2f} GiB/rank | temp "
          f"{mem['temp_bytes'] / 2 ** 30:.2f} GiB/rank")
    for r in rows[:top]:
        print(f"  {r['bytes'] / 2 ** 30:8.3f} GiB x{r['count']:6d} "
              f"{r['op']:15s} {r['dtype']}{r['shape']} over {r['group']} "
              f"[{r['site']}]")
    return rows


def probe(arch_id: str, shape_name: str, mesh_shape=(16, 16),
          top: int = 18) -> dict:
    """The cell's record on a plan mesh of `mesh_shape`, reported; the
    process must have no process group of its own."""
    tag = dryrun.mesh_tag(mesh_shape)
    mesh = mesh_lib.make_plan_mesh(mesh_shape)
    try:
        rec = dryrun.run_cell(arch_id, shape_name, mesh, tag, verbose=False)
    finally:
        mesh_lib.end_plan_mesh()
    if rec["status"] != "ok":
        print(f"{arch_id}/{shape_name}: {rec['status']} "
              f"({rec.get('reason', '')})")
        return rec
    report(rec, top)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true",
                    help="the two-pod (2, 16, 16) mesh")
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args(argv)
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    mesh_shape = mesh_lib.PRODUCTION_SHAPES[2 if args.multi else 1][0]
    return probe(args.arch, args.shape, mesh_shape, args.top)


if __name__ == "__main__":
    main()
