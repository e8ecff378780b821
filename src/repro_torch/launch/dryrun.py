"""The dry run: every (arch x shape x mesh) cell's placed step planned on
meta tensors, the counterpart of repro/launch/dryrun.py.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        [--mesh single|multi|both|D,M] [--rank R] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape train_4k --mesh 1,1 --batch 4 --microbatches 4

For each cell this builds the placed step as one rank (`--rank`, 0 by
default) of the mesh sees it (launch/programs.build_program: this
rank's parameter blocks or shards, optimizer state and inputs, all on
the meta device), runs it once under launch/step_analysis.analyze, and
writes <out>/<mesh>/<arch>__<shape>.json: `status` (ok, skipped with
the config's reason, or error with its repr), `kind`, `n_devices`,
`plan_s` (the seconds the plan took on this host, in place of the
reference's lower and compile seconds), `memory` (resident, temp and
peak bytes a rank, and the parameter, optimizer-state, input and cache
bytes apart), `dot_flops`, `collectives` (by op, count and operand
bytes, and their total), `collective_calls` (the same by shape and call
site), `launches` and `kernels` (each hand-written kernel's launches,
dot FLOPs and bytes), `replicated` (the leaves the port replicates where
the reference's rules would shard them) and `fits` (the peak under one
H100's 80 GB).

The meshes are the reference's production meshes, (16, 16) on one pod
(`single`, "pod16x16") and (2, 16, 16) on two (`multi`, "pod2x16x16"),
or `D,M`, a (data, model) mesh ("meshDxM"), each made once in this
process over torch's `fake` process group (launch/mesh.make_plan_mesh:
its collectives move nothing). Nothing is allocated on any device and no
tensor value is read: on meta tensors each kernel op takes its CUDA
wrapper, with its checks, shapes, scratch and launch count, up to the
launch, which is counted and not made (kernels/embedding_bag.planned).
There is no
compiler to ask: "fits" is the plan's peak against 80 GB, not a compiled
module's memory analysis. `--batch` and `--microbatches` plan a run at
another batch (the card's: a world of one rank on `--mesh 1,1`). Exits 1
if any cell errs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings
from typing import Optional

from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.programs import build_program
from repro_torch.launch.step_analysis import analyze

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "build", "dryrun")
DEVICE_BYTES = 80e9
MESHES = {"single": [(16, 16)], "multi": [(2, 16, 16)],
          "both": [(16, 16), (2, 16, 16)]}


def mesh_tag(mesh_shape) -> str:
    shape = tuple(mesh_shape)
    if shape == (16, 16):
        return "pod16x16"
    if shape == (2, 16, 16):
        return "pod2x16x16"
    return "mesh" + "x".join(str(n) for n in shape)


def run_cell(arch_id: str, shape_name: str, mesh, tag: str, *,
             batch: Optional[int] = None, microbatches: int = 1,
             verbose: bool = True) -> dict:
    """One cell's record (see the module docstring)."""
    arch = get_arch(arch_id)
    reason = arch.is_skipped(shape_name)
    if reason:
        return {"arch": arch_id, "shape": shape_name, "mesh": tag,
                "status": "skipped", "reason": reason}
    shape = arch.shape(shape_name)
    t0 = time.monotonic()
    prog = build_program(arch, shape, mesh, "meta", batch=batch,
                         microbatches=microbatches)
    res = analyze(prog.fn, *prog.args)
    plan_s = time.monotonic() - t0
    mem = dict(prog.memory, resident_bytes=res["resident_bytes"],
               temp_bytes=res["temp_bytes"], peak_bytes=res["peak_bytes"])
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": tag, "status": "ok",
        "kind": prog.kind, "n_devices": mesh.size(mesh.axis_names),
        "mesh_shape": prog.meta["mesh"], "rank": prog.meta["rank"],
        "batch": getattr(shape, "batch", None) if batch is None else batch,
        "microbatches": microbatches,
        "plan_s": plan_s, "memory": mem,
        "fits": res["peak_bytes"] <= DEVICE_BYTES,
        **{k: res[k] for k in ("dot_flops", "aten_dot_flops",
                               "kernel_dot_flops", "collectives",
                               "collective_bytes", "collective_calls",
                               "launches", "kernels")},
        "replicated": [[n, list(s)] for n, s in
                       prog.meta.get("replicated", ())],
    }
    if verbose:
        print(f"[{tag}] {arch_id}/{shape_name}: OK plan {plan_s:.1f}s | "
              f"resident/rank {mem['resident_bytes'] / 2 ** 30:.2f} GiB "
              f"temp/rank {mem['temp_bytes'] / 2 ** 30:.2f} GiB "
              f"peak {mem['peak_bytes'] / 2 ** 30:.2f} GiB"
              f"{'' if rec['fits'] else ' (over 80 GB)'} | "
              f"dotflops/rank {rec['dot_flops']:.3e} | "
              f"coll {rec['collective_bytes'] / 2 ** 30:.2f} GiB/rank",
              flush=True)
    return rec


def save_record(rec: dict, out_dir: str) -> str:
    d = os.path.join(out_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def _mesh_shapes(arg: str) -> list:
    if arg in MESHES:
        return MESHES[arg]
    shape = tuple(int(v) for v in arg.split(","))
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh takes single, multi, both, D,M or P,D,M, "
                         f"got {arg!r}")
    return [shape]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="single",
                    help="single (16, 16), multi (2, 16, 16), both, or D,M")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose view is planned")
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default: the shape's)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # torch's notice that all_gather_into_tensor has a new name, once a
    # call site
    warnings.filterwarnings("ignore", category=FutureWarning,
                            module="torch.distributed")
    if not (args.all or args.arch):
        ap.error("name an --arch, or --all")
    out_dir = os.path.abspath(args.out or OUT_DIR)
    archs = [args.arch] if args.arch else list_archs()
    failures = []
    for mesh_shape in _mesh_shapes(args.mesh):
        tag = mesh_tag(mesh_shape)
        mesh = mesh_lib.make_plan_mesh(mesh_shape, rank=args.rank)
        try:
            for arch_id in archs:
                arch = get_arch(arch_id)
                shapes = [args.shape] if args.shape else \
                    [s.name for s in arch.shapes]
                for shape_name in shapes:
                    try:
                        rec = run_cell(arch_id, shape_name, mesh, tag,
                                       batch=args.batch,
                                       microbatches=args.microbatches)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        traceback.print_exc()
                        rec = {"arch": arch_id, "shape": shape_name,
                               "mesh": tag, "status": "error",
                               "error": repr(e)}
                        failures.append(f"{tag}/{arch_id}/{shape_name}")
                    save_record(rec, out_dir)
        finally:
            mesh_lib.end_plan_mesh()
    if failures:
        print(f"\nFAILED cells ({len(failures)}):")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall requested cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
