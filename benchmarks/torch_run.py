"""Benchmark entrypoint of the PyTorch port (the port of
benchmarks/run.py): one module per paper figure.

    PYTHONPATH=src python -m benchmarks.torch_run \
        [--only fig5|fig7|fig7_fleet|fig8|roofline|kernels] [--device cuda]

  fig5   static throughput + OOM rates   (paper Fig. 5A/5B)
  fig7   rescale timelines + utilization (paper Fig. 7A-C, 2.05-2.29x)
  fig7_fleet  multi-trainer cluster co-tuning under churn (fleet plane)
  fig8   scaling drilldowns              (paper Fig. 8A-C)
  roofline    the cells measured on a card against the H100's ceilings
              (benchmarks/torch_roofline.py)
  kernels     the CUDA kernels against their plain versions and the
              reference's oracles (benchmarks/torch_kernels_bench.py; on
              `--device cpu` the plain versions and oracles alone)
"""
from __future__ import annotations

import argparse
import time

_KNOWN = ("fig5", "fig7", "fig7_fleet", "fig8", "roofline", "kernels")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="|".join(_KNOWN))
    ap.add_argument("--device", default="cuda",
                    help="the kernel benchmark's device (cuda, or cpu for "
                         "the plain versions alone)")
    args = ap.parse_args(argv)
    if args.only not in (None,) + _KNOWN:
        raise KeyError(f"unknown benchmark {args.only!r}; known: "
                       f"{', '.join(_KNOWN)}")
    t0 = time.time()

    from benchmarks import (torch_common, torch_fig5_static,
                            torch_fig7_fleet, torch_fig7_rescale,
                            torch_fig8_scaling, torch_kernels_bench,
                            torch_roofline)
    ran = []
    if args.only in (None, "fig5"):
        torch_fig5_static.run("criteo")
        torch_fig5_static.run("custom")
        ran.append("fig5")
    if args.only in (None, "fig7"):
        torch_fig7_rescale.run("criteo")
        torch_fig7_rescale.run("custom")
        ran.append("fig7")
    if args.only in (None, "fig7_fleet"):
        torch_fig7_fleet.run()
        ran.append("fig7_fleet")
    if args.only in (None, "fig8"):
        torch_fig8_scaling.run()
        ran.append("fig8")
    if args.only in (None, "roofline"):
        torch_roofline.run()
        ran.append("roofline")
    if args.only in (None, "kernels"):
        torch_kernels_bench.run(args.device)
        ran.append("kernels")
    print(f"\nbenchmarks done ({', '.join(ran)}) in {time.time()-t0:.0f}s; "
          f"artifacts in {torch_common.OUT_DIR}")
    return ran


if __name__ == "__main__":
    main()
