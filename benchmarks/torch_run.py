"""Benchmark entrypoint of the PyTorch port (the port of
benchmarks/run.py): one module per paper figure.

    PYTHONPATH=src python -m benchmarks.torch_run [--only fig5|fig7|fig7_fleet|fig8]

  fig5   static throughput + OOM rates   (paper Fig. 5A/5B)
  fig7   rescale timelines + utilization (paper Fig. 7A-C, 2.05-2.29x)
  fig7_fleet  multi-trainer cluster co-tuning under churn (fleet plane)
  fig8   scaling drilldowns              (paper Fig. 8A-C)

The reference's `roofline` and `kernels` (the kernel benchmarks) are not
ported yet: asking for them raises an error naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import time

# what the port does not have yet, and the ROADMAP queue 1 item that
# ports it
_NOT_PORTED = {"roofline": 7, "kernels": 7}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="fig5|fig7|fig7_fleet|fig8")
    args = ap.parse_args(argv)
    if args.only in _NOT_PORTED:
        raise KeyError(f"benchmark {args.only!r} is not ported to "
                       f"repro_torch yet (ROADMAP queue 1, item "
                       f"{_NOT_PORTED[args.only]})")
    if args.only not in (None, "fig5", "fig7", "fig7_fleet", "fig8"):
        raise KeyError(f"unknown benchmark {args.only!r}; known: fig5, "
                       f"fig7, fig7_fleet, fig8")
    t0 = time.time()

    from benchmarks import (torch_common, torch_fig5_static,
                            torch_fig7_fleet, torch_fig7_rescale,
                            torch_fig8_scaling)
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
    print(f"\nbenchmarks done ({', '.join(ran)}) in {time.time()-t0:.0f}s; "
          f"artifacts in {torch_common.OUT_DIR}")
    return ran


if __name__ == "__main__":
    main()
