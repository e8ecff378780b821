"""The benchmark of repro_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout, on a machine with the CUDA devices the
cell asks for (it exits 2 and prints no result otherwise). The last line
of standard output is the result: `correct`, `attempted`, `failed`, the
metrics (the cell's end-to-end ones, or with `--trace 1` its per-layer
ones), the device, with `--trace 1` the breakdown, and last the checks,
each number beside its limit. The checks are also the last lines of
standard error. Cells, configurations, mixes and metrics are data:
see BENCHMARK.json and perfbench/lib/harness.py.
"""
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# every cache of the run inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if __name__ == "__main__":
    from perfbench.lib.harness import main
    sys.exit(main(sys.argv[1:], t_start=T0))
