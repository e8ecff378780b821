"""Kernel micro-benchmarks of the port (the port of
benchmarks/kernels_bench.py): each hand-written CUDA kernel against its
plain PyTorch version and the reference's oracle, at the reference's
three shapes, with the H100's bound.

    PYTHONPATH=src python -m benchmarks.torch_kernels_bench [--device cuda|cpu]

Shapes (the reference's): `embedding_bag` and `embedding_bag_fused` over
a 16k x 128 f32 table, B = 256 bags of 4; `dot_interact` at B = 512,
F = 27, D = 128; `sage_aggregate` at B = 1024, F = 15, D = 602, H = 128.
Each row gives:
  - kernel_ms: the CUDA kernel (its wrapper in repro_torch.kernels),
    launch to launch, from CUDA events around many launches after a
    warm-up (at these sizes its inputs stay in the 50 MB L2);
  - plain_ms: its plain version (repro_torch.kernels.ref, the same
    arithmetic, which the CPU path runs and the kernel is held against);
  - oracle_ms: the reference's oracle (repro/kernels/ref.py: a take and
    a sum, an f32 Gram matrix and its lower triangle, a mean and a
    product) in one PyTorch expression;
  - bound_ms: the larger of the bytes the function must move (each input
    read once, each output written once) over 3.35 TB/s and its f32
    operations over 67 TFLOP/s (H100 SXM data sheet), both counted by
    repro_torch.kernels.costs, with its share of the kernel's time;
  - max_abs_err: the kernel against its plain version, held as in
    chip_smoke.py's `kernels` phase (the bags bitwise, the others
    allclose); on the CPU the oracle against the plain version.
The reference's interpret-mode timings and on-chip tile sizes are TPU
design points and are not carried over. With `--device cpu` only the
plain version and the oracle are timed (host clock), and kernel_ms is
null. Writes build/bench/torch_kernels.json.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks import torch_common

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# kernel against plain version (chip_smoke.py's `kernels` phase): the bags
# bitwise, the interaction and the aggregate rtol 1e-5 with these atols;
# the oracle, which sums in other orders, against the plain version on
# the CPU: rtol 1e-5, atol 1e-4
ATOL = {"embedding_bag": 0.0, "embedding_bag_fused": 0.0,
        "dot_interact": 1e-4, "sage_aggregate": 1e-5}
ORACLE_ATOL = 1e-4


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, device: torch.device, iters: int = 100,
            warmup: int = 10) -> float:
    """Mean ms a call: CUDA events around `iters` launches on a CUDA
    device, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def cases(device: torch.device):
    """(name, shape text, kernel or None, plain, oracle, cost) for the
    reference's three shapes, inputs from a seed-0 RandomState."""
    from repro_torch.kernels import costs
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    on_cuda = device.type == "cuda"
    rng = np.random.RandomState(0)
    put = lambda a: torch.from_numpy(a).to(device)

    table = put(rng.randn(1 << 14, 128).astype(np.float32))
    ids = put(rng.randint(0, 1 << 14, (256, 4)).astype(np.int32))
    tables, bags = table[None], ids[:, None, :]      # (1, V, D), (B, 1, 4)
    uniq = int(torch.unique(ids).numel())
    bag_cost = costs.bag_fwd(256, 1, 4, 1 << 14, 128, 4, uniq)
    oracle_bag = lambda: table[ids.long()].sum(1)
    # the port's functions take stacked tables: one feature, out (B, 1, D)
    yield ("embedding_bag", "16k x 128, B=256 bag=4",
           (lambda: eb.embedding_bag_fwd(tables, bags)[:, 0]) if on_cuda
           else None,
           lambda: ref.embedding_bag_ref(tables, bags)[:, 0], oracle_bag,
           bag_cost)
    yield ("embedding_bag_fused", "16k x 128, B=256 bag=4",
           (lambda: eb.embedding_bag_fused_fwd(tables, bags)[:, 0])
           if on_cuda else None,
           lambda: ref.embedding_bag_fused_ref(tables, bags)[:, 0],
           oracle_bag, bag_cost)

    feats = put(rng.randn(512, 27, 128).astype(np.float32))
    ii, jj = ref.tril_pairs(27, device)
    yield ("dot_interact", "B=512 F=27 D=128",
           (lambda: di.dot_interact_fwd(feats)) if on_cuda else None,
           lambda: ref.dot_interact_ref(feats),
           lambda: torch.einsum("bfd,bgd->bfg", feats, feats)[:, ii, jj],
           costs.dot_fwd(512, 27, 128, 4))

    neigh = put(rng.randn(1024, 15, 602).astype(np.float32))
    w = put((rng.randn(602, 128) * 0.04).astype(np.float32))
    yield ("sage_aggregate", "B=1024 F=15 D=602 H=128",
           (lambda: sa.sage_aggregate_fwd(neigh, w)[0]) if on_cuda else None,
           lambda: ref.sage_aggregate_ref(neigh, w),
           lambda: neigh.mean(1) @ w,
           costs.sage_fwd(1024, 15, 602, 128, 4, False))


def _max_err(name: str, got: torch.Tensor, want: torch.Tensor,
             atol: float) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, its plain "
                             f"version's {tuple(want.shape)}")
    err = (got.double() - want.double()).abs()
    bad = err > atol + 1e-5 * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off its "
                             f"plain version, max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def run(device="cuda", quiet: bool = False) -> list:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_kernels_bench: no CUDA device (run with "
                           "--device cpu for the plain versions alone)")
    rows = []
    for name, shape, kernel, plain, oracle, cost in cases(device):
        want = plain()
        err = (_max_err(name, kernel(), want, ATOL[name]) if kernel
               else _max_err(name, oracle(), want, ORACLE_ATOL))
        bms, by = bound_ms(cost.bytes, cost.ops)
        k_ms = time_ms(kernel, device) if kernel else None
        rows.append({
            "kernel": name, "shape": shape, "device": (
                torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
            "kernel_ms": k_ms, "plain_ms": time_ms(plain, device),
            "oracle_ms": time_ms(oracle, device),
            "bound_ms": bms, "bound_by": by,
            "bound_share": bms / k_ms if k_ms else None,
            "max_abs_err": err,
            "checked_against": "plain" if kernel else "oracle"})
    if not quiet:
        print(f"\n== CUDA kernels ({rows[0]['device']}; bound: bytes over "
              f"3.35 TB/s or f32 ops over 67 TFLOP/s) ==")
        for r in rows:
            k = ("   (no kernel on the CPU)" if r["kernel_ms"] is None else
                 f"kernel {r['kernel_ms']:8.4f} ms ({r['bound_share']:.0%} "
                 f"of the bound)")
            print(f"  {r['kernel']:20s} {r['shape']:24s} {k}  plain "
                  f"{r['plain_ms']:8.4f}  oracle {r['oracle_ms']:8.4f}  "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']})  err "
                  f"{r['max_abs_err']:.2e}")
    torch_common.save_json("torch_kernels.json", rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
