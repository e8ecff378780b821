#!/usr/bin/env python3
"""Probes behind the designs of the port's two backward kernels on one GPU.

    python3 kernel_probes.py

`chip_smoke.py` times each kernel as the port builds it. This script
times what its designs were chosen against, on the same card and in one
process, and prints one line a measurement (device time a call from
torch.profiler, as chip_smoke.time_ms takes it):

  scatter   embedding_bag_bwd at wide-deep's two arms, ids (65536, 40, 4)
            of the synthetic Criteo stream into (40, 2^20, D) at D = 1
            and 32, and at the DLRM's (2048, 26, 4) into (26, 2^20, 128),
            with its walk's feature group overridden (1, 2, 4, 8, 40 at
            D = 1); beside it index_add_ and the bound of chip_smoke.py.
  limits    the atomics alone: one float4 (D = 32) or float (D = 1)
            reduction a row of the same ids in the kernel's order, of the
            distinct ids sorted and shuffled; a plain load-add-store and a
            gather of the same rows.
  sass      the reductions each backward kernel of the built library
            issues (cuobjdump -sass): REDG, fire-and-forget, or ATOMG,
            which waits for the old value.
  variants  the scatter with streaming (evict-first) loads of d_out and
            ids, and with TMA bulk reductions (cp.reduce.async.bulk, one
            a row) in place of RED; dot_interact_bwd at 1-6 persistent
            CTAs an SM, with streaming stores, with an L2 prefetch hint on
            its copies and with its k loop unrolled by 8, against bmm.

Each variant is a copy of a kernel source under src/repro_torch/kernels/
csrc with one edit, built with nvcc into build/kernel_probes/. It needs
one CUDA card and nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "kernel_probes")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")

# the atomics alone, a plain read-modify-write and a gather of 32-float
# rows (8 threads a row), and scalar reductions
MICRO = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void red_rows(float* g, const int64_t* rows, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 8) return;
  atomicAdd(reinterpret_cast<float4*>(g + rows[t >> 3] * 32) + (t & 7),
            make_float4(1.f, 1.f, 1.f, 1.f));
}
__global__ void rmw_rows(float* g, const int64_t* rows, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 8) return;
  float4* p = reinterpret_cast<float4*>(g + rows[t >> 3] * 32) + (t & 7);
  float4 v = *p;
  v.x += 1.f; v.y += 1.f; v.z += 1.f; v.w += 1.f;
  *p = v;
}
__global__ void gather_rows(const float* g, const int64_t* rows, float* out,
                            int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 8) return;
  reinterpret_cast<float4*>(out)[t] = __ldg(
      reinterpret_cast<const float4*>(g + rows[t >> 3] * 32) + (t & 7));
}
__global__ void red_scalar(float* g, const int64_t* rows, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) atomicAdd(g + rows[t], 1.f);
}
extern "C" int micro(int which, float* g, const int64_t* rows, float* out,
                     int64_t n, void* stream) {
  const int64_t threads = which == 3 ? n : n * 8;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) red_rows<<<blocks, 256, 0, s>>>(g, rows, n);
  if (which == 1) rmw_rows<<<blocks, 256, 0, s>>>(g, rows, n);
  if (which == 2) gather_rows<<<blocks, 256, 0, s>>>(g, rows, out, n);
  if (which == 3) red_scalar<<<blocks, 256, 0, s>>>(g, rows, n);
  return (int)cudaGetLastError();
}
'''

# the scatter's float4 path with its REDs replaced by one TMA bulk
# reduction a (row, bag slot): the row times its count is staged in shared
# memory, and one lane a slot reduces it into the gradient row
BULK = (
    ('''template <bool kVec, int kUnroll>
__device__ __forceinline__ void scatter_row(''',
     '''template <bool kVec, int kUnroll>
__device__ __forceinline__ void scatter_row_red('''),
    ('''// dOut (B, F, D) scatter-added into the zeroed dense gradient''',
     '''template <bool kVec, int kUnroll>
__device__ __forceinline__ void scatter_row(const float* src, float* dst,
                                            const int32_t (&id)[kUnroll],
                                            const float (&w)[kUnroll],
                                            int64_t D, int lane, int lanes,
                                            int n, float bag, int mean) {
  extern __shared__ __align__(128) float sbuf[];
  float* buf = sbuf + (threadIdx.x / lanes) * kUnroll * D;
  for (int64_t c = lane; c < D / 4; c += lanes) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(src) + c);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (j < n && w[j] != 0.f)
        reinterpret_cast<float4*>(buf + j * D)[c] = scale4(g, w[j]);
  }
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  __syncwarp(__activemask());
  bool issued = false;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (j < n && (j & (lanes - 1)) == lane && w[j] != 0.f) {
      const uint32_t s = (uint32_t)__cvta_generic_to_shared(buf + j * D);
      asm volatile(
          "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
          " [%0], [%1], %2;\\n" :: "l"(dst + (int64_t)id[j] * D), "r"(s),
          "r"((uint32_t)(D * 4)) : "memory");
      issued = true;
    }
  }
  if (issued) {
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
  }
}

// dOut (B, F, D) scatter-added into the zeroed dense gradient'''),
    ('''    launch_bwd<true>(grid, s,''',
     '''    cudaFuncSetAttribute(embedding_bag_bwd_kernel<true, 4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (kBwdThreads >> lanes_log2) * 16 *
                             static_cast<int>(D));
    launch_bwd<true>(grid, s,'''),
    ('''    embedding_bag_bwd_kernel<kVec, 4><<<grid, kBwdThreads, 0, s>>>(''',
     '''    embedding_bag_bwd_kernel<kVec, 4><<<grid, kBwdThreads,
        kVec ? (kBwdThreads >> lanes_log2) * 16 * D : 0, s>>>('''),
)

SCATTER_VARIANTS = {
    "ldcs": (
        ("__ldg(reinterpret_cast<const float4*>(src) + c)",
         "__ldcs(reinterpret_cast<const float4*>(src) + c)"),
        ("__ldg(reinterpret_cast<const int4*>(row_ids + j))",
         "__ldcs(reinterpret_cast<const int4*>(row_ids + j))")),
    "bulk": BULK,
}
DOT_VARIANTS = {
    "stcs": (("reinterpret_cast<float4*>(dst + (i0 + r) * D)[col] = acc[r];",
              "__stcs(reinterpret_cast<float4*>(dst + (i0 + r) * D) + col, "
              "acc[r]);"),),
    "l2_256B": (('"cp.async.cg.shared.global [%0], [%1], 16;\\n"',
                 '"cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\\n"'),),
    "unroll8": (("#pragma unroll 4\n        for (int k = 0; k < F; ++k) {\n"
                 "          const float4 v",
                 "#pragma unroll 8\n        for (int k = 0; k < F; ++k) {\n"
                 "          const float4 v"),),
}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


def build_variants():
    """nvcc for the micro kernels and every variant, started together;
    returns their loaded libraries."""
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    sources = {"micro": MICRO}
    for src, variants in (("embedding_bag", SCATTER_VARIANTS),
                          ("dot_interact", DOT_VARIANTS)):
        text = open(os.path.join(CSRC, f"{src}.cu")).read()
        for name, edits in variants.items():
            out = text
            for old, new in edits:
                if old not in out:
                    raise RuntimeError(f"variant {name}: {old[:60]!r} not in "
                                       f"{src}.cu")
                out = out.replace(old, new)
            sources[f"{src}_{name}"] = out
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        if name == "micro":
            lib.micro.argtypes = (_I32, _P, _P, _P, _I64, _P)
        else:
            src = name.split("_")[0] + "_" + name.split("_")[1]
            for fn, argtypes in build.SIGNATURES[src].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_reductions(path: str) -> dict:
    """{kernel: {opcode: count}} of the REDG and ATOMG instructions in the
    library at `path`."""
    out = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {}
        elif name is not None:
            for word in line.split():
                if word.startswith(("REDG.", "ATOMG.")):
                    counts[name][word] = counts[name].get(word, 0) + 1
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import chip_smoke as cs
    from repro_torch.configs.dlrm_criteo import MODEL
    from repro_torch.configs.wide_deep import ARCH
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LIBRARIES

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    libs = build_variants()
    from repro_torch.kernels import build
    for name, ops in sass_reductions(
            str(build.library_path("embedding_bag"))).items():
        if "bwd" in name:
            print(f"sass {name}: {ops}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def scatter(lib, d_out, ids, grad, group):
        b, f, bag = ids.shape
        _, v, d = grad.shape
        plan = eb.bwd_plan(b, f, v, d)
        groups = -(-f // group)
        blocks = -(-b * min(group, f) * plan.lanes // eb.BWD_THREADS)

        def call():
            status = lib.embedding_bag_bwd(
                d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), b, f, v,
                d, bag, 0, int(plan.vec == 4), plan.lanes_log2, group,
                blocks, groups, stream())
            if status != 0:
                raise RuntimeError(f"embedding_bag_bwd: CUDA error {status}")
        return call

    # the ids: wide-deep's train batch and the DLRM's featurized batch
    cfg = ARCH.model
    wd = torch.as_tensor(cs._criteo_batch(cfg, 65536, 1)["sparse_ids"]) \
        .to(dev)
    rec = RecordSpec(batch=2048, n_sparse=MODEL.n_sparse,
                     n_dense=MODEL.n_dense, vocab=MODEL.vocab_sizes[0])
    dlrm = torch.as_tensor(featurize_block(
        raw_block(np.random.RandomState(1), rec), rec)["sparse_ids"]).to(dev)
    print(f"card: {cs.card_line()}")
    row_lib = LIBRARIES.get("embedding_bag")
    cases = (("wide arm", wd, cfg.vocab_sizes[0], 1, (1, 2, 4, 8, 40)),
             ("deep tables", wd, cfg.vocab_sizes[0], 32, (1, 2, 40)),
             ("DLRM", dlrm, MODEL.vocab_sizes[0], MODEL.embed_dim,
              (1, 2, 26)))
    for tag, ids, rows, d, groups in cases:
        b, n_f, bag = ids.shape
        flat = (ids.long() + (torch.arange(n_f, device=dev) * rows)
                .view(1, n_f, 1)).reshape(-1)
        uniq = int(torch.unique(flat).numel())
        d_out = torch.randn((b, n_f, d), device=dev, generator=gen)
        grad = torch.zeros((n_f, rows, d), device=dev)
        upd = d_out[:, :, None, :].expand(b, n_f, bag, d).reshape(-1, d) \
            .contiguous()
        lib_ms, _ = cs.time_ms(lambda: grad.view(n_f * rows, d).index_add_(
            0, flat, upd), [()])
        bnd, _ = cs.bound_ms(d_out.numel() * 4 + ids.numel() * 4
                             + 2 * uniq * d * 4, 0)
        print(f"scatter {tag} D = {d}: index_add_ {lib_ms:.4f} ms, bound "
              f"{bnd:.4f} ms; plan {eb.bwd_plan(b, n_f, rows, d)}")
        del upd
        variants = [("kernel", row_lib)]
        if d > 1:
            variants += [(n, libs[f"embedding_bag_{n}"])
                         for n in SCATTER_VARIANTS]
        # two rounds in turns, the second in reverse order
        for rnd in range(2):
            for name, lib in variants[::1 if rnd == 0 else -1]:
                for group in groups if name == "kernel" else groups[:1]:
                    ms, _ = cs.time_ms(scatter(lib, d_out, ids, grad, group),
                                       [()])
                    print(f"  {name} group {group}: {ms:.4f} ms", flush=True)
        if d in (1, 32):
            # the limits, over the same rows: in the kernel's walk order
            # (feature by feature), the distinct rows sorted and shuffled
            walk = (ids.long() + (torch.arange(n_f, device=dev) * rows)
                    .view(1, n_f, 1)).permute(1, 0, 2).reshape(-1) \
                .contiguous()
            distinct = torch.unique(walk)
            shuffled = distinct[torch.randperm(distinct.numel(), device=dev,
                                               generator=gen)]
            out = torch.empty((walk.numel() * 32 if d == 32 else 1,),
                              device=dev)
            kinds = (((0, "float4 reductions"), (1, "load-add-store"),
                      (2, "gather")) if d == 32 else
                     ((3, "float reductions"),))
            for order, r in (("walk order", walk), ("distinct sorted",
                                                     distinct),
                             ("distinct shuffled", shuffled)):
                for which, kind in kinds:
                    ms, _ = cs.time_ms(lambda: libs["micro"].micro(
                        which, grad.data_ptr(), r.data_ptr(),
                        out.data_ptr(), r.numel(), stream()), [()])
                    print(f"  limit D = {d} {kind}, {order} ({r.numel()} "
                          f"rows): {ms:.4f} ms", flush=True)
            del out, walk, distinct, shuffled
        del d_out, grad
        torch.cuda.empty_cache()

    # dot_interact_bwd at the DLRM shape, three input sets (85 MB)
    b, f, d = 2048, MODEL.n_sparse + 1, MODEL.embed_dim
    p = f * (f - 1) // 2
    sets = [(torch.randn((b, p), device=dev, generator=gen),
             torch.randn((b, f, d), device=dev, generator=gen))
            for _ in range(3)]
    ii, jj = ref.tril_pairs(f, dev)
    sym = []
    for g, x in sets:
        s = torch.zeros((b, f, f), device=dev)
        s[:, ii, jj] = g
        sym.append((s + s.transpose(1, 2), x))
    out = torch.empty((b, f, d), device=dev)
    plan = di.bwd_plan(b, f, d)

    def dot(lib, ctas):
        def call(g, x):
            status = lib.dot_interact_bwd(
                g.data_ptr(), x.data_ptr(), out.data_ptr(), b, f, d, 1,
                plan.warps, ctas, plan.smem, stream())
            if status != 0:
                raise RuntimeError(f"dot_interact_bwd: CUDA error {status}")
        return call
    variants = [("kernel", LIBRARIES.get("dot_interact"))] + [
        (n, libs[f"dot_interact_{n}"]) for n in DOT_VARIANTS]
    print(f"dot_interact_bwd ({b}, {f}, {d}): plan {plan}")
    for rnd in range(2):
        bmm_ms, _ = cs.time_ms(torch.bmm, sym)
        print(f"  bmm {bmm_ms:.4f} ms")
        for name, lib in variants[::1 if rnd == 0 else -1]:
            for per_sm in (range(1, 7) if name == "kernel" else (4, 5)):
                ms, _ = cs.time_ms(dot(lib, di.SMS * per_sm), sets)
                print(f"  {name} {per_sm} CTAs an SM: {ms:.4f} ms",
                      flush=True)
    print(f"card: {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
