#!/usr/bin/env python3
"""Probes behind the designs of the port's kernels on one GPU.

    python3 kernel_probes.py [--src DIR] [section ...]

`chip_smoke.py` times each kernel as the port builds it. This script
times what its designs were chosen against, on the same card and in one
process, and prints one line a measurement (device time a call from
torch.profiler, as chip_smoke.time_ms takes it, and where it says so
CUDA events launch to launch). Sections (all when none is named):

  fused     embedding_bag_fused_fwd at wide-deep's wide arm, ids (65536,
            40, 4) of the synthetic Criteo stream into (40, 2^20, 1) f32
            and bf16 tables: its walk's feature groups (2, 4, 8, 16); 2
            and 4 rows a thread (a probe kernel built on its source, at
            the plan's group); variants without its L2 hints (the
            evict-last policy on the gathers, evict-first on the id and
            output streams, or both); the bound by 32-byte sectors; the
            gathers alone, over the ids in the kernel's walk order and
            sorted; a device sort of the (id, position) pairs, the first
            step of bucketing the ids.
  dot_fwd   dot_interact_fwd at the DLRM shape (2048, 27, 128), f32 and
            bf16, at 1, 2, 4 and 8 warps a CTA and each count of CTAs an
            SM that shared memory allows; bmm + index beside it.
  sage      sage_aggregate_fwd at the GNN train step's three shapes,
            neigh and w each f32 or bf16.
  embedding embedding_bag_fwd at wide-deep's deep arm (65536, 40, 4) x
            (40, 2^20, 32) and the DLRM's (2048, 26, 4) x (26, 2^20, 128),
            f32 and bf16 tables, beside embedding_bag_fused_fwd through
            its wrapper (its 8 MiB dispatch skipped), F.embedding_bag
            and the bound; the SASS of the forward kernels (loads, local
            memory, branches). For this checkout's kernel also: its rows
            walked feature by feature, blocks of 256 and 512 threads, at
            least 16 blocks an SM, streaming output stores, 2 rows a lane
            group (a probe kernel on its helpers), and its gathers alone
            over the same rows in memory order, feature by feature and
            sorted (the floor the random order sets).
  scatter   embedding_bag_bwd at wide-deep's two arms, ids (65536, 40, 4)
            into (40, 2^20, D) at D = 1 and 32, and at the DLRM's (2048,
            26, 4) into (26, 2^20, 128), with its walk's feature group
            overridden (1, 2, 4, 8, 40 at D = 1); beside it index_add_ and
            the bound of chip_smoke.py. The atomics alone: one float4 (D =
            32) or float (D = 1) reduction a row of the same ids in the
            kernel's order, of the distinct ids sorted and shuffled; a
            plain load-add-store and a gather of the same rows. The
            reductions each backward kernel of the built library issues
            (cuobjdump -sass): REDG, fire-and-forget, or ATOMG / ATOM.
            Variants: streaming loads of d_out and ids, TMA bulk reductions
            (cp.reduce.async.bulk, one a row) in place of RED.
  dot_bwd   dot_interact_bwd at 1-6 persistent CTAs an SM, with streaming
            stores, with an L2 prefetch hint on its copies and with its k
            loop unrolled by 8, against bmm.
  narrow    the narrow-row lookups of a driver microbatch, f32, bags of
            one: xDeepFM's tables, ids (32768, 39, 1) into (39, 2^20,
            10), and DIEN's history, ids (6553600, 1, 1) into (1, 2^20,
            18). The forward and the scatter through their wrappers
            beside their plans' launch with the walk or the word
            overridden (the lane walk in 4-byte words, the design before
            the flat walk; the lane walk in 8-byte words; the flat walk
            in 4-byte words); variants with L2 hints (NARROW_VARIANTS:
            outputs stored, ids and d_out loaded evict-first); the
            forward with 1, 2 and 4 words a thread in flight
            (a probe kernel on its helpers, K words t, t + S, ... of the
            grid's S threads); F.embedding, F.embedding_bag, the plain
            indexing gather and index_add_; the bounds. The scatter at D
            = 1 (xDeepFM's linear arm, ids (32768, 39, 1), and the wide
            arm, ids (65536, 40, 4), into 2^20-row tables), and the
            forward there, on the flat walk (their plans) and on the
            lane walk (a thread a row). The loads, local memory and
            reductions of the narrow instantiations (cuobjdump -sass).
  profiler  torch.profiler's windows against CUDA events, at xDeepFM's
            embedding_bag_fwd (ids (32768, 39, 1) into (39, 2^20, 10)):
            PROFILER_WINDOWS windows of 20 calls each (chip_smoke's
            `_profiled`), the host quiet and with 12 busy processes, with
            and without chip_smoke's host wait at either end of a window
            (PAD_S); per window, the device time a call, the least and
            largest duration of its launches, the sum of the short
            sentinels and the window clock (chip_smoke.window_clock);
            beside them, CUDA events around single calls.
  segment   the full graph's gather and segment sum (models/segment.py,
            plain PyTorch) at ogb_products' 2,449,029 nodes and
            61,859,140 edges (random, sorted by dst, drawn on the card),
            D = 100 (layer 1) and 128 (layer 2): the forward and the
            table-gradient backward at 2^20-2^24 pairs a chunk, each
            with its peak memory over the resident tensors; one
            index_select + index_add_ over every pair at once; the
            chunk's index_select and index_add_ alone; the bound
            (inputs read once, output written once) and the floor of
            the message traffic (E x D gathered and added). CUDA events,
            the mean of 3 calls after one warm-up.
  take      the vocab shard's take pair (csrc/embedding_take.cu) at the
            LM embedding shapes (chip_smoke.LM_EMBED_SHAPES: 16,384
            TokenStream ids into gemma2-2b's (256000, 2304) and
            qwen2-moe-a2.7b's (151936, 2048) bf16 tables, one shard):
            the forward with its grid capped at 528, 1056 and 2112
            blocks (further rounds a thread) against one round of
            blocks, beside F.embedding, in turns; the backward's device
            time by kernel; the backward under TAKE_VARIANTS (the sum's
            group of 4, 8 or 16 elements, level 1 held to 1, 2 or 3
            blocks an SM), each checked bitwise against this checkout's
            kernel,
            its total and level-1 times, with ptxas' registers and spills
            of the sum's instantiations; index_add_ beside them.
  dneigh    sage_dneigh_kernel at GraphSAGE's h1 call, (1024, 15, 128)
            from (1024, 47) x (128, 47)^T, after d_w as in the h1
            backward, read by name from profiler windows as
            chip_smoke.named_kernel_ms reads it: under its plan (8 x 32
            tiles) and the 4 x 32 tiles, each as it is and under the
            DNEIGH_VARIANTS of the store path and tile (`tma`: the tile
            in shared memory written by TMA bulk copies; `float4`: by
            float4 stores; `cs`: evict-first stores; `cols64`, `cols128`:
            tiles that wide; `rr4`: 16 x 32 tiles in place of the plan's);
            at the plan also those that show where its time goes
            (`one_copy`: each row written once, not F times; `no_stage`:
            no loads of w and d_out; `stage_only`: a return before the
            product; `store_only`: no product, a tile of zeros written;
            `empty`: a return at its top; `carveout`: the largest
            shared-memory carve-out, d_w's) and the plan alone (no d_w
            before it). Two rounds in turns; each variant that computes
            the same sums bitwise against the plan's d_neigh; the plain
            version, the library expression, fill_ of a tensor of
            d_neigh's shape (the card's write rate through PyTorch) and
            the bound of chip_smoke.py beside them. With `--src`, that
            checkout's kernel under its own plan alone.
  scatter_bf16  embedding_bag_bwd into a bf16 gradient at dlrm-criteo's
            training shape, ids (65536, 26, 1) of the synthetic Criteo
            stream into (26, 2^22, 128): its bf16x2 REDs against the
            variant `atomic` (cuda_bf16.h's atomicAdd, a generic atom that
            returns the old value), in turns, with the reductions each
            bf16 instantiation issues (cuobjdump -sass).

Each variant is a copy of a kernel source under src/repro_torch/kernels/
csrc with one edit, built with nvcc into build/kernel_probes/. `--src
DIR` imports repro_torch from DIR (say, the src of an unpacked earlier
commit) for the sections that call only its wrappers (sage, embedding:
there the variants are left out).
It needs one CUDA card and nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# `--src DIR` times the repro_torch under DIR instead (another checkout's
# src, for the same probes on two versions in one process's conditions)
SRC = (sys.argv[2] if sys.argv[1:2] == ["--src"]
       else os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)
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
    ('''template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void scatter_row(''',
     '''template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void scatter_row_red('''),
    ('''// dOut (B, F, D) f32 scatter-added into the zeroed dense gradient''',
     '''template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void scatter_row(const float* src, T* dst,
                                            const int32_t (&id)[kUnroll],
                                            const float (&w)[kUnroll],
                                            int64_t D, int lane, int lanes,
                                            int n, float bag, int mean) {
  // the bulk reductions are f32 and take float4 rows: the other paths
  // keep their atomics
  if constexpr (sizeof(T) == 2 || VEC != 4) {
    scatter_row_red<T, VEC, kUnroll>(src, dst, id, w, D, lane, lanes, n,
                                     bag, mean);
    return;
  }
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

// dOut (B, F, D) f32 scatter-added into the zeroed dense gradient'''),
    ('''    if (vec == 4) BWD(float, 4, false);''',
     '''    if (vec == 4) {
      cudaFuncSetAttribute(embedding_bag_bwd_kernel<float, 4, 4, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (kBwdThreads >> lanes_log2) * 16 *
                               static_cast<int>(D));
      BWD(float, 4, false);
    }'''),
    ('''    embedding_bag_bwd_kernel<T, VEC, 4, kFlat><<<grid, kBwdThreads, 0, s>>>(''',
     '''    embedding_bag_bwd_kernel<T, VEC, 4, kFlat><<<grid, kBwdThreads,
        VEC == 4 && sizeof(T) == 4 ? (kBwdThreads >> lanes_log2) * 16 * D : 0,
        s>>>('''),
)

# the bf16 scatter's pairs through cuda_bf16.h's atomicAdd
SCATTER_BF16_VARIANTS = {
    "atomic": (('''  asm volatile("red.global.add.noftz.bf16x2 [%0], %1;" ::"l"(p),
               "r"(bf16_bits(a) | (bf16_bits(b) << 16))
               : "memory");''',
                '''  atomicAdd(reinterpret_cast<__nv_bfloat162*>(p),
            __floats2bfloat162_rn(a, b));'''),),
}

SCATTER_VARIANTS = {
    "ldcs": (
        ("__ldg(reinterpret_cast<const float4*>(src) + c)",
         "__ldcs(reinterpret_cast<const float4*>(src) + c)"),
        ("__ldg(reinterpret_cast<const int4*>(p + j))",
         "__ldcs(reinterpret_cast<const int4*>(p + j))")),
    "bulk": BULK,
}
# the forward's d loop unrolled by 2
DOT_FWD_VARIANTS = {
    "unroll2": (("        for (int d = 0; d < D; d += 4) {\n"
                 "          float4 vj[kBlk];",
                 "#pragma unroll 2\n"
                 "        for (int d = 0; d < D; d += 4) {\n"
                 "          float4 vj[kBlk];"),),
}
DOT_VARIANTS = {
    "stcs": (("reinterpret_cast<float4*>(dst + (i0 + r) * D)[col] = acc[r];",
              "__stcs(reinterpret_cast<float4*>(dst + (i0 + r) * D) + col, "
              "acc[r]);"),),
    "l2_256B": (('"cp.async.cg.shared.global [%0], [%1], 16;\\n"',
                 '"cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\\n"'),),
    "unroll8": (("#pragma unroll 4\n        for (int k = 0; k < F; ++k) {\n"
                 "          float4 v;",
                 "#pragma unroll 8\n        for (int k = 0; k < F; ++k) {\n"
                 "          float4 v;"),),
}

# the fused forward's gathers alone: a thread a row of 4 flat ids (f V +
# id, 32-bit) read as one int4, the 4 table elements summed into one
# output; over the ids in the kernel's walk order, or sorted (the same
# accesses a bucketing of the ids would give, its own cost aside)
GATHER = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void gather4(const float* t, const int4* idx, float* out,
                        int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int4 v = __ldg(idx + i);
  out[i] = ((__ldg(t + v.x) + __ldg(t + v.y)) + __ldg(t + v.z)) +
           __ldg(t + v.w);
}
extern "C" int gather(const float* t, const int* idx, float* out, int64_t n,
                      void* stream) {
  gather4<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      t, reinterpret_cast<const int4*>(idx), out, n);
  return (int)cudaGetLastError();
}
'''

# the fused forward without its L2 hints: the gathers without the
# evict-last policy, the id and output streams without evict-first, or
# neither
_NO_KEEP = (("    u.r = ld_keep(reinterpret_cast<const R*>(p));",
             "    u.r = __ldg(reinterpret_cast<const R*>(p));"),)
_NO_STREAM = (
    ("  return __ldcs(reinterpret_cast<const int4*>(p));",
     "  return __ldg(reinterpret_cast<const int4*>(p));"),
    ("  return __ldcs(p);", "  return __ldg(p);"),
    ("    __stcs(p, v[0]);", "    *p = v[0];"),
)
FUSED_VARIANTS = {"no_keep": _NO_KEEP, "no_stream": _NO_STREAM,
                  "no_hints": _NO_KEEP + _NO_STREAM}

# the fused forward with R rows a thread (consecutive places of its walk,
# every row's 4 gathers in flight before the adds) at D = 1, bags of 4,
# "sum": its source's helpers (place, the L2-hinted gathers and streams)
# with a kernel of its own
FUSED_ROWS = r'''
#include "embedding_bag_fused.cu"
namespace {
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ tables, const int32_t* __restrict__ ids,
            float* __restrict__ out, int64_t B, int64_t F, int64_t V,
            int group) {
  const int64_t slot0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (slot0 >= B * F) return;
  int64_t row[R];
  const T* table[R];
  int32_t id[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (slot0 + r >= B * F) continue;
    int64_t b, f;
    place(static_cast<uint32_t>(slot0 + r), static_cast<uint32_t>(B),
          static_cast<uint32_t>(F), static_cast<uint32_t>(group), &b, &f);
    row[r] = b * F + f;
    table[r] = tables + f * V;
    const int4 v = ld_ids4(ids + row[r] * 4);
    id[r][0] = v.x;
    id[r][1] = v.y;
    id[r][2] = v.z;
    id[r][3] = v.w;
  }
  float x[R][4][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (slot0 + r >= B * F) continue;
      if (valid_id(id[r][j], V)) {
        gather_f32<T, 1>(table[r] + id[r][j], x[r][j]);
      } else {
        x[r][j][0] = __int_as_float(0x7fc00000);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (slot0 + r >= B * F) continue;
    float acc[1] = {0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0] += x[r][j][0];
    st_out<1>(out + row[r], acc);
  }
}
template <typename T, int R>
void rows_launch(const void* t, const int32_t* ids, float* out, int64_t B,
                 int64_t F, int64_t V, int group, cudaStream_t s) {
  const int64_t threads = (B * F + R - 1) / R;
  rows_kernel<T, R><<<(unsigned)((threads + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(static_cast<const T*>(t), ids, out,
                                        B, F, V, group);
}
}  // namespace
extern "C" int fused_rows(const void* tables, const int32_t* ids, float* out,
                          int64_t B, int64_t F, int64_t V, int32_t bf16,
                          int32_t rows, int32_t group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 2 && !bf16)
    rows_launch<float, 2>(tables, ids, out, B, F, V, group, s);
  else if (rows == 4 && !bf16)
    rows_launch<float, 4>(tables, ids, out, B, F, V, group, s);
  else if (rows == 2)
    rows_launch<__nv_bfloat16, 2>(tables, ids, out, B, F, V, group, s);
  else if (rows == 4)
    rows_launch<__nv_bfloat16, 4>(tables, ids, out, B, F, V, group, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
'''

# the forward walking its rows feature by feature (feature-major: row
# b F + f at place f B + b) instead of in memory order, with blocks of
# 256 or 512 threads, with at least 16 blocks of 128 an SM (32 registers
# a thread), and with its output written evict-first (streaming stores)
EMB_FWD_VARIANTS = {
    "feature_major": (
        ("  const int64_t row = t >> lanes_log2;\n"
         "  if (row >= rows) return;",
         "  const int64_t place = t >> lanes_log2;\n"
         "  if (place >= rows) return;\n"
         "  const int64_t row =\n"
         "      place % (rows / F) * F + place / (rows / F);"),),
    "threads256": (("constexpr int kFwdThreads = 128;",
                    "constexpr int kFwdThreads = 256;"),),
    "threads512": (("constexpr int kFwdThreads = 128;",
                    "constexpr int kFwdThreads = 512;"),),
    "min16blocks": (("__global__ void __launch_bounds__(kFwdThreads)\n"
                     "embedding_bag_fwd_kernel(",
                     "__global__ void __launch_bounds__(kFwdThreads, 16)\n"
                     "embedding_bag_fwd_kernel("),),
    "stcs": (("    *p = v[0];", "    __stcs(p, v[0]);"),
             ("    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);",
              "    __stcs(reinterpret_cast<float2*>(p), "
              "make_float2(v[0], v[1]));"),
             ("      *reinterpret_cast<float4*>(p + i) =\n"
              "          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);",
              "      __stcs(reinterpret_cast<float4*>(p + i),\n"
              "             make_float4(v[i], v[i + 1], v[i + 2], "
              "v[i + 3]));")),
}
EMB_FWD_THREADS = {"threads256": 256, "threads512": 512}

# the narrow rows' streams with L2 hints: the outputs stored evict-first
# (the forward's `stcs`), the ids and the scatter's d_out loaded
# evict-first (`ldcs`), or both
_LDCS = (("      if (j < n) id[j] = __ldg(p + j);",
          "      if (j < n) id[j] = __ldcs(p + j);"),
         ("      float2 g = __ldg(reinterpret_cast<const float2*>(src) + c);",
          "      float2 g = __ldcs(reinterpret_cast<const float2*>(src) + "
          "c);"))
# the lane walk for f32 tables' and gradients' 8- and 4-byte words, the
# design before the flat walk, chosen by the plan's lanes_log2 (-1: flat)
_LANES = (
    ("  // the flat walk: exactly an f32 table's 8- and 4-byte words\n"
     "  const bool flat = !bf16 && vec < 4;",
     "  const bool flat = lanes_log2 == -1;"),
    ("  // the flat walk: exactly an f32 gradient's 8- and 4-byte words\n"
     "  const bool flat = !bf16 && vec < 4;",
     "  const bool flat = lanes_log2 == -1;"),
    ("    else if (vec == 2) FWD(float, 2, true);\n"
     "    else FWD(float, 1, true);",
     "    else if (vec == 2 && flat) FWD(float, 2, true);\n"
     "    else if (vec == 2) FWD(float, 2, false);\n"
     "    else if (flat) FWD(float, 1, true);\n"
     "    else FWD(float, 1, false);"),
    ("    else if (vec == 2) BWD(float, 2, true);\n"
     "    else BWD(float, 1, true);",
     "    else if (vec == 2 && flat) BWD(float, 2, true);\n"
     "    else if (vec == 2) BWD(float, 2, false);\n"
     "    else if (flat) BWD(float, 1, true);\n"
     "    else BWD(float, 1, false);"))
NARROW_VARIANTS = {"stcs": EMB_FWD_VARIANTS["stcs"], "ldcs": _LDCS,
                   "stream": EMB_FWD_VARIANTS["stcs"] + _LDCS,
                   "lanes": _LANES}

# two probe kernels on the forward's helpers (words, widening, stores),
# for 16-byte loads, bags of 4 and "sum": the forward's body with 2 rows
# a lane group (consecutive rows in memory order, both rows' 4 loads in
# flight before the adds), and the gathers alone (a lane group a row of
# 4 flat row indices f V + id, one int4, with no place arithmetic and no
# id check) over flat indices in any order
EMB_PROBE = r'''
#include "embedding_bag.cu"
namespace {
template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
rows2_kernel(const T* __restrict__ tables, const int32_t* __restrict__ ids,
             float* __restrict__ out, int64_t rows, int64_t F, int64_t V,
             int64_t D, int lanes_log2) {
  using W = typename Word<T, VEC>::type;
  const int64_t t = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x;
  const int64_t row0 = (t >> lanes_log2) * 2;
  if (row0 >= rows) return;
  const int lanes = 1 << lanes_log2;
  const int lane = (int)(t & (lanes - 1));
  int32_t id[2][4];
  const T* table[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + r < rows ? row0 + r : row0;
    const int4 v = __ldg(reinterpret_cast<const int4*>(ids) + row);
    id[r][0] = v.x; id[r][1] = v.y; id[r][2] = v.z; id[r][3] = v.w;
    table[r] = tables + (int64_t)((uint32_t)row % (uint32_t)F) * V * D;
  }
  const W* no_row = reinterpret_cast<const W*>(&g_no_row);
  const float nan = __int_as_float(0x7fc00000);
  for (int64_t c = lane; c < D / VEC; c += lanes) {
    W w[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[r][j] = __ldg(valid_id(id[r][j], V)
                            ? reinterpret_cast<const W*>(
                                  table[r] + (int64_t)id[r][j] * D) + c
                            : no_row);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + r >= rows) continue;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[VEC];
        widen(w[r][j], v);
        const bool ok = valid_id(id[r][j], V);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += ok ? v[k] : nan;
      }
      st_f32<VEC>(out + (row0 + r) * D + c * VEC, acc);
    }
  }
}
template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
gather_rows_kernel(const T* __restrict__ tables, const int4* __restrict__ flat,
                   float* __restrict__ out, int64_t rows, int64_t D,
                   int lanes_log2) {
  using W = typename Word<T, VEC>::type;
  const int64_t t = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x;
  const int64_t row = t >> lanes_log2;
  if (row >= rows) return;
  const int lanes = 1 << lanes_log2;
  const int4 q = __ldg(flat + row);
  for (int64_t c = (int)(t & (lanes - 1)); c < D / VEC; c += lanes) {
    W w[4];
    w[0] = __ldg(reinterpret_cast<const W*>(tables + (int64_t)q.x * D) + c);
    w[1] = __ldg(reinterpret_cast<const W*>(tables + (int64_t)q.y * D) + c);
    w[2] = __ldg(reinterpret_cast<const W*>(tables + (int64_t)q.z * D) + c);
    w[3] = __ldg(reinterpret_cast<const W*>(tables + (int64_t)q.w * D) + c);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[VEC];
      widen(w[j], v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
    st_f32<VEC>(out + row * D + c * VEC, acc);
  }
}
}  // namespace
extern "C" int rows2(const void* tables, const int32_t* ids, float* out,
                     int64_t B, int64_t F, int64_t V, int64_t D,
                     int32_t bf16, int32_t lanes_log2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = B * F;
  const unsigned blocks = (unsigned)(
      ((((rows + 1) / 2) << lanes_log2) + kFwdThreads - 1) / kFwdThreads);
  if (D % (bf16 ? 8 : 4)) return (int)cudaErrorInvalidValue;
  if (bf16)
    rows2_kernel<__nv_bfloat16, 8><<<blocks, kFwdThreads, 0, s>>>(
        (const __nv_bfloat16*)tables, ids, out, rows, F, V, D, lanes_log2);
  else
    rows2_kernel<float, 4><<<blocks, kFwdThreads, 0, s>>>(
        (const float*)tables, ids, out, rows, F, V, D, lanes_log2);
  return (int)cudaGetLastError();
}
extern "C" int gather_rows(const void* tables, const int32_t* flat,
                           float* out, int64_t rows, int64_t D, int32_t bf16,
                           int32_t lanes_log2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks =
      (unsigned)(((rows << lanes_log2) + kFwdThreads - 1) / kFwdThreads);
  if (D % (bf16 ? 8 : 4)) return (int)cudaErrorInvalidValue;
  if (bf16)
    gather_rows_kernel<__nv_bfloat16, 8><<<blocks, kFwdThreads, 0, s>>>(
        (const __nv_bfloat16*)tables, (const int4*)flat, out, rows, D,
        lanes_log2);
  else
    gather_rows_kernel<float, 4><<<blocks, kFwdThreads, 0, s>>>(
        (const float*)tables, (const int4*)flat, out, rows, D, lanes_log2);
  return (int)cudaGetLastError();
}
'''

# the forward's flat walk for f32 tables and bags of one ("sum") with K
# words a thread in flight: thread t takes words t, t + S, ..., t + (K -
# 1) S of the grid's S threads, every word's id load, then every word's
# table load, issued before the first store; its source's helpers
FLAT_WORDS = r'''
#include "embedding_bag.cu"
namespace {
template <int VEC, int K>
__global__ void __launch_bounds__(kFwdThreads)
flat_words_kernel(const float* __restrict__ tables,
                  const int32_t* __restrict__ ids, float* __restrict__ out,
                  int64_t rows, int64_t F, int64_t V, int64_t D,
                  Div per_row, Div per_feat) {
  using W = typename Word<float, VEC>::type;
  const int64_t S = (int64_t)gridDim.x * kFwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kFwdThreads + threadIdx.x;
  const int words = (int)(D / VEC);
  int64_t row[K];
  int c[K];
  int32_t id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row[k] = quotient(t + k * S, words, per_row);
    c[k] = (int)(t + k * S - row[k] * words);
    id[k] = row[k] < rows ? __ldg(ids + row[k]) : -1;
  }
  const W* no_row = reinterpret_cast<const W*>(&g_no_row);
  W w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t f = row[k] - quotient(row[k], F, per_feat) * F;
    w[k] = __ldg(valid_id(id[k], V)
                     ? reinterpret_cast<const W*>(
                           tables + (f * V + id[k]) * D) + c[k]
                     : no_row);
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (row[k] >= rows) continue;
    float v[VEC], acc[VEC];
    widen(w[k], v);
    const bool ok = valid_id(id[k], V);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[j] = 0.f;
      acc[j] += ok ? v[j] : nan;
    }
    st_f32<VEC>(out + row[k] * D + c[k] * VEC, acc);
  }
}
template <int VEC, int K>
void flat_launch(unsigned blocks, cudaStream_t s, const float* tables,
                 const int32_t* ids, float* out, int64_t rows, int64_t F,
                 int64_t V, int64_t D, Div r, Div f) {
  flat_words_kernel<VEC, K><<<blocks, kFwdThreads, 0, s>>>(
      tables, ids, out, rows, F, V, D, r, f);
}
}  // namespace
extern "C" int flat_words(const float* tables, const int32_t* ids,
                          float* out, int64_t B, int64_t F, int64_t V,
                          int64_t D, int32_t vec, int32_t k, int64_t blocks,
                          int64_t row_magic, int32_t row_shift,
                          int64_t feat_magic, int32_t feat_shift,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Div r{(uint32_t)row_magic, row_shift};
  const Div f{(uint32_t)feat_magic, feat_shift};
  const unsigned g = (unsigned)blocks;
  if (D % vec || blocks * kFwdThreads * k < B * F * (D / vec))
    return (int)cudaErrorInvalidValue;
#define FLAT(V_, K_) \
  if (vec == V_ && k == K_) \
    flat_launch<V_, K_>(g, s, tables, ids, out, B * F, F, V, D, r, f);
  FLAT(2, 1) FLAT(2, 2) FLAT(2, 4) FLAT(1, 1) FLAT(1, 2) FLAT(1, 4)
#undef FLAT
  return (int)cudaGetLastError();
}
'''

# the scatter's flat walk for f32 gradients, D % 4 == 2 and bags of one
# ("sum"), features walked one a group (gridDim.y), on its source's
# helpers: mode 0, float2 words, K a thread (words t + k S of the group's
# grid of S threads, every word's id and d_out loads before the first
# RED); mode 1, the same REDs of 1.0 with no d_out read (the REDs and the
# id loads alone); mode 2, D / 4 + 1 words a row, each a float4 RED where
# the gradient row is 16-byte aligned there and a float2 at the row's
# 8-byte aligned end (D / 4 float4s and one float2 a row, for D / 2
# float2s), d_out read as float2s
BWD_WORDS = r'''
#include "embedding_bag.cu"
namespace {
template <int MODE, int K>
__global__ void __launch_bounds__(kBwdThreads)
bwd_words_kernel(const float* __restrict__ d_out,
                 const int32_t* __restrict__ ids, float* __restrict__ grad,
                 int64_t B, int64_t F, int64_t V, int64_t D, Div per_row) {
  const int64_t f = blockIdx.y;
  const int64_t S = (int64_t)gridDim.x * kBwdThreads;
  const int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  const int words = MODE == 2 ? (int)(D / 4 + 1) : (int)(D / 2);
  int64_t b[K];
  int c[K];
  int32_t id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    b[k] = quotient(t + k * S, words, per_row);
    c[k] = (int)(t + k * S - b[k] * words);
    id[k] = b[k] < B ? __ldg(ids + b[k] * F + f) : -1;
  }
  float* dst = grad + f * V * D;
  if constexpr (MODE == 2) {
    const int m = (int)(D / 4);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!valid_id(id[k], V)) continue;
      const float* src = d_out + (b[k] * F + f) * D;
      float* row = dst + (int64_t)id[k] * D;
      const bool a16 = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
      const int off = a16 ? 4 * c[k] : (c[k] == 0 ? 0 : 4 * c[k] - 2);
      const bool four = a16 ? c[k] < m : c[k] > 0;
      const float2 lo = __ldg(reinterpret_cast<const float2*>(src + off));
      if (four) {
        const float2 hi =
            __ldg(reinterpret_cast<const float2*>(src + off + 2));
        atomicAdd(reinterpret_cast<float4*>(row + off),
                  make_float4(lo.x, lo.y, hi.x, hi.y));
      } else {
        atomicAdd(reinterpret_cast<float2*>(row + off), lo);
      }
    }
  } else {
    float2 g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g[k] = MODE == 1 || !valid_id(id[k], V)
                 ? make_float2(1.f, 1.f)
                 : __ldg(reinterpret_cast<const float2*>(
                             d_out + (b[k] * F + f) * D) + c[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (valid_id(id[k], V))
        atomicAdd(reinterpret_cast<float2*>(dst + (int64_t)id[k] * D) +
                      c[k], g[k]);
    }
  }
}
template <int MODE, int K>
void words_launch(dim3 grid, cudaStream_t s, const float* d_out,
                  const int32_t* ids, float* grad, int64_t B, int64_t F,
                  int64_t V, int64_t D, Div r) {
  bwd_words_kernel<MODE, K><<<grid, kBwdThreads, 0, s>>>(d_out, ids, grad,
                                                         B, F, V, D, r);
}
}  // namespace
extern "C" int bwd_words(const float* d_out, const int32_t* ids, float* grad,
                         int64_t B, int64_t F, int64_t V, int64_t D,
                         int32_t mode, int32_t k, int64_t blocks,
                         int64_t row_magic, int32_t row_shift,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t words = mode == 2 ? D / 4 + 1 : D / 2;
  if (D % 4 != 2 || blocks * kBwdThreads * k < B * words || F > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)F);
  const Div r{(uint32_t)row_magic, row_shift};
#define WORDS(M_, K_) \
  if (mode == M_ && k == K_) \
    words_launch<M_, K_>(grid, s, d_out, ids, grad, B, F, V, D, r);
  WORDS(0, 1) WORDS(0, 2) WORDS(1, 1) WORDS(2, 1) WORDS(2, 2)
#undef WORDS
  return (int)cudaGetLastError();
}
'''

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


# the take backward's level-1 sum: its group of elements (kSumUnroll) and
# the blocks an SM that launch bounds ask of level 1 (none: 1)
_UNROLL = "constexpr int kSumUnroll = 4;"
_BOUNDS = ("__launch_bounds__(kSumThreads)\n"
           "embedding_take_bwd_sum_kernel(")
TAKE_VARIANTS = {
    f"u{u}_b{b}": [(_UNROLL, f"constexpr int kSumUnroll = {u};"),
                   (_BOUNDS, f"__launch_bounds__(kSumThreads, "
                             f"kFirst ? {b} : 1)\n"
                             f"embedding_take_bwd_sum_kernel(")]
    for u, b in ((4, 2), (8, 1), (8, 2), (8, 3), (16, 1))}


# sage_dneigh_kernel's other store paths: its tile put in shared memory,
# then each row written F times, (row, f) in order, by TMA bulk copies
# (`tma`) or float4 stores (`float4`; rows of 32 floats, as at h1); both
# take D a multiple of 4 and a 16-byte aligned d_neigh, as at h1
_DN_STORES_AT = ("  // the stores, straight from registers: each (row, f) a "
                 "warp's 32")
_DN_TILE = r"""  __shared__ __align__(16) float v_s[rows * kDnCols];
#pragma unroll
  for (int i = 0; i < RR; ++i) v_s[(r0 + i) * kDnCols + dl] = acc[i] / f_div;
"""
DNEIGH_VARIANTS = {
    "tma": ((_DN_STORES_AT, _DN_TILE + r"""  // the tile's writes, made by the generic proxy, seen by the copies
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int r = tid / F, f = tid % F; r < nr;) {
    const uint32_t src = static_cast<uint32_t>(
        __cvta_generic_to_shared(v_s + r * kDnCols));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(d_neigh + ((b0 + r) * F + f) * D + d0), "r"(src),
           "r"(static_cast<uint32_t>(nc) * 4) : "memory");
    for (f += kDnThreads; f >= F; f -= F) ++r;
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // the tile stays until the copies have read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  if (B > 0) return;
""" + _DN_STORES_AT),),
    "float4": ((_DN_STORES_AT, _DN_TILE + r"""  __syncthreads();
  {
    constexpr int nv = kDnCols / 4;           // float4s a row
    constexpr int groups = kDnThreads / nv;   // (row, f) written at once
    const int j = (tid % nv) * 4;
    for (int r = tid / nv / F, f = tid / nv % F; r < nr;) {
      *reinterpret_cast<float4*>(d_neigh + ((b0 + r) * F + f) * D + d0 +
                                 j) =
          *reinterpret_cast<const float4*>(v_s + r * kDnCols + j);
      for (f += groups; f >= F; f -= F) ++r;
    }
  }
  if (B > 0) return;
""" + _DN_STORES_AT),),
    # evict-first stores (__stcs)
    "cs": (("      dst[static_cast<int64_t>(f) * D] = v;",
            "      __stcs(dst + static_cast<int64_t>(f) * D, v);"),),
    # tiles of 64 and 128 columns (4 x 64 and 2 x 128 at the plan's rows a
    # thread), and of 16 rows (4 a thread) where the plan takes 8
    "cols64": (("constexpr int kDnCols = 32;",
                "constexpr int kDnCols = 64;"),),
    "cols128": (("constexpr int kDnCols = 32;",
                 "constexpr int kDnCols = 128;"),),
    "rr4": ((": launch_dneigh<2>(", ": launch_dneigh<4>("),),
}

# where sage_dneigh_kernel's time goes: each row of the tile written once
# (one copy of F), and no staging of w and d_out (the product of whatever
# shared memory holds, then all F copies)
DNEIGH_VARIANTS["one_copy"] = ((
    "    for (int f = 0; f < F; ++f)\n      dst[",
    "    for (int f = 0; f < 1; ++f)\n      dst["),)
DNEIGH_VARIANTS["no_stage"] = (
    ("      cp_async<16>(flat + k0, base + k0, true);", "      {}"),
    ("        if (k >= pad && k < pad + n) cp_async<4>(flat + k, base + k, "
     "true);", "        {}"),
    ("          cp_async<4>(w_s + r * ld + h, ok ? src + h : w, ok);",
     "          {}"))
# the staging alone (a return before the product), and the stores alone
# (no chunk of H: the tile is zeros)
DNEIGH_VARIANTS["stage_only"] = ((
    "    // the product, h ascending",
    "    if (B > 0) return;\n    // the product, h ascending"),)
DNEIGH_VARIANTS["store_only"] = (
    ("  const bool run = dn_runs(H);", "  const bool run = false;"),
    ("  for (int h0 = 0; h0 < H; h0 += kDnKH) {",
     "  for (int h0 = 0; h0 < 0; h0 += kDnKH) {"))

# and a kernel that returns at once (its launch and CTAs alone)
DNEIGH_VARIANTS["empty"] = ((
    "  const bool run = dn_runs(H);",
    "  if (B > 0) return;\n  const bool run = dn_runs(H);"),)

# the SM's shared memory carve-out set to its largest, as d_w's 128 KB
# CTAs need it, so that no reconfiguration comes between the two kernels
DNEIGH_VARIANTS["carveout"] = ((
    "  sage_dneigh_kernel<RR><<<grid, kDnThreads, dn_smem(rows, H), s>>>(",
    "  const cudaError_t err = cudaFuncSetAttribute(\n"
    "      sage_dneigh_kernel<RR>,\n"
    "      cudaFuncAttributePreferredSharedMemoryCarveout,\n"
    "      cudaSharedmemCarveoutMaxShared);\n"
    "  if (err != cudaSuccess) return err;\n"
    "  sage_dneigh_kernel<RR><<<grid, kDnThreads, dn_smem(rows, H), s>>>("),)
# the variants whose d_neigh is the plan's, bit for bit (each value's sum
# has the same order), and those the probe also runs at the other tile
DNEIGH_SAME = ("default", "cs", "tma", "float4", "cols64", "cols128", "rr4",
               "carveout")
DNEIGH_OTHER = ("default", "cs", "tma", "float4", "cols64", "cols128")

# nvcc's output (ptxas' report) for each variant built
VARIANT_LOGS = {}


def build_variants(sections):
    """nvcc for the micro kernels and the variants of `sections`, started
    together; returns their loaded libraries. The forward's variants
    (section `embedding`) are this checkout's, and are built only when
    repro_torch is this checkout's too (no `--src`)."""
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    sources = {"micro": MICRO} if "scatter" in sections else {}
    if "fused" in sections:
        sources["gather"] = GATHER
        sources["fused_rows"] = FUSED_ROWS
    own = SRC == os.path.join(ROOT, "src")
    if "embedding" in sections and own:
        sources["emb_probe"] = EMB_PROBE
    if "narrow" in sections and own:
        sources["flat_words"] = FLAT_WORDS
        sources["bwd_words"] = BWD_WORDS
    for src, variants, section in (
            ("embedding_bag", SCATTER_VARIANTS, "scatter"),
            ("embedding_bag", SCATTER_BF16_VARIANTS, "scatter_bf16"),
            ("embedding_bag", EMB_FWD_VARIANTS,
             "embedding" if own else None),
            ("embedding_bag", NARROW_VARIANTS, "narrow" if own else None),
            ("dot_interact", DOT_VARIANTS, "dot_bwd"),
            ("dot_interact", DOT_FWD_VARIANTS, "dot_fwd"),
            ("embedding_bag_fused", FUSED_VARIANTS, "fused"),
            ("embedding_take", TAKE_VARIANTS, "take" if own else None),
            ("sage_aggregate", DNEIGH_VARIANTS, "dneigh" if own else None)):
        if section not in sections:
            continue
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
            [build.nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o",
             path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        VARIANT_LOGS[name] = log
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        if name == "micro":
            lib.micro.argtypes = (_I32, _P, _P, _P, _I64, _P)
        elif name == "gather":
            lib.gather.argtypes = (_P, _P, _P, _I64, _P)
        elif name == "fused_rows":
            lib.fused_rows.argtypes = (_P, _P, _P, _I64, _I64, _I64, _I32,
                                       _I32, _I32, _P)
        elif name == "flat_words":
            lib.flat_words.argtypes = (_P, _P, _P, _I64, _I64, _I64, _I64,
                                       _I32, _I32, _I64, _I64, _I32, _I64,
                                       _I32, _P)
        elif name == "bwd_words":
            lib.bwd_words.argtypes = (_P, _P, _P, _I64, _I64, _I64, _I64,
                                      _I32, _I32, _I64, _I64, _I32, _P)
        elif name == "emb_probe":
            lib.rows2.argtypes = (_P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                                  _I32, _P)
            lib.gather_rows.argtypes = (_P, _P, _P, _I64, _I64, _I32, _I32,
                                        _P)
        else:
            src = next(k for k in sorted(build.SIGNATURES, key=len,
                                         reverse=True)
                       if name.startswith(k + "_"))
            for fn, argtypes in build.SIGNATURES[src].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_ops(path: str, ops, match: str) -> dict:
    """{kernel: {opcode: count}} of the instructions whose opcode starts
    with one of `ops` in each kernel of the library at `path` whose name
    holds `match`."""
    out = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {}
        elif name is not None:
            for word in line.replace(";", " ").split():
                if word.startswith(ops):
                    counts[name][word] = counts[name].get(word, 0) + 1
    return {k: v for k, v in counts.items() if match in k}


def probe_fused(cs, libs, ids, cfg, gen):
    """The fused forward at the wide arm: plan sweeps and variants, f32 and
    bf16, two rounds in turns (the second in reverse order); the sector
    bound; a device sort of the (id, position) pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.build import LIBRARIES
    dev = ids.device
    b, n_f, bag = ids.shape
    rows = cfg.vocab_sizes[0]
    ids2 = torch.as_tensor(cs._criteo_batch(cfg, 65536, 3)["sparse_ids"]) \
        .to(dev)
    sets = [(ids,), (ids2,)]
    offs = (torch.arange(n_f, device=dev) * rows).view(1, n_f, 1)
    flat = (ids.long() + offs).reshape(-1)
    uniq = int(torch.unique(flat).numel())
    wide = torch.empty((n_f, rows, 1), device=dev)
    wide.normal_(generator=gen).mul_(0.01)
    out = torch.empty((b, n_f, 1), device=dev)

    def fused(lib, table, r, g):
        # the plan with its walk's group overridden; r rows a thread
        # through the probe kernel
        plan = eb.fused_plan(b, n_f, rows, 1, bag, table.element_size())
        bf16 = int(table.dtype == torch.bfloat16)

        def call(i):
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.embedding_bag_fused_fwd(
                table.data_ptr(), i.data_ptr(), out.data_ptr(), b, n_f, rows,
                1, bag, 0, bf16, plan.vec, plan.lanes_log2, g, plan.blocks,
                stream) if r == 1 else libs["fused_rows"].fused_rows(
                table.data_ptr(), i.data_ptr(), out.data_ptr(), b, n_f, rows,
                bf16, r, g, stream)
            if status != 0:
                raise RuntimeError(f"embedding_bag_fused_fwd: CUDA error "
                                   f"{status}")
        return call

    variants = [("kernel", LIBRARIES.get("embedding_bag_fused"))] + [
        (n, libs[f"embedding_bag_fused_{n}"]) for n in FUSED_VARIANTS]
    for dtype in (torch.float32, torch.bfloat16):
        table = wide.to(dtype)
        elem = table.element_size()
        sectors = int(torch.unique(flat // (32 // elem)).numel())
        bnd, _ = cs.bound_ms(ids.numel() * 4 + uniq * elem + b * n_f * 4, 0)
        sbnd, _ = cs.bound_ms(ids.numel() * 4 + sectors * 32 + b * n_f * 4,
                              0)
        lib_t = cs.time_ms(lambda x: F.embedding_bag(
            x, table.view(n_f * rows, 1), mode="sum"),
            [((i.long() + offs).reshape(b * n_f, bag),) for (i,) in sets])
        print(f"fused {str(dtype)[6:]}: bound {bnd:.4f} ms ({uniq} rows), "
              f"by sectors {sbnd:.4f} ms ({sectors} sectors of 32 B); "
              f"F.embedding_bag {lib_t.ms:.4f} ms", flush=True)
        g0 = eb.fused_plan(b, n_f, rows, 1, bag, elem).group
        want = eb.embedding_bag_fused_fwd(table, ids)
        for r in (2, 4):
            fused(None, table, r, g0)(ids)
            if not torch.equal(out, want):
                raise AssertionError(f"{r} rows a thread: not bit-equal to "
                                     f"embedding_bag_fused_fwd")
        for rnd in range(2):
            for name, lib in variants[::1 if rnd == 0 else -1]:
                sweep = ([(1, g) for g in (2, 4, 8, 16)]
                         + [(2, g0), (4, g0)] if name == "kernel"
                         else [(1, g0)])
                for r, g in sweep:
                    t = cs.time_ms(fused(lib, table, r, g), sets,
                                   kernel="embedding_bag_fused_fwd_kernel"
                                   if r == 1 else "rows_kernel")
                    print(f"  {name} rows {r} group {g}: {t.ms:.4f} ms, "
                          f"{t.wall:.4f} launch to launch", flush=True)
        del table
    # the gathers alone, in the walk order of groups of 4 features and
    # sorted
    walk = (ids.long() + offs).view(b, n_f // 4, 4, bag).permute(1, 0, 2, 3) \
        .reshape(-1).int()
    for order, idx in (("walk order", walk),
                       ("sorted", torch.sort(walk).values)):
        t = cs.time_ms(lambda: libs["gather"].gather(
            wide.data_ptr(), idx.data_ptr(), out.data_ptr(), b * n_f,
            torch.cuda.current_stream().cuda_stream), [()], kernel="gather4")
        print(f"  gathers alone (f32), {order}: {t.ms:.4f} ms, {t.wall:.4f} "
              f"launch to launch", flush=True)
    # bucketing the ids would start with a sort of the (id, position)
    # pairs: one device radix sort of the 10.5 M flat ids with their
    # positions (torch.sort returns both)
    t = cs.time_ms(lambda: torch.sort(flat), [()])
    t32 = cs.time_ms(lambda: torch.sort(flat.int()), [()])
    print(f"sort of {flat.numel()} (id, position) pairs: int64 ids "
          f"{t.ms:.4f} ms, int32 ids {t32.ms:.4f} ms", flush=True)


def probe_dot_fwd(cs, libs, model, gen):
    """dot_interact_fwd at the DLRM shape, f32 and bf16: warps a CTA 1, 2,
    4, 8 at every count of CTAs an SM up to what shared memory allows,
    against bmm + index, two rounds in turns."""
    import torch
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LIBRARIES
    lib = LIBRARIES.get("dot_interact")
    b, f, d = 2048, model.n_sparse + 1, model.embed_dim
    p = f * (f - 1) // 2
    ii, jj = ref.tril_pairs(f, torch.device("cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        sets = [(torch.randn((b, f, d), device="cuda", generator=gen)
                 .to(dtype),) for _ in range(3)]
        out = torch.empty((b, p), device="cuda", dtype=dtype)
        elem = sets[0][0].element_size()
        plan = di.fwd_plan(b, f, d, elem)
        per_warp = di.fwd_warp_smem(f, d, elem)
        bnd, _ = cs.bound_ms(b * f * d * elem + b * p * elem, 2 * b * p * d)
        print(f"dot_interact_fwd {str(dtype)[6:]} ({b}, {f}, {d}): plan "
              f"{plan}, bound {bnd:.4f} ms", flush=True)

        def call_for(warps, ctas, lib=lib):
            def call(x):
                status = lib.dot_interact_fwd(
                    x.data_ptr(), out.data_ptr(), b, f, d,
                    int(dtype == torch.bfloat16), plan.copy, warps, ctas,
                    warps * per_warp, torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"dot_interact_fwd: CUDA error "
                                       f"{status}")
            return call
        grid = [(w, n) for w in (1, 2, 4, 8)
                for n in range(1, min(di.SM_SHARED_BYTES
                                      // (w * per_warp + 1024),
                                      di.SM_CTAS, 64 // w) + 1)]
        for rnd in range(2):
            t = cs.time_ms(
                lambda x: torch.bmm(x, x.transpose(1, 2))[:, ii, jj], sets)
            print(f"  bmm + index {t.ms:.4f} ms", flush=True)
            for w, n in grid[::1 if rnd == 0 else -1]:
                t = cs.time_ms(call_for(w, min(-(-b // w), di.SMS * n)),
                               sets, kernel="dot_interact_fwd_kernel")
                print(f"  {w} warps a CTA, {n} CTAs an SM ({w * n} warps): "
                      f"{t.ms:.4f} ms, {t.wall:.4f} launch to launch",
                      flush=True)
            for name in DOT_FWD_VARIANTS:
                t = cs.time_ms(call_for(plan.warps, plan.ctas,
                                        libs[f"dot_interact_{name}"]),
                               sets, kernel="dot_interact_fwd_kernel")
                print(f"  {name} at the plan: {t.ms:.4f} ms, {t.wall:.4f} "
                      f"launch to launch", flush=True)
        del sets


def _events_ms(fn, iters: int = 3) -> float:
    """Mean device ms of fn() over `iters` calls after one warm-up, by
    CUDA events around the run."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_segment(cs, gen):
    """models/segment.py's chunked reduce at ogb_products, forward and
    backward, against its chunk size and one pass over every pair."""
    from types import SimpleNamespace
    import torch
    from repro_torch.configs.graphsage_reddit import ARCH
    from repro_torch.models import segment
    shape = ARCH.shape("ogb_products")
    n, e = shape.n_nodes, shape.n_edges
    src = torch.randint(0, n, (e,), device="cuda", generator=gen,
                        dtype=torch.int32)
    dst = torch.randint(0, n, (e,), device="cuda", generator=gen,
                        dtype=torch.int32).sort().values
    plan = segment.segment_plan(src, dst, n, n)
    for d in (100, 128):
        table = torch.randn((n, d), device="cuda", generator=gen)
        d_out = torch.randn((n, d), device="cuda", generator=gen)
        bound, by = cs.bound_ms(2 * n * d * 4 + 2 * e * 4, e * d)
        floor = 2 * e * d * 4 / cs.PEAK_BYTES_PER_S * 1e3
        print(f"segment D={d}: bound {bound:.4f} ms ({by}); message "
              f"traffic floor {floor:.4f} ms", flush=True)
        for chunk in (1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24):
            ctx = SimpleNamespace(plan=plan, chunk=chunk, rows=n,
                                  needs_input_grad=(True,))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd = _events_ms(lambda: segment.segment_sum(table, plan,
                                                         chunk=chunk))
            bwd = _events_ms(lambda: segment._SegmentSum.backward(ctx,
                                                                  d_out))
            extra = (torch.cuda.max_memory_allocated() - base) / 1e9
            print(f"  chunk {chunk}: forward {fwd:.3f} ms, backward "
                  f"{bwd:.3f} ms, peak {extra:.2f} GB over the resident",
                  flush=True)
        msg = torch.empty((segment.CHUNK_PAIRS, d), device="cuda")
        g, s = src[:segment.CHUNK_PAIRS], dst[:segment.CHUNK_PAIRS]
        out = torch.zeros_like(table)
        sel = _events_ms(lambda: torch.index_select(table, 0, g, out=msg))
        add = _events_ms(lambda: out.index_add_(0, s, msg))
        print(f"  one chunk of {segment.CHUNK_PAIRS}: index_select "
              f"{sel:.3f} ms, index_add_ {add:.3f} ms", flush=True)
        del msg, out

        def once():
            return torch.zeros_like(table).index_add_(
                0, dst, table.index_select(0, src))
        print(f"  every pair at once: {_events_ms(once):.3f} ms",
              flush=True)
        del table, d_out
        torch.cuda.empty_cache()


def probe_sage(cs, gen):
    """sage_aggregate_fwd at the GNN step's three shapes with neigh and w
    f32 or bf16 (each combination), two rounds in turns."""
    import torch
    from repro_torch.configs.graphsage_reddit import ARCH
    from repro_torch.kernels import sage_aggregate as sa
    shape, cfg = ARCH.shape("minibatch_lg"), ARCH.model
    path = cs._gnn_path_shapes(shape, cfg)
    combos = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
    print(f"sage: repro_torch from {os.path.dirname(sa.__file__)}")
    for tag, b, f, d, h, _ in path:
        n_sets = max(1, min(8, -(-64 * 2 ** 20 // (4 * b * f * d))))
        base = [(torch.randn((b, f, d), device="cuda", generator=gen),
                 torch.randn((d, h), device="cuda", generator=gen)
                 * d ** -0.5) for _ in range(n_sets)]
        for rnd in range(2):
            for nd, wd in combos[::1 if rnd == 0 else -1]:
                sets = [(n.to(nd), w.to(wd)) for n, w in base]
                try:
                    t = cs.time_ms(
                        lambda n, w: sa.sage_aggregate_fwd(n, w, True), sets,
                        kernel="sage_fwd_kernel")
                except TypeError as e:      # a version without bf16
                    print(f"sage_aggregate_fwd {tag} neigh {str(nd)[6:]} w "
                          f"{str(wd)[6:]}: refused ({e})", flush=True)
                    continue
                print(f"sage_aggregate_fwd {tag} neigh {str(nd)[6:]} w "
                      f"{str(wd)[6:]}: {t.ms:.4f} ms, {t.wall:.4f} launch to "
                      f"launch", flush=True)
                del sets
        del base


def probe_embedding(cs, libs, wd, dlrm, model, cfg, gen):
    """embedding_bag_fwd at wide-deep's deep arm, ids (65536, 40, 4) into
    (40, 2^20, 32), and at the DLRM's (2048, 26, 4) into (26, 2^20, 128),
    f32 and bf16 tables, two rounds in turns (the second in reverse
    order): the kernel and embedding_bag_fused_fwd through their
    wrappers, F.embedding_bag and the bound; and, for this checkout's
    kernel, the variants of EMB_FWD_VARIANTS, 2 rows a lane group, and
    its gathers alone over the flat row indices in memory order, feature
    by feature and sorted. Each variant is first checked bit-equal to the
    kernel. The SASS of the built forward kernels: loads, local memory,
    branches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.build import LIBRARIES
    print(f"embedding: repro_torch from {os.path.dirname(eb.__file__)}")
    LIBRARIES.get("embedding_bag")      # built before its SASS is read
    # the global loads, local memory and branches of each forward kernel
    for name, ops in sass_ops(str(build.library_path("embedding_bag")),
                              ("LDG.", "LDL", "STL", "BRA"),
                              "embedding_bag_fwd_kernel").items():
        print(f"sass {name}: {ops}")
    own = "emb_probe" in libs

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for tag, ids, rows, d in (("deep arm", wd, cfg.vocab_sizes[0],
                               cfg.embed_dim),
                              ("DLRM", dlrm, model.vocab_sizes[0],
                               model.embed_dim)):
        b, n_f, bag = ids.shape
        # the deep arm cycles two id sets (84 MB), as chip_smoke.py does
        sets = [(ids,)]
        if tag == "deep arm":
            sets.append((torch.as_tensor(cs._criteo_batch(
                cfg, 65536, 3)["sparse_ids"]).to(ids.device),))
        offs = (torch.arange(n_f, device=ids.device) * rows).view(1, n_f, 1)
        flat_sets = [((i.long() + offs).reshape(b * n_f, bag),)
                     for (i,) in sets]
        uniq = int(torch.unique(flat_sets[0][0]).numel())
        tables = torch.empty((n_f, rows, d), device="cuda")
        tables.normal_(generator=gen)
        out = torch.empty((b, n_f, d), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            table = tables.to(dtype)
            elem = table.element_size()
            bf16 = int(dtype == torch.bfloat16)
            dt = f"{tag} {str(dtype)[6:]}"
            bnd, _ = cs.bound_ms(ids.numel() * 4 + uniq * d * elem
                                 + b * n_f * d * 4, 0)
            lib_t = cs.time_ms(lambda x: F.embedding_bag(
                x, table.view(n_f * rows, d), mode="sum"), flat_sets)
            print(f"embedding {dt}: bound {bnd:.4f} ms; F.embedding_bag "
                  f"{lib_t.ms:.4f} ms", flush=True)
            calls = [("kernel", lambda i: eb.embedding_bag_fwd(table, i),
                      sets, "embedding_bag_fwd_kernel"),
                     ("fused kernel",
                      lambda i: eb.embedding_bag_fused_fwd(table, i), sets,
                      "embedding_bag_fused_fwd_kernel")]
            if own:
                want = eb.embedding_bag_fwd(table, ids)
                plan = eb.fwd_plan(b, n_f, d, elem)
                print(f"  plan {plan}", flush=True)

                def fwd(vlib, threads):
                    blocks = -(-b * n_f * plan.lanes // threads)

                    def call(i):
                        status = vlib.embedding_bag_fwd(
                            table.data_ptr(), i.data_ptr(), out.data_ptr(),
                            b, n_f, rows, d, bag, 0, bf16, plan.vec,
                            plan.lanes_log2, blocks, *plan.per_row,
                            *plan.per_feat, 0, 0, stream())
                        if status != 0:
                            raise RuntimeError(f"embedding_bag_fwd: CUDA "
                                               f"error {status}")
                    return call

                def rows2(i):
                    status = libs["emb_probe"].rows2(
                        table.data_ptr(), i.data_ptr(), out.data_ptr(), b,
                        n_f, rows, d, bf16, plan.lanes_log2, stream())
                    if status != 0:
                        raise RuntimeError(f"rows2: CUDA error {status}")

                variants = [(n, fwd(libs[f"embedding_bag_{n}"],
                                    EMB_FWD_THREADS.get(n, eb.FWD_THREADS)),
                             "embedding_bag_fwd_kernel")
                            for n in EMB_FWD_VARIANTS]
                variants.append(("2 rows a lane group", rows2,
                                 "rows2_kernel"))
                for name, call, kern in variants:
                    call(ids)
                    if not torch.equal(out, want):
                        raise AssertionError(f"{name}: not bit-equal to "
                                             f"embedding_bag_fwd")
                    calls.append((name, call, sets, kern))
                # the gathers alone over the flat row indices (f V + id)
                for order, arrange in (
                        ("memory order", lambda x: x),
                        ("feature by feature",
                         lambda x: x.view(b, n_f, bag).transpose(0, 1)),
                        ("sorted",
                         lambda x: torch.sort(x.reshape(-1)).values)):
                    gsets = [(arrange(x).reshape(-1, bag).int().contiguous(),)
                             for (x,) in flat_sets]

                    def gather(x):
                        status = libs["emb_probe"].gather_rows(
                            table.data_ptr(), x.data_ptr(), out.data_ptr(),
                            b * n_f, d, bf16, plan.lanes_log2, stream())
                        if status != 0:
                            raise RuntimeError(f"gather_rows: CUDA error "
                                               f"{status}")
                    calls.append((f"gathers alone, {order}", gather, gsets,
                                  "gather_rows_kernel"))
            for rnd in range(2):
                for name, call, args, kern in calls[::1 if rnd == 0 else -1]:
                    t = cs.time_ms(call, args, kernel=kern)
                    print(f"  {dt} {name}: {t.ms:.4f} ms, {t.wall:.4f} "
                          f"launch to launch ({bnd / t.ms:.0%} of the "
                          f"bound)", flush=True)
            del table
        del tables, out
        torch.cuda.empty_cache()


def _lanes(words: int) -> int:
    """The lane walk's lanes for a row of `words` words."""
    lanes = 1
    while lanes < 32 and lanes < words:
        lanes *= 2
    return lanes


def _fwd_plan(b, f, d, vec, flat):
    """embedding_bag_fwd's plan for ids (b, f, bag) into f32 tables of
    width d, in words of `vec` floats on the flat or the lane walk."""
    from repro_torch.kernels import embedding_bag as eb
    words = d // vec
    if flat:
        blocks = -(-b * f * words // eb.FWD_THREADS)
        threads = blocks * eb.FWD_THREADS
        return eb.FwdPlan(vec, 0, blocks, eb.divisor(words, threads),
                          eb.divisor(f, threads))
    lanes = _lanes(words)
    return eb.FwdPlan(vec, lanes, -(-b * f * lanes // eb.FWD_THREADS))


def _bwd_plan(b, f, v, d, vec, flat):
    """embedding_bag_bwd's plan (its feature groups) for d_out (b, f, d)
    into an f32 gradient, in words of `vec` floats on the flat or the
    lane walk."""
    from repro_torch.kernels import embedding_bag as eb
    plan = eb.bwd_plan(b, f, v, d)
    words = d // vec
    rows = b * min(plan.group, f)
    if flat:
        blocks = -(-rows * words // eb.BWD_THREADS)
        return eb.BwdPlan(vec, 0, plan.group, plan.groups, blocks,
                          eb.divisor(words, blocks * eb.BWD_THREADS))
    lanes = _lanes(words)
    return eb.BwdPlan(vec, lanes, plan.group, plan.groups,
                      -(-rows * lanes // eb.BWD_THREADS))


def probe_narrow(cs, libs, gen):
    """The narrow-row lookups: see the module's docstring (`narrow`).
    Each override and probe is first checked bitwise (the forward) or
    against the kernel within rtol 1e-5 / atol 1e-6 (the scatter, d_out
    non-negative); then all are timed in turns, two rounds, the second
    in reverse order."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.dien import ARCH as DIEN_ARCH
    from repro_torch.configs.wide_deep import ARCH as WD_ARCH
    from repro_torch.configs.xdeepfm import ARCH as XD_ARCH
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LIBRARIES
    dev = torch.device("cuda")
    lib = LIBRARIES.get("embedding_bag")
    path = str(build.library_path("embedding_bag"))
    # the flat walk's instantiations (kFlat, mangled Lb1E)
    for name, ops in sass_ops(path, ("LDG.", "LDL", "STL", "REDG.",
                                     "ATOMG.", "ATOM."), "Lb1E").items():
        print(f"sass {name}: {ops}")
    own = "flat_words" in libs
    # the walk and word overrides: the lane walk from the `lanes` variant
    # (this checkout's only)
    lanes = libs.get("embedding_bag_lanes")
    walks = ((("lane walk, 4-byte words (before)", 1, False),
              ("lane walk, 8-byte words", 2, False)) if own else ()) + \
        (("flat walk, 4-byte words", 1, True),)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(status, what):
        if status != 0:
            raise RuntimeError(f"{what}: CUDA error {status}")

    def fwd(table, out, plan, lib=lib):
        f, v, d = table.shape

        def call(i):
            b, _, bag = i.shape
            check(lib.embedding_bag_fwd(
                table.data_ptr(), i.data_ptr(), out.data_ptr(), b, f, v, d,
                bag, 0, 0, plan.vec, plan.lanes_log2, plan.blocks,
                *plan.per_row, *plan.per_feat, 0, 0, stream()),
                "embedding_bag_fwd")
        return call

    def flat_words(table, out, vec, k):
        f, v, d = table.shape

        def call(i):
            b = i.shape[0]
            blocks = -(-b * f * (d // vec) // (eb.FWD_THREADS * k))
            threads = blocks * eb.FWD_THREADS * k
            check(libs["flat_words"].flat_words(
                table.data_ptr(), i.data_ptr(), out.data_ptr(), b, f, v, d,
                vec, k, blocks, *eb.divisor(d // vec, threads),
                *eb.divisor(f, threads), stream()), "flat_words")
        return call

    def bwd(d_out, ids, grad, plan, lib=lib):
        b, f, bag = ids.shape
        _, v, d = grad.shape

        def call():
            check(lib.embedding_bag_bwd(
                d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), b, f, v,
                d, bag, 0, 0, plan.vec, plan.lanes_log2, plan.group,
                plan.blocks, plan.groups, *plan.per_row, 0, 0, stream()),
                "embedding_bag_bwd")
        return call

    def bwd_words(d_out, ids, grad, mode, k):
        b, f, _ = ids.shape
        _, v, d = grad.shape
        words = d // 4 + 1 if mode == 2 else d // 2
        blocks = -(-b * words // (eb.BWD_THREADS * k))

        def call():
            check(libs["bwd_words"].bwd_words(
                d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), b, f, v,
                d, mode, k, blocks,
                *eb.divisor(words, blocks * eb.BWD_THREADS * k), stream()),
                "bwd_words")
        return call

    def rounds(calls, bnd):
        for rnd in range(2):
            for name, call, args, kern in calls[::1 if rnd == 0 else -1]:
                t = cs.time_ms(call, args, kernel=kern)
                print(f"  {name}: {t.ms:.4f} ms, {t.wall:.4f} launch to "
                      f"launch ({bnd / t.ms:.0%} of the bound)", flush=True)

    lookups = []
    for arch, tag in ((XD_ARCH, "xdeepfm_tables"), (DIEN_ARCH, "dien_hist")):
        n = arch.shape("train_batch").batch // cs.SEQ_MICROBATCHES[
            arch.arch_id]
        sets = [cs._seq_lookups(arch.model, n, seed) for seed in (1, 2)]
        lookups.append((tag, sets[0][tag][0], [(x[tag][1],) for x in sets]))
    for tag, shape, id_sets in lookups:
        f, v, d = shape
        ids = id_sets[0][0]
        b = ids.shape[0]
        table = torch.empty(shape, device=dev).normal_(generator=gen)
        flat_table = table.view(f * v, d)
        offs = (torch.arange(f, device=dev) * v).view(1, f, 1)
        flat = [((i.long() + offs).reshape(b * f),) for (i,) in id_sets]
        feat = torch.arange(f, device=dev).view(1, f)
        uniq = int(torch.unique(flat[0][0]).numel())
        bnd, _ = cs.bound_ms(ids.numel() * 4 + uniq * d * 4 + b * f * d * 4,
                             0)
        out = torch.empty((b, f, d), device=dev)
        want = eb.embedding_bag_fwd(table, ids)
        print(f"narrow forward {tag}: ids {tuple(ids.shape)} into {shape}, "
              f"{uniq} distinct rows; bound {bnd:.4f} ms; plan "
              f"{eb.fwd_plan(b, f, d)}", flush=True)
        calls = [("kernel", lambda i: eb.embedding_bag_fwd(table, i),
                  id_sets, "embedding_bag_fwd_kernel")]
        for name, vec, flat_walk in walks:
            plan = _fwd_plan(b, f, d, vec, flat_walk)
            calls.append((f"{name} {plan}", fwd(
                table, out, plan, lib if flat_walk else lanes), id_sets,
                "embedding_bag_fwd_kernel"))
        if own:
            for k in (1, 2, 4):
                calls.append((f"flat walk, 8-byte words, {k} a thread",
                              flat_words(table, out, 2, k), id_sets,
                              "flat_words_kernel"))
            for n in ("stcs", "ldcs", "stream"):
                calls.append((f"variant {n}", fwd(
                    table, out, eb.fwd_plan(b, f, d),
                    libs[f"embedding_bag_{n}"]), id_sets,
                    "embedding_bag_fwd_kernel"))
        for name, call, _, _ in calls[1:]:
            out.fill_(0)
            call(ids)
            if not torch.equal(out, want):
                raise AssertionError(f"{tag} {name}: not bitwise the "
                                     f"kernel")
        calls += [("F.embedding", lambda x: F.embedding(x, flat_table), flat,
                   None),
                  ("F.embedding_bag", lambda x: F.embedding_bag(
                      x.view(-1, 1), flat_table, mode="sum"), flat, None),
                  ("plain indexing gather",
                   lambda i: table[feat, i[..., 0].long()], id_sets, None)]
        rounds(calls, bnd)
        # the scatter, non-negative d_out
        del out, want, flat_table
        d_out = torch.rand((b, f, d), device=dev, generator=gen)
        grad = torch.zeros_like(table)
        del table
        torch.cuda.empty_cache()
        want = ref.embedding_bag_bwd_ref(d_out, ids, v)
        bnd, _ = cs.bound_ms(d_out.numel() * 4 + ids.numel() * 4
                             + 2 * uniq * d * 4, 0)
        print(f"narrow scatter {tag}: bound {bnd:.4f} ms; plan "
              f"{eb.bwd_plan(b, f, v, d)}", flush=True)
        calls = [("kernel", lambda: eb.embedding_bag_scatter(d_out, ids,
                                                             grad), [()],
                  "embedding_bag_bwd_kernel")]
        for name, vec, flat_walk in walks:
            plan = _bwd_plan(b, f, v, d, vec, flat_walk)
            calls.append((f"{name} {plan}", bwd(
                d_out, ids, grad, plan, lib if flat_walk else lanes), [()],
                "embedding_bag_bwd_kernel"))
        if own:
            for n in ("ldcs", "stream"):
                calls.append((f"variant {n}", bwd(
                    d_out, ids, grad, eb.bwd_plan(b, f, v, d),
                    libs[f"embedding_bag_{n}"]), [()],
                    "embedding_bag_bwd_kernel"))
            for mode, k, name in ((0, 1, "float2 words, 1 a thread"),
                                  (0, 2, "float2 words, 2 a thread"),
                                  (2, 1, "float4 words where aligned"),
                                  (2, 2, "float4 words where aligned, 2 a "
                                         "thread")):
                calls.append((f"probe {name}",
                              bwd_words(d_out, ids, grad, mode, k), [()],
                              "bwd_words_kernel"))
        for name, call, _, _ in calls:
            grad.zero_()
            call()
            for i in range(f):
                cs._allclose(f"{tag} {name} f={i}", grad[i], want[i], 1e-5,
                             1e-6)
        if own:
            calls.append(("probe the REDs alone (of 1.0, no d_out read)",
                          bwd_words(d_out, ids, grad, 1, 1), [()],
                          "bwd_words_kernel"))
        del want
        idx = flat[0][0]
        src = d_out.view(b * f, d)
        calls.append(("index_add_", lambda: grad.view(f * v, d).index_add_(
            0, idx, src), [()], None))
        rounds(calls, bnd)
        del grad, d_out
        torch.cuda.empty_cache()

    # D = 1: the flat walk (the kernels' plans) and the lane walk
    if not own:
        return
    cfg = XD_ARCH.model
    linear = cs._seq_lookups(cfg, XD_ARCH.shape("train_batch").batch
                             // cs.SEQ_MICROBATCHES["xdeepfm"], 1)
    wide = torch.as_tensor(cs._criteo_batch(WD_ARCH.model, 65536, 1)[
        "sparse_ids"]).to(dev)
    for tag, ids, v in (("xdeepfm_linear", linear["xdeepfm_linear"][1],
                         linear["xdeepfm_linear"][0][1]),
                        ("wide arm", wide, WD_ARCH.model.vocab_sizes[0])):
        b, f, bag = ids.shape
        d_out = torch.rand((b, f, 1), device=dev, generator=gen)
        grad = torch.zeros((f, v, 1), device=dev)
        flat = (ids.long() + (torch.arange(f, device=dev) * v)
                .view(1, f, 1)).reshape(-1)
        uniq = int(torch.unique(flat).numel())
        bnd, _ = cs.bound_ms(d_out.numel() * 4 + ids.numel() * 4
                             + 2 * uniq * 4, 0)
        table = torch.randn((f, v, 1), device=dev, generator=gen)
        out = torch.empty((b, f, 1), device=dev)
        plan = _fwd_plan(b, f, 1, 1, False)
        print(f"narrow forward {tag} D = 1: ids {tuple(ids.shape)}; plan "
              f"{eb.fwd_plan(b, f, 1)}", flush=True)
        fwd(table, out, plan, lanes)(ids)
        if not torch.equal(out, eb.embedding_bag_fwd(table, ids)):
            raise AssertionError(f"{tag} D = 1 lane walk: not bitwise the "
                                 f"kernel")
        rounds([("kernel", lambda i: eb.embedding_bag_fwd(table, i), [(ids,)],
                 "embedding_bag_fwd_kernel"),
                (f"lane walk {plan}", fwd(table, out, plan, lanes), [(ids,)],
                 "embedding_bag_fwd_kernel")],
               cs.bound_ms(ids.numel() * 4 + uniq * 4 + b * f * 4, 0)[0])
        del table, out
        print(f"narrow scatter {tag} D = 1: ids {tuple(ids.shape)}; bound "
              f"{bnd:.4f} ms; plan {eb.bwd_plan(b, f, v, 1)}", flush=True)
        want = ref.embedding_bag_bwd_ref(d_out, ids, v)
        plan = _bwd_plan(b, f, v, 1, 1, False)
        calls = [("kernel", lambda: eb.embedding_bag_scatter(d_out, ids,
                                                             grad), [()],
                  "embedding_bag_bwd_kernel"),
                 (f"lane walk {plan}", bwd(d_out, ids, grad, plan, lanes),
                  [()], "embedding_bag_bwd_kernel")]
        for name, call, _, _ in calls:
            grad.zero_()
            call()
            for i in range(f):
                cs._allclose(f"{tag} {name} f={i}", grad[i], want[i], 1e-5,
                             1e-6)
        del want
        upd = d_out[:, :, None, :].expand(b, f, bag, 1).reshape(-1, 1) \
            .contiguous()
        calls.append(("index_add_", lambda: grad.view(f * v, 1).index_add_(
            0, flat, upd), [()], None))
        rounds(calls, bnd)
        del grad, d_out, upd
        torch.cuda.empty_cache()


def probe_scatter_bf16(cs, libs, gen):
    """The bf16 scatter at dlrm-criteo's training shape: the kernel and
    its `atomic` variant in turns (two rounds, the second in reverse
    order), and the reductions of each one's bf16 instantiations."""
    import torch
    from repro_torch.configs.dlrm_criteo import ARCH as DLRM_ARCH
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels.build import LIBRARIES
    dev = torch.device("cuda")
    cfg = DLRM_ARCH.model
    ids = torch.as_tensor(cs._criteo_batch(cfg, 65536, 9)["sparse_ids"]) \
        .to(dev)
    b, n_f, bag = ids.shape
    rows, d = cfg.vocab_sizes[0], cfg.embed_dim
    d_out = torch.randn((b, n_f, d), device=dev, generator=gen) \
        .to(torch.bfloat16).float()
    grad = torch.zeros((n_f, rows, d), dtype=torch.bfloat16, device=dev)
    plan = eb.bwd_plan(b, n_f, rows, d, 0, 2)
    print(f"scatter bf16 ({b}, {n_f}, {bag}) into ({n_f}, {rows}, {d}): "
          f"plan {plan}")

    def call(lib):
        def run():
            status = lib.embedding_bag_bwd(
                d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), b, n_f,
                rows, d, bag, 0, 1, plan.vec, plan.lanes_log2,
                plan.group, plan.blocks, plan.groups, *plan.per_row, 0, 0,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"embedding_bag_bwd: CUDA error {status}")
        return run
    variants = (("kernel", LIBRARIES.get("embedding_bag"),
                 str(build.library_path("embedding_bag"))),
                ("atomic", libs["embedding_bag_atomic"],
                 os.path.join(OUT, "embedding_bag_atomic.so")))
    for name, _, path in variants:
        for kernel, ops in sass_ops(path, ("REDG.", "ATOMG.", "ATOM."),
                                    "bwd_kernelI13__nv_bfloat16").items():
            print(f"  sass {name} {kernel[-40:]}: {ops}")
    for rnd in range(2):
        for name, lib, _ in variants[::1 if rnd == 0 else -1]:
            t = cs.time_ms(call(lib), [()], kernel="embedding_bag_bwd_kernel")
            print(f"  {name}: {t.ms:.4f} ms, {t.wall:.4f} launch to launch",
                  flush=True)
    del grad
    torch.cuda.empty_cache()


PROFILER_WINDOWS = 40


def _busy(stop):
    """A host process that spins until `stop` is set (the profiler
    section's load)."""
    x = 0
    while not stop.is_set():
        for i in range(100_000):
            x += i * i


def probe_profiler(cs, gen):
    import multiprocessing as mp
    import statistics

    import torch
    from repro_torch.configs.xdeepfm import ARCH as XD_ARCH
    from repro_torch.kernels import embedding_bag as eb

    dev = torch.device("cuda")
    cfg = XD_ARCH.model
    n = XD_ARCH.shape("train_batch").batch // 2
    sets = [cs._seq_lookups(cfg, n, seed)["xdeepfm_tables"]
            for seed in (1, 2)]
    shape = sets[0][0]
    table = torch.empty(shape, device=dev).normal_(generator=gen)
    args = [(ids,) for _, ids, _ in sets]
    fn = lambda i: eb.embedding_bag_fwd(table, i)
    name = "embedding_bag_fwd_kernel"
    single = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for k in range(10):
        torch.cuda.synchronize()
        torch.cuda._sleep(2 * cs.REF_CYCLES)
        start.record()
        fn(*args[k % 2])
        end.record()
        torch.cuda.synchronize()
        single.append(start.elapsed_time(end))
    print(f"profiler: xDeepFM embedding_bag_fwd {tuple(sets[0][1].shape)} "
          f"into {shape}; one call behind a spin, CUDA events: "
          f"{min(single):.4f}-{max(single):.4f} ms; reference spin "
          f"{cs.spin_ms():.4f} ms", flush=True)
    ctx = mp.get_context("spawn")
    pad = cs.PAD_S
    for load in (0, 12):
        stop = ctx.Event()
        procs = [ctx.Process(target=_busy, args=(stop,)) for _ in range(load)]
        for p in procs:
            p.start()
        try:
            for cs.PAD_S in (0.0, pad, 0.0, pad):
                rows = []
                for _ in range(PROFILER_WINDOWS):
                    prof, _, dev_us, clock = cs._profiled(fn, args, 20, 0)
                    kern = [e.time_range.end - e.time_range.start
                            for e in prof.events() if name in e.name
                            and e.device_type.name == "CUDA"]
                    short = sum(e.time_range.end - e.time_range.start
                                for e in prof.events()
                                if cs.SENTINEL in e.name
                                and e.device_type.name == "CUDA"
                                and e.time_range.end - e.time_range.start
                                < 100)
                    rows.append((dev_us / 20e3, len(kern),
                                 min(kern, default=0.0),
                                 max(kern, default=0.0), short,
                                 None if clock is None else clock[0]))
                clocks = sorted(r[5] for r in rows if r[5] is not None)
                off = [r for r in rows if not cs.clock_ok(
                    None if r[5] is None else (r[5], r[5]))]
                print(f"  {load} busy host processes, wait {cs.PAD_S} s: "
                      f"{len(rows)} windows; ms a call "
                      f"{min(r[0] for r in rows):.4f}-"
                      f"{max(r[0] for r in rows):.4f}; launches recorded "
                      f"{sorted({r[1] for r in rows})}; window clock "
                      f"{clocks[0]:.4f} / {statistics.median(clocks):.4f} / "
                      f"{clocks[-1]:.4f} (least / median / largest); "
                      f"{len(off)} off by more than {cs.CLOCK_TOL}",
                      flush=True)
                for r in off:
                    print(f"    off: {r[0]:.4f} ms a call, launches "
                          f"{r[2]:.1f}-{r[3]:.1f} us, short sentinels "
                          f"{r[4]:.2f} us, clock {r[5]}", flush=True)
        finally:
            cs.PAD_S = pad
            stop.set()
            for p in procs:
                p.join(10)


def probe_take(cs, libs):
    """Section `take` (see the module docstring)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LIBRARIES
    dev = torch.device("cuda")
    for name in libs:
        if name.startswith("embedding_take_"):
            for kernel, rep in cs.ptxas_report(VARIANT_LOGS[name]).items():
                if "sum_kernel" in kernel:
                    print(f"  {name[15:]} {kernel}: registers, stack, "
                          f"spill stores, spill loads {rep}", flush=True)
    own = LIBRARIES.get("embedding_take")
    plan_fn = eb.take_fwd_plan
    for arch_id, b, seq in cs.LM_EMBED_SHAPES:
        cfg = get_arch(arch_id).model
        v, d = cfg.vocab_size, cfg.d_model
        ids = torch.from_numpy(TokenStream(v, seq).batch(b)["tokens"]) \
            .to(dev).reshape(-1).to(torch.int32)
        n = ids.numel()
        table = torch.randn((v, d), device=dev).to(torch.bfloat16)
        flat = ids.long()
        words = n * d * 2 // 16
        one = plan_fn(n, d * 2).blocks
        for cap in ("F.embedding", one, 528, 1056, 2112, one,
                    "F.embedding"):
            if isinstance(cap, str):
                t = cs.time_ms(lambda: F.embedding(flat, table), [()])
            else:
                blocks = min(cap, one)
                plan = eb.TakeFwdPlan(16, blocks, eb.divisor(
                    d * 2 // 16, eb.take_fwd_span(words, blocks)))
                eb.take_fwd_plan = lambda *a, p=plan: p
                try:
                    if not torch.equal(
                            eb.embedding_take_fwd_local(table, ids, 0),
                            ref.embedding_take_local_ref(table, ids, 0)):
                        raise AssertionError(f"take fwd at {blocks} blocks")
                    t = cs.time_ms(lambda: eb.embedding_take_fwd_local(
                        table, ids, 0), [()],
                        kernel="embedding_take_fwd_kernel")
                finally:
                    eb.take_fwd_plan = plan_fn
                cap = f"{blocks} blocks"
            print(f"  take fwd {arch_id} ({n},) into ({v}, {d}) bf16, "
                  f"{cap}: {t.ms:.5f} ms ({t.events} events), "
                  f"{t.wall:.5f} launch to launch", flush=True)
        d_out = torch.rand((n, d), device=dev).to(torch.bfloat16)
        grad = torch.zeros_like(table)
        want = eb.embedding_take_bwd_local(d_out, ids, 0, v)
        fn = lambda: eb.embedding_take_scatter(d_out, ids, grad, 0)
        fn()
        prof, _, dev_us, clock = cs._profiled(fn, [()], 20, 0)
        for e in sorted(prof.key_averages(),
                        key=lambda e: -e.self_device_time_total):
            if e.self_device_time_total > 0 and cs.SENTINEL not in e.key:
                print(f"  take bwd {arch_id} by kernel: "
                      f"{e.self_device_time_total / 20:.3f} us a call, "
                      f"{e.count // 20} a call, {e.key[:100]}", flush=True)
        print(f"  take bwd {arch_id}: {dev_us / 20e3:.5f} ms a call, "
              f"window clock {clock}", flush=True)
        level1 = "embedding_take_bwd_sum_kernel<__nv_bfloat16, 8, true>"
        for name in ["own"] + [k for k in libs
                               if k.startswith("embedding_take_")] + ["own"]:
            build.LIBRARIES._libs["embedding_take"] = \
                own if name == "own" else libs[name]
            try:
                if not torch.equal(eb.embedding_take_bwd_local(
                        d_out, ids, 0, v), want):
                    raise AssertionError(f"take bwd variant {name}")
                t = cs.time_ms(fn, [()], kernel="embedding_take_bwd")
                l1, _ = cs.named_kernel_ms(fn, [()], level1)
            finally:
                build.LIBRARIES._libs["embedding_take"] = own
            print(f"  take bwd {arch_id} {name.replace('embedding_take_', '')}"
                  f": {t.ms:.5f} ms, level 1 {l1:.5f} ms", flush=True)
        t = cs.time_ms(lambda: grad.index_add_(0, flat, d_out), [()])
        print(f"  take bwd {arch_id}: index_add_ {t.ms:.5f} ms", flush=True)
        del table, d_out, grad, want
        torch.cuda.empty_cache()


def probe_dneigh(cs, libs, gen):
    """Section `dneigh` (see the module docstring)."""
    import torch
    from repro_torch.configs.graphsage_reddit import ARCH
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    from repro_torch.kernels import sage_aggregate as sa
    _, b, f, d, h, _ = cs._gnn_path_shapes(ARCH.shape("minibatch_lg"),
                                           ARCH.model)[2]
    print(f"dneigh: repro_torch from {os.path.dirname(sa.__file__)}; "
          f"h1 ({b}, {f}, {d}) from ({b}, {h}) x ({d}, {h})^T")
    for name in libs:
        if name.startswith("sage_aggregate_"):
            for kernel, rep in cs.ptxas_report(VARIANT_LOGS[name]).items():
                if "dneigh" in kernel:
                    print(f"  {name[15:]} {kernel}: registers, stack, spill "
                          f"stores, spill loads {rep}", flush=True)
    # eight input sets, as chip_smoke's h1 backward cycles through, with
    # an aggregate, so that d_w runs before d_neigh as on the path (and
    # an earlier checkout, whose d_neigh alone failed at h1, runs too)
    sets = [(torch.randn((b, h), device="cuda", generator=gen),
             torch.randn((d, h), device="cuda", generator=gen) * d ** -0.5,
             torch.randn((b, d), device="cuda", generator=gen))
            for _ in range(8)]
    bnd, by = cs.bound_ms(4 * (b * h + d * h + b * f * d), 2 * b * d * h)
    plain = cs.time_ms(lambda g, w, a: ref.sage_aggregate_bwd_ref(
        g, w, None, f, need_neigh=True), sets)
    lib = cs.time_ms(lambda g, w, a: (g @ w.t() / f)[:, None, :]
                     .expand(b, f, d).contiguous(), sets)
    fill = cs.time_ms(lambda g, w, a: torch.empty(
        (b, f, d), device="cuda").fill_(1.0), sets)
    print(f"  bound {bnd:.5f} ms by {by}; plain {plain.ms:.5f}; library "
          f"{lib.ms:.5f}; fill_ of a ({b}, {f}, {d}) f32 tensor "
          f"{fill.ms:.5f}", flush=True)

    def call(g, w, a):
        return sa.sage_aggregate_bwd(g, w, a, f, True)

    def alone(g, w, a):
        return sa.sage_aggregate_bwd(g, w, None, f, True)

    def kernel_ms(fn=call):
        return cs.named_kernel_ms(fn, sets, "sage_dneigh_kernel")
    if not hasattr(sa, "dneigh_plan"):       # a version before the plan
        ms, n = kernel_ms()
        print(f"  sage_dneigh_kernel: {ms:.5f} ms ({n} events)", flush=True)
        return
    own = build.LIBRARIES.get("sage_aggregate")
    plan_fn = sa.dneigh_plan
    chosen = plan_fn(b, f, d, h)
    want = call(*sets[0])[0]
    variants = [("default", own)] + [(k, libs[f"sage_aggregate_{k}"])
                                     for k in DNEIGH_VARIANTS]
    for rnd in range(2):
        for plan in (chosen, sa.DneighPlan(1))[::1 if rnd == 0 else -1]:
            label = "plan" if plan == chosen else "other"
            for var, lib_v in variants:
                # at the other tile, the store paths and tiles only
                if label == "other" and var not in DNEIGH_OTHER:
                    continue
                build.LIBRARIES._libs["sage_aggregate"] = lib_v
                sa.dneigh_plan = lambda *a, p=plan: p
                try:
                    if var in DNEIGH_SAME and not torch.equal(
                            call(*sets[0])[0], want):
                        raise AssertionError(f"dneigh {label} {var}: not "
                                             f"the plan's bits")
                    ms, n = kernel_ms()
                    # and with no d_w before it: a run of d_neigh alone
                    ms1, _ = (kernel_ms(alone) if label == "plan"
                              else (float("nan"), 0))
                finally:
                    build.LIBRARIES._libs["sage_aggregate"] = own
                    sa.dneigh_plan = plan_fn
                cols = {"cols64": 64, "cols128": 128}.get(var, 32)
                rr = 4 if var == "rr4" else plan.rr
                rows = rr * 128 // cols
                ctas = -(-b // rows) * -(-d // cols)
                store = var if var in ("tma", "float4") else "registers"
                print(f"  round {rnd} {label} ({rows} x {cols}, {ctas} "
                      f"CTAs) {store} {var}: {ms:.5f} ms ({n} events), "
                      f"{bnd / ms:.0%} of the bound; alone {ms1:.5f}",
                      flush=True)
    del sets


def main(sections) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_probes: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import chip_smoke as cs
    sys.path.insert(0, SRC)        # ahead of the src chip_smoke put first
    from repro_torch.configs.dlrm_criteo import MODEL
    from repro_torch.configs.wide_deep import ARCH
    from repro_torch.data.featurize import (RecordSpec, featurize_block,
                                            raw_block)
    from repro_torch.kernels import dot_interact as di
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LIBRARIES

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build(strict=SRC == os.path.join(ROOT, "src"))
    libs = build_variants(sections)
    from repro_torch.kernels import build
    if "scatter" in sections:
        # the reductions each backward kernel issues: REDG,
        # fire-and-forget, or ATOMG / ATOM (generic)
        for name, ops in sass_ops(str(build.library_path("embedding_bag")),
                                  ("REDG.", "ATOMG.", "ATOM."), "bwd").items():
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
        # threads a row: its lanes, or its words on the flat walk
        words = d // plan.vec
        blocks = -(-b * min(group, f) * (plan.lanes or words)
                   // eb.BWD_THREADS)
        div = eb.divisor(words, blocks * eb.BWD_THREADS) if plan.lanes == 0 \
            else eb.NO_DIV

        def call():
            status = lib.embedding_bag_bwd(
                d_out.data_ptr(), ids.data_ptr(), grad.data_ptr(), b, f, v,
                d, bag, 0, 0, plan.vec, plan.lanes_log2, group, blocks,
                groups, *div, 0, 0, stream())
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
    if "scatter" in sections:
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
            lib_ms = cs.time_ms(lambda: grad.view(n_f * rows, d).index_add_(
                0, flat, upd), [()]).ms
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
                        ms = cs.time_ms(scatter(lib, d_out, ids, grad,
                                                group), [()]).ms
                        print(f"  {name} group {group}: {ms:.4f} ms",
                              flush=True)
            if d in (1, 32):
                # the limits, over the same rows: in the kernel's walk order
                # (feature by feature), the distinct rows sorted and shuffled
                walk = (ids.long() + (torch.arange(n_f, device=dev) * rows)
                        .view(1, n_f, 1)).permute(1, 0, 2).reshape(-1) \
                    .contiguous()
                distinct = torch.unique(walk)
                shuffled = distinct[torch.randperm(
                    distinct.numel(), device=dev, generator=gen)]
                out = torch.empty((walk.numel() * 32 if d == 32 else 1,),
                                  device=dev)
                kinds = (((0, "float4 reductions"), (1, "load-add-store"),
                          (2, "gather")) if d == 32 else
                         ((3, "float reductions"),))
                for order, r in (("walk order", walk), ("distinct sorted",
                                                         distinct),
                                 ("distinct shuffled", shuffled)):
                    for which, kind in kinds:
                        ms = cs.time_ms(lambda: libs["micro"].micro(
                            which, grad.data_ptr(), r.data_ptr(),
                            out.data_ptr(), r.numel(), stream()), [()]).ms
                        print(f"  limit D = {d} {kind}, {order} ({r.numel()} "
                              f"rows): {ms:.4f} ms", flush=True)
                del out, walk, distinct, shuffled
            del d_out, grad
            torch.cuda.empty_cache()

    if "dot_bwd" in sections:
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
                    g.data_ptr(), x.data_ptr(), out.data_ptr(), b, f, d, 0,
                    plan.copy, 1, plan.warps, ctas, plan.smem, stream())
                if status != 0:
                    raise RuntimeError(f"dot_interact_bwd: CUDA error "
                                       f"{status}")
            return call
        variants = [("kernel", LIBRARIES.get("dot_interact"))] + [
            (n, libs[f"dot_interact_{n}"]) for n in DOT_VARIANTS]
        print(f"dot_interact_bwd ({b}, {f}, {d}): plan {plan}")
        for rnd in range(2):
            bmm_ms = cs.time_ms(torch.bmm, sym).ms
            print(f"  bmm {bmm_ms:.4f} ms")
            for name, lib in variants[::1 if rnd == 0 else -1]:
                for per_sm in (range(1, 7) if name == "kernel" else (4, 5)):
                    ms = cs.time_ms(dot(lib, di.SMS * per_sm), sets).ms
                    print(f"  {name} {per_sm} CTAs an SM: {ms:.4f} ms",
                          flush=True)
    if "fused" in sections:
        probe_fused(cs, libs, wd, cfg, gen)
    if "scatter_bf16" in sections:
        probe_scatter_bf16(cs, libs, gen)
    if "dot_fwd" in sections:
        probe_dot_fwd(cs, libs, MODEL, gen)
    if "sage" in sections:
        probe_sage(cs, gen)
    if "embedding" in sections:
        probe_embedding(cs, libs, wd, dlrm, MODEL, cfg, gen)
    if "narrow" in sections:
        probe_narrow(cs, libs, gen)
    if "profiler" in sections:
        probe_profiler(cs, gen)
    if "segment" in sections:
        probe_segment(cs, gen)
    if "take" in sections:
        probe_take(cs, libs)
    if "dneigh" in sections:
        probe_dneigh(cs, libs, gen)
    print(f"card: {cs.card_line()}")
    return 0


SECTIONS = ("fused", "dot_fwd", "sage", "embedding", "scatter", "dot_bwd",
            "scatter_bf16", "narrow", "profiler", "segment", "take",
            "dneigh")

if __name__ == "__main__":
    names = sys.argv[3:] if sys.argv[1:2] == ["--src"] else sys.argv[1:]
    names = names or list(SECTIONS)
    unknown = set(names) - set(SECTIONS)
    if unknown:
        sys.exit(f"kernel_probes: no section {sorted(unknown)}; the sections "
                 f"are {list(SECTIONS)}")
    sys.exit(main(names))
