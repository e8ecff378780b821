// Stacked multi-feature embedding bag for Hopper (sm_90a): the forward
// gather-and-sum and its backward scatter-add.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (`embedding_bag`, pallas_call at :75), which reduces one (V, D) table
// over a (B, bag) id block with a sequential (B, bag) grid that DMAs one
// row per step and accumulates in f32, j ascending. The TPU kernel has no
// backward; the JAX trainer differentiates `jnp.take` instead, whose
// transpose is a dense (F, V, D) scatter-add. Both directions live here.
//
// Layout: tables (F, V, D) f32, ids (B, F, bag) int32, out (B, F, D) f32.
// F*V*D exceeds 2^31 at the DLRM-Criteo widths (26 x 2^20 x 128), so every
// offset into the tables is 64-bit.
//
// Bound on this card: bytes. Each output row reads `bag` table rows and
// writes one, a handful of adds per byte. The design keeps the row loads
// wide and independent: one warp per (b, f) output row, each lane holding
// one float4 column slice (D = 128 is exactly 32 lanes x 4 floats), and
// the bag loop unrolled so the `bag` row loads are in flight together.
// The sum runs j ascending from 0.0f, so the f32 result is bit-equal to
// the plain PyTorch version (a left fold over j).
//
// An id outside [0, V) reads nothing and poisons its output row with NaN
// (the fill semantics of jnp.take); in the backward it adds nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ bool valid_id(int32_t id, int64_t V) {
  return id >= 0 && static_cast<int64_t>(id) < V;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fwd_kernel(const float* __restrict__ tables,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int64_t rows, int64_t F,
                         int64_t V, int64_t D, int bag, int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t f = row % F;
  const int32_t* row_ids = ids + row * bag;
  const float* table = tables + f * V * D;
  float* dst = out + row * D;
  const float nan = __int_as_float(0x7fc00000);
  if (kVec) {
    const int64_t d4 = D / 4;
    for (int64_t c = lane; c < d4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < bag; ++j) {
        const int32_t id = __ldg(row_ids + j);
        float4 r;
        if (valid_id(id, V)) {
          r = __ldg(reinterpret_cast<const float4*>(
                        table + static_cast<int64_t>(id) * D) + c);
        } else {
          r = make_float4(nan, nan, nan, nan);
        }
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
      }
      if (mean) {
        const float n = static_cast<float>(bag);
        acc.x /= n;
        acc.y /= n;
        acc.z /= n;
        acc.w /= n;
      }
      reinterpret_cast<float4*>(dst)[c] = acc;
    }
  } else {
    for (int64_t d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < bag; ++j) {
        const int32_t id = __ldg(row_ids + j);
        acc += valid_id(id, V) ? __ldg(table + static_cast<int64_t>(id) * D + d)
                               : nan;
      }
      if (mean) acc /= static_cast<float>(bag);
      dst[d] = acc;
    }
  }
}

// dOut (B, F, D) scatter-added into the zeroed dense gradient (F, V, D):
// one warp per (b, f) row, the row's gradient loaded once, then f32
// atomic adds into each of the `bag` destination rows (a float4 atomic
// per lane on the vector path). Atomic order varies between runs, so the
// sum over duplicate ids is exact only to rounding.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
embedding_bag_bwd_kernel(const float* __restrict__ d_out,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ grad, int64_t rows, int64_t F,
                         int64_t V, int64_t D, int bag, int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t f = row % F;
  const int32_t* row_ids = ids + row * bag;
  float* table_grad = grad + f * V * D;
  const float* src = d_out + row * D;
  const float n = static_cast<float>(bag);
  if (kVec) {
    const int64_t d4 = D / 4;
    for (int64_t c = lane; c < d4; c += 32) {
      float4 g = __ldg(reinterpret_cast<const float4*>(src) + c);
      if (mean) {
        g.x /= n;
        g.y /= n;
        g.z /= n;
        g.w /= n;
      }
      for (int j = 0; j < bag; ++j) {
        const int32_t id = __ldg(row_ids + j);
        if (!valid_id(id, V)) continue;
        // one vector atomic per float4 (sm_90: each element atomic on
        // its own), a quarter of the atomic instructions of scalar adds
        atomicAdd(reinterpret_cast<float4*>(
                      table_grad + static_cast<int64_t>(id) * D) + c, g);
      }
    }
  } else {
    for (int64_t d = lane; d < D; d += 32) {
      float g = __ldg(src + d);
      if (mean) g /= n;
      for (int j = 0; j < bag; ++j) {
        const int32_t id = __ldg(row_ids + j);
        if (!valid_id(id, V)) continue;
        atomicAdd(table_grad + static_cast<int64_t>(id) * D + d, g);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int embedding_bag_fwd(const float* tables, const int32_t* ids,
                                 float* out, int64_t B, int64_t F, int64_t V,
                                 int64_t D, int32_t bag, int32_t mean,
                                 void* stream) {
  const int64_t rows = B * F;
  if (rows == 0 || D == 0) return 0;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(tables) && aligned16(out)) {
    embedding_bag_fwd_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(tables, ids, out, rows, F, V, D,
                                             bag, mean);
  } else {
    embedding_bag_fwd_kernel<false><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, s>>>(tables, ids, out,
                                                        rows, F, V, D, bag,
                                                        mean);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int embedding_bag_bwd(const float* d_out, const int32_t* ids,
                                 float* grad, int64_t B, int64_t F, int64_t V,
                                 int64_t D, int32_t bag, int32_t mean,
                                 void* stream) {
  const int64_t rows = B * F;
  if (rows == 0 || D == 0) return 0;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(d_out) && aligned16(grad)) {
    embedding_bag_bwd_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                     0, s>>>(d_out, ids, grad, rows, F, V, D,
                                             bag, mean);
  } else {
    embedding_bag_bwd_kernel<false><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, s>>>(d_out, ids, grad,
                                                        rows, F, V, D, bag,
                                                        mean);
  }
  return static_cast<int>(cudaGetLastError());
}
