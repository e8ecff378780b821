// GraphSAGE neighbour aggregation for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sage_aggregate.py
// (`sage_aggregate`, pallas_call at :32). On the TPU a (tile_b, F, D)
// block of neighbour features sits in VMEM, is averaged over F in f32 and
// fed straight to the MXU against the grid-invariant (D, H) weight, so the
// (tile_b, D) aggregate never reaches HBM; B must divide by tile_b. The
// TPU kernel has no backward.
//
// Forward: neigh (B, F, D) f32, w (D, H) f32 -> out (B, H) f32,
// out[b] = (sum_f neigh[b, f] / F) @ w. A GEMM (M = B, K = D, N = H) whose
// A operand is made on the fly, in two phases per block. A block owns R
// rows and 128 output columns: R = 32, or R = 8 where B is too small to
// give each of the 132 SMs a block of 32 (the GNN's seed-level calls have
// B = 1024).
//  (1) It streams its rows' (R, F, D) slab of neigh, which is contiguous,
//      in order: each thread sums 8 float2 vectors (float where D is odd)
//      over f ascending in f32, with the loads of four values of f issued
//      before their adds (32 vectors in flight a thread), divides by F
//      with an IEEE division, and writes the aggregate transposed into
//      shared memory (d_pad x (R + 4) floats, 87.6 KB at D = 602, R = 32:
//      two blocks an SM).
//  (2) It multiplies that aggregate by w, staged 32 rows at a time in
//      shared memory while the next 32 load into registers, each thread
//      accumulating a (R / 8) x 4 register tile with FMAs, k ascending.
// The aggregate is bit-equal to the plain version's (the same left fold
// and division); the product differs from cuBLAS only in summation order.
// The edge is masked (no tile divisibility). A row of D = 602 floats is
// 2408 bytes, 8- but not 16-byte aligned, so vectors are float2, not
// float4. A first version that summed F for a 32-wide slice of D across
// 64 rows at a time (640 scattered 128-byte pieces a step, one memory
// round trip per f) ran at 4x its bound at the main shape, and with 16
// blocks at B = 1024 at 45x (PERF.md).
//
// Training needs d_w = agg^T d_out, so the forward also writes the
// aggregate (B, D) to device memory when the wrapper asks for it (w needs
// a gradient). At the main path's shape, neigh2 viewed as (15360, 10, 602)
// against (602, 128), that is 37.0 MB more written by the forward, and the
// backward then reads those 37.0 MB instead of recomputing the aggregate
// from the 369.9 MB of neigh (74 MB against 370 MB).
//
// Backward, two parts, each only when its input needs a gradient:
//  - d_w (D, H) = agg^T d_out, a reduction over all B rows. Blocks own a
//    128 x 128 tile of d_w (an 8 x 8 register tile per thread, fed by
//    four float4 shared-memory loads per 64 FMAs; the next 16 rows load
//    into registers while these are multiplied) and one of `splits`
//    ranges of rows (chosen by the wrapper so that the blocks fill whole
//    waves, with at least 64 rows each); each writes its partial tile to
//    a scratch buffer (splits, D, H), and a second pass sums the partials
//    in split order. No atomics: the result is deterministic. Each
//    partial sums its rows in ascending order, so an element of d_w
//    carries the rounding of partial sums as large as the largest
//    elements; chip_smoke.py holds it to 1e-5 of max|d_w|.
//  - d_neigh (B, F, D) = (d_out w^T) / F, broadcast over f, written only
//    when neigh needs a gradient (the GNN's h1 call; for the data inputs
//    it would be 370 MB written for nothing). A block computes a 16 x 64
//    tile of d_out w^T (h ascending), divides by F, and writes it F times.
//
// Bound on this card: bytes for the forward, which at the main shape
// reads 369.9 MB of neigh and 0.3 MB of w and writes 7.9 MB of out (plus
// 37.0 MB of aggregate when training), about 0.113 ms (0.124 ms) at
// 3.35 TB/s against 2.46 GFLOP, about 0.037 ms at 67 TFLOP/s in f32.
// Operations for d_w at that shape: 2.37 GFLOP (0.035 ms) against 45 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// forward: a block owns R rows (32, or 8 when B is small) and 128 output
// columns; warp w owns rows R/8 * w .. and lane l the columns l + 32 q
constexpr int kFwdThreads = 256;
constexpr int kFwdCols = 128;
constexpr int kFwdK = 32;              // rows of w staged at a time
constexpr int kFwdBatch = 8;           // vectors summed at once a thread
constexpr int kFUnroll = 4;            // values of f loaded at once
constexpr int kColsPerThread = 4;
constexpr int kMaxSmem = 232448;       // 227 KB a block can opt into

// d_w: a block owns a 128 x 128 tile of d_w and one range of rows, 16
// rows per stage; thread (ty, tx) owns d = 4 ty + 64 i, h = 4 tx + 64 j
// (i, j < 2, four consecutive each)
constexpr int kDwThreads = 256;
constexpr int kDwTile = 128;
constexpr int kDwRows = 16;

// d_neigh tile: 16 rows x 64 d per block, h chunk 16; thread (ty, tx)
// owns row ty and d = tx + 16 q (q < 4)
constexpr int kDnThreads = 256;
constexpr int kDnRows = 16;
constexpr int kDnCols = 64;
constexpr int kDnH = 16;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void add(T& s, T v) { s += v; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void add(T& s, T v) {
    s.x += v.x;
    s.y += v.y;
  }
  static __device__ __forceinline__ float get(const T& v, int j) {
    return j == 0 ? v.x : v.y;
  }
};

__host__ __device__ __forceinline__ int pad_k(int D) {
  return (D + kFwdK - 1) / kFwdK * kFwdK;
}

// shared memory of the forward: the transposed aggregate (d_pad, R + 4)
// and a (32, 128) slice of w
__host__ __device__ __forceinline__ size_t fwd_smem(int R, int D) {
  return sizeof(float) * (static_cast<size_t>(pad_k(D)) * (R + 4) +
                          kFwdK * kFwdCols);
}

template <int R, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
sage_fwd_kernel(const float* __restrict__ neigh, const float* __restrict__ w,
                float* __restrict__ out, float* __restrict__ agg_out,
                int64_t B, int F, int D, int H) {
  using V = Vec<VEC>;
  constexpr int ld = R + 4;                  // float4 rows, 4-way writes
  constexpr int kRowsPerThread = R / 8;
  extern __shared__ __align__(16) float smem[];
  const int d_pad = pad_k(D);
  float* agg_t = smem;                       // [d_pad][ld]
  float* w_s = smem + d_pad * ld;            // [kFwdK][kFwdCols]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int col0 = blockIdx.y * kFwdCols;
  const int rows = static_cast<int>(B - row0 < R ? B - row0 : R);
  const float f_div = static_cast<float>(F);
  const bool write_agg = agg_out != nullptr && blockIdx.y == 0;

  // 1. the aggregate of this block's rows, streamed row by row: vector v
  //    is (row v / dv, d = VEC (v % dv)); f ascending, f32, then / F
  const int dv = D / VEC;
  const int n_vec = rows * dv;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const float* base = neigh + row0 * fd;
  for (int v0 = 0; v0 < n_vec; v0 += kFwdThreads * kFwdBatch) {
    int64_t off[kFwdBatch];
    typename V::T s[kFwdBatch];
#pragma unroll
    for (int i = 0; i < kFwdBatch; ++i) {
      const int v = v0 + tid + kFwdThreads * i;
      const int r = v / dv;
      off[i] = v < n_vec ? r * fd + static_cast<int64_t>(v - r * dv) * VEC
                         : -1;
      s[i] = V::zero();
    }
    // the loads of kFUnroll values of f are issued before their adds, so
    // that 32 vectors a thread are in flight; each sum stays f ascending
    int f = 0;
    for (; f + kFUnroll <= F; f += kFUnroll) {
      typename V::T x[kFUnroll][kFwdBatch];
#pragma unroll
      for (int u = 0; u < kFUnroll; ++u) {
        const int64_t fo = static_cast<int64_t>(f + u) * D;
#pragma unroll
        for (int i = 0; i < kFwdBatch; ++i)
          x[u][i] = off[i] >= 0 ? V::load(base + off[i] + fo) : V::zero();
      }
#pragma unroll
      for (int u = 0; u < kFUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kFwdBatch; ++i) V::add(s[i], x[u][i]);
    }
    for (; f < F; ++f) {
      const int64_t fo = static_cast<int64_t>(f) * D;
#pragma unroll
      for (int i = 0; i < kFwdBatch; ++i)
        if (off[i] >= 0) V::add(s[i], V::load(base + off[i] + fo));
    }
#pragma unroll
    for (int i = 0; i < kFwdBatch; ++i) {
      if (off[i] < 0) continue;
      const int v = v0 + tid + kFwdThreads * i;
      const int r = v / dv;
      const int d = (v - r * dv) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = V::get(s[i], j) / f_div;
        agg_t[(d + j) * ld + r] = a;
        if (write_agg) agg_out[(row0 + r) * D + d + j] = a;
      }
    }
  }
  // the first slice of w, into registers; each later slice loads while
  // the one before it is multiplied
  constexpr int kWLoads = kFwdK * kFwdCols / kFwdThreads;
  float w_r[kWLoads];
  auto load_w = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int t = tid + kFwdThreads * i;
      const int kr = k0 + t / kFwdCols;
      const int hc = col0 + t % kFwdCols;
      w_r[i] = (kr < D && hc < H)
                   ? __ldg(w + static_cast<int64_t>(kr) * H + hc) : 0.f;
    }
  };
  load_w(0);
  // zero rows of d past D: they meet the zero rows of w_s, and garbage
  // there could be a NaN
  for (int t = tid; t < (d_pad - D) * ld; t += kFwdThreads)
    agg_t[D * ld + t] = 0.f;

  // 2. out (R, 128) = aggregate @ w[:, col0 : col0 + 128], k ascending
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < d_pad; k0 += kFwdK) {
    __syncthreads();   // agg_t written; the previous w_s slice consumed
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) w_s[tid + kFwdThreads * i] = w_r[i];
    __syncthreads();
    if (k0 + kFwdK < d_pad) load_w(k0 + kFwdK);
#pragma unroll 8
    for (int kk = 0; kk < kFwdK; ++kk) {
      const float* ar = agg_t + (k0 + kk) * ld + warp * kRowsPerThread;
      float a[kRowsPerThread];
      if constexpr (kRowsPerThread == 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(ar);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) a[r] = ar[r];
      }
      float wv[kColsPerThread];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q)
        wv[q] = w_s[kk * kFwdCols + lane + 32 * q];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q)
          acc[r][q] = fmaf(a[r], wv[q], acc[r][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int rr = warp * kRowsPerThread + r;
    if (rr >= rows) break;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int h = col0 + lane + 32 * q;
      if (h < H) out[(row0 + rr) * H + h] = acc[r][q];
    }
  }
}

__global__ void __launch_bounds__(kDwThreads)
sage_dw_partial_kernel(const float* __restrict__ agg,
                       const float* __restrict__ d_out,
                       float* __restrict__ partial, int64_t R, int D, int H,
                       int64_t rows_per_split) {
  __shared__ __align__(16) float a_s[kDwRows * kDwTile];
  __shared__ __align__(16) float g_s[kDwRows * kDwTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d0 = blockIdx.x * kDwTile;
  const int h0 = blockIdx.y * kDwTile;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < R ? r_begin + rows_per_split : R;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // stage r0's rows sit in shared memory while the next stage's are
  // loaded into registers (kLoads values of each operand a thread)
  constexpr int kLoads = kDwRows * kDwTile / kDwThreads;
  float a_r[kLoads], g_r[kLoads];
  auto load = [&](int64_t r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int t = tid + kDwThreads * i;
      const int64_t r = r0 + t / kDwTile;
      const int c = t % kDwTile;
      a_r[i] = (r < r_end && d0 + c < D) ? __ldg(agg + r * D + d0 + c) : 0.f;
      g_r[i] = (r < r_end && h0 + c < H) ? __ldg(d_out + r * H + h0 + c)
                                         : 0.f;
    }
  };
  load(r_begin);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kDwRows) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      a_s[tid + kDwThreads * i] = a_r[i];
      g_s[tid + kDwThreads * i] = g_r[i];
    }
    __syncthreads();
    if (r0 + kDwRows < r_end) load(r0 + kDwRows);
#pragma unroll
    for (int rr = 0; rr < kDwRows; ++rr) {
      const float* ar = a_s + rr * kDwTile + 4 * ty;
      const float* gr = g_s + rr * kDwTile + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ar + 64);
      const float4 g0 = *reinterpret_cast<const float4*>(gr);
      const float4 g1 = *reinterpret_cast<const float4*>(gr + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<int64_t>(blockIdx.z) * D * H;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + 4 * ty + 64 * (i / 4) + i % 4;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = h0 + 4 * tx + 64 * (j / 4) + j % 4;
      if (h < H) dst[static_cast<int64_t>(d) * H + h] = acc[i][j];
    }
  }
}

__global__ void sage_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ d_w, int64_t n,
                                      int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  float s = partial[i];
  for (int sp = 1; sp < splits; ++sp) s += partial[sp * n + i];
  d_w[i] = s;
}

__global__ void __launch_bounds__(kDnThreads)
sage_dneigh_kernel(const float* __restrict__ d_out,
                   const float* __restrict__ w, float* __restrict__ d_neigh,
                   int64_t B, int F, int D, int H) {
  __shared__ float g_s[kDnRows][kDnH + 1];
  __shared__ float w_s[kDnH][kDnCols + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kDnRows;
  const int d0 = blockIdx.y * kDnCols;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h0 = 0; h0 < H; h0 += kDnH) {
    {
      const int rr = tid / kDnH;
      const int hh = tid % kDnH;
      const int64_t b = b0 + rr;
      g_s[rr][hh] = (b < B && h0 + hh < H) ? __ldg(d_out + b * H + h0 + hh)
                                           : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDnH * kDnCols / kDnThreads; ++i) {
      const int t = tid + kDnThreads * i;
      const int hh = t % kDnH;
      const int c = t / kDnH;
      w_s[hh][c] = (d0 + c < D && h0 + hh < H)
                       ? __ldg(w + static_cast<int64_t>(d0 + c) * H + h0 + hh)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < kDnH; ++hh) {
      const float g = g_s[ty][hh];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = fmaf(g, w_s[hh][tx + 16 * q], acc[q]);
    }
    __syncthreads();
  }
  const int64_t b = b0 + ty;
  if (b >= B) return;
  const float f_div = static_cast<float>(F);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = acc[q] / f_div;
  float* dst = d_neigh + b * F * D;
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = d0 + tx + 16 * q;
      if (d < D) dst[static_cast<int64_t>(f) * D + d] = v[q];
    }
  }
}

unsigned blocks(int64_t n, int64_t per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of its launches (0 = launched).

// out (B, H) = mean_f(neigh) @ w; `agg` (B, D) receives the aggregate
// when it is not null.
extern "C" int sage_aggregate_fwd(const float* neigh, const float* w,
                                  float* out, float* agg, int64_t B,
                                  int32_t F, int32_t D, int32_t H,
                                  void* stream) {
  if (B == 0 || H == 0) return 0;
  if (F < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned col_tiles = blocks(H, kFwdCols);
  // 32 rows a block where that still gives every SM a block, else 8
  const bool wide = blocks(B, 32) * col_tiles >= 132 &&
                    fwd_smem(32, D) <= static_cast<size_t>(kMaxSmem);
  const int R = wide ? 32 : 8;
  const size_t smem = fwd_smem(R, D);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 2 == 0 &&
                   (reinterpret_cast<uintptr_t>(neigh) & 7u) == 0;
  const void* fn = wide ? (vec ? reinterpret_cast<const void*>(
                                     sage_fwd_kernel<32, 2>)
                               : reinterpret_cast<const void*>(
                                     sage_fwd_kernel<32, 1>))
                        : (vec ? reinterpret_cast<const void*>(
                                     sage_fwd_kernel<8, 2>)
                               : reinterpret_cast<const void*>(
                                     sage_fwd_kernel<8, 1>));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(B, R), col_tiles);
  if (wide && vec)
    sage_fwd_kernel<32, 2><<<grid, kFwdThreads, smem, s>>>(neigh, w, out, agg,
                                                           B, F, D, H);
  else if (wide)
    sage_fwd_kernel<32, 1><<<grid, kFwdThreads, smem, s>>>(neigh, w, out, agg,
                                                           B, F, D, H);
  else if (vec)
    sage_fwd_kernel<8, 2><<<grid, kFwdThreads, smem, s>>>(neigh, w, out, agg,
                                                          B, F, D, H);
  else
    sage_fwd_kernel<8, 1><<<grid, kFwdThreads, smem, s>>>(neigh, w, out, agg,
                                                          B, F, D, H);
  return static_cast<int>(cudaGetLastError());
}

// d_w (D, H) = agg^T d_out when `d_w` is not null (`partial` is scratch of
// splits * D * H floats); d_neigh (B, F, D) = (d_out w^T) / F broadcast
// over f when `d_neigh` is not null.
extern "C" int sage_aggregate_bwd(const float* d_out, const float* w,
                                  const float* agg, float* d_w,
                                  float* partial, float* d_neigh, int64_t B,
                                  int32_t F, int32_t D, int32_t H,
                                  int32_t splits, void* stream) {
  if (F < 1 || D < 1 || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_w != nullptr && H > 0) {
    const int64_t rows_per_split = (B + splits - 1) / splits;
    const dim3 grid(blocks(D, kDwTile), blocks(H, kDwTile), splits);
    sage_dw_partial_kernel<<<grid, kDwThreads, 0, s>>>(agg, d_out, partial,
                                                       B, D, H,
                                                       rows_per_split);
    const int64_t n = static_cast<int64_t>(D) * H;
    sage_dw_reduce_kernel<<<blocks(n, 256), 256, 0, s>>>(partial, d_w, n,
                                                         splits);
  }
  if (d_neigh != nullptr && B > 0) {
    const dim3 grid(blocks(B, kDnRows), blocks(D, kDnCols));
    sage_dneigh_kernel<<<grid, kDnThreads, 0, s>>>(d_out, w, d_neigh, B, F,
                                                   D, H);
  }
  return static_cast<int>(cudaGetLastError());
}
