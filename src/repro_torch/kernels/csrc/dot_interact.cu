// DLRM pairwise dot interaction for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dot_interact.py
// (`dot_interact`, pallas_call at :51). On the TPU a batch tile of
// features sits in VMEM, the F x F Gram matrix is an MXU matmul, and the
// strict lower triangle (i > j) is extracted by a second matmul against a
// 0/1 selection matrix, because a lane gather does not lower there. The
// TPU kernel has no backward.
//
// Forward: feats (B, F, D) f32 -> out (B, P) f32, P = F(F-1)/2, pair
// p = i(i-1)/2 + j for i > j (np.tril_indices(F, -1) order). One warp per
// sample stages the sample's (F, D) tile in shared memory (27 x 132 x 4 B
// = 14.3 KB at the DLRM-Criteo widths, rows padded to 132 floats). Each
// lane then owns a 7 x 4 block of the Gram matrix (rows a, a+4, ..., a+24
// for a = lane % 4; columns c, c+8, c+16, c+24 for c = lane / 4): per
// 4-wide step over D it loads 11 float4 and does 112 FMAs, so shared
// memory, not the FMA pipe, is what a pair of rows costs once. The
// padding puts the rows one lane group reads in distinct banks. The
// block covers the full 28 x 32 tile and only the strict lower triangle
// is stored: no selection matmul, no Gram matrix in device memory, and B
// needs to divide nothing. Each (i, j) sums d in ascending order.
//
// Backward: dFeats[b] = (S + S^T) feats[b], where S scatters dOut[b] into
// the strict lower triangle. A block per sample stages feats[b] and the
// symmetric F x F coefficient matrix in shared memory; warp w owns rows
// w, w+G, w+2G, w+3G (G warps) and lane l the float4 column slices l,
// l+32, ...: per k it loads four broadcast coefficients and one float4 of
// feats[b, k] and does 16 FMAs. Each output sums k in ascending order.
//
// Bound on this card: bytes (about 184 MFLOP against 31 MB forward at the
// main path's shapes; the f32 rate is not reached before the memory
// rate). Every input element is read from device memory once and every
// output element written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;
// forward lane tile: rows a + 4r (r < 7), columns c + 8q (q < 4)
constexpr int kRowGroups = 4;
constexpr int kRowsPerLane = 7;
constexpr int kColGroups = 8;
constexpr int kColsPerLane = 4;
constexpr int kTileRows = kRowGroups * kRowsPerLane;   // 28
constexpr int kTileCols = kColGroups * kColsPerLane;   // 32
// backward: rows per warp
constexpr int kBwdRowsPerWarp = 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// Row stride of the staged tile: D + 4 keeps float4 alignment and moves
// consecutive rows 4 banks apart; D + 1 (scalar path) moves them by one.
__host__ __device__ __forceinline__ int tile_ld(int D, bool vec) {
  return vec ? D + 4 : D + 1;
}

template <bool kVec>
__global__ void __launch_bounds__(32)
dot_interact_fwd_kernel(const float* __restrict__ feats,
                        float* __restrict__ out, int F, int D, int P) {
  extern __shared__ float xs[];                        // (F, ld)
  const int ld = tile_ld(D, kVec);
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const float* x = feats + b * F * D;
  if (kVec) {
    const int n4 = F * D / 4;
    for (int t = lane; t < n4; t += 32) {
      const int r = (4 * t) / D;
      *reinterpret_cast<float4*>(xs + r * ld + 4 * t - r * D) =
          __ldg(reinterpret_cast<const float4*>(x) + t);
    }
  } else {
    for (int t = lane; t < F * D; t += 32) {
      const int r = t / D;
      xs[r * ld + t - r * D] = __ldg(x + t);
    }
  }
  __syncwarp();
  const int a = lane % kRowGroups;
  const int c = lane / kRowGroups;
  float* dst = out + b * P;
  for (int i0 = 0; i0 < F; i0 += kTileRows) {
    // column tiles that can hold a pair j < i of this row tile
    for (int j0 = 0; j0 < F && j0 < i0 + kTileRows - 1; j0 += kTileCols) {
      const float* xi[kRowsPerLane];
      const float* xj[kColsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r)
        xi[r] = xs + min(i0 + a + kRowGroups * r, F - 1) * ld;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q)
        xj[q] = xs + min(j0 + c + kColGroups * q, F - 1) * ld;
      float acc[kRowsPerLane][kColsPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r)
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) acc[r][q] = 0.f;
      if (kVec) {
        for (int d = 0; d < D; d += 4) {
          float4 vj[kColsPerLane];
#pragma unroll
          for (int q = 0; q < kColsPerLane; ++q) vj[q] = ld4(xj[q] + d);
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) {
            const float4 vi = ld4(xi[r] + d);
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q)
              acc[r][q] = dot4(vi, vj[q], acc[r][q]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          float vj[kColsPerLane];
#pragma unroll
          for (int q = 0; q < kColsPerLane; ++q) vj[q] = xj[q][d];
#pragma unroll
          for (int r = 0; r < kRowsPerLane; ++r) {
            const float vi = xi[r][d];
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q)
              acc[r][q] = fmaf(vi, vj[q], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int i = i0 + a + kRowGroups * r;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          const int j = j0 + c + kColGroups * q;
          if (i < F && j < i) dst[i * (i - 1) / 2 + j] = acc[r][q];
        }
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
dot_interact_bwd_kernel(const float* __restrict__ d_out,
                        const float* __restrict__ feats,
                        float* __restrict__ d_feats, int F, int D, int P) {
  extern __shared__ float sm[];
  float* xs = sm;                                     // (F, D)
  float* cs = sm + F * D;                             // (F, F) symmetric
  const int64_t b = blockIdx.x;
  const float* x = feats + b * F * D;
  const float* g = d_out + b * P;
  if (kVec) {
    for (int t = threadIdx.x; t < F * D / 4; t += blockDim.x)
      reinterpret_cast<float4*>(xs)[t] =
          __ldg(reinterpret_cast<const float4*>(x) + t);
  } else {
    for (int t = threadIdx.x; t < F * D; t += blockDim.x) xs[t] = __ldg(x + t);
  }
  for (int t = threadIdx.x; t < F * F; t += blockDim.x) {
    const int i = t / F;
    const int j = t - i * F;
    float v = 0.f;
    if (i > j) v = __ldg(g + i * (i - 1) / 2 + j);
    else if (j > i) v = __ldg(g + j * (j - 1) / 2 + i);
    cs[t] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int rows[kBwdRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kBwdRowsPerWarp; ++m)
    rows[m] = min(warp + n_warps * m, F - 1);
  float* dst = d_feats + b * F * D;
  const int n_cols = kVec ? D / 4 : D;
  for (int col = lane; col < n_cols; col += 32) {
    if (kVec) {
      float4 acc[kBwdRowsPerWarp];
#pragma unroll
      for (int m = 0; m < kBwdRowsPerWarp; ++m)
        acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < F; ++k) {
        const float4 v = ld4(xs + k * D + 4 * col);
#pragma unroll
        for (int m = 0; m < kBwdRowsPerWarp; ++m) {
          const float cik = cs[rows[m] * F + k];
          acc[m].x = fmaf(cik, v.x, acc[m].x);
          acc[m].y = fmaf(cik, v.y, acc[m].y);
          acc[m].z = fmaf(cik, v.z, acc[m].z);
          acc[m].w = fmaf(cik, v.w, acc[m].w);
        }
      }
#pragma unroll
      for (int m = 0; m < kBwdRowsPerWarp; ++m) {
        const int i = warp + n_warps * m;
        if (i < F) reinterpret_cast<float4*>(dst + i * D)[col] = acc[m];
      }
    } else {
      float acc[kBwdRowsPerWarp] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < F; ++k) {
        const float v = xs[k * D + col];
#pragma unroll
        for (int m = 0; m < kBwdRowsPerWarp; ++m)
          acc[m] = fmaf(cs[rows[m] * F + k], v, acc[m]);
      }
#pragma unroll
      for (int m = 0; m < kBwdRowsPerWarp; ++m) {
        const int i = warp + n_warps * m;
        if (i < F) dst[i * D + col] = acc[m];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched); a tile over the 48 KB
// shared-memory window is refused with cudaErrorInvalidValue.
extern "C" int dot_interact_fwd(const float* feats, float* out, int64_t B,
                                int32_t F, int32_t D, void* stream) {
  if (B == 0 || F < 2) return 0;
  const bool vec = D % 4 == 0 && aligned16(feats);
  const size_t smem = sizeof(float) * static_cast<size_t>(F) * tile_ld(D, vec);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int P = F * (F - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dot_interact_fwd_kernel<true><<<static_cast<unsigned>(B), 32, smem, s>>>(
        feats, out, F, D, P);
  } else {
    dot_interact_fwd_kernel<false><<<static_cast<unsigned>(B), 32, smem, s>>>(
        feats, out, F, D, P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dot_interact_bwd(const float* d_out, const float* feats,
                                float* d_feats, int64_t B, int32_t F,
                                int32_t D, void* stream) {
  if (B == 0 || F < 1) return 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(F) * D + static_cast<size_t>(F) * F);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int P = F * (F - 1) / 2;
  int warps = (F + kBwdRowsPerWarp - 1) / kBwdRowsPerWarp;
  if (warps > 32) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && aligned16(feats) && aligned16(d_feats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    dot_interact_bwd_kernel<true><<<static_cast<unsigned>(B), 32 * warps,
                                    smem, s>>>(d_out, feats, d_feats, F, D, P);
  } else {
    dot_interact_bwd_kernel<false><<<static_cast<unsigned>(B), 32 * warps,
                                     smem, s>>>(d_out, feats, d_feats, F, D,
                                                P);
  }
  return static_cast<int>(cudaGetLastError());
}
