// DLRM pairwise dot interaction for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dot_interact.py
// (`dot_interact`, pallas_call at :51). On the TPU a batch tile of
// features sits in VMEM, the F x F Gram matrix is an MXU matmul, and the
// strict lower triangle (i > j) is extracted by a second matmul against a
// 0/1 selection matrix, because a lane gather does not lower there. The
// TPU kernel has no backward: the JAX trainer differentiates the pure-jnp
// form of `dot_interact` (src/repro/kernels/dot_interact.py:44), and the
// backward here is that function's transpose.
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
// Bound on this card: bytes (about 184 MFLOP against 31 MB at the main
// path's shapes; the f32 rate is not reached before the memory rate).
//
// Backward: dFeats[b] = C_b feats[b], C_b = S + S^T, where S scatters
// dOut[b] into the strict lower triangle. Bound by bytes: at the DLRM
// shape (2048, 27, 128) it reads feats and dOut and writes dFeats, 59.5
// MB (0.0178 ms at 3.35 TB/s), against 0.38 GFLOP of FMAs (6 us at 67
// TFLOP/s). The first version (one CTA a sample; load, build, compute and
// store in series; four scalar coefficient loads per float4 of feats)
// ran at 56% of that bound and lost to one cuBLAS bmm. This one:
//  - Persistent CTAs. The host plan (dot_interact.py, `bwd_plan`)
//    launches about four CTAs an SM, at most B; CTA c walks samples c,
//    c + gridDim.x, ... so there is no tail wave of CTAs.
//  - A double-buffered copy of the next sample. While a CTA works on
//    sample b, cp.async brings sample b + gridDim.x's feats tile (13,824
//    B, 16-byte copies when feats is 16-byte aligned and D % 4 == 0, else
//    4-byte copies) and its dOut row (1404 B, only 4-byte aligned: 4-byte
//    copies) into the other stage, so HBM streams while the CTA computes.
//  - Coefficients stored k-major, cs[k][8 w + r] = C_b[7 w + r][k]: warp
//    w owns rows 7w .. 7w + 6 (ceil(F / 7) warps, 4 at F = 27) and reads
//    its 7 coefficients for one k as two broadcast float4 loads. A lane
//    holds a float4 column slice of its 7 rows, so one float4 of feats
//    feeds 28 FMAs (the first version: 16, with four scalar loads).
//  - The coefficients are built without divisions: warp w takes k = w, w
//    + warps, ..., lane s a slot of the row, and looks the pair up by
//    i(i-1)/2 + j from the staged dOut row.
// Each output sums k in ascending order from 0.0f with f32 FMAs, as the
// first version did (bit-equal to cuBLAS's bmm on the H100 so far); no
// tensor cores: TF32 would break the 1e-5 tolerance, and the kernel is
// bound by bytes. Two __syncthreads a sample.
//
// Every input element is read from device memory once and every output
// element written once, in both directions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int64_t kMaxOptInSharedBytes = 232448;   // a block's, on sm_90
// forward lane tile: rows a + 4r (r < 7), columns c + 8q (q < 4)
constexpr int kRowGroups = 4;
constexpr int kRowsPerLane = 7;
constexpr int kColGroups = 8;
constexpr int kColsPerLane = 4;
constexpr int kTileRows = kRowGroups * kRowsPerLane;   // 28
constexpr int kTileCols = kColGroups * kColsPerLane;   // 32
// backward: rows of dFeats a warp, and its coefficient slots (7 + 1 pad)
constexpr int kBwdRows = 7;
constexpr int kBwdSlots = 8;
constexpr int kBwdMaxThreads = 640;          // ceil(128 / 7) warps, rounded

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

__device__ __forceinline__ float4 fma4(float c, float4 v, float4 acc) {
  return make_float4(fmaf(c, v.x, acc.x), fmaf(c, v.y, acc.y),
                     fmaf(c, v.z, acc.z), fmaf(c, v.w, acc.w));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Floats of one stage of the ring: the feats tile (F, D), then the dOut
// row (P), each rounded up to a multiple of 4 floats.
__host__ __device__ __forceinline__ int bwd_stage_floats(int F, int D) {
  return round4(F * D) + round4(F * (F - 1) / 2);
}

// Shared memory of a backward CTA: two stages and the coefficients
// (F, 8 x warps). Mirrored by dot_interact.py's `bwd_smem`.
size_t bwd_smem(int F, int D, int warps) {
  return sizeof(float) * (2 * static_cast<size_t>(bwd_stage_floats(F, D)) +
                          static_cast<size_t>(F) * kBwdSlots * warps);
}

// One CTA of ceil(F / 7) warps per launch slot, walking samples
// blockIdx.x, blockIdx.x + gridDim.x, ...; see the header.
template <bool kVec>
__global__ void __launch_bounds__(kBwdMaxThreads)
dot_interact_bwd_kernel(const float* __restrict__ d_out,
                        const float* __restrict__ feats,
                        float* __restrict__ d_feats, int64_t B, int F, int D,
                        int P) {
  extern __shared__ __align__(16) float sm[];
  const int stage_floats = bwd_stage_floats(F, D);
  const int xn = F * D;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const int ldc = kBwdSlots * n_warps;
  float* cs = sm + 2 * stage_floats;                 // (F, ldc)

  // stage `st` <- sample b's feats tile and dOut row, one commit group
  auto issue = [&](int64_t b, int st) {
    float* xs = sm + st * stage_floats;
    float* gs = xs + round4(xn);
    const float* x = feats + b * xn;
    if (kVec) {
      for (int t = 4 * tid; t < xn; t += 4 * n_threads)
        cp_async<16>(xs + t, x + t);
    } else {
      for (int t = tid; t < xn; t += n_threads) cp_async<4>(xs + t, x + t);
    }
    const float* g = d_out + b * P;
    for (int t = tid; t < P; t += n_threads) cp_async<4>(gs + t, g + t);
    cp_async_commit();
  };

  int64_t b = blockIdx.x;
  issue(b, 0);
  for (int st = 0; b < B; st ^= 1, b += gridDim.x) {
    // this sample's stage has landed, and every warp is done with the
    // other stage and the coefficients of the sample before
    cp_async_wait_all();
    __syncthreads();
    if (b + gridDim.x < B) issue(b + gridDim.x, st ^ 1);
    const float* xs = sm + st * stage_floats;
    const float* gs = xs + round4(xn);
    for (int k = warp; k < F; k += n_warps) {
      for (int slot = lane; slot < ldc; slot += 32) {
        const int r = slot & (kBwdSlots - 1);
        const int i = (slot / kBwdSlots) * kBwdRows + r;
        float v = 0.f;
        if (r < kBwdRows && i < F && i != k)
          v = i > k ? gs[i * (i - 1) / 2 + k] : gs[k * (k - 1) / 2 + i];
        cs[k * ldc + slot] = v;
      }
    }
    __syncthreads();
    const float* crow = cs + warp * kBwdSlots;
    float* dst = d_feats + b * xn;
    const int i0 = warp * kBwdRows;
    if (kVec) {
      for (int col = lane; col < D / 4; col += 32) {
        float4 acc[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r)
          acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int k = 0; k < F; ++k) {
          const float4 v = ld4(xs + k * D + 4 * col);
          const float4 c0 = ld4(crow + k * ldc);
          const float4 c1 = ld4(crow + k * ldc + 4);
          acc[0] = fma4(c0.x, v, acc[0]);
          acc[1] = fma4(c0.y, v, acc[1]);
          acc[2] = fma4(c0.z, v, acc[2]);
          acc[3] = fma4(c0.w, v, acc[3]);
          acc[4] = fma4(c1.x, v, acc[4]);
          acc[5] = fma4(c1.y, v, acc[5]);
          acc[6] = fma4(c1.z, v, acc[6]);
        }
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          if (i0 + r < F)
            reinterpret_cast<float4*>(dst + (i0 + r) * D)[col] = acc[r];
        }
      }
    } else {
      for (int col = lane; col < D; col += 32) {
        float acc[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < F; ++k) {
          const float v = xs[k * D + col];
          const float4 c0 = ld4(crow + k * ldc);
          const float4 c1 = ld4(crow + k * ldc + 4);
          acc[0] = fmaf(c0.x, v, acc[0]);
          acc[1] = fmaf(c0.y, v, acc[1]);
          acc[2] = fmaf(c0.z, v, acc[2]);
          acc[3] = fmaf(c0.w, v, acc[3]);
          acc[4] = fmaf(c1.x, v, acc[4]);
          acc[5] = fmaf(c1.y, v, acc[5]);
          acc[6] = fmaf(c1.z, v, acc[6]);
        }
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          if (i0 + r < F) dst[(i0 + r) * D + col] = acc[r];
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched). The forward refuses a
// tile over the 48 KB shared-memory window with cudaErrorInvalidValue.
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

// The backward launches the host plan (dot_interact.py, `bwd_plan`):
// `ctas` persistent CTAs of `warps` warps with `smem` bytes of shared
// memory each, `vec` 1 for 16-byte copies and float4 math (D % 4 == 0,
// feats and d_feats 16-byte aligned) else 0. A plan that does not fit
// the call (too few warps for F, too little shared memory, more than
// 227 KB of it) returns cudaErrorInvalidValue without launching.
extern "C" int dot_interact_bwd(const float* d_out, const float* feats,
                                float* d_feats, int64_t B, int32_t F,
                                int32_t D, int32_t vec, int32_t warps,
                                int32_t ctas, int64_t smem, void* stream) {
  if (B == 0 || F < 1) return 0;
  if (warps < 1 || warps * 32 > kBwdMaxThreads || warps * kBwdRows < F ||
      ctas < 1 || ctas > B || smem < static_cast<int64_t>(
          bwd_smem(F, D, warps)) || smem > kMaxOptInSharedBytes ||
      (vec && !(D % 4 == 0 && aligned16(feats) && aligned16(d_feats)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = F * (F - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = vec ? dot_interact_bwd_kernel<true>
                    : dot_interact_bwd_kernel<false>;
  if (smem > kMaxSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ctas, 32 * warps, static_cast<size_t>(smem), s>>>(
      d_out, feats, d_feats, B, F, D, P);
  return static_cast<int>(cudaGetLastError());
}
