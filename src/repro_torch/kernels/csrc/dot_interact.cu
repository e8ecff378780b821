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
// Forward: feats (B, F, D) f32 or bf16 -> out (B, P) in feats' dtype, P =
// F(F-1)/2, pair p = i(i-1)/2 + j for i > j (np.tril_indices(F, -1)
// order); each dot sums d ascending from 0.0f in f32 FMAs and a bf16 out
// is that f32 rounded to nearest even, as the TPU kernel casts to f32
// inside and back at the end. Bound by bytes: at the DLRM shape (2048,
// 27, 128) f32 it reads 28.3 MB and writes 2.9 MB (0.0093 ms at 3.35
// TB/s) against 92 M FMAs of the 351 pairs. The first version gave a
// sample a one-warp CTA that staged its tile, then computed a 28 x 32
// square of dots of which 351 were kept: 2.55x the FMAs, load and compute
// in series, and B = 2048 CTAs in two waves at 15 a SM, the second of 68.
// This one:
//  - Persistent warps. The host plan (dot_interact.py, `fwd_plan`) gives
//    each warp its own samples (warp w of the grid takes samples w, w + W,
//    ..., W the warps of the grid) and its own shared memory, and puts as
//    many warps on an SM as their shared memory allows (8 at the DLRM
//    shape): one wave, no tail of CTAs.
//  - The next sample copied while this one is computed: cp.async brings
//    sample b + W into the warp's second stage (16-byte copies where D %
//    4 == 0 and feats is 16-byte aligned, else 4-byte ones).
//  - Only the lower triangle: the F x F products are cut into 4 x 4
//    blocks, and only the nb (nb + 1) / 2 blocks (I, J) with I >= J are
//    computed, nb = ceil(F / 4), a lane a block: 448 dots at F = 27 for
//    the 351 kept (1.28x). A lane reads 4 rows i and 4 rows j per step of
//    4 in d (8 float4 loads for 64 FMAs).
//  - Bank-conflict-free reads: the tile's row r lives in slot (r % 4) nb
//    + r / 4, so the rows that the lanes of a quarter warp read at once
//    (4I + a for neighbouring I, or 4J + q) are neighbouring slots, and
//    slots start ld = 4 x odd floats apart (D % 4 == 0; ld odd for the
//    scalar path), in different banks; lanes of one I share its rows'
//    addresses (broadcast).
//  - bf16: cp.async copies the sample's raw bytes (16-, or 4-byte copies
//    where only those fit; a feats only 2-byte aligned is loaded lane by
//    lane instead), and the warp widens them once into an f32 tile of the
//    same layout before it computes. Widening at every read instead would
//    cost an integer op per element per use (nb uses), on the pipe the
//    FMAs issue from; once costs F x D per sample, a tenth of the FMAs.
// No tensor cores: TF32 would break the f32 tolerance (1e-5 against f32
// cuBLAS), and the kernel is bound by bytes.
//
// Backward, f32 or bf16 (dOut, feats and dFeats in feats' dtype, as the
// reference's gradient of a bf16 feats is bf16): dFeats[b] = C_b
// feats[b], C_b = S + S^T, where S scatters dOut[b] into the strict lower
// triangle. Bound by bytes: at the DLRM
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
// bf16 keeps that plan and order and moves half the bytes (0.95 GB at the
// DLRM-Criteo training shape (65536, 27, 128), 0.28 ms at 3.35 TB/s):
//  - the stages hold the raw bf16 bytes. cp.async brings the sample's feats
//    in 16-byte copies (8 elements; F D % 8 == 0 and feats 16-byte
//    aligned), else 4-byte ones (F D even, 4-byte aligned), else each
//    thread loads its elements (a feats only 2-byte aligned), and its dOut
//    row in the 4-byte words that hold it: a row of odd P starts on a
//    half word every other sample, so the stage keeps the row's offset (0
//    or 1) beside it, and the tensor's last element, when it ends on half
//    a word, is loaded alone, so nothing past dOut is read;
//  - the coefficients are widened when the warps build them (once a
//    sample), the feats in registers as each warp reads them (8 bytes, 4
//    elements, a step), and each output is rounded to bf16 once, when it
//    is stored (8 bytes a step where D % 4 == 0).
//
// Every input element is read from device memory once and every output
// element written once, in both directions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int64_t kMaxOptInSharedBytes = 232448;   // a block's, on sm_90
// backward: rows of dFeats a warp, and its coefficient slots (7 + 1 pad)
constexpr int kBwdRows = 7;
constexpr int kBwdSlots = 8;
constexpr int kBwdMaxThreads = 640;          // ceil(128 / 7) warps, rounded
// forward: a lane's block of the triangle, 4 rows i x 4 rows j
constexpr int kBlk = 4;
constexpr int kFwdMaxWarps = 8;           // dot_interact.py FWD_MAX_WARPS

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
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

__device__ __forceinline__ float bf16_bits_to_f32(unsigned short h) {
  return __bfloat162float(__ushort_as_bfloat16(h));
}

// The forward's f32 tile of a sample: row r in slot (r % 4) nb + r / 4,
// nb = ceil(F / 4), so that the rows a quarter warp reads at once (4I + a
// for a few neighbouring I, or 4J + q) lie in neighbouring slots; slots
// `fwd_ld` floats apart, ld / 4 odd for float4 reads (D % 4 == 0) or ld
// odd for scalar ones, so that neighbouring slots start in different
// banks. The tile holds the slots up to the last row's.
__host__ __device__ __forceinline__ int fwd_ld(int D) {
  return D % 4 == 0 ? 4 * ((D / 4) | 1) : (D | 1);
}
__host__ __device__ __forceinline__ int fwd_slot(int r, int nb) {
  return (r % kBlk) * nb + r / kBlk;
}
__host__ __device__ __forceinline__ int fwd_slots(int F) {
  const int nb = (F + kBlk - 1) / kBlk;
  int n = 0;
  for (int a = 0; a < kBlk && a < F; ++a) {
    const int last = a * nb + (F - 1 - a) / kBlk;     // slot of the last row
    n = last + 1 > n ? last + 1 : n;
  }
  return n;
}
__host__ __device__ __forceinline__ int fwd_tile_floats(int F, int D) {
  return round4(fwd_slots(F) * fwd_ld(D));
}
// The raw bf16 stage of a sample, in bytes: the (F, D) block as it lies
// in memory, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int fwd_raw_bytes(int F, int D) {
  return (2 * F * D + 15) & ~15;
}
// Shared memory of one forward warp: two f32 tiles (f32 feats, copied
// straight into them), or two raw bf16 stages and one f32 tile (bf16).
// Mirrored by dot_interact.py's `fwd_warp_smem`.
__host__ __device__ __forceinline__ int fwd_warp_smem(int F, int D,
                                                      bool bf16) {
  return bf16 ? 2 * fwd_raw_bytes(F, D) + 4 * fwd_tile_floats(F, D)
              : 8 * fwd_tile_floats(F, D);
}

// Persistent warps; see the header. T the feats' element type, kVec
// float4 math (D % 4 == 0), kCopy bytes a cp.async (16 or 4), or 0: a
// bf16 feats only 2-byte aligned, loaded by each lane and widened into
// the tile without cp.async.
template <typename T, bool kVec, int kCopy>
__global__ void __launch_bounds__(32 * kFwdMaxWarps)
dot_interact_fwd_kernel(const T* __restrict__ feats, T* __restrict__ out,
                        int64_t B, int F, int D, int P) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char fwd_sm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ld = fwd_ld(D);
  const int nb = (F + kBlk - 1) / kBlk;
  const int tile_floats = fwd_tile_floats(F, D);
  const int raw_bytes = fwd_raw_bytes(F, D);
  unsigned char* my = fwd_sm + warp * fwd_warp_smem(F, D, kBf16);
  // f32: stage s is tile s; bf16: raw stage s, then the one f32 tile
  float* tile = reinterpret_cast<float*>(my + 2 * raw_bytes);
  const int64_t fd = static_cast<int64_t>(F) * D;

  // stage `st` <- sample b, one commit group of this warp's copies
  auto issue = [&](int64_t b, int st) {
    const T* x = feats + b * fd;
    if constexpr (!kBf16) {
      float* xs = reinterpret_cast<float*>(my) + st * tile_floats;
      for (int r = 0; r < F; ++r) {
        float* dst = xs + fwd_slot(r, nb) * ld;
        const float* src = reinterpret_cast<const float*>(x) + r * D;
        if constexpr (kCopy == 16) {
          for (int c = 4 * lane; c < D; c += 128)
            cp_async<16>(dst + c, src + c);
        } else {
          for (int c = lane; c < D; c += 32) cp_async<4>(dst + c, src + c);
        }
      }
    } else {
      unsigned char* raw = my + st * raw_bytes;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
      for (int k = kCopy * lane; k < 2 * fd; k += 32 * kCopy)
        cp_async<kCopy>(raw + k, src + k);
    }
    cp_async_commit();
  };

  const int64_t n_workers =
      static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (kCopy != 0 && b < B) issue(b, 0);
  const int n_blocks = nb * (nb + 1) / 2;
  for (int st = 0; b < B; st ^= 1, b += n_workers) {
    // this sample's stage has landed, and every lane is done with the
    // stage (and tile) of the sample before
    if constexpr (kCopy != 0) cp_async_wait_all();
    __syncwarp();
    if (kCopy != 0 && b + n_workers < B) issue(b + n_workers, st ^ 1);
    const float* xs;
    if constexpr (kBf16) {
      // widen the bf16 sample into the f32 tile, once
      if constexpr (kCopy != 0) {
        const unsigned short* raw =
            reinterpret_cast<const unsigned short*>(my + st * raw_bytes);
        if (D % 8 == 0) {
          // 8 elements a lane: one 16-byte read, two float4 writes
          for (int r = 0; r < F; ++r) {
            float* dst = tile + fwd_slot(r, nb) * ld;
            for (int c = 8 * lane; c < D; c += 256) {
              const uint4 v = *reinterpret_cast<const uint4*>(raw + r * D + c);
              const unsigned w[4] = {v.x, v.y, v.z, v.w};
              float e[8];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                e[2 * k] = __uint_as_float(w[k] << 16);
                e[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
              }
              *reinterpret_cast<float4*>(dst + c) =
                  make_float4(e[0], e[1], e[2], e[3]);
              *reinterpret_cast<float4*>(dst + c + 4) =
                  make_float4(e[4], e[5], e[6], e[7]);
            }
          }
        } else {
          for (int r = 0; r < F; ++r) {
            float* dst = tile + fwd_slot(r, nb) * ld;
            for (int c = lane; c < D; c += 32)
              dst[c] = bf16_bits_to_f32(raw[r * D + c]);
          }
        }
      } else {
        const unsigned short* g =
            reinterpret_cast<const unsigned short*>(feats + b * fd);
        for (int r = 0; r < F; ++r) {
          float* dst = tile + fwd_slot(r, nb) * ld;
          for (int c = lane; c < D; c += 32)
            dst[c] = bf16_bits_to_f32(__ldg(g + r * D + c));
        }
      }
      __syncwarp();
      xs = tile;
    } else {
      xs = reinterpret_cast<const float*>(my) + st * tile_floats;
    }
    T* dst = out + b * P;
    // the blocks (I, J), I >= J, of the triangle in 4 x 4 blocks: block t
    // = I (I + 1) / 2 + J
    for (int t = lane; t < n_blocks; t += 32) {
      int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (I * (I + 1) / 2 > t) --I;
      while ((I + 1) * (I + 2) / 2 <= t) ++I;
      const int J = t - I * (I + 1) / 2;
      const float* xi[kBlk];
      const float* xj[kBlk];
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
        // rows past F read row F - 1 (their dots are not stored)
        xi[a] = xs + fwd_slot(min(kBlk * I + a, F - 1), nb) * ld;
        xj[a] = xs + fwd_slot(min(kBlk * J + a, F - 1), nb) * ld;
      }
      float acc[kBlk][kBlk];
#pragma unroll
      for (int a = 0; a < kBlk; ++a)
#pragma unroll
        for (int q = 0; q < kBlk; ++q) acc[a][q] = 0.f;
      if constexpr (kVec) {
        for (int d = 0; d < D; d += 4) {
          float4 vj[kBlk];
#pragma unroll
          for (int q = 0; q < kBlk; ++q) vj[q] = ld4(xj[q] + d);
#pragma unroll
          for (int a = 0; a < kBlk; ++a) {
            const float4 vi = ld4(xi[a] + d);
#pragma unroll
            for (int q = 0; q < kBlk; ++q)
              acc[a][q] = dot4(vi, vj[q], acc[a][q]);
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          float vj[kBlk];
#pragma unroll
          for (int q = 0; q < kBlk; ++q) vj[q] = xj[q][d];
#pragma unroll
          for (int a = 0; a < kBlk; ++a) {
            const float vi = xi[a][d];
#pragma unroll
            for (int q = 0; q < kBlk; ++q)
              acc[a][q] = fmaf(vi, vj[q], acc[a][q]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
        const int i = kBlk * I + a;
        if (i >= F) break;
        T* row = dst + i * (i - 1) / 2;
#pragma unroll
        for (int q = 0; q < kBlk; ++q) {
          const int j = kBlk * J + q;
          if (j < i) {
            if constexpr (kBf16) row[j] = __float2bfloat16_rn(acc[a][q]);
            else row[j] = acc[a][q];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float4 fma4(float c, float4 v, float4 acc) {
  return make_float4(fmaf(c, v.x, acc.x), fmaf(c, v.y, acc.y),
                     fmaf(c, v.z, acc.z), fmaf(c, v.w, acc.w));
}

// Floats of one f32 stage of the ring: the feats tile (F, D), then the
// dOut row (P), each rounded up to a multiple of 4 floats.
__host__ __device__ __forceinline__ int bwd_stage_floats(int F, int D) {
  return round4(F * D) + round4(F * (F - 1) / 2);
}
// Bytes of one bf16 stage: the sample's raw feats (rounded up to 16
// bytes), then the 4-byte words holding its dOut row, its first element
// at half word 0 or 1 (at most P + 3 half words, rounded up to 8).
__host__ __device__ __forceinline__ int bwd_raw_bytes(int F, int D) {
  return (2 * F * D + 15) & ~15;
}
__host__ __device__ __forceinline__ int bwd_stage_bytes(int F, int D,
                                                        bool bf16) {
  if (!bf16) return 4 * bwd_stage_floats(F, D);
  return bwd_raw_bytes(F, D) + 2 * ((F * (F - 1) / 2 + 3 + 7) & ~7);
}

// Shared memory of a backward CTA: two stages and the coefficients
// (F, 8 x warps) in f32. Mirrored by dot_interact.py's `bwd_smem`.
size_t bwd_smem(int F, int D, int warps, bool bf16) {
  return 2 * static_cast<size_t>(bwd_stage_bytes(F, D, bf16)) +
         sizeof(float) * static_cast<size_t>(F) * kBwdSlots * warps;
}

__device__ __forceinline__ float4 widen4(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

__device__ __forceinline__ uint2 narrow4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

// One CTA of ceil(F / 7) warps per launch slot, walking samples
// blockIdx.x, blockIdx.x + gridDim.x, ...; see the header. T the element
// type of dOut, feats and dFeats; kVec float4 math (D % 4 == 0); kCopy
// bytes a cp.async of the feats (f32: 16 with kVec, else 4; bf16: 16, 4,
// or 0 for loads thread by thread).
template <typename T, bool kVec, int kCopy>
__global__ void __launch_bounds__(kBwdMaxThreads)
dot_interact_bwd_kernel(const T* __restrict__ d_out,
                        const T* __restrict__ feats,
                        T* __restrict__ d_feats, int64_t B, int F, int D,
                        int P) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float sm[];
  const int stage_bytes = bwd_stage_bytes(F, D, kBf16);
  const int xn = F * D;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const int ldc = kBwdSlots * n_warps;
  unsigned char* smb = reinterpret_cast<unsigned char*>(sm);
  float* cs = reinterpret_cast<float*>(smb + 2 * stage_bytes);   // (F, ldc)

  // stage `st` <- sample b's feats tile and dOut row, one commit group
  auto issue = [&](int64_t b, int st) {
    unsigned char* stage = smb + st * stage_bytes;
    if constexpr (!kBf16) {
      float* xs = reinterpret_cast<float*>(stage);
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
    } else {
      const unsigned char* x =
          reinterpret_cast<const unsigned char*>(feats + b * xn);
      if constexpr (kCopy == 0) {
        unsigned short* raw = reinterpret_cast<unsigned short*>(stage);
        const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
        for (int t = tid; t < xn; t += n_threads) raw[t] = __ldg(xh + t);
      } else {
        for (int k = kCopy * tid; k < 2 * xn; k += kCopy * n_threads)
          cp_async<kCopy>(stage + k, x + k);
      }
      // the 4-byte words [w0, w1) of dOut holding row b, row b's first
      // element at half word (b P) % 2 of the first; a last word that
      // would run past the tensor's end (B P odd) is not copied, and its
      // one element of dOut is loaded alone
      unsigned* gw = reinterpret_cast<unsigned*>(stage + bwd_raw_bytes(F, D));
      const unsigned* dw = reinterpret_cast<const unsigned*>(d_out);
      const int64_t w0 = (b * P) >> 1;
      const int64_t full = (B * P) >> 1;
      int64_t w1 = ((b + 1) * P + 1) >> 1;
      if (w1 > full) {
        if (tid == 0) {
          reinterpret_cast<unsigned short*>(gw)[2 * (full - w0)] =
              __ldg(reinterpret_cast<const unsigned short*>(d_out) +
                    B * P - 1);
        }
        w1 = full;
      }
      for (int64_t w = w0 + tid; w < w1; w += n_threads)
        cp_async<4>(gw + (w - w0), dw + w);
    }
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
    const unsigned char* stage = smb + st * stage_bytes;
    const float* xs = reinterpret_cast<const float*>(stage);
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(stage);
    // dOut's row: f32 after the tile, or bf16 half words at its offset
    const float* gs = xs + round4(xn);
    const unsigned short* gh =
        reinterpret_cast<const unsigned short*>(stage + bwd_raw_bytes(F, D)) +
        ((b * P) & 1);
    for (int k = warp; k < F; k += n_warps) {
      for (int slot = lane; slot < ldc; slot += 32) {
        const int r = slot & (kBwdSlots - 1);
        const int i = (slot / kBwdSlots) * kBwdRows + r;
        float v = 0.f;
        if (r < kBwdRows && i < F && i != k) {
          const int p = i > k ? i * (i - 1) / 2 + k : k * (k - 1) / 2 + i;
          if constexpr (kBf16) {
            v = __uint_as_float(static_cast<unsigned>(gh[p]) << 16);
          } else {
            v = gs[p];
          }
        }
        cs[k * ldc + slot] = v;
      }
    }
    __syncthreads();
    const float* crow = cs + warp * kBwdSlots;
    T* dst = d_feats + b * xn;
    const int i0 = warp * kBwdRows;
    if (kVec) {
      for (int col = lane; col < D / 4; col += 32) {
        float4 acc[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r)
          acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int k = 0; k < F; ++k) {
          float4 v;
          if constexpr (kBf16) {
            v = widen4(*reinterpret_cast<const uint2*>(xh + k * D + 4 * col));
          } else {
            v = ld4(xs + k * D + 4 * col);
          }
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
          if (i0 + r < F) {
            if constexpr (kBf16) {
              reinterpret_cast<uint2*>(dst + (i0 + r) * D)[col] =
                  narrow4(acc[r]);
            } else {
              reinterpret_cast<float4*>(dst + (i0 + r) * D)[col] = acc[r];
            }
          }
        }
      }
    } else {
      for (int col = lane; col < D; col += 32) {
        float acc[kBwdRows];
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int k = 0; k < F; ++k) {
          float v;
          if constexpr (kBf16) {
            v = __uint_as_float(static_cast<unsigned>(xh[k * D + col]) << 16);
          } else {
            v = xs[k * D + col];
          }
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
          if (i0 + r < F) {
            if constexpr (kBf16) {
              dst[(i0 + r) * D + col] = __float2bfloat16_rn(acc[r]);
            } else {
              dst[(i0 + r) * D + col] = acc[r];
            }
          }
        }
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

bool aligned16(const void* p) { return aligned(p, 16); }

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched).
//
// The forward launches the host plan (dot_interact.py, `fwd_plan`): feats
// and out f32 (`bf16` 0) or bf16 (1); `copy` bytes a cp.async (16: D % 4
// == 0 for f32, F D % 8 == 0 for bf16, feats 16-byte aligned; 4: f32, or
// bf16 with F D even and feats 4-byte aligned; 0: bf16 loaded lane by
// lane); `ctas` CTAs of `warps` persistent warps with `smem` bytes of
// shared memory each. A plan that does not fit the call returns
// cudaErrorInvalidValue without launching.
extern "C" int dot_interact_fwd(const void* feats, void* out, int64_t B,
                                int32_t F, int32_t D, int32_t bf16,
                                int32_t copy, int32_t warps, int32_t ctas,
                                int64_t smem, void* stream) {
  if (B == 0 || F < 2) return 0;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const bool copy_ok =
      copy == 16 ? fd % (bf16 ? 8 : 4) == 0 && D % (bf16 ? 1 : 4) == 0 &&
                       aligned(feats, 16)
      : copy == 4 ? !bf16 || (fd % 2 == 0 && aligned(feats, 4))
      : copy == 0 && bf16;
  if (!copy_ok || D < 1 || warps < 1 || warps > kFwdMaxWarps || ctas < 1 ||
      smem < static_cast<int64_t>(warps) * fwd_warp_smem(F, D, bf16) ||
      smem > kMaxOptInSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = F * (F - 1) / 2;
  const bool vec = D % 4 == 0;
  void (*kernel)(const float*, float*, int64_t, int, int, int) = nullptr;
  void (*kernel16)(const __nv_bfloat16*, __nv_bfloat16*, int64_t, int, int,
                   int) = nullptr;
  if (!bf16) {
    kernel = copy == 16 ? dot_interact_fwd_kernel<float, true, 16>
             : vec      ? dot_interact_fwd_kernel<float, true, 4>
                        : dot_interact_fwd_kernel<float, false, 4>;
  } else if (vec) {
    kernel16 = copy == 16 ? dot_interact_fwd_kernel<__nv_bfloat16, true, 16>
               : copy == 4 ? dot_interact_fwd_kernel<__nv_bfloat16, true, 4>
                           : dot_interact_fwd_kernel<__nv_bfloat16, true, 0>;
  } else {
    kernel16 = copy == 16 ? dot_interact_fwd_kernel<__nv_bfloat16, false, 16>
               : copy == 4 ? dot_interact_fwd_kernel<__nv_bfloat16, false, 4>
                           : dot_interact_fwd_kernel<__nv_bfloat16, false, 0>;
  }
  const void* fn = bf16 ? reinterpret_cast<const void*>(kernel16)
                        : reinterpret_cast<const void*>(kernel);
  if (smem > kMaxSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    kernel16<<<ctas, 32 * warps, static_cast<size_t>(smem), s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<__nv_bfloat16*>(out), B, F, D, P);
  } else {
    kernel<<<ctas, 32 * warps, static_cast<size_t>(smem), s>>>(
        static_cast<const float*>(feats), static_cast<float*>(out), B, F, D,
        P);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward launches the host plan (dot_interact.py, `bwd_plan`):
// dOut, feats and dFeats f32 (`bf16` 0) or bf16 (1); `ctas` persistent
// CTAs of `warps` warps with `smem` bytes of shared memory each; `vec` 1
// for float4 math (D % 4 == 0, feats and d_feats 16-byte aligned for f32,
// d_feats 8-byte aligned for bf16) else 0; `copy` bytes a cp.async of the
// feats (f32: 16 with vec, else 4; bf16: 16 with F D % 8 == 0 and feats
// 16-byte aligned, 4 with F D even and feats 4-byte aligned, or 0); a
// bf16 dOut 4-byte aligned. A plan that does not fit the call (too few
// warps for F, too little shared memory, more than 227 KB of it) returns
// cudaErrorInvalidValue without launching.
extern "C" int dot_interact_bwd(const void* d_out, const void* feats,
                                void* d_feats, int64_t B, int32_t F,
                                int32_t D, int32_t bf16, int32_t copy,
                                int32_t vec, int32_t warps, int32_t ctas,
                                int64_t smem, void* stream) {
  if (B == 0 || F < 1) return 0;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const bool copy_ok =
      bf16 ? (copy == 16 ? fd % 8 == 0 && aligned16(feats)
              : copy == 4 ? fd % 2 == 0 && aligned(feats, 4)
                          : copy == 0) &&
                 aligned(d_out, 4) && (!vec || aligned(d_feats, 8))
           : copy == (vec ? 16 : 4) &&
                 (!vec || (aligned16(feats) && aligned16(d_feats)));
  if (warps < 1 || warps * 32 > kBwdMaxThreads || warps * kBwdRows < F ||
      ctas < 1 || ctas > B ||
      smem < static_cast<int64_t>(bwd_smem(F, D, warps, bf16)) ||
      smem > kMaxOptInSharedBytes || (vec && D % 4 != 0) || !copy_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = F * (F - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, const float*, float*, int64_t, int, int,
                 int) = nullptr;
  void (*kernel16)(const __nv_bfloat16*, const __nv_bfloat16*,
                   __nv_bfloat16*, int64_t, int, int, int) = nullptr;
  if (!bf16) {
    kernel = vec ? dot_interact_bwd_kernel<float, true, 16>
                 : dot_interact_bwd_kernel<float, false, 4>;
  } else if (vec) {
    kernel16 = copy == 16 ? dot_interact_bwd_kernel<__nv_bfloat16, true, 16>
               : copy == 4 ? dot_interact_bwd_kernel<__nv_bfloat16, true, 4>
                           : dot_interact_bwd_kernel<__nv_bfloat16, true, 0>;
  } else {
    kernel16 = copy == 16 ? dot_interact_bwd_kernel<__nv_bfloat16, false, 16>
               : copy == 4 ? dot_interact_bwd_kernel<__nv_bfloat16, false, 4>
                           : dot_interact_bwd_kernel<__nv_bfloat16, false, 0>;
  }
  const void* fn = bf16 ? reinterpret_cast<const void*>(kernel16)
                        : reinterpret_cast<const void*>(kernel);
  if (smem > kMaxSharedBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (bf16) {
    kernel16<<<ctas, 32 * warps, static_cast<size_t>(smem), s>>>(
        static_cast<const __nv_bfloat16*>(d_out),
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<__nv_bfloat16*>(d_feats), B, F, D, P);
  } else {
    kernel<<<ctas, 32 * warps, static_cast<size_t>(smem), s>>>(
        static_cast<const float*>(d_out), static_cast<const float*>(feats),
        static_cast<float*>(d_feats), B, F, D, P);
  }
  return static_cast<int>(cudaGetLastError());
}
