// Fused-bag embedding forward for Hopper (sm_90a): one thread (or a few)
// per output row, the whole bag in flight, the blocks walking the output
// a few features at a time so that the tables being read stay in L2.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (`embedding_bag_fused`, pallas_call at :135). That kernel binds one
// whole (V, D) table as a single VMEM-resident block and lets each grid
// step (one output row) gather and sum its bag from it, j ascending in
// f32. It runs only when the table is at most 8 MiB and the bag at most
// 16 (`_FUSED_MAX_TABLE_BYTES`, `_FUSED_MAX_BAG`, :86-88); otherwise the
// caller takes the row-DMA kernel (`embedding_bag`, ported in
// embedding_bag.cu). The dispatch lives in repro_torch/kernels/ops.py
// (`fused_fires`); this kernel is the resident-table branch.
//
// Layout: tables (F, V, D) f32, ids (B, F, bag) int32, out (B, F, D) f32,
// the same as embedding_bag_fwd. Every offset is 64-bit.
//
// Bound on this card: bytes. Each output element is `bag` loads and adds.
// The path that fires here is wide-deep's wide arm, D = 1: the
// (40, 2^20) f32 wide table viewed as (F, V, 1), 4 MiB a feature, bag 4.
// embedding_bag_fwd gives each (b, f) row a warp, which at D = 1 leaves
// 31 of 32 lanes idle. The design here:
//
// * Threads per row: `lanes` threads share one output row, each taking
//   every `lanes`-th float4 (or float, when D is not a multiple of 4 or
//   a pointer is not 16-byte aligned) of it; `lanes` is the power of two
//   covering the row's vectors, at most 32. At D = 1 that is one thread
//   a row, 256 rows a block.
// * The bag: every thread loads its bag's ids, then all `bag` table
//   elements, into registers before it adds (the loops are unrolled to a
//   compile-time bound, 4 for bags of up to 4 ids and 16 above, and
//   predicated on `bag`), so the bag's gathers are in flight together.
//   The smaller bound keeps a thread's registers low for the common
//   bags (wide-deep's 4), so more blocks fit an SM and more rows' loads
//   are in flight. The sum runs j ascending from 0.0f and "mean" divides
//   by `bag`: the f32 result is bit-equal to embedding_bag_fwd and to the
//   plain PyTorch version.
// * Order: the threads walk the output in groups of kGroup = 4
//   consecutive features: within a group, row after row b, and in each
//   row the group's 4 features (the last group holds the F % 4 features
//   left, if any). The blocks in flight at once then read the tables of
//   one or two groups only (4 x 4 MiB at the wide arm), and those stay
//   in the 50 MB L2: this is the TPU kernel's resident table on this
//   card. A group of 1 is a pure feature-major walk, whose neighbouring
//   threads read their bags F * bag * 4 bytes apart (640 B at
//   wide-deep) and write their outputs F * D * 4 bytes apart, half a
//   sector or less of each used; a group of F is the memory order
//   (batch-major), with ids and outputs contiguous but gathers spread
//   over all F tables (168 MB at the wide arm, over L2). In between, a
//   warp reads 4 * bag * 4 contiguous bytes of ids a row and writes
//   4 * D * 4 of output, while 8 tables at most are live. 4 was the
//   fastest of groups of 1, 2, 4, 8, 16 and 40 on the H100 (PERF.md).
//   Bags of 4 aligned ids are read as one int4 a thread.
// * Index arithmetic for the walk in 32 bits: the C entry refuses
//   (cudaErrorInvalidValue) a launch of more than 2^31 - 1 threads,
//   B * F * lanes; the largest the models give is 65536 * 40 * 8 =
//   2.1e7. Table, id and output offsets are 64-bit.

// What is left at the wide arm is the gathers themselves: 10.5 M random
// 4-byte loads, each a 32-byte sector fetched from L2 (or HBM on first
// touch). Prefetching the next group's tables into L2 in whole lines
// made it slower, not faster (PERF.md): the sectors' L2 traffic, not
// HBM, is what the kernel waits on.
//
// The two limits, re-derived for this card. 8 MiB of table is a sixth of
// the 50 MB L2: with the walk in groups of 4 features, 32 MiB of tables
// at most (two groups) are live at once, the rest of L2 holding ids and
// output on their way through. 16 bounds the registers: at D = 1 a
// thread keeps 16 ids and 16 floats, and at the widest vector path 16
// float4s (64 registers). Above either, the row-DMA kernel is used; the
// results are bit-equal either way, so a limit moves only time.
//
// An id outside [0, V) reads nothing and poisons its output row with NaN
// (the fill semantics of jnp.take), as in embedding_bag_fwd.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBag = 16;
constexpr uint32_t kGroup = 4;

__device__ __forceinline__ bool valid_id(int32_t id, int64_t V) {
  return id >= 0 && static_cast<int64_t>(id) < V;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The output row (b, f) at place `slot` of the walk in feature groups of
// kGroup (the last group holds the F % kGroup features left, if any).
__device__ __forceinline__ void place(uint32_t slot, uint32_t B, uint32_t F,
                                      int64_t* b, int64_t* f) {
  const uint32_t full = F / kGroup;
  const uint32_t span = B * kGroup;
  uint32_t g = slot / span;
  uint32_t size = kGroup;
  if (g >= full) {
    g = full;
    size = F - full * kGroup;
  }
  const uint32_t rem = slot - g * span;
  const uint32_t bb = rem / size;
  *b = static_cast<int64_t>(bb);
  *f = static_cast<int64_t>(g * kGroup + (rem - bb * size));
}

template <bool kVec, int kUnroll>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fused_fwd_kernel(const float* __restrict__ tables,
                               const int32_t* __restrict__ ids,
                               float* __restrict__ out, int64_t B, int64_t F,
                               int64_t V, int64_t D, int bag, int mean,
                               int lanes_log2) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t slot = t >> lanes_log2;      // the row's place in the walk
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  if (slot >= B * F) return;
  int64_t b, f;
  place(static_cast<uint32_t>(slot), static_cast<uint32_t>(B),
        static_cast<uint32_t>(F), &b, &f);
  const int64_t row = b * F + f;
  const int32_t* row_ids = ids + row * bag;
  const float* table = tables + f * V * D;
  float* dst = out + row * D;

  int32_t id[kUnroll];
  if (kUnroll == 4 && bag == 4 &&
      (reinterpret_cast<uintptr_t>(ids) & 15u) == 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row_ids));
    id[0] = v.x;
    id[1] = v.y;
    id[2] = v.z;
    id[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (j < bag) id[j] = __ldg(row_ids + j);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  const float n = static_cast<float>(bag);
  if (kVec) {
    const int64_t d4 = D / 4;
    for (int64_t c = lane; c < d4; c += lanes) {
      float4 r[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < bag) {
          r[j] = valid_id(id[j], V)
                     ? __ldg(reinterpret_cast<const float4*>(
                                 table + static_cast<int64_t>(id[j]) * D) +
                             c)
                     : make_float4(nan, nan, nan, nan);
        }
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < bag) acc = add4(acc, r[j]);
      }
      if (mean) {
        acc.x /= n;
        acc.y /= n;
        acc.z /= n;
        acc.w /= n;
      }
      reinterpret_cast<float4*>(dst)[c] = acc;
    }
  } else {
    for (int64_t d = lane; d < D; d += lanes) {
      float r[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < bag) {
          r[j] = valid_id(id[j], V)
                     ? __ldg(table + static_cast<int64_t>(id[j]) * D + d)
                     : nan;
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < bag) acc += r[j];
      }
      if (mean) acc /= n;
      dst[d] = acc;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int lanes_log2_for(int64_t vectors) {
  int l = 0;
  while (l < 5 && (int64_t{1} << l) < vectors) ++l;
  return l;
}

template <bool kVec, int kUnroll>
void launch(const float* tables, const int32_t* ids, float* out, int64_t B,
            int64_t F, int64_t V, int64_t D, int bag, int mean, int l2,
            cudaStream_t s) {
  const int64_t threads = (B * F) << l2;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  embedding_bag_fused_fwd_kernel<kVec, kUnroll><<<blocks, kThreads, 0, s>>>(
      tables, ids, out, B, F, V, D, bag, mean, l2);
}

template <bool kVec>
void launch_bag(const float* tables, const int32_t* ids, float* out,
                int64_t B, int64_t F, int64_t V, int64_t D, int bag,
                int mean, int l2, cudaStream_t s) {
  if (bag <= 4) {
    launch<kVec, 4>(tables, ids, out, B, F, V, D, bag, mean, l2, s);
  } else {
    launch<kVec, kMaxBag>(tables, ids, out, B, F, V, D, bag, mean, l2, s);
  }
}

}  // namespace

// C interface, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched); a bag outside [1, 16],
// or more than 2^31 - 1 threads (B * F rows times the threads a row),
// returns cudaErrorInvalidValue without launching.
extern "C" int embedding_bag_fused_fwd(const float* tables, const int32_t* ids,
                                       float* out, int64_t B, int64_t F,
                                       int64_t V, int64_t D, int32_t bag,
                                       int32_t mean, void* stream) {
  if (bag < 1 || bag > kMaxBag) return static_cast<int>(cudaErrorInvalidValue);
  if (B * F == 0 || D == 0) return 0;
  const bool vec = D % 4 == 0 && aligned16(tables) && aligned16(out);
  const int l2 = lanes_log2_for(vec ? D / 4 : D);
  if (B * F > (int64_t{INT32_MAX} >> l2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch_bag<true>(tables, ids, out, B, F, V, D, bag, mean, l2, s);
  } else {
    launch_bag<false>(tables, ids, out, B, F, V, D, bag, mean, l2, s);
  }
  return static_cast<int>(cudaGetLastError());
}
