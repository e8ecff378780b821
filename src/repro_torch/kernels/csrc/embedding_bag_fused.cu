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
// Layout: tables (F, V, D) f32 or bf16 (as the TPU kernel takes them),
// ids (B, F, bag) int32, out (B, F, D) f32, the same as
// embedding_bag_fwd. Every offset is 64-bit. A bf16 table is loaded as
// bf16 and widened to f32 in registers (exact): one template on the
// element type.
//
// Bound on this card: bytes. The path that fires here is wide-deep's wide
// arm, D = 1: the (40, 2^20) wide table viewed as (F, V, 1), 4 MiB a
// feature in f32, bag 4. Its bound counts 4 bytes a distinct row, but HBM
// and L2 move 32-byte sectors: the gathers touch 4.5 M of the 5.2 M
// sectors of the 168 MB table, and with the ids and the output that is a
// bound of 0.059 ms, against 0.027 by rows (chip_smoke.py prints both).
// Over the same ids the gathers alone, with no place arithmetic, take
// 0.120 ms in this kernel's walk order and 0.072 sorted (kernel_probes.py,
// PERF.md): the random order of the sectors is most of the cost, and
// sorting the 10.5 M ids takes 0.66 ms, more than the kernel.
//
// The design, launched from a host plan (embedding_bag.py, `fused_plan`):
//
// * Threads per row: `lanes` threads share one output row, each taking
//   every `lanes`-th load of it; a load is 16 bytes where D and the
//   pointers allow it (4 floats, 8 bf16), else 4 bytes of bf16, else one
//   element; `lanes` is the power of two covering the row's loads, at
//   most 32. At D = 1 that is one thread a row, 256 rows a block. Two or
//   four rows a thread (more gathers in flight a thread) measured slower
//   (kernel_probes.py, PERF.md).
// * The bag: every thread loads its bag's ids, then all `bag` table
//   elements, into registers before it adds (the loops are unrolled to a
//   compile-time bound, 4 for bags of up to 4 ids and 16 above, and
//   predicated on `bag`), so the bag's gathers are in flight together.
//   The sum runs j ascending from 0.0f and "mean" divides by `bag`: the
//   f32 result is bit-equal to embedding_bag_fwd and to the plain PyTorch
//   version.
// * Order: the threads walk the output in groups of features: within a
//   group, row after row b, and in each row the group's features (the
//   last group holds what is left). The plan sizes a group to the
//   features whose tables fit 16 MiB: 4 f32 tables of 4 MiB or 8 bf16 ones
//   of 2 MiB at the wide arm (of 2, 4, 8 and 16 features these were the
//   fastest). The blocks in flight read one or two groups' tables, which
//   stay in the 50 MB L2: the TPU kernel's resident table on this card.
//   A group of 1 is a feature-major walk, whose neighbouring threads read
//   ids and write outputs far apart; a group of F is the memory order,
//   with every table live at once.
// * L2 policy: the gathers of 4 and 2 bytes (D of 1 or 2) carry an
//   evict-last cache policy, the id stream and the output stream are read
//   and written evict-first, so that the streams pass through L2 without
//   pushing the live group's tables out (about 1% at f32, 3% at bf16).
// * Index arithmetic for the walk in 32 bits: the C entry refuses
//   (cudaErrorInvalidValue) a launch of more than 2^31 - 1 threads or
//   places; the largest the models give is 65536 * 40 = 2.6e6 places.
//   Table, id and output offsets are 64-bit.
//
// The two limits, re-derived for this card. 8 MiB of table is a sixth of
// the 50 MB L2: with the walk in groups of 16 MiB, 32 MiB of tables at
// most (two groups) are live at once, the rest of L2 holding ids and
// output on their way through. 16 bounds the registers: at D = 1 a thread
// keeps 16 ids and 16 floats. Above either, the row-DMA kernel is used;
// the results are bit-equal either way, so a limit moves only time.
//
// An id outside [0, V) reads nothing and poisons its output row with NaN
// (the fill semantics of jnp.take), as in embedding_bag_fwd.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBag = 16;

__device__ __forceinline__ bool valid_id(int32_t id, int64_t V) {
  return id >= 0 && static_cast<int64_t>(id) < V;
}

// N elements of T at p (aligned to their size), widened to f32 in
// registers: f32 as it is, bf16 by its 16 bits moved to the top of an f32
// (exact). One load of N * sizeof(T) bytes (2, 4, 8 or 16).
template <int kBytes> struct Bits;
template <> struct Bits<2> { using T = unsigned short; };
template <> struct Bits<4> { using T = unsigned int; };
template <> struct Bits<8> { using T = uint2; };
template <> struct Bits<16> { using T = uint4; };

// A gather of 4 or 2 bytes under an L2 evict-last policy: the live
// group's tables stay in L2 while the id and output streams pass through
// it evict-first (kernel_probes.py measured both, PERF.md). Wider loads
// (D > 2) are plain.
template <typename R>
__device__ __forceinline__ R ld_keep(const R* p) {
  if constexpr (sizeof(R) == 4) {
    uint64_t pol;
    unsigned v;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
    asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(v) : "l"(p), "l"(pol));
    return v;
  } else if constexpr (sizeof(R) == 2) {
    uint64_t pol;
    unsigned short v;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
    asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
        : "=h"(v) : "l"(p), "l"(pol));
    return v;
  } else {
    return __ldg(p);
  }
}

template <typename T, int N>
__device__ __forceinline__ void gather_f32(const T* p, float (&v)[N]) {
  using R = typename Bits<N * sizeof(T)>::T;
  if constexpr (sizeof(T) == 4) {
    union { R r; float e[N]; } u;
    u.r = ld_keep(reinterpret_cast<const R*>(p));
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = u.e[i];
  } else {
    union { R r; unsigned short e[N]; } u;
    u.r = ld_keep(reinterpret_cast<const R*>(p));
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __bfloat162float(__ushort_as_bfloat16(u.e[i]));
  }
}

// the id stream, each byte read once (evict-first)
__device__ __forceinline__ int4 ld_ids4(const int32_t* p) {
  return __ldcs(reinterpret_cast<const int4*>(p));
}
__device__ __forceinline__ int32_t ld_id(const int32_t* p) {
  return __ldcs(p);
}

// the output stream, each byte written once (evict-first): N f32 values
// to p (aligned to 4 N bytes, or 16 for N = 8)
template <int N>
__device__ __forceinline__ void st_out(float* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    __stcs(p, v[0]);
  } else if constexpr (N == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

// The output row (b, f) at place `slot` of the walk in feature groups of
// `group` features (the last group holds the F % group features left, if
// any): group after group, in each group row b after row b, in each row
// the group's features.
__device__ __forceinline__ void place(uint32_t slot, uint32_t B, uint32_t F,
                                      uint32_t group, int64_t* b,
                                      int64_t* f) {
  const uint32_t full = F / group;
  const uint32_t span = B * group;
  uint32_t g = slot / span;
  uint32_t size = group;
  if (g >= full) {
    g = full;
    size = F - full * group;
  }
  const uint32_t rem = slot - g * span;
  const uint32_t bb = rem / size;
  *b = static_cast<int64_t>(bb);
  *f = static_cast<int64_t>(g * group + (rem - bb * size));
}

// T the tables' element type, VEC elements a load, kUnroll the bag's
// unroll bound (4 or 16). Thread t takes the `lanes`-th part of the row
// at place t >> lanes_log2 of the walk.
template <typename T, int VEC, int kUnroll>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fused_fwd_kernel(const T* __restrict__ tables,
                               const int32_t* __restrict__ ids,
                               float* __restrict__ out, int64_t B, int64_t F,
                               int64_t V, int64_t D, int bag, int mean,
                               int lanes_log2, int group) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t slot = t >> lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  if (slot >= B * F) return;
  int64_t b, f;
  place(static_cast<uint32_t>(slot), static_cast<uint32_t>(B),
        static_cast<uint32_t>(F), static_cast<uint32_t>(group), &b, &f);
  const int64_t row = b * F + f;
  const T* table = tables + f * V * D;
  const int32_t* row_ids = ids + row * bag;
  int32_t id[kUnroll];
  if (kUnroll == 4 && bag == 4 &&
      (reinterpret_cast<uintptr_t>(ids) & 15u) == 0) {
    const int4 v = ld_ids4(row_ids);
    id[0] = v.x;
    id[1] = v.y;
    id[2] = v.z;
    id[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (j < bag) id[j] = ld_id(row_ids + j);
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  const float n = static_cast<float>(bag);
  for (int64_t c = lane; c < D / VEC; c += lanes) {
    // the whole bag in flight before the adds
    float x[kUnroll][VEC];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (j >= bag) continue;
      if (valid_id(id[j], V)) {
        gather_f32<T, VEC>(table + static_cast<int64_t>(id[j]) * D + c * VEC,
                           x[j]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) x[j][k] = nan;
      }
    }
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (j >= bag) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += x[j][k];
    }
    if (mean) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] /= n;
    }
    st_out<VEC>(out + row * D + c * VEC, acc);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the bag's unroll bound: 4 for bags of up to 4 ids, else 16
template <typename T, int VEC>
void launch(unsigned blocks, cudaStream_t s, const void* tables,
            const int32_t* ids, float* out, int64_t B, int64_t F, int64_t V,
            int64_t D, int bag, int mean, int l2, int group) {
  const T* t = static_cast<const T*>(tables);
  if (bag <= 4) {
    embedding_bag_fused_fwd_kernel<T, VEC, 4><<<blocks, kThreads, 0, s>>>(
        t, ids, out, B, F, V, D, bag, mean, l2, group);
  } else {
    embedding_bag_fused_fwd_kernel<T, VEC, kMaxBag>
        <<<blocks, kThreads, 0, s>>>(t, ids, out, B, F, V, D, bag, mean, l2,
                                     group);
  }
}

}  // namespace

// C interface, loaded with ctypes. Launches the host plan
// (embedding_bag.py, `fused_plan`) on `stream` and returns
// cudaGetLastError() of the launch (0 = launched): tables f32 (`bf16` 0)
// or bf16 (1), `vec` elements a load (f32: 4 or 1; bf16: 8, 2 or 1; D %
// vec == 0, tables and out aligned to the load and the store),
// 2^lanes_log2 threads a row, feature groups of `group`, `blocks` blocks
// of 256 threads. A plan that does not fit the call, a bag outside [1,
// 16], or a walk of more than 2^31 - 1 threads or places returns
// cudaErrorInvalidValue without launching.
extern "C" int embedding_bag_fused_fwd(const void* tables, const int32_t* ids,
                                       float* out, int64_t B, int64_t F,
                                       int64_t V, int64_t D, int32_t bag,
                                       int32_t mean, int32_t bf16,
                                       int32_t vec, int32_t lanes_log2,
                                       int32_t group, int64_t blocks,
                                       void* stream) {
  const int elem = bf16 ? 2 : 4;
  const bool vec_ok =
      bf16 ? (vec == 8 || vec == 2 || vec == 1) : (vec == 4 || vec == 1);
  if (bag < 1 || bag > kMaxBag || !vec_ok || lanes_log2 < 0 ||
      lanes_log2 > 5 || group < 1 || blocks < 0 || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * F == 0 || D == 0) return 0;
  if (D % vec != 0 || !aligned(tables, vec * elem) ||
      !aligned(out, vec == 8 ? 16 : 4 * vec) || B * F > INT32_MAX ||
      B * F > (int64_t{INT32_MAX} >> lanes_log2) ||
      blocks * kThreads < (B * F << lanes_log2))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED(T_, V_)                                                        \
  if (vec == V_)                                                             \
    launch<T_, V_>(grid, s, tables, ids, out, B, F, V, D, bag, mean,         \
                   lanes_log2, group);
  if (bf16) {
    FUSED(__nv_bfloat16, 8) FUSED(__nv_bfloat16, 2) FUSED(__nv_bfloat16, 1)
  } else {
    FUSED(float, 4) FUSED(float, 1)
  }
#undef FUSED
  return static_cast<int>(cudaGetLastError());
}
