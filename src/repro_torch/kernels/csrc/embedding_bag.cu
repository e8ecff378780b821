// Stacked multi-feature embedding bag for Hopper (sm_90a): the forward
// gather-and-sum and its backward scatter-add.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (`embedding_bag`, pallas_call at :75), which reduces one (V, D) table
// over a (B, bag) id block with a sequential (B, bag) grid that DMAs one
// row per step and accumulates in f32, j ascending. The TPU kernel has no
// backward; the JAX trainer differentiates the pure-jnp form of
// `embedding_bag` (src/repro/kernels/embedding_bag.py:52, a `jnp.take`),
// whose transpose is a dense (F, V, D) scatter-add. Both directions live
// here.
//
// Layout: tables (F, V, D) f32 or bf16 (the forward; the TPU kernel takes
// both and sums in f32), ids (B, F, bag) int32, out (B, F, D) f32; the
// backward reads an f32 d_out (the forward's output dtype) and writes the
// gradient in the tables' dtype, f32 or bf16, as the reference's gradient
// of a bf16 table is bf16 (the TPU kernel has no backward). F*V*D exceeds
// 2^31 at the DLRM-Criteo widths (26 x 2^20 x 128), so every offset into
// the tables is 64-bit.
//
// Forward, bound on this card by bytes. Each output row reads `bag` table
// rows and writes one, a handful of adds per byte. The sum runs j
// ascending from 0.0f and "mean" divides by `bag` (IEEE division), so the
// result is bit-equal to the plain PyTorch version (a left fold over j),
// f32 or bf16 tables alike: a bf16 is widened to f32 in registers by
// moving its 16 bits to the top of a word (exact), with shifts, no union
// (the first bf16 body's union of a uint4 and 8 shorts went through an
// 8-byte stack frame at 16-byte loads). The launch is a host plan
// (embedding_bag.py, `fwd_plan`) on one of two walks. What held the
// earlier versions (a warp a row, one 16-byte load a lane, ids loaded one
// at a time, a branch around each row load; then lane groups of scalar
// loads at D % 4 != 0) back, and what this one does about it
// (kernel_probes.py embedding and narrow; PERF.md):
//  - Idle lanes. On the lane walk a lane group of `lanes` threads covers
//    one (b, f) row, `lanes` the power of two covering its words, at most
//    32: the deep arm's D = 32 takes 8 lanes of float4 (4 rows a warp) or
//    4 of 8 bf16 (8 rows a warp), the DLRM's D = 128 32 lanes or 16. That
//    fills every lane where a row's words are a power of two, and no
//    other: DIEN's D = 18 took 32 lanes of which 18 loaded a float,
//    xDeepFM's D = 10 16 of which 10. An f32 table's words narrower than
//    16 bytes take the flat walk:
//    thread t takes word t of the flattened (rows, D / VEC) output, so
//    consecutive lanes load and store consecutive words whatever D, a
//    warp storing 256 contiguous bytes. A word's row t / (D / VEC) and
//    its feature row % F are each a wide multiply and a shift by the
//    plan's divisor (Granlund and Montgomery's, exact below 2^31; a
//    64-bit division above); the lanes of a row load its ids redundantly,
//    from L1. At D = 1 the two walks are the same, a thread a row.
//  - Narrow words. Words are 16 bytes where D and the pointers allow it;
//    for f32 tables next 8 bytes (float2) where D is even and the
//    pointers 8-byte aligned, as at D = 10 and 18: the flat walk in
//    float2s took 0.51-0.79x the time of the flat walk in floats there;
//    else one element. bf16 tables' narrower words (4 bytes, then one
//    element) keep the lane walk: no model takes them.
//  - The bag's loads were not in flight together. Each thread loads its
//    bag's ids first (an int4 where the bag is a multiple of 4 and the
//    ids 16-byte aligned), then issues every table load of the bag
//    before the first add: unrolled to 4 for bags of up to 4 ids and to
//    16 above, larger bags walked in chunks of 16, j ascending; on the
//    flat walk unrolled to 1 for bags of one (with 4, each word loaded
//    g_no_row for its 3 empty slots: 13% slower at DIEN's history). The
//    loads are branch-free: a slot past the bag, or an id outside [0, V),
//    loads a zero word (g_no_row) in place of a table row, and the
//    out-of-range id's value is a select of NaN.
//  - Rows gathered from DRAM. DIEN's history gathers 6.55 M rows of 72
//    bytes a microbatch from a 75.5 MB table, larger than the 50 MB L2.
//    A thread of the flat walk takes 2 words, t and t + S (S the grid's
//    threads), every load of both in flight before the first add: 14%
//    faster than one word there, equal at xDeepFM's tables; 4 words were
//    no faster than 2 (kFlatWords).
//  - The walk is memory order: row b F + f at place b F + f, so a warp's
//    ids and outputs are contiguous. Walking feature by feature (the
//    tables read 128 MB at a time instead of 5.4 GB) was 3-7% slower: the
//    outputs are then written 5 KB apart. The kernel's time is that of
//    its gathers alone in the same order (a probe kernel with no place
//    arithmetic and no id checks); sorted, the same gathers take about
//    0.9x (f32) and 0.75x (bf16) of it: what is left above the bound is
//    the random order of the rows.
//  - Blocks of 128 threads: about 1% faster than 256 at the DLRM's shape
//    and the deep arm's in f32, equal in bf16; 512 slower. Also measured
//    and not taken: 2 rows a lane group (its 8 loads in flight: within
//    2% either way), at least 16 blocks an SM (32 registers: up to 1%
//    faster in f32, 8-10% slower in bf16), streaming (evict-first)
//    output stores (equal at the deep arm; 1.5% faster at DIEN's
//    history, equal at xDeepFM's tables, with the ids loaded evict-first
//    too).
//
// Backward, bound by bytes on paper: d_out and ids read once, each
// distinct gradient row read and written once (the atomics'
// read-modify-write in L2). On the card what holds it is the L2's
// throughput of reductions: the adds alone, in this kernel's order and
// with nothing else read, take about nine tenths of the kernel's time at
// D = 32 and three quarters at DIEN's D = 18; a plain load-add-store of
// the same rows takes about a quarter less; TMA bulk reductions
// (cp.reduce.async.bulk, one a row) were no faster (kernel_probes.py,
// PERF.md).
// What held the earlier versions (a warp a row, lanes over D; then lane
// groups of scalar atomics at D % 4 != 0) back, and what this one does
// about it:
//  - Idle lanes at narrow rows. The lane walk covers one (b, f) row with
//    a group of `lanes` threads, the power of two covering its words, at
//    most 32: D = 128 takes 32 lanes, wide-deep's D = 32 takes 8 (4 rows
//    a warp) and its wide arm's D = 1 one thread (32 rows a warp). At D =
//    18 a row took 32 lanes of which 18 issued an atomic, at D = 10 16 of
//    which 10. An f32 gradient's words narrower than 16 bytes take the
//    flat walk, as the forward's: a thread a word of its feature group's
//    flattened d_out (2 words a thread were no faster). At D = 1 the two
//    walks are the same, a thread a row (equal times on the card).
//  - Narrow atomics. An f32 gradient takes float4 atomics where D % 4 ==
//    0 and the pointers are 16-byte aligned; else float2 atomics where D
//    is even and they are 8-byte aligned, halving DIEN's atomics from 118
//    M to 59 M a microbatch (0.72x the time of float atomics on the flat
//    walk there, 0.97x at xDeepFM's D = 10); else one column. Float4
//    atomics over the 16-byte aligned part of each row (D / 4 float4s
//    and a float2 a row, d_out read as float2s) were 5-20% slower.
//  - Atomics spread over every feature's gradient. The blocks walk the
//    rows in groups of `group` features, the group the slowest index
//    (gridDim.y), and within a group row b after row b, the group's
//    features innermost. The host plan (embedding_bag.py, `bwd_plan`)
//    sizes the group so that its gradient slices (V x D x 4 bytes each)
//    fit an L2 budget of 8 MiB: 2 features at D = 1 (4 MiB each), so the
//    4-byte atomics of the wide arm meet their 32-byte sectors in the 50
//    MB L2 instead of missing to HBM over a 168 MB gradient (groups of 1,
//    2, 4, 8 and 40 were timed; 2 was the fastest, 40 as slow as the
//    first version). At D = 32 and 128 one feature's slice exceeds L2 and
//    the group is 1: the rows one feature's batch touches stay in L2
//    while it is walked.
//  - A repeated id paid an atomic each time. Each thread compares its
//    bag's ids in registers (bags of up to 4 and 16 unrolled, larger ones
//    looped) and issues one atomic for each distinct valid id, with the
//    gradient times the id's count in the bag. The DLRM featurizer pads a
//    short list by repeating its head id, so its bags repeat ids often.
//  - Ids were loaded 4 bytes at a time: a bag of a multiple of 4 aligned
//    ids is loaded as int4s.
//  - The adds are fire-and-forget: `atomicAdd(float4*, float4)` and
//    `atomicAdd(float2*, float2)` with their results unused compile to one
//    REDG.E.ADD.F32x4 and REDG.E.ADD.F32x2 on sm_90a (a float to
//    REDG.E.ADD.F32), no ATOM waiting on a return. Also measured and not
//    taken at the narrow rows: d_out and the ids loaded evict-first (2%
//    faster at DIEN's D = 18, 24% slower at xDeepFM's D = 10).
// The zero fill is the gradient's allocation's, not this kernel's.
// Atomic order varies between runs, and a repeated id adds count x g
// where the plain version adds g count times, so the result matches the
// plain version to rounding (chip_smoke.py: rtol 1e-5, atol 1e-6).
//
// A bf16 gradient (a bf16 table's; the DLRM-Criteo reference's tables are
// bf16) keeps the lane walk and the plan above and changes only the adds:
// the f32 addend (count x g, divided by the bag for "mean") is rounded to
// bf16 once, and pairs of columns go to Hopper's native bf16x2 reduction
// (`red.global.add.noftz.bf16x2`, 4 of them for each 8 columns read as two
// float4s of d_out), or single columns to the bf16 one where D % 8 != 0 or
// a pointer is not 16-byte aligned. They are fire-and-forget REDs on a
// global address, as the f32 path's are: cuda_bf16.h's atomicAdd for bf16
// and bf16x2 is an `atom` on a generic address that returns the old value
// (a generic ATOM in the SASS of the first bf16 body, 20% slower at the
// DLRM-Criteo shape: kernel_probes.py scatter_bf16). The card has no
// one-column bf16 reduction: ptxas lowers it to a CAS loop, with an 8-byte
// stack frame, on a path the DLRM does not take. It halves the dense gradient
// (27.9 GB at 26 x 2^22 x 128, against 55.8 GB in f32), which is what lets
// the reference configuration train on one card. Every bf16 atomic rounds
// the row's running sum: a row that one slot of the batch touches gets
// its addend rounded once, bit-equal to the plain version (the f32 sum
// rounded once); a row touched n times is off by at most about one bf16
// ulp of its largest partial sum a touch, and in an order that changes
// between runs, as the reference's own bf16 scatter-add is.
//
// An id outside [0, V) reads nothing and poisons its output row with NaN
// (the fill semantics of jnp.take); in the backward it adds nothing.
//
// The local-rows mode (`local`, with `row0`): the tables are one rank's
// row shard (F, V, D) of row-sharded tables, rows [row0, row0 + V) of
// each feature's table (the reference's tp_multifeature_bag,
// src/repro/models/embedding.py:137-251). Each id is moved into the
// shard as it is loaded: an id in [row0, row0 + V) reads row id - row0,
// and any other id contributes 0 to the forward (not NaN: the
// reference's masked gather multiplies it by 0) and nothing to the
// scatter. A repeated id is counted only among the bag's slots that fall
// in the shard (equal ids fall in it together). Nothing else changes:
// the walks, the plans and the arithmetic are the unsharded path's, so
// a shard that holds every id is bit-equal to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kFwdThreads = 128;
// bags of up to 4 ids, and of up to 16, are unrolled to that bound;
// larger ones are walked in chunks of 16 (the forward) or slot by slot
// (the backward)
constexpr int kMaxUnrolledBag = 16;

__device__ __forceinline__ bool valid_id(int32_t id, int64_t V) {
  return id >= 0 && static_cast<int64_t>(id) < V;
}

// The host plan's divisor of the flat walk (embedding_bag.py, `divisor`):
// n / d = (n magic) >> shift for every n < 2^31 (Granlund and
// Montgomery's round-up method: magic = ceil(2^shift / d), shift = 31 +
// ceil(log2 d)), one wide multiply and a shift; magic 0 where the walk
// has indices of 2^31 or more, which take a 64-bit division.
struct Div {
  uint32_t magic;
  int shift;
};

__device__ __forceinline__ int64_t quotient(int64_t n, int64_t d, Div q) {
  if (q.magic == 0) return n / d;
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(n)) * q.magic) >> q.shift);
}

// The ids p[0, n) (at most kUnroll of them) into registers: as int4s
// where `vec4` (n a multiple of 4, p 16-byte aligned), else one by one.
template <int kUnroll>
__device__ __forceinline__ void load_ids(const int32_t* p, int n, bool vec4,
                                         int32_t (&id)[kUnroll]) {
  if (vec4) {
#pragma unroll
    for (int j = 0; j + 3 < kUnroll; j += 4) {
      if (j < n) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p + j));
        id[j] = v.x;
        id[j + 1] = v.y;
        id[j + 2] = v.z;
        id[j + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (j < n) id[j] = __ldg(p + j);
    }
  }
}

// The word one load of VEC elements of T brings: 16 bytes (4 floats, 8
// bf16), 8 bytes (2 floats), 4 bytes (2 bf16) or one element.
template <typename T, int VEC> struct Word;
template <> struct Word<float, 4> { using type = float4; };
template <> struct Word<float, 2> { using type = float2; };
template <> struct Word<float, 1> { using type = float; };
template <> struct Word<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Word<__nv_bfloat16, 2> { using type = unsigned int; };
template <> struct Word<__nv_bfloat16, 1> { using type = unsigned short; };

// A word widened to f32 in registers: a bf16 is the top half of an f32,
// so its 16 bits shifted into place are its value (exact).
__device__ __forceinline__ void widen(float4 w, float (&v)[4]) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void widen(float2 w, float (&v)[2]) {
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void widen(float w, float (&v)[1]) { v[0] = w; }
__device__ __forceinline__ void widen2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint4 w, float (&v)[8]) {
  widen2(w.x, v);
  widen2(w.y, v + 2);
  widen2(w.z, v + 4);
  widen2(w.w, v + 6);
}
__device__ __forceinline__ void widen(unsigned w, float (&v)[2]) {
  widen2(w, v);
}
__device__ __forceinline__ void widen(unsigned short w, float (&v)[1]) {
  v[0] = __uint_as_float(static_cast<unsigned>(w) << 16);
}

// The local-rows mode: ids[0, n) moved into the shard [row0, row0 + V),
// -1 for an id outside it (64-bit: id - row0 may leave int32's range).
template <int kUnroll>
__device__ __forceinline__ void shard_ids(int32_t (&id)[kUnroll], int n,
                                          int64_t row0, int64_t V) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    if (j < n) {
      const int64_t l = static_cast<int64_t>(id[j]) - row0;
      id[j] = l >= 0 && l < V ? static_cast<int32_t>(l) : -1;
    }
  }
}

// What an out-of-range id loads in place of a table row (its value is
// then replaced by NaN): any table, even an empty one, has no row to
// stand in.
__device__ __align__(16) uint4 g_no_row;

// N f32 values to p (aligned to 4 N bytes, or 16 for N = 8)
template <int N>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    *p = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// The forward's lane walk (16-byte words, and bf16's narrower ones). T is
// the tables' element type (float or __nv_bfloat16), VEC elements a load,
// kUnroll the bag's unroll bound (4 or 16). Thread t is lane t % lanes of
// the lane group of output row t / lanes (rows in memory order, (b, f) at
// b F + f), and takes the row's column words lane, lane + lanes, ... For
// each word, and each chunk of kUnroll bag slots (one chunk for a bag of
// at most kUnroll), it loads the chunk's ids, then issues all the chunk's
// table loads, then adds them, j ascending.
template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void fwd_lanes(const T* __restrict__ tables,
                                          const int32_t* __restrict__ ids,
                                          float* __restrict__ out,
                                          int64_t rows, int64_t F, int64_t V,
                                          int64_t D, int bag, int mean,
                                          int lanes_log2, int64_t row0,
                                          int local) {
  using W = typename Word<T, VEC>::type;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x;
  const int64_t row = t >> lanes_log2;
  if (row >= rows) return;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const int32_t* row_ids = ids + row * bag;
  const int64_t f =
      rows <= INT32_MAX
          ? static_cast<uint32_t>(row) % static_cast<uint32_t>(F)
          : row % F;
  const T* table = tables + f * V * D;
  float* dst = out + row * D;
  const bool ids4 =
      bag % 4 == 0 && (reinterpret_cast<uintptr_t>(ids) & 15u) == 0;
  const W* no_row = reinterpret_cast<const W*>(&g_no_row);
  // what an id outside the table adds: NaN, or 0 in the local-rows mode
  const float bad = local ? 0.f : __int_as_float(0x7fc00000);
  // a bag of at most kUnroll ids is one chunk (kUnroll 4 takes only
  // those); the column words of a row number D / VEC < 2^31
  const int chunks = kUnroll == 4 ? 1 : (bag + kUnroll - 1) / kUnroll;
  const int words = static_cast<int>(D / VEC);
  for (int c = lane; c < words; c += lanes) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int j0 = chunk * kUnroll;
      const int n = bag - j0;
      int32_t id[kUnroll];
      load_ids<kUnroll>(row_ids + j0, n, ids4, id);
      if (local) shard_ids<kUnroll>(id, n, row0, V);
      // every load of the chunk in flight before the first add: a slot
      // past the bag, or an id out of range, loads g_no_row instead of a
      // table row, and an out-of-range id's value is a select of `bad`
      W w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const bool ok = j < n && valid_id(id[j], V);
        w[j] = __ldg(ok ? reinterpret_cast<const W*>(
                              table + static_cast<int64_t>(id[j]) * D) +
                              c
                        : no_row);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n) {
          float v[VEC];
          widen(w[j], v);
          const bool ok = valid_id(id[j], V);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += ok ? v[k] : bad;
        }
      }
    }
    if (mean) {
      const float n = static_cast<float>(bag);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] /= n;
    }
    st_f32<VEC>(dst + c * VEC, acc);
  }
}

// Words a thread of the forward's flat walk (embedding_bag.py,
// FLAT_WORDS): 2 was 14-17% faster than 1 at DIEN's history and equal at
// xDeepFM's tables, 4 no faster than 2 (kernel_probes.py narrow)
constexpr int kFlatWords = 2;

// The forward's flat walk (f32 tables' 8- and 4-byte words): thread t
// takes the words t + k S (k < kFlatWords, S the grid's threads) of the
// flattened (rows, D / VEC) output, word c of row r at r (D / VEC) + c,
// the row and its feature r % F from the plan's divisors. For each chunk
// of kUnroll bag slots (kUnroll 1 or 4: one chunk; 16: chunks of 16) it
// loads every word's ids, then issues every word's table loads, then
// adds them, j ascending; a word past the output loads nothing and
// stores nothing.
template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void fwd_flat(const T* __restrict__ tables,
                                         const int32_t* __restrict__ ids,
                                         float* __restrict__ out,
                                         int64_t rows, int64_t F, int64_t V,
                                         int64_t D, int bag, int mean,
                                         Div per_row, Div per_feat,
                                         int64_t row0, int local) {
  using W = typename Word<T, VEC>::type;
  const int64_t S = static_cast<int64_t>(gridDim.x) * kFwdThreads;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kFwdThreads + threadIdx.x;
  const int words = static_cast<int>(D / VEC);
  int64_t row[kFlatWords];
  int c[kFlatWords];
  const T* table[kFlatWords];
#pragma unroll
  for (int k = 0; k < kFlatWords; ++k) {
    row[k] = quotient(t + k * S, words, per_row);
    c[k] = static_cast<int>(t + k * S - row[k] * words);
    table[k] = tables + (row[k] - quotient(row[k], F, per_feat) * F) * V * D;
  }
  if (row[0] >= rows) return;
  const bool ids4 =
      bag % 4 == 0 && (reinterpret_cast<uintptr_t>(ids) & 15u) == 0;
  const W* no_row = reinterpret_cast<const W*>(&g_no_row);
  const float bad = local ? 0.f : __int_as_float(0x7fc00000);
  const int chunks = kUnroll == 16 ? (bag + kUnroll - 1) / kUnroll : 1;
  float acc[kFlatWords][VEC];
#pragma unroll
  for (int k = 0; k < kFlatWords; ++k) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int j0 = chunk * kUnroll;
    // the chunk's slots of each word: none for a word past the output
    int n[kFlatWords];
    int32_t id[kFlatWords][kUnroll];
#pragma unroll
    for (int k = 0; k < kFlatWords; ++k) {
      n[k] = row[k] < rows ? bag - j0 : 0;
      load_ids<kUnroll>(ids + row[k] * bag + j0, n[k], ids4, id[k]);
      if (local) shard_ids<kUnroll>(id[k], n[k], row0, V);
    }
    W w[kFlatWords][kUnroll];
#pragma unroll
    for (int k = 0; k < kFlatWords; ++k) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const bool ok = j < n[k] && valid_id(id[k][j], V);
        w[k][j] = __ldg(ok ? reinterpret_cast<const W*>(
                                 table[k] +
                                 static_cast<int64_t>(id[k][j]) * D) +
                                 c[k]
                           : no_row);
      }
    }
#pragma unroll
    for (int k = 0; k < kFlatWords; ++k) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n[k]) {
          float v[VEC];
          widen(w[k][j], v);
          const bool ok = valid_id(id[k][j], V);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[k][i] += ok ? v[i] : bad;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kFlatWords; ++k) {
    if (row[k] >= rows) continue;
    if (mean) {
      const float nb = static_cast<float>(bag);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] /= nb;
    }
    st_f32<VEC>(out + row[k] * D + c[k] * VEC, acc[k]);
  }
}

// The forward: the lane walk, or the flat walk (kFlat).
template <typename T, int VEC, int kUnroll, bool kFlat>
__global__ void __launch_bounds__(kFwdThreads)
embedding_bag_fwd_kernel(const T* __restrict__ tables,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int64_t rows, int64_t F,
                         int64_t V, int64_t D, int bag, int mean,
                         int lanes_log2, Div per_row, Div per_feat,
                         int64_t row0, int local) {
  if constexpr (kFlat) {
    fwd_flat<T, VEC, kUnroll>(tables, ids, out, rows, F, V, D, bag, mean,
                              per_row, per_feat, row0, local);
  } else {
    fwd_lanes<T, VEC, kUnroll>(tables, ids, out, rows, F, V, D, bag, mean,
                               lanes_log2, row0, local);
  }
}

constexpr int kBwdThreads = 256;

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// The weight of bag slot j: how many slots of the bag name its id if j is
// the first of them and the id is valid, else 0. ids[0, n) in registers.
template <int kUnroll>
__device__ __forceinline__ void bag_weights(const int32_t (&id)[kUnroll],
                                            int n, int64_t V,
                                            float (&w)[kUnroll]) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    float c = 0.f;
    if (j < n && valid_id(id[j], V)) {
      bool first = true;
#pragma unroll
      for (int k = 0; k < j; ++k) first = first && id[k] != id[j];
      if (first) {
        c = 1.f;
#pragma unroll
        for (int k = j + 1; k < kUnroll; ++k) {
          if (k < n && id[k] == id[j]) c += 1.f;
        }
      }
    }
    w[j] = c;
  }
}

// The bits of v rounded to bf16 (to nearest even).
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One bf16x2 reduction of the pair (a, b), each rounded to bf16 once, into
// global p (4-byte aligned): a into p[0], b into p[1].
__device__ __forceinline__ void red_bf16x2(__nv_bfloat16* p, float a,
                                           float b) {
  asm volatile("red.global.add.noftz.bf16x2 [%0], %1;" ::"l"(p),
               "r"(bf16_bits(a) | (bf16_bits(b) << 16))
               : "memory");
}

// One bf16 reduction of a, rounded to bf16 once, into global p.
__device__ __forceinline__ void red_bf16(__nv_bfloat16* p, float a) {
  asm volatile("red.global.add.noftz.bf16 [%0], %1;" ::"l"(p),
               "h"(static_cast<unsigned short>(bf16_bits(a)))
               : "memory");
}

// The gradient row of (b, f), divided by the bag for "mean", scatter-added
// into the rows its bag names: lane `lane` of `lanes` takes the row's
// words lane, lane + lanes, ...; slot j adds w[j] times it. A word is
// VEC columns: a float4 (f32, VEC 4), 8 bf16 columns (bf16, VEC 8: two
// float4s of d_out, four bf16x2 atomics), a float2 (f32, VEC 2) or one
// column (VEC 1).
template <typename T, int VEC, int kUnroll>
__device__ __forceinline__ void scatter_row(const float* src, T* dst,
                                            const int32_t (&id)[kUnroll],
                                            const float (&w)[kUnroll],
                                            int64_t D, int lane, int lanes,
                                            int n, float bag, int mean) {
  constexpr bool kBf16 = sizeof(T) == 2;
  // a row that adds nothing (every id outside the table or the shard)
  // does not read d_out
  bool any = false;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) any = any || (j < n && w[j] != 0.f);
  if (!any) return;
  if constexpr (VEC == 4 && !kBf16) {
    for (int64_t c = lane; c < D / 4; c += lanes) {
      float4 g = __ldg(reinterpret_cast<const float4*>(src) + c);
      if (mean) g = make_float4(g.x / bag, g.y / bag, g.z / bag, g.w / bag);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n && w[j] != 0.f) {
          atomicAdd(reinterpret_cast<float4*>(
                        dst + static_cast<int64_t>(id[j]) * D) + c,
                    scale4(g, w[j]));
        }
      }
    }
  } else if constexpr (VEC == 8) {
    for (int64_t c = lane; c < D / 8; c += lanes) {
      float4 g0 = __ldg(reinterpret_cast<const float4*>(src) + 2 * c);
      float4 g1 = __ldg(reinterpret_cast<const float4*>(src) + 2 * c + 1);
      if (mean) {
        g0 = make_float4(g0.x / bag, g0.y / bag, g0.z / bag, g0.w / bag);
        g1 = make_float4(g1.x / bag, g1.y / bag, g1.z / bag, g1.w / bag);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n && w[j] != 0.f) {
          T* p = dst + static_cast<int64_t>(id[j]) * D + 8 * c;
          const float4 a = scale4(g0, w[j]), b = scale4(g1, w[j]);
          red_bf16x2(p, a.x, a.y);
          red_bf16x2(p + 2, a.z, a.w);
          red_bf16x2(p + 4, b.x, b.y);
          red_bf16x2(p + 6, b.z, b.w);
        }
      }
    }
  } else if constexpr (VEC == 2) {
    for (int64_t c = lane; c < D / 2; c += lanes) {
      float2 g = __ldg(reinterpret_cast<const float2*>(src) + c);
      if (mean) g = make_float2(g.x / bag, g.y / bag);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n && w[j] != 0.f) {
          atomicAdd(reinterpret_cast<float2*>(
                        dst + static_cast<int64_t>(id[j]) * D) + c,
                    make_float2(g.x * w[j], g.y * w[j]));
        }
      }
    }
  } else {
    for (int64_t d = lane; d < D; d += lanes) {
      float g = __ldg(src + d);
      if (mean) g /= bag;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (j < n && w[j] != 0.f) {
          T* p = dst + static_cast<int64_t>(id[j]) * D + d;
          if constexpr (kBf16) {
            red_bf16(p, g * w[j]);
          } else {
            atomicAdd(p, g * w[j]);
          }
        }
      }
    }
  }
}

// dOut (B, F, D) f32 scatter-added into the zeroed dense gradient (F, V,
// D) of element type T (f32 or bf16), VEC columns a word. Block (x, y)
// walks feature group y (features y * group onwards, the last group
// holding what is left) in the group's order: row b after row b, the
// group's features innermost. On the lane walk thread t of the group is
// lane t % lanes of the group's row t / lanes; on the flat walk (kFlat:
// an f32 gradient's 8- and 4-byte words) it takes word t of the group's
// flattened (rows, D / VEC) d_out: word `lane` of row t / (D / VEC),
// whose `lanes` are its D / VEC words.
// kUnroll 4 or 16 keeps a bag of at most that many ids in registers;
// kUnroll 0 takes any bag, comparing ids from memory.
template <typename T, int VEC, int kUnroll, bool kFlat>
__global__ void __launch_bounds__(kBwdThreads)
embedding_bag_bwd_kernel(const float* __restrict__ d_out,
                         const int32_t* __restrict__ ids,
                         T* __restrict__ grad, int64_t B, int64_t F,
                         int64_t V, int64_t D, int bag, int mean,
                         int lanes_log2, int64_t group, Div per_row,
                         int64_t row0, int local) {
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * group;
  const int64_t size = F - f0 < group ? F - f0 : group;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  int64_t slot;
  int lane, lanes;
  if constexpr (kFlat) {
    lanes = static_cast<int>(D / VEC);
    slot = quotient(t, lanes, per_row);
    lane = static_cast<int>(t - slot * lanes);
  } else {
    slot = t >> lanes_log2;
    lanes = 1 << lanes_log2;
    lane = static_cast<int>(t & (lanes - 1));
  }
  if (slot >= B * size) return;
  int64_t b = slot, fi = 0;
  if (size > 1) {
    if (slot <= INT32_MAX) {
      b = static_cast<uint32_t>(slot) / static_cast<uint32_t>(size);
    } else {
      b = slot / size;
    }
    fi = slot - b * size;
  }
  const int64_t f = f0 + fi;
  const int64_t row = b * F + f;
  const int32_t* row_ids = ids + row * bag;
  const float* src = d_out + row * D;
  T* dst = grad + f * V * D;
  const float bag_f = static_cast<float>(bag);
  if constexpr (kUnroll > 0) {
    int32_t id[kUnroll];
    load_ids<kUnroll>(
        row_ids, bag,
        bag % 4 == 0 && (reinterpret_cast<uintptr_t>(ids) & 15u) == 0, id);
    if (local) shard_ids<kUnroll>(id, bag, row0, V);
    float w[kUnroll];
    bag_weights<kUnroll>(id, bag, V, w);
    scatter_row<T, VEC, kUnroll>(src, dst, id, w, D, lane, lanes, bag,
                                 bag_f, mean);
  } else {
    // a bag over kMaxUnrolledBag ids: slot by slot, each id compared with
    // the bag's others in memory (L1); equal ids are equal in the shard
    for (int j = 0; j < bag; ++j) {
      const int32_t idj = __ldg(row_ids + j);
      int32_t lid[1] = {idj};
      if (local) shard_ids<1>(lid, 1, row0, V);
      if (!valid_id(lid[0], V)) continue;
      bool first = true;
      for (int k = 0; k < j && first; ++k) first = __ldg(row_ids + k) != idj;
      if (!first) continue;
      float c = 1.f;
      for (int k = j + 1; k < bag; ++k) c += __ldg(row_ids + k) == idj;
      const float w1[1] = {c};
      scatter_row<T, VEC, 1>(src, dst, lid, w1, D, lane, lanes, 1, bag_f,
                             mean);
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Whether a plan's divisor of the flat walk is exact for the quotients it
// takes: magic 0 (a 64-bit division), or a grid of at most 2^31 threads
// and (2^31 - 1) (magic d - 2^shift) < 2^shift, which makes (n magic) >>
// shift equal n / d for every n < 2^31.
bool div_ok(int64_t magic, int32_t shift, int64_t d, int64_t threads) {
  if (magic == 0) return true;
  if (magic < 0 || magic > UINT32_MAX || shift < 31 || shift > 62 ||
      d < 1 || d > INT32_MAX || threads > (int64_t{1} << 31))
    return false;
  const uint64_t m = static_cast<uint64_t>(magic) * static_cast<uint64_t>(d);
  const uint64_t p = uint64_t{1} << shift;
  return m >= p && (m - p) < (uint64_t{1} << 32) &&
         (m - p) * ((uint64_t{1} << 31) - 1) < p;
}

template <typename T, int VEC, bool kFlat>
void launch_bwd(dim3 grid, cudaStream_t s, const float* d_out,
                const int32_t* ids, void* grad_p, int64_t B, int64_t F,
                int64_t V, int64_t D, int bag, int mean, int lanes_log2,
                int64_t group, Div per_row, int64_t row0, int local) {
  T* grad = static_cast<T*>(grad_p);
  if (bag <= 4) {
    embedding_bag_bwd_kernel<T, VEC, 4, kFlat><<<grid, kBwdThreads, 0, s>>>(
        d_out, ids, grad, B, F, V, D, bag, mean, lanes_log2, group, per_row,
        row0, local);
  } else if (bag <= kMaxUnrolledBag) {
    embedding_bag_bwd_kernel<T, VEC, kMaxUnrolledBag, kFlat>
        <<<grid, kBwdThreads, 0, s>>>(d_out, ids, grad, B, F, V, D, bag,
                                      mean, lanes_log2, group, per_row, row0,
                                      local);
  } else {
    embedding_bag_bwd_kernel<T, VEC, 0, kFlat><<<grid, kBwdThreads, 0, s>>>(
        d_out, ids, grad, B, F, V, D, bag, mean, lanes_log2, group, per_row,
        row0, local);
  }
}

// the bag's unroll bound: 4 for bags of up to 4 ids, else 16; 1 for bags
// of one on the flat walk (kUnroll 4 loads g_no_row for the 3 empty slots
// of each word: 13% slower at DIEN's history, kernel_probes.py narrow)
template <typename T, int VEC, bool kFlat>
void launch_fwd(unsigned blocks, cudaStream_t s, const void* tables,
                const int32_t* ids, float* out, int64_t rows, int64_t F,
                int64_t V, int64_t D, int bag, int mean, int lanes_log2,
                Div per_row, Div per_feat, int64_t row0, int local) {
  const T* t = static_cast<const T*>(tables);
  if (kFlat && bag == 1) {
    embedding_bag_fwd_kernel<T, VEC, 1, kFlat><<<blocks, kFwdThreads, 0, s>>>(
        t, ids, out, rows, F, V, D, bag, mean, lanes_log2, per_row, per_feat,
        row0, local);
  } else if (bag <= 4) {
    embedding_bag_fwd_kernel<T, VEC, 4, kFlat><<<blocks, kFwdThreads, 0, s>>>(
        t, ids, out, rows, F, V, D, bag, mean, lanes_log2, per_row, per_feat,
        row0, local);
  } else {
    embedding_bag_fwd_kernel<T, VEC, kMaxUnrolledBag, kFlat>
        <<<blocks, kFwdThreads, 0, s>>>(t, ids, out, rows, F, V, D, bag,
                                        mean, lanes_log2, per_row, per_feat,
                                        row0, local);
  }
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of the launch (0 = launched).
//
// The forward launches the host plan (embedding_bag.py, `fwd_plan`):
// tables f32 (`bf16` 0) or bf16 (1), `vec` elements a word (f32: 4, 2 or
// 1; bf16: 8, 2 or 1; D % vec == 0, tables and out aligned to the load
// and the store); 2^lanes_log2 threads a row (the lane walk: 16-byte
// words, and bf16's narrower ones), or lanes_log2 -1 (the flat walk of an
// f32 table's 8- and 4-byte words, kFlatWords words a thread: a word's
// row and feature from the divisors
// (row_magic, row_shift) of D / vec and (feat_magic, feat_shift) of F);
// `blocks` blocks of 128 threads; its output is f32. A plan that does not
// fit the call (a grid that misses words, a divisor that is not exact)
// returns cudaErrorInvalidValue without launching. `local` 1 takes the
// local-rows mode: the tables are rows [row0, row0 + V) (row0 >= 0).
extern "C" int embedding_bag_fwd(const void* tables, const int32_t* ids,
                                 float* out, int64_t B, int64_t F, int64_t V,
                                 int64_t D, int32_t bag, int32_t mean,
                                 int32_t bf16, int32_t vec,
                                 int32_t lanes_log2, int64_t blocks,
                                 int64_t row_magic, int32_t row_shift,
                                 int64_t feat_magic, int32_t feat_shift,
                                 int64_t row0, int32_t local,
                                 void* stream) {
  const int elem = bf16 ? 2 : 4;
  const bool vec_ok = bf16 ? (vec == 8 || vec == 2 || vec == 1)
                           : (vec == 4 || vec == 2 || vec == 1);
  // the flat walk: exactly an f32 table's 8- and 4-byte words
  const bool flat = !bf16 && vec < 4;
  if (bag < 1 || !vec_ok || row0 < 0 || (local != 0 && local != 1) ||
      (!local && row0 != 0) ||
      (flat ? lanes_log2 != -1 : lanes_log2 < 0 || lanes_log2 > 5))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = B * F;
  if (rows == 0 || D == 0) return 0;
  // the words the grid takes: kFlatWords a thread on the flat walk
  const int64_t threads = blocks * kFwdThreads * (flat ? kFlatWords : 1);
  if (D % vec != 0 || !aligned(tables, vec * elem) ||
      !aligned(out, vec == 8 ? 16 : 4 * vec) || D > INT32_MAX ||
      blocks > INT32_MAX ||
      threads < (flat ? rows * (D / vec) : rows << lanes_log2) ||
      (flat && !(div_ok(row_magic, row_shift, D / vec, threads) &&
                 div_ok(feat_magic, feat_shift, F, threads))))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  const Div per_row{static_cast<uint32_t>(row_magic), row_shift};
  const Div per_feat{static_cast<uint32_t>(feat_magic), feat_shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T_, V_, FLAT_)                                                   \
  launch_fwd<T_, V_, FLAT_>(grid, s, tables, ids, out, rows, F, V, D, bag,   \
                            mean, lanes_log2, per_row, per_feat, row0, local)
  if (bf16) {
    if (vec == 8) FWD(__nv_bfloat16, 8, false);
    else if (vec == 2) FWD(__nv_bfloat16, 2, false);
    else FWD(__nv_bfloat16, 1, false);
  } else {
    if (vec == 4) FWD(float, 4, false);
    else if (vec == 2) FWD(float, 2, true);
    else FWD(float, 1, true);
  }
#undef FWD
  return static_cast<int>(cudaGetLastError());
}

// The backward launches the host plan (embedding_bag.py, `bwd_plan`):
// the gradient f32 (`bf16` 0) or bf16 (1); `vec` columns a word (f32: 4,
// float4 atomics, or 2, float2 atomics, or 1; bf16: 8, in bf16x2 atomics,
// or 1; D % vec == 0, d_out and grad aligned to the word: 16 bytes for 8
// bf16 columns); 2^lanes_log2 threads a row (the lane walk: 16-byte
// words, and a bf16 gradient's single columns), or lanes_log2 -1 (the
// flat walk of an f32 gradient's 8- and 4-byte words, a thread a word,
// its row from the divisor (row_magic, row_shift) of D / vec); feature
// groups of `group`, a grid of (blocks, groups). A plan that
// does not fit the call (a grid that misses words among them, a divisor
// that is not exact) returns cudaErrorInvalidValue without launching.
// `local` 1 takes the local-rows mode: the gradient is of rows [row0,
// row0 + V), and ids outside them add nothing.
extern "C" int embedding_bag_bwd(const float* d_out, const int32_t* ids,
                                 void* grad, int64_t B, int64_t F, int64_t V,
                                 int64_t D, int32_t bag, int32_t mean,
                                 int32_t bf16, int32_t vec,
                                 int32_t lanes_log2, int64_t group,
                                 int64_t blocks, int64_t groups,
                                 int64_t row_magic, int32_t row_shift,
                                 int64_t row0, int32_t local,
                                 void* stream) {
  if (B * F == 0 || D == 0) return 0;
  const bool vec_ok =
      bf16 ? (vec == 8 || vec == 1) : (vec == 4 || vec == 2 || vec == 1);
  // the flat walk: exactly an f32 gradient's 8- and 4-byte words
  const bool flat = !bf16 && vec < 4;
  const int64_t threads = blocks * kBwdThreads;
  const int64_t rows = B * std::min(group, F);
  const unsigned word = vec == 8 ? 16 : 4 * vec;
  if (bag < 1 || !vec_ok || row0 < 0 || (local != 0 && local != 1) ||
      (!local && row0 != 0) ||
      (flat ? lanes_log2 != -1 : lanes_log2 < 0 || lanes_log2 > 5) ||
      group < 1 || D % vec != 0 ||
      !aligned(d_out, word) || !aligned(grad, bf16 ? (vec == 8 ? 16 : 2)
                                                   : word) ||
      groups * group < F || groups > 65535 || blocks > INT32_MAX ||
      threads < (flat ? rows * (D / vec) : rows << lanes_log2) ||
      (flat && !div_ok(row_magic, row_shift, D / vec, threads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(groups));
  const Div per_row{static_cast<uint32_t>(row_magic), row_shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(T_, V_, FLAT_)                                                 \
  launch_bwd<T_, V_, FLAT_>(grid, s, d_out, ids, grad, B, F, V, D, bag,    \
                            mean, lanes_log2, group, per_row, row0, local)
  if (bf16) {
    if (vec == 8) BWD(__nv_bfloat16, 8, false);
    else BWD(__nv_bfloat16, 1, false);
  } else {
    if (vec == 4) BWD(float, 4, false);
    else if (vec == 2) BWD(float, 2, true);
    else BWD(float, 1, true);
  }
#undef BWD
  return static_cast<int>(cudaGetLastError());
}
