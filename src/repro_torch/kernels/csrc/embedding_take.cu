// The single-hot take from one rank's row shard for Hopper (sm_90a): the
// forward copy and its owner-writes backward.
//
// The function is the masked take of the reference's vocab-sharded
// lookup, tp_embedding_lookup (src/repro/models/embedding.py:39-81, the
// masked take at :72-78), and of tp_sampled_scores' gather
// (src/repro/models/recsys.py:353-358): an id in [row0, row0 + v_loc)
// reads row id - row0 of the shard, any other id reads zeros, in the
// table's dtype; the gradient lands in the shard only. It is the bag of
// one of the Pallas TPU kernel src/repro/kernels/embedding_bag.py
// (`embedding_bag`, pallas_call at :75) on one rank's rows, whose
// local-rows mode (csrc/embedding_bag.cu) computed it before for a (1,
// v_loc, D) table and (N, 1, 1) ids: an f32 output that the caller cast
// back, and a scatter of bf16 atomics fed a widened d_out. At the LM's
// shapes (16,384 ids over about 2,400 rows 4.6 KB wide, one id repeated
// some 4,000 times) that mode lost to F.embedding and index_add_
// (PERF.md §6). These two kernels are designed for that regime: bags of
// one, wide rows, many repeats, in the table's own dtype.
//
// Layout: table (v_loc, D) f32 or bf16, ids (N,) int32, out (N, D) in the
// table's dtype; the backward reads d_out (N, D) in the table's dtype and
// writes the gradient (v_loc, D) in it, into a tensor the caller zeroed
// (the zero fill is the allocation's, as embedding_bag_bwd's is).
//
// Forward, bound by bytes: the ids, each distinct row read once, the
// output written once (N 4 + uniq D e + N D e bytes). The output write is
// most of it (75.5 MB of 86.5 at gemma2-2b's (256000, 2304) bf16 table
// and 16,384 ids). A row is a copy of bytes, so the kernel is blind to
// the dtype and moves words: 16 bytes where the row's bytes and both
// pointers allow, else 4, else 2. The walk is flat over the output's
// words: thread t takes words t + k S (S the grid's threads, k <
// kFwdWords), so neighbouring threads load and store neighbouring words
// whatever the row width, and each thread has kFwdWords loads in flight
// before its first store (256 threads of 4 x 16 bytes: 128 KB in flight
// on an SM that holds 8 such blocks). A word's row is its index over the
// row's words, one wide multiply and a shift by the host plan's divisor
// (embedding_bag.py, `take_fwd_plan`). Table rows are read under an L2
// evict-last policy: the 9.8-11 MB of distinct rows stay in the 50 MB L2
// across their repeats while the output streams past with evict-first
// (`st.global.cs`) stores. An id outside the shard loads nothing and
// stores a zero word. The copy is exact, so the output is bitwise the
// plain version's. The grid is one round of blocks covering every word;
// a grid capped at 528-2112 blocks walking further rounds was no faster
// (kernel_probes.py take). Kept over a cp.async.bulk of each row through
// shared memory, not tried: TMA would move a row without registers, but
// as one 4.6 KB transfer a block waits on at a barrier, where the
// register copy keeps 128 KB in flight an SM with none.
//
// Backward, bound by bytes: d_out read once, the ids, each distinct
// gradient row written once (N D e + N 4 + uniq D e bytes). No atomics
// touch the gradient: each named row is written once, by its owner, with
// the f32 sum of its slots' d_out rows rounded once to the gradient's
// dtype. Run to run the bits are the same. The kernels:
//  1. A stable LSD radix sort of the slots by local row, hand-written:
//     the key of slot s is id - row0 for an id in the shard, else v_loc
//     (sorted last and skipped), the digits only the bits that v_loc
//     needs (18 at the LM's vocabularies: two passes of 9 bits). A pass
//     is three kernels: `count` (each tile's digit histogram), `scan`
//     (one block a digit: the exclusive scan of its counts over the
//     tiles) and `scatter` (each key's place: the digit's base, its
//     tile's offset, and its rank in the tile, taken in slot order with
//     __match_any_sync so that equal digits keep their order). Sorted,
//     a row's slots are contiguous and ascending.
//  2. A segmented sum in a fixed tree, a level a launch. Level 1 cuts the
//     sorted slots into chunks of kChunk positions; a lane group takes a
//     chunk and a tile of the row's 16-byte words (a warp covers 256 bf16
//     or 128 f32 columns), loads kSumUnroll d_out words before adding
//     them, and folds each row's slots in ascending order in f32. A row
//     whose slots all lie in the chunk is rounded and written there: a
//     row named once is d_out's row bit for bit, and a row folded in one
//     chunk is the plain version's left fold bit for bit. A row that
//     crosses the chunk's edge leaves an f32 partial in one of the
//     chunk's two places of the next level (its head: the row that
//     entered from the previous chunk; its tail: the row that leaves to
//     the next; a chunk the row fills has its partial at the head and a
//     zero at the tail, so a row's partials stay contiguous). The next
//     level is the same sum over those 2 x chunks partials in chunks of
//     kChunkUp, and so on until one chunk is left. A hot row (a frequent
//     token, BERT4Rec's MASK row) is split over every chunk it fills and
//     combined in log_{kChunkUp/2} levels, never by one thread walking
//     its slots. A group of kSumUnroll elements has its values loaded
//     together and the next group's keys loaded before it is added. At
//     the LM's shapes (kernel_probes.py take, NVIDIA H100 80GB HBM3,
//     700.00 W) groups of 4 took the least time: level 1 at 72
//     registers, so 3 blocks an SM fit and gemma2-2b's 2,304 lane groups
//     run in one wave; groups of 8 and 16 take 105 registers or more (2
//     blocks an SM, a second wave at gemma2-2b's shape), and 8 held to 3
//     blocks an SM by launch bounds spills.
//     The partials' order is fixed by the slots' positions, so two runs
//     give the same bits; a row that crosses a chunk edge differs from
//     the plain version's left fold by rounding alone.
// The scratch (the sort's ping-pong keys and slots, the digit counts, the
// levels' partials) comes from the wrapper (torch.empty), which sizes it
// from the host plan (embedding_bag.py, `take_bwd_plan`); the launches
// check it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWords = 4;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxRadixBits = 10;
constexpr int kMaxRadix = 1 << kMaxRadixBits;
constexpr int kScanPer = 8;
constexpr int kSumThreads = 256;
constexpr int kSumUnroll = 4;
constexpr int64_t kChunk = 64;
constexpr int64_t kChunkUp = 16;
// a level's key where no partial lies
constexpr int32_t kNone = -1;

// The host plan's divisor (embedding_bag.py, `divisor`): n / d = (n
// magic) >> shift for every n < 2^31; magic 0 takes a 64-bit division.
struct Div {
  uint32_t magic;
  int shift;
};

__device__ __forceinline__ int64_t quotient(int64_t n, int64_t d, Div q) {
  if (q.magic == 0) return n / d;
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(n)) * q.magic) >> q.shift);
}

// ---- forward ------------------------------------------------------------

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// a table word under the L2 evict-last policy
__device__ __forceinline__ uint4 ld_keep(const uint4* p, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned ld_keep(const unsigned* p,
                                            uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ unsigned short ld_keep(const unsigned short* p,
                                                  uint64_t pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;"
      : "=h"(v)
      : "l"(p), "l"(pol));
  return v;
}

// The flat walk over the output's `words` words of W (16, 4 or 2 bytes),
// `wpr` a row: thread t copies words t + k S, k < kFwdWords, every load
// issued before the first store, then the same kFwdWords S words further
// on while any are left (one round where the grid covers every word).
template <typename W>
__global__ void __launch_bounds__(kFwdThreads)
embedding_take_fwd_kernel(const W* __restrict__ table,
                          const int32_t* __restrict__ ids,
                          W* __restrict__ out, int64_t words, int64_t wpr,
                          Div per_row, int64_t row0, int64_t v_loc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFwdThreads;
  const uint64_t pol = keep_policy();
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kFwdThreads +
                   threadIdx.x;
       t < words; t += stride * kFwdWords) {
    W v[kFwdWords];
#pragma unroll
    for (int k = 0; k < kFwdWords; ++k) {
      const int64_t w = t + k * stride;
      v[k] = W{};
      if (w < words) {
        const int64_t r = quotient(w, wpr, per_row);
        const int64_t l = static_cast<int64_t>(__ldg(ids + r)) - row0;
        if (l >= 0 && l < v_loc)
          v[k] = ld_keep(table + l * wpr + (w - r * wpr), pol);
      }
    }
#pragma unroll
    for (int k = 0; k < kFwdWords; ++k) {
      const int64_t w = t + k * stride;
      if (w < words) __stcs(out + w, v[k]);
    }
  }
}

// ---- backward: the radix sort -------------------------------------------

// slot s's sort key: its local row, or v_loc for an id outside the shard
__device__ __forceinline__ int32_t shard_key(int32_t id, int64_t row0,
                                             int64_t v_loc) {
  const int64_t l = static_cast<int64_t>(id) - row0;
  return static_cast<int32_t>(l >= 0 && l < v_loc ? l : v_loc);
}

// A block's exclusive scan of one int a thread (kSortThreads threads);
// `total` gets the block's sum. `warp_sums` is shared, kSortWarps ints.
__device__ __forceinline__ int block_exclusive(int x, int* warp_sums,
                                               int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();
  return before + inc - x;
}

// Tile `blockIdx.x` (kSortThreads KPT positions): the histogram of its
// keys' digit (key >> shift) & (radix - 1) into counts[d tiles + tile].
// Pass 0 (keys null) takes the keys from the ids.
template <int KPT>
__global__ void __launch_bounds__(kSortThreads)
embedding_take_bwd_count_kernel(const int32_t* __restrict__ ids,
                                const int32_t* __restrict__ keys, int64_t n,
                                int64_t row0, int64_t v_loc, int shift,
                                int radix, int32_t* __restrict__ counts,
                                int64_t tiles) {
  __shared__ int hist[kMaxRadix];
  for (int d = threadIdx.x; d < radix; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortThreads * KPT;
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int64_t p = base + k * kSortThreads + threadIdx.x;
    if (p < n) {
      const int32_t key = keys != nullptr
                              ? __ldg(keys + p)
                              : shard_key(__ldg(ids + p), row0, v_loc);
      atomicAdd(&hist[(key >> shift) & (radix - 1)], 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kSortThreads)
    counts[static_cast<int64_t>(d) * tiles + blockIdx.x] = hist[d];
}

// Block d: the exclusive scan of digit d's counts over the tiles, in
// place, and the digit's total.
__global__ void __launch_bounds__(kSortThreads)
embedding_take_bwd_scan_kernel(int32_t* __restrict__ counts,
                               int32_t* __restrict__ totals, int64_t tiles) {
  __shared__ int warp_sums[kSortWarps];
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  int carry = 0;
  for (int64_t c0 = 0; c0 < tiles; c0 += kSortThreads * kScanPer) {
    const int64_t i0 = c0 + static_cast<int64_t>(threadIdx.x) * kScanPer;
    int v[kScanPer];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = i0 + k < tiles ? row[i0 + k] : 0;
      sum += v[k];
    }
    int total;
    int run = carry + block_exclusive(sum, warp_sums, total);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (i0 + k < tiles) row[i0 + k] = run;
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Tile `blockIdx.x`: each key (and its slot) to its place in the pass's
// output. Warp w takes the tile's positions w 32 KPT + k 32 + lane, k <
// KPT, in position order; a key's rank among its tile's equal digits is
// the count of its warp's earlier ones (a per-warp counter a digit, kept
// by the lowest lane of each __match_any_sync group) plus those of the
// earlier warps, so equal digits keep their order (the sort is stable).
template <int KPT>
__global__ void __launch_bounds__(kSortThreads)
embedding_take_bwd_scatter_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ keys_in,
    const int32_t* __restrict__ slots_in, int32_t* __restrict__ keys_out,
    int32_t* __restrict__ slots_out, int64_t n, int64_t row0, int64_t v_loc,
    int shift, int radix, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ totals, int64_t tiles) {
  __shared__ int wcnt[kSortWarps][kMaxRadix];
  __shared__ int dbase[kMaxRadix];
  __shared__ int warp_sums[kSortWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < radix; d += kSortThreads) {
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) wcnt[w][d] = 0;
  }
  {
    // the digits' bases: thread i takes digits [i per, (i + 1) per)
    const int per = (radix + kSortThreads - 1) / kSortThreads;
    const int d0 = threadIdx.x * per;
    int s = 0;
    for (int j = 0; j < per; ++j)
      if (d0 + j < radix) s += __ldg(totals + d0 + j);
    int total;
    int run = block_exclusive(s, warp_sums, total);
    for (int j = 0; j < per; ++j) {
      if (d0 + j < radix) {
        dbase[d0 + j] = run;
        run += __ldg(totals + d0 + j);
      }
    }
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortThreads * KPT +
                       static_cast<int64_t>(warp) * 32 * KPT;
  const unsigned below = (1u << lane) - 1u;
  int32_t key[KPT], slot[KPT];
  int dig[KPT], rank[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int64_t p = base + k * 32 + lane;
    const bool valid = p < n;
    key[k] = 0;
    slot[k] = 0;
    if (valid) {
      if (keys_in != nullptr) {
        key[k] = __ldg(keys_in + p);
        slot[k] = __ldg(slots_in + p);
      } else {
        key[k] = shard_key(__ldg(ids + p), row0, v_loc);
        slot[k] = static_cast<int32_t>(p);
      }
    }
    dig[k] = valid ? (key[k] >> shift) & (radix - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, dig[k]);
    const int prior = valid ? wcnt[warp][dig[k]] : 0;
    __syncwarp();
    if (valid && (peers & below) == 0)
      wcnt[warp][dig[k]] = prior + __popc(peers);
    __syncwarp();
    rank[k] = prior + __popc(peers & below);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kSortThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = wcnt[w][d];
      wcnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    if (dig[k] >= 0) {
      const int d = dig[k];
      const int64_t pos =
          static_cast<int64_t>(dbase[d]) +
          counts[static_cast<int64_t>(d) * tiles + blockIdx.x] +
          wcnt[warp][d] + rank[k];
      keys_out[pos] = key[k];
      slots_out[pos] = slot[k];
    }
  }
}

// ---- backward: the segmented sum ----------------------------------------

// The raw word of VEC elements of T one load brings, and its f32 values:
// 8 bf16 (16 bytes), 4 f32 (16 bytes), or one element.
template <typename T, int VEC> struct Raw;
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<float, 1> { using type = float; };

// a bf16 is the top half of an f32: its bits shifted into place (exact)
__device__ __forceinline__ void widen(uint4 w, float (&v)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(float4 w, float (&v)[4]) {
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void widen(unsigned short w, float (&v)[1]) {
  v[0] = __uint_as_float(static_cast<unsigned>(w) << 16);
}
__device__ __forceinline__ void widen(float w, float (&v)[1]) { v[0] = w; }

// d_out's words stream past (each read once: evict-first)
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  return __ldcs(p);
}
__device__ __forceinline__ unsigned short ld_stream(
    const unsigned short* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float ld_stream(const float* p) {
  return __ldcs(p);
}

// VEC f32 values of a partial at p (aligned to 4 VEC bytes; 16 for VEC 8)
template <int VEC>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 w = __ldcg(reinterpret_cast<const float4*>(p + i));
      v[i] = w.x;
      v[i + 1] = w.y;
      v[i + 2] = w.z;
      v[i + 3] = w.w;
    }
  }
}
template <int VEC>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// the sums rounded once to the gradient's dtype, to p
__device__ __forceinline__ void st_grad(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_grad(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(
             __bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(
              __bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}
__device__ __forceinline__ void st_grad(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                 bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}
__device__ __forceinline__ void st_grad(__nv_bfloat16* p,
                                        const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ bool row_key(int32_t k, int64_t v_loc) {
  return k >= 0 && k < v_loc;
}

// One level of the segmented sum over n sorted elements (keys: a local
// row, or a key outside [0, v_loc) that is skipped). Level 1 (kFirst)
// reads element p's values from d_out's row slots[p] in T; a later level
// reads f32 partials, row p of `vals`. Lane group g of 2^lanes_log2
// threads takes item g: chunk c = g / col_tiles (positions [c chunk,
// (c + 1) chunk)) and column tile g % col_tiles (its lanes one word of
// VEC columns each). Each row's elements are folded in position order in
// f32; a row whose elements all lie in the chunk is rounded and written
// to `grad`; a row that enters from the previous chunk leaves its partial
// at element 2c of the next level, a row that leaves to the next chunk at
// 2c + 1 (a row through the whole chunk: its partial at 2c, a zero at 2c
// + 1), with its key in next_keys (kNone where no partial lies). The last
// level (one chunk) has no next. The elements go kSumUnroll at a time:
// their values loaded together, the next group's keys (and slots)
// loaded before this group is added, so a group waits on one round trip.
template <typename T, int VEC, bool kFirst>
__global__ void __launch_bounds__(kSumThreads)
embedding_take_bwd_sum_kernel(const T* __restrict__ d_out,
                              const float* __restrict__ vals,
                              const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ slots, int64_t n,
                              int64_t chunk, int64_t v_loc, int64_t D,
                              int lanes_log2, int64_t col_tiles,
                              int64_t items, T* __restrict__ grad,
                              float* __restrict__ next_vals,
                              int32_t* __restrict__ next_keys) {
  using R = typename Raw<T, VEC>::type;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  const int64_t item = t >> lanes_log2;
  if (item >= items) return;
  const int lanes = 1 << lanes_log2;
  const int lane = static_cast<int>(t & (lanes - 1));
  const int64_t c = item / col_tiles;
  const int64_t j = item - c * col_tiles;
  const int64_t lo = c * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int32_t first = __ldg(keys + lo), last = __ldg(keys + hi - 1);
  const bool head_open =
      lo > 0 && row_key(first, v_loc) && __ldg(keys + lo - 1) == first;
  const bool tail_open =
      hi < n && row_key(last, v_loc) && __ldg(keys + hi) == last;
  if (j == 0 && lane == 0 && next_keys != nullptr) {
    next_keys[2 * c] = head_open ? first : kNone;
    next_keys[2 * c + 1] = tail_open ? last : kNone;
  }
  const int64_t word = j * lanes + lane;
  // level 1's skipped keys (ids outside the shard) sort last: a chunk
  // that begins with one holds no row; a later level's kNone may lie
  // before a row
  if ((kFirst && !row_key(first, v_loc)) || word >= D / VEC) return;
  const int64_t col = word * VEC;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  int32_t cur = first;
  bool first_seg = true;
  // a row's sum to its place: the next level's head or tail, or `grad`
  auto flush = [&](bool ends_chunk) {
    if (!row_key(cur, v_loc)) return;
    if (first_seg && head_open) {
      st_f32<VEC>(next_vals + 2 * c * D + col, acc);
      if (ends_chunk && tail_open) {
        float zero[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) zero[i] = 0.f;
        st_f32<VEC>(next_vals + (2 * c + 1) * D + col, zero);
      }
    } else if (ends_chunk && tail_open) {
      st_f32<VEC>(next_vals + (2 * c + 1) * D + col, acc);
    } else {
      st_grad(grad + static_cast<int64_t>(cur) * D + col, acc);
    }
  };
  // the keys (and level 1's slots) of the group at p0
  int32_t k[kSumUnroll], s[kSumUnroll];
  auto load_keys = [&](int64_t p0, int32_t (&kk)[kSumUnroll],
                       int32_t (&ss)[kSumUnroll]) {
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      const int64_t p = p0 + u;
      kk[u] = p < hi ? __ldg(keys + p) : kNone;
      ss[u] = kFirst && p < hi ? __ldg(slots + p) : 0;
    }
  };
  load_keys(lo, k, s);
  for (int64_t p0 = lo; p0 < hi; p0 += kSumUnroll) {
    // level 1 keeps its words raw (a bf16 word is 4 registers, 8 once
    // widened) until it adds them
    R r[kSumUnroll];
    float v[kFirst ? 1 : kSumUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      if constexpr (kFirst) {
        r[u] = R{};
        if (row_key(k[u], v_loc))
          r[u] = ld_stream(reinterpret_cast<const R*>(
              d_out + static_cast<int64_t>(s[u]) * D + col));
      } else if (row_key(k[u], v_loc)) {
        ld_f32<VEC>(vals + (p0 + u) * D + col, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
      }
    }
    int32_t kn[kSumUnroll], sn[kSumUnroll];
    load_keys(p0 + kSumUnroll, kn, sn);
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      if (p0 + u >= hi) break;
      if (k[u] != cur) {
        flush(false);
        cur = k[u];
        first_seg = false;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      }
      float w[VEC];
      if constexpr (kFirst) {
        widen(r[u], w);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) w[i] = v[u][i];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += w[i];
    }
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      k[u] = kn[u];
      s[u] = sn[u];
    }
  }
  flush(true);
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

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

template <int KPT>
cudaError_t sort_pass(cudaStream_t s, const int32_t* ids,
                      const int32_t* keys_in, const int32_t* slots_in,
                      int32_t* keys_out, int32_t* slots_out, int64_t n,
                      int64_t row0, int64_t v_loc, int shift, int radix,
                      int32_t* counts, int32_t* totals, int64_t tiles) {
  const unsigned grid = static_cast<unsigned>(tiles);
  embedding_take_bwd_count_kernel<KPT><<<grid, kSortThreads, 0, s>>>(
      ids, keys_in, n, row0, v_loc, shift, radix, counts, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  embedding_take_bwd_scan_kernel<<<radix, kSortThreads, 0, s>>>(
      counts, totals, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  embedding_take_bwd_scatter_kernel<KPT><<<grid, kSortThreads, 0, s>>>(
      ids, keys_in, slots_in, keys_out, slots_out, n, row0, v_loc, shift,
      radix, counts, totals, tiles);
  return cudaGetLastError();
}

// a level's chunk: kChunk positions at level 1, kChunkUp partials after
int64_t chunk_at(int level) { return level == 0 ? kChunk : kChunkUp; }
int64_t chunks_of(int64_t n, int level) {
  return (n + chunk_at(level) - 1) / chunk_at(level);
}

template <typename T, int VEC>
cudaError_t segmented_sum(cudaStream_t s, const void* d_out_p,
                          const int32_t* keys, const int32_t* slots,
                          int64_t n, int64_t v_loc, int64_t D, void* grad_p,
                          float* part_a, int32_t* pkeys_a, float* part_b,
                          int32_t* pkeys_b) {
  const T* d_out = static_cast<const T*>(d_out_p);
  T* grad = static_cast<T*>(grad_p);
  const int64_t words = D / VEC;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (int64_t{1} << lanes_log2) < words) ++lanes_log2;
  const int64_t col_tiles = (words + (1 << lanes_log2) - 1) >> lanes_log2;
  const float* vals = nullptr;
  const int32_t* lkeys = keys;
  float* bufs[2] = {part_a, part_b};
  int32_t* kbufs[2] = {pkeys_a, pkeys_b};
  for (int level = 0;; ++level) {
    const int64_t chunks = chunks_of(n, level);
    const bool last = chunks == 1;
    float* nv = last ? nullptr : bufs[level & 1];
    int32_t* nk = last ? nullptr : kbufs[level & 1];
    const int64_t items = chunks * col_tiles;
    const int64_t blocks =
        ((items << lanes_log2) + kSumThreads - 1) / kSumThreads;
    if (level == 0) {
      embedding_take_bwd_sum_kernel<T, VEC, true>
          <<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
              d_out, nullptr, lkeys, slots, n, kChunk, v_loc, D,
              lanes_log2, col_tiles, items, grad, nv, nk);
    } else {
      embedding_take_bwd_sum_kernel<T, VEC, false>
          <<<static_cast<unsigned>(blocks), kSumThreads, 0, s>>>(
              nullptr, vals, lkeys, nullptr, n, kChunkUp, v_loc, D,
              lanes_log2, col_tiles, items, grad, nv, nk);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || last) return e;
    vals = nv;
    lkeys = nk;
    n = 2 * chunks;
  }
}

}  // namespace

// C interface, loaded with ctypes. Each launches on `stream` and returns
// cudaGetLastError() of its launches (0 = launched), or
// cudaErrorInvalidValue, without launching, for a call that does not fit
// its plan.
//
// The forward (embedding_bag.py, `take_fwd_plan`): table (v_loc, D) and
// out (n, D) of `row_bytes` bytes a row, moved in words of `word` bytes
// (16, 4 or 2; row_bytes a multiple, both pointers aligned to it);
// `blocks` blocks of 256 threads walking the n row_bytes / word words,
// kFwdWords a thread a round; (row_magic, row_shift) the divisor of the
// row's words, exact below the walk's last index. Rows [row0, row0 +
// v_loc) of the table are this shard.
extern "C" int embedding_take_fwd(const void* table, const int32_t* ids,
                                  void* out, int64_t n, int64_t v_loc,
                                  int64_t row_bytes, int32_t word,
                                  int64_t blocks, int64_t row_magic,
                                  int32_t row_shift, int64_t row0,
                                  void* stream) {
  if (n < 0 || v_loc < 0 || row0 < 0 || row_bytes < 0 ||
      !(word == 16 || word == 4 || word == 2) || row_bytes % word != 0 ||
      !aligned(table, word) || !aligned(out, word))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t wpr = row_bytes / word;
  const int64_t words = n * wpr;
  if (words == 0) return 0;
  // the walk's indices stay below words + one round of the grid
  const int64_t span = words + blocks * kFwdThreads * kFwdWords;
  if (blocks < 1 || blocks > INT32_MAX ||
      !div_ok(row_magic, row_shift, wpr, span))
    return static_cast<int>(cudaErrorInvalidValue);
  const Div per_row{static_cast<uint32_t>(row_magic), row_shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (word == 16) {
    embedding_take_fwd_kernel<uint4><<<grid, kFwdThreads, 0, s>>>(
        static_cast<const uint4*>(table), ids, static_cast<uint4*>(out),
        words, wpr, per_row, row0, v_loc);
  } else if (word == 4) {
    embedding_take_fwd_kernel<unsigned><<<grid, kFwdThreads, 0, s>>>(
        static_cast<const unsigned*>(table), ids,
        static_cast<unsigned*>(out), words, wpr, per_row, row0, v_loc);
  } else {
    embedding_take_fwd_kernel<unsigned short><<<grid, kFwdThreads, 0, s>>>(
        static_cast<const unsigned short*>(table), ids,
        static_cast<unsigned short*>(out), words, wpr, per_row, row0, v_loc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward (embedding_bag.py, `take_bwd_plan`): d_out (n, D) and the
// zeroed grad (v_loc, D), both f32 (`bf16` 0) or bf16 (1), `vec` columns
// a word (f32: 4 or 1; bf16: 8 or 1; D a multiple, both pointers 16-byte
// aligned for 4 and 8). The sort: `passes` passes of `radix_bits` bits
// covering v_loc's bits, tiles of 256 kpt positions (kpt 1, 2, 4 or 8),
// `tiles` of them covering n; keys_a, slots_a, keys_b and slots_b n ints
// each, counts 2^radix_bits tiles ints, totals 2^radix_bits. The sum:
// part_a and part_b of part_a_rows and part_b_rows rows of D floats, and
// pkeys_a and pkeys_b as many ints, enough for every level (level 2
// takes 2 ceil(n / 64) rows of part_a, level 3 2 ceil(that / 64) of
// part_b, and so on in turns).
extern "C" int embedding_take_bwd(
    const void* d_out, const int32_t* ids, void* grad, int64_t n,
    int64_t v_loc, int64_t D, int64_t row0, int32_t bf16, int32_t vec,
    int32_t passes, int32_t radix_bits, int32_t kpt, int64_t tiles,
    int32_t* keys_a, int32_t* slots_a, int32_t* keys_b, int32_t* slots_b,
    int32_t* counts, int32_t* totals, float* part_a, int32_t* pkeys_a,
    int64_t part_a_rows, float* part_b, int32_t* pkeys_b,
    int64_t part_b_rows, void* stream) {
  if (n < 0 || v_loc < 0 || D < 0 || row0 < 0 || v_loc >= INT32_MAX ||
      n >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || D == 0 || v_loc == 0) return 0;
  const bool vec_ok = bf16 ? (vec == 8 || vec == 1) : (vec == 4 || vec == 1);
  int bits = 0;
  while ((int64_t{1} << bits) <= v_loc) ++bits;
  const int64_t tile = int64_t{kSortThreads} * kpt;
  if (!vec_ok || D % vec != 0 ||
      (vec > 1 && !(aligned(d_out, 16) && aligned(grad, 16))) ||
      radix_bits < 1 || radix_bits > kMaxRadixBits || passes < 1 ||
      passes * radix_bits < bits ||
      !(kpt == 1 || kpt == 2 || kpt == 4 || kpt == 8) ||
      tiles * tile < n || (tiles - 1) * tile >= n || tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // the levels' partials fit their buffers, in turns
  {
    int64_t m = n;
    for (int level = 0; chunks_of(m, level) > 1; ++level) {
      m = 2 * chunks_of(m, level);
      if (m > ((level & 1) ? part_b_rows : part_a_rows))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int radix = 1 << radix_bits;
  const int32_t* kin = nullptr;
  const int32_t* sin = nullptr;
  int32_t* kout[2] = {keys_a, keys_b};
  int32_t* sout[2] = {slots_a, slots_b};
  for (int pass = 0; pass < passes; ++pass) {
    int32_t* ko = kout[pass & 1];
    int32_t* so = sout[pass & 1];
    const int shift = pass * radix_bits;
    cudaError_t e;
#define PASS(K_)                                                             \
  sort_pass<K_>(s, ids, kin, sin, ko, so, n, row0, v_loc, shift, radix,     \
                counts, totals, tiles)
    if (kpt == 1) e = PASS(1);
    else if (kpt == 2) e = PASS(2);
    else if (kpt == 4) e = PASS(4);
    else e = PASS(8);
#undef PASS
    if (e != cudaSuccess) return static_cast<int>(e);
    kin = ko;
    sin = so;
  }
  cudaError_t e;
  if (bf16) {
    e = vec == 8 ? segmented_sum<__nv_bfloat16, 8>(s, d_out, kin, sin, n,
                                                    v_loc, D, grad, part_a,
                                                    pkeys_a, part_b, pkeys_b)
                 : segmented_sum<__nv_bfloat16, 1>(s, d_out, kin, sin, n,
                                                    v_loc, D, grad, part_a,
                                                    pkeys_a, part_b, pkeys_b);
  } else {
    e = vec == 4 ? segmented_sum<float, 4>(s, d_out, kin, sin, n, v_loc, D,
                                           grad, part_a, pkeys_a, part_b,
                                           pkeys_b)
                 : segmented_sum<float, 1>(s, d_out, kin, sin, n, v_loc, D,
                                           grad, part_a, pkeys_a, part_b,
                                           pkeys_b);
  }
  return static_cast<int>(e);
}
