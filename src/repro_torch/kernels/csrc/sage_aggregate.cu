// GraphSAGE neighbour aggregation for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sage_aggregate.py
// (`sage_aggregate`, pallas_call at :32). On the TPU a (tile_b, F, D)
// block of neighbour features sits in VMEM, is averaged over F in f32 and
// fed straight to the MXU against the grid-invariant (D, H) weight, so the
// (tile_b, D) aggregate never reaches HBM; B must divide by tile_b. The
// TPU kernel has no backward.
//
// Forward: neigh (B, F, D), w (D, H), each f32 or bf16 (the TPU kernel
// casts both to f32 inside) -> out (B, H) in neigh's dtype,
// out[b] = (sum_f neigh[b, f] / F) @ w: a GEMM (M = B, K = D, N = H) whose
// A operand is made on the fly. The mean and the product are f32 for
// either dtype and a bf16 out is their f32 result rounded to nearest
// even; the saved aggregate is f32. Bound by bytes: at the main shape, neigh2
// (15360, 10, 602) x (602, 128), it reads 369.9 MB of neigh and writes
// 7.9 MB of out (+ 37.0 MB of aggregate when training), about 0.113 ms
// (0.124 ms) at 3.35 TB/s against 2.46 GFLOP, 0.037 ms at 67 TFLOP/s.
//  - Persistent CTAs, one an SM. The host plan (sage_aggregate.py,
//    `fwd_plan`) gives each of at most 132 a contiguous range of rows, B /
//    132 rounded either way, walked in tiles of 32 rows (8 where it has
//    fewer, as the GNN's 1024-row calls do), so no wave has a tail.
//  - Producer and consumer warps. Eight loader warps stream a tile's rows
//    from HBM straight into registers (each thread kBatch vectors of 1, 2
//    or 4 floats, the loads of kFUnroll values of f issued before their
//    adds), sum over f in f32 from neigh[b, 0] upwards, divide by F with an
//    IEEE division (bit-equal to ref.sage_mean_ref) and write the tile of
//    the aggregate to shared memory, and to the saved aggregate when
//    training. Four multiplier warps multiply the tile before by w. The
//    aggregate has two buffers and named barriers hand them over (full,
//    free), so HBM streams tile t + 1 while tile t is multiplied.
//  - w without exposed latency: the multipliers stream w through a ring
//    of up to 8 slices of 32 rows (one 16 KB piece at H = 128) with
//    cp.async, several slices ahead, across tiles.
//  - The product: each multiplier thread owns a 4 x 8 register tile (rows
//    4 ty.., columns 4 tx.. and 64 + 4 tx..), fed by three float4 shared
//    loads per 32 FMAs, k ascending. At 32 rows the four warps cover the
//    tile; at 8 rows each warp takes 8 of every 32 rows of w and the four
//    partial tiles are summed in warp order. The order of every sum is
//    fixed by the shapes, so a result is the same from run to run and with
//    or without the saved aggregate. f32 FMAs, not TF32 tensor cores:
//    one-pass TF32 would miss the 1e-5 tolerances, and the kernel is bound
//    by bytes.
//  - Alignment. A row of D = 602 floats is 2408 bytes, 8- but not 16-byte
//    aligned, so neigh is loaded as the widest vectors that divide both a
//    row and the base pointer, counted in bytes (the host plan picks 16,
//    8 or 4 bytes of f32, 16, 4 or 2 of bf16: a bf16 row of 602 is 1204
//    bytes, 4-byte loads); any contiguous tensor is taken. The saved
//    aggregate's rows are padded to a multiple of 4 floats (604 at D =
//    602) so that d_w copies them 16 bytes at a time. The ragged edge
//    (rows past a range, d past D, columns past H) is masked or
//    zero-filled, never refused.
//  - bf16: the loaders keep a load's raw bits in registers until its add
//    and widen them there (exact), 32 bytes a thread in flight per value
//    of f as in f32. A bf16 w is widened to f32 first by a kernel of its
//    own (`sage_widen_w`, launched and counted by the wrapper; cp.async
//    cannot widen, and widening it slice by slice in the multipliers'
//    registers was twice as slow, PERF.md), so the tiles, the ring and
//    the product are the f32 kernel's.
//  Staging neigh in a shared-memory ring (cp.async or 1-D bulk copies)
//  was measured slower than loading it into registers (PERF.md).
//
// Backward (f32; for bf16 inputs ops.py hands it d_out and w in f32),
// two parts, each only when its input needs a gradient:
//  - d_w (D, H) = agg^T d_out, a reduction over all B rows, bound by f32
//    operations (2.37 GFLOP, 0.035 ms, against 45 MB at the main shape).
//    A CTA owns a 128 x 128 tile of d_w (an 8 x 8 register tile a thread,
//    four float4 shared loads per 64 FMAs) and one range of rows, streamed
//    32 rows a stage through a 4-stage cp.async ring of agg (16-byte copies
//    from the padded rows) and d_out. The ranges of one tile form clusters
//    (the host plan, `dw_plan`, takes the size that keeps the most CTAs
//    on the card at once: 2 at the GNN's D = 602) that sum their partial
//    tiles through distributed shared memory in rank order; with more than
//    one cluster a tile, the clusters' sums go to a scratch of (clusters,
//    D, H), 13 x 0.3 MB at the main shape instead of 52 partials' 16 MB,
//    and a second pass adds them in cluster order. No atomics: the result
//    is deterministic. Each range sums its rows in ascending order, so an
//    element carries the rounding of partial sums as large as the largest
//    elements; chip_smoke.py holds it to 1e-5 of max|d_w|.
//  - d_neigh (B, F, D) = (d_out w^T) / F, broadcast over f, written only
//    when neigh needs a gradient (the GNN's h1 call; for the data inputs
//    it would be 370 MB written for nothing). Bound by the bytes it
//    writes: at h1, (1024, 15, 128) from (1024, 47) x (128, 47)^T, 7.86 MB
//    written and 0.22 MB read, 0.0024 ms at 3.35 TB/s, against 12.3
//    MFLOP. The kernel's first design (16 x 64 tiles, 128 blocks at h1, h
//    in chunks of 16, 60 scalar stores a thread) read 0.0069 ms there. Each CTA runs
//    one chain, stage, multiply, store, and at h1 every CTA is on the card
//    at once, so the time is the launch of the grid plus one chain; the
//    design keeps each step short (each step's time is in PERF.md, from
//    `kernel_probes.py dneigh`):
//     - A CTA of 128 threads owns a tile of 32 columns and 4 x RR rows, a
//       thread one column and RR rows. The host plan (`dneigh_plan`) takes
//       RR 2: 512 CTAs of 8 x 32 at h1, about 4 an SM; RR 1 where that
//       would put fewer than two on each SM.
//     - Staging: where H is odd and fits one chunk of 128, w's rows d0 ..
//       and d_out's rows b0 .. are each one contiguous run of floats,
//       copied into shared memory by 16-byte cp.async at the run's own
//       alignment (4-byte ones at its ends; rows of 47 floats are 188
//       bytes apart, never 16-byte aligned, and a 4-byte copy a float
//       took longer than the rest of the chain). Otherwise row by row, 4
//       bytes a copy, into rows ld floats apart (4 mod 8), H in chunks of
//       128.
//     - The product: f32 FMAs with h ascending, then the IEEE division by
//       F of ref.sage_aggregate_bwd_ref. From the runs, a lane's row of w
//       is H floats past its neighbour's, in 32 different banks, and
//       d_out's rows are broadcasts; from the rows, float4 loads (ld = 4
//       mod 8: 8 lanes' loads meet no bank twice).
//     - Stores straight from registers: each thread writes its values F
//       times, each (row, f) a warp's 32 consecutive floats, 128 bytes;
//       any D and any alignment. The tile put in shared memory and its
//       rows written F times by TMA bulk copies or float4 stores, and
//       tiles of 64 or 128 columns, measured slower at h1 (variants in
//       `kernel_probes.py dneigh`).
//    Each value's sum has one order, fixed by H alone, and all F copies of
//    a row come from one register, so both tiles give the same bits, the
//    F copies of a row are equal and two runs are equal.
//
// The versions before this one, and their times, are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // d_w

// forward: kLoaders threads stream and reduce neigh, kMults multiply; a
// tile has kCols output columns; a slice of w, kWRows of its rows; a ring
// of up to kMaxStages slices (cp_async_wait takes up to 6 in flight)
constexpr int kLoaders = 256;
constexpr int kMults = 128;
constexpr int kCols = 128;
constexpr int kWRows = 32;
constexpr int kMaxStages = 8;

// d_w: a CTA owns a kDwTile x kDwTile tile of d_w, kDwRows rows a stage
constexpr int kDwTile = 128;
constexpr int kDwRows = 32;
constexpr int kDwStages = 4;
constexpr int kMaxCluster = 8;

// d_neigh: kDnThreads threads a CTA over a tile of kDnCols columns, each
// one column and RR rows; H staged kDnKH values at a time
constexpr int kDnThreads = 128;
constexpr int kDnCols = 32;
constexpr int kDnKH = 128;

// a BYTES-wide copy global -> shared that lands asynchronously; an invalid
// one zero-fills its destination and reads nothing
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `n` committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// named barriers of the forward (0 is __syncthreads): a tile's aggregate
// in buffer b is full (kBarFull + b) or free again (kBarFree + b); the
// multipliers' own (kBarMult)
constexpr int kBarFull = 1;
constexpr int kBarFree = 3;
constexpr int kBarMult = 5;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// The forward's shared memory, in floats: `bufs` tiles of the aggregate
// (R, lda), the multipliers' partial tiles when R = 8 (4, 8, kCols), and
// `stages` slots of kWRows rows of w: kWRows x H floats in one piece when
// w has one column tile (and kCols more, which the product reads past a
// short last row), else rows of kCols floats.
__host__ __device__ __forceinline__ int fwd_lda(int D) {
  return (D + kWRows - 1) / kWRows * kWRows + 4;
}
__host__ __device__ __forceinline__ int fwd_slot(int H) {
  return H <= kCols ? (kWRows * H + 3) / 4 * 4 + kCols : kWRows * kCols;
}
__host__ __device__ __forceinline__ size_t fwd_smem(int R, int bufs, int D,
                                                    int H, int stages) {
  return sizeof(float) *
         (static_cast<size_t>(bufs) * R * fwd_lda(D) +
          (R == 8 ? 4 * 8 * kCols : 0) +
          static_cast<size_t>(stages) * fwd_slot(H));
}

// N elements of T loaded as one access of N * sizeof(T) bytes (f32 as
// float, float2 or float4; bf16 as raw bits of 2, 4 or 16 bytes), and
// their widening to f32 in registers: f32 as it is, bf16 by its 16 bits
// moved to the top of an f32 (exact).
template <int kBytes> struct Bits;
template <> struct Bits<2> { using T = unsigned short; };
template <> struct Bits<4> { using T = unsigned int; };
template <> struct Bits<8> { using T = uint2; };
template <> struct Bits<16> { using T = uint4; };

template <int N> struct Floats;
template <> struct Floats<1> { using T = float; };
template <> struct Floats<2> { using T = float2; };
template <> struct Floats<4> { using T = float4; };

// f32: the float, float2 or float4 itself; bf16: N elements' raw bits
template <typename T, int N> struct RawType {
  using R = typename Bits<N * sizeof(T)>::T;
};
template <int N> struct RawType<float, N> {
  using R = typename Floats<N>::T;
};

template <typename T, int N>
struct Raw {
  using R = typename RawType<T, N>::R;
  static __device__ __forceinline__ R load(const T* p) {
    return __ldg(reinterpret_cast<const R*>(p));
  }
  static __device__ __forceinline__ void widen(const R& r, float (&v)[N]) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (N == 1) {
        v[0] = r;
      } else if constexpr (N == 2) {
        v[0] = r.x;
        v[1] = r.y;
      } else {
        v[0] = r.x;
        v[1] = r.y;
        v[2] = r.z;
        v[3] = r.w;
      }
    } else {
      union { R r; unsigned short e[N]; } u;
      u.r = r;
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __bfloat162float(__ushort_as_bfloat16(u.e[i]));
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (sizeof(T) == 4) return x;
  else return __float2bfloat16_rn(x);
}

// The loaders' part of a tile: the mean over f of rows row0 .. row0 + rows,
// read from neigh straight into registers (each loader thread kBatch
// vectors of VEC elements of d at a time, 32 bytes, the loads of kFUnroll
// values of f issued before their adds, kept as raw bits until the add),
// f ascending in f32 from neigh[b, 0], then an IEEE division by F
// (bit-equal to ref.sage_mean_ref), into the tile `a_t` (R, lda) and,
// when training, the saved aggregate.
template <typename T, int R, int VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ neigh,
                                          float* a_t, float* agg_out,
                                          int64_t row0, int rows, int F,
                                          int D, int lda, int ld_agg,
                                          int ltid) {
  using L = Raw<T, VEC>;
  constexpr int kBatch = 32 / static_cast<int>(sizeof(T)) / VEC;
  constexpr int kFUnroll = 5;
  const int dv = D / VEC;
  const int n_vec = rows * dv;
  const int64_t fd = static_cast<int64_t>(F) * D;
  const T* base = neigh + row0 * fd;
  const float f_div = static_cast<float>(F);
  for (int v0 = 0; v0 < n_vec; v0 += kLoaders * kBatch) {
    int64_t off[kBatch];
    float s[kBatch][VEC];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int v = v0 + (ltid / 32) * 32 * kBatch + 32 * i + ltid % 32;
      const int r = v / dv;
      off[i] = v < n_vec ? r * fd + static_cast<int64_t>(v - r * dv) * VEC
                         : -1;
    }
    // kFUnroll values of f at a time, all their loads issued before the
    // adds; the first group starts each sum at f = 0
    for (int f = 0; f < F; f += kFUnroll) {
      const int nf = F - f < kFUnroll ? F - f : kFUnroll;
      typename L::R x[kFUnroll][kBatch];
#pragma unroll
      for (int u = 0; u < kFUnroll; ++u) {
        const int64_t fo = static_cast<int64_t>(f + u) * D;
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (u < nf && off[i] >= 0) x[u][i] = L::load(base + off[i] + fo);
      }
#pragma unroll
      for (int u = 0; u < kFUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (u >= nf || off[i] < 0) continue;
          float e[VEC];
          L::widen(x[u][i], e);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            if (f + u == 0) s[i][j] = e[j];
            else s[i][j] += e[j];
          }
        }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (off[i] < 0) continue;
      const int v = v0 + (ltid / 32) * 32 * kBatch + 32 * i + ltid % 32;
      const int r = v / dv;
      const int d = (v - r * dv) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = s[i][j] / f_div;
        a_t[r * lda + d + j] = a;
        if (agg_out != nullptr) agg_out[(row0 + r) * ld_agg + d + j] = a;
      }
    }
  }
  // rows past the range meet w as zeros
  for (int i = rows * lda + ltid; i < R * lda; i += kLoaders) a_t[i] = 0.f;
}

// See the header. T neigh's and out's element type (float or
// __nv_bfloat16), R rows a tile (32, or 8 where a CTA has fewer), VEC
// elements a load of neigh, WVEC whether w's rows are 16-byte aligned.
template <typename T, int R, int VEC, bool WVEC>
__global__ void __launch_bounds__(kLoaders + kMults, 1)
sage_fwd_kernel(const T* __restrict__ neigh, const float* __restrict__ w,
                T* __restrict__ out, float* __restrict__ agg_out,
                int64_t B, int F, int D, int H, int ld_agg, int bufs,
                int stages) {
  // multipliers: R = 32, each warp all of a slice's kWRows rows of w for
  // rows 8 w_i .. 8 w_i + 7 of the tile; R = 8, each warp 8 of them for all
  // 8 rows (the four partial tiles summed in warp order at the end)
  constexpr int kKw = R == 32 ? kWRows : kWRows / 4;
  extern __shared__ __align__(16) float smem[];
  const int lda = fwd_lda(D);
  float* agg_s = smem;                             // [bufs][R][lda]
  float* red = agg_s + bufs * R * lda;             // [4][8][kCols], R = 8
  float* ring = red + (R == 8 ? 4 * 8 * kCols : 0);
  const int slot_f = fwd_slot(H);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int cols = H - col0 < kCols ? H - col0 : kCols;
  const bool w_whole = gridDim.y == 1;
  const int wpitch = w_whole ? H : kCols;
  const int64_t row_begin = B * blockIdx.x / gridDim.x;
  const int64_t row_end = B * (blockIdx.x + 1) / gridDim.x;
  const int n_tiles = static_cast<int>((row_end - row_begin + R - 1) / R);
  const int nk = (D + kWRows - 1) / kWRows;        // slices of w a tile
  constexpr int kAll = kLoaders + kMults;

  // values of d past D: zeros in every buffer, never written again
  for (int r = 0; r < bufs * R; ++r)
    for (int d = D + tid; d < lda; d += kAll) agg_s[r * lda + d] = 0.f;
  __syncthreads();

  if (tid < kLoaders) {
    for (int t = 0; t < n_tiles; ++t) {
      const int b = t % bufs;
      if (t >= bufs) bar_sync(kBarFree + b, kAll);
      const int64_t row0 = row_begin + static_cast<int64_t>(t) * R;
      const int rows = static_cast<int>(row_end - row0 < R ? row_end - row0
                                                            : R);
      load_tile<T, R, VEC>(neigh, agg_s + b * R * lda,
                        blockIdx.y == 0 ? agg_out : nullptr, row0, rows, F,
                        D, lda, ld_agg, tid);
      bar_arrive(kBarFull + b, kAll);
    }
    return;
  }

  const int mt = tid - kLoaders;                   // 0 .. kMults - 1
  const int mw = mt / 32;
  const int lane = mt % 32;
  const int tx = lane % 16;
  // rows 4 ty .. 4 ty + 3 of the tile, columns 4 tx + (0..3), 64 + 4 tx +
  // (0..3); rows kb .. kb + kKw of each slice of w
  const int ty = R == 32 ? mw * 2 + lane / 16 : lane / 16;
  const int kb = R == 32 ? 0 : mw * kKw;

  // slice q (of all tiles' slices in turn) of w into its slot, by the
  // multipliers with cp.async, as one group; rows past D are zeros
  auto issue = [&](int q) {
    const int k0 = (q % nk) * kWRows;
    float* slot = ring + (q % stages) * slot_f;
    if (w_whole) {
      const float* src = w + static_cast<int64_t>(k0) * H;
      const int n = (D - k0 < kWRows ? D - k0 : kWRows) * H;
      if constexpr (WVEC) {
        for (int i = mt * 4; i < kWRows * H; i += kMults * 4)
          cp_async<16>(slot + i, i < n ? src + i : w, i < n);
      } else {
        for (int i = mt; i < kWRows * H; i += kMults)
          cp_async<4>(slot + i, i < n ? src + i : w, i < n);
      }
    } else {
      for (int i = mt; i < kWRows * kCols; i += kMults) {
        const int k = k0 + i / kCols;
        const int h = i % kCols;
        const bool ok = k < D && h < cols;
        cp_async<4>(slot + i,
                    ok ? w + static_cast<int64_t>(k) * H + col0 + h : w, ok);
      }
    }
    cp_async_commit();
  };
  const int total = n_tiles * nk;
  for (int q = 0; q < stages - 1; ++q) {
    if (q < total) issue(q);
    else cp_async_commit();
  }

  float acc[4][8];
  for (int t = 0; t < n_tiles; ++t) {
    const int b = t % bufs;
    const float* a_t = agg_s + b * R * lda;
    bar_sync(kBarFull + b, kAll);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < nk; ++s) {
      const int q = t * nk + s;
      cp_async_wait(stages - 2);
      bar_sync(kBarMult, kMults);   // slice q landed; slot of q - 1 free
      if (q + stages - 1 < total) issue(q + stages - 1);
      else cp_async_commit();
      const float* w_s = ring + (q % stages) * slot_f;
      const int k0 = s * kWRows;
#pragma unroll
      for (int kq = 0; kq < kKw; kq += 4) {
        float4 a4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              a_t + (4 * ty + i) * lda + k0 + kb + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = w_s + (kb + kq + kk) * wpitch + 4 * tx;
          float bw[8];
          if constexpr (WVEC) {
            const float4 w0 = *reinterpret_cast<const float4*>(wr);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + 64);
            bw[0] = w0.x; bw[1] = w0.y; bw[2] = w0.z; bw[3] = w0.w;
            bw[4] = w1.x; bw[5] = w1.y; bw[6] = w1.z; bw[7] = w1.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bw[j] = wr[j];
              bw[4 + j] = wr[64 + j];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y
                          : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bw[j], acc[i][j]);
          }
        }
      }
    }
    const int64_t tile0 = row_begin + static_cast<int64_t>(t) * R;
    if constexpr (R == 8) {
      // the four warps' partial tiles, summed in warp order
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = red + (mw * 8 + 4 * ty + i) * kCols + 4 * tx;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 64) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      bar_sync(kBarMult, kMults);
      for (int e = mt; e < 8 * kCols; e += kMults) {
        const int r = e / kCols;
        const int h = e % kCols;
        const float sum = ((red[e] + red[8 * kCols + e]) +
                           red[16 * kCols + e]) + red[24 * kCols + e];
        if (tile0 + r < row_end && h < cols)
          out[(tile0 + r) * H + col0 + h] = from_f32<T>(sum);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = tile0 + 4 * ty + i;
        if (row >= row_end) break;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int h = 4 * tx + (j / 4) * 64 + j % 4;
          if (h < cols) out[row * H + col0 + h] = from_f32<T>(acc[i][j]);
        }
      }
    }
    // the loaders may refill this buffer (they wait only for tiles that
    // have one to come)
    if (t + bufs < n_tiles) bar_arrive(kBarFree + b, kAll);
  }
  cp_async_wait(0);
}

// Copies rows r0 .. r0 + kDwRows of this CTA's column ranges of agg
// (lda floats a row) and d_out into stage `st` (agg, then d_out, each
// kDwRows x kDwTile); rows past r_end and columns past D or H zero-fill.
__device__ __forceinline__ void dw_issue(
    float* st, const float* __restrict__ agg, int64_t lda,
    const float* __restrict__ d_out, int64_t r0, int64_t r_end, int d0,
    int h0, int D, int H, bool a_vec4, bool g_vec4) {
  const int tid = threadIdx.x;
  float* g_s = st + kDwRows * kDwTile;
  if (a_vec4) {
    for (int c = tid; c < kDwRows * kDwTile / 4; c += kThreads) {
      const int r = c / (kDwTile / 4);
      const int j = (c % (kDwTile / 4)) * 4;
      const bool ok = r0 + r < r_end && d0 + j < D;
      cp_async<16>(st + r * kDwTile + j, ok ? agg + (r0 + r) * lda + d0 + j
                                            : agg, ok);
    }
  } else {
    for (int c = tid; c < kDwRows * kDwTile; c += kThreads) {
      const int r = c / kDwTile;
      const int j = c % kDwTile;
      const bool ok = r0 + r < r_end && d0 + j < D;
      cp_async<4>(st + c, ok ? agg + (r0 + r) * lda + d0 + j : agg, ok);
    }
  }
  if (g_vec4) {
    for (int c = tid; c < kDwRows * kDwTile / 4; c += kThreads) {
      const int r = c / (kDwTile / 4);
      const int j = (c % (kDwTile / 4)) * 4;
      const bool ok = r0 + r < r_end && h0 + j < H;
      cp_async<16>(g_s + r * kDwTile + j,
                   ok ? d_out + (r0 + r) * H + h0 + j : d_out, ok);
    }
  } else {
    for (int c = tid; c < kDwRows * kDwTile; c += kThreads) {
      const int r = c / kDwTile;
      const int j = c % kDwTile;
      const bool ok = r0 + r < r_end && h0 + j < H;
      cp_async<4>(g_s + c, ok ? d_out + (r0 + r) * H + h0 + j : d_out, ok);
    }
  }
}

// d_w's partial over one range of rows for one tile; the cluster's CTAs
// (consecutive ranges of the same tile) then sum their partials in rank
// order through distributed shared memory, and rank q writes rows
// q kDwTile / C .. of the sum to `dst` (d_w, or the cluster's slice of
// the scratch when a tile has more than one cluster)
__global__ void __launch_bounds__(kThreads, 1)
sage_dw_kernel(const float* __restrict__ agg, int64_t lda,
               const float* __restrict__ d_out, float* __restrict__ d_w,
               float* __restrict__ scratch, int64_t B, int D, int H,
               int64_t rows_per_split, bool a_vec4, bool g_vec4) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = 2 * kDwRows * kDwTile;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d0 = blockIdx.x * kDwTile;
  const int h0 = blockIdx.y * kDwTile;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * rows_per_split;
  const int64_t r_end0 = r_begin + rows_per_split;
  const int64_t r_end = r_end0 < B ? r_end0 : B;
  const int total = r_end > r_begin
      ? static_cast<int>((r_end - r_begin + kDwRows - 1) / kDwRows) : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < total)
      dw_issue(smem + s * kStage, agg, lda, d_out, r_begin + s * kDwRows,
               r_end, d0, h0, D, H, a_vec4, g_vec4);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait(kDwStages - 2);
    __syncthreads();   // stage `it` landed; stage it - 1 is free again
    {
      const int nx = it + kDwStages - 1;
      if (nx < total)
        dw_issue(smem + (nx % kDwStages) * kStage, agg, lda, d_out,
                 r_begin + static_cast<int64_t>(nx) * kDwRows, r_end, d0,
                 h0, D, H, a_vec4, g_vec4);
      cp_async_commit();
    }
    const float* a_s = smem + (it % kDwStages) * kStage;
    const float* g_s = a_s + kDwRows * kDwTile;
#pragma unroll 8
    for (int r = 0; r < kDwRows; ++r) {
      const float* ar = a_s + r * kDwTile + 4 * ty;
      const float* gr = g_s + r * kDwTile + 4 * tx;
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
  }
  cp_async_wait(0);
  __syncthreads();     // the ring is free: it takes the partial tile
  float* part = smem;  // [kDwTile][kDwTile], d major
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = part + (4 * ty + 64 * (i / 4) + i % 4) * kDwTile + 4 * tx;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 64) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();      // every partial of the cluster is written
  const int rows = kDwTile / C;
  float* out = scratch == nullptr
      ? d_w
      : scratch + static_cast<int64_t>(blockIdx.z / C) * D * H;
  for (int e = tid; e < rows * kDwTile / 4; e += kThreads) {
    const int dl = rank * rows + e / (kDwTile / 4);
    const int hl = (e % (kDwTile / 4)) * 4;
    const int idx = dl * kDwTile + hl;
    // every rank's float4 first, then their sum in rank order
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + idx);
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < C) {
        sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w;
      }
    if (d0 + dl >= D) continue;
    const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
    float* row = out + static_cast<int64_t>(d0 + dl) * H + h0 + hl;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (h0 + hl + j < H) row[j] = sv[j];
  }
  cluster.sync();      // no CTA leaves while another reads its partial
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

// Whether w's and d_out's rows are staged as the runs of floats they are
// in memory (H odd and one chunk) rather than row by row
__host__ __device__ __forceinline__ bool dn_runs(int H) {
  return H <= kDnKH && H % 2 == 1;
}
// Floats between the rows of w and d_out staged row by row: a chunk of kh
// values of h rounded up to an odd multiple of 4 (4 mod 8), so that 8
// consecutive rows' float4 loads fall in 8 different 16-byte bank groups.
__host__ __device__ __forceinline__ int dn_ld(int H) {
  const int kh = H < kDnKH ? H : kDnKH;
  const int ld = (kh + 3) / 4 * 4;
  return ld % 8 == 0 ? ld + 4 : ld;
}
// Floats of shared memory that hold a run of n floats staged by
// stage_run: up to 3 before it, rounded up to 16 bytes
__host__ __device__ __forceinline__ int dn_run(int n) {
  return (n + 3 + 3) / 4 * 4;
}
// d_neigh's shared memory for a tile of `rows` rows: the runs of w's
// kDnCols rows and d_out's `rows` rows, or those rows of a chunk of H, ld
// floats apart
__host__ __device__ __forceinline__ size_t dn_smem(int rows, int H) {
  return sizeof(float) *
         (dn_runs(H) ? static_cast<size_t>(dn_run(kDnCols * H) +
                                           dn_run(rows * H))
                     : static_cast<size_t>(kDnCols + rows) * dn_ld(H));
}

// `n` floats from `src` (4-byte aligned) into shared memory at `flat`
// (16-byte aligned): float k lands at flat[pad + k], pad being src's
// offset in floats past 16 bytes, so that its 16-byte pieces land 16-byte
// aligned; a piece wholly inside the run is one 16-byte cp.async, the
// run's ends 4-byte ones. Returns pad.
__device__ __forceinline__ int stage_run(float* flat, const float* src,
                                         int n) {
  const int pad =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const float* base = src - pad;
  for (int k0 = 4 * threadIdx.x; k0 < pad + n; k0 += 4 * kDnThreads) {
    if (k0 >= pad && k0 + 4 <= pad + n) {
      cp_async<16>(flat + k0, base + k0, true);
    } else {
      for (int k = k0; k < k0 + 4; ++k)
        if (k >= pad && k < pad + n) cp_async<4>(flat + k, base + k, true);
    }
  }
  return pad;
}

// See the header. RR rows a thread: the CTA's tile is RR * kDnThreads /
// kDnCols rows of kDnCols columns.
template <int RR>
__global__ void __launch_bounds__(kDnThreads)
sage_dneigh_kernel(const float* __restrict__ d_out,
                   const float* __restrict__ w, float* __restrict__ d_neigh,
                   int64_t B, int F, int D, int H) {
  constexpr int rows = RR * kDnThreads / kDnCols;
  extern __shared__ __align__(16) float smem[];
  // H odd and one chunk: w's rows d0 .. d0 + nc and d_out's rows b0 .. b0
  // + nr are read as the runs of floats they are in memory
  const bool run = dn_runs(H);
  const int ld = dn_ld(H);
  float* w_s = smem;   // w's run, or its rows [kDnCols][ld]
  float* g_s = smem + (run ? dn_run(kDnCols * H) : kDnCols * ld);  // d_out's
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dl = tid % kDnCols;          // this thread's column
  const int r0 = tid / kDnCols * RR;     // and its rows r0 .. r0 + RR - 1
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int d0 = blockIdx.y * kDnCols;
  const int nr = static_cast<int>(B - b0 < rows ? B - b0 : rows);
  const int nc = D - d0 < kDnCols ? D - d0 : kDnCols;
  const float f_div = static_cast<float>(F);

  float acc[RR];
#pragma unroll
  for (int i = 0; i < RR; ++i) acc[i] = 0.f;
  for (int h0 = 0; h0 < H; h0 += kDnKH) {
    const int kh = H - h0 < kDnKH ? H - h0 : kDnKH;
    const int kp = (kh + 3) / 4 * 4;
    int wp = 0, gp = 0;
    if (run) {
      wp = stage_run(w_s, w + static_cast<int64_t>(d0) * H, nc * H);
      gp = stage_run(g_s, d_out + b0 * H, nr * H);
    } else {
      // rows d0 .. d0 + kDnCols of w, then rows b0 .. b0 + rows of d_out,
      // values h0 .. h0 + kp, into rows of ld floats, a row a warp, 4
      // bytes a copy; zeros past D, B or H
      for (int r = warp; r < kDnCols + rows; r += kDnThreads / 32) {
        const bool is_w = r < kDnCols;
        const bool row_ok = is_w ? r < nc : r - kDnCols < nr;
        const float* src = is_w ? w + static_cast<int64_t>(d0 + r) * H + h0
                                : d_out + (b0 + r - kDnCols) * H + h0;
        for (int h = lane; h < kp; h += 32) {
          const bool ok = row_ok && h < kh;
          cp_async<4>(w_s + r * ld + h, ok ? src + h : w, ok);
        }
      }
    }
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    // the product, h ascending
    if (run) {
      // a lane's row of w is H floats past its neighbour's, in 32
      // different banks; d_out's rows are read as broadcasts
      const float* wr = w_s + wp + dl * H;
      const float* gr = g_s + gp + r0 * H;
      for (int h = 0; h < H; ++h) {
        const float wv = wr[h];
#pragma unroll
        for (int i = 0; i < RR; ++i)
          acc[i] = fmaf(gr[i * H + h], wv, acc[i]);
      }
    } else {
      const float* wr = w_s + dl * ld;
      for (int h = 0; h < kp; h += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr + h);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(g_s + (r0 + i) * ld + h);
          acc[i] = fmaf(g4.x, w4.x, acc[i]);
          acc[i] = fmaf(g4.y, w4.y, acc[i]);
          acc[i] = fmaf(g4.z, w4.z, acc[i]);
          acc[i] = fmaf(g4.w, w4.w, acc[i]);
        }
      }
    }
    __syncthreads();   // the chunk is read; the next may overwrite it
  }

  // the stores, straight from registers: each (row, f) a warp's 32
  // consecutive floats
  if (dl >= nc) return;
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    if (r0 + i >= nr) break;
    const float v = acc[i] / f_div;
    float* dst = d_neigh + (b0 + r0 + i) * F * D + d0 + dl;
    for (int f = 0; f < F; ++f)
      dst[static_cast<int64_t>(f) * D] = v;
  }
}

unsigned blocks(int64_t n, int64_t per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid,
                           dim3 cluster, size_t smem, cudaStream_t s,
                           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr size_t kDwSmem = sizeof(float) * kDwStages * 2 * kDwRows * kDwTile;

// w (n bf16) widened into w32 (n floats), 4 elements a thread
__global__ void __launch_bounds__(256)
widen_w_kernel(const __nv_bfloat16* __restrict__ w, float* __restrict__ w32,
               int64_t n) {
  const int64_t i = 4 * (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < n) w32[i + k] = __bfloat162float(w[i + k]);
}

template <typename T, int R, int VEC, bool WVEC>
cudaError_t launch_fwd(dim3 grid, size_t smem, cudaStream_t s,
                       const void* neigh, const float* w, void* out,
                       float* agg, int64_t B, int F, int D, int H, int ld_agg,
                       int bufs, int stages) {
  cudaError_t err = cudaFuncSetAttribute(
      sage_fwd_kernel<T, R, VEC, WVEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sage_fwd_kernel<T, R, VEC, WVEC><<<grid, kLoaders + kMults, smem, s>>>(
      static_cast<const T*>(neigh), w, static_cast<T*>(out), agg, B, F, D, H,
      ld_agg, bufs, stages);
  return cudaGetLastError();
}

// d_neigh's grid: a CTA a tile of RR * kDnThreads / kDnCols rows and
// kDnCols columns
template <int RR>
cudaError_t launch_dneigh(cudaStream_t s, const float* d_out, const float* w,
                          float* d_neigh, int64_t B, int F, int D, int H) {
  constexpr int rows = RR * kDnThreads / kDnCols;
  const dim3 grid(blocks(B, rows), blocks(D, kDnCols));
  sage_dneigh_kernel<RR><<<grid, kDnThreads, dn_smem(rows, H), s>>>(
      d_out, w, d_neigh, B, F, D, H);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each returns a cudaError_t (0 = done);
// the launches go on `stream`. The plan (the forward's rows a tile, CTAs,
// values of f a piece, stages, the width of its loads of neigh; d_w's
// ranges of rows and their clusters) comes from the host
// (repro_torch/kernels/sage_aggregate.py); a plan the kernels do not take
// returns cudaErrorInvalidValue and launches nothing.

// The most clusters of `cluster` d_w CTAs that can run at once.
extern "C" int sage_dw_max_clusters(int32_t cluster, int32_t* n) {
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sage_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDwSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kDwSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int m = 0;
  err = cudaOccupancyMaxActiveClusters(&m, sage_dw_kernel, &cfg);
  *n = m;
  return static_cast<int>(err);
}

// w32 (n floats) = w (n bf16), widened (exact): the f32 w that
// sage_aggregate_fwd reads for a bf16 w.
extern "C" int sage_widen_w(const void* w, float* w32, int64_t n,
                            void* stream) {
  if (n == 0) return 0;
  if (n < 0 || !aligned(w, 2) || !aligned(w32, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  widen_w_kernel<<<blocks(n, 4 * 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w), w32, n);
  return static_cast<int>(cudaGetLastError());
}

// out (B, H) = mean_f(neigh) @ w over `ctas` x ceil(H / 128) CTAs of
// tiles of `rows` rows (8 or 32) in `bufs` (1 or 2) buffers, a ring of
// `stages` slices of w and loads of `vec` elements of neigh; neigh and
// out f32 (`neigh_bf16` 0) or bf16 (1); vec 4, 2 or 1 for f32, 8, 2 or 1
// for bf16 (16-, 4- or 2-byte loads of bf16), D % vec == 0 and neigh
// aligned to a load; `agg` (B rows of ld_agg floats) receives the f32
// aggregate when it is not null. w is f32 (a bf16 w is widened first by
// sage_widen_w).
extern "C" int sage_aggregate_fwd(const void* neigh, const float* w,
                                  void* out, float* agg, int64_t B,
                                  int32_t F, int32_t D, int32_t H,
                                  int32_t ld_agg, int32_t rows, int32_t bufs,
                                  int32_t ctas, int32_t stages, int32_t vec,
                                  int32_t neigh_bf16, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int elem = neigh_bf16 ? 2 : 4;
  const bool vec_ok = neigh_bf16 ? (vec == 8 || vec == 2 || vec == 1)
                                 : (vec == 4 || vec == 2 || vec == 1);
  if (F < 1 || D < 1 || (rows != 8 && rows != 32) ||
      (bufs != 1 && bufs != 2) || ctas < 1 || ctas > B || stages < 2 ||
      stages > kMaxStages || !vec_ok || D % vec != 0 ||
      !aligned(neigh, elem * vec) || !aligned(w, 4) ||
      (agg != nullptr && ld_agg < D))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(rows, bufs, D, H, stages);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = w;
  const dim3 grid(ctas, blocks(H, kCols));
  const bool wvec = H % 4 == 0 && aligned(wf, 16);
#define SAGE_FWD(T_, R_, V_)                                                \
  if (rows == R_ && vec == V_)                                              \
    return static_cast<int>(                                                \
        wvec ? launch_fwd<T_, R_, V_, true>(grid, smem, s, neigh, wf, out,  \
                                            agg, B, F, D, H, ld_agg, bufs,  \
                                            stages)                         \
             : launch_fwd<T_, R_, V_, false>(grid, smem, s, neigh, wf, out, \
                                             agg, B, F, D, H, ld_agg, bufs, \
                                             stages));
  if (neigh_bf16) {
    SAGE_FWD(__nv_bfloat16, 32, 8) SAGE_FWD(__nv_bfloat16, 32, 2)
    SAGE_FWD(__nv_bfloat16, 32, 1) SAGE_FWD(__nv_bfloat16, 8, 8)
    SAGE_FWD(__nv_bfloat16, 8, 2) SAGE_FWD(__nv_bfloat16, 8, 1)
  } else {
    SAGE_FWD(float, 32, 4) SAGE_FWD(float, 32, 2) SAGE_FWD(float, 32, 1)
    SAGE_FWD(float, 8, 4) SAGE_FWD(float, 8, 2) SAGE_FWD(float, 8, 1)
  }
#undef SAGE_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// d_w (D, H) = agg^T d_out when `d_w` is not null: `splits` ranges of
// rows per 128 x 128 tile, in clusters of `cluster` (1, 2, 4 or 8);
// `scratch` holds splits / cluster partial sums of (D, H) when that is
// more than 1 (else it may be null). agg's rows are lda floats apart.
// Without d_w, the split and scratch are not read.
// d_neigh (B, F, D) = (d_out w^T) / F broadcast over f when `d_neigh` is
// not null, `dn_rr` (1 or 2) rows of it a thread.
extern "C" int sage_aggregate_bwd(const float* d_out, const float* w,
                                  const float* agg, int64_t lda, float* d_w,
                                  float* scratch, float* d_neigh, int64_t B,
                                  int32_t F, int32_t D, int32_t H,
                                  int32_t splits, int32_t cluster,
                                  int32_t dn_rr, void* stream) {
  if (F < 1 || D < 1 ||
      (d_w != nullptr &&
       (splits < 1 || splits > 65535 || cluster < 1 ||
        cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
        splits % cluster != 0 || (splits > cluster && scratch == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_neigh != nullptr && dn_rr != 1 && dn_rr != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_w != nullptr && H > 0) {
    if (lda < D) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t rows_per_split = (B + splits - 1) / splits;
    const bool a_vec4 = lda % 4 == 0 && aligned(agg, 16);
    const bool g_vec4 = H % 4 == 0 && aligned(d_out, 16);
    const bool two_pass = splits > cluster;
    cudaError_t err = launch_cluster(
        sage_dw_kernel, dim3(blocks(D, kDwTile), blocks(H, kDwTile), splits),
        dim3(1, 1, cluster), kDwSmem, s, agg, lda, d_out, d_w,
        two_pass ? scratch : nullptr, B, D, H, rows_per_split, a_vec4,
        g_vec4);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (two_pass) {
      const int64_t n = static_cast<int64_t>(D) * H;
      sage_dw_reduce_kernel<<<blocks(n, 256), 256, 0, s>>>(
          scratch, d_w, n, splits / cluster);
    }
  }
  if (d_neigh != nullptr && B > 0)
    return static_cast<int>(
        dn_rr == 1 ? launch_dneigh<1>(s, d_out, w, d_neigh, B, F, D, H)
                   : launch_dneigh<2>(s, d_out, w, d_neigh, B, F, D, H));
  return static_cast<int>(cudaGetLastError());
}
