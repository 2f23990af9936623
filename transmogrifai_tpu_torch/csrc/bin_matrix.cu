// bin_matrix: quantile bin of every element of a float32 design matrix
// x [n, d] against per-column edges [d, E]:
//
//   bin[i, j] = #{e : edges[j, e] < x[i, j]}   (np.searchsorted side='left')
//   bin[i, j] = #{e : edges[j, e] is not NaN}  where x[i, j] is NaN
//
// written directly in the tree learner's device dtype (int8 when every bin
// id fits, else int32), which folds the JAX package's separate int8 cast
// (trees._bins_cast) into the one pass.
//
// Replaces the TPU kernel transmogrifai_tpu/parallel/pallas_kernels.py:
// _bin_pallas (body _bin_kernel_body), which walks 512-row tiles of x with
// the columns padded to 128 lanes and the edges transposed to [E, D] in
// VMEM, comparing every element with all E edges.
//
// Bound on the H100: the pass must read x once and write the bins once,
// 4 * n * d bytes in and n * d (int8) or 4 * n * d (int32) out, plus the
// edges: at 10M x 39 with int8, 1.95 GB, 0.58 ms at 3.35 TB/s.  That is
// about 2.9 elements per clock on each of the 132 SMs, so the arithmetic
// must stay near 30 instructions an element or the SMs' dispatch rate
// (4 warp instructions a clock) binds first: a count over all 31 edges,
// ~70 instructions an element, cannot reach the byte bound.  Below ~1M
// elements the bound is under 1.5 us and the launch itself binds: a
// serving batch of 1-128 rows x 7 is 7-896 elements.  The design:
//
//   tiles   x is one contiguous stream of n * d floats, cut into fixed
//           16 KB tiles (kTileWords floats).  The tiles need not hold whole
//           rows: the column of word w is w mod d, tracked by
//           increment-and-wrap from the tile's first column.
//   ring    (bin_tiles_kernel) block b takes the tiles b, b + G, ...; G is
//           as many blocks as fit on each SM times the SMs, and never more
//           than the tiles.  One thread keeps a ring of kStages tiles in
//           flight with 1-D TMA bulk copies completing on mbarriers
//           (tile_ring.cuh); a block stages the edge table once.
//   small   (bin_small_kernel) a launch of a few tiles would pipeline
//           nothing on the ring and waits on its barriers, its producer
//           thread and its 64 KB of shared memory.  So this route is a
//           separate kernel with a smaller plan: kSmallWords = 1 024-word
//           (4 KB) tiles, a block a tile and one float4 a thread, so that
//           the grid is never larger than the work, no block stages the
//           edges without words to bin (a body of < 4 words gives one
//           block, for the unaligned words alone), and the work spreads
//           over as many SMs as it can fill.  A thread issues its float4
//           load (and block 0 its head or tail word) at entry, so that the
//           read overlaps the staging of the edges, the only dynamic
//           shared memory; then it searches its four words in lockstep
//           (below).  At one row the launch itself is most of the time:
//           the empty-launch floor (tx_bin_matrix_floor) measures it.
//   which   every small block stages the whole edge table (d * (P + 1)
//           words) for its 4 KB of x, so the small route runs while its
//           blocks stage at most kSmallStageWords = 8 Mi table words in
//           all and, past one wave of resident blocks, at most
//           kSmallWaveWords = 2 Mi a wave; else the ring.  Both limits are
//           crossovers measured on an H100 with each route forced at the
//           same shapes (kernel_ab.py routes; 31 edges; cold ms, small /
//           ring).  In all: 4M x 7 0.0709 / 0.0718, 7M x 7 0.1221 /
//           0.1210; 2.5M x 9 0.0609 / 0.0657, 10M x 9 0.2298 / 0.2229; 1M
//           x 15 0.0463 / 0.0479, 1.5M x 15 0.0671 / 0.0659; 0.1M x 39
//           0.0195 / 0.0201, 0.25M x 39 0.0434 / 0.0387, 10M x 39 1.537 /
//           0.971.  A wave: 100 columns (3.5 Mi words a wave) 10k rows,
//           one wave, 0.0130 / 0.0132, 20k rows 0.0204 / 0.0184; 256
//           columns 3 000 rows 0.0193 / 0.0207, 3 200 rows (one wave and
//           8 blocks) 0.0269 / 0.0205; 538 columns 750 rows 0.0313 /
//           0.0330, 760 rows 0.0466 / 0.0331.  The limits' largest misses
//           there: 11k x 100 (just past a wave) 0.0145 / 0.0165 and 270M x
//           1 (past all) 0.5746 / 0.6216 take the ring, 25k x 60 0.0133 /
//           0.0128 the small kernel; within 3% at every other shape
//           measured.
//   lanes   thread l reads tile words 4l..4l+3, 4l+4T.., one float4 at a
//           time: neighbouring lanes read neighbouring 16 bytes (no bank
//           conflicts for any d) and write neighbouring bins, 4 bytes
//           (int8) or 16 bytes (int32) a thread, so a warp stores 128 or
//           512 contiguous bytes.
//   search  the block stages each column's edges into shared memory at a
//           row stride of P + 1 words (P the power of two above E, at
//           least 32; odd, so that the lanes' columns fall in different
//           banks), NaN-padded to P - 1 entries, with an info word (the
//           non-NaN count and a flag) in slot P - 1, which a warp a row
//           computes with ballots as it stages the row (one barrier).  The
//           flag says that the row is a non-decreasing non-NaN prefix
//           followed by NaN, which is what quantile_bin_edges gives: for
//           such a row "edge < x" is true on a prefix, and a branch-free
//           lower_bound over the P - 1 slots finds its length in log2(P)
//           steps (5 at E = 31) - NaN pads compare false.  The small kernel
//           runs a thread's four searches in lockstep, a step of all four
//           at a time, so that their shared-memory reads overlap (a search
//           a word, each behind its NaN branch, queues them one after
//           another: a build that did so, timed beside this one on an
//           H100, took longer at 1-180k rows).  Any other row (unsorted, NaN inside)
//           keeps the exact compare-count over its E edges: a branch on a
//           property of the input, not a fallback.
//   edges   x words before the first 16-byte-aligned one (a row-offset
//           view such as x[3:]) and the last < 4 words are binned by block
//           0 straight from global memory; then stores are scalar, as the
//           bins' words are not 4-aligned either.
//
// Edge tables larger than the shared memory left beside the ring (d * (P +
// 1) * 4 bytes above ~160 KB) go to the column-tiled kernel of the first
// version (bin_coltile_kernel): a grid of row blocks x column tiles, as
// many columns as fit their edges in 48 KB, a linear count.
//
// Bins are exact for any edge row (unsorted, duplicated, +-inf, -0.0, NaN
// anywhere) and bit-identical from launch to launch.  Offsets are 64-bit;
// rows past n and columns past d are never read or written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kTileWords = 4096;  // 16 KB of x a tile
constexpr long long kRingBytes = 4LL * kStages * kTileWords;
// dynamic shared memory a block may take on the H100 (227 KB), less room
// for the static barriers
constexpr long long kDynSmemMax = 227 * 1024 - 1024;
constexpr int kMinSteps = 5;  // P >= 32: E <= 31 takes the unrolled search
// the small route's tile of x: one float4 a thread
constexpr int kSmallWords = 4 * kThreads;
// the small route's limits (each of its blocks stages the whole edge
// table for its kSmallWords words of x): the table words its blocks stage
// in all, and, past one wave of resident blocks, in each wave
constexpr long long kSmallStageWords = 8LL << 20;
constexpr long long kSmallWaveWords = 2LL << 20;
// the column-tiled kernel
constexpr int kColRows = 4;             // rows per thread
constexpr int kItemsPerBlock = 2048;    // (row group, column) items per block
constexpr long long kColSmemBytes = 48 * 1024;  // needs no opt-in attribute
// the C entry's own error codes; CUDA's are >= 0
constexpr int kErrEdges = -1;  // one column's edges exceed kColSmemBytes
constexpr int kErrGrid = -2;   // the grid would pass its limits
constexpr int kErrRoute = -3;  // a route forced on a column-tiled plan

struct BinPlan {
  long long n_words;   // n * d
  long long head;      // words before the 16-byte-aligned body
  long long body_end;  // head + a multiple of 4 words
  long long n_tiles;   // kTileWords-word tiles of the body
  int d, n_edges, steps, vec_out;
};

enum Route { kRing, kSmall, kColTiles };
constexpr int kPlanned = -1;  // the plan's own route, none forced

// a launch of one route, as plan_launch gives it
struct Launch {
  Route route;
  dim3 grid;
  size_t smem;
  BinPlan plan;                // the ring and small routes
  int tile_w, rows_per_block;  // the column-tiled route
};

// bin of v against the staged edge row `row` (stride P + 1, P = 2^steps)
template <int kSteps>
__device__ __forceinline__ int bin_of(const float* row, float v, int steps,
                                      int n_edges, bool all_sorted) {
  const int p = 1 << (kSteps ? kSteps : steps);
  if (isnan(v)) return __float_as_int(row[p - 1]) >> 1;
  if (all_sorted || (__float_as_int(row[p - 1]) & 1)) {
    int pos = 0;
    if (kSteps) {
#pragma unroll
      for (int s = p >> 1; s > 0; s >>= 1) pos += (row[pos + s - 1] < v) ? s : 0;
    } else {
      for (int s = p >> 1; s > 0; s >>= 1) pos += (row[pos + s - 1] < v) ? s : 0;
    }
    return pos;
  }
  int k = 0;
  for (int e = 0; e < n_edges; ++e) k += (row[e] < v) ? 1 : 0;
  return k;
}

// stages the edges into table rows of stride P + 1, NaN-padded to P - 1
// entries, and each row's info word (2 * non-NaN count + sorted flag) in
// slot P - 1, a warp a row: lane j loads edge j and compares it with its
// left neighbour's by a shuffle, and ballots count the row; a row is sorted
// when no non-NaN edge follows a NaN or a larger edge.  One barrier, which
// also says whether every row is sorted (the return value).  Slot P of a
// row is padding that no search reads.
__device__ __forceinline__ bool stage_table(const float* __restrict__ edges,
                                            float* table, int d, int n_edges,
                                            int P) {
  const int tid = threadIdx.x, stride = P + 1;
  const int warps = blockDim.x / 32, lane = tid & 31;
  bool mine_sorted = true;
  for (int c = tid / 32; c < d; c += warps) {
    const float* src = edges + (long long)c * n_edges;
    float* row = table + c * stride;
    int valid = 0;
    bool sorted = true;
    float carry = NAN;  // the previous chunk's last edge
    for (int j0 = 0; j0 < P; j0 += 32) {
      const int j = j0 + lane;
      const float v = j < n_edges ? __ldg(src + j) : NAN;
      row[j] = v;
      float left = __shfl_up_sync(0xffffffffu, v, 1);
      if (lane == 0) left = carry;
      const bool edge = !isnan(v);
      const bool bad = edge && j > 0 && !(left <= v);
      valid += __popc(__ballot_sync(0xffffffffu, edge));
      sorted = sorted && !__any_sync(0xffffffffu, bad);
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();  // the pad in slot P - 1 is written before the info
    if (lane == 0) row[P - 1] = __int_as_float(2 * valid + (sorted ? 1 : 0));
    mine_sorted = mine_sorted && sorted;
  }
  return __syncthreads_and(mine_sorted) != 0;
}

// the unaligned head and the < 4-word tail: thread t < head + tail holds
// word edge_word(p, t)
__device__ __forceinline__ long long edge_word(const BinPlan& p, int t) {
  return t < p.head ? t : p.body_end + (t - p.head);
}

__device__ __forceinline__ bool holds_edge_word(const BinPlan& p) {
  return blockIdx.x == 0 &&
         threadIdx.x < p.head + (p.n_words - p.body_end);
}

// the bin of this thread's head or tail word, whose value is v
template <typename OutT, int kSteps>
__device__ __forceinline__ void bin_edge_word(const BinPlan& p, float v,
                                              const float* table, int steps,
                                              bool uniform, OutT* out) {
  const long long g = edge_word(p, threadIdx.x);
  const int c = (int)(g % p.d);
  out[g] = (OutT)bin_of<kSteps>(table + c * ((1 << steps) + 1), v, steps,
                                p.n_edges, uniform);
}

template <typename OutT>
__device__ __forceinline__ void store4(OutT* out, long long g, int a, int b,
                                       int c, int e, bool vec) {
  if (vec) {
    if (sizeof(OutT) == 1) {
      *reinterpret_cast<uint32_t*>(out + g) =
          (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
          ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(e & 0xff) << 24);
    } else {
      *reinterpret_cast<int4*>(out + g) = make_int4(a, b, c, e);
    }
  } else {
    out[g] = (OutT)a;
    out[g + 1] = (OutT)b;
    out[g + 2] = (OutT)c;
    out[g + 3] = (OutT)e;
  }
}

template <typename OutT, int kSteps>
__global__ void __launch_bounds__(kThreads)
    bin_tiles_kernel(const float* __restrict__ x,
                     const float* __restrict__ edges, BinPlan p,
                     OutT* __restrict__ out) {
  extern __shared__ __align__(128) float bin_smem[];
  float* ring = bin_smem;                            // [kStages][kTileWords]
  float* table = bin_smem + kStages * kTileWords;    // [d][P + 1]
  __shared__ uint64_t bars[kStages];

  const int tid = threadIdx.x;
  const long long G = gridDim.x, b = blockIdx.x;
  const int steps = kSteps ? kSteps : p.steps;
  const int P = 1 << steps;
  const int stride = P + 1;
  const int d = p.d, n_edges = p.n_edges;

  auto load_tile = [&](long long t, int s) {
    const long long g0 = p.head + t * kTileWords;
    const long long words = min((long long)kTileWords, p.body_end - g0);
    tx::ring_load(ring + s * kTileWords, x + g0, (uint32_t)(4 * words),
                   &bars[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) tx::mbar_init(&bars[s], 1);
    tx::fence_mbar_init();
    for (int k = 0; k < kStages && b + k * G < p.n_tiles; ++k) {
      load_tile(b + k * G, k);
    }
  }

  const bool uniform = stage_table(edges, table, d, n_edges, P);
  if (holds_edge_word(p)) {
    bin_edge_word<OutT, kSteps>(p, x[edge_word(p, tid)], table, steps,
                                uniform, out);
  }

  const int dstride = d * stride;
  const int step = ((4 * kThreads) % d) * stride;
  const int adv = (int)(((long long)G * kTileWords) % d);
  int c0 = (int)((p.head + b * kTileWords) % d);  // this tile's first column
  for (long long k = 0;; ++k) {
    const long long t = b + k * G;
    if (t >= p.n_tiles) break;
    const int s = (int)(k % kStages);
    tx::mbar_wait(&bars[s], (uint32_t)((k / kStages) & 1));
    const long long g0 = p.head + t * kTileWords;
    const int words = (int)min((long long)kTileWords, p.body_end - g0);
    const float4* tile = reinterpret_cast<const float4*>(ring + s * kTileWords);
    int cb = ((c0 + 4 * tid) % d) * stride;
    for (int i = 4 * tid; i < words; i += 4 * kThreads) {
      const float4 v = tile[i >> 2];
      const int cb1 = cb + stride == dstride ? 0 : cb + stride;
      const int cb2 = cb1 + stride == dstride ? 0 : cb1 + stride;
      const int cb3 = cb2 + stride == dstride ? 0 : cb2 + stride;
      store4(out, g0 + i,
             bin_of<kSteps>(table + cb, v.x, steps, n_edges, uniform),
             bin_of<kSteps>(table + cb1, v.y, steps, n_edges, uniform),
             bin_of<kSteps>(table + cb2, v.z, steps, n_edges, uniform),
             bin_of<kSteps>(table + cb3, v.w, steps, n_edges, uniform),
             p.vec_out != 0);
      cb += step;
      if (cb >= dstride) cb -= dstride;
    }
    c0 += adv;
    if (c0 >= d) c0 -= d;
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && t + kStages * G < p.n_tiles) {
      tx::fence_proxy_async();
      load_tile(t + kStages * G, s);
    }
  }
}

template <typename OutT, int kSteps>
__global__ void __launch_bounds__(kThreads)
    bin_small_kernel(const float* __restrict__ x,
                     const float* __restrict__ edges, BinPlan p,
                     OutT* __restrict__ out) {
  extern __shared__ __align__(128) float bin_smem[];  // [d][P + 1]
  float* table = bin_smem;

  const int tid = threadIdx.x;
  const int steps = kSteps ? kSteps : p.steps;
  const int P = 1 << steps;
  const int stride = P + 1;
  const int d = p.d, n_edges = p.n_edges;
  const long long g0 = p.head + (long long)blockIdx.x * kSmallWords;
  const int i = 4 * tid;  // this thread's first word in the tile
  const bool live = g0 + i < p.body_end;

  // the float4 (and the head or tail word) first: the read's latency
  // overlaps the staging below
  const float4 v = live ? __ldg(reinterpret_cast<const float4*>(x + g0 + i))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool edge_word_held = holds_edge_word(p);
  const float edge_v = edge_word_held ? __ldg(x + edge_word(p, tid)) : 0.f;
  const bool uniform = stage_table(edges, table, d, n_edges, P);
  if (edge_word_held) {
    bin_edge_word<OutT, kSteps>(p, edge_v, table, steps, uniform, out);
  }
  if (!live) return;

  // each word's edge row
  const int dstride = d * stride;
  const float val[4] = {v.x, v.y, v.z, v.w};
  int row[4], bin[4];
  row[0] = (int)((g0 + i) % d) * stride;
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    row[e] = row[e - 1] + stride == dstride ? 0 : row[e - 1] + stride;
  }
  if (uniform) {
    // every row a sorted prefix: the branch-free lower_bound of the four
    // words in lockstep, so that their shared-memory reads overlap instead
    // of queueing one search behind another
#pragma unroll
    for (int e = 0; e < 4; ++e) bin[e] = 0;
#pragma unroll
    for (int s = P >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bin[e] += (table[row[e] + bin[e] + s - 1] < val[e]) ? s : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (isnan(val[e])) bin[e] = __float_as_int(table[row[e] + P - 1]) >> 1;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bin[e] = bin_of<kSteps>(table + row[e], val[e], steps, n_edges, false);
    }
  }
  store4(out, g0 + i, bin[0], bin[1], bin[2], bin[3], p.vec_out != 0);
}

// the launch plan's measure: an empty kernel at the same grid, threads and
// dynamic shared memory
__global__ void empty_kernel() {}

template <typename OutT>
__global__ void bin_coltile_kernel(const float* __restrict__ x,
                                   const float* __restrict__ edges,
                                   long long n, int d, int n_edges, int tile_w,
                                   int rows_per_block, OutT* __restrict__ out) {
  extern __shared__ __align__(128) float bin_smem[];  // [E][tw], [tile_w] counts
  float* sh = bin_smem;
  int* nan_free = reinterpret_cast<int*>(sh + (size_t)n_edges * tile_w);
  const int col0 = blockIdx.y * tile_w;
  const int tw = min(tile_w, d - col0);

  for (int i = threadIdx.x; i < n_edges * tw; i += blockDim.x) {
    const int c = i / n_edges;
    const int e = i - c * n_edges;
    sh[e * tw + c] = edges[(long long)(col0 + c) * n_edges + e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < tw; c += blockDim.x) {
    int k = 0;
    for (int e = 0; e < n_edges; ++e) k += isnan(sh[e * tw + c]) ? 0 : 1;
    nan_free[c] = k;
  }
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long rows_left = n - row0;
  const int rows = (int)(rows_left < rows_per_block ? rows_left : rows_per_block);
  const int groups = (rows + kColRows - 1) / kColRows;
  for (int item = threadIdx.x; item < groups * tw; item += blockDim.x) {
    const int g = item / tw;
    const int c = item - g * tw;
    const long long base = (row0 + (long long)g * kColRows) * d + col0 + c;
    float v[kColRows];
    int acc[kColRows];
#pragma unroll
    for (int k = 0; k < kColRows; ++k) {
      acc[k] = 0;
      v[k] = (g * kColRows + k < rows) ? x[base + (long long)k * d] : 0.0f;
    }
    for (int e = 0; e < n_edges; ++e) {
      const float edge = sh[e * tw + c];
#pragma unroll
      for (int k = 0; k < kColRows; ++k) acc[k] += (edge < v[k]) ? 1 : 0;
    }
    const int nan_bin = nan_free[c];
#pragma unroll
    for (int k = 0; k < kColRows; ++k) {
      if (g * kColRows + k < rows) {
        out[base + (long long)k * d] = (OutT)(isnan(v[k]) ? nan_bin : acc[k]);
      }
    }
  }
}

// the largest dynamic shared memory a kernel opts into for a launch of
// `smem` bytes: none up to 48 KB, else all a block may take (the attribute
// only grows, so a smaller launch never refuses a later larger one)
size_t opt_in(size_t smem) { return smem > 48 * 1024 ? kDynSmemMax : 0; }

template <typename OutT, int kSteps>
int plan_tiles(const BinPlan& plan, int route, Launch* L) {
  const size_t table_bytes = L->smem;
  const long long small_blocks =
      (plan.body_end - plan.head + kSmallWords - 1) / kSmallWords;
  const long long table_words = (long long)(table_bytes / 4);
  const long long staged = small_blocks * table_words;
  const bool planned = route == kPlanned;
  L->plan = plan;
  bool small = planned ? staged <= kSmallStageWords : route == kSmall;
  if (small && ((planned && staged > kSmallWaveWords) ||
                table_bytes > 48 * 1024)) {
    int resident = 0;  // also opts the kernel in above 48 KB, as the ring is
    const int rc = tx::persistent_grid(bin_small_kernel<OutT, kSteps>,
                                       kThreads, table_bytes,
                                       opt_in(table_bytes), &resident);
    if (rc != 0) return rc;
    small = !planned || small_blocks <= resident ||
            resident * table_words <= kSmallWaveWords;
  }
  if (small) {
    L->route = kSmall;
    L->grid = dim3(small_blocks > 0 ? (unsigned)small_blocks : 1u);
    return 0;
  }
  int ring_grid = 0;
  const int rc = tx::persistent_grid(bin_tiles_kernel<OutT, kSteps>, kThreads,
                                     kRingBytes + table_bytes, kDynSmemMax,
                                     &ring_grid);
  if (rc != 0) return rc;
  L->route = kRing;  // never more blocks than tiles
  L->grid = dim3((unsigned)(plan.n_tiles < ring_grid ? plan.n_tiles
                                                       : ring_grid));
  L->smem = kRingBytes + table_bytes;
  return 0;
}

// Chooses the route and its grid: the column-tiled kernel when the staged
// edge table does not fit beside the ring, else the small kernel while its
// blocks stage at most kSmallStageWords words of edge table in all and
// either fit in one wave or stage at most kSmallWaveWords a wave, else the
// ring.
template <typename OutT>
int plan_launch(const float* x, long long n, int d, int n_edges,
                const OutT* out, int route, Launch* L) {
  int steps = kMinSteps;
  while ((1LL << steps) <= n_edges) ++steps;  // P > E
  const long long table_bytes = 4LL * d * ((1LL << steps) + 1);
  if (steps > 30 || kRingBytes + table_bytes > kDynSmemMax) {
    const long long fit = kColSmemBytes / (4LL * (n_edges + 1));
    if (fit < 1) return kErrEdges;
    L->route = kColTiles;
    L->tile_w = (int)(fit < d ? fit : d);
    L->rows_per_block =
        kColRows * ((kItemsPerBlock + L->tile_w - 1) / L->tile_w);
    const long long row_blocks =
        (n + L->rows_per_block - 1) / L->rows_per_block;
    const int col_tiles = (d + L->tile_w - 1) / L->tile_w;
    if (col_tiles > 65535 || row_blocks > 0x7fffffffLL) return kErrGrid;
    if (route != kPlanned) return kErrRoute;
    L->grid = dim3((unsigned)row_blocks, (unsigned)col_tiles);
    L->smem = sizeof(float) * ((size_t)n_edges * L->tile_w + L->tile_w);
    return 0;
  }
  BinPlan plan;
  plan.n_words = n * d;
  plan.head = tx::head_words(x, plan.n_words);
  plan.body_end = plan.head + (plan.n_words - plan.head) / 4 * 4;
  plan.n_tiles = (plan.body_end - plan.head + kTileWords - 1) / kTileWords;
  plan.d = d;
  plan.n_edges = n_edges;
  plan.steps = steps;
  // the bins of word g go to out + g, and tile words come in 4s from head
  const uintptr_t first_out = (uintptr_t)out + plan.head * sizeof(OutT);
  plan.vec_out = first_out % (4 * sizeof(OutT)) == 0 ? 1 : 0;
  L->smem = (size_t)table_bytes;
  return steps == kMinSteps ? plan_tiles<OutT, kMinSteps>(plan, route, L)
                            : plan_tiles<OutT, 0>(plan, route, L);
}

template <typename OutT, int kSteps>
void launch_planned(const float* x, const float* edges, const Launch& L,
                    OutT* out, cudaStream_t s) {
  if (L.route == kRing) {
    bin_tiles_kernel<OutT, kSteps><<<L.grid, kThreads, L.smem, s>>>(
        x, edges, L.plan, out);
  } else {
    bin_small_kernel<OutT, kSteps><<<L.grid, kThreads, L.smem, s>>>(
        x, edges, L.plan, out);
  }
}

template <typename OutT>
int launch(const float* x, const float* edges, long long n, int d, int n_edges,
           OutT* out, int route, cudaStream_t s) {
  Launch L;
  const int rc = plan_launch(x, n, d, n_edges, out, route, &L);
  if (rc != 0) return rc;
  if (L.route == kColTiles) {
    bin_coltile_kernel<OutT><<<L.grid, kThreads, L.smem, s>>>(
        x, edges, n, d, n_edges, L.tile_w, L.rows_per_block, out);
  } else if (L.plan.steps == kMinSteps) {
    launch_planned<OutT, kMinSteps>(x, edges, L, out, s);
  } else {
    launch_planned<OutT, 0>(x, edges, L, out, s);
  }
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_floor(const float* x, long long n, int d, int n_edges,
                 const OutT* out, cudaStream_t s) {
  Launch L;
  int rc = plan_launch(x, n, d, n_edges, out, kPlanned, &L);
  if (rc != 0) return rc;
  int unused = 0;
  rc = tx::persistent_grid(empty_kernel, kThreads, L.smem, opt_in(L.smem),
                           &unused);
  if (rc != 0) return rc;
  empty_kernel<<<L.grid, kThreads, L.smem, s>>>();
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d] and edges [d, n_edges] float32, contiguous, on the current
// device; out [n, d] int8 (out_int8 != 0) or int32, contiguous.  Plans the
// launch (plan_launch: the column-tiled, small or ring route); route is
// kPlanned (-1), or kRing (0) or kSmall (1) to force that route, which
// times the two beside each other.  Returns kErrEdges or kErrGrid without
// launching when the column-tiled plan does not fit, kErrRoute when a
// route is forced on it, a CUDA error from planning or launching, or 0;
// launches on `stream`.
extern "C" int tx_bin_matrix(const float* x, const float* edges, long long n,
                             int d, int n_edges, int out_int8, void* out,
                             int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8) {
    return launch(x, edges, n, d, n_edges, static_cast<int8_t*>(out), route,
                  s);
  }
  return launch(x, edges, n, d, n_edges, static_cast<int32_t*>(out), route,
                s);
}

// An empty kernel launched with tx_bin_matrix's grid, threads and dynamic
// shared memory for these arguments: what the launch alone costs.  Returns
// as tx_bin_matrix does.
extern "C" int tx_bin_matrix_floor(const float* x, long long n, int d,
                                   int n_edges, int out_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8) {
    return launch_floor(x, n, d, n_edges, static_cast<const int8_t*>(nullptr),
                        s);
  }
  return launch_floor(x, n, d, n_edges, static_cast<const int32_t*>(nullptr),
                      s);
}
