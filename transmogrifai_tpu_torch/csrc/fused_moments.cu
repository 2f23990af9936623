// fused_moments: one sweep of a float32 design matrix x [n, d] against a
// label y [n], giving per column sum(x), sum(x^2), sum(x*y), min(x) and
// max(x), plus sum(y) and sum(y^2).
//
// Replaces the TPU kernel transmogrifai_tpu/parallel/pallas_kernels.py:
// _moments_pallas (body _moments_kernel_body), whose sequential grid
// carries one [8, D] block from row tile to row tile.
//
// Bound on the H100: the sweep must read every element once, 4 * n * (d +
// 1) bytes; at 10M x 39 that is 1.6 GB, 0.48 ms at 3.35 TB/s, at 1M x 538
// 2.15 GB, 0.64 ms, and at 10k x 4 243 170 MB, 0.051 ms.  The arithmetic
// (3 multiply-adds and 2 compares an element) is far below the card's
// rate, so the design spends its effort on keeping the read busy and every
// lane useful.  Two routes, by width:
//
// d <= T (T = 256 threads), moments_tiles_kernel:
//   tiles   the grid takes tiles of R whole rows of x, R * d contiguous
//           floats (about 16 KB), block b the tiles b, b + G, ...; G is as
//           many blocks as fit on each SM times the SMs, and never more
//           than the tiles.  One thread keeps a ring of kStages tiles in
//           flight with 1-D TMA bulk copies completing on mbarriers
//           (tile_ring.cuh), each tile's R floats of y beside its x.  Where
//           x or y is not 16-byte aligned, and for a last partial tile, y
//           is read straight from global memory.
//   lanes   lane l owns column (l mod d) for the tile rows l / d, l / d +
//           T / d, ...: the floor(T/d) * d lanes in use read consecutive
//           words.
//   edges   x words before the first 16-byte-aligned one (a row-offset
//           view such as x[1:]) and the last < 4 words are summed by block
//           0 straight from global memory.
//   regs    __launch_bounds__(T, 2), the two blocks an SM that the ring's
//           shared memory allows: without the bound this kernel, once it
//           no longer shared a function with the wide route, compiled to a
//           slower sweep at 60k-10M rows (a build without it, timed beside
//           this one on an H100).
//
// d > T, moments_slabs_kernel:
//   slabs   the columns split into S = ceil(d / T) balanced slabs of W =
//           ceil(d / S) (538 -> 3 x 180, 4 243 -> 17 x 250), and the rows
//           into row blocks: a 2-D grid of S slabs x B row blocks, block
//           (s, b) one lane a column of slab s (W rounded up to whole
//           warps) over rows [b * rows, (b + 1) * rows).  B fills the card
//           at this kernel's own occupancy (not the ring route's), but a
//           row block keeps at least kMinBlockRows = 256 rows, so that the
//           float64 scratch written and read back stays within about a
//           tenth of x's bytes (a build at 512 rows, timed beside this one
//           on an H100, lost more at 1 000 x 257 and 30k x 538 than it
//           gained at 10k x 4 243).
//   reads   a row's pitch of 538 or 4 243 floats is not a multiple of 16
//           bytes, so a 2-D TMA tensor map cannot describe the slab and
//           1-D bulk copies of its row segments are misaligned; and a
//           slab row is read once, so staging it in shared memory buys no
//           reuse.  The lanes read straight from global memory with
//           register-level ILP: each lane issues kChunk = 32 independent
//           row loads before it consumes any (a warp reads 128 contiguous
//           bytes of each row), and the warp's lanes load the chunk's 32
//           floats of y at once and pass them round with __shfl_sync.
//   issue   a lane's element costs a load, a shuffle, an add, two
//           multiply-adds and min.NaN / max.NaN (one instruction each, where
//           a compare-and-select takes three); the y sums leave the element
//           loop: warp 0 of slab 0 adds the chunk's y, a lane a row, in
//           float64, and folds its lanes in a fixed order at the end.
//   combine two levels of counters: each row block counts itself in with
//           an integer atomicAdd on its group's counter (kGroup = 16 row
//           blocks a group), and the last one of the group combines the
//           group's partials in float64, a thread a column, in row-block
//           order; then the group counts itself in on its slab's counter,
//           and the last group of the slab combines the groups' partials in
//           group order.  Each resets its counter.  A thread's combine
//           waits about an L2 round trip a partial, so one level over B ~
//           300 row blocks sat on the launch's tail (a one-level build,
//           timed beside this one on an H100, was slower at 1M and 200k x
//           538); now no combine takes more than 16 steps plus B / 16, the
//           first level runs while other row blocks still sweep, and the S
//           slabs combine in parallel.
//
// Both routes: a lane sums in float32 over one tile or one chunk of 32 rows
// and adds that into float64; partials are float64 in scratch [B (+ the
// groups), 7, d] and the counters one a slab and group: the caller keeps
// both, and tx_fused_moments says what its plan needs where they are too
// short, so that a launch crosses from the host once.  The combine runs in
// a fixed order with no float atomics, so the result is bit-identical from
// run to run, whichever block arrives last.  min/max propagate NaN, as
// jnp.minimum/jnp.maximum do; CUDA's fminf and fmaxf would drop it.  No
// host chunk loop is needed at any n.  Offsets are 64-bit; rows past n and
// columns past d are never read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kTileWords = 4096;  // at most 16 KB of x a tile
constexpr int kTileRows = 1024;   // at most 4 KB of y a tile
constexpr long long kRingBytes = 4LL * kStages * (kTileWords + kTileRows);
constexpr int kStats = 7;  // x_sum, x_sq, xy, x_min, x_max, y_sum, y_sq
constexpr int kChunk = 32;                // d > T: row loads a lane keeps in flight
constexpr long long kMinBlockRows = 256;  // d > T: rows of a row block at least
constexpr int kGroup = 16;  // d > T: row blocks a first-level combine takes
// the C entry's own error code (CUDA's are >= 0): the scratch is too short
constexpr int kErrScratch = -1;

struct TilePlan {
  long long n, n_words;  // rows; n * d
  long long head;        // words before the 16-byte-aligned body
  long long body_end;    // head + a multiple of 4 words
  long long n_tiles;     // tiles of tile_rows rows
  int d, tile_rows;
  int y_tiles;           // x and y 16-byte aligned: whole tiles stage y
};

struct SlabPlan {
  long long n, block_rows;
  int d, width;  // columns; columns of a slab (the last may hold fewer)
  int groups;    // groups of kGroup row blocks
};

// the launch of either route, as plan_launch gives it
struct Launch {
  bool slabs;
  dim3 grid;
  int threads;
  size_t smem;
  long long partials;  // [7, d] float64 partials the scratch must hold
  int counters;        // combine counters (a slab and each of its groups)
  TilePlan tiles;
  SlabPlan slab;
};

template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  return (v < acc || isnan(v)) ? v : acc;
}

template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || isnan(v)) ? v : acc;
}

// float32 sums of one stretch, then added into a lane's float64 totals
struct LaneSums {
  double x1 = 0.0, x2 = 0.0, xy = 0.0, y1 = 0.0, y2 = 0.0;
  float mn = INFINITY, mx = -INFINITY;
};

struct Stretch {
  float x1 = 0.f, x2 = 0.f, xy = 0.f, y1 = 0.f, y2 = 0.f;
  __device__ __forceinline__ void add(LaneSums& l, float v, float yv,
                                      bool y_lane) {
    x1 += v;
    x2 = fmaf(v, v, x2);
    xy = fmaf(v, yv, xy);
    l.mn = nan_min(l.mn, v);
    l.mx = nan_max(l.mx, v);
    if (y_lane) {
      y1 += yv;
      y2 = fmaf(yv, yv, y2);
    }
  }
  __device__ __forceinline__ void flush(LaneSums& l) const {
    l.x1 += x1;
    l.x2 += x2;
    l.xy += xy;
    l.y1 += y1;
    l.y2 += y2;
  }
};

// min and max that propagate NaN, one instruction each (sm_80 and later)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void combine(double* acc, const double* v) {
  acc[0] += v[0];
  acc[1] += v[1];
  acc[2] += v[2];
  acc[3] = nan_min(acc[3], v[3]);
  acc[4] = nan_max(acc[4], v[4]);
  acc[5] += v[5];
  acc[6] += v[6];
}

__device__ __forceinline__ void identity(double* acc) {
  acc[0] = acc[1] = acc[2] = acc[5] = acc[6] = 0.0;
  acc[3] = INFINITY;
  acc[4] = -INFINITY;
}

__device__ __forceinline__ void store_partial(double* partial, long long g,
                                              int d, int c, const double* v) {
  double* p = partial + g * kStats * d + c;
  for (int k = 0; k < kStats; ++k) p[(long long)k * d] = v[k];
}

// column c's partials of blocks [g_lo, g_hi), in block order; the y sums
// live in column 0
__device__ __forceinline__ void range_sum(double* acc, const double* partial,
                                          int d, int c, int g_lo, int g_hi) {
  identity(acc);
  double v[kStats] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int g = g_lo; g < g_hi; ++g) {
    const double* pg = partial + (long long)g * kStats * d + c;
    for (int k = 0; k < 5; ++k) v[k] = __ldcg(pg + (long long)k * d);
    if (c == 0) {
      v[5] = __ldcg(pg + 5LL * d);
      v[6] = __ldcg(pg + 6LL * d);
    }
    combine(acc, v);
  }
}

// out: x_sum[d], x_sq[d], xy[d], x_min[d], x_max[d], y_sum, y_sq
__device__ __forceinline__ void emit(float* out, int d, int c,
                                     const double* acc) {
  for (int k = 0; k < 5; ++k) out[(long long)k * d + c] = (float)acc[k];
  if (c == 0) {
    out[5LL * d] = (float)acc[5];
    out[5LL * d + 1] = (float)acc[6];
  }
}

// counts the block in on *counter (after its partial is written) and says
// whether it is the last of `blocks`; the last one sees every partial
__device__ __forceinline__ bool last_in(unsigned int* counter,
                                        unsigned int blocks, int* is_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *is_last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  if (!*is_last) return false;
  __threadfence();
  return true;
}

__global__ void __launch_bounds__(kThreads, 2)
    moments_tiles_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, TilePlan p,
                         double* __restrict__ partial,
                         unsigned int* __restrict__ counter,
                         float* __restrict__ out) {
  extern __shared__ __align__(128) float mom_ring[];  // [kStages][kTileWords]
  __shared__ uint64_t bars[kStages];
  __shared__ double sh[kStats][kThreads];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int G = gridDim.x, b = blockIdx.x;
  const int d = p.d;
  const int rho = kThreads / d;  // tile rows a pass of the lanes covers
  const int lanes = rho * d;
  const int tile_words = p.tile_rows * d;
  const int col = (int)((p.head + tid) % d);
  const long long row_in_tile = (p.head + tid) / d;
  const bool active = tid < lanes;
  const bool y_lane = active && col == 0;
  LaneSums lane;

  float* y_ring = mom_ring + kStages * kTileWords;  // [kStages][kTileRows]
  // a whole tile of an aligned x and y stages its R floats of y beside x
  auto y_staged = [&](long long t) {
    return p.y_tiles && (t + 1) * p.tile_rows <= p.n;
  };
  auto load_tile = [&](long long t, int s) {
    const long long g0 = p.head + t * tile_words;
    const long long words = min((long long)tile_words, p.body_end - g0);
    if (y_staged(t)) {
      tx::mbar_arrive_expect_tx(&bars[s], 4 * (words + p.tile_rows));
      tx::bulk_g2s(mom_ring + s * kTileWords, x + g0, 4 * words, &bars[s]);
      tx::bulk_g2s(y_ring + s * kTileRows, y + t * p.tile_rows,
                   4 * p.tile_rows, &bars[s]);
    } else {
      tx::ring_load(mom_ring + s * kTileWords, x + g0, (uint32_t)(4 * words),
                    &bars[s]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) tx::mbar_init(&bars[s], 1);
    tx::fence_mbar_init();
    for (int k = 0; k < kStages && b + (long long)k * G < p.n_tiles; ++k) {
      load_tile(b + (long long)k * G, k);
    }
  }
  // the unaligned head and the < 4-word tail: lanes 0..d-1 hold one column
  // each
  if (b == 0 && tid < d) {
    Stretch st;
    const long long n_tail = p.n_words - p.body_end;
    for (long long i = 0; i < p.head + n_tail; ++i) {
      const long long g = i < p.head ? i : p.body_end + (i - p.head);
      if (g % d == col) st.add(lane, x[g], y[g / d], y_lane);
    }
    st.flush(lane);
  }
  __syncthreads();  // the barriers' initialisation is visible

  for (long long k = 0;; ++k) {
    const long long t = b + k * G;
    if (t >= p.n_tiles) break;
    const int s = (int)(k % kStages);
    tx::mbar_wait(&bars[s], (uint32_t)((k / kStages) & 1));
    if (active) {
      const long long g0 = p.head + t * tile_words;
      const int words = (int)min((long long)tile_words, p.body_end - g0);
      const float* tile = mom_ring + s * kTileWords;
      Stretch st;
      if (y_staged(t)) {  // head == 0: the tile starts a row
        const float* y_tile = y_ring + s * kTileRows;
        int r = (int)row_in_tile;
#pragma unroll 4
        for (int i = tid; i < words; i += lanes, r += rho) {
          st.add(lane, tile[i], y_tile[r], y_lane);
        }
      } else {
        long long r = t * p.tile_rows + row_in_tile;
#pragma unroll 4
        for (int i = tid; i < words; i += lanes, r += rho) {
          st.add(lane, tile[i], __ldg(y + r), y_lane);
        }
      }
      st.flush(lane);
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && t + (long long)kStages * G < p.n_tiles) {
      tx::fence_proxy_async();
      load_tile(t + (long long)kStages * G, s);
    }
  }

  // the block's lanes in lane order: column c is held by lanes
  // (c - head) mod d, + d, + 2d, ...
  sh[0][tid] = lane.x1;
  sh[1][tid] = lane.x2;
  sh[2][tid] = lane.xy;
  sh[3][tid] = lane.mn;
  sh[4][tid] = lane.mx;
  sh[5][tid] = lane.y1;
  sh[6][tid] = lane.y2;
  __syncthreads();
  if (tid < d) {
    double acc[kStats], v[kStats];
    identity(acc);
    const int l0 = (int)(((tid - p.head) % d + d) % d);
    for (int l = l0; l < lanes; l += d) {
      for (int k = 0; k < kStats; ++k) v[k] = sh[k][l];
      combine(acc, v);
    }
    double* mine = partial + (long long)b * kStats * d + tid;
    for (int k = 0; k < kStats; ++k) mine[(long long)k * d] = acc[k];
  }

  // the last block combines every block's partial: thread (q, c) sums
  // blocks [q G / Q, (q + 1) G / Q) of column c, then one thread a column
  // adds the Q ranges in order
  if (!last_in(counter, (unsigned int)G, &is_last)) return;
  double acc[kStats];
  const int Q = kThreads / d;
  if (tid < Q * d) {
    const int c = tid % d, q = tid / d;
    range_sum(acc, partial, d, c, (int)((long long)q * G / Q),
              (int)((long long)(q + 1) * G / Q));
    for (int k = 0; k < kStats; ++k) sh[k][tid] = acc[k];
  }
  __syncthreads();
  if (tid < d) {
    double v[kStats];
    identity(acc);
    for (int q = 0; q < Q; ++q) {
      for (int k = 0; k < kStats; ++k) v[k] = sh[k][q * d + tid];
      combine(acc, v);
    }
    emit(out, d, tid, acc);
  }
  if (tid == 0) *counter = 0u;  // every block has counted itself in
}

__global__ void __launch_bounds__(kThreads)
    moments_slabs_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, SlabPlan p,
                         double* __restrict__ partial,
                         unsigned int* __restrict__ counters,
                         float* __restrict__ out) {
  __shared__ int is_last;
  const int tid = threadIdx.x, lane_id = tid & 31;
  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const int d = p.d;
  const int c0 = s * p.width;
  const int width = min(p.width, d - c0);
  // the lanes past the slab's last column (in its last warp) repeat that
  // column's loads, so that every lane of a warp takes part in the shuffles
  const bool active = tid < width;
  const int c = c0 + (active ? tid : width - 1);
  // warp 0 of slab 0 also sums y: lane l takes row l of each chunk
  const bool y_warp = s == 0 && tid < 32;
  const long long r0 = b * p.block_rows;
  const long long r1 = min(r0 + p.block_rows, p.n);
  LaneSums lane;

  for (long long r = r0; r < r1; r += kChunk) {
    const int rows = (int)min((long long)kChunk, r1 - r);
    const float y_mine = lane_id < rows ? __ldg(y + r + lane_id) : 0.f;
    if (y_warp) {
      lane.y1 += y_mine;
      lane.y2 = fma((double)y_mine, (double)y_mine, lane.y2);
    }
    const float* xr = x + r * d + c;
    float x1 = 0.f, x2 = 0.f, xy = 0.f;
    auto add = [&](float v, int k) {
      x1 += v;
      x2 = fmaf(v, v, x2);
      xy = fmaf(v, __shfl_sync(0xffffffffu, y_mine, k), xy);
      lane.mn = min_nan(lane.mn, v);
      lane.mx = max_nan(lane.mx, v);
    };
    if (rows == kChunk) {
      float v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) v[k] = __ldg(xr + (long long)k * d);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) add(v[k], k);
    } else {
      for (int k = 0; k < rows; ++k) add(__ldg(xr + (long long)k * d), k);
    }
    lane.x1 += x1;
    lane.x2 += x2;
    lane.xy += xy;
  }
  if (y_warp) {  // the warp's y sums, in a fixed order, into lane 0 (column 0)
    for (int off = 16; off > 0; off >>= 1) {
      lane.y1 += __shfl_down_sync(0xffffffffu, lane.y1, off);
      lane.y2 += __shfl_down_sync(0xffffffffu, lane.y2, off);
    }
  }
  double acc[kStats] = {lane.x1, lane.x2, lane.xy, lane.mn,
                        lane.mx, lane.y1, lane.y2};
  if (active) store_partial(partial, b, d, c, acc);

  // two levels, each a counter and a fixed order: the last row block of
  // each group of kGroup combines the group's partials into partial
  // [B + group], and the last group of the slab combines the groups'
  const int blocks = gridDim.y, group = (int)(b / kGroup);
  const int g_lo = group * kGroup, g_hi = min(g_lo + kGroup, blocks);
  unsigned int* group_counter = counters + gridDim.x + s * p.groups + group;
  if (!last_in(group_counter, g_hi - g_lo, &is_last)) return;
  if (active) {
    range_sum(acc, partial, d, c, g_lo, g_hi);
    store_partial(partial, blocks + group, d, c, acc);
  }
  if (tid == 0) *group_counter = 0u;  // the group has counted itself in
  if (!last_in(counters + s, p.groups, &is_last)) return;
  if (active) {
    range_sum(acc, partial, d, c, blocks, blocks + p.groups);
    emit(out, d, c, acc);
  }
  if (tid == 0) counters[s] = 0u;  // every group has counted itself in
}

// the launch plan's measure: an empty kernel at the same grid, threads and
// dynamic shared memory
__global__ void empty_kernel() {}

int plan_launch(const float* x, const float* y, long long n, int d,
                Launch* L) {
  int rc = 0;
  if (d <= kThreads) {
    TilePlan& p = L->tiles;
    p.n = n;
    p.n_words = n * d;
    p.d = d;
    p.head = tx::head_words(x, p.n_words);
    p.body_end = p.head + (p.n_words - p.head) / 4 * 4;
    const int rows_fit =
        kTileWords / d < kTileRows ? kTileWords / d : kTileRows;
    p.tile_rows = 4 * (rows_fit / 4);
    p.y_tiles = p.head == 0 && (uintptr_t)y % 16 == 0 ? 1 : 0;
    p.n_tiles = (p.body_end - p.head + (long long)p.tile_rows * d - 1) /
                ((long long)p.tile_rows * d);
    int grid = 0;
    rc = tx::persistent_grid(moments_tiles_kernel, kThreads, kRingBytes,
                             kRingBytes, &grid);
    if (rc != 0) return rc;
    // never more blocks than tiles; block 0 alone when the body is empty
    if (grid > p.n_tiles) grid = p.n_tiles > 0 ? (int)p.n_tiles : 1;
    L->slabs = false;
    L->grid = dim3((unsigned)grid);
    L->threads = kThreads;
    L->smem = kRingBytes;
    L->partials = grid;
    L->counters = 1;
    return 0;
  }
  SlabPlan& p = L->slab;
  const int slabs = (d + kThreads - 1) / kThreads;
  p.n = n;
  p.d = d;
  p.width = (d + slabs - 1) / slabs;
  const int threads = (p.width + 31) / 32 * 32;
  int fill = 0;  // blocks of this kernel the card holds at once
  rc = tx::persistent_grid(moments_slabs_kernel, threads, 0, 0, &fill);
  if (rc != 0) return rc;
  long long blocks = (fill + slabs - 1) / slabs;
  const long long by_rows = (n + kMinBlockRows - 1) / kMinBlockRows;
  if (blocks > by_rows) blocks = by_rows;
  if (blocks > 65535) blocks = 65535;
  // whole chunks: only the last row block ends in a partial chunk
  p.block_rows = (n + blocks - 1) / blocks;
  p.block_rows = (p.block_rows + kChunk - 1) / kChunk * kChunk;
  blocks = (n + p.block_rows - 1) / p.block_rows;
  if (slabs > 65535) return (int)cudaErrorInvalidConfiguration;
  p.groups = (int)((blocks + kGroup - 1) / kGroup);
  L->slabs = true;
  L->grid = dim3((unsigned)slabs, (unsigned)blocks);
  L->threads = threads;
  L->smem = 0;
  L->partials = blocks + p.groups;
  L->counters = slabs * (1 + p.groups);
  return 0;
}

}  // namespace

// x [n, d] and y [n] float32, contiguous, on the current device (any
// alignment of either); partial is float64 scratch of partial_doubles
// doubles; counters are n_counters unsigned ints, 0 before the launch (the
// kernel leaves them 0); out is float32 [5 * d + 2].  Plans the grid and
// launches on `stream`.  The plan needs 7 * d * its partials doubles and
// its counters: where either buffer is shorter, sets *need_partial_doubles
// and *need_counters to what it needs and returns kErrScratch without
// launching, so that the caller grows its buffers and calls again.
// Returns a CUDA error from planning or launching, or 0.
extern "C" int tx_fused_moments(const float* x, const float* y, long long n,
                                int d, double* partial,
                                long long partial_doubles,
                                unsigned int* counters, int n_counters,
                                float* out, void* stream,
                                long long* need_partial_doubles,
                                int* need_counters) {
  Launch L;
  const int rc = plan_launch(x, y, n, d, &L);
  if (rc != 0) return rc;
  if (partial_doubles < L.partials * kStats * d || n_counters < L.counters) {
    *need_partial_doubles = L.partials * kStats * d;
    *need_counters = L.counters;
    return kErrScratch;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.slabs) {
    moments_slabs_kernel<<<L.grid, L.threads, L.smem, s>>>(
        x, y, L.slab, partial, counters, out);
  } else {
    moments_tiles_kernel<<<L.grid, L.threads, L.smem, s>>>(
        x, y, L.tiles, partial, counters, out);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched with tx_fused_moments' grid, threads and dynamic
// shared memory for these inputs: what the launch alone costs.
extern "C" int tx_fused_moments_floor(const float* x, const float* y,
                                      long long n, int d, void* stream) {
  Launch L;
  int rc = plan_launch(x, y, n, d, &L);
  if (rc != 0) return rc;
  int unused = 0;
  rc = tx::persistent_grid(empty_kernel, L.threads, L.smem, L.smem, &unused);
  if (rc != 0) return rc;
  empty_kernel<<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
