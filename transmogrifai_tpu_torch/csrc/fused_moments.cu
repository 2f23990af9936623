// fused_moments: one sweep of a float32 design matrix x [n, d] against a
// label y [n], giving per column sum(x), sum(x^2), sum(x*y), min(x) and
// max(x), plus sum(y) and sum(y^2).
//
// Replaces the TPU kernel transmogrifai_tpu/parallel/pallas_kernels.py:
// _moments_pallas (body _moments_kernel_body), whose sequential grid
// carries one [8, D] block from row tile to row tile.
//
// Bound on the H100: the sweep must read every element once, 4 * n * (d +
// 1) bytes; at 10M x 39 that is 1.6 GB, 0.48 ms at 3.35 TB/s, and at the
// main path's 1M x 11 0.014 ms.  The arithmetic (3 multiply-adds and 2
// compares an element) is far below the card's rate, so the design spends
// its effort on keeping the read busy and every lane useful:
//
//   tiles   a persistent grid (as many blocks as fit on each SM, times the
//           SMs) takes tiles of R whole rows of x, R * d contiguous floats
//           (about 16 KB), block b the tiles b, b + G, ...; one thread
//           keeps a ring of kStages tiles in flight with 1-D TMA bulk
//           copies completing on mbarriers (tile_ring.cuh), each tile's R
//           floats of y beside its x.  (Read from global memory instead,
//           y stalls every warp on a cache miss every few rows, and the
//           sweep ran slower than the first version's.)  Where x or y is
//           not 16-byte aligned, and for a last partial tile, y is read
//           straight from global memory.
//   lanes   for d <= T (T = 256 threads) lane l owns column (l mod d) for
//           the tile rows l / d, l / d + T / d, ...: the floor(T/d) * d
//           lanes in use read consecutive words (253 of 256 busy at d = 11,
//           234 at d = 39, where the first version's power-of-two column
//           blocks left 31% to 78% of a block's lanes idle).  For d > T a
//           row is wider than the lanes: the block walks column chunks of
//           T, each lane one column, reading its rows straight from global
//           memory (a warp reads 128 contiguous bytes of a row).
//   sums    a lane sums in float32 over one tile (or, for d > T, over at
//           most 2^16 rows) and adds that into float64; the block combines
//           its lanes in float64 in lane order into scratch [G, 7, d].
//   combine one launch: each block counts itself in with an integer
//           atomicAdd on a counter, and the last one combines the G
//           partials in float64 in block-index order (threads take fixed
//           contiguous ranges of blocks, then one thread a column adds the
//           ranges in order), writes the float32 results and resets the
//           counter to 0 for the next launch.  The order does not depend on
//           which block arrives last, and there are no float atomics, so
//           the result is bit-identical from run to run.
//   edges   x words before the first 16-byte-aligned one (a row-offset
//           view such as x[1:]) and the last < 4 words are summed by block
//           0 straight from global memory.
//
// min/max propagate NaN, as jnp.minimum/jnp.maximum do; CUDA's fminf and
// fmaxf would drop it.  No host chunk loop is needed at any n.  Offsets
// are 64-bit; rows past n and columns past d are never read.

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
constexpr long long kLaneRowsMax = 1 << 16;  // d > T: rows a float32 sum takes

struct MomentsPlan {
  long long n, n_words;  // rows; n * d
  long long head;        // words before the 16-byte-aligned body
  long long body_end;    // head + a multiple of 4 words
  long long n_tiles;     // tiles of tile_rows rows (d <= T)
  long long block_rows;  // rows of one row block (d > T)
  long long row_blocks;
  int d, tile_rows;
  int y_tiles;           // x and y 16-byte aligned: whole tiles stage y
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

__global__ void __launch_bounds__(kThreads)
    moments_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   MomentsPlan p, double* __restrict__ partial,
                   unsigned int* __restrict__ counter, float* __restrict__ out) {
  extern __shared__ __align__(128) float mom_ring[];  // [kStages][kTileWords]
  __shared__ uint64_t bars[kStages];
  __shared__ double sh[kStats][kThreads];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int G = gridDim.x, b = blockIdx.x;
  const int d = p.d;
  double* mine = partial + (long long)b * kStats * d;

  if (d <= kThreads) {
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
        tx::ring_load(mom_ring + s * kTileWords, x + g0,
                       (uint32_t)(4 * words), &bars[s]);
      }
    };
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) tx::mbar_init(&bars[s], 1);
      tx::fence_mbar_init();
      for (int k = 0; k < kStages && b + (long long)k * G < p.n_tiles; ++k) {
        load_tile(b + (long long)k * G, k);
      }
    }
    // the unaligned head and the < 4-word tail: lanes 0..d-1 hold one
    // column each
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
      for (int k = 0; k < kStats; ++k) mine[(long long)k * d + tid] = acc[k];
    }
  } else {
    // d > T: column chunks of T, each lane one column, row blocks b, b + G
    for (int c = tid; c < d; c += kThreads) {
      LaneSums lane;
      const bool y_lane = c == 0;
      for (long long m = b; m < p.row_blocks; m += G) {
        const long long r0 = m * p.block_rows;
        const long long r1 = min(r0 + p.block_rows, p.n);
        Stretch st;
#pragma unroll 4
        for (long long r = r0; r < r1; ++r) {
          st.add(lane, x[r * d + c], __ldg(y + r), y_lane);
        }
        st.flush(lane);
      }
      const double v[kStats] = {lane.x1, lane.x2, lane.xy, lane.mn, lane.mx,
                                lane.y1, lane.y2};
      for (int k = 0; k < kStats; ++k) mine[(long long)k * d + c] = v[k];
    }
  }

  // count the block in; the last one combines every block's partial
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1u) == (unsigned int)(G - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  auto range_sum = [&](double* acc, int c, int g_lo, int g_hi) {
    identity(acc);
    double v[kStats] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int g = g_lo; g < g_hi; ++g) {
      const double* pg = partial + (long long)g * kStats * d + c;
      for (int k = 0; k < 5; ++k) v[k] = __ldcg(pg + (long long)k * d);
      if (c == 0) {  // the y sums live in column 0
        v[5] = __ldcg(pg + 5LL * d);
        v[6] = __ldcg(pg + 6LL * d);
      }
      combine(acc, v);
    }
  };
  auto emit = [&](const double* acc, int c) {
    // out: x_sum[d], x_sq[d], xy[d], x_min[d], x_max[d], y_sum, y_sq
    for (int k = 0; k < 5; ++k) out[(long long)k * d + c] = (float)acc[k];
    if (c == 0) {
      out[5LL * d] = (float)acc[5];
      out[5LL * d + 1] = (float)acc[6];
    }
  };
  double acc[kStats];
  if (d <= kThreads) {
    // thread (q, c) sums blocks [q G / Q, (q + 1) G / Q) of column c
    const int Q = kThreads / d;
    if (tid < Q * d) {
      const int c = tid % d, q = tid / d;
      range_sum(acc, c, (int)((long long)q * G / Q),
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
      emit(acc, tid);
    }
  } else {
    for (int c = tid; c < d; c += kThreads) {
      range_sum(acc, c, 0, G);
      emit(acc, c);
    }
  }
  if (tid == 0) *counter = 0u;  // every block has counted itself in
}

}  // namespace

// x [n, d] and y [n] float32, contiguous, on the current device (any
// alignment of either); partial is float64 scratch of partial_doubles >=
// 7 * d values; counter is one unsigned int that is 0 before the launch
// (the kernel leaves it 0); out is float32 [5 * d + 2].  Plans the
// persistent grid, at most as many blocks as the scratch holds [7, d]
// partials for, and launches on `stream`.  Returns a CUDA error from
// planning or launching, or 0.
extern "C" int tx_fused_moments(const float* x, const float* y, long long n,
                                int d, double* partial,
                                long long partial_doubles,
                                unsigned int* counter, float* out,
                                void* stream) {
  MomentsPlan p;
  p.n = n;
  p.n_words = n * d;
  p.d = d;
  p.head = tx::head_words(x, p.n_words);
  p.body_end = p.head + (p.n_words - p.head) / 4 * 4;
  const int rows_fit = kTileWords / d < kTileRows ? kTileWords / d : kTileRows;
  p.tile_rows = d <= kThreads ? 4 * (rows_fit / 4) : 0;
  p.y_tiles = p.head == 0 && (uintptr_t)y % 16 == 0 ? 1 : 0;
  p.n_tiles = d <= kThreads
                  ? (p.body_end - p.head + (long long)p.tile_rows * d - 1) /
                        ((long long)p.tile_rows * d)
                  : 0;
  const size_t smem = d <= kThreads ? (size_t)kRingBytes : 0;
  int grid = 0;
  int rc = tx::persistent_grid(moments_kernel, kThreads, smem, kRingBytes,
                                &grid);
  if (rc != 0) return rc;
  const long long fit = partial_doubles / (7LL * d);
  if (fit < 1) return (int)cudaErrorInvalidValue;
  if (grid > fit) grid = (int)fit;
  p.block_rows = (n + grid - 1) / grid;
  if (p.block_rows > kLaneRowsMax) p.block_rows = kLaneRowsMax;
  p.row_blocks = (n + p.block_rows - 1) / p.block_rows;
  moments_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, p, partial, counter, out);
  return (int)cudaGetLastError();
}
