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
// ~70 instructions an element, cannot reach the byte bound.  The design:
//
//   tiles   x is one contiguous stream of n * d floats.  A persistent grid
//           (as many blocks as fit on each SM, times the SMs) takes fixed
//           16 KB tiles of that stream, block b the tiles b, b + G, ...;
//           one thread keeps a ring of kStages tiles in flight with 1-D TMA
//           bulk copies completing on mbarriers (tile_ring.cuh).  The
//           tiles need not hold whole rows: the column of word w is
//           w mod d, tracked by increment-and-wrap from the tile's first
//           column.
//   lanes   thread l reads tile words 4l..4l+3, 4l+4T.., one float4 at a
//           time: neighbouring lanes read neighbouring 16 bytes (no bank
//           conflicts for any d) and write neighbouring bins, 4 bytes
//           (int8) or 16 bytes (int32) a thread, so a warp stores 128 or
//           512 contiguous bytes.
//   search  the block stages each column's edges into shared memory at a
//           row stride of P + 1 words (P the power of two above E, at
//           least 32; odd, so that the lanes' columns fall in different
//           banks), NaN-padded to P - 1 entries, with an info word (the
//           non-NaN count and a flag) in slot P - 1.  The flag says that
//           the row is a non-decreasing non-NaN prefix followed by NaN,
//           which is what quantile_bin_edges gives: for such a row
//           "edge < x" is true on a prefix, and a branch-free lower_bound
//           over the P - 1 slots finds its length in log2(P) steps (5 at
//           E = 31) - NaN pads compare false.  Any other row (unsorted,
//           NaN inside) keeps the exact compare-count over its E edges: a
//           branch on a property of the input, not a fallback.
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
// the column-tiled kernel
constexpr int kColRows = 4;             // rows per thread
constexpr int kItemsPerBlock = 2048;    // (row group, column) items per block
constexpr long long kColSmemBytes = 48 * 1024;  // needs no opt-in attribute
// the C entry's own error codes; CUDA's are >= 0
constexpr int kErrEdges = -1;  // one column's edges exceed kColSmemBytes
constexpr int kErrGrid = -2;   // the grid would pass its limits

struct BinPlan {
  long long n_words;   // n * d
  long long head;      // words before the 16-byte-aligned body
  long long body_end;  // head + a multiple of 4 words
  long long n_tiles;   // kTileWords-word tiles of the body
  int d, n_edges, steps, vec_out;
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
  __shared__ int all_sorted;

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
    all_sorted = 1;
    for (int k = 0; k < kStages && b + k * G < p.n_tiles; ++k) {
      load_tile(b + k * G, k);
    }
  }

  // stage the edges (the info slot is written next), then classify rows
  for (int i = tid; i < d * stride; i += kThreads) {
    const int c = i / stride, j = i - c * stride;
    table[i] = j < n_edges ? edges[(long long)c * n_edges + j] : NAN;
  }
  __syncthreads();
  for (int c = tid; c < d; c += kThreads) {
    const float* row = table + c * stride;
    int valid = 0;
    bool sorted = true, tail = false;
    for (int j = 0; j < n_edges; ++j) {
      if (isnan(row[j])) {
        tail = true;
      } else {
        ++valid;
        if (tail || (j > 0 && row[j - 1] > row[j])) sorted = false;
      }
    }
    table[c * stride + P - 1] = __int_as_float(2 * valid + (sorted ? 1 : 0));
    if (!sorted) all_sorted = 0;
  }
  __syncthreads();
  const bool uniform = all_sorted != 0;

  // the unaligned head and the < 4-word tail, straight from global memory
  if (b == 0) {
    const long long n_tail = p.n_words - p.body_end;
    if (tid < p.head + n_tail) {
      const long long g = tid < p.head ? tid : p.body_end + (tid - p.head);
      const int c = (int)(g % d);
      out[g] = (OutT)bin_of<kSteps>(table + c * stride, x[g], steps, n_edges,
                                    uniform);
    }
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

template <typename OutT, int kSteps>
int launch_tiles(const float* x, const float* edges, const BinPlan& plan,
                 size_t smem, OutT* out, cudaStream_t s) {
  auto kernel = bin_tiles_kernel<OutT, kSteps>;
  int grid = 0;
  const int rc = tx::persistent_grid(kernel, kThreads, smem, kDynSmemMax, &grid);
  if (rc != 0) return rc;
  kernel<<<grid, kThreads, smem, s>>>(x, edges, plan, out);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_coltiles(const float* x, const float* edges, long long n, int d,
                    int n_edges, OutT* out, cudaStream_t s) {
  const long long fit = kColSmemBytes / (4LL * (n_edges + 1));
  if (fit < 1) return kErrEdges;
  const int tile_w = (int)(fit < d ? fit : d);
  const int rows_per_block = kColRows * ((kItemsPerBlock + tile_w - 1) / tile_w);
  const long long row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const int col_tiles = (d + tile_w - 1) / tile_w;
  if (col_tiles > 65535 || row_blocks > 0x7fffffffLL) return kErrGrid;
  const dim3 grid((unsigned)row_blocks, (unsigned)col_tiles);
  const size_t smem = sizeof(float) * ((size_t)n_edges * tile_w + tile_w);
  bin_coltile_kernel<OutT><<<grid, kThreads, smem, s>>>(
      x, edges, n, d, n_edges, tile_w, rows_per_block, out);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const float* x, const float* edges, long long n, int d, int n_edges,
           OutT* out, cudaStream_t s) {
  int steps = kMinSteps;
  while ((1LL << steps) <= n_edges) ++steps;  // P > E
  const long long table_bytes = 4LL * d * ((1LL << steps) + 1);
  if (steps > 30 || kRingBytes + table_bytes > kDynSmemMax) {
    return launch_coltiles(x, edges, n, d, n_edges, out, s);
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
  plan.vec_out =
      ((uintptr_t)(out + plan.head) % (4 * sizeof(OutT))) == 0 ? 1 : 0;
  const size_t smem = (size_t)(kRingBytes + table_bytes);
  return steps == kMinSteps
             ? launch_tiles<OutT, kMinSteps>(x, edges, plan, smem, out, s)
             : launch_tiles<OutT, 0>(x, edges, plan, smem, out, s);
}

}  // namespace

// x [n, d] and edges [d, n_edges] float32, contiguous, on the current
// device; out [n, d] int8 (out_int8 != 0) or int32, contiguous.  Plans the
// launch: the tiled kernel when the staged edge table fits beside the
// ring, else the column-tiled one.  Returns kErrEdges or kErrGrid without
// launching when the column-tiled plan does not fit, a CUDA error from
// planning or launching, or 0; launches on `stream`.
extern "C" int tx_bin_matrix(const float* x, const float* edges, long long n,
                             int d, int n_edges, int out_int8, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8) {
    return launch(x, edges, n, d, n_edges, static_cast<int8_t*>(out), s);
  }
  return launch(x, edges, n, d, n_edges, static_cast<int32_t*>(out), s);
}
