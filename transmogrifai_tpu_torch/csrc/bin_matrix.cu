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
// VMEM, then slices the padded lanes off.  Here:
//
//   grid    (row blocks) x (column tiles).  A column tile is as many
//           columns as fit their edges in 48 KB of shared memory (all of
//           them for the tree learner's d <= a few hundred at E = 31), so
//           a block reads whole rows and its loads are contiguous.
//   stage   the block copies its tile's edges into shared memory,
//           transposed to [E][tile] so that neighbouring threads (which
//           own neighbouring columns) read neighbouring words, and counts
//           each column's non-NaN edges once.
//   count   each thread owns one column and kRows rows of it: it loads
//           the kRows values into registers, then walks the E edges once,
//           so every shared-memory load feeds kRows compares.
//
// The count is a linear compare-count over the whole edge row, exact for
// any edge row (unsorted, duplicated or NaN edges included): NaN edges
// compare false, like the TPU kernel's.  A binary search over the sorted
// non-NaN prefix would cost log2(E) instead of E compares per element; it
// is not needed at the default E = 31, where the bytes bound the kernel.
//
// Row offsets are 64-bit (10M x 39 is 390M elements; larger inputs pass
// 2^31).  Rows past n and columns past d are never read or written.
//
// Bound: the pass must read x once and write the bins once: 4 * n * d
// bytes in, n * d (int8) or 4 * n * d (int32) bytes out, plus 4 * d * E
// bytes of edges.  At 10M x 39 with int8 that is 1.95 GB, about 0.58 ms at
// the H100's 3.35 TB/s; the n * d * E compares (12.1e9) take about 0.18 ms
// at the float32 rate, so the bytes bound it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;             // rows per thread
constexpr int kItemsPerBlock = 2048; // (row group, column) items per block
constexpr long long kSmemBytes = 48 * 1024;  // needs no opt-in attribute
// the C entry's own error codes; CUDA's are >= 0
constexpr int kErrEdges = -1;  // one column's edges exceed kSmemBytes
constexpr int kErrGrid = -2;   // the grid would pass its limits

template <typename OutT>
__global__ void bin_kernel(const float* __restrict__ x,
                           const float* __restrict__ edges,
                           long long n, int d, int n_edges, int tile_w,
                           int rows_per_block, OutT* __restrict__ out) {
  extern __shared__ float sh[];  // [n_edges][tw] edges, then [tile_w] counts
  int* nan_free = reinterpret_cast<int*>(sh + (size_t)n_edges * tile_w);
  const int col0 = blockIdx.y * tile_w;
  const int tw = min(tile_w, d - col0);

  // edges arrive row-major [d, E]: consecutive i read consecutive words
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
  const int groups = (rows + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < groups * tw; item += blockDim.x) {
    const int g = item / tw;
    const int c = item - g * tw;
    const long long base = (row0 + (long long)g * kRows) * d + col0 + c;
    float v[kRows];
    int acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      acc[k] = 0;
      v[k] = (g * kRows + k < rows) ? x[base + (long long)k * d] : 0.0f;
    }
    for (int e = 0; e < n_edges; ++e) {
      const float edge = sh[e * tw + c];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] += (edge < v[k]) ? 1 : 0;
    }
    const int nan_bin = nan_free[c];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (g * kRows + k < rows) {
        out[base + (long long)k * d] = (OutT)(isnan(v[k]) ? nan_bin : acc[k]);
      }
    }
  }
}

}  // namespace

// x [n, d] and edges [d, n_edges] float32, contiguous, on the device; out
// [n, d] int8 (out_int8 != 0) or int32.  Plans the grid: a column tile is
// as many columns as fit their edges and non-NaN counts in kSmemBytes, a
// block about kItemsPerBlock items of kRows rows each.  Returns kErrEdges
// or kErrGrid without launching when the plan does not fit, else launches
// on `stream` and returns cudaGetLastError().
extern "C" int tx_bin_matrix(const float* x, const float* edges, long long n,
                             int d, int n_edges, int out_int8, void* out,
                             void* stream) {
  const long long fit = kSmemBytes / (4LL * (n_edges + 1));
  if (fit < 1) return kErrEdges;
  const int tile_w = (int)(fit < d ? fit : d);
  const int rows_per_block = kRows * ((kItemsPerBlock + tile_w - 1) / tile_w);
  const long long row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const int col_tiles = (d + tile_w - 1) / tile_w;
  if (col_tiles > 65535 || row_blocks > 0x7fffffffLL) return kErrGrid;
  const dim3 grid((unsigned)row_blocks, (unsigned)col_tiles);
  const size_t smem = sizeof(float) * ((size_t)n_edges * tile_w + tile_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8) {
    bin_kernel<int8_t><<<grid, kThreads, smem, s>>>(
        x, edges, n, d, n_edges, tile_w, rows_per_block,
        static_cast<int8_t*>(out));
  } else {
    bin_kernel<int32_t><<<grid, kThreads, smem, s>>>(
        x, edges, n, d, n_edges, tile_w, rows_per_block,
        static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}
