// fused_moments: one sweep of a float32 design matrix x [n, d] against a
// label y [n], giving per column sum(x), sum(x^2), sum(x*y), min(x) and
// max(x), plus sum(y) and sum(y^2).
//
// Replaces the TPU kernel transmogrifai_tpu/parallel/pallas_kernels.py:
// _moments_pallas (body _moments_kernel_body), whose sequential grid
// carries one [8, D] block from row tile to row tile.  Blocks on Hopper
// run in parallel and in no order, so the sweep is two passes here:
//
//   pass 1  grid (S row splits) x (column blocks).  Thread (tx, ty) owns
//           column blockIdx.y * BX + tx and walks rows ty, ty + BY, ... of
//           its split, accumulating float32 partials over at most 2^16
//           rows (the wrapper sizes the splits so).  The block combines
//           its BY row lanes in float64, in lane order, and writes a
//           [7, d] float64 partial for its split: scratch [S, 7, d].
//   pass 2  one block per column combines the S partials in float64 in a
//           fixed order (strided sums, then a fixed tree) and rounds once
//           to float32.
//
// No float atomics anywhere, so the result is bit-identical from run to
// run.  Because the combine is float64, no host-side chunk loop is needed
// at any n (the TPU wrapper splits above 2^22 rows for float32's sake).
//
// min/max propagate NaN, as jnp.minimum/jnp.maximum do; CUDA's fminf and
// fmaxf would drop it.  Row offsets are 64-bit (10M x 39 is 390M
// elements).  Columns past d and rows past n are never read.
//
// Bound: the sweep must read every element once, 4 * n * (d + 1) bytes;
// at 10M x 39 that is 1.6 GB, about 0.48 ms at the H100's 3.35 TB/s.  The
// arithmetic (3 FMAs and 2 compares per element) is far below the card's
// rate, so the design spends its effort on the read: a warp covers 32
// consecutive floats of the matrix (BX = the smallest power of two >= d,
// capped at 32, so a narrow matrix packs 32 / BX rows into each warp
// load), every thread keeps one load in flight per row it owns, and S is
// large enough to put several blocks on each of the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStats = 7;  // x_sum, x_sq, xy, x_min, x_max, y_sum, y_sq

template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  return (v < acc || isnan(v)) ? v : acc;
}

template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || isnan(v)) ? v : acc;
}

__global__ void moments_partial_kernel(const float* __restrict__ x,
                                       const float* __restrict__ y,
                                       long long n, int d,
                                       long long rows_per_split,
                                       double* __restrict__ partial) {
  __shared__ double sh[kStats][kThreads];
  const int bx = blockDim.x, by = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = ty * bx + tx;
  const int s = blockIdx.x;
  const int j = blockIdx.y * bx + tx;
  const long long r0 = (long long)s * rows_per_split;
  const long long r1 = min(r0 + rows_per_split, n);
  const bool col_ok = j < d;
  const bool y_lane = (j == 0);  // one column's lanes also sum y

  float sx = 0.f, sxx = 0.f, sxy = 0.f, sy = 0.f, syy = 0.f;
  float mn = INFINITY, mx = -INFINITY;
  if (col_ok) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += by) {
      const float v = x[r * d + j];
      const float yv = y[r];
      sx += v;
      sxx += v * v;
      sxy += v * yv;
      mn = nan_min(mn, v);
      mx = nan_max(mx, v);
      if (y_lane) {
        sy += yv;
        syy += yv * yv;
      }
    }
  }
  sh[0][lane] = sx;
  sh[1][lane] = sxx;
  sh[2][lane] = sxy;
  sh[3][lane] = mn;
  sh[4][lane] = mx;
  sh[5][lane] = sy;
  sh[6][lane] = syy;
  __syncthreads();
  if (ty == 0 && col_ok) {
    double acc[kStats] = {0.0, 0.0, 0.0, INFINITY, -INFINITY, 0.0, 0.0};
    for (int t = 0; t < by; ++t) {  // lane order: deterministic
      const int l = t * bx + tx;
      acc[0] += sh[0][l];
      acc[1] += sh[1][l];
      acc[2] += sh[2][l];
      acc[3] = nan_min(acc[3], sh[3][l]);
      acc[4] = nan_max(acc[4], sh[4][l]);
      acc[5] += sh[5][l];
      acc[6] += sh[6][l];
    }
    double* p = partial + (long long)s * kStats * d;
    for (int k = 0; k < kStats; ++k) p[(long long)k * d + j] = acc[k];
  }
}

__global__ void moments_combine_kernel(const double* __restrict__ partial,
                                       int splits, int d,
                                       float* __restrict__ out) {
  __shared__ double sh[kStats][kThreads];
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  double acc[kStats] = {0.0, 0.0, 0.0, INFINITY, -INFINITY, 0.0, 0.0};
  for (int s = t; s < splits; s += blockDim.x) {
    const double* p = partial + (long long)s * kStats * d + j;
    acc[0] += p[0];
    acc[1] += p[(long long)d];
    acc[2] += p[2LL * d];
    acc[3] = nan_min(acc[3], p[3LL * d]);
    acc[4] = nan_max(acc[4], p[4LL * d]);
    acc[5] += p[5LL * d];
    acc[6] += p[6LL * d];
  }
  for (int k = 0; k < kStats; ++k) sh[k][t] = acc[k];
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride /= 2) {
    if (t < stride) {
      sh[0][t] += sh[0][t + stride];
      sh[1][t] += sh[1][t + stride];
      sh[2][t] += sh[2][t + stride];
      sh[3][t] = nan_min(sh[3][t], sh[3][t + stride]);
      sh[4][t] = nan_max(sh[4][t], sh[4][t + stride]);
      sh[5][t] += sh[5][t + stride];
      sh[6][t] += sh[6][t + stride];
    }
    __syncthreads();
  }
  if (t == 0) {
    // out: x_sum[d], x_sq[d], xy[d], x_min[d], x_max[d], y_sum, y_sq
    for (int k = 0; k < 5; ++k) out[(long long)k * d + j] = (float)sh[k][0];
    if (j == 0) {
      out[5LL * d] = (float)sh[5][0];
      out[5LL * d + 1] = (float)sh[6][0];
    }
  }
}

}  // namespace

// x [n, d] and y [n] float32, contiguous, on the current device; partial
// is float64 scratch of [splits, 7, d]; out is float32 [5 * d + 2].
// rows_per_split * splits >= n, and rows_per_split <= 8 * 2^16 so that no
// thread sums more than 2^16 rows (a block has at least 8 row lanes).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int tx_fused_moments(const float* x, const float* y, long long n,
                                int d, long long rows_per_split, int splits,
                                double* partial, float* out, void* stream) {
  int bx = 1;
  while (bx < d && bx < 32) bx *= 2;
  const dim3 block(bx, kThreads / bx);
  const dim3 grid(splits, (d + bx - 1) / bx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  moments_partial_kernel<<<grid, block, 0, st>>>(x, y, n, d, rows_per_split,
                                                 partial);
  moments_combine_kernel<<<d, kThreads, 0, st>>>(partial, splits, d, out);
  return static_cast<int>(cudaGetLastError());
}
