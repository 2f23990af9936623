// tile_ring.cuh: the pieces both streaming kernels (bin_matrix.cu,
// fused_moments.cu) share on Hopper (sm_90a).
//
//   * a ring of shared-memory stages filled by 1-D TMA bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx::bytes).  A 1-D bulk copy
//     takes a plain global address and a byte count, so it needs no
//     CUtensorMap and no driver-API linking under the ctypes build.  Its
//     source, destination and size must be multiples of 16 bytes; the
//     callers stage a 16-byte-aligned body and treat the few words before
//     and after it apart.
//   * the launch plan: the card's SM count and how many blocks of a kernel
//     fit on an SM at a given block size and dynamic shared-memory size,
//     with the opt-in above 48 KB, cached per (device, kernel, threads,
//     size) so that a launch pays for the queries once.
//
// The ring protocol (one producer thread, every thread a consumer):
//
//   thread 0:  mbar_init(bar[s], 1) for every stage, fence_mbar_init();
//              for the first kStages tiles: arrive_expect_tx + bulk_g2s.
//   all:       for the k-th tile of the block, stage s = k % kStages:
//                mbar_wait(bar[s], (k / kStages) & 1); read stage s;
//                __syncthreads();
//              thread 0: fence_proxy_async(), then refill stage s with the
//              tile kStages further on.
//
// The __syncthreads() after each tile is the "stage empty" barrier: no
// copy starts into a stage before every thread has finished reading it,
// and every copy started is waited on before the block exits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's earlier generic-proxy accesses of shared memory
// before its later async-proxy ones (the bulk copy that refills a stage)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16) from 16-byte-aligned global
// memory into 16-byte-aligned shared memory; completes on `bar` as
// transaction bytes
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// thread 0's half of the ring: arm stage `bar` for `bytes` and copy
__device__ __forceinline__ void ring_load(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, bytes);
  bulk_g2s(dst, src, bytes, bar);
}

// words before the first 16-byte-aligned word of a float array, at most n
__host__ __device__ inline long long head_words(const void* p, long long n) {
  const long long h = (long long)(((16 - (uintptr_t)p % 16) % 16) / 4);
  return h < n ? h : n;
}

// Blocks of `kernel` (at `threads` threads and `smem` bytes of dynamic
// shared memory) that fit on one SM, times the SMs of the current device:
// the persistent grid.  Opts the kernel into `smem_max`, the most any of
// its launches takes, when that is above 48 KB (the attribute is the
// kernel's, not the launch's: a smaller value set for one launch would
// refuse a larger one later).  Returns 0 and sets *grid, or a CUDA error
// code (a kernel that fits no block on an SM gives
// cudaErrorInvalidConfiguration).
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, size_t smem_max,
                    int* grid) {
  struct Entry {
    int device;
    const void* kernel;
    int threads;
    size_t smem;
    int grid;
  };
  static std::mutex lock;
  static Entry cache[256];
  static int used = 0;
  int device = 0;
  int rc = (int)cudaGetDevice(&device);
  if (rc != 0) return rc;
  const void* key = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> guard(lock);
    for (int i = 0; i < used; ++i) {
      if (cache[i].device == device && cache[i].kernel == key &&
          cache[i].threads == threads && cache[i].smem == smem) {
        *grid = cache[i].grid;
        return 0;
      }
    }
  }
  if (smem_max > 48 * 1024) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (rc != 0) return rc;
  }
  int sms = 0, per_sm = 0;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
  if (rc != 0) return rc;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
  if (rc != 0) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  std::lock_guard<std::mutex> guard(lock);
  if (used < 256) cache[used++] = Entry{device, key, threads, smem, *grid};
  return 0;
}

}  // namespace tx
