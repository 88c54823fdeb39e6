// Helpers shared by the port's CUDA kernels. Each kernel source is built on
// its own into a shared library with a plain C interface (kernels/_build.py);
// every C entry point launches on the caller's stream and returns
// cudaGetLastError().
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

// int32 max: the "absent" first position and the saturation ceiling.
constexpr uint32_t kNever = 0x7fffffffu;

// Block-wide exclusive prefix sum of one int per thread. blockDim.x must be
// a multiple of 32 and at most 1024. Every thread of the block must call
// it. Writes the block's total to *total.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_prefix[32];
  __shared__ int block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_prefix[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? warp_prefix[lane] : 0;
    int w_incl = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w_incl, d);
      if (lane >= d) w_incl += t;
    }
    if (lane < n_warps) warp_prefix[lane] = w_incl - w;
    if (lane == 31) block_total = w_incl;
  }
  __syncthreads();
  const int result = warp_prefix[warp] + incl - v;
  *total = block_total;
  __syncthreads();  // a later call may reuse the shared slots
  return result;
}

// Blocks for a grid-stride loop over n elements: enough to fill the card,
// no more than the elements need.
inline int grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // 16 blocks on each of an H100's 132 SMs
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

// Blocks of ``kernel`` (``threads`` a block, no dynamic shared memory) that
// the current device holds at once: SMs x resident blocks an SM, from the
// device's properties. ``cache`` holds one such kernel's answer by device
// ordinal (64 entries, 0 = not asked yet; a race writes the same value).
inline int resident_wave(const void* kernel, int threads, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int b = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) cache[dev] = b;
  return b;
}

}  // namespace repro

// Exported by every kernel library, so a wrapper can name a failed launch.
#define REPRO_EXPORT_ERROR_STRING                                    \
  extern "C" const char* error_string(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }
