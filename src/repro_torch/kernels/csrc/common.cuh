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

// The most blocks grid_for gives: 16 on each of an H100's 132 SMs.
constexpr int64_t kGridCap = 132 * 16;

// Blocks for a grid-stride loop over n elements: enough to fill the card,
// no more than the elements need.
inline int grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return static_cast<int>(want < 1 ? 1 : (want < kGridCap ? want : kGridCap));
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

// One launch as a library's <library>_launch_config reports it, field by
// field (kernels/_build.py LAUNCH_FIELDS): the grid's x, y and z; threads a
// block; dynamic shared bytes; the dynamic shared bytes the launcher opts
// in to with cudaFuncSetAttribute before the launch (0: none); the cap the
// launcher puts on grid x (0: none).
struct LaunchRecord {
  int64_t grid_x, grid_y, grid_z, threads, smem, opt_in, cap;
};
constexpr int kLaunchFields = 7;

// Writes record i into out, which has room for max records; returns i + 1,
// or -1 when there is no room.
inline int put_launch(int64_t* out, int max, int i, const LaunchRecord& r) {
  if (i < 0 || i >= max) return -1;
  int64_t* o = out + static_cast<int64_t>(i) * kLaunchFields;
  o[0] = r.grid_x;
  o[1] = r.grid_y;
  o[2] = r.grid_z;
  o[3] = r.threads;
  o[4] = r.smem;
  o[5] = r.opt_in;
  o[6] = r.cap;
  return i + 1;
}

}  // namespace repro

// The signature of every library's <library>_launch_config: the launches
// (kLaunchFields int64 each, at most max of them) that C entry point
// number `entry` of the library makes for the shape args[0 .. n_args),
// computed from the constants its launcher uses, on the current device.
// Returns how many it wrote, or -1 for an entry, shape or room it does not
// take. Output pointers are taken as 16-byte aligned, as PyTorch allocates.
#define REPRO_LAUNCH_CONFIG(library)                                             \
  extern "C" int library##_launch_config(int entry, const int64_t* args, int n_args, \
                                         int64_t* out, int max)

// Exported by every kernel library, so a wrapper can name a failed launch.
#define REPRO_EXPORT_ERROR_STRING                                    \
  extern "C" const char* error_string(int code) {                    \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }
