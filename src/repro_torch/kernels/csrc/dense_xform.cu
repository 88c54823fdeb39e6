// The dense transform for Hopper: Neg2Zero -> Logarithm, log1p(max(x, 0))
// into f32, on int32 or f32 input, one launch per chunk.
//
// Replaces src/repro/kernels/dense_xform/kernel.py::dense_transform.
//
// What bounds it on this card: bytes, and below a few MB the launch. It
// reads 4 bytes and writes 4 bytes per element, with one log1pf between:
// the crossed plan's [16384, 12] int32 group is 1.57 MB, 0.47 µs at 3.35
// TB/s, under the cost of a launch, so what costs is the instructions and
// round trips per byte and how evenly the blocks land on the SMs.
//
// Design. The TPU kernel streamed [512, n_dense] row blocks through VMEM
// over a padded grid. Here the flat row-major buffer needs no padding:
//  - four consecutive elements a thread, one 16-byte load (four 4-byte
//    loads where the input does not line up with the output) and one
//    16-byte store, aligned on the output; a head and a tail of up to three
//    elements take one element a thread, so any contiguous buffer works,
//    one that starts 4 bytes past a 16-byte boundary too;
//  - 128 threads a block, and at most one resident wave of the card (SMs x
//    resident blocks, from the device's properties) with a grid-stride loop
//    over the rest; 64-bit indices. (Two or eight elements a thread, and
//    blocks of 64 or 256 threads, took longer on an H100.)
// The input type is a template parameter: the decoded and binary feeds give
// int32, a caller may give f32. The transform is dense_quad.cuh's, which
// keeps a NaN input NaN.

#include <algorithm>

#include "dense_quad.cuh"

namespace {

constexpr int kThreads = 128;

// out[i] = log1p(max(f32(x[i]), 0)) for i < n: the elements [0, head) and
// [head + 4 quads, n) (fewer than four each) one a thread, the quads
// between four a thread. out + head is 16-byte aligned, and so is x + head
// when vec_in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_xform_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t n, int head,
                       int64_t quads, bool vec_in) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t tail = head + 4 * quads;
  if (g < head) out[g] = neg2zero_log1p(static_cast<float>(x[g]));
  if (g < n - tail) out[tail + g] = neg2zero_log1p(static_cast<float>(x[tail + g]));
  for (int64_t q = g; q < quads; q += stride) {
    const int64_t e = head + 4 * q;
    *reinterpret_cast<float4*>(out + e) = neg2zero_log1p(load_quad_f32(x + e, vec_in));
  }
}

// Blocks of dense_xform_kernel<T> that the current device holds at once.
template <typename T>
int wave() {
  static int blocks[64] = {};
  return repro::resident_wave(reinterpret_cast<const void*>(dense_xform_kernel<T>), kThreads,
                              blocks);
}

// Blocks for `quads` quads: a block per 128 quads, at most one resident wave.
template <typename T>
int blocks_for(int64_t quads) {
  const int64_t want = std::max<int64_t>(1, (quads + kThreads - 1) / kThreads);
  return static_cast<int>(std::min<int64_t>(want, wave<T>()));
}

template <typename T>
int launch(const void* x, void* out, int64_t n, cudaStream_t stream) {
  const auto* in = static_cast<const T*>(x);
  auto* o = static_cast<float*>(out);
  const int head = static_cast<int>(
      std::min<int64_t>(n, ((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4));
  const int64_t quads = (n - head) / 4;
  const bool vec_in = (reinterpret_cast<uintptr_t>(in + head) & 15) == 0;
  const int blocks = blocks_for<T>(quads);
  dense_xform_kernel<T><<<blocks, kThreads, 0, stream>>>(in, o, n, head, quads, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
repro::LaunchRecord launch_record(int64_t n) {
  return {blocks_for<T>(n / 4), 1, 1, kThreads, 0, 0, wave<T>()};
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x: int32 (is_f32 == 0) or f32 (is_f32 != 0), n elements, contiguous, at
// any 4-byte alignment. out: f32, n elements, contiguous, at any 4-byte
// alignment. n >= 1.
extern "C" int dense_transform(const void* x, void* out, int64_t n, int is_f32, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float>(x, out, n, s) : launch<int>(x, out, n, s);
}

// Entry 0 dense_transform, args (n, is_f32): one launch of
// dense_xform_kernel<int> or <float> with an aligned output (no head).
REPRO_LAUNCH_CONFIG(dense_xform) {
  if (entry != 0 || n_args != 2 || args[0] < 1) return -1;
  return repro::put_launch(out, max, 0,
                           args[1] ? launch_record<float>(args[0]) : launch_record<int>(args[0]));
}
