// The dense transform for Hopper: Neg2Zero -> Logarithm, log1p(max(x, 0))
// into f32, on int32 or f32 input, one launch per chunk.
//
// Replaces src/repro/kernels/dense_xform/kernel.py::dense_transform.
//
// What bounds it on this card: bytes. It reads 4 bytes and writes 4 bytes
// per element, with one log1pf between.
//
// Design. The TPU kernel streamed [512, n_dense] row blocks through VMEM
// over a padded grid. Here one thread per element of the flat row-major
// matrix, in a grid-stride loop that masks the ragged end itself, so no
// padding is needed and loads and stores coalesce. The input type is a
// template parameter: the decoded and binary feeds give int32, a caller may
// give f32. max is taken after the conversion to f32, as in the reference,
// so a NaN input stays NaN (fmaxf would turn it into 0). Built without fast
// math, so log1pf keeps its accuracy (rtol 1e-6 against torch.log1p).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void dense_xform_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = static_cast<float>(x[i]);
    out[i] = log1pf(v < 0.f ? 0.f : v);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// x: int32 (is_f32 == 0) or f32 (is_f32 != 0), n elements. out: f32, n
// elements. n >= 1.
extern "C" int dense_transform(const void* x, void* out, int64_t n, int is_f32, void* stream) {
  const int grid = repro::grid_for(n, kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    dense_xform_kernel<float>
        <<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out), n);
  } else {
    dense_xform_kernel<int>
        <<<grid, kThreads, 0, s>>>(static_cast<const int*>(x), static_cast<float*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
