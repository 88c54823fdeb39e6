// Loop ② for Hopper: uint32 Modulus -> ApplyVocab gather, beside
// Neg2Zero -> Logarithm on the dense columns, one launch per chunk.
//
// Replaces src/repro/kernels/fused_xform/kernel.py::fused_transform
// (kGather = true) and ::fused_mod_dense (kGather = false, which stops at the
// modded indices and leaves the gather to the caller).
//
// What bounds it on this card: bytes. Per row it reads n_sparse + n_dense
// int32 and writes as many int32/f32; the gather reads one table entry per
// sparse element, from L2 for the 520 KB table at 5K and mostly from device
// memory for the 104 MB table at 1M.
//
// Design. The TPU kernel held every column's table in VMEM (constant index
// map) and fell back to fused_mod_dense plus an XLA gather once the tables
// outgrew it. Here the gather reads the table straight from device memory
// through L2 at any vocab_range, so loop ② needs no memory tier. One thread
// per element of the row-major [rows, n_sparse] and [rows, n_dense] matrices,
// so loads and stores coalesce. The dense half is log1pf(fmaxf((float)d, 0)),
// built without fast math so log1pf keeps its accuracy.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kGather>
__global__ void xform_kernel(const int* __restrict__ table, const int* __restrict__ sparse,
                             const int* __restrict__ dense, int* __restrict__ ids,
                             float* __restrict__ dense_out, int rows, int n_sparse, int n_dense,
                             int vocab_range) {
  const int n_s = rows * n_sparse;
  const int n_d = rows * n_dense;
  const int n = n_s > n_d ? n_s : n_d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    if (i < n_s) {
      const uint32_t v = static_cast<uint32_t>(sparse[i]) % static_cast<uint32_t>(vocab_range);
      if (kGather) {
        const int c = i % n_sparse;
        ids[i] = table[static_cast<int64_t>(c) * vocab_range + v];
      } else {
        ids[i] = static_cast<int>(v);
      }
    }
    if (i < n_d) dense_out[i] = log1pf(fmaxf(static_cast<float>(dense[i]), 0.f));
  }
}

template <bool kGather>
int launch(const void* table, const void* sparse, const void* dense, void* ids, void* dense_out,
           int rows, int n_sparse, int n_dense, int vocab_range, void* stream) {
  const int64_t n_s = static_cast<int64_t>(rows) * n_sparse;
  const int64_t n_d = static_cast<int64_t>(rows) * n_dense;
  xform_kernel<kGather><<<repro::grid_for(n_s > n_d ? n_s : n_d, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(sparse),
      static_cast<const int*>(dense), static_cast<int*>(ids), static_cast<float*>(dense_out),
      rows, n_sparse, n_dense, vocab_range);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// table: int32 [n_sparse, vocab_range]. sparse: int32 [rows, n_sparse] raw
// hashes. dense: int32 [rows, n_dense]. ids: int32 [rows, n_sparse] out.
// dense_out: f32 [rows, n_dense] out. rows * max(n_sparse, n_dense) < 2^31.
extern "C" int fused_transform(const void* table, const void* sparse, const void* dense,
                               void* ids, void* dense_out, int rows, int n_sparse, int n_dense,
                               int vocab_range, void* stream) {
  return launch<true>(table, sparse, dense, ids, dense_out, rows, n_sparse, n_dense, vocab_range,
                      stream);
}

// As fused_transform without the table: modded int32 [rows, n_sparse] out.
extern "C" int fused_mod_dense(const void* sparse, const void* dense, void* modded,
                               void* dense_out, int rows, int n_sparse, int n_dense,
                               int vocab_range, void* stream) {
  return launch<false>(nullptr, sparse, dense, modded, dense_out, rows, n_sparse, n_dense,
                       vocab_range, stream);
}
