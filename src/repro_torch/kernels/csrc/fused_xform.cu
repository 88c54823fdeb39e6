// Loop ② for Hopper: uint32 Modulus -> ApplyVocab gather, beside
// Neg2Zero -> Logarithm on the dense columns, one launch per chunk.
//
// Replaces src/repro/kernels/fused_xform/kernel.py::fused_transform
// (kGather = true) and ::fused_mod_dense (kGather = false, which stops at the
// modded indices and leaves the gather to the caller).
//
// What bounds it on this card: bytes and latency. Per row it reads n_sparse
// + n_dense int32 and writes as many int32/f32; the gather reads one table
// entry per sparse element, in 32-byte sectors, from L2 for the 520 KB
// table at 5K and mostly from device memory for the 104 MB table at 1M.
// For a 16384-row chunk that is 5.1 MB, 1.5-1.7 µs, close to the cost of a
// launch, so the dependent round trips (the hash, then the table entry)
// and the instructions per element decide the rest.
//
// Design. The TPU kernel held every column's table in VMEM (constant index
// map) and fell back to fused_mod_dense plus an XLA gather once the tables
// outgrew it. Here the gather reads the table straight from device memory
// through L2 at any vocab_range, so loop ② needs no memory tier.
//  - Four consecutive elements a thread, 16-byte loads and stores where the
//    rows are aligned; the sparse quads take the first threads, the dense
//    quads warps of their own after them; 128 threads a block, so the
//    blocks spread evenly over the SMs. (Eight elements a thread, or blocks
//    of 64, 256 or 512 threads, took longer on an H100.)
//  - A thread loads its four hashes, computes all four slots, then issues
//    the four table loads together, so they are in flight at once.
//  - The modulus is Lemire's fastmod, v mod V = hi64(lo64(M * v) * V) with
//    M = ceil(2^64 / V) mod 2^64 from the wrapper: exact for every uint32 v
//    and 1 <= V < 2^32, three multiplies in place of a division. The column
//    of the quad's first element comes the same way (M for n_sparse), the
//    next three by a step.
//  - 64-bit indices throughout.
// The dense half is log1pf(fmaxf((float)d, 0)), built without fast math so
// log1pf keeps its accuracy.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// v mod d from m = ceil(2^64 / d) mod 2^64 (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019); d = 1 gives m = 0 and 0.
__device__ __forceinline__ uint32_t fastmod(uint32_t v, uint64_t m, uint32_t d) {
  const uint64_t low = m * v;
  const uint64_t hi = static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) * d +
                      __umulhi(static_cast<uint32_t>(low), d);
  return static_cast<uint32_t>(hi >> 32);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kGather>
__device__ __forceinline__ int slot_value(const int* __restrict__ table, uint32_t v, int col,
                                          uint32_t vocab_range) {
  return kGather ? __ldg(table + static_cast<int64_t>(col) * vocab_range + v)
                 : static_cast<int>(v);
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads)
    xform_kernel(const int* __restrict__ table, const int* __restrict__ sparse,
                 const int* __restrict__ dense, int* __restrict__ ids,
                 float* __restrict__ dense_out, int64_t n_s, int64_t n_d, int n_sparse,
                 uint64_t cols_magic, uint32_t vocab_range, uint64_t vocab_magic) {
  const int64_t quads_s = (n_s + 3) / 4;
  const int64_t quads = quads_s + (n_d + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; q < quads;
       q += stride) {
    if (q < quads_s) {
      const int64_t e = 4 * q;
      // e < 2^31: rows * n_sparse is below it (the wrapper's check)
      int col = static_cast<int>(fastmod(static_cast<uint32_t>(e), cols_magic, n_sparse));
      if (e + 4 <= n_s && aligned16(sparse) && aligned16(ids)) {
        const int4 h = __ldg(reinterpret_cast<const int4*>(sparse + e));
        const int hv[4] = {h.x, h.y, h.z, h.w};
        uint32_t v[4];
        int c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = fastmod(static_cast<uint32_t>(hv[j]), vocab_magic, vocab_range);
          c[j] = col;
          col = col + 1 == n_sparse ? 0 : col + 1;
        }
        int out[4];  // all four gathers issued before any is used
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = slot_value<kGather>(table, v[j], c[j], vocab_range);
        *reinterpret_cast<int4*>(ids + e) = make_int4(out[0], out[1], out[2], out[3]);
      } else {
        for (int64_t i = e; i < e + 4 && i < n_s; ++i) {
          const uint32_t v = fastmod(static_cast<uint32_t>(sparse[i]), vocab_magic, vocab_range);
          ids[i] = slot_value<kGather>(table, v, col, vocab_range);
          col = col + 1 == n_sparse ? 0 : col + 1;
        }
      }
    } else {
      const int64_t e = 4 * (q - quads_s);
      if (e + 4 <= n_d && aligned16(dense) && aligned16(dense_out)) {
        const int4 d = __ldg(reinterpret_cast<const int4*>(dense + e));
        *reinterpret_cast<float4*>(dense_out + e) =
            make_float4(log1pf(fmaxf(static_cast<float>(d.x), 0.f)),
                        log1pf(fmaxf(static_cast<float>(d.y), 0.f)),
                        log1pf(fmaxf(static_cast<float>(d.z), 0.f)),
                        log1pf(fmaxf(static_cast<float>(d.w), 0.f)));
      } else {
        for (int64_t i = e; i < e + 4 && i < n_d; ++i)
          dense_out[i] = log1pf(fmaxf(static_cast<float>(dense[i]), 0.f));
      }
    }
  }
}

template <bool kGather>
int launch(const void* table, const void* sparse, const void* dense, void* ids, void* dense_out,
           int rows, int n_sparse, int n_dense, uint64_t cols_magic, int vocab_range,
           uint64_t vocab_magic, void* stream) {
  const int64_t n_s = static_cast<int64_t>(rows) * n_sparse;
  const int64_t n_d = static_cast<int64_t>(rows) * n_dense;
  const int64_t quads = (n_s + 3) / 4 + (n_d + 3) / 4;
  xform_kernel<kGather><<<repro::grid_for(quads, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(sparse),
      static_cast<const int*>(dense), static_cast<int*>(ids), static_cast<float*>(dense_out),
      n_s, n_d, n_sparse, cols_magic, static_cast<uint32_t>(vocab_range), vocab_magic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// table: int32 [n_sparse, vocab_range]. sparse: int32 [rows, n_sparse] raw
// hashes. dense: int32 [rows, n_dense]. ids: int32 [rows, n_sparse] out.
// dense_out: f32 [rows, n_dense] out. rows * max(n_sparse, n_dense) < 2^31.
// cols_magic and vocab_magic: ceil(2^64 / d) mod 2^64 for d = n_sparse (0
// when n_sparse is 0) and d = vocab_range.
extern "C" int fused_transform(const void* table, const void* sparse, const void* dense,
                               void* ids, void* dense_out, int rows, int n_sparse, int n_dense,
                               uint64_t cols_magic, int vocab_range, uint64_t vocab_magic,
                               void* stream) {
  return launch<true>(table, sparse, dense, ids, dense_out, rows, n_sparse, n_dense, cols_magic,
                      vocab_range, vocab_magic, stream);
}

// As fused_transform without the table: modded int32 [rows, n_sparse] out.
extern "C" int fused_mod_dense(const void* sparse, const void* dense, void* modded,
                               void* dense_out, int rows, int n_sparse, int n_dense,
                               uint64_t cols_magic, int vocab_range, uint64_t vocab_magic,
                               void* stream) {
  return launch<false>(nullptr, sparse, dense, modded, dense_out, rows, n_sparse, n_dense,
                       cols_magic, vocab_range, vocab_magic, stream);
}
