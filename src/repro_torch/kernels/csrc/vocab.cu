// The per-op vocabulary kernels for Hopper: GenVocab's scatter-min of first
// positions (with the optional occurrence-count plane) and ApplyVocab's
// table gather, each one launch per chunk on modded values.
//
// Replaces src/repro/kernels/vocab/kernel.py::genvocab and ::apply_vocab.
//
// What bounds them on this card: memory traffic. genvocab reads 4 bytes of
// modded value per (row, column) element plus the row's position, and does
// one atomicMin (and one atomicAdd with counts) on a data-dependent slot of
// the state; apply_vocab reads 4 bytes, gathers one table entry and writes
// 4 bytes per element. The 27 x 5000 int32 state or table (540 KB) stays in
// the 50 MB L2; the 27 x 1M one (108 MB) does not, so at 1M each atomic or
// gather is a scattered 32-byte sector access in device memory.
//
// Design. The TPU kernels put one column per grid step: genvocab held the
// column's whole state row in VMEM and updated it with a serial
// read-modify-write loop over the chunk's rows (two equal values in one
// chunk must min-combine), and apply_vocab gathered from the VMEM-resident
// row; tables past VMEM went to XLA. Here min is order-independent, so
// atomicMin on the int32 state in device memory gives the reference's state
// bit for bit at any vocab_range, with no serial loop and no memory tier.
// Both kernels read the pipeline's row-major [rows, n_cols] layout directly,
// one thread per element, so a warp's loads and stores coalesce; the TPU's
// transposed [n_cols, rows] layout is not needed. The positions come from
// the wrapper (vocab.positions: uint32 from rows_seen, saturating at NEVER,
// NEVER for invalid rows). A row at NEVER is skipped: atomicMin with NEVER
// changes nothing, and the reference adds no count for it. A value outside
// [0, vocab_range) is skipped by genvocab (the reference's scatter drops
// it) and gives 0 in apply_vocab; the pipeline's modulus never makes one.
// The state and counts are updated in place; the reference donates them.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void genvocab_kernel(int* __restrict__ first_pos, int* __restrict__ counts,
                                const int* __restrict__ modded, const int* __restrict__ pos,
                                int rows, int n_cols, int vocab_range) {
  const int total = rows * n_cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = i / n_cols;
    const int p = pos[r];
    if (static_cast<uint32_t>(p) >= repro::kNever) continue;  // invalid or saturated
    const uint32_t v = static_cast<uint32_t>(modded[i]);
    if (v >= static_cast<uint32_t>(vocab_range)) continue;
    const int c = i - r * n_cols;
    const int64_t slot = static_cast<int64_t>(c) * vocab_range + v;
    atomicMin(first_pos + slot, p);
    if (counts != nullptr) atomicAdd(counts + slot, 1);
  }
}

__global__ void apply_vocab_kernel(const int* __restrict__ table, const int* __restrict__ modded,
                                   int* __restrict__ ids, int rows, int n_cols, int vocab_range) {
  const int total = rows * n_cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const uint32_t v = static_cast<uint32_t>(modded[i]);
    const int c = i % n_cols;
    ids[i] = v < static_cast<uint32_t>(vocab_range)
                 ? table[static_cast<int64_t>(c) * vocab_range + v]
                 : 0;
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// first_pos: int32 [n_cols, vocab_range], updated in place. counts: int32
// [n_cols, vocab_range] updated in place, or null for no count plane.
// modded: int32 [rows, n_cols] in [0, vocab_range). pos: int32 [rows].
// 1 <= rows * n_cols < 2^31.
extern "C" int genvocab(void* first_pos, void* counts, const void* modded, const void* pos,
                        int rows, int n_cols, int vocab_range, void* stream) {
  genvocab_kernel<<<repro::grid_for(static_cast<int64_t>(rows) * n_cols, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(first_pos), static_cast<int*>(counts), static_cast<const int*>(modded),
      static_cast<const int*>(pos), rows, n_cols, vocab_range);
  return static_cast<int>(cudaGetLastError());
}

// table: int32 [n_cols, vocab_range]. modded: int32 [rows, n_cols] in
// [0, vocab_range). ids: int32 [rows, n_cols] out. 1 <= rows * n_cols < 2^31.
extern "C" int apply_vocab(const void* table, const void* modded, void* ids, int rows,
                           int n_cols, int vocab_range, void* stream) {
  apply_vocab_kernel<<<repro::grid_for(static_cast<int64_t>(rows) * n_cols, kThreads), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(modded), static_cast<int*>(ids),
      rows, n_cols, vocab_range);
  return static_cast<int>(cudaGetLastError());
}
