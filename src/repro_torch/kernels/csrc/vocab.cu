// The per-op vocabulary kernels for Hopper: GenVocab's scatter-min of first
// positions (with the optional occurrence-count plane) and ApplyVocab's
// table gather, each one launch per chunk on modded values.
//
// Replaces src/repro/kernels/vocab/kernel.py::genvocab and ::apply_vocab.
//
// What bounds them on this card: latency, then memory traffic. genvocab
// reads 4 bytes of modded value per (row, column) element and a valid byte
// per row, and does an atomicMin (and an atomicAdd with counts) on a
// data-dependent slot of the state; apply_vocab reads 4 bytes, gathers one
// table entry and writes 4 bytes per element. The 27 x 5000 int32 state or
// table (540 KB) stays in the 50 MB L2; the 27 x 1M one (108 MB) does not,
// so at 1M each atomic or gather is a scattered 32-byte sector access in
// device memory. A chunk's bytes take well under a microsecond, so the
// dependent round trips of one small launch, the atomics that hot slots
// serialize in L2, and the count of valid rows (which rows_seen needs
// whole) set genvocab's time.
//
// Design. The TPU kernels put one column per grid step: genvocab held the
// column's whole state row in VMEM and updated it with a serial
// read-modify-write loop over the chunk's rows (two equal values in one
// chunk must min-combine), and apply_vocab gathered from the VMEM-resident
// row; tables past VMEM went to XLA. Here min is order-independent, so
// atomicMin on the int32 state in device memory gives the reference's state
// bit for bit at any vocab_range, with no serial loop and no memory tier.
// Both kernels read the pipeline's row-major [rows, n_cols] layout
// directly; the TPU's transposed [n_cols, rows] layout is not needed.
//  - genvocab is all of GenVocab in one launch, with no work on the host or
//    in other launches: the warp-per-column kernel of genvocab_warp.cuh,
//    which fused_genvocab runs too. It computes each row's position from
//    rows_seen on the device (vocab.positions: a row is live only if it is
//    valid and below NEVER; valid need not be a prefix), merges equal slots
//    of 32 rows in the warp, reads each slot before its atomicMin, adds a
//    group's size to the count plane with one atomicAdd, and counts the
//    valid rows into the row tally, whose last block writes the advanced
//    rows_seen (vocab.advance_rows_seen) to a separate output. A value
//    outside [0, vocab_range) is skipped (the reference's scatter drops
//    it); the pipeline's modulus never makes one.
//  - apply_vocab is one thread per element, so a warp's loads and stores
//    coalesce; a value outside [0, vocab_range) gives 0.
// The state and counts are updated in place; the reference donates them.

#include "genvocab_warp.cuh"

namespace {

constexpr int kThreads = 256;

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
// modded: int32 [rows, n_cols] in [0, vocab_range). valid: bool [rows].
// rows_seen_in/out: int32 []. tally: uint64 [1], 0 before the launch and
// after it; no other launch may use it meanwhile. 1 <= rows, 0 <= n_cols,
// rows * n_cols < 2^31.
extern "C" int genvocab(void* first_pos, void* counts, const void* modded, const void* valid,
                        const void* rows_seen_in, void* rows_seen_out, void* tally, int rows,
                        int n_cols, int vocab_range, void* stream) {
  auto* fp = static_cast<int*>(first_pos);
  auto* cn = static_cast<int*>(counts);
  auto* vals = static_cast<const int*>(modded);
  auto* ok = static_cast<const uint8_t*>(valid);
  auto* seen_in = static_cast<const int*>(rows_seen_in);
  auto* seen_out = static_cast<int*>(rows_seen_out);
  auto* t = static_cast<unsigned long long*>(tally);
  auto* st = static_cast<cudaStream_t>(stream);
  return cn != nullptr
             ? launch_genvocab_warp<RangeSlot, true>(fp, cn, vals, ok, seen_in, seen_out, t,
                                                     rows, n_cols, vocab_range, st)
             : launch_genvocab_warp<RangeSlot, false>(fp, nullptr, vals, ok, seen_in, seen_out,
                                                      t, rows, n_cols, vocab_range, st);
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
