// Loop ① for Hopper: uint32 Modulus -> GenVocab scatter-min of first
// positions (+ the optional occurrence-count plane), one launch per chunk.
//
// Replaces src/repro/kernels/fused_vocab/kernel.py::fused_genvocab
// (fused_genvocab here) and ::fused_genvocab_slabs (fused_genvocab_counts).
//
// What bounds it on this card: not bytes. A 1 MiB utf8 chunk holds about
// 3745 live rows of 26 hashes (390 KB), a binary chunk 16384 (1.7 MB), so
// the bytes take 0.2-0.6 µs, under one launch. What costs is latency: the
// dependent round trips of a launch this small; atomics on one address,
// which serialize in L2 (Piper's feed is Zipf(1.3) over 2^14 hashes a
// column, so about a quarter of a column's rows hit one slot: 4096 atomics
// on the binary chunk); at 1M a fresh slot is a scattered read-modify-write
// of device memory; and the count of valid rows, which needs the whole
// chunk before rows_seen can advance.
//
// Design of fused_genvocab. The TPU kernel kept the state in VMEM and
// carried it across an in-order grid, with slabs for ranges beyond VMEM.
// Here min is order-independent, so atomicMin on the int32 state in device
// memory gives the reference's state bit for bit at any range, in one
// pass: the warp-per-column kernel of genvocab_warp.cuh (a block per 32
// rows, equal slots merged in the warp, a read before each atomicMin, the
// valid rows counted into a 64-bit tally), with the modulus taken on each
// hash as it is read.
//
// fused_genvocab_counts runs the same kernel with the count plane: the
// lane that acts for a group of equal slots also adds the group's size with
// one atomicAdd, so the counts cost one atomic per distinct slot of 32 rows
// rather than one per element, and no division or serial count of rows.

#include "genvocab_warp.cuh"

namespace {

__global__ void empty() {}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// first_pos: int32 [n_cols, vocab_range], updated in place. sparse: int32
// [rows, n_cols] raw hashes. valid: bool [rows]. rows_seen_in/out: int32 [].
// tally: uint64 [1], 0 before the launch and after it; no other launch may
// use it meanwhile. 1 <= rows, 1 <= n_cols, rows * n_cols < 2^31.
extern "C" int fused_genvocab(void* first_pos, const void* sparse, const void* valid,
                              const void* rows_seen_in, void* rows_seen_out, void* tally,
                              int rows, int n_cols, int vocab_range, void* stream) {
  return launch_genvocab_warp<ModSlot, false>(
      static_cast<int*>(first_pos), nullptr, static_cast<const int*>(sparse),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(rows_seen_in),
      static_cast<int*>(rows_seen_out), static_cast<unsigned long long*>(tally), rows, n_cols,
      vocab_range, static_cast<cudaStream_t>(stream));
}

// As fused_genvocab, and counts: int32 [n_cols, vocab_range], updated in place.
extern "C" int fused_genvocab_counts(void* first_pos, void* counts, const void* sparse,
                                     const void* valid, const void* rows_seen_in,
                                     void* rows_seen_out, void* tally, int rows, int n_cols,
                                     int vocab_range, void* stream) {
  return launch_genvocab_warp<ModSlot, true>(
      static_cast<int*>(first_pos), static_cast<int*>(counts), static_cast<const int*>(sparse),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(rows_seen_in),
      static_cast<int*>(rows_seen_out), static_cast<unsigned long long*>(tally), rows, n_cols,
      vocab_range, static_cast<cudaStream_t>(stream));
}

// Entries 0 fused_genvocab and 1 fused_genvocab_counts, args (rows,
// n_cols): one launch of genvocab_warp_kernel.
REPRO_LAUNCH_CONFIG(fused_vocab) {
  if ((entry != 0 && entry != 1) || n_args != 2 || args[0] < 1) return -1;
  return repro::put_launch(out, max, 0, genvocab_warp_launch(args[0], static_cast<int>(args[1])));
}

// An empty kernel on the stream: the launch floor the smoke measures
// beside the microsecond kernels.
extern "C" int empty_kernel(void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
