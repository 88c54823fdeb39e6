// Loop ① for Hopper: uint32 Modulus -> GenVocab scatter-min of first
// positions (+ the optional occurrence-count plane), one launch per chunk.
//
// Replaces src/repro/kernels/fused_vocab/kernel.py::fused_genvocab
// (kTrackCounts = false) and ::fused_genvocab_slabs (kTrackCounts = true).
//
// What bounds it on this card: memory traffic. Each (row, column) element
// reads 4 bytes of hash and does one atomicMin (and one atomicAdd with
// counts) on a data-dependent slot of the state. The 26 x 5000 int32 state
// (520 KB) stays in the 50 MB L2; the 26 x 1M state (104 MB, twice that with
// counts) does not, so at 1M each atomic is a scattered read-modify-write of
// a 32-byte sector in device memory.
//
// Design. The TPU kernels kept the state in VMEM, carried across an in-order
// grid, and split ranges beyond VMEM into slabs streamed one by one. None of
// that is needed here: min is order-independent, so atomicMin on the int32
// state in device memory gives the same state as the reference's scatter-min
// at any vocab_range, in one pass, with no slab tier. One thread per element
// of the row-major [rows, n_cols] hash matrix, so a warp's loads coalesce.
// Positions are computed here from rows_seen and valid exactly as
// vocab.positions does (uint32, saturating at NEVER); a row at NEVER is
// skipped, which is what the reference's min identity and zero count
// increment amount to. Block 0 also counts the valid rows and writes the
// advanced rows_seen (vocab.advance_rows_seen) to a separate output, so no
// thread reads a count another thread has already moved. The state is
// updated in place; the reference donates it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kTrackCounts>
__global__ void genvocab_kernel(int* __restrict__ first_pos, int* __restrict__ counts,
                                const int* __restrict__ sparse, const uint8_t* __restrict__ valid,
                                const int* __restrict__ rows_seen_in,
                                int* __restrict__ rows_seen_out, int rows, int n_cols,
                                int vocab_range) {
  const uint32_t seen = static_cast<uint32_t>(rows_seen_in[0]);
  const int total = rows * n_cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = i / n_cols;
    if (!valid[r]) continue;
    const uint32_t p = seen + static_cast<uint32_t>(r);  // wraps like the reference's uint32
    if (p >= repro::kNever) continue;                    // saturated: dropped
    const int c = i - r * n_cols;
    const uint32_t v = static_cast<uint32_t>(sparse[i]) % static_cast<uint32_t>(vocab_range);
    const int64_t slot = static_cast<int64_t>(c) * vocab_range + v;
    atomicMin(first_pos + slot, static_cast<int>(p));
    if (kTrackCounts) atomicAdd(counts + slot, 1);
  }
  if (blockIdx.x == 0) {
    int n_valid = 0;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) n_valid += valid[r] != 0;
    int total_valid;
    repro::block_exclusive_sum(n_valid, &total_valid);
    if (threadIdx.x == 0) {
      const uint32_t t = seen + static_cast<uint32_t>(total_valid);
      rows_seen_out[0] = static_cast<int>(t > repro::kNever ? repro::kNever : t);
    }
  }
}

template <bool kTrackCounts>
int launch(void* first_pos, void* counts, const void* sparse, const void* valid,
           const void* rows_seen_in, void* rows_seen_out, int rows, int n_cols, int vocab_range,
           void* stream) {
  genvocab_kernel<kTrackCounts>
      <<<repro::grid_for(static_cast<int64_t>(rows) * n_cols, kThreads), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<int*>(first_pos), static_cast<int*>(counts),
          static_cast<const int*>(sparse), static_cast<const uint8_t*>(valid),
          static_cast<const int*>(rows_seen_in), static_cast<int*>(rows_seen_out), rows, n_cols,
          vocab_range);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// first_pos: int32 [n_cols, vocab_range], updated in place. sparse: int32
// [rows, n_cols] raw hashes. valid: bool [rows]. rows_seen_in/out: int32 [].
// rows * n_cols < 2^31; rows >= 1.
extern "C" int fused_genvocab(void* first_pos, const void* sparse, const void* valid,
                              const void* rows_seen_in, void* rows_seen_out, int rows, int n_cols,
                              int vocab_range, void* stream) {
  return launch<false>(first_pos, nullptr, sparse, valid, rows_seen_in, rows_seen_out, rows,
                       n_cols, vocab_range, stream);
}

// As fused_genvocab, and counts: int32 [n_cols, vocab_range], updated in place.
extern "C" int fused_genvocab_counts(void* first_pos, void* counts, const void* sparse,
                                     const void* valid, const void* rows_seen_in,
                                     void* rows_seen_out, int rows, int n_cols, int vocab_range,
                                     void* stream) {
  return launch<true>(first_pos, counts, sparse, valid, rows_seen_in, rows_seen_out, rows, n_cols,
                      vocab_range, stream);
}
