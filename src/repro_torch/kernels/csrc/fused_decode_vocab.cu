// Bytes-in loop ① for Hopper: Decode -> uint32 Modulus -> GenVocab
// scatter-min of first positions, from a raw UTF-8 chunk straight into the
// VocabState; the decoded field table is never stored.
//
// Replaces src/repro/kernels/fused_decode_vocab/kernel.py::
// fused_decode_genvocab, together with the short-row correction that
// src/repro/kernels/fused_decode_vocab/ops.py::fused_decode_update applies
// after it.
//
// What bounds it on this card: memory traffic. The chunk is read by the
// count and compact passes, and each sparse field's bytes once more by the
// fold; each sparse cell of a kept row then does one atomicMin on a
// data-dependent slot of the state. The 26 x 5000 int32 state (520 KB)
// stays in L2; the 26 x 1M state (104 MB) does not, so at 1M each atomic is
// a scattered read-modify-write of a 32-byte sector in device memory.
//
// Design. The TPU kernel carried the decode scan across an in-order grid and
// kept the state in VMEM. Here the shared delimiter passes
// (decode_passes.cuh) place every field, then
//   4. genvocab — one thread per sparse cell (row, c) of the max_rows rows.
//      Rows at or past n_cap = min(#newlines, max_rows), read on the device
//      from the scan's totals, are skipped. Each thread folds its field as
//      fold_field does (0 past the last delimiter) and does
//      atomicMin(first_pos[c, value % V], pos), pos = rows_seen + row in
//      uint32; a position at or past NEVER is skipped, which is what the
//      reference's saturation at NEVER (the min identity) amounts to.
// Every cell of every kept row is scattered, a short row's missing fields
// with the value 0, exactly as decode -> vocab.update scatters the decoded
// table's zeros; so the reference wrapper's per-column short-row correction
// has no counterpart. min is order-independent, so the state is
// bit-identical at any V, with no memory tier. One thread writes the advanced
// rows_seen (rows_seen + n_cap, saturating at NEVER) to a separate output,
// so no thread reads a count that another has already moved. first_pos is
// updated in place; the reference donates it. There is no count plane, as in
// the reference.

#include "decode_passes.cuh"

namespace {

__global__ void genvocab_kernel(const uint8_t* __restrict__ buf,
                                const int* __restrict__ delim_pos, const int* __restrict__ totals,
                                int* __restrict__ first_pos, const int* __restrict__ rows_seen_in,
                                int* __restrict__ rows_seen_out, int max_rows, int n_fields,
                                int hex_start, int vocab_range) {
  const int n_sparse = n_fields - hex_start;
  const int64_t n_delims = totals[0];
  const int n_cap = totals[1] < max_rows ? totals[1] : max_rows;
  const uint32_t seen = static_cast<uint32_t>(rows_seen_in[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t t = seen + static_cast<uint32_t>(n_cap);
    rows_seen_out[0] = static_cast<int>(t > repro::kNever ? repro::kNever : t);
  }
  const int64_t cells = static_cast<int64_t>(n_cap) * n_sparse;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < cells;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / n_sparse);
    const int c = static_cast<int>(i - static_cast<int64_t>(row) * n_sparse);
    const uint32_t p = seen + static_cast<uint32_t>(row);  // wraps like the reference's uint32
    if (p >= repro::kNever) continue;                      // saturated: dropped
    const int64_t k = static_cast<int64_t>(row) * n_fields + hex_start + c;
    const uint32_t v = fold_field(buf, delim_pos, k, n_delims, 16u) %
                       static_cast<uint32_t>(vocab_range);
    atomicMin(first_pos + static_cast<int64_t>(c) * vocab_range + v, static_cast<int>(p));
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING
REPRO_EXPORT_DECODE_SCRATCH

// buf: uint8 [n] raw rows. scratch: int32 [decode_scratch_ints(n, max_rows *
// n_fields)]. first_pos: int32 [n_fields - hex_start, vocab_range], updated
// in place. rows_seen_in/out: int32 []. n < 2^31, max_rows * n_fields < 2^31,
// n_fields > hex_start.
extern "C" int fused_decode_genvocab(const void* buf, int64_t n, int max_rows, int n_fields,
                                     int hex_start, int vocab_range, void* scratch,
                                     void* first_pos, const void* rows_seen_in,
                                     void* rows_seen_out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(buf);
  const DecodeScratch sc = decode_scratch(scratch, n);
  run_decode_passes(bytes, n, static_cast<int64_t>(max_rows) * n_fields, sc, s);
  const int64_t cells = static_cast<int64_t>(max_rows) * (n_fields - hex_start);
  genvocab_kernel<<<repro::grid_for(cells, kDecodeThreads), kDecodeThreads, 0, s>>>(
      bytes, sc.delim_pos, sc.totals, static_cast<int*>(first_pos),
      static_cast<const int*>(rows_seen_in), static_cast<int*>(rows_seen_out), max_rows,
      n_fields, hex_start, vocab_range);
  return static_cast<int>(cudaGetLastError());
}
