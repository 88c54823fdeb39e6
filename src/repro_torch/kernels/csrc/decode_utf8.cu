// Parallel UTF-8 tabular decode for Hopper: Decode (+ FillMissing, Hex2Int)
// and the StoreData scatter, from a raw byte chunk to the [max_rows, fields]
// table.
//
// Replaces src/repro/kernels/decode_utf8/kernel.py::decode_scan (the Pallas
// segmented affine scan) together with the scatter that
// src/repro/kernels/decode_utf8/ops.py::_decode applies to its output.
//
// What bounds it on this card: bytes. The chunk is read twice (count, then
// compact) and each field's bytes a third time by the fold, and the table
// (max_rows * n_fields int32) is written once; the arithmetic is a
// multiply-add per digit.
//
// Design. The TPU kernel carried (m, a, neg, ndelim) from one 2048-byte tile
// to the next through its in-order grid. CUDA blocks run in no order, so this
// kernel compacts the delimiters instead of carrying a scan: passes 1-3
// (count, scan, compact; decode_passes.cuh) find the byte position of every
// delimiter whose ordinal k is below max_rows * n_fields, then
//   4. fold    — one thread per output cell k = row * n_fields + col folds the
//                bytes of field k (fold_field), in base 16 iff
//                col >= hex_start.
// A field of any length, or one that straddles tiles, needs nothing special;
// rows past max_rows are never written (the reference drops them); cells past
// the last delimiter get 0, so a truncated final row keeps the fields it
// completed and padding rows are otherwise zero; valid[r] = r < #newlines.
// Every output cell is written exactly once, so nothing is zero-filled first.

#include "decode_passes.cuh"

namespace {

__global__ void fold_kernel(const uint8_t* __restrict__ buf, const int* __restrict__ delim_pos,
                            const int* __restrict__ totals, int max_rows, int n_fields,
                            int hex_start, int n_dense, int n_sparse, int* __restrict__ label,
                            int* __restrict__ dense, int* __restrict__ sparse,
                            uint8_t* __restrict__ valid) {
  const int64_t cells = static_cast<int64_t>(max_rows) * n_fields;
  const int64_t n_delims = totals[0];
  const int n_newlines = totals[1];
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < cells;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(k / n_fields);
    const int col = static_cast<int>(k - static_cast<int64_t>(row) * n_fields);
    const int out =
        static_cast<int>(fold_field(buf, delim_pos, k, n_delims, col >= hex_start ? 16u : 10u));
    if (col == 0) {
      label[row] = out;
      valid[row] = row < n_newlines;
    } else if (col <= n_dense) {
      dense[static_cast<int64_t>(row) * n_dense + (col - 1)] = out;
    } else {
      sparse[static_cast<int64_t>(row) * n_sparse + (col - 1 - n_dense)] = out;
    }
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING
REPRO_EXPORT_DECODE_SCRATCH

// buf: uint8 [n]. scratch: int32 [decode_scratch_ints(n, max_rows * n_fields)].
// label: int32 [max_rows]; dense: int32 [max_rows, n_dense];
// sparse: int32 [max_rows, n_sparse]; valid: bool [max_rows]; all contiguous.
// n_fields == 1 + n_dense + n_sparse, hex_start == 1 + n_dense, n < 2^31.
extern "C" int decode_utf8(const void* buf, int64_t n, int max_rows, int n_fields, int hex_start,
                           int n_dense, int n_sparse, void* scratch, void* label, void* dense,
                           void* sparse, void* valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = static_cast<int64_t>(max_rows) * n_fields;
  const uint8_t* bytes = static_cast<const uint8_t*>(buf);
  const DecodeScratch sc = decode_scratch(scratch, n);
  run_decode_passes(bytes, n, cells, sc, s);
  if (cells > 0) {
    fold_kernel<<<repro::grid_for(cells, kDecodeThreads), kDecodeThreads, 0, s>>>(
        bytes, sc.delim_pos, sc.totals, max_rows, n_fields, hex_start, n_dense, n_sparse,
        static_cast<int*>(label), static_cast<int*>(dense), static_cast<int*>(sparse),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
