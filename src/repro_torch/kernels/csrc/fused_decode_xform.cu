// Bytes-in loop ② for Hopper: Decode -> uint32 Modulus -> ApplyVocab gather
// beside Neg2Zero -> Logarithm, from a raw UTF-8 chunk straight to the final
// features; the decoded field table is never stored.
//
// Replaces src/repro/kernels/fused_decode_xform/kernel.py::
// fused_decode_transform.
//
// What bounds it on this card: bytes. The chunk is read by the count and
// compact passes, and each field's bytes once more by the fold; the outputs
// (label and ids int32, dense f32, valid bool) are written once; the gather
// reads one table entry per sparse cell, from L2 for the 520 KB table at 5K
// and mostly from device memory for the 104 MB table at 1M.
//
// Design. The TPU kernel carried the decode scan across an in-order grid,
// accumulated a [max_rows + 1, n_fields] int32 table in VMEM (a trash row
// for dropped lanes, dense values as f32 bits) and seeded it at grid step 0
// with the transform of a zero field. None of that is carried over: after the
// shared delimiter passes (decode_passes.cuh),
//   4. transform — one thread per output cell (row, col) of
//      [max_rows, n_fields] folds its field with fold_field (0 past
//      the last delimiter) and writes it straight to its output:
//        label[row]         the raw value, and valid[row] = row < #newlines;
//        dense[row, col-1]  log1pf(fmaxf((float)v, 0));
//        ids[row, c]        table[c, v % V], read from device memory at any V.
// Every cell is written exactly once, with 0 folded where the reference never
// wrote, so padding rows get the reference's table[c, 0] and log1p(0). Rows
// past max_rows are never produced. Built without fast math, so log1pf keeps
// its accuracy.

#include "decode_passes.cuh"

namespace {

__global__ void transform_kernel(const uint8_t* __restrict__ buf,
                                 const int* __restrict__ delim_pos,
                                 const int* __restrict__ totals, const int* __restrict__ table,
                                 int max_rows, int n_fields, int hex_start, int vocab_range,
                                 int* __restrict__ label, float* __restrict__ dense,
                                 int* __restrict__ ids, uint8_t* __restrict__ valid) {
  const int n_dense = hex_start - 1;
  const int n_sparse = n_fields - hex_start;
  const int64_t cells = static_cast<int64_t>(max_rows) * n_fields;
  const int64_t n_delims = totals[0];
  const int n_newlines = totals[1];
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < cells;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(k / n_fields);
    const int col = static_cast<int>(k - static_cast<int64_t>(row) * n_fields);
    const uint32_t v = fold_field(buf, delim_pos, k, n_delims, col >= hex_start ? 16u : 10u);
    if (col == 0) {
      label[row] = static_cast<int>(v);
      valid[row] = row < n_newlines;
    } else if (col < hex_start) {
      dense[static_cast<int64_t>(row) * n_dense + (col - 1)] =
          log1pf(fmaxf(static_cast<float>(static_cast<int>(v)), 0.f));
    } else {
      const int c = col - hex_start;
      ids[static_cast<int64_t>(row) * n_sparse + c] =
          table[static_cast<int64_t>(c) * vocab_range + v % static_cast<uint32_t>(vocab_range)];
    }
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING
REPRO_EXPORT_DECODE_SCRATCH

// buf: uint8 [n] raw rows. scratch: int32 [decode_scratch_ints(n, max_rows *
// n_fields)]. table: int32 [n_fields - hex_start, vocab_range]. label: int32
// [max_rows]; dense: f32 [max_rows, hex_start - 1]; ids: int32 [max_rows,
// n_fields - hex_start]; valid: bool [max_rows]; all contiguous. n < 2^31,
// max_rows * n_fields < 2^31.
extern "C" int fused_decode_transform(const void* buf, int64_t n, int max_rows, int n_fields,
                                      int hex_start, int vocab_range, void* scratch,
                                      const void* table, void* label, void* dense, void* ids,
                                      void* valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(buf);
  const int64_t cells = static_cast<int64_t>(max_rows) * n_fields;
  const DecodeScratch sc = decode_scratch(scratch, n);
  run_decode_passes(bytes, n, cells, sc, s);
  if (cells > 0) {
    transform_kernel<<<repro::grid_for(cells, kDecodeThreads), kDecodeThreads, 0, s>>>(
        bytes, sc.delim_pos, sc.totals, static_cast<const int*>(table), max_rows, n_fields,
        hex_start, vocab_range, static_cast<int*>(label), static_cast<float*>(dense),
        static_cast<int*>(ids), static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
