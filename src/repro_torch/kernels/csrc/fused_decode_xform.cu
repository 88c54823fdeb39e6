// Bytes-in loop ② for Hopper: Decode -> uint32 Modulus -> ApplyVocab gather
// beside Neg2Zero -> Logarithm, from a raw UTF-8 chunk straight to the final
// features, in one launch; the decoded field table is never stored.
//
// Replaces src/repro/kernels/fused_decode_xform/kernel.py::
// fused_decode_transform.
//
// What bounds it on this card: latency more than bytes, as for decode. It
// reads the chunk once, the table entry of each sparse cell (from L2 for
// the 520 KB table at 5K, mostly from device memory for the 104 MB table at
// 1M), and writes its outputs once (label and ids int32, dense f32, valid
// bool): 3.7 MB for a 1 MiB chunk at 16384 rows, 1.1 µs at 3.35 TB/s.
//
// Design. The TPU kernel carried the decode scan across an in-order grid,
// accumulated a [max_rows + 1, n_fields] int32 table in VMEM (a trash row
// for dropped lanes, dense values as f32 bits) and seeded it at grid step 0
// with the transform of a zero field. None of that is carried over: the
// kernel is decode_utf8.cu's single-pass look-back scan over 8 KiB tiles
// (decode_tiles.cuh), with this file's writer of a cell in place of
// decode's. The thread that folds field (row, col) writes it straight to
// its output:
//   label[row]         the raw value;
//   dense[row, col-1]  log1pf(max((float)v, 0)) (dense_quad.cuh);
//   ids[row, c]        table[c, v % V], read from device memory at any V.
// The trailing blocks write every cell at or past the chunk's delimiter
// count as the transform of a zero field, as the reference's seeded table
// gives it: label 0, dense log1p(0) = 0 and ids table[c, 0] (not 0). The
// last tile writes valid[r] = r < #newlines. Every cell is written exactly
// once; rows past max_rows are never written.

#include "decode_tiles.cuh"
#include "dense_quad.cuh"

namespace {

// The id of a zero field in column c: table[c, 0], at each element i of
// the row-major [rows, n_sparse] ids.
struct PadId {
  const int* table;
  int vocab_range, n_sparse;

  __device__ __forceinline__ int operator()(int64_t i) const {
    // i < max_rows * n_fields < 2^31
    const uint32_t c = static_cast<uint32_t>(i) % static_cast<uint32_t>(n_sparse);
    return __ldg(table + static_cast<int64_t>(c) * vocab_range);
  }
};

struct XformOut : Cells {
  int* label;
  float* dense;
  int* ids;
  const int* table;
  int vocab_range;

  __device__ __forceinline__ void write(int row, int col, int v, unsigned) const {
    const int n_dense = hex_start - 1;
    if (col == 0) {
      label[row] = v;
    } else if (col < hex_start) {
      dense[static_cast<int64_t>(row) * n_dense + (col - 1)] =
          neg2zero_log1p(static_cast<float>(v));
    } else {
      const int c = col - hex_start;
      const uint32_t slot = static_cast<uint32_t>(v) % static_cast<uint32_t>(vocab_range);
      ids[static_cast<int64_t>(row) * (n_fields - hex_start) + c] =
          __ldg(table + static_cast<int64_t>(c) * vocab_range + slot);
    }
  }

  // log1p(max(0, 0)) is +0.0f, whose bits are 0.
  __device__ void pad_rows(int64_t r, int64_t w, int64_t nw) const {
    const int64_t n_dense = hex_start - 1, n_sparse = n_fields - hex_start;
    fill_ints(label, r, max_rows, w, nw, Zero{});
    fill_ints(reinterpret_cast<int*>(dense), r * n_dense, max_rows * n_dense, w, nw, Zero{});
    fill_ints(ids, r * n_sparse, max_rows * n_sparse, w, nw,
              PadId{table, vocab_range, static_cast<int>(n_sparse)});
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// buf: uint8 [n] raw rows. scratch and epoch: as launch_decode_tiles
// (decode_tiles.cuh) takes them. table: int32 [n_fields - hex_start,
// vocab_range]. label: int32 [max_rows]; dense: f32 [max_rows, hex_start -
// 1]; ids: int32 [max_rows, n_fields - hex_start]; valid: bool [max_rows];
// all contiguous. 1 <= hex_start < n_fields, n < 2^31, max_rows * n_fields
// < 2^31.
extern "C" int fused_decode_transform(const void* buf, int64_t n, int max_rows, int n_fields,
                                      int hex_start, int vocab_range, void* scratch, int epoch,
                                      const void* table, void* label, void* dense, void* ids,
                                      void* valid, void* stream) {
  const XformOut o{{max_rows, n_fields, hex_start, static_cast<uint8_t*>(valid)},
                   static_cast<int*>(label), static_cast<float*>(dense), static_cast<int*>(ids),
                   static_cast<const int*>(table), vocab_range};
  return launch_decode_tiles(buf, n, scratch, epoch, o, stream);
}

// Entry 0 fused_decode_transform, args (n): one launch of decode_tiles_kernel.
REPRO_LAUNCH_CONFIG(fused_decode_xform) {
  if (entry != 0 || n_args != 1 || args[0] < 0 || args[0] >= (int64_t{1} << 31)) return -1;
  return repro::put_launch(out, max, 0, decode_tiles_launch(args[0]));
}
