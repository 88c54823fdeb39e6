// Parallel UTF-8 tabular decode for Hopper: Decode (+ FillMissing, Hex2Int)
// and the StoreData scatter, from a raw byte chunk to the [max_rows, fields]
// table, in one launch.
//
// Replaces src/repro/kernels/decode_utf8/kernel.py::decode_scan (the Pallas
// segmented affine scan) together with the scatter that
// src/repro/kernels/decode_utf8/ops.py::_decode applies to its output.
//
// What bounds it on this card, and its design: decode_tiles.cuh, the
// single-pass chained scan with decoupled look-back over 8 KiB tiles that
// fused_decode_xform.cu and fused_decode_vocab.cu run too. This file is its
// writer of a cell: the field's int32 value into label, dense or sparse,
// and 0 for a cell no delimiter of the chunk ends.

#include "decode_tiles.cuh"

namespace {

struct Out : Cells {
  int* label;
  int* dense;
  int* sparse;
  int n_dense, n_sparse;

  __device__ __forceinline__ void write(int row, int col, int v, unsigned) const {
    if (col == 0) {
      label[row] = v;
    } else if (col <= n_dense) {
      dense[static_cast<int64_t>(row) * n_dense + (col - 1)] = v;
    } else {
      sparse[static_cast<int64_t>(row) * n_sparse + (col - 1 - n_dense)] = v;
    }
  }

  __device__ void pad_rows(int64_t r, int64_t w, int64_t nw) const {
    fill_ints(label, r, max_rows, w, nw, Zero{});
    fill_ints(dense, r * n_dense, static_cast<int64_t>(max_rows) * n_dense, w, nw, Zero{});
    fill_ints(sparse, r * n_sparse, static_cast<int64_t>(max_rows) * n_sparse, w, nw, Zero{});
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// The int32 scratch words a call on an n-byte chunk needs (lookback.cuh's
// int64 words, two int32 each), for every kernel on decode_tiles.cuh
// (kernels/_scratch.py).
extern "C" int64_t decode_scan_scratch_ints(int64_t n) {
  return 2 * scan_scratch_words(tiles_for(n));
}

// buf: uint8 [n]. scratch and epoch: as launch_decode_tiles
// (decode_tiles.cuh) takes them. label: int32 [max_rows]; dense: int32
// [max_rows, n_dense]; sparse: int32 [max_rows, n_sparse]; valid: bool
// [max_rows]; all contiguous. n_fields == 1 + n_dense + n_sparse,
// hex_start == 1 + n_dense, n < 2^31, max_rows * n_fields < 2^31.
extern "C" int decode_utf8(const void* buf, int64_t n, int max_rows, int n_fields, int hex_start,
                           int n_dense, int n_sparse, void* scratch, int epoch, void* label,
                           void* dense, void* sparse, void* valid, void* stream) {
  const Out o{{max_rows, n_fields, hex_start, static_cast<uint8_t*>(valid)},
              static_cast<int*>(label), static_cast<int*>(dense), static_cast<int*>(sparse),
              n_dense, n_sparse};
  return launch_decode_tiles(buf, n, scratch, epoch, o, stream);
}

// Entry 0 decode_utf8, args (n): one launch of decode_tiles_kernel.
REPRO_LAUNCH_CONFIG(decode_utf8) {
  if (entry != 0 || n_args != 1 || args[0] < 0 || args[0] >= (int64_t{1} << 31)) return -1;
  return repro::put_launch(out, max, 0, decode_tiles_launch(args[0]));
}
