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
// kernel compacts the delimiters instead of carrying a scan:
//   1. count   — each 4 KiB tile counts its delimiters and newlines;
//   2. scan    — one block turns the tile counts into each tile's first
//                global delimiter ordinal, and totals them;
//   3. compact — each tile writes the byte position of every delimiter whose
//                ordinal k is below max_rows * n_fields to delim_pos[k];
//   4. fold    — one thread per output cell k = row * n_fields + col folds the
//                bytes of field k, between delim_pos[k - 1] and delim_pos[k],
//                in uint32: v = v * base + digit, neg |= (byte == '-'), with
//                base 16 iff col >= hex_start. The reference wraps in int32;
//                uint32 gives the same bits without signed overflow.
// A field of any length, or one that straddles tiles, needs nothing special;
// rows past max_rows are never written (the reference drops them); cells past
// the last delimiter get 0, so a truncated final row keeps the fields it
// completed and padding rows are otherwise zero; valid[r] = r < #newlines.
// Every output cell is written exactly once, so nothing is zero-filled first.
// Digits are 0-9 and a-f in every field (a-f count 10-15 in a decimal field
// too); every other byte is inert.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTile = kThreads * kBytesPerThread;  // 4096 bytes
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool is_delim(uint8_t b) { return b == 0x09 || b == 0x0A; }

// This thread's 16 bytes of its tile; bytes past n read as 0 (inert).
__device__ __forceinline__ void load16(const uint8_t* buf, int64_t n, int64_t start,
                                       uint8_t out[kBytesPerThread]) {
  const uint8_t* p = buf + start;
  if (start + kBytesPerThread <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < kBytesPerThread; ++j) out[j] = (words[j >> 2] >> (8 * (j & 3))) & 0xff;
  } else {
#pragma unroll
    for (int j = 0; j < kBytesPerThread; ++j) out[j] = start + j < n ? p[j] : 0;
  }
}

__global__ void count_kernel(const uint8_t* __restrict__ buf, int64_t n,
                             int* __restrict__ tile_delims, int* __restrict__ tile_newlines) {
  uint8_t bytes[kBytesPerThread];
  load16(buf, n, static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kBytesPerThread, bytes);
  int nd = 0, nl = 0;
#pragma unroll
  for (int j = 0; j < kBytesPerThread; ++j) {
    nd += is_delim(bytes[j]);
    nl += bytes[j] == 0x0A;
  }
  int total_d, total_n;
  repro::block_exclusive_sum(nd, &total_d);
  repro::block_exclusive_sum(nl, &total_n);
  if (threadIdx.x == 0) {
    tile_delims[blockIdx.x] = total_d;
    tile_newlines[blockIdx.x] = total_n;
  }
}

__global__ void scan_tiles_kernel(const int* __restrict__ tile_delims,
                                  const int* __restrict__ tile_newlines, int n_tiles,
                                  int* __restrict__ tile_offsets, int* __restrict__ totals) {
  int carry_d = 0, carry_n = 0;
  for (int start = 0; start < n_tiles; start += blockDim.x) {
    const int t = start + threadIdx.x;
    const int d = t < n_tiles ? tile_delims[t] : 0;
    const int nl = t < n_tiles ? tile_newlines[t] : 0;
    int total_d, total_n;
    const int excl = repro::block_exclusive_sum(d, &total_d);
    repro::block_exclusive_sum(nl, &total_n);
    if (t < n_tiles) tile_offsets[t] = carry_d + excl;
    carry_d += total_d;
    carry_n += total_n;
  }
  if (threadIdx.x == 0) {
    totals[0] = carry_d;
    totals[1] = carry_n;
  }
}

__global__ void compact_kernel(const uint8_t* __restrict__ buf, int64_t n,
                               const int* __restrict__ tile_offsets, int* __restrict__ delim_pos,
                               int64_t cap) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kBytesPerThread;
  uint8_t bytes[kBytesPerThread];
  load16(buf, n, start, bytes);
  int nd = 0;
#pragma unroll
  for (int j = 0; j < kBytesPerThread; ++j) nd += is_delim(bytes[j]);
  int total;
  int64_t k = tile_offsets[blockIdx.x] + repro::block_exclusive_sum(nd, &total);
#pragma unroll
  for (int j = 0; j < kBytesPerThread; ++j) {
    if (is_delim(bytes[j])) {
      if (k < cap) delim_pos[k] = static_cast<int>(start + j);
      ++k;
    }
  }
}

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
    uint32_t value = 0;
    if (k < n_delims) {
      const int begin = k == 0 ? 0 : delim_pos[k - 1] + 1;
      const int end = delim_pos[k];
      const uint32_t base = col >= hex_start ? 16u : 10u;
      uint32_t v = 0;
      bool neg = false;
      for (int i = begin; i < end; ++i) {
        const uint8_t b = buf[i];
        if (b >= '0' && b <= '9') {
          v = v * base + (b - '0');
        } else if (b >= 'a' && b <= 'f') {
          v = v * base + (b - 'a' + 10);
        } else if (b == '-') {
          neg = true;
        }
      }
      value = neg ? 0u - v : v;
    }
    const int out = static_cast<int>(value);
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

int64_t n_tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

REPRO_EXPORT_ERROR_STRING

// int32 scratch the wrapper allocates for one call: three per-tile arrays,
// the two totals, and one position per output cell.
extern "C" int64_t decode_utf8_scratch_ints(int64_t n, int64_t cells) {
  return 3 * n_tiles_for(n) + 2 + cells;
}

// buf: uint8 [n]. label: int32 [max_rows]; dense: int32 [max_rows, n_dense];
// sparse: int32 [max_rows, n_sparse]; valid: bool [max_rows]; all contiguous.
// n_fields == 1 + n_dense + n_sparse, hex_start == 1 + n_dense, n < 2^31.
extern "C" int decode_utf8(const void* buf, int64_t n, int max_rows, int n_fields, int hex_start,
                           int n_dense, int n_sparse, void* scratch, void* label, void* dense,
                           void* sparse, void* valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = n_tiles_for(n);
  const int64_t cells = static_cast<int64_t>(max_rows) * n_fields;
  int* tile_delims = static_cast<int*>(scratch);
  int* tile_newlines = tile_delims + n_tiles;
  int* tile_offsets = tile_newlines + n_tiles;
  int* totals = tile_offsets + n_tiles;
  int* delim_pos = totals + 2;
  const uint8_t* bytes = static_cast<const uint8_t*>(buf);
  if (n_tiles > 0) {
    count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(bytes, n, tile_delims,
                                                                     tile_newlines);
    scan_tiles_kernel<<<1, kScanThreads, 0, s>>>(tile_delims, tile_newlines,
                                                 static_cast<int>(n_tiles), tile_offsets, totals);
    compact_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(bytes, n, tile_offsets,
                                                                       delim_pos, cells);
  } else {
    cudaMemsetAsync(totals, 0, 2 * sizeof(int), s);
  }
  if (cells > 0) {
    fold_kernel<<<repro::grid_for(cells, kThreads), kThreads, 0, s>>>(
        bytes, delim_pos, totals, max_rows, n_fields, hex_start, n_dense, n_sparse,
        static_cast<int*>(label), static_cast<int*>(dense), static_cast<int*>(sparse),
        static_cast<uint8_t*>(valid));
  }
  return static_cast<int>(cudaGetLastError());
}
