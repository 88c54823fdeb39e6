// Parallel UTF-8 tabular decode for Hopper: Decode (+ FillMissing, Hex2Int)
// and the StoreData scatter, from a raw byte chunk to the [max_rows, fields]
// table, in one launch.
//
// Replaces src/repro/kernels/decode_utf8/kernel.py::decode_scan (the Pallas
// segmented affine scan) together with the scatter that
// src/repro/kernels/decode_utf8/ops.py::_decode applies to its output.
//
// What bounds it on this card: latency more than bytes. It must read the
// chunk once and write the table (max_rows * n_fields int32) and valid
// once: 3.7 MB for a 1 MiB chunk at 16384 rows, 1.1 µs at 3.35 TB/s. The
// arithmetic is a multiply-add per digit. What costs is the chain: the
// ordinal of a field needs the delimiter count of every byte before it, and
// most of the table (the cells past the chunk's last delimiter, 77% of a
// synth chunk's) can be written only once the whole chunk is counted.
//
// Design. The TPU kernel carried (m, a, neg, ndelim) from one tile to the
// next through its in-order grid. CUDA blocks run in no order, so this
// kernel runs a single-pass chained scan with decoupled look-back
// (lookback.cuh) over 8 KiB tiles, one block of 1024 threads a tile:
//   1. each block draws a tile id in launch order and stages the tile, and
//      the 256 bytes before it, in shared memory with 16-byte loads (the
//      chunk is read once); each thread classifies its 8 bytes four at a
//      time (__vcmpeq4), and the block compacts the tile-local position of
//      each delimiter into shared memory;
//   2. it publishes its counts, learns the delimiters before it and the last
//      one's byte position by look-back, and publishes its inclusive prefix;
//   3. delimiter j of the tile ends field k = (delimiters before) + j; for
//      each k < max_rows * n_fields one thread folds that field's bytes from
//      shared memory, in base 16 iff its column is at or above hex_start,
//      and writes the cell. A field that began more than 256 bytes before
//      the tile (longer than that) reads its head from device memory;
//   4. the grid holds kTrailing blocks beyond the tiles, whose ids come
//      after every tile's: they wait for the last tile's inclusive prefix
//      and write 0 to every cell at or past the chunk's delimiter count; the
//      last tile writes valid[r] = r < #newlines.
// No block ever waits on one that has not started: a tile waits only on
// tiles drawn before it, a trailing block only on the last tile, which was
// drawn before every trailing block. So the kernel runs at any chunk size
// and beside any other launch (two streams, two decodes), and tiles never
// wait behind blocks that spin.
// Every output cell is written exactly once, so nothing is zero-filled first;
// rows past max_rows are never written (the reference drops them); a
// truncated final row keeps the fields it completed.

#include "lookback.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileBytes = 8192;
constexpr int kPerThread = kTileBytes / kThreads;  // bytes a thread classifies
constexpr int kHalo = 256;                         // bytes before the tile, staged with it
constexpr int kTrailing = 32;                      // blocks that write the zeros
static_assert(kPerThread % 4 == 0 && kTileBytes % 16 == 0, "tile layout");

int64_t tiles_for(int64_t n) { return (n + kTileBytes - 1) / kTileBytes; }

// 16 bytes of buf from g; bytes past n read as 0.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ buf, int64_t n, int64_t g,
                                        bool aligned) {
  if (aligned && g + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(buf + g));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (g + j < n) w[j >> 2] |= static_cast<uint32_t>(buf[g + j]) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 0 into p[begin, end), by worker w of nw, 16 bytes a store where aligned.
__device__ void zero_ints(int* __restrict__ p, int64_t begin, int64_t end, int64_t w,
                          int64_t nw) {
  if (begin >= end) return;
  const int64_t skew = (16 - (reinterpret_cast<uintptr_t>(p + begin) & 15)) & 15;
  const int64_t head = min(end, begin + skew / 4);
  for (int64_t i = begin + w; i < head; i += nw) p[i] = 0;
  const int64_t quads = (end - head) / 4;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (int64_t i = w; i < quads; i += nw) q[i] = make_int4(0, 0, 0, 0);
  for (int64_t i = head + 4 * quads + w; i < end; i += nw) p[i] = 0;
}

struct Out {
  int* label;
  int* dense;
  int* sparse;
  uint8_t* valid;
  int max_rows, n_fields, hex_start, n_dense, n_sparse;

  __device__ __forceinline__ void write(int row, int col, int v) const {
    if (col == 0) {
      label[row] = v;
    } else if (col <= n_dense) {
      dense[static_cast<int64_t>(row) * n_dense + (col - 1)] = v;
    } else {
      sparse[static_cast<int64_t>(row) * n_sparse + (col - 1 - n_dense)] = v;
    }
  }
};

// The cells no delimiter of the chunk ends, [min(delimiters, cells),
// cells), get 0, by block `slice` of `n_slices`, once the last tile has
// published the chunk's delimiters.
__device__ void write_zeros(const ScanScratch& s, int slice, int n_slices, int n_tiles,
                            unsigned epoch, const Out& o) {
  __shared__ unsigned total_delims;
  if (threadIdx.x == 0) total_delims = n_tiles > 0 ? wait_inclusive(s, n_tiles - 1, epoch) : 0u;
  __syncthreads();
  const int64_t cells = static_cast<int64_t>(o.max_rows) * o.n_fields;
  const int64_t first = min(static_cast<int64_t>(total_delims), cells);
  const int64_t w = static_cast<int64_t>(slice) * kThreads + threadIdx.x;
  const int64_t nw = static_cast<int64_t>(n_slices) * kThreads;
  // the row that `first` cuts, from its column on; then whole rows
  const int row0 = static_cast<int>(first / o.n_fields);
  const int col0 = static_cast<int>(first - static_cast<int64_t>(row0) * o.n_fields);
  if (col0 > 0) {
    for (int64_t c = col0 + w; c < o.n_fields; c += nw) o.write(row0, static_cast<int>(c), 0);
  }
  const int64_t r1 = row0 + (col0 > 0);
  zero_ints(o.label, r1, o.max_rows, w, nw);
  zero_ints(o.dense, r1 * o.n_dense, static_cast<int64_t>(o.max_rows) * o.n_dense, w, nw);
  zero_ints(o.sparse, r1 * o.n_sparse, static_cast<int64_t>(o.max_rows) * o.n_sparse, w, nw);
}

// valid[r] = r < rows for every r < max_rows, by worker w of nw, 16 rows a
// store where aligned.
__device__ void write_valid(const Out& o, unsigned rows, int w, int nw) {
  const int skew = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(o.valid) & 15)) & 15);
  const int head = min(o.max_rows, skew);
  for (int r = w; r < head; r += nw) o.valid[r] = static_cast<unsigned>(r) < rows;
  const int quads = (o.max_rows - head) / 16;
  for (int i = w; i < quads; i += nw) {
    uint32_t b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned r = head + 16 * i + 4 * j;  // the first of four rows
      b[j] = (r < rows) | (r + 1 < rows) << 8 | (r + 2 < rows) << 16 | (r + 3 < rows) << 24;
    }
    reinterpret_cast<uint4*>(o.valid + head)[i] = make_uint4(b[0], b[1], b[2], b[3]);
  }
  for (int r = head + 16 * quads + w; r < o.max_rows; r += nw)
    o.valid[r] = static_cast<unsigned>(r) < rows;
}

__global__ void __launch_bounds__(kThreads)
    decode_kernel(const uint8_t* __restrict__ buf, int64_t n, int n_tiles, ScanScratch s,
                  unsigned epoch, Out o) {
  __shared__ __align__(16) uint8_t staged[kHalo + kTileBytes];
  __shared__ uint16_t delim_at[kTileBytes];  // tile-local position of each delimiter
  __shared__ Before before;                  // what the tile needs of earlier tiles
  __shared__ unsigned chunk_rows;            // the last tile's: every tile's newlines
  uint8_t* const tile_bytes = staged + kHalo;

  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
  const unsigned t = draw_tile(s.counter);
  if (t >= static_cast<unsigned>(n_tiles)) {
    // 4. a trailing block: the cells past the chunk's last delimiter, once
    //    the last tile's inclusive prefix is there (an empty chunk: all of
    //    them, and valid)
    const int slice = static_cast<int>(t) - n_tiles;
    write_zeros(s, slice, kTrailing, n_tiles, epoch, o);
    if (n_tiles == 0 && slice == 0) write_valid(o, 0, threadIdx.x, kThreads);
    return;
  }
  const int64_t start = static_cast<int64_t>(t) * kTileBytes;

  // 1. stage the tile and the kHalo bytes before it: coalesced 16-byte loads
  for (int off = 16 * threadIdx.x; off < kHalo + kTileBytes; off += 16 * kThreads) {
    const int64_t g = start - kHalo + off;
    *reinterpret_cast<uint4*>(staged + off) =
        g >= 0 ? load16(buf, n, g, aligned) : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // classify this thread's kPerThread consecutive bytes, held in registers
  const int mine = threadIdx.x * kPerThread;
  uint32_t words[kPerThread / 4];
#pragma unroll
  for (int i = 0; i < kPerThread / 4; ++i)
    words[i] = reinterpret_cast<const uint32_t*>(tile_bytes + mine)[i];
  // four bytes at a time: 0xff in each byte lane that holds a delimiter
  uint32_t delims[kPerThread / 4];
  int nd = 0, nl = 0;
#pragma unroll
  for (int i = 0; i < kPerThread / 4; ++i) {
    const uint32_t newline = __vcmpeq4(words[i], 0x0a0a0a0au);
    delims[i] = newline | __vcmpeq4(words[i], 0x09090909u);
    nd += __popc(delims[i]) >> 3;
    nl += __popc(newline) >> 3;
  }
  int packed_total;  // delimiters in the low 16 bits, newlines in the high
  const int excl = repro::block_exclusive_sum(nd | nl << 16, &packed_total) & 0xffff;
  const int tile_delims = packed_total & 0xffff;
  const int tile_newlines = packed_total >> 16;
  int k = excl;
#pragma unroll
  for (int i = 0; i < kPerThread / 4; ++i) {
    for (uint32_t m = delims[i] & 0x80808080u; m != 0; m &= m - 1)
      delim_at[k++] = static_cast<uint16_t>(mine + 4 * i + ((__ffs(m) - 1) >> 3));
  }
  __syncthreads();

  // 2. publish the tile's counts, learn what the tile needs of the earlier
  //    ones, publish the inclusive prefix
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      publish_tile(s, t, tile_delims ? static_cast<int>(start) + delim_at[tile_delims - 1] : -1,
                   tile_newlines, epoch);
      publish_chain(s, t, t == 0 ? kInclusive : kAggregate, tile_delims, epoch);
    }
    if (t > 0) {
      const Before b = look_back(s, t, epoch);
      if (threadIdx.x == 0) {
        publish_chain(s, t, kInclusive, b.delims + tile_delims, epoch);
        before = b;
      }
    } else if (threadIdx.x == 0) {
      before = {0u, -1};
    }
    if (t == static_cast<unsigned>(n_tiles) - 1) {
      const unsigned rows = sum_newlines(s, n_tiles, epoch);
      if (threadIdx.x == 0) chunk_rows = rows;
    }
  }
  __syncthreads();

  // 3. fold each field that a delimiter of this tile ends
  const int64_t cells = static_cast<int64_t>(o.max_rows) * o.n_fields;
  const int64_t k0 = before.delims;
  const int n_fold = static_cast<int>(
      max(int64_t{0}, min(static_cast<int64_t>(tile_delims), cells - k0)));
  if (static_cast<int>(threadIdx.x) < n_fold) {
    // (row, col) of field k0 + threadIdx.x, then a step of kThreads fields
    const int k_first = static_cast<int>(k0) + threadIdx.x;
    int row = k_first / o.n_fields;
    int col = k_first - row * o.n_fields;
    const int step_rows = kThreads / o.n_fields;
    const int step_cols = kThreads - step_rows * o.n_fields;
    for (int j = threadIdx.x; j < n_fold; j += kThreads) {
      const uint32_t base = col >= o.hex_start ? 16u : 10u;
      const int end = delim_at[j];
      int begin;
      Fold f;
      if (j == 0) {
        // the field began after the last earlier delimiter: in the staged
        // halo, or further back in device memory (a field longer than it)
        const int64_t g = static_cast<int64_t>(before.last) + 1;
        for (int64_t i = g; i < start - kHalo; ++i) f.add(buf[i], base);
        begin = static_cast<int>(max(g - start, int64_t{-kHalo}));
      } else {
        begin = delim_at[j - 1] + 1;
      }
      for (int i = begin; i < end; ++i) f.add(tile_bytes[i], base);
      o.write(row, col, f.value());
      row += step_rows;
      col += step_cols;
      if (col >= o.n_fields) {
        col -= o.n_fields;
        ++row;
      }
    }
  }

  // the last tile writes valid from every tile's newlines
  if (t == static_cast<unsigned>(n_tiles) - 1) write_valid(o, chunk_rows, threadIdx.x, kThreads);
}

}  // namespace

REPRO_EXPORT_ERROR_STRING


// The int32 scratch words a call on an n-byte chunk needs (lookback.cuh's
// int64 words, two int32 each).
extern "C" int64_t decode_scan_scratch_ints(int64_t n) {
  return 2 * scan_scratch_words(tiles_for(n));
}

// buf: uint8 [n]. scratch: int32 [>= decode_scan_scratch_ints(n)], zeroed
// when made and used by no other launch meanwhile; epoch: this call's,
// 1 <= epoch < 2^30, unlike any earlier call's on this scratch since it was
// zeroed. label: int32 [max_rows]; dense: int32 [max_rows, n_dense];
// sparse: int32 [max_rows, n_sparse]; valid: bool [max_rows]; all
// contiguous. n_fields == 1 + n_dense + n_sparse, hex_start == 1 + n_dense,
// n < 2^31, max_rows * n_fields < 2^31.
extern "C" int decode_utf8(const void* buf, int64_t n, int max_rows, int n_fields, int hex_start,
                           int n_dense, int n_sparse, void* scratch, int epoch, void* label,
                           void* dense, void* sparse, void* valid, void* stream) {
  const int64_t tiles = tiles_for(n);
  const Out o{static_cast<int*>(label), static_cast<int*>(dense), static_cast<int*>(sparse),
              static_cast<uint8_t*>(valid), max_rows, n_fields, hex_start, n_dense, n_sparse};
  decode_kernel<<<static_cast<unsigned>(tiles + kTrailing), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n, static_cast<int>(tiles), scan_scratch(scratch, tiles),
      static_cast<unsigned>(epoch), o);
  return static_cast<int>(cudaGetLastError());
}
