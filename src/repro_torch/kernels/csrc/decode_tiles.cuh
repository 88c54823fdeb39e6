// The single-pass parallel UTF-8 decode over a chunk's byte tiles, shared by
// the kernels that read raw bytes as a [max_rows, n_fields] grid of cells:
// decode_utf8.cu writes each cell as the int32 value of its field,
// fused_decode_xform.cu as loop ②'s features of it, fused_decode_vocab.cu
// scatter-mins its sparse cells' positions into loop ①'s state. Each kernel
// brings its own writer of a cell (`Out` below); everything else is here.
//
// What bounds it on an H100: latency more than bytes. It must read the
// chunk once and write its outputs once: 3.7 MB for a 1 MiB chunk at 16384
// rows, 1.1 µs at 3.35 TB/s. The arithmetic is a multiply-add per digit.
// What costs is the chain: the ordinal of a field needs the delimiter count
// of every byte before it, and most of the grid (the cells past the chunk's
// last delimiter, 77% of a synth chunk's) can be written only once the
// whole chunk is counted.
//
// Design. The TPU kernels carried (m, a, neg, ndelim) from one tile to the
// next through their in-order grid. CUDA blocks run in no order, so this
// kernel runs a single-pass chained scan with decoupled look-back
// (lookback.cuh) over 8 KiB tiles, one block of 1024 threads a tile:
//   1. each block draws a tile id in launch order and stages the tile, and
//      the 256 bytes before it, in shared memory with 16-byte loads (the
//      chunk is read once); each thread classifies its 8 bytes four at a
//      time (__vcmpeq4), and the block compacts the tile-local position of
//      each delimiter into shared memory;
//   2. it publishes its counts, learns the delimiters before it and the last
//      one's byte position by look-back, and publishes its inclusive prefix
//      (a writer with kRowsKnown: a second warp does the same over the
//      newlines at once, so the tile knows the chunk's rows through its end,
//      and the newlines of the 1024 bytes after it, counted while it
//      stages, prove some rows more);
//   3. delimiter j of the tile ends field k = (delimiters before) + j; for
//      each k < max_rows * n_fields one thread folds that field's bytes from
//      shared memory, in base 16 iff its column is at or above hex_start,
//      and writes the cell through Out::write. A field that began more than
//      256 bytes before the tile (longer than that) reads its head from
//      device memory, byte by byte;
//   4. the grid holds kTrailing blocks beyond the tiles, whose ids come
//      after every tile's: they wait for the last tile's inclusive prefix
//      and write every cell at or past the chunk's delimiter count as the
//      writer's value of a zero (empty) field; the last tile writes
//      valid[r] = r < #newlines. A writer with kRowsKnown has no padding and
//      no valid: its trailing blocks run Out::finish instead, and every tile
//      calls Out::tile_done after its fold.
// No block ever waits on one that has not started: a tile waits only on
// tiles drawn before it, a trailing block only on tiles, which were drawn
// before every trailing block. So the kernel runs at any chunk size
// and beside any other launch (two streams, two decodes), and tiles never
// wait behind blocks that spin.
// Every output cell is written exactly once, so nothing is filled first;
// rows past max_rows are never written (the reference drops them); a
// truncated final row keeps the fields it completed.
//
// An Out derives from Cells and has
//   void write(int row, int col, int v, unsigned rows_known) const — the cell
//       of a field of value v; rows_known is 0, or with kRowsKnown the
//       chunk's newlines through the end of the tile that folded it;
//   void pad_rows(int64_t r, int64_t w, int64_t nw) const — every cell of the
//       rows [r, max_rows) as write(row, col, 0, 0) would give it, by worker
//       w of nw (fill_ints below);
// and with kRowsKnown = true, in place of pad_rows,
//   void tile_done(const ScanScratch&, int n_tiles, unsigned epoch) const —
//       called by every thread of a tile after its fold;
//   void finish(const ScanScratch&, int slice, int n_slices, int n_tiles,
//       unsigned epoch) const — by every thread of trailing block `slice`.
#pragma once

#include "lookback.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTileBytes = 8192;
constexpr int kPerThread = kTileBytes / kThreads;  // bytes a thread classifies
constexpr int kHalo = 256;                         // bytes before the tile, staged with it
constexpr int kTrailing = 32;                      // blocks that write the padding
static_assert(kPerThread % 4 == 0 && kTileBytes % 16 == 0, "tile layout");

int64_t tiles_for(int64_t n) { return (n + kTileBytes - 1) / kTileBytes; }

// The grid every Out shares: max_rows rows of n_fields fields (decimal below
// hex_start, hex from it on), and valid[max_rows].
struct Cells {
  static constexpr bool kRowsKnown = false;
  int max_rows, n_fields, hex_start;
  uint8_t* valid;
};

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

// A fill value that is 0 everywhere.
struct Zero {
  __device__ __forceinline__ int operator()(int64_t) const { return 0; }
};

// value(i) into p[i] for i in [begin, end), by worker w of nw, 16 bytes a
// store where aligned. (p may hold 32-bit floats: pass their bits.)
template <class Value>
__device__ void fill_ints(int* __restrict__ p, int64_t begin, int64_t end, int64_t w, int64_t nw,
                          const Value& value) {
  if (begin >= end) return;
  const int64_t skew = (16 - (reinterpret_cast<uintptr_t>(p + begin) & 15)) & 15;
  const int64_t head = min(end, begin + skew / 4);
  for (int64_t i = begin + w; i < head; i += nw) p[i] = value(i);
  const int64_t quads = (end - head) / 4;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (int64_t i = w; i < quads; i += nw) {
    const int64_t e = head + 4 * i;
    q[i] = make_int4(value(e), value(e + 1), value(e + 2), value(e + 3));
  }
  for (int64_t i = head + 4 * quads + w; i < end; i += nw) p[i] = value(i);
}

// The cells no delimiter of the chunk ends, [min(delimiters, cells),
// cells), as the writer's zero field, by block `slice` of `n_slices`, once
// the last tile has published the chunk's delimiters.
template <class Out>
__device__ void write_padding(const ScanScratch& s, int slice, int n_slices, int n_tiles,
                              unsigned epoch, const Out& o) {
  __shared__ unsigned total_delims;
  if (threadIdx.x == 0)
    total_delims = n_tiles > 0 ? wait_inclusive(s.chain, n_tiles - 1, epoch) : 0u;
  __syncthreads();
  const int64_t cells = static_cast<int64_t>(o.max_rows) * o.n_fields;
  const int64_t first = min(static_cast<int64_t>(total_delims), cells);
  const int64_t w = static_cast<int64_t>(slice) * kThreads + threadIdx.x;
  const int64_t nw = static_cast<int64_t>(n_slices) * kThreads;
  // the row that `first` cuts, from its column on; then whole rows
  const int row0 = static_cast<int>(first / o.n_fields);
  const int col0 = static_cast<int>(first - static_cast<int64_t>(row0) * o.n_fields);
  if (col0 > 0) {
    for (int64_t c = col0 + w; c < o.n_fields; c += nw)
      o.write(row0, static_cast<int>(c), 0, 0u);
  }
  o.pad_rows(row0 + (col0 > 0), w, nw);
}

// valid[r] = r < rows for every r < max_rows, by worker w of nw, 16 rows a
// store where aligned.
__device__ void write_valid(const Cells& o, unsigned rows, int w, int nw) {
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

template <class Out>
__global__ void __launch_bounds__(kThreads)
    decode_tiles_kernel(const uint8_t* __restrict__ buf, int64_t n, int n_tiles, ScanScratch s,
                        unsigned epoch, Out o) {
  __shared__ __align__(16) uint8_t staged[kHalo + kTileBytes];
  __shared__ uint16_t delim_at[kTileBytes];  // tile-local position of each delimiter
  __shared__ Before before;                  // what the tile needs of earlier tiles
  __shared__ unsigned chunk_rows;            // the last tile's: every tile's newlines
  __shared__ unsigned rows_before;           // kRowsKnown: the earlier tiles' newlines
  uint8_t* const tile_bytes = staged + kHalo;

  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 15) == 0;
  const unsigned t = draw_tile(s.counter);
  if (t >= static_cast<unsigned>(n_tiles)) {
    // 4. a trailing block: once the tiles are counted, the cells past the
    //    chunk's last delimiter (an empty chunk: all of them, and valid), or
    //    the writer's own finish
    const int slice = static_cast<int>(t) - n_tiles;
    if constexpr (Out::kRowsKnown) {
      o.finish(s, slice, kTrailing, n_tiles, epoch);
    } else {
      write_padding(s, slice, kTrailing, n_tiles, epoch, o);
      if (n_tiles == 0 && slice == 0) write_valid(o, 0, threadIdx.x, kThreads);
    }
    return;
  }
  const int64_t start = static_cast<int64_t>(t) * kTileBytes;

  // 1. stage the tile and the kHalo bytes before it: coalesced 16-byte loads
  //    (kRowsKnown: and count the newlines of the kThreads bytes after it)
  const int64_t ahead_at = start + kTileBytes + threadIdx.x;
  const bool ahead_newline = Out::kRowsKnown && ahead_at < n && __ldg(buf + ahead_at) == '\n';
  for (int off = 16 * threadIdx.x; off < kHalo + kTileBytes; off += 16 * kThreads) {
    const int64_t g = start - kHalo + off;
    *reinterpret_cast<uint4*>(staged + off) =
        g >= 0 ? load16(buf, n, g, aligned) : make_uint4(0, 0, 0, 0);
  }
  unsigned ahead = 0;  // kRowsKnown: newlines in the kThreads bytes after the tile
  if constexpr (Out::kRowsKnown) {
    ahead = static_cast<unsigned>(__syncthreads_count(ahead_newline));
  } else {
    __syncthreads();
  }

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
  //    ones, publish the inclusive prefix; with kRowsKnown, warp 1 does the
  //    same over the newline chain meanwhile
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      publish_last(s, t, tile_delims ? static_cast<int>(start) + delim_at[tile_delims - 1] : -1,
                   epoch);
      if constexpr (!Out::kRowsKnown) publish_newlines(s, t, 0u, tile_newlines, epoch);
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
    if constexpr (!Out::kRowsKnown) {
      if (t == static_cast<unsigned>(n_tiles) - 1) {
        const unsigned rows = sum_newlines(s, n_tiles, epoch);
        if (threadIdx.x == 0) chunk_rows = rows;
      }
    }
  } else if (Out::kRowsKnown && threadIdx.x < 64) {
    const bool lead = threadIdx.x == 32;
    if (lead) publish_newlines(s, t, t == 0 ? kInclusive : kAggregate, tile_newlines, epoch);
    const unsigned r = t > 0 ? exclusive_prefix(s.newlines, t, epoch) : 0u;
    if (lead) {
      if (t > 0) publish_newlines(s, t, kInclusive, r + tile_newlines, epoch);
      rows_before = r;
    }
  }
  __syncthreads();

  // 3. fold each field that a delimiter of this tile ends
  const int64_t cells = static_cast<int64_t>(o.max_rows) * o.n_fields;
  const int64_t k0 = before.delims;
  // kRowsKnown: rows the chunk surely has, from the newlines through the
  // tile's end and just after it
  const unsigned rows_known = Out::kRowsKnown ? rows_before + tile_newlines + ahead : 0u;
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
      o.write(row, col, f.value(), rows_known);
      row += step_rows;
      col += step_cols;
      if (col >= o.n_fields) {
        col -= o.n_fields;
        ++row;
      }
    }
  }

  if constexpr (Out::kRowsKnown) {
    o.tile_done(s, n_tiles, epoch);
  } else if (t == static_cast<unsigned>(n_tiles) - 1) {
    // the last tile writes valid from every tile's newlines
    write_valid(o, chunk_rows, threadIdx.x, kThreads);
  }
}

// The one launch over an n-byte chunk, as <library>_launch_config reports
// it: a block per tile and kTrailing blocks after them, static shared
// memory only.
inline repro::LaunchRecord decode_tiles_launch(int64_t n) {
  return {tiles_for(n) + kTrailing, 1, 1, kThreads, 0, 0, 0};
}

// One launch of decode_tiles_kernel over the n-byte chunk buf on stream.
// scratch: int32 words (lookback.cuh's int64 words, two int32 each), at
// least decode_scan_scratch_ints(n) (decode_utf8.cu), zeroed when made and
// used by no other launch meanwhile; epoch: this call's, 1 <= epoch < 2^30,
// unlike any earlier call's on this scratch since it was zeroed. n < 2^31,
// max_rows * n_fields < 2^31.
template <class Out>
int launch_decode_tiles(const void* buf, int64_t n, void* scratch, int epoch, const Out& o,
                        void* stream) {
  const int64_t tiles = tiles_for(n);
  decode_tiles_kernel<Out><<<static_cast<unsigned>(tiles + kTrailing), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), n, static_cast<int>(tiles), scan_scratch(scratch, tiles),
      static_cast<unsigned>(epoch), o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
