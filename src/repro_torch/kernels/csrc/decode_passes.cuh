// The delimiter passes of the parallel UTF-8 decode, which the bytes-in
// loop-① kernel (fused_decode_vocab.cu) still runs. decode_utf8.cu and the
// bytes-in loop-② kernel (fused_decode_xform.cu) run the single-pass scan
// of decode_tiles.cuh and lookback.cuh instead, which this one can take in
// turn.
//
// They turn a byte chunk into the byte position of every delimiter with its
// global ordinal, without an in-order grid:
//   1. count   — each 4 KiB tile counts its delimiters and newlines;
//   2. scan    — one block turns the tile counts into each tile's first
//                global delimiter ordinal, and totals them
//                (totals[0] = #delimiters, totals[1] = #newlines);
//   3. compact — each tile writes the byte position of every delimiter whose
//                ordinal k is below cap to delim_pos[k].
// The kernel then runs its own last pass: one thread per field ordinal k
// it needs, which folds the field's bytes with fold_field().
#pragma once

#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTile = kDecodeThreads * kBytesPerThread;  // 4096 bytes
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

// The value of field k (k < cap): its bytes, between delim_pos[k - 1] and
// delim_pos[k], folded in uint32 — v = v * base + digit, neg |= (byte ==
// '-'). The reference wraps in int32; uint32 gives the same bits without
// signed overflow. A field past the last delimiter (k >= n_delims) is 0.
// Digits are 0-9 and a-f in every field (a-f count 10-15 in a decimal field
// too); every other byte is inert.
__device__ __forceinline__ uint32_t fold_field(const uint8_t* __restrict__ buf,
                                               const int* __restrict__ delim_pos, int64_t k,
                                               int64_t n_delims, uint32_t base) {
  if (k >= n_delims) return 0u;
  const int begin = k == 0 ? 0 : delim_pos[k - 1] + 1;
  const int end = delim_pos[k];
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
  return neg ? 0u - v : v;
}

int64_t n_tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

// The int32 scratch of one call, carved from one buffer of
// decode_scratch_ints(n, cap) ints: three per-tile arrays, the two totals,
// and one position per delimiter ordinal below cap.
struct DecodeScratch {
  int* tile_delims;
  int* tile_newlines;
  int* tile_offsets;
  int* totals;
  int* delim_pos;
};

DecodeScratch decode_scratch(void* scratch, int64_t n) {
  const int64_t n_tiles = n_tiles_for(n);
  DecodeScratch s;
  s.tile_delims = static_cast<int*>(scratch);
  s.tile_newlines = s.tile_delims + n_tiles;
  s.tile_offsets = s.tile_newlines + n_tiles;
  s.totals = s.tile_offsets + n_tiles;
  s.delim_pos = s.totals + 2;
  return s;
}

// Passes 1-3 on stream st (a memset of the totals for an empty buffer).
void run_decode_passes(const uint8_t* bytes, int64_t n, int64_t cap, const DecodeScratch& s,
                       cudaStream_t st) {
  const int64_t n_tiles = n_tiles_for(n);
  if (n_tiles == 0) {
    cudaMemsetAsync(s.totals, 0, 2 * sizeof(int), st);
    return;
  }
  count_kernel<<<static_cast<unsigned>(n_tiles), kDecodeThreads, 0, st>>>(bytes, n, s.tile_delims,
                                                                          s.tile_newlines);
  scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(s.tile_delims, s.tile_newlines,
                                                static_cast<int>(n_tiles), s.tile_offsets,
                                                s.totals);
  compact_kernel<<<static_cast<unsigned>(n_tiles), kDecodeThreads, 0, st>>>(
      bytes, n, s.tile_offsets, s.delim_pos, cap);
}

}  // namespace

// Exported by every library that includes this header: the int32 scratch
// ints one call needs for an n-byte chunk and cap delimiter ordinals.
#define REPRO_EXPORT_DECODE_SCRATCH                                        \
  extern "C" int64_t decode_scratch_ints(int64_t n, int64_t cap) {         \
    return 3 * n_tiles_for(n) + 2 + cap;                                   \
  }
