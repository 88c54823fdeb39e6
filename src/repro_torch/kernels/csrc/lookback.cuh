// The single-pass chained scan over the byte tiles of a chunk (Merrill and
// Garland's decoupled look-back), for the kernels that read raw UTF-8 bytes.
// decode_utf8.cu runs on it; fused_decode_vocab.cu and fused_decode_xform.cu
// still run the three passes of decode_passes.cuh and can take it.
//
// One launch covers the chunk. Each block draws a tile id from a counter in
// launch order, so a block only ever waits on tiles whose blocks have
// started, whatever the residency. A tile publishes its delimiter count (its
// aggregate) as soon as it has counted its bytes, then reads its
// predecessors' words, 128 at a time, summing aggregates until it meets an
// inclusive prefix, and publishes its own inclusive prefix.
//
// Every word that one block writes and another reads is 64 bits and carries
// the call's epoch beside its value (epoch << 34 | flag << 32 | value), so
// one relaxed load both finds that the word is there and reads it: no
// fences, one round trip a window. Per tile:
//   chain[t]    its delimiters (flag 1, the aggregate), then the delimiters
//               of it and every earlier tile (flag 2, the inclusive prefix);
//   last[t]     1 + its last delimiter's byte position (0: it has none);
//   newlines[t] its newlines.
// A tile's first field begins after the last delimiter of the nearest
// earlier tile that has one; the newlines add up to the chunk's rows.
//
// Scratch: int64 words zeroed once when made and kept per (device, stream)
// by the wrapper, with no fill between calls: the tile-id counter (put back
// to 0 by the block that draws the launch's last id), then chain, last and
// newlines, one word a tile each. Each call passes a new epoch (1 <= epoch
// < 2^30), so a word of an earlier call never passes for one of this call;
// the wrapper zeroes the words when the epoch wraps, and makes new zeroed
// words when a chunk needs more tiles.
#pragma once

#include "common.cuh"

namespace {

constexpr unsigned kAggregate = 1u, kInclusive = 2u;
constexpr int kWindow = 4;  // predecessors a lane reads at once: 128 a warp

struct ScanScratch {
  unsigned* counter;
  unsigned long long* chain;
  unsigned long long* last;
  unsigned long long* newlines;
};

inline int64_t scan_scratch_words(int64_t tiles) { return 1 + 3 * tiles; }

inline ScanScratch scan_scratch(void* words, int64_t tiles) {
  unsigned long long* w = static_cast<unsigned long long*>(words);
  return {reinterpret_cast<unsigned*>(w), w + 1, w + 1 + tiles, w + 1 + 2 * tiles};
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A word of this call: its epoch field is this call's.
__device__ __forceinline__ bool current(unsigned long long w, unsigned epoch) {
  return static_cast<unsigned>(w >> 34) == epoch;
}

__device__ __forceinline__ unsigned long long word(unsigned epoch, unsigned flag,
                                                   unsigned value) {
  return static_cast<unsigned long long>(epoch << 2 | flag) << 32 | value;
}

// The pause between two polls of words that were not there yet: it doubles
// up to 128 ns.
__device__ __forceinline__ void pause(unsigned& ns) {
  __nanosleep(ns);
  ns = ns < 128 ? 2 * ns : ns;
}

// The word at p once this call has written it.
__device__ __forceinline__ unsigned long long wait_word(const unsigned long long* p,
                                                        unsigned epoch) {
  unsigned long long w = ld_relaxed(p);
  for (unsigned ns = 16; !current(w, epoch); pause(ns)) w = ld_relaxed(p);
  return w;
}

// This block's tile id, in launch order; every thread of the block calls it.
__device__ __forceinline__ unsigned draw_tile(unsigned* counter) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(counter, 1u);
    // every other block of this launch has drawn: ready for the next launch
    if (t == gridDim.x - 1) atomicExch(counter, 0u);
    tile = t;
  }
  __syncthreads();
  return tile;
}

__device__ __forceinline__ void publish_chain(const ScanScratch& s, unsigned t, unsigned flag,
                                              unsigned delims, unsigned epoch) {
  st_relaxed(s.chain + t, word(epoch, flag, delims));
}

// Tile t's last delimiter (-1 for none) and its newlines, for later tiles.
__device__ __forceinline__ void publish_tile(const ScanScratch& s, unsigned t, int last,
                                             unsigned newlines, unsigned epoch) {
  st_relaxed(s.last + t, word(epoch, 0, static_cast<unsigned>(last + 1)));
  st_relaxed(s.newlines + t, word(epoch, 0, newlines));
}

// The newlines of tiles [0, n_tiles), by one full warp, once all are
// there: kWindow words a lane in flight at once.
__device__ unsigned sum_newlines(const ScanScratch& s, int n_tiles, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned sum = 0;
  for (int base = lane; base < n_tiles; base += 32 * kWindow) {
    unsigned long long w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const int t = base + 32 * i;
      w[i] = t < n_tiles ? ld_relaxed(s.newlines + t) : word(epoch, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const int t = base + 32 * i;
      for (unsigned ns = 16; !current(w[i], epoch); pause(ns)) w[i] = ld_relaxed(s.newlines + t);
      sum += static_cast<unsigned>(w[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// Tile t's inclusive prefix (its delimiters and every earlier tile's), by
// one thread, once it is published.
__device__ __forceinline__ unsigned wait_inclusive(const ScanScratch& s, unsigned t,
                                                   unsigned epoch) {
  unsigned long long w = ld_relaxed(s.chain + t);
  for (unsigned ns = 16; w != word(epoch, kInclusive, static_cast<unsigned>(w)); pause(ns))
    w = ld_relaxed(s.chain + t);
  return static_cast<unsigned>(w);
}

// What tile t needs of the tiles before it.
struct Before {
  unsigned delims;  // their delimiters
  int last;         // the byte position of their last delimiter, -1 if none
};

// Before for tile t >= 1, by one full warp. The delimiters: windows of
// 32 kWindow predecessors, nearest first, every load of a window in flight
// at once, until an inclusive prefix (or the chunk's start). The last
// delimiter is nearly always in tile t - 1; else lane 0 walks further back.
__device__ Before look_back(const ScanScratch& s, unsigned t, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  unsigned long long prev_last = lane == 0 ? ld_relaxed(s.last + (t - 1)) : 0ull;
  unsigned delims = 0;
  for (int base = static_cast<int>(t) - 1 - lane;; base -= 32 * kWindow) {
    // slot 32 i + lane is tile base - 32 i: slots in order of distance
    unsigned long long w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const int p = base - 32 * i;
      w[i] = p >= 0 ? ld_relaxed(s.chain + p) : word(epoch, kInclusive, 0);
    }
#pragma unroll
    for (int i = 0; i < kWindow; ++i) {
      const int p = base - 32 * i;
      for (unsigned ns = 16; !current(w[i], epoch); pause(ns)) w[i] = ld_relaxed(s.chain + p);
    }
    int stop = 32 * kWindow;  // the nearest inclusive prefix
#pragma unroll
    for (int i = kWindow - 1; i >= 0; --i) {
      const unsigned inc = __ballot_sync(0xffffffffu, ((w[i] >> 32) & 3u) == kInclusive);
      if (inc) stop = 32 * i + __ffs(inc) - 1;
    }
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < kWindow; ++i) sum += 32 * i + lane <= stop ? static_cast<unsigned>(w[i]) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    delims += sum;
    if (stop < 32 * kWindow) break;
  }
  int last = -1;
  if (lane == 0) {
    for (int p = static_cast<int>(t) - 1; p >= 0; --p) {
      const unsigned long long w =
          p == static_cast<int>(t) - 1 && current(prev_last, epoch) ? prev_last
                                                                    : wait_word(s.last + p, epoch);
      if (static_cast<unsigned>(w) != 0u) {
        last = static_cast<int>(static_cast<unsigned>(w)) - 1;
        break;
      }
    }
  }
  return {delims, __shfl_sync(0xffffffffu, last, 0)};
}

// The field fold of the decode: v = v * base + digit in uint32, neg |= '-'.
// Digits are 0-9 and a-f in every field (a-f count 10-15 in a decimal field
// too); every other byte is inert. The reference wraps in int32; uint32
// gives the same bits without signed overflow.
struct Fold {
  uint32_t v = 0;
  bool neg = false;

  __device__ __forceinline__ void add(uint8_t b, uint32_t base) {
    const uint32_t dec = static_cast<uint32_t>(b) - '0';
    const uint32_t hex = static_cast<uint32_t>(b) - 'a';
    const bool digit = dec < 10u || hex < 6u;
    v = digit ? v * base + (dec < 10u ? dec : hex + 10u) : v;
    neg |= b == '-';
  }

  __device__ __forceinline__ int value() const { return static_cast<int>(neg ? 0u - v : v); }
};

}  // namespace
