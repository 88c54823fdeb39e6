// GenVocab's warp-per-column scatter-min and its row tally, shared by
// fused_vocab.cu (fused_genvocab and fused_genvocab_counts: raw hashes, the
// modulus inside) and vocab.cu (genvocab: modded values), each with or
// without the count plane.
//
// Layout. One block per 32 consecutive rows, one warp per column (up to 32
// warps; more columns take turns), lane l on row l, and no barrier, so each
// warp waits on two round trips to memory:
//  - it loads its rows' valid bytes and values together (a row's value is
//    read whether or not the row is valid);
//  - equal slots of the 32 rows meet in the warp: __match_any_sync groups
//    them, and the group's lowest lane, which holds the group's smallest
//    position, alone acts;
//  - that lane reads the slot first (an L2 load, .cg: the kernel writes the
//    state, so never the read-only path) and issues atomicMin only if the
//    slot holds a larger position. This is exact because the state only
//    ever falls: a stale read is never below the current value, so a
//    skipped atomic could not have changed it. Every later chunk's
//    positions exceed every earlier one's, so after the first chunks almost
//    every hot slot is a load and no atomic;
//  - with the count plane, the same lane adds the group's size (__popc of
//    its lanes) with one atomicAdd: each live row adds one to each of its
//    columns' slots, so the sum is the reference's count, in one atomic per
//    distinct slot rather than one per element.
// Positions are vocab.positions: p = u32(rows_seen) + r, and a row is live
// only if it is valid and p < NEVER (an invalid or saturated row adds
// nothing). The state is updated in place; the reference donates it.
//
// The tally. The valid rows are counted without a serial tail: lane 0 of
// warp 0 of each block adds its block's valid rows and one ticket into a
// 64-bit tally in device memory (count in the low word, tickets in the
// high) with one atomicAdd, whose result it reads only when the block is
// done. The block that drew the last ticket writes the advanced rows_seen
// (vocab.advance_rows_seen: uint32, saturating at NEVER) to a separate
// output, so no thread reads a count another has moved, and puts the tally
// back to 0 for the next launch. The wrappers keep one tally per (device,
// stream) (kernels/_scratch.py::tally): launches on one stream run in
// order and each leaves the tally at 0, so every kernel of both libraries
// may share it, and launches on two streams never share one.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoSlot = 0xffffffffu;  // never a slot: vocab_range < 2^31

// One block's share of the valid-row count: one thread of each block adds
// its count and one ticket with one atomicAdd, which it issues as soon as
// the count is known and reads back only when the block is done
// (finish_rows).
__device__ __forceinline__ unsigned long long tally_rows(unsigned long long* tally, int n_valid) {
  return atomicAdd(tally, (1ull << 32) | static_cast<unsigned long long>(n_valid));
}

// The block that drew the last ticket writes rows_seen_out and clears tally.
__device__ __forceinline__ void finish_rows(unsigned long long* tally, unsigned long long old,
                                            int n_valid, uint32_t seen, int* rows_seen_out) {
  if ((old >> 32) == gridDim.x - 1u) {
    // seen <= NEVER and the count < 2^31: the uint32 sum cannot wrap
    const uint32_t t = seen + static_cast<uint32_t>(old) + static_cast<uint32_t>(n_valid);
    rows_seen_out[0] = static_cast<int>(t > repro::kNever ? repro::kNever : t);
    *tally = 0ull;
  }
}

// The slot of a raw hash: the uint32 Modulus of loop ①.
struct ModSlot {
  __device__ __forceinline__ static uint32_t of(uint32_t h, uint32_t vocab_range) {
    return h % vocab_range;
  }
};

// The slot of a modded value: itself, or none outside [0, vocab_range) (the
// reference's scatter drops it; the pipeline's modulus never makes one).
struct RangeSlot {
  __device__ __forceinline__ static uint32_t of(uint32_t v, uint32_t vocab_range) {
    return v < vocab_range ? v : kNoSlot;
  }
};

// vals: int32 [rows, n_cols]; counts: the count plane (kCounts) or unused.
// Launch with (rows + 31) / 32 blocks of genvocab_warp_threads(n_cols)
// threads; warp w takes the columns w, w + warps, ... Lane 0 of warp 0 also
// adds the block's valid rows to the tally.
template <class Slot, bool kCounts>
__global__ void __launch_bounds__(1024)
    genvocab_warp_kernel(int* __restrict__ first_pos, int* __restrict__ counts,
                         const int* __restrict__ vals, const uint8_t* __restrict__ valid,
                         const int* __restrict__ rows_seen_in, int* __restrict__ rows_seen_out,
                         unsigned long long* __restrict__ tally, int rows, int n_cols,
                         int vocab_range) {
  const uint32_t seen = static_cast<uint32_t>(rows_seen_in[0]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool in = r < rows;
  const int* row = vals + (in ? r : 0) * n_cols;
  const bool is_valid = in && valid[r] != 0;
  const unsigned valid_mask = __ballot_sync(kFull, is_valid);
  unsigned long long ticket = 0;
  if (warp == 0 && lane == 0) ticket = tally_rows(tally, __popc(valid_mask));
  // r < 2^31 and seen <= NEVER: no uint32 wrap
  const uint32_t p = seen + static_cast<uint32_t>(r);
  const bool live = is_valid && p < repro::kNever;
  for (int c = warp; c < n_cols; c += n_warps) {
    const uint32_t h = static_cast<uint32_t>(row[c]);
    const uint32_t v = live ? Slot::of(h, static_cast<uint32_t>(vocab_range)) : kNoSlot;
    const unsigned peers = __match_any_sync(kFull, v);
    if (v != kNoSlot && __ffs(peers) - 1 == lane) {  // the group's smallest position
      const int64_t slot = static_cast<int64_t>(c) * vocab_range + v;
      if (__ldcg(first_pos + slot) > static_cast<int>(p)) {
        atomicMin(first_pos + slot, static_cast<int>(p));
      }
      if (kCounts) atomicAdd(counts + slot, __popc(peers));
    }
  }
  if (warp == 0 && lane == 0) finish_rows(tally, ticket, __popc(valid_mask), seen, rows_seen_out);
}

// A warp a column, at most 32 warps a block.
inline int genvocab_warp_threads(int n_cols) { return 32 * std::min(std::max(n_cols, 1), 32); }

// The launch of genvocab_warp_kernel over rows >= 1 rows, as
// <library>_launch_config reports it.
inline repro::LaunchRecord genvocab_warp_launch(int64_t rows, int n_cols) {
  return {(rows + 31) / 32, 1, 1, genvocab_warp_threads(n_cols), 0, 0, 0};
}

// The launch of genvocab_warp_kernel over rows >= 1 rows on stream.
template <class Slot, bool kCounts>
int launch_genvocab_warp(int* first_pos, int* counts, const int* vals, const uint8_t* valid,
                         const int* rows_seen_in, int* rows_seen_out,
                         unsigned long long* tally, int rows, int n_cols, int vocab_range,
                         cudaStream_t stream) {
  genvocab_warp_kernel<Slot, kCounts><<<(rows + 31) / 32, genvocab_warp_threads(n_cols), 0,
                                        stream>>>(
      first_pos, counts, vals, valid, rows_seen_in, rows_seen_out, tally, rows, n_cols,
      vocab_range);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
