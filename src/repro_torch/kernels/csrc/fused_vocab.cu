// Loop ① for Hopper: uint32 Modulus -> GenVocab scatter-min of first
// positions (+ the optional occurrence-count plane), one launch per chunk.
//
// Replaces src/repro/kernels/fused_vocab/kernel.py::fused_genvocab
// (fused_genvocab here) and ::fused_genvocab_slabs (fused_genvocab_counts).
//
// What bounds it on this card: not bytes. A 1 MiB utf8 chunk holds about
// 3745 live rows of 26 hashes (390 KB), a binary chunk 16384 (1.7 MB), so
// the bytes take 0.2-0.6 µs, under one launch. What costs is latency: the
// dependent round trips of a launch this small; atomics on one address,
// which serialize in L2 (Piper's feed is Zipf(1.3) over 2^14 hashes a
// column, so about a quarter of a column's rows hit one slot: 4096 atomics
// on the binary chunk); at 1M a fresh slot is a scattered read-modify-write
// of device memory; and the count of valid rows, which needs the whole
// chunk before rows_seen can advance.
//
// Design of fused_genvocab. The TPU kernel kept the state in VMEM and
// carried it across an in-order grid, with slabs for ranges beyond VMEM.
// Here min is order-independent, so atomicMin on the int32 state in device
// memory gives the reference's state bit for bit at any range, in one
// pass. One block per 32 consecutive rows, one warp per column (up to 32
// warps; more columns take turns), lane l on row l, and no barrier, so
// each warp waits on two round trips to memory:
//  - it loads its rows' valid bytes and hashes together (a row's hash is
//    read whether or not the row is valid);
//  - equal slots of the 32 rows meet in the warp: __match_any_sync groups
//    them, and the group's lowest lane, which holds the group's smallest
//    position, alone acts;
//  - that lane reads the slot first (an L2 load, .cg: the kernel writes
//    the state, so never the read-only path) and issues atomicMin only if
//    the slot holds a larger position. This is exact because the state
//    only ever falls: a stale read is never below the current value, so a
//    skipped atomic could not have changed it. Every later chunk's
//    positions exceed every earlier one's, so after the first chunks
//    almost every hot slot is a load and no atomic.
// The valid rows are counted without a serial tail: warp 0 of each block
// adds its rows' count and one ticket into a 64-bit tally in device memory
// (count in the low word, tickets in the high) with one atomicAdd, whose
// result it reads only when the block is done. The block that drew the
// last ticket writes the advanced rows_seen (vocab.advance_rows_seen:
// uint32, saturating at NEVER) to a separate output, so no thread reads a
// count another has moved, and puts the tally back to 0 for the next
// launch. The wrapper keeps one tally per (device, stream): launches on one
// stream run in order, and launches on two streams never share one.
// Positions are vocab.positions (uint32 from rows_seen, NEVER for an
// invalid or saturated row; such a row adds nothing). The state is updated
// in place; the reference donates it.
//
// fused_genvocab_counts keeps one thread per element of the [rows, n_cols]
// matrix (an atomicMin and an atomicAdd each; merging duplicates would
// need the group's size added, a later redesign) and shares the tally.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // fused_genvocab_counts
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoSlot = 0xffffffffu;  // never a slot: vocab_range < 2^31

// One block's share of the valid-row count: thread 0 of each block adds its
// count and one ticket with one atomicAdd, which it issues as soon as the
// count is known and reads back only when the block is done (finish_rows).
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

// One block per 32 rows; lane l of every warp takes row row0 + l, and warp
// w the columns w, w + warps, ... No barrier: each warp reads its rows'
// valid bytes and hashes together (a row's hash is read whether or not the
// row is valid, so the two loads are in flight at once), merges equal slots,
// and its leaders read, then maybe update, the state. Warp 0 also adds the
// block's valid rows to the tally.
__global__ void __launch_bounds__(1024)
    genvocab_warp_kernel(int* __restrict__ first_pos, const int* __restrict__ sparse,
                         const uint8_t* __restrict__ valid, const int* __restrict__ rows_seen_in,
                         int* __restrict__ rows_seen_out, unsigned long long* __restrict__ tally,
                         int rows, int n_cols, int vocab_range) {
  const uint32_t seen = static_cast<uint32_t>(rows_seen_in[0]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool in = r < rows;
  const int* row = sparse + (in ? r : 0) * n_cols;
  const bool is_valid = in && valid[r] != 0;
  const unsigned valid_mask = __ballot_sync(kFull, is_valid);
  unsigned long long ticket = 0;
  if (warp == 0 && lane == 0) ticket = tally_rows(tally, __popc(valid_mask));
  // r < 2^31 and seen <= NEVER: no uint32 wrap
  const uint32_t p = seen + static_cast<uint32_t>(r);
  const bool live = is_valid && p < repro::kNever;
  for (int c = warp; c < n_cols; c += n_warps) {
    const uint32_t h = static_cast<uint32_t>(row[c]);
    const uint32_t v = live ? h % static_cast<uint32_t>(vocab_range) : kNoSlot;
    const unsigned peers = __match_any_sync(kFull, v);
    if (live && __ffs(peers) - 1 == lane) {  // the group's smallest position
      int* slot = first_pos + static_cast<int64_t>(c) * vocab_range + v;
      if (__ldcg(slot) > static_cast<int>(p)) atomicMin(slot, static_cast<int>(p));
    }
  }
  if (warp == 0 && lane == 0) finish_rows(tally, ticket, __popc(valid_mask), seen, rows_seen_out);
}

// One thread per element of the row-major [rows, n_cols] hashes, each an
// atomicMin and an atomicAdd; the valid rows counted through the tally.
__global__ void genvocab_counts_kernel(int* __restrict__ first_pos, int* __restrict__ counts,
                                       const int* __restrict__ sparse,
                                       const uint8_t* __restrict__ valid,
                                       const int* __restrict__ rows_seen_in,
                                       int* __restrict__ rows_seen_out,
                                       unsigned long long* __restrict__ tally, int rows,
                                       int n_cols, int vocab_range) {
  const uint32_t seen = static_cast<uint32_t>(rows_seen_in[0]);
  const int64_t total = static_cast<int64_t>(rows) * n_cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < total; i += stride) {
    const int64_t r = i / n_cols;
    if (!valid[r]) continue;
    const uint32_t p = seen + static_cast<uint32_t>(r);  // r < 2^31: no uint32 wrap
    if (p >= repro::kNever) continue;                    // saturated: dropped
    const int c = static_cast<int>(i - r * n_cols);
    const uint32_t v = static_cast<uint32_t>(sparse[i]) % static_cast<uint32_t>(vocab_range);
    const int64_t slot = static_cast<int64_t>(c) * vocab_range + v;
    atomicMin(first_pos + slot, static_cast<int>(p));
    atomicAdd(counts + slot, 1);
  }
  int n_valid = 0;
  for (int64_t r = first; r < rows; r += stride) n_valid += valid[r] != 0;
  int block_valid;
  repro::block_exclusive_sum(n_valid, &block_valid);
  if (threadIdx.x == 0) {
    finish_rows(tally, tally_rows(tally, block_valid), block_valid, seen, rows_seen_out);
  }
}

__global__ void empty() {}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// first_pos: int32 [n_cols, vocab_range], updated in place. sparse: int32
// [rows, n_cols] raw hashes. valid: bool [rows]. rows_seen_in/out: int32 [].
// tally: uint64 [1], 0 before the launch and after it; no other launch may
// use it meanwhile. 1 <= rows, 1 <= n_cols, rows * n_cols < 2^31.
extern "C" int fused_genvocab(void* first_pos, const void* sparse, const void* valid,
                              const void* rows_seen_in, void* rows_seen_out, void* tally,
                              int rows, int n_cols, int vocab_range, void* stream) {
  const int threads = 32 * (n_cols < 32 ? n_cols : 32);
  genvocab_warp_kernel<<<(rows + 31) / 32, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(first_pos), static_cast<const int*>(sparse),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(rows_seen_in),
      static_cast<int*>(rows_seen_out), static_cast<unsigned long long*>(tally), rows, n_cols,
      vocab_range);
  return static_cast<int>(cudaGetLastError());
}

// As fused_genvocab, and counts: int32 [n_cols, vocab_range], updated in place.
extern "C" int fused_genvocab_counts(void* first_pos, void* counts, const void* sparse,
                                     const void* valid, const void* rows_seen_in,
                                     void* rows_seen_out, void* tally, int rows, int n_cols,
                                     int vocab_range, void* stream) {
  genvocab_counts_kernel<<<repro::grid_for(static_cast<int64_t>(rows) * n_cols, kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(first_pos), static_cast<int*>(counts), static_cast<const int*>(sparse),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(rows_seen_in),
      static_cast<int*>(rows_seen_out), static_cast<unsigned long long*>(tally), rows, n_cols,
      vocab_range);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the stream: the launch floor the smoke measures
// beside the microsecond kernels.
extern "C" int empty_kernel(void* stream) {
  empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
