// Bytes-in loop ① for Hopper: Decode -> uint32 Modulus -> GenVocab
// scatter-min of first positions, from a raw UTF-8 chunk straight into the
// VocabState in one launch; the decoded field table is never stored.
//
// Replaces src/repro/kernels/fused_decode_vocab/kernel.py::
// fused_decode_genvocab, together with the short-row correction that
// src/repro/kernels/fused_decode_vocab/ops.py::fused_decode_update applies
// after it.
//
// What bounds it on this card: latency more than bytes, as for decode. It
// reads the chunk once and does one scatter-min on a data-dependent slot of
// the state for each sparse cell of a kept row. The 26 x 5000 int32 state
// (520 KB) stays in L2; the 26 x 1M state (104 MB) does not, so at 1M each
// slot is a scattered 32-byte sector in device memory.
//
// Design. The TPU kernel carried the decode scan across an in-order grid and
// kept the state in VMEM. Here the kernel is decode_utf8.cu's single-pass
// look-back scan over 8 KiB tiles (decode_tiles.cuh) with this file's writer
// of a cell, which asks for kRowsKnown: beside the delimiters, a second
// chain gives each tile the chunk's newlines through its end, N_t.
//  - The thread that folds sparse cell (row, c) of value v takes slot =
//    u32(v) % V and position p = u32(rows_seen) + row (no wrap: rows_seen
//    <= NEVER); p >= NEVER is dropped, which is what the reference's
//    saturation at NEVER (the min identity) amounts to. Label and dense
//    cells write nothing.
//  - A cell may be scattered only if row < n_cap = min(#newlines,
//    max_rows), and #newlines is known only once the last tile is counted.
//    row < N_t proves it (row < max_rows holds for every folded cell): the
//    thread scatters at once. Any other cell (the row that straddles each
//    tile boundary; in a chunk of rows longer than n_fields, the flat rows
//    that run ahead of the newlines; a truncated final row) is appended as
//    (row * n_sparse + c, slot) to a pending list, one atomicAdd a warp.
//    Every pending cell is a sparse cell of a row below max_rows, so the
//    list holds at most max_rows * n_sparse. The newlines in the 1024
//    bytes after a tile count towards N_t, so the row that straddles a
//    tile's end is proven there unless it is longer than that: the list of
//    a well-formed chunk stays empty.
//  - A scatter reads the slot first (an L2 load, .cg: the kernel writes the
//    state, so never the read-only path) and issues atomicMin only if the
//    slot holds a larger position; exact because the state only falls
//    (genvocab_warp.cuh says why).
//  - One 64-bit word counts the pending cells (low half) and the tiles
//    done (high half). The tile that finishes last learns the pending count
//    from its own done atomic, publishes it with the call's epoch and puts
//    the word back to 0 for the next launch. The first trailing block
//    writes, as soon as the last tile has published its prefixes, the
//    advanced rows_seen (vocab.advance_rows_seen, n_cap = min(#newlines,
//    max_rows)) to a separate output and the reference's short-row
//    correction (the cells no delimiter ends, [#delimiters, n_cap *
//    n_fields), hold zero fields, whose slot-0 minimum in column c is at
//    its first such row r_miss: one atomicMin a column when r_miss <
//    n_cap). Then every trailing block waits for the pending count and
//    scatters its share of the pending cells below n_cap.
// min is order-independent, so the state is bit-identical at any V, with no
// memory tier. first_pos is updated in place; the reference donates it.
// There is no count plane, as in the reference.

#include <cooperative_groups.h>

#include "decode_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

struct VocabOut : Cells {
  static constexpr bool kRowsKnown = true;
  int* first_pos;
  int vocab_range;
  const int* rows_seen_in;
  int* rows_seen_out;
  // tiles done in the high half, pending cells in the low; 0 between launches
  unsigned long long* counts;
  uint2* pending;  // (row * n_sparse + c, slot) of each pending cell

  __device__ __forceinline__ void scatter(int c, uint32_t slot, uint32_t p) const {
    int* cell = first_pos + static_cast<int64_t>(c) * vocab_range + slot;
    if (__ldcg(cell) > static_cast<int>(p)) atomicMin(cell, static_cast<int>(p));
  }

  __device__ __forceinline__ void write(int row, int col, int v, unsigned rows_known) const {
    if (col < hex_start) return;
    const uint32_t p = static_cast<uint32_t>(__ldg(rows_seen_in)) + static_cast<uint32_t>(row);
    if (p >= repro::kNever) return;
    const int c = col - hex_start;
    const uint32_t slot = static_cast<uint32_t>(v) % static_cast<uint32_t>(vocab_range);
    if (static_cast<unsigned>(row) < rows_known) {
      scatter(c, slot, p);
      return;
    }
    const cg::coalesced_group g = cg::coalesced_threads();
    unsigned at = 0;
    if (g.thread_rank() == 0)
      at = static_cast<unsigned>(atomicAdd(counts, static_cast<unsigned long long>(g.size())));
    at = g.shfl(at, 0) + g.thread_rank();
    pending[at] = make_uint2(static_cast<unsigned>(row * (n_fields - hex_start) + c), slot);
  }

  // The tile is done: one count, after a fence (as a grid-wide barrier
  // releases). The last tile to finish learns the pending count from the
  // same atomic, publishes it with the call's epoch and puts the counts
  // back to 0 (every tile is done with them).
  __device__ void tile_done(const ScanScratch& s, int n_tiles, unsigned epoch) const {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      const unsigned long long old = atomicAdd(counts, 1ull << 32);
      if (static_cast<unsigned>(old >> 32) == static_cast<unsigned>(n_tiles) - 1) {
        __threadfence();
        *counts = 0;
        st_relaxed(s.flag, word(epoch, 0, static_cast<unsigned>(old)));
      }
    }
  }

  // Trailing block `slice`: block 0 first writes what needs only the
  // chunk's totals (rows_seen, the short-row correction); then every block
  // scatters its share of the pending cells once the last tile has
  // published their count.
  __device__ void finish(const ScanScratch& s, int slice, int n_slices, int n_tiles,
                         unsigned epoch) const {
    __shared__ unsigned delims, rows, n_pending;
    if (threadIdx.x == 0) {
      delims = n_tiles > 0 ? wait_inclusive(s.chain, n_tiles - 1, epoch) : 0u;
      rows = n_tiles > 0 ? wait_inclusive(s.newlines, n_tiles - 1, epoch) : 0u;
    }
    __syncthreads();
    const uint32_t seen = static_cast<uint32_t>(__ldg(rows_seen_in));
    const unsigned n_cap = min(rows, static_cast<unsigned>(max_rows));
    const unsigned n_sparse = static_cast<unsigned>(n_fields - hex_start);
    if (slice == 0) {
      // the short-row correction: column c's first cell past the chunk's
      // last delimiter, at flat row r_miss (ops.py of the reference)
      for (unsigned c = threadIdx.x; c < n_sparse; c += kThreads) {
        const int64_t r_miss =
            (static_cast<int64_t>(delims) + n_fields - 1 - (hex_start + static_cast<int>(c))) /
            n_fields;
        if (r_miss < n_cap) {
          const uint32_t p = seen + static_cast<uint32_t>(r_miss);
          if (p < repro::kNever) scatter(static_cast<int>(c), 0u, p);
        }
      }
      if (threadIdx.x == 0) {
        // seen <= NEVER and n_cap < 2^31: the uint32 sum cannot wrap
        const uint32_t t = seen + n_cap;
        rows_seen_out[0] = static_cast<int>(t > repro::kNever ? repro::kNever : t);
      }
    }
    if (threadIdx.x == 0) {
      n_pending = n_tiles > 0 ? static_cast<unsigned>(wait_word(s.flag, epoch)) : 0u;
      __threadfence();
    }
    __syncthreads();
    for (unsigned i = static_cast<unsigned>(slice) * kThreads + threadIdx.x; i < n_pending;
         i += static_cast<unsigned>(n_slices) * kThreads) {
      const uint2 e = __ldcg(pending + i);
      const unsigned row = e.x / n_sparse;
      if (row < n_cap) scatter(static_cast<int>(e.x - row * n_sparse), e.y, seen + row);
    }
  }
};

}  // namespace

REPRO_EXPORT_ERROR_STRING

// buf: uint8 [n] raw rows. scratch and epoch: as launch_decode_tiles
// (decode_tiles.cuh) takes them. pending: int32 [4 + 2 * max_rows *
// (n_fields - hex_start)]: the 64-bit counts and a word of padding, then
// two words a cell; zeroed when made, left so by each launch, and used by
// no other launch meanwhile. first_pos: int32
// [n_fields - hex_start, vocab_range], updated in place. rows_seen_in/out:
// int32 []. 1 <= hex_start < n_fields, n < 2^31, max_rows * n_fields < 2^31.
extern "C" int fused_decode_genvocab(const void* buf, int64_t n, int max_rows, int n_fields,
                                     int hex_start, int vocab_range, void* scratch, int epoch,
                                     void* pending, void* first_pos, const void* rows_seen_in,
                                     void* rows_seen_out, void* stream) {
  auto* counts = static_cast<unsigned long long*>(pending);
  const VocabOut o{{max_rows, n_fields, hex_start, nullptr},
                   static_cast<int*>(first_pos), vocab_range,
                   static_cast<const int*>(rows_seen_in), static_cast<int*>(rows_seen_out),
                   counts, reinterpret_cast<uint2*>(counts + 2)};
  return launch_decode_tiles(buf, n, scratch, epoch, o, stream);
}

// Entry 0 fused_decode_genvocab, args (n): one launch of decode_tiles_kernel.
REPRO_LAUNCH_CONFIG(fused_decode_vocab) {
  if (entry != 0 || n_args != 1 || args[0] < 0 || args[0] >= (int64_t{1} << 31)) return -1;
  return repro::put_launch(out, max, 0, decode_tiles_launch(args[0]));
}
