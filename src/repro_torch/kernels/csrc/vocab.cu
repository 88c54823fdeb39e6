// The per-op vocabulary kernels for Hopper: GenVocab's scatter-min of first
// positions (with the optional occurrence-count plane) and ApplyVocab's
// table gather, each one launch per chunk on modded values.
//
// Replaces src/repro/kernels/vocab/kernel.py::genvocab and ::apply_vocab.
//
// What bounds them on this card: latency, then memory traffic. genvocab
// reads 4 bytes of modded value per (row, column) element and a valid byte
// per row, and does an atomicMin (and an atomicAdd with counts) on a
// data-dependent slot of the state; apply_vocab reads 4 bytes, gathers one
// table entry and writes 4 bytes per element (3.5 MB for the crossed plan's
// [16384, 27] chunk: 1.08 µs at 3.35 TB/s), so the round trips a thread
// waits on decide its time. The 27 x 5000 int32 state or
// table (540 KB) stays in the 50 MB L2; the 27 x 1M one (108 MB) does not,
// so at 1M each atomic or gather is a scattered 32-byte sector access in
// device memory. A chunk's bytes take well under a microsecond, so the
// dependent round trips of one small launch, the atomics that hot slots
// serialize in L2, and the count of valid rows (which rows_seen needs
// whole) set genvocab's time.
//
// Design. The TPU kernels put one column per grid step: genvocab held the
// column's whole state row in VMEM and updated it with a serial
// read-modify-write loop over the chunk's rows (two equal values in one
// chunk must min-combine), and apply_vocab gathered from the VMEM-resident
// row; tables past VMEM went to XLA. Here min is order-independent, so
// atomicMin on the int32 state in device memory gives the reference's state
// bit for bit at any vocab_range, with no serial loop and no memory tier.
// Both kernels read the pipeline's row-major [rows, n_cols] layout
// directly; the TPU's transposed [n_cols, rows] layout is not needed.
//  - genvocab is all of GenVocab in one launch, with no work on the host or
//    in other launches: the warp-per-column kernel of genvocab_warp.cuh,
//    which fused_genvocab runs too. It computes each row's position from
//    rows_seen on the device (vocab.positions: a row is live only if it is
//    valid and below NEVER; valid need not be a prefix), merges equal slots
//    of 32 rows in the warp, reads each slot before its atomicMin, adds a
//    group's size to the count plane with one atomicAdd, and counts the
//    valid rows into the row tally, whose last block writes the advanced
//    rows_seen (vocab.advance_rows_seen) to a separate output. A value
//    outside [0, vocab_range) is skipped (the reference's scatter drops
//    it); the pipeline's modulus never makes one.
//  - apply_vocab gives each thread four consecutive elements: one 16-byte
//    load of their values (four 4-byte loads where the values do not line
//    up with the ids), all four table loads issued before any is used (read
//    through __ldg: the table is read-only for the call), and one 16-byte
//    store, aligned on ids; a head and a tail of up to three elements take
//    one element a thread. The column steps and wraps from a counter, with
//    no division per element. The grid is at most one resident wave of the
//    card (SMs x resident blocks, from the device's properties), with a
//    grid-stride loop over the rest. A value outside [0, vocab_range) gives
//    0.
// The state and counts are updated in place; the reference donates them.

#include <algorithm>

#include "genvocab_warp.cuh"

namespace {

constexpr int kApplyThreads = 128;

// table[c, v] for v in [0, vocab_range), else 0.
__device__ __forceinline__ int gather(const int* __restrict__ table, uint32_t v, int c,
                                      uint32_t vocab_range) {
  return v < vocab_range ? __ldg(table + static_cast<int64_t>(c) * vocab_range + v) : 0;
}

// ids[i] = table[i % n_cols, modded[i]] for i < total: the elements
// [0, head) and [head + 4 quads, total) (fewer than four each) one a
// thread, the quads between four a thread. ids + head is 16-byte aligned,
// and so is modded + head when vec_in.
__global__ void __launch_bounds__(kApplyThreads)
    apply_vocab_kernel(const int* __restrict__ table, const int* __restrict__ modded,
                       int* __restrict__ ids, int total, int head, int quads, bool vec_in,
                       int n_cols, uint32_t vocab_range) {
  const int stride = gridDim.x * kApplyThreads;
  const int g = blockIdx.x * kApplyThreads + threadIdx.x;
  // the head and the tail, fewer than four elements each
  const int tail = head + 4 * quads;
  if (g < head) ids[g] = gather(table, static_cast<uint32_t>(modded[g]), g % n_cols, vocab_range);
  if (g < total - tail) {
    const int j = tail + g;
    ids[j] = gather(table, static_cast<uint32_t>(modded[j]), j % n_cols, vocab_range);
  }
  if (g >= quads) return;
  // the column of this thread's first element, and its step to the next quad
  int col = (head + 4 * g) % n_cols;
  const int step = (4 * stride) % n_cols;
  for (int q = g; q < quads; q += stride) {
    const int e = head + 4 * q;
    uint32_t v[4];
    if (vec_in) {
      const int4 m = __ldg(reinterpret_cast<const int4*>(modded + e));
      v[0] = m.x, v[1] = m.y, v[2] = m.z, v[3] = m.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = static_cast<uint32_t>(__ldg(modded + e + k));
    }
    int out[4];  // all four gathers issued before any is used
    int c = col;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[k] = gather(table, v[k], c, vocab_range);
      c = c + 1 == n_cols ? 0 : c + 1;
    }
    *reinterpret_cast<int4*>(ids + e) = make_int4(out[0], out[1], out[2], out[3]);
    col += step;
    col = col >= n_cols ? col - n_cols : col;
  }
}

// Blocks of apply_vocab_kernel that the current device holds at once.
int apply_wave() {
  static int blocks[64] = {};
  return repro::resident_wave(reinterpret_cast<const void*>(apply_vocab_kernel), kApplyThreads,
                              blocks);
}

// Blocks of apply_vocab_kernel for `quads` quads: a block per 128 quads, at
// most one resident wave.
int apply_blocks(int quads) {
  const int want = std::max(1, (quads + kApplyThreads - 1) / kApplyThreads);
  return std::min(want, apply_wave());
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// Entry 0 genvocab, args (rows, n_cols): one launch of genvocab_warp_kernel.
// Entry 1 apply_vocab, args (rows, n_cols): one launch of apply_vocab_kernel
// with an aligned ids (no head).
REPRO_LAUNCH_CONFIG(vocab) {
  if (n_args != 2 || args[0] < 1) return -1;
  if (entry == 0) {
    return repro::put_launch(out, max, 0, genvocab_warp_launch(args[0], static_cast<int>(args[1])));
  }
  if (entry != 1 || args[0] * args[1] < 1 || args[0] * args[1] >= (int64_t{1} << 31)) return -1;
  const int quads = static_cast<int>(args[0] * args[1] / 4);
  return repro::put_launch(out, max, 0, {apply_blocks(quads), 1, 1, kApplyThreads, 0, 0,
                                         apply_wave()});
}

// first_pos: int32 [n_cols, vocab_range], updated in place. counts: int32
// [n_cols, vocab_range] updated in place, or null for no count plane.
// modded: int32 [rows, n_cols] in [0, vocab_range). valid: bool [rows].
// rows_seen_in/out: int32 []. tally: uint64 [1], 0 before the launch and
// after it; no other launch may use it meanwhile. 1 <= rows, 0 <= n_cols,
// rows * n_cols < 2^31.
extern "C" int genvocab(void* first_pos, void* counts, const void* modded, const void* valid,
                        const void* rows_seen_in, void* rows_seen_out, void* tally, int rows,
                        int n_cols, int vocab_range, void* stream) {
  auto* fp = static_cast<int*>(first_pos);
  auto* cn = static_cast<int*>(counts);
  auto* vals = static_cast<const int*>(modded);
  auto* ok = static_cast<const uint8_t*>(valid);
  auto* seen_in = static_cast<const int*>(rows_seen_in);
  auto* seen_out = static_cast<int*>(rows_seen_out);
  auto* t = static_cast<unsigned long long*>(tally);
  auto* st = static_cast<cudaStream_t>(stream);
  return cn != nullptr
             ? launch_genvocab_warp<RangeSlot, true>(fp, cn, vals, ok, seen_in, seen_out, t,
                                                     rows, n_cols, vocab_range, st)
             : launch_genvocab_warp<RangeSlot, false>(fp, nullptr, vals, ok, seen_in, seen_out,
                                                      t, rows, n_cols, vocab_range, st);
}

// table: int32 [n_cols, vocab_range]. modded: int32 [rows, n_cols] in
// [0, vocab_range), contiguous, at any 4-byte alignment. ids: int32 [rows,
// n_cols] out, contiguous. 1 <= rows * n_cols < 2^31.
extern "C" int apply_vocab(const void* table, const void* modded, void* ids, int rows,
                           int n_cols, int vocab_range, void* stream) {
  const int total = rows * n_cols;
  const auto* m = static_cast<const int*>(modded);
  auto* out = static_cast<int*>(ids);
  const int head = static_cast<int>(
      std::min<int64_t>(total, ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4));
  const int quads = (total - head) / 4;
  const bool vec_in = (reinterpret_cast<uintptr_t>(m + head) & 15) == 0;
  const int blocks = apply_blocks(quads);
  apply_vocab_kernel<<<blocks, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), m, out, total, head, quads, vec_in, n_cols,
      static_cast<uint32_t>(vocab_range));
  return static_cast<int>(cudaGetLastError());
}
