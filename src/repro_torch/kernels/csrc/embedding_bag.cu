// The DLRM per-column embedding gather for Hopper, and its gradient.
//
// embedding_gather replaces src/repro/kernels/embedding_bag/kernel.py::
// embedding_gather: out[b, c, :] = tables[c, ids[b, c], :].
// embedding_gather_backward replaces none: the JAX package's gradient is
// XLA's scatter-add through src/repro/kernels/embedding_bag/ref.py::
// embedding_gather (its training loss never reaches the Pallas kernel).
//
// Ids follow that ref and what jax.grad makes of it: a negative id wraps
// once (id + V). The forward then clamps to [0, V-1] (the Pallas kernel
// fills NaN for ids >= V instead); the gradient, XLA's scatter-add
// transpose of that gather, drops an id still outside [0, V) after the
// wrap. Piper's ordinals are always in range.
//
// What bounds them on this card: bytes. The forward reads 4 bytes of id
// per (b, c), one table row of D floats per distinct (c, id), and writes
// the [B, C, D] output once. The gradient reads the [B, C, D] output
// gradient and the ids once and writes the whole dense [C, V, D] gradient
// (6.66 GB at C = 26, V = 10^6, D = 64: about 2 ms at 3.35 TB/s), which
// dwarfs everything else at large V; at V = 5000 the bound is 18 µs, and
// what costs there is ordering the rows and reading them in that order.
//
// Design, forward. The TPU kernel held one column's table in VMEM per grid
// row and gathered a 512-row batch block from it; tables past 8 MiB went to
// XLA. Here the table stays in device memory at every V: one thread per
// 16-byte vector of the output in [B, C, D] order, so neighbouring threads
// write neighbouring addresses and read one table row together. It falls
// back to one float per thread when D is not a multiple of 4 or a pointer
// is not 16-byte aligned. The wrapper allocates the output.
//
// Design, gradient: deterministic, the same inputs give the same bits on
// every run, with no floating-point atomics. Two kernels:
//  1. sort and zero: blocks 0..C-1 each sort one column's wrapped ids with
//     a stable LSD radix sort, the batch row b as payload, while the other
//     blocks zero the dense gradient with 16-byte streaming stores. Each
//     block of that launch asks for more than half an SM's shared memory,
//     so no zeroing block shares an SM with a sort block (one that did ran
//     slowest and set the launch's end). Above ZERO_IN_KERNEL_MAX_BYTES
//     (ops.py) a cudaMemsetAsync zeroes the gradient first, faster than
//     the blocks would, and the launch only sorts. The sort runs over
//     ceil(log2(V+1)) key bits only, kRadixBits a pass (13 bits, two passes
//     at V = 5000; 20, three at 10^6): each pass a histogram per warp,
//     one block-wide scan, and a stable scatter ranked per warp by
//     __match_any_sync, in shared memory when the padded column fits
//     (kSharedSortRows), else in a scratch buffer in device memory.
//     Stability leaves equal ids in ascending b. A dropped id gets key V
//     and padding key 2^bits - 1, so both sort after every row of the
//     table. Each sort block then finds, for every kSegment-long segment
//     of its sorted column, where the run of its first key starts and
//     where the run of its last key ends, and clears the segment's ticket.
//  2. sum: one warp per segment of a column. The segment's rows of the
//     output gradient arrive in shared memory by bulk copies (the copy
//     engine's: no register holds them in flight), one per row issued by
//     the row's lane, and the warp (lanes over D) adds each run's rows in
//     ascending b. Rows are read in sorted order, so each is a scattered
//     256-byte read: that, not the arithmetic, sets this kernel's time. A
//     run inside the segment is written to its gradient row. A run that
//     crosses a segment boundary leaves a partial from each segment it
//     touches: the tail of the segment where it starts, the head of each
//     later one. Each of those warps then takes a ticket of the run (an
//     acquire-release atomicAdd); the one that draws the last adds the
//     partials in segment order, starting segment first, and writes the
//     row. A hot id (a quarter of a Piper column) is thus summed by ~32
//     warps at once and joined by one, never by one warp over a thousand
//     dependent loads.
// The association of every sum is fixed by the sorted data alone, so no
// schedule can change a bit. The count of launches is fixed too: two
// kernels (and a memset when the sort launch does not zero) per call.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;      // gather
constexpr int kSortThreads = 1024;  // sort and zero blocks
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRadixBits = 7;
constexpr int kBuckets = 1 << kRadixBits;
// Per-warp histograms, digit-major, each digit's row padded by one word so
// that the lanes of a warp, which touch one column (their warp's) in
// different rows, fall in different banks.
constexpr int kHistRow = kSortWarps + 1;
constexpr int kHist = kBuckets * kHistRow;
constexpr int kSharedSortRows = 8192;  // padded rows sorted in shared memory
constexpr int kSegment = 32;           // sorted positions a warp of the sum kernel takes
constexpr int kSumThreads = 128;
constexpr int kJoin = 8;  // partials a finishing warp loads at once
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBuckets * kSortWarps % kSortThreads == 0, "the scan gives each thread whole digits");

__device__ __forceinline__ int wrap_id(int id, int vocab) { return id < 0 ? id + vocab : id; }

__device__ __forceinline__ int clamp_id(int id, int vocab) {
  const int i = wrap_id(id, vocab);
  return i < 0 ? 0 : (i >= vocab ? vocab - 1 : i);
}

// The sort key of a gradient row: the wrapped id, or vocab if dropped.
__device__ __forceinline__ int grad_key(int id, int vocab) {
  const int i = wrap_id(id, vocab);
  return i < 0 || i >= vocab ? vocab : i;
}

// T is float4 (width = D / 4) or float (width = D).
template <typename T>
__global__ void gather_kernel(const T* __restrict__ tables, const int* __restrict__ ids,
                              T* __restrict__ out, int64_t n_rows, int n_cols, int vocab,
                              int width) {
  const int64_t total = n_rows * width;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = t / width;  // the (b, c) row of the output
    const int q = static_cast<int>(t - r * width);
    const int c = static_cast<int>(r % n_cols);
    const int64_t row = static_cast<int64_t>(c) * vocab + clamp_id(ids[r], vocab);
    out[t] = tables[row * width + q];
  }
}

// One stable pass of the block's LSD radix sort: (sk, sv) -> (dk, dv) by
// the digit of `bits` bits at `shift`. Warp w owns positions
// [w * per_warp, (w + 1) * per_warp) and walks them 32 at a time.
__device__ void radix_pass(const int* sk, const int* sv, int* dk, int* dv, int* hist, int padded,
                           int shift, int bits) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per_warp = padded / kSortWarps;
  const int begin = w * per_warp;
  const unsigned below = (1u << lane) - 1u;
  const unsigned mask = (1u << bits) - 1u;
  for (int i = t; i < kHist; i += kSortThreads) hist[i] = 0;
  __syncthreads();
  for (int j = begin + lane; j < begin + per_warp; j += 32) {
    const unsigned d = (static_cast<unsigned>(sk[j]) >> shift) & mask;
    const unsigned peers = __match_any_sync(kFull, d);
    if ((peers & below) == 0) hist[d * kHistRow + w] += __popc(peers);
    __syncwarp();  // the next round's leader may be another lane
  }
  __syncthreads();
  // exclusive scan of the histograms in (digit, warp) order; thread t
  // takes kPer consecutive (digit, warp) entries of one digit's row
  constexpr int kPer = kBuckets * kSortWarps / kSortThreads;
  int* mine = hist + (t * kPer / kSortWarps) * kHistRow + t * kPer % kSortWarps;
  int v[kPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    v[q] = mine[q];
    sum += v[q];
  }
  int total;
  int run = repro::block_exclusive_sum(sum, &total);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    mine[q] = run;
    run += v[q];
  }
  __syncthreads();
  for (int j = begin + lane; j < begin + per_warp; j += 32) {
    const int k = sk[j], b = sv[j];
    const unsigned d = (static_cast<unsigned>(k) >> shift) & mask;
    const unsigned peers = __match_any_sync(kFull, d);
    const int base = hist[d * kHistRow + w];
    const int to = base + __popc(peers & below);
    dk[to] = k;
    dv[to] = b;
    __syncwarp();
    if ((peers & below) == 0) hist[d * kHistRow + w] = base + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

// Blocks 0..n_cols-1 sort a column each into sorted[c] = (keys[padded],
// rows[padded]) and fill seg[c] and tickets[c]; blocks n_cols.. zero the
// n floats of grad.
__global__ void __launch_bounds__(kSortThreads)
    sort_zero_kernel(const int* __restrict__ ids, int* __restrict__ sorted,
                     int* __restrict__ sort_scratch, int2* __restrict__ seg,
                     int* __restrict__ tickets, float* __restrict__ grad, int64_t n, int batch,
                     int n_cols, int vocab, int padded, int key_bits, int n_seg) {
  const int t = threadIdx.x;
  if (blockIdx.x >= n_cols) {  // zero: 16-byte stores, then the last n % 4 floats
    const int64_t zb = blockIdx.x - n_cols, step = (gridDim.x - n_cols) * int64_t{kSortThreads};
    float4* grad4 = reinterpret_cast<float4*>(grad);
    const int64_t n4 = n / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t i = zb * kSortThreads + t; i < n4; i += 4 * step) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (i + q * step < n4) __stcs(grad4 + i + q * step, zero);
      }
    }
    if (zb == 0 && t < n - n4 * 4) __stcs(grad + n4 * 4 + t, 0.f);
    return;
  }
  extern __shared__ int smem[];
  int* hist = smem;
  const int c = blockIdx.x;
  // two (keys, rows) buffers: in shared memory when the column fits
  int* k0 = padded <= kSharedSortRows ? smem + kHist
                                      : sort_scratch + static_cast<int64_t>(c) * 4 * padded;
  int* r0 = k0 + padded;
  int* k1 = r0 + padded;
  int* r1 = k1 + padded;
  const int pad_key = static_cast<int>((1u << key_bits) - 1u);
  for (int i0 = 0; i0 < padded; i0 += 4 * kSortThreads) {  // the ids' loads in flight together
    int id[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kSortThreads + t;
      id[q] = i < batch ? ids[static_cast<int64_t>(i) * n_cols + c] : 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * kSortThreads + t;
      if (i < padded) {
        k0[i] = i < batch ? grad_key(id[q], vocab) : pad_key;
        r0[i] = i;
      }
    }
  }
  __syncthreads();
  const int passes = (key_bits + kRadixBits - 1) / kRadixBits;
  for (int p = 0; p < passes; ++p) {
    const bool odd = p & 1;
    radix_pass(odd ? k1 : k0, odd ? r1 : r0, odd ? k0 : k1, odd ? r0 : r1, hist, padded,
               p * kRadixBits, min(kRadixBits, key_bits - p * kRadixBits));
  }
  const int* keys = passes & 1 ? k1 : k0;
  const int* rows = passes & 1 ? r1 : r0;
  int* keys_out = sorted + static_cast<int64_t>(c) * 2 * padded;
  for (int i = t; i < batch; i += kSortThreads) {
    keys_out[i] = keys[i];
    keys_out[padded + i] = rows[i];
  }
  // per segment: the segment where the run of its first key starts, and
  // the one where the run of its last key ends
  for (int s = t; s < n_seg; s += kSortThreads) {
    const int first = s * kSegment;
    const int last = min(first + kSegment, batch) - 1;
    const int k_first = keys[first], k_last = keys[last];
    int lo = 0, hi = first;  // the first position whose key is k_first
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] < k_first) lo = mid + 1; else hi = mid;
    }
    int lo2 = last + 1, hi2 = batch;  // the first position past the run of k_last
    while (lo2 < hi2) {
      const int mid = (lo2 + hi2) >> 1;
      if (keys[mid] <= k_last) lo2 = mid + 1; else hi2 = mid;
    }
    seg[static_cast<int64_t>(c) * n_seg + s] = make_int2(lo / kSegment, (lo2 - 1) / kSegment);
    tickets[static_cast<int64_t>(c) * n_seg + s] = 0;
  }
}

// The ticket of a run: lane 0 adds one with acquire-release semantics at
// device scope, after the warp's partial stores (ordered before it by
// __syncwarp), and before the finishing warp's loads of the others'.
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// float2 (two floats a lane, D even and 8-byte aligned rows) or float.
template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float2 vzero<float2>() { return make_float2(0.f, 0.f); }
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
template <typename V> __device__ __forceinline__ V vload(const float* p) {
  return *reinterpret_cast<const V*>(p);
}
template <typename V> __device__ __forceinline__ V vload_l2(const float* p);
template <> __device__ __forceinline__ float vload_l2<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ float2 vload_l2<float2>(const float* p) {
  return __ldcg(reinterpret_cast<const float2*>(p));
}
template <typename V> __device__ __forceinline__ void vstore(float* p, V v) {
  *reinterpret_cast<V*>(p) = v;
}

// The warp that draws the last ticket of the run of `key` over segments
// s0..s1 of column c adds its partials in segment order and writes the row.
template <typename V>
__device__ void join_run(const float* __restrict__ head, const float* __restrict__ tail,
                         int* __restrict__ tickets, float* __restrict__ grad, int c, int s0,
                         int s1, int key, int n_seg, int vocab, int dim, int lane) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  __syncwarp();  // every lane's partial, before lane 0's release
  int ticket = 0;
  if (lane == 0) ticket = take_ticket(tickets + static_cast<int64_t>(c) * n_seg + s0);
  if (__shfl_sync(kFull, ticket, 0) != s1 - s0) return;  // the whole warp
  __syncwarp();  // lane 0's acquire, before every lane's loads
  const int64_t col = static_cast<int64_t>(c) * n_seg;
  for (int d = lane * kVec; d - lane * kVec < dim; d += 32 * kVec) {
    if (d >= dim) continue;
    V acc = vload_l2<V>(tail + (col + s0) * dim + d);
    for (int u = s0 + 1; u <= s1; u += kJoin) {
      V part[kJoin];
#pragma unroll
      for (int q = 0; q < kJoin; ++q) {
        if (u + q <= s1) part[q] = vload_l2<V>(head + (col + u + q) * dim + d);
      }
#pragma unroll
      for (int q = 0; q < kJoin; ++q) {
        if (u + q <= s1) vadd(acc, part[q]);
      }
    }
    vstore(grad + (static_cast<int64_t>(c) * vocab + key) * dim + d, acc);
  }
}

// One bulk copy of `bytes` from device memory into shared memory at `dst`,
// completing on the mbarrier at `bar` (the async proxy: no register holds
// the data in flight).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One warp per kSegment sorted positions of one column. partials is [2,
// n_cols, n_seg, dim]: plane 0 a segment's head piece (its run began in
// an earlier segment), plane 1 its tail piece (its run starts here and
// goes on past it). V = float2: the segment's rows arrive in shared memory
// by bulk copies, one per row, issued by the row's lane (dim % 4 == 0,
// 16-byte aligned rows); V = float: each lane loads its floats of every
// row from device memory.
template <typename V>
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const float* __restrict__ grad_out, const int* __restrict__ sorted,
               const int2* __restrict__ seg, int* __restrict__ tickets,
               float* __restrict__ partials, float* __restrict__ grad, int batch, int n_cols,
               int vocab, int dim, int padded, int n_seg) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  constexpr bool kBulk = kVec == 2;
  extern __shared__ __align__(16) float staged[];  // [kSumThreads / 32, kSegment, dim]
  __shared__ __align__(8) uint64_t bars[kSumThreads / 32];
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(kSumThreads) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_cols) * n_seg) return;  // the whole warp
  const int c = static_cast<int>(warp / n_seg);
  const int s = static_cast<int>(warp - static_cast<int64_t>(c) * n_seg);
  const int* keys = sorted + static_cast<int64_t>(c) * 2 * padded;
  const int begin = s * kSegment;
  const int n = min(kSegment, batch - begin);
  const int key = lane < n ? keys[begin + lane] : -1;
  const int b = lane < n ? keys[padded + begin + lane] : 0;
  const int2 info = seg[warp];
  float* buf = staged + (threadIdx.x >> 5) * kSegment * dim;
  const uint32_t bar = hopper::smem_u32(&bars[threadIdx.x >> 5]);
  if (kBulk) {
    if (lane == 0) {
      hopper::mbar_init(bar, 1);
      hopper::fence_barrier_init();
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive_expect_tx(bar, n * dim * 4);
    __syncwarp();
    if (lane < n) {
      bulk_copy(hopper::smem_u32(buf + lane * dim),
                grad_out + (static_cast<int64_t>(b) * n_cols + c) * dim, dim * 4, bar);
    }
  }
  const bool run_before = info.x < s, run_after = info.y > s;
  const int next = __shfl_down_sync(kFull, key, 1);
  const unsigned ends = __ballot_sync(kFull, lane < n && (lane == n - 1 || key != next));
  const bool one_piece = (ends & (ends - 1u)) == 0u;
  const int first_key = __shfl_sync(kFull, key, 0);
  const int last_key = __shfl_sync(kFull, key, n - 1);
  const int64_t plane = static_cast<int64_t>(n_cols) * n_seg * dim;
  float* head = partials;
  float* tail = partials + plane;
  const int64_t part = warp * dim;
  if (kBulk) hopper::mbar_wait(bar, 0);

  for (int d0 = 0; d0 < dim; d0 += 32 * kVec) {
    const int d = d0 + lane * kVec;
    const bool on = d < dim;
    V acc = vzero<V>();
    int start = 0;
#pragma unroll
    for (int j = 0; j < kSegment; ++j) {
      const int bj = __shfl_sync(kFull, b, j);
      if (j < n) {
        if (on) {
          vadd(acc, vload<V>(kBulk ? buf + j * dim + d
                                   : grad_out + (static_cast<int64_t>(bj) * n_cols + c) * dim + d));
        }
        if ((ends >> j) & 1u) {  // the piece [start, j] ends here
          const int kj = __shfl_sync(kFull, key, j);
          if (kj != vocab && on) {
            if (start == 0 && run_before) {
              vstore(head + part + d, acc);
            } else if (j == n - 1 && run_after) {
              vstore(tail + part + d, acc);
            } else {
              vstore(grad + (static_cast<int64_t>(c) * vocab + kj) * dim + d, acc);
            }
          }
          acc = vzero<V>();
          start = j + 1;
        }
      }
    }
  }
  // the run of the first key began earlier: it ends here, or goes on
  // through the whole segment to the segment info.y
  if (run_before && first_key != vocab) {
    join_run<V>(head, tail, tickets, grad, c, info.x, one_piece && run_after ? info.y : s,
                first_key, n_seg, vocab, dim, lane);
  }
  // the run of the last key starts here and goes on to segment info.y
  if (run_after && last_key != vocab && !(one_piece && run_before)) {
    join_run<V>(head, tail, tickets, grad, c, s, info.y, last_key, n_seg, vocab, dim, lane);
  }
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// tables: f32 [n_cols, vocab, dim]. ids: int32 [batch, n_cols]. out: f32
// [batch, n_cols, dim]. vec4: 1 when dim % 4 == 0 and tables and out are
// 16-byte aligned. 1 <= batch * n_cols < 2^31, n_cols * vocab < 2^31.
extern "C" int embedding_gather(const void* tables, const void* ids, void* out, int batch,
                                int n_cols, int vocab, int dim, int vec4, void* stream) {
  const int64_t n_rows = static_cast<int64_t>(batch) * n_cols;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    gather_kernel<float4><<<repro::grid_for(n_rows * (dim / 4), kThreads), kThreads, 0, s>>>(
        static_cast<const float4*>(tables), static_cast<const int*>(ids),
        static_cast<float4*>(out), n_rows, n_cols, vocab, dim / 4);
  } else {
    gather_kernel<float><<<repro::grid_for(n_rows * dim, kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(tables), static_cast<const int*>(ids),
        static_cast<float*>(out), n_rows, n_cols, vocab, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad: f32 [n_cols, vocab, dim] out, every element written; 16-byte
// aligned. grad_out: f32 [batch, n_cols, dim]. ids: int32 [batch, n_cols].
// Scratch (int32 unless named): sorted [n_cols, 2, padded]; sort_scratch
// [n_cols, 4, padded] when padded > kSharedSortRows (8192), else unused;
// seg int2 [n_cols, n_seg]; tickets [n_cols, n_seg]; partials f32 [2,
// n_cols, n_seg, dim]; n_seg = ceil(batch / 32), padded = batch rounded up
// to a multiple of 1024 (at least 1024). zero_in_kernel: 1 to zero grad in
// the sort launch, 0 for a cudaMemsetAsync before it. bulk: 1 when the
// rows may arrive by bulk copies: dim % 4 == 0, dim <= 256 (128 KB of
// staged rows a block) and grad_out 16-byte aligned. 0 <= batch, batch * n_cols < 2^31,
// n_cols * vocab < 2^31.
extern "C" int embedding_gather_backward(void* grad, const void* grad_out, const void* ids,
                                         void* sorted, void* sort_scratch, void* seg,
                                         void* tickets, void* partials, int batch, int n_cols,
                                         int vocab, int dim, int padded, int zero_in_kernel,
                                         int bulk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(n_cols) * vocab * dim;
  if (batch == 0 || n == 0 || !zero_in_kernel) {
    const cudaError_t err = cudaMemsetAsync(grad, 0, n * sizeof(float), s);
    if (err != cudaSuccess || batch == 0 || n == 0) return static_cast<int>(err);
  }
  const int n_seg = (batch + kSegment - 1) / kSegment;
  const int key_bits = 32 - __builtin_clz(static_cast<unsigned>(vocab));  // keys 0..vocab
  size_t smem =
      (kHist + (padded <= kSharedSortRows ? 4 * static_cast<size_t>(padded) : 0)) * sizeof(int);
  int zero_blocks = 0;
  if (zero_in_kernel) {
    // Each block asks for more than half of an SM's shared memory, so no
    // two share an SM: the zeroing blocks take the SMs the sort leaves,
    // and none is slowed by a sort block beside it.
    int device, sms, sm_smem;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t alone = static_cast<size_t>(sm_smem) / 2 + 1024;
    smem = smem > alone ? smem : alone;
    const int64_t want = (n / 4 + kSortThreads - 1) / kSortThreads;
    const int room = sms > n_cols + 1 ? sms - n_cols : 1;
    zero_blocks = static_cast<int>(want < room ? (want < 1 ? 1 : want) : room);
  }
  cudaError_t err = cudaFuncSetAttribute(
      sort_zero_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_zero_kernel<<<n_cols + zero_blocks, kSortThreads, smem, s>>>(
      static_cast<const int*>(ids), static_cast<int*>(sorted), static_cast<int*>(sort_scratch),
      static_cast<int2*>(seg), static_cast<int*>(tickets), static_cast<float*>(grad),
      zero_in_kernel ? n : 0, batch, n_cols, vocab, padded, key_bits, n_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = static_cast<int64_t>(n_cols) * n_seg * 32;
  const int blocks = static_cast<int>((threads + kSumThreads - 1) / kSumThreads);
  if (bulk) {
    const int staged = kSumThreads / 32 * kSegment * dim * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(sum_kernel<float2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               staged);
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_kernel<float2><<<blocks, kSumThreads, staged, s>>>(
        static_cast<const float*>(grad_out), static_cast<const int*>(sorted),
        static_cast<const int2*>(seg), static_cast<int*>(tickets), static_cast<float*>(partials),
        static_cast<float*>(grad), batch, n_cols, vocab, dim, padded, n_seg);
  } else {
    sum_kernel<float><<<blocks, kSumThreads, 0, s>>>(
        static_cast<const float*>(grad_out), static_cast<const int*>(sorted),
        static_cast<const int2*>(seg), static_cast<int*>(tickets), static_cast<float*>(partials),
        static_cast<float*>(grad), batch, n_cols, vocab, dim, padded, n_seg);
  }
  return static_cast<int>(cudaGetLastError());
}
