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
// dwarfs everything else at large V.
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
// every run, with no floating-point atomics. One cudaMemsetAsync zeroes the
// dense gradient, then three kernels:
//  1. sort: one block per column sorts the packed keys (wrapped id << 32 |
//     b) of its B rows with a bitonic network, in shared memory when the
//     padded length fits (B <= 4096), else in place in the scratch. Equal
//     ids end up adjacent, in ascending b; a dropped id gets key kDrop,
//     which sorts after every row of the table and is never written.
//  2. tiles: one warp per 32 sorted positions of a column. Each run of
//     equal ids inside the tile is summed in ascending b by the whole warp
//     (lanes over D). A run that starts and ends in the tile is written to
//     its gradient row; a run's piece at the tile's head (it began in an
//     earlier tile) or tail (it goes on into the next) goes to a partial.
//  3. fixup: the warp of the tile where a longer run starts adds the head
//     partials of the following tiles to its tail partial, in tile order,
//     and writes the row.
// The association of every sum is fixed by the sorted data alone, so no
// schedule can change a bit. The count of launches is fixed too: one
// memset and three kernels per call, whatever the ids.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kTile = 32;  // sorted positions per warp in the tile kernel
constexpr unsigned kFull = 0xffffffffu;

constexpr int kDrop = INT_MAX;  // sort key of an id the gradient drops

__device__ __forceinline__ int wrap_id(int id, int vocab) { return id < 0 ? id + vocab : id; }

__device__ __forceinline__ int clamp_id(int id, int vocab) {
  const int i = wrap_id(id, vocab);
  return i < 0 ? 0 : (i >= vocab ? vocab - 1 : i);
}

__device__ __forceinline__ int grad_key(int id, int vocab) {
  const int i = wrap_id(id, vocab);
  return i < 0 || i >= vocab ? kDrop : i;
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

__device__ __forceinline__ int key_of(long long packed) { return static_cast<int>(packed >> 32); }
__device__ __forceinline__ int row_of(long long packed) {
  return static_cast<int>(packed & 0xffffffffll);
}

// One block per column: sorted[c, :padded] = the column's packed keys in
// ascending order, LLONG_MAX past the batch. padded is a power of two.
__global__ void sort_kernel(const int* __restrict__ ids, long long* __restrict__ sorted,
                            int batch, int n_cols, int vocab, int padded, int in_shared) {
  extern __shared__ long long smem[];
  const int c = blockIdx.x;
  long long* col = sorted + static_cast<int64_t>(c) * padded;
  long long* buf = in_shared ? smem : col;
  for (int i = threadIdx.x; i < padded; i += blockDim.x) {
    buf[i] = i < batch ? (static_cast<long long>(
                              grad_key(ids[static_cast<int64_t>(i) * n_cols + c], vocab))
                          << 32) | i
                       : LLONG_MAX;
  }
  __syncthreads();
  for (int k = 2; k <= padded; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < padded; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const long long a = buf[i], b = buf[l];
          if ((a > b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      __syncthreads();  // also orders the global-memory passes of one block
    }
  }
  if (in_shared) {
    for (int i = threadIdx.x; i < padded; i += blockDim.x) col[i] = buf[i];
  }
}

// One warp per tile of kTile sorted positions of one column. partials is
// [2, n_cols, n_tiles, dim]: plane 0 the sum of the tile's head piece when
// its run began in an earlier tile, plane 1 the sum of the tail piece when
// its run starts in this tile and goes on past it.
__global__ void tile_kernel(const float* __restrict__ grad_out,
                            const long long* __restrict__ sorted, float* __restrict__ grad,
                            float* __restrict__ partials, int batch, int n_cols, int vocab,
                            int dim, int padded, int n_tiles) {
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_cols) * n_tiles) return;  // whole warp
  const int c = static_cast<int>(warp / n_tiles);
  const int t = static_cast<int>(warp - static_cast<int64_t>(c) * n_tiles);
  const long long* col = sorted + static_cast<int64_t>(c) * padded;
  const int begin = t * kTile;
  const int n = min(kTile, batch - begin);
  const long long mine = lane < n ? col[begin + lane] : LLONG_MAX;
  const int key = key_of(mine);
  const int b = row_of(mine);
  // did the tile's first run begin in an earlier tile; does its last go on?
  const bool run_before = begin > 0 && key_of(col[begin - 1]) == key_of(col[begin]);
  const bool run_after =
      begin + n < batch && key_of(col[begin + n]) == key_of(col[begin + n - 1]);
  const int64_t part = (static_cast<int64_t>(c) * n_tiles + t) * dim;
  const int64_t plane = static_cast<int64_t>(n_cols) * n_tiles * dim;
  for (int d = lane; d - lane < dim; d += 32) {
    float acc = 0.f;
    int start = 0;  // first position of the current piece in the tile
    for (int j = 0; j < n; ++j) {
      const int bj = __shfl_sync(kFull, b, j);
      const int kj = __shfl_sync(kFull, key, j);
      const int knext = __shfl_sync(kFull, key, j + 1 < 32 ? j + 1 : j);
      if (d < dim) acc += grad_out[(static_cast<int64_t>(bj) * n_cols + c) * dim + d];
      if (j == n - 1 || knext != kj) {  // the piece [start, j] ends here
        const bool head = start == 0 && run_before;
        const bool tail = j == n - 1 && run_after;
        if (d < dim && kj != kDrop) {
          if (head) {
            partials[part + d] = acc;
          } else if (tail) {
            partials[plane + part + d] = acc;
          } else {
            grad[(static_cast<int64_t>(c) * vocab + kj) * dim + d] = acc;
          }
        }
        acc = 0.f;
        start = j + 1;
      }
    }
  }
}

// One warp per tile: if a run starts in this tile and goes on past it, sum
// its tail partial and the head partials of the tiles it runs through, in
// tile order, into its gradient row.
__global__ void fixup_kernel(const long long* __restrict__ sorted,
                             const float* __restrict__ partials, float* __restrict__ grad,
                             int batch, int n_cols, int vocab, int dim, int padded,
                             int n_tiles) {
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_cols) * n_tiles) return;
  const int c = static_cast<int>(warp / n_tiles);
  const int t = static_cast<int>(warp - static_cast<int64_t>(c) * n_tiles);
  const long long* col = sorted + static_cast<int64_t>(c) * padded;
  const int begin = t * kTile;
  const int end = min(begin + kTile, batch);  // one past the tile's last position
  const int key = key_of(col[end - 1]);
  if (key == kDrop || end == batch || key_of(col[end]) != key) return;  // ends here
  if (key_of(col[begin]) == key && begin > 0 && key_of(col[begin - 1]) == key) {
    return;  // the whole tile is inside a run that started earlier
  }
  // the run goes through tiles t+1 .. last, ending inside tile last
  int last = t + 1;
  while ((last + 1) * kTile < batch && key_of(col[(last + 1) * kTile]) == key) ++last;
  const int64_t plane = static_cast<int64_t>(n_cols) * n_tiles * dim;
  const float* head = partials + static_cast<int64_t>(c) * n_tiles * dim;
  for (int d = lane; d < dim; d += 32) {
    float acc = partials[plane + (static_cast<int64_t>(c) * n_tiles + t) * dim + d];
    for (int u = t + 1; u <= last; ++u) acc += head[static_cast<int64_t>(u) * dim + d];
    grad[(static_cast<int64_t>(c) * vocab + key) * dim + d] = acc;
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

// grad: f32 [n_cols, vocab, dim] out, every element written. grad_out: f32
// [batch, n_cols, dim]. ids: int32 [batch, n_cols]. sorted: int64 scratch
// [n_cols, padded], padded = the least power of two >= batch. partials: f32
// scratch [2, n_cols, ceil(batch / 32), dim]. 0 <= batch < 2^31,
// batch * n_cols < 2^31, n_cols * vocab < 2^31.
extern "C" int embedding_gather_backward(void* grad, const void* grad_out, const void* ids,
                                         void* sorted, void* partials, int batch, int n_cols,
                                         int vocab, int dim, int padded, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t grad_bytes = static_cast<size_t>(n_cols) * vocab * dim * sizeof(float);
  const cudaError_t err = cudaMemsetAsync(grad, 0, grad_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n_cols == 0 || dim == 0) return static_cast<int>(cudaGetLastError());
  const int in_shared = padded <= 4096;  // 32 KB of keys, under the 48 KB default
  const int sort_threads = padded < kSortThreads ? (padded < 32 ? 32 : padded) : kSortThreads;
  sort_kernel<<<n_cols, sort_threads, in_shared ? padded * sizeof(long long) : 0, s>>>(
      static_cast<const int*>(ids), static_cast<long long*>(sorted), batch, n_cols, vocab,
      padded, in_shared);
  const int n_tiles = (batch + kTile - 1) / kTile;
  const int64_t threads = static_cast<int64_t>(n_cols) * n_tiles * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  tile_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(grad_out), static_cast<const long long*>(sorted),
      static_cast<float*>(grad), static_cast<float*>(partials), batch, n_cols, vocab, dim,
      padded, n_tiles);
  fixup_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const long long*>(sorted), static_cast<const float*>(partials),
      static_cast<float*>(grad), batch, n_cols, vocab, dim, padded, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
