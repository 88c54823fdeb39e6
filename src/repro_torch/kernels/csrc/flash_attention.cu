// Blockwise online-softmax (flash) attention for Hopper: causal or not,
// GQA/MQA by head map, float32 or bf16 in, the input's type out.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention.
// out[b, h] = softmax(q[b, h] k[b, g]^T / sqrt(D)) v[b, g], with kv head
// g = h / (Hq / Hkv): the head map of the Pallas kernel's index map, read
// in place, so no repeated kv head is ever stored. Causal masking is
// aligned top-left as in that kernel (query row i sees keys <= i); the
// wrapper only lets causal calls through with Sq == Skv, where top-left and
// the reference's bottom-right alignment agree.
//
// What bounds it on this card: tensor-core operations. At the slice's
// shapes (gemma-2b: Hq 8, Hkv 1, D 256, S 4096 or 32768) a causal call does
// 4·B·Hq·S²·D/2 operations (275 G at B 4, S 4096) for (2·B·Hq + 2·B·Hkv)·
// S·D·2 bytes of bf16 in and out (151 MB): about 1800 operations per byte,
// far above the H100's 295 bf16 operations per byte of device memory.
//
// Design. The TPU kernel walked kv blocks along a sequential grid axis and
// carried (max, sum, accumulator) in VMEM scratch between grid steps. CUDA
// blocks run in no order, so here one block owns one tile of query rows of
// one (batch, head) and loops over the kv tiles itself; the kv tiles wholly
// above the diagonal are never visited. Per tile it keeps in shared memory
// the Q tile and K and V tiles, and in registers (bf16) or shared
// memory (float32) the running max, the running sum (one scalar per query
// row, where the TPU kernel padded them to 128 lanes) and the float32
// accumulator. The [Sq, Skv] scores and probabilities never reach device
// memory: each q element is read once, each k and v element once per
// q tile that needs it, and the output is written once.
//  - bf16: 4 warps, 16 query rows each (a 64-row tile); mma.sync
//    m16n8k16 with float32 accumulation for S = Q K^T and for O += P V.
//    K and V tiles are double-buffered: cp.async copies the next tile into
//    shared memory while the tensor cores work on this one.
//    The scores stay in the accumulator registers, are masked, scaled and
//    exponentiated there (in the log2 domain), and are rounded to bf16 as
//    the A operand of P V, the one rounding the float32 reference does not
//    have (held within 2e-2). The row statistics reduce over the 4 lanes
//    that share a row. Q, K and V tiles are stored row-major with rows
//    padded by 8 elements, so that the ldmatrix fragment loads of Q, K and
//    (transposing) V hit 32 distinct banks. The float32
//    accumulator of a 16 x 256 tile is 128 registers a thread, so at
//    D = 256 the kv tile is 32 keys (64 below).
//  - float32: plain FMAs on the CUDA cores, no TF32 and no fast math; a
//    32-row tile, 32 keys at a time, scores, accumulator and statistics in
//    shared memory. q is scaled by 1/sqrt(D) before the product, as in the
//    TPU kernel, and every exp is expf.
// q, k and v are read through their (batch, head, row) strides, so the
// strided head views of the attention layer need no copy; the last
// dimension must be contiguous, and rows 16-byte aligned. Masked logits are
// -1e30, not -inf, as in the reference: exp(-1e30 - m) is 0, where
// -inf - -inf would be NaN. Rows and keys past the ends of a ragged last
// tile are zero-filled and masked. The Q, K and V tiles of one block need
// more than 48 KB of shared memory, so each launch first raises the
// kernel's dynamic shared-memory limit.

#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;  // elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // contiguous [B, Hq, Sq, D]
  Strides sq, sk, sv;
  int hq, hkv, len_q, len_kv, head_dim, causal;
  float scale;
};

// --------------------------------------------------------------------- //
// bf16: tensor cores
// --------------------------------------------------------------------- //
constexpr int kWarps = 4;
constexpr int kThreadsBf16 = kWarps * 32;
constexpr int kRowsBf16 = kWarps * 16;  // query rows per block

template <int D>
struct Bf16Tile {
  static constexpr int kKeys = D >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int kStride = D + 8;             // padded rows of Q, K and V
  // Q, and two stages of K and V
  static constexpr int kSmemBytes = (kRowsBf16 + 4 * kKeys) * kStride * 2;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One 16-byte copy from device to shared memory that bypasses the
// registers; with valid false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most n of this thread's committed copy groups are pending.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i] (transposed for _trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* row) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* row) {
  const auto addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16) flash_bf16_kernel(Args p) {
  using T = Bf16Tile<D>;
  constexpr int BK = T::kKeys;
  constexpr int QS = T::kStride;
  constexpr int kVec = 8;        // bf16 per 16-byte vector
  constexpr int kRowVecs = D / kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [64][QS]
  bf16* kbuf = qs + kRowsBf16 * QS;           // [2][BK][QS]
  bf16* vbuf = kbuf + 2 * BK * QS;            // [2][BK][QS]

  const int n_tiles = (p.len_q + kRowsBf16 - 1) / kRowsBf16;
  // causal: the longest tiles (last rows) first
  const int iq = p.causal ? n_tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;
  const int q0 = iq * kRowsBf16;

  for (int i = threadIdx.x; i < kRowsBf16 * kRowVecs; i += kThreadsBf16) {
    const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
    const bool in = q0 + r < p.len_q;
    cp_async16(qs + r * QS + c, qg + (in ? (q0 + r) * p.sq.s + c : 0), in);
  }
  // K and V tile t into stage t % 2, zeros past the last key
  auto load_kv = [&](int t) {
    const int k0 = t * BK;
    bf16* ks = kbuf + (t & 1) * BK * QS;
    bf16* vs = vbuf + (t & 1) * BK * QS;
    for (int i = threadIdx.x; i < BK * kRowVecs; i += kThreadsBf16) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      const bool in = k0 + r < p.len_kv;
      cp_async16(ks + r * QS + c, kg + (in ? (k0 + r) * p.sk.s + c : 0), in);
      cp_async16(vs + r * QS + c, vg + (in ? (k0 + r) * p.sv.s + c : 0), in);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2;       // fragment row (and row + 8)
  const int gc = (lane & 3) * 2;  // fragment column pair
  const int row0 = q0 + warp * 16 + gr;
  const float scale_log2 = p.scale * kLog2e;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // causal: keys past the tile's last row are masked for every row in it
  const int kv_end = p.causal ? min(p.len_kv, q0 + kRowsBf16) : p.len_kv;
  const int n_kv = (kv_end + BK - 1) / BK;
  load_kv(0);  // one copy group with Q
  for (int t = 0; t < n_kv; ++t) {
    // the next tile's copies run while this one is computed
    if (t + 1 < n_kv) {
      load_kv(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    const bf16* ks = kbuf + (t & 1) * BK * QS;
    const bf16* vs = vbuf + (t & 1) * BK * QS;

    // S = Q K^T: this warp's 16 rows by BK keys. The A fragment of a
    // k-step is one ldmatrix (lane l: row l%16, column 8·(l/16)); the B
    // fragments of two key tiles are another (lane l: key 8·(l/16) + l%8,
    // column 8·(l/8 % 2)).
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* qrow = qs + (warp * 16 + (lane & 15)) * QS + (lane >> 4) * 8;
    const bf16* krow = ks + ((lane & 7) + (lane >> 4) * 8) * QS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qrow + kk);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, krow + j * 8 * QS + kk);
        mma_bf16(s[j], a, bb);
        mma_bf16(s[j + 1], a, bb + 2);
      }
    }

    // mask, then the online softmax of each of this thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + gc + e;
          float x = s[j][2 * i + e] * scale_log2;
          if (col >= p.len_kv || (p.causal && col > row)) x = kNegInf;
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f(s[j][2 * i + e] - mx);
          s[j][2 * i + e] = pe;
          sum += pe;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P from the score registers (the accumulator layout of two
    // neighbouring n-tiles is the A layout of one k-step); the B fragments
    // of two n-tiles per transposing ldmatrix: lane l addresses key row
    // kk*16 + l%16 at column (n + l/16)*8
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * QS + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vrow + n * 8);
        mma_bf16(o[n], a, bb);
        mma_bf16(o[n + 1], a, bb + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* out = static_cast<bf16*>(p.out) + static_cast<int64_t>(bh) * p.len_q * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.len_q) continue;
    bf16* orow = out + static_cast<int64_t>(row) * D + gc;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Bf16Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.len_q + kRowsBf16 - 1) / kRowsBf16);
  flash_bf16_kernel<D><<<grid, kThreadsBf16, smem, stream>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------------------- //
// float32: CUDA cores
// --------------------------------------------------------------------- //
constexpr int kThreadsF32 = 256;
constexpr int kRowsF32 = 32;  // query rows per block
constexpr int kKeysF32 = 32;  // keys per kv tile (one per lane)

__host__ __device__ constexpr int f32_stride(int d) { return d + 1; }  // odd: no bank conflicts

__host__ __device__ constexpr int f32_smem_floats(int d) {
  return kRowsF32 * f32_stride(d)     // Q (scaled)
         + kKeysF32 * f32_stride(d)   // K
         + kKeysF32 * d               // V
         + kRowsF32 * d               // accumulator
         + kRowsF32 * (kKeysF32 + 1)  // scores, then probabilities
         + 3 * kRowsF32;              // running max, running sum, rescale
}

__global__ void __launch_bounds__(kThreadsF32) flash_f32_kernel(Args p) {
  const int d = p.head_dim;
  const int ld = f32_stride(d);
  constexpr int SS = kKeysF32 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRowsF32 * ld;
  float* vs = ks + kKeysF32 * ld;
  float* os = vs + kKeysF32 * d;
  float* ss = os + kRowsF32 * d;
  float* ms = ss + kRowsF32 * SS;
  float* ls = ms + kRowsF32;
  float* as = ls + kRowsF32;

  const int n_tiles = (p.len_q + kRowsF32 - 1) / kRowsF32;
  const int iq = p.causal ? n_tiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;
  const int q0 = iq * kRowsF32;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRowsF32 * d; i += kThreadsF32) {
    const int r = i / d, c = i % d;
    qs[r * ld + c] = q0 + r < p.len_q ? qg[(q0 + r) * p.sq.s + c] * p.scale : 0.f;
    os[i] = 0.f;
  }
  if (tid < kRowsF32) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }

  const int tx = tid % 16, ty = tid / 16;  // scores: rows ty, ty+16; keys tx, tx+16
  const int kv_end = p.causal ? min(p.len_kv, q0 + kRowsF32) : p.len_kv;
  for (int k0 = 0; k0 < kv_end; k0 += kKeysF32) {
    __syncthreads();
    for (int i = tid; i < kKeysF32 * d; i += kThreadsF32) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < p.len_kv;
      ks[r * ld + c] = in ? kg[(k0 + r) * p.sk.s + c] : 0.f;
      vs[i] = in ? vg[(k0 + r) * p.sv.s + c] : 0.f;
    }
    __syncthreads();

    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = 0; c < d; ++c) {
      const float q_0 = qs[ty * ld + c], q_1 = qs[(ty + 16) * ld + c];
      const float k_0 = ks[tx * ld + c], k_1 = ks[(tx + 16) * ld + c];
      acc[0][0] = fmaf(q_0, k_0, acc[0][0]);
      acc[0][1] = fmaf(q_0, k_1, acc[0][1]);
      acc[1][0] = fmaf(q_1, k_0, acc[1][0]);
      acc[1][1] = fmaf(q_1, k_1, acc[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = ty + 16 * i, key = tx + 16 * e;
        const int row = q0 + r, col = k0 + key;
        const bool masked = col >= p.len_kv || (p.causal && col > row);
        ss[r * SS + key] = masked ? kNegInf : acc[i][e];
      }
    }
    __syncthreads();

    // one warp per row: max, probabilities, sum
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kRowsF32; r += kThreadsF32 / 32) {
      const float x = ss[r * SS + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pe = expf(x - m_new);
      ss[r * SS + lane] = pe;
      float sum = pe;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    for (int i = tid; i < kRowsF32 * d; i += kThreadsF32) {
      const int r = i / d, c = i % d;
      float pv = 0.f;
#pragma unroll 8
      for (int key = 0; key < kKeysF32; ++key) pv = fmaf(ss[r * SS + key], vs[key * d + c], pv);
      os[i] = os[i] * as[r] + pv;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out) + static_cast<int64_t>(bh) * p.len_q * d;
  for (int i = tid; i < kRowsF32 * d; i += kThreadsF32) {
    const int r = i / d;
    if (q0 + r < p.len_q) out[static_cast<int64_t>(q0) * d + i] = os[i] / ls[r];
  }
}

cudaError_t launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const int smem = f32_smem_floats(a.head_dim) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.hq, (a.len_q + kRowsF32 - 1) / kRowsF32);
  flash_f32_kernel<<<grid, kThreadsF32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXPORT_ERROR_STRING

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], each addressed through its
// (batch, head, row) strides in elements with a contiguous last dimension;
// out contiguous [B, Hq, Sq, D] of the same type. is_bf16: 0 for float32,
// 1 for bf16. The wrapper has checked: Hq % Hkv == 0; B·Hq < 2^31 and
// ceil(Sq / 64) < 65536; bf16: D in {16, 32, 64, 128, 256}, 16-byte aligned
// rows; float32: D <= 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                               int64_t v_ss, int batch, int hq, int hkv, int len_q, int len_kv,
                               int head_dim, int causal, int is_bf16, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.sq = {q_sb, q_sh, q_ss};
  a.sk = {k_sb, k_sh, k_ss};
  a.sv = {v_sb, v_sh, v_ss};
  a.hq = hq;
  a.hkv = hkv;
  a.len_q = len_q;
  a.len_kv = len_kv;
  a.head_dim = head_dim;
  a.causal = causal;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim)));
  const auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return static_cast<int>(launch_f32(a, batch, s));
  switch (head_dim) {
    case 16: return static_cast<int>(launch_bf16<16>(a, batch, s));
    case 32: return static_cast<int>(launch_bf16<32>(a, batch, s));
    case 64: return static_cast<int>(launch_bf16<64>(a, batch, s));
    case 128: return static_cast<int>(launch_bf16<128>(a, batch, s));
    case 256: return static_cast<int>(launch_bf16<256>(a, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
