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
// What bounds it on this card: tensor-core operations. At the serving
// path's shapes (gemma-2b: Hq 8, Hkv 1, D 256, S 4096 or 32768) a causal
// call does 4·B·Hq·S²·D/2 operations (275 G at B 4, S 4096) for
// (2·B·Hq + 2·B·Hkv)·S·D·2 bytes of bf16 in and out (151 MB): about 1800
// operations per byte, far above the H100's 295 bf16 operations per byte
// of device memory. So the design feeds the tensor cores through the one
// instruction that reaches their full rate (wgmma), keeps them fed from
// shared memory that a separate warp fills ahead of them (TMA), and makes
// each K/V byte brought on chip serve 128 query rows.
//
// The TPU kernel walked kv blocks along a sequential grid axis and carried
// (max, sum, accumulator) in VMEM scratch between grid steps. CUDA blocks
// run in no order, so here one block owns one tile of query rows of one
// (batch, head) and loops over the kv tiles itself; the kv tiles wholly
// above the diagonal are never visited. The [Sq, Skv] scores and
// probabilities never reach device memory: each q element is read once,
// each k and v element once per query tile that needs it (from L2 for the
// query heads that share a kv head: they are neighbours in blockIdx.x), and
// the output is written once. Causal grids run the longest tiles first.
//
// Three routes, chosen by the wrapper from (dtype, D) alone (ops.route):
//  - wgmma (bf16, D 64, 128, 256): 128 query rows per block, three
//    warpgroups. Warpgroup 0 is the producer: it gives up registers
//    (setmaxnreg 24); its first warp walks the ring and one lane starts
//    every TMA load, Q once, then K and V tiles into rings of stages, each
//    stage guarded by a "full" mbarrier (the TMA transaction count) and an
//    "empty" one (one arrival from each consumer warpgroup), for K and for
//    V apiece. Warpgroups 1 and 2 are consumers of 64 query rows each
//    (setmaxnreg 240). Per kv tile a consumer computes S = Q K^T with
//    wgmma m64nBNk16 from shared memory (both operands K-major), releases
//    the K stage, scales, masks (only on the tiles that straddle the
//    diagonal or the end) and exponentiates S in registers in the log2
//    domain, rounds P to bf16 in registers (the accumulator layout of S is
//    the A-register layout of the next product), and computes O += P V
//    with wgmma m64nDk16, P from registers and V from shared memory
//    MN-major through the descriptor's transpose bit; then it releases the
//    V stage. Each step starts S of tile t together with P V of tile t - 1,
//    so that the softmax of tile t runs under that product; the
//    accumulator is rescaled after it retires. The two consumers share
//    each K/V tile and interleave on the tensor cores. The row statistics reduce
//    over the 4 lanes of a quad; the running sums stay per lane until the
//    end. Tiles arrive through 4-D tensor maps over (D, S, H, B) with the
//    tensor's own strides, in boxes of 64 columns stored with the 128-byte
//    swizzle that wgmma's descriptors read; rows past the end arrive as
//    zeros (TMA's out-of-bounds fill) and keys past len_kv are masked.
//    D 256: 80-key tiles, 2 stages each of K and V (Q 64 KiB + 160 KiB, as
//    much as a block may hold; 80 keys ran faster than 64 at gemma-2b's
//    shapes, and the Q K^T product reads fewer shared-memory bytes per
//    operation); D 128: 128-key tiles, 2 stages; D 64: 128-key tiles, 4
//    stages. The float32 accumulator of 64 x 256 is 128 registers a
//    consumer thread, the scores 40.
//  - mma_sync (bf16, D 16, 32): no model runs these at full width; 4 warps
//    of 16 query rows, mma.sync m16n8k16, ldmatrix fragment loads, K and V
//    double-buffered by cp.async into padded rows.
//  - f32: plain FMAs on the CUDA cores, no TF32 and no fast math; a
//    32-row tile, 32 keys at a time, scores, accumulator and statistics in
//    shared memory. q is scaled by 1/sqrt(D) before the product, as in the
//    TPU kernel, and every exp is expf.
// Both bf16 routes round P to bf16 as the A operand of P V, the one
// rounding the float32 reference does not have (held within 2e-2).
// q, k and v are read through their (batch, head, row) strides, so the
// strided head views of the attention layer need no copy; the last
// dimension must be contiguous, and rows 16-byte aligned. Masked logits are
// -1e30, not -inf, as in the reference: exp(-1e30 - m) is 0, where
// -inf - -inf would be NaN. Each launch first raises the kernel's dynamic
// shared-memory limit. A failed launch or a refused tensor map is returned
// to the caller, which raises: no route falls back to another.

#include <cmath>

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --------------------------------------------------------------------- //
// bf16, D 64 / 128 / 256: TMA, wgmma, warp specialisation
// --------------------------------------------------------------------- //
constexpr int kWgRows = 128;      // query rows per block: 64 per consumer warpgroup
constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kBoxCols = 64;      // bf16 columns in one 128-byte swizzled row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128·24 + 256·240 <= 65536

template <int D>
struct WgTile {
  static constexpr int kKeys = D == 256 ? 80 : 128;  // keys per K/V tile
  static constexpr int kKStages = D == 64 ? 4 : 2;   // depth of the K ring
  static constexpr int kVStages = D == 64 ? 4 : 2;   // depth of the V ring
  static constexpr int kColBlocks = D / kBoxCols;    // TMA boxes per tile
  static constexpr int kQBytes = kWgRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;   // one K or one V tile
  static constexpr int kQBlockBytes = kWgRows * 128;  // one 64-column block of Q
  static constexpr int kKvBlockBytes = kKeys * 128;
  static constexpr int kBarriers = 1 + 2 * (kKStages + kVStages);  // Q; full and empty
  // 1024 bytes of slack: the swizzled tiles start 1024-byte aligned
  static constexpr int kSmemBytes =
      1024 + kQBytes + (kKStages + kVStages) * kTileBytes + 8 * kBarriers;
};

struct WgArgs {
  bf16* out;  // contiguous [B, Hq, Sq, D]
  int hq, hkv, len_q, len_kv, causal;
  float scale_log2;
};

// Scale, mask and exponentiate this thread's scores of one kv tile (rows
// row0 and row0 + 8 in the accumulator layout, key columns col0 + 8j +
// {0, 1}) in the log2 domain; update the running max m and the lane's
// share of the running sum l, and return in alpha the factor by which the
// accumulator's two rows must be rescaled.
template <int BN, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row0, int col0, int len_kv,
                                             bool causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float mx = m[i];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * i + e] * scale_log2;
        if (kMask) {
          const int col = col0 + 8 * j + e;
          if (col >= len_kv || (causal && col > row)) x = kNegInf;
        }
        s[4 * j + 2 * i + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = exp2f(m[i] - mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f(s[4 * j + 2 * i + e] - mx);
        s[4 * j + 2 * i + e] = pe;
        sum += pe;
      }
    }
    l[i] = l[i] * alpha[i] + sum;  // alpha is the quad's: the lanes' sums add up at the end
    m[i] = mx;
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const WgArgs p) {
  using T = WgTile<D>;
  using namespace hopper;
  constexpr int BN = T::kKeys;
  constexpr int SK = T::kKStages, SV = T::kVStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + T::kQBytes;          // [SK] K tiles
  const uint32_t v_s = k_s + SK * T::kTileBytes;  // [SV] V tiles
  const uint32_t bars = v_s + SV * T::kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + SK + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + 2 * SK + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 2 * SK + SV + st); };

  const int n_qtiles = (p.len_q + kWgRows - 1) / kWgRows;
  // causal: the longest tiles (last rows) first
  const int iq = p.causal ? n_qtiles - 1 - static_cast<int>(blockIdx.y) : blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = iq * kWgRows;
  // causal: keys past the tile's last row are masked for every row in it
  const int kv_end = p.causal ? min(p.len_kv, q0 + kWgRows) : p.len_kv;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < SK; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), 2);  // one arrival from each consumer warpgroup
    }
    for (int st = 0; st < SV; ++st) {
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: warp 0 walks the ring, lane 0 starts the loads -----
    regs_release<kProducerRegs>();
    if (threadIdx.x < 32) {
      const bool elected = threadIdx.x == 0;
      if (elected) {
        mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kColBlocks; ++c)
          tma_load_4d(q_s + c * T::kQBlockBytes, &tq, q_full, c * kBoxCols, q0, h, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int sk = t % SK, sv = t % SV;
        const uint32_t ks = k_s + sk * T::kTileBytes, vs = v_s + sv * T::kTileBytes;
        // both consumers are done with the tile that held the stage
        if (t >= SK) mbar_wait(k_empty(sk), ((t / SK) & 1) ^ 1);
        if (elected) {
          mbar_arrive_expect_tx(k_full(sk), T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kColBlocks; ++c)
            tma_load_4d(ks + c * T::kKvBlockBytes, &tk, k_full(sk), c * kBoxCols, t * BN, hk, b);
        }
        if (t >= SV) mbar_wait(v_empty(sv), ((t / SV) & 1) ^ 1);
        if (elected) {
          mbar_arrive_expect_tx(v_full(sv), T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kColBlocks; ++c)
            tma_load_4d(vs + c * T::kKvBlockBytes, &tv, v_full(sv), c * kBoxCols, t * BN, hk, b);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------
    regs_claim<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wg_row0 = q0 + 64 * cw;              // this warpgroup's first row
    const int row0 = wg_row0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    // causal: the first warpgroup's rows end 64 keys earlier
    const int my_end = p.causal ? min(p.len_kv, wg_row0 + 64) : p.len_kv;
    const int n_mine = (my_end + BN - 1) / BN;  // n_kv or n_kv - 1

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const uint32_t q_rows = q_s + cw * 64 * 128;  // this warpgroup's 64 rows of each block

    // one thread releases a stage for the warpgroup once the products
    // that read it have retired (a wgmma retires for all four warps at once)
    auto release = [&](uint32_t bar) {
      if (tid == 0) mbar_arrive(bar);
    };

    // S = Q K^T of the tile in stage sk: D/16 k-steps, step kk 32 bytes
    // into 64-column block kk/4 of Q and K
    auto qk_async = [&](float (&sc)[BN / 2], int sk) {
      const uint32_t ks = k_s + sk * T::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(q_rows + (kk / 4) * T::kQBlockBytes + off, 16, 1024),
                 sw128_desc(ks + (kk / 4) * T::kKvBlockBytes + off, 16, 1024), kk > 0);
      }
    };
    // O += P V of the tile in stage sv: k-step kk is keys 16kk..16kk+15,
    // 2048 bytes into each 64-column block of V; the blocks are
    // kKvBlockBytes apart along N
    uint32_t pa[BN / 16][4];
    auto pv_async = [&](int sv) {
      const uint32_t vs = v_s + sv * T::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, pa[kk], sw128_desc(vs + kk * 16 * 128, T::kKvBlockBytes, 1024));
    };
    auto softmax = [&](float (&sc)[BN / 2], float (&alpha)[2], int t) {
      const int k0 = t * BN;
      const int col0 = k0 + 2 * (lane % 4);
      if (k0 + BN > p.len_kv || (p.causal && k0 + BN - 1 > wg_row0))
        softmax_tile<BN, true>(sc, m, l, alpha, row0, col0, p.len_kv, p.causal, p.scale_log2);
      else
        softmax_tile<BN, false>(sc, m, l, alpha, row0, col0, p.len_kv, p.causal, p.scale_log2);
    };
    // P as the A registers of BN/16 k-steps: k-step kk is the score chunks
    // 2kk and 2kk + 1
    auto to_bf16 = [&](const float (&sc)[BN / 2]) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // Tile 0 alone; then each step starts S of tile t and P V of tile t - 1
    // together, so that the softmax of tile t runs while P V is on the
    // tensor cores. The accumulator is rescaled once that product retired.
    float alpha[2];
    {
      float sc[BN / 2];
      mbar_wait(q_full, 0);
      mbar_wait(k_full(0), 0);
      fence_regs(sc);
      wgmma_fence();
      qk_async(sc, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(k_empty(0));
      softmax(sc, alpha, 0);  // o is zero: nothing to rescale
      to_bf16(sc);
    }
    for (int t = 1; t < n_mine; ++t) {
      const int sk = t % SK, prev = (t - 1) % SV;
      float sc[BN / 2];
      mbar_wait(k_full(sk), (t / SK) & 1);
      fence_regs(sc);
      fence_regs(o);
      wgmma_fence();
      qk_async(sc, sk);
      wgmma_commit();
      mbar_wait(v_full(prev), ((t - 1) / SV) & 1);
      pv_async(prev);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile t has retired; P V of tile t - 1 may still run
      fence_regs(sc);
      release(k_empty(sk));
      softmax(sc, alpha, t);
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty(prev));
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
      to_bf16(sc);
    }
    {
      const int last = (n_mine - 1) % SV;
      mbar_wait(v_full(last), ((n_mine - 1) / SV) & 1);
      fence_regs(o);
      wgmma_fence();
      pv_async(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty(last));
    }

    // O / l, rounded to bf16, rows past len_q left out
    bf16* out = p.out + static_cast<int64_t>(bh) * p.len_q * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = row0 + 8 * i;
      if (row >= p.len_q) continue;
      const float inv = 1.f / li;
      bf16* orow = out + static_cast<int64_t>(row) * D + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Codes at and above this are a refused tensor map: kEncodeFailed + CUresult.
constexpr int kEncodeFailed = 100000;

int tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || f == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return 0;
}

// A 4-D map over a bf16 [B, H, L, D] tensor with strides st (elements),
// innermost first (D, L, H, B), in boxes of 64 columns x `rows` rows
// stored with the 128-byte swizzle; zeros past the ends. A dimension of
// extent 1 is never stepped along, so its stride is replaced by a packed
// one (TMA takes only nonzero multiples of 16 bytes).
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, Strides st, int batch,
               int heads, int len, int d, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const int64_t given[3] = {st.s, st.h, st.b};
  cuuint64_t strides[3];
  cuuint64_t packed = static_cast<cuuint64_t>(d) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : static_cast<cuuint64_t>(given[i]) * 2;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch_wgmma(const Args& a, int batch, cudaStream_t stream) {
  using T = WgTile<D>;
  EncodeTiled encode;
  int err = tensor_map_encoder(&encode);
  if (err) return err;
  CUtensorMap tq, tk, tv;
  if ((err = encode_map(encode, &tq, a.q, a.sq, batch, a.hq, a.len_q, D, kWgRows))) return err;
  if ((err = encode_map(encode, &tk, a.k, a.sk, batch, a.hkv, a.len_kv, D, T::kKeys))) return err;
  if ((err = encode_map(encode, &tv, a.v, a.sv, batch, a.hkv, a.len_kv, D, T::kKeys))) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  WgArgs w;
  w.out = static_cast<bf16*>(a.out);
  w.hq = a.hq;
  w.hkv = a.hkv;
  w.len_q = a.len_q;
  w.len_kv = a.len_kv;
  w.causal = a.causal;
  w.scale_log2 = a.scale * kLog2e;
  const dim3 grid(batch * a.hq, (a.len_q + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<D><<<grid, kWgThreads, T::kSmemBytes, stream>>>(tq, tk, tv, w);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------- //
// bf16, D 16 / 32: mma.sync
// --------------------------------------------------------------------- //
constexpr int kWarps = 4;
constexpr int kThreadsBf16 = kWarps * 32;
constexpr int kRowsBf16 = kWarps * 16;  // query rows per block

template <int D>
struct Bf16Tile {
  static constexpr int kKeys = 64;                  // keys per kv tile
  static constexpr int kStride = D + 8;             // padded rows of Q, K and V
  // Q, and two stages of K and V
  static constexpr int kSmemBytes = (kRowsBf16 + 4 * kKeys) * kStride * 2;
};

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
int launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Bf16Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.hq, (a.len_q + kRowsBf16 - 1) / kRowsBf16);
  flash_bf16_kernel<D><<<grid, kThreadsBf16, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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

int f32_smem_bytes(int d) { return f32_smem_floats(d) * static_cast<int>(sizeof(float)); }

int launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const int smem = f32_smem_bytes(a.head_dim);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.hq, (a.len_q + kRowsF32 - 1) / kRowsF32);
  flash_f32_kernel<<<grid, kThreadsF32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launch of route (0 f32, 1 mma_sync, 2 wgmma) at head_dim d over
// batch * hq heads of len_q queries; false for a route that does not take d.
bool launch_record(int64_t batch, int64_t hq, int64_t len_q, int d, int route,
                   repro::LaunchRecord* r) {
  int rows, threads, smem;
  if (route == 0 && d % 4 == 0 && d >= 4 && d <= 256) {
    rows = kRowsF32, threads = kThreadsF32, smem = f32_smem_bytes(d);
  } else if (route == 1 && (d == 16 || d == 32)) {
    rows = kRowsBf16, threads = kThreadsBf16;
    smem = d == 16 ? Bf16Tile<16>::kSmemBytes : Bf16Tile<32>::kSmemBytes;
  } else if (route == 2 && (d == 64 || d == 128 || d == 256)) {
    rows = kWgRows, threads = kWgThreads;
    smem = d == 64 ? WgTile<64>::kSmemBytes
                   : (d == 128 ? WgTile<128>::kSmemBytes : WgTile<256>::kSmemBytes);
  } else {
    return false;
  }
  *r = {batch * hq, (len_q + rows - 1) / rows, 1, threads, smem, smem, 0};
  return true;
}

}  // namespace

// Entry 0 flash_attention, args (batch, hq, len_q, head_dim, route): one
// launch of flash_f32_kernel, flash_bf16_kernel<D> or flash_wgmma_kernel<D>.
REPRO_LAUNCH_CONFIG(flash_attention) {
  repro::LaunchRecord r;
  if (entry != 0 || n_args != 5 ||
      !launch_record(args[0], args[1], args[2], static_cast<int>(args[3]),
                     static_cast<int>(args[4]), &r)) {
    return -1;
  }
  return repro::put_launch(out, max, 0, r);
}

// The message of a code this library returned: a CUDA error, or a tensor
// map that cuTensorMapEncodeTiled refused.
extern "C" const char* error_string(int code) {
  if (code >= kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], each addressed through its
// (batch, head, row) strides in elements with a contiguous last dimension;
// out contiguous [B, Hq, Sq, D] of the same type. route (ops.route): 0
// float32, 1 bf16 mma.sync (D 16, 32), 2 bf16 wgmma (D 64, 128, 256); a
// route that does not take head_dim is refused. The wrapper has checked:
// Hq % Hkv == 0; B·Hq < 2^31 and fewer than 65536 query tiles; 16-byte
// aligned rows, strides and base; float32: D <= 256.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                               int64_t v_ss, int batch, int hq, int hkv, int len_q, int len_kv,
                               int head_dim, int causal, int route, void* stream) {
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
  if (route == 0) return launch_f32(a, batch, s);
  if (route == 1 && head_dim == 16) return launch_bf16<16>(a, batch, s);
  if (route == 1 && head_dim == 32) return launch_bf16<32>(a, batch, s);
  if (route == 2 && head_dim == 64) return launch_wgmma<64>(a, batch, s);
  if (route == 2 && head_dim == 128) return launch_wgmma<128>(a, batch, s);
  if (route == 2 && head_dim == 256) return launch_wgmma<256>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
