// Backward of GQA flash attention (FlashAttention-2's recomputing backward).
// Given q (B, S, H, D), k and v (B, T, Hkv, D), the forward's out (B, S, H, D)
// and each query row's log-sum-exp lse (B, Hkv, G, S) = (B, H, S) fp32, and
// dout, it writes dq, dk and dv in the inputs' type:
//
//   Dsum = rowsum(dO * O)                       fp32
//   P    = exp(scale * Q K^T - lse)             masked: keys >= T, queries >= S
//                                               and (causal) key > query + T - S
//   dV   = P^T dO          dS = P * (dO V^T - Dsum)
//   dQ   = dS K * scale    dK = dS^T Q * scale
//
// the G = H / Hkv query heads of a KV head summed into its dK and dV. A
// masked pair gets probability 0 from the mask itself, never from
// exp(-1e30 - lse), so a query row with no live key (causal, S > T: the
// forward's lse -1e30, output 0) gets zero gradient.
//
// Replaces src/repro/kernels/ref.py::_flash_bwd, the backward of the
// reference's custom_vjp (ref.py:91, defvjp at :222). The reference has no
// Pallas backward: its VJP is jnp that XLA compiles into one program. Here
// it is three kernels launched back to back on one stream:
//
//   dsum     one warp per query row: Dsum, fp32, in lse's (B, H, S) order.
//   dK, dV   grid (key tiles, Hkv, B): a block owns a tile of keys of one
//            (batch, KV head), keeps its K and V rows in shared memory and
//            its dK and dV in registers, and walks the G query heads and,
//            for each, the query tiles from the first with a live pair (the
//            causal diagonal) to the end: Q, dO, lse and Dsum staged per tile.
//   dQ       grid (query tiles, H, B): a block owns a query tile of one head,
//            keeps Q and dO in shared memory and dQ in registers, and walks
//            the key tiles up to its causal limit.
//
// The two passes recompute Q K^T and dO V^T each (7 products where the
// function needs 5): the price of having no atomics. FlashAttention-2 adds
// each pair's dS K into dQ with floating-point atomics, whose order changes
// from run to run; here every sum runs in a fixed order (the head and tile
// loops), so the same inputs give the same bits, which the training path's
// crash-and-relaunch check needs. Both passes are one template: a block's
// "own" rows (keys, or queries) and its "streamed" rows (queries, or keys):
//   X = A1 B1^T, Y = A2 B2^T   (own x streamed: S^T and dP^T, or S and dP)
//   acc1 += dS B1, acc2 += P B2 (dK and dV from Q and dO; or dQ from K)
//
// Variants, picked by the wrapper (kernels/flash_attention.py) before launch,
// as the forward's are:
//   tc   bf16 at D in {64, 112, 128}: tensor-core products with
//        mma.sync m16n8k16 (bf16 in, fp32 accumulate), fragments read from
//        shared memory with ldmatrix (.trans for the streamed operand of
//        the second products). Tiles of 64 own x 64 streamed rows, four
//        warps of 16 own rows each; each 16-column slice of a streamed
//        tile goes X, Y -> P, dS (fp32, rounded to bf16 for their products,
//        as the forward rounds P) -> acc, the accumulator layout of X being
//        the A-fragment layout of the next product, so P and dS never leave
//        registers. Shared rows are padded by 8 elements, which puts the 8
//        rows of an ldmatrix on 8 distinct 16-byte bank groups. D = 112 is
//        computed natively: 7 k-steps of 16 and 14 output tiles of 8.
//   fma  fp32 at every D (so fp32 never goes through TF32) and bf16 at D in
//        {16, 32}: 32 x 32 tiles in fp32 shared memory, fp32 FMAs, each
//        thread a 2 x 4 patch of X and Y and 2 rows x D/8 columns of each
//        accumulator; P and dS staged in shared memory.
//
// Bound on an H100: at the training shape (B 4, S = T = 2048, H 16, Hkv 8,
// D 128, causal, bf16) the function's five products do 2.5x the forward's
// flops against reading q, k, v, out, dout and lse and writing dq, dk, dv
// once: bound by operations (989 TFLOP/s bf16 dense). mma.sync reaches only
// part of that rate on Hopper (wgmma is the full-rate path), and the two
// passes do 7/5 of the products; both are what a later redesign takes up.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include "convert.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// ---- loop bounds shared by both variants ----------------------------------

// The first streamed query tile (of `cols` rows) with a live pair for keys
// from k0 on: causal pairs need query + offset >= key.
__device__ __forceinline__ int first_query_tile(int k0, int offset, int causal, int cols) {
  return causal ? max(k0 - offset, 0) / cols : 0;
}

// The key tiles (of `cols` keys) that the query tile [q0, q0 + rows) reaches.
__device__ __forceinline__ int key_tiles(int q0, int rows, int s, int t, int offset, int causal, int cols) {
  const int nk = (t + cols - 1) / cols;
  if (!causal) return nk;
  const int q_last = min(q0 + rows, s) - 1 + offset;
  return q_last < 0 ? 0 : min(q_last / cols + 1, nk);
}

__device__ __forceinline__ bool live_pair(int qi, int ki, int s, int t, int offset, int causal) {
  return qi < s && ki < t && (!causal || qi + offset >= ki);
}

// ---- Dsum = rowsum(dO * O) ---------------------------------------------------

constexpr int DSUM_WARPS = 8;

template <typename T, int D>
__global__ void __launch_bounds__(DSUM_WARPS * 32)
flash_bwd_dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ dsum, int64_t rows,
            int s, int h) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CHUNKS = D / VEC;  // <= 32: one 16-byte piece per lane
  static_assert(CHUNKS <= 32, "a row must fit one warp's 16-byte pieces");
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * DSUM_WARPS + (threadIdx.x >> 5);  // (b, s, h) order
  if (row >= rows) return;
  float acc = 0.0f;
  if (lane < CHUNKS) {
    float o[VEC], g[VEC];
    load16(out + row * D + lane * VEC, o);
    load16(dout + row * D + lane * VEC, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(o[i], g[i], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const int64_t bs = row / h;
    dsum[(bs / s * h + row % h) * s + bs % s] = acc;
  }
}

// ---- tensor-core variant (bf16, D in {64, 112, 128}) --------------------------

constexpr int TC_ROWS = 64;  // own rows a block: 4 warps x 16
constexpr int TC_COLS = 64;  // streamed rows a step
constexpr int TC_THREADS = 128;

template <int D>
struct TcLayout {
  static constexpr int LD = D + 8;  // row stride (elements): 16-byte aligned, conflict-free ldmatrix
  static constexpr size_t bytes() {
    return sizeof(bf16) * (2 * TC_ROWS + 2 * TC_COLS) * LD + sizeof(float) * 2 * TC_COLS;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `valid` of 64 rows of D bf16 (global row stride `gstride` elements,
// 16-byte aligned) into shared rows of stride D + 8, zero-filling the rest.
template <int D>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* __restrict__ src, int64_t gstride, int valid) {
  constexpr int CHUNKS = D / 8;
  constexpr int LD = TcLayout<D>::LD;
  for (int e = threadIdx.x; e < 64 * CHUNKS; e += TC_THREADS) {
    const int r = e / CHUNKS;
    const int c = (e % CHUNKS) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) raw = __ldg(reinterpret_cast<const uint4*>(src + r * gstride + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

// Fragment layouts (m16n8k16, lane = 4 * gq + tq): an accumulator tile's
// element e sits at row gq + 8 * (e >> 1), column 2 * tq + (e & 1).
//
// One streamed tile (b1s, b2s, and for KV the per-column lse / Dsum in
// shared memory; for dQ the own rows' in registers) into the accumulators.
template <int D, bool KV>
__device__ __forceinline__ void tc_step(float (&acc1)[D / 8][4], float (&acc2)[KV ? D / 8 : 1][4], uint32_t a1_addr,
                                        uint32_t a2_addr, uint32_t b1_base, uint32_t b2_base, const float* lse_s,
                                        const float* dsum_s, const float (&lse_own)[2], const float (&dsum_own)[2],
                                        int own_lo, int c0, int s, int t, int offset, int causal, float scale_log2) {
  constexpr int LDB = TcLayout<D>::LD * 2;  // row stride in bytes
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;  // own_lo already holds this lane's row group
  const int m = lane >> 3, rr = lane & 7;
  // ldmatrix row addresses of this lane: the non-transposed B operand
  // (matrices: n 0-7 k 0-7, n 0-7 k 8-15, n 8-15 k 0-7, n 8-15 k 8-15) and
  // the transposed one (k 0-7 n 0-7, k 8-15 n 0-7, k 0-7 n 8-15, k 8-15 n 8-15).
  const uint32_t b_off = (rr + (m >> 1) * 8) * LDB + (m & 1) * 16;
  const uint32_t bt_off = (rr + (m & 1) * 8) * LDB + (m >> 1) * 16;
#pragma unroll 1
  for (int cc = 0; cc < TC_COLS / 16; ++cc) {
    float x[2][4], y[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.0f;
    const uint32_t row16 = cc * 16 * LDB;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a1[4], a2[4], b1[4], b2[4];
      ldsm_x4(a1, a1_addr + kk * 32);
      ldsm_x4(b1, b1_base + row16 + b_off + kk * 32);
      mma_bf16(x[0], a1, b1[0], b1[1]);
      mma_bf16(x[1], a1, b1[2], b1[3]);
      ldsm_x4(a2, a2_addr + kk * 32);
      ldsm_x4(b2, b2_base + row16 + b_off + kk * 32);
      mma_bf16(y[0], a2, b2[0], b2[1]);
      mma_bf16(y[1], a2, b2[2], b2[3]);
    }
    // P and dS as A fragments of the next products: (a0, a1, a2, a3) of a
    // 16 x 16 slice are (rows 0-7 k 0-7, rows 8-15 k 0-7, rows 0-7 k 8-15,
    // rows 8-15 k 8-15), i.e. accumulator tile 0's two halves, then tile 1's.
    uint32_t pa[4], dsa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int own = own_lo + 8 * (e >> 1);
        const int col = cc * 16 + n * 8 + 2 * tq + (e & 1);  // within the streamed tile
        const int qi = KV ? c0 + col : own;
        const int ki = KV ? own : c0 + col;
        const float l2 = KV ? lse_s[col] : lse_own[e >> 1];
        const float dsum = KV ? dsum_s[col] : dsum_own[e >> 1];
        p[e] = live_pair(qi, ki, s, t, offset, causal) ? exp2f(x[n][e] * scale_log2 - l2) : 0.0f;
        ds[e] = p[e] * (y[n][e] - dsum);
      }
      pa[2 * n] = pack_bf16(p[0], p[1]);
      pa[2 * n + 1] = pack_bf16(p[2], p[3]);
      dsa[2 * n] = pack_bf16(ds[0], ds[1]);
      dsa[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, b1_base + row16 + bt_off + np * 32);
      mma_bf16(acc1[2 * np], dsa, b[0], b[1]);
      mma_bf16(acc1[2 * np + 1], dsa, b[2], b[3]);
      if constexpr (KV) {
        ldsm_x4_trans(b, b2_base + row16 + bt_off + np * 32);
        mma_bf16(acc2[2 * np], pa, b[0], b[1]);
        mma_bf16(acc2[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }
}

// KV: (d1, d2) = (dK, dV), grid (ceil(T / 64), Hkv, B).
// !KV: d1 = dQ, grid (ceil(S / 64), H, B), the longest query tiles first.
template <int D, bool KV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
              bf16* __restrict__ d1, bf16* __restrict__ d2, int s, int t, int h, int hkv, int causal, float scale) {
  constexpr int LD = TcLayout<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* a1s = reinterpret_cast<bf16*>(smem_raw);  // own rows: K, or Q
  bf16* a2s = a1s + TC_ROWS * LD;                 // own rows: V, or dO
  bf16* b1s = a2s + TC_ROWS * LD;                 // streamed: Q, or K
  bf16* b2s = b1s + TC_COLS * LD;                 // streamed: dO, or V
  float* lse_s = reinterpret_cast<float*>(b2s + TC_COLS * LD);  // KV: the streamed queries' lse * log2 e
  float* dsum_s = lse_s + TC_COLS;

  const int g_size = h / hkv;
  const int b = blockIdx.z;
  const int offset = t - s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const float scale_log2 = scale * LOG2E;
  const int nq = (s + TC_COLS - 1) / TC_COLS;
  const int own0 = KV ? blockIdx.x * TC_ROWS : (nq - 1 - static_cast<int>(blockIdx.x)) * TC_ROWS;
  const int n_own = KV ? t : s;
  const int hk = KV ? blockIdx.y : blockIdx.y / g_size;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const bf16* kb = k + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;
  const bf16* vb = v + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;

  // Own rows: staged once (the first step's barrier orders them).
  if constexpr (KV) {
    stage_tc<D>(a1s, kb + own0 * kv_stride, kv_stride, min(TC_ROWS, t - own0));
    stage_tc<D>(a2s, vb + own0 * kv_stride, kv_stride, min(TC_ROWS, t - own0));
  } else {
    const int64_t off = static_cast<int64_t>(b) * s * q_stride + own0 * q_stride + static_cast<int64_t>(blockIdx.y) * D;
    stage_tc<D>(a1s, q + off, q_stride, min(TC_ROWS, s - own0));
    stage_tc<D>(a2s, dout + off, q_stride, min(TC_ROWS, s - own0));
  }

  const int own_lo = own0 + warp * 16 + gq;  // this lane's own rows: own_lo and own_lo + 8
  float lse_own[2] = {0.0f, 0.0f}, dsum_own[2] = {0.0f, 0.0f};
  if constexpr (!KV) {
    const int64_t row0 = (static_cast<int64_t>(b) * h + blockIdx.y) * s;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (own_lo + 8 * i < s) {
        lse_own[i] = lse[row0 + own_lo + 8 * i] * LOG2E;
        dsum_own[i] = dsum[row0 + own_lo + 8 * i];
      }
    }
  }

  float acc1[D / 8][4], acc2[KV ? D / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < (KV ? D / 8 : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.0f;

  // ldmatrix A addresses of this lane (matrices: rows 0-7 k 0-7, rows 8-15
  // k 0-7, rows 0-7 k 8-15, rows 8-15 k 8-15 of the warp's 16 own rows).
  const int m = lane >> 3, rr = lane & 7;
  const uint32_t a_off = ((warp * 16 + rr + (m & 1) * 8) * LD + (m >> 1) * 8) * 2;
  const uint32_t a1_addr = smem_u32(a1s) + a_off, a2_addr = smem_u32(a2s) + a_off;
  const uint32_t b1_base = smem_u32(b1s), b2_base = smem_u32(b2s);

  if constexpr (KV) {
    const int qt0 = first_query_tile(own0, offset, causal, TC_COLS);
    for (int g = 0; g < g_size; ++g) {
      const int head = hk * g_size + g;
      const int64_t base = static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * D;
      const int64_t row0 = (static_cast<int64_t>(b) * h + head) * s;
      for (int qt = qt0; qt < nq; ++qt) {
        const int c0 = qt * TC_COLS;
        __syncthreads();  // the previous step's readers are done
        stage_tc<D>(b1s, q + base + c0 * q_stride, q_stride, min(TC_COLS, s - c0));
        stage_tc<D>(b2s, dout + base + c0 * q_stride, q_stride, min(TC_COLS, s - c0));
        if (threadIdx.x < TC_COLS) {
          const int qi = c0 + threadIdx.x;
          lse_s[threadIdx.x] = qi < s ? lse[row0 + qi] * LOG2E : 0.0f;
          dsum_s[threadIdx.x] = qi < s ? dsum[row0 + qi] : 0.0f;
        }
        __syncthreads();
        tc_step<D, KV>(acc1, acc2, a1_addr, a2_addr, b1_base, b2_base, lse_s, dsum_s, lse_own, dsum_own, own_lo,
                       c0, s, t, offset, causal, scale_log2);
      }
    }
  } else {
    const int hi = key_tiles(own0, TC_ROWS, s, t, offset, causal, TC_COLS);
    for (int kt = 0; kt < hi; ++kt) {
      const int c0 = kt * TC_COLS;
      __syncthreads();
      stage_tc<D>(b1s, kb + c0 * kv_stride, kv_stride, min(TC_COLS, t - c0));
      stage_tc<D>(b2s, vb + c0 * kv_stride, kv_stride, min(TC_COLS, t - c0));
      __syncthreads();
      tc_step<D, KV>(acc1, acc2, a1_addr, a2_addr, b1_base, b2_base, lse_s, dsum_s, lse_own, dsum_own, own_lo,
                     c0, s, t, offset, causal, scale_log2);
    }
  }

  // Epilogue: dK (or dQ) = acc1 * scale, dV = acc2; bf16 pairs.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = own_lo + 8 * i;
    if (r >= n_own) continue;
    const int64_t off = KV ? (static_cast<int64_t>(b) * t + r) * kv_stride + static_cast<int64_t>(hk) * D
                           : (static_cast<int64_t>(b) * s + r) * q_stride + static_cast<int64_t>(blockIdx.y) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(d1 + off + c) = pack_bf16(acc1[n][2 * i] * scale, acc1[n][2 * i + 1] * scale);
      if constexpr (KV) *reinterpret_cast<uint32_t*>(d2 + off + c) = pack_bf16(acc2[n][2 * i], acc2[n][2 * i + 1]);
    }
  }
}

// ---- FMA variant (fp32 at every D, bf16 at D in {16, 32}) ---------------------

constexpr int F_ROWS = 32;  // own rows a block
constexpr int F_COLS = 32;  // streamed rows a step
constexpr int F_THREADS = 128;  // 16 row pairs x 8 column lanes
constexpr int F_LDP = F_COLS + 1;

template <int D>
struct FmaLayout {
  static constexpr int LD = D + 1;  // fp32 row stride: a column of 8 rows hits 8 banks
  static constexpr size_t bytes() {
    return sizeof(float) * ((2 * F_ROWS + 2 * F_COLS) * LD + 2 * F_ROWS * F_LDP + 2 * F_COLS);
  }
};

// `valid` of `rows` rows of D elements of T into fp32 shared rows of stride
// D + 1, zero-filling the rest.
template <typename T, int D>
__device__ __forceinline__ void stage_fma(float* dst, const T* __restrict__ src, int64_t gstride, int rows,
                                          int valid) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = FmaLayout<D>::LD;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += F_THREADS) {
    const int r = e / CHUNKS;
    const int c = (e % CHUNKS) * VEC;
    float f[VEC];
    if (r < valid) {
      load16(src + r * gstride + c, f);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * LD + c + i] = f[i];
  }
}

template <typename T, int D, bool KV>
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ d1, T* __restrict__ d2, int s, int t, int h, int hkv, int causal, float scale) {
  constexpr int LD = FmaLayout<D>::LD;
  constexpr int DJ = D / 8;  // accumulator columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a1s = reinterpret_cast<float*>(smem_raw);  // own rows: K, or Q
  float* a2s = a1s + F_ROWS * LD;                   // own rows: V, or dO
  float* b1s = a2s + F_ROWS * LD;                   // streamed: Q, or K
  float* b2s = b1s + F_COLS * LD;                   // streamed: dO, or V
  float* ps = b2s + F_COLS * LD;                    // [F_ROWS][F_LDP] P
  float* dss = ps + F_ROWS * F_LDP;                 // [F_ROWS][F_LDP] dS
  float* lse_s = dss + F_ROWS * F_LDP;              // KV: the streamed queries' lse
  float* dsum_s = lse_s + F_COLS;

  const int g_size = h / hkv;
  const int b = blockIdx.z;
  const int offset = t - s;
  const int ty = threadIdx.x >> 3;  // own rows 2 ty, 2 ty + 1
  const int tx = threadIdx.x & 7;   // streamed rows and accumulator columns tx + 8 j
  const int nq = (s + F_COLS - 1) / F_COLS;
  const int own0 = KV ? blockIdx.x * F_ROWS : (nq - 1 - static_cast<int>(blockIdx.x)) * F_ROWS;
  const int n_own = KV ? t : s;
  const int hk = KV ? blockIdx.y : blockIdx.y / g_size;
  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const T* kb = k + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;

  if constexpr (KV) {
    stage_fma<T, D>(a1s, kb + own0 * kv_stride, kv_stride, F_ROWS, min(F_ROWS, t - own0));
    stage_fma<T, D>(a2s, vb + own0 * kv_stride, kv_stride, F_ROWS, min(F_ROWS, t - own0));
  } else {
    const int64_t off = static_cast<int64_t>(b) * s * q_stride + own0 * q_stride + static_cast<int64_t>(blockIdx.y) * D;
    stage_fma<T, D>(a1s, q + off, q_stride, F_ROWS, min(F_ROWS, s - own0));
    stage_fma<T, D>(a2s, dout + off, q_stride, F_ROWS, min(F_ROWS, s - own0));
  }
  float lse_own[2] = {0.0f, 0.0f}, dsum_own[2] = {0.0f, 0.0f};
  if constexpr (!KV) {
    const int64_t row0 = (static_cast<int64_t>(b) * h + blockIdx.y) * s;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = own0 + 2 * ty + i;
      if (r < s) {
        lse_own[i] = lse[row0 + r];
        dsum_own[i] = dsum[row0 + r];
      }
    }
  }

  float acc1[2][DJ], acc2[2][KV ? DJ : 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc1[i][j] = 0.0f;
#pragma unroll
    for (int j = 0; j < (KV ? DJ : 1); ++j) acc2[i][j] = 0.0f;
  }

  // One streamed tile (staged by the caller) into the accumulators.
  auto step = [&](int c0) {
    float x[2][4], y[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a1[2], a2[2], b1[4], b2[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a1[i] = a1s[(2 * ty + i) * LD + d];
        a2[i] = a2s[(2 * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = b1s[(tx + 8 * j) * LD + d];
        b2[j] = b2s[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[i][j] = fmaf(a1[i], b1[j], x[i][j]);
          y[i][j] = fmaf(a2[i], b2[j], y[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int own = own0 + 2 * ty + i;
        const int col = tx + 8 * j;
        const int qi = KV ? c0 + col : own;
        const int ki = KV ? own : c0 + col;
        const float l = KV ? lse_s[col] : lse_own[i];
        const float dsum = KV ? dsum_s[col] : dsum_own[i];
        const float p = live_pair(qi, ki, s, t, offset, causal) ? expf(x[i][j] * scale - l) : 0.0f;
        ps[(2 * ty + i) * F_LDP + col] = p;
        dss[(2 * ty + i) * F_LDP + col] = p * (y[i][j] - dsum);
      }
    __syncthreads();  // the whole P and dS tiles are in shared memory
#pragma unroll 4
    for (int c = 0; c < F_COLS; ++c) {
      float p[2], ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        p[i] = ps[(2 * ty + i) * F_LDP + c];
        ds[i] = dss[(2 * ty + i) * F_LDP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float bv1 = b1s[c * LD + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) acc1[i][j] = fmaf(ds[i], bv1, acc1[i][j]);
        if constexpr (KV) {
          const float bv2 = b2s[c * LD + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 2; ++i) acc2[i][j] = fmaf(p[i], bv2, acc2[i][j]);
        }
      }
    }
  };

  if constexpr (KV) {
    const int qt0 = first_query_tile(own0, offset, causal, F_COLS);
    for (int g = 0; g < g_size; ++g) {
      const int head = hk * g_size + g;
      const int64_t base = static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * D;
      const int64_t row0 = (static_cast<int64_t>(b) * h + head) * s;
      for (int qt = qt0; qt < nq; ++qt) {
        const int c0 = qt * F_COLS;
        __syncthreads();  // the previous step's readers are done
        stage_fma<T, D>(b1s, q + base + c0 * q_stride, q_stride, F_COLS, min(F_COLS, s - c0));
        stage_fma<T, D>(b2s, dout + base + c0 * q_stride, q_stride, F_COLS, min(F_COLS, s - c0));
        if (threadIdx.x < F_COLS) {
          const int qi = c0 + threadIdx.x;
          lse_s[threadIdx.x] = qi < s ? lse[row0 + qi] : 0.0f;
          dsum_s[threadIdx.x] = qi < s ? dsum[row0 + qi] : 0.0f;
        }
        __syncthreads();
        step(c0);
      }
    }
  } else {
    const int hi = key_tiles(own0, F_ROWS, s, t, offset, causal, F_COLS);
    for (int kt = 0; kt < hi; ++kt) {
      const int c0 = kt * F_COLS;
      __syncthreads();
      stage_fma<T, D>(b1s, kb + c0 * kv_stride, kv_stride, F_COLS, min(F_COLS, t - c0));
      stage_fma<T, D>(b2s, vb + c0 * kv_stride, kv_stride, F_COLS, min(F_COLS, t - c0));
      __syncthreads();
      step(c0);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = own0 + 2 * ty + i;
    if (r >= n_own) continue;
    const int64_t off = KV ? (static_cast<int64_t>(b) * t + r) * kv_stride + static_cast<int64_t>(hk) * D
                           : (static_cast<int64_t>(b) * s + r) * q_stride + static_cast<int64_t>(blockIdx.y) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      d1[off + tx + 8 * j] = from_f32<T>(acc1[i][j] * scale);
      if constexpr (KV) d2[off + tx + 8 * j] = from_f32<T>(acc2[i][j]);
    }
  }
}

// ---- launch -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *dout, *lse;
  void *dsum, *dq, *dk, *dv;
  int b, s, t, h, hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dsum(const Args& a) {
  const int64_t rows = static_cast<int64_t>(a.b) * a.s * a.h;
  const unsigned blocks = static_cast<unsigned>((rows + DSUM_WARPS - 1) / DSUM_WARPS);
  flash_bwd_dsum_kernel<T, D><<<blocks, DSUM_WARPS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), static_cast<float*>(a.dsum), rows, a.s, a.h);
  return static_cast<int>(cudaGetLastError());
}

// Launch one pass `kernel` on grid (tiles, heads, B) with `smem` bytes.
template <typename T, typename K>
int launch_pass(K kernel, size_t smem, int tiles, int heads, const Args& a, void* d1, void* d2) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(TC_THREADS == F_THREADS, "both variants run one block size");
  kernel<<<dim3(tiles, heads, a.b), TC_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<T*>(d1), static_cast<T*>(d2), a.s, a.t, a.h, a.hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const Args& a) {
  int err = launch_dsum<bf16, D>(a);
  if (err) return err;
  const size_t smem = TcLayout<D>::bytes();
  err = launch_pass<bf16>(flash_bwd_tc_kernel<D, true>, smem, (a.t + TC_ROWS - 1) / TC_ROWS, a.hkv, a, a.dk, a.dv);
  if (err) return err;
  return launch_pass<bf16>(flash_bwd_tc_kernel<D, false>, smem, (a.s + TC_ROWS - 1) / TC_ROWS, a.h, a, a.dq, nullptr);
}

template <typename T, int D>
int launch_fma(const Args& a) {
  int err = launch_dsum<T, D>(a);
  if (err) return err;
  const size_t smem = FmaLayout<D>::bytes();
  err = launch_pass<T>(flash_bwd_fma_kernel<T, D, true>, smem, (a.t + F_ROWS - 1) / F_ROWS, a.hkv, a, a.dk, a.dv);
  if (err) return err;
  return launch_pass<T>(flash_bwd_fma_kernel<T, D, false>, smem, (a.s + F_ROWS - 1) / F_ROWS, a.h, a, a.dq, nullptr);
}

}  // namespace

// q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, T, Hkv, D): contiguous,
// 16-byte aligned, one element type; lse (B, H, S) fp32 contiguous, the
// forward's; dsum (B, H, S) fp32 scratch. D in {16, 32, 64, 112, 128} for
// fp32 and bf16 (bf16 at 64, 112 and 128 on the tensor cores); H % Hkv == 0.
// Launches three kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                       const void* dout, const void* lse, void* dsum, void* dq, void* dk, void* dv,
                                       int b, int s, int t, int h, int hkv, int d, int causal, float scale,
                                       cudaStream_t stream) {
  const Args a{q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s, t, h, hkv, causal, scale, stream};
  switch (d) {
    case 16: return launch_fma<float, 16>(a);
    case 32: return launch_fma<float, 32>(a);
    case 64: return launch_fma<float, 64>(a);
    case 112: return launch_fma<float, 112>(a);
    case 128: return launch_fma<float, 128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                        const void* dout, const void* lse, void* dsum, void* dq, void* dk, void* dv,
                                        int b, int s, int t, int h, int hkv, int d, int causal, float scale,
                                        cudaStream_t stream) {
  const Args a{q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s, t, h, hkv, causal, scale, stream};
  switch (d) {
    case 16: return launch_fma<bf16, 16>(a);
    case 32: return launch_fma<bf16, 32>(a);
    case 64: return launch_tc<64>(a);
    case 112: return launch_tc<112>(a);
    case 128: return launch_tc<128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
