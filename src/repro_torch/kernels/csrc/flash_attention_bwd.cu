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
// forward's lse -1e30, output 0) gets exactly zero gradient.
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
//            causal diagonal) to the end.
//   dQ       grid (query tiles, H, B): a block owns a query tile of one head,
//            keeps Q and dO in shared memory and dQ in registers, and walks
//            the key tiles up to its causal limit.
//
// Bound on an H100: at the training shape (B 4, S = T = 2048, H 16, Hkv 8,
// D 128, causal, bf16) the function's five products (Q K^T, dO V^T, P^T dO,
// dS^T Q, dS K: 2.5x the forward's flops) against reading q, k, v, out,
// dout and lse and writing dq, dk, dv once are bound by operations: 173.8 us
// at 989 TFLOP/s bf16 dense. This design runs seven products (each pass
// recomputes Q K^T and dO V^T), so its own floor is 7/5 of that, 243.3 us.
// What each part of the tensor-core variant (bf16, D in {64, 112, 128})
// does about it:
//
//   products  every product is wgmma, the only path to the full bf16 rate
//             (hopper.cuh's helpers, shared with the forward). The score
//             products S^T = K Q^T and dP^T = V dO^T (dK/dV pass), S = Q K^T
//             and dP = dO V^T (dQ pass) read both operands from shared
//             memory, K-major as stored (the forward's Q K^T); the gradient
//             products dV += P^T dO, dK += dS^T Q and dQ += dS K take P^T,
//             dS^T or dS from registers as bf16 (the fp32 accumulator layout
//             of a score tile is the register-A layout of the next product)
//             and the streamed tile MN-major under the transpose bit (the
//             forward's P V). P and dS never leave registers; both are
//             rounded to bf16 for their products, as the forward rounds P.
//   copies    TMA: 4-D tensor maps over the (B, T, Hkv, d) and (B, S, H, d)
//             layouts, 128-byte swizzled, 64-column boxes (two panels at
//             D = 112 and 128): no consumer thread spends registers or
//             instructions on a copy; TMA fills rows past S or T, and
//             columns 112-127 at D = 112, with zeros. The dK/dV pass's
//             producer warp stages each query tile's lse and Dsum (64 fp32
//             each) beside it with plain loads: a TMA box over the (B, H, S)
//             rows would start off 16-byte alignment when S % 4 != 0.
//   pipeline  a block is one producer warp (in a warpgroup that setmaxnreg
//             shrinks to 24 registers) and two consumer warpgroups (240).
//             The own tiles are loaded once; the streamed tiles come through
//             a ring with full (TMA bytes landed) and empty (all 8 consumer
//             warps done) mbarriers, so the next tiles load while the tensor
//             cores work: 3 stages of Q, dO, lse and Dsum (dK/dV pass), 2 of
//             K and V (dQ pass). Each consumer issues its two score products
//             as one wgmma group and its gradient products as a second and
//             waits on each; the two warpgroups share the tensor cores, so
//             one's exponentials run while the other's products do (the
//             forward's explicit ping-pong turns measured no faster here).
//   tiles     dK/dV: 128 keys a block (64 a warpgroup: 64 + 64 fp32
//             accumulator registers for dK and dV at D 128, 32 + 32 for the
//             two score tiles) against 64-query tiles; key tile 0 walks the
//             most query tiles (causal) and launches first. dQ: 128 query
//             rows a block (64 a warpgroup: 64 accumulator registers for dQ,
//             64 + 64 for the score tiles) against 128-key tiles; the query
//             tiles nearest the diagonal's end launch first. A warpgroup
//             skips a tile with no live pair for its rows; only tiles that
//             the causal diagonal, S or T cut are masked; key tiles wholly
//             above the diagonal are never loaded. Shared memory: 166,400 B
//             (dK/dV) and 197,632 B (dQ) at D 128, within 227 KB.
//   D = 112   (zamba2's heads) is computed natively: products whose depth
//             is D take 7 k-steps of 16 and never read the zero columns;
//             products whose width is D run at N = 128, and the epilogue
//             stores no column >= 112.
//   order     no floating-point atomics and no split of one output row's sum
//             across blocks: each dK and dV row is summed in one block's
//             registers over the G heads, then the query tiles, in loop
//             order, and each dQ row over the key tiles, so the same inputs
//             give the same bits, which the training path's crash-and-
//             relaunch check needs. That is why dQ has a pass of its own
//             (FlashAttention-2 adds each dS K into dQ with atomics, whose
//             order changes from run to run): 7 products for 5, and no dQ
//             workspace to write and read again.
//
// The FMA variant: fp32 at every D (so fp32 never goes through TF32) and
// bf16 at D in {16, 32} (widened on the way to the registers). Its products
// are IEEE fp32 FFMAs, so its bound is the CUDA cores' 67 TFLOP/s: 7/5 of
// the five products' floor, as above (1,571.4 us at zamba2's tensor-parallel
// rank call, B 2, S = T = 2048, H = Hkv = 16, D 112). An SM issues 128 FFMA
// lanes a clock but serves 128 bytes of shared memory a clock, so the design
// is an SGEMM's, one template for both passes: a block's 64 "own" rows (keys,
// or queries) and the 128-row "streamed" tiles it walks (queries, or keys):
//
//   warps     256 threads: warpgroup 0 computes X = A0 B0^T (S^T = K Q^T,
//             or S = Q K^T) and turns it into P; warpgroup 1 computes
//             Y = A1 B1^T (dP^T = V dO^T, or dP = dO V^T) and turns it into
//             dS = P * (Y - Dsum) once P is written. Each thread (8 row
//             lanes x 16 column lanes of its warpgroup) owns an 8 x 8 patch:
//             own rows ty + 8 i, streamed rows tx + 16 j, read as 16-byte
//             shared loads of 4 columns of d (16 loads for 256 FFMAs).
//   gradient  P and dS are written once to shared memory, transposed
//             (streamed x own, each thread's 8 own rows adjacent); the
//             gradient products read 8 own rows of a streamed row in two
//             16-byte loads beside D / 16 values of the right operand (8 x 8
//             patches at D 112 and 128; at 112 the 16 columns past D are
//             computed and never stored). dK/dV pass: warpgroup 0 sums
//             dV += P^T dO, warpgroup 1 dK += dS^T Q. dQ pass: both sum
//             dQ += dS K, warpgroup w over keys 64 w .. 64 w + 63 of each
//             tile; the two sums are added in that order at the end.
//   copies    TMA, issued by thread 0: the own tiles (64 x D each, dense)
//             once; the streamed tiles through a 3-stage ring of chunks in
//             the order the products read them: D / 16 score chunks of 128
//             rows x 16 columns of B0 and B1 (swizzled, so that the 16 rows
//             a warp reads at once hit distinct banks), then gradient chunks
//             of 32 rows x D of each warpgroup's right operand (dense, zero-
//             filled past D; 16 rows and 4 stages for fp32 at D 128, where
//             3 stages of 32 rows do not fit). One block barrier and the
//             stage's mbarrier wait for each chunk and free the one before
//             it, so 2 (or 3) chunks are in flight while the FFMAs run.
//   softmax   P = exp2(X * scale * log2(e) - lse * log2(e)) in one FMA and
//             one exponential; masks are evaluated only on tiles that the
//             causal diagonal, S or T cut; tiles wholly above the diagonal
//             are never loaded.
//   grids     dK/dV: ceil(T/64) x Hkv x B blocks, dQ: ceil(S/64) x H x B,
//             launched tile-major with the longest tiles first (key tile 0;
//             the query tiles nearest the diagonal's end), so that no long
//             block starts in the last wave. One block per SM (shared memory).
//   order     each output row is summed by one thread over the G heads, the
//             streamed tiles and their rows in loop order, with no atomics.
// The wrapper (kernels/flash_attention.py) picks the variant before launch,
// as the forward's are picked; its fma_plan mirrors this geometry.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <math.h>

#include "convert.cuh"
#include "hopper.cuh"

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

// ---- tensor-core variant (bf16, D in {64, 112, 128}): wgmma + TMA --------------

constexpr int TC_CONSUMERS = 256;               // two consumer warpgroups of 64 own rows
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // + the producer warpgroup
constexpr int KV_OWN = 128, KV_STREAM = 64, KV_STAGES = 3;  // dK/dV pass: keys a block, queries a stage
constexpr int Q_OWN = 128, Q_STREAM = 128, Q_STAGES = 2;    // dQ pass: queries a block, keys a stage

// Shared memory of one pass: its two own tiles (K and V, or Q and dO), then
// STAGES streamed tiles of each of the other two (Q and dO, or K and V),
// each tile ceil(D / 64) swizzle panels of (rows x 128 bytes), 1024-byte
// aligned; then, with ROWS (the dK/dV pass), each stage's queries' lse and
// Dsum. DP is D rounded up to whole panels: the width of the products
// whose width is D, and of their accumulators.
template <int D, int OWN, int STREAM, int STAGES, bool ROWS>
struct TcSmem {
  static constexpr int PANELS = (D + PANEL - 1) / PANEL;
  static constexpr int DP = PANELS * PANEL;
  static constexpr int OWN_PANEL = OWN * ROW_BYTES;
  static constexpr int STREAM_PANEL = STREAM * ROW_BYTES;
  static constexpr int OWN_BYTES = PANELS * OWN_PANEL;        // one own tile
  static constexpr int STREAM_BYTES = PANELS * STREAM_PANEL;  // one streamed tile
  static constexpr int A2_OFF = OWN_BYTES;
  static constexpr int B1_OFF = 2 * OWN_BYTES;
  static constexpr int B2_OFF = B1_OFF + STAGES * STREAM_BYTES;
  static constexpr int ROWS_OFF = B2_OFF + STAGES * STREAM_BYTES;
  static constexpr int ROW_VALUES = ROWS ? 2 * STREAM : 0;  // fp32 a stage: lse, then Dsum
  static constexpr int BYTES = ROWS_OFF + STAGES * ROW_VALUES * 4;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};
template <int D>
using KvSmem = TcSmem<D, KV_OWN, KV_STREAM, KV_STAGES, true>;
template <int D>
using QSmem = TcSmem<D, Q_OWN, Q_STREAM, Q_STAGES, false>;

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// dK/dV pass, grid (ceil(T / 128), Hkv, B): a block owns 128 keys of one
// (batch, KV head), 64 a consumer warpgroup, and walks the G query heads in
// order and, for each, the 64-row query tiles from the causal diagonal on.
// Key tile 0 walks the most (causal) and is launched first.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int s, int t, int h, int hkv, int causal, float scale) {
  using L = KvSmem<D>;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t own_full, full[KV_STAGES], empty[KV_STAGES];
  uint8_t* smem = align_1024(tc_smem);

  const int g_size = h / hkv;
  const int k0 = blockIdx.x * KV_OWN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = t - s;
  const int qt0 = first_query_tile(k0, offset, causal, KV_STREAM);
  const int per_head = (s + KV_STREAM - 1) / KV_STREAM - qt0;  // >= 1: query k0 - offset < S sees key k0
  const int n_tiles = g_size * per_head;

  if (threadIdx.x == 0) {
    mbar_init(&own_full, 1);
#pragma unroll
    for (int i = 0; i < KV_STAGES; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes, lane 0's with the TMA bytes
      mbar_init(&empty[i], TC_CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    // ---- producer warpgroup: one warp; lane 0 issues every TMA copy, and
    // the warp stages each query tile's lse (times log2 e) and Dsum with
    // plain loads (a TMA box over the (B, H, S) rows would start off 16-byte
    // alignment whenever S % 4 != 0) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x - TC_CONSUMERS;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(&own_full, 2 * L::OWN_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_4d(smem + p * L::OWN_PANEL, &tm_k, &own_full, p * PANEL, hk, k0, b);
          tma_load_4d(smem + L::A2_OFF + p * L::OWN_PANEL, &tm_v, &own_full, p * PANEL, hk, k0, b);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % KV_STAGES;
        const int head = hk * g_size + i / per_head;
        const int q0 = (qt0 + i % per_head) * KV_STREAM;
        mbar_wait(&empty[st], ((i / KV_STAGES) & 1) ^ 1);  // the first round passes at once
        float* rows = reinterpret_cast<float*>(smem + L::ROWS_OFF + st * L::ROW_VALUES * 4);
        const int64_t row0 = (static_cast<int64_t>(b) * h + head) * s + q0;  // lse's (B, H, S) order
#pragma unroll
        for (int r = lane; r < KV_STREAM; r += 32) {
          const bool in = q0 + r < s;
          rows[r] = in ? lse[row0 + r] * LOG2E : 0.0f;
          rows[KV_STREAM + r] = in ? dsum[row0 + r] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * L::STREAM_BYTES);
          uint8_t* qd = smem + L::B1_OFF + st * L::STREAM_BYTES;
          uint8_t* dod = smem + L::B2_OFF + st * L::STREAM_BYTES;
#pragma unroll
          for (int p = 0; p < L::PANELS; ++p) {
            tma_load_4d(qd + p * L::STREAM_PANEL, &tm_q, &full[st], p * PANEL, head, q0, b);
            tma_load_4d(dod + p * L::STREAM_PANEL, &tm_do, &full[st], p * PANEL, head, q0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    // Each query tile: S^T = K Q^T and dP^T = V dO^T (one async wgmma
    // group); P^T and dS^T in fp32 registers, rounded to bf16 fragments;
    // dV += P^T dO and dK += dS^T Q (a second group); release the stage.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    constexpr int NS = KV_STREAM / 2;  // score registers a thread (m64 x n64)
    constexpr int NO = L::DP / 2;      // accumulator registers a thread (m64 x nDP)
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int wg_k0 = k0 + wg * 64;
    const int key0 = wg_k0 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and key0 + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    float dk_acc[NO], dv_acc[NO];
    zero(dk_acc);
    zero(dv_acc);
    const uint32_t k_base = smem_u32(smem) + wg * 64 * ROW_BYTES;
    const uint32_t v_base = smem_u32(smem + L::A2_OFF) + wg * 64 * ROW_BYTES;
    mbar_wait(&own_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % KV_STAGES;
      const int q0 = (qt0 + i % per_head) * KV_STREAM;
      mbar_wait(&full[st], (i / KV_STAGES) & 1);
      // No live pair for this warpgroup's keys: all >= T, or (causal) every
      // query of the tile before the first key's diagonal.
      const bool dead = wg_k0 >= t || (causal && min(q0 + KV_STREAM, s) - 1 + offset < wg_k0);
      if (!dead) {
        const uint32_t q_base = smem_u32(smem + L::B1_OFF + st * L::STREAM_BYTES);
        const uint32_t do_base = smem_u32(smem + L::B2_OFF + st * L::STREAM_BYTES);
        const float* lse_s = reinterpret_cast<const float*>(smem + L::ROWS_OFF + st * L::ROW_VALUES * 4);
        const float* dsum_s = lse_s + KV_STREAM;  // lse_s holds lse * log2 e
        float sc[NS], dp[NS];
        wgmma_fence();
        mma_rows<D, KV_STREAM>(sc, k_base, L::OWN_PANEL, q_base, L::STREAM_PANEL);   // S^T = K Q^T
        mma_rows<D, KV_STREAM>(dp, v_base, L::OWN_PANEL, do_base, L::STREAM_PANEL);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_all(sc);
        reg_fence_all(dp);
        // Only a tile that S or the causal diagonal cuts is masked: a masked
        // score is -inf, so its P is 0 and its dS 0. Keys >= T are never
        // stored.
        if (q0 + KV_STREAM > s || (causal && q0 + offset < wg_k0 + 63)) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (!live_pair(q0 + col0 + acc_col(j), key0 + acc_row(j), s, t, offset, causal)) sc[j] = -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < NS; j += 2) {  // registers j, j + 1: queries q0 + c, q0 + c + 1
          const int c = col0 + acc_col(j);
          const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 ds = *reinterpret_cast<const float2*>(dsum_s + c);
          sc[j] = ex2(fmaf(sc[j], scale_log2, -l.x));
          sc[j + 1] = ex2(fmaf(sc[j + 1], scale_log2, -l.y));
          dp[j] = sc[j] * (dp[j] - ds.x);
          dp[j + 1] = sc[j + 1] * (dp[j + 1] - ds.y);
        }
        uint32_t pa[KV_STREAM / 16][4], dsa[KV_STREAM / 16][4];
        to_fragments<KV_STREAM>(pa, sc);
        to_fragments<KV_STREAM>(dsa, dp);
        wgmma_fence();
        mma_cols<L::DP, KV_STREAM>(dv_acc, pa, do_base, L::STREAM_PANEL);  // dV += P^T dO
        mma_cols<L::DP, KV_STREAM>(dk_acc, dsa, q_base, L::STREAM_PANEL);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_all(dv_acc);
        reg_fence_all(dk_acc);
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // Epilogue: dK = acc * scale, dV = acc, bf16 pairs; no row >= T and no
    // column >= D (the zero padding of D = 112) is stored.
    const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
    bf16* dkb = dk + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;
    bf16* dvb = dv + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int r = key0 + acc_row(j);
      const int c = col0 + acc_col(j);
      if (8 * (j / 4) < D && r < t) {
        *reinterpret_cast<uint32_t*>(dkb + r * kv_stride + c) = pack_bf16(dk_acc[j] * scale, dk_acc[j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + r * kv_stride + c) = pack_bf16(dv_acc[j], dv_acc[j + 1]);
      }
    }
  }
}

// dQ pass, grid (ceil(S / 128), H, B): a block owns 128 query rows of one
// head, 64 a consumer warpgroup, and walks the 128-key tiles up to its
// causal limit; the query tiles nearest the diagonal's end launch first.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dq, int s,
                   int t, int h, int hkv, int causal, float scale) {
  using L = QSmem<D>;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t own_full, full[Q_STAGES], empty[Q_STAGES];
  uint8_t* smem = align_1024(tc_smem);

  const int nq = (s + Q_OWN - 1) / Q_OWN;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * Q_OWN;  // longest tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = head / (h / hkv);
  const int offset = t - s;
  const int n_tiles = key_tiles(q0, Q_OWN, s, t, offset, causal, Q_STREAM);

  if (threadIdx.x == 0) {
    mbar_init(&own_full, 1);
#pragma unroll
    for (int i = 0; i < Q_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == TC_CONSUMERS) {
      mbar_expect_tx(&own_full, 2 * L::OWN_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_4d(smem + p * L::OWN_PANEL, &tm_q, &own_full, p * PANEL, head, q0, b);
        tma_load_4d(smem + L::A2_OFF + p * L::OWN_PANEL, &tm_do, &own_full, p * PANEL, head, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % Q_STAGES;
        mbar_wait(&empty[st], ((i / Q_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::STREAM_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_4d(smem + L::B1_OFF + st * L::STREAM_BYTES + p * L::STREAM_PANEL, &tm_k, &full[st], p * PANEL,
                      hk, i * Q_STREAM, b);
          tma_load_4d(smem + L::B2_OFF + st * L::STREAM_BYTES + p * L::STREAM_PANEL, &tm_v, &full[st], p * PANEL,
                      hk, i * Q_STREAM, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    // Each key tile: S = Q K^T and dP = dO V^T (one async wgmma group); P
    // and dS in fp32 registers, dS rounded to bf16 fragments; dQ += dS K
    // (a second group); release the stage.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    constexpr int NS = Q_STREAM / 2;
    constexpr int NO = L::DP / 2;
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int wg_q0 = q0 + wg * 64;
    const int row0 = wg_q0 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    const int64_t lrow = (static_cast<int64_t>(b) * h + head) * s;
    float lse2[2] = {0.0f, 0.0f}, dsum_r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r < s) {
        lse2[r] = lse[lrow + row0 + 8 * r] * LOG2E;
        dsum_r[r] = dsum[lrow + row0 + 8 * r];
      }
    }
    float dq_acc[NO];
    zero(dq_acc);
    const uint32_t q_base = smem_u32(smem) + wg * 64 * ROW_BYTES;
    const uint32_t do_base = smem_u32(smem + L::A2_OFF) + wg * 64 * ROW_BYTES;
    const int wg_first = wg_q0 + offset;                     // earliest query position of this warpgroup
    const int wg_last = min(wg_q0 + 64, s) - 1 + offset;     // and its latest
    mbar_wait(&own_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % Q_STAGES;
      const int k0 = i * Q_STREAM;
      mbar_wait(&full[st], (i / Q_STAGES) & 1);
      // No live pair for this warpgroup's rows: all >= S, or (causal) the
      // tile's first key past the last row's diagonal.
      const bool dead = wg_q0 >= s || (causal && k0 > wg_last);
      if (!dead) {
        const uint32_t k_base = smem_u32(smem + L::B1_OFF + st * L::STREAM_BYTES);
        const uint32_t v_base = smem_u32(smem + L::B2_OFF + st * L::STREAM_BYTES);
        float sc[NS], dp[NS];
        wgmma_fence();
        mma_rows<D, Q_STREAM>(sc, q_base, L::OWN_PANEL, k_base, L::STREAM_PANEL);   // S = Q K^T
        mma_rows<D, Q_STREAM>(dp, do_base, L::OWN_PANEL, v_base, L::STREAM_PANEL);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_all(sc);
        reg_fence_all(dp);
        // Only a tile that T or the causal diagonal cuts is masked (a masked
        // score is -inf: P 0, dS 0); rows >= S are never stored.
        if (k0 + Q_STREAM > t || (causal && k0 + Q_STREAM - 1 > wg_first)) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (!live_pair(row0 + acc_row(j), k0 + col0 + acc_col(j), s, t, offset, causal)) sc[j] = -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int r = (j / 2) % 2;
          dp[j] = ex2(fmaf(sc[j], scale_log2, -lse2[r])) * (dp[j] - dsum_r[r]);
        }
        uint32_t dsa[Q_STREAM / 16][4];
        to_fragments<Q_STREAM>(dsa, dp);
        wgmma_fence();
        mma_cols<L::DP, Q_STREAM>(dq_acc, dsa, k_base, L::STREAM_PANEL);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence_all(dq_acc);
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    const int64_t q_stride = static_cast<int64_t>(h) * D;
    bf16* dqb = dq + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * D;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int r = row0 + acc_row(j);
      if (8 * (j / 4) < D && r < s)
        *reinterpret_cast<uint32_t*>(dqb + r * q_stride + col0 + acc_col(j)) =
            pack_bf16(dq_acc[j] * scale, dq_acc[j + 1] * scale);
    }
  }
}

// ---- FMA variant (fp32 at every D, bf16 at D in {16, 32}) ---------------------

constexpr int F_THREADS = 256;    // two warpgroups, each 8 row lanes x 16 column lanes
constexpr int F_OWN = 64;         // own rows a block (keys, or queries)
constexpr int F_STREAM = 128;     // streamed rows a tile (queries, or keys)
constexpr int F_AW = 16;          // columns of d a score-product chunk
constexpr int F_LDS = F_OWN + 4;  // row stride of the transposed fp32 P and dS tiles

// Shared memory of one pass, from a 1024-byte aligned base: the ring's
// STAGES chunks (two parts each, one a warpgroup), the two own tiles
// (64 x D each, dense), the transposed fp32 P and dS tiles, the mbarriers.
template <typename T, int D>
struct FmaBwd {
  static constexpr int E = static_cast<int>(sizeof(T));
  static constexpr int RB = F_AW * E;                   // bytes of a score-chunk row: its swizzle span
  static constexpr int NA = D / F_AW;                   // score chunks a tile
  static constexpr int DP = D == 112 ? 128 : D;         // gradient chunk row (TMA zero-fills past D)
  static constexpr int CW = DP / 16;                    // accumulator columns a thread
  static constexpr int A_BYTES = F_STREAM * F_AW * E;  // a warpgroup's score chunk: 128 rows x 16 columns
  // Streamed rows of a warpgroup's gradient chunk, and the ring's stages:
  // 32 and 3, but 16 and 4 for fp32 at D 128, where 3 stages of 32 rows
  // would not fit beside the own tiles (fewer, larger chunks need fewer
  // barriers: 3 % of the backward at D 112, PERF.md).
  static constexpr int BR = E == 4 && D == 128 ? 16 : 32;
  static constexpr int STAGES = BR == 32 ? 3 : 4;
  static constexpr int B_BYTES = BR * DP * E;           // a warpgroup's gradient chunk: BR rows x DP
  static constexpr int PART = ((A_BYTES > B_BYTES ? A_BYTES : B_BYTES) + 1023) / 1024 * 1024;
  static constexpr int OWN_TILE = F_OWN * D * E;
  static constexpr int S_TILE = 4 * F_STREAM * F_LDS;  // one transposed fp32 tile
  // + the mbarriers (room for 4) and 1024 bytes to align the base
  static constexpr size_t bytes() { return STAGES * 2 * PART + 2 * OWN_TILE + 2 * S_TILE + 32 + 1024; }
  static_assert(bytes() <= 232448, "one block's shared memory must fit the SM's 227 KB");
};

// One pass of the FMA backward. A block owns 64 rows of one (batch, head):
// keys of a KV head (KV, the dK/dV pass) or queries of a head (the dQ
// pass), staged once as A0 = K, A1 = V (or Q, dO). It walks 128-row
// streamed tiles (the G heads' query tiles, or the key tiles) in loop order.
// Warpgroup w computes its 8 x 8 patch of X_w = A_w B_w^T from score chunks
// of B0 = Q, B1 = dO (or K, V); warpgroup 0 turns X_0 into P and writes it,
// warpgroup 1 then turns X_1 into dS = P * (X_1 - Dsum) and writes it, both
// transposed in shared memory. Gradient chunks then stream rows of the
// products' right operands: warpgroup 0 sums dV += P^T dO and warpgroup 1
// dK += dS^T Q (KV); in the dQ pass both sum dQ += dS K, warpgroup w over
// keys 64 w .. 64 w + 63 of each tile, added in that order at the end.
// The maps: own0, own1 (boxes of 64 rows x D), a0, a1 (128 rows x 16
// columns, swizzled), b0, b1 (BR rows x DP).
template <typename T, int D, bool KV>
__global__ void __launch_bounds__(F_THREADS, 1)
flash_bwd_fma_kernel(const __grid_constant__ CUtensorMap tm_own0, const __grid_constant__ CUtensorMap tm_own1,
                     const __grid_constant__ CUtensorMap tm_a0, const __grid_constant__ CUtensorMap tm_a1,
                     const __grid_constant__ CUtensorMap tm_b0, const __grid_constant__ CUtensorMap tm_b1,
                     const float* __restrict__ lse, const float* __restrict__ dsum, T* __restrict__ d1,
                     T* __restrict__ d2, int s, int t, int h, int hkv, int causal, float scale) {
  using L = FmaBwd<T, D>;
  constexpr int CW = L::CW;
  constexpr int G = CW < 4 ? CW : 4;
  constexpr int NB = (KV ? F_STREAM : F_STREAM / 2) / L::BR;  // gradient chunks a tile
  constexpr int CPT = L::NA + NB;                            // chunks a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring = align_1024(smem_raw);                                                  // L::STAGES x [2][PART]
  T* own = reinterpret_cast<T*>(ring + L::STAGES * 2 * L::PART);                          // [2][F_OWN][D]
  float* pw = reinterpret_cast<float*>(ring + L::STAGES * 2 * L::PART + 2 * L::OWN_TILE);  // [F_STREAM][F_LDS] P
  float* dsw = pw + F_STREAM * F_LDS;                                                    // [F_STREAM][F_LDS] dS
  uint64_t* full = reinterpret_cast<uint64_t*>(dsw + F_STREAM * F_LDS);

  // Blocks run tile-major (every head and batch of one own tile, then the
  // next), the tiles with the most streamed tiles first: key tile 0 (KV), or
  // the query tiles nearest the causal diagonal's end.
  const int g_size = h / hkv;
  const int heads = KV ? hkv : h;
  const int n_own_tiles = ((KV ? t : s) + F_OWN - 1) / F_OWN;
  const int hb = static_cast<int>(gridDim.x) / n_own_tiles;  // heads x batch
  const int tile = static_cast<int>(blockIdx.x) / hb;
  const int head_own = static_cast<int>(blockIdx.x) % hb % heads;  // KV: the KV head; dQ: the query head
  const int b = static_cast<int>(blockIdx.x) % hb / heads;
  const int offset = t - s;
  const int wg = threadIdx.x >> 7;
  const int ty = (threadIdx.x >> 4) & 7;  // own rows ty + 8 i
  const int tx = threadIdx.x & 15;        // streamed rows tx + 16 j; accumulator columns lane_col<CW>(tx, c)
  const int key = swz_key<L::RB>(tx);
  const int n_stream = KV ? s : t;
  const int own0 = (KV ? tile : n_own_tiles - 1 - tile) * F_OWN;
  const int hk = KV ? head_own : head_own / g_size;
  const float c2 = scale * LOG2E;
  const float* stat = wg == 0 ? lse : dsum;  // warpgroup 0 needs lse, 1 Dsum

  // Streamed tiles: per head, the query tiles from the first with a live
  // pair (KV), or the key tiles up to the causal limit.
  const int nst = (n_stream + F_STREAM - 1) / F_STREAM;
  const int first = KV ? min(first_query_tile(own0, offset, causal, F_STREAM), nst) : 0;
  const int per = KV ? nst - first : key_tiles(own0, F_OWN, s, t, offset, causal, F_STREAM);
  const int n_tiles = KV ? g_size * per : per;
  auto tile_head = [&](int ti) { return KV ? hk * g_size + ti / per : head_own; };
  auto tile_row = [&](int ti) { return KV ? (first + ti % per) * F_STREAM : ti * F_STREAM; };

  // The chunks in walk order, issued by thread 0: for each tile, score
  // chunk j < NA (columns 16 j .. 16 j + 15 of its 128 rows of B0 and B1),
  // then gradient chunk j - NA (BR rows of dO and of Q at the same position,
  // or BR rows of K for each warpgroup's half); the own tiles come with
  // chunk 0. `load` is called once for each chunk, in order: its cursor
  // (the chunk within the tile, the tile's first row, the streamed head)
  // steps without a division.
  int ld_j = 0, ld_row = first * F_STREAM, ld_head = KV ? hk * g_size : hk;
  auto load = [&](int n) {
    const int st = n % L::STAGES;
    uint8_t* dst = ring + st * 2 * L::PART;
    if (ld_j < L::NA) {
      mbar_expect_tx(&full[st], 2 * L::A_BYTES + (n == 0 ? 2 * L::OWN_TILE : 0));
      if (n == 0) {
        tma_load_4d(own, &tm_own0, &full[st], 0, head_own, own0, b);
        tma_load_4d(own + F_OWN * D, &tm_own1, &full[st], 0, head_own, own0, b);
      }
      tma_load_4d(dst, &tm_a0, &full[st], ld_j * F_AW, ld_head, ld_row, b);
      tma_load_4d(dst + L::PART, &tm_a1, &full[st], ld_j * F_AW, ld_head, ld_row, b);
    } else {
      const int r0 = ld_row + (ld_j - L::NA) * L::BR;
      mbar_expect_tx(&full[st], 2 * L::B_BYTES);
      tma_load_4d(dst, &tm_b0, &full[st], 0, ld_head, r0, b);
      tma_load_4d(dst + L::PART, &tm_b1, &full[st], 0, ld_head, KV ? r0 : r0 + F_STREAM / 2, b);
    }
    if (++ld_j == CPT) {  // the next tile: the next row block, or (KV) the next head's first
      ld_j = 0;
      ld_row += F_STREAM;
      if (KV && ld_row >= nst * F_STREAM) {
        ld_row = first * F_STREAM;
        ++ld_head;
      }
    }
  };
  const int n_chunks = n_tiles * CPT;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < L::STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int n = 0; n < L::STAGES - 1; ++n)
      if (n < n_chunks) load(n);
  }
  // The next chunk, once its bytes have landed. The barrier first retires
  // the chunk before it, whose stage thread 0 then refills.
  int n_next = 0;
  auto next = [&]() -> const T* {
    __syncthreads();
    if (threadIdx.x == 0 && n_next + L::STAGES - 1 < n_chunks) load(n_next + L::STAGES - 1);
    mbar_wait(&full[n_next % L::STAGES], (n_next / L::STAGES) & 1);
    return reinterpret_cast<const T*>(ring + (n_next++ % L::STAGES) * 2 * L::PART);
  };

  float acc[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int c0 = tile_row(ti);
    float x[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) x[i][j] = 0.0f;
#pragma unroll 1
    for (int a = 0; a < L::NA; ++a) {
      const T* ch = next();
      patch_dot<T, F_AW, D, 8, L::RB>(x, own + (wg * F_OWN + ty) * D + a * F_AW,
                                      ch + wg * L::PART / L::E + tx * F_AW, key);
    }

    // lse * log2(e) (warpgroup 0) or Dsum (1) of each streamed column j (KV)
    // or own row i (dQ), read after the products so that they hold no
    // registers during them.
    float st[8];
    const int64_t row0 = (static_cast<int64_t>(b) * h + tile_head(ti)) * s;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = KV ? c0 + tx + 16 * e : own0 + ty + 8 * e;
      st[e] = r < s ? stat[row0 + r] * (wg == 0 ? LOG2E : 1.0f) : 0.0f;
    }
    // Only tiles that the causal diagonal, S or T cut are masked. The
    // previous tile's readers of pw and dsw passed this tile's barriers.
    const int q_first = KV ? c0 : own0, q_rows = KV ? F_STREAM : F_OWN;
    const int k_first = KV ? own0 : c0, k_rows = KV ? F_OWN : F_STREAM;
    const bool edge = q_first + q_rows > s || k_first + k_rows > t ||
                      (causal && k_first + k_rows - 1 > q_first + offset);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float p = ex2(fmaf(x[i][j], c2, -(KV ? st[j] : st[i])));
          if (edge) {
            const int own_i = own0 + ty + 8 * i, col = c0 + tx + 16 * j;
            if (!live_pair(KV ? col : own_i, KV ? own_i : col, s, t, offset, causal)) p = 0.0f;
          }
          x[i][j] = p;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* dst = pw + (tx + 16 * j) * F_LDS + ty * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4][j], x[5][j], x[6][j], x[7][j]);
      }
    }
    __syncthreads();  // P is in pw
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[8];
        const float* src = pw + (tx + 16 * j) * F_LDS + ty * 8;
        lds<4>(src, p);
        lds<4>(src + 4, p + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i][j] = p[i] * (x[i][j] - (KV ? st[j] : st[i]));
        float* dst = dsw + (tx + 16 * j) * F_LDS + ty * 8;
        *reinterpret_cast<float4*>(dst) = make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4][j], x[5][j], x[6][j], x[7][j]);
      }
    }

    // The gradient products (the first chunk's barrier publishes dS).
    const float* grad = KV && wg == 0 ? pw : dsw;
#pragma unroll 1
    for (int bb = 0; bb < NB; ++bb) {
      const T* ch = next();
      const int cb = (KV ? 0 : wg * F_STREAM / 2) + bb * L::BR;
      rows_dot<T, L::BR, F_LDS, L::DP, CW>(acc, grad + cb * F_LDS + ty * 8, ch + wg * L::PART / L::E + G * tx);
    }
  }

  const int64_t q_stride = static_cast<int64_t>(h) * D;
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  float vals[CW];
  if constexpr (KV) {  // warpgroup 0 stores dV, 1 stores dK * scale
    const float mul = wg == 0 ? 1.0f : scale;
    T* dst = wg == 0 ? d2 : d1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = own0 + ty + 8 * i;
      if (r >= t) continue;
#pragma unroll
      for (int c = 0; c < CW; ++c) vals[c] = acc[i][c] * mul;
      store_cols<T, D, CW>(dst + (static_cast<int64_t>(b) * t + r) * kv_stride + static_cast<int64_t>(hk) * D, tx,
                           vals);
    }
  } else {  // dQ = (warpgroup 0's sum + warpgroup 1's) * scale, stored by warpgroup 0
    const int lane = threadIdx.x & 127;
    __syncthreads();  // every gradient read of dsw is done: pw holds warpgroup 1's sums
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) pw[(i * CW + c) * 128 + lane] = acc[i][c];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = own0 + ty + 8 * i;
        if (r >= s) continue;
#pragma unroll
        for (int c = 0; c < CW; ++c) vals[c] = (acc[i][c] + pw[(i * CW + c) * 128 + lane]) * scale;
        store_cols<T, D, CW>(d1 + (static_cast<int64_t>(b) * s + r) * q_stride + static_cast<int64_t>(head_own) * D,
                             tx, vals);
      }
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

// Launch one FMA pass `kernel` on own tiles x heads x B blocks with `smem`
// bytes, reading its maps.
template <typename T, typename K>
int launch_pass(K kernel, size_t smem, int tiles, int heads, const Args& a, const CUtensorMap (&m)[6], void* d1,
                void* d2) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(tiles) * heads * a.b;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), F_THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<T*>(d1), static_cast<T*>(d2), a.s, a.t, a.h, a.hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The prologue, then the two wgmma passes, each on its own tensor maps: the
// dK/dV pass reads K, V in boxes of 128 own rows and Q, dO in boxes of 64
// streamed rows; the dQ pass
// reads Q, dO in boxes of 128 own rows and K, V in boxes of 128 streamed
// rows. kernels/flash_attention.py::bwd_plan mirrors this geometry.
template <int D>
int launch_tc(const Args& a) {
  int err = launch_dsum<bf16, D>(a);
  if (err) return err;
  CUtensorMap q_s, do_s, k_o, v_o;
  err = make_map(&q_s, a.q, a.b, a.s, a.h, D, KV_STREAM);
  if (!err) err = make_map(&do_s, a.dout, a.b, a.s, a.h, D, KV_STREAM);
  if (!err) err = make_map(&k_o, a.k, a.b, a.t, a.hkv, D, KV_OWN);
  if (!err) err = make_map(&v_o, a.v, a.b, a.t, a.hkv, D, KV_OWN);
  if (!err) err = set_smem(flash_bwd_kv_kernel<D>, KvSmem<D>::ALLOC);
  if (err) return err;
  flash_bwd_kv_kernel<D><<<dim3((a.t + KV_OWN - 1) / KV_OWN, a.hkv, a.b), TC_THREADS, KvSmem<D>::ALLOC, a.stream>>>(
      q_s, do_s, k_o, v_o, static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.s, a.t, a.h, a.hkv, a.causal, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  CUtensorMap q_o, do_o, k_s, v_s;
  err = make_map(&q_o, a.q, a.b, a.s, a.h, D, Q_OWN);
  if (!err) err = make_map(&do_o, a.dout, a.b, a.s, a.h, D, Q_OWN);
  if (!err) err = make_map(&k_s, a.k, a.b, a.t, a.hkv, D, Q_STREAM);
  if (!err) err = make_map(&v_s, a.v, a.b, a.t, a.hkv, D, Q_STREAM);
  if (!err) err = set_smem(flash_bwd_q_kernel<D>, QSmem<D>::ALLOC);
  if (err) return err;
  flash_bwd_q_kernel<D><<<dim3((a.s + Q_OWN - 1) / Q_OWN, a.h, a.b), TC_THREADS, QSmem<D>::ALLOC, a.stream>>>(
      q_o, do_o, k_s, v_s, static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dq), a.s, a.t, a.h, a.hkv, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The prologue, then the two FMA passes on grids of 64 own rows (keys of a
// KV head, then queries of a head), each on its own maps: own tiles in
// boxes of 64 rows x D, score chunks in boxes of 128 rows x 16 columns
// (swizzled), gradient chunks in boxes of BR rows x DP.
// kernels/flash_attention.py::fma_plan mirrors this geometry.
template <typename T, int D>
int launch_fma(const Args& a) {
  using L = FmaBwd<T, D>;
  int err = launch_dsum<T, D>(a);
  if (err) return err;
  constexpr CUtensorMapDataType type = map_type<T>();
  constexpr CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  // (pointer, seq, heads) of q and dout, and of k and v
  auto q_map = [&](CUtensorMap* m, const void* p, int cols, int rows, CUtensorMapSwizzle sw) {
    return make_map(m, p, type, L::E, a.b, a.s, a.h, D, cols, rows, sw);
  };
  auto kv_map = [&](CUtensorMap* m, const void* p, int cols, int rows, CUtensorMapSwizzle sw) {
    return make_map(m, p, type, L::E, a.b, a.t, a.hkv, D, cols, rows, sw);
  };
  constexpr CUtensorMapSwizzle sw = swizzle_of<L::RB>();
  CUtensorMap kv[6], q[6];  // own0, own1, a0, a1, b0, b1
  err = kv_map(&kv[0], a.k, D, F_OWN, none);
  if (!err) err = kv_map(&kv[1], a.v, D, F_OWN, none);
  if (!err) err = q_map(&kv[2], a.q, F_AW, F_STREAM, sw);
  if (!err) err = q_map(&kv[3], a.dout, F_AW, F_STREAM, sw);
  if (!err) err = q_map(&kv[4], a.dout, L::DP, L::BR, none);
  if (!err) err = q_map(&kv[5], a.q, L::DP, L::BR, none);
  if (!err) err = q_map(&q[0], a.q, D, F_OWN, none);
  if (!err) err = q_map(&q[1], a.dout, D, F_OWN, none);
  if (!err) err = kv_map(&q[2], a.k, F_AW, F_STREAM, sw);
  if (!err) err = kv_map(&q[3], a.v, F_AW, F_STREAM, sw);
  if (!err) err = kv_map(&q[4], a.k, L::DP, L::BR, none);
  if (!err) q[5] = q[4];
  if (err) return err;
  const size_t smem = L::bytes();
  err = launch_pass<T>(flash_bwd_fma_kernel<T, D, true>, smem, (a.t + F_OWN - 1) / F_OWN, a.hkv, a, kv, a.dk, a.dv);
  if (err) return err;
  return launch_pass<T>(flash_bwd_fma_kernel<T, D, false>, smem, (a.s + F_OWN - 1) / F_OWN, a.h, a, q, a.dq, nullptr);
}

}  // namespace

// q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, T, Hkv, D): contiguous,
// 16-byte aligned, one element type; lse (B, H, S) fp32 contiguous, the
// forward's; dsum (B, H, S) fp32 scratch. D in {16, 32, 64, 112, 128} for
// fp32 and bf16 (bf16 at 64, 112 and 128 on the tensor cores); H % Hkv == 0.
// Launches three kernels on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success), or -1 when the driver has no
// cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
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

// Dynamic shared memory one block of a tensor-core pass asks for at head_dim
// `d` (pass 0: dK/dV, 1: dQ; 0 if d is not served):
// kernels/flash_attention.py::bwd_plan computes the same numbers.
extern "C" int flash_attention_bwd_tc_smem_bytes(int d, int pass) {
  switch (d) {
    case 64: return pass ? QSmem<64>::ALLOC : KvSmem<64>::ALLOC;
    case 112: return pass ? QSmem<112>::ALLOC : KvSmem<112>::ALLOC;
    case 128: return pass ? QSmem<128>::ALLOC : KvSmem<128>::ALLOC;
    default: return 0;
  }
}

// Dynamic shared memory one block of an FMA pass asks for at head_dim `d`
// with `elem`-byte elements (4: fp32, 2: bf16; 0 where the pair is not
// served); both passes ask for the same: kernels/flash_attention.py::
// fma_plan computes the same number.
extern "C" int flash_attention_fma_smem_bytes(int d, int elem) {
  if (elem == 4) {
    switch (d) {
      case 16: return static_cast<int>(FmaBwd<float, 16>::bytes());
      case 32: return static_cast<int>(FmaBwd<float, 32>::bytes());
      case 64: return static_cast<int>(FmaBwd<float, 64>::bytes());
      case 112: return static_cast<int>(FmaBwd<float, 112>::bytes());
      case 128: return static_cast<int>(FmaBwd<float, 128>::bytes());
    }
  } else if (elem == 2) {
    switch (d) {
      case 16: return static_cast<int>(FmaBwd<bf16, 16>::bytes());
      case 32: return static_cast<int>(FmaBwd<bf16, 32>::bytes());
    }
  }
  return 0;
}
