// Forward GQA attention in bf16 on Hopper's tensor cores (wgmma + TMA), for
// head_dim 64, 112 and 128: out = softmax(Q K^T / sqrt(d), masked) V for q
// (B, S, H, D) and k, v (B, T, Hkv, D), fp32 statistics, out in bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) for bf16 at d in {64, 112, 128}; fp32, and
// bf16 at d in {16, 32}, stay on the FMA kernel in flash_attention.cu. The
// wrapper (kernels/flash_attention.py) picks one of the two before launch.
//
// Bound on an H100: at the serving shapes (causal, S = T = 512 and 4096,
// d = 128) the kernel does 2 * 2 * d flops per live (q, k) pair against
// reading Q, K, V and writing O once, so it is bound by operations, and only
// the bf16 tensor cores (989 TFLOP/s dense) come near that bound. What each
// part of the design does about it:
//
//   products  S = Q K^T is wgmma m64n128k16 with Q and K read from shared
//             memory through descriptors (both K-major, as stored); O += P V
//             takes P from registers as bf16 (the fp32 score fragment is
//             converted in place: the accumulator layout of S is the
//             register-A layout of the second product) and V from shared
//             memory with the transpose bit set. P rounded to bf16 before
//             the second product is what every tensor-core flash kernel does.
//   copies    Q, K and V are 4-D TMA tensor maps over the (B, T, Hkv, d)
//             layout, 128-byte swizzled (a 64-column box per panel, two
//             panels at d = 112 and 128); no transpose, no padding copy: TMA
//             fills rows past S or T with zeros, keys >= T are masked here,
//             and no output row >= S is written.
//   d = 112   (zamba2's heads) is computed natively, the cache unpadded: the
//             maps' innermost dim is 112 (rows of 224 bytes), so TMA fills
//             columns 112-127 of the second panel with zeros. Q K^T runs
//             7 k-steps of 16 columns and never reads them; P V runs at
//             N = 128 (wgmma's MN-major 128-byte-swizzled B spans whole
//             64-column panels), which gives 16 zero output columns that the
//             epilogue does not store. The scale is 1 / sqrt(112).
//   pipeline  K and V tiles live in a 3-stage ring in shared memory with
//             full (TMA bytes landed) and empty (both consumer warpgroups
//             done) mbarriers. One producer warp issues every copy; the two
//             consumer warpgroups compute. setmaxnreg moves registers from
//             the producer warpgroup (24) to the consumers (240). Inside a
//             consumer, tile i's softmax runs while the tensor cores do tile
//             i - 1's P V (S(i) and P(i-1) V(i-1) are issued as two async
//             wgmma groups; the softmax waits for the first only). Between
//             the consumers, two named barriers hand the tensor cores back
//             and forth ("ping-pong"): one warpgroup issues its products
//             while the other runs its softmax.
//   tiles     a block owns a 128-row query tile of one (batch, head): two
//             consumer warpgroups of 64 rows, walking 128-key tiles. The
//             grid launches the query tiles nearest the causal diagonal's end
//             first, so the longest blocks start first.
//   softmax   row max and sum are reduced inside the wgmma accumulator layout
//             (4 threads share a row: two shuffles), ex2.approx on
//             log2e-prescaled scores; only tiles that the causal diagonal or
//             T cuts are masked; tiles wholly above the diagonal are never
//             loaded. A
//             masked score is -inf and its probability 0, so a row with no
//             live key ends as 0 / max(l, 1e-30) = 0.
//   lse       for training the caller passes an fp32 (B, H, S) buffer and
//             the epilogue stores each row's natural log-sum-exp once (the
//             backward recomputes the probabilities from it): the running
//             max is of raw scores and the sums are of 2^(s * scale_log2 -
//             m * scale_log2), so lse = (m * scale_log2 + log2 l) * ln 2,
//             with the reference's max(l, 1e-30) floor and its -1e30 for a
//             row with no live key. Serving passes null: no extra store.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below). The mbarrier, TMA and
// wgmma helpers are hopper.cuh's, shared with the backward's tensor-core
// passes; the tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links against the runtime only.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // keys per K/V tile
constexpr int STAGES = 3;        // K/V ring depth
constexpr int CONSUMERS = 256;   // two consumer warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NO_KEY_LSE = -1e30f;  // the reference's sentinel: a row with no live key

// Shared memory: the Q tile, then STAGES K tiles, then STAGES V tiles, each
// stored as ceil(D / 64) panels of (rows x 128 bytes), 1024-byte aligned (the
// period of the 128-byte swizzle). DP is D rounded up to whole panels: the
// width of the P V product and of the output registers.
template <int D>
struct Smem {
  static constexpr int PANELS = (D + PANEL - 1) / PANEL;
  static constexpr int DP = PANELS * PANEL;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int KV_PANEL = BK * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};

constexpr int NS = BK / 2;  // score registers per consumer thread (m64 x n128)

// S = Q K^T over d in 16-column steps (4 per 128-byte panel; 7 at d = 112,
// so the zero-filled columns are never read), issued asynchronously as one
// wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[NS], uint32_t q_base, uint32_t k_base) {
  wgmma_fence();
  mma_rows<D, BK>(sc, q_base, Smem<D>::Q_PANEL, k_base, Smem<D>::KV_PANEL);
  wgmma_commit();
}

// O += P V over a tile's keys in 16-row steps of V (MN-major: the transpose
// bit is set, LBO steps between the 64-column panels), one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Smem<D>::DP / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_base) {
  wgmma_fence();
  mma_cols<Smem<D>::DP, BK>(o, pa, v_base, Smem<D>::KV_PANEL);
  wgmma_commit();
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other: a warpgroup issues its wgmma groups only on its
// turn, so one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(CONSUMERS) : "memory");
}

// Online softmax of one score tile in place (sc becomes P in fp32): masks
// keys >= T and, when causal, keys past each row's diagonal, but only when
// the tile is cut by one of them; updates the running max m and this
// thread's row sums l, and returns in corr the factor the output rows must
// be rescaled by. The 4 lanes of a row reduce its max by two shuffles.
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             bool cut, int k0, int t, int causal, int q_pos0, int col0,
                                             float scale_log2) {
  if (cut) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = k0 + col0 + acc_col(j);
      if (col >= t || (causal && col > q_pos0 + acc_row(j))) sc[j] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * scale_log2;  // no live key yet: p = 0, not NaN
    corr[r] = ex2(m[r] * scale_log2 - ms[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float p = ex2(fmaf(sc[j], scale_log2, -ms[(j / 2) % 2]));
    sc[j] = p;
    l[(j / 2) % 2] += p;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, int s, int t, int h, int hkv, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES], kv_empty[STAGES];
  uint8_t* smem = align_1024(smem_raw);

  const int nq = (s + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;  // longest tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = head / (h / hkv);
  const int offset = t - s;
  // Key tiles this query tile needs: all of them, or (causal) up to the
  // last live query's position; none when every query precedes key 0.
  const int nk = (t + BK - 1) / BK;
  int n_tiles = nk;
  if (causal) {
    const int q_last = min(q0 + BQ, s) - 1 + offset;
    n_tiles = q_last < 0 ? 0 : min(q_last / BK + 1, nk);
  }

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&kv_empty[i], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&q_full, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) tma_load_4d(smem + p * L::Q_PANEL, &tm_q, &q_full, p * PANEL, head, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        mbar_wait(&kv_empty[st], ((i / STAGES) & 1) ^ 1);  // the first round passes at once
        uint8_t* kd = smem + L::K_OFF + st * L::KV_BYTES;
        uint8_t* vd = smem + L::V_OFF + st * L::KV_BYTES;
        mbar_expect_tx(&k_full[st], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load_4d(kd + p * L::KV_PANEL, &tm_k, &k_full[st], p * PANEL, hk, i * BK, b);
        mbar_expect_tx(&v_full[st], L::KV_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          tma_load_4d(vd + p * L::KV_PANEL, &tm_v, &v_full[st], p * PANEL, hk, i * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    // Tile i's softmax runs while the tensor cores do tile i - 1's P V:
    //   on this warpgroup's turn: S(i) = Q K(i)^T; O += P(i-1) V(i-1)
    //     (two async wgmma groups), then pass the turn
    //   wait for S(i); softmax(i) -> P(i), corr(i)
    //   wait for P(i-1) V(i-1); release stage i-1; O *= corr(i)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    constexpr int NO = L::DP / 2;  // output registers per thread (m64 x nDP)
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const int wg_first = q0 + wg * 64 + offset;  // earliest query position of this warpgroup

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max of raw scores
    float l[2] = {0.0f, 0.0f};            // this thread's part of the row sums
    float corr[2];
    float sc[NS];
    uint32_t pa[BK / 16][4];

    const uint32_t q_base = smem_u32(smem) + wg * 64 * ROW_BYTES;
    const uint32_t k_base = smem_u32(smem + L::K_OFF);
    const uint32_t v_base = smem_u32(smem + L::V_OFF);
    // Only the tiles that T or the causal diagonal cuts need the mask.
    auto cut = [&](int k0) { return k0 + BK > t || (causal && k0 + BK - 1 > wg_first); };
    mbar_wait(&q_full, 0);

    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);  // warpgroup 0 goes first
      turn_wait(wg);
      mbar_wait(&k_full[0], 0);
      issue_qk<D>(sc, q_base, k_base);
      turn_pass(wg);
      wgmma_wait<0>();
      reg_fence_all(sc);
      softmax_tile(sc, m, l, corr, cut(0), 0, t, causal, row0 + offset, col0, scale_log2);
      to_fragments<BK>(pa, sc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      turn_wait(wg);
      mbar_wait(&k_full[st], (i / STAGES) & 1);
      issue_qk<D>(sc, q_base, k_base + st * L::KV_BYTES);
      mbar_wait(&v_full[prev], ((i - 1) / STAGES) & 1);
      issue_pv<D>(o, pa, v_base + prev * L::KV_BYTES);
      turn_pass(wg);
      wgmma_wait<1>();  // S(i) is done; P(i-1) V(i-1) may still run
      reg_fence_all(sc);
      softmax_tile(sc, m, l, corr, cut(i * BK), i * BK, t, causal, row0 + offset, col0, scale_log2);
      wgmma_wait<0>();
      reg_fence_all(o);
      if (lane == 0) mbar_arrive(&kv_empty[prev]);
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] *= corr[(j / 2) % 2];
      reg_fence_all(o);
      to_fragments<BK>(pa, sc);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % STAGES;
      turn_wait(wg);
      mbar_wait(&v_full[last], ((n_tiles - 1) / STAGES) & 1);
      issue_pv<D>(o, pa, v_base + last * L::KV_BYTES);
      if (wg == 0) turn_pass(wg);  // each warpgroup passes as often as the other waits
      wgmma_wait<0>();
      reg_fence_all(o);
    }

    // Finalise: row sums across the 4 lanes, the reference's 1e-30 floor.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
    }
    if (lse != nullptr && lane % 4 == 0) {  // the 4 lanes of a row hold the same m and l
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < s)
          lse[(static_cast<int64_t>(b) * h + head) * s + row] =
              m[r] == -INFINITY ? NO_KEY_LSE : (m[r] * scale_log2 + log2f(fmaxf(l[r], 1e-30f))) * LN2;
      }
    }
    const int64_t row_stride = static_cast<int64_t>(h) * D;
    __nv_bfloat16* ob = out + static_cast<int64_t>(b) * s * row_stride + static_cast<int64_t>(head) * D;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int r = row0 + acc_row(j);
      if (8 * (j / 4) < D && r < s) {  // columns D .. DP - 1 are padding
        const float f = inv[(j / 2) % 2];
        *reinterpret_cast<__nv_bfloat162*>(ob + r * row_stride + col0 + acc_col(j)) =
            __floats2bfloat162_rn(o[j] * f, o[j + 1] * f);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s, int t, int h,
           int hkv, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, b, s, h, D, BQ);
  if (err == 0) err = make_map(&tk, k, b, t, hkv, D, BK);
  if (err == 0) err = make_map(&tv, v, b, t, hkv, D, BK);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                Smem<D>::ALLOC);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_tc_kernel<D><<<grid, THREADS, Smem<D>::ALLOC, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), s, t, h, hkv, causal,
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D): contiguous bf16,
// 16-byte aligned; D in {64, 112, 128}; H % Hkv == 0; lse null or fp32
// (B, H, S). Launches on `stream` and returns cudaGetLastError() (0 on
// success), -1 when the driver has no cuTensorMapEncodeTiled, -2 when it
// refuses a tensor map.
extern "C" int flash_attention_tc_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int b,
                                       int s, int t, int h, int hkv, int d, int causal, float scale,
                                       cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
    case 112: return launch<112>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
    case 128: return launch<128>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block asks for at head_dim `d` (0 if d is not
// served): kernels/flash_attention.py::tc_plan computes the same number.
extern "C" int flash_attention_tc_smem_bytes(int d) {
  switch (d) {
    case 64: return Smem<64>::ALLOC;
    case 112: return Smem<112>::ALLOC;
    case 128: return Smem<128>::ALLOC;
    default: return 0;
  }
}
