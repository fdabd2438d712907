// Forward GQA attention with a blocked online softmax (FlashAttention
// semantics): out = softmax(Q K^T * scale, masked) V, for q (B, S, H, D) and
// k, v (B, T, Hkv, D), fp32 or bf16 in, fp32 statistics, out in q's type.
// It serves fp32 at every D and bf16 at D in {16, 32}; bf16 at D in
// {64, 112, 128} goes to the tensor-core kernel in flash_attention_tc.cu (the
// wrapper, kernels/flash_attention.py, picks one before launch).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) for those types. That kernel walks a
// grid whose fourth, sequential axis visits the kv blocks and carries
// (acc, m, l) in VMEM scratch; its wrapper pads S and T up to the block
// sizes. Here blocks run in parallel and in no order, so the kv loop lives
// inside the block.
//
// Bound on an H100: causal prefill at the serving shapes does 2 * 2 * d
// flops per live (q, k) pair against reading Q, K, V and writing O once, far
// above the card's ridge point at S = T >= 512: it is bound by operations.
// Its products are IEEE fp32 FFMAs (no tensor cores, no TF32; bf16 inputs
// are widened on the way to the registers), so its bound is the CUDA cores'
// 67 TFLOP/s. An SM issues 128 FFMA lanes a clock but serves 128 bytes of
// shared memory a clock, so the design is an SGEMM's:
//
//   grid     ceil(S/128) x H x B blocks, one 128-row query tile of one head
//            each, launched tile-major with the tiles nearest the causal
//            diagonal's end first (the longest blocks start first); one
//            block of 256 threads per SM (shared memory).
//   tiles    a thread (row lane ty, column lane tx, 16 x 16) owns query rows
//            ty + 16 i and keys tx + 16 j (i, j < 8): an 8 x 8 patch of each
//            128 x 128 score tile, read as 16-byte shared loads of 4
//            columns of d (16 loads for 256 FFMAs), and 8 rows x D / 16
//            columns of the output accumulator (at D 112 a thread computes
//            8 columns as at 128; the 16 past 112 are never stored).
//   copies   TMA into a 4-stage ring of chunks that the block walks in
//            order: for each key tile, K in boxes of 128 keys x 32 columns
//            of d (16 at D 112 and 16), stored with the TMA swizzle of the
//            row's span so that the 16 rows a warp reads at once hit
//            distinct banks, then V in boxes of 32 keys x D (dense, zero-
//            filled past D and T). Thread 0 issues them; each chunk is
//            waited for on its stage's mbarrier after one block barrier,
//            which also frees the chunk before it, so 3 are in flight while
//            the FFMAs run and no other thread spends an instruction on a
//            copy (per-thread cp.async copies cost 9 % of the forward and
//            13 % of the backward: PERF.md). Q (128 x D, dense) comes with
//            the first chunk.
//   softmax  in the exp2 domain with scale * log2(e) folded into one FMA;
//            the row max is reduced over the 16 column lanes by shuffles,
//            the row sum kept per lane and reduced once at the end. Masks
//            are evaluated only on key tiles that the causal diagonal or T
//            cuts; tiles wholly above the diagonal are never loaded.
//   P        written once to shared memory, transposed (keys x rows, each
//            thread's 8 rows adjacent), where O += P V reads 8 rows of a key
//            in two 16-byte loads beside D / 16 values of V.
//
// The KV head of query head h is h / (H / Hkv). The causal mask compares
// q_pos + (T - S) with k_pos; keys at or past T are masked and rows at or
// past S are zero-filled and never stored, so the wrapper pads nothing. A
// masked score is -inf before the exponential and its probability 0, so a
// row with no live key ends as 0 / max(l, 1e-30) = 0 with its max still the
// reference's -1e30 sentinel, never NaN. Rows are normalised once at the
// end with the reference's max(l, 1e-30) floor. When the caller passes an
// `lse` buffer (training: the backward recomputes the probabilities from
// it), each row's natural log-sum-exp m + log(max(l, 1e-30)) (-1e30 for a
// row with no live key) is stored there once, in (B, H, S) = (B, Hkv, G, S)
// order, by the row's first lane; serving passes null and stores nothing
// more. kernels/flash_attention.py::fma_plan mirrors this geometry.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <math.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

constexpr int RL = 16;           // row lanes: a thread's rows are RL apart
constexpr int BQ = 8 * RL;       // query rows a block
constexpr int BK = 128;          // keys a tile
constexpr int THREADS = 16 * RL; // RL row lanes x 16 column lanes
constexpr int VR = 32;           // keys a V chunk
constexpr int STAGES = 4;        // chunks in the ring
constexpr int LDP = BQ + 4;      // row stride of the transposed fp32 P tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, from a 1024-byte aligned base: the ring's STAGES chunks, Q
// (BQ x D, dense), the transposed fp32 P tile, the ring's mbarriers.
template <typename T, int D>
struct Fwd {
  static constexpr int E = static_cast<int>(sizeof(T));
  static constexpr int W = D % 32 == 0 ? 32 : 16;  // columns of d a K chunk
  static constexpr int RB = W * E;                 // bytes of a K chunk row: its swizzle span
  static constexpr int NKC = D / W;                // K chunks a tile
  static constexpr int NVC = BK / VR;              // V chunks a tile
  static constexpr int CPT = NKC + NVC;            // chunks a tile
  static constexpr int DP = D == 112 ? 128 : D;    // V chunk row: 16 lanes x CW columns (TMA zero-fills past D)
  static constexpr int CW = DP / 16;               // output columns a thread
  static constexpr int K_BYTES = BK * W * E;
  static constexpr int V_BYTES = VR * DP * E;
  static constexpr int STAGE = ((K_BYTES > V_BYTES ? K_BYTES : V_BYTES) + 1023) / 1024 * 1024;
  static constexpr int Q_BYTES = BQ * D * E;
  static constexpr int P_BYTES = 4 * BK * LDP;
  static constexpr size_t bytes() { return STAGES * STAGE + Q_BYTES + P_BYTES + STAGES * 8 + 1024; }  // + alignment slack
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, float* __restrict__ lse, int s,
                 int t, int h, int hkv, int causal, float scale) {
  using L = Fwd<T, D>;
  constexpr int CW = L::CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* ring = align_1024(smem_raw);                                           // STAGES x STAGE
  const T* qs = reinterpret_cast<const T*>(ring + STAGES * L::STAGE);             // [BQ][D]
  float* ps = reinterpret_cast<float*>(ring + STAGES * L::STAGE + L::Q_BYTES);  // [BK][LDP] P, transposed
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE + L::Q_BYTES + L::P_BYTES);

  // Blocks run tile-major (every head and batch of one query tile, then the
  // next), the tiles nearest the causal diagonal's end first: the longest
  // blocks start first, so no long block starts in the grid's last wave.
  const int nq = (s + BQ - 1) / BQ;
  const int hb = static_cast<int>(gridDim.x) / nq;  // heads x batch
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / hb) * BQ;
  const int head = static_cast<int>(blockIdx.x) % hb % h;
  const int b = static_cast<int>(blockIdx.x) % hb / h;
  const int hk = head / (h / hkv);
  const int offset = t - s;
  const int ty = threadIdx.x >> 4;  // rows ty + RL i
  const int tx = threadIdx.x & 15;  // keys tx + 16 j, output columns lane_col<CW>(tx, c)
  const int key = swz_key<L::RB>(tx);
  const float c2 = scale * LOG2E;
  const int64_t q_stride = static_cast<int64_t>(h) * D;  // between positions of q / out

  // Key tiles this query tile needs: all of them, or (causal) up to the
  // last live query's position; none when every query precedes key 0.
  const int nk = (t + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int q_last = min(q0 + BQ, s) - 1 + offset;
    hi = q_last < 0 ? 0 : min(q_last / BK + 1, nk);
  }
  const int n_chunks = hi * L::CPT;

  // Chunk n of the walk, issued by thread 0: K chunk j < NKC of key tile
  // n / CPT, or its V chunk j - NKC; Q comes with chunk 0.
  auto load = [&](int n) {
    const int st = n % STAGES;
    uint8_t* dst = ring + st * L::STAGE;
    const int k0 = n / L::CPT * BK;
    const int j = n % L::CPT;
    if (j < L::NKC) {
      mbar_expect_tx(&full[st], L::K_BYTES + (n == 0 ? L::Q_BYTES : 0));
      if (n == 0) tma_load_4d(const_cast<T*>(qs), &tm_q, &full[st], 0, head, q0, b);
      tma_load_4d(dst, &tm_k, &full[st], j * L::W, hk, k0, b);
    } else {
      mbar_expect_tx(&full[st], L::V_BYTES);
      tma_load_4d(dst, &tm_v, &full[st], 0, hk, k0 + (j - L::NKC) * VR, b);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n)
      if (n < n_chunks) load(n);
  }
  // The next chunk, once its bytes have landed. The barrier first retires
  // the chunk before it, whose stage thread 0 then refills.
  int n_next = 0;
  auto next = [&]() -> const T* {
    __syncthreads();
    if (threadIdx.x == 0 && n_next + STAGES - 1 < n_chunks) load(n_next + STAGES - 1);
    mbar_wait(&full[n_next % STAGES], (n_next / STAGES) & 1);
    return reinterpret_cast<const T*>(ring + (n_next++ % STAGES) * L::STAGE);
  };

  float m[8], l[8], acc[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * BK;
    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < L::NKC; ++j) {
      const T* kc = next();
      patch_dot<T, L::W, D, RL, L::RB>(sc, qs + ty * D + j * L::W, kc + tx * L::W, key);
    }

    // Online softmax of the tile in the exp2 domain. The previous tile's
    // readers of ps passed this tile's first barrier, so P can be written.
    const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (edge) {
        const int q_pos = q0 + ty + RL * i + offset;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k_pos = k0 + tx + 16 * j;
          if (k_pos >= t || (causal && q_pos < k_pos)) sc[i][j] = -INFINITY;
        }
      }
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, sc[i][j]);
      // The 16 column lanes of a row are neighbours: xor 1 .. 8 stays inside.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx * c2);  // stays NEG while the row has no live key
      const float corr = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = ex2(fmaf(sc[i][j], c2, -m_new));  // -inf (masked) gives 0
        l[i] += sc[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* dst = ps + (tx + 16 * j) * LDP + ty * 8;
      *reinterpret_cast<float4*>(dst) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }

    // O += P V over the tile's V chunks (the first one's barrier publishes P).
#pragma unroll 1
    for (int j = 0; j < L::NVC; ++j) {
      const T* vc = next();
      constexpr int G = CW < 4 ? CW : 4;
      rows_dot<T, VR, LDP, L::DP, CW>(acc, ps + j * VR * LDP + ty * 8, vc + G * tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    const int r = q0 + ty + RL * i;
    if (r >= s) continue;
    const float denom = fmaxf(sum, 1e-30f);
    float vals[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) vals[c] = acc[i][c] / denom;
    store_cols<T, D, CW>(out + (static_cast<int64_t>(b) * s + r) * q_stride + static_cast<int64_t>(head) * D, tx,
                         vals);
    if (lse != nullptr && tx == 0)
      lse[(static_cast<int64_t>(b) * h + head) * s + r] = (m[i] == NEG ? NEG : m[i] * LN2) + logf(denom);
  }
}

// Q in one box (128 rows x D, dense); K in boxes of 128 keys x W columns,
// swizzled; V in boxes of 32 keys x DP columns (dense; columns past D read
// as 0): kernels/flash_attention.py::fma_plan mirrors this geometry.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s, int t,
           int h, int hkv, int causal, float scale, cudaStream_t stream) {
  using L = Fwd<T, D>;
  constexpr CUtensorMapDataType type = map_type<T>();
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, type, L::E, b, s, h, D, D, BQ, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = make_map(&tm_k, k, type, L::E, b, t, hkv, D, L::W, BK, swizzle_of<L::RB>());
  if (!err) err = make_map(&tm_v, v, type, L::E, b, t, hkv, D, L::DP, VR, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  const size_t smem = L::bytes();
  cudaError_t cerr = cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int64_t blocks = static_cast<int64_t>((s + BQ - 1) / BQ) * h * b;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<T*>(out),
                                                          static_cast<float*>(lse), s, t, h, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s, int t,
             int h, int hkv, int d, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
  }
  if constexpr (sizeof(T) == 4) {  // bf16 at 64, 112 and 128 is flash_attention_tc.cu's
    switch (d) {
      case 64: return launch<T, 64>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
      case 112: return launch<T, 112>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
      case 128: return launch<T, 128>(q, k, v, out, lse, b, s, t, h, hkv, causal, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D): contiguous,
// 16-byte aligned, one element type; D in {16, 32, 64, 112, 128} for fp32 and
// {16, 32} for bf16; H % Hkv == 0. lse: null, or fp32 (B, H, S) for each
// row's natural log-sum-exp.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or -1
// when the driver has no cuTensorMapEncodeTiled, -2 when it refuses a map.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                                   int b, int s, int t, int h, int hkv, int d, int causal, float scale,
                                   cudaStream_t stream) {
  return dispatch<float>(q, k, v, out, lse, b, s, t, h, hkv, d, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                                    int b, int s, int t, int h, int hkv, int d, int causal, float scale,
                                    cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, lse, b, s, t, h, hkv, d, causal, scale, stream);
}

// Dynamic shared memory one block asks for at head_dim `d` with `elem`-byte
// elements (4: fp32, 2: bf16; 0 where the pair is not served):
// kernels/flash_attention.py::fma_plan computes the same number.
extern "C" int flash_attention_fma_smem_bytes(int d, int elem) {
  if (elem == 4) {
    switch (d) {
      case 16: return static_cast<int>(Fwd<float, 16>::bytes());
      case 32: return static_cast<int>(Fwd<float, 32>::bytes());
      case 64: return static_cast<int>(Fwd<float, 64>::bytes());
      case 112: return static_cast<int>(Fwd<float, 112>::bytes());
      case 128: return static_cast<int>(Fwd<float, 128>::bytes());
    }
  } else if (elem == 2) {
    switch (d) {
      case 16: return static_cast<int>(Fwd<__nv_bfloat16, 16>::bytes());
      case 32: return static_cast<int>(Fwd<__nv_bfloat16, 32>::bytes());
    }
  }
  return 0;
}
