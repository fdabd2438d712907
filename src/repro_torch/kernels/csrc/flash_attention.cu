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
// inside the block:
//
//   grid   (ceil(S/64), H, B): one 64-row query tile of one head per block,
//          the tiles nearest the causal diagonal's end launched first;
//   block  128 threads = 16 row groups x 8 column lanes; each thread owns
//          4 query rows: a 4 x 8 patch of every 64 x 64 score tile and a
//          4 x D/8 patch of the output accumulator, both in registers;
//   loop   over 64-key K and V tiles staged in shared memory (in the input
//          type, row stride padded against bank conflicts): scores in fp32,
//          row max and sum reduced across the 8 lanes of a row by shuffles,
//          P staged in shared memory, then acc = acc * corr + P V.
//
// The KV head of query head h is h / (H / Hkv). The causal mask compares
// q_pos + (T - S) with k_pos; tiles wholly above the diagonal are never
// loaded, and keys at or past T are masked, so the wrapper pads nothing.
// A masked score is the reference's -1e30 sentinel and its probability is 0,
// so a row with no live key ends as 0 / max(l, 1e-30) = 0, never NaN. Rows
// are normalised once at the end with the reference's max(l, 1e-30) floor.
// When the caller passes an `lse` buffer (training: the backward recomputes
// the probabilities from it), each row's log-sum-exp m + log(max(l, 1e-30))
// is stored there once, in (B, H, S) = (B, Hkv, G, S) order, by the row's
// first lane; serving passes null and stores nothing more.
//
// Bound on an H100: causal prefill at the serving shapes does 2 * 2 * d
// flops per live (q, k) pair against reading Q, K, V and writing O once, far
// above the card's ridge point at S = T >= 512: it is bound by operations.
// This kernel does its products with plain fp32 FMAs (no tensor cores;
// bf16 inputs are widened on read), which caps it near the 67 TFLOP/s fp32
// rate: the bound of its fp32 inputs, but far from the 989 TFLOP/s bf16
// tensor-core bound, which is why bf16 at D in {64, 128} does not come here.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include "convert.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int LDP = BK + 1;   // row stride of the fp32 probability tile
constexpr float NEG_INF = -1e30f;

// Row stride (elements) of a staged Q or K tile: one extra 32-bit word per
// row, so the lanes of a warp reading one column of 8 rows hit 8 banks.
template <typename T, int D>
struct Layout {
  static constexpr int LD = D + 4 / static_cast<int>(sizeof(T));
  static constexpr size_t bytes() {
    return sizeof(float) * BQ * LDP + sizeof(T) * (BQ * LD + BK * LD + BK * D);
  }
};

// Copy `valid` rows of D elements (global row stride `gstride` elements,
// 16-byte aligned) into `rows` shared rows of stride `ld`, zero-filling the
// rest. Raw 16-byte loads, stored as four 32-bit words (`ld` keeps each
// shared row 4-byte aligned only).
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, int64_t gstride,
                                      int rows, int valid) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CHUNKS = D / VEC;
  for (int e = threadIdx.x; e < rows * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS;
    const int c = (e % CHUNKS) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) raw = __ldg(reinterpret_cast<const uint4*>(src + r * gstride + c));
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + r * ld + c);
    w[0] = raw.x;
    w[1] = raw.y;
    w[2] = raw.z;
    w[3] = raw.w;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s, int t, int h, int hkv, int causal,
                 float scale) {
  constexpr int LD = Layout<T, D>::LD;
  constexpr int DJ = D / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);  // [BQ][LDP] probabilities
  T* qs = reinterpret_cast<T*>(ps + BQ * LDP);     // [BQ][LD]
  T* ks = qs + BQ * LD;                            // [BK][LD]
  T* vs = ks + BK * LD;                            // [BK][D]

  const int nq = (s + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = head / (h / hkv);
  const int offset = t - s;
  const int ty = threadIdx.x >> 3;  // rows ty * 4 .. ty * 4 + 3
  const int tx = threadIdx.x & 7;   // columns tx + 8 * j

  const int64_t q_stride = static_cast<int64_t>(h) * D;     // between positions of q / out
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;  // between positions of k / v
  const T* qb = q + static_cast<int64_t>(b) * s * q_stride + static_cast<int64_t>(head) * D;
  const T* kb = k + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * t * kv_stride + static_cast<int64_t>(hk) * D;

  stage<T, D>(qs, LD, qb + q0 * q_stride, q_stride, BQ, min(BQ, s - q0));

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // Key tiles this query tile needs: all of them, or (causal) up to the
  // last live query's position; none when every query precedes key 0.
  const int nk = (t + BK - 1) / BK;
  int hi = nk;
  if (causal) {
    const int q_last = min(q0 + BQ, s) - 1 + offset;
    hi = q_last < 0 ? 0 : min(q_last / BK + 1, nk);
  }

  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of ks, vs and ps are done
    stage<T, D>(ks, LD, kb + k0 * kv_stride, kv_stride, BK, min(BK, t - k0));
    stage<T, D>(vs, D, vb + k0 * kv_stride, kv_stride, BK, min(BK, t - k0));
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_f32(ks[(tx + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i + offset;
      bool live[8];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k_pos = k0 + tx + 8 * j;
        live[j] = k_pos < t && (!causal || q_pos >= k_pos);
        sc[i][j] = live[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      // The 8 lanes of a row group are neighbours: xor 1, 2, 4 stays inside.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = live[j] ? expf(sc[i][j] - mx) : 0.0f;
        ps[(ty * 4 + i) * LDP + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // the whole probability tile is in ps

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = to_f32(vs[c * D + tx + 8 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + static_cast<int64_t>(b) * s * q_stride + r * q_stride + static_cast<int64_t>(head) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 8 * j] = from_f32<T>(acc[i][j] / denom);
    if (lse != nullptr && tx == 0) lse[(static_cast<int64_t>(b) * h + head) * s + r] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s, int t,
           int h, int hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), s, t, h, hkv, causal, scale);
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
// Launches on `stream` and returns cudaGetLastError() (0 on success).
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
