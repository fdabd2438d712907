// Decode attention: one query token per sequence against a KV cache, masked
// at and past each sequence's length. q (B, H, D), caches (B, S, Hkv, D),
// lengths (B,) int32; fp32 scores and softmax, out (B, H, D) in q's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _dec_kernel). That kernel scalar-prefetches the
// lengths, walks (batch, kv head, kv block) with the kv blocks sequential,
// carries the online softmax in VMEM scratch and lets the G = H / Hkv query
// heads of a KV head share each staged block. Here (split-KV, as in
// flash-decoding):
//
//   grid   (Hkv, B, splits): one block per (sequence, KV head, slice of the
//          cache); each block reads its own lengths[b] (the twin of scalar
//          prefetch) and walks its slice, clipped at that length;
//   block  128 threads; a loop over 64-key tiles: K and V rows are read
//          with 16-byte loads, widened to fp32 in shared memory; the G x 64
//          scores are one dot product per thread and entry; one warp per
//          query row takes the tile's max and sum; the G x D accumulator is
//          rescaled and advanced in shared memory;
//   merge  with one slice the block normalises and writes the output; with
//          several it writes its unnormalised (acc, m, l) to scratch and a
//          second kernel, one block per (sequence, query head), rescales the
//          slices to their common max and divides once.
//
// Cache rows at or past lengths[b] are never read, so a padded or unfilled
// cache tail cannot leak into the result. A sequence of length 0 gives 0.
//
// Bound on an H100: each step reads the live K and V rows once, ~1 flop per
// byte, far below the ridge point: it is bound by bytes. At the serving
// shapes (B = 2..8, Hkv = 8) one block per (sequence, KV head) gives only
// 16-64 blocks for 132 SMs, each loading its tiles one after another; the
// wrapper therefore splits the cache into slices of at least 128 keys until
// there are about two blocks per SM. Tiles within a block are still loaded
// synchronously (no cp.async or TMA pipeline): that is left for a later,
// measured change.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include "convert.cuh"

namespace {

constexpr int TK = 64;        // keys per staged tile
constexpr int THREADS = 128;  // four warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

template <int D>
size_t smem_bytes(int g) {
  // q [G][D], K [TK][D+1], V [TK][D], scores [G][TK], acc [G][D], m, l, corr [G]
  return sizeof(float) * (static_cast<size_t>(g) * D + TK * (D + 1) + TK * D +
                          static_cast<size_t>(g) * TK + static_cast<size_t>(g) * D + 3 * g);
}

// Partial results of one slice, for the merge: acc [G][D] unnormalised,
// then m [G] and l [G], at ((b * Hkv + hk) * splits + split).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int s_max, int h, int hkv, int chunk, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CHUNKS = D / VEC;  // 16-byte chunks per cache row
  constexpr int LDK = D + 1;       // K rows padded: lanes on consecutive keys hit distinct banks
  extern __shared__ __align__(16) float sm[];
  const int g = h / hkv;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  float* qs = sm;                 // [G][D]
  float* ks = qs + g * D;         // [TK][LDK]
  float* vs = ks + TK * LDK;      // [TK][D]
  float* ss = vs + TK * D;        // [G][TK] scores, then probabilities
  float* acc = ss + g * TK;       // [G][D]
  float* mrow = acc + g * D;      // [G]
  float* lrow = mrow + g;         // [G]
  float* crow = lrow + g;         // [G]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int len = max(0, min(lengths[b], s_max));
  const int k_end = min(len, (split + 1) * chunk);  // this slice: [split * chunk, k_end)
  const T* qb = q + (static_cast<int64_t>(b) * h + static_cast<int64_t>(hk) * g) * D;
  for (int e = tid; e < g * D; e += THREADS) {
    qs[e] = to_f32(qb[e]);
    acc[e] = 0.0f;
  }
  for (int e = tid; e < g; e += THREADS) {
    mrow[e] = NEG_INF;
    lrow[e] = 0.0f;
  }

  const int64_t row_stride = static_cast<int64_t>(hkv) * D;  // between cache positions
  const T* kb = kc + static_cast<int64_t>(b) * s_max * row_stride + static_cast<int64_t>(hk) * D;
  const T* vb = vc + static_cast<int64_t>(b) * s_max * row_stride + static_cast<int64_t>(hk) * D;

  for (int k0 = split * chunk; k0 < k_end; k0 += TK) {
    const int valid = min(TK, k_end - k0);
    __syncthreads();  // the previous tile's readers (and the set-up above) are done
    for (int e = tid; e < valid * CHUNKS; e += THREADS) {
      const int r = e / CHUNKS;
      const int c = (e % CHUNKS) * VEC;
      const int64_t off = (k0 + r) * row_stride + c;
      float f[VEC];
      load16(kb + off, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) ks[r * LDK + c + i] = f[i];
      load16(vb + off, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vs[r * D + c + i] = f[i];
    }
    __syncthreads();

    for (int e = tid; e < g * TK; e += THREADS) {
      const int gi = e / TK;
      const int c = e % TK;
      float dot = 0.0f;
      if (c < valid) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[gi * D + d], ks[c * LDK + d], dot);
      }
      ss[e] = c < valid ? dot * scale : NEG_INF;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = mrow[gi];
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, ss[gi * TK + c]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < TK; c += 32) {
        const float p = c < valid ? expf(ss[gi * TK + c] - mx) : 0.0f;
        ss[gi * TK + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(mrow[gi] - mx);
        crow[gi] = corr;
        lrow[gi] = lrow[gi] * corr + sum;
        mrow[gi] = mx;
      }
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += THREADS) {
      const int gi = e / D;
      const int d = e % D;
      float a = acc[e] * crow[gi];
      for (int c = 0; c < valid; ++c) a = fmaf(ss[gi * TK + c], vs[c * D + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  if (splits == 1) {
    T* ob = out + (static_cast<int64_t>(b) * h + static_cast<int64_t>(hk) * g) * D;
    for (int e = tid; e < g * D; e += THREADS) ob[e] = from_f32<T>(acc[e] / fmaxf(lrow[e / D], 1e-30f));
    return;
  }
  const int64_t slot = (static_cast<int64_t>(b) * hkv + hk) * splits + split;
  float* pa = part_acc + slot * g * D;
  float* pml = part_ml + slot * 2 * g;
  for (int e = tid; e < g * D; e += THREADS) pa[e] = acc[e];
  for (int e = tid; e < g; e += THREADS) {
    pml[e] = mrow[e];
    pml[g + e] = lrow[e];
  }
}

// Merge the slices of one (sequence, query head): D threads, one output
// element each. An empty slice has m = -1e30 and l = 0 and weighs nothing.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    T* __restrict__ out, int h, int hkv, int splits) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / hkv;
  const int hk = head / g;
  const int gi = head % g;
  const int d = threadIdx.x;
  const int64_t base = (static_cast<int64_t>(b) * hkv + hk) * splits;
  float mx = NEG_INF;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, part_ml[(base + sp) * 2 * g + gi]);
  float l = 0.0f, a = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* pml = part_ml + (base + sp) * 2 * g;
    const float w = expf(pml[gi] - mx);
    l = fmaf(pml[g + gi], w, l);
    a = fmaf(part_acc[((base + sp) * g + gi) * D + d], w, a);
  }
  out[(static_cast<int64_t>(b) * h + head) * D + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part_acc;
  float* part_ml;
  int b, s_max, h, hkv, splits, chunk;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(a.h / a.hkv);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T, D><<<dim3(a.hkv, a.b, a.splits), THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths,
      static_cast<T*>(a.out), a.part_acc, a.part_ml, a.s_max, a.h, a.hkv, a.chunk, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  decode_merge_kernel<T, D><<<dim3(a.h, a.b), D, 0, stream>>>(a.part_acc, a.part_ml,
                                                              static_cast<T*>(a.out), a.h, a.hkv,
                                                              a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, D), k_cache and v_cache (B, S_max, Hkv, D), out (B, H, D):
// contiguous, 16-byte aligned, one element type; lengths (B,) int32 on the
// same device; D in {16, 32, 64, 128}; H % Hkv == 0. The cache is cut into
// `splits` slices of `chunk` keys (a multiple of 64, splits * chunk >=
// S_max); with splits > 1, part_acc holds B * Hkv * splits * (H / Hkv) * D
// floats and part_ml twice B * Hkv * splits * (H / Hkv).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const int* lengths, void* out, float* part_acc, float* part_ml,
                                    int b, int s_max, int h, int hkv, int d, int splits, int chunk,
                                    float scale, cudaStream_t stream) {
  const Args a{q, k, v, lengths, out, part_acc, part_ml, b, s_max, h, hkv, splits, chunk, scale};
  return dispatch<float>(a, d, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const int* lengths, void* out, float* part_acc,
                                     float* part_ml, int b, int s_max, int h, int hkv, int d,
                                     int splits, int chunk, float scale, cudaStream_t stream) {
  const Args a{q, k, v, lengths, out, part_acc, part_ml, b, s_max, h, hkv, splits, chunk, scale};
  return dispatch<__nv_bfloat16>(a, d, stream);
}
