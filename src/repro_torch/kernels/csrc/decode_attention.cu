// Decode attention: one query token per sequence against a KV cache, masked
// at and past each sequence's length. q (B, H, D), caches (B, S, Hkv, D),
// lengths (B,) int32; fp32 scores and softmax, out (B, H, D) in q's type,
// and optionally lse (B, H) fp32, each row's natural log-sum-exp of its
// scaled scores over the live keys (-inf for a sequence of length 0): what
// a cache split on its sequence axis needs to merge the slices' outputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _dec_kernel). That kernel scalar-prefetches the
// lengths, walks (batch, kv head, kv block) with the kv blocks sequential,
// carries the online softmax in VMEM scratch and lets the G = H / Hkv query
// heads of a KV head share each staged block.
//
// Bound on an H100: each step reads the live K and V rows once and does ~1
// flop per byte, far below the ridge point, so it is bound by bytes. At the
// serving shapes (B = 2..8, Hkv = 8) there are only 16-64 (sequence, KV head)
// pairs for 132 SMs, so each pair's cache is cut into slices worked by the
// blocks of one thread-block cluster. What the design does about the bytes:
//
//   grid     (splits, Hkv * head chunks, B), cluster (splits, 1, 1): a block
//            owns one slice of one (sequence, KV head) and the query heads of
//            one head chunk (all G heads when G <= 8); each block reads its
//            own lengths[b] (the twin of scalar prefetch) and clips its slice
//            there. kernels/decode_attention.py::decode_plan picks the slice
//            and cluster sizes (up to 8, the portable limit) from the SM
//            count: about one block per SM.
//   ring     K and V stay in their stored type in shared memory, in a
//            4-stage ring of TK-key tiles (16 KB of K + V a stage), filled
//            with cp.async 16 bytes a thread at offsets fixed per thread;
//            each thread's copies complete on the stage's mbarrier
//            (cp.async.mbarrier.arrive.noinc), so three stages (48 KB) stay
//            in flight while one is computed. Rows at or past lengths[b] are
//            never requested.
//   compute  eight warps, straight from the staged tile: LPK = D / (16 B)
//            lanes share a key, each holding a 16-byte piece of the row,
//            widened in registers (at d = 112 a row is 14 or 28 pieces; a
//            key then takes 16 or 32 lanes, the last 2 or 4 idle, so that
//            the shuffles stay within powers of two; the cache is read
//            unpadded); the G dot products are reduced with
//            shuffles; each lane keeps its piece of the G x D accumulator and
//            the heads' running max and sum (log2 domain, ex2.approx) in
//            registers. CUDA-core FMAs only: at ~1 flop a byte there is
//            nothing for the tensor cores.
//   merge    in the same launch: a warp's key groups merge by shuffles, the
//            block's warps through shared memory, then the cluster's slices
//            through distributed shared memory in rank order, each block
//            writing a share of the output. No global scratch, no second
//            kernel, and the same inputs give the same bits.
//
// What still holds it back (PERF.md): a launch's fixed cost (reading
// lengths, the first tile's latency, the two cluster barriers of the merge)
// is several microseconds beside 6-11 us of streaming at the serving shapes;
// bulk (TMA) row copies and deeper or wider rings measured no faster.
//
// Cache rows at or past lengths[b] are never read, so a padded or unfilled
// cache tail cannot leak into the result. A sequence of length 0 gives 0.
// The lse store is one extra write per head from the merge's own (max,
// sum); `out` is computed and stored the same way with or without it.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cooperative_groups.h>

#include "convert.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;             // ring depth
constexpr int STAGE_TARGET = 16384;   // bytes of K + V in one stage
constexpr int MAX_TILE = 128;         // keys per stage, at most
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The smallest power of two >= n.
__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// Lanes that share a key at head_dim d and element size elem: one 16-byte
// piece of the row each, rounded up to a power of two.
__host__ __device__ constexpr int key_lanes(int d, int elem) { return pow2_ceil(d * elem / 16); }

// Keys per ring stage at head_dim d and element size elem: STAGE_TARGET
// bytes of K and V, at most MAX_TILE, a multiple of the keys the eight
// warps take at once (mirrored by kernels/decode_attention.py::tile_keys).
__host__ __device__ constexpr int tile_keys(int d, int elem) {
  const int keys = STAGE_TARGET / (2 * d * elem) < MAX_TILE ? STAGE_TARGET / (2 * d * elem) : MAX_TILE;
  const int step = WARPS * (32 / key_lanes(d, elem));
  return keys / step * step;
}

// Dynamic shared memory: the ring, the warps' partial states and the
// block's state (GC heads x (m, l, D accumulators) each, fp32), then the
// stages' mbarriers (mirrored by decode_attention.py::smem_bytes).
__host__ __device__ constexpr int ring_bytes(int d, int elem) { return STAGES * 2 * tile_keys(d, elem) * d * elem; }
__host__ __device__ constexpr int part_bytes(int d, int gc) { return ((WARPS + 1) * gc * (d + 2) * 4 + 15) / 16 * 16; }
__host__ __device__ constexpr int smem_bytes(int d, int elem, int gc) {
  return ring_bytes(d, elem) + part_bytes(d, gc) + STAGES * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// 2^x on the special-function unit (relative error ~2^-22; 0 for x << 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The stage's mbarrier counts this thread's arrival once all its earlier
// cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Vec<T>::N elements of shared memory, widened to fp32.
template <typename T>
__device__ __forceinline__ void lds16(const unsigned char* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f32(e[i]);
}

// GC: a power of two >= the block's head count (its registers are sized by
// it; heads past the count are computed on zeros and never stored).
template <typename T, int D, int GC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ lse, int s_max, int h, int hkv,
              int nchunk, int gchunk, int chunk, float qscale) {
  constexpr int ELEM = static_cast<int>(sizeof(T));
  constexpr int VEC = Vec<T>::N;       // elements in a lane's 16-byte piece
  constexpr int LPK = D / VEC;         // 16-byte pieces of a row: the lanes that hold one
  constexpr int LPKP = key_lanes(D, ELEM);  // lanes per key (LPK rounded up to a power of two)
  constexpr int KPW = 32 / LPKP;       // keys a warp takes at once
  constexpr int ROW = D * ELEM;        // bytes of a cache row
  constexpr int CH = ROW / 16;         // 16-byte pieces per row
  constexpr int TK = tile_keys(D, ELEM);
  constexpr int KW = TK / WARPS;       // keys per warp and tile
  constexpr int NK = KW / KPW;         // keys per lane group and tile
  constexpr int STAGE = 2 * TK * ROW;  // K tile, then V tile
  constexpr int RPP = THREADS / CH;    // rows of a tile one pass of the block copies
  constexpr int PASSES = (TK + RPP - 1) / RPP;  // copies per thread into each of the K and V tiles
  constexpr int PART = GC * (D + 2);   // m [GC], l [GC], acc [GC][D]
  static_assert(NK >= 1 && KW % KPW == 0 && TK % (WARPS * KPW) == 0 && PASSES >= 1, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* wpart = reinterpret_cast<float*>(smem + ring_bytes(D, ELEM));
  float* res = wpart + WARPS * PART;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ring_bytes(D, ELEM) + part_bytes(D, GC));

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());  // the cluster spans gridDim.x
  const int splits = gridDim.x;
  const int hk = blockIdx.y / nchunk;
  const int hc = blockIdx.y % nchunk;
  const int b = blockIdx.z;
  const int g = h / hkv;
  const int head0 = hk * g + hc * gchunk;
  const int gcount = min(gchunk, g - hc * gchunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int piece = lane % LPKP;  // which 16 bytes of a row this lane holds
  const int sub = lane / LPKP;    // which of the warp's KPW keys
  const bool on = LPK == LPKP || piece < LPK;  // false on the idle lanes past the row (d = 112)

  // This lane's piece of each head's query, prescaled by scale * log2(e);
  // loaded while lengths[b] is in flight.
  float qr[GC][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    if (gi < gcount && on) {
      load16(q + (static_cast<int64_t>(b) * h + head0 + gi) * D + piece * VEC, qr[gi]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[gi][e] = 0.0f;
    }
  }
  const int len = max(0, min(lengths[b], s_max));
  const int k0 = split * chunk;
  const int k_end = min(len, k0 + chunk);  // this slice: [k0, k_end)
  const int ntiles = k_end > k0 ? (k_end - k0 + TK - 1) / TK : 0;

  const int64_t row_stride = static_cast<int64_t>(hkv) * D;  // between cache positions
  const T* kb = kc + static_cast<int64_t>(b) * s_max * row_stride + static_cast<int64_t>(hk) * D;
  const T* vb = vc + static_cast<int64_t>(b) * s_max * row_stride + static_cast<int64_t>(hk) * D;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], THREADS);
  }
  __syncthreads();

  // Thread tid copies piece tid % CH of rows tid / CH + i * RPP of each
  // tile's K and V: the offsets are fixed, only the tile's first row moves.
  // When CH does not divide THREADS (d = 112) the last THREADS % CH
  // threads copy nothing, and the last pass stops at the tile's end.
  const int crow = tid / CH;
  const bool copier = THREADS % CH == 0 || tid < RPP * CH;
  const int64_t csrc = crow * row_stride + (tid % CH) * VEC;
  const uint32_t cdst = smem_u32(smem) + crow * ROW + (tid % CH) * 16;
  auto issue = [&](int t) {
    const int base = k0 + t * TK;
    const int64_t off = static_cast<int64_t>(base) * row_stride + csrc;
    const uint32_t dst = cdst + (t % STAGES) * STAGE;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      const int row = crow + i * RPP;
      if (copier && (TK % RPP == 0 || row < TK) && base + row < k_end) {
        cp_async16(dst + i * RPP * ROW, kb + off + i * RPP * row_stride);
        cp_async16(dst + TK * ROW + i * RPP * ROW, vb + off + i * RPP * row_stride);
      }
    }
    cp_async_arrive(&full[t % STAGES]);
  };
  for (int t = 0; t < min(STAGES, ntiles); ++t) issue(t);

  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[gi][e] *= qscale;
      acc[gi][e] = 0.0f;
    }
    m[gi] = NEG_INF;
    l[gi] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const unsigned char* ks = smem + (t % STAGES) * STAGE;
    const unsigned char* vs = ks + TK * ROW;
    const int r0 = warp * KW + sub;  // this lane group's keys: r0 + j * KPW
    const int live = k_end - (k0 + t * TK);

    float s[NK][GC];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float kf[VEC];
      if (on) {
        lds16<T>(ks + (r0 + j * KPW) * ROW + piece * 16, kf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.0f;
      }
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qr[gi][e], kf[e], dot);
        s[j][gi] = dot;
      }
    }
#pragma unroll
    for (int off = 1; off < LPKP; off <<= 1) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) s[j][gi] += __shfl_xor_sync(0xffffffffu, s[j][gi], off);
      }
    }
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (r0 + j * KPW < live) mx = fmaxf(mx, s[j][gi]);
      }
      const float corr = fast_exp2(m[gi] - mx);
      m[gi] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][gi] = r0 + j * KPW < live ? fast_exp2(s[j][gi] - mx) : 0.0f;  // now a probability
        sum += s[j][gi];
      }
      l[gi] = fmaf(l[gi], corr, sum);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (on && r0 + j * KPW < live) {  // a stale row may hold anything, NaN included
        float vf[VEC];
        lds16<T>(vs + (r0 + j * KPW) * ROW + piece * 16, vf);
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[gi][e] = fmaf(s[j][gi], vf[e], acc[gi][e]);
        }
      }
    }
    if (t + STAGES < ntiles) {
      __syncthreads();  // every warp is done with this stage
      issue(t + STAGES);
    }
  }

  // Merge the warp's KPW key groups: lanes lane and lane ^ (LPKP * 2^i) hold
  // the same piece of the row.
#pragma unroll
  for (int off = LPKP; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mx = fmaxf(m[gi], mo);
      const float wa = fast_exp2(m[gi] - mx);
      const float wb = fast_exp2(mo - mx);
      l[gi] = l[gi] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * wa + ao * wb;
      }
      m[gi] = mx;
    }
  }
  if (sub == 0 && on) {
    float* wp = wpart + warp * PART;
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) wp[2 * GC + gi * D + piece * VEC + e] = acc[gi][e];
      if (piece == 0) {
        wp[gi] = m[gi];
        wp[GC + gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // The block's state: its warps merged in order, into `res` (same layout).
  for (int e = tid; e < GC * D; e += THREADS) {
    const int gi = e / D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wpart[w * PART + gi]);
    float a = 0.0f, ls = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = fast_exp2(wpart[w * PART + gi] - mx);
      a = fmaf(wpart[w * PART + 2 * GC + e], wt, a);
      ls = fmaf(wpart[w * PART + GC + gi], wt, ls);
    }
    res[2 * GC + e] = a;
    if (e % D == 0) {
      res[gi] = mx;
      res[GC + gi] = ls;
    }
  }
  cluster.sync();  // every block's state is written and visible to the cluster

  // The cluster's slices, merged in rank order; block r writes outputs
  // r * THREADS + tid, stepping by the cluster's threads.
  for (int e = split * THREADS + tid; e < gcount * D; e += splits * THREADS) {
    const int gi = e / D;
    float mx = NEG_INF;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(res + gi, r));
    float a = 0.0f, ls = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* peer = cluster.map_shared_rank(res, r);
      const float wt = fast_exp2(peer[gi] - mx);
      a = fmaf(peer[2 * GC + e], wt, a);
      ls = fmaf(peer[GC + gi], wt, ls);
    }
    out[(static_cast<int64_t>(b) * h + head0 + gi) * D + e % D] = from_f32<T>(a / fmaxf(ls, 1e-30f));
    // The scores were scaled by log2(e): back to natural log. No live key:
    // mx is the -1e30 sentinel and ls 0, so log2(ls) makes it -inf.
    if (lse != nullptr && e % D == 0) lse[static_cast<int64_t>(b) * h + head0 + gi] = (mx + log2f(ls)) * LN2;
  }
  cluster.sync();  // no block leaves while a peer may still read its state
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* lse;
  int b, s_max, h, hkv, splits, chunk, nchunk, gchunk;
  float scale;
};

template <typename T, int D, int GC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes(D, static_cast<int>(sizeof(T)), GC);
  auto kernel = decode_kernel<T, D, GC>;
  static uint64_t configured = 0;  // a bit per device: attributes set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(configured >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) configured |= uint64_t{1} << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.hkv * a.nchunk, a.b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.out), a.lse, a.s_max, a.h,
                           a.hkv, a.nchunk, a.gchunk, a.chunk, a.scale * LOG2E);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const Args& a, cudaStream_t stream) {
  if (a.gchunk <= 1) return launch<T, D, 1>(a, stream);
  if (a.gchunk <= 2) return launch<T, D, 2>(a, stream);
  if (a.gchunk <= 4) return launch<T, D, 4>(a, stream);
  if (a.gchunk <= 8) return launch<T, D, 8>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return by_group<T, 16>(a, stream);
    case 32: return by_group<T, 32>(a, stream);
    case 64: return by_group<T, 64>(a, stream);
    case 112: return by_group<T, 112>(a, stream);
    case 128: return by_group<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H, D), k_cache and v_cache (B, S_max, Hkv, D), out (B, H, D):
// contiguous, 16-byte aligned, one element type; lengths (B,) int32 on the
// same device; D in {16, 32, 64, 112, 128}; H % Hkv == 0. The grid is
// (splits, Hkv * nchunk, B) in clusters of `splits` blocks: slices of
// `chunk` keys (splits * chunk >= S_max), the G = H / Hkv heads in `nchunk`
// chunks of at most `gchunk` <= 8 (decode_attention.py::decode_plan).
// lse, when not null: (B, H) fp32 on the same device, written as well.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v, const int* lengths, void* out, float* lse,
                                    int b, int s_max, int h, int hkv, int d, int splits, int chunk, int nchunk,
                                    int gchunk, float scale, cudaStream_t stream) {
  const Args a{q, k, v, lengths, out, lse, b, s_max, h, hkv, splits, chunk, nchunk, gchunk, scale};
  return dispatch<float>(a, d, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v, const int* lengths, void* out, float* lse,
                                     int b, int s_max, int h, int hkv, int d, int splits, int chunk, int nchunk,
                                     int gchunk, float scale, cudaStream_t stream) {
  const Args a{q, k, v, lengths, out, lse, b, s_max, h, hkv, splits, chunk, nchunk, gchunk, scale};
  return dispatch<__nv_bfloat16>(a, d, stream);
}

// The kernel's dynamic shared memory for element size `elem` (4 or 2),
// head_dim d and a head chunk of `gc` (a power of two <= 8).
extern "C" int decode_attention_smem_bytes(int elem, int d, int gc) { return smem_bytes(d, elem, gc); }

// Keys per ring stage for element size `elem` and head_dim d.
extern "C" int decode_attention_tile_keys(int elem, int d) { return tile_keys(d, elem); }
