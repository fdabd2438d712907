// Forward GQA attention in bf16 on Hopper's tensor cores (wgmma + TMA), for
// head_dim 64 and 128: out = softmax(Q K^T / sqrt(d), masked) V for q
// (B, S, H, D) and k, v (B, T, Hkv, D), fp32 statistics, out in bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) for bf16 at d in {64, 128}; fp32, and
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
//             panels at d = 128); no transpose, no padding copy: TMA fills
//             rows past S or T with zeros, keys >= T are masked here, and no
//             output row >= S is written.
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
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below). The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links against the runtime only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // keys per K/V tile
constexpr int STAGES = 3;        // K/V ring depth
constexpr int CONSUMERS = 256;   // two consumer warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int PANEL = 64;        // bf16 columns in one 128-byte swizzle panel
constexpr int ROW_BYTES = 128;   // bytes of one row of a panel
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory: the Q tile, then STAGES K tiles, then STAGES V tiles, each
// stored as D / 64 panels of (rows x 128 bytes), 1024-byte aligned (the
// period of the 128-byte swizzle).
template <int D>
struct Smem {
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int KV_PANEL = BK * ROW_BYTES;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
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

// ---- TMA -------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }

// Pin a register value in program order: the compiler may not move its
// reads or writes across this point (around the asynchronous wgmma).
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// D (m64 x n128, fp32) {+}= A (m64 x k16, bf16, shared) * B (n128 x k16, bf16, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64 x n128, fp32) += A (m64 x k16, bf16, registers) * B (k16 x n128, bf16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n64, fp32) += A (m64 x k16, bf16, registers) * B (k16 x n64, bf16, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc_v);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t desc_v) {
  wgmma_rs_n128(o, a, desc_v);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t desc_v) {
  wgmma_rs_n64(o, a, desc_v);
}

// 2^x on the special-function unit (the softmax's exponentials are its
// bottleneck); subnormal results flush to 0, far below a bf16 P's resolution.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nN (fp32) within a warpgroup: warp w owns
// rows 16w .. 16w + 15; lane (g = lane / 4, c = lane % 4) holds, for
// register i, row g + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * c + i % 2.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + (i % 2); }

constexpr int NS = BK / 2;  // score registers per consumer thread (m64 x n128)

// S = Q K^T over d in 16-column steps (4 per 128-byte panel), issued
// asynchronously as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[NS], uint32_t q_base, uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 32 bytes = 16 bf16 columns
    wgmma_ss_n128(sc, sw128_desc(q_base + (kk / 4) * Smem<D>::Q_PANEL + step, 16, 1024),
                  sw128_desc(k_base + (kk / 4) * Smem<D>::KV_PANEL + step, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V over a tile's keys in 16-row steps of V (MN-major: the transpose
// bit is set, LBO steps between the 64-column panels), one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4], uint32_t v_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], sw128_desc(v_base + kk * 16 * ROW_BYTES, Smem<D>::KV_PANEL, 1024));
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
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

// P (fp32, accumulator layout) as bf16 register-A fragments, one per 16-key
// step: the accumulator layout of m64n128 is the A layout of m64k16 pairs.
__device__ __forceinline__ void to_fragments(uint32_t (&pa)[BK / 16][4], const float (&sc)[NS]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      reg_fence(pa[kk][r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out, int s, int t,
                int h, int hkv, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES], kv_empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

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
    constexpr int NO = D / 2;  // output registers per thread (m64 x nD)
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
      to_fragments(pa, sc);
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
      to_fragments(pa, sc);
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
    const int64_t row_stride = static_cast<int64_t>(h) * D;
    __nv_bfloat16* ob = out + static_cast<int64_t>(b) * s * row_stride + static_cast<int64_t>(head) * D;
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      const int r = row0 + acc_row(j);
      if (r < s) {
        const float f = inv[(j / 2) % 2];
        *reinterpret_cast<__nv_bfloat162*>(ob + r * row_stride + col0 + acc_col(j)) =
            __floats2bfloat162_rn(o[j] * f, o[j + 1] * f);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the C entry points besides cudaError_t values (all > 0).
constexpr int ERR_NO_ENCODER = -1;   // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_TENSOR_MAP = -2;   // cuTensorMapEncodeTiled refused the geometry

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (batch, seq, heads, d) as a 4-D map, innermost first
// (d, heads, seq, batch), read in boxes of 64 columns x 1 head x `rows`
// positions x 1 batch, 128-byte swizzled; positions past `seq` read as 0.
// kernels/flash_attention.py::tc_plan mirrors these numbers.
int make_map(CUtensorMap* map, const void* base, int batch, int seq, int heads, int d, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * heads, 2ull * d * heads * seq};  // bytes, dims 1..3
  const cuuint32_t box[4] = {PANEL, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s, int t, int h, int hkv,
           int causal, float scale, cudaStream_t stream) {
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s, t, h, hkv, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D): contiguous bf16,
// 16-byte aligned; D in {64, 128}; H % Hkv == 0. Launches on `stream` and
// returns cudaGetLastError() (0 on success), -1 when the driver has no
// cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int flash_attention_tc_bf16(const void* q, const void* k, const void* v, void* out, int b, int s,
                                       int t, int h, int hkv, int d, int causal, float scale,
                                       cudaStream_t stream) {
  switch (d) {
    case 64: return launch<64>(q, k, v, out, b, s, t, h, hkv, causal, scale, stream);
    case 128: return launch<128>(q, k, v, out, b, s, t, h, hkv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block asks for at head_dim `d` (0 if d is not
// served): kernels/flash_attention.py::tc_plan computes the same number.
extern "C" int flash_attention_tc_smem_bytes(int d) {
  switch (d) {
    case 64: return Smem<64>::ALLOC;
    case 128: return Smem<128>::ALLOC;
    default: return 0;
  }
}
