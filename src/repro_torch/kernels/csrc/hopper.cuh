// Hopper building blocks shared by the flash kernels (the tensor-core
// forward, flash_attention_tc.cu, the FMA forward, flash_attention.cu, and
// the backward's passes, flash_attention_bwd.cu): mbarriers, TMA copies and
// the host-side tensor maps they read, wgmma products and their
// descriptors, fences and waits, the wgmma accumulator layout, and the FMA
// kernels' swizzled reads and register-tiled products.  The build hash
// covers every .cuh here, so an edit rebuilds every kernel.
//
// Every operand tile of the tensor-core kernels lives in shared memory as
// 128-byte-swizzled panels of 64 bf16 columns (PANEL) by the tile's rows,
// each panel 1024-byte aligned (the swizzle's period): what a TMA box of 64
// columns writes, and what a wgmma descriptor of layout B128 reads.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

constexpr int PANEL = 64;       // bf16 columns in one 128-byte swizzle panel
constexpr int ROW_BYTES = 128;  // bytes of one row of a panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to the swizzle's 1024-byte period
// (the allocation carries 1024 bytes of slack for it).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
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
// K-major (as stored, rows of a tile): LBO 16, SBO 1024 (8 rows of 128
// bytes), a 16-column step 32 bytes into the panel. MN-major (the transpose
// bit): LBO the bytes between the 64-column panels, SBO 1024, a 16-row step
// 16 x 128 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin a register value in program order: the compiler may not move its
// reads or writes across this point (around the asynchronous wgmma).
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void reg_fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

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

// D (m64 x n64, fp32) {+}= A (m64 x k16, bf16, shared) * B (n64 x k16, bf16, shared, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// The two operand patterns at width N (64 or 128): ss with both operands
// K-major (Q K^T), rs with A from registers and B MN-major (P V).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  wgmma_ss_n128(d, desc_a, desc_b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  wgmma_ss_n64(d, desc_a, desc_b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n128(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n64(d, a, desc_b);
}

// x {=} A B^T over d in 16-column steps (4 a panel; 7 at D = 112, so the
// zero-filled columns are never read): A the warpgroup's 64 own rows at
// a_base, B N streamed rows at b_base, both K-major (as stored).
template <int D, int N>
__device__ __forceinline__ void mma_rows(float (&x)[N / 2], uint32_t a_base, int a_panel, uint32_t b_base,
                                         int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 32 bytes = 16 bf16 columns
    wgmma_ss<N>(x, sw128_desc(a_base + (kk / 4) * a_panel + step, 16, 1024),
                sw128_desc(b_base + (kk / 4) * b_panel + step, 16, 1024), kk > 0);
  }
}

// acc += F B: F the bf16 fragments of an m64 x N tile, B N streamed rows at
// b_base read MN-major (the transpose bit; LBO steps between the 64-column
// panels), in 16-row steps, at DP columns.
template <int DP, int N>
__device__ __forceinline__ void mma_cols(float (&acc)[DP / 2], const uint32_t (&f)[N / 16][4], uint32_t b_base,
                                         int b_panel) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs<DP>(acc, f[kk], sw128_desc(b_base + kk * 16 * ROW_BYTES, b_panel, 1024));
}

// Accumulator layout of wgmma m64nN (fp32) within a warpgroup: warp w owns
// rows 16w .. 16w + 15; lane (g = lane / 4, c = lane % 4) holds, for
// register i, row g + 8 * ((i / 2) % 2) and column 8 * (i / 4) + 2 * c + i % 2.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + (i % 2); }

// 2^x on the special-function unit; subnormal results flush to 0, far
// below a bf16 value's resolution.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64 x nN fp32 accumulator as bf16 register-A fragments, one per 16
// columns: the accumulator layout of m64nN is the A layout of N / 16 m64k16
// steps.
template <int N>
__device__ __forceinline__ void to_fragments(uint32_t (&pa)[N / 16][4], const float (&sc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      reg_fence(pa[kk][r]);
    }
  }
}

// ---- FMA kernels: TMA rings and register-tiled fp32 products -------------
//
// The FMA flash kernels (flash_attention.cu and the backward's FMA passes)
// stage their tiles row-major in shared memory through TMA, in rings that the
// block walks one chunk at a time. A tile that a warp reads as 2 rows at a
// time (Q, the own tiles) or as whole rows (V, the gradient chunks) is stored
// dense; a chunk whose 16 rows a warp reads at once (K, the score chunks) is
// RB = 32, 64 or 128 bytes a row and stored with the TMA swizzle of that
// span, which XORs a row's 16-byte units with bits of the row, so that 8
// threads reading the same column of 8 consecutive rows hit 32 banks.

// The swizzle key of row `row` of a box with RB-byte rows (1024-byte aligned):
// what its 16-byte unit indices are XORed with. Rows 16 apart share it.
template <int RB>
__device__ __forceinline__ int swz_key(int row) {
  return (row * RB >> 7) & (RB / 16 - 1);
}

// Where element `e` of a row with swizzle key `key` lies, in elements from
// the row's start.
template <typename T>
__device__ __forceinline__ int swz(int e, int key) {
  constexpr int E = static_cast<int>(sizeof(T));
  const int byte = e * E;
  return ((((byte >> 4) ^ key) << 4) | (byte & 15)) / E;
}

// N consecutive elements of shared memory (N * sizeof(T) bytes, aligned to
// that size) in one load, widened to fp32.
template <int N>
__device__ __forceinline__ void lds(const float* p, float* f) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float* f) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(e[i]);
  } else if constexpr (N == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    f[0] = __low2float(v), f[1] = __high2float(v);
  } else {
    f[0] = __bfloat162float(*p);
  }
}

// x[i][j] += sum over dd < W of A[i * ASTEP][dd] * B[16 j][dd]: a thread's
// 8 x 8 patch of the product of two row-major tiles, `a` its first A row
// (dense, stride LDA), `b` its first B row of a swizzled chunk (rows of RB
// bytes, swizzle key `key`). Each 4-column step is 16 shared loads of 4
// values for 256 FFMAs; each sum runs in column order.
template <typename T, int W, int LDA, int ASTEP, int RB>
__device__ __forceinline__ void patch_dot(float (&x)[8][8], const T* a, const T* b, int key) {
  constexpr int LDB = RB / static_cast<int>(sizeof(T));
#pragma unroll
  for (int dd = 0; dd < W; dd += 4) {
    float av[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) lds<4>(a + i * ASTEP * LDA + dd, av[i]);
    const int bo = swz<T>(dd, key);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float bv[4];
      lds<4>(b + j * 16 * LDB + bo, bv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][j] = fmaf(av[i][e], bv[e], x[i][j]);
    }
  }
}

// acc[i][c] += sum over kk < R of P[kk][i] * B[kk][col(c)]: `p` the
// thread's 8 values in row 0 of a transposed fp32 tile (stride LDP), `b`
// its first column of a row-major tile (stride LDB). A thread's CW columns
// are CW / G groups of G = min(CW, 4) neighbours, 16 G apart, so a warp's
// 16 column lanes read whole rows; each step is 2 + CW / G loads for 8 CW
// FFMAs, each sum in row order.
template <typename T, int R, int LDP, int LDB, int CW>
__device__ __forceinline__ void rows_dot(float (&acc)[8][CW], const float* p, const T* b) {
  constexpr int G = CW < 4 ? CW : 4;
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    float pv[8], bv[CW];
    lds<4>(p + kk * LDP, pv);
    lds<4>(p + kk * LDP + 4, pv + 4);
#pragma unroll
    for (int g = 0; g < CW / G; ++g) lds<G>(b + kk * LDB + 16 * G * g, bv + G * g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pv[i], bv[c], acc[i][c]);
  }
}

// The output column of a thread's c-th accumulator column (see rows_dot),
// for column lane tx.
template <int CW>
__device__ __forceinline__ int lane_col(int tx, int c) {
  constexpr int G = CW < 4 ? CW : 4;
  return (c / G) * 16 * G + G * tx + c % G;
}

// A thread's CW accumulator columns (see rows_dot) of one output row of D
// columns: 16-byte stores of fp32, element stores of bf16; columns >= D (at
// D 112, lanes 12-15's second group) are not stored.
template <typename T, int D, int CW>
__device__ __forceinline__ void store_cols(T* row, int tx, const float (&vals)[CW]) {
  if constexpr (sizeof(T) == 4 && CW % 4 == 0) {
#pragma unroll
    for (int g = 0; g < CW / 4; ++g) {
      const int col = lane_col<CW>(tx, 4 * g);
      if (col < D)
        *reinterpret_cast<float4*>(row + col) = make_float4(vals[4 * g], vals[4 * g + 1], vals[4 * g + 2], vals[4 * g + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (lane_col<CW>(tx, c) < D) row[lane_col<CW>(tx, c)] = from_f32<T>(vals[c]);
  }
}

// ---- host side: tensor maps ------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the C entry points besides cudaError_t values (all > 0).
constexpr int ERR_NO_ENCODER = -1;  // cuTensorMapEncodeTiled not found in the driver
constexpr int ERR_TENSOR_MAP = -2;  // cuTensorMapEncodeTiled refused the geometry

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links against the runtime only.
inline EncodeTiled encoder() {
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

// A tensor (batch, seq, heads, d) of `elem`-byte elements of `type` as a
// 4-D map, innermost first (d, heads, seq, batch), read in boxes of `cols`
// columns x 1 head x `rows` positions x 1 batch with `swizzle`; positions
// past `seq` and columns past `d` read as 0. kernels/flash_attention.py's
// plans mirror these numbers.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int batch, int seq,
                    int heads, int d, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t e = static_cast<cuuint64_t>(elem);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {e * d, e * d * heads, e * d * heads * seq};  // bytes, dims 1..3
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// The tensor-core kernels' bf16 map: 64-column boxes (one panel), 128-byte swizzled.
inline int make_map(CUtensorMap* map, const void* base, int batch, int seq, int heads, int d, int rows) {
  return make_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, batch, seq, heads, d, PANEL, rows,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// The element type of T for a tensor map, and the swizzle whose span is RB
// bytes (a box row of RB bytes read as 16-byte units, see swz).
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <int RB>
constexpr CUtensorMapSwizzle swizzle_of() {
  static_assert(RB == 32 || RB == 64 || RB == 128, "a swizzle spans 32, 64 or 128 bytes");
  return RB == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}
