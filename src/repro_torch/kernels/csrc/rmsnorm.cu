// Fused RMSNorm over the last axis: out = x * rsqrt(mean(x^2) + eps) * gamma
// with fp32 statistics, x (rows, d) fp32 or bf16, gamma (d,) fp32, out in
// x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// _rms_kernel), which stages a (row_block x d) tile in VMEM and writes the
// scaled tile once.
//
// Bound on an H100: 1 read and 1 write of x, ~4 flops per element: it is
// bound by bytes, so the design keeps enough 16-byte loads in flight to
// stream at the HBM rate and reads each byte of x once:
//
//   row in registers  for d = 2048 (bf16, fp32) and d = 4096 (bf16) the
//          kernel is templated on the row length: each lane of a warp holds
//          its slice of the row (lane + 32 j, j < NV, in 16-byte vectors) in
//          registers and issues all NV loads before the reduction, so x is
//          read once from HBM and never re-read;
//   persistent blocks  the grid is sized to the SM count (as many blocks per
//          SM as fit), and each warp walks rows warp, warp + W, ...; at
//          d = 2048 it keeps its gamma slice in fp32 registers across rows
//          (at bf16 d = 4096 those 128 registers would spill, so gamma comes
//          from L1 there), and where the registers allow (bf16) it issues
//          the next row's loads before it stores the current one;
//   other rows  a generic loop over 16-byte vectors (any d with 16-byte
//          rows), or a scalar loop for rows that cannot take 16-byte vectors
//          (odd d): one warp per row, a second pass re-reads the row from
//          L1/L2.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include "convert.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Registers one lane spends on a row of NV vectors: 4 * NV for the row
// slice (doubled when the next row is prefetched) and VEC * NV for the fp32
// gamma slice, each kept only where it fits in 128.
template <typename T, int NV>
struct RowPlan {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int D = 32 * VEC * NV;
  static constexpr bool GAMMA_IN_REGS = VEC * NV <= 64;
  static constexpr bool PREFETCH = 2 * 4 * NV + (GAMMA_IN_REGS ? VEC * NV : 0) <= 128;
};

// The fp32 gamma values of vector j of a lane's slice.
template <int VEC>
__device__ __forceinline__ void load_gamma(float (&g)[VEC], const float* __restrict__ gamma, int lane, int j) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(gamma + (lane + 32 * j) * VEC + e));
    g[e] = v.x;
    g[e + 1] = v.y;
    g[e + 2] = v.z;
    g[e + 3] = v.w;
  }
}

template <typename T, int NV>
__device__ __forceinline__ void load_row(uint4 (&r)[NV], const T* __restrict__ xr, int lane) {
  const uint4* p = reinterpret_cast<const uint4*>(xr);
#pragma unroll
  for (int j = 0; j < NV; ++j) r[j] = __ldg(p + lane + 32 * j);
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ out, int64_t rows,
                   float eps) {
  using P = RowPlan<T, NV>;
  constexpr int VEC = P::VEC;
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together

  float g[P::GAMMA_IN_REGS ? NV : 1][VEC];
  if constexpr (P::GAMMA_IN_REGS) {
#pragma unroll
    for (int j = 0; j < NV; ++j) load_gamma<VEC>(g[j], gamma, lane, j);
  }

  uint4 cur[NV];
  load_row<T, NV>(cur, x + row * P::D, lane);
  for (; row < rows; row += stride) {
    const int64_t next = row + stride;
    uint4 nxt[NV];
    if (P::PREFETCH && next < rows) load_row<T, NV>(nxt, x + next * P::D, lane);

    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const T* e = reinterpret_cast<const T*>(&cur[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = to_f32(e[i]);
        ss = fmaf(f, f, ss);
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(P::D) + eps);

    T* orow = out + row * P::D;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const T* e = reinterpret_cast<const T*>(&cur[j]);
      float f[VEC];
      if constexpr (!P::GAMMA_IN_REGS) load_gamma<VEC>(g[0], gamma, lane, j);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = to_f32(e[i]) * inv * g[P::GAMMA_IN_REGS ? j : 0][i];
      store16(orow + (lane + 32 * j) * VEC, f);
    }

    if (P::PREFETCH) {
#pragma unroll
      for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
    } else if (next < rows) {
      load_row<T, NV>(cur, x + next * P::D, lane);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_loop_kernel(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ out, int64_t rows,
                    int d, float eps, int vec) {
  constexpr int VEC = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32; row < rows; row += stride) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float ss = 0.0f;
    if (vec) {
      for (int c = lane * VEC; c < d; c += 32 * VEC) {
        float f[VEC];
        load16(xr + c, f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float f = to_f32(xr[c]);
        ss = fmaf(f, f, ss);
      }
    }
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    if (vec) {
      for (int c = lane * VEC; c < d; c += 32 * VEC) {
        float f[VEC];
        load16(xr + c, f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = f[i] * inv * gamma[c + i];
        store16(orow + c, f);
      }
    } else {
      for (int c = lane; c < d; c += 32) orow[c] = from_f32<T>(to_f32(xr[c]) * inv * gamma[c]);
    }
  }
}

// Persistent grid: as many blocks as fit on every SM at once, but no more
// than the rows need.
template <typename Kernel>
int grid_for(Kernel kernel, long long rows, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (rows + WARPS - 1) / WARPS;
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(need < full ? need : full);
  return 0;
}

template <typename T, int NV>
int launch_rows(const void* x, const float* gamma, void* out, long long rows, float eps, cudaStream_t stream) {
  int blocks = 0;
  const int err = grid_for(rmsnorm_row_kernel<T, NV>, rows, &blocks);
  if (err != 0) return err;
  rmsnorm_row_kernel<T, NV><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), gamma, static_cast<T*>(out),
                                                             rows, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* gamma, void* out, long long rows, int d, float eps, int vec,
           cudaStream_t stream) {
  constexpr int ROW = 32 * Vec<T>::N;  // elements of one vector per lane across a warp
  // Row lengths served with the row in registers (kernels/rmsnorm.py::variant
  // mirrors this choice).
  if (vec && d == 2048) return launch_rows<T, 2048 / ROW>(x, gamma, out, rows, eps, stream);
  if constexpr (sizeof(T) == 2) {  // fp32 at 4096 would hold 256 registers of row and gamma
    if (vec && d == 4096) return launch_rows<T, 4096 / ROW>(x, gamma, out, rows, eps, stream);
  }
  int blocks = 0;
  const int err = grid_for(rmsnorm_loop_kernel<T>, rows, &blocks);
  if (err != 0) return err;
  rmsnorm_loop_kernel<T><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), gamma, static_cast<T*>(out),
                                                         rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, d) contiguous, one element type; gamma (d,) fp32, 16-byte
// aligned. `vec` is nonzero when d * sizeof(T) is a multiple of 16 and x and
// out are 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int rmsnorm_f32(const void* x, const float* gamma, void* out, long long rows, int d, float eps, int vec,
                           cudaStream_t stream) {
  return launch<float>(x, gamma, out, rows, d, eps, vec, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const float* gamma, void* out, long long rows, int d, float eps,
                            int vec, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, gamma, out, rows, d, eps, vec, stream);
}
