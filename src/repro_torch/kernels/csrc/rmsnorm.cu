// Fused RMSNorm over the last axis: out = x * rsqrt(mean(x^2) + eps) * gamma
// with fp32 statistics, x (rows, d) fp32 or bf16, gamma (d,) fp32, out in
// x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (body
// _rms_kernel), which stages a (row_block x d) tile in VMEM and writes the
// scaled tile once. Here one warp owns one row (8 rows per 256-thread
// block): a first pass sums the squares in fp32 with 16-byte loads and a
// shuffle reduction, a second pass scales and writes with 16-byte stores.
// The second pass re-reads the row, which the first pass has just brought
// into L1/L2 (4 KB for d = 2048 in bf16), so device memory sees each input
// byte once. Rows whose length or address does not allow 16-byte vectors
// take a scalar path; odd row counts need no padding.
//
// Bound on an H100: 1 read and 1 write of x, ~3 flops per element: it is
// bound by bytes.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include "convert.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ gamma, T* __restrict__ out,
               int64_t rows, int d, float eps, int vec) {
  constexpr int VEC = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
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

template <typename T>
int launch(const void* x, const float* gamma, void* out, long long rows, int d, float eps, int vec,
           cudaStream_t stream) {
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  rmsnorm_kernel<T><<<static_cast<unsigned int>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, static_cast<T*>(out), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, d) contiguous, one element type; gamma (d,) fp32. `vec`
// is nonzero when d * sizeof(T) is a multiple of 16 and x and out are
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int rmsnorm_f32(const void* x, const float* gamma, void* out, long long rows, int d,
                           float eps, int vec, cudaStream_t stream) {
  return launch<float>(x, gamma, out, rows, d, eps, vec, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const float* gamma, void* out, long long rows, int d,
                            float eps, int vec, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, gamma, out, rows, d, eps, vec, stream);
}
