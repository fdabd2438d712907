// Batched normal-equation assembly for the disaggregation solve (paper Eq. 1):
// gram[g] = C_g^T C_g (M x M) and rhs[g] = C_g^T w_g (M) in fp32, for G
// independent (N x M) contribution blocks C_g and power targets w_g.
//
// Replaces the Pallas TPU kernel src/repro/kernels/disagg_solve.py::disagg_gram
// (body _gram_kernel). That kernel pads M to the 128-lane MXU width and carries
// its sum over a sequential grid axis of N blocks in VMEM scratch. Here blocks
// run in parallel and in no order, so the N loop lives inside the block:
//
//   grid  (G, ceil(M/T), ceil(M/T)): one T x T tile of one gram per block;
//   block T x T threads, one gram entry each, accumulated in a register;
//   loop  over N in CHUNK-row slabs: the tile's two column ranges of C_g
//         (and w_g on diagonal tiles) are staged in shared memory, then every
//         thread does CHUNK fused multiply-adds from shared memory.
//
// Diagonal tiles also accumulate rhs (one row of threads). Ragged M and N are
// masked here (zero-filled in shared memory), so the wrapper pads nothing.
//
// Bound on an H100: the work is 2*G*N*M^2 flops against (G*N*(M+1) + G*M*(M+1))
// * 4 bytes. On the engine's shapes (M = 8, N = 60..100) that is ~4 flop/byte,
// far below the card's fp32 ridge point, and each call moves a few MB: the
// kernel is bound by memory and launch latency, not by arithmetic, so it uses
// plain fp32 FMAs and no tensor cores. wgmma, TMA and a SYRK-style upper-triangle
// tile order are left for a later, measured change.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;      // output tile edge: T x T gram entries per block
constexpr int CHUNK = 64;  // rows of C staged per loop iteration

__global__ void __launch_bounds__(T * T)
disagg_gram_kernel(const float* __restrict__ c, const float* __restrict__ w,
                   float* __restrict__ gram, float* __restrict__ rhs, int n, int m) {
  __shared__ float sa[CHUNK][T];  // C_g[n0:n0+CHUNK, i0:i0+T]
  __shared__ float sb[CHUNK][T];  // C_g[n0:n0+CHUNK, j0:j0+T]
  __shared__ float sw[CHUNK];     // w_g[n0:n0+CHUNK] (diagonal tiles only)

  const int64_t g = blockIdx.x;
  const int i0 = blockIdx.y * T;
  const int j0 = blockIdx.z * T;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * T + tx;
  const bool diag = blockIdx.y == blockIdx.z;
  const float* cg = c + g * n * m;
  const float* wg = w + g * n;

  float acc = 0.0f;    // gram[i0 + ty][j0 + tx]
  float acc_r = 0.0f;  // rhs[j0 + tx], used by row ty == 0 of diagonal tiles
  for (int n0 = 0; n0 < n; n0 += CHUNK) {
    for (int e = tid; e < CHUNK * T; e += T * T) {
      const int r = e / T;
      const int col = e % T;
      const int row = n0 + r;
      const bool in_n = row < n;
      const int64_t base = static_cast<int64_t>(row) * m;
      sa[r][col] = (in_n && i0 + col < m) ? cg[base + i0 + col] : 0.0f;
      sb[r][col] = (in_n && j0 + col < m) ? cg[base + j0 + col] : 0.0f;
    }
    if (diag && tid < CHUNK) sw[tid] = (n0 + tid < n) ? wg[n0 + tid] : 0.0f;
    __syncthreads();
    const int len = min(CHUNK, n - n0);
    for (int r = 0; r < len; ++r) acc = fmaf(sa[r][ty], sb[r][tx], acc);
    if (diag && ty == 0) {
      for (int r = 0; r < len; ++r) acc_r = fmaf(sw[r], sb[r][tx], acc_r);
    }
    __syncthreads();
  }

  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i < m && j < m) gram[g * m * m + static_cast<int64_t>(i) * m + j] = acc;
  if (diag && ty == 0 && j < m) rhs[g * m + j] = acc_r;
}

}  // namespace

// c: (G, N, M) fp32 contiguous; w: (G, N); gram: (G, M, M); rhs: (G, M).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int disagg_gram_f32(const float* c, const float* w, float* gram, float* rhs,
                               int g, int n, int m, cudaStream_t stream) {
  const int tiles = (m + T - 1) / T;
  disagg_gram_kernel<<<dim3(g, tiles, tiles), dim3(T, T), 0, stream>>>(c, w, gram, rhs, n, m);
  return static_cast<int>(cudaGetLastError());
}
