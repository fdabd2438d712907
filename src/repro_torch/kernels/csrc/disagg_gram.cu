// Batched normal-equation assembly for the disaggregation solve (paper Eq. 1):
// gram[g] = C_g^T C_g (M x M) and rhs[g] = C_g^T w_g (M) in fp32, for G
// independent (N x M) contribution blocks C_g and power targets w_g.
//
// Replaces the Pallas TPU kernel src/repro/kernels/disagg_solve.py::disagg_gram
// (body _gram_kernel). That kernel pads M to the 128-lane MXU width and carries
// its sum over a sequential grid axis of N blocks in VMEM scratch. Here blocks
// run in parallel and in no order, so the N loop lives inside the block, and
// the gram's symmetry is used: only entries (i, j) with i <= j are summed, and
// each is stored twice.
//
// Bound on an H100: the work is G*N*M*(M+1) flops for the unique gram entries
// plus 2*G*N*M for rhs, against (G*N*(M+1) + G*M*(M+1)) * 4 bytes. At the
// engine's M = 8 that is ~2 flop/byte: bound by bytes (and, at a few MB a
// call, by latency). It is ~M/4 flop/byte, so the fp32 ridge point (~20) lies
// near M = 80: M = 64 is still bound by bytes, M = 256 by fp32 FMAs.
// IEEE fp32 FMAs throughout (no TF32, no tensor cores). Two variants, picked
// by M and N on the host (kernels/disagg_solve.py::gram_plan):
//
//   warp   (M <= 16, N <= 1024) one warp per batch entry g, a grid-stride
//          loop over G sized to the SM count. Each g's contiguous rows come
//          into shared memory in chunks as 16-byte cp.async copies (the
//          ragged head and tail of an unaligned chunk as 4-byte ones),
//          double-buffered so the next chunk (the next g's slab, at the
//          engine's shapes) lands while the current one is reduced. Each lane
//          owns a few of the M(M+1)/2 + M upper-triangle and rhs entries (44
//          at M = 8) and writes them mirrored.
//   tiled  (the rest) a register-tiled SYRK: a block owns a BT x BT tile on or
//          above the diagonal, each thread a 4 x 4 block of it, fed from
//          16-row shared-memory slabs of the tile's two column ranges,
//          double-buffered with cp.async. Where G x tiles leaves the card
//          short of blocks, N is split across the blocks of a cluster, which
//          add their tiles through distributed shared memory in rank order:
//          one launch, no scratch, the same bits every call. Diagonal tiles
//          also sum rhs for their rows.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes (plain C interface below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// warp variant (M <= 16, N <= 1024)
// ---------------------------------------------------------------------------

// Floats by which `p` sits past a 16-byte boundary (0..3).
__device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// One warp copies `count` floats from `src` to `dst + misalign(src)` (`dst`
// 16-byte aligned), so that both sides of the middle are 16-byte aligned.
__device__ __forceinline__ void warp_copy(float* dst, const float* src, int count, int lane) {
  const int sh = misalign(src);
  dst += sh;
  const int head = min((4 - sh) & 3, count);
  const int vecs = (count - head) / 4;
  const int tail = count - head - 4 * vecs;
  if (lane < head) cp_async4(dst + lane, src + lane);
  for (int v = lane; v < vecs; v += 32) cp_async16(dst + head + 4 * v, src + head + 4 * v);
  if (lane < tail) cp_async4(dst + head + 4 * vecs + lane, src + head + 4 * vecs + lane);
}

// MAXM: 8 or 16, the largest M the instantiation takes; each lane owns EPL
// entries of the M(M+1)/2 upper-triangle ones followed by the M rhs ones.
template <int MAXM>
__global__ void __launch_bounds__(256)
gram_warp_kernel(const float* __restrict__ c, const float* __restrict__ w, float* __restrict__ gram,
                 float* __restrict__ rhs, int g_count, int n, int m, int rows, int buf_floats) {
  constexpr int EPL = (MAXM * (MAXM + 1) / 2 + MAXM + 31) / 32;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float* bufs = sm + warp * 2 * buf_floats;  // two buffers: C rows, then w (at c_floats)
  const int c_floats = (rows * m + 4 + 3) / 4 * 4;

  const int tri = m * (m + 1) / 2;
  // Entry k is column i times column j (j == m: times w), packed i | j << 8.
  int ij[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) {
    int e = lane + 32 * k;
    ij[k] = 0;
    if (e < tri) {
      int i = 0;
      while (e >= m - i) {
        e -= m - i;
        ++i;
      }
      ij[k] = i | (i + e) << 8;
    } else if (e < tri + m) {
      ij[k] = (e - tri) | m << 8;
    }
  }

  const int nchunks = (n + rows - 1) / rows;
  const int first = blockIdx.x * warps + warp;
  const int stride = gridDim.x * warps;
  const int mine = first < g_count ? (g_count - 1 - first) / stride + 1 : 0;
  const int items = mine * nchunks;

  auto chunk_src = [&](int item, const float** cs, const float** ws, int* rc) {
    const int64_t gg = first + static_cast<int64_t>(item / nchunks) * stride;
    const int r0 = (item % nchunks) * rows;
    *rc = min(rows, n - r0);
    *cs = c + (gg * n + r0) * m;
    *ws = w + gg * n + r0;
  };
  auto issue = [&](int item) {
    const float *cs, *ws;
    int rc;
    chunk_src(item, &cs, &ws, &rc);
    float* buf = bufs + (item & 1) * buf_floats;
    warp_copy(buf, cs, rc * m, lane);
    warp_copy(buf + c_floats, ws, rc, lane);
    cp_async_commit();
  };

  float acc[EPL];
#pragma unroll
  for (int k = 0; k < EPL; ++k) acc[k] = 0.0f;
  if (items > 0) issue(0);
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float *cs, *ws;
    int rc;
    chunk_src(it, &cs, &ws, &rc);
    const float* buf = bufs + (it & 1) * buf_floats;
    const float* crow = buf + misalign(cs);
    const float* wrow = buf + c_floats + misalign(ws);
#pragma unroll 4
    for (int r = 0; r < rc; ++r, crow += m) {
      const float wr = wrow[r];
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        const int i = ij[k] & 0xff, j = ij[k] >> 8;
        acc[k] = fmaf(crow[i], j < m ? crow[j] : wr, acc[k]);
      }
    }
    __syncwarp();  // the buffer is refilled two items on
    if (it % nchunks == nchunks - 1) {
      const int64_t gg = first + static_cast<int64_t>(it / nchunks) * stride;
      float* gp = gram + gg * m * m;
#pragma unroll
      for (int k = 0; k < EPL; ++k) {
        const int e = lane + 32 * k;
        const int i = ij[k] & 0xff, j = ij[k] >> 8;
        if (e < tri) {
          gp[i * m + j] = acc[k];
          gp[j * m + i] = acc[k];
        } else if (e < tri + m) {
          rhs[gg * m + i] = acc[k];
        }
        acc[k] = 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tiled variant (M > 16 or N > 1024)
// ---------------------------------------------------------------------------

constexpr int KC = 16;  // rows of C per shared-memory slab

// BT: 32 (64 threads) or 64 (256 threads); VEC4: M % 4 == 0, so tile rows
// are 16-byte aligned and copied 16 bytes at a time.
template <int BT, bool VEC4>
__global__ void __launch_bounds__((BT / 4) * (BT / 4))
gram_tiled_kernel(const float* __restrict__ c, const float* __restrict__ w, float* __restrict__ gram,
                  float* __restrict__ rhs, int n, int m, int tiles, int rows_per_split) {
  constexpr int TPR = BT / 4;  // threads along a tile row
  constexpr int THREADS = TPR * TPR;
  constexpr int Q = TPR / 4;   // lanes that share a row's rhs, each over every Q-th slab row
  __shared__ __align__(16) float as[2][KC][BT];
  __shared__ __align__(16) float bs[2][KC][BT];
  __shared__ float ws[2][KC];
  __shared__ __align__(16) float red[BT * BT + BT];  // this block's tile and rhs, for the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // the cluster spans gridDim.x
  const int splits = gridDim.x;
  const int64_t g = blockIdx.y;
  int idx = blockIdx.z;
  int ti = 0;
  while (idx >= tiles - ti) {
    idx -= tiles - ti;
    ++ti;
  }
  const int tj = ti + idx;
  const bool diag = ti == tj;
  const int i0 = ti * BT;
  const int j0 = tj * BT;
  const int tid = threadIdx.x;
  const int ty = tid / TPR;
  const int tx = tid % TPR;

  const int n0 = rank * rows_per_split;
  const int n1 = min(n, n0 + rows_per_split);
  const int nk = n1 > n0 ? (n1 - n0 + KC - 1) / KC : 0;
  const float* cg_ = c + g * n * m;
  const float* wg = w + g * n;

  auto issue = [&](int kc, int buf) {
    const int r0 = n0 + kc * KC;
    const int panels = diag ? 1 : 2;
    if (VEC4) {
      for (int e = tid; e < panels * KC * (BT / 4); e += THREADS) {
        const int p = e / (KC * (BT / 4));
        const int r = (e / (BT / 4)) % KC;
        const int col = (e % (BT / 4)) * 4;
        float* dst = p ? &bs[buf][r][col] : &as[buf][r][col];
        const int gc = (p ? j0 : i0) + col;
        if (r0 + r < n1 && gc < m) {
          cp_async16(dst, cg_ + static_cast<int64_t>(r0 + r) * m + gc);
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      for (int e = tid; e < panels * KC * BT; e += THREADS) {
        const int p = e / (KC * BT);
        const int r = (e / BT) % KC;
        const int col = e % BT;
        float* dst = p ? &bs[buf][r][col] : &as[buf][r][col];
        const int gc = (p ? j0 : i0) + col;
        if (r0 + r < n1 && gc < m) {
          cp_async4(dst, cg_ + static_cast<int64_t>(r0 + r) * m + gc);
        } else {
          *dst = 0.0f;
        }
      }
    }
    if (diag && tid < KC) {
      if (r0 + tid < n1) {
        cp_async4(&ws[buf][tid], wg + r0 + tid);
      } else {
        ws[buf][tid] = 0.0f;
      }
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
  float racc = 0.0f;  // diagonal tiles: rhs of row ty * 4 + (tx & 3), over slab rows (tx >> 2) mod Q
  if (nk > 0) issue(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) {
      issue(kc + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*bsrc)[BT] = diag ? as[buf] : bs[buf];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bsrc[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
      }
    }
    if (diag) {
#pragma unroll
      for (int kk = 0; kk < KC / Q; ++kk) {
        const int k = kk * Q + (tx >> 2);
        racc = fmaf(as[buf][k][ty * 4 + (tx & 3)], ws[buf][k], racc);
      }
    }
    __syncthreads();  // the slab is refilled next iteration
  }
  // Sum rhs over the Q lanes (tx >> 2 = 0..Q-1) that share a row.
#pragma unroll
  for (int off = 4; off < TPR; off <<= 1) racc += __shfl_xor_sync(0xffffffffu, racc, off);

  float* gp = gram + g * m * m;
  if (splits == 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tx * 4 + b;
        if (i < m && j < m) {
          gp[static_cast<int64_t>(i) * m + j] = acc[a][b];
          if (!diag) gp[static_cast<int64_t>(j) * m + i] = acc[a][b];
        }
      }
    }
    if (diag && tx < 4 && i0 + ty * 4 + tx < m) rhs[g * m + i0 + ty * 4 + tx] = racc;
    return;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) red[(ty * 4 + a) * BT + tx * 4 + b] = acc[a][b];
  }
  if (tx < 4) red[BT * BT + ty * 4 + tx] = racc;
  cluster.sync();
  // The slices' tiles, added in rank order; block r stores a share.
  for (int e = rank * THREADS + tid; e < BT * BT + (diag ? BT : 0); e += splits * THREADS) {
    float s = 0.0f;
    for (int r = 0; r < splits; ++r) s += *cluster.map_shared_rank(red + e, r);
    if (e < BT * BT) {
      const int i = i0 + e / BT;
      const int j = j0 + e % BT;
      if (i < m && j < m) {
        gp[static_cast<int64_t>(i) * m + j] = s;
        if (!diag) gp[static_cast<int64_t>(j) * m + i] = s;
      }
    } else if (i0 + e - BT * BT < m) {
      rhs[g * m + i0 + e - BT * BT] = s;
    }
  }
  cluster.sync();  // no block leaves while a peer may still read its tile
}

template <int BT, bool VEC4>
int launch_tiled(const float* c, const float* w, float* gram, float* rhs, int g, int n, int m, int splits,
                 int rows_per_split, cudaStream_t stream) {
  const int tiles = (m + BT - 1) / BT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, g, tiles * (tiles + 1) / 2);
  cfg.blockDim = dim3((BT / 4) * (BT / 4));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gram_tiled_kernel<BT, VEC4>, c, w, gram, rhs, n, m, tiles,
                                       rows_per_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int MAXM>
int launch_warp(const float* c, const float* w, float* gram, float* rhs, int g, int n, int m, int blocks,
                int warps, int rows, cudaStream_t stream) {
  const int buf_floats = (rows * m + 4 + 3) / 4 * 4 + (rows + 4 + 3) / 4 * 4;
  const int smem = warps * 2 * buf_floats * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(gram_warp_kernel<MAXM>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_warp_kernel<MAXM><<<blocks, warps * 32, smem, stream>>>(c, w, gram, rhs, g, n, m, rows, buf_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c: (G, N, M) fp32 contiguous; w: (G, N); gram: (G, M, M); rhs: (G, M).
// The launch is kernels/disagg_solve.py::gram_plan's:
//   variant 0 (warp, M <= 16, N <= 1024): `blocks` blocks of `warps` warps,
//     chunks of `rows` rows (rows * M <= 1024, rows <= 256);
//   variant 1 (tiled, otherwise): tiles of `tile` (32 or 64) on or above the
//     diagonal, N cut into `splits` slices of `rows` rows, one cluster each.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int disagg_gram_f32(const float* c, const float* w, float* gram, float* rhs, int g, int n, int m,
                               int variant, int blocks, int warps, int rows, int tile, int splits,
                               cudaStream_t stream) {
  if (variant == 0) {
    if (m <= 8) return launch_warp<8>(c, w, gram, rhs, g, n, m, blocks, warps, rows, stream);
    if (m <= 16) return launch_warp<16>(c, w, gram, rhs, g, n, m, blocks, warps, rows, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = m % 4 == 0;
  if (tile == 32) {
    return vec4 ? launch_tiled<32, true>(c, w, gram, rhs, g, n, m, splits, rows, stream)
                : launch_tiled<32, false>(c, w, gram, rhs, g, n, m, splits, rows, stream);
  }
  if (tile == 64) {
    return vec4 ? launch_tiled<64, true>(c, w, gram, rhs, g, n, m, splits, rows, stream)
                : launch_tiled<64, false>(c, w, gram, rhs, g, n, m, splits, rows, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
