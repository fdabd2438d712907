// Element-type helpers shared by the attention and RMSNorm kernels: fp32 and
// bf16 values converted to fp32 registers, 16-byte vector loads and stores.
// Included by flash_attention.cu, decode_attention.cu and rmsnorm.cu; the
// build hash covers every .cuh here, so an edit rebuilds all three.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// Elements of T in one 16-byte vector: 4 fp32 or 8 bf16.
template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
};

// Load Vec<T>::N elements from 16-byte-aligned global memory as fp32.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f32(e[i]);
}

// Store Vec<T>::N fp32 values as T to 16-byte-aligned global memory.
template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p, const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
