// Shared helpers of the mdgat_tpu_torch kernels: dtype conversion, warp
// reductions, and the -1e30 sentinel that stands in for -inf everywhere
// (exp() of it is exactly 0; sums of a few stay finite).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace mdgat {

constexpr float kBigNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// io dtype codes shared with the Python wrappers
enum IoDtype : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The attention score of one (query, key) pair: q . k over the head dim as
// one FMA chain in ascending d, starting from 0. The fused-MHA backward
// re-evaluates `s >= thr` on recomputed scores, so the forward that
// produced thr and both backward passes all form s here: the same values
// through the same chain give the same bits, and no kept entry flips.
template <int DH, typename A, typename B>
__device__ __forceinline__ float score_dot(const A* q, const B* k) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc = fmaf(q[d], k[d], acc);
  return acc;
}

// Sets the dynamic shared-memory cap of a kernel when it asks for more
// than the default 48 KB (Hopper allows 227 KB per block).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace mdgat
