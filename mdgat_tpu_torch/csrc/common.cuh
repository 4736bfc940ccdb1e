// Shared helpers of the mdgat_tpu_torch kernels: dtype conversion, 16-byte
// loads and cp.async staging, warp reductions, and the -1e30 sentinel that
// stands in for -inf everywhere (exp() of it is exactly 0; sums of a few
// stay finite).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

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

// Four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16) access.
// The address must be aligned to the access.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// four bf16 as they lie in memory (8 bytes) -> f32
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 raw) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ uint2 float4_to_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16(v.x), __float2bfloat16(v.y));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16(v.z), __float2bfloat16(v.w));
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  return raw;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = float4_to_bf16x4(v);
}
// The same to global memory, always as one vector store: through a pointer
// held in a struct, a plain store4 compiles to four scalar stores
__device__ __forceinline__ void store4_global(float* p, float4 v) {
  __stwb(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4_global(__nv_bfloat16* p, float4 v) {
  __stwb(reinterpret_cast<uint2*>(p), float4_to_bf16x4(v));
}

// cp.async: a 16-byte copy from global to shared memory that passes through
// no register and completes in the background. `bytes` < 16 zero-fills the
// rest of the 16 (0 reads nothing and writes zeros; src must still be a
// valid address). Copies are grouped by cp_async_commit();
// cp_async_wait<N>() returns once all but the newest N groups have landed.
__device__ __forceinline__ void cp_async16(unsigned smem_addr, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr),
               "l"(src), "r"(bytes) : "memory");
}
// the address of a shared-memory location as cp.async takes it
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* smem_dst, const void* src,
                                           int bytes = 16) {
  cp_async16(smem_address(smem_dst), src, bytes);
}
// the same for one float (cached at all levels; `bytes` 0 writes a zero)
__device__ __forceinline__ void cp_async4(float* smem_dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(smem_dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages four consecutive elements into shared memory as f32: cp.async for
// f32 sources, a converting load and store for bf16. With !ok the four
// floats are zeros and src is not read.
__device__ __forceinline__ void stage4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       bool ok) {
  store4(dst, ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f));
}

inline bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Sets the dynamic shared-memory cap of a kernel when it asks for more
// than the default 48 KB (Hopper allows 227 KB per block).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The same for a kernel launched hundreds of times a step: the launch site
// keeps one SmemCap per kernel instantiation (a function-local static),
// which remembers the largest cap set on each device, so that a steady
// launch makes no call into the CUDA runtime for it. Host threads that
// launch the kernel at once (one a device, or several on one device) set
// the cap under one mutex, and the cap only grows: a thread that asked for
// less never lowers the cap another thread has recorded.
struct SmemCap {
  static constexpr int kDevices = 64;
  std::atomic<size_t> set[kDevices] = {};
  std::mutex lock;
};
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, SmemCap& cap) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= SmemCap::kDevices) return allow_smem(kernel, bytes);
  if (bytes <= cap.set[device].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> guard(cap.lock);
  if (bytes <= cap.set[device].load(std::memory_order_relaxed)) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) cap.set[device].store(bytes, std::memory_order_release);
  return err;
}

constexpr size_t kMaxSmem = 227 * 1024;

// The key-tile layout of the attention forward (csrc/attention.cu) and of
// the backward's rows kernel (csrc/mha_bwd.cu): K or V streams through one
// tile of kKT keys at a row stride of Dh + 4 floats, beside a [rows][M + pad]
// slab of scores or weights whose stride of 8 mod 32 floats puts the four
// rows of a warp's 4 x 8 register tile on disjoint banks.
constexpr int kKT = 256;
__host__ __device__ constexpr int slab_stride(int M) { return (M + 31) / 32 * 32 + 8; }
// floats of the tile buffer, which also holds the [32 / (Dh / 4)][rows][Dh]
// partial sums of the slab products
__host__ __device__ constexpr int tile_floats(int DH, int BR) {
  return kKT * (DH + 4) > 128 * BR ? kKT * (DH + 4) : 128 * BR;
}

}  // namespace mdgat
