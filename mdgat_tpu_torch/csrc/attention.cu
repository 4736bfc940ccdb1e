// Top-k / dense masked attention with the per-row k-th-value threshold.
//
// Replaces the TPU kernel mdgat_tpu/ops/pallas/attention.py::_attn_kernel
// (reached from pallas_topk_attention) and its selection core
// _stacked_prob, EXACT arm: the k-th largest valid score of each query row
// is found by a binary search over order-preserving int32 keys
// (_monotone_key / _key_to_float), so the threshold equals the k-th value
// bit for bit and every tie at it is kept. The softmax subtracts the row
// max taken before the search; masked and dropped entries exponentiate the
// -1e30 sentinel to 0; the denominator is floored at 1e-30, so an
// all-masked row gives zeros and no NaN. The fast value-bisection arm of
// the TPU kernel is not ported.
//
// Design. One warp per query row; the row's M scores live in registers
// (C = ceil(M/32) per lane, M <= 1024). A block serves one (batch, head)
// and 8 warps x RPW rows of it. Phase 1 stages the head's K tile in shared
// memory (rows padded to Dh+1 floats: lane j reads key j, so the stride
// keeps the 32 lanes on 32 banks), computes the scores, runs the search
// with warp ballots + __popc (32 steps at most, stopping once the interval
// closes), and writes the unnormalised weights e to a per-row shared
// buffer. Phase 2 stages V in the same buffer (K and V together would not
// fit at M=1024) and forms e @ V, one output dim per lane, scaled by
// 1/denom. Internals are f32 for f32 and bf16 inputs.
//
// With a non-null `lse` the kernel also writes the per-row logsumexp over
// the kept entries, max + log(max(denom, 1e-30)): the second residual of
// the fused-MHA forward (_mha_fwd_kernel), from which its backward rebuilds
// the probabilities. An all-masked row gives thr = +1e30 and lse = -1e30.
//
// What bounds it on the H100: shared-memory bandwidth. Each score and each
// PV term is one FMA fed by one shared-memory read (q sits in registers,
// e is a broadcast), so the kernel runs far below the FMA peak; the search
// adds C ballots per step. K and V are read once per block from L2. A
// faster version would use mma tiles for QK^T and PV (later work).

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ int monotone_key(float s) {
  int bits = __float_as_int(s);
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float key_to_float(int key) {
  int bits = key >= 0 ? key : key ^ 0x7FFFFFFF;
  return __int_as_float(bits);
}

// overflow-safe ceiling average: keys span the whole int32 range
__device__ __forceinline__ int ceil_avg(int a, int b) {
  int fa = (a >> 1) + (b >> 1) + (a & b & 1);
  return fa + ((a ^ b) & 1);
}

template <typename T, int DH, int C>
__global__ void __launch_bounds__(kWarps * 32)
topk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      T* __restrict__ o, float* __restrict__ thr,
                      float* __restrict__ lse, int H, int N, int M, int topk,
                      float scale, int rpw) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1;
  float* kv = smem;              // [M][LD]: K in phase 1, V in phase 2
  float* ew = smem + M * LD;     // [kWarps * rpw][M] unnormalised weights
  __shared__ float inv_denom[kWarps * 8];

  const int bh = blockIdx.y;     // b * H + h
  const int b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_per_block = kWarps * rpw;
  const int row0 = blockIdx.x * rows_per_block;
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;

  const T* kb = k + static_cast<size_t>(bh) * M * DH;
  for (int i = threadIdx.x; i < M * DH; i += blockDim.x)
    kv[(i / DH) * LD + (i % DH)] = to_f32(kb[i]);
  __syncthreads();

  for (int t = 0; t < rpw; ++t) {
    const int slot = warp * rpw + t;
    const int n = row0 + slot;
    if (n >= N) break;  // ragged query edge
    const T* qrow = q + (static_cast<size_t>(bh) * N + n) * DH;
    float qr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = to_f32(qrow[d]);

    float s[C];
    unsigned valid_bits = 0;
    float minv = -kBigNeg;       // smallest valid score (+1e30 if none)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      float acc = 0.f;
      bool ok = false;
      if (j < M) {
        acc = score_dot<DH>(qr, kv + j * LD);
        ok = mb[j] != 0;
      }
      s[c] = ok ? acc * scale : kBigNeg;
      if (ok) {
        valid_bits |= 1u << c;
        minv = fminf(minv, s[c]);
      }
    }
    float mx = kBigNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);           // pre-search row max (masked entries -1e30)

    unsigned keep_bits = valid_bits;
    float row_thr = kBigNeg;
    if (topk > 0) {
      int key[C];
#pragma unroll
      for (int c = 0; c < C; ++c) key[c] = monotone_key(s[c]);
      int lo = monotone_key(warp_min(minv));
      int hi = monotone_key(mx);
      // largest key t with count(key >= t) >= topk: that key is the k-th
      // largest score. Once lo >= hi no later step moves lo.
      for (int it = 0; it < 32 && lo < hi; ++it) {
        const int mid = ceil_avg(lo, hi);
        int cnt = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) cnt += __popc(__ballot_sync(kFull, key[c] >= mid));
        if (cnt >= topk) lo = mid; else hi = mid - 1;
      }
      keep_bits = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (key[c] >= lo) keep_bits |= 1u << c;
      keep_bits &= valid_bits;   // all-masked rows keep nothing
      row_thr = key_to_float(lo);
    }

    float sum = 0.f;
    float* erow = ew + slot * M;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      const float e = expf((keep_bits >> c) & 1u ? s[c] - mx : kBigNeg);
      sum += e;
      if (j < M) erow[j] = e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      inv_denom[slot] = 1.f / fmaxf(sum, 1e-30f);
      thr[static_cast<size_t>(bh) * N + n] = row_thr;
      if (lse != nullptr)
        lse[static_cast<size_t>(bh) * N + n] = mx + logf(fmaxf(sum, 1e-30f));
    }
  }
  __syncthreads();

  const T* vb = v + static_cast<size_t>(bh) * M * DH;
  for (int i = threadIdx.x; i < M * DH; i += blockDim.x)
    kv[(i / DH) * LD + (i % DH)] = to_f32(vb[i]);
  __syncthreads();

  for (int t = 0; t < rpw; ++t) {
    const int slot = warp * rpw + t;
    const int n = row0 + slot;
    if (n >= N) break;
    const float* erow = ew + slot * M;
    T* orow = o + (static_cast<size_t>(bh) * N + n) * DH;
    const float inv = inv_denom[slot];
    if constexpr (DH >= 32) {
      constexpr int P = DH / 32;   // output dims per lane
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.f;
      for (int j = 0; j < M; ++j) {
        const float e = erow[j];
        const float* vr = kv + j * LD;
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] = fmaf(e, vr[lane + 32 * p], acc[p]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) orow[lane + 32 * p] = from_f32<T>(acc[p] * inv);
    } else {
      constexpr int G = 32 / DH;   // lane groups, each over every G-th key
      const int d = lane % DH, g = lane / DH;
      float acc = 0.f;
      for (int j = g; j < M; j += G) acc = fmaf(erow[j], kv[j * LD + d], acc);
#pragma unroll
      for (int off = DH; off < 32; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (g == 0) orow[d] = from_f32<T>(acc * inv);
    }
  }
}

template <typename T, int DH, int C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* thr, float* lse, int B,
                   int H, int N, int M, int topk, float scale,
                   cudaStream_t stream) {
  const int rpw = M <= 256 ? 4 : 2;  // rows per warp: two blocks an SM above 256
  const size_t smem = (static_cast<size_t>(M) * (DH + 1) +
                       static_cast<size_t>(kWarps) * rpw * M) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = topk_attention_kernel<T, DH, C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * rpw;
  dim3 grid((N + rows_per_block - 1) / rows_per_block, B * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), thr, lse, H, N, M,
      topk, scale, rpw);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t dispatch_c(const void* q, const void* k, const void* v,
                       const uint8_t* mask, void* o, float* thr, float* lse,
                       int B, int H, int N, int M, int topk, float scale,
                       cudaStream_t stream) {
  if (M <= 256)
    return launch<T, DH, 8>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
  if (M <= 512)
    return launch<T, DH, 16>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
  if (M <= 1024)
    return launch<T, DH, 32>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* o, float* thr, float* lse,
                        int B, int H, int N, int M, int Dh, int topk, float scale,
                        cudaStream_t stream) {
  switch (Dh) {
    case 8: return dispatch_c<T, 8>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
    case 16: return dispatch_c<T, 16>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
    case 32: return dispatch_c<T, 32>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
    case 64: return dispatch_c<T, 64>(q, k, v, mask, o, thr, lse, B, H, N, M, topk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mdgat

// q [B,H,N,Dh], k/v [B,H,M,Dh] (f32 or bf16, contiguous), mask [B,M] uint8,
// o [B,H,N,Dh] (input dtype), thr [B,H,N] f32, lse [B,H,N] f32 or null.
// topk 0 = dense.
extern "C" cudaError_t mdgat_topk_attention(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* thr, void* lse, int B, int H, int N, int M, int Dh, int topk,
    float scale, int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || topk < 0) return cudaErrorInvalidValue;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* t = static_cast<float*>(thr);
  auto* l = static_cast<float*>(lse);
  if (io_dtype == kF32)
    return dispatch_dh<float>(q, k, v, m, o, t, l, B, H, N, M, Dh, topk, scale, stream);
  if (io_dtype == kBF16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, m, o, t, l, B,
                                      H, N, M, Dh, topk, scale, stream);
  return cudaErrorInvalidValue;
}

extern "C" const char* mdgat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
