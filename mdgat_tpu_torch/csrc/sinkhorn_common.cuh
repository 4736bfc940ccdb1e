// Pieces shared by the Sinkhorn forward kernel (sinkhorn.cu) and the replay
// backward kernel (sinkhorn_bwd.cu): a block sum, the masked load of one
// row of raw scores into a warp's registers and the row logsumexp of one
// warp.
#pragma once

#include "common.cuh"

namespace mdgat {

// block-wide sum; every thread gets the result
template <int THREADS>
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < THREADS / 32; ++i) r += red[i];
  return r;
}

// Loads issued before any of them is used, by a thread walking a column:
// the streamed passes are bound by L2 latency otherwise.
constexpr int kBatch = 8;

// One warp loads row `Zrow` of the raw score block into registers (column
// lane + 32 c in z[c]) and masks it from the marginals: an entry is valid
// iff its row is (rv) and its column's log-marginal is above -5e29.
template <int C>
__device__ __forceinline__ void load_masked_row(float (&z)[C],
                                                const float* __restrict__ Zrow,
                                                bool rv, const float* lnu,
                                                int M, int lane) {
  const float half_neg = 0.5f * kBigNeg;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    z[c] = j < M ? __ldg(Zrow + j) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    if (j < M) z[c] = (rv && lnu[j] > half_neg) ? z[c] : kBigNeg;
  }
}

// logsumexp over [t | row_bin] of one warp's row (max first, then the sum
// of exps, as the JAX kernel does); every lane gets the result.
template <int C>
__device__ __forceinline__ float row_lse(const float (&t)[C], int M, int lane,
                                         float row_bin) {
  float m = -CUDART_INF_F;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < M) m = fmaxf(m, t[c]);
  const float mm = fmaxf(warp_max(m), row_bin);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (lane + 32 * c < M) s += expf(t[c] - mm);
  s = warp_sum(s) + expf(row_bin - mm);
  return logf(s) + mm;
}

}  // namespace mdgat
