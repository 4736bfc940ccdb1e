// Passes shared by the Sinkhorn forward kernel (sinkhorn.cu) and the replay
// backward kernel (sinkhorn_bwd.cu): block reductions, the bin logsumexp,
// the row logsumexp of one warp and the column pass of the whole block.
// The backward replays the forward iterations and later recomputes u_t from
// the stored v history; both go through the functions below, so the
// recomputed potentials carry the same bits as the replayed ones.
#pragma once

#include "common.cuh"

namespace mdgat {

// block-wide max and sum; every thread gets the result
template <int THREADS>
__device__ float block_max(float x, float* red) {
  x = warp_max(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < THREADS / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}

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

// log(sum exp(vec - mx) + exp(extra - mx)) + mx + shift with
// mx = max(max(vec), extra): the bin-row / bin-column updates are
// target - bin_lse(...).
template <int THREADS>
__device__ float bin_lse(const float* vec, int len, float extra, float shift,
                         float* red) {
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < len; i += THREADS) m = fmaxf(m, vec[i]);
  const float mx = fmaxf(block_max<THREADS>(m, red), extra);
  float s = 0.f;
  for (int i = threadIdx.x; i < len; i += THREADS) s += expf(vec[i] - mx);
  s = block_sum<THREADS>(s, red) + expf(extra - mx);
  return logf(s) + mx + shift;
}

// Loads kBatch rows of column j (rows i0, i0 + G, ...) before any of them
// is used, so kBatch loads are in flight per thread: the column pass is
// bound by L2 latency otherwise. The mask is applied after the load.
constexpr int kBatch = 8;

__device__ __forceinline__ void load_column_batch(float (&zr)[kBatch],
                                                  const float* __restrict__ Zb,
                                                  int i0, int G, int N, int M,
                                                  int j) {
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int i = i0 + r * G;
    zr[r] = i < N ? __ldg(Zb + static_cast<size_t>(i) * M + j) : 0.f;
  }
}


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

// u[i] = lmu[i] - lse_j([Z + v | row_bin]) for every row, one warp per row.
template <int C, int THREADS>
__device__ __forceinline__ void row_pass(const float* __restrict__ Zb,
                                         const float* lmu, const float* lnu,
                                         const float* v, float* u, int N, int M,
                                         float row_bin) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < N; i += THREADS / 32) {
    float t[C];
    load_masked_row<C>(t, Zb + static_cast<size_t>(i) * M,
                       lmu[i] > 0.5f * kBigNeg, lnu, M, lane);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < M) t[c] += v[lane + 32 * c];
    const float r = row_lse<C>(t, M, lane, row_bin);
    if (lane == 0) u[i] = lmu[i] - r;
  }
}

// v[j] = lnu[j] - lse_i([Z + u ; col_bin]) for every column. One thread
// per column, neighbouring threads on neighbouring addresses; when the
// block has more threads than columns, G = THREADS / M groups of threads
// split the rows of a column and combine their partial max, then their
// partial sums, through part / colmax ([THREADS] each). Ends on a block
// barrier.
template <int THREADS>
__device__ __forceinline__ void col_pass(const float* __restrict__ Zb,
                                         const float* lmu, const float* lnu,
                                         const float* u, float* v, float* part,
                                         float* colmax, int N, int M,
                                         float col_bin) {
  const float half_neg = 0.5f * kBigNeg;
  const int tid = threadIdx.x;
  const int span = M < THREADS ? M : THREADS;
  const int G = THREADS / span;
  const int g = tid / span, jl = tid % span;
  for (int j0 = 0; j0 < M; j0 += span) {
    const int j = j0 + jl;
    const bool active = g < G && j < M;
    const bool cv = active && lnu[j] > half_neg;
    float m = -CUDART_INF_F;
    if (active) {
      for (int i0 = g; i0 < N; i0 += kBatch * G) {
        float zr[kBatch];
        load_column_batch(zr, Zb, i0, G, N, M, j);
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const int i = i0 + r * G;
          if (i < N) m = fmaxf(m, ((cv && lmu[i] > half_neg) ? zr[r] : kBigNeg) + u[i]);
        }
      }
    }
    part[tid] = m;
    __syncthreads();
    if (active && g == 0) {
      for (int gg = 1; gg < G; ++gg) m = fmaxf(m, part[gg * span + jl]);
      colmax[jl] = fmaxf(m, col_bin);
    }
    __syncthreads();
    float s = 0.f;
    if (active) {
      const float mm = colmax[jl];
      for (int i0 = g; i0 < N; i0 += kBatch * G) {
        float zr[kBatch];
        load_column_batch(zr, Zb, i0, G, N, M, j);
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          const int i = i0 + r * G;
          if (i < N) s += expf(((cv && lmu[i] > half_neg) ? zr[r] : kBigNeg) + u[i] - mm);
        }
      }
    }
    part[tid] = s;
    __syncthreads();
    if (active && g == 0) {
      for (int gg = 1; gg < G; ++gg) s += part[gg * span + jl];
      const float mm = colmax[jl];
      s += expf(col_bin - mm);
      v[j] = lnu[j] - (logf(s) + mm);
    }
    __syncthreads();
  }
}

}  // namespace mdgat
