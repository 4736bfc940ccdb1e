// Dustbin log-Sinkhorn forward, one block per pair.
//
// Replaces the TPU kernel mdgat_tpu/ops/pallas/sinkhorn.py::_kernel
// (reached from pallas_log_optimal_transport through _fwd_from_prep). Same
// semantics: the raw score block is masked in-kernel from the marginals
// (a row/column is valid iff its log-marginal is above -5e29, the
// _MASK_DENSE arm), padded potentials start at the -1e30 sentinel, and
// each iteration runs the row logsumexp over [Z + v | alpha + vbin], the
// bin-row update, the column logsumexp over [Z + u ; alpha + ubin] and the
// bin-column update. The epilogue writes dense = Z + u + v - norm, the bin
// row, the bin column and the corner. The decision-aux epilogue of the TPU
// kernel (gated off there) is not ported.
//
// Residency differs from the TPU, which pins the whole block in VMEM. At
// N = M = 256 f32 one pair is 256 KB, more than the 227 KB of shared memory
// a block may use, so Z stays in global memory and is re-read on every
// pass; at the serving batch (64 pairs x 256 KB = 16 MB) and the stretch
// shape (8 x 4 MB) it stays resident in the 50 MB L2. u, v and the log
// marginals sit in shared memory. Rows go one warp each, with the row of Z
// cached in registers (C = ceil(M/32) per lane, M <= 1024). Columns go one
// thread each, neighbouring threads on neighbouring addresses; when the
// block has more threads than columns, G = threads / M groups of threads
// split the rows of each column and combine their partial max, then their
// partial sums, in shared memory. Both passes take the max first and then
// the sum of exps, as the JAX kernel does.
//
// What bounds it on the H100: reading the pair's block from L2 three times
// per iteration, at the latency of one SM's loads. The column pass needs
// many loads in flight, hence 1024 threads a block (512 when a row caches
// 16-32 values a lane) and batches of 8 loads issued before their values
// are used. With one block per pair a batch of 64 fills 64 of the 132 SMs,
// and 8 pairs at N=1024 only 8; splitting a pair over a cluster with
// distributed shared memory is later work.

#include "common.cuh"

namespace mdgat {
namespace {

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

// lse over [vec | extra] shifted by `shift`:
//   target - (log(sum exp(vec - mx) + exp(extra - mx)) + mx + shift)
// with mx = max(max(vec), extra) -- the bin-row / bin-column updates.
template <int THREADS>
__device__ float bin_update(const float* vec, int len, float extra,
                            float target, float shift, float* red) {
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < len; i += THREADS) m = fmaxf(m, vec[i]);
  const float mx = fmaxf(block_max<THREADS>(m, red), extra);
  float s = 0.f;
  for (int i = threadIdx.x; i < len; i += THREADS) s += expf(vec[i] - mx);
  s = block_sum<THREADS>(s, red) + expf(extra - mx);
  return target - (logf(s) + mx + shift);
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

template <int C, int THREADS>
__global__ void __launch_bounds__(THREADS)
sinkhorn_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, const float* __restrict__ scalars,
                float* __restrict__ out, float* __restrict__ bin_row,
                float* __restrict__ bin_col, float* __restrict__ corner, int N,
                int M, int iters) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float sm[];
  float* u = sm;             // [N]
  float* v = u + N;          // [M]
  float* lmu = v + M;        // [N]
  float* lnu = lmu + N;      // [M]
  float* part = lnu + M;     // [THREADS] column partials
  float* colmax = part + THREADS;  // [THREADS]
  __shared__ float red[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2], norm = scalars[b * 4 + 3];
  const float* Zb = Z + static_cast<size_t>(b) * N * M;
  // column pass layout: `span` columns per sweep, G row groups per column
  const int span = M < THREADS ? M : THREADS;
  const int G = THREADS / span;
  const int g = tid / span, jl = tid % span;

  for (int i = tid; i < N; i += THREADS) {
    lmu[i] = log_mu[static_cast<size_t>(b) * N + i];
    u[i] = lmu[i] > half_neg ? 0.f : kBigNeg;
  }
  for (int j = tid; j < M; j += THREADS) {
    lnu[j] = log_nu[static_cast<size_t>(b) * M + j];
    v[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
  }
  float ubin = 0.f, vbin = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // u: row logsumexp over [Z + v | alpha + vbin], one warp per row
    const float row_bin = alpha + vbin;
    for (int i = warp; i < N; i += kWarps) {
      const bool rv = lmu[i] > half_neg;
      float t[C];
      float m = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        t[c] = j < M ? __ldg(Zb + static_cast<size_t>(i) * M + j) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) {
          t[c] = ((rv && lnu[j] > half_neg) ? t[c] : kBigNeg) + v[j];
          m = fmaxf(m, t[c]);
        }
      }
      const float mm = fmaxf(warp_max(m), row_bin);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (lane + 32 * c < M) s += expf(t[c] - mm);
      s = warp_sum(s) + expf(row_bin - mm);
      if (lane == 0) u[i] = lmu[i] - (logf(s) + mm);
    }
    __syncthreads();
    // bin row: lse over [alpha + v | alpha + vbin]
    ubin = bin_update<THREADS>(v, M, vbin, lmub, alpha, red);

    // v: column logsumexp over [Z + u ; alpha + ubin]
    const float col_bin = alpha + ubin;
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
    // bin column: lse over [alpha + u ; alpha + ubin]
    vbin = bin_update<THREADS>(u, N, ubin, lnub, alpha, red);
  }

  float* ob = out + static_cast<size_t>(b) * N * M;
  for (size_t idx = tid; idx < static_cast<size_t>(N) * M; idx += THREADS) {
    const int i = static_cast<int>(idx / M), j = static_cast<int>(idx % M);
    const float z = (lmu[i] > half_neg && lnu[j] > half_neg) ? Zb[idx] : kBigNeg;
    ob[idx] = z + u[i] + v[j] - norm;
  }
  for (int j = tid; j < M; j += THREADS)
    bin_row[static_cast<size_t>(b) * M + j] = alpha + ubin + v[j] - norm;
  for (int i = tid; i < N; i += THREADS)
    bin_col[static_cast<size_t>(b) * N + i] = alpha + u[i] + vbin - norm;
  if (tid == 0) corner[b] = alpha + ubin + vbin - norm;
}

template <int C, int THREADS>
cudaError_t launch(const float* Z, const float* log_mu, const float* log_nu,
                   const float* scalars, float* out, float* bin_row,
                   float* bin_col, float* corner, int B, int N, int M,
                   int iters, cudaStream_t stream) {
  const size_t smem = (2 * (static_cast<size_t>(N) + M) + 2 * THREADS) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = sinkhorn_kernel<C, THREADS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, THREADS, smem, stream>>>(Z, log_mu, log_nu, scalars, out,
                                       bin_row, bin_col, corner, N, M, iters);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdgat

// Z [B,N,M] raw scores, log_mu [B,N], log_nu [B,M], scalars [B,4] =
// (alpha, log_mu_bin, log_nu_bin, norm), all f32 and contiguous. Outputs:
// dense [B,N,M], bin_row [B,M], bin_col [B,N], corner [B].
extern "C" cudaError_t mdgat_sinkhorn(const void* Z, const void* log_mu,
                                      const void* log_nu, const void* scalars,
                                      void* out, void* bin_row, void* bin_col,
                                      void* corner, int B, int N, int M,
                                      int iters, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || N <= 0 || M <= 0 || iters < 0) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (M <= 256)
    return launch<8, 1024>(f(Z), f(log_mu), f(log_nu), f(scalars), g(out), g(bin_row),
                     g(bin_col), g(corner), B, N, M, iters, stream);
  if (M <= 512)
    return launch<16, 512>(f(Z), f(log_mu), f(log_nu), f(scalars), g(out), g(bin_row),
                      g(bin_col), g(corner), B, N, M, iters, stream);
  if (M <= 1024)
    return launch<32, 512>(f(Z), f(log_mu), f(log_nu), f(scalars), g(out), g(bin_row),
                      g(bin_col), g(corner), B, N, M, iters, stream);
  return cudaErrorInvalidValue;
}
