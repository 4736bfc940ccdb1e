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

#include "sinkhorn_common.cuh"

namespace mdgat {
namespace {

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
  const int tid = threadIdx.x;
  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2], norm = scalars[b * 4 + 3];
  const float* Zb = Z + static_cast<size_t>(b) * N * M;

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
    row_pass<C, THREADS>(Zb, lmu, lnu, v, u, N, M, alpha + vbin);
    __syncthreads();
    // bin row: lse over [alpha + v | alpha + vbin]
    ubin = lmub - bin_lse<THREADS>(v, M, vbin, alpha, red);
    // v: column logsumexp over [Z + u ; alpha + ubin]
    col_pass<THREADS>(Zb, lmu, lnu, u, v, part, colmax, N, M, alpha + ubin);
    // bin column: lse over [alpha + u ; alpha + ubin]
    vbin = lnub - bin_lse<THREADS>(u, N, ubin, alpha, red);
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
