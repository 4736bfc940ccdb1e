// Dustbin log-Sinkhorn backward: exact reverse mode through the unrolled
// iterations, one block per pair.
//
// Replaces the TPU kernel mdgat_tpu/ops/pallas/sinkhorn.py::_bwd_kernel
// (reached from _ot_trainable through _bwd_call). Same algorithm: replay
// the forward iterations keeping only the v / vbin history, then walk the
// adjoint from the last iteration to the first. In step t the potentials
// u_t, ubin_t are recomputed from v_{t-1} (by the functions the replay used,
// sinkhorn_common.cuh, so they carry the same bits), and the softmax
// weights of the column updates are rebuilt from the potentials
// (c = log_nu - v_t, cb = log_nu_bin - vbin_t). Outputs: dZ [B, N, M] (the
// wrapper zeroes it outside the valid block) and dalpha [B].
//
// Design. The TPU kernel pins Z, dO and dZ in VMEM. One pair at N = M = 512
// f32 is 1 MB, so here they stay in global memory, as in the forward
// kernel; the v history ((iters + 1) x M floats, 43 KB at 20 iterations and
// M = 512) sits in shared memory. A reverse step needs row sums
// (du_i += sum_j contrib_ij) and column sums (dv_j += sum_i contrib2_ij) of
// [N, M] slabs. Both come from ONE row sweep: a warp owns a row, keeps its
// masked Z row in registers, recomputes r_i and u_i, forms contrib, reduces
// its row sum with shuffles (which completes du_i), forms contrib2 with
// that du_i, adds both into dZ (one read and one write of the row) and
// adds contrib2 into per-lane column accumulators that live in registers
// across the warp's rows. After the sweep the warps' accumulators are
// combined through shared memory in warp order, so the result is the same
// on every run and no atomics are used. The first step reads dO where
// later steps read dZ, which spares the copy. The column sums of dO that
// start the recursion come from a sweep of the same form. So the reverse
// walk has no column pass; only the replay does.
//
// What bounds it on the H100: per pair, three reads of Z per replayed
// iteration (L2 latency, as in the forward kernel) and, per reverse step,
// one read of Z and one read and one write of dZ. At the training shape
// (64 x 512 x 512) Z, dO and dZ are 192 MB together and do not fit the
// 50 MB L2, so the sweeps stream from HBM. One block per pair fills 64 of
// the 132 SMs.

#include "sinkhorn_common.cuh"

namespace mdgat {
namespace {

template <int C, int THREADS>
__global__ void __launch_bounds__(THREADS)
sinkhorn_bwd_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                    const float* __restrict__ log_nu,
                    const float* __restrict__ scalars,
                    const float* __restrict__ d_out, const float* __restrict__ d_bin_row,
                    const float* __restrict__ d_bin_col,
                    const float* __restrict__ d_corner, float* __restrict__ dZ,
                    float* __restrict__ dalpha_out, int N, int M, int iters) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float sm[];
  float* u = sm;                          // [N]   replay only
  float* lmu = u + N;                     // [N]
  float* lnu = lmu + N;                   // [M]
  float* dv = lnu + M;                    // [M]   adjoint of v_t
  float* part = dv + M;                   // [THREADS]
  float* colmax = part + THREADS;         // [THREADS]
  float* vhist = colmax + THREADS;        // [iters + 1][M]
  float* vbinhist = vhist + static_cast<size_t>(iters + 1) * M;  // [iters + 1]
  float* colacc = vbinhist + (iters + 1); // [kWarps][M]
  __shared__ float red[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2];
  const float* Zb = Z + static_cast<size_t>(b) * N * M;
  const float* dOb = d_out + static_cast<size_t>(b) * N * M;
  float* dZb = dZ + static_cast<size_t>(b) * N * M;
  const float* dbr = d_bin_row + static_cast<size_t>(b) * M;
  const float* dbc = d_bin_col + static_cast<size_t>(b) * N;

  // ---- forward replay, keeping the v-side history (index 0 = start) ----
  for (int i = tid; i < N; i += THREADS) {
    lmu[i] = log_mu[static_cast<size_t>(b) * N + i];
    u[i] = lmu[i] > half_neg ? 0.f : kBigNeg;
  }
  for (int j = tid; j < M; j += THREADS) {
    lnu[j] = log_nu[static_cast<size_t>(b) * M + j];
    vhist[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
  }
  if (tid == 0) vbinhist[0] = 0.f;
  float ubin = 0.f, vbin = 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const float* v = vhist + static_cast<size_t>(it) * M;
    float* v_next = vhist + static_cast<size_t>(it + 1) * M;
    row_pass<C, THREADS>(Zb, lmu, lnu, v, u, N, M, alpha + vbin);
    __syncthreads();
    ubin = lmub - bin_lse<THREADS>(v, M, vbin, alpha, red);
    col_pass<THREADS>(Zb, lmu, lnu, u, v_next, part, colmax, N, M, alpha + ubin);
    vbin = lnub - bin_lse<THREADS>(u, N, ubin, alpha, red);
    if (tid == 0) vbinhist[it + 1] = vbin;
  }
  __syncthreads();

  // ---- adjoints of the outputs ----
  // O = Z + u_T + v_T - norm; Obr = a + ubin_T + v_T - norm;
  // Obc = a + u_T + vbin_T - norm; Oc = a + ubin_T + vbin_T - norm.
  float s = 0.f;
  for (int j = tid; j < M; j += THREADS) s += dbr[j];
  const float sum_dbr = block_sum<THREADS>(s, red);
  s = 0.f;
  for (int i = tid; i < N; i += THREADS) s += dbc[i];
  const float sum_dbc = block_sum<THREADS>(s, red);
  const float dc = d_corner[b];
  float dalpha = sum_dbr + sum_dbc + dc;
  float dvbin = sum_dbc + dc;
  const float dubin_out = sum_dbr + dc;

  // dv_T[j] = sum_i dO[i][j] + dbr[j]: column sums by the row sweep's scheme
  {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int i = warp; i < N; i += kWarps) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) acc[c] += __ldg(dOb + static_cast<size_t>(i) * M + j);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < M) colacc[warp * M + lane + 32 * c] = acc[c];
    __syncthreads();
    for (int j = tid; j < M; j += THREADS) {
      float t = dbr[j];
      for (int w = 0; w < kWarps; ++w) t += colacc[w * M + j];
      dv[j] = t;
    }
    if (iters == 0)   // no iteration: dZ is dO
      for (size_t idx = tid; idx < static_cast<size_t>(N) * M; idx += THREADS)
        dZb[idx] = dOb[idx];
    __syncthreads();
  }

  // ---- adjoint recursion, t = iters .. 1 ----
  for (int t = iters; t >= 1; --t) {
    const float* v_t = vhist + static_cast<size_t>(t) * M;
    const float* v_prev = vhist + static_cast<size_t>(t - 1) * M;
    const float vbin_t = vbinhist[t], vbin_prev = vbinhist[t - 1];
    const bool is_last = t == iters;
    const float* gsrc = is_last ? dOb : dZb;
    // ubin_t again from v_prev, as the replay formed it
    const float rb = bin_lse<THREADS>(v_prev, M, vbin_prev, alpha, red);
    const float ubin_t = lmub - rb;
    // step 4: vbin_t = lnub - cb, cb = lse_i([a + u_t ; a + ubin_t])
    const float cb = lnub - vbin_t;
    float dubin = (is_last ? dubin_out : 0.f) + (-dvbin) * expf(alpha + ubin_t - cb);
    dalpha += -dvbin;
    // step 3, bin part: v_t = lnu - c, c_j = lse_i([Z + u_t ; a + ubin_t])
    s = 0.f;
    for (int j = tid; j < M; j += THREADS)
      s += expf(alpha + ubin_t - (lnu[j] - v_t[j])) * (-dv[j]);
    const float pb = block_sum<THREADS>(s, red);
    dubin += pb;
    dalpha += pb;

    // the row sweep: u_t, du, both slab terms of dZ, column sums, sb_t
    const float row_bin = alpha + vbin_prev;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    float sb = 0.f;
    for (int i = warp; i < N; i += kWarps) {
      float z[C], tt[C];
      load_masked_row<C>(z, Zb + static_cast<size_t>(i) * M, lmu[i] > half_neg,
                         lnu, M, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        tt[c] = j < M ? z[c] + v_prev[j] : 0.f;
      }
      const float r = row_lse<C>(tt, M, lane, row_bin);   // as the replay
      const float u_i = lmu[i] - r;
      float g[C];
      float gsum = 0.f, csum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        g[c] = 0.f;
        if (j < M) {
          g[c] = gsrc[static_cast<size_t>(i) * M + j];
          gsum += g[c];
          // step 3: contrib = exp(Z + u_t - c) * (-dv)
          const float contrib = expf(z[c] + u_i - (lnu[j] - v_t[j])) * (-dv[j]);
          csum += contrib;
          g[c] += contrib;
        }
      }
      float du = (-dvbin) * expf(alpha + u_i - cb) + warp_sum(csum);
      if (is_last) du += warp_sum(gsum) + dbc[i];
      // step 1: u_t = lmu - r, r_i = lse_j([Z + v_prev | a + vbin_prev])
      const float ndu = -du;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) {
          const float contrib2 = ndu * expf(tt[c] - r);
          dZb[static_cast<size_t>(i) * M + j] = g[c] + contrib2;
          acc[c] += contrib2;
        }
      }
      if (lane == 0) sb += ndu * expf(row_bin - r);
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (lane + 32 * c < M) colacc[warp * M + lane + 32 * c] = acc[c];
    const float sb_t = block_sum<THREADS>(sb, red);   // barriers inside
    // step 2: ubin_t = lmub - rb, rb = lse_j([a + v_prev | a + vbin_prev])
    for (int j = tid; j < M; j += THREADS) {
      float tsum = (-dubin) * expf(alpha + v_prev[j] - rb);
      for (int w = 0; w < kWarps; ++w) tsum += colacc[w * M + j];
      dv[j] = tsum;
    }
    dvbin = (-dubin) * expf(alpha + vbin_prev - rb) + sb_t;
    dalpha += -dubin;
    dalpha += sb_t;
    __syncthreads();
  }
  if (tid == 0) dalpha_out[b] = dalpha;
}

template <int C, int THREADS>
cudaError_t launch(const float* Z, const float* log_mu, const float* log_nu,
                   const float* scalars, const float* d_out,
                   const float* d_bin_row, const float* d_bin_col,
                   const float* d_corner, float* dZ, float* dalpha, int B, int N,
                   int M, int iters, cudaStream_t stream) {
  const size_t floats = 2 * static_cast<size_t>(N) + 2 * static_cast<size_t>(M) +
                        2 * THREADS + static_cast<size_t>(iters + 1) * (M + 1) +
                        static_cast<size_t>(THREADS / 32) * M;
  const size_t smem = floats * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = sinkhorn_bwd_kernel<C, THREADS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, THREADS, smem, stream>>>(Z, log_mu, log_nu, scalars, d_out,
                                       d_bin_row, d_bin_col, d_corner, dZ,
                                       dalpha, N, M, iters);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdgat

// Z, d_out, dZ [B,N,M]; log_mu, d_bin_col [B,N]; log_nu, d_bin_row [B,M];
// scalars [B,4] = (alpha, log_mu_bin, log_nu_bin, norm); d_corner, dalpha
// [B]; all f32 and contiguous. Returns cudaErrorInvalidValue when the v
// history does not fit a block's shared memory.
extern "C" cudaError_t mdgat_sinkhorn_bwd(
    const void* Z, const void* log_mu, const void* log_nu, const void* scalars,
    const void* d_out, const void* d_bin_row, const void* d_bin_col,
    const void* d_corner, void* dZ, void* dalpha, int B, int N, int M,
    int iters, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || N <= 0 || M <= 0 || iters < 0) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
#define MDGAT_SBWD(C, T)                                                     \
  return launch<C, T>(f(Z), f(log_mu), f(log_nu), f(scalars), f(d_out),      \
                      f(d_bin_row), f(d_bin_col), f(d_corner), g(dZ),        \
                      g(dalpha), B, N, M, iters, stream)
  if (M <= 256) MDGAT_SBWD(8, 1024);
  if (M <= 512) MDGAT_SBWD(16, 512);
  if (M <= 1024) MDGAT_SBWD(32, 512);
#undef MDGAT_SBWD
  return cudaErrorInvalidValue;
}
