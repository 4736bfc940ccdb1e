// Dustbin log-Sinkhorn forward, one thread-block cluster per pair.
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
// Design, carried over from the replay backward (sinkhorn_bwd.cu). The TPU
// kernel pins the pair's block in VMEM; here a pair runs on a cluster of G
// CTAs (1-16; 16 is non-portable), each owning a band of ceil(N / G) rows.
// * Resident (the band of masked Z fits in shared memory, with the vectors;
//   64 x 512 x 512 at G = 8 takes 64 rows, 128 KB): Z is read from HBM
//   once, into the band, and dense written once.
// * Streamed (8 x 1024 x 1024: a band of 1024 columns fits at no G <= 16):
//   every pass reads the band from L2 (8 pairs, 32 MB, stay there).
// * Wide (above 1024 columns, or where a band's vectors do not fit in shared
//   memory): sinkhorn_wide_kernel below, its vectors in a global scratch.
// An iteration:
// 1. rows, a warp a row (load_masked_row / row_lse of sinkhorn_common.cuh):
//    u_i = lmu_i - lse_j([Z + v | alpha + vbin]), CTA-local;
// 2. columns, a thread a column (`groups` threads split the band's rows when
//    the CTA has more threads than columns), over the CTA's band of Z + u;
//    one warp also forms the statistics of u over the band, another the bin
//    row, ubin = lmub - lse_j([alpha + v | alpha + vbin]), which needs only
//    v (every CTA holds all of v);
// 3. the CTAs' column statistics go through distributed shared memory after
//    a cluster barrier, and every CTA adds them in rank order, so all CTAs
//    hold the same v and vbin bits and runs are bit-equal (no atomics). Two
//    exchange buffers alternate: a buffer is written again only after the
//    next barrier, which every CTA reaches after reading it.
// The column logsumexp takes one exchange an iteration: each thread keeps
// (max, sum of exps against that max) over its rows, updated with one expf
// an element (the sum is rescaled when the max moves); the row groups and
// then the CTAs are merged max first. One column pass and one cluster
// barrier an iteration. It rounds differently from the twin's max-first
// order, within its 1e-4; a max-first form (two passes, two barriers) was
// 14-17% slower at the plan's points (PERF.md).
//
// 1024 threads a CTA: 32 warps hide a row's reductions. With 32 columns a
// lane (M > 512) the build spills a few registers and is still faster than
// 512 threads (PERF.md).
//
// What bounds it on the H100: the exp unit and latency. Rows and columns
// take an expf an element each (0.67 G at 64 x 512 x 512 and 20
// iterations: the MUFU's 16 a clock an SM puts the floor near 0.19 ms,
// against 0.040 ms for the bytes of Z and dense); a row is a chain of warp
// reductions; every exchange is a barrier that waits on the slowest CTA and
// remote reads of G partials a column.

#include <cooperative_groups.h>

#include "sinkhorn_common.cuh"

namespace mdgat {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
constexpr int kMaxCols = 1024;   // columns the register arms take
constexpr int kThreads = 1024;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// floats of shared memory a CTA takes (all of it dynamic): the bin scalars
// [4]; lnu, v [M]; lmu, u [band]; the row groups' partial max and sums
// [kThreads] each; two exchange buffers, each a max half and a sum half of
// [M + 4] (index M: the statistics of u); the band of masked Z when
// resident. ops/cuda/sinkhorn.py::fwd_smem_bytes mirrors it.
__host__ __device__ inline size_t fwd_smem_floats(int band, int M, bool resident) {
  const size_t mp = pad4(M);
  return 4 + 2 * mp + 2 * static_cast<size_t>(pad4(band)) + 2 * kThreads +
         4 * (mp + 4) + (resident ? static_cast<size_t>(band) * M : 0);
}

// (m, s), s the sum of exp(x - m) over the values added: adds x with one
// expf (the sum is rescaled when x raises the max)
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  const float d = x - m;
  const float e = expf(-fabsf(d));
  s = d > 0.f ? fmaf(s, e, 1.f) : s + e;
  m = fmaxf(m, x);
}

// (m, s) merged with (m2, s2), max first; an empty side has m = -inf
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <int C, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, const float* __restrict__ scalars,
                float* __restrict__ out, float* __restrict__ bin_row,
                float* __restrict__ bin_col, float* __restrict__ corner, int N,
                int M, int iters) {
  constexpr int kWarps = kThreads / 32;
  constexpr int W = kWarps - 1;    // also forms the statistics of u
  constexpr int WB = kWarps - 2;   // also forms the bin row
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int band = (N + G - 1) / G;
  const int row0 = rank * band;
  const int nb = max(0, min(N, row0 + band) - row0);   // rows of this CTA
  const int mp = pad4(M);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // column work: `span` columns a pass, `groups` threads on each of them,
  // group g taking band rows g, g + groups, ...
  const int span = M < kThreads ? M : kThreads;
  const int groups = kThreads / span;
  const int grp = tid / span, jl = tid - grp * span;

  extern __shared__ __align__(16) float sm[];
  float* bins = sm;                 // [0] the new ubin, [1] the new vbin
  float* lnu = sm + 4;              // [M]
  float* v = lnu + mp;              // [M]
  float* lmu = v + mp;              // [band]
  float* u = lmu + pad4(band);      // [band]
  float* pm = u + pad4(band);       // [kThreads] the row groups' max
  float* ps = pm + kThreads;        // [kThreads] ... and sums
  float* xb = ps + kThreads;        // [2][2][mp + 4] exchange buffers
  float* Zs = xb + 4 * (mp + 4);    // [band][M] masked Z, resident only

  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2], norm = scalars[b * 4 + 3];
  const float* Zb = Z + (static_cast<size_t>(b) * N + row0) * M;

  for (int j = tid; j < M; j += kThreads) {
    lnu[j] = log_nu[static_cast<size_t>(b) * M + j];
    v[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
  }
  for (int il = tid; il < nb; il += kThreads) {
    lmu[il] = log_mu[static_cast<size_t>(b) * N + row0 + il];
    u[il] = lmu[il] > half_neg ? 0.f : kBigNeg;
  }
  __syncthreads();
  if constexpr (RES) {
    for (int il = warp; il < nb; il += kWarps) {
      float z[C];
      load_masked_row<C>(z, Zb + static_cast<size_t>(il) * M, lmu[il] > half_neg,
                         lnu, M, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) Zs[il * M + j] = z[c];
      }
    }
    __syncthreads();
  }

  // masked Z of band row il, column j (cv: column j is valid)
  auto zat = [&](int il, int j, bool cv) -> float {
    if constexpr (RES) return Zs[il * M + j];
    else
      return (cv && lmu[il] > half_neg) ? __ldg(Zb + static_cast<size_t>(il) * M + j)
                                        : kBigNeg;
  };
  // f(Z_ij + u_i) over this thread's band rows of column j, kBatch loads
  // issued before any is used
  auto column = [&](int j, auto&& f) {
    const bool cv = lnu[j] > half_neg;
    for (int il0 = grp; il0 < nb; il0 += kBatch * groups) {
      float zr[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int il = il0 + r * groups;
        zr[r] = il < nb ? zat(il, j, cv) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int il = il0 + r * groups;
        if (il < nb) f(zr[r] + u[il]);
      }
    }
  };
  // the bin row's update from v and vbin, into bins[0]
  auto bin_row_update = [&](float vbin) {
    float t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      t[c] = j < M ? v[j] : 0.f;
    }
    const float rb = row_lse<C>(t, M, lane, vbin) + alpha;
    if (lane == 0) bins[0] = lmub - rb;
  };
  auto remote = [&](const float* p, int r) { return *cluster.map_shared_rank(p, r); };
  auto xbuf = [&](int sel) { return xb + sel * 2 * (mp + 4); };
  const int xsum = mp + 4;          // the sum half of a buffer

  float ubin = 0.f, vbin = 0.f;
  int xsel = 0;
  for (int it = 0; it < iters; ++it) {
    // 1. u_i = lmu_i - lse_j([Z + v | alpha + vbin]), a warp a row
    const float row_bin = alpha + vbin;
    for (int il = warp; il < nb; il += kWarps) {
      float t[C];
      if constexpr (RES) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          t[c] = j < M ? Zs[il * M + j] + v[j] : 0.f;
        }
      } else {
        load_masked_row<C>(t, Zb + static_cast<size_t>(il) * M,
                           lmu[il] > half_neg, lnu, M, lane);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          if (j < M) t[c] += v[j];
        }
      }
      const float r = row_lse<C>(t, M, lane, row_bin);
      if (lane == 0) u[il] = lmu[il] - r;
    }
    __syncthreads();

    // 2. (max, sum of exps) of Z + u over this CTA's rows, a column a thread
    float* X = xbuf(xsel);
    for (int j0 = 0; j0 < M; j0 += span) {
      const int j = j0 + jl;
      float m = -CUDART_INF_F, s = 0.f;
      const bool mine = grp < groups && j < M;
      if (mine) column(j, [&](float x) { online_add(m, s, x); });
      if (groups == 1) {
        // 512 < M < 1024: the threads past the span hold no column
        if (mine) { X[j] = m; X[xsum + j] = s; }
      } else {
        pm[tid] = m;
        ps[tid] = s;
      }
    }
    if (warp == W) {              // u over the band, into index M
      float m = -CUDART_INF_F, s = 0.f;
      for (int il = lane; il < nb; il += 32) online_add(m, s, u[il]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(kFull, m, o);
        const float s2 = __shfl_xor_sync(kFull, s, o);
        lse_merge(m, s, m2, s2);
      }
      if (lane == 0) { X[M] = m; X[xsum + M] = s; }
    }
    if (warp == WB) bin_row_update(vbin);
    if (groups > 1) {             // one chunk of columns: span = M
      __syncthreads();
      if (grp == 0) {
        float m = pm[jl];
        for (int g = 1; g < groups; ++g) m = fmaxf(m, pm[g * span + jl]);
        float s = 0.f;
        for (int g = 0; g < groups; ++g) {
          const float mg = pm[g * span + jl];
          if (mg > -CUDART_INF_F) s += ps[g * span + jl] * expf(mg - m);
        }
        X[jl] = m;
        X[xsum + jl] = s;
      }
    }
    cluster.sync();
    // 3. the CTAs' statistics in rank order: v, and vbin from index M
    const float ubin_new = bins[0];
    const float col_bin = alpha + ubin_new;
    auto merged = [&](int j, float bin) {   // lse over the cluster and bin
      float xm[kMaxCluster], xs[kMaxCluster];
      float mx = bin;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < G) {
          xm[r] = remote(X + j, r);
          xs[r] = remote(X + xsum + j, r);
          mx = fmaxf(mx, xm[r]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < G) s += xs[r] * expf(xm[r] - mx);
      return logf(s + expf(bin - mx)) + mx;
    };
    for (int j = tid; j < M; j += kThreads) v[j] = lnu[j] - merged(j, col_bin);
    if (tid == kThreads - 1) bins[1] = lnub - (merged(M, ubin_new) + alpha);
    ubin = ubin_new;
    xsel ^= 1;
    __syncthreads();
    vbin = bins[1];
  }
  cluster.sync();   // no CTA leaves while another may read its buffers

  // dense = Z + u + v - norm over the band; the bin column; rank 0 the bin
  // row and the corner
  float* ob = out + (static_cast<size_t>(b) * N + row0) * M;
  for (int il = warp; il < nb; il += kWarps) {
    const float ui = u[il];
    for (int j = lane; j < M; j += 32)
      ob[static_cast<size_t>(il) * M + j] = zat(il, j, lnu[j] > half_neg) + ui + v[j] - norm;
    if (lane == 0) bin_col[static_cast<size_t>(b) * N + row0 + il] = alpha + ui + vbin - norm;
  }
  if (rank == 0) {
    for (int j = tid; j < M; j += kThreads)
      bin_row[static_cast<size_t>(b) * M + j] = alpha + ubin + v[j] - norm;
    if (tid == 0) corner[b] = alpha + ubin + vbin - norm;
  }
}

// ---- the wide arm: more than 1024 columns, or a band whose vectors do not
// fit in shared memory ----
//
// The same iteration and the same exchange in rank order, with what the
// register arms keep on chip moved out: a row's logsumexp loops over its
// columns (max first, then the sum of exps, as row_lse does), a thread
// walks its columns in chunks of kThreads, and v, u and the two exchange
// buffers live in a global scratch of wide_fwd_floats a CTA that the
// wrapper allocates (the CTAs of a cluster read each other's buffers from
// L2 after the cluster barrier, whose release / acquire orders them). Z is
// streamed. Only device memory limits N and M. Simple, not tuned.

// floats of the wide arm's scratch a CTA: v [M], u [band], two exchange
// buffers of a max half and a sum half [M + 4] each (index M: u's
// statistics)
__host__ __device__ inline size_t wide_fwd_floats(int band, int M) {
  const size_t mp = pad4(M);
  return mp + pad4(band) + 4 * (mp + 4);
}

__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_wide_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                     const float* __restrict__ log_nu,
                     const float* __restrict__ scalars, float* __restrict__ out,
                     float* __restrict__ bin_row, float* __restrict__ bin_col,
                     float* __restrict__ corner, float* __restrict__ scratch,
                     int N, int M, int iters) {
  constexpr int kWarps = kThreads / 32;
  constexpr int W = kWarps - 1;    // also forms the statistics of u
  constexpr int WB = kWarps - 2;   // also forms the bin row
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int band = (N + G - 1) / G;
  const int row0 = rank * band;
  const int nb = max(0, min(N, row0 + band) - row0);
  const int mp = pad4(M);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t per_cta = wide_fwd_floats(band, M);
  auto cta = [&](int r) { return scratch + (static_cast<size_t>(b) * G + r) * per_cta; };
  float* v = cta(rank);                 // [M]
  float* u = v + mp;                    // [band]
  const size_t xoff = mp + pad4(band);  // the exchange buffers
  const int xsum = mp + 4;
  __shared__ float bins[2];             // the new ubin, the new vbin

  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2], norm = scalars[b * 4 + 3];
  const float* lnu = log_nu + static_cast<size_t>(b) * M;
  const float* lmu = log_mu + static_cast<size_t>(b) * N + row0;
  const float* Zb = Z + (static_cast<size_t>(b) * N + row0) * M;

  for (int j = tid; j < M; j += kThreads) v[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
  for (int il = tid; il < nb; il += kThreads) u[il] = lmu[il] > half_neg ? 0.f : kBigNeg;
  __syncthreads();

  auto zat = [&](int il, int j) -> float {   // masked Z of band row il
    return (lnu[j] > half_neg && lmu[il] > half_neg)
               ? __ldg(Zb + static_cast<size_t>(il) * M + j) : kBigNeg;
  };
  // logsumexp over [x_j for j < M | bin], one warp, max first
  auto warp_lse = [&](auto&& x, float bin) {
    float m = -CUDART_INF_F;
    for (int j = lane; j < M; j += 32) m = fmaxf(m, x(j));
    const float mm = fmaxf(warp_max(m), bin);
    float s = 0.f;
    for (int j = lane; j < M; j += 32) s += expf(x(j) - mm);
    return logf(warp_sum(s) + expf(bin - mm)) + mm;
  };

  float ubin = 0.f, vbin = 0.f;
  int xsel = 0;
  for (int it = 0; it < iters; ++it) {
    // 1. u_i = lmu_i - lse_j([Z + v | alpha + vbin]), a warp a row
    const float row_bin = alpha + vbin;
    for (int il = warp; il < nb; il += kWarps) {
      const float r = warp_lse([&](int j) { return zat(il, j) + v[j]; }, row_bin);
      if (lane == 0) u[il] = lmu[il] - r;
    }
    __syncthreads();

    // 2. (max, sum of exps) of Z + u over this CTA's rows, a column a thread
    float* X = cta(rank) + xoff + xsel * 2 * (mp + 4);
    for (int j = tid; j < M; j += kThreads) {
      float m = -CUDART_INF_F, s = 0.f;
      for (int il0 = 0; il0 < nb; il0 += kBatch) {
        float zr[kBatch];
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
          zr[r] = il0 + r < nb ? zat(il0 + r, j) : 0.f;
#pragma unroll
        for (int r = 0; r < kBatch; ++r)
          if (il0 + r < nb) online_add(m, s, zr[r] + u[il0 + r]);
      }
      X[j] = m;
      X[xsum + j] = s;
    }
    if (warp == W) {              // u over the band, into index M
      float m = -CUDART_INF_F, s = 0.f;
      for (int il = lane; il < nb; il += 32) online_add(m, s, u[il]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(kFull, m, o);
        const float s2 = __shfl_xor_sync(kFull, s, o);
        lse_merge(m, s, m2, s2);
      }
      if (lane == 0) { X[M] = m; X[xsum + M] = s; }
    }
    if (warp == WB) {             // the bin row from v and vbin
      const float rb = warp_lse([&](int j) { return v[j]; }, vbin) + alpha;
      if (lane == 0) bins[0] = lmub - rb;
    }
    cluster.sync();
    // 3. the CTAs' statistics in rank order: v, and vbin from index M
    const float ubin_new = bins[0];
    const float col_bin = alpha + ubin_new;
    const size_t xat = xoff + xsel * 2 * (mp + 4);
    auto merged = [&](int j, float bin) {   // lse over the cluster and bin
      float xm[kMaxCluster], xs[kMaxCluster];
      float mx = bin;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < G) {
          xm[r] = __ldcg(cta(r) + xat + j);
          xs[r] = __ldcg(cta(r) + xat + xsum + j);
          mx = fmaxf(mx, xm[r]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < G) s += xs[r] * expf(xm[r] - mx);
      return logf(s + expf(bin - mx)) + mx;
    };
    for (int j = tid; j < M; j += kThreads) v[j] = lnu[j] - merged(j, col_bin);
    if (tid == kThreads - 1) bins[1] = lnub - (merged(M, ubin_new) + alpha);
    ubin = ubin_new;
    xsel ^= 1;
    __syncthreads();
    vbin = bins[1];
  }
  cluster.sync();   // no CTA leaves while another may read its buffers

  float* ob = out + (static_cast<size_t>(b) * N + row0) * M;
  for (int il = warp; il < nb; il += kWarps) {
    const float ui = u[il];
    for (int j = lane; j < M; j += 32)
      ob[static_cast<size_t>(il) * M + j] = zat(il, j) + ui + v[j] - norm;
    if (lane == 0) bin_col[static_cast<size_t>(b) * N + row0 + il] = alpha + ui + vbin - norm;
  }
  if (rank == 0) {
    for (int j = tid; j < M; j += kThreads)
      bin_row[static_cast<size_t>(b) * M + j] = alpha + ubin + v[j] - norm;
    if (tid == 0) corner[b] = alpha + ubin + vbin - norm;
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        float*, float*, float*, float*, int, int, int);

// the instantiation for M columns (C = ceil(M / 32) rounded up to 8, 16,
// 32 a lane), resident or streamed
Kernel pick_kernel(int M, bool res) {
  if (M <= 256) return res ? sinkhorn_kernel<8, true> : sinkhorn_kernel<8, false>;
  if (M <= 512) return res ? sinkhorn_kernel<16, true> : sinkhorn_kernel<16, false>;
  return res ? sinkhorn_kernel<32, true> : sinkhorn_kernel<32, false>;
}

bool fits_resident(int N, int M, int G) {
  const int band = (N + G - 1) / G;
  return fwd_smem_floats(band, M, true) * sizeof(float) <= kMaxSmem;
}

// the wide arm: more columns than a register arm holds, or a band whose
// vectors do not fit in shared memory even streamed
bool wide_arm(int N, int M, int G) {
  const int band = (N + G - 1) / G;
  return M > kMaxCols || fwd_smem_floats(band, M, false) * sizeof(float) > kMaxSmem;
}

bool valid_args(int N, int M, int G) {
  return N > 0 && M > 0 && G >= 1 && G <= kMaxCluster;
}

// the launch configuration of a pair a cluster of G CTAs; sets the kernel's
// shared-memory cap (and the non-portable cluster size above 8)
template <typename K>
cudaError_t configure(K kernel, int B, int G, size_t smem, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && G > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(B * G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

size_t smem_bytes(int N, int M, int G, bool res) {
  return fwd_smem_floats((N + G - 1) / G, M, res) * sizeof(float);
}

}  // namespace
}  // namespace mdgat

// Z [B,N,M] raw scores, log_mu [B,N], log_nu [B,M], scalars [B,4] =
// (alpha, log_mu_bin, log_nu_bin, norm), all f32 and contiguous. Outputs:
// dense [B,N,M], bin_row [B,M], bin_col [B,N], corner [B]. cluster: the CTAs
// a pair (1-16), which the plan (ops/cuda/sinkhorn.py::sinkhorn_plan)
// picks. The band stays resident wherever it fits. Takes every iteration
// count and every N and M: the wide arm (above 1024 columns, or where the
// vectors of a band do not fit in shared memory) takes a scratch of
// B * cluster * wide_fwd_floats floats (ops/cuda/sinkhorn.py::
// fwd_scratch_floats), null otherwise.
extern "C" cudaError_t mdgat_sinkhorn(const void* Z, const void* log_mu,
                                      const void* log_nu, const void* scalars,
                                      void* out, void* bin_row, void* bin_col,
                                      void* corner, void* scratch,
                                      long long scratch_floats, int B, int N,
                                      int M, int iters, int cluster,
                                      cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || iters < 0 || !valid_args(N, M, cluster))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (wide_arm(N, M, cluster)) {
    const size_t need = static_cast<size_t>(B) * cluster *
                        wide_fwd_floats((N + cluster - 1) / cluster, M);
    if (scratch == nullptr || static_cast<size_t>(scratch_floats) < need)
      return cudaErrorInvalidValue;
    cudaError_t err = configure(sinkhorn_wide_kernel, B, cluster, 0, stream, cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaLaunchKernelEx(&cfg, sinkhorn_wide_kernel, f(Z), f(log_mu), f(log_nu),
                              f(scalars), g(out), g(bin_row), g(bin_col), g(corner),
                              g(scratch), N, M, iters);
  }
  const bool res = fits_resident(N, M, cluster);
  const Kernel kernel = pick_kernel(M, res);
  cudaError_t err = configure(kernel, B, cluster, smem_bytes(N, M, cluster, res),
                              stream, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, f(Z), f(log_mu), f(log_nu), f(scalars),
                            g(out), g(bin_row), g(bin_col), g(corner), N, M, iters);
}

// *count = how many clusters of that launch the card holds at once
// (cudaOccupancyMaxActiveClusters): the waves of a batch are ceil(B / it).
extern "C" cudaError_t mdgat_sinkhorn_active_clusters(int N, int M, int cluster,
                                                      int* count) {
  using namespace mdgat;
  if (!valid_args(N, M, cluster) || count == nullptr)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (wide_arm(N, M, cluster)) {
    cudaError_t err = configure(sinkhorn_wide_kernel, 1, cluster, 0, nullptr, cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(count, sinkhorn_wide_kernel, &cfg);
  }
  const bool res = fits_resident(N, M, cluster);
  const Kernel kernel = pick_kernel(M, res);
  cudaError_t err = configure(kernel, 1, cluster, smem_bytes(N, M, cluster, res),
                              nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}
