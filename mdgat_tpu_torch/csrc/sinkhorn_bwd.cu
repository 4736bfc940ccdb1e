// Dustbin log-Sinkhorn backward: exact reverse mode through the unrolled
// iterations, one thread-block cluster per pair.
//
// Replaces the TPU kernel mdgat_tpu/ops/pallas/sinkhorn.py::_bwd_kernel
// (reached from _ot_trainable through _bwd_call). Same algorithm: replay
// the forward iterations keeping a history, then walk the adjoint from the
// last iteration to the first. Step t takes the potentials u_t, ubin_t with
// the bits the replay formed from v_{t-1} (below: History), and rebuilds
// the softmax weights of the column updates from the potentials (c =
// log_nu - v_t, cb = log_nu_bin - vbin_t).
// Outputs: dZ [B, N, M] (the wrapper zeroes it outside the valid block) and
// dalpha [B].
//
// Design. The TPU kernel pins Z, dO and dZ in VMEM. Here a pair runs on a
// cluster of G CTAs (G = 8 portable, 16 non-portable), each owning a band
// of ceil(N / G) rows; a warp owns whole rows (C columns a lane).
// * Resident (the band fits; the plan at 64 x 512 x 512, G = 8): the CTA
//   keeps its band of masked Z in shared memory for every pass (64 rows,
//   128 KB) and its band of dZ in registers (R rows a warp, 1024 threads:
//   32 dZ floats a thread); dO is read once, into those registers, and dZ
//   written once.
// * Streamed (e.g. 8 x 1024 x 1024): 512 threads, the same passes read Z
//   from L2 / HBM into registers and keep dZ in global memory.
// * Wide (above 1024 columns, or a streamed band too long for shared
//   memory): sinkhorn_bwd_wide_kernel below, its vectors in a global scratch.
// A replayed iteration sweeps the band twice: the row logsumexp (u_i) with
// the column max of Z + u on the same row at hand, then the column sums of
// exps. Column work is per-warp partials in shared memory, added in warp
// order into per-CTA partials, exchanged through distributed shared memory
// after a cluster barrier and added in CTA-rank order by every CTA: the
// column max (and the max of u), the column sums of exps (and of u), and
// in the reverse step the column sums of contrib2 (and the bin terms). So
// every CTA holds the same v and dv bits, runs are bit-equal, and no
// atomics are used. Two exchange buffers alternate: a buffer is written
// again only after the next barrier, which every CTA reaches after reading
// it. The CTA-local sums (the bin row's sum of exps in the replay, pb in the
// reverse step) ride on the exchange's own barrier.
// History: a global scratch that the wrapper allocates (hist_floats) holds
// v_t, vbin_t and the bin row's logsumexp rb_t of every iteration, and each
// row's logsumexp r_i; the replay writes them, the barriers order them
// before the reverse walk, which reads them a step ahead. So step t takes
// u_t = lmu - r and ubin_t = lmub - rb with the bits the replay formed, as
// recomputing them from v_{t-1} by the same functions would, without a
// second row logsumexp. The history's size (43 KB + 41 KB a pair at 20
// iterations and N = M = 512) limits neither shared memory nor the
// iteration count.
//
// What bounds it on the H100: latency. An iteration replayed takes 2 expf
// an element and a reverse step 2 (80 an element at 20 iterations, 1.3 G a
// launch over every entry at 64 x 512 x 512: the MUFU, 16 a clock an SM,
// an eighth of the FMA rate, puts the floor near 0.36 ms, against the
// 0.094 of a bound that counts an expf as one FMA-rate operation, as the
// smoke's bound does). The sweeps run at about a
// third of the issue rate: a row is a chain of warp reductions, two rows a
// warp; then three cluster exchanges an iteration pair, each a barrier that
// waits on the slowest CTA and remote reads of G partials a column. 64
// pairs on 15 clusters of 8 (what the card holds at once) take 5 waves for
// 4.3 waves of work. The resident plan reads Z and dO once from HBM and
// writes dZ once.

#include <cooperative_groups.h>

#include "sinkhorn_common.cuh"

namespace mdgat {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
constexpr int kMaxCols = 1024;   // columns the register arms take

// threads a CTA: resident, 1024 (two rows a warp at C = 16, so 32 warps an
// SM hide the latency of a row's chain of reductions); streamed, 512 (a row
// of z and dZ in registers at C = 32)
__host__ __device__ constexpr int threads_for(int R) { return R > 0 ? 1024 : 512; }
// rows a warp keeps resident at C columns a lane (32 dZ floats a thread);
// none at C = 32
__host__ __device__ constexpr int resident_rows(int C) {
  return C == 8 ? 4 : C == 16 ? 2 : 0;
}
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// floats of shared memory a CTA takes for a band of `band` rows: lnu, v,
// v_prev, dv [M]; two exchange buffers [M + 4]; lmu, u [band]; the warps'
// column partials [warps][M]; the band of Z when resident
__host__ __device__ inline size_t smem_floats(int band, int M, int R) {
  const size_t mp = pad4(M);
  return 4 * mp + 2 * (mp + 4) + 2 * static_cast<size_t>(pad4(band)) +
         threads_for(R) / 32 * mp + (R > 0 ? static_cast<size_t>(band) * M : 0);
}
// floats of the history scratch a pair: [iters + 1][M + 2] (v_t, vbin_t
// and rb_t = lse_j([a + v_t | a + vbin_t]) of iteration t), then each row's
// logsumexp [iters][N]
__host__ __device__ inline size_t hist_floats(int N, int M, int iters) {
  return static_cast<size_t>(iters + 1) * (M + 2) + static_cast<size_t>(iters) * N;
}

// R > 0: resident, R rows a warp; R == 0: streamed
template <int C, int R>
__global__ void __launch_bounds__(threads_for(R), 1)
sinkhorn_bwd_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                    const float* __restrict__ log_nu,
                    const float* __restrict__ scalars,
                    const float* __restrict__ d_out, const float* __restrict__ d_bin_row,
                    const float* __restrict__ d_bin_col,
                    const float* __restrict__ d_corner, float* __restrict__ dZ,
                    float* __restrict__ dalpha_out, float* __restrict__ hist,
                    int N, int M, int iters) {
  constexpr bool kResident = R > 0;
  constexpr int kThreads = threads_for(R), kWarps = kThreads / 32;
  constexpr int kCols = (kMaxCols + kThreads - 1) / kThreads;   // columns a thread owns
  constexpr int kRowsAhead = 2;                // band rows a thread prefetches
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int band = (N + G - 1) / G;
  const int row0 = rank * band;
  const int nb = max(0, min(N, row0 + band) - row0);   // rows of this CTA
  const int mp = pad4(M);
  const int hs = M + 2;                   // history row: v [M], vbin, rb

  extern __shared__ __align__(16) float sm[];
  float* lnu = sm;                        // [M]
  float* vc = lnu + mp;                   // [M] replay: v; reverse: -(lnu - v_t)
  float* vp = vc + mp;                    // [M] reverse: v_{t-1}
  float* dv = vp + mp;                    // [M] replay: column max; reverse: dv_t
  float* xb = dv + mp;                    // [2][M + 4] exchange buffers
  float* lmu = xb + 2 * (mp + 4);         // [band]
  float* u = lmu + pad4(band);            // [band] replay: u; reverse: r
  float* colacc = u + pad4(band);         // [kWarps][M] warps' column partials
  float* Zs = colacc + kWarps * mp;       // [band][M] masked Z, resident only
  // per-warp scalars: wred goes through the exchange (summed or maxed over
  // the cluster), wsum stays in the CTA (loc_sum); vmax: the warps' max of v
  __shared__ float wred[kWarps], wsum[kWarps], vmax[kWarps], red[kWarps];
  __shared__ float loc_sum;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2];
  const float* Zb = Z + (static_cast<size_t>(b) * N + row0) * M;
  const float* dOb = d_out + (static_cast<size_t>(b) * N + row0) * M;
  float* dZb = dZ + (static_cast<size_t>(b) * N + row0) * M;
  const float* dbr = d_bin_row + static_cast<size_t>(b) * M;
  const float* dbc = d_bin_col + static_cast<size_t>(b) * N;
  float* hb = hist + static_cast<size_t>(b) * hist_floats(N, M, iters);
  float* rh = hb + static_cast<size_t>(iters + 1) * hs + row0;
  float* acc = colacc + warp * mp;        // this warp's column partials

  // masked Z of band row il: streamed, loaded into z; resident, read from
  // shared memory where it is used (z unused)
  auto zload = [&](float (&z)[C], int il) {
    if constexpr (!kResident)
      load_masked_row<C>(z, Zb + static_cast<size_t>(il) * M,
                         lmu[il] > half_neg, lnu, M, lane);
  };
  auto zval = [&](const float (&z)[C], int il, int c) {
    if constexpr (kResident) return Zs[il * M + lane + 32 * c];
    else return z[c];
  };
  // the rows of this warp: band rows warp, warp + kWarps, ...
  auto each_row = [&](auto&& body) {
    if constexpr (kResident) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int il = warp + kWarps * r;
        if (il < nb) body(il);
      }
    } else {
      for (int il = warp; il < nb; il += kWarps) body(il);
    }
  };
  // exchange buffer `xsel` of every CTA of the cluster, in rank order
  int xsel = 0;
  auto xbuf = [&](int sel) { return xb + sel * (mp + 4); };
  auto cluster_max = [&](int at) {
    float* mine = xbuf(xsel) + at;
    float m = -CUDART_INF_F;
#pragma unroll 4
    for (int r = 0; r < G; ++r) m = fmaxf(m, *cluster.map_shared_rank(mine, r));
    return m;
  };
  auto cluster_sum = [&](int at, float s) {   // s + the entries, rank order
    float* mine = xbuf(xsel) + at;
#pragma unroll 4
    for (int r = 0; r < G; ++r) s += *cluster.map_shared_rank(mine, r);
    return s;
  };
  // After the barrier: the warps' column partials and wred (added in warp
  // order, or their max) in this CTA's exchange buffer, wsum added in warp
  // order in loc_sum; then the cluster barrier, after which every CTA reads
  // every CTA's buffer and loc_sum.
  auto post = [&](bool is_max) {
    __syncthreads();
    float* X = xbuf(xsel);
    for (int j = tid; j < M; j += kThreads) {
      float t = colacc[j];
      for (int w = 1; w < kWarps; ++w)
        t = is_max ? fmaxf(t, colacc[w * mp + j]) : t + colacc[w * mp + j];
      X[j] = t;
    }
    if (tid == 0) {
      float t = wred[0];
      for (int w = 1; w < kWarps; ++w) t = is_max ? fmaxf(t, wred[w]) : t + wred[w];
      X[mp] = t;
    } else if (tid == 32) {
      float t = wsum[0];
      for (int w = 1; w < kWarps; ++w) t += wsum[w];
      loc_sum = t;
    }
    cluster.sync();
  };
  // this thread's columns of v: their max, per warp, into vmax
  auto v_max = [&]() {
    float m = -CUDART_INF_F;
    for (int j = tid; j < M; j += kThreads) m = fmaxf(m, vc[j]);
    m = warp_max(m);
    if (lane == 0) vmax[warp] = m;
  };

  // ---- set-up: marginals, v_0, the band of masked Z ----
  for (int j = tid; j < M; j += kThreads) {
    lnu[j] = log_nu[static_cast<size_t>(b) * M + j];
    vc[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
    if (rank == 0) hb[j] = vc[j];
  }
  v_max();
  for (int il = tid; il < nb; il += kThreads)
    lmu[il] = log_mu[static_cast<size_t>(b) * N + row0 + il];
  if (rank == 0 && tid == 0) hb[M] = 0.f;
  __syncthreads();
  if constexpr (kResident) {
    for (int i = tid; i < nb * M; i += kThreads) {
      const int il = i / M, j = i % M;
      const float z = __ldg(Zb + i);
      Zs[i] = (lmu[il] > half_neg && lnu[j] > half_neg) ? z : kBigNeg;
    }
    __syncthreads();
  }

  // ---- forward replay, keeping the history (index 0 = start) ----
  float vbin = 0.f;
  for (int it = 0; it < iters; ++it) {
    // the bin row: rb = lse_j([a + v | a + vbin]), its sum of exps per warp
    // now, added up in the next exchange
    float mx = vmax[0];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, vmax[w]);
    mx = fmaxf(mx, vbin);
    {
      float e = 0.f;
      for (int j = tid; j < M; j += kThreads) e += expf(vc[j] - mx);
      e = warp_sum(e);
      if (lane == 0) wsum[warp] = e;
    }
    // row pass: u_i = lmu_i - lse_j([Z + v | alpha + vbin]) (its logsumexp
    // kept for the reverse walk); with the row still at hand, the column max
    // of Z + u over this warp's rows
    const float row_bin = alpha + vbin;
    {
      float cm[C];
#pragma unroll
      for (int c = 0; c < C; ++c) cm[c] = -CUDART_INF_F;
      float wu = -CUDART_INF_F;
      each_row([&](int il) {
        float z[C], t[C];
        zload(z, il);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          t[c] = j < M ? zval(z, il, c) + vc[j] : 0.f;
        }
        const float r = row_lse<C>(t, M, lane, row_bin);
        const float ui = lmu[il] - r;
        if (lane == 0) {
          u[il] = ui;
          rh[static_cast<size_t>(it) * N + il] = r;
        }
        wu = fmaxf(wu, ui);
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (lane + 32 * c < M) cm[c] = fmaxf(cm[c], zval(z, il, c) + ui);
      });
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (lane + 32 * c < M) acc[lane + 32 * c] = cm[c];
      if (lane == 0) wred[warp] = wu;
    }
    post(true);                           // column max, max of u; bin row sum
    const float rb = logf(loc_sum + expf(vbin - mx)) + mx + alpha;
    const float ubin = lmub - rb;
    const float col_bin = alpha + ubin;
    if (rank == 0 && tid == 0) hb[static_cast<size_t>(it) * hs + M + 1] = rb;
    for (int j = tid; j < M; j += kThreads) dv[j] = fmaxf(cluster_max(j), col_bin);
    const float umx = fmaxf(cluster_max(mp), ubin);
    xsel ^= 1;
    __syncthreads();                      // the column max is in dv
    // sums of exps over this warp's rows: columns, and u
    {
      float cs[C];
#pragma unroll
      for (int c = 0; c < C; ++c) cs[c] = 0.f;
      float wus = 0.f;
      each_row([&](int il) {
        float z[C];
        zload(z, il);
        const float ui = u[il];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          if (j < M) cs[c] += expf(zval(z, il, c) + ui - dv[j]);
        }
        wus += expf(ui - umx);
      });
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (lane + 32 * c < M) acc[lane + 32 * c] = cs[c];
      if (lane == 0) wred[warp] = wus;
    }
    post(false);
    float* hn = hb + static_cast<size_t>(it + 1) * hs;
    for (int j = tid; j < M; j += kThreads) {
      const float s = cluster_sum(j, 0.f) + expf(col_bin - dv[j]);
      vc[j] = lnu[j] - (logf(s) + dv[j]);
      if (rank == 0) hn[j] = vc[j];
    }
    v_max();
    const float su = cluster_sum(mp, 0.f);
    vbin = lnub - (logf(su + expf(ubin - umx)) + umx + alpha);
    if (rank == 0 && tid == 0) hn[M] = vbin;
    xsel ^= 1;
    __syncthreads();
  }

  // ---- adjoints of the outputs ----
  // O = Z + u_T + v_T - norm; Obr = a + ubin_T + v_T - norm;
  // Obc = a + u_T + vbin_T - norm; Oc = a + ubin_T + vbin_T - norm.
  float s = 0.f;
  for (int j = tid; j < M; j += kThreads) s += dbr[j];
  const float sum_dbr = block_sum<kThreads>(s, red);
  s = 0.f;
  for (int i = tid; i < N; i += kThreads) s += dbc[i];
  const float sum_dbc = block_sum<kThreads>(s, red);
  const float dc = d_corner[b];
  float dalpha = sum_dbr + sum_dbc + dc;
  float dvbin = sum_dbc + dc;
  const float dubin_out = sum_dbr + dc;

  // the band of dZ: registers (resident) or global memory, starting at dO;
  // dv_T[j] = sum_i dO[i][j] + dbr[j]
  float dzr[kResident ? R : 1][C];
  for (int j = lane; j < M; j += 32) acc[j] = 0.f;
  auto load_do = [&](int il, float (&g)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      g[c] = j < M ? __ldg(dOb + static_cast<size_t>(il) * M + j) : 0.f;
      if (j < M) acc[j] += g[c];
      if (!kResident && iters == 0 && j < M)   // no iteration: dZ is dO
        dZb[static_cast<size_t>(il) * M + j] = g[c];
    }
  };
  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int il = warp + kWarps * r;
      if (il < nb) load_do(il, dzr[r]);
    }
  } else {
    for (int il = warp; il < nb; il += kWarps) {
      float g[C];
      load_do(il, g);
    }
  }
  if (lane == 0) wred[warp] = 0.f;
  post(false);
  for (int j = tid; j < M; j += kThreads) dv[j] = cluster_sum(j, dbr[j]);
  xsel ^= 1;

  // The history a step ahead, this thread's columns and band rows: when
  // step t starts, vp holds v_t and `ahead` v_{t-1}, vbin and rb of t - 1,
  // r_ahead the rows' logsumexp of step t.
  float ahead[kCols], r_ahead[kRowsAhead];
  float vbin_t = 0.f, vbin_ahead = 0.f, rb_ahead = 0.f;
  auto fetch_v = [&](int t) {             // v_t, vbin_t, rb_t
    const float* h = hb + static_cast<size_t>(t) * hs;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = tid + q * kThreads;
      if (j < M) ahead[q] = __ldcg(h + j);
    }
    vbin_ahead = __ldcg(h + M);
    rb_ahead = __ldcg(h + M + 1);
  };
  auto fetch_r = [&](int t) {             // the rows' logsumexp of step t
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
      const int il = tid + k * kThreads;
      if (il < nb) r_ahead[k] = __ldcg(rh + static_cast<size_t>(t - 1) * N + il);
    }
  };
  if (iters >= 1) {
    fetch_v(iters);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = tid + q * kThreads;
      if (j < M) vp[j] = ahead[q];
    }
    vbin_t = vbin_ahead;
    fetch_v(iters - 1);
    fetch_r(iters);
  }
  __syncthreads();

  // ---- adjoint recursion, t = iters .. 1 ----
  for (int t = iters; t >= 1; --t) {
    // this thread's columns: vc = -(lnu - v_t), vp = v_{t-1}; its band rows'
    // logsumexp into u; then step t - 1's history ahead
    const bool is_last = t == iters;
    const float vbin_prev = vbin_ahead, rb = rb_ahead;
    const float ubin_t = lmub - rb;        // as the replay formed it
    // step 3, bin part: v_t = lnu - c, c_j = lse_i([Z + u_t ; a + ubin_t]):
    // pb over this thread's columns, added up in the exchange
    float pb_part = 0.f;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int j = tid + q * kThreads;
      if (j < M) {
        vc[j] = -(lnu[j] - vp[j]);
        vp[j] = ahead[q];
        pb_part += expf(alpha + ubin_t + vc[j]) * (-dv[j]);
      }
    }
    pb_part = warp_sum(pb_part);
    if (lane == 0) wsum[warp] = pb_part;
#pragma unroll
    for (int k = 0; k < kRowsAhead; ++k) {
      const int il = tid + k * kThreads;
      if (il < nb) u[il] = r_ahead[k];
    }
    for (int il = tid + kRowsAhead * kThreads; il < nb; il += kThreads)
      u[il] = __ldcg(rh + static_cast<size_t>(t - 1) * N + il);
    if (t >= 2) {
      fetch_v(t - 2);
      fetch_r(t - 1);
    }
    __syncthreads();
    // step 4: vbin_t = lnub - cb, cb = lse_i([a + u_t ; a + ubin_t])
    const float cb = lnub - vbin_t;

    // the row sweep: u_t, du, both slab terms of dZ, column sums, sb_t
    const float row_bin = alpha + vbin_prev;
    for (int j = lane; j < M; j += 32) acc[j] = 0.f;
    float sb = 0.f;
    // g: the row's dZ so far. Resident it lives in registers; streamed it
    // is read from dO (last step) or dZ and written back.
    const float* gsrc = is_last ? dOb : dZb;
    auto row = [&](int il, float (&g)[C]) {
      float z[C];
      zload(z, il);
      const float r = u[il];              // the replay's row logsumexp
      const float u_i = lmu[il] - r;
      if constexpr (!kResident) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          g[c] = j < M ? gsrc[static_cast<size_t>(il) * M + j] : 0.f;
        }
      }
      float gsum = 0.f, csum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) {
          gsum += g[c];
          // step 3: contrib = exp(Z + u_t - c) * (-dv)
          const float contrib = expf(zval(z, il, c) + u_i + vc[j]) * (-dv[j]);
          csum += contrib;
          g[c] += contrib;
        }
      }
      float du = (-dvbin) * expf(alpha + u_i - cb) + warp_sum(csum);
      if (is_last) du += warp_sum(gsum) + dbc[row0 + il];
      // step 1: u_t = lmu - r, r_i = lse_j([Z + v_prev | a + vbin_prev])
      const float ndu = -du;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        if (j < M) {
          const float contrib2 = ndu * expf(zval(z, il, c) + vp[j] - r);
          g[c] += contrib2;
          acc[j] += contrib2;
        }
      }
      sb += ndu * expf(row_bin - r);
      if constexpr (!kResident) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          if (j < M) dZb[static_cast<size_t>(il) * M + j] = g[c];
        }
      }
    };
    if constexpr (kResident) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int il = warp + kWarps * r;
        if (il < nb) row(il, dzr[r]);
      }
    } else {
      for (int il = warp; il < nb; il += kWarps) {
        float g[C];
        row(il, g);
      }
    }
    if (lane == 0) wred[warp] = sb;
    post(false);                          // column sums of contrib2, sb; pb
    const float pb = loc_sum;
    float dubin = (is_last ? dubin_out : 0.f) + (-dvbin) * expf(alpha + ubin_t - cb);
    dalpha += -dvbin;
    dubin += pb;
    dalpha += pb;
    // step 2: ubin_t = lmub - rb, rb = lse_j([a + v_prev | a + vbin_prev])
    for (int j = tid; j < M; j += kThreads)
      dv[j] = cluster_sum(j, (-dubin) * expf(alpha + vp[j] - rb));
    const float sb_t = cluster_sum(mp, 0.f);
    xsel ^= 1;
    dvbin = (-dubin) * expf(alpha + vbin_prev - rb) + sb_t;
    dalpha += -dubin;
    dalpha += sb_t;
    vbin_t = vbin_prev;
    // no barrier: the next step writes only this thread's columns and rows
    // before its own, and the exchange's barriers order the rest
  }

  if constexpr (kResident) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int il = warp + kWarps * r;
      if (il < nb) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = lane + 32 * c;
          if (j < M) dZb[static_cast<size_t>(il) * M + j] = dzr[r][c];
        }
      }
    }
  }
  if (rank == 0 && tid == 0) dalpha_out[b] = dalpha;
  cluster.sync();   // no CTA leaves while another may read its buffers
}

// ---- the wide arm: more than 1024 columns, or a band whose streamed
// vectors do not fit in shared memory ----
//
// The same replay and reverse walk, the same exchanges in rank order and
// the same history, with what the register arms keep on chip moved out:
// a row's logsumexp and sums loop over its columns (a warp a row); every
// column reduction is a column pass, a thread a column walking the band's
// rows in order (the replay's column max and sums of exps; in the reverse
// step contrib2, which that pass also adds into dZ, after a row pass has
// added contrib and formed each row's du); the vectors v_t, v_{t-1}, dv,
// the rows' logsumexp and -du and the two exchange buffers live in a
// global scratch of wide_bwd_floats a CTA that the wrapper allocates (the
// CTAs of a cluster read each other's buffers from L2 after the cluster
// barrier, whose release / acquire orders them). Z, dO and dZ stream. Only
// device memory limits N and M. Simple, not tuned.
constexpr int kWideThreads = 512;

// floats of the wide arm's scratch a CTA: vc, vp, dv [M]; two exchange
// buffers [M + 4] (index pad4(M): a scalar); the rows' logsumexp and -du
// [band]
__host__ __device__ inline size_t wide_bwd_floats(int band, int M) {
  const size_t mp = pad4(M);
  return 3 * mp + 2 * (mp + 4) + 2 * static_cast<size_t>(pad4(band));
}

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

__global__ void __launch_bounds__(kWideThreads, 1)
sinkhorn_bwd_wide_kernel(const float* __restrict__ Z, const float* __restrict__ log_mu,
                         const float* __restrict__ log_nu,
                         const float* __restrict__ scalars,
                         const float* __restrict__ d_out,
                         const float* __restrict__ d_bin_row,
                         const float* __restrict__ d_bin_col,
                         const float* __restrict__ d_corner, float* __restrict__ dZ,
                         float* __restrict__ dalpha_out, float* __restrict__ hist,
                         float* __restrict__ scratch, int N, int M, int iters) {
  constexpr int kThreads = kWideThreads, kWarps = kThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int band = (N + G - 1) / G;
  const int row0 = rank * band;
  const int nb = max(0, min(N, row0 + band) - row0);
  const int mp = pad4(M);
  const int hs = M + 2;                   // history row: v [M], vbin, rb
  const size_t per_cta = wide_bwd_floats(band, M);
  auto cta = [&](int r) { return scratch + (static_cast<size_t>(b) * G + r) * per_cta; };
  float* vc = cta(rank);                  // replay: v; reverse: -(lnu - v_t)
  float* vp = vc + mp;                    // reverse: v_{t-1}
  float* dv = vp + mp;                    // replay: column max; reverse: dv_t
  const size_t xoff = 3 * static_cast<size_t>(mp);   // [2][M + 4]
  float* u = vc + xoff + 2 * (mp + 4);    // [band] replay: u; reverse: r
  float* ndu = u + pad4(band);            // [band] reverse: -du
  __shared__ float red[kWarps];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float half_neg = 0.5f * kBigNeg;
  const float alpha = scalars[b * 4 + 0], lmub = scalars[b * 4 + 1];
  const float lnub = scalars[b * 4 + 2];
  const float* lnu = log_nu + static_cast<size_t>(b) * M;
  const float* lmu = log_mu + static_cast<size_t>(b) * N + row0;
  const float* Zb = Z + (static_cast<size_t>(b) * N + row0) * M;
  const float* dOb = d_out + (static_cast<size_t>(b) * N + row0) * M;
  float* dZb = dZ + (static_cast<size_t>(b) * N + row0) * M;
  const float* dbr = d_bin_row + static_cast<size_t>(b) * M;
  const float* dbc = d_bin_col + static_cast<size_t>(b) * N;
  float* hb = hist + static_cast<size_t>(b) * hist_floats(N, M, iters);
  float* rh = hb + static_cast<size_t>(iters + 1) * hs + row0;

  auto zat = [&](int il, int j) -> float {   // masked Z of band row il
    return (lnu[j] > half_neg && lmu[il] > half_neg)
               ? __ldg(Zb + static_cast<size_t>(il) * M + j) : kBigNeg;
  };
  // f(il, z) over the band's rows of column j, in order, kBatch loads
  // issued before any is used
  auto column = [&](int j, auto&& f) {
    for (int il0 = 0; il0 < nb; il0 += kBatch) {
      float zr[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) zr[r] = il0 + r < nb ? zat(il0 + r, j) : 0.f;
#pragma unroll
      for (int r = 0; r < kBatch; ++r)
        if (il0 + r < nb) f(il0 + r, zr[r]);
    }
  };
  // exchange buffer `xsel` of CTA r; the cluster's entries in rank order
  int xsel = 0;
  auto xbuf = [&](int r) { return cta(r) + xoff + xsel * (mp + 4); };
  auto cluster_max = [&](int at) {
    float m = -CUDART_INF_F;
    for (int r = 0; r < G; ++r) m = fmaxf(m, __ldcg(xbuf(r) + at));
    return m;
  };
  auto cluster_sum = [&](int at, float s) {   // s + the entries, rank order
    for (int r = 0; r < G; ++r) s += __ldcg(xbuf(r) + at);
    return s;
  };

  // ---- set-up: v_0 ----
  for (int j = tid; j < M; j += kThreads) {
    vc[j] = lnu[j] > half_neg ? 0.f : kBigNeg;
    if (rank == 0) hb[j] = vc[j];
  }
  if (rank == 0 && tid == 0) hb[M] = 0.f;
  __syncthreads();

  // ---- forward replay, keeping the history (index 0 = start) ----
  float vbin = 0.f;
  for (int it = 0; it < iters; ++it) {
    // the bin row: rb = lse_j([a + v | a + vbin]), CTA-local (every CTA
    // holds all of v)
    float m = -CUDART_INF_F;
    for (int j = tid; j < M; j += kThreads) m = fmaxf(m, vc[j]);
    const float mx = fmaxf(block_max<kThreads>(m, red), vbin);
    float e = 0.f;
    for (int j = tid; j < M; j += kThreads) e += expf(vc[j] - mx);
    const float rb = logf(block_sum<kThreads>(e, red) + expf(vbin - mx)) + mx + alpha;
    const float ubin = lmub - rb;
    const float col_bin = alpha + ubin;
    if (rank == 0 && tid == 0) hb[static_cast<size_t>(it) * hs + M + 1] = rb;
    // rows: u_i = lmu_i - lse_j([Z + v | alpha + vbin]), its logsumexp kept
    const float row_bin = alpha + vbin;
    for (int il = warp; il < nb; il += kWarps) {
      float mr = -CUDART_INF_F;
      for (int j = lane; j < M; j += 32) mr = fmaxf(mr, zat(il, j) + vc[j]);
      const float mm = fmaxf(warp_max(mr), row_bin);
      float sr = 0.f;
      for (int j = lane; j < M; j += 32) sr += expf(zat(il, j) + vc[j] - mm);
      const float r = logf(warp_sum(sr) + expf(row_bin - mm)) + mm;
      if (lane == 0) {
        u[il] = lmu[il] - r;
        rh[static_cast<size_t>(it) * N + il] = r;
      }
    }
    __syncthreads();
    // column max of Z + u over the band, and the max of u
    float* X = xbuf(rank);
    for (int j = tid; j < M; j += kThreads) {
      float cm = -CUDART_INF_F;
      column(j, [&](int il, float z) { cm = fmaxf(cm, z + u[il]); });
      X[j] = cm;
    }
    float um = -CUDART_INF_F;
    for (int il = tid; il < nb; il += kThreads) um = fmaxf(um, u[il]);
    um = block_max<kThreads>(um, red);
    if (tid == 0) X[mp] = um;
    cluster.sync();
    for (int j = tid; j < M; j += kThreads) dv[j] = fmaxf(cluster_max(j), col_bin);
    const float umx = fmaxf(cluster_max(mp), ubin);
    xsel ^= 1;
    __syncthreads();                      // the column max is in dv
    // sums of exps over the band: columns, and u
    X = xbuf(rank);
    for (int j = tid; j < M; j += kThreads) {
      float cs = 0.f;
      const float dvj = dv[j];
      column(j, [&](int il, float z) { cs += expf(z + u[il] - dvj); });
      X[j] = cs;
    }
    float us = 0.f;
    for (int il = tid; il < nb; il += kThreads) us += expf(u[il] - umx);
    us = block_sum<kThreads>(us, red);
    if (tid == 0) X[mp] = us;
    cluster.sync();
    float* hn = hb + static_cast<size_t>(it + 1) * hs;
    for (int j = tid; j < M; j += kThreads) {
      const float s = cluster_sum(j, 0.f) + expf(col_bin - dv[j]);
      vc[j] = lnu[j] - (logf(s) + dv[j]);
      if (rank == 0) hn[j] = vc[j];
    }
    const float su = cluster_sum(mp, 0.f);
    vbin = lnub - (logf(su + expf(ubin - umx)) + umx + alpha);
    if (rank == 0 && tid == 0) hn[M] = vbin;
    xsel ^= 1;
    __syncthreads();
  }

  // ---- adjoints of the outputs ----
  float s = 0.f;
  for (int j = tid; j < M; j += kThreads) s += dbr[j];
  const float sum_dbr = block_sum<kThreads>(s, red);
  s = 0.f;
  for (int i = tid; i < N; i += kThreads) s += dbc[i];
  const float sum_dbc = block_sum<kThreads>(s, red);
  const float dc = d_corner[b];
  float dalpha = sum_dbr + sum_dbc + dc;
  float dvbin = sum_dbc + dc;
  const float dubin_out = sum_dbr + dc;
  // dv_T[j] = sum_i dO[i][j] + dbr[j]; with no iteration dZ is dO
  {
    float* X = xbuf(rank);
    for (int j = tid; j < M; j += kThreads) {
      float acc = 0.f;
      for (int il = 0; il < nb; ++il) {
        const float g = __ldg(dOb + static_cast<size_t>(il) * M + j);
        acc += g;
        if (iters == 0) dZb[static_cast<size_t>(il) * M + j] = g;
      }
      X[j] = acc;
    }
    cluster.sync();
    for (int j = tid; j < M; j += kThreads) dv[j] = cluster_sum(j, dbr[j]);
    xsel ^= 1;
  }
  float vbin_t = iters >= 1 ? __ldcg(hb + static_cast<size_t>(iters) * hs + M) : 0.f;
  __syncthreads();

  // ---- adjoint recursion, t = iters .. 1 ----
  for (int t = iters; t >= 1; --t) {
    const bool is_last = t == iters;
    const float* hprev = hb + static_cast<size_t>(t - 1) * hs;
    const float vbin_prev = __ldcg(hprev + M), rb = __ldcg(hprev + M + 1);
    const float ubin_t = lmub - rb;       // as the replay formed it
    // step 3, bin part: pb, CTA-local (every CTA holds all columns)
    float pb_part = 0.f;
    for (int j = tid; j < M; j += kThreads) {
      vc[j] = -(lnu[j] - __ldcg(hb + static_cast<size_t>(t) * hs + j));
      vp[j] = __ldcg(hprev + j);
      pb_part += expf(alpha + ubin_t + vc[j]) * (-dv[j]);
    }
    const float pb = block_sum<kThreads>(pb_part, red);
    for (int il = tid; il < nb; il += kThreads)
      u[il] = __ldcg(rh + static_cast<size_t>(t - 1) * N + il);
    __syncthreads();
    // step 4: vbin_t = lnub - cb, cb = lse_i([a + u_t ; a + ubin_t])
    const float cb = lnub - vbin_t;
    const float row_bin = alpha + vbin_prev;

    // the row pass: dZ += contrib, du per row (-du kept), sb
    const float* gsrc = is_last ? dOb : dZb;
    float sb = 0.f;
    for (int il = warp; il < nb; il += kWarps) {
      const float r = u[il];              // the replay's row logsumexp
      const float u_i = lmu[il] - r;
      float gsum = 0.f, csum = 0.f;
      for (int j = lane; j < M; j += 32) {
        const size_t at = static_cast<size_t>(il) * M + j;
        const float g = gsrc[at];
        // step 3: contrib = exp(Z + u_t - c) * (-dv)
        const float contrib = expf(zat(il, j) + u_i + vc[j]) * (-dv[j]);
        gsum += g;
        csum += contrib;
        dZb[at] = g + contrib;
      }
      float du = (-dvbin) * expf(alpha + u_i - cb) + warp_sum(csum);
      if (is_last) du += warp_sum(gsum) + dbc[row0 + il];
      if (lane == 0) ndu[il] = -du;
      sb += (-du) * expf(row_bin - r);
    }
    const float sb_cta = block_sum<kThreads>(lane == 0 ? sb : 0.f, red);
    // step 1: u_t = lmu - r, r_i = lse_j([Z + v_prev | a + vbin_prev]):
    // contrib2 = -du_i exp(Z + v_prev - r_i), into dZ and the column sums
    float* X = xbuf(rank);
    for (int j = tid; j < M; j += kThreads) {
      float acc = 0.f;
      const float vpj = vp[j];
      column(j, [&](int il, float z) {
        const float c2 = ndu[il] * expf(z + vpj - u[il]);
        dZb[static_cast<size_t>(il) * M + j] += c2;
        acc += c2;
      });
      X[j] = acc;
    }
    if (tid == 0) X[mp] = sb_cta;
    cluster.sync();
    float dubin = (is_last ? dubin_out : 0.f) + (-dvbin) * expf(alpha + ubin_t - cb);
    dalpha += -dvbin;
    dubin += pb;
    dalpha += pb;
    // step 2: ubin_t = lmub - rb, rb = lse_j([a + v_prev | a + vbin_prev])
    for (int j = tid; j < M; j += kThreads)
      dv[j] = cluster_sum(j, (-dubin) * expf(alpha + vp[j] - rb));
    const float sb_t = cluster_sum(mp, 0.f);
    xsel ^= 1;
    dvbin = (-dubin) * expf(alpha + vbin_prev - rb) + sb_t;
    dalpha += -dubin;
    dalpha += sb_t;
    vbin_t = vbin_prev;
    __syncthreads();                      // dv, before the next step reads it
  }

  if (rank == 0 && tid == 0) dalpha_out[b] = dalpha;
  cluster.sync();   // no CTA leaves while another may read its buffers
}

template <int C, int R>
cudaError_t launch(const float* Z, const float* log_mu, const float* log_nu,
                   const float* scalars, const float* d_out,
                   const float* d_bin_row, const float* d_bin_col,
                   const float* d_corner, float* dZ, float* dalpha, float* hist,
                   int B, int N, int M, int iters, int G, cudaStream_t stream) {
  const int band = (N + G - 1) / G;
  const size_t smem = smem_floats(band, M, R) * sizeof(float);
  if (smem > kMaxSmem || (R > 0 && band > threads_for(R) / 32 * R))
    return cudaErrorInvalidValue;
  auto kernel = sinkhorn_bwd_kernel<C, R>;
  cudaError_t err = allow_smem_once(kernel, smem);
  if (err == cudaSuccess && G > 8) err = allow_wide_cluster(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G);
  cfg.blockDim = dim3(threads_for(R));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, Z, log_mu, log_nu, scalars, d_out,
                            d_bin_row, d_bin_col, d_corner, dZ, dalpha, hist, N,
                            M, iters);
}

// whether a band of ceil(N / G) rows can stay on chip at C columns a lane
template <int C>
bool fits_resident(int N, int M, int G) {
  constexpr int R = resident_rows(C);
  const int band = (N + G - 1) / G;
  return R > 0 && band <= threads_for(R) / 32 * R &&
         smem_floats(band, M, R) * sizeof(float) <= kMaxSmem;
}

// The plan: clusters of 8 CTAs where the band of 8 stays on chip, else of
// 16 where that band does; else streamed, clusters of 8 (at 8 x 1024 x 1024
// 16 CTAs a cluster leave 7 clusters on the card at once: two waves of 8
// pairs).
template <int C>
int plan_cluster(int N, int M) {
  if (fits_resident<C>(N, M, 8)) return 8;
  if (fits_resident<C>(N, M, kMaxCluster)) return kMaxCluster;
  return 8;
}

// whether a streamed band of ceil(N / G) rows fits (its vectors and the
// warps' column partials in shared memory)
bool fits_streamed(int N, int M, int G) {
  return M <= kMaxCols &&
         smem_floats((N + G - 1) / G, M, 0) * sizeof(float) <= kMaxSmem;
}

cudaError_t launch_wide(const float* Z, const float* log_mu, const float* log_nu,
                        const float* scalars, const float* d_out,
                        const float* d_bin_row, const float* d_bin_col,
                        const float* d_corner, float* dZ, float* dalpha,
                        float* hist, float* scratch, long long scratch_floats,
                        int B, int N, int M, int iters, int G,
                        cudaStream_t stream) {
  const size_t need =
      static_cast<size_t>(B) * G * wide_bwd_floats((N + G - 1) / G, M);
  if (scratch == nullptr || static_cast<size_t>(scratch_floats) < need)
    return cudaErrorInvalidValue;
  auto kernel = sinkhorn_bwd_wide_kernel;
  if (G > 8) {
    const cudaError_t err = allow_wide_cluster(kernel);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G);
  cfg.blockDim = dim3(kWideThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, Z, log_mu, log_nu, scalars, d_out,
                            d_bin_row, d_bin_col, d_corner, dZ, dalpha, hist,
                            scratch, N, M, iters);
}

template <int C>
cudaError_t dispatch(const float* Z, const float* log_mu, const float* log_nu,
                     const float* scalars, const float* d_out,
                     const float* d_bin_row, const float* d_bin_col,
                     const float* d_corner, float* dZ, float* dalpha,
                     float* hist, int B, int N, int M, int iters, int G,
                     cudaStream_t stream) {
  if (G == 0) G = plan_cluster<C>(N, M);
  if (G < 1 || G > kMaxCluster) return cudaErrorInvalidValue;
  if constexpr (resident_rows(C) > 0) {
    if (fits_resident<C>(N, M, G))
      return launch<C, resident_rows(C)>(Z, log_mu, log_nu, scalars, d_out,
                                         d_bin_row, d_bin_col, d_corner, dZ,
                                         dalpha, hist, B, N, M, iters, G, stream);
  }
  return launch<C, 0>(Z, log_mu, log_nu, scalars, d_out, d_bin_row, d_bin_col,
                      d_corner, dZ, dalpha, hist, B, N, M, iters, G, stream);
}

}  // namespace
}  // namespace mdgat

// Z, d_out, dZ [B,N,M]; log_mu, d_bin_col [B,N]; log_nu, d_bin_row [B,M];
// scalars [B,4] = (alpha, log_mu_bin, log_nu_bin, norm); d_corner, dalpha
// [B]; hist scratch of B x hist_floats(N, M, iters) floats (the v / vbin
// history, then each row's logsumexp); all f32 and contiguous. cluster: 0
// for the plan, else the CTAs a pair (1-16; the smoke's sweep). Takes every
// iteration count, N and M: the wide arm (above 1024 columns, or where a
// streamed band does not fit at that cluster size; the wrapper's plan,
// ops/cuda/sinkhorn.py::bwd_plan, names its cluster) takes a scratch of
// B x cluster x wide_bwd_floats floats, null otherwise.
extern "C" cudaError_t mdgat_sinkhorn_bwd(
    const void* Z, const void* log_mu, const void* log_nu, const void* scalars,
    const void* d_out, const void* d_bin_row, const void* d_bin_col,
    const void* d_corner, void* dZ, void* dalpha, void* hist, void* scratch,
    long long scratch_floats, int B, int N, int M, int iters, int cluster,
    cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || N <= 0 || M <= 0 || iters < 0 || cluster < 0 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  if (cluster > 0 && !fits_streamed(N, M, cluster))
    return launch_wide(f(Z), f(log_mu), f(log_nu), f(scalars), f(d_out),
                       f(d_bin_row), f(d_bin_col), f(d_corner), g(dZ), g(dalpha),
                       g(hist), g(scratch), scratch_floats, B, N, M, iters,
                       cluster, stream);
#define MDGAT_SBWD(C)                                                        \
  return dispatch<C>(f(Z), f(log_mu), f(log_nu), f(scalars), f(d_out),       \
                     f(d_bin_row), f(d_bin_col), f(d_corner), g(dZ),         \
                     g(dalpha), g(hist), B, N, M, iters, cluster, stream)
  if (M <= 256) MDGAT_SBWD(8);
  if (M <= 512) MDGAT_SBWD(16);
  if (M <= 1024) MDGAT_SBWD(32);
#undef MDGAT_SBWD
  return cudaErrorInvalidValue;
}
