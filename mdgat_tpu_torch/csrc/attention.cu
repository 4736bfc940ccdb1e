// Top-k / dense masked attention with the per-row k-th-value threshold.
//
// Replaces the TPU kernel mdgat_tpu/ops/pallas/attention.py::_attn_kernel
// (reached from pallas_topk_attention) and its selection core
// _stacked_prob, both arms. The EXACT arm finds the k-th largest valid
// score of each query row exactly over order-preserving int32 keys
// (_monotone_key / _key_to_float), so the threshold equals the k-th value
// bit for bit and every tie at it is kept. The FAST arm (fast_passes > 0,
// the TPU kernel's default) is its value bisection: lo starts at the
// smallest valid score, hi at the row max, and each of fast_passes passes
// counts s >= lo + c_j * (hi - lo) at fast_mids midpoints (c = 1/3, 2/3, or
// 1/2) and moves [lo, hi] to the bracket of the largest midpoint whose
// count reaches topk; the threshold is lo and the kept set s >= lo holds the
// true top-k (and possibly near ties below the k-th value). Every midpoint
// is a rounded multiply and a rounded add (__fmul_rn / __fadd_rn: no FMA
// contraction), as ops/attention.py::fast_threshold forms it, so thr is the
// twin's bits. The softmax subtracts the row max taken before
// the search; masked and dropped entries weigh exactly 0; the denominator
// is floored at 1e-30, so an all-masked row gives zeros and no NaN (its
// thr is +1e30, its lse -1e30). With a non-null `lse` the kernel also writes the
// per-row logsumexp over the kept entries, max + log(max(denom, 1e-30)):
// the second residual of the fused-MHA forward (_mha_fwd_kernel).
//
// Accumulation order, which the fused-MHA backward relies on: every score
// is ONE fmaf chain over the head dim, d ascending from 0, started at 0,
// then times `scale`: the chain of score_dot (common.cuh), with which
// csrc/mha_bwd.cu re-forms s and tests s >= thr. The register tile below
// keeps that chain per element, so no kept entry flips in the backward.
//
// Design. A block of 256 threads serves 8 * TR query rows of one (batch,
// head) in three phases.
//  A. Scores, as a small GEMM: Q [rows][Dh] and a tile of 256 keys
//     [key][Dh] are staged by 16-byte cp.async with a row stride of Dh + 4
//     floats; a thread owns TR rows x 8 keys in registers and reads both
//     operands as 16-byte vectors along d (rows i*4 + tm, keys j*8 + tn of
//     a 4 x 8 warp: disjoint banks), so per four d steps TR + 8 loads feed
//     32 * TR FMAs. The masked, scaled scores go to a [rows][M + 8] slab in
//     shared memory. K streams through one tile buffer, so M up to 1024
//     fits beside the slab at every head size (the wide arm below takes
//     more).
//  B. Selection and softmax, one warp per row, the row's keys in registers
//     (up to four of the warp's rows advance together, 32 keys a lane at
//     most, so that one row's dependent steps fill another's latency). The
//     search keeps an interval [lo, hi] of keys that holds the k-th
//     largest, with count(key >= lo) and count(key > hi) known. Each step
//     picks a pivot (the first steps bisect the VALUE interval, which
//     halves the undecided count on spread-out scores; later ones bisect
//     the key interval, which bounds the steps), counts key >= pivot per
//     lane and closes the count with one __reduce_add_sync. Once at most
//     32 keys are undecided they are compacted, one per lane, and ranked
//     against each other by shuffles: the k-th is read off directly. Any
//     pivot sequence ends at the same key, so the result is the 32-step
//     key bisection's, bit for bit, in about five steps on random scores
//     (ops/cuda/attention.py::selection_mirror repeats it on the CPU).
//     The fast arm keeps the keys in the same registers and runs its passes
//     over them: two compares a key a pass, one __reduce_add_sync a
//     midpoint, no candidate ranking.
//  C. PV, as a second register-tiled product over the weights left in the
//     slab (dropped entries are zeros): V streams through the tile buffer
//     (its first tile in flight during phase B), a thread owns TR rows x 4
//     dims over a quarter of the keys, so a V read feeds TR rows, and the
//     quarters are added in a fixed order through shared memory. (PV over
//     compacted (weight, index) pairs of the kept entries only was built
//     and measured: each pair costs a 128-byte read of a V row that no
//     other query row shares, and at k = M / 8 it only drew level with the
//     dense product, at k = M / 4 and M / 2 it lost; PERF.md has the times.)
//  Wide arm (M > 1024, C = 0): 8 rows a block and a row a warp; phase B
//     walks the row's slab at every counting step instead of registers
//     (select_wide_row), with the same pivots, so thr is the same bits. The
//     slab stays in shared memory where it fits and goes to a global
//     scratch that the wrapper allocates beyond; phases A and C are the
//     register arm's at TR = 1. Simple, not tuned: PERF.md has its times.
// Nothing is atomic: two runs give the same bits. Internals are f32 for f32
// and bf16 I/O. The launch below owns the plan: it picks TR and the chunk
// count from M and sizes the shared memory; the wrapper only refuses the
// shapes that no instantiation takes.
//
// What bounds it on the H100: phase A the f32 FMA pipe fed from shared
// memory (10.7 FMAs a 16-byte load at TR = 4); phase B instruction slots
// and the integer pipe (about 450 instructions a row at M = 256); phase C
// the FMA pipe again. Two blocks an SM overlap one block's phase B with the other's
// products.

#include <limits.h>

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kThreads = 256, kWarps = 8;
constexpr int kValueSteps = 12;  // search steps that bisect the value interval
constexpr int kCandidates = 32;  // undecided keys finished by ranking

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

// A midpoint of the fast arm: lo + c * (hi - lo), each operation rounded on
// its own, as the twin (ops/attention.py::fast_threshold) and the TPU
// kernel's source spell it.
__device__ __forceinline__ float fast_mid(float lo, float hi, float c) {
  return __fadd_rn(lo, __fmul_rn(c, __fsub_rn(hi, lo)));
}

// One pass's bracket update of the fast arm from the counts c0 >= c1 of
// its midpoints m0 < m1 (m1 unused when mids is 1): the bracket above the
// largest midpoint whose count reaches topk, else [lo, m0].
__device__ __forceinline__ void fast_update(float& lo, float& hi, float m0,
                                            float m1, int c0, int c1,
                                            int mids, int topk) {
  float nlo = lo, nhi = m0;
  if (c0 >= topk) {
    nlo = m0;
    nhi = mids == 2 ? m1 : hi;
  }
  if (mids == 2 && c1 >= topk) {
    nlo = m1;
    nhi = hi;
  }
  lo = nlo;
  hi = nhi;
}

// the midpoints' fractions: (j + 1) / (mids + 1) rounded to f32
__device__ __forceinline__ float fast_c0(int mids) {
  return mids == 2 ? 1.f / 3.f : 0.5f;
}
constexpr float kFastC1 = 2.f / 3.f;

// rows of a warp that go through phase B together: at most 32 keys a lane
__host__ __device__ constexpr int rows_in_flight(int TR, int C) {
  return TR * C <= 32 ? TR : 32 / C;
}

// Phase B of the wide arm (M > 1024 keys, C = 0): one warp selects one
// row, `Sr`, whose scores stay in the slab; every counting step reads the
// row again instead of registers. The same pivots, counts and candidate
// ranking as the register arm, so the threshold is the same bits
// (ops/cuda/attention.py::selection_mirror). Leaves the row's weights in
// the slab (zeros through the last 32-key chunk) and writes 1 / sum, thr
// and lse; a dead row (past N) does nothing.
__device__ __forceinline__ void select_wide_row(
    float* Sr, const uint8_t* __restrict__ mb, bool live, int M, int nc,
    int topk, int fast_mids, int fast_passes, int lane, int* cand,
    float& inv, size_t row, float* __restrict__ thr,
    float* __restrict__ lse) {
  if (!live) return;                     // warp-uniform
  int nv = 0, hi = INT_MIN, lo = monotone_key(-kBigNeg);
  for (int j = lane; j < M; j += 32) {
    const int key = monotone_key(Sr[j]);  // masked keys hold the sentinel
    hi = max(hi, key);
    if (mb[j] != 0) {
      ++nv;
      lo = min(lo, key);
    }
  }
  nv = __reduce_add_sync(kFull, nv);
  hi = __reduce_max_sync(kFull, hi);     // pre-search row max
  lo = __reduce_min_sync(kFull, lo);     // smallest valid (+1e30 if none)
  const float mx = key_to_float(hi);
  float flo = key_to_float(lo);          // the fast arm's threshold
  if (topk > 0 && fast_passes > 0) {
    const float ca = fast_c0(fast_mids);
    float fhi = mx;
    for (int p = 0; p < fast_passes; ++p) {
      const float m0 = fast_mid(flo, fhi, ca), m1 = fast_mid(flo, fhi, kFastC1);
      int c0 = 0, c1 = 0;
      for (int j = lane; j < M; j += 32) {
        const float s = Sr[j];           // masked keys hold the sentinel
        c0 += s >= m0;
        c1 += s >= m1;
      }
      c0 = __reduce_add_sync(kFull, c0);
      c1 = __reduce_add_sync(kFull, c1);
      fast_update(flo, fhi, m0, m1, c0, c1, fast_mids, topk);
    }
  } else if (topk > 0) {
    int c_lo = nv, c_hi = 0;
    bool act = topk < nv && lo < hi && nv > kCandidates;
    for (int it = 0; act; ++it) {
      int mid = ceil_avg(lo, hi);
      if (it < kValueSteps) {
        const int vmid = monotone_key(0.5f * key_to_float(lo) + 0.5f * key_to_float(hi));
        if (vmid > lo && vmid <= hi) mid = vmid;
      }
      int cnt = 0;
      for (int j = lane; j < M; j += 32) cnt += monotone_key(Sr[j]) >= mid;
      cnt = __reduce_add_sync(kFull, cnt);
      if (cnt >= topk) { lo = mid; c_lo = cnt; }
      else { hi = mid - 1; c_hi = cnt; }
      act = lo < hi && c_lo - c_hi > kCandidates;
    }
    if (topk < nv && lo < hi) {          // at most kCandidates keys in [lo, hi]
      int nu = 0;
      for (int j0 = 0; j0 < M; j0 += 32) {
        const int j = j0 + lane;
        const int key = j < M ? monotone_key(Sr[j]) : INT_MIN;
        const bool in = j < M && key >= lo && key <= hi;
        const unsigned bal = __ballot_sync(kFull, in);
        if (in) cand[nu + __popc(bal & ((1u << lane) - 1u))] = key;
        nu += __popc(bal);
      }
      __syncwarp();
      const int x = lane < nu ? cand[lane] : INT_MIN;
      int at_least = 0;
      for (int j = 0; j < kCandidates; ++j) at_least += __shfl_sync(kFull, x, j) >= x;
      const int rank = topk - c_hi;      // 1 <= rank <= nu
      lo = __reduce_max_sync(kFull, lane < nu && at_least >= rank ? x : INT_MIN);
      __syncwarp();
    }
  }
  float sum = 0.f;
  for (int j = lane; j < nc * 32; j += 32) {
    const float s = Sr[j];
    const bool keep = j < M && mb[j] != 0 &&
                      (topk == 0 || (fast_passes > 0 ? s >= flo : monotone_key(s) >= lo));
    const float e = keep ? expf(s - mx) : 0.f;
    sum += e;
    Sr[j] = e;
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    inv = 1.f / fmaxf(sum, 1e-30f);
    thr[row] = topk > 0 ? (fast_passes > 0 ? flo : key_to_float(lo)) : kBigNeg;
    if (lse != nullptr) lse[row] = mx + logf(fmaxf(sum, 1e-30f));
  }
}

template <typename T, int DH, int TR, int C>
__global__ void __launch_bounds__(kThreads, 2)
topk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      T* __restrict__ o, float* __restrict__ thr,
                      float* __restrict__ lse, float* __restrict__ slab, int H,
                      int N, int M, int topk, int fast_mids, int fast_passes,
                      float scale) {
  constexpr int BR = 8 * TR, LD = DH + 4, DG = DH / 4;
  constexpr int RW = rows_in_flight(TR, C);
  constexpr bool kWide = C == 0;
  static_assert(!kWide || TR == 1, "the wide arm runs a row a warp");
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_inv[BR];
  __shared__ int cand[kWarps][RW][kCandidates];
  const int nc = (M + 31) / 32;          // 32-key chunks of a row
  const int LDS = slab_stride(M);
  // [BR][LDS] scores, then weights: in shared memory, or (the wide arm,
  // where it does not fit) this block's part of a global scratch
  float* S = smem;
  if (kWide && slab != nullptr)
    S = slab + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * BR * LDS;
  float* KV = S == smem ? smem + BR * LDS : smem;  // [kKT][LD] K or V tile; PV partials
  float* Qs = KV + tile_floats(DH, BR);  // [BR][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H;
  const int row0 = blockIdx.x * BR;
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;
  const T* qb = q + static_cast<size_t>(bh) * N * DH;
  const T* kb = k + static_cast<size_t>(bh) * M * DH;
  const T* vb = v + static_cast<size_t>(bh) * M * DH;
  const int tiles = (M + kKT - 1) / kKT;

  auto load_kv = [&](const T* base, int tile) {
    for (int i = tid; i < kKT * DG; i += kThreads) {
      const int j = i / DG, d4 = (i % DG) * 4, key = tile * kKT + j;
      const bool ok = key < M;
      stage4(KV + j * LD + d4, ok ? base + static_cast<size_t>(key) * DH + d4 : base, ok);
    }
    cp_async_commit();
  };

  // ---- phase A: scores -------------------------------------------------
  for (int i = tid; i < BR * DG; i += kThreads) {
    const int r = i / DG, d4 = (i % DG) * 4, n = row0 + r;
    const bool ok = n < N;
    stage4(Qs + r * LD + d4, ok ? qb + static_cast<size_t>(n) * DH + d4 : qb, ok);
  }
  {
    const int tm = lane >> 3, tn = lane & 7, wm = warp >> 2, wn = warp & 3;
    for (int t = 0; t < tiles; ++t) {
      if (t > 0) __syncthreads();        // the tile before is read
      load_kv(kb, t);                    // (its group holds Q too at t = 0)
      cp_async_wait<0>();
      __syncthreads();
      const int key0 = t * kKT + wn * 64;
      if (key0 >= M) continue;           // warp-uniform: no key of this span
      float acc[TR][8];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      const float* qp = Qs + (wm * 4 * TR + tm) * LD;
      const float* kp = KV + (wn * 64 + tn) * LD;
#pragma unroll
      for (int d4 = 0; d4 < DH; d4 += 4) {
        float qa[TR][4], ka[8][4];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          *reinterpret_cast<float4*>(qa[i]) =
              *reinterpret_cast<const float4*>(qp + i * 4 * LD + d4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(ka[j]) =
              *reinterpret_cast<const float4*>(kp + j * 8 * LD + d4);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)   // d ascending: the chain of score_dot
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(qa[i][dd], ka[j][dd], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = key0 + j * 8 + tn;
        if (col >= nc * 32) continue;
        const bool ok = col < M && mb[col] != 0;
#pragma unroll
        for (int i = 0; i < TR; ++i)
          S[(wm * 4 * TR + i * 4 + tm) * LDS + col] =
              ok ? acc[i][j] * scale : kBigNeg;
      }
    }
  }
  __syncthreads();
  load_kv(vb, 0);                        // in flight during phase B

  // ---- phase B: selection and softmax, one warp per row ------------------
  if constexpr (kWide) {
    select_wide_row(S + warp * LDS, mb, row0 + warp < N, M, nc, topk,
                    fast_mids, fast_passes, lane, cand[warp][0], row_inv[warp],
                    static_cast<size_t>(bh) * N + row0 + warp, thr, lse);
  } else {
  unsigned valid_bits = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = lane + 32 * c;
    if (j < M && mb[j] != 0) valid_bits |= 1u << c;
  }
  const int nvalid = __reduce_add_sync(kFull, __popc(valid_bits));
  const unsigned lt_mask = (1u << lane) - 1u;

  // RW rows of the warp advance together, statement by statement: each
  // step of a row is a chain of dependent instructions (pivot, count, warp
  // reduction, decision), and independent rows fill each other's latency.
  for (int t0 = 0; t0 < TR; t0 += RW) {
    const int r0 = warp * TR + t0;
    if (row0 + r0 >= N) break;           // ragged query edge (warp-uniform)
    int key[RW][C];
    bool live[RW];
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      live[u] = row0 + r0 + u < N;       // a dead row is handled as all-masked
#pragma unroll
      for (int c = 0; c < C; ++c)
        key[u][c] = monotone_key(
            live[u] && c < nc ? S[(r0 + u) * LDS + lane + 32 * c] : kBigNeg);
    }
    __syncwarp();                        // the rows are in registers

    int lo[RW], hi[RW], nv[RW];
    unsigned vbits[RW];
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      vbits[u] = live[u] ? valid_bits : 0u;
      nv[u] = live[u] ? nvalid : 0;
      int lmax = INT_MIN, lmin = monotone_key(-kBigNeg);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        lmax = max(lmax, key[u][c]);
        if ((vbits[u] >> c) & 1u) lmin = min(lmin, key[u][c]);
      }
      hi[u] = lmax;
      lo[u] = lmin;
    }
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      hi[u] = __reduce_max_sync(kFull, hi[u]);  // pre-search row max
      lo[u] = __reduce_min_sync(kFull, lo[u]);  // smallest valid (+1e30 if none)
    }
    float mx[RW], flo[RW];               // flo: the fast arm's threshold
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      mx[u] = key_to_float(hi[u]);
      flo[u] = key_to_float(lo[u]);
    }

    if (topk > 0 && fast_passes > 0) {
      // the fast arm: every row runs the same passes, the RW rows together
      const float ca = fast_c0(fast_mids);
      float fhi[RW];
#pragma unroll
      for (int u = 0; u < RW; ++u) fhi[u] = mx[u];
      for (int p = 0; p < fast_passes; ++p) {
        float m0[RW], m1[RW];
        int c0[RW], c1[RW];
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          m0[u] = fast_mid(flo[u], fhi[u], ca);
          m1[u] = fast_mid(flo[u], fhi[u], kFastC1);
          c0[u] = 0;
          c1[u] = 0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float s = key_to_float(key[u][c]);
            c0[u] += s >= m0[u];
            c1[u] += s >= m1[u];
          }
        }
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          c0[u] = __reduce_add_sync(kFull, c0[u]);
          c1[u] = __reduce_add_sync(kFull, c1[u]);
        }
#pragma unroll
        for (int u = 0; u < RW; ++u)
          fast_update(flo[u], fhi[u], m0[u], m1[u], c0[u], c1[u], fast_mids,
                      topk);
      }
    } else if (topk > 0) {
      // The k-th largest key is the largest t with count(key >= t) >= topk.
      // With topk >= nvalid that is lo as it stands. Otherwise
      // count(key >= lo) >= topk > count(key > hi) holds throughout.
      int c_lo[RW], c_hi[RW];
      bool act[RW], any = false;
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        c_lo[u] = nv[u];
        c_hi[u] = 0;
        act[u] = topk < nv[u] && lo[u] < hi[u] && nv[u] > kCandidates;
        any |= act[u];
      }
      for (int it = 0; any; ++it) {
        int mid[RW], cnt[RW];
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          mid[u] = ceil_avg(lo[u], hi[u]);
          if (it < kValueSteps) {
            const int vmid = monotone_key(0.5f * key_to_float(lo[u]) +
                                          0.5f * key_to_float(hi[u]));
            if (vmid > lo[u] && vmid <= hi[u]) mid[u] = vmid;
          }
          cnt[u] = 0;
#pragma unroll
          for (int c = 0; c < C; ++c) cnt[u] += key[u][c] >= mid[u];
        }
#pragma unroll
        for (int u = 0; u < RW; ++u) cnt[u] = __reduce_add_sync(kFull, cnt[u]);
        any = false;
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          if (!act[u]) continue;
          if (cnt[u] >= topk) { lo[u] = mid[u]; c_lo[u] = cnt[u]; }
          else { hi[u] = mid[u] - 1; c_hi[u] = cnt[u]; }
          act[u] = lo[u] < hi[u] && c_lo[u] - c_hi[u] > kCandidates;
          any |= act[u];
        }
      }
      // rows still open have at most kCandidates keys in [lo, hi]: one per
      // lane, ranked against each other
      bool open[RW];
      int nu[RW];
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        open[u] = topk < nv[u] && lo[u] < hi[u];
        nu[u] = 0;
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          const bool in = open[u] && key[u][c] >= lo[u] && key[u][c] <= hi[u];
          const unsigned bal = __ballot_sync(kFull, in);
          if (in) cand[warp][u][nu[u] + __popc(bal & lt_mask)] = key[u][c];
          nu[u] += __popc(bal);
        }
      __syncwarp();
      // the k-th largest is the largest candidate x with count(y >= x) >= rank
      int x[RW], at_least[RW];
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        x[u] = lane < nu[u] ? cand[warp][u][lane] : INT_MIN;
        at_least[u] = 0;
      }
#pragma unroll
      for (int j = 0; j < kCandidates; ++j)  // empty lanes hold INT_MIN
#pragma unroll
        for (int u = 0; u < RW; ++u)
          at_least[u] += __shfl_sync(kFull, x[u], j) >= x[u];
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const int rank = topk - c_hi[u];  // 1 <= rank <= nu on an open row
        const int kth = __reduce_max_sync(
            kFull, lane < nu[u] && at_least[u] >= rank ? x[u] : INT_MIN);
        if (open[u]) lo[u] = kth;
      }
      __syncwarp();
    }

    // unnormalised weights, over the row's scores
    float sum[RW];
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      unsigned keep_bits = vbits[u];
      if (topk > 0) {
        keep_bits = 0;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (fast_passes > 0 ? key_to_float(key[u][c]) >= flo[u]
                              : key[u][c] >= lo[u])
            keep_bits |= 1u << c;
        keep_bits &= vbits[u];           // all-masked rows keep nothing
      }
      sum[u] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        const float e = (keep_bits >> c) & 1u
                            ? expf(key_to_float(key[u][c]) - mx[u]) : 0.f;
        sum[u] += e;
        S[(r0 + u) * LDS + lane + 32 * c] = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < RW; ++u)
        sum[u] += __shfl_xor_sync(kFull, sum[u], off);
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      if (lane == 0 && live[u]) {
        const size_t row = static_cast<size_t>(bh) * N + row0 + r0 + u;
        row_inv[r0 + u] = 1.f / fmaxf(sum[u], 1e-30f);
        thr[row] = topk > 0 ? (fast_passes > 0 ? flo[u] : key_to_float(lo[u]))
                            : kBigNeg;
        if (lse != nullptr) lse[row] = mx[u] + logf(fmaxf(sum[u], 1e-30f));
      }
    }
  }
  }  // the register arm

  // ---- phase C: PV as a second register-tiled product ------------------
  __syncthreads();                       // every row's weights are written
  constexpr int KS = 32 / DG;            // key groups: 256 / (8 row groups * DG)
  const int dg = tid % DG, rg = (tid / DG) % 8, ks = tid / (8 * DG);
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      __syncthreads();
      load_kv(vb, t);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int nkeys = min(kKT, M - t * kKT);
    for (int j0 = ks * 4; j0 < nkeys; j0 += KS * 4) {
      float e[TR][4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        *reinterpret_cast<float4*>(e[i]) = *reinterpret_cast<const float4*>(
            S + (i * 8 + rg) * LDS + t * kKT + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(KV + (j0 + jj) * LD + dg * 4);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          acc[i][0] = fmaf(e[i][jj], vv.x, acc[i][0]);
          acc[i][1] = fmaf(e[i][jj], vv.y, acc[i][1]);
          acc[i][2] = fmaf(e[i][jj], vv.z, acc[i][2]);
          acc[i][3] = fmaf(e[i][jj], vv.w, acc[i][3]);
        }
      }
    }
  }
  __syncthreads();                       // the V tile is read: partials over it
  float* part = KV;                      // [KS][BR][DH]
#pragma unroll
  for (int i = 0; i < TR; ++i)
    store4(part + (ks * BR + i * 8 + rg) * DH + dg * 4,
           make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  __syncthreads();
  for (int i = tid; i < BR * DG; i += kThreads) {
    const int r = i / DG, d4 = (i % DG) * 4, n = row0 + r;
    if (n >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < KS; ++z) {       // key groups in a fixed order
      const float4 p = load4(part + (z * BR + r) * DH + d4);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    const float inv = row_inv[r];
    store4(o + (static_cast<size_t>(bh) * N + n) * DH + d4,
           make_float4(s.x * inv, s.y * inv, s.z * inv, s.w * inv));
  }
}

template <typename T, int DH, int TR, int C>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* thr, float* lse,
                   float* slab, long long slab_floats, int B, int H, int N,
                   int M, int topk, int fast_mids, int fast_passes,
                   float scale, cudaStream_t stream) {
  constexpr int BR = 8 * TR;
  const size_t rest = tile_floats(DH, BR) + BR * (DH + 4);
  const size_t slab_smem = static_cast<size_t>(BR) * slab_stride(M);
  dim3 grid((N + BR - 1) / BR, B * H);
  size_t smem = sizeof(float) * (slab_smem + rest);
  if (C > 0 || smem <= kMaxSmem) {
    slab = nullptr;
  } else {  // the wide arm's slab goes to the wrapper's scratch
    smem = sizeof(float) * rest;
    if (slab == nullptr ||
        slab_floats < static_cast<long long>(grid.x) * grid.y * slab_smem)
      return cudaErrorInvalidValue;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = topk_attention_kernel<T, DH, TR, C>;
  static SmemCap cap;
  cudaError_t err = allow_smem(kernel, smem, cap);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), thr, lse, slab, H, N,
      M, topk, fast_mids, fast_passes, scale);
  return cudaGetLastError();
}

// C = 8 / 16 / 32 chunks of 32 keys a lane holds (M <= 256 / 512 / 1024), at
// 32, 32 and 16 query rows a block, so that the score slab leaves room for
// two blocks an SM at the models' shapes. (64 rows at M <= 256 and 16 rows
// at M <= 512 were built and timed too: both slower, PERF.md.) Above 1024
// keys the wide arm: 8 rows a block, a row a warp, the slab in shared
// memory where it fits (about 5800 keys at Dh 32) and in the wrapper's
// scratch (ops/cuda/attention.py::slab_floats) beyond.
template <typename T, int DH>
cudaError_t dispatch_rows(const void* q, const void* k, const void* v,
                          const uint8_t* mask, void* o, float* thr, float* lse,
                          float* slab, long long slab_floats, int B, int H,
                          int N, int M, int topk, int fast_mids,
                          int fast_passes, float scale, cudaStream_t stream) {
#define MDGAT_ATTN(TR, C)                                                     \
  return launch<T, DH, TR, C>(q, k, v, mask, o, thr, lse, slab, slab_floats,  \
                              B, H, N, M, topk, fast_mids, fast_passes,      \
                              scale, stream)
  if (M <= 256) MDGAT_ATTN(4, 8);
  if (M <= 512) MDGAT_ATTN(4, 16);
  if (M <= 1024) MDGAT_ATTN(2, 32);
  MDGAT_ATTN(1, 0);
#undef MDGAT_ATTN
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* o, float* thr, float* lse,
                        float* slab, long long slab_floats, int B, int H, int N,
                        int M, int Dh, int topk, int fast_mids,
                        int fast_passes, float scale, cudaStream_t stream) {
  if (!aligned_to(q, 4 * sizeof(T)) || !aligned_to(k, 4 * sizeof(T)) ||
      !aligned_to(v, 4 * sizeof(T)) || !aligned_to(o, 4 * sizeof(T)))
    return cudaErrorInvalidValue;
#define MDGAT_DH(DH)                                                          \
  case DH:                                                                    \
    return dispatch_rows<T, DH>(q, k, v, mask, o, thr, lse, slab,            \
                                slab_floats, B, H, N, M, topk, fast_mids,    \
                                fast_passes, scale, stream);
  switch (Dh) {
    MDGAT_DH(8)
    MDGAT_DH(16)
    MDGAT_DH(32)
    MDGAT_DH(64)
    default: return cudaErrorInvalidValue;
  }
#undef MDGAT_DH
}

}  // namespace
}  // namespace mdgat

// q [B,H,N,Dh], k/v [B,H,M,Dh] (f32 or bf16, contiguous), mask [B,M] uint8,
// o [B,H,N,Dh] (input dtype), thr [B,H,N] f32, lse [B,H,N] f32 or null.
// topk 0 = dense. fast_passes 0 selects with the exact arm; a positive count
// with the fast arm, fast_mids (1 or 2) midpoints a pass. slab: f32 scratch
// of slab_floats floats for the wide arm's score slab where it does not fit
// in shared memory, else null.
extern "C" cudaError_t mdgat_topk_attention(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* thr, void* lse, void* slab, long long slab_floats, int B, int H,
    int N, int M, int Dh, int topk, int fast_mids, int fast_passes,
    float scale, int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || topk < 0 || fast_passes < 0 ||
      (fast_passes > 0 && fast_mids != 1 && fast_mids != 2))
    return cudaErrorInvalidValue;
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* t = static_cast<float*>(thr);
  auto* l = static_cast<float*>(lse);
  auto* sl = static_cast<float*>(slab);
  if (io_dtype == kF32)
    return dispatch_dh<float>(q, k, v, m, o, t, l, sl, slab_floats, B, H, N, M,
                              Dh, topk, fast_mids, fast_passes, scale, stream);
  if (io_dtype == kBF16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, m, o, t, l, sl, slab_floats, B,
                                      H, N, M, Dh, topk, fast_mids,
                                      fast_passes, scale, stream);
  return cudaErrorInvalidValue;
}

extern "C" const char* mdgat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
