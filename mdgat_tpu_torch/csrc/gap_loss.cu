// The gap-loss margin kernels: everything of the gap loss that touches the
// dense [B, N, M] transport block, forward and backward.
//
// Replaces the two TPU kernels of mdgat_tpu/ops/pallas/loss.py:
//
// * _gap_fwd_kernel (via _gap_calls_fwd): mdgat_gap_fwd reads the block once
//   and emits the pre-log margin sums S0 [B, N] (anchors = rows) and
//   S1 [B, M] (anchors = columns). Per anchor with positive index p (the
//   dustbin when the ground truth is < 0):
//     S = sum_{c != p} relu(score[c] - score[p] + gamma)
//   over every other candidate, the dustbin included; candidates in a
//   masked column (direction 0) or row (direction 1) count as the -1e30
//   sentinel. The 2 * log1p and the masked anchor means stay plain tensor
//   code in the wrapper, as the TPU version keeps them outside its kernel.
// * _gap_bwd_kernel (via _fgm_bwd): mdgat_gap_bwd reads the block once more
//   and writes the cotangent dd [B, N, M] once, with dbin_row and dbin_col.
//
// What is different from the TPU kernels, and why:
//
// * The TPU kernel finds the positive score with a one-hot compare and a
//   full-row sum, because its compiler has no gather, and blocks the batch
//   by a fast-memory budget. Here the positive is one indexed load per
//   anchor (`positive()`), guarded so that a ground-truth index outside
//   the block gives 0, which is what the one-hot sum gives there.
// * One warp per row with the lanes across the columns: loads and stores
//   are coalesced and a row's sum is a register sum plus warp shuffles. The
//   forward runs a pair on a thread-block cluster (gap_fwd_kernel below):
//   the column side is gathered once a pair, and the column sums are added
//   across the cluster's CTAs in rank order, in one launch. The backward's
//   grid is (row tile, pair). No atomics: two runs give the same bits.
// * The cotangent of a positive needs the number of active margins of its
//   anchor, over the whole row or column: a block cannot write its tile of
//   dd before every tile has been counted. The forward therefore also
//   emits the two count vectors (as exact small integers in f32), which
//   the autograd function keeps, and the backward is one pass: read dense
//   once, write dd once. The backward rebuilds each indicator from the
//   same f32 expression as the forward (`margin()`, no contraction, fixed
//   operand order), so that a margin at exactly zero cannot be counted on
//   one side and masked on the other.
// * dd needs no scatter: `m == p[n]` and `n == q[m]` are tested at each
//   element (the column side staged in shared memory), and a positive
//   shared by both directions gets both terms in one store.
//
// What bounds them on the H100: bytes. At 64 x 512 x 512 f32 the forward
// reads 67 MB (0.020 ms at 3.35 TB/s), the backward reads and writes 67 MB
// each (0.040 ms); the arithmetic is a few operations per element.

#include <cooperative_groups.h>

#include "common.cuh"

namespace mdgat {
namespace {

namespace cg = cooperative_groups;

constexpr int kGapThreads = 256;
constexpr int kGapWarps = kGapThreads / 32;
constexpr int kGapRows = 32;        // rows of one backward tile
constexpr int kGapMaxCols = 1024;   // staged column vectors
constexpr int kGapLaneCols = kGapMaxCols / 32;

// Margin of one candidate against the anchor's positive. The forward adds
// it where it is > 0; the backward's indicator is `> 0` on this same value.
__device__ __forceinline__ float margin(float cand, float pos, float gamma) {
  return __fadd_rn(__fsub_rn(cand, pos), gamma);
}

// Index of an anchor's positive among `count` candidates: `count` stands
// for the dustbin.
__device__ __forceinline__ int positive_index(int gt, int count) {
  return gt < 0 ? count : gt;
}

// Score of the positive: the dustbin score at idx == count, the candidate
// (the sentinel when it is masked) at idx < count, and 0 beyond: no
// candidate matches such an index.
__device__ __forceinline__ float positive_score(int idx, int count, float bin,
                                                float cand, bool valid) {
  if (idx == count) return bin;
  if (idx > count) return 0.f;
  return valid ? cand : kBigNeg;
}
// ... with the candidate and its mask read here, only where idx < count
__device__ __forceinline__ float positive(int idx, int count, float bin,
                                          const float* __restrict__ cand,
                                          size_t stride,
                                          const uint8_t* __restrict__ mask) {
  const bool in = idx < count;
  return positive_score(idx, count, bin, in ? cand[idx * stride] : 0.f,
                        in && (mask == nullptr || mask[idx]));
}

// The column side of one pair, staged in shared memory.
struct Columns {
  float pos[kGapMaxCols];    // positive score of the column's anchor
  int idx[kGapMaxCols];      // its row index, N for the dustbin
  uint8_t valid[kGapMaxCols];
};

// columns [lo, hi) of it
__device__ __forceinline__ void stage_columns(
    Columns& c, const float* __restrict__ d, const float* __restrict__ bin_row,
    const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
    const uint8_t* __restrict__ cm, int N, int M, int lo, int hi) {
  for (int m = lo + threadIdx.x; m < hi; m += kGapThreads) {
    const int q = positive_index(gt1[m], N);
    c.idx[m] = q;
    c.pos[m] = positive(q, N, bin_row[m], d + m, static_cast<size_t>(M), rm);
    c.valid[m] = cm == nullptr || cm[m];
  }
}

// ---- gap_fwd_kernel: S0, S1 and the counts, one cluster a pair ----
//
// Design. A pair runs on a thread-block cluster of G CTAs (1-16; above 8
// non-portable), CTA `rank` taking the band of rows [rank * band, (rank +
// 1) * band) and the share of columns [rank * ceil(M / G), ...). The plan
// (ops/cuda/gap_loss.py::gap_plan) picks G and band.
// 1. Each CTA gathers the column side of its share of the columns (the
//    positive, its row, validity: one scattered load a column, once a pair)
//    and the row side of its band (ground truth, dustbin score, validity)
//    into shared memory and arrives at a cluster barrier; each warp loads
//    its first row; after the barrier every CTA copies the other shares of
//    the column side from their owners through distributed shared memory
//    (every load of a thread issued before its first store).
// 2. The eight warps are S column slices (S = 2 above 512 columns, else 1)
//    of 8 / S row groups; row group g takes rows g, g + 8 / S, ... of the
//    band, the next row's loads in flight while it works on one. A lane
//    reads its columns 4 * lane + 128 * j .. + 3 of its slice with 16-byte
//    loads, beside the row's positive (one guarded load, its index from
//    shared memory). Both directions' margins come from the same loaded
//    value. A row's sum and count close in the warp (four chains, then
//    shuffles; with two slices the halves are added in slice order through
//    shared memory after the rows); the columns' are kept in registers over
//    the group's rows.
// 3. The row groups' column sums are folded in a fixed tree through shared
//    memory; after a cluster barrier each CTA adds, for its share of the
//    columns, the CTAs' sums in rank order through distributed shared
//    memory (the G loads of a column issued together), adds the dustbin
//    term and writes S1 and the counts. A last cluster barrier keeps every
//    CTA's shared memory alive until read.
// One launch, no scratch in HBM, no atomics: two runs give the same bits.
// At most 128 registers a thread, so that two CTAs share an SM and 16-CTA
// clusters find room.
// What bounds it on the H100: bytes (64 x 512 x 512: 67 MB read once,
// 0.020 ms at 3.35 TB/s).
constexpr int kGapMaxCluster = 16;
constexpr int kGapCopy = kGapMaxCols / kGapThreads;   // columns a thread copies

// the cluster barrier in two halves: arrive (release) now, wait (acquire)
// later; every thread of every CTA of the cluster takes both
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The row side of a CTA's band, staged once
struct BandRows {
  int gt[kGapMaxCols];         // ground truth
  float binc[kGapMaxCols];     // dustbin score
  uint8_t valid[kGapMaxCols];
};

// Shared memory besides the column and row sides, in turn: the two slices'
// row sums and counts [band][2][2] while the rows run; then the fold's
// buffers [4 / S][2][128 * CH * S] (the same 4 * 128 * CH floats)
constexpr int kGapWork = 4 * kGapMaxCols;

// one row's operands, loaded ahead of their use
template <int CH>
struct GapRow {
  float4 v[CH];      // the lane's columns of its slice
  float cand;        // the score at the positive's column
};

// CH: 16-byte chunks of a row a lane reads in its slice; S: column slices
// (M <= 128 * CH * S); VEC: rows start on 16-byte boundaries (M % 4 == 0,
// dense aligned), else four guarded element loads a chunk
template <int CH, int S, bool VEC>
__global__ void __launch_bounds__(kGapThreads, 2)
gap_fwd_kernel(const float* __restrict__ dense, const float* __restrict__ bin_row,
               const float* __restrict__ bin_col, const int* __restrict__ gt0,
               const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
               const uint8_t* __restrict__ cm, float* __restrict__ s0,
               float* __restrict__ cnt0, float* __restrict__ s1,
               float* __restrict__ cnt1, int N, int M, int band, float gamma) {
  constexpr int W = 128 * CH * S;               // columns a CTA covers
  constexpr int RG = kGapWarps / S;             // row groups
  static_assert(W <= kGapMaxCols && (S == 1 || S == 2), "the staged columns");
  static_assert(2 * 2 * kGapMaxCols <= kGapWork && (RG / 2) * 2 * W <= kGapWork,
                "the work buffer");
  __shared__ __align__(16) Columns col;
  __shared__ __align__(16) BandRows rows;
  __shared__ __align__(16) float work[kGapWork];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slice = warp % S, group = warp / S;
  const float* d = dense + static_cast<size_t>(b) * N * M;
  const size_t bm = static_cast<size_t>(b) * M;
  const size_t bn0 = static_cast<size_t>(b) * N;
  const uint8_t* rmb = rm ? rm + bn0 : nullptr;
  const uint8_t* cmb = cm ? cm + bm : nullptr;
  const int r0 = rank * band, r_end = min(N, r0 + band);

  // 1. this CTA's share of the column side, and its band's row side
  const int share = (M + G - 1) / G;
  const int c_lo = min(M, rank * share), c_hi = min(M, c_lo + share);
  stage_columns(col, d, bin_row + bm, gt1 + bm, rmb, cmb, N, M, c_lo, c_hi);
  for (int n = r0 + tid; n < r_end; n += kGapThreads) {
    rows.gt[n - r0] = gt0[bn0 + n];
    rows.binc[n - r0] = bin_col[bn0 + n];
    rows.valid[n - r0] = rmb == nullptr || rmb[n];
  }
  __syncthreads();
  cluster_arrive();

  const int c0 = slice * 128 * CH + 4 * lane;   // the lane's first column
  auto load_row = [&](int n, GapRow<CH>& r) {
    const float* drow = d + static_cast<size_t>(n) * M;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int m0 = c0 + 128 * j;
      if (VEC) {
        r.v[j] = m0 < M ? load4(drow + m0) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        r.v[j].x = m0 < M ? drow[m0] : 0.f;
        r.v[j].y = m0 + 1 < M ? drow[m0 + 1] : 0.f;
        r.v[j].z = m0 + 2 < M ? drow[m0 + 2] : 0.f;
        r.v[j].w = m0 + 3 < M ? drow[m0 + 3] : 0.f;
      }
    }
    const int p = positive_index(rows.gt[n - r0], M);
    r.cand = p < M ? drow[p] : 0.f;
  };
  int n = r0 + group;
  GapRow<CH> next;
  if (n < r_end) load_row(n, next);

  // ... and the other shares of the column side from their owners
  cluster_wait();
  {
    float pv[kGapCopy];
    int qv[kGapCopy];
    uint8_t vv[kGapCopy];
#pragma unroll
    for (int k = 0; k < kGapCopy; ++k) {
      const int m = tid + k * kGapThreads, r = m / share;
      if (m < M && r != rank) {
        pv[k] = *cluster.map_shared_rank(&col.pos[m], r);
        qv[k] = *cluster.map_shared_rank(&col.idx[m], r);
        vv[k] = *cluster.map_shared_rank(&col.valid[m], r);
      }
    }
#pragma unroll
    for (int k = 0; k < kGapCopy; ++k) {
      const int m = tid + k * kGapThreads, r = m / share;
      if (m < M && r != rank) {
        col.pos[m] = pv[k];
        col.idx[m] = qv[k];
        col.valid[m] = vv[k];
      }
    }
  }
  __syncthreads();

  // 2. the band's rows
  float cs[CH][4], cc[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cs[j][e] = cc[j][e] = 0.f;
  for (; n < r_end; n += RG) {
    const GapRow<CH> row = next;
    if (n + RG < r_end) load_row(n + RG, next);
    const int i = n - r0;
    const int p = positive_index(rows.gt[i], M);
    const bool row_valid = rows.valid[i];
    // the mask of column p from the column side
    const float pos0 =
        positive_score(p, M, rows.binc[i], row.cand, p < M && col.valid[p]);
    // the row's sum and count as four chains (column e of each chunk),
    // added in a fixed order after the chunks
    float rs[4] = {0.f, 0.f, 0.f, 0.f}, rc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int m0 = c0 + 128 * j;
      if (m0 >= M) continue;
      const float4 cp = load4(&col.pos[m0]);
      const int4 ci = *reinterpret_cast<const int4*>(&col.idx[m0]);
      const uchar4 cv = *reinterpret_cast<const uchar4*>(&col.valid[m0]);
      const float xs[4] = {row.v[j].x, row.v[j].y, row.v[j].z, row.v[j].w};
      const float ps[4] = {cp.x, cp.y, cp.z, cp.w};
      const int qs[4] = {ci.x, ci.y, ci.z, ci.w};
      const bool vs[4] = {cv.x != 0, cv.y != 0, cv.z != 0, cv.w != 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + e;
        if (!VEC && m >= M) break;
        const float t0 = margin(vs[e] ? xs[e] : kBigNeg, pos0, gamma);
        if (m != p && t0 > 0.f) {
          rs[e] += t0;
          rc[e] += 1.f;
        }
        const float t1 = margin(row_valid ? xs[e] : kBigNeg, ps[e], gamma);
        if (n != qs[e] && t1 > 0.f) {
          cs[j][e] += t1;
          cc[j][e] += 1.f;
        }
      }
    }
    const float rsum = warp_sum((rs[0] + rs[1]) + (rs[2] + rs[3]));
    const float rcnt = warp_sum((rc[0] + rc[1]) + (rc[2] + rc[3]));
    const float bt = margin(rows.binc[i], pos0, gamma);
    const bool bi = p != M && bt > 0.f;
    if (S == 1) {
      if (lane == 0) {
        s0[bn0 + n] = rsum + (bi ? bt : 0.f);
        cnt0[bn0 + n] = rcnt + (bi ? 1.f : 0.f);
      }
    } else if (lane == 0) {                     // the slice's half, for below
      float* part = work + (i * 2 + slice) * 2;
      part[0] = rsum;
      part[1] = rcnt;
    }
  }
  if (S == 2) {            // a row's halves in slice order, then the dustbin
    __syncthreads();
    for (int i = tid; i < r_end - r0; i += kGapThreads) {
      const float* part = work + i * 4;
      const int p = positive_index(rows.gt[i], M);
      // the positive again, as the row's warps formed it
      const float pos0 = positive_score(
          p, M, rows.binc[i], p < M ? d[static_cast<size_t>(r0 + i) * M + p] : 0.f,
          p < M && col.valid[p]);
      const float bt = margin(rows.binc[i], pos0, gamma);
      const bool bi = p != M && bt > 0.f;
      s0[bn0 + r0 + i] = (part[0] + part[2]) + (bi ? bt : 0.f);
      cnt0[bn0 + r0 + i] = (part[1] + part[3]) + (bi ? 1.f : 0.f);
    }
  }

  // 3. the row groups' column sums in a fixed tree: group g + h into group
  // g, h = RG / 2, ..., 1; then group 0's into the first buffer
  __syncthreads();
  auto buf = [&](int k, int q) { return work + (k * 2 + q) * W; };
#pragma unroll
  for (int h = RG / 2; h >= 1; h /= 2) {
    if (group >= h && group < 2 * h) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int m0 = c0 + 128 * j;
        store4(buf(group - h, 0) + m0, make_float4(cs[j][0], cs[j][1], cs[j][2], cs[j][3]));
        store4(buf(group - h, 1) + m0, make_float4(cc[j][0], cc[j][1], cc[j][2], cc[j][3]));
      }
    }
    __syncthreads();
    if (group < h) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int m0 = c0 + 128 * j;
        const float4 s = load4(buf(group, 0) + m0), c = load4(buf(group, 1) + m0);
        cs[j][0] += s.x, cs[j][1] += s.y, cs[j][2] += s.z, cs[j][3] += s.w;
        cc[j][0] += c.x, cc[j][1] += c.y, cc[j][2] += c.z, cc[j][3] += c.w;
      }
    }
    __syncthreads();
  }
  if (group == 0) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int m0 = c0 + 128 * j;
      store4(buf(0, 0) + m0, make_float4(cs[j][0], cs[j][1], cs[j][2], cs[j][3]));
      store4(buf(0, 1) + m0, make_float4(cc[j][0], cc[j][1], cc[j][2], cc[j][3]));
    }
  }
  cluster_arrive();
  cluster_wait();
  // this CTA's share of the columns: the CTAs in rank order, then the
  // dustbin term
  for (int m = c_lo + tid; m < c_hi; m += kGapThreads) {
    float sv[kGapMaxCluster], nv[kGapMaxCluster];
#pragma unroll
    for (int r = 0; r < kGapMaxCluster; ++r) {
      if (r < G) {
        sv[r] = *cluster.map_shared_rank(buf(0, 0) + m, r);
        nv[r] = *cluster.map_shared_rank(buf(0, 1) + m, r);
      }
    }
    const float binr = bin_row[bm + m];
    float sum = 0.f, cnt = 0.f;
#pragma unroll
    for (int r = 0; r < kGapMaxCluster; ++r) {
      if (r < G) {
        sum += sv[r];
        cnt += nv[r];
      }
    }
    const int q = col.idx[m];
    const float bt = margin(binr, col.pos[m], gamma);
    const bool bi = q != N && bt > 0.f;
    s1[bm + m] = sum + (bi ? bt : 0.f);
    cnt1[bm + m] = cnt + (bi ? 1.f : 0.f);
  }
  cluster_arrive();   // no CTA leaves while another may read its shared memory
  cluster_wait();
}

// dd for the tile's rows, dbin_col for them, and (tile 0) dbin_row.
__global__ void __launch_bounds__(kGapThreads)
gap_bwd_kernel(const float* __restrict__ dense,
               const float* __restrict__ bin_row,
               const float* __restrict__ bin_col, const int* __restrict__ gt0,
               const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
               const uint8_t* __restrict__ cm, const float* __restrict__ cnt0,
               const float* __restrict__ cnt1, const float* __restrict__ ds0,
               const float* __restrict__ ds1, float* __restrict__ dd,
               float* __restrict__ dbin_row, float* __restrict__ dbin_col,
               int N, int M, float gamma) {
  __shared__ Columns col;
  __shared__ float ds1_s[kGapMaxCols], dpos1_s[kGapMaxCols];
  const int b = blockIdx.y, row0 = blockIdx.x * kGapRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bm = static_cast<size_t>(b) * M;
  const float* d = dense + static_cast<size_t>(b) * N * M;
  float* ddb = dd + static_cast<size_t>(b) * N * M;
  const uint8_t* rmb = rm ? rm + static_cast<size_t>(b) * N : nullptr;
  const uint8_t* cmb = cm ? cm + bm : nullptr;
  stage_columns(col, d, bin_row + bm, gt1 + bm, rmb, cmb, N, M, 0, M);
  for (int m = threadIdx.x; m < M; m += kGapThreads) {
    // each thread reads back only what it staged itself
    const float ds = ds1[bm + m];
    const float dpos = -ds * cnt1[bm + m];
    ds1_s[m] = ds;
    dpos1_s[m] = dpos;
    if (blockIdx.x == 0) {
      const int q = col.idx[m];
      const float bt = margin(bin_row[bm + m], col.pos[m], gamma);
      const bool bi = q != N && bt > 0.f;
      dbin_row[bm + m] = (q == N ? dpos : 0.f) + (bi ? ds : 0.f);
    }
  }
  __syncthreads();

  for (int r = warp; r < kGapRows; r += kGapWarps) {
    const int n = row0 + r;
    if (n >= N) break;
    const size_t bn = static_cast<size_t>(b) * N + n;
    const float* drow = d + static_cast<size_t>(n) * M;
    float* ddrow = ddb + static_cast<size_t>(n) * M;
    const int p = positive_index(gt0[bn], M);
    const float binc = bin_col[bn];
    const float pos0 = positive(p, M, binc, drow, 1, cmb);
    const bool row_valid = rmb == nullptr || rmb[n];
    const float ds = ds0[bn];
    const float dpos0 = -ds * cnt0[bn];
#pragma unroll
    for (int j = 0; j < kGapLaneCols; ++j) {
      const int m = lane + 32 * j;
      if (m < M) {
        const float x = drow[m];
        float v0 = 0.f, v1 = 0.f;
        if (col.valid[m]) {
          const float t0 = margin(x, pos0, gamma);
          v0 = m == p ? dpos0 : (t0 > 0.f ? ds : 0.f);
        }
        if (row_valid) {
          const float t1 = margin(x, col.pos[m], gamma);
          v1 = n == col.idx[m] ? dpos1_s[m] : (t1 > 0.f ? ds1_s[m] : 0.f);
        }
        ddrow[m] = v0 + v1;
      }
    }
    if (lane == 0) {
      const float bt = margin(binc, pos0, gamma);
      const bool bi = p != M && bt > 0.f;
      dbin_col[bn] = (p == M ? dpos0 : 0.f) + (bi ? ds : 0.f);
    }
  }
}

inline bool gap_shape_ok(int B, int N, int M) {
  return B > 0 && B <= 65535 && N > 0 && M > 0 && M <= kGapMaxCols;
}

using GapFwdKernel = void (*)(const float*, const float*, const float*, const int*,
                              const int*, const uint8_t*, const uint8_t*, float*,
                              float*, float*, float*, int, int, int, float);

// the forward's launch: B pairs, a cluster of G CTAs each (the
// non-portable attribute set above 8)
cudaError_t gap_fwd_config(GapFwdKernel kernel, int B, int G, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  if (G > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(B * G);
  cfg.blockDim = dim3(kGapThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// the forward's instantiation for M columns: a lane's chunks and slices
GapFwdKernel pick_gap_fwd(int M, bool vec) {
  if (M <= 256) return vec ? gap_fwd_kernel<2, 1, true> : gap_fwd_kernel<2, 1, false>;
  if (M <= 512) return vec ? gap_fwd_kernel<4, 1, true> : gap_fwd_kernel<4, 1, false>;
  return vec ? gap_fwd_kernel<4, 2, true> : gap_fwd_kernel<4, 2, false>;
}

}  // namespace
}  // namespace mdgat

// dense [B, N, M], bin_row [B, M], bin_col [B, N] f32; gt0 [B, N], gt1
// [B, M] int32 (< 0 = unmatched); rm [B, N], cm [B, M] uint8 or null (all
// valid). Out: s0, cnt0 [B, N] and s1, cnt1 [B, M] f32. M at most 1024.
// cluster: the CTAs a pair (1-16), band: the rows a CTA (at most 1024),
// from the plan (ops/cuda/gap_loss.py::gap_plan); together every row once,
// no CTA without a row.
extern "C" cudaError_t mdgat_gap_fwd(const void* dense, const void* bin_row,
                                     const void* bin_col, const void* gt0,
                                     const void* gt1, const void* rm,
                                     const void* cm, void* s0, void* s1,
                                     void* cnt0, void* cnt1, int B, int N, int M,
                                     int cluster, int band, float gamma,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (!gap_shape_ok(B, N, M) || cluster < 1 || cluster > kGapMaxCluster || band <= 0 ||
      band > kGapMaxCols ||
      static_cast<long long>(band) * cluster < N ||
      static_cast<long long>(band) * (cluster - 1) >= N)
    return cudaErrorInvalidValue;
  const bool vec = M % 4 == 0 && aligned_to(dense, 16);
  GapFwdKernel kernel = pick_gap_fwd(M, vec);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = gap_fwd_config(kernel, B, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i = [](const void* p) { return static_cast<const int*>(p); };
  auto u = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return cudaLaunchKernelEx(&cfg, kernel, f(dense), f(bin_row), f(bin_col), i(gt0),
                            i(gt1), u(rm), u(cm), o(s0), o(cnt0), o(s1), o(cnt1), N, M,
                            band, gamma);
}

// The forward's operands and counts, plus ds0 [B, N], ds1 [B, M] f32. Out:
// dd [B, N, M], dbin_row [B, M], dbin_col [B, N] f32.
extern "C" cudaError_t mdgat_gap_bwd(const void* dense, const void* bin_row,
                                     const void* bin_col, const void* gt0,
                                     const void* gt1, const void* rm,
                                     const void* cm, const void* cnt0,
                                     const void* cnt1, const void* ds0,
                                     const void* ds1, void* dd, void* dbin_row,
                                     void* dbin_col, int B, int N, int M,
                                     float gamma, cudaStream_t stream) {
  using namespace mdgat;
  if (!gap_shape_ok(B, N, M)) return cudaErrorInvalidValue;
  const int tiles = (N + kGapRows - 1) / kGapRows;
  gap_bwd_kernel<<<dim3(tiles, B), kGapThreads, 0, stream>>>(
      static_cast<const float*>(dense), static_cast<const float*>(bin_row),
      static_cast<const float*>(bin_col), static_cast<const int*>(gt0),
      static_cast<const int*>(gt1), static_cast<const uint8_t*>(rm),
      static_cast<const uint8_t*>(cm), static_cast<const float*>(cnt0),
      static_cast<const float*>(cnt1), static_cast<const float*>(ds0),
      static_cast<const float*>(ds1), static_cast<float*>(dd),
      static_cast<float*>(dbin_row), static_cast<float*>(dbin_col), N, M,
      gamma);
  return cudaGetLastError();
}

// *count = how many clusters of G CTAs of the forward's launch for M
// columns the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" cudaError_t mdgat_gap_active_clusters(int M, int cluster, int* count) {
  using namespace mdgat;
  if (M <= 0 || M > kGapMaxCols || cluster < 1 || cluster > kGapMaxCluster ||
      count == nullptr)
    return cudaErrorInvalidValue;
  const GapFwdKernel kernel = pick_gap_fwd(M, true);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = gap_fwd_config(kernel, 1, cluster, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}
