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
//   are coalesced and a row's sum is a register sum plus warp shuffles.
//   Both kernels run a pair on a thread-block cluster (gap_fwd_kernel,
//   gap_bwd_kernel below): the column side is gathered once a pair, and the
//   forward's column sums are added across the cluster's CTAs in rank
//   order, in one launch each. Any N and M: columns go in chunks of 1024,
//   a CTA's band of rows in pieces of 1024. No atomics: two runs give the
//   same bits.
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
constexpr int kGapChunk = 1024;     // columns staged at a time
constexpr int kGapPiece = 1024;     // rows of a band staged at a time
constexpr int kGapMaxCluster = 16;
// rows of a backward warp in flight: 4 (a CTA an SM at 190 registers) was
// slower than 2 at 8 x 1024 x 1024 (0.0531 against 0.0355 ms, PERF.md)
constexpr int kGapBwdDepth = 2;

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

// The column side of one chunk of columns, staged in shared memory; the
// backward's also holds each column's cotangent and its positive's.
struct Columns {
  float pos[kGapChunk];      // positive score of the column's anchor
  int idx[kGapChunk];        // its row index, N for the dustbin
  uint8_t valid[kGapChunk];
};
struct BwdColumns : Columns {
  float ds[kGapChunk];       // ds1
  float dpos[kGapChunk];     // -ds1 * cnt1: the cotangent of the positive
};

// columns [lo, hi) of it; `d`, `bin_row`, `gt1` and `cm` point at the
// chunk's first column
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

// The cluster barrier in two halves: arrive (release) now, wait (acquire)
// later; every thread of every CTA of the cluster takes both
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// After the barrier that follows the staging: the other CTAs' shares of the
// chunk's `mk` columns (share `share` each) copied from their owners through
// distributed shared memory, every load of a thread issued before its first
// store. `field(c)` names the arrays to copy.
template <typename Cols, typename Fields>
__device__ __forceinline__ void copy_shares(cg::cluster_group& cluster, Cols& c,
                                            int mk, int share, int rank,
                                            Fields&& fields) {
  constexpr int kCopy = kGapChunk / kGapThreads;
  decltype(fields(c, 0)) got[kCopy];
#pragma unroll
  for (int k = 0; k < kCopy; ++k) {
    const int m = threadIdx.x + k * kGapThreads, r = m / share;
    if (m < mk && r != rank) got[k] = fields(*cluster.map_shared_rank(&c, r), m);
  }
#pragma unroll
  for (int k = 0; k < kCopy; ++k) {
    const int m = threadIdx.x + k * kGapThreads, r = m / share;
    if (m < mk && r != rank) got[k].store(c, m);
  }
}

// one column of the forward's column side, as copy_shares moves it
struct FwdCol {
  float pos;
  int idx;
  uint8_t valid;
  __device__ void store(Columns& c, int m) const {
    c.pos[m] = pos;
    c.idx[m] = idx;
    c.valid[m] = valid;
  }
};
struct BwdCol {
  FwdCol base;
  float ds, dpos;
  __device__ void store(BwdColumns& c, int m) const {
    base.store(c, m);
    c.ds[m] = ds;
    c.dpos[m] = dpos;
  }
};

// The row side of a piece of a CTA's band (at most kGapPiece rows), staged
// once a chunk; the backward's also holds each row's cotangents
struct BandRows {
  int gt[kGapPiece];           // ground truth
  float binc[kGapPiece];       // dustbin score
  uint8_t valid[kGapPiece];
};
struct BwdRows : BandRows {
  float ds[kGapPiece];         // ds0
  float dpos[kGapPiece];       // -ds0 * cnt0
};

// one row's operands, loaded ahead of their use
template <int CH>
struct GapRow {
  float4 v[CH];      // the lane's columns of its slice of the chunk
  float cand;        // the score at the positive's column
  bool pvalid;       // that column is valid
};

// Loads the lane's columns c0 + 128 j .. + 3 of row n's chunk (mk columns
// from k0) and the row's positive p: 16-byte loads with VEC, else four
// guarded element loads a chunk
template <int CH, bool VEC, bool WIDE>
__device__ __forceinline__ void load_row(GapRow<CH>& r, const float* __restrict__ drow,
                                         const uint8_t* __restrict__ cmb, int k0,
                                         int mk, int c0, int p, int M) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int m0 = c0 + 128 * j;
    const float* src = drow + k0 + m0;
    if (VEC) {
      r.v[j] = m0 < mk ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r.v[j].x = m0 < mk ? src[0] : 0.f;
      r.v[j].y = m0 + 1 < mk ? src[1] : 0.f;
      r.v[j].z = m0 + 2 < mk ? src[2] : 0.f;
      r.v[j].w = m0 + 3 < mk ? src[3] : 0.f;
    }
  }
  r.cand = p < M ? drow[p] : 0.f;
  // the positive's column may lie in another chunk: its mask from memory
  // (one chunk holds every column's in shared memory)
  if (WIDE) r.pvalid = p < M && (cmb == nullptr || cmb[p]);
}

// Shared memory of the forward besides the column and row sides, in turn:
// the two slices' row sums and counts [piece][2][2] while the rows run;
// then the fold's buffers [4 / S][2][W] (W = 128 * CH * S <= kGapChunk)
constexpr int kGapWork = 4 * kGapChunk;

// ---- gap_fwd_kernel: S0, S1 and the counts, one cluster a pair ----
//
// Design. A pair runs on a thread-block cluster of G CTAs (1-16; above 8
// non-portable), CTA `rank` taking the band of rows [rank * band, (rank +
// 1) * band). The plan (ops/cuda/gap_loss.py::gap_plan) picks G and band.
// The columns go in chunks of W = 128 * CH * S (one chunk up to 1024
// columns), and each chunk's column side is shared out: CTA `rank` owns
// columns [rank * ceil(W / G), ...) of it. A band of more than 1024 rows
// runs in pieces of 1024. For each chunk:
// 1. Each CTA gathers the column side of its share (the positive, its row,
//    validity: one scattered load a column, once a pair) and the row side
//    of its band's first piece (ground truth, dustbin score, validity) into
//    shared memory and arrives at a cluster barrier; each warp loads its
//    first row; after the barrier every CTA copies the other shares of the
//    column side from their owners through distributed shared memory.
// 2. The eight warps are S column slices (S = 2 above 512 columns, else 1)
//    of 8 / S row groups; row group g takes rows g, g + 8 / S, ... of the
//    piece, the next row's loads in flight while it works on one. A lane
//    reads its columns 4 * lane + 128 * j .. + 3 of its slice with 16-byte
//    loads, beside the row's positive (one guarded load, its index from
//    shared memory). Both directions' margins come from the same loaded
//    value. A row's sum and count close in the warp (four chains, then
//    shuffles; with two slices the halves are added in slice order through
//    shared memory after the piece's rows) and are added to the chunks
//    before in S0 / cnt0 (chunk order; the dustbin term after the last);
//    the columns' are kept in registers over the band's rows.
// 3. The row groups' column sums are folded in a fixed tree through shared
//    memory; after a cluster barrier each CTA adds, for its share of the
//    chunk, the CTAs' sums in rank order through distributed shared memory
//    (the G loads of a column issued together), adds the dustbin term and
//    writes S1 and the counts. A last cluster barrier keeps every CTA's
//    shared memory alive until read.
// One launch, no scratch in HBM, no atomics: two runs give the same bits.
// At most 128 registers a thread, so that two CTAs share an SM and 16-CTA
// clusters find room. Up to 1024 columns and rows a CTA every loop runs
// once, as in the design of one chunk it grew from.
// What bounds it on the H100: bytes (64 x 512 x 512: 67 MB read once,
// 0.020 ms at 3.35 TB/s).

// CH: 16-byte chunks of a row a lane reads in its slice; S: column slices
// (W = 128 * CH * S columns a chunk); VEC: rows start on 16-byte boundaries
// (M % 4 == 0, dense aligned), else four guarded element loads a chunk;
// WIDE: more than one chunk or piece (M > W or a band of more than 1024
// rows), else every loop below runs once and folds away
template <int CH, int S, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kGapThreads, 2)
gap_fwd_kernel(const float* __restrict__ dense, const float* __restrict__ bin_row,
               const float* __restrict__ bin_col, const int* __restrict__ gt0,
               const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
               const uint8_t* __restrict__ cm, float* __restrict__ s0,
               float* __restrict__ cnt0, float* __restrict__ s1,
               float* __restrict__ cnt1, int N, int M, int band, float gamma) {
  constexpr int W = 128 * CH * S;               // columns a chunk
  constexpr int RG = kGapWarps / S;             // row groups
  static_assert(W <= kGapChunk && (S == 1 || S == 2), "the staged columns");
  static_assert(2 * 2 * kGapPiece <= kGapWork && (RG / 2) * 2 * W <= kGapWork,
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
  const int c0 = slice * 128 * CH + 4 * lane;   // the lane's first column

  auto stage_rows = [&](int p0, int p_end) {
    for (int n = p0 + tid; n < p_end; n += kGapThreads) {
      rows.gt[n - p0] = gt0[bn0 + n];
      rows.binc[n - p0] = bin_col[bn0 + n];
      rows.valid[n - p0] = rmb == nullptr || rmb[n];
    }
  };
  // the positive's score of row n (index i in its piece) and the dustbin term
  auto row_positive = [&](int i, int p, float cand, bool pvalid) {
    return positive_score(p, M, rows.binc[i], cand, pvalid);
  };

  for (int k0 = 0; k0 < (WIDE ? M : 1); k0 += W) {
    const int mk = WIDE ? min(W, M - k0) : M;   // columns of this chunk
    const bool first = !WIDE || k0 == 0, last = !WIDE || k0 + W >= M;
    // 1. this CTA's share of the chunk's column side, its first piece's
    // row side
    const int share = (mk + G - 1) / G;
    const int c_lo = min(mk, rank * share), c_hi = min(mk, c_lo + share);
    stage_columns(col, d + k0, bin_row + bm + k0, gt1 + bm + k0, rmb,
                  cmb ? cmb + k0 : nullptr, N, M, c_lo, c_hi);
    int p_end = WIDE ? min(r_end, r0 + kGapPiece) : r_end;
    stage_rows(r0, p_end);
    __syncthreads();
    cluster_arrive();
    int n = r0 + group;
    GapRow<CH> next;
    if (n < p_end)
      load_row<CH, VEC, WIDE>(next, d + static_cast<size_t>(n) * M, cmb, k0, mk, c0,
                        positive_index(rows.gt[n - r0], M), M);
    // ... and the other shares of the column side from their owners
    cluster_wait();
    copy_shares(cluster, col, mk, share, rank, [](const Columns& c, int m) {
      return FwdCol{c.pos[m], c.idx[m], c.valid[m]};
    });
    __syncthreads();

    // 2. the band's rows, a piece at a time
    float cs[CH][4], cc[CH][4];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[j][e] = cc[j][e] = 0.f;
    for (int p0 = r0; p0 < (WIDE ? r_end : r0 + 1); p0 += kGapPiece) {
      p_end = WIDE ? min(r_end, p0 + kGapPiece) : r_end;
      if (p0 > r0) {                          // the piece before is done
        __syncthreads();
        stage_rows(p0, p_end);
        __syncthreads();
        n = p0 + group;
        if (n < p_end)
          load_row<CH, VEC, WIDE>(next, d + static_cast<size_t>(n) * M, cmb, k0, mk, c0,
                            positive_index(rows.gt[n - p0], M), M);
      }
      for (; n < p_end; n += RG) {
        const GapRow<CH> row = next;
        if (n + RG < p_end)
          load_row<CH, VEC, WIDE>(next, d + static_cast<size_t>(n + RG) * M, cmb, k0, mk,
                            c0, positive_index(rows.gt[n + RG - p0], M), M);
        const int i = n - p0;
        const int p = positive_index(rows.gt[i], M);
        const bool row_valid = rows.valid[i];
        const float pos0 = row_positive(
            i, p, row.cand, WIDE ? row.pvalid : p < M && col.valid[p]);
        // the row's sum and count as four chains (column e of each
        // 16-byte chunk), added in a fixed order after the chunks
        float rs[4] = {0.f, 0.f, 0.f, 0.f}, rc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int m0 = c0 + 128 * j;
          if (m0 >= mk) continue;
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
            if (!VEC && m >= mk) break;
            const float t0 = margin(vs[e] ? xs[e] : kBigNeg, pos0, gamma);
            if (k0 + m != p && t0 > 0.f) {
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
        if (S == 1) {
          if (lane == 0) {
            float sv = rsum, cv = rcnt;
            if (!first) {                     // the chunks before, in order
              sv = s0[bn0 + n] + sv;
              cv = cnt0[bn0 + n] + cv;
            }
            if (last) {                       // the dustbin term
              const float bt = margin(rows.binc[i], pos0, gamma);
              const bool bi = p != M && bt > 0.f;
              sv += bi ? bt : 0.f;
              cv += bi ? 1.f : 0.f;
            }
            s0[bn0 + n] = sv;
            cnt0[bn0 + n] = cv;
          }
        } else if (lane == 0) {               // the slice's half, for below
          float* part = work + (i * 2 + slice) * 2;
          part[0] = rsum;
          part[1] = rcnt;
        }
      }
      if (S == 2) {        // a row's halves in slice order, then the dustbin
        __syncthreads();
        for (int i = tid; i < p_end - p0; i += kGapThreads) {
          const float* part = work + i * 4;
          const int row_n = p0 + i;
          float sv = part[0] + part[2], cv = part[1] + part[3];
          if (!first) {
            sv = s0[bn0 + row_n] + sv;
            cv = cnt0[bn0 + row_n] + cv;
          }
          if (last) {
            const int p = positive_index(rows.gt[i], M);
            // the positive again, as the row's warps formed it
            const float pos0 = row_positive(
                i, p, p < M ? d[static_cast<size_t>(row_n) * M + p] : 0.f,
                WIDE ? p < M && (cmb == nullptr || cmb[p])
                     : p < M && col.valid[p]);
            const float bt = margin(rows.binc[i], pos0, gamma);
            const bool bi = p != M && bt > 0.f;
            sv += bi ? bt : 0.f;
            cv += bi ? 1.f : 0.f;
          }
          s0[bn0 + row_n] = sv;
          cnt0[bn0 + row_n] = cv;
        }
      }
    }

    // 3. the row groups' column sums in a fixed tree: group g + h into
    // group g, h = RG / 2, ..., 1; then group 0's into the first buffer
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
    // this CTA's share of the chunk: the CTAs in rank order, then the
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
      const float binr = bin_row[bm + k0 + m];
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
      s1[bm + k0 + m] = sum + (bi ? bt : 0.f);
      cnt1[bm + k0 + m] = cnt + (bi ? 1.f : 0.f);
    }
    cluster_arrive();   // no CTA stages, writes or leaves while another may
    cluster_wait();     // read its shared memory
  }
}

// ---- gap_bwd_kernel: dd, dbin_row, dbin_col, one cluster a pair ----
//
// Design, the forward's carried over. The backward has no reduction: each
// element's cotangent is a function of its value, its row's anchor
// (positive, cotangent, count) and its column's. What the old design (a
// grid of 32-row tiles) lost its time to was the column side: every tile
// gathered it for all M columns (one scattered load of the positive a
// column), 16 times a pair at 64 x 512 x 512, with 4-byte row accesses and
// four rows a warp. Here a pair runs on a cluster of G CTAs by the plan
// (ops/cuda/gap_loss.py::gap_plan, the forward's), each a band of rows; a chunk's
// column side (positive, its row, validity, ds1 and -ds1 * cnt1) is
// gathered once a pair, each CTA its share, and copied to the others
// through distributed shared memory; the owner of a column writes its
// dbin_row. The row side of a piece (ground truth, dustbin score,
// validity, ds0, -ds0 * cnt0) is staged too, so a row's positive loads
// with the row. Warps, slices and lanes as in the forward: 16-byte loads
// of dense and 16-byte stores of dd (VEC); a warp keeps a ring of
// kGapBwdDepth rows in registers, each slot loading the row D further on as
// its row is taken, so two rows' loads are in flight while it works on one;
// each lane of slice 0 writes its row's dbin_col once. Under 128
// registers: two CTAs an SM. A split cluster
// barrier (arrive after the copy, wait before the next chunk's staging)
// keeps a share alive until every CTA has copied it. Each indicator is
// rebuilt from margin(), the forward's expression, so the outputs are those
// of fused_gap_margins_backward_reference bit for bit; no atomics.
// What bounds it on the H100: bytes (64 x 512 x 512: 67 MB read and 67 MB
// written, 0.040 ms at 3.35 TB/s).
template <int CH, int S, bool VEC>
__global__ void __launch_bounds__(kGapThreads, 2)
gap_bwd_kernel(const float* __restrict__ dense, const float* __restrict__ bin_row,
               const float* __restrict__ bin_col, const int* __restrict__ gt0,
               const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
               const uint8_t* __restrict__ cm, const float* __restrict__ cnt0,
               const float* __restrict__ cnt1, const float* __restrict__ ds0,
               const float* __restrict__ ds1, float* __restrict__ dd,
               float* __restrict__ dbin_row, float* __restrict__ dbin_col, int N,
               int M, int band, float gamma) {
  constexpr int W = 128 * CH * S;               // columns a chunk
  constexpr int RG = kGapWarps / S;             // row groups
  constexpr int D = kGapBwdDepth;               // rows of a warp in flight
  static_assert(W <= kGapChunk && (S == 1 || S == 2), "the staged columns");
  __shared__ __align__(16) BwdColumns col;
  __shared__ __align__(16) BwdRows rows;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slice = warp % S, group = warp / S;
  const float* d = dense + static_cast<size_t>(b) * N * M;
  float* ddb = dd + static_cast<size_t>(b) * N * M;
  const size_t bm = static_cast<size_t>(b) * M;
  const size_t bn0 = static_cast<size_t>(b) * N;
  const uint8_t* rmb = rm ? rm + bn0 : nullptr;
  const uint8_t* cmb = cm ? cm + bm : nullptr;
  const int r0 = rank * band, r_end = min(N, r0 + band);
  const int c0 = slice * 128 * CH + 4 * lane;   // the lane's first column

  auto stage_rows = [&](int p0, int p_end) {
    for (int n = p0 + tid; n < p_end; n += kGapThreads) {
      const float ds = ds0[bn0 + n];
      rows.gt[n - p0] = gt0[bn0 + n];
      rows.binc[n - p0] = bin_col[bn0 + n];
      rows.valid[n - p0] = rmb == nullptr || rmb[n];
      rows.ds[n - p0] = ds;
      rows.dpos[n - p0] = -ds * cnt0[bn0 + n];
    }
  };

  for (int k0 = 0; k0 < M; k0 += W) {
    const int mk = min(W, M - k0);              // columns of this chunk
    const int share = (mk + G - 1) / G;
    const int c_lo = min(mk, rank * share), c_hi = min(mk, c_lo + share);
    if (k0 > 0) {            // our rows of the last chunk are done, and
      __syncthreads();       // every CTA has copied our share of it
      cluster_wait();
    }
    // 1. this CTA's share of the chunk's column side, with its dbin_row,
    // and the first piece's row side
    stage_columns(col, d + k0, bin_row + bm + k0, gt1 + bm + k0, rmb,
                  cmb ? cmb + k0 : nullptr, N, M, c_lo, c_hi);
    for (int m = c_lo + tid; m < c_hi; m += kGapThreads) {
      // each thread reads back only what it staged itself
      const float ds = ds1[bm + k0 + m];
      const float dpos = -ds * cnt1[bm + k0 + m];
      col.ds[m] = ds;
      col.dpos[m] = dpos;
      const int q = col.idx[m];
      const float bt = margin(bin_row[bm + k0 + m], col.pos[m], gamma);
      const bool bi = q != N && bt > 0.f;
      dbin_row[bm + k0 + m] = (q == N ? dpos : 0.f) + (bi ? ds : 0.f);
    }
    int p_end = min(r_end, r0 + kGapPiece);
    stage_rows(r0, p_end);
    __syncthreads();
    cluster_arrive();
    // the warp's first D rows of the first piece load while the cluster
    // meets; row group g takes rows g, g + RG, ... of a piece
    GapRow<CH> ring[D];
    auto fetch = [&](GapRow<CH>& r, int n, int p0) {
      if (n < p_end)
        load_row<CH, VEC, true>(r, d + static_cast<size_t>(n) * M, cmb, k0, mk, c0,
                                positive_index(rows.gt[n - p0], M), M);
    };
#pragma unroll
    for (int u = 0; u < D; ++u) fetch(ring[u], r0 + group + u * RG, r0);
    cluster_wait();
    copy_shares(cluster, col, mk, share, rank, [](const BwdColumns& c, int m) {
      return BwdCol{FwdCol{c.pos[m], c.idx[m], c.valid[m]}, c.ds[m], c.dpos[m]};
    });
    __syncthreads();
    cluster_arrive();                           // our copies are made

    // dd of row n over the chunk's columns; its dbin_col with the first chunk
    auto emit = [&](const GapRow<CH>& row, int n, int p0) {
      const int i = n - p0;
      const int p = positive_index(rows.gt[i], M);
      const bool row_valid = rows.valid[i];
      const float ds = rows.ds[i], dpos0 = rows.dpos[i];
      const float pos0 = positive_score(p, M, rows.binc[i], row.cand, row.pvalid);
      float* ddrow = ddb + static_cast<size_t>(n) * M + k0;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int m0 = c0 + 128 * j;
        if (m0 >= mk) continue;
        const float4 cp = load4(&col.pos[m0]);
        const float4 cds = load4(&col.ds[m0]);
        const float4 cdp = load4(&col.dpos[m0]);
        const int4 ci = *reinterpret_cast<const int4*>(&col.idx[m0]);
        const uchar4 cv = *reinterpret_cast<const uchar4*>(&col.valid[m0]);
        const float xs[4] = {row.v[j].x, row.v[j].y, row.v[j].z, row.v[j].w};
        const float ps[4] = {cp.x, cp.y, cp.z, cp.w};
        const float dss[4] = {cds.x, cds.y, cds.z, cds.w};
        const float dps[4] = {cdp.x, cdp.y, cdp.z, cdp.w};
        const int qs[4] = {ci.x, ci.y, ci.z, ci.w};
        const bool vs[4] = {cv.x != 0, cv.y != 0, cv.z != 0, cv.w != 0};
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v0 = 0.f, v1 = 0.f;
          if (vs[e]) {
            const float t0 = margin(xs[e], pos0, gamma);
            v0 = k0 + m0 + e == p ? dpos0 : (t0 > 0.f ? ds : 0.f);
          }
          if (row_valid) {
            const float t1 = margin(xs[e], ps[e], gamma);
            v1 = n == qs[e] ? dps[e] : (t1 > 0.f ? dss[e] : 0.f);
          }
          out[e] = v0 + v1;
        }
        if (VEC) {
          store4_global(ddrow + m0, make_float4(out[0], out[1], out[2], out[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (m0 + e < mk) ddrow[m0 + e] = out[e];
        }
      }
      if (k0 == 0 && slice == 0 && lane == 0) {
        const float bt = margin(rows.binc[i], pos0, gamma);
        const bool bi = p != M && bt > 0.f;
        dbin_col[bn0 + n] = (p == M ? dpos0 : 0.f) + (bi ? ds : 0.f);
      }
    };

    // 2. the band's rows, a piece at a time, D rows of a warp in flight:
    // a row's slot is refilled with the row D further on as it is taken
    for (int p0 = r0; p0 < r_end; p0 += kGapPiece) {
      p_end = min(r_end, p0 + kGapPiece);
      if (p0 > r0) {                            // the piece before is done
        __syncthreads();
        stage_rows(p0, p_end);
        __syncthreads();
#pragma unroll
        for (int u = 0; u < D; ++u) fetch(ring[u], p0 + group + u * RG, p0);
      }
      for (int n = p0 + group; n < p_end; n += D * RG) {
#pragma unroll
        for (int u = 0; u < D; ++u) {
          const int nu = n + u * RG;
          if (nu < p_end) {
            const GapRow<CH> row = ring[u];
            fetch(ring[u], nu + D * RG, p0);
            emit(row, nu, p0);
          }
        }
      }
    }
  }
  cluster_wait();   // no CTA leaves while another may copy its share
}

inline bool gap_shape_ok(int B, int N, int M) {
  return B > 0 && B <= 65535 && N > 0 && M > 0;
}

// a pair's plan: a cluster of G CTAs (1-16), bands of `band` rows that
// cover every row once, no CTA without a row
inline bool gap_plan_ok(int N, int G, int band) {
  return G >= 1 && G <= kGapMaxCluster && band > 0 &&
         static_cast<long long>(band) * G >= N &&
         static_cast<long long>(band) * (G - 1) < N;
}

// the launch of either kernel: B pairs, a cluster of G CTAs each (the
// non-portable attribute set above 8)
template <typename K>
cudaError_t gap_config(K kernel, int B, int G, cudaStream_t stream,
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

using GapFwdKernel = void (*)(const float*, const float*, const float*, const int*,
                              const int*, const uint8_t*, const uint8_t*, float*,
                              float*, float*, float*, int, int, int, float);
using GapBwdKernel = void (*)(const float*, const float*, const float*, const int*,
                              const int*, const uint8_t*, const uint8_t*,
                              const float*, const float*, const float*,
                              const float*, float*, float*, float*, int, int, int,
                              float);

// the instantiations for M columns: a lane's 16-byte chunks and the slices
// (above 1024 columns, chunks of 1024)
GapFwdKernel pick_gap_fwd(int M, int band, bool vec) {
  if (M > kGapChunk || band > kGapPiece)
    return vec ? gap_fwd_kernel<4, 2, true, true> : gap_fwd_kernel<4, 2, false, true>;
  if (M <= 256)
    return vec ? gap_fwd_kernel<2, 1, true, false> : gap_fwd_kernel<2, 1, false, false>;
  if (M <= 512)
    return vec ? gap_fwd_kernel<4, 1, true, false> : gap_fwd_kernel<4, 1, false, false>;
  return vec ? gap_fwd_kernel<4, 2, true, false> : gap_fwd_kernel<4, 2, false, false>;
}
GapBwdKernel pick_gap_bwd(int M, bool vec) {
  if (M <= 256) return vec ? gap_bwd_kernel<2, 1, true> : gap_bwd_kernel<2, 1, false>;
  if (M <= 512) return vec ? gap_bwd_kernel<4, 1, true> : gap_bwd_kernel<4, 1, false>;
  return vec ? gap_bwd_kernel<4, 2, true> : gap_bwd_kernel<4, 2, false>;
}

}  // namespace
}  // namespace mdgat

// dense [B, N, M], bin_row [B, M], bin_col [B, N] f32; gt0 [B, N], gt1
// [B, M] int32 (< 0 = unmatched); rm [B, N], cm [B, M] uint8 or null (all
// valid). Out: s0, cnt0 [B, N] and s1, cnt1 [B, M] f32. Any N and M.
// cluster: the CTAs a pair (1-16), band: the rows a CTA, from the plan
// (ops/cuda/gap_loss.py::gap_plan); together every row once, no CTA
// without a row.
extern "C" cudaError_t mdgat_gap_fwd(const void* dense, const void* bin_row,
                                     const void* bin_col, const void* gt0,
                                     const void* gt1, const void* rm,
                                     const void* cm, void* s0, void* s1,
                                     void* cnt0, void* cnt1, int B, int N, int M,
                                     int cluster, int band, float gamma,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (!gap_shape_ok(B, N, M) || !gap_plan_ok(N, cluster, band))
    return cudaErrorInvalidValue;
  const bool vec = M % 4 == 0 && aligned_to(dense, 16);
  const GapFwdKernel kernel = pick_gap_fwd(M, band, vec);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = gap_config(kernel, B, cluster, stream, cfg, attr);
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
// dd [B, N, M], dbin_row [B, M], dbin_col [B, N] f32. cluster and band
// from the plan (ops/cuda/gap_loss.py::gap_plan), as the forward's.
extern "C" cudaError_t mdgat_gap_bwd(const void* dense, const void* bin_row,
                                     const void* bin_col, const void* gt0,
                                     const void* gt1, const void* rm,
                                     const void* cm, const void* cnt0,
                                     const void* cnt1, const void* ds0,
                                     const void* ds1, void* dd, void* dbin_row,
                                     void* dbin_col, int B, int N, int M,
                                     int cluster, int band, float gamma,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (!gap_shape_ok(B, N, M) || !gap_plan_ok(N, cluster, band))
    return cudaErrorInvalidValue;
  const bool vec = M % 4 == 0 && aligned_to(dense, 16) && aligned_to(dd, 16);
  const GapBwdKernel kernel = pick_gap_bwd(M, vec);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = gap_config(kernel, B, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto i = [](const void* p) { return static_cast<const int*>(p); };
  auto u = [](const void* p) { return static_cast<const uint8_t*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return cudaLaunchKernelEx(&cfg, kernel, f(dense), f(bin_row), f(bin_col), i(gt0),
                            i(gt1), u(rm), u(cm), f(cnt0), f(cnt1), f(ds0), f(ds1),
                            o(dd), o(dbin_row), o(dbin_col), N, M, band, gamma);
}

// *count = how many clusters of G CTAs of the forward's (backward: with
// `backward` != 0) launch for M columns the card holds at once
// (cudaOccupancyMaxActiveClusters).
extern "C" cudaError_t mdgat_gap_active_clusters(int M, int cluster, int backward,
                                                 int* count) {
  using namespace mdgat;
  if (M <= 0 || cluster < 1 || cluster > kGapMaxCluster || count == nullptr)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (backward) {
    const GapBwdKernel kernel = pick_gap_bwd(M, true);
    const cudaError_t err = gap_config(kernel, 1, cluster, nullptr, cfg, attr);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  }
  const GapFwdKernel kernel = pick_gap_fwd(M, 1, true);
  const cudaError_t err = gap_config(kernel, 1, cluster, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}
