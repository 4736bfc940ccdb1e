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
// * Grid (row tile, pair), one warp per row with the lanes across the
//   columns: loads and stores are coalesced and a row's sum is a register
//   sum plus one warp shuffle. The column sums are kept per lane in
//   registers over the warp's rows, 256 columns at a time, added over the
//   block's warps in warp order, written as one row of `partial` per tile,
//   and added over the tiles in ascending order by mdgat_gap_fwd's second
//   launch. No atomics: two runs give the same bits.
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

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kGapThreads = 256;
constexpr int kGapWarps = kGapThreads / 32;
constexpr int kGapRows = 32;        // rows of one tile
constexpr int kGapWarpRows = kGapRows / kGapWarps;
constexpr int kGapMaxCols = 1024;   // staged column vectors
constexpr int kGapLaneCols = kGapMaxCols / 32;
constexpr int kGapChunk = 256;      // columns of one forward chunk
constexpr int kGapChunkCols = kGapChunk / 32;
static_assert(kGapChunk == kGapThreads, "one thread per chunk column");

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
__device__ __forceinline__ float positive(int idx, int count, float bin,
                                          const float* __restrict__ cand,
                                          size_t stride,
                                          const uint8_t* __restrict__ mask) {
  if (idx == count) return bin;
  if (idx > count) return 0.f;
  return (mask == nullptr || mask[idx]) ? cand[idx * stride] : kBigNeg;
}

// The column side of one pair, staged once per block.
struct Columns {
  float pos[kGapMaxCols];    // positive score of the column's anchor
  int idx[kGapMaxCols];      // its row index, N for the dustbin
  uint8_t valid[kGapMaxCols];
};

__device__ __forceinline__ void stage_columns(
    Columns& c, const float* __restrict__ d, const float* __restrict__ bin_row,
    const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
    const uint8_t* __restrict__ cm, int N, int M) {
  for (int m = threadIdx.x; m < M; m += kGapThreads) {
    const int q = positive_index(gt1[m], N);
    c.idx[m] = q;
    c.pos[m] = positive(q, N, bin_row[m], d + m, static_cast<size_t>(M), rm);
    c.valid[m] = cm == nullptr || cm[m];
  }
}

// S0 and the row counts for the tile's rows; partial [B][tiles][2][M] gets
// the tile's column sums (row 0) and column counts (row 1). The columns are
// walked in chunks of 256, so that a lane keeps eight column sums at a time
// (and the block enough registers free for four blocks to share an SM); a
// warp's rows are warp, warp + 8, ...: a row's sum runs over its columns in
// ascending order, a column's over the warp's rows in ascending order and
// then over the warps in warp order.
__global__ void __launch_bounds__(kGapThreads)
gap_fwd_kernel(const float* __restrict__ dense,
               const float* __restrict__ bin_row,
               const float* __restrict__ bin_col, const int* __restrict__ gt0,
               const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
               const uint8_t* __restrict__ cm, float* __restrict__ s0,
               float* __restrict__ cnt0, float* __restrict__ partial, int N,
               int M, float gamma) {
  __shared__ Columns col;
  __shared__ float wacc[kGapWarps][2][kGapChunk];
  const int b = blockIdx.y, row0 = blockIdx.x * kGapRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* d = dense + static_cast<size_t>(b) * N * M;
  const uint8_t* rmb = rm ? rm + static_cast<size_t>(b) * N : nullptr;
  const uint8_t* cmb = cm ? cm + static_cast<size_t>(b) * M : nullptr;
  stage_columns(col, d, bin_row + static_cast<size_t>(b) * M,
                gt1 + static_cast<size_t>(b) * M, rmb, cmb, N, M);
  __syncthreads();

  // the warp's rows: positive index and score, validity, running sums
  int p[kGapWarpRows];
  float pos0[kGapWarpRows], rsum[kGapWarpRows], rcnt[kGapWarpRows];
  bool row_valid[kGapWarpRows];
#pragma unroll
  for (int i = 0; i < kGapWarpRows; ++i) {
    const int n = row0 + warp + kGapWarps * i;
    rsum[i] = rcnt[i] = pos0[i] = 0.f;
    p[i] = 0;
    row_valid[i] = false;
    if (n < N) {
      const size_t bn = static_cast<size_t>(b) * N + n;
      p[i] = positive_index(gt0[bn], M);
      pos0[i] = positive(p[i], M, bin_col[bn], d + static_cast<size_t>(n) * M,
                         1, cmb);
      row_valid[i] = rmb == nullptr || rmb[n];
    }
  }

  float* out = partial +
               (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 2 * M;
  for (int c0 = 0; c0 < M; c0 += kGapChunk) {
    float csum[kGapChunkCols], ccnt[kGapChunkCols];
#pragma unroll
    for (int j = 0; j < kGapChunkCols; ++j) csum[j] = ccnt[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kGapWarpRows; ++i) {
      const int n = row0 + warp + kGapWarps * i;
      if (n < N) {
        const float* drow = d + static_cast<size_t>(n) * M;
#pragma unroll
        for (int j = 0; j < kGapChunkCols; ++j) {
          const int m = c0 + lane + 32 * j;
          if (m < M) {
            const float x = drow[m];
            const float t0 = margin(col.valid[m] ? x : kBigNeg, pos0[i], gamma);
            if (m != p[i] && t0 > 0.f) {
              rsum[i] += t0;
              rcnt[i] += 1.f;
            }
            const float t1 =
                margin(row_valid[i] ? x : kBigNeg, col.pos[m], gamma);
            if (n != col.idx[m] && t1 > 0.f) {
              csum[j] += t1;
              ccnt[j] += 1.f;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGapChunkCols; ++j) {
      wacc[warp][0][lane + 32 * j] = csum[j];
      wacc[warp][1][lane + 32 * j] = ccnt[j];
    }
    __syncthreads();
    // the block's column sums of this chunk: the warps in warp order
    const int m = c0 + threadIdx.x;
    if (m < M) {
      float sum = 0.f, cnt = 0.f;
#pragma unroll
      for (int w = 0; w < kGapWarps; ++w) {
        sum += wacc[w][0][threadIdx.x];
        cnt += wacc[w][1][threadIdx.x];
      }
      out[m] = sum;
      out[M + m] = cnt;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kGapWarpRows; ++i) {
    const int n = row0 + warp + kGapWarps * i;
    if (n < N) {
      const float sum = warp_sum(rsum[i]), cnt = warp_sum(rcnt[i]);
      if (lane == 0) {
        const size_t bn = static_cast<size_t>(b) * N + n;
        const float bt = margin(bin_col[bn], pos0[i], gamma);
        const bool bi = p[i] != M && bt > 0.f;
        s0[bn] = sum + (bi ? bt : 0.f);
        cnt0[bn] = cnt + (bi ? 1.f : 0.f);
      }
    }
  }
}

// S1 and the column counts: the tiles' partials in ascending order, then
// the dustbin term.
__global__ void gap_fwd_reduce_kernel(
    const float* __restrict__ dense, const float* __restrict__ bin_row,
    const int* __restrict__ gt1, const uint8_t* __restrict__ rm,
    const float* __restrict__ partial, float* __restrict__ s1,
    float* __restrict__ cnt1, int B, int N, int M, int tiles, float gamma) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(B) * M) return;
  const int b = static_cast<int>(i / M), m = static_cast<int>(i % M);
  const int q = positive_index(gt1[i], N);
  const float pos = positive(
      q, N, bin_row[i], dense + static_cast<size_t>(b) * N * M + m,
      static_cast<size_t>(M), rm ? rm + static_cast<size_t>(b) * N : nullptr);
  float sum = 0.f, cnt = 0.f;
  const float* p = partial + static_cast<size_t>(b) * tiles * 2 * M + m;
  for (int t = 0; t < tiles; ++t) {
    sum += p[static_cast<size_t>(t) * 2 * M];
    cnt += p[static_cast<size_t>(t) * 2 * M + M];
  }
  const float bt = margin(bin_row[i], pos, gamma);
  const bool bi = q != N && bt > 0.f;
  s1[i] = sum + (bi ? bt : 0.f);
  cnt1[i] = cnt + (bi ? 1.f : 0.f);
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
  stage_columns(col, d, bin_row + bm, gt1 + bm, rmb, cmb, N, M);
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

}  // namespace
}  // namespace mdgat

// dense [B, N, M], bin_row [B, M], bin_col [B, N] f32; gt0 [B, N], gt1
// [B, M] int32 (< 0 = unmatched); rm [B, N], cm [B, M] uint8 or null (all
// valid). Out: s0, cnt0 [B, N] and s1, cnt1 [B, M] f32. partial is scratch
// of B * ceil(N / 32) * 2 * M floats. M at most 1024.
extern "C" cudaError_t mdgat_gap_fwd(const void* dense, const void* bin_row,
                                     const void* bin_col, const void* gt0,
                                     const void* gt1, const void* rm,
                                     const void* cm, void* s0, void* s1,
                                     void* cnt0, void* cnt1, void* partial,
                                     int B, int N, int M, float gamma,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (!gap_shape_ok(B, N, M)) return cudaErrorInvalidValue;
  const int tiles = (N + kGapRows - 1) / kGapRows;
  const auto* d = static_cast<const float*>(dense);
  const auto* br = static_cast<const float*>(bin_row);
  const auto* g1 = static_cast<const int*>(gt1);
  const auto* rmask = static_cast<const uint8_t*>(rm);
  auto* part = static_cast<float*>(partial);
  gap_fwd_kernel<<<dim3(tiles, B), kGapThreads, 0, stream>>>(
      d, br, static_cast<const float*>(bin_col), static_cast<const int*>(gt0),
      g1, rmask, static_cast<const uint8_t*>(cm), static_cast<float*>(s0),
      static_cast<float*>(cnt0), part, N, M, gamma);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(B) * M;
  gap_fwd_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          stream>>>(d, br, g1, rmask, part,
                                    static_cast<float*>(s1),
                                    static_cast<float*>(cnt1), B, N, M, tiles,
                                    gamma);
  return cudaGetLastError();
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
