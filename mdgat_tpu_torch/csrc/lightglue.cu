// LightGlue's kernels (models/lightglue.py, ops/cuda/lightglue.py): the
// rotary self-attention, the two-way cross-attention, LayerNorm + GELU
// between an FFN's two products, and the assignment with its decision.
//
// They replace no TPU kernel: the JAX package has no LightGlue. Its linear
// layers run on gemm.cu::gemm_kernel; these compute the rest of the net on
// the card, in float32 (no TF32), for head dim 64 (D 256, 4 heads).
//
// What bounds them on the H100. At 2048 keypoints a pair the attention
// products are about 59% of a pair's ~229 GFLOP (self 2 x 4.3, cross 6.4 a
// layer): the f32 FMA pipe, 67 TFLOP/s, which shared memory must feed (the
// SM starts 128 FMAs a clock and serves 128 bytes of shared memory). The
// assignment is ~1% of the work, LayerNorm + GELU a read and a write of the
// FFN's hidden rows (bytes, 3.35 TB/s).
//
// The shared design: a block of 256 threads owns a 64 x 64 tile of scores;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows a * 16 + ty and columns
// c * 16 + tx (a, c < 4). Every product (scores, P V, P^T V) is
// tile_product: both operands in shared memory as [output index][k] with a
// row stride of 68 floats, read as 16-byte vectors along k, so that per
// four k a thread issues 8 vector loads for 64 FMAs; the 16 tx of a
// half-warp read 16 rows 68 floats apart (disjoint banks), the two ty of a
// warp read the same rows of B (a broadcast), and A is a broadcast. V is
// staged transposed ([d][key]) so that P V has the same form.
//
// (a) lg_self_attention_kernel: a block a (pair, head, 64 queries); q
//     rotated as it is loaded, then over key tiles: k rotated as loaded, v
//     transposed, scores / 8, padded keys out, an online softmax (row max
//     and sum reduced over the 16 tx with shuffles), P V. No score slab,
//     no scratch: it captures at any key count.
// (b) lg_cross_attention_kernel: a block a (pair, head, 64 rows of cloud
//     0), qk0 and v0 resident. Each 64 x 64 tile of sim = qk0 qk1^T / 8 is
//     formed once and gives both directions: m0's online row softmax
//     against v1 (completed in the block), and for each of the tile's
//     columns its max over the block's valid rows, its sum and P_col^T v0,
//     written as a partial. lg_cross_merge_kernel merges a column's
//     partials over the row tiles in ascending order (max, rescale, sum):
//     m1 = softmax_cols(sim)^T v0, the same bits from run to run. The
//     partials (66 floats a row tile and column) are a scratch sized from
//     the shapes (ops/cuda/lightglue.py::cross_scratch_floats).
// (c) lg_ln_gelu_kernel: a warp a row, the row in registers (one read, one
//     write), mean and variance by warp sums, erf GELU.
// (d) the assignment, four launches over 64 x 64 tiles of sim = md0 md1^T
//     (K = D in chunks of 64): lg_assign_stats_kernel writes each tile's
//     row and column (max, sum exp) over the valid block;
//     lg_assign_lse_kernel merges them into the row and column log-sum-exps
//     and takes logsigmoid(z) of every keypoint; lg_assign_max_kernel forms
//     the tile again and the inner block ((s - lse_row) + (s - lse_col)) +
//     (logsigmoid(z0) + logsigmoid(z1)), and writes each tile's row and
//     column maxima with their first indices; lg_assign_decide_kernel (a
//     block a pair) takes the maxima, the mutual check, exp(best) > th and
//     mscores as upstream's filter_matches. The [B, N, M] matrix is never
//     written; sim is formed twice, which at 1% of the work costs less than
//     writing and reading it.

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kT = 64;            // tile edge: rows, columns, head dim
constexpr int kLD = kT + 4;       // shared row stride (16-byte rows, banks)
constexpr int kTileFloats = kT * kLD;
constexpr int kThreads = 256;
constexpr int kRot = kT / 2;      // rotary frequencies a head

// acc[a][c] += sum_k A[(a*16+ty)*kLD + k] * B[(c*16+tx)*kLD + k], k < 64,
// one FMA chain an output in ascending k
__device__ __forceinline__ void tile_product(const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             float (&acc)[4][4], int ty,
                                             int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (i * 16 + ty) * kLD + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (j * 16 + tx) * kLD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// over the 16 tx of a row (lanes xor 1..8 stay in a half-warp)
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// rows r0.. of a [rows][ld] matrix, columns k0..k0+63, into [r][kLD]; rows
// past n are zero
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int n, int ld, int k0, int tid) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int idx = tid + e * kThreads, r = idx >> 4, c = (idx & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      v = load4(src + static_cast<size_t>(r0 + r) * ld + k0 + c);
    *reinterpret_cast<float4*>(dst + r * kLD + c) = v;
  }
}

// rows r0.. of a [rows][64] head, rotated by their cos / sin ([rows][32]):
// out[2i] = x[2i] c - x[2i+1] s, out[2i+1] = x[2i+1] c + x[2i] s
__device__ __forceinline__ void load_rotated(float* dst, const float* src,
                                             const float* cs, const float* sn,
                                             int r0, int n, int tid) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int idx = tid + e * kThreads, r = idx >> 5, i = idx & 31;
    float2 o = make_float2(0.f, 0.f);
    if (r0 + r < n) {
      const size_t row = static_cast<size_t>(r0 + r);
      const float2 x = *reinterpret_cast<const float2*>(src + row * kT + 2 * i);
      const float c = cs[row * kRot + i], s = sn[row * kRot + i];
      o.x = x.x * c - x.y * s;
      o.y = x.y * c + x.x * s;
    }
    *reinterpret_cast<float2*>(dst + r * kLD + 2 * i) = o;
  }
}

// rows r0.. of a [rows][64] head, transposed: dst[d][r]
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                int r0, int n, int tid) {
  const int r = tid & 63;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = ((tid >> 6) + 4 * e) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = load4(src + static_cast<size_t>(r0 + r) * kT + d);
    dst[(d + 0) * kLD + r] = v.x;
    dst[(d + 1) * kLD + r] = v.y;
    dst[(d + 2) * kLD + r] = v.z;
    dst[(d + 3) * kLD + r] = v.w;
  }
}

// -------------------------------------------------- (a) self-attention
__global__ void __launch_bounds__(kThreads)
lg_self_attention_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ cosb,
                         const float* __restrict__ sinb,
                         const bool* __restrict__ mask, float* __restrict__ out,
                         int H, int N) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;
  float* sk = sq + kTileFloats;
  float* svt = sk + kTileFloats;
  float* sp = svt + kTileFloats;
  float* ok = sp + kTileFloats;  // [64] key validity of the tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, r0 = blockIdx.x * kT;
  const size_t head = static_cast<size_t>(N) * kT;
  const float* q = qkv + (static_cast<size_t>(b) * 3 * H + h) * head;
  const float* k = q + static_cast<size_t>(H) * head;
  const float* v = k + static_cast<size_t>(H) * head;
  const float* cs = cosb + static_cast<size_t>(b) * N * kRot;
  const float* sn = sinb + static_cast<size_t>(b) * N * kRot;
  const bool* mk = mask + static_cast<size_t>(b) * N;

  load_rotated(sq, q, cs, sn, r0, N, tid);
  float acc[4][4] = {}, mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = kBigNeg, lrow[i] = 0.f;

  for (int c0 = 0; c0 < N; c0 += kT) {
    __syncthreads();  // the previous tile's products are done
    load_rotated(sk, k, cs, sn, c0, N, tid);
    load_transposed(svt, v, c0, N, tid);
    if (tid < kT) ok[tid] = (c0 + tid < N && mk[c0 + tid]) ? 1.f : 0.f;
    __syncthreads();
    float s[4][4] = {};
    tile_product(sq, sk, s, ty, tx);
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = ok[j * 16 + tx] != 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kBigNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= 0.125f;
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(mrow[i], max16(mx));
      const float alpha = expf(mrow[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - mnew) : 0.f;
        sp[(i * 16 + ty) * kLD + j * 16 + tx] = p;
        sum += p;
      }
      lrow[i] = lrow[i] * alpha + sum16(sum);
      mrow[i] = mnew;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_product(sp, svt, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i * 16 + ty;
    if (row >= N) continue;
    const float inv = lrow[i] > 0.f ? 1.f / lrow[i] : 0.f;
    float* o = out + (static_cast<size_t>(bh) * N + row) * kT;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j * 16 + tx] = acc[i][j] * inv;
  }
}

// ------------------------------------------------- (b) cross-attention
constexpr int kCrossSmem =
    (6 * kTileFloats + 2 * 16 * kT + 4 * kT) * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kThreads)
lg_cross_attention_kernel(const float* __restrict__ qkv0,
                          const float* __restrict__ qkv1,
                          const bool* __restrict__ mask0,
                          const bool* __restrict__ mask1,
                          float* __restrict__ m0out, float* __restrict__ pacc,
                          float* __restrict__ pstat, int H, int N, int M) {
  extern __shared__ __align__(16) float smem[];
  float* sqk0 = smem;
  float* sv0t = sqk0 + kTileFloats;
  float* sqk1 = sv0t + kTileFloats;
  float* sv1t = sqk1 + kTileFloats;
  float* sp = sv1t + kTileFloats;   // row softmax P [row][col]
  float* spt = sp + kTileFloats;    // column softmax P^T [col][row]
  float* red = spt + kTileFloats;   // [16][64] column partials of each ty
  float* cmax = red + 16 * kT;
  float* csum = cmax + kT;
  float* ok0 = csum + kT;           // row validity
  float* ok1 = ok0 + kT;            // column validity of the tile
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rt = blockIdx.x, RT = gridDim.x, r0 = rt * kT;
  const float* qk0 = qkv0 + (static_cast<size_t>(b) * 2 * H + h) * N * kT;
  const float* v0 = qk0 + static_cast<size_t>(H) * N * kT;
  const float* qk1 = qkv1 + (static_cast<size_t>(b) * 2 * H + h) * M * kT;
  const float* v1 = qk1 + static_cast<size_t>(H) * M * kT;
  const bool* mk0 = mask0 + static_cast<size_t>(b) * N;
  const bool* mk1 = mask1 + static_cast<size_t>(b) * M;

  load_tile(sqk0, qk0, r0, N, kT, 0, tid);
  load_transposed(sv0t, v0, r0, N, tid);
  if (tid < kT) ok0[tid] = (r0 + tid < N && mk0[r0 + tid]) ? 1.f : 0.f;
  float acc[4][4] = {}, mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mrow[i] = kBigNeg, lrow[i] = 0.f;

  for (int c0 = 0; c0 < M; c0 += kT) {
    __syncthreads();
    load_tile(sqk1, qk1, c0, M, kT, 0, tid);
    load_transposed(sv1t, v1, c0, M, tid);
    if (tid < kT) ok1[tid] = (c0 + tid < M && mk1[c0 + tid]) ? 1.f : 0.f;
    __syncthreads();
    float s[4][4] = {};
    tile_product(sqk0, sqk1, s, ty, tx);
    bool vc[4], vr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vc[j] = ok1[j * 16 + tx] != 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) vr[i] = ok0[i * 16 + ty] != 0.f;
    // rows: m0's online softmax over the valid columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kBigNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= 0.125f;
        if (vc[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(mrow[i], max16(mx));
      const float alpha = expf(mrow[i] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vc[j] ? expf(s[i][j] - mnew) : 0.f;
        sp[(i * 16 + ty) * kLD + j * 16 + tx] = p;
        sum += p;
      }
      lrow[i] = lrow[i] * alpha + sum16(sum);
      mrow[i] = mnew;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    // columns: the max over this block's valid rows
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = kBigNeg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (vr[i]) mx = fmaxf(mx, s[i][j]);
      red[ty * kT + j * 16 + tx] = mx;
    }
    __syncthreads();
    tile_product(sp, sv1t, acc, ty, tx);
    if (tid < kT) {
      float g = kBigNeg;
#pragma unroll
      for (int t = 0; t < 16; ++t) g = fmaxf(g, red[t * kT + tid]);
      cmax[tid] = g;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j * 16 + tx;
      const float g = cmax[col];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = vr[i] ? expf(s[i][j] - g) : 0.f;
        spt[col * kLD + i * 16 + ty] = p;
        sum += p;
      }
      red[ty * kT + col] = sum;
    }
    __syncthreads();
    if (tid < kT) {
      float t = 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u) t += red[u * kT + tid];
      csum[tid] = t;
    }
    float part[4][4] = {};
    tile_product(spt, sv0t, part, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = c0 + a * 16 + ty;
      if (col >= M) continue;
      float* o = pacc + ((static_cast<size_t>(bh) * RT + rt) * M + col) * kT;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c * 16 + tx] = part[a][c];
    }
    __syncthreads();
    if (tid < kT && c0 + tid < M) {
      float* st = pstat + ((static_cast<size_t>(bh) * RT + rt) * M + c0 + tid) * 2;
      st[0] = cmax[tid];
      st[1] = csum[tid];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i * 16 + ty;
    if (row >= N) continue;
    const float inv = lrow[i] > 0.f ? 1.f / lrow[i] : 0.f;
    float* o = m0out + (static_cast<size_t>(bh) * N + row) * kT;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j * 16 + tx] = acc[i][j] * inv;
  }
}

// m1[bh][col][d]: a column's partials over the row tiles, in ascending order
__global__ void __launch_bounds__(kThreads)
lg_cross_merge_kernel(const float* __restrict__ pacc,
                      const float* __restrict__ pstat, float* __restrict__ m1,
                      int RT, int M) {
  const int col = blockIdx.x * 4 + (threadIdx.x >> 6), d = threadIdx.x & 63;
  const int bh = blockIdx.y;
  if (col >= M) return;
  const size_t first = static_cast<size_t>(bh) * RT * M + col;
  float g = kBigNeg;
  for (int r = 0; r < RT; ++r) g = fmaxf(g, pstat[(first + static_cast<size_t>(r) * M) * 2]);
  float total = 0.f, a = 0.f;
  for (int r = 0; r < RT; ++r) {
    const size_t at = first + static_cast<size_t>(r) * M;
    const float sum = pstat[at * 2 + 1];
    if (sum > 0.f) {
      const float w = expf(pstat[at * 2] - g);
      total = fmaf(w, sum, total);
      a = fmaf(w, pacc[at * kT + d], a);
    }
  }
  m1[(static_cast<size_t>(bh) * M + col) * kT + d] = total > 0.f ? a / total : 0.f;
}

// ------------------------------------------------ (c) LayerNorm + GELU
template <int V>  // float4s a lane: C = 128 V
__global__ void __launch_bounds__(kThreads)
lg_ln_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int R, float eps) {
  constexpr int C = 128 * V;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float* xr = x + static_cast<size_t>(row) * C;
  float4 v[V];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    v[q] = load4(xr + q * 128 + lane * 4);
    s += (v[q].x + v[q].y) + (v[q].z + v[q].w);
  }
  const float mean = warp_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const float a = v[q].x - mean, b = v[q].y - mean, c = v[q].z - mean,
                d = v[q].w - mean;
    ss += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = 1.f / sqrtf(warp_sum(ss) / C + eps);
  float* orow = out + static_cast<size_t>(row) * C;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int c = q * 128 + lane * 4;
    const float4 g = load4(w + c), bb = load4(bias + c);
    float y[4] = {(v[q].x - mean) * rstd * g.x + bb.x,
                  (v[q].y - mean) * rstd * g.y + bb.y,
                  (v[q].z - mean) * rstd * g.z + bb.z,
                  (v[q].w - mean) * rstd * g.w + bb.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      y[t] = 0.5f * y[t] * (1.f + erff(y[t] * 0.70710678118654752f));
    *reinterpret_cast<float4*>(orow + c) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

// -------------------------------------------- (d) assignment, decision
// the scratch of mdgat_lg_assign, in floats (indices stored as int bits)
struct AssignScratch {
  float *rowpart, *colpart;       // [B][N][CT][2], [B][M][RT][2]: max, sum
  float *lr, *lz0, *lc, *lz1;     // [B][N], [B][N], [B][M], [B][M]
  float *rbv, *cbv;               // [B][N][CT], [B][M][RT]: a tile's best
  int *rbi, *cbi;                 // and its first index
  int* ridx;                      // [B][N] a row's best column (-1 none)
  float* rval;                    // [B][N] its value
  int* cidx;                      // [B][M]
  __device__ AssignScratch(float* p, int B, int N, int M, int RT, int CT) {
    const size_t n = static_cast<size_t>(B) * N, m = static_cast<size_t>(B) * M;
    rowpart = p; p += n * CT * 2;
    colpart = p; p += m * RT * 2;
    lr = p; p += n;
    lz0 = p; p += n;
    lc = p; p += m;
    lz1 = p; p += m;
    rbv = p; p += n * CT;
    rbi = reinterpret_cast<int*>(p); p += n * CT;
    cbv = p; p += m * RT;
    cbi = reinterpret_cast<int*>(p); p += m * RT;
    ridx = reinterpret_cast<int*>(p); p += n;
    rval = p; p += n;
    cidx = reinterpret_cast<int*>(p);
  }
  static long long floats(int B, int N, int M, int RT, int CT) {
    const long long n = static_cast<long long>(B) * N, m = static_cast<long long>(B) * M;
    return 2 * n * CT + 2 * m * RT + 2 * n + 2 * m + 2 * n * CT + 2 * m * RT +
           2 * n + m;
  }
};

constexpr int kAssignSmem = (2 * kTileFloats + 2 * 16 * kT + kT) * 4;

// the 64 x 64 tile (rt, ct) of md0 md1^T over K = D, and the tile's
// row and column validity in okr / okc
__device__ __forceinline__ void sim_tile(const float* md0, const float* md1,
                                         const bool* mk0, const bool* mk1,
                                         int r0, int c0, int N, int M, int D,
                                         int ld, float* sa, float* sb,
                                         float* okr, float* okc,
                                         float (&s)[4][4], int tid, int ty,
                                         int tx) {
  if (tid < kT) {
    okr[tid] = (r0 + tid < N && mk0[r0 + tid]) ? 1.f : 0.f;
    okc[tid] = (c0 + tid < M && mk1[c0 + tid]) ? 1.f : 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += kT) {
    __syncthreads();
    load_tile(sa, md0, r0, N, ld, k0, tid);
    load_tile(sb, md1, c0, M, ld, k0, tid);
    __syncthreads();
    tile_product(sa, sb, s, ty, tx);
  }
}

__global__ void __launch_bounds__(kThreads)
lg_assign_stats_kernel(const float* __restrict__ md0,
                       const float* __restrict__ md1,
                       const bool* __restrict__ mask0,
                       const bool* __restrict__ mask1, float* __restrict__ scr,
                       int B, int N, int M, int D, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kTileFloats;
  float* red = sb + kTileFloats;      // [2][16][64]: maxima, then sums
  float* cmax = red + 2 * 16 * kT;    // [64]
  __shared__ float okr[kT], okc[kT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int CT = gridDim.x, RT = gridDim.y, r0 = rt * kT, c0 = ct * kT;
  AssignScratch sc(scr, B, N, M, RT, CT);
  float s[4][4] = {};
  sim_tile(md0 + static_cast<size_t>(b) * N * ld, md1 + static_cast<size_t>(b) * M * ld,
           mask0 + static_cast<size_t>(b) * N, mask1 + static_cast<size_t>(b) * M,
           r0, c0, N, M, D, ld, sa, sb, okr, okc, s, tid, ty, tx);
  bool vr[4], vc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) vr[i] = okr[i * 16 + ty] != 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) vc[j] = okc[j * 16 + tx] != 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = kBigNeg;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (vc[j]) mx = fmaxf(mx, s[i][j]);
    mx = max16(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += vc[j] ? expf(s[i][j] - mx) : 0.f;
    sum = sum16(sum);
    const int row = r0 + i * 16 + ty;
    if (tx == 0 && row < N) {
      float* p = sc.rowpart + ((static_cast<size_t>(b) * N + row) * CT + ct) * 2;
      p[0] = mx;
      p[1] = sum;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float mx = kBigNeg;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (vr[i]) mx = fmaxf(mx, s[i][j]);
    red[ty * kT + j * 16 + tx] = mx;
  }
  __syncthreads();
  if (tid < kT) {
    float g = kBigNeg;
#pragma unroll
    for (int t = 0; t < 16; ++t) g = fmaxf(g, red[t * kT + tid]);
    cmax[tid] = g;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float g = cmax[j * 16 + tx];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += vr[i] ? expf(s[i][j] - g) : 0.f;
    red[16 * kT + ty * kT + j * 16 + tx] = sum;
  }
  __syncthreads();
  if (tid < kT && c0 + tid < M) {
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < 16; ++u) t += red[16 * kT + u * kT + tid];
    float* p = sc.colpart + ((static_cast<size_t>(b) * M + c0 + tid) * RT + rt) * 2;
    p[0] = cmax[tid];
    p[1] = t;
  }
}

__device__ __forceinline__ float log_sigmoid(float z) {
  return fminf(z, 0.f) - log1pf(expf(-fabsf(z)));
}

// a log-sum-exp from (max, sum) partials, in ascending order
__device__ __forceinline__ float merge_lse(const float* p, int parts) {
  float g = kBigNeg;
  for (int t = 0; t < parts; ++t) g = fmaxf(g, p[2 * t]);
  float total = 0.f;
  for (int t = 0; t < parts; ++t)
    if (p[2 * t + 1] > 0.f) total = fmaf(expf(p[2 * t] - g), p[2 * t + 1], total);
  return total > 0.f ? g + logf(total) : kBigNeg;
}

__global__ void __launch_bounds__(kThreads)
lg_assign_lse_kernel(const float* __restrict__ md0,
                     const float* __restrict__ md1, float* __restrict__ scr,
                     int B, int N, int M, int D, int ld, int RT, int CT) {
  AssignScratch sc(scr, B, N, M, RT, CT);
  const int idx = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (idx < N) {
    const size_t at = static_cast<size_t>(b) * N + idx;
    sc.lr[at] = merge_lse(sc.rowpart + at * CT * 2, CT);
    sc.lz0[at] = log_sigmoid(md0[at * ld + D]);
  } else if (idx < N + M) {
    const size_t at = static_cast<size_t>(b) * M + (idx - N);
    sc.lc[at] = merge_lse(sc.colpart + at * RT * 2, RT);
    sc.lz1[at] = log_sigmoid(md1[at * ld + D]);
  }
}

// (v, i) better than (bv, bi): larger, or equal at a smaller index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i >= 0 && (bi < 0 || i < bi));
}

__global__ void __launch_bounds__(kThreads)
lg_assign_max_kernel(const float* __restrict__ md0,
                     const float* __restrict__ md1,
                     const bool* __restrict__ mask0,
                     const bool* __restrict__ mask1, float* __restrict__ scr,
                     int B, int N, int M, int D, int ld) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;
  float* sb = sa + kTileFloats;
  float* redv = sb + kTileFloats;                          // [16][64]
  int* redi = reinterpret_cast<int*>(redv + 16 * kT);      // [16][64]
  __shared__ float okr[kT], okc[kT];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int CT = gridDim.x, RT = gridDim.y, r0 = rt * kT, c0 = ct * kT;
  AssignScratch sc(scr, B, N, M, RT, CT);
  float s[4][4] = {};
  sim_tile(md0 + static_cast<size_t>(b) * N * ld, md1 + static_cast<size_t>(b) * M * ld,
           mask0 + static_cast<size_t>(b) * N, mask1 + static_cast<size_t>(b) * M,
           r0, c0, N, M, D, ld, sa, sb, okr, okc, s, tid, ty, tx);
  float lr[4], lz0[4], lc[4], lz1[4];
  bool vr[4], vc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i * 16 + ty;
    vr[i] = okr[i * 16 + ty] != 0.f;
    const size_t at = static_cast<size_t>(b) * N + (row < N ? row : 0);
    lr[i] = sc.lr[at];
    lz0[i] = sc.lz0[at];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c0 + j * 16 + tx;
    vc[j] = okc[j * 16 + tx] != 0.f;
    const size_t at = static_cast<size_t>(b) * M + (col < M ? col : 0);
    lc[j] = sc.lc[at];
    lz1[j] = sc.lz1[at];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s[i][j] = ((s[i][j] - lr[i]) + (s[i][j] - lc[j])) + (lz0[i] + lz1[j]);
  // rows: the best valid column of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv = -CUDART_INF_F;
    int bi = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (vr[i] && vc[j] && better(s[i][j], c0 + j * 16 + tx, bv, bi))
        bv = s[i][j], bi = c0 + j * 16 + tx;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
    }
    const int row = r0 + i * 16 + ty;
    if (tx == 0 && row < N) {
      const size_t at = (static_cast<size_t>(b) * N + row) * CT + ct;
      sc.rbv[at] = bv;
      sc.rbi[at] = bi;
    }
  }
  // columns: the best valid row of the tile
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float bv = -CUDART_INF_F;
    int bi = -1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (vr[i] && vc[j] && better(s[i][j], r0 + i * 16 + ty, bv, bi))
        bv = s[i][j], bi = r0 + i * 16 + ty;
    redv[ty * kT + j * 16 + tx] = bv;
    redi[ty * kT + j * 16 + tx] = bi;
  }
  __syncthreads();
  if (tid < kT && c0 + tid < M) {
    float bv = -CUDART_INF_F;
    int bi = -1;
    for (int t = 0; t < 16; ++t)
      if (better(redv[t * kT + tid], redi[t * kT + tid], bv, bi))
        bv = redv[t * kT + tid], bi = redi[t * kT + tid];
    const size_t at = (static_cast<size_t>(b) * M + c0 + tid) * RT + rt;
    sc.cbv[at] = bv;
    sc.cbi[at] = bi;
  }
}

__global__ void __launch_bounds__(1024)
lg_assign_decide_kernel(float* __restrict__ scr, long long* __restrict__ m0,
                        long long* __restrict__ m1, float* __restrict__ s0,
                        float* __restrict__ s1, int B, int N, int M, int RT,
                        int CT, float th) {
  AssignScratch sc(scr, B, N, M, RT, CT);
  const int b = blockIdx.x;
  const size_t rn = static_cast<size_t>(b) * N, cm = static_cast<size_t>(b) * M;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float bv = -CUDART_INF_F;
    int bi = -1;
    for (int t = 0; t < CT; ++t) {
      const size_t at = (rn + i) * CT + t;
      if (better(sc.rbv[at], sc.rbi[at], bv, bi)) bv = sc.rbv[at], bi = sc.rbi[at];
    }
    sc.ridx[rn + i] = bi;
    sc.rval[rn + i] = bv;
  }
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    float bv = -CUDART_INF_F;
    int bi = -1;
    for (int t = 0; t < RT; ++t) {
      const size_t at = (cm + j) * RT + t;
      if (better(sc.cbv[at], sc.cbi[at], bv, bi)) bv = sc.cbv[at], bi = sc.cbi[at];
    }
    sc.cidx[cm + j] = bi;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int j = sc.ridx[rn + i];
    const bool mutual = j >= 0 && sc.cidx[cm + j] == i;
    const float ms = mutual ? expf(sc.rval[rn + i]) : 0.f;
    s0[rn + i] = ms;
    m0[rn + i] = (mutual && ms > th) ? j : -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const int i = sc.cidx[cm + j];
    const bool mutual = i >= 0 && sc.ridx[rn + i] == j;
    s1[cm + j] = mutual ? s0[rn + i] : 0.f;
    m1[cm + j] = (mutual && m0[rn + i] >= 0) ? i : -1;
  }
}

int tiles(int n) { return (n + kT - 1) / kT; }

}  // namespace
}  // namespace mdgat

// out [B, H, N, 64] = softmax(rot(q) rot(k)^T / 8, padded keys out) v, for
// qkv [B, 3H, N, 64] (q heads, k heads, v heads), cos / sin [B, N, 32],
// mask [B, N] bool
extern "C" cudaError_t mdgat_lg_self_attention(const void* qkv, const void* cosb,
                                               const void* sinb, const void* mask,
                                               void* out, int B, int H, int N,
                                               int dh, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || dh != kT || B * H > 65535)
    return cudaErrorInvalidValue;
  constexpr int smem = (4 * kTileFloats + kT) * 4;
  static SmemCap cap;
  cudaError_t err = allow_smem(lg_self_attention_kernel, smem, cap);
  if (err != cudaSuccess) return err;
  lg_self_attention_kernel<<<dim3(tiles(N), B * H), kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const bool*>(mask),
      static_cast<float*>(out), H, N);
  return cudaGetLastError();
}

// m0 [B, H, N, 64] and m1 [B, H, M, 64] of qkv0 [B, 2H, N, 64] and qkv1
// [B, 2H, M, 64] (qk heads, then v heads); part is the partials' scratch,
// B H ceil(N / 64) M 66 floats
extern "C" cudaError_t mdgat_lg_cross_attention(
    const void* qkv0, const void* qkv1, const void* mask0, const void* mask1,
    void* m0, void* m1, void* part, long long part_floats, int B, int H, int N,
    int M, int dh, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0 || dh != kT || B * H > 65535)
    return cudaErrorInvalidValue;
  const long long rt = tiles(N);
  const long long acc_floats = static_cast<long long>(B) * H * rt * M * kT;
  if (part_floats != acc_floats + static_cast<long long>(B) * H * rt * M * 2)
    return cudaErrorInvalidValue;
  static SmemCap cap;
  cudaError_t err = allow_smem(lg_cross_attention_kernel, kCrossSmem, cap);
  if (err != cudaSuccess) return err;
  float* pacc = static_cast<float*>(part);
  float* pstat = pacc + acc_floats;
  lg_cross_attention_kernel<<<dim3(tiles(N), B * H), kThreads, kCrossSmem, stream>>>(
      static_cast<const float*>(qkv0), static_cast<const float*>(qkv1),
      static_cast<const bool*>(mask0), static_cast<const bool*>(mask1),
      static_cast<float*>(m0), pacc, pstat, H, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lg_cross_merge_kernel<<<dim3((M + 3) / 4, B * H), kThreads, 0, stream>>>(
      pacc, pstat, static_cast<float*>(m1), static_cast<int>(rt), M);
  return cudaGetLastError();
}

// out [R, C] = GELU(LayerNorm(x) * w + b), C in {128, 256, 512, 1024}
extern "C" cudaError_t mdgat_lg_ln_gelu(const void* x, const void* w,
                                        const void* b, void* out, int R, int C,
                                        float eps, cudaStream_t stream) {
  using namespace mdgat;
  if (R <= 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kThreads / 32 - 1) / (kThreads / 32));
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  switch (C) {
    case 128: lg_ln_gelu_kernel<1><<<grid, kThreads, 0, stream>>>(xf, wf, bf, of, R, eps); break;
    case 256: lg_ln_gelu_kernel<2><<<grid, kThreads, 0, stream>>>(xf, wf, bf, of, R, eps); break;
    case 512: lg_ln_gelu_kernel<4><<<grid, kThreads, 0, stream>>>(xf, wf, bf, of, R, eps); break;
    case 1024: lg_ln_gelu_kernel<8><<<grid, kThreads, 0, stream>>>(xf, wf, bf, of, R, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// matches0 [B, N] / matches1 [B, M] (int64, -1 unmatched) and mscores0 /
// mscores1 of md0 [B, N, ld] / md1 [B, M, ld] (descriptor in columns < D, z
// in column D), masks [B, N] / [B, M] bool; scratch of AssignScratch::floats
extern "C" cudaError_t mdgat_lg_assign(const void* md0, const void* md1,
                                       const void* mask0, const void* mask1,
                                       void* scratch, long long scratch_floats,
                                       void* m0, void* m1, void* s0, void* s1,
                                       int B, int N, int M, int D, int ld,
                                       float th, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || N <= 0 || M <= 0 || D <= 0 || D % kT || ld <= D || ld % 4 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const int RT = tiles(N), CT = tiles(M);
  if (RT > 65535 || scratch_floats != AssignScratch::floats(B, N, M, RT, CT))
    return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(md0);
  const auto* c = static_cast<const float*>(md1);
  const auto* k0 = static_cast<const bool*>(mask0);
  const auto* k1 = static_cast<const bool*>(mask1);
  auto* scr = static_cast<float*>(scratch);
  const dim3 grid(CT, RT, B);
  lg_assign_stats_kernel<<<grid, kThreads, kAssignSmem, stream>>>(a, c, k0, k1, scr, B, N, M, D, ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lg_assign_lse_kernel<<<dim3((N + M + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      a, c, scr, B, N, M, D, ld, RT, CT);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lg_assign_max_kernel<<<grid, kThreads, kAssignSmem, stream>>>(a, c, k0, k1, scr, B, N, M, D, ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lg_assign_decide_kernel<<<B, 1024, 0, stream>>>(
      scr, static_cast<long long*>(m0), static_cast<long long*>(m1),
      static_cast<float*>(s0), static_cast<float*>(s1), B, N, M, RT, CT, th);
  return cudaGetLastError();
}
