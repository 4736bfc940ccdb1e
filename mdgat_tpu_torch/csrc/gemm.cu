// Tiled f32 GEMM with the epilogues of the eval attentional-propagation
// layer: out = [relu](A @ W + bias) [+ residual].
//
// Together with attention.cu this replaces the TPU kernel
// mdgat_tpu/ops/pallas/attention.py::_layer_kernel (reached from
// fused_layer_apply): one whole eval layer, x + MLP(cat(x, MHA(x, src))),
// with eval BatchNorm folded into the first MLP conv. The layer runs as six
// launches of this kernel around one attention launch (q, k, v
// projections; attention; head merge; first MLP conv + ReLU; second MLP
// conv + residual). The TPU kernel keeps every intermediate in VMEM; here
// the intermediates (q, k, v, attention output, merge, MLP hidden, all
// f32) round-trip through HBM between launches. Fusing the layer into one
// kernel is later work.
//
// Layout options cover what the layer needs without relayout copies:
// * A may be given as two operands, A1 [R, K1] and A2 [R, K2] (f32),
//   standing for cat(A1, A2) [R, K1 + K2]: the concat-free first MLP conv,
//   relu(x @ w1x + merge @ w1m + b1).
// * A1 may be read head-split: a [B, H, rows, K1/H] tensor read as
//   [B * rows, K1] with column h * Dh + d (the attention output feeding the
//   head merge).
// * The output may be written head-split, [B, H, rows, C/H] from column
//   h * Dh + d (q, k, v straight into the attention kernel's layout).
// The host folds the 1/sqrt(Dh) score scale into wq/bq and permutes the
// torch channel interleave (c = d*H + h) into head-blocked columns, so the
// head split is a plain reshape.
//
// The fused-MHA training pair (ops/cuda/mha.py) runs its products here
// too. Its backward needs two more modes. W may be read transposed
// (w_trans: w is [C, K] and stands for its transpose; this mode takes no
// bias), for dq @ wq^T, g @ wm^T and cat(dk, dv) @ cat(wk, wv)^T. And
// gemm_tn_kernel forms the weight gradients, skinny products with a long
// reduction (x^T dq: [D, B*N] x [B*N, D]): the rows are split over the
// grid's z axis, each block writes a partial [K1+1, C] tile (row K1 holds
// the column sums of B, the bias gradient), and a second kernel adds the
// partials in a fixed order, so the result does not change from run to run
// (the TPU kernel accumulates them across its sequential grid instead).
//
// Design: a 64x64 output tile per block of 256 threads, 4x4 per thread,
// K in steps of 16 through shared memory, f32 FMA (no TF32). A1 and the
// residual/output are f32 or bf16; internals are f32. Rows and columns are
// bounds-checked, so any R, C, K works (the ragged query edge included).
// What bounds it on the H100: the f32 FMA pipe fed from shared memory
// (8 shared loads per 16 FMAs), far from the tensor-core rate; the layer's
// HBM round trips between launches come on top.

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

template <typename TA, typename TO, bool WT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a1, int a1_heads, const float* __restrict__ a2,
            int K1, int K2, const float* __restrict__ w,
            const float* __restrict__ bias, const TO* __restrict__ res,
            TO* __restrict__ out, int out_heads, int rows_per_batch, int R,
            int C, int relu) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int K = K1 + K2;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int dh_in = a1_heads > 0 ? K1 / a1_heads : 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK, four elements per thread, k fastest (coalesced)
#pragma unroll
    for (int e = 0; e < (BM * BK) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / BK, kk = idx % BK;
      const int row = row0 + r, kc = k0 + kk;
      float val = 0.f;
      if (row < R && kc < K) {
        if (kc < K1) {
          if (a1_heads > 0) {
            const int b = row / rows_per_batch, n = row % rows_per_batch;
            const int h = kc / dh_in, d = kc % dh_in;
            val = to_f32(a1[((static_cast<size_t>(b) * a1_heads + h) *
                             rows_per_batch + n) * dh_in + d]);
          } else {
            val = to_f32(a1[static_cast<size_t>(row) * K1 + kc]);
          }
        } else {
          val = a2[static_cast<size_t>(row) * K2 + (kc - K1)];
        }
      }
      As[kk][r] = val;
    }
    // W tile: BK x BN, columns fastest (coalesced)
#pragma unroll
    for (int e = 0; e < (BK * BN) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int kk = idx / BN, c = idx % BN;
      const int kc = k0 + kk, col = col0 + c;
      if constexpr (WT)
        Bs[kk][c] = (kc < K && col < C) ? w[static_cast<size_t>(col) * K + kc] : 0.f;
      else
        Bs[kk][c] = (kc < K && col < C) ? w[static_cast<size_t>(kc) * C + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bcol[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bcol[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bcol[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int dh_out = out_heads > 0 ? C / out_heads : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= C) continue;
      float val = acc[i][j];
      if constexpr (!WT) val += bias[col];  // the transposed mode has no bias
      if (relu) val = fmaxf(val, 0.f);
      size_t o;
      if (out_heads > 0) {
        const int b = row / rows_per_batch, n = row % rows_per_batch;
        const int h = col / dh_out, d = col % dh_out;
        o = ((static_cast<size_t>(b) * out_heads + h) * rows_per_batch + n) *
                dh_out + d;
      } else {
        o = static_cast<size_t>(row) * C + col;
      }
      if (res != nullptr) val = to_f32(res[o]) + val;
      out[o] = from_f32<TO>(val);
    }
  }
}

template <typename TA, typename TO>
cudaError_t launch(const void* a1, int a1_heads, const float* a2, int K1,
                   int K2, const float* w, const float* bias, const void* res,
                   void* out, int out_heads, int rows_per_batch, int R, int C,
                   int relu, int w_trans, cudaStream_t stream) {
  dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  // W transposed is its own instantiation: the plain one keeps the eval
  // layer's code, and its registers, as they were
  auto kernel = w_trans ? gemm_kernel<TA, TO, true> : gemm_kernel<TA, TO, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a1), a1_heads, a2, K1, K2, w, bias,
      static_cast<const TO*>(res), static_cast<TO*>(out), out_heads,
      rows_per_batch, R, C, relu);
  return cudaGetLastError();
}

// partial[z][k][c] = sum over the rows r of split z of a[r][k] * b[r][c],
// k < K1; partial[z][K1][c] = sum over those rows of b[r][c].
__global__ void __launch_bounds__(kThreads)
gemm_tn_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ partial, int R, int K1, int C,
               int rows_per_split) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int k0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool sums = blockIdx.y == 0 && ty == 0;

  float acc[4][4];
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int e = 0; e < (BK * BM) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int rr = idx / BM, kk = idx % BM;
      const int row = r0 + rr, kc = k0 + kk;
      As[rr][kk] = (row < r_end && kc < K1)
                       ? a[static_cast<size_t>(row) * K1 + kc] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int rr = idx / BN, c = idx % BN;
      const int row = r0 + rr, col = col0 + c;
      Bs[rr][c] = (row < r_end && col < C)
                      ? b[static_cast<size_t>(row) * C + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < BK; ++rr) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (sums) {
#pragma unroll
        for (int j = 0; j < 4; ++j) csum[j] += bv[j];
      }
    }
    __syncthreads();
  }

  float* pz = partial + static_cast<size_t>(blockIdx.z) * (K1 + 1) * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + ty * 4 + i;
    if (kc >= K1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < C) pz[static_cast<size_t>(kc) * C + col] = acc[i][j];
    }
  }
  if (sums) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < C) pz[static_cast<size_t>(K1) * C + col] = csum[j];
    }
  }
}

// dw[k][c] = sum_z partial[z][k][c] (k < K1), db[c] = sum_z partial[z][K1][c],
// z ascending: a fixed order.
__global__ void tn_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dw, float* __restrict__ db,
                                 int K1, int C, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = (K1 + 1) * C;
  if (idx >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z)
    s += partial[static_cast<size_t>(z) * total + idx];
  if (idx < K1 * C) dw[idx] = s; else db[idx - K1 * C] = s;
}

}  // namespace
}  // namespace mdgat

// out[R, C] = [relu](cat(a1, a2) @ w + bias) [+ res]; w [K1+K2, C] f32,
// bias [C] f32, a2 [R, K2] f32 or null (K2 = 0), res null or laid out as
// out. With w_trans, w is [C, K1+K2] and stands for its transpose, and bias
// must be null.
// a1_heads / out_heads > 0 select the head-split layouts, whose batch holds
// rows_per_batch rows. Dtype codes: 0 f32, 1 bf16.
extern "C" cudaError_t mdgat_gemm(const void* a1, int a1_dtype, int a1_heads,
                                  const void* a2, int K1, int K2,
                                  const void* w, const void* bias,
                                  const void* res, void* out, int out_dtype,
                                  int out_heads, int rows_per_batch, int R,
                                  int C, int relu, int w_trans,
                                  cudaStream_t stream) {
  using namespace mdgat;
  if (R <= 0 || C <= 0 || K1 <= 0 || K2 < 0 || (K2 > 0 && a2 == nullptr) ||
      (bias == nullptr) != (w_trans != 0))
    return cudaErrorInvalidValue;
  if ((a1_heads > 0 || out_heads > 0) && (rows_per_batch <= 0 || R % rows_per_batch))
    return cudaErrorInvalidValue;
  if ((a1_heads > 0 && K1 % a1_heads) || (out_heads > 0 && C % out_heads))
    return cudaErrorInvalidValue;
  const auto* a2f = static_cast<const float*>(a2);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  using bf16 = __nv_bfloat16;
  if (a1_dtype == kF32 && out_dtype == kF32)
    return launch<float, float>(a1, a1_heads, a2f, K1, K2, wf, bf, res, out,
                                out_heads, rows_per_batch, R, C, relu, w_trans,
                                stream);
  if (a1_dtype == kBF16 && out_dtype == kF32)
    return launch<bf16, float>(a1, a1_heads, a2f, K1, K2, wf, bf, res, out,
                               out_heads, rows_per_batch, R, C, relu, w_trans,
                                stream);
  if (a1_dtype == kF32 && out_dtype == kBF16)
    return launch<float, bf16>(a1, a1_heads, a2f, K1, K2, wf, bf, res, out,
                               out_heads, rows_per_batch, R, C, relu, w_trans,
                                stream);
  if (a1_dtype == kBF16 && out_dtype == kBF16)
    return launch<bf16, bf16>(a1, a1_heads, a2f, K1, K2, wf, bf, res, out,
                              out_heads, rows_per_batch, R, C, relu, w_trans,
                                stream);
  return cudaErrorInvalidValue;
}

// dw [K1, C] = a^T b and db [C] = column sums of b, for a [R, K1] and
// b [R, C], all f32 and contiguous. partial is scratch of
// splits * (K1 + 1) * C floats; split z covers rows
// [z * rows_per_split, (z + 1) * rows_per_split).
extern "C" cudaError_t mdgat_gemm_tn(const void* a, const void* b,
                                     void* partial, void* dw, void* db, int R,
                                     int K1, int C, int rows_per_split,
                                     int splits, cudaStream_t stream) {
  using namespace mdgat;
  if (R <= 0 || K1 <= 0 || C <= 0 || rows_per_split <= 0 || splits <= 0 ||
      static_cast<long long>(rows_per_split) * splits < R)
    return cudaErrorInvalidValue;
  dim3 grid((C + BN - 1) / BN, (K1 + BM - 1) / BM, splits);
  gemm_tn_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(partial), R, K1, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = (K1 + 1) * C;
  tn_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<float*>(db), K1, C, splits);
  return cudaGetLastError();
}
