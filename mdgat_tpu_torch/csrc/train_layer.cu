// The MLP half of the whole-layer TRAINING kernels: the first conv with
// the batch-statistic sums, the BatchNorm affine + ReLU + second conv +
// residual, and the BatchNorm / MLP backward.
//
// Replaces, together with csrc/attention.cu, csrc/mha_bwd.cu and
// csrc/gemm.cu (ops/cuda/train_layer.py strings the launches together),
// the four TPU kernels of mdgat_tpu/ops/pallas/attention.py reached from
// _tl_fwd_calls and _ftl_bwd:
//
// * _tl_fwd1_kernel: after the fused-MHA launches have produced the
//   message, mdgat_tl_h1 forms h1 = cat(x, msg) @ w1 + b1 and, from the f32
//   accumulator before h1 is rounded to its storage type, the per-channel
//   sum and sum of squares over the rows the row mask marks.
// * _tl_fwd2_kernel: mdgat_tl_fwd2, y = x + relu(h1 * a + c) @ w2 + b2, the
//   BatchNorm affine and the ReLU applied while the A tile is loaded.
// * _tl_bwd1_kernel: mdgat_tl_bwd_sums forms dh2 = g @ w2^T tile by tile,
//   rebuilds hhat, the BN output and the ReLU mask from h1 in registers and
//   emits the column sums Sg, Sgh, dscale, dbias over ALL rows, padded ones
//   included (every row is normalised with the batch statistics, so every
//   row's cotangent reaches them; the row mask enters only in the next
//   kernel). dh2 never reaches memory. mdgat_tl_dw2 is dw2 = u^T g and
//   db2 = column sums of g, u = relu(bn(h1)) rebuilt while the A tile is
//   loaded.
// * _tl_bwd2_kernel: mdgat_tl_dh1 forms the same dh2 tile again and writes
//   dh1 = inv * (dh2 * relu_mask * scale - (Sg/cnt + hhat * Sgh/cnt) * rowmask)
//   once, in f32; every product that consumes it (dmsg, dx_mlp, dw1x, db1,
//   dw1m) and the attention backward run on the kernels of csrc/gemm.cu
//   and csrc/mha_bwd.cu.
//
// The TPU grid is sequential: those kernels zero their accumulators at
// program 0 and add into them program after program. CUDA blocks run in no
// order, so every cross-row sum here is per-block partials (one row of
// `partial` per block of rows, summed inside the block in a fixed thread
// order) and a second kernel that adds the partials in ascending block
// order. No atomics: the results carry the same bits on every run.
//
// w1 is [2D, 2D] f32, 256 KB at D = 128 and more than one SM's shared
// memory, so no weight is resident: all products walk K in steps of 16
// through shared tiles (64x64 output tile, 256 threads, 4x4 per thread, f32
// FMA: the tiling that gemm_tn_kernel of csrc/gemm.cu keeps too). x, h1, g
// and y are f32 or bf16 (one type per call); msg, dh1, the vectors and
// every sum are f32.
//
// What bounds them on the H100: the f32 FMA pipe fed from shared memory,
// eight scalar shared reads per sixteen FMAs; mdgat_tl_bwd_sums and
// mdgat_tl_dh1 both form g @ w2^T (the TPU kernels do so too). h1 ([B*N,
// 2D], 33.5 MB in f32 at 64 x 512 x 256) and dh1 round-trip through HBM
// between launches.

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// acc += A[row0 .. row0+BM, :K] @ W[:, col0 .. col0+BN]. `a(row, kc)` yields
// one element of A (its prologue applied) for row < R, kc < K. W is [K, C]
// row-major, or with WT [C, K] standing for its transpose. Thread
// (tx, ty) = (threadIdx.x % 16, threadIdx.x / 16) owns rows ty*4..+3 and
// columns tx*4..+3 of the tile.
template <bool WT, typename ALoad>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], ALoad a,
                                             const float* __restrict__ w,
                                             int K, int C, int R, int row0,
                                             int col0) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / BK, kk = idx % BK;
      const int row = row0 + r, kc = k0 + kk;
      As[kk][r] = (row < R && kc < K) ? a(row, kc) : 0.f;
    }
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
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Row blockIdx.y of partial [gridDim.y][V][C]: the block's column sums of V
// quantities. s[v][j] holds thread (tx, ty)'s sum over its four rows of
// quantity v in column col0 + tx*4 + j; the sixteen ty are added in
// ascending order.
template <int V>
__device__ __forceinline__ void write_column_partials(const float (&s)[V][4],
                                                      float* __restrict__ partial,
                                                      int C, int col0) {
  __shared__ float red[V][kThreads / 16][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[v][ty][tx * 4 + j] = s[v][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < V * BN; idx += kThreads) {
    const int v = idx / BN, c = idx % BN;
    float sum = 0.f;
    for (int t = 0; t < kThreads / 16; ++t) sum += red[v][t][c];
    const int col = col0 + c;
    if (col < C)
      partial[(static_cast<size_t>(blockIdx.y) * V + v) * C + col] = sum;
  }
}

// out[i] = sum_p partial[p][i], p ascending: a fixed order.
__global__ void partial_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int P, int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<size_t>(p) * total + idx];
  out[idx] = s;
}

template <typename T>
struct PlainLoad {   // a [R, K]
  const T* a;
  int K;
  __device__ __forceinline__ float operator()(int row, int kc) const {
    return to_f32(a[static_cast<size_t>(row) * K + kc]);
  }
};

template <typename T>
struct CatLoad {     // cat(x [R, K1], msg [R, K2])
  const T* x;
  const float* msg;
  int K1, K2;
  __device__ __forceinline__ float operator()(int row, int kc) const {
    return kc < K1 ? to_f32(x[static_cast<size_t>(row) * K1 + kc])
                   : msg[static_cast<size_t>(row) * K2 + (kc - K1)];
  }
};

template <typename T>
struct ReluAffineLoad {   // relu(h1 * a + c): the forward's BN + ReLU
  const T* h1;
  const float* a;
  const float* c;
  int K;
  __device__ __forceinline__ float operator()(int row, int kc) const {
    const float h = to_f32(h1[static_cast<size_t>(row) * K + kc]);
    return fmaxf(h * a[kc] + c[kc], 0.f);
  }
};

// hhat and the BN output of one stored h1 value, as the backward rebuilds
// them: vec rows 0 = mean, 1 = inv, 2 = scale, 3 = bias, each [C].
struct BnRebuild {
  float hhat, bn;
  __device__ __forceinline__ BnRebuild(float h, const float* __restrict__ vec,
                                       int C, int col) {
    hhat = (h - vec[col]) * vec[C + col];
    bn = hhat * vec[2 * C + col] + vec[3 * C + col];
  }
};

template <typename T>
struct ReluBnLoad {   // u = relu(bn(h1)) rebuilt from vec4
  const T* h1;
  const float* vec;
  int K;
  __device__ __forceinline__ float operator()(int row, int kc) const {
    const BnRebuild r(to_f32(h1[static_cast<size_t>(row) * K + kc]), vec, K, kc);
    return fmaxf(r.bn, 0.f);
  }
};

// h1 = cat(x, msg) @ w1 + b1, stored as T; partial [gridDim.y][2][C] gets
// the block's masked column sums of the f32 h1 and of its square.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tl_h1_kernel(const T* __restrict__ x, const float* __restrict__ msg,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const uint8_t* __restrict__ rowmask, T* __restrict__ h1,
             float* __restrict__ partial, int D, int R, int C) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  tile_product<false>(acc, CatLoad<T>{x, msg, D, D}, w1, 2 * D, C, R, row0, col0);
  float s[2][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= R) continue;
    const float m = (rowmask == nullptr || rowmask[row]) ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= C) continue;
      const float val = acc[i][j] + b1[col];
      h1[static_cast<size_t>(row) * C + col] = from_f32<T>(val);
      const float hm = val * m;
      s[0][j] += hm;
      s[1][j] += hm * val;
    }
  }
  write_column_partials<2>(s, partial, C, col0);
}

// y = x + relu(h1 * a + c) @ w2 + b2; h1 [R, K], w2 [K, C], x and y [R, C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
tl_fwd2_kernel(const T* __restrict__ x, const T* __restrict__ h1,
               const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ w2, const float* __restrict__ b2,
               T* __restrict__ y, int R, int K, int C) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  tile_product<false>(acc, ReluAffineLoad<T>{h1, a, c, K}, w2, K, C, R, row0, col0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= C) continue;
      const size_t o = static_cast<size_t>(row) * C + col;
      y[o] = from_f32<T>(to_f32(x[o]) + (acc[i][j] + b2[col]));
    }
  }
}

// The dh2 = g @ w2^T tile (g [R, D], w2 [C2, D]) and what the BN backward
// takes from it. SUMS: partial [gridDim.y][4][C2] gets the block's column
// sums of G, G * hhat, dbn * hhat and dbn over every row < R, where
// dbn = dh2 * (bn > 0) and G = dbn * scale. Otherwise out [R, C2] gets
// dh1 = inv * (G - (c1 + hhat * c2) * rowmask), vec rows 4 = c1, 5 = c2.
template <typename T, bool SUMS>
__global__ void __launch_bounds__(kThreads)
tl_dh2_kernel(const T* __restrict__ g, const T* __restrict__ h1,
              const float* __restrict__ w2, const float* __restrict__ vec,
              const uint8_t* __restrict__ rowmask, float* __restrict__ out,
              int D, int R, int C2) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  tile_product<true>(acc, PlainLoad<T>{g, D}, w2, D, C2, R, row0, col0);
  float s[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= R) continue;
    const bool valid = rowmask == nullptr || rowmask[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= C2) continue;
      const size_t o = static_cast<size_t>(row) * C2 + col;
      const BnRebuild r(to_f32(h1[o]), vec, C2, col);
      const float dbn = r.bn > 0.f ? acc[i][j] : 0.f;
      const float G = dbn * vec[2 * C2 + col];
      if constexpr (SUMS) {
        s[0][j] += G;
        s[1][j] += G * r.hhat;
        s[2][j] += dbn * r.hhat;
        s[3][j] += dbn;
      } else {
        const float corr =
            valid ? vec[4 * C2 + col] + r.hhat * vec[5 * C2 + col] : 0.f;
        out[o] = vec[C2 + col] * (G - corr);
      }
    }
  }
  if constexpr (SUMS) write_column_partials<4>(s, out, C2, col0);
}

// partial[z][k][c] = sum over the rows r of split z of u[r][k] * g[r][c],
// k < K1, with u = relu(bn(h1)); partial[z][K1][c] = sum of g[r][c].
template <typename T>
__global__ void __launch_bounds__(kThreads)
tl_dw2_kernel(const T* __restrict__ h1, const float* __restrict__ vec,
              const T* __restrict__ g, float* __restrict__ partial, int R,
              int K1, int C, int rows_per_split) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const ReluBnLoad<T> u{h1, vec, K1};
  const int k0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool sums = blockIdx.y == 0 && ty == 0;

  float acc[4][4] = {};
  float csum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int e = 0; e < (BK * BM) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int rr = idx / BM, kk = idx % BM;
      const int row = r0 + rr, kc = k0 + kk;
      As[rr][kk] = (row < r_end && kc < K1) ? u(row, kc) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / kThreads; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int rr = idx / BN, c = idx % BN;
      const int row = r0 + rr, col = col0 + c;
      Bs[rr][c] = (row < r_end && col < C)
                      ? to_f32(g[static_cast<size_t>(row) * C + col]) : 0.f;
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

inline cudaError_t reduce_partials(const float* partial, float* out, int P,
                                   int total, cudaStream_t stream) {
  partial_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, out, P, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h1(const void* x, const float* msg, const float* w1,
                      const float* b1, const uint8_t* rowmask, void* h1,
                      float* partial, float* sums, int D, int R,
                      cudaStream_t stream) {
  const int C = 2 * D;
  dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  tl_h1_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), msg, w1, b1, rowmask, static_cast<T*>(h1), partial, D, R, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, sums, static_cast<int>(grid.y), 2 * C, stream);
}

template <typename T>
cudaError_t launch_fwd2(const void* x, const void* h1, const float* a,
                        const float* c, const float* w2, const float* b2,
                        void* y, int R, int K, int C, cudaStream_t stream) {
  dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  tl_fwd2_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(h1), a, c, w2, b2, static_cast<T*>(y), R, K, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_sums(const void* g, const void* h1, const float* w2,
                            const float* vec4, float* partial, float* sums,
                            int D, int R, cudaStream_t stream) {
  const int C2 = 2 * D;
  dim3 grid((C2 + BN - 1) / BN, (R + BM - 1) / BM);
  tl_dh2_kernel<T, true><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(h1), w2, vec4, nullptr, partial, D, R, C2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, sums, static_cast<int>(grid.y), 4 * C2, stream);
}

template <typename T>
cudaError_t launch_dh1(const void* g, const void* h1, const float* w2,
                       const float* vec6, const uint8_t* rowmask, float* dh1,
                       int D, int R, cudaStream_t stream) {
  const int C2 = 2 * D;
  dim3 grid((C2 + BN - 1) / BN, (R + BM - 1) / BM);
  tl_dh2_kernel<T, false><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(g), static_cast<const T*>(h1), w2, vec6, rowmask, dh1, D, R, C2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw2(const void* h1, const float* vec4, const void* g,
                       float* partial, float* out, int R, int D,
                       int rows_per_split, int splits, cudaStream_t stream) {
  const int K1 = 2 * D, C = D;
  dim3 grid((C + BN - 1) / BN, (K1 + BM - 1) / BM, splits);
  tl_dw2_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(h1), vec4, static_cast<const T*>(g), partial, R, K1, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, out, splits, (K1 + 1) * C, stream);
}

}  // namespace
}  // namespace mdgat

// All entries: x, h1, g, y are [R, .] of the io dtype (0 f32, 1 bf16);
// weights, vectors, msg, dh1, partials and sums are f32; rowmask is uint8
// [R] or null (every row valid). D is the layer width, the hidden width is
// 2 D.

// h1 [R, 2D] = cat(x [R, D], msg [R, D]) @ w1 [2D, 2D] + b1, and
// sums [2][2D] = masked column sums of the f32 h1 and of its square.
// partial is scratch of ceil(R / 64) * 2 * 2D floats.
extern "C" cudaError_t mdgat_tl_h1(const void* x, const void* msg,
                                   const void* w1, const void* b1,
                                   const void* rowmask, void* h1,
                                   void* partial, void* sums, int D, int R,
                                   int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0) return cudaErrorInvalidValue;
  const auto* m = static_cast<const float*>(msg);
  const auto* w = static_cast<const float*>(w1);
  const auto* b = static_cast<const float*>(b1);
  const auto* rm = static_cast<const uint8_t*>(rowmask);
  auto* p = static_cast<float*>(partial);
  auto* s = static_cast<float*>(sums);
  if (io_dtype == kF32)
    return launch_h1<float>(x, m, w, b, rm, h1, p, s, D, R, stream);
  if (io_dtype == kBF16)
    return launch_h1<__nv_bfloat16>(x, m, w, b, rm, h1, p, s, D, R, stream);
  return cudaErrorInvalidValue;
}

// y [R, D] = x + relu(h1 [R, 2D] * a + c) @ w2 [2D, D] + b2.
extern "C" cudaError_t mdgat_tl_fwd2(const void* x, const void* h1,
                                     const void* a, const void* c,
                                     const void* w2, const void* b2, void* y,
                                     int D, int R, int io_dtype,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0) return cudaErrorInvalidValue;
  const auto* af = static_cast<const float*>(a);
  const auto* cf = static_cast<const float*>(c);
  const auto* w = static_cast<const float*>(w2);
  const auto* b = static_cast<const float*>(b2);
  if (io_dtype == kF32)
    return launch_fwd2<float>(x, h1, af, cf, w, b, y, R, 2 * D, D, stream);
  if (io_dtype == kBF16)
    return launch_fwd2<__nv_bfloat16>(x, h1, af, cf, w, b, y, R, 2 * D, D, stream);
  return cudaErrorInvalidValue;
}

// sums [4][2D] = (Sg, Sgh, dscale, dbias) over all R rows, from g [R, D],
// h1 [R, 2D], w2 [2D, D] and vec4 [4][2D] (mean, inv, scale, bias).
// partial is scratch of ceil(R / 64) * 4 * 2D floats.
extern "C" cudaError_t mdgat_tl_bwd_sums(const void* g, const void* h1,
                                         const void* w2, const void* vec4,
                                         void* partial, void* sums, int D,
                                         int R, int io_dtype,
                                         cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0) return cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(w2);
  const auto* v = static_cast<const float*>(vec4);
  auto* p = static_cast<float*>(partial);
  auto* s = static_cast<float*>(sums);
  if (io_dtype == kF32)
    return launch_bwd_sums<float>(g, h1, w, v, p, s, D, R, stream);
  if (io_dtype == kBF16)
    return launch_bwd_sums<__nv_bfloat16>(g, h1, w, v, p, s, D, R, stream);
  return cudaErrorInvalidValue;
}

// out [2D + 1][D]: rows < 2D are dw2 = relu(bn(h1))^T g, row 2D is db2 =
// column sums of g. partial is scratch of splits * (2D + 1) * D floats;
// split z covers rows [z * rows_per_split, (z + 1) * rows_per_split).
extern "C" cudaError_t mdgat_tl_dw2(const void* h1, const void* vec4,
                                    const void* g, void* partial, void* out,
                                    int D, int R, int rows_per_split,
                                    int splits, int io_dtype,
                                    cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || rows_per_split <= 0 || splits <= 0 ||
      static_cast<long long>(rows_per_split) * splits < R)
    return cudaErrorInvalidValue;
  const auto* v = static_cast<const float*>(vec4);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  if (io_dtype == kF32)
    return launch_dw2<float>(h1, v, g, p, o, R, D, rows_per_split, splits, stream);
  if (io_dtype == kBF16)
    return launch_dw2<__nv_bfloat16>(h1, v, g, p, o, R, D, rows_per_split, splits, stream);
  return cudaErrorInvalidValue;
}

// dh1 [R, 2D] f32 from g, h1, w2, vec6 [6][2D] (mean, inv, scale, bias,
// Sg / cnt, Sgh / cnt) and the row mask.
extern "C" cudaError_t mdgat_tl_dh1(const void* g, const void* h1,
                                    const void* w2, const void* vec6,
                                    const void* rowmask, void* dh1, int D,
                                    int R, int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0) return cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(w2);
  const auto* v = static_cast<const float*>(vec6);
  const auto* rm = static_cast<const uint8_t*>(rowmask);
  auto* o = static_cast<float*>(dh1);
  if (io_dtype == kF32)
    return launch_dh1<float>(g, h1, w, v, rm, o, D, R, stream);
  if (io_dtype == kBF16)
    return launch_dh1<__nv_bfloat16>(g, h1, w, v, rm, o, D, R, stream);
  return cudaErrorInvalidValue;
}
