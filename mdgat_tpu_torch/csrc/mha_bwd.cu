// Attention core of the fused-MHA backward, selection frozen at the
// forward's per-row threshold.
//
// Replaces the [N, M] work of the TPU kernel
// mdgat_tpu/ops/pallas/attention.py::_mha_bwd_kernel / _mha_bwd_block
// (reached from _mha_bwd_call): with s = q . k (the 1/sqrt(Dh) scale is
// folded into wq), keep = mask & (s >= thr) and p = exp(s - lse) on kept
// entries, it forms
//   o  = p v            (the merge-weight gradient's operand)
//   dp = do v^T,  ds = p * (dp - rowsum(dp * p))
//   dq = ds k,  dk = ds^T q,  dv = p^T do.
// The projections before it and the weight gradients after it run on
// csrc/gemm.cu (ops/cuda/mha.py strings the launches together).
//
// Design. The TPU kernel holds a pair's [N, M] slabs in VMEM and reduces
// over either axis at will. Here p is rebuilt twice, from thr and lse, by
// two kernels that need no atomics and give the same bits on every run:
//
// * rows kernel: one warp per query row, the block laid out as the forward
//   kernel (csrc/attention.cu): K staged in shared memory, the row's
//   scores in registers, p written to a per-row shared buffer; then V
//   staged over K for o = p v, delta = do . o (equal to rowsum(dp * p),
//   since p sums to one over the kept entries or is all zero) and
//   ds = p * (do . v_j - delta), which overwrites p; then K staged again
//   for dq = ds k. o and dq go out as [B, N, D] with head-blocked columns,
//   ready for the GEMMs.
// * keys kernel: a block owns 64 keys of one (batch, head), one warp 8 of
//   them, and walks the query rows in chunks of 128 staged in shared
//   memory (q, do, thr, lse, delta). For 32 queries at a time a lane
//   rebuilds p and ds of its (query, key) pair, the warp swaps them
//   through shared memory, and each lane then owns one output dim of
//   dv_j += p_i do_i and dk_j += ds_i q_i. dk and dv go out as [B, M, D].
//
// keep must not flip between the forward and these two kernels: all three
// form s with score_dot (common.cuh) on q and k from the same GEMM kernel.
//
// What bounds it on the H100: shared-memory bandwidth, as in the forward
// kernel (one shared read or two per FMA); five [N, M, Dh] products run
// where the forward has two. mma tiles are later work.

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kWarps = 8;
constexpr int kKeysPerBlock = 64;   // keys kernel: keys per block
constexpr int kKeysPerWarp = kKeysPerBlock / kWarps;
constexpr int kQueryChunk = 128;    // keys kernel: query rows staged at once

// Copies `rows` rows of Dh floats into a tile padded to Dh + 1 (lane j
// reads row j, so the stride keeps 32 lanes on 32 banks) and zero-fills
// the tile up to `fill` rows.
template <int DH>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src,
                                           int rows, int fill) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < fill * DH; i += blockDim.x)
    dst[(i / DH) * LD + (i % DH)] = i < rows * DH ? src[i] : 0.f;
}

template <int DH, int C>
__global__ void __launch_bounds__(kWarps * 32)
mha_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ thr, const float* __restrict__ lse,
                    float* __restrict__ o_full, float* __restrict__ dq_full,
                    float* __restrict__ delta, int H, int N, int M, int rpw) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1;
  constexpr int P = (DH + 31) / 32;   // output dims per lane
  float* kv = smem;                   // [M][LD]: K, then V, then K again
  float* pw = smem + M * LD;          // [kWarps * rpw][M]: p, then ds

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int D = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kWarps * rpw;
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;
  const float* kb = k + static_cast<size_t>(bh) * M * DH;
  const float* vb = v + static_cast<size_t>(bh) * M * DH;

  stage_tile<DH>(kv, kb, M, M);
  __syncthreads();
  for (int t = 0; t < rpw; ++t) {
    const int slot = warp * rpw + t;
    const int n = row0 + slot;
    if (n >= N) break;
    const size_t row = static_cast<size_t>(bh) * N + n;
    const float* qrow = q + row * DH;
    float qr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = qrow[d];
    const float row_thr = thr[row], row_lse = lse[row];
    float* prow = pw + slot * M;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      if (j < M) {
        const float s = score_dot<DH>(qr, kv + j * LD);
        const bool keep = mb[j] != 0 && s >= row_thr;
        prow[j] = expf(keep ? s - row_lse : kBigNeg);
      }
    }
  }
  __syncthreads();

  stage_tile<DH>(kv, vb, M, M);
  __syncthreads();
  for (int t = 0; t < rpw; ++t) {
    const int slot = warp * rpw + t;
    const int n = row0 + slot;
    if (n >= N) break;
    const size_t row = static_cast<size_t>(bh) * N + n;
    const float* dorow = dout + row * DH;
    float* prow = pw + slot * M;
    float dor[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dor[d] = dorow[d];
    // o = p v, one output dim (or P of them) per lane
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int j = 0; j < M; ++j) {
      const float pj = prow[j];
      const float* vr = kv + j * LD;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (lane + 32 * p < DH) acc[p] = fmaf(pj, vr[lane + 32 * p], acc[p]);
    }
    float dl = 0.f;
    float* orow = o_full + (static_cast<size_t>(b) * N + n) * D + h * DH;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int d = lane + 32 * p;
      if (d < DH) {
        orow[d] = acc[p];
        dl = fmaf(dorow[d], acc[p], dl);
      }
    }
    dl = warp_sum(dl);
    if (lane == 0) delta[row] = dl;
    __syncwarp();                   // every lane has read p before ds lands
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      if (j < M) prow[j] = prow[j] * (score_dot<DH>(dor, kv + j * LD) - dl);
    }
  }
  __syncthreads();

  stage_tile<DH>(kv, kb, M, M);
  __syncthreads();
  for (int t = 0; t < rpw; ++t) {
    const int slot = warp * rpw + t;
    const int n = row0 + slot;
    if (n >= N) break;
    const float* dsrow = pw + slot * M;
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    for (int j = 0; j < M; ++j) {
      const float dsj = dsrow[j];
      const float* kr = kv + j * LD;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (lane + 32 * p < DH) acc[p] = fmaf(dsj, kr[lane + 32 * p], acc[p]);
    }
    float* dqrow = dq_full + (static_cast<size_t>(b) * N + n) * D + h * DH;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (lane + 32 * p < DH) dqrow[lane + 32 * p] = acc[p];
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
mha_bwd_keys_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ thr, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk_full,
                    float* __restrict__ dv_full, int H, int N, int M) {
  constexpr int LD = DH + 1;
  constexpr int P = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* qs = smem;                          // [kQueryChunk][LD]
  float* dos = qs + kQueryChunk * LD;        // [kQueryChunk][LD]
  float* ks = dos + kQueryChunk * LD;        // [kKeysPerBlock][LD]
  float* vs = ks + kKeysPerBlock * LD;       // [kKeysPerBlock][LD]
  float* thr_s = vs + kKeysPerBlock * LD;    // [kQueryChunk]
  float* lse_s = thr_s + kQueryChunk;
  float* del_s = lse_s + kQueryChunk;
  float* pbuf = del_s + kQueryChunk;         // [kWarps][32]
  float* dsbuf = pbuf + kWarps * 32;         // [kWarps][32]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int D = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = blockIdx.x * kKeysPerBlock;
  const int nkeys = min(kKeysPerBlock, M - key0);
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;

  stage_tile<DH>(ks, k + (static_cast<size_t>(bh) * M + key0) * DH, nkeys, nkeys);
  stage_tile<DH>(vs, v + (static_cast<size_t>(bh) * M + key0) * DH, nkeys, nkeys);

  float dk[kKeysPerWarp][P], dv[kKeysPerWarp][P];
#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t)
#pragma unroll
    for (int p = 0; p < P; ++p) dk[t][p] = dv[t][p] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kQueryChunk) {
    const int nq = min(kQueryChunk, N - q0);
    __syncthreads();                // the previous chunk is no longer read
    stage_tile<DH>(qs, q + (static_cast<size_t>(bh) * N + q0) * DH, nq,
                   kQueryChunk);
    stage_tile<DH>(dos, dout + (static_cast<size_t>(bh) * N + q0) * DH, nq,
                   kQueryChunk);
    for (int i = threadIdx.x; i < kQueryChunk; i += blockDim.x) {
      const bool in = i < nq;
      const size_t row = static_cast<size_t>(bh) * N + q0 + i;
      thr_s[i] = in ? thr[row] : CUDART_INF_F;   // rows past N keep nothing
      lse_s[i] = in ? lse[row] : 0.f;
      del_s[i] = in ? delta[row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kKeysPerWarp; ++t) {
      const int jl = warp * kKeysPerWarp + t;
      if (jl >= nkeys || mb[key0 + jl] == 0) continue;   // warp-uniform
      const float* kr = ks + jl * LD;
      const float* vr = vs + jl * LD;
      for (int i0 = 0; i0 < nq; i0 += 32) {
        const int i = i0 + lane;    // rows in [nq, chunk) hold zeros and
        const float* qr = qs + i * LD;   // thr = +inf: p = ds = 0
        const float* dr = dos + i * LD;
        const float s = score_dot<DH>(qr, kr);
        const bool keep = s >= thr_s[i];
        const float p = expf(keep ? s - lse_s[i] : kBigNeg);
        const float ds = p * (score_dot<DH>(dr, vr) - del_s[i]);
        pbuf[warp * 32 + lane] = p;
        dsbuf[warp * 32 + lane] = ds;
        __syncwarp();
        for (int ii = 0; ii < 32; ++ii) {
          const float pi = pbuf[warp * 32 + ii], dsi = dsbuf[warp * 32 + ii];
          const float* dor = dos + (i0 + ii) * LD;
          const float* qor = qs + (i0 + ii) * LD;
#pragma unroll
          for (int pp = 0; pp < P; ++pp) {
            const int d = lane + 32 * pp;
            if (d < DH) {
              dv[t][pp] = fmaf(pi, dor[d], dv[t][pp]);
              dk[t][pp] = fmaf(dsi, qor[d], dk[t][pp]);
            }
          }
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kKeysPerWarp; ++t) {
    const int jl = warp * kKeysPerWarp + t;
    if (jl >= nkeys) continue;
    const size_t base = (static_cast<size_t>(b) * M + key0 + jl) * D + h * DH;
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      const int d = lane + 32 * pp;
      if (d < DH) {
        dk_full[base + d] = dk[t][pp];
        dv_full[base + d] = dv[t][pp];
      }
    }
  }
}

template <int DH, int C>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* delta, int B, int H, int N, int M,
                        cudaStream_t stream) {
  const int rpw = M <= 256 ? 4 : 2;  // as the forward: two blocks an SM above 256
  const size_t smem = (static_cast<size_t>(M) * (DH + 1) +
                       static_cast<size_t>(kWarps) * rpw * M) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = mha_bwd_rows_kernel<DH, C>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * rpw;
  dim3 grid((N + rows_per_block - 1) / rows_per_block, B * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, k, v, dout, mask, thr, lse,
                                              o_full, dq_full, delta, H, N, M,
                                              rpw);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_both(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* dk_full, float* dv_full, float* delta, int B,
                        int H, int N, int M, cudaStream_t stream) {
  cudaError_t err;
  if (M <= 256)
    err = launch_rows<DH, 8>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, B, H, N, M, stream);
  else if (M <= 512)
    err = launch_rows<DH, 16>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                              delta, B, H, N, M, stream);
  else if (M <= 1024)
    err = launch_rows<DH, 32>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                              delta, B, H, N, M, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;

  const size_t smem = (static_cast<size_t>(2 * kQueryChunk + 2 * kKeysPerBlock) *
                           (DH + 1) + 3 * kQueryChunk + 2 * kWarps * 32) *
                      sizeof(float);
  auto kernel = mha_bwd_keys_kernel<DH>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kKeysPerBlock - 1) / kKeysPerBlock, B * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, k, v, dout, mask, thr, lse,
                                              delta, dk_full, dv_full, H, N, M);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mdgat

// q, dout [B,H,N,Dh], k, v [B,H,M,Dh], thr, lse [B,H,N], all f32 and
// contiguous; mask [B,M] uint8. Outputs, f32: o_full, dq_full [B,N,H*Dh] and
// dk_full, dv_full [B,M,H*Dh] with head-blocked columns h*Dh + d; delta
// [B,H,N] is scratch (do . o per row). Two launches: rows, then keys.
extern "C" cudaError_t mdgat_mha_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* thr, const void* lse, void* o_full,
    void* dq_full, void* dk_full, void* dv_full, void* delta, int B, int H,
    int N, int M, int Dh, cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  const auto* m = static_cast<const uint8_t*>(mask);
#define MDGAT_BWD(DH)                                                        \
  return launch_both<DH>(f(q), f(k), f(v), f(dout), m, f(thr), f(lse),       \
                         g(o_full), g(dq_full), g(dk_full), g(dv_full),      \
                         g(delta), B, H, N, M, stream)
  switch (Dh) {
    case 8: MDGAT_BWD(8);
    case 16: MDGAT_BWD(16);
    case 32: MDGAT_BWD(32);
    case 64: MDGAT_BWD(64);
    default: return cudaErrorInvalidValue;
  }
#undef MDGAT_BWD
}
