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
// * rows kernel (p, o, delta, ds, dq), the design of the forward's kernel
//   (csrc/attention.cu, phases A and C): a block of 256 threads serves
//   8 * TR query rows of one (batch, head); Q and dO are staged by 16-byte
//   cp.async, and K and V stream through one 256-key tile buffer, four
//   passes: (1) K: the scores as a register tile (TR rows x 8 keys a
//   thread, both operands read as 16-byte vectors along d), p = exp(s -
//   lse) on kept entries into a [rows][M + 8] slab; (2) V: o = P V, a
//   thread owning TR rows x 4 dims over one of 32 / (Dh / 4) key groups,
//   the groups added in a fixed order, then delta = do . o per row (equal
//   to rowsum(dp * p), since p sums to one over the kept entries or is all
//   zero); (3) V again: dP = dO V^T as a register tile, ds = p * (dp -
//   delta) in place of p; (4) K again: dq = dS K as in (2). One slab and a
//   second V pass, not a dP slab beside the p slab: at 32 rows and 512 keys
//   one slab leaves two blocks an SM (about 110 KB each at Dh 32), two
//   would leave one. Keys at or past the batch entry's last valid key are
//   not visited (they keep nothing). o and dq go out as [B, N, D] with
//   head-blocked columns, ready for the GEMMs; delta [B, H, N] for the keys
//   kernel.
// * keys kernel: a block owns 64 keys of one (batch, head), one warp 8 of
//   them, and walks the query rows in chunks of 128 staged in shared
//   memory (q, do, thr, lse, delta). For 32 queries at a time a lane
//   rebuilds p and ds of its (query, key) pair, the warp swaps them
//   through shared memory, and each lane then owns one output dim of
//   dv_j += p_i do_i and dk_j += ds_i q_i. dk and dv go out as [B, M, D].
//
// keep must not flip between the forward and these two kernels: the keys
// kernel forms s with score_dot (common.cuh), the rows kernel's register
// tile and the forward's keep score_dot's fmaf chain per element (d
// ascending from 0), and all three read q and k from the same GEMM kernel,
// whose outputs do not depend on its tile.
//
// What bounds them on the H100: the f32 FMA pipe, fed from shared memory.
// The rows kernel runs four [N, M, Dh] products a block (scores, o, dP, dq)
// at 10.7 FMAs a 16-byte shared load in the register tiles and 8 in the
// slab products (TR = 4); between tiles a block waits for its next tile,
// which the other block of the SM covers. The keys kernel still takes one
// shared read or two per FMA (five products with the rows kernel's delta);
// the register-tiled design is the next step there.

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

// Copies keys [t * kKT, t * kKT + nk4) of a [M][DH] tensor into the tile
// buffer [kKT][DH + 4] by 16-byte cp.async, zero-filling keys >= nvalid.
template <int DH>
__device__ __forceinline__ void load_key_tile(float* dst, const float* src, int t,
                                              int nk4, int nvalid) {
  constexpr int DG = DH / 4, LD = DH + 4;
  for (int i = threadIdx.x; i < nk4 * DG; i += blockDim.x) {
    const int j = i / DG, d4 = (i % DG) * 4, key = t * kKT + j;
    const bool ok = key < nvalid;
    cp_async16(dst + j * LD + d4,
               ok ? src + static_cast<size_t>(key) * DH + d4 : src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// A block of 256 threads serves BR = 8 * TR query rows of one (batch, head).
// Keys at or past the batch entry's last valid key are skipped: they keep
// nothing, so they add exact zeros to every sum.
template <int DH, int TR>
__global__ void __launch_bounds__(kWarps * 32, 2)
mha_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ thr, const float* __restrict__ lse,
                    float* __restrict__ o_full, float* __restrict__ dq_full,
                    float* __restrict__ delta, int H, int N, int M) {
  constexpr int BR = 8 * TR, LD = DH + 4, DG = DH / 4;
  constexpr int KS = 32 / DG;           // key groups of the P V / dS K layout
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_thr[BR], row_lse[BR], row_delta[BR];
  __shared__ int warp_last[kWarps];
  const int LDS = slab_stride(M);
  float* S = smem;                      // [BR][LDS]: p, then ds
  float* KV = S + BR * LDS;             // [kKT][LD] K or V tile; partial sums
  float* Qs = KV + tile_floats(DH, BR);   // [BR][LD]
  float* Ds = Qs + BR * LD;             // [BR][LD] dO

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int D = H * DH;
  const int row0 = blockIdx.x * BR;
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;
  const float* kb = k + static_cast<size_t>(bh) * M * DH;
  const float* vb = v + static_cast<size_t>(bh) * M * DH;

  // Q and dO rows (zeros past N), the rows' thr and lse (rows past N keep
  // nothing), the batch entry's last valid key
  for (int i = tid; i < BR * DG; i += kWarps * 32) {
    const int r = i / DG, d4 = (i % DG) * 4, n = row0 + r;
    const bool ok = n < N;
    const size_t at = (static_cast<size_t>(bh) * N + (ok ? n : 0)) * DH + d4;
    cp_async16(Qs + r * LD + d4, q + at, ok ? 16 : 0);
    cp_async16(Ds + r * LD + d4, dout + at, ok ? 16 : 0);
  }
  cp_async_commit();
  if (tid < BR) {
    const int n = row0 + tid;
    const size_t row = static_cast<size_t>(bh) * N + n;
    row_thr[tid] = n < N ? thr[row] : CUDART_INF_F;
    row_lse[tid] = n < N ? lse[row] : 0.f;
  }
  int last = 0;
  for (int j = tid; j < M; j += kWarps * 32)
    if (mb[j] != 0) last = j + 1;
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  int Me = 0;                           // keys that matter: [0, Me)
#pragma unroll
  for (int w = 0; w < kWarps; ++w) Me = max(Me, warp_last[w]);
  const int Me4 = (Me + 3) / 4 * 4;     // what the float4 slab reads cover
  const int tiles = (Me + kKT - 1) / kKT;
  auto tile_keys = [&](int t) { return min(kKT, Me4 - t * kKT); };

  // ---- phase 1: scores as a register tile; p into the slab --------------
  // A thread owns rows wm*4*TR + i*4 + tm and keys wn*64 + j*8 + tn of a
  // 256-key tile (a warp 4 x 8 threads) and reads both operands as 16-byte
  // vectors along d: each score is ONE fmaf chain over d ascending from 0,
  // the chain of score_dot and of the forward's register tile, so s >= thr
  // keeps exactly the forward's entries.
  const int tm = lane >> 3, tn = lane & 7, wm = warp >> 2, wn = warp & 3;
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) __syncthreads();         // the tile before is read
    load_key_tile<DH>(KV, kb, t, tile_keys(t), Me);
    cp_async_wait<0>();
    __syncthreads();
    const int key0 = t * kKT + wn * 64;
    if (key0 >= Me) continue;           // warp-uniform
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
      for (int dd = 0; dd < 4; ++dd)    // d ascending: the chain of score_dot
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(qa[i][dd], ka[j][dd], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = key0 + j * 8 + tn;
      if (col >= Me4) continue;
      const bool valid = col < Me && mb[col] != 0;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = wm * 4 * TR + i * 4 + tm;
        const bool keep = valid && acc[i][j] >= row_thr[r];
        S[r * LDS + col] = expf(keep ? acc[i][j] - row_lse[r] : kBigNeg);
      }
    }
  }

  cp_async_wait<0>();                   // Q and dO, also where no key is valid

  // Products over the slab, the forward's phase C: a thread owns TR rows x 4
  // dims over one of KS key groups, so one 16-byte read of a K / V row feeds
  // TR rows; the groups' partial sums are added in a fixed order.
  const int dg = tid % DG, rg = (tid / DG) % 8, ks = tid / (8 * DG);
  auto slab_product = [&](const float* base, float (&acc)[TR][4]) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      __syncthreads();                  // the tile buffer is free
      load_key_tile<DH>(KV, base, t, tile_keys(t), Me);
      cp_async_wait<0>();
      __syncthreads();
      const int nkeys = tile_keys(t);
      for (int j0 = ks * 4; j0 < nkeys; j0 += KS * 4) {
        float e[TR][4];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          *reinterpret_cast<float4*>(e[i]) = *reinterpret_cast<const float4*>(
              S + (i * 8 + rg) * LDS + t * kKT + j0);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kv =
              *reinterpret_cast<const float4*>(KV + (j0 + jj) * LD + dg * 4);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            acc[i][0] = fmaf(e[i][jj], kv.x, acc[i][0]);
            acc[i][1] = fmaf(e[i][jj], kv.y, acc[i][1]);
            acc[i][2] = fmaf(e[i][jj], kv.z, acc[i][2]);
            acc[i][3] = fmaf(e[i][jj], kv.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();                    // the tile is read: partials over it
    float* part = KV;                   // [KS][BR][DH]
#pragma unroll
    for (int i = 0; i < TR; ++i)
      store4(part + (ks * BR + i * 8 + rg) * DH + dg * 4,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    __syncthreads();
  };
  // the sum of the key groups' partials at (row r, dims d4..d4+3)
  auto partial_sum = [&](int r, int d4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < KS; ++z) {      // key groups in a fixed order
      const float4 p = load4(KV + (z * BR + r) * DH + d4);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    return s;
  };
  auto out_at = [&](float* base, int n, int d4) {
    return base + (static_cast<size_t>(b) * N + n) * D + h * DH + d4;
  };

  // ---- phase 2: o = P V over the V tiles; delta = do . o per row ---------
  {
    float acc[TR][4];
    slab_product(vb, acc);
    // BR * DG (row, 4 dims) items; the DG threads of a row are DG
    // consecutive lanes, so the row's dot product closes by shuffles
    for (int i0 = 0; i0 < BR * DG; i0 += kWarps * 32) {
      const int i = i0 + tid, r = i / DG, d4 = (i % DG) * 4, n = row0 + r;
      float dot = 0.f;
      if (i < BR * DG) {
        const float4 o4 = partial_sum(r, d4);
        const float4 do4 = load4(Ds + r * LD + d4);
        dot = fmaf(do4.w, o4.w, fmaf(do4.z, o4.z, fmaf(do4.y, o4.y, do4.x * o4.x)));
        if (n < N) store4(out_at(o_full, n, d4), o4);
      }
#pragma unroll
      for (int off = DG / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (i < BR * DG && i % DG == 0) {
        row_delta[r] = dot;
        if (n < N) delta[static_cast<size_t>(bh) * N + n] = dot;
      }
    }
  }

  // ---- phase 3: dP = dO V^T as a register tile; ds = p (dp - delta) -------
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();                    // partials / the tile before are read
    load_key_tile<DH>(KV, vb, t, tile_keys(t), Me);
    cp_async_wait<0>();
    __syncthreads();
    const int key0 = t * kKT + wn * 64;
    if (key0 >= Me) continue;           // warp-uniform
    float acc[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const float* dp_ = Ds + (wm * 4 * TR + tm) * LD;
    const float* vp = KV + (wn * 64 + tn) * LD;
#pragma unroll
    for (int d4 = 0; d4 < DH; d4 += 4) {
      float da[TR][4], va[8][4];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        *reinterpret_cast<float4*>(da[i]) =
            *reinterpret_cast<const float4*>(dp_ + i * 4 * LD + d4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(va[j]) =
            *reinterpret_cast<const float4*>(vp + j * 8 * LD + d4);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(da[i][dd], va[j][dd], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = key0 + j * 8 + tn;
      if (col >= Me4) continue;
#pragma unroll
      for (int i = 0; i < TR; ++i) {    // the entry this thread wrote in phase 1
        const int r = wm * 4 * TR + i * 4 + tm;
        float* sp = S + r * LDS + col;
        *sp = *sp * (acc[i][j] - row_delta[r]);
      }
    }
  }

  // ---- phase 4: dq = dS K over the K tiles --------------------------------
  {
    float acc[TR][4];
    slab_product(kb, acc);
    for (int i = tid; i < BR * DG; i += kWarps * 32) {
      const int r = i / DG, d4 = (i % DG) * 4, n = row0 + r;
      if (n < N) store4(out_at(dq_full, n, d4), partial_sum(r, d4));
    }
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

template <int DH, int TR>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* delta, int B, int H, int N, int M,
                        cudaStream_t stream) {
  constexpr int BR = 8 * TR;
  const size_t smem = sizeof(float) * (static_cast<size_t>(BR) * slab_stride(M) +
                                       tile_floats(DH, BR) + 2 * BR * (DH + 4));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = mha_bwd_rows_kernel<DH, TR>;
  static SmemCap cap;
  cudaError_t err = allow_smem(kernel, smem, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BR - 1) / BR, B * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, k, v, dout, mask, thr, lse,
                                              o_full, dq_full, delta, H, N, M);
  return cudaGetLastError();
}

// The launch owns the plan: 32 query rows a block up to 512 keys (two blocks
// an SM at Dh 32), 16 above, so that the slab leaves room for the tile.
template <int DH>
cudaError_t launch_both(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* dk_full, float* dv_full, float* delta, int B,
                        int H, int N, int M, cudaStream_t stream) {
  cudaError_t err;
  if (M <= 512)
    err = launch_rows<DH, 4>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, B, H, N, M, stream);
  else if (M <= 1024)
    err = launch_rows<DH, 2>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, B, H, N, M, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;

  const size_t smem = (static_cast<size_t>(2 * kQueryChunk + 2 * kKeysPerBlock) *
                           (DH + 1) + 3 * kQueryChunk + 2 * kWarps * 32) *
                      sizeof(float);
  auto kernel = mha_bwd_keys_kernel<DH>;
  static SmemCap cap;
  err = allow_smem(kernel, smem, cap);
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
  // the rows kernel stages q, dout, k, v by 16-byte copies
  if (!aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(dout, 16) || !aligned_to(o_full, 16) || !aligned_to(dq_full, 16))
    return cudaErrorInvalidValue;
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
