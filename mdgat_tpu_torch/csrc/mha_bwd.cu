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
// * keys kernel (dk, dv), the rows kernel's design turned around: a block
//   of 256 threads owns a tile of KT keys of one (batch, head), whose K and
//   V rows it stages once by 16-byte cp.async; the query rows stream
//   through in tiles of RT rows (Q, dO, thr, lse, delta) on a two-stage
//   cp.async ring, so the next tile's loads overlap this tile's products.
//   Per row tile: (1) S^T = K Q^T and (2) dP^T = V dO^T as register tiles
//   (4 keys x TQ rows a thread, both operands 16-byte vectors along d), p
//   and ds = p (dp - delta) into two [KT][RT + 8] slabs; (3) dv += P dO and
//   dk += dS Q as one slab product, a thread owning 4 keys x 4 dims of both
//   over one of RS row groups, its 32 accumulators in registers across all
//   row tiles. Row tiles are added in ascending order and row groups in a
//   fixed order at the end. A block whose keys all lie at or past the batch
//   entry's last valid key writes zeros and returns. dk and dv go out as
//   [B, M, D] with head-blocked columns.
//
// keep must not flip between the forward and these two kernels: both
// backward kernels' register tiles and the forward's keep score_dot's fmaf
// chain per element (common.cuh; d ascending from 0), and all three read q
// and k from the same GEMM kernel, whose outputs do not depend on its tile.
//
// What bounds them on the H100: the f32 FMA pipe, fed from shared memory.
// Each kernel runs four [N, M, Dh] products a block: the rows kernel
// scores, o, dP, dq; the keys kernel scores, dP, dv, dk (8.6 GFMA a launch
// at 64 x 4 x 512 x 512 x 32, 0.26 ms at the full pipe). The rows kernel
// feeds 10.7 FMAs a 16-byte shared load in its register tiles and 8 in the
// slab products (TR = 4); the keys kernel 8 in both (4 x 4 tiles). Between
// row tiles a block waits at two barriers, which the other block of the SM
// covers. Both form p densely over the valid keys, so top-k layers cost as
// much as dense ones.

#include "common.cuh"

namespace mdgat {
namespace {

constexpr int kWarps = 8;
constexpr int kKeyTile = 64;    // keys kernel: keys a block at Dh <= 32

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
                    float* __restrict__ delta, float* __restrict__ slab, int H,
                    int N, int M) {
  constexpr int BR = 8 * TR, LD = DH + 4, DG = DH / 4;
  constexpr int KS = 32 / DG;           // key groups of the P V / dS K layout
  constexpr bool kWide = TR == 1;       // the arm above 1024 keys
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_thr[BR], row_lse[BR], row_delta[BR];
  __shared__ int warp_last[kWarps];
  const int LDS = slab_stride(M);
  // [BR][LDS]: p, then ds; in shared memory, or (the wide arm, where it
  // does not fit) this block's part of a global scratch
  float* S = smem;
  if (kWide && slab != nullptr)
    S = slab + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * BR * LDS;
  float* KV = S == smem ? smem + BR * LDS : smem;  // [kKT][LD] K or V tile; partial sums
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

// The keys kernel's tiling. A block of 256 threads owns KT = WK * 4 * TK keys
// of one (batch, head) and streams the query rows in tiles of RT = (8 / WK)
// * 8 * TQ. Per row tile a thread owns TK keys x TQ rows of the score and
// dP register tiles (a warp 4 x 8 threads, WK warps along the keys), and in
// the two slab products 4 keys x 4 dims of dK and dV over one of RS row
// groups of the tile.
template <int DH, int WK, int TK, int TQ>
struct KeysTiling {
  static constexpr int KT = WK * 4 * TK, WQ = kWarps / WK, RT = WQ * 8 * TQ;
  static constexpr int LD = DH + 4;       // K, V, Q, dO tile row stride
  static constexpr int LDP = RT + 8;      // slab stride: 8 mod 32 floats
  static constexpr int DG = DH / 4, KQ = KT / 4;
  static constexpr int RS = kWarps * 32 / (KQ * DG), RG = RT / RS;
  static constexpr int kStages = 2;       // row tiles in flight: this + next
  static constexpr int kStageFloats = 2 * RT * LD + 3 * RT;
  static constexpr size_t kSmemFloats =
      2 * KT * LD + kStages * kStageFloats + 2 * KT * LDP;
  static_assert(kWarps % WK == 0 && RT % 32 == 0, "tile shape");
  static_assert(KQ * DG * RS == kWarps * 32 && RG % 4 == 0, "slab layout");
  // the row groups' partial sums of dk and dv reuse the two slabs
  static_assert(RS == 1 || 2 * KT * LDP >= 2 * RS * KT * DH, "partials");
};

// dk = dS^T Q and dv = P^T dO for a tile of keys, summed over every query
// row. p and ds are rebuilt per (key, row) exactly as the rows kernel does:
// the score as one fmaf chain over d ascending from 0 (score_dot's), keep =
// mask & (s >= thr), p = exp(s - lse), ds = p (do . v - delta). Row tiles
// are added in ascending order, rows ascending within a tile, row groups in
// a fixed order: no atomics, the same bits on every run. A block whose keys
// all lie at or past its batch entry's last valid key writes zeros.
template <int DH, int WK, int TK, int TQ>
__global__ void __launch_bounds__(kWarps * 32, 2)
mha_bwd_keys_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ thr, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk_full,
                    float* __restrict__ dv_full, int H, int N, int M) {
  using T = KeysTiling<DH, WK, TK, TQ>;
  constexpr int KT = T::KT, RT = T::RT, LD = T::LD, LDP = T::LDP, DG = T::DG;
  constexpr int KQ = T::KQ, RG = T::RG;
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_last[kWarps];
  float* Ks = smem;                       // [KT][LD]
  float* Vs = Ks + KT * LD;               // [KT][LD]
  float* ring = Vs + KT * LD;             // kStages x (Q, dO [RT][LD]; thr, lse, delta [RT])
  float* Ps = ring + T::kStages * T::kStageFloats;   // [KT][LDP] p
  float* Ss = Ps + KT * LDP;              // [KT][LDP] ds

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int D = H * DH;
  const int key0 = blockIdx.x * KT;
  const uint8_t* mb = mask + static_cast<size_t>(b) * M;
  auto out_at = [&](float* base, int key, int d4) {
    return base + (static_cast<size_t>(b) * M + key) * D + h * DH + d4;
  };

  // the batch entry's last valid key: a block wholly past it keeps nothing
  int last = 0;
  for (int j = tid; j < M; j += kWarps * 32)
    if (mb[j] != 0) last = j + 1;
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  int Me = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) Me = max(Me, warp_last[w]);
  if (key0 >= Me) {                       // block-uniform
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < KT * DG; i += kWarps * 32) {
      const int key = key0 + i / DG, d4 = (i % DG) * 4;
      if (key < M) {
        store4(out_at(dk_full, key, d4), zero);
        store4(out_at(dv_full, key, d4), zero);
      }
    }
    return;
  }

  // K and V of the block's keys (zeros past M), once
  for (int i = tid; i < KT * DG; i += kWarps * 32) {
    const int j = i / DG, d4 = (i % DG) * 4, key = key0 + j;
    const bool ok = key < M;
    const size_t at = (static_cast<size_t>(bh) * M + (ok ? key : 0)) * DH + d4;
    cp_async16(Ks + j * LD + d4, k + at, ok ? 16 : 0);
    cp_async16(Vs + j * LD + d4, v + at, ok ? 16 : 0);
  }
  cp_async_commit();

  // a row tile into its ring stage: Q and dO rows (zeros past N) by 16-byte
  // copies, thr, lse and delta by 4-byte ones
  const int tiles = (N + RT - 1) / RT;
  auto stage = [&](int s) { return ring + s * T::kStageFloats; };
  auto load_rows = [&](int t) {
    float* st = stage(t % T::kStages);
    const int r0 = t * RT;
    for (int i = tid; i < RT * DG; i += kWarps * 32) {
      const int r = i / DG, d4 = (i % DG) * 4, n = r0 + r;
      const bool ok = n < N;
      const size_t at = (static_cast<size_t>(bh) * N + (ok ? n : 0)) * DH + d4;
      cp_async16(st + r * LD + d4, q + at, ok ? 16 : 0);
      cp_async16(st + (RT + r) * LD + d4, dout + at, ok ? 16 : 0);
    }
    for (int r = tid; r < RT; r += kWarps * 32) {
      const int n = r0 + r;
      const bool ok = n < N;
      const size_t at = static_cast<size_t>(bh) * N + (ok ? n : 0);
      float* vec = st + 2 * RT * LD;
      cp_async4(vec + r, thr + at, ok ? 4 : 0);
      cp_async4(vec + RT + r, lse + at, ok ? 4 : 0);
      cp_async4(vec + 2 * RT + r, delta + at, ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < tiles) load_rows(s);
    cp_async_commit();
  }

  // register tiles: keys wk*4*TK + i*4 + tk, rows wq*8*TQ + j*8 + tq
  const int tk = lane >> 3, tq = lane & 7, wk = warp % WK, wq = warp / WK;
  bool kvalid[TK];
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int key = key0 + wk * 4 * TK + i * 4 + tk;
    kvalid[i] = key < M && mb[key] != 0;
  }
  // slab products: keys kq + i*KQ, dims dq*4..+3, rows of group rs
  const int dq = tid % DG, kq = (tid / DG) % KQ, rs = tid / (DG * KQ);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + T::kStages - 1 < tiles) load_rows(t + T::kStages - 1);
    cp_async_commit();
    cp_async_wait<T::kStages - 1>();      // this tile (and K, V) landed
    __syncthreads();
    const float* Qs = stage(t % T::kStages);
    const float* Ds = Qs + RT * LD;
    const float* thr_s = Ds + RT * LD;
    const float* lse_s = thr_s + RT;
    const float* del_s = lse_s + RT;
    const int rows_left = N - t * RT;

    // S^T = K Q^T, then dP^T = V dO^T, as register tiles; both operands
    // read as 16-byte vectors along d, each entry ONE fmaf chain over d
    // ascending from 0 (score_dot's), so s >= thr keeps the forward's set
    float p[TK][TQ];
    {
      float acc[TK][TQ];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;
      const float* kp = Ks + (wk * 4 * TK + tk) * LD;
      const float* qp = Qs + (wq * 8 * TQ + tq) * LD;
#pragma unroll
      for (int d4 = 0; d4 < DH; d4 += 4) {
        float ka[TK][4], qa[TQ][4];
#pragma unroll
        for (int i = 0; i < TK; ++i)
          *reinterpret_cast<float4*>(ka[i]) = load4(kp + i * 4 * LD + d4);
#pragma unroll
        for (int j = 0; j < TQ; ++j)
          *reinterpret_cast<float4*>(qa[j]) = load4(qp + j * 8 * LD + d4);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int i = 0; i < TK; ++i)
#pragma unroll
            for (int j = 0; j < TQ; ++j)
              acc[i][j] = fmaf(qa[j][dd], ka[i][dd], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int r = wq * 8 * TQ + j * 8 + tq;
        const bool row_ok = r < rows_left;
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          const bool keep = kvalid[i] && row_ok && acc[i][j] >= thr_s[r];
          p[i][j] = expf(keep ? acc[i][j] - lse_s[r] : kBigNeg);
        }
      }
    }
    {
      float acc[TK][TQ];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[i][j] = 0.f;
      const float* vp = Vs + (wk * 4 * TK + tk) * LD;
      const float* dp_ = Ds + (wq * 8 * TQ + tq) * LD;
#pragma unroll
      for (int d4 = 0; d4 < DH; d4 += 4) {
        float va[TK][4], da[TQ][4];
#pragma unroll
        for (int i = 0; i < TK; ++i)
          *reinterpret_cast<float4*>(va[i]) = load4(vp + i * 4 * LD + d4);
#pragma unroll
        for (int j = 0; j < TQ; ++j)
          *reinterpret_cast<float4*>(da[j]) = load4(dp_ + j * 8 * LD + d4);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int i = 0; i < TK; ++i)
#pragma unroll
            for (int j = 0; j < TQ; ++j)
              acc[i][j] = fmaf(da[j][dd], va[i][dd], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const int key = wk * 4 * TK + i * 4 + tk, r = wq * 8 * TQ + j * 8 + tq;
          Ps[key * LDP + r] = p[i][j];
          Ss[key * LDP + r] = p[i][j] * (acc[i][j] - del_s[r]);
        }
    }
    __syncthreads();                      // the slabs are written

    // dv += P dO and dk += dS Q over this thread's row group
    const int rbeg = rs * RG;
#pragma unroll 2
    for (int r = rbeg; r < rbeg + RG; r += 4) {
      float pe[4][4], se[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(pe[i]) = load4(Ps + (kq + i * KQ) * LDP + r);
        *reinterpret_cast<float4*>(se[i]) = load4(Ss + (kq + i * KQ) * LDP + r);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 do4 = load4(Ds + (r + jj) * LD + dq * 4);
        const float4 q4 = load4(Qs + (r + jj) * LD + dq * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][0] = fmaf(pe[i][jj], do4.x, dv[i][0]);
          dv[i][1] = fmaf(pe[i][jj], do4.y, dv[i][1]);
          dv[i][2] = fmaf(pe[i][jj], do4.z, dv[i][2]);
          dv[i][3] = fmaf(pe[i][jj], do4.w, dv[i][3]);
          dk[i][0] = fmaf(se[i][jj], q4.x, dk[i][0]);
          dk[i][1] = fmaf(se[i][jj], q4.y, dk[i][1]);
          dk[i][2] = fmaf(se[i][jj], q4.z, dk[i][2]);
          dk[i][3] = fmaf(se[i][jj], q4.w, dk[i][3]);
        }
      }
    }
    __syncthreads();                      // the stage and the slabs are free
  }

  // row groups 1.. hand their partials to group 0 through the slabs, which
  // adds them in group order
  if constexpr (T::RS > 1) {
    float* part = Ps;                     // [RS - 1][KT][DH] dv, then dk
    constexpr int kPart = (T::RS - 1) * KT * DH;
    if (rs > 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = ((rs - 1) * KT + kq + i * KQ) * DH + dq * 4;
        store4(part + at, make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]));
        store4(part + kPart + at, make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]));
      }
    __syncthreads();
    if (rs == 0)
      for (int z = 1; z < T::RS; ++z)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = ((z - 1) * KT + kq + i * KQ) * DH + dq * 4;
          const float4 a = load4(part + at), c = load4(part + kPart + at);
          dv[i][0] += a.x; dv[i][1] += a.y; dv[i][2] += a.z; dv[i][3] += a.w;
          dk[i][0] += c.x; dk[i][1] += c.y; dk[i][2] += c.z; dk[i][3] += c.w;
        }
  }
  if (rs == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + kq + i * KQ;
      if (key < M) {
        store4(out_at(dv_full, key, dq * 4),
               make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]));
        store4(out_at(dk_full, key, dq * 4),
               make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]));
      }
    }
}

template <int DH, int TR>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* delta, float* slab, long long slab_floats, int B,
                        int H, int N, int M, cudaStream_t stream) {
  constexpr int BR = 8 * TR;
  const size_t rest = tile_floats(DH, BR) + 2 * BR * (DH + 4);
  const size_t slab_smem = static_cast<size_t>(BR) * slab_stride(M);
  dim3 grid((N + BR - 1) / BR, B * H);
  size_t smem = sizeof(float) * (slab_smem + rest);
  if (TR > 1 || smem <= kMaxSmem) {
    slab = nullptr;
  } else {  // the wide arm's slab goes to the wrapper's scratch
    smem = sizeof(float) * rest;
    if (slab == nullptr ||
        slab_floats < static_cast<long long>(grid.x) * grid.y * slab_smem)
      return cudaErrorInvalidValue;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = mha_bwd_rows_kernel<DH, TR>;
  static SmemCap cap;
  cudaError_t err = allow_smem(kernel, smem, cap);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, k, v, dout, mask, thr, lse,
                                              o_full, dq_full, delta, slab, H,
                                              N, M);
  return cudaGetLastError();
}

template <int DH, int WK, int TK, int TQ>
cudaError_t launch_keys(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, const float* delta, float* dk_full,
                        float* dv_full, int B, int H, int N, int M,
                        cudaStream_t stream) {
  using T = KeysTiling<DH, WK, TK, TQ>;
  const size_t smem = sizeof(float) * T::kSmemFloats;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = mha_bwd_keys_kernel<DH, WK, TK, TQ>;
  static SmemCap cap;
  cudaError_t err = allow_smem(kernel, smem, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((M + T::KT - 1) / T::KT, B * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(q, k, v, dout, mask, thr, lse,
                                              delta, dk_full, dv_full, H, N, M);
  return cudaGetLastError();
}

// The launch owns the plan. Rows kernel: 32 query rows a block up to 512
// keys (two blocks an SM at Dh 32), 16 up to 1024, so that the slab leaves
// room for the tile; above 1024 keys the wide arm, 8 rows a block, the slab
// in shared memory where it fits and in the wrapper's scratch beyond (ops/
// cuda/attention.py::slab_floats). The keys kernel has no limit on M: a
// block owns a tile of keys whatever their number. Keys kernel: 64 keys x 64 rows a block at Dh <= 32 (94 KB,
// two blocks an SM; 4% faster than 128 keys x 32 rows, 97 KB, at 64 x 4 x
// 512 x 512 x 32, the smoke's sweep), 64 keys x 32 rows at Dh 64.
// `key_tile` 64 or 128 asks for that tiling instead (the smoke's sweep);
// Dh 64 takes 64 only.
template <int DH>
cudaError_t launch_both(const float* q, const float* k, const float* v,
                        const float* dout, const uint8_t* mask, const float* thr,
                        const float* lse, float* o_full, float* dq_full,
                        float* dk_full, float* dv_full, float* delta,
                        float* slab, long long slab_floats, int B, int H, int N,
                        int M, int key_tile, cudaStream_t stream) {
  if (key_tile == 0) key_tile = kKeyTile;
  if (key_tile != 64 && (key_tile != 128 || DH == 64)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (M <= 512)
    err = launch_rows<DH, 4>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, slab, slab_floats, B, H, N, M, stream);
  else if (M <= 1024)
    err = launch_rows<DH, 2>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, slab, slab_floats, B, H, N, M, stream);
  else
    err = launch_rows<DH, 1>(q, k, v, dout, mask, thr, lse, o_full, dq_full,
                             delta, slab, slab_floats, B, H, N, M, stream);
  if (err != cudaSuccess) return err;
  if constexpr (DH == 64)   // 64 keys x 32 rows
    return launch_keys<DH, 4, 4, 2>(q, k, v, dout, mask, thr, lse, delta,
                                    dk_full, dv_full, B, H, N, M, stream);
  else if (key_tile == 128)  // 128 keys x 32 rows
    return launch_keys<DH, 8, 4, 4>(q, k, v, dout, mask, thr, lse, delta,
                                    dk_full, dv_full, B, H, N, M, stream);
  else                       // 64 keys x 64 rows
    return launch_keys<DH, 4, 4, 4>(q, k, v, dout, mask, thr, lse, delta,
                                    dk_full, dv_full, B, H, N, M, stream);
}

}  // namespace
}  // namespace mdgat

// q, dout [B,H,N,Dh], k, v [B,H,M,Dh], thr, lse [B,H,N], all f32 and
// contiguous; mask [B,M] uint8. Outputs, f32: o_full, dq_full [B,N,H*Dh] and
// dk_full, dv_full [B,M,H*Dh] with head-blocked columns h*Dh + d; delta
// [B,H,N] is scratch (do . o per row); slab, f32 scratch of slab_floats
// floats for the wide arm's slab where it does not fit in shared memory,
// else null. Two launches: rows, then keys. key_tile: 0 for the launch's
// plan, or 64 / 128 keys a block.
extern "C" cudaError_t mdgat_mha_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* thr, const void* lse, void* o_full,
    void* dq_full, void* dk_full, void* dv_full, void* delta, void* slab,
    long long slab_floats, int B, int H, int N, int M, int Dh, int key_tile,
    cudaStream_t stream) {
  using namespace mdgat;
  if (B <= 0 || H <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  // both kernels stage q, dout, k, v by 16-byte copies and store by
  // 16-byte vectors
  if (!aligned_to(q, 16) || !aligned_to(k, 16) || !aligned_to(v, 16) ||
      !aligned_to(dout, 16) || !aligned_to(o_full, 16) ||
      !aligned_to(dq_full, 16) || !aligned_to(dk_full, 16) ||
      !aligned_to(dv_full, 16))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  const auto* m = static_cast<const uint8_t*>(mask);
#define MDGAT_BWD(DH)                                                        \
  return launch_both<DH>(f(q), f(k), f(v), f(dout), m, f(thr), f(lse),       \
                         g(o_full), g(dq_full), g(dk_full), g(dv_full),      \
                         g(delta), g(slab), slab_floats, B, H, N, M, key_tile, \
                         stream)
  switch (Dh) {
    case 8: MDGAT_BWD(8);
    case 16: MDGAT_BWD(16);
    case 32: MDGAT_BWD(32);
    case 64: MDGAT_BWD(64);
    default: return cudaErrorInvalidValue;
  }
#undef MDGAT_BWD
}
