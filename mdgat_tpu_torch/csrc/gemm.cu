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
// Design of gemm_tn_kernel (the A^T products): csrc/tn_product.cuh, the
// split product it shares with the train layer's dw2 kernel.
//
// Design of gemm_kernel (the forward products and the W^T products). Every
// output element is ONE fmaf chain over k ascending from 0, started at 0,
// with the bias added after it, on the vector path and the guarded one
// alike: acc = fmaf(a[r][k], w[k][c], acc). A forward projection and its
// recomputation in the backward therefore agree bit for bit (zero padding
// of K only appends fmaf(0, 0, acc)). f32 FMA throughout, no TF32.
//
// What bounds it on the H100: the f32 FMA pipe (67 TFLOP/s), which a kernel
// reaches only if shared memory feeds it: the SM starts 128 FMAs a clock but
// has 32 shared-memory lanes. So each thread owns an 8x8 register tile and
// reads both operands as 16-byte vectors ALONG k: per four k steps 8 + 8
// loads feed 256 FMAs (16 FMAs a load; the 64x64 / 4x4 kernel before it had
// 2). A warp is 4 x 8 threads over a 32 x 64 tile; a block is WM x WN warps.
// A is kept in shared memory as it lies in HBM, [row][k] with a row stride
// of kBK + 4 floats, so that the four rows a warp reads at once (rows
// i*4 + tm) fall on disjoint banks; the plain W tile is [k][col] and a
// thread's columns are two runs of four (tn*4.., 32 + tn*4..), read as
// vectors along the columns; the W^T tile is [col][k] like A (W^T is read
// k-fastest from HBM, coalesced, and never transposed: the thread's columns
// are j*8 + tn, again on disjoint banks). Tiles of 8 k (16 for W^T) arrive
// through a four-stage (three-stage) cp.async ring (16-byte copies,
// zero-filled past R, C and K), so the loads of the next tiles are in
// flight under the FMAs of this one and one __syncthreads() separates
// tiles. A bf16 A1 is staged by 8-byte converting loads into the same ring.
// Operands that cannot take vector accesses (K1, K2, the head size or C not
// a multiple of four, unaligned pointers) go through guarded element loads:
// the same kernel, the same chain, slower. The epilogue writes 16-byte
// vectors where the layout allows (head-split included: Dh a multiple of
// four keeps a vector inside a head). One tile configuration serves every
// shape: a 64 x 64 block for small products was built and dropped, since no
// product of the model is small enough to select it. Where it stands:
// 16384x128x128 runs at 1.2x torch.addmm's time and 32768x128x128 at 1.04x
// (PERF.md); with one 128 x 128 block an SM and eight warps the FMA pipe
// idles on shared-memory latency between tiles.

#include "common.cuh"
#include "tn_product.cuh"

namespace mdgat {
namespace {

enum GemmFlags : int { kAVec = 1, kWVec = 2, kOutVec = 4, kRelu = 8 };

// Where element (row, kc) of a head-split [B, H, rows, dh] tensor lies.
__device__ __forceinline__ size_t head_index(int row, int c, int heads, int dh,
                                             int rows_per_batch) {
  const int b = row / rows_per_batch, n = row % rows_per_batch;
  const int h = c / dh, d = c % dh;
  return ((static_cast<size_t>(b) * heads + h) * rows_per_batch + n) * dh + d;
}

// WM x WN warps a block; kBK the depth of one stage of the ring, kStages
// its length
template <typename TA, typename TO, bool WT, int WM, int WN, int kBK, int kStages>
__global__ void __launch_bounds__(32 * WM * WN)
gemm_kernel(const TA* __restrict__ a1, int a1_heads, const float* __restrict__ a2,
            int K1, int K2, const float* __restrict__ w,
            const float* __restrict__ bias, const TO* __restrict__ res,
            TO* __restrict__ out, int out_heads, int rows_per_batch, int R,
            int C, int flags) {
  constexpr int BM = 32 * WM, BN = 64 * WN, T = 32 * WM * WN;
  constexpr int kLDK = kBK + 4;  // row stride of a k-contiguous tile
  constexpr int KQ = kBK / 4;    // 16-byte chunks of a row
  constexpr int A_STAGE = BM * kLDK, STAGE = (BM + BN) * kLDK;
  extern __shared__ __align__(16) float smem[];
  const int K = K1 + K2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = lane >> 3, tn = lane & 7;
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int dh_in = a1_heads > 0 ? K1 / a1_heads : 0;
  const bool a_vec = flags & kAVec, w_vec = flags & kWVec;

  auto a1_at = [&](int row, int kc) -> size_t {
    return a1_heads > 0 ? head_index(row, kc, a1_heads, dh_in, rows_per_batch)
                        : static_cast<size_t>(row) * K1 + kc;
  };

  // What this thread's 16-byte loads do not change from tile to tile: the
  // chunk of four k (kq), each row's validity and where it starts in A1 and
  // A2, each W column's validity and where it starts. A tile then costs a
  // compare, an add and one cp.async per chunk: no divide, no index
  // arithmetic in the k loop.
  constexpr int EA = (BM * KQ) / T, EW = (BN * KQ) / T;
  const int kq = (tid % KQ) * 4;
  const unsigned smem_u32 = smem_address(smem);
  const int dh_shift = dh_in > 0 ? __ffs(dh_in) - 1 : 0;  // a power of two
  const size_t head_stride = static_cast<size_t>(rows_per_batch) * dh_in;
  const TA* a1_row[EA];
  const float* a2_row[EA];
  const float* w_at[EW];
  bool a_ok[EA], w_ok[EW];
#pragma unroll
  for (int e = 0; e < EA; ++e) {
    const int row = row0 + (tid + e * T) / KQ;
    a_ok[e] = row < R;
    const int rr = a_ok[e] ? row : 0;
    a1_row[e] = a1 + a1_at(rr, 0);
    a2_row[e] = a2 + static_cast<size_t>(rr) * K2 - K1;
  }
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int c = tid + e * T;
    const int col = col0 + (WT ? c / KQ : (c % (BN / 4)) * 4);
    w_ok[e] = col < C;
    const int cc = w_ok[e] ? col : 0;
    w_at[e] = WT ? w + static_cast<size_t>(cc) * K + kq
                 : w + static_cast<size_t>(c / (BN / 4)) * C + cc;
  }

  // one stage: the A tile [BM][kLDK], then the W tile ([kBK][BN] plain,
  // [BN][kLDK] transposed)
  auto load_tile = [&](int tile, int stage) {
    float* As = smem + stage * STAGE;
    const unsigned as_u32 = smem_u32 + stage * STAGE * 4;
    const int k0 = tile * kBK;
    if (a_vec) {   // K1, K2 multiples of four, the head size a power of two
      const int kc = k0 + kq;
      const size_t off1 =
          a1_heads > 0 ? (static_cast<size_t>(kc >> dh_shift) * head_stride +
                          (kc & (dh_in - 1)))
                       : kc;
#pragma unroll
      for (int e = 0; e < EA; ++e) {
        const int at = ((tid + e * T) / KQ) * kLDK + kq;
        const bool ok = a_ok[e] && kc < K;
        if (kc >= K1)
          cp_async16(as_u32 + at * 4,
                     ok ? static_cast<const void*>(a2_row[e] + kc) : a1,
                     ok ? 16 : 0);
        else if constexpr (sizeof(TA) == 4)
          cp_async16(as_u32 + at * 4, ok ? a1_row[e] + off1 : a1, ok ? 16 : 0);
        else
          stage4(As + at, ok ? a1_row[e] + off1 : a1, ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EA; ++e) {
        const int c = tid + e * T;
        const int r = c / KQ, row = row0 + r;
        float* dst = As + r * kLDK + kq;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ki = k0 + kq + i;
          float val = 0.f;
          if (row < R && ki < K)
            val = ki < K1 ? to_f32(a1[a1_at(row, ki)])
                          : a2[static_cast<size_t>(row) * K2 + (ki - K1)];
          dst[i] = val;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < EW; ++e) {
      const int c = tid + e * T;
      if constexpr (WT) {   // w [C][K]: four k of one column
        const int n = c / KQ, kc = k0 + kq, col = col0 + n;
        const int at = A_STAGE + n * kLDK + kq;
        if (w_vec) {        // K a multiple of four
          const bool ok = w_ok[e] && kc < K;
          cp_async16(as_u32 + at * 4, ok ? w_at[e] + k0 : w, ok ? 16 : 0);
        } else {
          const float* src = w + static_cast<size_t>(col) * K + kc;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            As[at + i] = (col < C && kc + i < K) ? src[i] : 0.f;
        }
      } else {              // w [K][C]: four columns of one k
        const int kk = c / (BN / 4), n4 = (c % (BN / 4)) * 4;
        const int kc = k0 + kk, col = col0 + n4;
        const int at = A_STAGE + kk * BN + n4;
        if (w_vec) {        // C a multiple of four
          const bool ok = w_ok[e] && kc < K;
          cp_async16(as_u32 + at * 4,
                     ok ? w_at[e] + static_cast<size_t>(k0) * C : w, ok ? 16 : 0);
        } else {
          const float* src = w + static_cast<size_t>(kc) * C + col;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            As[at + i] = (kc < K && col + i < C) ? src[i] : 0.f;
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed
    __syncthreads();                // ... for every thread; tile t-1 is read
    if (t + kStages - 1 < tiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const float* As = smem + (t % kStages) * STAGE + (wm * 32 + tm) * kLDK;
    const float* Bs = smem + (t % kStages) * STAGE + A_STAGE;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(a[i]) =
            *reinterpret_cast<const float4*>(As + i * 4 * kLDK + k4);
      if constexpr (WT) {
        float b[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float4*>(b[j]) = *reinterpret_cast<const float4*>(
              Bs + (wn * 64 + j * 8 + tn) * kLDK + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i][kk], b[j][kk], acc[i][j]);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float b[8];
          const float* brow = Bs + (k4 + kk) * BN + wn * 64 + tn * 4;
          *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(brow);
          *reinterpret_cast<float4*>(b + 4) =
              *reinterpret_cast<const float4*>(brow + 32);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
        }
      }
    }
  }

  // epilogue: bias, ReLU, residual, in that order, then the store
  const int dh_out = out_heads > 0 ? C / out_heads : 0;
  auto out_at = [&](int row, int col) -> size_t {
    return out_heads > 0
               ? head_index(row, col, out_heads, dh_out, rows_per_batch)
               : static_cast<size_t>(row) * C + col;
  };
  auto finish = [&](float val, int col, size_t o) -> float {
    if constexpr (!WT) val += bias[col];  // the transposed mode has no bias
    if (flags & kRelu) val = fmaxf(val, 0.f);
    if (res != nullptr) val = to_f32(res[o]) + val;
    return val;
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + wm * 32 + i * 4 + tm;
    if (row >= R) continue;
    if constexpr (WT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + wn * 64 + j * 8 + tn;
        if (col >= C) continue;
        const size_t o = out_at(row, col);
        out[o] = from_f32<TO>(finish(acc[i][j], col, o));
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = col0 + wn * 64 + half * 32 + tn * 4;
        if ((flags & kOutVec) && col < C) {   // C, Dh multiples of four
          const size_t o = out_at(row, col);
          float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (res != nullptr) r4 = load4(res + o);
          const float4 b4 = load4(bias + col);
          float v[4] = {acc[i][half * 4] + b4.x, acc[i][half * 4 + 1] + b4.y,
                        acc[i][half * 4 + 2] + b4.z, acc[i][half * 4 + 3] + b4.w};
          if (flags & kRelu) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
          }
          if (res != nullptr) {
            v[0] = r4.x + v[0]; v[1] = r4.y + v[1];
            v[2] = r4.z + v[2]; v[3] = r4.w + v[3];
          }
          store4(out + o, make_float4(v[0], v[1], v[2], v[3]));
        } else if (!(flags & kOutVec)) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e >= C) continue;
            const size_t o = out_at(row, col + e);
            out[o] = from_f32<TO>(finish(acc[i][half * 4 + e], col + e, o));
          }
        }
      }
    }
  }
}

// The block is 4 x 2 warps (a 128 x 128 tile, 256 threads). The ring is four
// stages of 8 k for the plain product and three of 16 k for W^T, the fastest
// of the combinations tried on the H100 (PERF.md). The W^T ring is over the
// default 48 KB of shared memory: its cap is raised once per device.
template <typename TA, typename TO, bool WT>
cudaError_t launch_tiles(const void* a1, int a1_heads, const float* a2, int K1,
                         int K2, const float* w, const float* bias,
                         const void* res, void* out, int out_heads,
                         int rows_per_batch, int R, int C, int flags,
                         cudaStream_t stream) {
  constexpr int WM = 4, WN = 2, kBK = WT ? 16 : 8, kStages = WT ? 3 : 4;
  constexpr int BM = 32 * WM, BN = 64 * WN;
  constexpr size_t smem = sizeof(float) * kStages * (BM + BN) * (kBK + 4);
  static_assert(smem <= kMaxSmem, "the ring must fit a block's shared memory");
  auto kernel = gemm_kernel<TA, TO, WT, WM, WN, kBK, kStages>;
  static SmemCap cap;
  cudaError_t err = allow_smem(kernel, smem, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(
      static_cast<const TA*>(a1), a1_heads, a2, K1, K2, w, bias,
      static_cast<const TO*>(res), static_cast<TO*>(out), out_heads,
      rows_per_batch, R, C, flags);
  return cudaGetLastError();
}

template <typename TA, typename TO>
cudaError_t launch(const void* a1, int a1_heads, const float* a2, int K1,
                   int K2, const float* w, const float* bias,
                   const void* res, void* out, int out_heads,
                   int rows_per_batch, int R, int C, int relu, int w_trans,
                   cudaStream_t stream) {
  // which operands take 16-byte accesses; the rest go element by element
  const int K = K1 + K2;
  const int dh_in = a1_heads > 0 ? K1 / a1_heads : 4;
  const int dh_out = out_heads > 0 ? C / out_heads : 4;
  int flags = relu ? kRelu : 0;
  if (K1 % 4 == 0 && K2 % 4 == 0 && dh_in % 4 == 0 &&
      (dh_in & (dh_in - 1)) == 0 &&      // the head offset is a shift
      aligned_to(a1, 4 * sizeof(TA)) && aligned_to(a2, 16))
    flags |= kAVec;
  if ((w_trans ? K : C) % 4 == 0 && aligned_to(w, 16)) flags |= kWVec;
  if (!w_trans && C % 4 == 0 && dh_out % 4 == 0 && aligned_to(bias, 16) &&
      aligned_to(out, 4 * sizeof(TO)) && aligned_to(res, 4 * sizeof(TO)))
    flags |= kOutVec;
  if (w_trans)
    return launch_tiles<TA, TO, true>(a1, a1_heads, a2, K1, K2, w, bias, res,
                                      out, out_heads, rows_per_batch, R, C,
                                      flags, stream);
  return launch_tiles<TA, TO, false>(a1, a1_heads, a2, K1, K2, w, bias, res,
                                     out, out_heads, rows_per_batch, R, C,
                                     flags, stream);
}

// ---- gemm_tn_kernel: dw = a^T b and db = colsum(b), split over rows ----
//
// partial[z] [K1 + 1][C] of split z (tn_product.cuh); tn_reduce_kernel then
// adds the splits.
constexpr int kReduceGroups = 8; // tn_reduce_kernel: chunks of splits

template <bool VEC>
__global__ void __launch_bounds__(kTnThreads, 1)
gemm_tn_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ partial, int R, int K1, int C,
               int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  tn_split_product<float, VEC>(a, b, partial, R, K1, C, rows_per_split,
                               IdentityColumns{}, smem);
}

// dw[k][c] = sum_z partial[z][k][c] (k < K1), db[c] = sum_z partial[z][K1][c]
// in a fixed order: the splits in kReduceGroups chunks of consecutive z, each
// chunk summed z ascending by one warp, then the chunks added in ascending
// order. A lane owns W consecutive outputs (W = 4: 16-byte loads), a warp
// reads one contiguous run of every partial it visits.
template <int W>
__global__ void __launch_bounds__(kReduceGroups * 32)
tn_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                 float* __restrict__ db, int K1, int C, int splits) {
  __shared__ float red[kReduceGroups][32 * W];
  const size_t total = static_cast<size_t>(K1 + 1) * C;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const size_t o = (static_cast<size_t>(blockIdx.x) * 32 + lane) * W;
  const int per = (splits + kReduceGroups - 1) / kReduceGroups;
  const int z0 = min(splits, grp * per), z1 = min(splits, z0 + per);
  float s[W];
#pragma unroll
  for (int w = 0; w < W; ++w) s[w] = 0.f;
  if (o < total) {
#pragma unroll 4
    for (int z = z0; z < z1; ++z) {
      const float* p = partial + static_cast<size_t>(z) * total + o;
      if constexpr (W == 4) {
        const float4 v = load4(p);
        s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
      } else {
        s[0] += *p;
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) red[grp][lane * W + w] = s[w];
  __syncthreads();
  if (grp != 0 || o >= total) return;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    float t = red[0][lane * W + w];
#pragma unroll
    for (int g = 1; g < kReduceGroups; ++g) t += red[g][lane * W + w];
    const size_t idx = o + w;        // total is a multiple of W
    if (idx < static_cast<size_t>(K1) * C) dw[idx] = t; else db[idx - static_cast<size_t>(K1) * C] = t;
  }
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
// b [R, C], all f32 and contiguous. partial is scratch of partial_floats =
// splits * (K1 + 1) * C floats; split z covers rows [z * rows_per_split,
// min(R, (z + 1) * rows_per_split)). The plan (ops/cuda/layer.py::tn_plan)
// must cover every row once and leave no split empty.
extern "C" cudaError_t mdgat_gemm_tn(const void* a, const void* b,
                                     void* partial, long long partial_floats,
                                     void* dw, void* db, int R, int K1, int C,
                                     int rows_per_split, int splits,
                                     cudaStream_t stream) {
  using namespace mdgat;
  if (R <= 0 || K1 <= 0 || C <= 0 || rows_per_split <= 0 || splits <= 0 ||
      splits > 65535 ||
      static_cast<long long>(rows_per_split) * splits < R ||
      static_cast<long long>(rows_per_split) * (splits - 1) >= R ||
      partial_floats != static_cast<long long>(splits) * (K1 + 1) * C)
    return cudaErrorInvalidValue;
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* pf = static_cast<float*>(partial);
  dim3 grid((C + kTnTile - 1) / kTnTile, (K1 + kTnTile - 1) / kTnTile, splits);
  cudaError_t err;
  if (K1 % 4 == 0 && C % 4 == 0 && aligned_to(a, 16) && aligned_to(b, 16) &&
      aligned_to(partial, 16)) {
    static SmemCap cap;
    err = allow_smem(gemm_tn_kernel<true>, kTnSmem, cap);
    if (err != cudaSuccess) return err;
    gemm_tn_kernel<true><<<grid, kTnThreads, kTnSmem, stream>>>(
        af, bf, pf, R, K1, C, rows_per_split);
  } else {
    static SmemCap cap;
    err = allow_smem(gemm_tn_kernel<false>, kTnSmem, cap);
    if (err != cudaSuccess) return err;
    gemm_tn_kernel<false><<<grid, kTnThreads, kTnSmem, stream>>>(
        af, bf, pf, R, K1, C, rows_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(K1 + 1) * C;
  if (total % 4 == 0 && aligned_to(partial, 16)) {
    const unsigned blocks = static_cast<unsigned>((total / 4 + 31) / 32);
    tn_reduce_kernel<4><<<blocks, kReduceGroups * 32, 0, stream>>>(
        pf, static_cast<float*>(dw), static_cast<float*>(db), K1, C, splits);
  } else {
    const unsigned blocks = static_cast<unsigned>((total + 31) / 32);
    tn_reduce_kernel<1><<<blocks, kReduceGroups * 32, 0, stream>>>(
        pf, static_cast<float*>(dw), static_cast<float*>(db), K1, C, splits);
  }
  return cudaGetLastError();
}
