// The split-K A^T B product shared by csrc/gemm.cu::gemm_tn_kernel (dw =
// a^T b and db = column sums of b: the weight and bias gradients of the
// projections) and csrc/train_layer.cu::tl_dw2_kernel (dw2 = relu(bn(h1))^T
// g and db2), which differ only in the prologue applied to a.
//
// The output [K1, C] is cut into 128 x 128 tiles (blockIdx.y along k,
// blockIdx.x along c) and the rows into splits (blockIdx.z); a block forms
// its tile over its split's rows and writes it to partial[z], row K1 of which
// holds the split's column sums of b; a second kernel adds the splits in a
// fixed order.
//
// Design. Each step of the reduction is the outer product of one row of a
// (along k) and the same row of b (along c), so neither operand needs a
// transpose: stages of 32 rows of a and b are copied as they lie in HBM by
// 16-byte cp.async into a four-stage ring (bf16 loaded into registers before
// the product of the stage three behind, converted into the ring after it,
// so its latency hides under that product), and a thread owns an 8 x 8 register tile of the 128 x 128 output tile of its
// block, reading per row two 16-byte vectors of a and two of b for 64 FMAs
// (16 FMAs a load). A lane stages the same four columns of a in every stage,
// so a prologue on a (the BatchNorm and ReLU of tl_dw2_kernel) keeps their
// constants in registers and applies itself once per staged value: to an
// f32 stage in place, once the lane's own copies have landed and before the
// barrier that hands the stage to the product; to bf16 and guarded loads as
// they are converted. The column sums leave the product loop: per stage each of the
// 16 threads that share a thread's columns adds two rows, and the 16 sums
// close in a fixed order after the loop. One block an SM: the 128 KB ring
// and up to 255 registers a thread (about 160 used) ran faster than two
// blocks of 128 registers, and than a 16 x 8 tile on 128 threads (PERF.md).
// The row splits are a plan of the wrapper (ops/cuda/layer.py::tn_plan,
// ops/cuda/train_layer.py::dw2_plan: about a block an SM over the output
// tiles, whole stages), which the C entries check.
// What bounds it on the H100: the f32 FMA pipe (128 x 32768 x 128: 1.07
// GFLOP, 0.016 ms at 67 TFLOP/s, against 0.010 ms for the operands' bytes);
// the partials (S splits x (K1 + 1) x C floats) and their second pass are
// the price of filling 132 SMs with one or two output tiles. VEC: K1 and C
// multiples of four and a, b, partial aligned to a vector of four; otherwise
// guarded element loads in the same code. f32 FMA, no TF32.
#pragma once

#include "common.cuh"

namespace mdgat {

constexpr int kTnTile = 128;     // output tile edge, along k and along c
constexpr int kTnRows = 32;      // rows of a and of b in one stage of the ring
constexpr int kTnStages = 4;
constexpr int kTnThreads = 256;  // 4 x 2 warps, a 32 x 64 tile each
constexpr int kTnStage = kTnRows * 2 * kTnTile;   // floats: a tile, b tile
constexpr size_t kTnSmem = sizeof(float) * kTnStages * kTnStage;

// The first of the four columns of a that this lane stages (the prologue's
// columns col .. col + 3)
__device__ __forceinline__ int tn_lane_column() {
  return static_cast<int>(blockIdx.y) * kTnTile + (threadIdx.x & 31) * 4;
}

// The prologue of a plain product: a as it is.
struct IdentityColumns {
  static constexpr bool kIdentity = true;
  __device__ __forceinline__ float operator()(float v, int) const { return v; }
};

// partial[z][k][c] = sum over the rows r of split z of pro(a[r][k]) * b[r][c]
// (k < K1); partial[z][K1][c] = sum over those rows of b[r][c], for z =
// blockIdx.z, rows [z * rows_per_split, min(R, (z + 1) * rows_per_split)).
// pro(v, i) maps a value of column tn_lane_column() + i. smem holds kTnSmem
// bytes.
template <typename T, bool VEC, typename Prologue>
__device__ __forceinline__ void tn_split_product(const T* __restrict__ a,
                                                 const T* __restrict__ b,
                                                 float* __restrict__ partial, int R,
                                                 int K1, int C, int rows_per_split,
                                                 const Prologue& pro, float* smem) {
  // f32 lands by cp.async (the prologue then runs in place); bf16 (VEC) is
  // loaded into registers before the product of the stage three behind it
  // and converted into the ring after that product, so that its latency
  // hides under the product
  constexpr bool kAsync = VEC && sizeof(T) == sizeof(float);
  constexpr bool kStaged = VEC && !kAsync;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = lane >> 3, tn = lane & 7, wm = warp >> 1, wn = warp & 1;
  const int k0 = blockIdx.y * kTnTile, c0 = blockIdx.x * kTnTile;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const unsigned smem_u32 = smem_address(smem);

  // A stage is [kTnRows][128] of a (its k0.. columns), then [kTnRows][128]
  // of b (its c0.. columns), both as they lie in HBM: a row of the stage is
  // one outer product's operands. A warp copies whole rows: 32 lanes x 4
  // elements, contiguous in HBM and in shared memory.
  const int col4 = lane * 4;
  const bool a_ok = k0 + col4 < K1, b_ok = c0 + col4 < C;
  auto stage_row = [&](int tile, int e) { return r_begin + tile * kTnRows + warp + 8 * e; };
  uint2 a_raw[kTnRows / 8], b_raw[kTnRows / 8];   // a bf16 stage in flight
  auto fetch = [&](int tile) {
#pragma unroll
    for (int e = 0; e < kTnRows / 8; ++e) {
      const int row = stage_row(tile, e);
      const bool rok = row < r_end;
      const T* arow = a + static_cast<size_t>(rok ? row : r_begin) * K1 + k0 + col4;
      const T* brow = b + static_cast<size_t>(rok ? row : r_begin) * C + c0 + col4;
      a_raw[e] = rok && a_ok ? *reinterpret_cast<const uint2*>(arow) : make_uint2(0, 0);
      b_raw[e] = rok && b_ok ? *reinterpret_cast<const uint2*>(brow) : make_uint2(0, 0);
    }
  };
  auto put = [&](int tile, int stage) {
    float* As = smem + stage * kTnStage;
    float* Bs = As + kTnRows * kTnTile;
#pragma unroll
    for (int e = 0; e < kTnRows / 8; ++e) {
      const int at = (warp + 8 * e) * kTnTile + col4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (stage_row(tile, e) < r_end && a_ok) {
        const float4 v = bf16x4_to_float4(a_raw[e]);
        u = make_float4(pro(v.x, 0), pro(v.y, 1), pro(v.z, 2), pro(v.w, 3));
      }
      store4(As + at, u);
      store4(Bs + at, bf16x4_to_float4(b_raw[e]));
    }
  };
  auto load_stage = [&](int tile, int stage) {
    if constexpr (kStaged) {
      fetch(tile);
      put(tile, stage);
    } else {
      float* As = smem + stage * kTnStage;
      float* Bs = As + kTnRows * kTnTile;
#pragma unroll
      for (int e = 0; e < kTnRows / 8; ++e) {
        const int row = stage_row(tile, e), at = (warp + 8 * e) * kTnTile + col4;
        const bool rok = row < r_end;
        const T* arow = a + static_cast<size_t>(rok ? row : r_begin) * K1 + k0 + col4;
        const T* brow = b + static_cast<size_t>(rok ? row : r_begin) * C + c0 + col4;
        if constexpr (kAsync) {
          cp_async16(smem_u32 + (stage * kTnStage + at) * 4, rok && a_ok ? arow : a,
                     rok && a_ok ? 16 : 0);
          cp_async16(smem_u32 + (stage * kTnStage + kTnRows * kTnTile + at) * 4,
                     rok && b_ok ? brow : b, rok && b_ok ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            As[at + i] = rok && k0 + col4 + i < K1 ? pro(to_f32(arow[i]), i) : 0.f;
            Bs[at + i] = rok && c0 + col4 + i < C ? to_f32(brow[i]) : 0.f;
          }
        }
      }
    }
  };

  // A thread owns k = wm*32 + {tm*4.., 16 + tm*4..} and c = wn*64 +
  // {tn*4.., 32 + tn*4..}: per row, two 16-byte loads of a (four distinct
  // addresses in a warp, broadcast) and two of b (eight, one 128-byte run)
  // feed 64 FMAs.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float csum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const bool sums = blockIdx.y == 0;   // one k tile of a column forms the sums

  const int tiles = (r_end - r_begin + kTnRows - 1) / kTnRows;
#pragma unroll
  for (int s = 0; s < kTnStages - 1; ++s) {
    if (s < tiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kTnStages - 2>();   // this thread's copies of stage t have landed
    if constexpr (kAsync && !Prologue::kIdentity) {
      // ... so it applies the prologue to its own chunks of a
      if (a_ok) {
#pragma unroll
        for (int e = 0; e < kTnRows / 8; ++e) {
          if (stage_row(t, e) >= r_end) continue;
          float* p = smem + (t % kTnStages) * kTnStage + (warp + 8 * e) * kTnTile + col4;
          const float4 v = *reinterpret_cast<const float4*>(p);
          *reinterpret_cast<float4*>(p) =
              make_float4(pro(v.x, 0), pro(v.y, 1), pro(v.z, 2), pro(v.w, 3));
        }
      }
    }
    __syncthreads();                  // stage t is ready for every thread; t-1 is read
    const int next = t + kTnStages - 1;
    if (next < tiles) {
      if constexpr (kStaged)
        fetch(next);
      else
        load_stage(next, next % kTnStages);
    }
    cp_async_commit();
    const float* ap = smem + (t % kTnStages) * kTnStage + wm * 32 + tm * 4;
    const float* bp = smem + (t % kTnStages) * kTnStage + kTnRows * kTnTile +
                      wn * 64 + tn * 4;
#pragma unroll
    for (int rr = 0; rr < kTnRows; ++rr) {
      float av[8], bv[8];
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(ap + rr * kTnTile);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(ap + rr * kTnTile + 16);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(bp + rr * kTnTile);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(bp + rr * kTnTile + 32);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // column sums outside the product: each of the 16 threads that share a
    // thread's columns (its wm, tm) adds two rows of the stage, rows past
    // the split being zeros
    if (sums) {
#pragma unroll
      for (int e = 0; e < kTnRows / 16; ++e) {
        const float* brow = bp + (wm * 4 + tm + 16 * e) * kTnTile;
        const float4 lo = *reinterpret_cast<const float4*>(brow);
        const float4 hi = *reinterpret_cast<const float4*>(brow + 32);
        csum[0] += lo.x; csum[1] += lo.y; csum[2] += lo.z; csum[3] += lo.w;
        csum[4] += hi.x; csum[5] += hi.y; csum[6] += hi.z; csum[7] += hi.w;
      }
    }
    if constexpr (kStaged) {
      if (next < tiles) put(next, next % kTnStages);   // slot of stage t-1, read
    }
  }

  float* pz = partial + static_cast<size_t>(blockIdx.z) * (K1 + 1) * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kc = k0 + wm * 32 + (i < 4 ? tm * 4 + i : 16 + tm * 4 + i - 4);
    if (kc >= K1) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = c0 + wn * 64 + half * 32 + tn * 4;
      float* dst = pz + static_cast<size_t>(kc) * C + col;
      if constexpr (VEC) {
        if (col < C)
          store4(dst, make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                                  acc[i][half * 4 + 2], acc[i][half * 4 + 3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < C) dst[e] = acc[i][half * 4 + e];
      }
    }
  }
  if (!sums) return;                  // block-uniform
  // the 16 partial sums of a column, in a fixed order: over tm by shuffles,
  // then over wm through shared memory (the ring is no longer read)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    csum[j] += __shfl_xor_sync(kFull, csum[j], 8);
    csum[j] += __shfl_xor_sync(kFull, csum[j], 16);
  }
  __syncthreads();
  float* red = smem;                  // [4 wm][128 columns]
  if (tm == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[wm * kTnTile + wn * 64 + (j < 4 ? tn * 4 + j : 32 + tn * 4 + j - 4)] = csum[j];
  }
  __syncthreads();
  if (tid < kTnTile) {
    const int col = c0 + tid;
    if (col < C)
      pz[static_cast<size_t>(K1) * C + col] =
          ((red[tid] + red[kTnTile + tid]) + red[2 * kTnTile + tid]) +
          red[3 * kTnTile + tid];
  }
}

}  // namespace mdgat
