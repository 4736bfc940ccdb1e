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
//   BatchNorm affine and the ReLU applied once to each staged value of h1.
// * _tl_bwd1_kernel: mdgat_tl_bwd_sums forms dh2 = g @ w2^T tile by tile,
//   rebuilds hhat, the BN output and the ReLU mask from h1 in registers and
//   emits the column sums Sg, Sgh, dscale, dbias over ALL rows, padded ones
//   included (every row is normalised with the batch statistics, so every
//   row's cotangent reaches them; the row mask enters only in the next
//   kernel). dh2 never reaches memory. mdgat_tl_dw2 is dw2 = u^T g and
//   db2 = column sums of g, u = relu(bn(h1)) rebuilt on the staged rows.
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
// order. No atomics: the results carry the same bits on every run. Each
// entry takes its row plan (rows a block, blocks) from the wrapper and
// refuses one that does not cover every row exactly once.
//
// x, h1, g and y are f32 or bf16 (one type per call); msg, dh1, the vectors
// and every sum are f32. What bounds every kernel here on the H100 is the
// f32 FMA pipe, as shared memory feeds it: each gives a thread an 8 x 8
// register tile read as 16-byte vectors (16 FMAs a shared load) under a
// cp.async ring, one block an SM (tl_h1 and tl_fwd2 share that product,
// resident_product, with W resident; tl_dw2 shares gemm_tn_kernel's); only
// the general forms for other widths and unaligned operands still run the
// 64x64 tile of 4x4 a thread (tile_product: 2 FMAs a shared load,
// synchronous staging). h1 ([B*N, 2D], 33.5 MB in f32 at 64 x 512 x 256)
// and dh1 round-trip through HBM between launches.

#include <type_traits>

#include "common.cuh"
#include "tn_product.cuh"

namespace mdgat {
namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// acc += A[row0 .. row0+BM, :K] @ W[:, col0 .. col0+BN]. `a(row, kc)` yields
// one element of A (its prologue applied) for row < R, kc < K. W is [K, C]
// row-major. Thread (tx, ty) = (threadIdx.x % 16, threadIdx.x / 16) owns
// rows ty*4..+3 and columns tx*4..+3 of the tile.
template <typename ALoad>
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
// quantities. s[v][j] holds thread (tx, ty)'s sum over its rows of
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
// them (one expression for the dh2 kernel's ReLU mask and dw2's u): from
// the column's mean, inv, scale and bias, or from vec rows 0-3, each [C].
struct BnRebuild {
  float hhat, bn;
  __device__ __forceinline__ BnRebuild(float h, float mean, float inv, float scale,
                                       float bias) {
    hhat = (h - mean) * inv;
    bn = hhat * scale + bias;
  }
  __device__ __forceinline__ BnRebuild(float h, const float* __restrict__ vec,
                                       int C, int col)
      : BnRebuild(h, vec[col], vec[C + col], vec[2 * C + col], vec[3 * C + col]) {}
};

// ---- the resident product of tl_h1_kernel and tl_fwd2_kernel ----
//
// A persistent block multiplies the 128-row tiles of its rows of A [R, 2D]
// by 128 columns of W (row k at w + k * ldw + col0), which it keeps in
// shared memory for the launch, [2D][128] f32 (128 KB at D = 128), as they
// lie in HBM. The row plan (ops/cuda/train_layer.py::h1_plan, fwd2_plan)
// gives row block y (blockIdx.y) the rows [y * rows_per_block, (y + 1) *
// rows_per_block), a whole number of 128-row tiles, at most one block an
// SM. The rows of A come through a four-stage cp.async ring of 32 k
// (16-byte copies; a bf16 operand, or one with a prologue, through
// registers: loaded before the product of the stage three behind it and
// converted into the ring after that product, so that its latency hides
// under the product, since cp.async cannot convert), one ring over every
// stage of every tile of the block, so the next tile's first stages are in
// flight under a tile's epilogue.
// A thread owns an 8 x 8 register tile (rows wm*32 + i*4 + tm, columns wn*64
// + tn*4.. and wn*64 + 32 + tn*4..) and per four k reads eight 16-byte
// vectors of A along k (four rows a warp, on disjoint banks at a row stride
// of 36 floats) and eight of W along the columns (one 128-byte run a warp)
// for 256 FMAs: gemm_kernel's plain-W mode with W resident. Every output is
// one fmaf chain over k ascending from 0.
//
// The tile policy (H1Tile, Fwd2Tile) says where A comes from (k below
// kSplit from the io-typed operand ta, row stride kTa; the rest from the f32
// operand fa, row stride kFa), the prologue applied once to each staged
// value of A (a tile with a prologue stages every value through registers,
// an f32 one too, and applies it on the way into the ring), what a tile
// fetches before its last stage, the tile's epilogue, and what closes the
// launch.
constexpr int kResRows = 128;      // rows of a tile
constexpr int kResCols = 128;      // columns of W a block keeps
constexpr int kResDepth = 32;      // k of one stage of the ring
constexpr int kResStages = 4;
constexpr int kResThreads = 256;   // 4 x 2 warps of 32 rows x 64 columns
constexpr int kResWidth = 128;     // D of the resident form
constexpr int kResLd = kResDepth + 4;   // row stride of a stage, floats
// floats of shared memory: W's columns [2D][128], the ring [4][128][36]
// (200 KB); fwd2 adds a and c [2][2D]
constexpr size_t kResSmem =
    sizeof(float) * (2 * kResWidth * kResCols + kResStages * kResRows * kResLd);
constexpr size_t kFwd2Smem = kResSmem + sizeof(float) * 2 * 2 * kResWidth;

// a thread's place in the 8 x 8 tiling of a 128 x 128 tile
struct ResLane {
  int tm, tn, wm, wn;
  __device__ __forceinline__ ResLane() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    tm = lane >> 3, tn = lane & 7, wm = warp >> 1, wn = warp & 1;
  }
  __device__ __forceinline__ int row(int i) const { return wm * 32 + i * 4 + tm; }
  __device__ __forceinline__ int col(int j) const {   // j < 8
    return wn * 64 + (j >> 2) * 32 + tn * 4 + (j & 3);
  }
  // the first of the four columns j = half * 4 ..
  __device__ __forceinline__ int col4(int half) const { return wn * 64 + half * 32 + tn * 4; }
};

__device__ __forceinline__ float4 as_float4(float4 v) { return v; }
__device__ __forceinline__ float4 as_float4(uint2 raw) { return bf16x4_to_float4(raw); }

template <typename T, int D, class Tile>
__device__ __forceinline__ void resident_product(Tile& tile, const float* __restrict__ w,
                                                 int ldw, int col0, int r_begin,
                                                 int r_end, float* smem) {
  constexpr int K = 2 * D;
  constexpr int kSteps = K / kResDepth;               // stages a tile
  constexpr int kQ = kResDepth / 4;                   // 16-byte chunks of a stage row
  constexpr int kWQ = kResCols / 4;                   // 16-byte chunks of a W row
  constexpr int kPer = kResRows * kQ / kResThreads;   // chunks a thread copies
  constexpr bool kStaged = sizeof(T) != sizeof(float) || Tile::kPrologue;
  using Raw = std::conditional_t<sizeof(T) == sizeof(float), float4, uint2>;
  static_assert(D % kResDepth == 0 && Tile::kSplit % kResDepth == 0 &&
                Tile::kSplit <= K, "the resident form's width");
  float* Ws = smem;                                   // [K][128]
  float* ring = Ws + K * kResCols;                    // [kResStages][128][kResLd]
  const int tid = threadIdx.x;
  const ResLane t;
  const int total = (r_end - r_begin + kResRows - 1) / kResRows * kSteps;

  // W's columns land with the first stage's group
  for (int e = tid; e < K * kWQ; e += kResThreads) {
    const int k = e / kWQ, c = (e - k * kWQ) * 4;
    cp_async16(Ws + k * kResCols + c, w + static_cast<size_t>(k) * ldw + col0 + c);
  }
  tile.setup(ring + kResStages * kResRows * kResLd, t);
  __syncthreads();                                    // what setup staged

  // stage s: tile s / kSteps, k of (s % kSteps) * 32 ..; a thread copies
  // the chunk kq of the rows row_of(e)
  const int kq = (tid % kQ) * 4;
  auto slot = [&](int s) { return ring + (s % kResStages) * kResRows * kResLd + kq; };
  auto row_of = [&](int e) { return tid / kQ + e * (kResThreads / kQ); };
  auto kc_of = [&](int s) { return (s % kSteps) * kResDepth + kq; };
  auto first_row = [&](int s) { return r_begin + (s / kSteps) * kResRows; };
  auto from_t = [&](int s) { return (s % kSteps) * kResDepth < Tile::kSplit; };
  Raw raw[kPer];
  auto fetch = [&](int s) {          // a stage into registers
    const int row0 = first_row(s), kc = kc_of(s);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int row = row0 + row_of(e);
      raw[e] = row < r_end ? *reinterpret_cast<const Raw*>(
                                 tile.ta + static_cast<size_t>(row) * Tile::kTa + kc)
                           : Raw{};
    }
  };
  auto put = [&](int s) {            // ... and from them into the ring
    float* dst = slot(s);
    const int kc = kc_of(s);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      store4(dst + row_of(e) * kResLd, tile.prologue(as_float4(raw[e]), kc));
  };
  auto load_stage = [&](int s) {
    if (kStaged && from_t(s)) {
      fetch(s);
      put(s);
      return;
    }
    float* dst = slot(s);
    const int row0 = first_row(s), kc = kc_of(s);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int rr = row_of(e);
      const bool ok = row0 + rr < r_end;
      const size_t at = ok ? row0 + rr : r_begin;
      if (kc < Tile::kSplit)         // the same for every chunk of the stage
        stage4(dst + rr * kResLd, tile.ta + at * Tile::kTa + kc, ok);
      else
        cp_async16(dst + rr * kResLd, tile.fa + at * Tile::kFa + (kc - Tile::kSplit),
                   ok ? 16 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int p = 0; p < kResStages - 1; ++p) {
    if (p < total) load_stage(p);
    cp_async_commit();
  }
  for (int st = 0; st < total; ++st) {
    cp_async_wait<kResStages - 2>();   // stage st (and W) have landed ...
    __syncthreads();                   // ... for every thread; stage st-1 is read
    const int next = st + kResStages - 1;
    const bool staged = kStaged && next < total && from_t(next);
    if (staged)
      fetch(next);
    else if (next < total)
      load_stage(next);
    cp_async_commit();
    const int kt = st % kSteps;
    if (kt == kSteps - 1) tile.before_last(first_row(st), r_end, t);
    const float* As = ring + (st % kResStages) * kResRows * kResLd + t.row(0) * kResLd;
    const float* Bs = Ws + kt * kResDepth * kResCols + t.col4(0);
#pragma unroll
    for (int k4 = 0; k4 < kResDepth; k4 += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(a[i]) =
            *reinterpret_cast<const float4*>(As + i * 4 * kResLd + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[8];
        const float* brow = Bs + (k4 + kk) * kResCols;
        *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(brow);
        *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(brow + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
    if (staged) put(next);             // the slot of stage st - 1, read
    if (kt != kSteps - 1) continue;
    tile.epilogue(acc, first_row(st), r_end, t);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  tile.finish(ring, t);
}

// ---- tl_h1_kernel: h1 = cat(x, msg) @ w1 + b1 and its masked column sums ----
//
// h1 [R, 2D] is stored as T; partial [blocks][2][2D] gets each row block's
// column sums of h1 * m and h1^2 * m (m the row mask), taken from the f32
// value before that rounding.
//
// Design: the resident product over A = cat(x, msg). At D = 128, w1 [2D,
// 2D] is 256 KB, more than an SM holds, so the 2D = 256 columns are split
// over two blocks (blockIdx.x), each keeping its half. b1 is added after
// the chain. The epilogue stores h1 (16-byte vectors in f32) and adds the
// f32 value and its square, times the row mask, in registers over all of
// the block's rows; at the end the 16 sums of a column close in a fixed
// order (the four tm by shuffles, then the four warp rows through shared
// memory).
// What bounds it on the H100: the f32 FMA pipe (R = 32768, D = 128: 4.29
// GFLOP, 0.064 ms at 67 TFLOP/s, against 0.020 ms for x, msg in and h1 out).
// Other widths and unaligned operands run tl_h1_tiled_kernel (64 x 64 tiles
// of tile_product, w1 read from L2 a tile at a time) under the same plan.
template <typename T, int D>
struct H1Tile {
  static constexpr int kSplit = D, kTa = D, kFa = D;   // x, then msg
  static constexpr bool kPrologue = false;
  const T* ta;
  const float* fa;
  const float* b1;
  const uint8_t* rowmask;
  T* h1;
  float* partial;
  int col0;
  float bias[8], s[2][8];
  __device__ __forceinline__ H1Tile(const T* x, const float* msg, const float* b1_,
                                    const uint8_t* rowmask_, T* h1_, float* partial_,
                                    int col0_)
      : ta(x), fa(msg), b1(b1_), rowmask(rowmask_), h1(h1_), partial(partial_),
        col0(col0_) {}
  __device__ __forceinline__ void setup(float*, const ResLane& t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bias[j] = b1[col0 + t.col(j)];
      s[0][j] = s[1][j] = 0.f;
    }
  }
  __device__ __forceinline__ float4 prologue(float4 v, int) const { return v; }
  __device__ __forceinline__ void before_last(int, int, const ResLane&) {}
  // h1 out, the sums in registers
  __device__ __forceinline__ void epilogue(const float (&acc)[8][8], int row0, int r_end,
                                           const ResLane& t) {
    constexpr int C = 2 * D;
    float m[8];                        // the row mask, every load before a store
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + t.row(i);
      m[i] = row < r_end && (rowmask == nullptr || rowmask[row]) ? 1.f : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + t.row(i);
      if (row >= r_end) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = half * 4 + e;
          v[e] = acc[i][j] + bias[j];
          const float hm = v[e] * m[i];
          s[0][j] += hm;
          s[1][j] += hm * v[e];
        }
        store4_global(h1 + static_cast<size_t>(row) * C + col0 + t.col4(half),
                      make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
  // the 16 sums of a column in a fixed order: over tm by shuffles, then the
  // four warp rows through shared memory (every copy has landed; the ring
  // is no longer read once all threads pass the barrier)
  __device__ __forceinline__ void finish(float* ring, const ResLane& t) {
    constexpr int C = 2 * D;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[q][j] += __shfl_xor_sync(kFull, s[q][j], 8);
        s[q][j] += __shfl_xor_sync(kFull, s[q][j], 16);
      }
    cp_async_wait<0>();
    __syncthreads();
    float* red = ring;                  // [4 wm][2][128]
    if (t.tm == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(t.wm * 2 + q) * kResCols + t.col(j)] = s[q][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * kResCols; e += kResThreads) {
      const int q = e / kResCols, c = e - q * kResCols;
      const float* r = red + q * kResCols + c;
      partial[(static_cast<size_t>(blockIdx.y) * 2 + q) * C + col0 + c] =
          ((r[0] + r[2 * kResCols]) + r[4 * kResCols]) + r[6 * kResCols];
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kResThreads, 1)
tl_h1_kernel(const T* __restrict__ x, const float* __restrict__ msg,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const uint8_t* __restrict__ rowmask, T* __restrict__ h1,
             float* __restrict__ partial, int R, int rows_per_block) {
  static_assert(2 * D == 2 * kResCols, "two column halves of 128");
  extern __shared__ __align__(16) float smem[];
  const int r_begin = blockIdx.y * rows_per_block;
  H1Tile<T, D> tile(x, msg, b1, rowmask, h1, partial, blockIdx.x * kResCols);
  resident_product<T, D>(tile, w1, 2 * D, tile.col0, r_begin,
                         min(R, r_begin + rows_per_block), smem);
}

// The general form: 64 x 64 tiles of tile_product (4 x 4 a thread, w1 read
// a tile at a time), row block blockIdx.y of the same plan walking its
// 64-row tiles, the sums in registers over them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tl_h1_tiled_kernel(const T* __restrict__ x, const float* __restrict__ msg,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const uint8_t* __restrict__ rowmask, T* __restrict__ h1,
                   float* __restrict__ partial, int D, int R, int rows_per_block) {
  const int C = 2 * D, col0 = blockIdx.x * BN;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[2][4] = {};
  for (int row0 = r_begin; row0 < r_end; row0 += BM) {
    float acc[4][4] = {};
    tile_product(acc, CatLoad<T>{x, msg, D, D}, w1, 2 * D, C, r_end, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row >= r_end) continue;
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
  }
  write_column_partials<2>(s, partial, C, col0);
}

// ---- tl_fwd2_kernel: y = x + relu(h1 * a + c) @ w2 + b2 ----
//
// h1 [R, 2D], w2 [2D, D], x and y [R, D]; a and c [2D] are the BatchNorm
// affine of the batch statistics.
//
// Design: the resident product over A = u = relu(h1 * a + c), w2 [2D][D]
// all resident (128 KB at D = 128: one column block), the same plan shape
// as h1 (fwd2_plan: whole 128-row tiles, one block an SM). a and c go into
// shared memory once a launch; u is formed once per staged value of h1 by
// ReluAffineLoad's expression, fmaxf(h * a + c, 0). A tile's 16 vectors of
// x are loaded into registers before its last stage's product, under it;
// the epilogue writes y = x + (acc + b2) as 16-byte vectors (8 bytes in
// bf16).
// What bounds it on the H100: the f32 FMA pipe (R = 32768, D = 128: 2.15
// GFLOP, 0.032 ms at 67 TFLOP/s, against 0.020 ms for h1 and x in and y
// out). Other widths and unaligned operands run tl_fwd2_tiled_kernel (64 x
// 64 tiles of tile_product with the affine and the ReLU on the A load, w2
// read a tile at a time) under the same plan.
template <typename T, int D>
struct Fwd2Tile {
  static constexpr int kSplit = 2 * D, kTa = 2 * D, kFa = 0;   // all of A from h1
  static constexpr bool kPrologue = true;
  // four values of x as they lie in memory
  using Raw = std::conditional_t<sizeof(T) == sizeof(float), float4, uint2>;
  const T* ta;
  const float* fa = nullptr;
  const T* x;
  const float* a;
  const float* c;
  const float* b2;
  T* y;
  const float* av = nullptr;         // a and c in shared memory
  const float* cv = nullptr;
  float bias[8];
  Raw xr[8][2];
  __device__ __forceinline__ Fwd2Tile(const T* h1, const T* x_, const float* a_,
                                      const float* c_, const float* b2_, T* y_)
      : ta(h1), x(x_), a(a_), c(c_), b2(b2_), y(y_) {}
  __device__ __forceinline__ void setup(float* extra, const ResLane& t) {
    for (int e = threadIdx.x; e < 2 * D; e += kResThreads) {
      extra[e] = a[e];
      extra[2 * D + e] = c[e];
    }
    av = extra;
    cv = extra + 2 * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[j] = b2[t.col(j)];
  }
  __device__ __forceinline__ float4 prologue(float4 h, int kc) const {
    const float4 s = load4(av + kc), o = load4(cv + kc);
    return make_float4(fmaxf(h.x * s.x + o.x, 0.f), fmaxf(h.y * s.y + o.y, 0.f),
                       fmaxf(h.z * s.z + o.z, 0.f), fmaxf(h.w * s.w + o.w, 0.f));
  }
  // the tile's x, under its last stage's product
  __device__ __forceinline__ void before_last(int row0, int r_end, const ResLane& t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + t.row(i);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        xr[i][half] = row < r_end ? *reinterpret_cast<const Raw*>(
                                        x + static_cast<size_t>(row) * D + t.col4(half))
                                  : Raw{};
    }
  }
  __device__ __forceinline__ void epilogue(const float (&acc)[8][8], int row0, int r_end,
                                           const ResLane& t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + t.row(i);
      if (row >= r_end) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 xv = as_float4(xr[i][half]);
        const float* b = bias + half * 4;
        const float* s = acc[i] + half * 4;
        store4_global(y + static_cast<size_t>(row) * D + t.col4(half),
                      make_float4(xv.x + (s[0] + b[0]), xv.y + (s[1] + b[1]),
                                  xv.z + (s[2] + b[2]), xv.w + (s[3] + b[3])));
      }
    }
  }
  __device__ __forceinline__ void finish(float*, const ResLane&) {}
};

template <typename T, int D>
__global__ void __launch_bounds__(kResThreads, 1)
tl_fwd2_kernel(const T* __restrict__ x, const T* __restrict__ h1,
               const float* __restrict__ a, const float* __restrict__ c,
               const float* __restrict__ w2, const float* __restrict__ b2,
               T* __restrict__ y, int R, int rows_per_block) {
  static_assert(D == kResCols, "w2's columns in one block");
  extern __shared__ __align__(16) float smem[];
  const int r_begin = blockIdx.y * rows_per_block;
  Fwd2Tile<T, D> tile(h1, x, a, c, b2, y);
  resident_product<T, D>(tile, w2, D, 0, r_begin, min(R, r_begin + rows_per_block), smem);
}

// The general form: 64 x 64 tiles of tile_product with the affine and the
// ReLU applied as the A tile is loaded, row block blockIdx.y of the same
// plan walking its 64-row tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tl_fwd2_tiled_kernel(const T* __restrict__ x, const T* __restrict__ h1,
                     const float* __restrict__ a, const float* __restrict__ c,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     T* __restrict__ y, int R, int K, int C, int rows_per_block) {
  const int col0 = blockIdx.x * BN;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int row0 = r_begin; row0 < r_end; row0 += BM) {
    float acc[4][4] = {};
    tile_product(acc, ReluAffineLoad<T>{h1, a, c, K}, w2, K, C, r_end, row0, col0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row >= r_end) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + tx * 4 + j;
        if (col >= C) continue;
        const size_t o = static_cast<size_t>(row) * C + col;
        y[o] = from_f32<T>(to_f32(x[o]) + (acc[i][j] + b2[col]));
      }
    }
  }
}

// ---- tl_dh2_kernel: dh2 = g @ w2^T and what the BN backward takes from it ----
//
// dh2 [R, 2D] = g [R, D] @ w2^T (w2 [2D, D]), tile by tile, never stored.
// SUMS: partial [blocks][4][2D] gets the block's column sums of G, G * hhat,
// dbn * hhat and dbn over every row < R, padded ones included, where dbn =
// dh2 * (bn > 0) and G = dbn * scale (vec rows 0-3: mean, inv, scale,
// bias). Otherwise out [R, 2D] gets dh1 = inv * (G - (c1 + hhat * c2) *
// rowmask), vec rows 4 = c1, 5 = c2.
//
// Design. At D = 128 w2 is 128 KB: it stays in shared memory for the whole
// launch. The grid is persistent, one block an SM (the plan, ops/cuda/
// train_layer.py::dh2_plan, gives block z the rows [z * rows_per_block,
// (z + 1) * rows_per_block), a whole number of 64-row tiles); a block walks
// its row tiles with the g rows of the next tile in flight by 16-byte
// cp.async (two stages, 33 KB each) and the h1 lines of the current tile
// prefetched into L2 under the product. A tile is 64 rows x 256 columns, a
// thread an 8 x 8 register tile (rows_by_wt_product: 16 FMAs a 16-byte
// shared load, as gemm_kernel's W^T mode). The epilogue rebuilds hhat, the
// BN output and the ReLU mask from h1 (each element read once, 32-byte runs,
// a thread's 64 loads issued before any is used) and either adds the four
// sums in registers over the block's rows (then over the warp's four row
// lanes by shuffles and the two warp rows through shared memory, a fixed
// order) or writes dh1. Every dh2 element is one
// fmaf chain over k ascending from 0 in both instantiations, so the two
// launches of a layer form the same dh2 bits and the same ReLU mask.
// The resident form is compiled for D = 128 (its strides and trip counts
// constants); other widths and unaligned g or w2 run tl_dh2_chunked_kernel:
// the same tiles and product over K in chunks of 32 staged element by
// element, column tiles of 256, w2 re-read per tile.
// What bounds it on the H100: the f32 FMA pipe (R = 32768, D = 128: 2.15
// GFLOP, 0.032 ms at 67 TFLOP/s, against 0.015 ms for g and h1 in and 0.025
// with dh1 out).
constexpr int kDhRows = 64;       // rows of g a tile
constexpr int kDhCols = 256;      // columns of dh2 a tile: all of 2D at D = 128
constexpr int kDhThreads = 256;   // 2 x 4 warps of 32 rows x 64 columns
constexpr int kDhChunk = 32;      // depth of a step of the chunked form
constexpr int kDhVecs = 6;        // vec rows staged: mean, inv, scale, bias, c1, c2

constexpr int kDhWidth = 128;     // D of the resident form
// floats of shared memory of the resident form: w2 [256][D + 4], two g
// tiles [64][D + 4], vec [6][256] (209 KB at D = 128)
constexpr size_t kDhSmem =
    sizeof(float) * ((kDhCols + 2 * kDhRows) * (kDhWidth + 4) + kDhVecs * kDhCols);
// the chunked form: a g chunk [64][36], a w2 chunk [256][36], vec [6][256]
constexpr size_t kDhChunkSmem =
    sizeof(float) * ((kDhRows + kDhCols) * (kDhChunk + 4) + kDhVecs * kDhCols);

// acc[i][j] += sum over k < klen of a[r_i][k] * w[c_j][k], k ascending (one
// fmaf chain per element, continued from call to call), with r_i = wm * 32 +
// i * 4 + tm and c_j = wn * 64 + j * 8 + tn for lane = tm * 8 + tn and warp
// = wm * 4 + wn. a [64][lda] and w [256][ldw] lie in shared memory
// k-contiguous, klen a multiple of four. Per four k a thread reads eight
// 16-byte vectors of a (four addresses a warp, broadcast) and eight of w
// (one 128-byte run a warp) for 256 FMAs; strides of 4 mod 32 floats keep
// both conflict-free.
__device__ __forceinline__ void rows_by_wt_product(float (&acc)[8][8],
                                                   const float* __restrict__ a, int lda,
                                                   const float* __restrict__ w, int ldw,
                                                   int klen) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ap = a + ((warp >> 2) * 32 + (lane >> 3)) * lda;
  const float* wp = w + ((warp & 3) * 64 + (lane & 7)) * ldw;
#pragma unroll 2
  for (int k4 = 0; k4 < klen; k4 += 4) {
    float av[8][4], bv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(av[i]) =
          *reinterpret_cast<const float4*>(ap + i * 4 * lda + k4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(bv[j]) =
          *reinterpret_cast<const float4*>(wp + j * 8 * ldw + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
  }
}

// The BN backward's epilogue of one tile (rows row0.., columns col0..;
// this thread's 8 x 8 of dh2 in acc). V: the vec rows in shared memory at a
// stride of kDhCols, column 0 standing for col0. SUMS: s[q][j] gets this
// thread's rows' G, G * hhat, dbn * hhat, dbn of column c_j; else dh1 goes
// to out.
template <typename T, bool SUMS>
__device__ __forceinline__ void dh2_epilogue(const float (&acc)[8][8], float (&s)[4][8],
                                             const T* __restrict__ h1, const float* V,
                                             const uint8_t* __restrict__ rowmask,
                                             float* __restrict__ out, int row0,
                                             int r_end, int col0, int C2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt = row0 + (warp >> 2) * 32 + (lane >> 3);
  const int ct = col0 + (warp & 3) * 64 + (lane & 7);
  // every h1 value of the thread's 8 x 8 first: 64 loads in flight, the
  // tile's latency paid once
  float h[8][8];
  bool valid[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = rt + i * 4;
    valid[i] = SUMS || rowmask == nullptr || (row < r_end && rowmask[row]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = ct + j * 8;
      h[i][j] = (row < r_end && col < C2)
                    ? to_f32(h1[static_cast<size_t>(row) * C2 + col]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cl = ct - col0 + j * 8, col = ct + j * 8;
    if (col >= C2) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = rt + i * 4;
      if (row >= r_end) continue;
      const BnRebuild r(h[i][j], V, kDhCols, cl);
      const float dbn = r.bn > 0.f ? acc[i][j] : 0.f;
      const float G = dbn * V[2 * kDhCols + cl];
      if constexpr (SUMS) {
        s[0][j] += G;
        s[1][j] += G * r.hhat;
        s[2][j] += dbn * r.hhat;
        s[3][j] += dbn;
      } else {
        const float corr =
            valid[i] ? V[4 * kDhCols + cl] + r.hhat * V[5 * kDhCols + cl] : 0.f;
        out[static_cast<size_t>(row) * C2 + col] = V[kDhCols + cl] * (G - corr);
      }
    }
  }
}

// vec rows (4 for SUMS, 6 otherwise) of columns col0.. into V [6][256],
// zeros past C2
template <bool SUMS>
__device__ __forceinline__ void stage_vec(float* V, const float* __restrict__ vec,
                                          int col0, int C2) {
  for (int e = threadIdx.x; e < kDhVecs * kDhCols; e += kDhThreads) {
    const int vr = e / kDhCols, col = col0 + e - vr * kDhCols;
    V[e] = (col < C2 && (!SUMS || vr < 4)) ? vec[vr * C2 + col] : 0.f;
  }
}

// partial[blockIdx.x][q][col0 + c] = the block's sums: s over the four row
// lanes of a warp (shuffles), then warp row 0 + warp row 1 (red [2][4][256],
// shared memory no longer read). Ends on a block barrier.
__device__ __forceinline__ void dh2_write_sums(float (&s)[4][8], float* red,
                                               float* __restrict__ partial,
                                               int col0, int C2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[q][j] += __shfl_xor_sync(kFull, s[q][j], 8);
      s[q][j] += __shfl_xor_sync(kFull, s[q][j], 16);
    }
  __syncthreads();
  if ((lane >> 3) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[((warp >> 2) * 4 + q) * kDhCols + (warp & 3) * 64 + j * 8 + lane] = s[q][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 4 * kDhCols; e += kDhThreads) {
    const int q = e / kDhCols, c = e - q * kDhCols;
    if (col0 + c < C2)
      partial[(static_cast<size_t>(blockIdx.x) * 4 + q) * C2 + col0 + c] =
          red[e] + red[4 * kDhCols + e];
  }
  __syncthreads();
}

// the h1 lines of rows [row0, row_end) into L2 ahead of the epilogue
template <typename T>
__device__ __forceinline__ void prefetch_rows_l2(const T* h1, int row0, int row_end,
                                                 int C2) {
  const char* base = reinterpret_cast<const char*>(h1 + static_cast<size_t>(row0) * C2);
  const size_t bytes = static_cast<size_t>(row_end - row0) * C2 * sizeof(T);
  for (size_t at = static_cast<size_t>(threadIdx.x) * 128; at < bytes;
       at += static_cast<size_t>(kDhThreads) * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(base + at));
}

// The resident form: w2 [2D][D] in shared memory for the launch. D is a
// compile-time width (the model's 128), so that strides and trip counts
// are constants (with D read at run time the kernel ran slower, PERF.md).
template <typename T, bool SUMS, int D>
__global__ void __launch_bounds__(kDhThreads, 1)
tl_dh2_kernel(const T* __restrict__ g, const T* __restrict__ h1,
              const float* __restrict__ w2, const float* __restrict__ vec,
              const uint8_t* __restrict__ rowmask, float* __restrict__ out,
              int R, int rows_per_block) {
  static_assert(D % 4 == 0 && 2 * D <= kDhCols, "the resident form's width");
  extern __shared__ __align__(16) float smem[];
  constexpr int C2 = 2 * D, ld = D + 4, kq = D / 4;
  float* Ws = smem;                          // [256][ld], rows past C2 zero
  float* Gs = Ws + kDhCols * ld;             // [2][64][ld]
  float* Vs = Gs + 2 * kDhRows * ld;         // [6][256]
  const int tid = threadIdx.x;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  const int tiles = (r_end - r_begin + kDhRows - 1) / kDhRows;

  for (int e = tid; e < kDhCols * kq; e += kDhThreads) {
    const int c = e / kq, q = (e - c * kq) * 4;
    const bool ok = c < C2;
    cp_async16(Ws + c * ld + q, ok ? w2 + static_cast<size_t>(c) * D + q : w2, ok ? 16 : 0);
  }
  stage_vec<SUMS>(Vs, vec, 0, C2);
  auto stage = [&](int t, int buf) {         // the g rows of tile t
    float* dst = Gs + buf * kDhRows * ld;
    const int row0 = r_begin + t * kDhRows;
    for (int e = tid; e < kDhRows * kq; e += kDhThreads) {
      const int rr = e / kq, q = (e - rr * kq) * 4;
      const bool ok = row0 + rr < r_end;
      stage4(dst + rr * ld + q, g + static_cast<size_t>(ok ? row0 + rr : 0) * D + q, ok);
    }
  };
  stage(0, 0);
  cp_async_commit();

  float s[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[q][j] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<0>();      // tile t (and w2) have landed ...
    __syncthreads();         // ... for every thread; tile t - 1 is read
    if (t + 1 < tiles) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int row0 = r_begin + t * kDhRows;
    prefetch_rows_l2(h1, row0, min(r_end, row0 + kDhRows), C2);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    rows_by_wt_product(acc, Gs + (t & 1) * kDhRows * ld, ld, Ws, ld, D);
    dh2_epilogue<T, SUMS>(acc, s, h1, Vs, rowmask, out, row0, r_end, 0, C2);
  }
  if constexpr (SUMS) dh2_write_sums(s, Gs, out, 0, C2);
}

// The chunked form, for every other shape: column tiles of 256, K in chunks
// of 32 staged element by element (zeros past R, 2D and D).
template <typename T, bool SUMS>
__global__ void __launch_bounds__(kDhThreads, 1)
tl_dh2_chunked_kernel(const T* __restrict__ g, const T* __restrict__ h1,
                      const float* __restrict__ w2, const float* __restrict__ vec,
                      const uint8_t* __restrict__ rowmask, float* __restrict__ out,
                      int D, int R, int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = kDhChunk + 4;
  float* As = smem;                          // [64][ld]
  float* Ws = As + kDhRows * ld;             // [256][ld]
  float* Vs = Ws + kDhCols * ld;             // [6][256]
  const int C2 = 2 * D, tid = threadIdx.x;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(R, r_begin + rows_per_block);
  for (int col0 = 0; col0 < C2; col0 += kDhCols) {
    __syncthreads();                         // Vs of the last column tile is read
    stage_vec<SUMS>(Vs, vec, col0, C2);
    float s[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[q][j] = 0.f;
    for (int row0 = r_begin; row0 < r_end; row0 += kDhRows) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < D; k0 += kDhChunk) {
        __syncthreads();                     // the last chunk is read
        for (int e = tid; e < kDhRows * kDhChunk; e += kDhThreads) {
          const int rr = e / kDhChunk, kk = e - rr * kDhChunk;
          const int row = row0 + rr, k = k0 + kk;
          As[rr * ld + kk] =
              (row < r_end && k < D) ? to_f32(g[static_cast<size_t>(row) * D + k]) : 0.f;
        }
        for (int e = tid; e < kDhCols * kDhChunk; e += kDhThreads) {
          const int c = e / kDhChunk, kk = e - c * kDhChunk;
          const int col = col0 + c, k = k0 + kk;
          Ws[c * ld + kk] = (col < C2 && k < D) ? w2[static_cast<size_t>(col) * D + k] : 0.f;
        }
        __syncthreads();
        rows_by_wt_product(acc, As, ld, Ws, ld, kDhChunk);
      }
      dh2_epilogue<T, SUMS>(acc, s, h1, Vs, rowmask, out, row0, r_end, col0, C2);
    }
    if constexpr (SUMS) dh2_write_sums(s, As, out, col0, C2);
  }
}

// ---- tl_dw2_kernel: dw2 = relu(bn(h1))^T g and db2 = column sums of g ----
//
// partial[z][k][c] = sum over the rows r of split z of u[r][k] * g[r][c]
// (k < 2D), u = relu(bn(h1)) rebuilt from vec rows 0-3 (mean, inv, scale,
// bias); partial[z][2D][c] = sum over those rows of g[r][c]. Every row,
// padded ones included.
//
// Design: gemm_tn_kernel's split product (tn_product.cuh: 128 x 128 output
// tiles, two at D = 128; rows split by ops/cuda/train_layer.py::dw2_plan,
// about one block an SM; a four-stage cp.async ring of 32-row stages of h1
// and g as they lie in HBM; 8 x 8 register tiles) with u formed once per
// staged value of h1 by BnReluColumns (BnRebuild's expression, the one the
// dh2 kernel's ReLU mask comes from): not three operations on every register
// read. partial_reduce_kernel then adds the splits in ascending order.
// What bounds it on the H100: the f32 FMA pipe (R = 32768, D = 128: 2.15
// GFLOP, 0.032 ms at 67 TFLOP/s, against 0.015 ms for h1 and g in).

// u = relu(bn(h)) of the four h1 columns col .. col + 3 a lane stages, their
// mean, inv, scale and bias in registers (zeros past C, where no u is read)
struct BnReluColumns {
  static constexpr bool kIdentity = false;
  float mean[4], inv[4], scale[4], bias[4];
  __device__ __forceinline__ BnReluColumns(const float* __restrict__ vec, int C, int col) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = col + i < C;
      mean[i] = ok ? vec[col + i] : 0.f;
      inv[i] = ok ? vec[C + col + i] : 0.f;
      scale[i] = ok ? vec[2 * C + col + i] : 0.f;
      bias[i] = ok ? vec[3 * C + col + i] : 0.f;
    }
  }
  __device__ __forceinline__ float operator()(float h, int i) const {
    return fmaxf(BnRebuild(h, mean[i], inv[i], scale[i], bias[i]).bn, 0.f);
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kTnThreads, 1)
tl_dw2_kernel(const T* __restrict__ h1, const float* __restrict__ vec,
              const T* __restrict__ g, float* __restrict__ partial, int R,
              int K1, int C, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  tn_split_product<T, VEC>(h1, g, partial, R, K1, C, rows_per_split,
                           BnReluColumns(vec, K1, tn_lane_column()), smem);
}

inline cudaError_t reduce_partials(const float* partial, float* out, int P,
                                   int total, cudaStream_t stream) {
  partial_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, out, P, total);
  return cudaGetLastError();
}

// row block z of a launch takes rows [z * rows_per_block, min(R, (z + 1) *
// rows_per_block)): every row once, no block empty, whole tiles of `tile`
inline bool row_plan_ok(int R, int rows_per_block, int blocks, int tile) {
  return rows_per_block > 0 && rows_per_block % tile == 0 && blocks > 0 &&
         blocks <= 65535 && static_cast<long long>(rows_per_block) * blocks >= R &&
         static_cast<long long>(rows_per_block) * (blocks - 1) < R;
}

template <typename T>
cudaError_t launch_h1(const void* x, const float* msg, const float* w1,
                      const float* b1, const uint8_t* rowmask, void* h1,
                      float* partial, float* sums, int D, int R,
                      int rows_per_block, int blocks, cudaStream_t stream) {
  const int C = 2 * D;
  const auto* xt = static_cast<const T*>(x);
  auto* ht = static_cast<T*>(h1);
  cudaError_t err;
  static_assert(kResSmem <= kMaxSmem, "the resident form must fit an SM");
  if (D == kResWidth && aligned_to(x, 4 * sizeof(T)) && aligned_to(msg, 16) &&
      aligned_to(w1, 16) && aligned_to(h1, 4 * sizeof(T))) {
    static SmemCap cap;
    err = allow_smem(tl_h1_kernel<T, kResWidth>, kResSmem, cap);
    if (err != cudaSuccess) return err;
    tl_h1_kernel<T, kResWidth><<<dim3(C / kResCols, blocks), kResThreads, kResSmem, stream>>>(
        xt, msg, w1, b1, rowmask, ht, partial, R, rows_per_block);
  } else {
    tl_h1_tiled_kernel<T><<<dim3((C + BN - 1) / BN, blocks), kThreads, 0, stream>>>(
        xt, msg, w1, b1, rowmask, ht, partial, D, R, rows_per_block);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, sums, blocks, 2 * C, stream);
}

template <typename T>
cudaError_t launch_fwd2(const void* x, const void* h1, const float* a,
                        const float* c, const float* w2, const float* b2,
                        void* y, int D, int R, int rows_per_block, int blocks,
                        cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* ht = static_cast<const T*>(h1);
  auto* yt = static_cast<T*>(y);
  static_assert(kFwd2Smem <= kMaxSmem, "the resident form must fit an SM");
  if (D == kResWidth && aligned_to(x, 4 * sizeof(T)) && aligned_to(h1, 4 * sizeof(T)) &&
      aligned_to(w2, 16) && aligned_to(y, 4 * sizeof(T))) {
    static SmemCap cap;
    cudaError_t err = allow_smem(tl_fwd2_kernel<T, kResWidth>, kFwd2Smem, cap);
    if (err != cudaSuccess) return err;
    tl_fwd2_kernel<T, kResWidth><<<dim3(1, blocks), kResThreads, kFwd2Smem, stream>>>(
        xt, ht, a, c, w2, b2, yt, R, rows_per_block);
  } else {
    tl_fwd2_tiled_kernel<T><<<dim3((D + BN - 1) / BN, blocks), kThreads, 0, stream>>>(
        xt, ht, a, c, w2, b2, yt, R, 2 * D, D, rows_per_block);
  }
  return cudaGetLastError();
}

template <typename T, bool SUMS>
cudaError_t launch_dh2(const void* g, const void* h1, const float* w2,
                       const float* vec, const uint8_t* rowmask, float* out,
                       int D, int R, int rows_per_block, int blocks,
                       cudaStream_t stream) {
  const auto* gt = static_cast<const T*>(g);
  const auto* ht = static_cast<const T*>(h1);
  cudaError_t err;
  static_assert(kDhSmem <= kMaxSmem, "the resident form must fit an SM");
  if (D == kDhWidth && aligned_to(g, 4 * sizeof(T)) && aligned_to(w2, 16)) {
    static SmemCap cap;
    err = allow_smem(tl_dh2_kernel<T, SUMS, kDhWidth>, kDhSmem, cap);
    if (err != cudaSuccess) return err;
    tl_dh2_kernel<T, SUMS, kDhWidth><<<blocks, kDhThreads, kDhSmem, stream>>>(
        gt, ht, w2, vec, rowmask, out, R, rows_per_block);
  } else {
    static SmemCap cap;
    err = allow_smem(tl_dh2_chunked_kernel<T, SUMS>, kDhChunkSmem, cap);
    if (err != cudaSuccess) return err;
    tl_dh2_chunked_kernel<T, SUMS><<<blocks, kDhThreads, kDhChunkSmem, stream>>>(
        gt, ht, w2, vec, rowmask, out, D, R, rows_per_block);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_sums(const void* g, const void* h1, const float* w2,
                            const float* vec4, float* partial, float* sums,
                            int D, int R, int rows_per_block, int blocks,
                            cudaStream_t stream) {
  cudaError_t err = launch_dh2<T, true>(g, h1, w2, vec4, nullptr, partial, D, R,
                                        rows_per_block, blocks, stream);
  if (err != cudaSuccess) return err;
  return reduce_partials(partial, sums, blocks, 4 * 2 * D, stream);
}

template <typename T>
cudaError_t launch_dw2(const void* h1, const float* vec4, const void* g,
                       float* partial, float* out, int R, int D,
                       int rows_per_split, int splits, cudaStream_t stream) {
  const int K1 = 2 * D, C = D;
  const auto* ht = static_cast<const T*>(h1);
  const auto* gt = static_cast<const T*>(g);
  dim3 grid((C + kTnTile - 1) / kTnTile, (K1 + kTnTile - 1) / kTnTile, splits);
  cudaError_t err;
  static_assert(kTnSmem <= kMaxSmem, "the ring must fit an SM");
  if (D % 4 == 0 && aligned_to(h1, 4 * sizeof(T)) && aligned_to(g, 4 * sizeof(T)) &&
      aligned_to(partial, 16)) {
    static SmemCap cap;
    err = allow_smem(tl_dw2_kernel<T, true>, kTnSmem, cap);
    if (err != cudaSuccess) return err;
    tl_dw2_kernel<T, true><<<grid, kTnThreads, kTnSmem, stream>>>(
        ht, vec4, gt, partial, R, K1, C, rows_per_split);
  } else {
    static SmemCap cap;
    err = allow_smem(tl_dw2_kernel<T, false>, kTnSmem, cap);
    if (err != cudaSuccess) return err;
    tl_dw2_kernel<T, false><<<grid, kTnThreads, kTnSmem, stream>>>(
        ht, vec4, gt, partial, R, K1, C, rows_per_split);
  }
  err = cudaGetLastError();
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
// sums [2][2D] = masked column sums of the f32 h1 and of its square. The row
// plan (ops/cuda/train_layer.py::h1_plan) gives row block z the rows [z *
// rows_per_block, min(R, (z + 1) * rows_per_block)), whole 128-row tiles; it
// must cover every row once with no block empty. partial is scratch of
// partial_floats = blocks * 2 * 2D floats.
extern "C" cudaError_t mdgat_tl_h1(const void* x, const void* msg,
                                   const void* w1, const void* b1,
                                   const void* rowmask, void* h1,
                                   void* partial, long long partial_floats,
                                   void* sums, int D, int R, int rows_per_block,
                                   int blocks, int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || !row_plan_ok(R, rows_per_block, blocks, kResRows) ||
      partial_floats != static_cast<long long>(blocks) * 2 * 2 * D)
    return cudaErrorInvalidValue;
  const auto* m = static_cast<const float*>(msg);
  const auto* w = static_cast<const float*>(w1);
  const auto* b = static_cast<const float*>(b1);
  const auto* rm = static_cast<const uint8_t*>(rowmask);
  auto* p = static_cast<float*>(partial);
  auto* s = static_cast<float*>(sums);
  if (io_dtype == kF32)
    return launch_h1<float>(x, m, w, b, rm, h1, p, s, D, R, rows_per_block, blocks,
                            stream);
  if (io_dtype == kBF16)
    return launch_h1<__nv_bfloat16>(x, m, w, b, rm, h1, p, s, D, R, rows_per_block,
                                    blocks, stream);
  return cudaErrorInvalidValue;
}

// y [R, D] = x + relu(h1 [R, 2D] * a + c) @ w2 [2D, D] + b2. The row plan
// (ops/cuda/train_layer.py::fwd2_plan) gives row block z the rows [z *
// rows_per_block, min(R, (z + 1) * rows_per_block)), whole 128-row tiles; it
// must cover every row once with no block empty.
extern "C" cudaError_t mdgat_tl_fwd2(const void* x, const void* h1,
                                     const void* a, const void* c,
                                     const void* w2, const void* b2, void* y,
                                     int D, int R, int rows_per_block, int blocks,
                                     int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || !row_plan_ok(R, rows_per_block, blocks, kResRows))
    return cudaErrorInvalidValue;
  const auto* af = static_cast<const float*>(a);
  const auto* cf = static_cast<const float*>(c);
  const auto* w = static_cast<const float*>(w2);
  const auto* b = static_cast<const float*>(b2);
  if (io_dtype == kF32)
    return launch_fwd2<float>(x, h1, af, cf, w, b, y, D, R, rows_per_block, blocks,
                              stream);
  if (io_dtype == kBF16)
    return launch_fwd2<__nv_bfloat16>(x, h1, af, cf, w, b, y, D, R, rows_per_block,
                                      blocks, stream);
  return cudaErrorInvalidValue;
}

// sums [4][2D] = (Sg, Sgh, dscale, dbias) over all R rows, from g [R, D],
// h1 [R, 2D], w2 [2D, D] and vec4 [4][2D] (mean, inv, scale, bias). The row
// plan (ops/cuda/train_layer.py::dh2_plan) gives block z the rows [z *
// rows_per_block, min(R, (z + 1) * rows_per_block)); it must cover every
// row once with no block empty. partial is scratch of partial_floats =
// blocks * 4 * 2D floats.
extern "C" cudaError_t mdgat_tl_bwd_sums(const void* g, const void* h1,
                                         const void* w2, const void* vec4,
                                         void* partial, long long partial_floats,
                                         void* sums, int D, int R,
                                         int rows_per_block, int blocks,
                                         int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || !row_plan_ok(R, rows_per_block, blocks, kDhRows) ||
      partial_floats != static_cast<long long>(blocks) * 4 * 2 * D)
    return cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(w2);
  const auto* v = static_cast<const float*>(vec4);
  auto* p = static_cast<float*>(partial);
  auto* s = static_cast<float*>(sums);
  if (io_dtype == kF32)
    return launch_bwd_sums<float>(g, h1, w, v, p, s, D, R, rows_per_block, blocks, stream);
  if (io_dtype == kBF16)
    return launch_bwd_sums<__nv_bfloat16>(g, h1, w, v, p, s, D, R, rows_per_block,
                                          blocks, stream);
  return cudaErrorInvalidValue;
}

// out [2D + 1][D]: rows < 2D are dw2 = relu(bn(h1))^T g, row 2D is db2 =
// column sums of g, over all R rows of h1 [R, 2D] and g [R, D], vec4 [4][2D]
// (mean, inv, scale, bias). The split plan (ops/cuda/train_layer.py::
// dw2_plan) gives split z the rows [z * rows_per_split, min(R, (z + 1) *
// rows_per_split)), whole 32-row stages; it must cover every row once with
// no split empty. partial is scratch of partial_floats = splits * (2D + 1) *
// D floats.
extern "C" cudaError_t mdgat_tl_dw2(const void* h1, const void* vec4,
                                    const void* g, void* partial,
                                    long long partial_floats, void* out, int D,
                                    int R, int rows_per_split, int splits,
                                    int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || !row_plan_ok(R, rows_per_split, splits, kTnRows) ||
      partial_floats != static_cast<long long>(splits) * (2 * D + 1) * D)
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
// Sg / cnt, Sgh / cnt) and the row mask, under the row plan of
// mdgat_tl_bwd_sums.
extern "C" cudaError_t mdgat_tl_dh1(const void* g, const void* h1,
                                    const void* w2, const void* vec6,
                                    const void* rowmask, void* dh1, int D,
                                    int R, int rows_per_block, int blocks,
                                    int io_dtype, cudaStream_t stream) {
  using namespace mdgat;
  if (D <= 0 || R <= 0 || !row_plan_ok(R, rows_per_block, blocks, kDhRows))
    return cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(w2);
  const auto* v = static_cast<const float*>(vec6);
  const auto* rm = static_cast<const uint8_t*>(rowmask);
  auto* o = static_cast<float*>(dh1);
  if (io_dtype == kF32)
    return launch_dh2<float, false>(g, h1, w, v, rm, o, D, R, rows_per_block, blocks, stream);
  if (io_dtype == kBF16)
    return launch_dh2<__nv_bfloat16, false>(g, h1, w, v, rm, o, D, R, rows_per_block,
                                            blocks, stream);
  return cudaErrorInvalidValue;
}
