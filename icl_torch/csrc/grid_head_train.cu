// Training grid head with dropout, and with the cross-entropy fused in, f32,
// for Hopper (sm_90a):
//
//     hd[g, a, b, k]  = dropout(relu(X[g, a, k] + b1[k] + Y[g, b, k]))
//     out[g, a, b, :] = hd[g, a, b, :] . W2 + b2
//
// Replaces the Pallas kernels of icl/ops/grid_head_train.py:
//   K5 _fwd_pallas (_fwd_kernel)               -> icl_ght_fwd_f32
//   K6 _bwd_pallas (_bwd_kernel)               -> icl_ght_bwd_f32
//   K7 _fwd_loss_pallas (_fwd_loss_flat_kernel, _fwd_loss_kernel)
//                                              -> icl_ght_loss_fwd_f32
//   K8 _bwd_loss_pallas (_bwd_loss_flat_kernel, _bwd_loss_kernel)
//                                              -> icl_ght_loss_bwd_f32
// and, each its own instantiation, their exact=False mode (the reference's
// default training precision: Precision.DEFAULT in _dot_precision and the
// head dots) -> icl_ght_{fwd,bwd,loss_fwd,loss_bwd}_onepass.
// The TPU's flat/tiled split, its transposed [O, N] CE layout and its
// VPU-vs-MXU dot choices existed for 128-lane vregs and Mosaic's limits;
// here one design covers every shape.
//
// Dropout.  The keep bit of element (g, a, b, k) is a pure function of
// (seeds[g], a, b, k):
//     bits = hash32(hash32(hash32(hash32(seed) ^ a) ^ b) ^ k),  keep iff
//     bits >= thr = round(rate * 2^32)
// (icl_torch/ops/grid_head_train.py computes the same in int64), and kept
// elements are scaled by `scale` = float32(1 / (1 - rate)).  No tile or
// block enters it, so every kernel here, the plain version and the
// pair-form gather see the same mask.  thr == 0 means no dropout.
//
// Design.
//  * Forward family (K5, K7, and the first half of K8): the tile routine
//    of grid_head_tile.cuh, shared with grid_head.cu, with the dropout hash
//    on: a warp owns a 4 x 4 register tile of cells, its lanes split K in
//    16-byte chunks, a transpose-reduce leaves every lane with one cell's O
//    logits, and the epilogue runs one cell a lane.  K5 stores them; K7
//    turns them into the cell's CE terms (max shift, first-max argmax),
//    sums them over the warp by a fixed butterfly and over the block's
//    warps in order into [blocks, 3] partials; K8's first kernel writes the
//    logit gradient g3 = (softmax - onehot) * w * gl, [G, A, B, O] (16 KB
//    per image at A = B = 32).  K7 and K8 skip cells of weight 0 under a
//    warp-uniform mask (their g3 is written as 0).  The [A, B, K]
//    activation never leaves the registers, and K7's logits never reach
//    device memory.
//  * Backward (K6, and the second half of K8): one block per (g, tile of
//    kBwdCols = 32 columns k), of kBwdSlices = 4 warps.  The image's cell
//    cotangents g3 [A, B, O] are put into shared memory once per block.
//    Thread (k, s) takes kBwdRows = 4 rows a of slice s (rows 4s .., then
//    4s + 16 .. where A > 16); its warp first lists the b's at which any
//    of the four rows' cells has a non-zero g3 and puts those cells' hash
//    keys hash32(hash32(hash32(seed) ^ a) ^ b) into shared memory, so an
//    element costs one hash, not three, and one or two broadcast loads.
//    The thread then walks the listed cells alone (in K8 the cells of
//    weight 0 carry no gradient): it recomputes z, the mask and hd;
//    dz = (g3 . W2[k, :]) * [z > 0] * keep * scale.
//    dX[a, k] is finished in that thread, in 4 independent sums over b;
//    the slices' partial dY[b, k], db1[k] and dW2[k, :] (two accumulators
//    each, even and odd rows) meet in shared memory and are added in the
//    order s = 0, 1, 2, 3.  A first design had one thread per (g, k) walk
//    all A * B cells in one chain at 134 registers (12 warps to an SM,
//    three hashes an element, g3 read from L2): latency-bound.
//  * The per-image (or per-row) partials are summed over rows by a second,
//    fixed-order pass.  No atomics anywhere: results repeat bit for bit.
//
// The one-pass mode (kOnePass).  Each operand of the three head
// contractions is rounded to bf16 (round to nearest even) and their exact
// products are summed in f32, as one bf16 pass of the TPU's matrix unit
// does: in the forward family the logit dot hd . W2, hd rounded after the
// dropout scale (the tile routine's kFastDot); in the backward kernel
// dh = g3 . W2[k, :] and dW2 += hd * g3, where W2[k, :] is rounded once as
// it is loaded, g3 once in shared memory after db2 has summed it, and hd
// as it is recomputed.  dz = dh * [z > 0] * keep * scale, dX, dY, db1 and
// db2 stay f32.  K8's first kernel writes g3 from the one-pass logits, so
// its softmax is the forward's.  It runs the f32 mode's FMAs plus a
// conversion an operand (no tensor cores: O = 2 or 4 would pad an mma's N
// to 8).  The forward kernels of the mode
// have their own __global__ with their own launch bounds, so ptxas gives
// them the registers the roundings need without touching the f32 kernels'
// allocation.
//
// What bounds it on the H100: at the relation shapes (G = 64, A = B <= 32,
// K = 800, O = 4) each call is a few microseconds of arithmetic spread
// over 448 to 2048 blocks; the hash (a dozen integer operations per
// element, on a pipe of half the f32 rate) costs more than the O-wide dot.
// At these sizes the launches and the reduction pass are a large share of
// the time.
#include "grid_head_tile.cuh"

namespace {

using namespace icl_head;

constexpr int kBwdCols = 32;     // backward: k columns per block (a warp)
constexpr int kBwdSlices = 4;    // backward: warps per block, slicing rows a
constexpr int kBwdRows = 4;      // backward: rows a per thread at a time
constexpr int kSumThreads = 128; // row-sum pass

enum Mode { kLogits = 0, kLoss = 1, kDLogits = 2 };

// kLogits: out = logits [G, A, B, O]
// kLoss:   out = per-block partials [blocks, 3] (sum ce*w, hits, valid)
// kDLogits: out = g3 [G, A, B, O] = (softmax - onehot) * w * gl[0]
// kOnePass: the logits of the one-pass bf16 dot (the note above).
template <int kMode, int kO, bool kExactO, int kV, bool kOnePass>
__device__ __forceinline__ void head_fwd(const HeadArgs& p) {
  __shared__ float red[kRedFloats];
  __shared__ float red3[kMaxWarps][3];
  float logit[kO];
  const TileCoords t = tile_coords<kO>(p);
  const int O = p.O;
  int lbl = 0;                          // asked for before the k loop
  float w = 1.f;
  if (kMode != kLogits && t.inside) {
    lbl = __ldg(p.labels + t.cell);
    w = __ldg(p.weights + t.cell);
  }
  const float gscale = kMode == kDLogits ? __ldg(p.gl) : 0.f;
  head_tile_logits<kO, kExactO, kV, true, kMode != kLogits, false, kOnePass>(
      p, t, red, logit);
  if (kMode == kLogits) {
    if (t.owner) store_cell<kO, kExactO>(p.out + t.cell * O, logit, O);
    return;
  }
  float part[3] = {0.f, 0.f, 0.f};
  if (t.inside) {
    float m = logit[0];
#pragma unroll
    for (int o = 1; o < kO; ++o)
      if (o < O) m = fmaxf(m, logit[o]);
    float se = 0.f, picked = 0.f;
    int best = O;                       // first-max argmax
#pragma unroll
    for (int o = 0; o < kO; ++o) {
      if (o < O) {
        const float sh = logit[o] - m;
        se += expf(sh);
        if (o == lbl) picked = sh;
        if (best == O && logit[o] == m) best = o;
      }
    }
    if (kMode == kLoss) {
      if (t.owner) {
        const bool valid = w > 0.f;
        part[0] = (logf(se) - picked) * w;
        part[1] = (valid && best == lbl) ? 1.f : 0.f;
        part[2] = valid ? 1.f : 0.f;
      }
    } else {
      const float wg = w * gscale;
      float g3[kO];
#pragma unroll
      for (int o = 0; o < kO; ++o)
        g3[o] = o < O ? (expf(logit[o] - m) / se - (o == lbl ? 1.f : 0.f)) * wg
                      : 0.f;
      if (t.owner) store_cell<kO, kExactO>(p.out + t.cell * O, g3, O);
    }
  }
  if (kMode == kLoss) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        part[i] += __shfl_xor_sync(kFull, part[i], s);
      if (lane == 0) red3[warp][i] = part[i];
    }
    __syncthreads();
    if (threadIdx.x < 3) {              // the block's warps, in order
      float sum = 0.f;
      for (int q = 0; q < (int)(blockDim.x >> 5); ++q)
        sum += red3[q][threadIdx.x];
      p.out[(size_t)blockIdx.x * 3 + threadIdx.x] = sum;
    }
  }
}

template <int kMode, int kO, bool kExactO, int kV>
__global__ void __launch_bounds__(kMaxWarps * 32)
head_fwd_kernel(const HeadArgs p) {
  head_fwd<kMode, kO, kExactO, kV, false>(p);
}

// The one-pass mode's roundings take more registers than the f32 kernels
// get: 177-180 at kO = 4, 132-142 at kO = 2, so one block an SM is asked
// for and three blocks of four warps fit an SM at kO = 2.  K5 (kLogits,
// every cell) at kO = 2 asks for two, which caps a thread at 128
// registers: four blocks fit, and the affinity batch's 512 blocks run in
// one wave instead of two (0.038 -> 0.034 ms on the H100).  The weighted
// modes keep one: on a real affinity batch, whose live cells fill the
// first rows and columns of each image, two blocks an SM made K7 and K8's
// forward half 13-21 % slower (why is open; a spread block order did not
// help).
template <int kMode, int kO, bool kExactO, int kV>
__global__ void __launch_bounds__(kMaxWarps * 32,
                                  kMode == kLogits && kO <= 2 ? 2 : 1)
head_fwd_onepass_kernel(const HeadArgs p) {
  head_fwd<kMode, kO, kExactO, kV, true>(p);
}

// Whether a cell's cotangent g3[c, :] (at gc, kO wide as in the walk) has
// a non-zero entry; NaN counts as non-zero.
template <int kO>
__device__ __forceinline__ bool cell_live(const float* gc, int O) {
  if constexpr (kO == 4) {
    const float4 v = *reinterpret_cast<const float4*>(gc);
    return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
  } else if constexpr (kO == 2) {
    const float2 v = *reinterpret_cast<const float2*>(gc);
    return v.x != 0.f || v.y != 0.f;
  } else {
    bool live = false;
#pragma unroll
    for (int o = 0; o < kO; ++o) live |= o < O && gc[o] != 0.f;
    return live;
  }
}

// One block per (g = blockIdx.y, 32 columns k); thread (kl, s) = (lane,
// warp).  g3 [G, A, B, O] is the logits' cotangent.  Writes dX [G, A, K],
// dY [G, B, K] and the image's partials part[g] = [dW2 (K x O) | db1 (K) |
// db2 (O), when with_db2].  kO is the head width the registers are sized
// for: O == kO, or O <= kO = kMaxO.  kOnePass: the one-pass bf16 mode.
//
// Only the cells with a non-zero cotangent are walked (in K8 the cells of
// weight 0 have none).  Before it walks a group of kBwdRows rows, warp s
// lists in shared memory the b's, in ascending order, at which any of the
// group's cells is live, each with a bit per live cell, and hashes the
// keys of those cells alone.  A skipped cell would add dz = +0 to dX and
// dY and h * (+0) to dW2: every sum starts at +0.f and is never -0 (x + y
// is -0 only when both are), so adding +0 leaves it as it was, and with
// each sum still taken in its order (dX over b, dY over the rows and then
// the slices, dW2 in its even and odd accumulators) the results keep their
// bits.  That holds for finite X, Y, b1 and W2: with an Inf h or an Inf or
// NaN W2 entry a skipped cell's h * 0 or (0 * W2) * scale would have been
// NaN, and the walk leaves it out.  A cell is warp-uniform (the lanes are columns k), so a skip costs
// no divergence.
template <int kO, bool kOnePass>
__global__ void __launch_bounds__(kBwdCols * kBwdSlices, kO <= 4 ? 8 : 4)
head_bwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ b1, const float* __restrict__ W2,
                const int* __restrict__ seeds, const float* __restrict__ g3,
                float* __restrict__ dX, float* __restrict__ dY,
                float* __restrict__ part, int A, int B, int K, int O,
                int with_db2, uint32_t thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int cells = A * B;
  const int g = blockIdx.y;
  const int kl = threadIdx.x & (kBwdCols - 1);
  const int s = threadIdx.x / kBwdCols;
  const int k = blockIdx.x * kBwdCols + kl;
  const bool active = k < K;
  float* gs = smem;                                   // [A][B][O]  g3[g]
  float* red = gs + cells * O;         // [slices][B][32] dY partials
  float* redw = red + kBwdSlices * B * kBwdCols;      // [slices][O + 1][32]
  // warp s's group: the keys hash32(hash32(hash32(seed) ^ a) ^ b) of its
  // live cells, [kBwdRows][B], and its work list, [B]
  uint32_t* keys = reinterpret_cast<uint32_t*>(
      redw + kBwdSlices * (O + 1) * kBwdCols) + s * (kBwdRows + 1) * B;
  int* list = reinterpret_cast<int*>(keys + kBwdRows * B);
  const int cols = K * O + K + (with_db2 ? O : 0);
  float* pg = part + (size_t)g * cols;

  const float* gg = g3 + (size_t)g * cells * O;
  for (int i = threadIdx.x; i < cells * O; i += blockDim.x) gs[i] = gg[i];
  __syncthreads();
  if (with_db2 && blockIdx.x == 0 && threadIdx.x < O) {
    float t = 0.f;                       // db2: the image's cells in order
    for (int c = 0; c < cells; ++c) t += gs[c * O + threadIdx.x];
    pg[K * O + K + threadIdx.x] = t;
  }
  if constexpr (kOnePass) {   // g3 rounded once, after db2 has summed it
    if (with_db2 && blockIdx.x == 0) __syncthreads();   // block-uniform
    for (int i = threadIdx.x; i < cells * O; i += blockDim.x)
      gs[i] = bf16_round(gs[i]);
    __syncthreads();
  }

  float w2[kO], dw2[2][kO];
#pragma unroll
  for (int o = 0; o < kO; ++o) {
    w2[o] = (active && o < O) ? W2[k * O + o] : 0.f;
    if constexpr (kOnePass) w2[o] = bf16_round(w2[o]);
    dw2[0][o] = dw2[1][o] = 0.f;
  }
  const float bk = active ? b1[k] : 0.f;
  const float* Xg = X + (size_t)g * A * K;
  const float* Yg = Y + (size_t)g * B * K;
  const uint32_t seed_key = thr != 0u ? hash32((uint32_t)seeds[g]) : 0u;
  float db1 = 0.f;
  float* myred = red + (size_t)s * B * kBwdCols + kl;
  for (int b = 0; b < B; ++b) myred[b * kBwdCols] = 0.f;   // b's never walked
  for (int a0 = s * kBwdRows; a0 < A; a0 += kBwdSlices * kBwdRows) {
    // the group's work list: entry b << kBwdRows | (a bit per live row)
    int n = 0;
    for (int b0 = 0; b0 < B; b0 += kBwdCols) {
      const int b = b0 + kl;
      int rows = 0;
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) {
        if (b < B && a0 + i < A &&
            cell_live<kO>(gs + ((a0 + i) * B + b) * O, O)) {
          rows |= 1 << i;
          if (thr != 0u)
            keys[i * B + b] =
                hash32(hash32(seed_key ^ (uint32_t)(a0 + i)) ^ (uint32_t)b);
        }
      }
      const unsigned live = __ballot_sync(kFull, rows != 0);
      if (rows != 0)
        list[n + __popc(live & ((1u << kl) - 1u))] = (b << kBwdRows) | rows;
      n += __popc(live);
    }
    __syncwarp();
    float xk[kBwdRows], dx[kBwdRows];
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      xk[i] = (active && a0 + i < A) ? Xg[(size_t)(a0 + i) * K + k] + bk : 0.f;
      dx[i] = 0.f;
    }
#pragma unroll 2
    for (int e = 0; e < n; ++e) {
      const int entry = list[e];
      const int b = entry >> kBwdRows;
      const float yv = active ? Yg[(size_t)b * K + k] : 0.f;
      float dy = 0.f;
      const auto cell = [&](const int i) {
        const int c = (a0 + i) * B + b;
        const float z = xk[i] + yv;
        float f = 1.f;
        if (thr != 0u)
          f = hash32(keys[i * B + b] ^ (uint32_t)k) >= thr ? scale : 0.f;
        float h = fmaxf(z, 0.f) * f;
        if constexpr (kOnePass) h = bf16_round(h);
        const float sg = z > 0.f ? f : 0.f;
        float gv[kO];
        if constexpr (kO == 4) {
          const float4 v = *reinterpret_cast<const float4*>(gs + c * 4);
          gv[0] = v.x, gv[1] = v.y, gv[2] = v.z, gv[3] = v.w;
        } else if constexpr (kO == 2) {
          const float2 v = *reinterpret_cast<const float2*>(gs + c * 2);
          gv[0] = v.x, gv[1] = v.y;
        } else {
#pragma unroll
          for (int o = 0; o < kO; ++o) gv[o] = o < O ? gs[c * O + o] : 0.f;
        }
        float dh = 0.f;
#pragma unroll
        for (int o = 0; o < kO; ++o) {
          dh = fmaf(gv[o], w2[o], dh);
          dw2[i & 1][o] = fmaf(h, gv[o], dw2[i & 1][o]);
        }
        const float dz = dh * sg;
        dx[i] += dz;
        dy += dz;
      };
      // all rows live (a dense grid) takes one branch-free body, whose
      // rows the compiler interleaves
      if ((entry & ((1 << kBwdRows) - 1)) == (1 << kBwdRows) - 1) {
#pragma unroll
        for (int i = 0; i < kBwdRows; ++i) cell(i);
      } else {
#pragma unroll
        for (int i = 0; i < kBwdRows; ++i)
          if ((entry >> i) & 1) cell(i);
      }
      myred[b * kBwdCols] += dy;
    }
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      if (active && a0 + i < A) dX[((size_t)g * A + a0 + i) * K + k] = dx[i];
      db1 += dx[i];
    }
    __syncwarp();                 // the next group rewrites list and keys
  }
  float* myw = redw + (size_t)s * (O + 1) * kBwdCols + kl;
#pragma unroll
  for (int o = 0; o < kO; ++o)
    if (o < O) myw[o * kBwdCols] = dw2[0][o] + dw2[1][o];
  myw[O * kBwdCols] = db1;
  __syncthreads();
  if (!active) return;
  // the slices' partials, added in the order s = 0, 1, ...
  for (int b = s; b < B; b += kBwdSlices) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < kBwdSlices; ++p)
      t += red[((size_t)p * B + b) * kBwdCols + kl];
    dY[((size_t)g * B + b) * K + k] = t;
  }
  for (int o = s; o <= O; o += kBwdSlices) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < kBwdSlices; ++p)
      t += redw[((size_t)p * (O + 1) + o) * kBwdCols + kl];
    pg[o < O ? k * O + o : K * O + k] = t;
  }
}

// out[c] = sum over n of part[n, c]: one block per column; thread t sums
// rows t, t + kSumThreads, ... in order, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kSumThreads)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                int N, int C) {
  __shared__ float red[kSumThreads];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += kSumThreads)
    s += part[(size_t)n * C + c];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = red[0];
}

// The forward family: ksplit warps of a block split K (icl_torch/ops/
// grid_head.py launch_plan picks it); plan_launch settles the rest.  The
// loss kernel writes a row of partials a block: part_rows must be its grid.
template <int kMode, bool kOnePass>
cudaError_t launch_fwd(HeadArgs p, int G, int ksplit, int part_rows,
                       cudaStream_t stream) {
  int vec;
  unsigned blocks, threads;
  if (!plan_launch(p, G, ksplit, &vec, &blocks, &threads))
    return cudaErrorInvalidValue;
  if (kMode == kLoss && (long long)blocks != part_rows)
    return cudaErrorInvalidValue;
#define ICL_CALL(kO, kExactO, kV)                                    \
  do {                                                               \
    if constexpr (kOnePass)                                          \
      head_fwd_onepass_kernel<kMode, kO, kExactO, kV>                \
          <<<blocks, threads, 0, stream>>>(p);                       \
    else                                                             \
      head_fwd_kernel<kMode, kO, kExactO, kV>                        \
          <<<blocks, threads, 0, stream>>>(p);                       \
  } while (0)
  ICL_HEAD_DISPATCH(p.O, vec, ICL_CALL);
#undef ICL_CALL
  return cudaGetLastError();
}

HeadArgs head_args(const float* X, const float* Y, const float* b1,
                   const float* W2, const float* b2, const int* seeds,
                   const int* labels, const float* weights, const float* gl,
                   float* out, int A, int B, int K, int O, uint32_t thr,
                   float scale) {
  HeadArgs p = {};
  p.X = X, p.Y = Y, p.b1 = b1, p.W2 = W2, p.b2 = b2, p.seeds = seeds;
  p.labels = labels, p.weights = weights, p.gl = gl, p.out = out;
  p.A = A, p.B = B, p.K = K, p.O = O, p.thr = thr, p.scale = scale;
  return p;
}

template <int kO, bool kOnePass>
cudaError_t launch_bwd_o(const float* X, const float* Y, const float* b1,
                         const float* W2, const int* seeds, const float* g3,
                         float* dX, float* dY, float* part, int G, int A,
                         int B, int K, int O, int with_db2, uint32_t thr,
                         float scale, cudaStream_t stream) {
  // g3 of the image, the slices' dY, their dW2 and db1, and each warp's
  // keys and work list
  const size_t smem = ((size_t)A * B * O + (size_t)kBwdSlices * kBwdCols
                       * (B + O + 1) + (size_t)kBwdSlices * (kBwdRows + 1)
                       * B) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        head_bwd_kernel<kO, kOnePass>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((K + kBwdCols - 1) / kBwdCols, G);
  head_bwd_kernel<kO, kOnePass>
      <<<grid, kBwdCols * kBwdSlices, smem, stream>>>(
      X, Y, b1, W2, seeds, g3, dX, dY, part, A, B, K, O, with_db2, thr,
      scale);
  return cudaGetLastError();
}

template <bool kOnePass>
cudaError_t launch_bwd(const float* X, const float* Y, const float* b1,
                       const float* W2, const int* seeds, const float* g3,
                       float* dX, float* dY, float* part, float* sums, int G,
                       int A, int B, int K, int O, int with_db2, uint32_t thr,
                       float scale, cudaStream_t stream) {
  cudaError_t err =
      O == 4 ? launch_bwd_o<4, kOnePass>(X, Y, b1, W2, seeds, g3, dX, dY,
                                         part, G, A, B, K, O, with_db2, thr,
                                         scale, stream)
      : O == 2
          ? launch_bwd_o<2, kOnePass>(X, Y, b1, W2, seeds, g3, dX, dY, part,
                                      G, A, B, K, O, with_db2, thr, scale,
                                      stream)
          : launch_bwd_o<kMaxO, kOnePass>(X, Y, b1, W2, seeds, g3, dX, dY,
                                          part, G, A, B, K, O, with_db2, thr,
                                          scale, stream);
  if (err != cudaSuccess) return err;
  const int cols = K * O + K + (with_db2 ? O : 0);
  sum_rows_kernel<<<cols, kSumThreads, 0, stream>>>(part, sums, G, cols);
  return cudaGetLastError();
}

cudaError_t prologue(int G, int A, int B, int K, int O, int device) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || O <= 0 || O > kMaxO ||
      G > 65535)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

// The four calls of either mode; the extern "C" entry points below name
// them.
template <bool kOnePass>
int fwd_entry(const float* X, const float* Y, const float* b1,
              const float* W2, const float* b2, const int* seeds, float* out,
              int G, int A, int B, int K, int O, uint32_t thr, float scale,
              int ksplit, int device, void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd<kLogits, kOnePass>(
      head_args(X, Y, b1, W2, b2, seeds, nullptr, nullptr, nullptr, out, A, B,
                K, O, thr, scale),
      G, ksplit, 0, (cudaStream_t)stream);
}

template <bool kOnePass>
int bwd_entry(const float* X, const float* Y, const float* b1,
              const float* W2, const int* seeds, const float* g, float* dX,
              float* dY, float* part, float* sums, int G, int A, int B, int K,
              int O, uint32_t thr, float scale, int device, void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd<kOnePass>(X, Y, b1, W2, seeds, g, dX, dY, part, sums,
                                   G, A, B, K, O, 0, thr, scale,
                                   (cudaStream_t)stream);
}

template <bool kOnePass>
int loss_fwd_entry(const float* X, const float* Y, const float* b1,
                   const float* W2, const float* b2, const int* seeds,
                   const int* labels, const float* weights, float* part,
                   float* sums, int part_rows, int G, int A, int B, int K,
                   int O, uint32_t thr, float scale, int ksplit, int device,
                   void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  err = launch_fwd<kLoss, kOnePass>(
      head_args(X, Y, b1, W2, b2, seeds, labels, weights, nullptr, part, A, B,
                K, O, thr, scale),
      G, ksplit, part_rows, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<3, kSumThreads, 0, (cudaStream_t)stream>>>(part, sums,
                                                               part_rows, 3);
  return (int)cudaGetLastError();
}

template <bool kOnePass>
int loss_bwd_entry(const float* X, const float* Y, const float* b1,
                   const float* W2, const float* b2, const int* seeds,
                   const int* labels, const float* weights, const float* gl,
                   float* g3, float* dX, float* dY, float* part, float* sums,
                   int G, int A, int B, int K, int O, uint32_t thr,
                   float scale, int ksplit, int device, void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  err = launch_fwd<kDLogits, kOnePass>(
      head_args(X, Y, b1, W2, b2, seeds, labels, weights, gl, g3, A, B, K, O,
                thr, scale),
      G, ksplit, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd<kOnePass>(X, Y, b1, W2, seeds, g3, dX, dY, part,
                                   sums, G, A, B, K, O, 1, thr, scale,
                                   (cudaStream_t)stream);
}

}  // namespace

// Every entry point takes contiguous tensors (f32; seeds and labels int32),
// launches on `stream` (a cudaStream_t from the caller) on `device`, and
// returns the cudaError_t of its launches: 0 on success.  G, A and B must
// be positive (the caller handles an empty grid without a launch),
// 1 <= O <= 8, G <= 65535; the backward kernels also need the image's
// cotangents, 4 * A * B * O bytes, 512 * (B + O + 1) bytes of partials and
// 80 * B bytes of work lists and keys within a block's 227 KB of shared
// memory.  `thr` and `scale`
// as in the header; thr = 0 keeps every element.  The forward family takes
// ksplit, the number of warps that split K (1..8), from the caller, and
// the 16-byte form when X, Y, b1 and W2 are 16-byte aligned and K % 4 == 0.
// Outputs and scratch are allocated by the caller.  Each call has an _f32
// entry point (exact) and an _onepass one (the one-pass bf16 mode) with
// the same arguments.

// K5: out [G, A, B, O] logits.
#define ICL_GHT_FWD(SUFFIX, ONEPASS)                                        \
  extern "C" int icl_ght_fwd_##SUFFIX(                                      \
      const float* X, const float* Y, const float* b1, const float* W2,     \
      const float* b2, const int* seeds, float* out, int G, int A, int B,   \
      int K, int O, uint32_t thr, float scale, int ksplit, int device,      \
      void* stream) {                                                       \
    return fwd_entry<ONEPASS>(X, Y, b1, W2, b2, seeds, out, G, A, B, K, O,  \
                              thr, scale, ksplit, device, stream);          \
  }

// K6: cotangent g [G, A, B, O] -> dX [G, A, K], dY [G, B, K] and
// sums = [dW2 (K x O) | db1 (K)]; part is scratch [G, K*O + K].
#define ICL_GHT_BWD(SUFFIX, ONEPASS)                                        \
  extern "C" int icl_ght_bwd_##SUFFIX(                                      \
      const float* X, const float* Y, const float* b1, const float* W2,     \
      const int* seeds, const float* g, float* dX, float* dY, float* part,  \
      float* sums, int G, int A, int B, int K, int O, uint32_t thr,         \
      float scale, int device, void* stream) {                              \
    return bwd_entry<ONEPASS>(X, Y, b1, W2, seeds, g, dX, dY, part, sums,   \
                              G, A, B, K, O, thr, scale, device, stream);   \
  }

// K7: labels [G, A, B] int32, weights [G, A, B] -> sums = [sum ce*w,
// sum hits, sum valid]; part is scratch [part_rows, 3], one row a block of
// the plan.
#define ICL_GHT_LOSS_FWD(SUFFIX, ONEPASS)                                   \
  extern "C" int icl_ght_loss_fwd_##SUFFIX(                                 \
      const float* X, const float* Y, const float* b1, const float* W2,     \
      const float* b2, const int* seeds, const int* labels,                 \
      const float* weights, float* part, float* sums, int part_rows, int G, \
      int A, int B, int K, int O, uint32_t thr, float scale, int ksplit,    \
      int device, void* stream) {                                           \
    return loss_fwd_entry<ONEPASS>(X, Y, b1, W2, b2, seeds, labels,         \
                                   weights, part, sums, part_rows, G, A, B, \
                                   K, O, thr, scale, ksplit, device,        \
                                   stream);                                 \
  }

// K8: gl [1] (device) is the loss cotangent -> dX, dY and sums = [dW2 |
// db1 | db2]; g3 is scratch [G, A, B, O], part scratch [G, K*O + K + O].
#define ICL_GHT_LOSS_BWD(SUFFIX, ONEPASS)                                   \
  extern "C" int icl_ght_loss_bwd_##SUFFIX(                                 \
      const float* X, const float* Y, const float* b1, const float* W2,     \
      const float* b2, const int* seeds, const int* labels,                 \
      const float* weights, const float* gl, float* g3, float* dX,          \
      float* dY, float* part, float* sums, int G, int A, int B, int K,      \
      int O, uint32_t thr, float scale, int ksplit, int device,             \
      void* stream) {                                                       \
    return loss_bwd_entry<ONEPASS>(X, Y, b1, W2, b2, seeds, labels,         \
                                   weights, gl, g3, dX, dY, part, sums, G,  \
                                   A, B, K, O, thr, scale, ksplit, device,  \
                                   stream);                                 \
  }

ICL_GHT_FWD(f32, false)
ICL_GHT_BWD(f32, false)
ICL_GHT_LOSS_FWD(f32, false)
ICL_GHT_LOSS_BWD(f32, false)
ICL_GHT_FWD(onepass, true)
ICL_GHT_BWD(onepass, true)
ICL_GHT_LOSS_FWD(onepass, true)
ICL_GHT_LOSS_BWD(onepass, true)
