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
//  * Forward family (K5, K7, and the first half of K8): one block per
//    (g, a), as in grid_head.cu.  X[g, a] + b1 and W2 (transposed to
//    [O, K]) sit in shared memory; each warp takes columns b in turn, its
//    lanes stride over K, and a fixed xor butterfly of shuffles leaves the
//    cell's O logits in every lane.  K5 writes them; K7 turns them into the
//    cell's CE terms (max shift, first-max argmax) and sums them per block
//    in a fixed order into [G*A, 3] partials; K8's first kernel writes the
//    logit gradient g3 = (softmax - onehot) * w * gl, [G, A, B, O] (16 KB
//    per image at A = B = 32).  The [A, B, K] activation never leaves the
//    SM, and K7's logits never reach device memory.
//  * Backward (K6, and the second half of K8): one block per (g, tile of
//    kBwdCols = 32 columns k), of kBwdSlices = 4 warps.  The image's cell
//    cotangents g3 [A, B, O] and the per-cell hash keys
//    hash32(hash32(hash32(seed) ^ a) ^ b) [A, B] are put into shared memory
//    once per block, so an element costs one hash, not three, and one or
//    two broadcast loads.  Thread (k, s) takes kBwdRows = 4 rows a of slice
//    s (rows 4s .., then 4s + 16 .. where A > 16) and walks b: it recomputes
//    z, the mask and hd; dz = (g3 . W2[k, :]) * [z > 0] * keep * scale.
//    dX[a, k] is finished in that thread, in 4 independent sums over b;
//    the slices' partial dY[b, k], db1[k] and dW2[k, :] (two accumulators
//    each, even and odd rows) meet in shared memory and are added in the
//    order s = 0, 1, 2, 3.  A first design had one thread per (g, k) walk
//    all A * B cells in one chain at 134 registers (12 warps to an SM,
//    three hashes an element, g3 read from L2): latency-bound.
//  * The per-image (or per-row) partials are summed over rows by a second,
//    fixed-order pass.  No atomics anywhere: results repeat bit for bit.
//
// What bounds it on the H100: at the relation shapes (G = 64, A = B <= 32,
// K = 800, O = 4) each call is a few microseconds of arithmetic spread
// over 448 to 2048 blocks; the hash (a dozen integer operations per
// element) costs about as much as the O-wide dot.  At these sizes the
// launches and the reduction pass are a large share of the time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxO = 8;         // head widths in this repo: 4 (relation), 2
constexpr int kWarps = 8;        // forward family: warps per block
constexpr int kBwdCols = 32;     // backward: k columns per block (a warp)
constexpr int kBwdSlices = 4;    // backward: warps per block, slicing rows a
constexpr int kBwdRows = 4;      // backward: rows a per thread at a time
constexpr int kSumThreads = 128; // row-sum pass

enum Mode { kLogits = 0, kLoss = 1, kDLogits = 2 };

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  return (x >> 16) ^ x;
}

// kLogits: out = logits [G, A, B, O]
// kLoss:   out = per-block partials [G * A, 3] (sum ce*w, hits, valid)
// kDLogits: out = g3 [G, A, B, O] = (softmax - onehot) * w * gl[0]
template <int kMode>
__global__ void __launch_bounds__(kWarps * 32)
head_fwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ b1, const float* __restrict__ W2,
                const float* __restrict__ b2, const int* __restrict__ seeds,
                const int* __restrict__ labels,
                const float* __restrict__ weights,
                const float* __restrict__ gl, float* __restrict__ out, int A,
                int B, int K, int O, uint32_t thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* xa = smem;        // [K]     X[g, a] + b1
  float* w2t = smem + K;   // [O, K]  W2 transposed
  __shared__ float red[kWarps][3];
  const int ga = blockIdx.x;  // g * A + a
  const int g = ga / A;
  const int a = ga - g * A;
  const float* x = X + (size_t)ga * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) xa[k] = x[k] + b1[k];
  for (int i = threadIdx.x; i < K * O; i += blockDim.x) {
    const int k = i / O, o = i - k * O;
    w2t[o * K + k] = W2[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t row_key = hash32(hash32((uint32_t)seeds[g]) ^ (uint32_t)a);
  const float gscale = kMode == kDLogits ? gl[0] : 0.f;
  float part[3] = {0.f, 0.f, 0.f};
  for (int b = warp; b < B; b += kWarps) {
    const float* y = Y + ((size_t)g * B + b) * K;
    const uint32_t cell = hash32(row_key ^ (uint32_t)b);
    float acc[kMaxO];
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) acc[o] = 0.f;
    for (int k = lane; k < K; k += 32) {
      float h = fmaxf(xa[k] + y[k], 0.f);
      if (thr != 0u) h = hash32(cell ^ (uint32_t)k) >= thr ? h * scale : 0.f;
#pragma unroll
      for (int o = 0; o < kMaxO; ++o)
        if (o < O) acc[o] = fmaf(h, w2t[o * K + k], acc[o]);
    }
    float logit[kMaxO];
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) {
      float v = acc[o];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
      logit[o] = o < O ? v + b2[o] : 0.f;
    }
    if (lane != 0) continue;
    const size_t c = (size_t)ga * B + b;
    if (kMode == kLogits) {
#pragma unroll
      for (int o = 0; o < kMaxO; ++o)
        if (o < O) out[c * O + o] = logit[o];
      continue;
    }
    const int lbl = labels[c];
    const float w = weights[c];
    float m = logit[0];
#pragma unroll
    for (int o = 1; o < kMaxO; ++o)
      if (o < O) m = fmaxf(m, logit[o]);
    float se = 0.f, picked = 0.f;
    int best = O;                       // first-max argmax
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) {
      if (o < O) {
        const float sh = logit[o] - m;
        se += expf(sh);
        if (o == lbl) picked = sh;
        if (best == O && logit[o] == m) best = o;
      }
    }
    if (kMode == kLoss) {
      const bool valid = w > 0.f;
      part[0] += (logf(se) - picked) * w;
      part[1] += (valid && best == lbl) ? 1.f : 0.f;
      part[2] += valid ? 1.f : 0.f;
    } else {
      const float wg = w * gscale;
#pragma unroll
      for (int o = 0; o < kMaxO; ++o)
        if (o < O)
          out[c * O + o] =
              (expf(logit[o] - m) / se - (o == lbl ? 1.f : 0.f)) * wg;
    }
  }
  if (kMode == kLoss) {
    if (lane == 0) {
      red[warp][0] = part[0];
      red[warp][1] = part[1];
      red[warp][2] = part[2];
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      out[(size_t)ga * 3 + threadIdx.x] = s;
    }
  }
}

// One block per (g = blockIdx.y, 32 columns k); thread (kl, s) = (lane,
// warp).  g3 [G, A, B, O] is the logits' cotangent.  Writes dX [G, A, K],
// dY [G, B, K] and the image's partials part[g] = [dW2 (K x O) | db1 (K) |
// db2 (O), when with_db2].  kO is the head width the registers are sized
// for: O == kO, or O <= kO = kMaxO.
template <int kO>
__global__ void __launch_bounds__(kBwdCols * kBwdSlices, kO <= 4 ? 8 : 4)
head_bwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ b1, const float* __restrict__ W2,
                const int* __restrict__ seeds, const float* __restrict__ g3,
                float* __restrict__ dX, float* __restrict__ dY,
                float* __restrict__ part, int A, int B, int K, int O,
                int with_db2, uint32_t thr, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int cells = A * B;
  float* gs = smem;                                   // [A][B][O]  g3[g]
  uint32_t* keys = reinterpret_cast<uint32_t*>(gs + cells * O);  // [A][B]
  float* red = gs + cells * (O + 1);   // [slices][B][32] dY partials
  float* redw = red + kBwdSlices * B * kBwdCols;      // [slices][O + 1][32]
  const int g = blockIdx.y;
  const int kl = threadIdx.x & (kBwdCols - 1);
  const int s = threadIdx.x / kBwdCols;
  const int k = blockIdx.x * kBwdCols + kl;
  const bool active = k < K;
  const int cols = K * O + K + (with_db2 ? O : 0);
  float* pg = part + (size_t)g * cols;

  const float* gg = g3 + (size_t)g * cells * O;
  for (int i = threadIdx.x; i < cells * O; i += blockDim.x) gs[i] = gg[i];
  if (thr != 0u) {
    const uint32_t seed_key = hash32((uint32_t)seeds[g]);
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int a = c / B;
      keys[c] = hash32(hash32(seed_key ^ (uint32_t)a) ^ (uint32_t)(c - a * B));
    }
  }
  __syncthreads();
  if (with_db2 && blockIdx.x == 0 && threadIdx.x < O) {
    float t = 0.f;                       // db2: the image's cells in order
    for (int c = 0; c < cells; ++c) t += gs[c * O + threadIdx.x];
    pg[K * O + K + threadIdx.x] = t;
  }

  float w2[kO], dw2[2][kO];
#pragma unroll
  for (int o = 0; o < kO; ++o) {
    w2[o] = (active && o < O) ? W2[k * O + o] : 0.f;
    dw2[0][o] = dw2[1][o] = 0.f;
  }
  const float bk = active ? b1[k] : 0.f;
  const float* Xg = X + (size_t)g * A * K;
  const float* Yg = Y + (size_t)g * B * K;
  float db1 = 0.f;
  float* myred = red + (size_t)s * B * kBwdCols + kl;
  for (int a0 = s * kBwdRows; a0 < A || a0 == s * kBwdRows;
       a0 += kBwdSlices * kBwdRows) {
    const bool first = a0 == s * kBwdRows;
    float xk[kBwdRows], dx[kBwdRows];
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      xk[i] = (active && a0 + i < A) ? Xg[(size_t)(a0 + i) * K + k] + bk : 0.f;
      dx[i] = 0.f;
    }
#pragma unroll 2
    for (int b = 0; b < B; ++b) {
      const float yv = active ? Yg[(size_t)b * K + k] : 0.f;
      float dy = 0.f;
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) {
        if (a0 + i < A) {
          const int c = (a0 + i) * B + b;
          const float z = xk[i] + yv;
          float f = 1.f;
          if (thr != 0u) f = hash32(keys[c] ^ (uint32_t)k) >= thr ? scale : 0.f;
          const float h = fmaxf(z, 0.f) * f;
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
        }
      }
      myred[b * kBwdCols] = first ? dy : myred[b * kBwdCols] + dy;
    }
#pragma unroll
    for (int i = 0; i < kBwdRows; ++i) {
      if (active && a0 + i < A) dX[((size_t)g * A + a0 + i) * K + k] = dx[i];
      db1 += dx[i];
    }
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

template <int kMode>
cudaError_t launch_fwd(const float* X, const float* Y, const float* b1,
                       const float* W2, const float* b2, const int* seeds,
                       const int* labels, const float* weights,
                       const float* gl, float* out, int G, int A, int B,
                       int K, int O, uint32_t thr, float scale,
                       cudaStream_t stream) {
  const size_t smem = (size_t)K * (1 + O) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        head_fwd_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  head_fwd_kernel<kMode><<<G * A, kWarps * 32, smem, stream>>>(
      X, Y, b1, W2, b2, seeds, labels, weights, gl, out, A, B, K, O, thr,
      scale);
  return cudaGetLastError();
}

template <int kO>
cudaError_t launch_bwd_o(const float* X, const float* Y, const float* b1,
                         const float* W2, const int* seeds, const float* g3,
                         float* dX, float* dY, float* part, int G, int A,
                         int B, int K, int O, int with_db2, uint32_t thr,
                         float scale, cudaStream_t stream) {
  // g3 and keys of the image, the slices' dY, and their dW2 and db1
  const size_t smem = ((size_t)A * B * (O + 1) + (size_t)kBwdSlices * kBwdCols
                       * (B + O + 1)) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        head_bwd_kernel<kO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((K + kBwdCols - 1) / kBwdCols, G);
  head_bwd_kernel<kO><<<grid, kBwdCols * kBwdSlices, smem, stream>>>(
      X, Y, b1, W2, seeds, g3, dX, dY, part, A, B, K, O, with_db2, thr,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* X, const float* Y, const float* b1,
                       const float* W2, const int* seeds, const float* g3,
                       float* dX, float* dY, float* part, float* sums, int G,
                       int A, int B, int K, int O, int with_db2, uint32_t thr,
                       float scale, cudaStream_t stream) {
  cudaError_t err =
      O == 4 ? launch_bwd_o<4>(X, Y, b1, W2, seeds, g3, dX, dY, part, G, A, B,
                               K, O, with_db2, thr, scale, stream)
      : O == 2
          ? launch_bwd_o<2>(X, Y, b1, W2, seeds, g3, dX, dY, part, G, A, B, K,
                            O, with_db2, thr, scale, stream)
          : launch_bwd_o<kMaxO>(X, Y, b1, W2, seeds, g3, dX, dY, part, G, A,
                                B, K, O, with_db2, thr, scale, stream);
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

}  // namespace

// Every entry point takes contiguous tensors (f32; seeds and labels int32),
// launches on `stream` (a cudaStream_t from the caller) on `device`, and
// returns the cudaError_t of its launches: 0 on success.  G, A and B must
// be positive (the caller handles an empty grid without a launch),
// 1 <= O <= 8, G <= 65535; the backward kernels also need the image's
// cotangents and keys, 4 * A * B * (O + 1) bytes, and 512 * (B + O + 1) bytes
// of partials within a block's 227 KB of shared memory.  `thr` and `scale`
// as in the header; thr = 0 turns dropout off.  Outputs and scratch are
// allocated by the caller.

// K5: out [G, A, B, O] logits.
extern "C" int icl_ght_fwd_f32(const float* X, const float* Y,
                               const float* b1, const float* W2,
                               const float* b2, const int* seeds, float* out,
                               int G, int A, int B, int K, int O,
                               uint32_t thr, float scale, int device,
                               void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fwd<kLogits>(X, Y, b1, W2, b2, seeds, nullptr, nullptr,
                                  nullptr, out, G, A, B, K, O, thr, scale,
                                  (cudaStream_t)stream);
}

// K6: cotangent g [G, A, B, O] -> dX [G, A, K], dY [G, B, K] and
// sums = [dW2 (K x O) | db1 (K)]; part is scratch [G, K*O + K].
extern "C" int icl_ght_bwd_f32(const float* X, const float* Y,
                               const float* b1, const float* W2,
                               const int* seeds, const float* g, float* dX,
                               float* dY, float* part, float* sums, int G,
                               int A, int B, int K, int O, uint32_t thr,
                               float scale, int device, void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd(X, Y, b1, W2, seeds, g, dX, dY, part, sums, G, A, B,
                         K, O, 0, thr, scale, (cudaStream_t)stream);
}

// K7: labels [G, A, B] int32, weights [G, A, B] -> sums = [sum ce*w,
// sum hits, sum valid]; part is scratch [G*A, 3].
extern "C" int icl_ght_loss_fwd_f32(const float* X, const float* Y,
                                    const float* b1, const float* W2,
                                    const float* b2, const int* seeds,
                                    const int* labels, const float* weights,
                                    float* part, float* sums, int G, int A,
                                    int B, int K, int O, uint32_t thr,
                                    float scale, int device, void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  err = launch_fwd<kLoss>(X, Y, b1, W2, b2, seeds, labels, weights, nullptr,
                          part, G, A, B, K, O, thr, scale,
                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<3, kSumThreads, 0, (cudaStream_t)stream>>>(part, sums,
                                                               G * A, 3);
  return (int)cudaGetLastError();
}

// K8: gl [1] (device) is the loss cotangent -> dX, dY and sums = [dW2 |
// db1 | db2]; g3 is scratch [G, A, B, O], part scratch [G, K*O + K + O].
extern "C" int icl_ght_loss_bwd_f32(const float* X, const float* Y,
                                    const float* b1, const float* W2,
                                    const float* b2, const int* seeds,
                                    const int* labels, const float* weights,
                                    const float* gl, float* g3, float* dX,
                                    float* dY, float* part, float* sums,
                                    int G, int A, int B, int K, int O,
                                    uint32_t thr, float scale, int device,
                                    void* stream) {
  cudaError_t err = prologue(G, A, B, K, O, device);
  if (err != cudaSuccess) return (int)err;
  err = launch_fwd<kDLogits>(X, Y, b1, W2, b2, seeds, labels, weights, gl,
                             g3, G, A, B, K, O, thr, scale,
                             (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_bwd(X, Y, b1, W2, seeds, g3, dX, dY, part, sums, G, A,
                         B, K, O, 1, thr, scale, (cudaStream_t)stream);
}
