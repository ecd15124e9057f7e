// Box ranking (K9), f32, for Hopper (sm_90a).  For each image g and
// mention a, over the image's candidate boxes b:
//
//     s[g, a, b]    = relu(X[g, a] + b1 + Y[g, b]) . W2[:, col] + b2[col]
//     rank[g, a, :] = softmax over b of s[g, a, :], masked to box_valid[g]
//
// Invalid boxes get exactly 0; an image with no valid box gets a row of
// zeros (the sum is clamped at 1e-30, as the reference's is), never NaN.
//
// Replaces: icl/ops/affinity_rank.py affinity_rank_pallas (_rank_kernel),
// which held a tile of mentions and the image's whole box axis in VMEM so
// that the grid activation, the head column, the mask and the softmax
// fused and only the [G, A, B] ranking reached HBM.
//
// What bounds it on the H100: the [A, B, K] activation is the only large
// intermediate (K=1024: 4 KB per cell; the plain version materialises
// 134 MB of it at G=64 A=16 B=32) and it never leaves the SM.  Per cell the
// kernel does K adds, K max and K FMAs against K*4 bytes of Y[g, b] read
// from L2 (Y[g] is reused by all A blocks of the image; Y of a 64-image
// batch, 8 MB, stays in the 50 MB L2): about 0.75 FLOP per byte, so L2
// bandwidth and the warp reductions bound it, far from the FP32 pipes.  The
// softmax is B values per row, nothing.
//
// Design: the grid head's (csrc/grid_head.cu) with one output column and
// the softmax behind it.  One block per (g, a).  X[g, a] + b1 and the W2
// column are staged once in shared memory (2 * K floats, 8 KB at K=1024).
// Each warp takes boxes b in turn; its lanes stride over K with coalesced
// loads of Y[g, b] and reduce with a fixed xor butterfly of shuffles; lane
// 0 writes the score to shared memory.  After a __syncthreads, warp 0
// takes the B scores: the masked max, expf, and the sum, each as a strided
// per-lane pass in index order followed by a fixed butterfly; it writes
// e / max(sum, 1e-30).  No atomics, no data-dependent order: repeated calls
// give the same bits.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
affinity_rank_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                     const float* __restrict__ b1,
                     const float* __restrict__ W2,
                     const float* __restrict__ b2,
                     const uint8_t* __restrict__ box_valid,
                     float* __restrict__ out, int A, int B, int K, int O,
                     int col) {
  extern __shared__ float smem[];
  float* xa = smem;            // [K]  X[g, a] + b1
  float* w = smem + K;         // [K]  W2[:, col]
  float* s = smem + 2 * K;     // [B]  scores, then exp
  const int ga = blockIdx.x;   // g * A + a
  const int g = ga / A;
  const float* x = X + (size_t)ga * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    xa[k] = x[k] + b1[k];
    w[k] = W2[(size_t)k * O + col];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* yg = Y + (size_t)g * B * K;
  const float bias = b2[col];
  for (int b = warp; b < B; b += kWarps) {
    const float* y = yg + (size_t)b * K;
    float acc = 0.f;
    for (int k = lane; k < K; k += 32)
      acc = fmaf(fmaxf(xa[k] + y[k], 0.f), w[k], acc);
    acc = warp_sum(acc);
    if (lane == 0) s[b] = acc + bias;
  }
  __syncthreads();

  if (warp != 0) return;
  const uint8_t* valid = box_valid + (size_t)g * B;
  float m = -FLT_MAX;
  for (int b = lane; b < B; b += 32)
    if (valid[b]) m = fmaxf(m, s[b]);
  m = warp_max(m);
  float sum = 0.f;
  for (int b = lane; b < B; b += 32) {
    const float e = valid[b] ? expf(s[b] - m) : 0.f;
    s[b] = e;
    sum += e;
  }
  sum = fmaxf(warp_sum(sum), 1e-30f);
  float* o = out + (size_t)ga * B;
  for (int b = lane; b < B; b += 32) o[b] = s[b] / sum;
}

}  // namespace

// Launches on `stream` (a cudaStream_t from the caller) on `device`.
// box_valid is one byte per box (torch.bool).  Returns the cudaError_t of
// the launch: 0 on success.  G, A and B must be positive (the caller
// handles an empty grid without a launch), 0 <= col < O.
extern "C" int icl_affinity_rank_f32(const float* X, const float* Y,
                                     const float* b1, const float* W2,
                                     const float* b2,
                                     const uint8_t* box_valid, float* out,
                                     int G, int A, int B, int K, int O,
                                     int col, int device, void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || col < 0 || col >= O)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)2 * K + B) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(affinity_rank_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  affinity_rank_kernel<<<G * A, kWarps * 32, smem, (cudaStream_t)stream>>>(
      X, Y, b1, W2, b2, box_valid, out, A, B, K, O, col);
  return (int)cudaGetLastError();
}
