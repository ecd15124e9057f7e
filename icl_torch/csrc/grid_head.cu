// Fused M x M grid head, f32, for Hopper (sm_90a):
//
//     out[g, a, b, :] = relu(X[g, a] + b1 + Y[g, b]) . W2 + b2
//
// Replaces: icl/ops/grid_head.py grid_head_pallas, both of its Pallas bodies
// (_flat_kernel, one tile per image with a transposed [O, A*B] output, and
// _kernel, (8, 128) tiles for large grids).  Both layouts existed for the
// TPU's 128-lane vregs; here one kernel covers every grid size and writes
// the public [G, A, B, O] layout directly.
//
// What bounds it on the H100: the [A, B, K] activation is the only large
// intermediate (relation K=800: 3.2 KB per cell) and it never leaves the
// SM.  Per cell the kernel does K adds, K max and K*O FMAs against K*4
// bytes of Y read from L2 (Y[g] is reused by all A blocks of the image),
// so at O=4 it sits near 2.5 FLOP/byte: bound by L2/shared-memory traffic
// and by the warp-level reduction, far from the FP32 pipes.  At the served
// shapes (G <= 64, M <= 32) the whole call is a few microseconds and the
// launch itself is a large share.
//
// Design: one block per (g, a).  X[g, a] + b1 and W2 (transposed to [O, K]
// so that neighbouring lanes read neighbouring words, no bank conflicts)
// are staged once in shared memory.  Each warp takes columns b in turn;
// its lanes stride over K with coalesced loads of Y[g, b], keep O partial
// sums in registers, and reduce them with a fixed xor-butterfly of warp
// shuffles.  No atomics and no data-dependent order: a response is
// bitwise repeatable.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxO = 8;    // head widths in this repo: 4 (relation), 2 (affinity)
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
grid_head_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 const float* __restrict__ b1, const float* __restrict__ W2,
                 const float* __restrict__ b2, float* __restrict__ out,
                 int A, int B, int K, int O) {
  extern __shared__ float smem[];
  float* xa = smem;        // [K]     X[g, a] + b1
  float* w2t = smem + K;   // [O, K]  W2 transposed
  const int ga = blockIdx.x;            // g * A + a
  const int g = ga / A;
  const float* x = X + (size_t)ga * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) xa[k] = x[k] + b1[k];
  for (int i = threadIdx.x; i < K * O; i += blockDim.x) {
    const int k = i / O, o = i - k * O;
    w2t[o * K + k] = W2[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* yg = Y + (size_t)g * B * K;
  float* og = out + (size_t)ga * B * O;
  for (int b = warp; b < B; b += kWarps) {
    const float* y = yg + (size_t)b * K;
    float acc[kMaxO];
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) acc[o] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float h = fmaxf(xa[k] + y[k], 0.f);
#pragma unroll
      for (int o = 0; o < kMaxO; ++o)
        if (o < O) acc[o] = fmaf(h, w2t[o * K + k], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) {
      if (o < O) {
        float v = acc[o];
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == 0) og[(size_t)b * O + o] = v + b2[o];
      }
    }
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t from the caller) on `device`.
// Returns the cudaError_t of the launch: 0 on success.  G, A and B must be
// positive (the caller handles an empty grid without a launch), 1 <= O <= 8.
extern "C" int icl_grid_head_f32(const float* X, const float* Y,
                                 const float* b1, const float* W2,
                                 const float* b2, float* out, int G, int A,
                                 int B, int K, int O, int device,
                                 void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || O <= 0 || O > kMaxO)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)K * (1 + O) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(grid_head_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  grid_head_kernel<<<G * A, kWarps * 32, smem, (cudaStream_t)stream>>>(
      X, Y, b1, W2, b2, out, A, B, K, O);
  return (int)cudaGetLastError();
}
