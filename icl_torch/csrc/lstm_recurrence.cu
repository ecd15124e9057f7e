// Masked Keras LSTM recurrence, forward, f32, for Hopper (sm_90a).
//
// For each group g (a direction of a BiLSTM; direction 1 arrives already
// time-reversed) and row b, over t = 0 .. L-1:
//
//     z   = x_proj[g, t, b] + h_{t-1} . R[g]          gate slabs i, f, c~, o
//     c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_c)
//     h_t = sigmoid(z_o) * tanh(c_t)
//     (h, c) = mask[g, t, b] ? (h_t, c_t) : (h_{t-1}, c_{t-1})   carry-through
//     hs[g, t, b] = h
//
// and h_final[g, b] = h after step L-1 (zeros when L = 0 or the row has
// length 0).  The semantics are those of _lstm_recurrence_fwd_impl in
// icl/models/rnn.py.  For training, the kernel also writes the backward
// pass's residuals when their pointers are non-null: gates[g, t, b] = the
// post-activation i, f, c~, o slabs (not masked) and cs[g, t, b] = c after
// the mask.  The predict path passes null and writes nothing more.
//
// Replaces: icl/ops/lstm_kernel.py bilstm_recurrence_pallas (_lstm_kernel,
// batch tiles of 32) and bilstm_stream_pallas (_stream_kernel, full batch,
// both directions in one program).  On the TPU both lost to the lax.scan
// because one core runs grid programs in order; on the H100 the batch
// tiles of both directions run side by side on separate SMs.
//
// What bounds it on the H100: the L steps are a sequential chain, and each
// step of a block needs all of R[g] (H x 4H f32 = 640 KB at H=200), which
// does not fit in a block's 227 KB of shared memory.  So every step streams
// R[g] from L2 (both directions, 1.28 MB, stay resident in the 50 MB L2)
// into the block's SM.  The floor is one SM's L2 bandwidth: a few
// microseconds per step, whatever the batch, while the tiles of a batch up
// to 132 SMs wide run side by side.  A first version (one thread per
// hidden unit, 7 warps per SM, each walking all H values of k) measured
// about 32 us per step on the H100: latency-bound on its chain of L2 loads,
// with too few loads in flight to reach that floor.
//
// Design: one block per (group, tile of kTile rows), looping over all L
// steps inside the block; rows are independent, so blocks never
// synchronise.  Each step has two phases:
//  A. kSplit slices of threads split the k (h) reduction: thread (s, j)
//     sums h[k] * R[g, k, q*H + j] over its quarter of k for hidden unit j,
//     the four gates q and the tile's rows (R loads coalesced across the
//     warp; h broadcast from shared memory, k-major so one float4 holds a
//     k's rows).  The partial sums go to shared memory.
//  B. after one __syncthreads(), thread (s, j) finishes row s of unit j:
//     it adds the kSplit partials in a fixed order (no atomics: bitwise
//     repeatable) to x_proj (loaded before phase A, so its latency hides
//     behind it), applies the gates and the mask, and writes h and c back
//     to shared memory and h to hs.  Only that thread touches that (row,
//     unit), so h and c need one buffer each and a second __syncthreads()
//     ends the step.
// Keeping R on chip (a thread-block cluster with distributed shared memory)
// is left to a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4;    // batch rows per block
constexpr int kSplit = 4;   // thread slices splitting the k reduction
static_assert(kTile == kSplit, "phase B gives each slice one row");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(1024)
lstm_recurrence_kernel(const float* __restrict__ xp,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ R, float* __restrict__ hs,
                       float* __restrict__ h_final, float* __restrict__ gates,
                       float* __restrict__ cs, int L, int B, int H) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);   // [H][kTile]  h, k-major
  float* c_s = h_s + H * kTile;                   // [kTile][H]  c
  float* red = c_s + kTile * H;                   // [kSplit][kTile][4][H]
  const int Hp = blockDim.x / kSplit;             // H rounded up to warps
  const int s = threadIdx.x / Hp;
  const int j = threadIdx.x - s * Hp;
  const bool active = j < H;
  const int kc = (H + kSplit - 1) / kSplit;
  const int k0 = s * kc;
  const int k1 = min(H, k0 + kc);
  const int g = blockIdx.y;
  const int b = blockIdx.x * kTile + s;           // the row phase B updates
  const bool updates = active && b < B;
  const int H4 = 4 * H;
  const float* Rg = R + (size_t)g * H * H4;

  for (int i = threadIdx.x; i < 2 * H * kTile; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < L; ++t) {
    const size_t row0 = ((size_t)g * L + t) * B;  // (g, t, b=0)
    float zx[4];
    if (updates) {
      const float* z = xp + (row0 + b) * H4 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) zx[q] = z[q * H];
    }
    // phase A: partial h . R over this slice's k
    if (active) {
      float acc[kTile][4];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float* rk = Rg + (size_t)k * H4 + j;
        const float w0 = __ldg(rk), w1 = __ldg(rk + H);
        const float w2 = __ldg(rk + 2 * H), w3 = __ldg(rk + 3 * H);
        const float4 h4 = *reinterpret_cast<const float4*>(h_s + k * kTile);
        const float hv[kTile] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
          acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
          acc[r][2] = fmaf(hv[r], w2, acc[r][2]);
          acc[r][3] = fmaf(hv[r], w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          red[((s * kTile + r) * 4 + q) * H + j] = acc[r][q];
    }
    __syncthreads();
    // phase B: row s of unit j
    if (updates) {
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float d = 0.f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p)
          d += red[((p * kTile + s) * 4 + q) * H + j];
        z[q] = zx[q] + d;
      }
      const float ig = sigmoid(z[0]);
      const float fg = sigmoid(z[1]);
      const float gg = tanhf(z[2]);
      const float og = sigmoid(z[3]);
      float* hp = h_s + j * kTile + s;
      float* cp = c_s + s * H + j;
      const float ct = fg * *cp + ig * gg;
      if (mask[row0 + b]) {
        *cp = ct;
        *hp = og * tanhf(ct);
      }
      hs[(row0 + b) * H + j] = *hp;
      if (gates != nullptr) {
        float* gp = gates + (row0 + b) * H4 + j;
        gp[0] = ig;
        gp[H] = fg;
        gp[2 * H] = gg;
        gp[3 * H] = og;
        cs[(row0 + b) * H + j] = *cp;
      }
    }
    __syncthreads();
  }
  if (updates) h_final[((size_t)g * B + b) * H + j] = h_s[j * kTile + s];
}

}  // namespace

// x_proj [G, L, B, 4H], mask [G, L, B] (bytes, 0 or 1), R [G, H, 4H] in;
// hs [G, L, B, H] and h_final [G, B, H] out, and, when `gates` is non-null,
// the residuals gates [G, L, B, 4H] and cs [G, L, B, H]; all contiguous f32
// except the mask.  Launches on `stream` (a cudaStream_t from the caller)
// on `device` and returns the cudaError_t of the launch: 0 on success.  G,
// L and B must be positive (the caller handles empty inputs without a
// launch), and 1 <= H <= 256 (a block holds kSplit * H threads, rounded up
// to warps).
extern "C" int icl_lstm_recurrence_f32(const float* x_proj,
                                       const uint8_t* mask, const float* R,
                                       float* hs, float* h_final,
                                       float* gates, float* cs, int G, int L,
                                       int B, int H, int device,
                                       void* stream) {
  const int threads = kSplit * ((H + 31) / 32 * 32);
  if ((gates == nullptr) != (cs == nullptr)) return (int)cudaErrorInvalidValue;
  if (G <= 0 || L <= 0 || B <= 0 || H <= 0 || threads > 1024 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(2 + 4 * kSplit) * H * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_recurrence_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + kTile - 1) / kTile, G);
  lstm_recurrence_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x_proj, mask, R, hs, h_final, gates, cs, L, B, H);
  return (int)cudaGetLastError();
}
