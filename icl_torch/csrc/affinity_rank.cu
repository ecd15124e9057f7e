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
// What bounds it on the H100: the grid head's arithmetic at one output
// column (3 float instructions per element of [cells, K]) over operands
// that stay in L2 (Y of a 64-image batch is 8 MB), so, as for the grid
// head, the instruction and load rate of the SMs sets the pace, not device
// memory; the [A, B, K] activation (the plain version materialises 134 MB
// of it at G=64 A=16 B=32 K=1024) never leaves the registers and the
// scores never leave the SM.  The softmax is B values a row, nothing.  A
// design with one cell a warp (4-byte loads of Y, a 5-step shuffle tree a
// cell, the softmax on one warp of eight) took 0.022 ms where the bound is
// 0.004: loads and shuffles set its pace.
//
// Design: the tile routine of grid_head_tile.cuh in its column form (a
// 4 x 4 register tile of cells a warp, 16-byte loads straight from global
// memory, the transpose-reduce, one sum a cell over W2[:, col]).  A block
// owns whole rows of the ranking: 4 mentions of one image and all B boxes.
// Its warps take the column tiles (4 boxes each) in turn, up to 8 side by
// side, and leave the scores in shared memory (4 x B floats).  On small
// grids (a served request: G = 4) K is split over the warps of a block as
// in the grid head, the slices summed in shared memory in slice order.
// After one barrier a warp a mention runs the masked max, expf and the sum
// (a strided pass a lane in index order, then a fixed butterfly) and writes
// e / max(sum, 1e-30) to out[g, a, :].  No atomics, no data-dependent
// order: repeated calls give the same bits.  Operands that are not 16-byte
// aligned, or K % 4 != 0, take the same routine with 4-byte loads.
//
// The bf16 mode (icl_affinity_rank_bf16dot) takes the tile routine's fast
// dot (the activation and the W2 column rounded to bf16, f32 sums): under
// --compute_dtype bf16 the reference ranks the fast-dot logits it also
// writes as probabilities, so the ranking follows the same logits here.
//
// Shared memory a block: 2 KB of K-split partials and 16 x B bytes of
// scores.  Registers a thread (ptxas, sm_90a, no spill; chip_smoke.py
// prints them and fails on a spill): 98 in the 16-byte form at O = 2, 100
// at other widths, 62 in the scalar form; a block of 16 warps fits an SM.
#include "grid_head_tile.cuh"

#include <float.h>

namespace {

using namespace icl_head;

constexpr int kRankColWarps = 8;   // column tiles side by side in a block
constexpr int kRankWarps = 16;     // warps a block: column tiles x k slices
constexpr int kRankRows = Tile<1>::kRows;   // mentions a block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

// Block b is (image g, row tile): rows a0 .. a0 + 3.  Warp w is column
// tile w % col_warps of each group of col_warps tiles and k slice
// w / col_warps.  kExactO: W2 is [K, 2]; kV: 4 (16-byte loads) or 1;
// kFastDot: the tile routine's bf16 fast dot.
template <bool kExactO, int kV, bool kFastDot>
__global__ void __launch_bounds__(kRankWarps * 32)
affinity_rank_kernel(const HeadArgs p, const uint8_t* __restrict__ box_valid) {
  using T = Tile<1>;
  __shared__ float red[kRedFloats];
  extern __shared__ float sc[];       // [kRankRows][B] scores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = p.B;
  TileCoords t;
  t.g = blockIdx.x / p.row_tiles;
  t.a0 = (blockIdx.x % p.row_tiles) * T::kRows;
  t.ctw = warp % p.col_warps;
  t.s = warp / p.col_warps;
  const int c = lane >> T::kShift;    // the lane's cell of the tile
  const int col_tiles = (B + T::kCols - 1) / T::kCols;
  // every warp makes the same number of turns: a K split meets at barriers
  for (int ct0 = 0; ct0 < col_tiles; ct0 += p.col_warps) {
    t.b0 = (ct0 + t.ctw) * T::kCols;  // beyond B: no live cell, no work
    float logit[1];
    head_tile_logits<1, kExactO, kV, false, false, true, kFastDot>(p, t, red,
                                                                  logit);
    const int r = c / T::kCols, b = t.b0 + c % T::kCols;
    if (t.s == 0 && (lane & (T::kGroup - 1)) == 0 && t.a0 + r < p.A && b < B)
      sc[r * B + b] = logit[0];
    if (p.ksplit > 1) __syncthreads();   // red is written again next turn
  }
  __syncthreads();

  const uint8_t* valid = box_valid + (size_t)t.g * B;
  for (int r = warp; r < T::kRows && t.a0 + r < p.A; r += blockDim.x >> 5) {
    float* s = sc + r * B;
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
    float* o = p.out + ((size_t)t.g * p.A + t.a0 + r) * B;
    for (int b = lane; b < B; b += 32) o[b] = s[b] / sum;
  }
}

template <bool kFastDot>
int launch(const float* X, const float* Y, const float* b1, const float* W2,
           const float* b2, const uint8_t* box_valid, float* out, int G,
           int A, int B, int K, int O, int col, int ksplit, int device,
           void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || col < 0 || col >= O)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HeadArgs p = {};
  p.X = X, p.Y = Y, p.b1 = b1, p.W2 = W2, p.b2 = b2, p.out = out;
  p.A = A, p.B = B, p.K = K, p.O = O, p.col = col;
  const int col_tiles = (B + Tile<1>::kCols - 1) / Tile<1>::kCols;
  p.ksplit = ksplit;
  p.col_warps = col_tiles < kRankColWarps ? col_tiles : kRankColWarps;
  p.row_tiles = (A + kRankRows - 1) / kRankRows;
  p.col_groups = 1;
  const long long blocks = (long long)G * p.row_tiles;
  if (ksplit < 1 || ksplit * p.col_warps > kRankWarps || blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y) |
      reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(W2);
  const bool vec = K % 4 == 0 && bits % 16 == 0;
  const unsigned threads = 32u * ksplit * p.col_warps;
  const size_t smem = (size_t)kRankRows * B * sizeof(float);
#define ICL_CALL(kExactO, kV)                                               \
  do {                                                                      \
    if (smem > 40 * 1024) {                                                 \
      err = cudaFuncSetAttribute(                                           \
          affinity_rank_kernel<kExactO, kV, kFastDot>,                      \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);          \
      if (err != cudaSuccess) return (int)err;                              \
    }                                                                       \
    affinity_rank_kernel<kExactO, kV, kFastDot>                             \
        <<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(        \
            p, box_valid);                                                  \
  } while (0)
  if (vec && O == 2) {
    ICL_CALL(true, 4);
  } else if (vec) {
    ICL_CALL(false, 4);
  } else {
    ICL_CALL(false, 1);
  }
#undef ICL_CALL
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t from the caller) on `device`.
// box_valid is one byte per box (torch.bool).  Returns the cudaError_t of
// the launch: 0 on success.  G, A and B must be positive (the caller
// handles an empty grid without a launch), 0 <= col < O.  ksplit warps of a
// block split K (icl_torch/ops/grid_head.py launch_plan picks it for a
// block of whole rows); a block has min(column tiles, 8) x ksplit warps, at
// most 16.  The 16-byte form is taken when X, Y, b1 and W2 are 16-byte
// aligned and K % 4 == 0.
extern "C" int icl_affinity_rank_f32(const float* X, const float* Y,
                                     const float* b1, const float* W2,
                                     const float* b2,
                                     const uint8_t* box_valid, float* out,
                                     int G, int A, int B, int K, int O,
                                     int col, int ksplit, int device,
                                     void* stream) {
  return launch<false>(X, Y, b1, W2, b2, box_valid, out, G, A, B, K, O, col,
                       ksplit, device, stream);
}

// The same call in the bf16 fast-dot mode: the scores are the fast-dot
// grid head's column, as the reference ranks the fast-dot logits it writes.
extern "C" int icl_affinity_rank_bf16dot(const float* X, const float* Y,
                                         const float* b1, const float* W2,
                                         const float* b2,
                                         const uint8_t* box_valid,
                                         float* out, int G, int A, int B,
                                         int K, int O, int col, int ksplit,
                                         int device, void* stream) {
  return launch<true>(X, Y, b1, W2, b2, box_valid, out, G, A, B, K, O, col,
                      ksplit, device, stream);
}
