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
// The bf16 mode (icl_affinity_rank_bf16dot, affinity_rank_bf16dot_kernel)
// ranks the fast-dot logits (the activation and the W2 column rounded to
// bf16, f32 sums): under --compute_dtype bf16 the reference ranks the
// fast-dot logits it also writes as probabilities.  On large grids its
// scores come from the tensor cores (affinity_rank_bf16dot_kernel): the
// grid head's mma.sync routine of grid_head_tile.cuh (dot_block) in its
// column form, B one real column of eight (one mma still stands for 16 x
// 16 FMAs).  A block owns one group of 8 mentions and all the image's
// boxes; its warps take the tiles of 16 (8) boxes side by side, up to 8,
// times the K split; the scores meet in shared memory and the masked
// softmax below is the f32 mode's.  On small grids
// (icl_affinity_rank_bf16fma) the f32 kernel takes the tile routine's
// kFastDot; icl_torch/ops/grid_head.py dot_plan picks the form.
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

// The masked softmax over each row r < rows (a0 + r < A) of the block's
// scores sc[r][B], a warp a row: the max and the sum of expf over the
// image's valid boxes (a strided pass a lane in index order, then a fixed
// butterfly), e / max(sum, 1e-30) to out[g, a0 + r, :], invalid boxes 0.
// Every thread of the block calls it after the scores' barrier.
__device__ __forceinline__ void masked_softmax(float* sc, int rows, int g,
                                               int a0, int A, int B,
                                               const uint8_t* box_valid,
                                               float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* valid = box_valid + (size_t)g * B;
  for (int r = warp; r < rows && a0 + r < A; r += blockDim.x >> 5) {
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
    float* o = out + ((size_t)g * A + a0 + r) * B;
    for (int b = lane; b < B; b += 32) o[b] = s[b] / sum;
  }
}

// Block b is (image g, row tile): rows a0 .. a0 + 3.  Warp w is column
// tile w % col_warps of each group of col_warps tiles and k slice
// w / col_warps.  kExactO: W2 is [K, 2]; kV: 4 (16-byte loads) or 1;
// kFastDot: the tile routine's bf16 fast dot (the FMA form of the bf16
// mode, for small grids).
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

  masked_softmax(sc, T::kRows, t.g, t.a0, p.A, B, box_valid, p.out);
}

// The bf16 mode: the header's dot_block (block b: image g, group of
// mentions, all its boxes); slice 0's lanes l % 4 == 0 hold column 0 of
// rows l / 4 and l / 4 + 8 and leave the scores in shared memory, then
// the masked softmax.
template <int kBT, bool kVec>
__global__ void __launch_bounds__(kDotWarps * 32, 2)
affinity_rank_bf16dot_kernel(const DotArgs p,
                             const uint8_t* __restrict__ box_valid) {
  using T = DotTile<kBT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(
      smem + dot_smem(kBT, p.chunks, blockDim.x >> 5, 0, false));
  const int lane = threadIdx.x & 31;
  const float bias = __ldg(p.b2 + p.col);
  dot_block<kBT, kVec>(p, smem, [&](const DotAcc<kBT>& acc, int,
                                    int a0, int b0) {
    if ((lane & 3) != 0) return;
#pragma unroll
    for (int i = 0; i < DotTile<kBT>::kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = kBT == 16 ? a0 + i : a0 + 2 * i + h;
        const int b = b0 + (lane >> 2) + (kBT == 16 ? 8 * h : 0);
        if (a < p.A && b < p.B) sc[(a - a0) * p.B + b] = acc[i][2 * h] + bias;
      }
    }
  });
  __syncthreads();
  const int g = blockIdx.x / p.row_groups;
  masked_softmax(sc, T::kMentions, g, (blockIdx.x % p.row_groups) *
                 T::kMentions, p.A, p.B, box_valid, p.out);
}

template <bool kFastDot>
int launch_tile(const float* X, const float* Y, const float* b1,
                const float* W2, const float* b2, const uint8_t* box_valid,
                float* out, int G, int A, int B, int K, int O, int col,
                int ksplit, int device, void* stream) {
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

int launch_bf16dot(const float* X, const float* Y, const float* b1,
                   const float* W2, const float* b2,
                   const uint8_t* box_valid, float* out, int G, int A, int B,
                   int K, int O, int col, int ksplit, int device,
                   void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || col < 0 || col >= O)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DotArgs p = {};
  p.X = X, p.Y = Y, p.b1 = b1, p.W2 = W2, p.b2 = b2, p.out = out;
  p.G = G, p.A = A, p.B = B, p.K = K, p.O = O, p.col = col;
  int vec, bt;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_dot(p, ksplit, true, &vec, &bt, &blocks, &threads, &smem))
    return (int)cudaErrorInvalidValue;
#define ICL_CALL(kBT, kVec)                                                  \
  do {                                                                       \
    if (smem > 48 * 1024) {                                                  \
      err = cudaFuncSetAttribute(affinity_rank_bf16dot_kernel<kBT, kVec>,    \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                                 \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    affinity_rank_bf16dot_kernel<kBT, kVec>                                  \
        <<<blocks, threads, smem, (cudaStream_t)stream>>>(p, box_valid);     \
  } while (0)
  if (bt == 16) {
    if (vec) ICL_CALL(16, true); else ICL_CALL(16, false);
  } else {
    if (vec) ICL_CALL(8, true); else ICL_CALL(8, false);
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
  return launch_tile<false>(X, Y, b1, W2, b2, box_valid, out, G, A, B, K, O,
                            col, ksplit, device, stream);
}

// The same call in the bf16 fast-dot mode's FMA form, for small grids
// (icl_torch/ops/affinity_rank.py takes it below the fast dot's work
// threshold): the f32 launch shape, the tile routine's kFastDot.
extern "C" int icl_affinity_rank_bf16fma(const float* X, const float* Y,
                                         const float* b1, const float* W2,
                                         const float* b2,
                                         const uint8_t* box_valid,
                                         float* out, int G, int A, int B,
                                         int K, int O, int col, int ksplit,
                                         int device, void* stream) {
  return launch_tile<true>(X, Y, b1, W2, b2, box_valid, out, G, A, B, K, O,
                           col, ksplit, device, stream);
}

// The same call in the bf16 fast-dot mode: the scores are the fast-dot
// grid head's column, as the reference ranks the fast-dot logits it writes,
// from the tensor cores.  A block is one group of mentions with all its
// boxes, min(box tiles, 8) x ksplit warps, at most 8 (icl_torch/ops/
// grid_head.py dot_plan picks ksplit); W2 is read in any alignment.
extern "C" int icl_affinity_rank_bf16dot(const float* X, const float* Y,
                                         const float* b1, const float* W2,
                                         const float* b2,
                                         const uint8_t* box_valid,
                                         float* out, int G, int A, int B,
                                         int K, int O, int col, int ksplit,
                                         int device, void* stream) {
  return launch_bf16dot(X, Y, b1, W2, b2, box_valid, out, G, A, B, K, O,
                        col, ksplit, device, stream);
}
