// Fused M x M grid head, f32, for Hopper (sm_90a):
//
//     out[g, a, b, :] = relu(X[g, a] + b1 + Y[g, b]) . W2 + b2
//
// Replaces: icl/ops/grid_head.py grid_head_pallas, both of its Pallas bodies
// (K1 _flat_kernel, one tile per image with a transposed [O, A*B] output,
// and K2 _kernel, (8, 128) tiles for large grids).  Both layouts existed for
// the TPU's 128-lane vregs; here one kernel covers every grid size and
// writes the public [G, A, B, O] layout directly.
//
// What bounds it on the H100: the [A, B, K] activation is the only large
// intermediate (relation K=800: 3.2 KB per cell) and it never leaves the
// registers.  Per element there are 2 + O float instructions against 4
// bytes of Y from L2, so the instruction rate sets the pace once the loads
// are wide and shared by a register tile of cells; at the served shapes
// (G <= 8, M <= 32) the whole call is a few microseconds and the launch
// itself is a large share, so K is split over the warps of a block to put
// a single image on more than a handful of warps.
//
// Design: the tile routine of grid_head_tile.cuh (a 4 x 4 register tile of
// cells a warp, 16-byte loads, transpose-reduce, K split for small grids),
// here without dropout; each cell's owner lane stores its O logits in one
// 16- or 8-byte store.  No atomics: a response is bitwise repeatable.
//
// The bf16 mode, the reference's fast_dot of both Pallas bodies (the
// activation and W2 rounded to bf16, f32 sums), f32 in and out, in two
// forms that icl_torch/ops/grid_head.py dot_plan picks between by the
// grid's work.  On large grids (icl_grid_head_bf16dot,
// grid_head_bf16dot_kernel) it runs on the tensor cores: the header's
// mma.sync routine (dot_block), a block a group of 8 mentions with its
// boxes, X + b1 and W2's bf16 fragments staged once a block in shared
// memory, Y through a cp.async ring a warp, K split over the warps of a
// block; per element 1.5 instructions where the FMA form runs 2 + O and
// two conversions.  On small grids, where that block's set-up costs more
// than the whole call, the FMA form (icl_grid_head_bf16fma,
// grid_head_bf16fma_kernel): the tile routine's kFastDot in the f32
// kernel's launch shape.
#include "grid_head_tile.cuh"

namespace {

using namespace icl_head;

template <int kO, bool kExactO, int kV>
__global__ void __launch_bounds__(kMaxWarps * 32)
grid_head_kernel(const HeadArgs p) {
  __shared__ float red[kRedFloats];
  float logit[kO];
  const TileCoords t = tile_coords<kO>(p);
  head_tile_logits<kO, kExactO, kV, false, false>(p, t, red, logit);
  if (t.owner) store_cell<kO, kExactO>(p.out + t.cell * p.O, logit, p.O);
}

// The bf16 mode on small grids (the FMA form, icl_grid_head_bf16fma): the
// tile routine's fast dot (kFastDot: the activation and W2 rounded to bf16
// an element, f32 FMAs) in the f32 kernel's launch shape, a kernel of its
// own with one block an SM in its launch bounds (under the f32 kernel's,
// ptxas held the scalar generic form to 64 registers and spilled).
template <int kO, bool kExactO, int kV>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
grid_head_bf16fma_kernel(const HeadArgs p) {
  __shared__ float red[kRedFloats];
  float logit[kO];
  const TileCoords t = tile_coords<kO>(p);
  head_tile_logits<kO, kExactO, kV, false, false, false, true>(p, t, red,
                                                              logit);
  if (t.owner) store_cell<kO, kExactO>(p.out + t.cell * p.O, logit, p.O);
}

// The bf16 mode: the header's dot_block (block b: image g, group of
// mentions), then each lane of slice 0 stores columns 2 (l % 4) + {0, 1}
// of rows l / 4 and l / 4 + 8 of each m-tile, those below O of the cells
// inside the grid.
template <int kBT, bool kVec>
__global__ void __launch_bounds__(kDotWarps * 32, 2)
grid_head_bf16dot_kernel(const DotArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, n = 2 * (lane & 3);
  dot_block<kBT, kVec>(p, smem, [&](const DotAcc<kBT>& acc, int g,
                                    int a0, int b0) {
    if (n >= p.O) return;
    const float c0 = __ldg(p.b2 + n);
    const float c1 = n + 1 < p.O ? __ldg(p.b2 + n + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < DotTile<kBT>::kTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = kBT == 16 ? a0 + i : a0 + 2 * i + h;
        const int b = b0 + (lane >> 2) + (kBT == 16 ? 8 * h : 0);
        if (a < p.A && b < p.B) {
          float* dst = p.out + (((size_t)g * p.A + a) * p.B + b) * p.O + n;
          const float v0 = acc[i][2 * h] + c0, v1 = acc[i][2 * h + 1] + c1;
          if (p.O % 2 == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < p.O) dst[1] = v1;
          }
        }
      }
    }
  });
}

int launch_bf16dot(const float* X, const float* Y, const float* b1,
                   const float* W2, const float* b2, float* out, int G, int A,
                   int B, int K, int O, int ksplit, int device, void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || O <= 0 || O > kMaxO)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DotArgs p = {};
  p.X = X, p.Y = Y, p.b1 = b1, p.W2 = W2, p.b2 = b2, p.out = out;
  p.G = G, p.A = A, p.B = B, p.K = K, p.O = O, p.col = -1;
  int vec, bt;
  unsigned blocks, threads;
  size_t smem;
  if (!plan_dot(p, ksplit, false, &vec, &bt, &blocks, &threads, &smem))
    return (int)cudaErrorInvalidValue;
#define ICL_CALL(kBT, kVec)                                                  \
  do {                                                                       \
    if (smem > 48 * 1024) {                                                  \
      err = cudaFuncSetAttribute(grid_head_bf16dot_kernel<kBT, kVec>,        \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                                 \
      if (err != cudaSuccess) return (int)err;                               \
    }                                                                        \
    grid_head_bf16dot_kernel<kBT, kVec>                                      \
        <<<blocks, threads, smem, (cudaStream_t)stream>>>(p);                \
  } while (0)
  if (bt == 16) {
    if (vec) ICL_CALL(16, true); else ICL_CALL(16, false);
  } else {
    if (vec) ICL_CALL(8, true); else ICL_CALL(8, false);
  }
#undef ICL_CALL
  return (int)cudaGetLastError();
}

template <bool kFastDot>
int launch(const float* X, const float* Y, const float* b1, const float* W2,
           const float* b2, float* out, int G, int A, int B, int K, int O,
           int ksplit, int device, void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0 || O <= 0 || O > kMaxO)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HeadArgs p = {};
  p.X = X, p.Y = Y, p.b1 = b1, p.W2 = W2, p.b2 = b2, p.out = out;
  p.A = A, p.B = B, p.K = K, p.O = O;
  int vec;
  unsigned blocks, threads;
  if (!plan_launch(p, G, ksplit, &vec, &blocks, &threads))
    return (int)cudaErrorInvalidValue;
#define ICL_CALL(kO, kExactO, kV)                          \
  do {                                                     \
    if constexpr (kFastDot)                                \
      grid_head_bf16fma_kernel<kO, kExactO, kV>            \
          <<<blocks, threads, 0, (cudaStream_t)stream>>>(p); \
    else                                                   \
      grid_head_kernel<kO, kExactO, kV>                    \
          <<<blocks, threads, 0, (cudaStream_t)stream>>>(p); \
  } while (0)
  ICL_HEAD_DISPATCH(O, vec, ICL_CALL);
#undef ICL_CALL
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (a cudaStream_t from the caller) on `device`.
// Returns the cudaError_t of the launch: 0 on success.  G, A and B must be
// positive (the caller handles an empty grid without a launch), 1 <= O <= 8.
// ksplit warps of a block split K (1 <= ksplit <= 8; icl_torch/ops/
// grid_head.py launch_plan picks it); the 16-byte form is taken when X, Y,
// b1 and W2 are 16-byte aligned and K % 4 == 0 (plan_launch).
extern "C" int icl_grid_head_f32(const float* X, const float* Y,
                                 const float* b1, const float* W2,
                                 const float* b2, float* out, int G, int A,
                                 int B, int K, int O, int ksplit, int device,
                                 void* stream) {
  return launch<false>(X, Y, b1, W2, b2, out, G, A, B, K, O, ksplit, device,
                       stream);
}

// The same call in the bf16 fast-dot mode's FMA form, for small grids
// (icl_torch/ops/grid_head.py takes it below its work threshold): the f32
// launch shape and form rules, launch_plan's ksplit.
extern "C" int icl_grid_head_bf16fma(const float* X, const float* Y,
                                     const float* b1, const float* W2,
                                     const float* b2, float* out, int G,
                                     int A, int B, int K, int O, int ksplit,
                                     int device, void* stream) {
  return launch<true>(X, Y, b1, W2, b2, out, G, A, B, K, O, ksplit, device,
                      stream);
}

// The same call in the bf16 fast-dot mode, on the tensor cores.  ksplit
// warps of a block split K (1 <= ksplit <= 8; icl_torch/ops/grid_head.py
// dot_plan picks it); the 16-byte loads are taken when X, Y and b1 are
// 16-byte aligned and K % 4 == 0 (plan_dot).  W2 is read in any alignment.
extern "C" int icl_grid_head_bf16dot(const float* X, const float* Y,
                                     const float* b1, const float* W2,
                                     const float* b2, float* out, int G,
                                     int A, int B, int K, int O, int ksplit,
                                     int device, void* stream) {
  return launch_bf16dot(X, Y, b1, W2, b2, out, G, A, B, K, O, ksplit, device,
                        stream);
}
