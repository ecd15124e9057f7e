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
// The bf16 mode (icl_grid_head_bf16dot, grid_head_bf16dot_kernel): the
// tile routine's fast dot, the reference's fast_dot of both Pallas bodies
// (the activation and W2 rounded to bf16, f32 sums); f32 in and out, the
// same launch shape.  It runs the f32 mode's FMAs, so it is no faster; a
// tensor-core design (mma.sync bf16, N padded from O = 2 or 4 to 8) is
// later work.
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

// The bf16 mode, a kernel of its own with one block an SM in its launch
// bounds: under the f32 kernel's bounds ptxas held the scalar generic form
// (kO = 8, kV = 1) to 64 registers and spilled 12 bytes; told that one
// block an SM is enough, it takes the 90 it needs (122-156 in the other
// forms), and the f32 kernel stays as it was.
template <int kO, bool kExactO, int kV>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
grid_head_bf16dot_kernel(const HeadArgs p) {
  __shared__ float red[kRedFloats];
  float logit[kO];
  const TileCoords t = tile_coords<kO>(p);
  head_tile_logits<kO, kExactO, kV, false, false, false, true>(p, t, red,
                                                              logit);
  if (t.owner) store_cell<kO, kExactO>(p.out + t.cell * p.O, logit, p.O);
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
      grid_head_bf16dot_kernel<kO, kExactO, kV>            \
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

// The same call in the bf16 fast-dot mode.
extern "C" int icl_grid_head_bf16dot(const float* X, const float* Y,
                                     const float* b1, const float* W2,
                                     const float* b2, float* out, int G,
                                     int A, int B, int K, int O, int ksplit,
                                     int device, void* stream) {
  return launch<true>(X, Y, b1, W2, b2, out, G, A, B, K, O, ksplit, device,
                      stream);
}
