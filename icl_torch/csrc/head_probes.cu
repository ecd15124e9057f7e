// Two measuring kernels beside the grid head, f32/int32, for Hopper
// (sm_90a).  They replace no TPU kernel and no path runs them: they give
// the grid-head kernels' bounds their two yardsticks on the card at hand.
//
//  * icl_probe_empty: a kernel of one thread that does nothing.  Its device
//    time is the floor under any launch: the served grid-head calls, whose
//    bytes and operations come to 0.0002-0.0003 ms, are read against it.
//  * icl_probe_hash_u32: the dropout hash of grid_head_tile.cuh alone, over
//    every element (g, a, b, k) of a grid: one warp per cell, lanes over k,
//    four independent chains a lane, and the cell's count of kept elements
//    as the only output (4 bytes a cell).  No loads, no float work: its
//    time is what the hash's ten 32-bit integer operations an element cost
//    (xor, two rounds of shift-xor-multiply, shift-xor, compare), and so
//    the rate at which the integer pipe runs them.  The forward kernels
//    (K5, K7, K8) run exactly this hash per element.
#include "grid_head_tile.cuh"

namespace {

using namespace icl_head;

constexpr int kHashWarps = 8;

__global__ void empty_kernel() {}

__global__ void __launch_bounds__(kHashWarps * 32)
hash_kernel(const int* __restrict__ seeds, int* __restrict__ kept,
            long long cells, int A, int B, int K, uint32_t thr) {
  const long long cell =
      (long long)blockIdx.x * kHashWarps + (threadIdx.x >> 5);
  if (cell >= cells) return;
  const int lane = threadIdx.x & 31;
  const int b = (int)(cell % B);
  const int a = (int)((cell / B) % A);
  const int g = (int)(cell / ((long long)A * B));
  const uint32_t key = hash32(
      hash32(hash32((uint32_t)seeds[g]) ^ (uint32_t)a) ^ (uint32_t)b);
  int n[4] = {0, 0, 0, 0};
  int k = lane;
  for (; k + 96 < K; k += 128) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      n[i] += hash32(key ^ (uint32_t)(k + 32 * i)) >= thr ? 1 : 0;
  }
  for (; k < K; k += 32) n[0] += hash32(key ^ (uint32_t)k) >= thr ? 1 : 0;
  const int total = __reduce_add_sync(kFull, n[0] + n[1] + n[2] + n[3]);
  if (lane == 0) kept[cell] = total;
}

}  // namespace

// Both launch on `stream` (a cudaStream_t from the caller) on `device` and
// return the cudaError_t of the launch: 0 on success.
extern "C" int icl_probe_empty(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// kept [G, A, B] int32: per cell, how many k in [0, K) the mask keeps
// (hash >= thr), with the key of (seeds[g], a, b) as in the head kernels.
extern "C" int icl_probe_hash_u32(const int* seeds, int* kept, int G, int A,
                                  int B, int K, uint32_t thr, int device,
                                  void* stream) {
  if (G <= 0 || A <= 0 || B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)G * A * B;
  const long long blocks = (cells + kHashWarps - 1) / kHashWarps;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  hash_kernel<<<(unsigned)blocks, kHashWarps * 32, 0, (cudaStream_t)stream>>>(
      seeds, kept, cells, A, B, K, thr);
  return (int)cudaGetLastError();
}
