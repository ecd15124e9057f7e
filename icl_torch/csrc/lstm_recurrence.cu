// Masked Keras LSTM recurrence, forward, f32 and bf16, for Hopper (sm_90a).
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
// What bounds it on the H100: operations.  The L steps are a sequential
// chain of [rows, H] x [H, 4H] products in f32 FMAs; the bytes (x_proj in,
// hs out) take a tenth of that time.  One TF32 pass on the tensor cores
// keeps an 11-bit significand and breaks the 1e-5 gate.  Three passes
// (hi = tf32(x), lo = tf32(x - hi), a . b as a_lo . b_hi + a_hi . b_lo +
// a_hi . b_hi a chunk of 8 k's, the chunks added in k order) lose about
// 2^-22 of a product and hold it, but on the H100 such a phase A was no
// faster than these FMAs: the SM clock falls while the tensor cores run,
// and the split R fragments double phase A's shared-memory reads (PERF.md,
// PR 14).  What stands in the way of the bound is R[g]: H x 4H f32 is
// 640 KB at H=200, and a block has 227 KB of shared memory.  A first design
// streamed R from L2 in every step of every block, which cost one SM's L2
// bandwidth (about 10 us a step) whatever the batch.
//
// Design: R stays on chip for all L steps, split over a thread-block
// cluster with distributed shared memory.
//  * A cluster of kCluster = 8 blocks owns one group g and two tiles of
//    kTile = 8 batch rows.  Block r of the cluster owns the hidden units
//    [r*Hc, (r+1)*Hc), Hc = ceil(H / 8), and loads, once, the matching
//    columns of all four gate slabs of R[g] into its shared memory, as
//    [k][unit] float4 = the unit's (i, f, c~, o) weights: 80 KB at H=200,
//    128 KB at H=256.  For each tile it also holds the full h [H][8]
//    (k-major: a k's rows are two float4s) in two buffers.
//  * Each half of the block's 16 warps runs one of the two tiles, with its
//    own named barrier, in its own time: the two halves share the slice of
//    R (a second block on the SM would need a second copy, and there is no
//    room), and while one half adds partial sums, applies the gates or
//    waits for its peers' h, the other half's FMAs keep the SM busy.
//  * A step of a half.  A: warp s of its kSplit = 8 warps sums its eighth
//    of k for every unit (lane = unit) into a register tile of 8 rows x 4
//    gates: per k one 16-byte load of R and two broadcast 16-byte loads of
//    h feed 32 FMAs, so FMA issue, not shared-memory bandwidth, is the
//    limit.  The partial tiles go to shared memory.  B: after the half's
//    barrier, thread (s, unit) finishes row s of its unit: it adds the
//    kSplit partials in a fixed order (no atomics: bitwise repeatable) to
//    x_proj (loaded a step ahead), applies the gates and the mask with c
//    and h of that row in registers, and writes the new h into the other h
//    buffer of its own block.  After a second barrier the half's threads
//    push the block's units of the new h, 16 bytes each (st.async through
//    distributed shared memory), to the 7 peers, which wait for it; only
//    then do they load the next step's x_proj and mask and write hs and
//    the residuals to device memory, from registers.
//  * Hand-over of h without a cluster-wide barrier.  Every st.async
//    reports its bytes to an mbarrier of the *receiving* block, one per
//    tile and h buffer, armed with the bytes the peers' units take; a half
//    starts step t + 1 when its own barrier says the buffer is whole,
//    however far other tiles' work has come.  (A first version ended each
//    step with barrier.cluster arrive.release / wait.acquire; the release
//    alone took a fifth of the step.)  Two buffers are enough: a block can
//    only be sent the h of step t + 1 by peers that have the whole h of
//    step t, which this block sent after it last read the buffer that the
//    new h overwrites.  The one cluster barrier is at the start: every
//    block's barriers and buffers exist before a peer writes to them.
//  * The gates use ex2.approx-based exp and the fast divide: sigmoid(x) =
//    1 / (1 + __expf(-x)), tanh(x) = 2 sigmoid(2x) - 1.  Their absolute
//    error is that of one f32 rounding (about 1e-7), a hundredth of the
//    1e-5 gate, and the exact expf / tanhf / IEEE divide made phase B a
//    third longer.
//  * Rows beyond B and units beyond H read the last valid one's inputs and
//    store nothing; a half whose tile lies beyond B leaves after the
//    cluster barrier.
//
// Wider LSTMs (256 < H <= 512): the same kernel over a cluster of
// kWideCluster = 16 blocks (a non-portable cluster size, which the H100
// takes), so a block still owns at most 32 units, one a lane.  Up to H =
// 368 a block's slice of R (91 KB at H = 300) still fits its shared memory
// beside the h buffers and the partial tiles.  Above, it does not (262 KB
// at 512), and phase A reads R from device memory instead, four coalesced
// loads a k (the unit's i, f, c~, o weights), every step, from L2: a step
// takes several times as long as with R on chip.  Everything else, the
// order of every sum included, is the narrow kernel's.  That is the f32
// mode's layout alone: the bf16 mode's R, half the bytes, stays on chip
// at 512.
//
// The bf16 mode (icl_lstm_recurrence_bf16): x_proj, R, hs, h_final and the
// residuals are __nv_bfloat16 in device memory, half the bytes; the
// semantics are the reference's lax.scan at compute_dtype=bf16
// (icl/models/rnn.py lstm_recurrence, whose TPU kernel is the bf16 mode of
// _stream_kernel in icl/ops/lstm_kernel.py: jnp.dot(h, R,
// preferred_element_type=f32) on the MXU, bf16 products summed in f32).
// The kernel rounds to bf16 where the plain version (eager PyTorch ops on
// bf16 tensors, lstm_recurrence_reference) rounds, each op computed in f32
// and rounded once:
//   d = bf16(h . R)              the batched matmul's output
//   z = bf16(x_proj + d)
//   i, f, o = bf16(sigmoid(z)), c~ = bf16(tanh(z))
//   c = bf16(bf16(f * c_prev) + bf16(i * c~))
//   h = bf16(o * bf16(tanh(c)))
// and the masked carry copies values.  The gates here are expf with an
// IEEE divide and tanhf, the functions PyTorch's own bf16 sigmoid and tanh
// evaluate in f32: an approximate gate would move a value across a bf16
// rounding boundary now and then.
//
// Its phase A runs on the tensor cores: mma.sync m16n8k16 bf16 with f32
// sums, the MXU's operation.  "Swap A and B": M = the block's 4 Hc
// unit-gate columns (row m = unit m / 4, gate m % 4, so phase B reads a
// unit's four sums as one float4), N = the tile's 8 rows, K = H padded to
// 16.  R[g]'s slice is loaded once, as bf16, in the A fragments' register
// order ([m-tile][k-step][lane] x 8 values, one 16-byte load a lane and
// k-step, no bank conflict): 46 KB a block at H = 200, 128 KB at 512, so R
// stays on chip at every width and the from-memory layout serves f32
// alone.  Warp s of a half owns m-tile s (4 Hc <= 128: at most 8 tiles)
// and walks all of K, so its sums are whole and go to one [T][M] tile
// with no cross-warp sum.  h keeps the f32 hand-over; a lane reads its B
// values from the f32 buffer (bf16 values, so the conversion is exact),
// the k's of a lane's four slots taken as tig + {0, 4, 8, 12} of the chunk
// so that each load is one bank a lane.  The order of the sum: each chunk
// of 16 k's is one mma from a zero accumulator, and the chunks are added
// in f32 in k order (the mma's own sum of 16 products is not an IEEE
// sequence of additions; the chunked order keeps its effect inside one
// chunk, and the chunks' mma's do not wait on each other).  Units beyond
// H, rows beyond 4 Hc and k beyond H hold +0 in R and are read as +0 from
// h (stale shared memory could hold a NaN, and NaN . 0 is NaN).  What stays
// apart from the plain version is the order of the h . R sum, which moves
// a rounded d by one bf16 unit where the sum lies near a boundary, and
// that unit travels down the steps.  Where two blocks' shared memory fits
// an SM (H = 200: 78 KB a block) and the grid is larger than one wave of
// one block an SM, or the cluster is 16 blocks, the launch takes an
// instantiation capped at 64 registers a thread, so two blocks of 512
// threads share an SM and a large batch needs half the waves; a build
// with -DICL_LSTM_BF16_BLOCKS=1 or =2 takes one or two wherever two fit
// (lstm_phase_clocks.py --bf16 times both beside the rule).
//
// Compiled with -DICL_LSTM_CLOCKS the kernel also adds up, for thread 0 of
// block (0, 0), the cycles of each phase of a step (icl_torch/tools/
// lstm_phase_clocks.py reads them): the machine this runs on has no
// profiler that sees inside a kernel.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks per cluster: each owns ceil(H/8) units
constexpr int kWideCluster = 16;  // above kMaxNarrowH: R read from memory
constexpr int kMaxNarrowH = kCluster * 32;       // a unit a lane: 256
constexpr int kMaxH = kWideCluster * 32;         // 512
constexpr int kSplit = 8;    // warps per half block, splitting the k reduction
constexpr int kTile = 8;     // batch rows per tile: one per warp in phase B
constexpr int kHalf = kSplit * 32;   // threads per half block (one tile)
static_assert(kTile == kSplit && kTile == 8,
              "phase B gives each warp one row; phase A reads a k's rows as two "
              "float4s");

#ifdef ICL_LSTM_CLOCKS
__device__ long long g_clocks[8];
#define TICK(i)                                \
  {                                            \
    const long long now = clock64();           \
    if (probe) g_clocks[i] += now - tick;      \
    tick = now;                                \
  }
#else
#define TICK(i)
#endif

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.f * sigmoid(2.f * x) - 1.f;
}

// the bf16 mode's gates: PyTorch's f32 evaluation of its bf16 sigmoid
__device__ __forceinline__ float sigmoid_ieee(float x) {
  return 1.f / (1.f + expf(-x));
}

// x rounded to bf16 (nearest even): its 16 bits (one cvt.rn.bf16.f32), and
// the value widened back, exact in f32
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  uint16_t b;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(x));
  return b;
}
__device__ __forceinline__ float bf16r(float x) {
  return __uint_as_float((uint32_t)bf16_bits(x) << 16);
}

// device memory <-> the kernel's f32 registers
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // v is a bf16 value already: exact
  *reinterpret_cast<unsigned short*>(p) = bf16_bits(v);
}

// two f32 values that bf16 represents exactly, as one bf16x2 register: lo
// in the low half, as an mma fragment holds the lower k
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d = A . B from a zero accumulator: one 16 x 8 x 16 bf16 product, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
        "f"(0.f));
}

// The bf16 mode's tiles: m-tiles of 16 unit-gate columns (a block's 4 Hc),
// k-steps of 16, and a row of the [T][M] tile of sums, padded by 4 floats
// so that the fragments' stores hit 32 banks
__host__ __device__ __forceinline__ int m_tiles(int Hc) {
  return (4 * Hc + 15) / 16;
}
__host__ __device__ __forceinline__ int k_steps(int H) {
  return (H + 15) / 16;
}
__host__ __device__ __forceinline__ int d_row(int Hc) {
  return 16 * m_tiles(Hc) + 4;
}

// 16-byte vectors of R on chip a block: f32 [H][Hc] x (i, f, c~, o) when
// resident; bf16 the mma A fragments [m-tile][k-step][lane] x 8 values
__host__ __device__ __forceinline__ size_t r_vectors(bool bf16,
                                                     bool resident, int H,
                                                     int Hc) {
  if (bf16) return (size_t)m_tiles(Hc) * k_steps(H) * 32;
  return resident ? (size_t)H * Hc : 0;
}

// floats of a half's sums of h . R: f32 the kSplit warps' partial tiles
// [kSplit][T][Hc] x 4; bf16 one [T][d_row] tile
__host__ __device__ __forceinline__ size_t part_floats(bool bf16, int Hc) {
  return bf16 ? (size_t)kTile * d_row(Hc)
              : (size_t)4 * kSplit * kTile * Hc;
}

// barrier of one half block (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + half), "n"(kHalf) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of this block's shared-memory address `addr` in block `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(arrivals) : "memory");
}

// one arrival, and `bytes` more to be reported by st.async, in this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// four floats to a peer's shared memory, their bytes reported to its barrier
__device__ __forceinline__ void send4(uint32_t dst, uint32_t bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// E: the element type of device memory, float or __nv_bfloat16 (the bf16
// mode); on chip everything is f32 but the bf16 mode's R.  NC: blocks a
// cluster, kCluster or kWideCluster.  kResident: R in shared memory, else
// read from device memory every step (f32 only).  kMinBlocks: blocks an SM
// the registers are capped for (2: 64 a thread; the bf16 mode only).
template <typename E, int NC, bool kResident, int kMinBlocks>
__global__ void __launch_bounds__(2 * kHalf, kMinBlocks)
lstm_cluster_kernel(const E* __restrict__ xp,
                    const uint8_t* __restrict__ mask,
                    const E* __restrict__ R, E* __restrict__ hs,
                    E* __restrict__ h_final, E* __restrict__ gates,
                    E* __restrict__ cs, int L, int B, int H) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  static_assert(kResident || !kBf16, "the bf16 mode keeps R on chip");
  static_assert(kMinBlocks == 1 || kBf16, "f32 runs one block an SM");
  // the push's 16-byte vectors a thread sends: 2 (NC = 8) or 4 (NC = 16)
  constexpr int kPush = ((NC - 1) * 64 + kHalf - 1) / kHalf;
  constexpr int T = kTile;
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t full[2][2];  // [half][buffer]: h is whole
  const int Hc = (H + NC - 1) / NC;
  const int half = threadIdx.x / kHalf;
  const int ht = threadIdx.x - half * kHalf;
  float4* Rs = smem4;                                   // [H][Hc] x (i,f,c~,o)
  float* h0 = reinterpret_cast<float*>(
      Rs + r_vectors(kBf16, kResident, H, Hc));
  float* hbuf = h0 + half * 2 * H * T;                  // [2][H][T], this half's
  float* sums = h0 + 4 * H * T + half * part_floats(kBf16, Hc);
  float4* part = reinterpret_cast<float4*>(sums);       // f32: [kSplit][T][Hc]
  // bf16: the A fragments of R (r_vectors) and the [T][Ms] tile of sums
  const uint4* Rf = reinterpret_cast<const uint4*>(smem4);
  const int nks = k_steps(H);
  const int Ms = d_row(Hc);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y;
  const int b0 = ((blockIdx.x / NC) * 2 + half) * T;   // the tile's row 0
  const int s = ht >> 5;
  const int ul = ht & 31;
  const int u = rank * Hc + ul;                 // the hidden unit of this lane
  const bool active = ul < Hc && u < H;
  const int H4 = 4 * H;
  const int kc = (H + kSplit - 1) / kSplit;
  const int k0 = s * kc;
  const int k1 = min(H, k0 + kc);

  // once: this block's columns of R[g], h = 0, and the barriers
  const E* Rg = R + (size_t)g * H * H4;
  if constexpr (kBf16) {
    // A fragment of m-tile mt, k-step ks, lane: register j holds row
    // gid + 8 (j & 1) and, low half then high, the k's tig + 8 (j >> 1)
    // and that + 4 of the chunk (phase A reads h at the same k's); zero
    // outside the block's units and beyond H
    const unsigned short* Rb = reinterpret_cast<const unsigned short*>(Rg);
    const int nv = (int)r_vectors(true, true, H, Hc);
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const int lane = i & 31;
      const int ks = (i >> 5) % nks;
      const int mt = (i >> 5) / nks;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mt * 16 + (lane >> 2) + (j & 1) * 8;
        const int uu = rank * Hc + (m >> 2);
        const int k = ks * 16 + (lane & 3) + (j >> 1) * 8;
        uint32_t lo = 0u, hi = 0u;
        if ((m >> 2) < Hc && uu < H) {
          const unsigned short* p = Rb + (size_t)(m & 3) * H + uu;
          if (k < H) lo = __ldg(p + (size_t)k * H4);
          if (k + 4 < H) hi = __ldg(p + (size_t)(k + 4) * H4);
        }
        w[j] = lo | (hi << 16);
      }
      reinterpret_cast<uint4*>(smem4)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int i = threadIdx.x; kResident && i < H * Hc; i += blockDim.x) {
      const int k = i / Hc;
      const int uu = rank * Hc + (i - k * Hc);
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (uu < H) {
        const E* p = Rg + (size_t)k * H4 + uu;
        w = make_float4(load_f32(p), load_f32(p + H), load_f32(p + 2 * H),
                        load_f32(p + 3 * H));
      }
      Rs[i] = w;
    }
  }
  for (int i = ht; i < H * T; i += kHalf) hbuf[i] = 0.f;
  const uint32_t bars = smem_addr(full[half]);
  // a whole h less this block's own units, which it writes itself
  const int own = max(0, min(Hc, H - rank * Hc));
  const uint32_t h_bytes = (uint32_t)((H - own) * T * sizeof(float));
  if (ht == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (L > 1) mbar_expect(bars + 8, h_bytes);   // step 1 reads buffer 1
    if (L > 2) mbar_expect(bars, h_bytes);       // step 2 reads buffer 0
  }
  // every block of the cluster runs, and its R, h and barriers are in
  // place, before any peer writes into its shared memory
  cluster.sync();
  if (b0 >= B) return;   // no second tile: the same half of every peer

  // x_proj and the mask of step t for this thread's row; a row beyond B or
  // a unit beyond H reads the last valid one's (and stores nothing), so no
  // load waits on a condition
  const int b = b0 + s;
  const bool stores = active && b < B;
  const E* xrow = xp + ((size_t)g * L * B + min(b, B - 1)) * H4
                 + min(u, H - 1);
  const uint8_t* mrow = mask + (size_t)g * L * B + min(b, B - 1);
  float c = 0.f, h = 0.f, zx[4];
  uint8_t m;
  auto load_step = [&](int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      zx[q] = load_f32(xrow + (size_t)t * B * H4 + q * H);
    m = __ldg(mrow + (size_t)t * B);
  };
  load_step(0);

  // The push's addresses do not change from step to step: this thread
  // sends vector i = ht + j * kHalf, where the NC - 1 peers' share of the
  // block's units has that many 16-byte vectors (at most (NC - 1) * 64),
  // of the block's units of h to peer i / nvec.  Kept for buffer 0;
  // buffer 1 lies H * T floats further in every block.
  const int nvec = own * (T / 4);
  uint32_t push_src[kPush], push_dst[kPush], push_bar[kPush];
#pragma unroll
  for (int j = 0; j < kPush; ++j) {
    const int i = ht + j * kHalf;
    const bool sends = i < (NC - 1) * nvec;
    const int peer = sends ? i / nvec : 0;
    const int dst = (rank + 1 + peer) % NC;
    push_src[j] = (uint32_t)sizeof(float) * (rank * Hc * T)
                  + 16u * (i - peer * nvec);
    push_dst[j] = sends ? peer_addr(smem_addr(hbuf) + push_src[j], dst) : 0u;
    push_bar[j] = peer_addr(bars, dst);
  }
  const uint32_t buf_bytes = (uint32_t)(H * T * sizeof(float));
#ifdef ICL_LSTM_CLOCKS
  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  long long tick = clock64();
#endif
  for (int t = 0; t < L; ++t) {
    const int cur = t & 1;
    if (t > 0) {
      mbar_wait(bars + 8 * cur, ((t - 1) >> 1) & 1);
      // the buffer's next whole h is the one step t + 2 reads
      if (ht == 0 && t + 2 < L) mbar_expect(bars + 8 * cur, h_bytes);
    }
    TICK(0)
    if constexpr (kBf16) {
      // phase A on the tensor cores: warp s, m-tile s, all of K; chunk
      // ks's 16 products from a zero accumulator, the chunks added in k
      // order.  Lane (gid, tig) holds h[row gid] at the chunk's k's tig +
      // {0, 4, 8, 12}: 32 lanes, 32 banks a load.  Only the last chunk
      // reaches past H, and reads +0 there.
      if (s < m_tiles(Hc)) {
        const int gid = ul >> 2;
        const int tig = ul & 3;
        const float* hp = hbuf + cur * H * T + tig * T + gid;
        const uint4* a = Rf + (size_t)s * nks * 32 + ul;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        auto chunk = [&](int ks, float v0, float v4, float v8, float v12) {
          float d[4];
          mma_bf16(d, a[ks * 32], bf16x2(v0, v4), bf16x2(v8, v12));
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += d[q];
        };
        const int whole = H / 16;
#pragma unroll 4
        for (int ks = 0; ks < whole; ++ks) {
          const float* p = hp + ks * 16 * T;
          chunk(ks, p[0], p[4 * T], p[8 * T], p[12 * T]);
        }
        if (whole < nks) {
          const float* p = hp + whole * 16 * T;
          const int k = whole * 16 + tig;
          chunk(whole, k < H ? p[0] : 0.f, k + 4 < H ? p[4 * T] : 0.f,
                k + 8 < H ? p[8 * T] : 0.f, k + 12 < H ? p[12 * T] : 0.f);
        }
        // d[m][n] -> sums[n][m]: rows gid and gid + 8, columns 2 tig, + 1
        float* st = sums + 2 * tig * Ms + s * 16 + gid;
        st[0] = acc[0];
        st[Ms] = acc[1];
        st[8] = acc[2];
        st[Ms + 8] = acc[3];
      }
    } else if (active) {
      // phase A: partial h . R over this warp's k, for the lane's unit
      float acc[T][4];
#pragma unroll
      for (int r = 0; r < T; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      const float4* h4 = reinterpret_cast<const float4*>(hbuf + cur * H * T);
      // the unit's (i, f, c~, o) weights of row k of R[g]
      auto weights = [&](int k) {
        if constexpr (kResident) {
          return Rs[k * Hc + ul];
        } else {
          const E* p = Rg + (size_t)k * H4 + u;
          return make_float4(load_f32(p), load_f32(p + H),
                             load_f32(p + 2 * H), load_f32(p + 3 * H));
        }
      };
      // the operands of k + 1 are loaded into their own registers before
      // the FMAs of k, so no FMA waits on shared memory (the last k
      // reloads itself)
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f), ha = w, hb = w;
      if (k0 < k1) {
        w = weights(k0);
        ha = h4[k0 * 2];
        hb = h4[k0 * 2 + 1];
      }
#pragma unroll 5
      for (int k = k0; k < k1; ++k) {
        const int kn = min(k + 1, k1 - 1);
        const float4 wn = weights(kn);
        const float4 han = h4[kn * 2];
        const float4 hbn = h4[kn * 2 + 1];
        const float hv[T] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int r = 0; r < T; ++r) {
          acc[r][0] = fmaf(hv[r], w.x, acc[r][0]);
          acc[r][1] = fmaf(hv[r], w.y, acc[r][1]);
          acc[r][2] = fmaf(hv[r], w.z, acc[r][2]);
          acc[r][3] = fmaf(hv[r], w.w, acc[r][3]);
        }
        w = wn;
        ha = han;
        hb = hbn;
      }
#pragma unroll
      for (int r = 0; r < T; ++r)
        part[(s * T + r) * Hc + ul] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    TICK(1)
    half_sync(half);
    TICK(2)
    // phase B: row s of the lane's unit
    float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f;
    if (active) {
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kBf16) {
        d = *reinterpret_cast<const float4*>(sums + s * Ms + 4 * ul);
      } else {
#pragma unroll
        for (int p = 0; p < kSplit; ++p) {
          const float4 v = part[(p * T + s) * Hc + ul];
          d.x += v.x;
          d.y += v.y;
          d.z += v.z;
          d.w += v.w;
        }
      }
      if constexpr (kBf16) {   // the rounding points of the header's note
        ig = bf16r(sigmoid_ieee(bf16r(zx[0] + bf16r(d.x))));
        fg = bf16r(sigmoid_ieee(bf16r(zx[1] + bf16r(d.y))));
        gg = bf16r(tanhf(bf16r(zx[2] + bf16r(d.z))));
        og = bf16r(sigmoid_ieee(bf16r(zx[3] + bf16r(d.w))));
        const float ct = bf16r(bf16r(fg * c) + bf16r(ig * gg));
        if (m) {
          c = ct;
          h = bf16r(og * bf16r(tanhf(ct)));
        }
      } else {
        ig = sigmoid(zx[0] + d.x);
        fg = sigmoid(zx[1] + d.y);
        gg = tanh_fast(zx[2] + d.z);
        og = sigmoid(zx[3] + d.w);
        const float ct = fg * c + ig * gg;
        if (m) {
          c = ct;
          h = og * tanh_fast(ct);
        }
      }
      // the new h of this unit's row, into this block's other buffer
      hbuf[(cur ^ 1) * H * T + u * T + s] = h;
    }
    TICK(3)
    if (t + 1 < L) {
      // this block's units of the new h, 16 bytes a thread, to the same
      // place in the NC - 1 peers' other buffer: first, the peers wait
      // for it
      half_sync(half);
      TICK(4)
#pragma unroll
      for (int j = 0; j < kPush; ++j)
        if (push_dst[j] != 0u)
          send4(push_dst[j] + (cur ^ 1) * buf_bytes,
                push_bar[j] + 8 * (cur ^ 1),
                *reinterpret_cast<const float4*>(
                    reinterpret_cast<const char*>(hbuf) + push_src[j]
                    + (cur ^ 1) * buf_bytes));
      TICK(5)
      load_step(t + 1);
    }
    if (stores) {
      const size_t row = ((size_t)g * L + t) * B + b;
      store(hs + row * H + u, h);
      if (gates != nullptr) {
        E* gp = gates + row * H4 + u;
        store(gp, ig);
        store(gp + H, fg);
        store(gp + 2 * H, gg);
        store(gp + 3 * H, og);
        store(cs + row * H + u, c);
      }
    }
  }
  if (stores) store(h_final + ((size_t)g * B + b) * H + u, h);
}

size_t smem_bytes(bool bf16, int H, int NC, bool resident) {
  const int Hc = (H + NC - 1) / NC;
  // the slice of R when resident; per half two h buffers and the sums
  return r_vectors(bf16, resident, H, Hc) * 16
         + 2 * (2 * (size_t)H * kTile + part_floats(bf16, Hc)) * sizeof(float);
}

template <typename E, int NC, bool kResident, int kMinBlocks = 1>
int launch_nc(const E* x_proj, const uint8_t* mask, const E* R, E* hs,
              E* h_final, E* gates, E* cs, int G, int L, int B, int H,
              void* stream) {
  const auto kernel = lstm_cluster_kernel<E, NC, kResident, kMinBlocks>;
  const size_t smem = smem_bytes(std::is_same<E, __nv_bfloat16>::value, H,
                                 NC, kResident);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && NC > kCluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC * ((tiles + 1) / 2), G);
  cfg.blockDim = dim3(2 * kHalf);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x_proj, mask, R, hs, h_final,
                                 gates, cs, L, B, H);
}

template <typename E>
int launch(const E* x_proj, const uint8_t* mask, const E* R, E* hs,
           E* h_final, E* gates, E* cs, int G, int L, int B, int H,
           int device, void* stream) {
  if ((gates == nullptr) != (cs == nullptr)) return (int)cudaErrorInvalidValue;
  if (G <= 0 || L <= 0 || B <= 0 || H <= 0 || H > kMaxH || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    // R on chip at every width.  Two blocks an SM where their shared
    // memory fits (with the 1 KB the card reserves a block, and the
    // barriers), and the grid would take more than one wave of one block
    // an SM or the cluster is 16 blocks (it then spans 8 SMs).  Else one:
    // a block alone has the SM's shared memory, which phase A's fragment
    // loads are bound by, and 128 registers.
    int per_sm = 0, sms = 0;
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    const int NC = H <= kMaxNarrowH ? kCluster : kWideCluster;
    const bool fits =
        2 * (smem_bytes(true, H, NC, true) + 2048) <= (size_t)per_sm;
    const long long blocks =
        (long long)G * NC * (((B + kTile - 1) / kTile + 1) / 2);
#ifdef ICL_LSTM_BF16_BLOCKS   // a measuring build: 1 or 2 wherever 2 fit
    const bool two = fits && ICL_LSTM_BF16_BLOCKS == 2;
#else
    const bool two = fits && (NC == kWideCluster || blocks > sms);
#endif
    if (NC == kCluster)
      return two ? launch_nc<E, kCluster, true, 2>(x_proj, mask, R, hs,
                                                   h_final, gates, cs, G, L,
                                                   B, H, stream)
                 : launch_nc<E, kCluster, true, 1>(x_proj, mask, R, hs,
                                                   h_final, gates, cs, G, L,
                                                   B, H, stream);
    return two ? launch_nc<E, kWideCluster, true, 2>(x_proj, mask, R, hs,
                                                     h_final, gates, cs, G,
                                                     L, B, H, stream)
               : launch_nc<E, kWideCluster, true, 1>(x_proj, mask, R, hs,
                                                     h_final, gates, cs, G,
                                                     L, B, H, stream);
  } else {
    if (H <= kMaxNarrowH)
      return launch_nc<E, kCluster, true>(x_proj, mask, R, hs, h_final, gates,
                                          cs, G, L, B, H, stream);
    // the wide cluster keeps R on chip while it fits beside the kernel's
    // static shared memory (the barriers) and a margin
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (smem_bytes(false, H, kWideCluster, true) + 1024 <= (size_t)optin)
      return launch_nc<E, kWideCluster, true>(x_proj, mask, R, hs, h_final,
                                              gates, cs, G, L, B, H, stream);
    return launch_nc<E, kWideCluster, false>(x_proj, mask, R, hs, h_final,
                                             gates, cs, G, L, B, H, stream);
  }
}

}  // namespace

#ifdef ICL_LSTM_CLOCKS
// out[0..5]: cycles summed by thread 0 of block (0, 0) since the last reset,
// in the phases wait, A, barrier, B, second barrier, push; the loads and
// stores after the push count into the next step's wait.
extern "C" int icl_lstm_recurrence_clocks(long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * 8);
  if (err == cudaSuccess && reset) {
    const long long zero[8] = {0};
    err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

// x_proj [G, L, B, 4H], mask [G, L, B] (bytes, 0 or 1), R [G, H, 4H] in;
// hs [G, L, B, H] and h_final [G, B, H] out, and, when `gates` is non-null,
// the residuals gates [G, L, B, 4H] and cs [G, L, B, H]; all contiguous f32
// except the mask.  Launches on `stream` (a cudaStream_t from the caller)
// on `device` and returns the cudaError_t of the launch: 0 on success.  G,
// L and B must be positive (the caller handles empty inputs without a
// launch), and 1 <= H <= 512 (a lane per unit of a block's share of H: an
// eighth up to 256, at which the block's slice of R takes 128 KB of shared
// memory, a sixteenth above).
extern "C" int icl_lstm_recurrence_f32(const float* x_proj,
                                       const uint8_t* mask, const float* R,
                                       float* hs, float* h_final,
                                       float* gates, float* cs, int G, int L,
                                       int B, int H, int device,
                                       void* stream) {
  return launch<float>(x_proj, mask, R, hs, h_final, gates, cs, G, L, B, H,
                       device, stream);
}

// The same call in the bf16 mode (the header's note): every tensor but the
// mask is contiguous bf16.  Any H in 1..512, odd ones too: the kernel reads
// and writes device memory one element at a time.
extern "C" int icl_lstm_recurrence_bf16(const __nv_bfloat16* x_proj,
                                        const uint8_t* mask,
                                        const __nv_bfloat16* R,
                                        __nv_bfloat16* hs,
                                        __nv_bfloat16* h_final,
                                        __nv_bfloat16* gates,
                                        __nv_bfloat16* cs, int G, int L,
                                        int B, int H, int device,
                                        void* stream) {
  return launch<__nv_bfloat16>(x_proj, mask, R, hs, h_final, gates, cs, G, L,
                               B, H, device, stream);
}
