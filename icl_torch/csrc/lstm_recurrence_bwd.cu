// Masked Keras LSTM recurrence, backward, f32 and bf16, for Hopper (sm_90a).
//
// For each group g (a direction of a BiLSTM) and row b, with dh = dhf[g, b]
// and dc = 0, over t = L-1 down to 0:
//
//     dh    = dh + dhs[g, t, b]
//     m     = mask[g, t, b];  i, f, c~, o = gates[g, t, b];  tc = tanh(cs[g, t, b])
//     dh_t  = dh m
//     dc_t  = dc m + dh_t o (1 - tc^2)
//     di    = dc_t c~ i (1 - i)          df = dc_t cs[g, t-1, b] f (1 - f)
//     dc~   = dc_t i (1 - c~^2)          do = dh_t tc o (1 - o)
//     dgates[g, t, b] = (di, df, dc~, do)                 the cotangent of x_proj
//     dh    = dgates[g, t, b] . R[g]^T + dh (1 - m)
//     dc    = dc_t f + dc (1 - m)
//
// with cs[g, -1, b] = 0.  That is _lstm_recurrence_bwd_impl in
// icl/models/rnn.py and the plain loop lstm_recurrence_bwd in
// icl_torch/ops/lstm_recurrence.py, step for step; the inputs are the
// residuals the forward kernel (lstm_recurrence.cu) writes: the
// post-activation gates, not masked, and c after the mask (so tc is the
// tanh of the step's new state wherever m = 1, and every term that reads it
// is 0 where m = 0).  dR is not computed here: it is one GEMM over the
// whole sequence in the wrapper.
//
// Replaces no Pallas kernel: the JAX package differentiates its recurrence
// with a reverse lax.scan, which XLA compiles into one loop on the device.
// The port's counterpart was a Python loop of eager PyTorch ops, about 35
// launches a step (a batched matmul and the gate arithmetic), which held
// the host for most of a relation train step while the card stood idle.
// This kernel runs all L steps in one launch.
//
// What bounds it on the H100: operations, as in the forward.  The L steps
// are a sequential chain of [rows, 4H] x [4H, H] products in f32 FMAs
// (the same count as the forward's h . R; one TF32 pass would break the
// 1e-5 gate); the bytes (the residuals and dhs in, dgates out) take a
// fraction of that time.  What stands in the way is R[g], 640 KB at H =
// 200, read again in every step.
//
// Design: R stays on chip for all L steps, split over a thread-block
// cluster with distributed shared memory, as in the forward, and each
// block keeps the very slice the forward keeps: the four gate columns of
// its units.
//  * A cluster of kCluster = 8 blocks (kWideCluster = 16 above 256 units)
//    owns one group g and two tiles of kTile = 8 batch rows, one tile a
//    half block of 256 threads.  Block r owns the units [r Hc, (r+1) Hc),
//    Hc = ceil(H / NC), and loads once, from R^T (the wrapper transposes R,
//    so that this load, and the per-step reads of the from-memory layout,
//    are coalesced), its columns of R[g] as [unit v][k] float4 = (R[k, v],
//    R[k, H+v], R[k, 2H+v], R[k, 3H+v]): 80 KB at H=200, 128 KB at 256.
//  * Phase E, thread (unit, row) of a half: it forms the four gate
//    cotangents of its unit and row from the residuals, loaded a step ahead,
//    and its dh and dc, kept in registers across the steps; writes them to
//    dgates in device memory and, as one float4, to the half's [unit][row]
//    tile in shared memory.
//  * Phase A, after the half's barrier: thread k sums, for each row, the
//    block's part of dh[row, k], sum over its units v and the four gates
//    of dgates[row, v] . R[k, v]: per unit one 16-byte load of R (lanes on
//    consecutive k) and eight broadcast 16-byte loads of the tile feed 32
//    FMAs.  So the block's share of the product needs only its own
//    cotangents: what the cluster exchanges is H partial sums a row (each
//    block its part of every other block's units), not the 4H cotangents.
//  * Hand-over.  Thread k sends its eight rows' partial sums, 2 x 16 bytes
//    (st.async through distributed shared memory), to the block that owns
//    unit k, into the slot of the sending block in that block's [block]
//    [unit][row] buffer; every st.async reports its bytes to an mbarrier of
//    the receiving block, one per half and buffer, armed with the bytes the
//    peers send it.  In phase E of the next step, thread (unit, row) adds
//    the slots of its unit and row in block order (no atomics: the sums are
//    bitwise repeatable) and the carried dh (1 - m).  Two buffers are
//    enough, for the forward's reason: a peer can only send the sums of
//    step n + 1 after it has this block's sums of step n, which this block
//    sends after its half has read the buffer that step n + 1's sums fill.
//    That needs every block to wait for its peers' sums, so a block that
//    owns no unit (at small H, where ceil(H / Hc) < NC) takes no part: it
//    would wait for nothing.  The one cluster barrier is at the start, as
//    in the forward.
//  * The last step computes no product (the dh it would give is that of
//    the zero initial state).  Rows beyond B and units beyond H read the
//    last valid one's inputs and store nothing; a half whose tile lies
//    beyond B leaves after the cluster barrier.
//  * The gates are the accurate tanhf and the IEEE arithmetic of the plain
//    loop; they run once a step a thread, beside a phase A of 4 Hc FMAs a
//    row.
//
// Wider LSTMs: up to 512 units over the 16-block cluster, each thread of
// phase A taking k and k + 256.  While a block's slice of R fits its shared
// memory beside the tiles and buffers (up to H = 416), it stays on chip;
// above, phase A reads it from R^T in device memory every step, four
// coalesced loads a unit, from L2.  Everything else, the order of every
// sum included, is the same.
//
// The bf16 mode (icl_lstm_recurrence_bwd_bf16, --compute_dtype bf16):
// gates, cs, R, dhs, dhf and dgates are __nv_bfloat16 in device memory and
// the semantics are the plain loop's on bf16 tensors, each eager op
// computed in f32 and rounded once, the reference's backward in its
// compute dtype.  The kernel rounds where those ops round:
//   dh    = bf16(dh + dhs)                  tc = bf16(tanh(cs))
//   dc_t  = bf16(dc m + bf16(bf16(dh_t o) bf16(1 - bf16(tc tc))))
//   do    = bf16(bf16(bf16(dh_t tc) o) bf16(1 - o))     (di, df alike)
//   dc~   = bf16(bf16(dc_t i) bf16(1 - bf16(c~ c~)))
//   dh    = bf16(bf16(dgates . R^T) + dh (1 - m))
//   dc    = bf16(bf16(dc_t f) + dc (1 - m))
// where a product by m or 1 - m (0 or 1) is exact.  R's slice is held as
// f32 (bf16 values widen exactly) and phase A is the f32 mode's: products
// of bf16 values are exact in f32 and summed in f32, as the batched
// matmul's bf16 GEMM sums them, in another order; the sum is rounded
// once.  What stays apart from the plain loop is that order, which moves
// a rounded dh by one bf16 unit where the sum lies near a boundary.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks per cluster: each owns ceil(H/8) units
constexpr int kWideCluster = 16;   // above kMaxNarrowH
constexpr int kMaxNarrowH = kCluster * 32;    // 32 units a block: 256
constexpr int kMaxH = kWideCluster * 32;      // 512
constexpr int kTile = 8;           // batch rows per tile
constexpr int kHalf = 32 * kTile;  // threads per half block: 32 units x 8 rows

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

// x rounded to bf16 (nearest even) and widened back, exact in f32
__device__ __forceinline__ float bf16r(float x) {
  uint16_t b;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(x));
  return __uint_as_float((uint32_t)b << 16);
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
  *reinterpret_cast<unsigned short*>(p) =
      (unsigned short)(__float_as_uint(v) >> 16);
}

// shared memory a block: the slice of R when resident, and per half the
// [Hc][kTile] float4 tile of cotangents and two [NC][Hc][kTile] buffers of
// partial sums
__host__ __device__ __forceinline__ size_t r_vectors(bool resident, int H,
                                                     int Hc) {
  return resident ? (size_t)Hc * H : 0;
}
__host__ __device__ __forceinline__ size_t half_floats(int NC, int Hc) {
  return (size_t)4 * Hc * kTile + (size_t)2 * NC * Hc * kTile;
}

size_t smem_bytes(int H, int NC, bool resident) {
  const int Hc = (H + NC - 1) / NC;
  return r_vectors(resident, H, Hc) * 16 + 2 * half_floats(NC, Hc) * 4;
}

// E: the element type of device memory, float or __nv_bfloat16 (the bf16
// mode); on chip everything is f32.  NC: blocks a cluster, kCluster or
// kWideCluster.  kResident: R in shared memory, else read from R^T in
// device memory every step.
template <typename E, int NC, bool kResident>
__global__ void __launch_bounds__(2 * kHalf, 1)
lstm_bwd_cluster_kernel(const E* __restrict__ gates,
                        const E* __restrict__ cs,
                        const uint8_t* __restrict__ mask,
                        const E* __restrict__ Rt,
                        const E* __restrict__ dhs,
                        const E* __restrict__ dhf,
                        E* __restrict__ dgates, int L, int B, int H) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  // the k's of phase A a thread: k and, in the wide cluster, k + 256
  constexpr int kPer = NC * 32 / kHalf;
  constexpr int T = kTile;
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t full[2][2];  // [half][buffer]: sums whole
  const int Hc = (H + NC - 1) / NC;
  const int half = threadIdx.x / kHalf;
  const int ht = threadIdx.x - half * kHalf;
  float4* Rs = smem4;                                   // [Hc][H]
  float4* tile = Rs + r_vectors(kResident, H, Hc)
                 + (size_t)half * half_floats(NC, Hc) / 4;   // [Hc][T]
  float* sums = reinterpret_cast<float*>(tile + Hc * T);   // [2][NC][Hc][T]
  const int buf_floats = NC * Hc * T;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y;
  const int b0 = ((blockIdx.x / NC) * 2 + half) * T;   // the tile's row 0
  const int own = max(0, min(Hc, H - rank * Hc));      // units of this block
  const int nsrc = (H + Hc - 1) / Hc;    // blocks 0 .. nsrc - 1 own units
  const size_t H4 = 4 * (size_t)H;
  const size_t HH = (size_t)H * H;
  const E* Rg = Rt + (size_t)g * H4 * H;               // R^T[g]: [4H][H]

  // once: this block's columns of R[g], and the barriers
  if constexpr (kResident) {
    for (int i = threadIdx.x; i < Hc * H; i += blockDim.x) {
      const int v = i / H;
      const int k = i - v * H;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v < own) {
        const E* p = Rg + (size_t)(rank * Hc + v) * H + k;
        w = make_float4(load_f32(p), load_f32(p + HH), load_f32(p + 2 * HH),
                        load_f32(p + 3 * HH));
      }
      Rs[i] = w;
    }
  }
  const uint32_t bars = smem_addr(full[half]);
  // the partial sums of this block's units from the nsrc - 1 peers
  const uint32_t in_bytes = (uint32_t)((nsrc - 1) * own * T * sizeof(float));
  if (ht == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (L > 1) mbar_expect(bars + 8, in_bytes);   // step 1 reads buffer 1
    if (L > 2) mbar_expect(bars, in_bytes);       // step 2 reads buffer 0
  }
  // every block of the cluster runs, and its R and barriers are in place,
  // before any peer writes into its shared memory
  cluster.sync();
  // no second tile: the same half of every peer.  A block that owns no
  // unit (H <= (NC - 1) Hc) has no part in the product and leaves too: it
  // would wait for nothing and so could run steps ahead of its peers.
  if (b0 >= B || rank >= nsrc) return;

  // phase E: thread (unit ul, row r); a row beyond B or a unit beyond H
  // reads the last valid one's inputs (and stores nothing)
  const int r = ht & (T - 1);
  const int ul = ht / T;
  const int u = rank * Hc + ul;
  const int b = b0 + r;
  const bool stores = ul < own && b < B;
  const int uc = min(u, H - 1);
  const size_t row0 = (size_t)g * L * B + min(b, B - 1);   // (g, 0, b)
  const E* grow = gates + row0 * H4 + uc;
  const E* crow = cs + row0 * H + uc;
  const E* drow = dhs + row0 * H + uc;
  const uint8_t* mrow = mask + row0;
  float dh = load_f32(dhf + ((size_t)g * B + min(b, B - 1)) * H + uc);
  float dc = 0.f, carry = 0.f;
  float gi, gf, gg, go, c_t, c_prev, dhs_t, m;
  auto load_step = [&](int t) {
    const size_t o = (size_t)t * B;
    gi = load_f32(grow + o * H4);
    gf = load_f32(grow + o * H4 + H);
    gg = load_f32(grow + o * H4 + 2 * H);
    go = load_f32(grow + o * H4 + 3 * H);
    c_t = load_f32(crow + o * H);
    c_prev = t > 0 ? load_f32(crow + (o - B) * H) : 0.f;
    dhs_t = load_f32(drow + o * H);
    m = __ldg(mrow + o) ? 1.f : 0.f;
  };
  load_step(L - 1);

  // phase A's targets: thread k's eight sums go to the block owning unit
  // k, into the slot [rank][k - its first unit] of its buffers (the same
  // offset in every block); its own units' stay here
  uint32_t send_dst[kPer], send_bar[kPer];
  int send_own[kPer];    // float offset into this block's buffer, or -1
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = ht + i * kHalf;
    const int dst = min(k, H - 1) / Hc;
    const int off = (rank * Hc + (min(k, H - 1) - dst * Hc)) * T;
    send_own[i] = dst == rank ? off : -1;
    send_dst[i] = peer_addr(smem_addr(sums + off), dst);
    send_bar[i] = peer_addr(bars, dst);
  }
  const uint32_t buf_bytes = (uint32_t)(buf_floats * sizeof(float));

  for (int n = 0; n < L; ++n) {
    const int t = L - 1 - n;
    const int cur = n & 1;
    if (n > 0) {
      // the sums of step n - 1: the peers' in buffer cur, and this block's
      mbar_wait(bars + 8 * cur, ((n - 1) >> 1) & 1);
      // the buffer's next whole set is the one step n + 2 reads
      if (ht == 0 && n + 2 < L) mbar_expect(bars + 8 * cur, in_bytes);
      float mm = 0.f;
      if (ul < Hc) {   // else beyond the buffer
        const float* p = sums + cur * buf_floats + ht;   // [src][ul][r]
        for (int src = 0; src < nsrc; ++src) mm += p[src * Hc * T];
      }
      dh = kBf16 ? bf16r(bf16r(mm) + carry) : mm + carry;
    }
    // phase E
    float d_i, d_f, d_g, d_o;
    if constexpr (kBf16) {   // the rounding points of the header's note
      dh = bf16r(dh + dhs_t);
      const float tc = bf16r(tanhf(c_t));
      const float dh_t = dh * m;
      const float dc_t = bf16r(dc * m + bf16r(bf16r(dh_t * go)
                                              * bf16r(1.f - bf16r(tc * tc))));
      d_o = bf16r(bf16r(bf16r(dh_t * tc) * go) * bf16r(1.f - go));
      d_f = bf16r(bf16r(bf16r(dc_t * c_prev) * gf) * bf16r(1.f - gf));
      d_i = bf16r(bf16r(bf16r(dc_t * gg) * gi) * bf16r(1.f - gi));
      d_g = bf16r(bf16r(dc_t * gi) * bf16r(1.f - bf16r(gg * gg)));
      carry = dh * (1.f - m);
      dc = bf16r(bf16r(dc_t * gf) + dc * (1.f - m));
    } else {
      dh = dh + dhs_t;
      const float tc = tanhf(c_t);
      const float dh_t = dh * m;
      const float dc_t = dc * m + dh_t * go * (1.f - tc * tc);
      d_o = dh_t * tc * go * (1.f - go);
      d_f = dc_t * c_prev * gf * (1.f - gf);
      d_i = dc_t * gg * gi * (1.f - gi);
      d_g = dc_t * gi * (1.f - gg * gg);
      carry = dh * (1.f - m);
      dc = dc_t * gf + dc * (1.f - m);
    }
    if (stores) {
      E* dp = dgates + (row0 + (size_t)t * B) * H4 + u;
      store(dp, d_i);
      store(dp + H, d_f);
      store(dp + 2 * H, d_g);
      store(dp + 3 * H, d_o);
    }
    if (n + 1 == L) break;
    if (ul < Hc) tile[ht] = make_float4(d_i, d_f, d_g, d_o);
    load_step(t - 1);
    half_sync(half);

    // phase A: this block's part of dh[row, k] for the thread's k's
    float acc[kPer][T];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int q = 0; q < T; ++q) acc[i][q] = 0.f;
#pragma unroll 2
    for (int v = 0; v < own; ++v) {
      float4 w[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int k = min(ht + i * kHalf, H - 1);
        if constexpr (kResident) {
          w[i] = Rs[v * H + k];
        } else {
          const E* p = Rg + (size_t)(rank * Hc + v) * H + k;
          w[i] = make_float4(load_f32(p), load_f32(p + HH),
                             load_f32(p + 2 * HH), load_f32(p + 3 * HH));
        }
      }
      const float4* dv = tile + v * T;
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const float4 d = dv[q];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          acc[i][q] = fmaf(d.x, w[i].x, acc[i][q]);
          acc[i][q] = fmaf(d.y, w[i].y, acc[i][q]);
          acc[i][q] = fmaf(d.z, w[i].z, acc[i][q]);
          acc[i][q] = fmaf(d.w, w[i].w, acc[i][q]);
        }
      }
    }
    // the sums of step n, to buffer cur ^ 1 of the owner of each k
    const int nb = cur ^ 1;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (ht + i * kHalf >= H) continue;
      const float4 lo = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      const float4 hi = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (send_own[i] >= 0) {
        float4* p = reinterpret_cast<float4*>(sums + nb * buf_floats
                                              + send_own[i]);
        p[0] = lo;
        p[1] = hi;
      } else {
        send4(send_dst[i] + nb * buf_bytes, send_bar[i] + 8 * nb, lo);
        send4(send_dst[i] + nb * buf_bytes + 16, send_bar[i] + 8 * nb, hi);
      }
    }
    // this block's own sums are in place, and the tile may be rewritten
    half_sync(half);
  }
}

template <typename E, int NC, bool kResident>
int launch_nc(const E* gates, const E* cs, const uint8_t* mask, const E* Rt,
              const E* dhs, const E* dhf, E* dgates, int G, int L, int B,
              int H, void* stream) {
  const auto kernel = lstm_bwd_cluster_kernel<E, NC, kResident>;
  const size_t smem = smem_bytes(H, NC, kResident);
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
  return (int)cudaLaunchKernelEx(&cfg, kernel, gates, cs, mask, Rt, dhs, dhf,
                                 dgates, L, B, H);
}

template <typename E>
int launch(const E* gates, const E* cs, const uint8_t* mask, const E* Rt,
           const E* dhs, const E* dhf, E* dgates, int G, int L, int B, int H,
           int device, void* stream) {
  if (G <= 0 || L <= 0 || B <= 0 || H <= 0 || H > kMaxH || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H <= kMaxNarrowH)
    return launch_nc<E, kCluster, true>(gates, cs, mask, Rt, dhs, dhf, dgates,
                                        G, L, B, H, stream);
  // the wide cluster keeps R on chip while it fits beside the kernel's
  // static shared memory (the barriers) and a margin
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes(H, kWideCluster, true) + 1024 <= (size_t)optin)
    return launch_nc<E, kWideCluster, true>(gates, cs, mask, Rt, dhs, dhf,
                                            dgates, G, L, B, H, stream);
  return launch_nc<E, kWideCluster, false>(gates, cs, mask, Rt, dhs, dhf,
                                           dgates, G, L, B, H, stream);
}

}  // namespace

// gates [G, L, B, 4H], cs [G, L, B, H], mask [G, L, B] (bytes, 0 or 1),
// Rt [G, 4H, H] (R[g] transposed), dhs [G, L, B, H] and dhf [G, B, H] in;
// dgates [G, L, B, 4H] out; all contiguous f32 except the mask.  Launches
// on `stream` (a cudaStream_t from the caller) on `device` and returns the
// cudaError_t of the launch: 0 on success.  G, L and B must be positive
// (the caller handles empty inputs without a launch), and 1 <= H <= 512.
extern "C" int icl_lstm_recurrence_bwd_f32(const float* gates,
                                           const float* cs,
                                           const uint8_t* mask,
                                           const float* Rt, const float* dhs,
                                           const float* dhf, float* dgates,
                                           int G, int L, int B, int H,
                                           int device, void* stream) {
  return launch<float>(gates, cs, mask, Rt, dhs, dhf, dgates, G, L, B, H,
                       device, stream);
}

// The same call in the bf16 mode (the header's note): every tensor but the
// mask is contiguous bf16.
extern "C" int icl_lstm_recurrence_bwd_bf16(
    const __nv_bfloat16* gates, const __nv_bfloat16* cs, const uint8_t* mask,
    const __nv_bfloat16* Rt, const __nv_bfloat16* dhs,
    const __nv_bfloat16* dhf, __nv_bfloat16* dgates, int G, int L, int B,
    int H, int device, void* stream) {
  return launch<__nv_bfloat16>(gates, cs, mask, Rt, dhs, dhf, dgates, G, L, B,
                               H, device, stream);
}
