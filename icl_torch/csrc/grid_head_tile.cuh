// The grid head's forward tile routine, f32, for Hopper (sm_90a):
//
//     logit[g, a, b, :] = dropout(relu(X[g, a] + b1 + Y[g, b])) . W2 + b2
//
// and its one-pass bf16 dot (kFastDot): the two operands of the dot, the
// activation dropout(relu((X + b1) + Y)) (added in f32 in that order, and
// rounded after the dropout scale) and every W2 entry, are rounded to bf16
// (round to nearest even).  A product of two bf16 values is exact in f32,
// so the FMAs and the sums stay f32: what a one-pass bf16 dot with f32
// accumulation computes.  Inputs and outputs stay f32.  It is the
// exact=False mode of the training forward family, with dropout
// (Precision.DEFAULT in icl/ops/grid_head_train.py).  It runs the same
// FMAs as the f32 mode, plus two conversions an element; the f32 mode is
// another instantiation and keeps its bits.  The bf16 mode of K1/K2 and K9
// without dropout (the reference's fast_dot in icl/ops/grid_head.py
// _kernel and _flat_kernel) takes this form on small grids and the second
// routine of this header, on the tensor cores (at its end), on large
// ones.
//
// One source for every forward kernel of the grid head: grid_head.cu (the
// Pallas kernels K1 _flat_kernel and K2 _kernel of icl/ops/grid_head.py)
// and the forward family of grid_head_train.cu (K5 _fwd_kernel, K7
// _fwd_loss_*kernel and the recomputing first half of K8 _bwd_loss_*kernel
// of icl/ops/grid_head_train.py) include it and add only their epilogue;
// so does affinity_rank.cu (K9 _rank_kernel of icl/ops/affinity_rank.py),
// which takes one column of W2 (the column form below) and puts a masked
// softmax over each row of the grid behind it.
//
// What bounds the function on the H100.  Per element of [cells, K] there
// are 2 + O float instructions (add, max, O FMAs) and, with dropout, 10
// integer ones for the hash, on a pipe of half the float rate (the hash
// alone runs at 12-14 T operations/s, head_probes.cu); the operands are a
// few MB that stay in L2.  So the schedulers' instruction rate sets the
// pace, not memory, as long as the loads per FMA are few and wide.  A
// design with one cell per warp makes one 4-byte load of Y, one of X and O
// of W2 per element: there the load/store unit is the limit, and every Y
// row is read once per row a of its image.
//
// Design.
//  * A warp owns a register tile of kRows x kCols cells (4 x 4 for O = 2
//    and O = 4; 2 x 2 in the generic form, O <= 8).  Its lanes split K in
//    chunks of kV = 4 consecutive k (one 16-byte load each; lanes on
//    neighbouring chunks, so a warp's load is one 512-byte run).  Per chunk
//    a lane loads 4 x-vectors, 4 y-vectors, b1 and the 4 rows of W2 (in
//    their own [K, O] layout: one float4 at O = 4, half of one at O = 2; no
//    transpose, no division) for 16 cells x 4 k: 13 wide loads per 384
//    float instructions.  Y[g, b] is read by A / 4 warps of its image.
//  * No staging pass and no block-wide barrier in front of the work: the
//    operands come straight from global memory through L1 (read-only
//    loads).  X rows, b1 and W2 are shared by the warps of an SM and hit
//    in L1; Y streams from L2.  The warps of a block run unsynchronised, so
//    one warp's loads overlap another's arithmetic.  Shared memory holds
//    only the partial sums of a K split (2 KB) and the loss partials.  (A
//    two-stage cp.async ring for Y in shared memory, each lane copying its
//    own 16 bytes a column one pass ahead, measured 10 % slower at G = 64:
//    four copies and four shared loads a pass where there were four loads.)
//  * Cells are skipped under a warp-uniform mask: cells beyond the edge of
//    a ragged tile (their rows and columns read clamped addresses and are
//    never written) and, in the weighted kernels (loss and its backward),
//    cells of weight 0.  A tile with no live cell skips the k loop.
//  * Transpose-reduce: a lane ends the k loop with cells x O partial sums.
//    Five exchange steps over lane bits 4..0 halve the live set while it
//    holds more than one cell (each lane keeps one half and sends the
//    other), then butterfly the rest: 64 shuffles for a 4 x 4 tile at O = 4
//    where a butterfly per value takes 320, and lane l ends with all O sums
//    of cell l >> 1.  The epilogue (bias, CE, stores) runs one cell a lane.
//  * Small grids (served requests: G = 1..8) have too few tiles to fill
//    132 SMs, so the launcher splits K over `ksplit` warps of a block
//    (slice s takes chunks s, s + ksplit, ...); the slices' sums meet in
//    shared memory and are added in the order s = 0, 1, ....  The wrapper
//    picks ksplit from (G, A, B, K); everything else of the launch follows
//    from it and the operands here (plan_launch).
//  * No atomics, no data-dependent order: results repeat bit for bit.
//  * What is left of K after the whole 128-wide passes (K = 800: 32) goes
//    one k a lane, a quarter pass instead of a pass with 24 lanes idle.
//  * Alignment: the 16-byte form needs X, Y, b1 and W2 16-byte aligned and
//    K % 4 == 0.  Otherwise kV = 1: the same routine with scalar loads (the
//    generic 2 x 2 form), picked by plan_launch from the pointers.
//  * The column form (kColumn, kO = 1): the head is the single column
//    p.col of W2 [K, p.O], a 4 x 4 tile of one sum a cell.  At p.O = 2 a
//    lane reads its 4 rows of W2 whole (8 floats, two 16-byte loads) and
//    keeps the column's half; at other widths it reads 4 floats one by one.
//
// Shared memory a block, every shape: 2 KB of K-split partials (8 warps x
// 64 floats) plus, in the loss kernel, 96 bytes.  Registers a thread
// (ptxas, sm_90a, no spill in any form; chip_smoke.py prints them and
// fails on a spill): the 4 x 4 tile at O = 4 holds 64 sums, 16 cell keys and
// 52 operand floats, 142 registers without dropout and 168-170 with it;
// at O = 2, 120 and 106-110; the generic forms 73-128.  At 170 registers
// three blocks of four warps fit an SM, more than the 8 warps an SM gets at
// G = 64, A = B = 16.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace icl_head {

constexpr int kMaxO = 8;        // head widths in this repo: 4 (relation), 2
constexpr int kMaxWarps = 8;    // warps a block: column tiles x k slices
constexpr int kColTiles = 4;    // column tiles a block where K is not split
constexpr int kRedFloats = kMaxWarps * 64;   // K-split partials a block
constexpr unsigned kFull = 0xffffffffu;

// x rounded to bf16 (nearest even) and widened back: exact in f32; one
// cvt.rn.bf16.f32 and a shift
__device__ __forceinline__ float bf16_round(float x) {
  uint16_t b;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(x));
  return __uint_as_float((uint32_t)b << 16);
}

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  x = ((x >> 16) ^ x) * 0x45d9f3bu;
  return (x >> 16) ^ x;
}

// The register tile of a head width: kO is the width the registers are
// sized for (O == kO when exact, else O <= kO = kMaxO).
template <int kO>
struct Tile {
  static constexpr int kRows = kO <= 4 ? 4 : 2;
  static constexpr int kCols = kO <= 4 ? 4 : 2;
  static constexpr int kCells = kRows * kCols;
  static constexpr int kGroup = 32 / kCells;   // lanes that end with a cell
  static constexpr int kShift = kCells == 16 ? 1 : 3;   // log2(kGroup)
};

struct HeadArgs {
  const float* X;        // [G, A, K]
  const float* Y;        // [G, B, K]
  const float* b1;       // [K]
  const float* W2;       // [K, O]
  const float* b2;       // [O]
  const int* seeds;      // [G], dropout kernels
  const int* labels;     // [G, A, B], weighted kernels
  const float* weights;  // [G, A, B], weighted kernels
  const float* gl;       // [1], the loss cotangent (device)
  float* out;
  int A, B, K, O;
  int col;               // the column form: the column of W2 and b2 taken
  int ksplit;            // warps splitting K (the caller's choice)
  int col_warps;         // column tiles a block      } set by plan_launch
  int row_tiles, col_groups;   //                     }
  uint32_t thr;          // keep iff hash >= thr
  float scale;           // factor on kept elements
};

// One exchange step of the transpose-reduce over lane bit M: while more
// than kKeep values are live, a lane keeps one half and sends the other;
// after that, a butterfly.  v[0 .. kKeep) ends as the sums of the lane's
// cell over all 32 lanes, equal bits in the lanes that share the cell.
template <int kN, int kKeep, int M, int kFullN>
__device__ __forceinline__ void reduce_step(float (&v)[kFullN], int lane) {
  if constexpr (M >= 1) {
    if constexpr (kN > kKeep) {
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const float send = up ? v[i] : v[i + kN / 2];
        const float keep = up ? v[i + kN / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, M);
      }
      reduce_step<kN / 2, kKeep, M / 2, kFullN>(v, lane);
    } else {
#pragma unroll
      for (int o = 0; o < kKeep; ++o)
        v[o] += __shfl_xor_sync(kFull, v[o], M);
      reduce_step<kN, kKeep, M / 2, kFullN>(v, lane);
    }
  }
}

// Loads kN consecutive floats at p: 16-byte loads (kN a multiple of 4), one
// 8-byte load (kN == 2), else 4-byte loads.  `wide` says whether p is
// aligned for them.
template <int kN, bool kWide>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[kN]) {
  if constexpr (kWide && kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (kWide && kN == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = __ldg(p + i);
  }
}

// The state of a warp's tile through the k loop.
template <int kO>
struct TileState {
  const float* xg;   // X[g]
  const float* yg;   // Y[g]
  int xo[Tile<kO>::kRows], yo[Tile<kO>::kCols];   // row and column offsets
  uint32_t keys[Tile<kO>::kCells];                // per-cell hash keys
  unsigned mask;                                  // live cells
  float acc[Tile<kO>::kCells * kO];               // the lane's partial sums
};

// Adds the lane's kW consecutive k, from k on, to every live cell of the
// tile.  kAligned: the operands take 16-byte loads (the kW == 4 passes of
// the 16-byte form, and W2's rows in its scalar last pass).  kColumn: kO
// is 1 and the head is column p.col of W2 [K, p.O]; kExactO then says that
// p.O is 2.  kFastDot: the activation, after the dropout scale, and W2
// are rounded to bf16 (the header's note).
template <int kO, bool kExactO, int kW, bool kAligned, bool kDrop,
          bool kColumn = false, bool kFastDot = false>
__device__ __forceinline__ void tile_accumulate(const HeadArgs& p,
                                                TileState<kO>& st, int k) {
  using T = Tile<kO>;
  constexpr int TA = T::kRows, TB = T::kCols;
  float xb[TA][kW], yv[TB][kW], w[kW * kO], bv[kW];
  load_vec<kW, kAligned>(p.b1 + k, bv);
#pragma unroll
  for (int r = 0; r < TA; ++r) {
    load_vec<kW, kAligned>(st.xg + st.xo[r] + k, xb[r]);
#pragma unroll
    for (int v = 0; v < kW; ++v) xb[r][v] += bv[v];
  }
#pragma unroll
  for (int c = 0; c < TB; ++c)
    load_vec<kW, kAligned>(st.yg + st.yo[c] + k, yv[c]);
  if constexpr (kColumn && kExactO) {   // both columns of the kW rows
    float both[kW * 2];
    load_vec<kW * 2, kAligned>(p.W2 + (size_t)k * 2, both);
#pragma unroll
    for (int v = 0; v < kW; ++v) w[v] = p.col ? both[2 * v + 1] : both[2 * v];
  } else if constexpr (kColumn) {
#pragma unroll
    for (int v = 0; v < kW; ++v)
      w[v] = __ldg(p.W2 + (size_t)(k + v) * p.O + p.col);
  } else if constexpr (kExactO) {   // rows k .. k + kW - 1 of W2, contiguous
    load_vec<kW * kO, kAligned>(p.W2 + (size_t)k * kO, w);
  } else {
#pragma unroll
    for (int v = 0; v < kW; ++v)
#pragma unroll
      for (int o = 0; o < kO; ++o)
        w[v * kO + o] =
            o < p.O ? __ldg(p.W2 + (size_t)(k + v) * p.O + o) : 0.f;
  }
  if constexpr (kFastDot) {
#pragma unroll
    for (int i = 0; i < kW * kO; ++i) w[i] = bf16_round(w[i]);
  }
#pragma unroll
  for (int r = 0; r < TA; ++r) {
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      if ((st.mask >> (r * TB + c)) & 1u) {
#pragma unroll
        for (int v = 0; v < kW; ++v) {
          float h = fmaxf(xb[r][v] + yv[c][v], 0.f);
          if constexpr (kDrop)
            h = hash32(st.keys[r * TB + c] ^ (uint32_t)(k + v)) >= p.thr
                    ? h * p.scale
                    : 0.f;
          if constexpr (kFastDot) h = bf16_round(h);
#pragma unroll
          for (int o = 0; o < kO; ++o)
            st.acc[(r * TB + c) * kO + o] =
                fmaf(h, w[v * kO + o], st.acc[(r * TB + c) * kO + o]);
        }
      }
    }
  }
}

// Where the calling thread works.  Block b of the grid is (image g, row
// tile, group of column tiles); warp w of the block is column tile
// w % col_warps of the group and k slice w / col_warps.  A lane's cell is
// the one it ends the transpose-reduce with: cell (lane >> kShift) of the
// tile, row-major.
struct TileCoords {
  int g, a0, b0;   // image, first row and first column of the warp's tile
  int s, ctw;      // k slice, column tile within the block
  int a, b;        // the lane's cell
  size_t cell;     // (g * A + a) * B + b; only valid when `inside`
  bool inside;     // the cell lies in the grid (any slice)
  bool owner;      // one lane per cell inside the grid, in slice 0: it writes
};

template <int kO>
__device__ __forceinline__ TileCoords tile_coords(const HeadArgs& p) {
  using T = Tile<kO>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  TileCoords t;
  t.ctw = warp % p.col_warps;
  t.s = warp / p.col_warps;
  const int cg = blockIdx.x % p.col_groups;
  const int rt = (blockIdx.x / p.col_groups) % p.row_tiles;
  t.g = blockIdx.x / (p.col_groups * p.row_tiles);
  t.a0 = rt * T::kRows;
  t.b0 = (cg * p.col_warps + t.ctw) * T::kCols;
  const int c = lane >> T::kShift;
  t.a = t.a0 + c / T::kCols;
  t.b = t.b0 + c % T::kCols;
  t.inside = t.a < p.A && t.b < p.B;
  t.owner = t.inside && t.s == 0 && (lane & (T::kGroup - 1)) == 0;
  t.cell = ((size_t)t.g * p.A + t.a) * p.B + t.b;
  return t;
}

// The logits of the calling warp's tile.  Every thread of the block must
// call it (a K split meets at a barrier).  `red` is kRedFloats of shared
// memory.  In the weighted kernels (kWeighted) cells of weight 0 are not
// computed: they come out as b2.  On return, in the warps of slice 0,
// logit[0 .. O) are the logits of the lane's cell (b2 added; zero beyond
// O), equal bits in the lanes that share a cell.  In the column form
// (kColumn, kO = 1) logit[0] is the logit of column p.col.  kFastDot: the
// one-pass bf16 dot (the header's note).
template <int kO, bool kExactO, int kV, bool kDrop, bool kWeighted,
          bool kColumn = false, bool kFastDot = false>
__device__ __forceinline__ void head_tile_logits(const HeadArgs& p,
                                                 const TileCoords& t,
                                                 float* red,
                                                 float (&logit)[kO]) {
  using T = Tile<kO>;
  constexpr int TA = T::kRows, TB = T::kCols, kCells = T::kCells;
  constexpr int kN = kCells * kO;
  const int lane = threadIdx.x & 31;
  const int A = p.A, B = p.B, K = p.K, O = p.O;

  // the live cells of the tile, as a warp-uniform mask: lane c looks at
  // cell c = (c / TB, c % TB)
  TileState<kO> st;
  const int ac = t.a0 + lane / TB, bc = t.b0 + lane % TB;
  bool live = lane < kCells && ac < A && bc < B;
  if (kWeighted && live)
    live = __ldg(p.weights + ((size_t)t.g * A + ac) * B + bc) != 0.f;
  st.mask = __ballot_sync(kFull, live);

  if constexpr (kDrop) {
    const uint32_t seed_key = hash32((uint32_t)__ldg(p.seeds + t.g));
    const uint32_t mine =
        hash32(hash32(seed_key ^ (uint32_t)ac) ^ (uint32_t)bc);
#pragma unroll
    for (int c = 0; c < kCells; ++c)
      st.keys[c] = __shfl_sync(kFull, mine, c);
  }
  float (&acc)[kN] = st.acc;
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;

  if (st.mask != 0u) {
    st.xg = p.X + (size_t)t.g * A * K;
    st.yg = p.Y + (size_t)t.g * B * K;
    // rows and columns beyond the edge read clamped addresses
#pragma unroll
    for (int r = 0; r < TA; ++r) st.xo[r] = min(t.a0 + r, A - 1) * K;
#pragma unroll
    for (int c = 0; c < TB; ++c) st.yo[c] = min(t.b0 + c, B - 1) * K;
    // whole passes of 32 lanes x kV k, dealt to the slices in turn; then
    // what is left of K (K = 800: 32 of a 128-wide pass) one k a lane, so
    // that no lane idles through a wide pass; it goes to the next slice
    constexpr int kPass = 32 * kV;
    const int full = K / kPass;
    for (int it = t.s; it < full; it += p.ksplit)
      tile_accumulate<kO, kExactO, kV, kV == 4, kDrop, kColumn, kFastDot>(
          p, st, (it * 32 + lane) * kV);
    if (full % p.ksplit == t.s) {
      for (int k = full * kPass + lane; k < K; k += 32)
        tile_accumulate<kO, kExactO, 1, kV == 4, kDrop, kColumn, kFastDot>(
            p, st, k);
    }
    __syncwarp();
    reduce_step<kN, kO, 16, kN>(acc, lane);
  }

  if (p.ksplit > 1) {                   // block-uniform
    const int warp = threadIdx.x >> 5;
    const int c = lane >> T::kShift;
    if ((lane & (T::kGroup - 1)) == 0) {
#pragma unroll
      for (int o = 0; o < kO; ++o) red[(warp * kCells + c) * kO + o] = acc[o];
    }
    __syncthreads();
    if (t.s == 0) {                     // the slices, in the order 0, 1, ...
#pragma unroll
      for (int o = 0; o < kO; ++o) {
        float sum = red[(t.ctw * kCells + c) * kO + o];
        for (int q = 1; q < p.ksplit; ++q)
          sum += red[((q * p.col_warps + t.ctw) * kCells + c) * kO + o];
        acc[o] = sum;
      }
    }
  }
  if constexpr (kColumn) {
    logit[0] = acc[0] + __ldg(p.b2 + p.col);
  } else {
#pragma unroll
    for (int o = 0; o < kO; ++o)
      logit[o] = o < O ? acc[o] + __ldg(p.b2 + o) : 0.f;
  }
}

// Stores a cell's O logits (or their gradient) at dst.
template <int kO, bool kExactO>
__device__ __forceinline__ void store_cell(float* dst, const float (&v)[kO],
                                           int O) {
  if constexpr (kExactO && kO == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kExactO && kO == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int o = 0; o < kO; ++o)
      if (o < O) dst[o] = v[o];
  }
}

// Settles the form and the launch shape of a call; ksplit, the number of
// warps that split K, is the caller's one choice.  The 16-byte form (*vec)
// is taken when X, Y, b1 and W2 are 16-byte aligned and K % 4 == 0; the
// tiles are those of the form ICL_HEAD_DISPATCH then picks (4 x 4 cells a
// warp in the 16-byte forms at O = 2 and O = 4, else 2 x 2); a block holds
// one column tile when K is split and up to kColTiles otherwise (1, 2 or 4
// measured alike).  Returns false on a split the kernels do not take.
inline bool plan_launch(HeadArgs& p, int G, int ksplit, int* vec,
                        unsigned* blocks, unsigned* threads) {
  if (ksplit < 1 || ksplit > kMaxWarps) return false;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(p.X) | reinterpret_cast<uintptr_t>(p.Y) |
      reinterpret_cast<uintptr_t>(p.b1) | reinterpret_cast<uintptr_t>(p.W2);
  *vec = p.K % 4 == 0 && bits % 16 == 0;
  const int t = *vec && (p.O == 2 || p.O == 4) ? 4 : 2;
  const int col_tiles = (p.B + t - 1) / t;
  p.ksplit = ksplit;
  p.col_warps =
      ksplit > 1 ? 1 : (col_tiles < kColTiles ? col_tiles : kColTiles);
  p.row_tiles = (p.A + t - 1) / t;
  p.col_groups = (col_tiles + p.col_warps - 1) / p.col_warps;
  const long long n = (long long)G * p.row_tiles * p.col_groups;
  if (n >= (1ll << 31)) return false;
  *blocks = (unsigned)n;
  *threads = 32u * p.ksplit * p.col_warps;
  return true;
}

// ---------------------------------------------------------------------------
// The fast dot on the tensor cores: the bf16 mode of K1/K2 (grid_head.cu
// grid_head_bf16dot_kernel) and of K9 (affinity_rank.cu
// affinity_rank_bf16dot_kernel).
//
// It computes what the fast dot above computes without dropout: h =
// relu((X + b1) + Y), added in f32 in that order and rounded to bf16
// (nearest even); W2 rounded to bf16; the exact products summed in f32;
// + b2.  The dot is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
// A is 16 cells x 16 k of h, built in registers: one f32 add an element,
// then one cvt.rn.relu.bf16x2.f32 takes the max with 0 and rounds two
// values into a fragment register.  B is 16 k x 8 of W2: its O columns
// (K9: the one column ranked) and zeros up to 8.  Per element of [cells,
// K] that is 1.5 instructions and 1/256 of an mma, where the FMA form
// ran 2 + O float instructions and two conversions (at 16 a clock an SM,
// the conversions alone made the FMA form's fast dot slower than f32).
//
// What bounds it then is the operands' way in, not the arithmetic: the
// bytes each SM pulls from L2 (Y above all, read again by every group of
// mentions of its image) and the round trips before a warp's first chunk.
// So:
//  * A block is one group of 8 mentions of an image and all its boxes, in
//    warp tiles of 16 boxes (8 where B <= 8): up to 8 tiles side by side,
//    the rest in turns, times the K split.  An m-tile's 16 rows are 16
//    boxes of one mention (kBT = 16: 8 m-tiles a warp) or 8 boxes of two
//    (kBT = 8: 4 m-tiles).  Lane l holds rows l / 4 and l / 4 + 8 of each.
//  * The 16 k's of a chunk are dealt to the fragment's slots so that a
//    lane's four are consecutive: slots 2t, 2t + 1 (registers a0, a1 and
//    b0) take k0 + 4t + {0, 1}, slots 8 + 2t, 9 + 2t (a2, a3, b1) take
//    k0 + 4t + {2, 3}, t = l % 4.  A and B agree on it, so the sum is the
//    same, and every operand of a lane is one 16-byte load a row.
//  * Once a block, into shared memory (stage_block, every load of a round
//    issued before its first store): X + b1 of its mentions (f32, the
//    reference's first add; K padded to a multiple of 16 with zeros) and
//    W2's B fragments rounded to bf16, in the order the lanes read them
//    (zero past O and past K).  Y goes through a ring of kDotStages
//    chunks a warp (cp.async, 16 bytes a lane; +0 past K), its first
//    chunks in flight while the block stages the rest.  A chunk costs a
//    lane (kBT = 16) 2 copies and 2 shared loads of Y, 8 broadcast loads
//    of X + b1 and one 8-byte load of B for 64 elements of h: 64 adds, 32
//    cvt and 8 mma.  Nothing past K is read from stale shared memory,
//    which may hold a NaN.
//  * The sum's order: each m-tile's accumulator runs through the chunks
//    of the warp's k slice in k order (D = A B + D).  Small grids split K
//    over ksplit warps (slice s takes chunks s, s + ksplit, ...); the
//    slices meet in shared memory and are added in the order s = 0, 1, ...
//    No atomics, no data-dependent order: two calls give equal bits.
//  * Rows beyond the grid's edge read clamped rows and are not written.
//    Operands not 16-byte aligned, or K % 4 != 0, take 4-byte loads
//    (kVec false), the same routine.
//  * A block's set-up (a round of loads for X + b1 and W2, then the
//    ring's) costs about as much as the FMA form's whole call on a small
//    grid, so the callers (icl_torch/ops/grid_head.py dot_plan) give this
//    routine the grids with work enough and the FMA form the rest.

constexpr int kDotMentions = 8;    // mentions a warp tile and a block
constexpr int kDotWarps = 8;       // warps a block at most
constexpr int kDotK = 16;          // k a chunk
constexpr int kDotStages = 4;      // chunks in a warp's ring (3 in flight)
constexpr int kDotSmem = 227 * 1024;                // a block's shared memory

struct DotArgs {
  const float* X;        // [G, A, K]
  const float* Y;        // [G, B, K]
  const float* b1;       // [K]
  const float* W2;       // [K, O]
  const float* b2;       // [O]
  float* out;
  int G, A, B, K, O;
  int col;               // the column form: the column of W2 and b2 taken
  int ksplit;            // warps splitting K (the caller's choice)
  int tasks;             // warp tiles side by side in a block } set by
  int row_groups;        // groups of mentions of an image    } plan_dot
  int col_tiles;         // tiles of kBT boxes of an image    }
  int chunks;            // ceil(K / 16)                      }
};

template <int kBT>
struct DotTile {
  static constexpr int kTiles = kBT == 16 ? 8 : 4;   // m-tiles a warp
  static constexpr int kMentions = kDotMentions;
  static constexpr int kYRows = kBT / 8;         // Y rows a lane copies
  static constexpr int kRed = kTiles * 4 * 32;   // a warp's K-split sums
  // floats a warp: the ring, room for the K split's sums that reuse it
  static constexpr int kRing = kDotStages * kBT * kDotK > kRed
                                   ? kDotStages * kBT * kDotK
                                   : kRed;
};

// a lane's accumulators: 4 floats of each m-tile
template <int kBT>
using DotAcc = float[DotTile<kBT>::kTiles][4];

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;   // lo in the low half, as a fragment holds the lower k
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;   // max(v, 0) rounded to bf16, both values
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += A . B: one 16 x 8 x 16 bf16 product, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// k .. k + 3 of a row into shared memory, +0 past K, without waiting: one
// 16-byte cp.async (kVec: K % 4 == 0 and the row 16-byte aligned) or four
// 4-byte ones; a copy past K reads nothing and fills zeros.
template <bool kVec>
__device__ __forceinline__ void copy_k4(float* dst,
                                        const float* __restrict__ row, int k,
                                        int K) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (kVec) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(k < K ? row + k : row), "r"(k < K ? 16 : 0)
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   :: "r"(d + 4 * j), "l"(k + j < K ? row + k + j : row),
                      "r"(k + j < K ? 4 : 0)
                   : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// The lane's rows of Y in a warp tile whose first box is b0, as offsets in
// the image, clamped to the grid: l / 4 (and l / 4 + 8 at kBT = 16).
template <int kBT>
struct DotRows {
  int yo[DotTile<kBT>::kYRows];
  bool live;             // the tile has a box inside the grid (warp-uniform)
};

template <int kBT>
__device__ __forceinline__ DotRows<kBT> dot_rows(const DotArgs& p, int b0) {
  const int r = (threadIdx.x & 31) >> 2;
  DotRows<kBT> w;
#pragma unroll
  for (int i = 0; i < DotTile<kBT>::kYRows; ++i)
    w.yo[i] = min(b0 + r + 8 * i, p.B - 1) * p.K;
  w.live = b0 < p.B;
  return w;
}

// Copies chunk c of the tile's Y rows into a ring stage [kBT][16]: lane l
// takes k = 16 c + 4 (l % 4) .. + 3 of its rows.
template <int kBT, bool kVec>
__device__ __forceinline__ void dot_copy(const DotArgs& p, const float* yg,
                                         const DotRows<kBT>& w, int c,
                                         float* stage) {
  const int lane = threadIdx.x & 31, r = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < DotTile<kBT>::kYRows; ++i)
    copy_k4<kVec>(stage + (r + 8 * i) * kDotK + t * 4, yg + w.yo[i],
                  c * kDotK + t * 4, p.K);
}

// The first kDotStages - 1 chunks of the warp's k slice s into its ring
// (one commit group each, empty ones too).
template <int kBT, bool kVec>
__device__ __forceinline__ void dot_start(const DotArgs& p, const float* yg,
                                          const DotRows<kBT>& w, int s,
                                          float* ring) {
#pragma unroll
  for (int j = 0; j < kDotStages - 1; ++j) {
    const int c = s + j * p.ksplit;
    if (w.live && c < p.chunks)
      dot_copy<kBT, kVec>(p, yg, w, c, ring + j * kBT * kDotK);
    copy_commit();
  }
}

// The block's operands into shared memory, once:
//  * W2's B fragments rounded to bf16: entry c * 32 + l is lane l's {b0,
//    b1} of chunk c: column n = l / 4 of W2 (the column form: n = 0 is
//    p.col), k = 16 c + 4 (l % 4) + {0, 1} and + {2, 3}; zero for n past
//    O (column form: past 0) and k past K.  Warp w takes chunks w, w +
//    warps, ...
//  * X + b1 of the mentions a0 .. a0 + kMentions - 1 (clamped to the
//    grid): row m at xb + m * 16 chunks, zero past K; thread i takes k's
//    4 i .. 4 i + 3 of every row.
// A round issues all its loads (kStageChunks chunks of W2 a warp, 4 k's
// of b1 and of each X row a thread) before its first store, so the block
// waits about one latency a round.  Every thread of the block calls it.
constexpr int kStageChunks = 4;

template <int kBT, bool kVec>
__device__ __forceinline__ void stage_block(const DotArgs& p, int g, int a0,
                                            uint2* frag, float* xb) {
  constexpr int kM = DotTile<kBT>::kMentions;
  const int lane = threadIdx.x & 31, nc = lane >> 2;
  const int warps = blockDim.x >> 5;
  const int col = p.col >= 0 ? p.col : nc;
  const bool live = p.col >= 0 ? nc == 0 : nc < p.O;
  const int kp = p.chunks * kDotK;
  const float* xg = p.X + (size_t)g * p.A * p.K;
  for (int r = 0; r * kStageChunks * warps < p.chunks ||
                  r * 4 * (int)blockDim.x < kp; ++r) {
    float w[kStageChunks][4];
#pragma unroll
    for (int u = 0; u < kStageChunks; ++u) {
      const int c = (threadIdx.x >> 5) + (r * kStageChunks + u) * warps;
      const int k = c * kDotK + (lane & 3) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[u][j] = live && c < p.chunks && k + j < p.K
                      ? __ldg(p.W2 + (k + j) * p.O + col)
                      : 0.f;
    }
    const int k = 4 * (threadIdx.x + r * blockDim.x);
    float4 xv[kM], bv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < kM; ++m) xv[m] = bv;
    if constexpr (kVec) {
      if (k < p.K) {
        bv = __ldg(reinterpret_cast<const float4*>(p.b1 + k));
#pragma unroll
        for (int m = 0; m < kM; ++m)
          xv[m] = __ldg(reinterpret_cast<const float4*>(
              xg + min(a0 + m, p.A - 1) * p.K + k));
      }
    } else {
      float f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = k + j < p.K ? __ldg(p.b1 + k + j) : 0.f;
      bv = make_float4(f[0], f[1], f[2], f[3]);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float* x = xg + min(a0 + m, p.A - 1) * p.K;
#pragma unroll
        for (int j = 0; j < 4; ++j) f[j] = k + j < p.K ? __ldg(x + k + j) : 0.f;
        xv[m] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageChunks; ++u) {
      const int c = (threadIdx.x >> 5) + (r * kStageChunks + u) * warps;
      if (c < p.chunks)
        frag[c * 32 + lane] =
            make_uint2(bf16x2(w[u][0], w[u][1]), bf16x2(w[u][2], w[u][3]));
    }
    if (k < kp) {   // X + b1 in f32, the reference's first add
#pragma unroll
      for (int m = 0; m < kM; ++m)
        *reinterpret_cast<float4*>(xb + m * kp + k) =
            make_float4(xv[m].x + bv.x, xv[m].y + bv.y, xv[m].z + bv.z,
                        xv[m].w + bv.w);
    }
  }
}

// The m-tiles' products of chunk c: Y from the ring stage, X + b1 from the
// block's rows, B the chunk's fragment of W2.
template <int kBT>
__device__ __forceinline__ void dot_chunk(const float* stage, const float* xb,
                                          int kp, int c, uint2 bf,
                                          DotAcc<kBT>& acc) {
  const int lane = threadIdx.x & 31, r = lane >> 2, t = lane & 3;
  const float4 y0 = lds4(stage + r * kDotK + t * 4);
  const float4 y1 = kBT == 16 ? lds4(stage + (r + 8) * kDotK + t * 4) : y0;
  const float* xc = xb + c * kDotK + t * 4;
#pragma unroll
  for (int i = 0; i < DotTile<kBT>::kTiles; ++i) {
    // (X + b1) + Y in f32, rows l / 4 (x0, y0) and l / 4 + 8 (x1, y1)
    const float4 x0 = lds4(xc + (kBT == 16 ? i : 2 * i) * kp);
    const float4 x1 = kBT == 16 ? x0 : lds4(xc + (2 * i + 1) * kp);
    uint32_t a[4];
    a[0] = relu_bf16x2(x0.x + y0.x, x0.y + y0.y);
    a[1] = relu_bf16x2(x1.x + y1.x, x1.y + y1.y);
    a[2] = relu_bf16x2(x0.z + y0.z, x0.w + y0.w);
    a[3] = relu_bf16x2(x1.z + y1.z, x1.w + y1.w);
    mma_bf16(acc[i], a, bf);
  }
}

// The warp's k slice s, after dot_start: acc (zeroed here) ends as the sums
// over the slice's chunks, in k order.  Each turn copies the chunk
// kDotStages - 1 ahead, waits for this one's group, and computes.
template <int kBT, bool kVec>
__device__ __forceinline__ void dot_slice(const DotArgs& p, const float* yg,
                                          const DotRows<kBT>& w,
                                          const uint2* frag, const float* xb,
                                          int s, float* ring,
                                          DotAcc<kBT>& acc) {
  constexpr int kStage = kBT * kDotK;
#pragma unroll
  for (int i = 0; i < DotTile<kBT>::kTiles; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  const int lane = threadIdx.x & 31, kp = p.chunks * kDotK;
  if (w.live) {
    for (int it = 0, c = s; c < p.chunks; ++it, c += p.ksplit) {
      const int ahead = c + (kDotStages - 1) * p.ksplit;
      if (ahead < p.chunks)
        dot_copy<kBT, kVec>(
            p, yg, w, ahead,
            ring + ((it + kDotStages - 1) % kDotStages) * kStage);
      copy_commit();
      copy_wait<kDotStages - 1>();
      __syncwarp();
      dot_chunk<kBT>(ring + (it % kDotStages) * kStage, xb, kp, c,
                     frag[c * 32 + lane], acc);
      __syncwarp();
    }
  }
  copy_wait<0>();
  __syncwarp();
}

// The K split's meeting: the warps of slices 1 .. ksplit - 1 leave their
// sums in their own rings, and the warp of slice 0 of each tile adds them
// to its own in the order s = 1, 2, ...  Every thread of the block calls
// it; warp w is tile slot w % tasks of slice w / tasks, its ring at
// rings + w * kRing.
template <int kBT>
__device__ __forceinline__ void dot_reduce(const DotArgs& p, float* rings,
                                           DotAcc<kBT>& acc) {
  constexpr int kRing = DotTile<kBT>::kRing;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp % p.tasks, s = warp / p.tasks;
  if (s > 0) {
#pragma unroll
    for (int i = 0; i < DotTile<kBT>::kTiles; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rings[warp * kRing + (i * 4 + q) * 32 + lane] = acc[i][q];
  }
  __syncthreads();
  if (s == 0) {
    for (int t = 1; t < p.ksplit; ++t) {
      const float* r = rings + (t * p.tasks + slot) * kRing;
#pragma unroll
      for (int i = 0; i < DotTile<kBT>::kTiles; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += r[(i * 4 + q) * 32 + lane];
    }
  }
}

// A fast-dot block's shared memory: W2's fragments (chunks x 32 x 8
// bytes), X + b1 of its mentions (mentions x chunks x 64 bytes), a ring a
// warp, then (ranking) the scores.
__host__ __device__ __forceinline__ size_t dot_smem(int bt, int chunks,
                                                    int warps, int B,
                                                    bool whole_rows) {
  const int mentions = kDotMentions;
  const int ring = bt == 16 ? DotTile<16>::kRing : DotTile<8>::kRing;
  return (size_t)chunks * 32 * 8 + (size_t)mentions * chunks * kDotK * 4 +
         (size_t)warps * ring * 4 + (whole_rows ? (size_t)mentions * B * 4 : 0);
}

// Block b of a fast-dot kernel: image g and group of mentions rg (b = g x
// row_groups + rg).  Stages the block's operands, then in turns of p.tasks
// box tiles runs each warp's slice of its tile, meets the K split, and
// hands slice 0's sums to epi(acc, g, a0, b0).  Every thread of the block
// calls it; epi is called by the warps of slice 0.
template <int kBT, bool kVec, class Epilogue>
__device__ __forceinline__ void dot_block(const DotArgs& p,
                                          unsigned char* smem,
                                          Epilogue&& epi) {
  using T = DotTile<kBT>;
  uint2* frag = reinterpret_cast<uint2*>(smem);
  float* xb = reinterpret_cast<float*>(frag + p.chunks * 32);
  float* rings = xb + T::kMentions * p.chunks * kDotK;
  const int warp = threadIdx.x >> 5;
  const int slot = warp % p.tasks, s = warp / p.tasks;
  const int g = blockIdx.x / p.row_groups;
  const int a0 = (blockIdx.x % p.row_groups) * T::kMentions;
  const float* yg = p.Y + (size_t)g * p.B * p.K;
  float* ring = rings + warp * T::kRing;
  DotRows<kBT> w = dot_rows<kBT>(p, slot * kBT);
  dot_start<kBT, kVec>(p, yg, w, s, ring);   // in flight while staging
  stage_block<kBT, kVec>(p, g, a0, frag, xb);
  __syncthreads();
  for (int ct0 = 0; ct0 < p.col_tiles; ct0 += p.tasks) {
    const int b0 = (ct0 + slot) * kBT;
    if (ct0 > 0) {   // the last turn's sums are read: the rings are free
      __syncthreads();
      w = dot_rows<kBT>(p, b0);
      dot_start<kBT, kVec>(p, yg, w, s, ring);
    }
    DotAcc<kBT> acc;
    dot_slice<kBT, kVec>(p, yg, w, frag, xb, s, ring, acc);
    if (p.ksplit > 1) dot_reduce<kBT>(p, rings, acc);
    if (s == 0 && w.live) epi(acc, g, a0, b0);
  }
}

// Settles the launch of the fast dot; ksplit, the number of warps that
// split K, is the caller's one choice (icl_torch/ops/grid_head.py dot_plan
// computes the same).  kBT is 8 where B <= 8, else 16.  A block is one
// group of mentions of an image with all its boxes: min(box tiles, 8)
// tiles side by side (the rest in turns) times the split, at most 8
// warps.  Shared memory: dot_smem (whole_rows: the ranking's scores too).
// Returns false on a call the kernels do not take.
inline bool plan_dot(DotArgs& p, int ksplit, bool whole_rows, int* vec,
                     int* bt, unsigned* blocks, unsigned* threads,
                     size_t* smem) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(p.X) | reinterpret_cast<uintptr_t>(p.Y) |
      reinterpret_cast<uintptr_t>(p.b1);
  *vec = p.K % 4 == 0 && bits % 16 == 0;
  *bt = p.B <= 8 ? 8 : 16;
  const int mentions = kDotMentions;
  p.row_groups = (p.A + mentions - 1) / mentions;
  p.col_tiles = (p.B + *bt - 1) / *bt;
  p.chunks = (p.K + kDotK - 1) / kDotK;
  p.ksplit = ksplit;
  p.tasks = p.col_tiles < kDotWarps ? p.col_tiles : kDotWarps;
  const long long n = (long long)p.G * p.row_groups;
  if (ksplit < 1 || p.tasks * ksplit > kDotWarps || n >= (1ll << 31) ||
      (long long)p.K * p.O >= (1ll << 31))
    return false;
  *blocks = (unsigned)n;
  *threads = 32u * p.tasks * ksplit;
  *smem = dot_smem(*bt, p.chunks, p.tasks * ksplit, p.B, whole_rows);
  return *smem <= (size_t)kDotSmem;
}

}  // namespace icl_head

// Runs the statement CALL(kO, kExactO, kV) for the form that takes a head
// of width O: the 16-byte forms at O = 4, O = 2 and generic, or the scalar
// generic one.
#define ICL_HEAD_DISPATCH(O, vec, CALL)   \
  do {                                    \
    if ((vec) && (O) == 4) {              \
      CALL(4, true, 4);                   \
    } else if ((vec) && (O) == 2) {       \
      CALL(2, true, 4);                   \
    } else if (vec) {                     \
      CALL(8, false, 4);                  \
    } else {                              \
      CALL(8, false, 1);                  \
    }                                     \
  } while (0)
