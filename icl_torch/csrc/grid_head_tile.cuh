// The grid head's forward tile routine, f32, for Hopper (sm_90a):
//
//     logit[g, a, b, :] = dropout(relu(X[g, a] + b1 + Y[g, b])) . W2 + b2
//
// and its one-pass bf16 dot (kFastDot): the two operands of the dot, the
// activation dropout(relu((X + b1) + Y)) (added in f32 in that order, and
// rounded after the dropout scale) and every W2 entry, are rounded to bf16
// (round to nearest even).  A product of two bf16 values is exact in f32,
// so the FMAs and the sums stay f32: what a one-pass bf16 dot with f32
// accumulation computes.  Inputs and outputs stay f32.  It is the bf16
// mode of K1/K2 and K9 without dropout (the reference's fast_dot in
// icl/ops/grid_head.py _kernel and _flat_kernel) and the exact=False mode
// of the training forward family with it (Precision.DEFAULT in
// icl/ops/grid_head_train.py).  It runs the same FMAs as the f32 mode,
// plus two conversions an element; the f32 mode is another instantiation
// and keeps its bits.
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
