// The flash-attention backward for heads wider than 128 on Hopper (sm_90a):
// dQ, and dK with dV, at every head width W that is a multiple of 64 from
// 192 to 512.
//
// Replaces, at those widths, the same two TPU kernels of
// syncfusion_tpu/ops/attention.py as flash_bwd.cu:
//   flash_bwd_dq_wide   <- `_flash_bwd_dq_kernel` (K2a), with the reduction
//                          delta = rowsum(dO∘O) fused in;
//   flash_bwd_dkv_wide  <- `_flash_bwd_dkv_kernel` (K2b).
// For each (batch, head), with P = exp(q kᵀ·scale - lse) and dS = P∘(dO vᵀ
// - delta): dQ = scale·dS·K, dK = scale·dSᵀ·q, dV = Pᵀ·dO, with an optional
// causal (top-left aligned) mask.  The forward at these widths (K1) is
// flash_fwd_wide_sm90.cu's; wider heads go to flash_wide.cu.  The wrapper
// zero-pads a head to W and passes the true width's scale (the zero columns
// change no logit, LSE or delta, and come out 0).
//
// What bounds it: per (batch, head) K2a does 6·T²·W operations (S, dP,
// dS·K) and K2b 8·T²·W (S, dP, Pᵀ·dO, dSᵀ·q) against ~6·T·W elements
// moved: above the card's ridge at the UNet's T = 1024 and 2048, so the
// tensor cores' rate.
//
// The design (one launch a call for each kernel; no atomics, so dq, dk, dv
// and delta are the same bits from run to run):
//
// * Roles.  A block owns `rows` rows of one side: q rows in K2a (its dQ
//   rows), keys in K2b (its dK and dV rows).  That side's two operands stay
//   in shared memory for the whole block (K2a: q and dO; K2b: K and V); the
//   other side's two stream through the ring in tiles of `ring_rows` rows
//   (K2a: V and K tiles; K2b: q and dO tiles).  The outputs are held at the
//   full width in registers, split over the block's warps by columns, and
//   never recomputed per chunk of columns: each S and dP element is
//   computed once a block (f32) or once a warpgroup (bf16, below).
// * Loads.  TMA (cp.async.bulk.tensor, sm90.cuh) through 4-D tensor maps
//   (W, L, H, B) built per call from the strides (tensor_map.cuh), so q, k
//   and v may be views of one packed projection.  Boxes are 128 bytes wide
//   (64 bf16 or 32 f32 columns) by a tile's rows, each on a 1024-byte
//   boundary, with the 128-byte swizzle; rows past L land as 0 and their
//   logits are masked.  Thread 0 issues every load: the block's own tiles
//   once, then the ring's items into two slots, each slot with a `full`
//   mbarrier (armed with its bytes) and an `empty` one on which all 256
//   threads arrive when done reading it; thread 0 then loads the slot's
//   next item.  No producer warp: a ninth warp caps every thread at 168
//   registers under ptxas (flash_fwd_wide_sm90.cu's note).  K2b's LSE and
//   delta vary along its products' N: each thread reads its queries' values
//   from global memory (L2) at the top of each q tile, before waiting for
//   the tile's loads.  (Read by TMA from a flat f32 map, each box starting
//   at element bh·L + l0, they ended the f32 kernel at L = 1001 with an
//   illegal-instruction error on the card, where L = 1024 agreed: a box
//   whose innermost start is not 16-byte aligned.)
// * K2a per key tile: dP = dO·Vᵀ (V's slot then released), S = q·Kᵀ, dS =
//   P∘(dP - delta), dQ += dS·K (K's slot released).  K2a first computes
//   delta = rowsum(dO∘O) of its rows at the full width, O loaded by TMA
//   into the ring's slots before the ring starts, in a fixed order of
//   operations, and writes it once, with no atomics.
// * K2b per q tile: Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ with keys as the products'
//   M, so that Pᵀ and dSᵀ come out in the layout dV += Pᵀ·dO and dK +=
//   dSᵀ·q take as their A operand: no transpose through shared memory.
// * bf16: S and dP (Sᵀ, dPᵀ) on wgmma m64n32k16 from shared memory, both
//   operands K-major; the outputs on wgmma m64n64k16 with P or dS from
//   registers (the accumulator layout is the A-fragment layout) as hi + lo
//   bf16, two products (one rounding to bf16 moves an element by up to
//   2^-9, beyond the gradient gate of 1e-3), and the ring's tile as an
//   MN-major B.  Blocks of 64 rows (one wgmma M), ring tiles of 32 rows;
//   the two warpgroups hold ceil and floor of half of the output's 64-column
//   pieces (at most 128 registers a thread at W = 512) and each computes S
//   and dP itself.  K2b's blocks come in two roles, a dK block and a dV
//   block (a grid dimension), so that no warpgroup holds both outputs.
//   Operations per (query, key) pair in units of W: K2a S 2 + dP 2 a group
//   (8) and dS·K 2 x 2 (4): 12 against the function's 6 (2x); K2b dV block
//   S 2 a group (4) and Pᵀ·dO 4, dK block S + dP a group (8) and dSᵀ·q 4:
//   20 against 8 (2.5x).
// * f32: 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh: big + small parts, each
//   product as small·big + big·small + big·big, the outputs' per-tile
//   partial sums added in f32), fragments read by the threads from the
//   swizzled TMA tiles.  Not on wgmma: a tf32 wgmma reads both operands
//   K-major, so the MN-major B of the output products would need transposed
//   copies, and every operand a small part beside it, which does not fit
//   (flash_fwd_wide_sm90.cu's note).  Blocks of 32 rows (two m16 tiles) and
//   their two f32 tiles stay within shared memory at W = 512 (64-row tiles
//   alone would take 256 KB); ring tiles of 32 rows, 16 where 32 does not
//   fit (W >= 384).  Warp w takes rows 16(w % 2) .. and part w / 2 of four
//   column parts of W / 4: it computes S and dP over its part's columns
//   only, the four partial sums of each element are exchanged through
//   shared memory (double-buffered by tile parity, one __syncthreads a
//   tile) and added in a fixed order, and it holds its part's columns of
//   each output (W / 8 registers an output).  S's and dP's k-loop is
//   unrolled by 2 and the output products' loads are free to move ahead of
//   the products before them (no scheduling barriers, unlike K1's f32
//   body): 13% faster at the 2 x 256 UNet's training call than with them,
//   at most 239 registers and no spills.  No operation is repeated:
//   per pair in tf32 products of 2·W, K2a 3·(2 + 2 + 2) = 18 = 3 x the
//   function's 6, K2b 3·8 = 24.  K2b computes dK and dV in one block.
//
// flash_wide.cu's chunked pair, which took these widths before, recomputes
// S and dP once per 128-column chunk: K2a 1.67x the function's operations
// at W = 192 and 256 to 3x at 512, K2b 2x to 3.5x, all on tf32 mma.sync.
//
// Filling the card: blocks of 32 rows in f32 (64 in bf16) give, at B = 2
// and T = 1024 with heads x W = 512, 128 blocks of K2a and of K2b at W = 256
// (64 at 512; the chunked pair has 128 and 256, four warps each, doing up
// to 3x the operations); bf16 K2b has twice K2a's blocks (two roles).  Each
// block has 8 warps.
//
// Shared memory (`BwdPlan`, returned by `flash_bwd_wide_plan` and mirrored
// by ops/attention.py's `wide_bwd_plan`): 1024 bytes for the alignment,
// the block's two own tiles, the ring's two slots, f32's exchange buffers,
// 512 bytes for the LSE and delta, the five barriers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"
#include "sm90_tiles.cuh"
#include "tensor_map.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kStages = 2;     // slots of the ring
constexpr int kThreadsBwd = 256;  // two warpgroups
constexpr int kMaxWidth = 512;
constexpr size_t kSmemMax = 232448;
constexpr uint32_t kVecBytes = 512;  // K2a's LSE and delta of its rows

// Dynamic shared memory of a (type, width, rows, ring rows, column parts).
template <typename T>
constexpr size_t bwd_bytes(int width, int rows, int ring_rows, int parts) {
  return 1024 + 2 * size_t(rows) * width * sizeof(T) +
         kStages * size_t(ring_rows) * width * sizeof(T) +
         (sizeof(T) == 4 ? 2 * 2 * size_t(parts) * rows * ring_rows * 4 : 0) +
         kVecBytes + 64;
}

template <typename T, int kW>
struct BwdPlan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kEsize = sizeof(T);
  static constexpr int kPieces = kW / kPiece;
  static constexpr int kRows = kF32 ? 32 : 64;  // own rows a block
  static constexpr int kParts = kF32 ? 4 : 2;   // column parts of the outputs
  static constexpr int kRingRows =
      !kF32 ? 32 : (bwd_bytes<T>(kW, 32, 32, 4) <= kSmemMax ? 32 : 16);
  static constexpr int kRoles = kF32 ? 1 : 2;   // K2b blocks a row tile
  static constexpr int kBoxCols = 128 / kEsize;
  static constexpr int kBoxes = kW / kBoxCols;
  static constexpr uint32_t kOwnBox = kRows * 128;      // bytes of a box
  static constexpr uint32_t kRingBox = kRingRows * 128;
  static constexpr uint32_t kOwnBytes = uint32_t(kRows) * kW * kEsize;
  static constexpr uint32_t kSlotBytes = uint32_t(kRingRows) * kW * kEsize;
  static constexpr uint32_t kXBytes =
      kF32 ? 2 * 2 * kParts * kRows * kRingRows * 4 : 0;
  static constexpr size_t kSmem = bwd_bytes<T>(kW, kRows, kRingRows, kParts);
  static constexpr int kJ = kRingRows / 8;          // n-tiles of S
  static constexpr int kGroupPieces = (kPieces + 1) / 2;  // bf16
  static constexpr int kPartCols = kW / kParts;     // f32
  static constexpr int kPartTiles = kPartCols / 8;  // f32
  static constexpr int kAcc = kF32 ? kPartTiles * 4 : kGroupPieces * 32;
  // operations per (query, key) pair in units of W (the function's: K2a 6,
  // K2b 8); f32 in tf32 products, three a product
  static constexpr int kDqOps = kF32 ? 18 : 12;
  static constexpr int kDkvOps = kF32 ? 24 : 20;
  static_assert(kW % kPiece == 0 && kW > 128 && kW <= kMaxWidth, "width");
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kAcc <= 128, "an output's registers");
  static_assert(kF32 || kRingRows == 32, "bf16 S is wgmma n32");
  static_assert(kPartTiles % 2 == 0, "f32 output passes of two n-tiles");
  static_assert(kRows * kW * kEsize <= kStages * kSlotBytes,
                "K2a's O tile fits the ring");
};

// Shared memory of a block: the own tiles at own (1024-aligned) and own +
// kOwnBytes, the ring's slots, f32's exchange buffers, the LSE and delta,
// the barriers; `data` is `own` as a generic pointer.
struct BwdSmem {
  uint32_t own, ring, xb, vec, full, empty, rbar;
  unsigned char* data;
};

template <class P>
__device__ __forceinline__ BwdSmem bwd_layout(unsigned char* smem) {
  BwdSmem sm;
  const uint32_t raw = smem_addr(smem);
  sm.own = raw + ((1024 - (raw & 1023)) & 1023);
  sm.ring = sm.own + 2 * P::kOwnBytes;
  sm.xb = sm.ring + kStages * P::kSlotBytes;
  sm.vec = sm.xb + P::kXBytes;
  sm.full = sm.vec + kVecBytes;
  sm.empty = sm.full + 8 * kStages;
  sm.rbar = sm.empty + 8 * kStages;
  sm.data = smem + (sm.own - raw);
  return sm;
}

// Generic pointer of a shared address of the block.
__device__ __forceinline__ unsigned char* at(const BwdSmem& sm, uint32_t a) {
  return sm.data + (a - sm.own);
}

// Rows row0 .. of a (W, L, H, B) map into `dst` as W / box-columns boxes of
// `box` bytes, counted on the barrier `bar`.
template <class P>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row0, int h,
                                          int b, uint32_t box) {
  for (int c = 0; c < P::kBoxes; ++c)
    tma_load_4d(dst + c * box, map, bar, c * P::kBoxCols, row0, h, b);
}

__device__ __forceinline__ void init_barriers(const BwdSmem& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, kThreadsBwd);
    }
    mbar_init(sm.rbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();
}

// The first of the thread's 16 rows of the block (m16 tile): bf16 the
// warp's within its warpgroup's 64, f32 warp w's 16(w % 2).
template <class P>
__device__ __forceinline__ int tile_row0() {
  const int w = thread_index() >> 5;
  return 16 * (P::kF32 ? (w & 1) : (w & 3));
}

// ---------------------------------------------------------------------------
// d = a·bᵀ for the block's own rows (a, kRows rows) against a ring tile (b,
// kRingRows rows), in the accumulator layout d[j][e] (n-tile j: b's rows 8j
// ..; e as sm90.cuh describes): bf16 over the full width, f32 over the
// warp's column part (a partial sum, see exchange).
// ---------------------------------------------------------------------------

// bf16, one warpgroup: W / 16 wgmma m64n32k16, both operands K-major.
template <class P>
__device__ __forceinline__ void products(float (&d)[P::kJ][4], uint32_t a,
                                         uint32_t b, const unsigned char*,
                                         const unsigned char*, std::false_type) {
  float(&dd)[16] = reinterpret_cast<float(&)[16]>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P::kPieces * 4; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns, 32 bytes
    wgmma_64x32x16_ss(dd, sw128_desc(a + (kk >> 2) * P::kOwnBox + off, 16, 1024),
                      sw128_desc(b + (kk >> 2) * P::kRingBox + off, 16, 1024),
                      kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) fence_operand(dd[i]);
}

// f32, one warp's 16 rows: 3xTF32 over the W / 4 columns of its part.
template <class P>
__device__ __forceinline__ void products(float (&d)[P::kJ][4], uint32_t,
                                         uint32_t, const unsigned char* ap,
                                         const unsigned char* bp,
                                         std::true_type) {
  const int tid = thread_index();  // offsets recomputed at each call
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 1);
  const int c0 = P::kPartCols * (tid >> 6);
#pragma unroll
  for (int j = 0; j < P::kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < P::kPartTiles; ++kk) {
    const int c = c0 + 8 * kk + 2 * t;
    uint32_t ab[4], am[4];
    load2(reinterpret_cast<const float*>(ap + sw128<float, P::kRows>(r0 + g, c)),
          ab[0], ab[2], am[0], am[2]);
    load2(reinterpret_cast<const float*>(ap + sw128<float, P::kRows>(r0 + g + 8, c)),
          ab[1], ab[3], am[1], am[3]);
    uint32_t bb[P::kJ][2], bm[P::kJ][2];
#pragma unroll
    for (int j = 0; j < P::kJ; ++j)
      load2(reinterpret_cast<const float*>(
                bp + sw128<float, P::kRingRows>(8 * j + g, c)),
            bb[j][0], bb[j][1], bm[j][0], bm[j][1]);
#pragma unroll
    for (int j = 0; j < P::kJ; ++j) mma_1688_tf32(d[j], am, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < P::kJ; ++j) mma_1688_tf32(d[j], ab, bm[j][0], bm[j][1]);
#pragma unroll
    for (int j = 0; j < P::kJ; ++j) mma_1688_tf32(d[j], ab, bb[j][0], bb[j][1]);
  }
}

// f32: s and dp, each a warp's partial sum over its column part, become the
// full sums: every warp writes its parts into this tile's half of the
// exchange buffer, and after one barrier adds the four parts of its rows
// in the order of the parts (the same bits in every warp of those rows).
// The halves alternate by tile, so a tile's writes never meet the reads of
// the tile before (a barrier lies between).
template <class P>
__device__ __forceinline__ void exchange(float (&s)[P::kJ][4],
                                         float (&dp)[P::kJ][4], float* xb) {
  constexpr int kE = P::kJ * 4 * 32;  // one warp's values of one matrix
  const int tid = thread_index();
  const int lane = tid & 31;
  const int r = (tid >> 5) & 1;
  const int c = tid >> 6;
  float* mine = xb + (c * 2 + r) * 2 * kE + lane;
#pragma unroll
  for (int j = 0; j < P::kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(4 * j + e) * 32] = s[j][e];
      mine[kE + (4 * j + e) * 32] = dp[j][e];
    }
  __syncthreads();
  const float* rows = xb + r * 2 * kE + lane;
#pragma unroll
  for (int j = 0; j < P::kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (4 * j + e) * 32;
      float x = rows[i], y = rows[kE + i];
#pragma unroll
      for (int part = 1; part < P::kParts; ++part) {
        x += rows[part * 4 * kE + i];
        y += rows[part * 4 * kE + kE + i];
      }
      s[j][e] = x;
      dp[j][e] = y;
    }
}

// ---------------------------------------------------------------------------
// acc += x·b: x in the accumulator layout of `products` (its n-tiles the
// k index of this product), b the ring tile (its rows the k index, its
// columns the output's).
// ---------------------------------------------------------------------------

// bf16: the group's output pieces, x as hi + lo bf16 A fragments from
// registers, b MN-major.
template <class P>
__device__ __forceinline__ void add_product(float (&acc)[P::kAcc],
                                            const float (&x)[P::kJ][4],
                                            uint32_t b, const unsigned char*,
                                            std::false_type) {
  constexpr int kK = P::kRingRows / 16;
  float(&out)[P::kGroupPieces][32] =
      reinterpret_cast<float(&)[P::kGroupPieces][32]>(acc);
  const int first = (thread_index() >> 7) * P::kGroupPieces;
  const int mine = imin(P::kGroupPieces, P::kPieces - first);
  uint32_t ph[kK][4], pl[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float(&x0)[4] = x[2 * kk];
    const float(&x1)[4] = x[2 * kk + 1];
    split_bf16(x0[0], x0[1], ph[kk][0], pl[kk][0]);
    split_bf16(x0[2], x0[3], ph[kk][1], pl[kk][1]);
    split_bf16(x1[0], x1[1], ph[kk][2], pl[kk][2]);
    split_bf16(x1[2], x1[3], ph[kk][3], pl[kk][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc) {
    if (pc < mine) {
      const uint32_t bp = b + (first + pc) * P::kRingBox;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        // rows 16kk .. 16kk + 15: two groups of 8 rows, 1024 bytes apart
        const uint64_t db = sw128_desc(bp + kk * 16 * 128, P::kRingBox, 1024);
        wgmma_64x64x16_rs_mn(out[pc], ph[kk], db);
        wgmma_64x64x16_rs_mn(out[pc], pl[kk], db);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(out[pc][i]);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_operand(ph[kk][i]);
      fence_operand(pl[kk][i]);
    }
}

// f32: n-tiles n0 .. n0 + kN - 1 of the warp's part, 3xTF32 on mma.sync,
// x's n-tile j fed as the A fragment of k-step j in tf32_mma.cuh's
// permuted k order (a_from_c), b read in the matching rows; the tile's
// products a partial sum added in f32.
template <class P, int kN>
__device__ __forceinline__ void add_cols(float (&out)[P::kPartTiles][4],
                                         const float (&x)[P::kJ][4],
                                         const unsigned char* bp, int n0) {
  const int tid = thread_index();  // offsets recomputed at each call
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = t >> 1;
  const int c0 = P::kPartCols * (tid >> 6);
  float part[kN][4];
#pragma unroll
  for (int u = 0; u < kN; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
  for (int j = 0; j < P::kJ; ++j) {
    uint32_t ab[4], am[4];
    a_from_c(x[j], t, ab, am);
    uint32_t bb[kN][2], bm[kN][2];
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int col = c0 + 8 * (n0 + u) + g;
      load1(reinterpret_cast<const float*>(
                bp + sw128<float, P::kRingRows>(8 * j + 2 * t + h, col)),
            bb[u][0], bm[u][0]);
      load1(reinterpret_cast<const float*>(
                bp + sw128<float, P::kRingRows>(8 * j + 2 * t + 1 - h, col)),
            bb[u][1], bm[u][1]);
    }
#pragma unroll
    for (int u = 0; u < kN; ++u) mma_1688_tf32(part[u], am, bb[u][0], bb[u][1]);
#pragma unroll
    for (int u = 0; u < kN; ++u) mma_1688_tf32(part[u], ab, bm[u][0], bm[u][1]);
#pragma unroll
    for (int u = 0; u < kN; ++u) mma_1688_tf32(part[u], ab, bb[u][0], bb[u][1]);
  }
#pragma unroll
  for (int u = 0; u < kN; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n0 + u][e] += part[u][e];
}

template <class P>
__device__ __forceinline__ void add_product(float (&acc)[P::kAcc],
                                            const float (&x)[P::kJ][4],
                                            uint32_t, const unsigned char* bp,
                                            std::true_type) {
  float(&out)[P::kPartTiles][4] = reinterpret_cast<float(&)[P::kPartTiles][4]>(acc);
  constexpr int kQuads = P::kPartTiles / 4;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) add_cols<P, 4>(out, x, bp, 4 * q);
  if constexpr (P::kPartTiles % 4 != 0) add_cols<P, 2>(out, x, bp, 4 * kQuads);
}

// Rows row0 + the thread's (g, g + 8) of an output, those below `limit`,
// its columns of acc (bf16: the group's pieces; f32: the warp's part) times
// `mul` at out + row·ld.
template <class P, typename T>
__device__ __forceinline__ void store_rows(T* out, long long ld,
                                           const float (&acc)[P::kAcc],
                                           int row0, int limit, float mul) {
  const int tid = thread_index();
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + tile_row0<P>();
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= limit) continue;
    if constexpr (P::kF32) {
      T* p = out + row * ld + P::kPartCols * (tid >> 6) + 2 * t;
#pragma unroll
      for (int n = 0; n < P::kPartTiles; ++n)
        store2(p + 8 * n, acc[4 * n + 2 * hr] * mul, acc[4 * n + 2 * hr + 1] * mul);
    } else {
      const int first = (tid >> 7) * P::kGroupPieces;
      const int mine = imin(P::kGroupPieces, P::kPieces - first);
#pragma unroll
      for (int pc = 0; pc < P::kGroupPieces; ++pc) {
        if (pc >= mine) break;
        T* p = out + row * ld + kPiece * (first + pc) + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          store2(p + 8 * n, acc[32 * pc + 4 * n + 2 * hr] * mul,
                 acc[32 * pc + 4 * n + 2 * hr + 1] * mul);
      }
    }
  }
}

template <class P>
__device__ __forceinline__ void zero(float (&acc)[P::kAcc]) {
#pragma unroll
  for (int i = 0; i < P::kAcc; ++i) acc[i] = 0.f;
}

// ---------------------------------------------------------------------------
// K2a: one block, kRows q rows; q and dO stay, V and K stream (item 2·tile
// is V, 2·tile + 1 K, item i in slot i mod 2).
// ---------------------------------------------------------------------------

template <typename T, int kW>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap to,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  float* __restrict__ delta,
                                  T* __restrict__ dq, int heads, int lq,
                                  int lk, Strides sdq, int causal,
                                  float scale) {
  using P = BwdPlan<T, kW>;
  using IsF32 = std::integral_constant<bool, P::kF32>;
  constexpr int kRT = P::kRingRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem sm = bwd_layout<P>(smem);
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * P::kRows;
  const int kend = causal ? imin(lk, q0 + P::kRows) : lk;
  const int tiles = (kend + kRT - 1) / kRT;
  const bool loader = threadIdx.x == 0;
  init_barriers(sm);

  // q and dO, and O into the ring's slots for delta
  if (loader) {
    mbar_arrive_expect_tx(sm.rbar, 3 * P::kOwnBytes);
    load_rows<P>(sm.own, &tq, sm.rbar, q0, h, b, P::kOwnBox);
    load_rows<P>(sm.own + P::kOwnBytes, &tdo, sm.rbar, q0, h, b, P::kOwnBox);
    load_rows<P>(sm.ring, &to, sm.rbar, q0, h, b, P::kOwnBox);
  }
  mbar_wait(sm.rbar, 0);

  // delta = rowsum(dO∘O) at the full width: 256 / kRows threads a row, each
  // over its column pairs in order, then a butterfly over those threads
  float* lse2_s = reinterpret_cast<float*>(at(sm, sm.vec));
  float* delta_s = lse2_s + P::kRows;
  {
    constexpr int kTpr = kThreadsBwd / P::kRows;
    const int row = threadIdx.x / kTpr;
    const int sub = threadIdx.x % kTpr;
    const unsigned char* dop = sm.data + P::kOwnBytes;
    const unsigned char* op = at(sm, sm.ring);
    float sum = 0.f;
    for (int m = sub; m < kW / 2; m += kTpr) {
      const uint32_t off = sw128<T, P::kRows>(row, 2 * m);
      const T* x = reinterpret_cast<const T*>(dop + off);
      const T* y = reinterpret_cast<const T*>(op + off);
      sum = fmaf(to_float(x[0]), to_float(y[0]), sum);
      sum = fmaf(to_float(x[1]), to_float(y[1]), sum);
    }
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (sub == 0) {
      const int qi = q0 + row;
      float lv = 0.f;
      if (qi < lq) {
        lv = lse[(long long)bh * lq + qi] * kLog2e;
        delta[(long long)bh * lq + qi] = sum;
      }
      lse2_s[row] = lv;
      delta_s[row] = sum;
    }
  }
  __syncthreads();  // the vectors written; every thread done with O

  auto issue = [&](int i) {
    if (i >= 2 * tiles) return;
    const int slot = i % kStages;
    mbar_wait(sm.empty + 8 * slot, ((i / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(sm.full + 8 * slot, P::kSlotBytes);
    load_rows<P>(sm.ring + slot * P::kSlotBytes, (i & 1) ? &tk : &tv,
                 sm.full + 8 * slot, (i >> 1) * kRT, h, b, P::kRingBox);
  };
  if (loader) {
    fence_proxy_async();
    for (int i = 0; i < kStages; ++i) issue(i);
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = tile_row0<P>();
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse2_s[r0 + g + 8 * r];
    dl[r] = delta_s[r0 + g + 8 * r];
  }
  const float sl = scale * kLog2e;
  float* xb = reinterpret_cast<float*>(at(sm, sm.xb));
  const unsigned char* ring_p = at(sm, sm.ring);
  float acc[P::kAcc];
  zero<P>(acc);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kRT;
    const uint32_t par = it & 1;
    float s[P::kJ][4], dp[P::kJ][4];
    // dP = dO·Vᵀ (slot 0)
    mbar_wait(sm.full, par);
    __syncwarp();
    products<P>(dp, sm.own + P::kOwnBytes, sm.ring, sm.data + P::kOwnBytes,
                ring_p, IsF32{});
    mbar_arrive(sm.empty);
    if (loader) issue(2 * it + 2);
    __syncwarp();  // warp 0 converged again after its loader lane
    // S = q·Kᵀ (slot 1)
    mbar_wait(sm.full + 8, par);
    __syncwarp();
    products<P>(s, sm.own, sm.ring + P::kSlotBytes, sm.data,
                ring_p + P::kSlotBytes, IsF32{});
    if constexpr (P::kF32) exchange<P>(s, dp, xb + par * (P::kXBytes / 8));

    // dS = P∘(dP - delta) on rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const bool edge = k0 + kRT > lk || (causal && k0 + kRT - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < P::kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2(fmaf(s[j][e], sl, -lse2[e >> 1]));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= lk || (causal && key > row)) pe = 0.f;
        }
        s[j][e] = pe * (dp[j][e] - dl[e >> 1]);
      }

    // dQ += dS·K
    add_product<P>(acc, s, sm.ring + P::kSlotBytes, ring_p + P::kSlotBytes,
                   IsF32{});
    mbar_arrive(sm.empty + 8);
    if (loader) issue(2 * it + 3);
    __syncwarp();  // warp 0 converged again after its loader lane
  }

  store_rows<P>(dq + b * sdq.b + h * sdq.h, sdq.l, acc, q0, lq, scale);
}

// ---------------------------------------------------------------------------
// K2b: one block, kRows keys; K (and V) stay, q and dO tiles stream with
// their LSE and delta.  f32 blocks compute dK and dV (items: q, dO); bf16
// blocks one of them, by blockIdx.z: 0 dK (items: dO, q), 1 dV (q, dO).
// ---------------------------------------------------------------------------

template <typename T, int kW>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   T* __restrict__ dk, T* __restrict__ dv,
                                   int heads, int lq, int lk, Strides sdk,
                                   Strides sdv, int causal, float scale) {
  using P = BwdPlan<T, kW>;
  using IsF32 = std::integral_constant<bool, P::kF32>;
  constexpr int kRT = P::kRingRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem sm = bwd_layout<P>(smem);
  const bool for_dk = P::kF32 || blockIdx.z == 0;
  const bool for_dv = P::kF32 || blockIdx.z == 1;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * P::kRows;
  // q rows before the block's first key see none of its keys
  const int first = causal ? k0 / kRT : 0;
  const int tiles = (lq + kRT - 1) / kRT - first;
  T* dkp = dk + b * sdk.b + h * sdk.h;
  T* dvp = dv + b * sdv.b + h * sdv.h;
  if (tiles <= 0) {  // no query sees these keys: dK and dV are 0
    for (int i = threadIdx.x; i < P::kRows * kW / 2; i += kThreadsBwd) {
      const int row = k0 + i / (kW / 2);
      const int col = 2 * (i % (kW / 2));
      if (row >= lk) continue;
      if (for_dk) store2(dkp + row * sdk.l + col, 0.f, 0.f);
      if (for_dv) store2(dvp + row * sdv.l + col, 0.f, 0.f);
    }
    return;
  }
  const bool loader = threadIdx.x == 0;
  init_barriers(sm);

  // item 2·tile + 1 is q where it feeds the last product (dK blocks of bf16),
  // else dO
  const bool q_second = !P::kF32 && for_dk;
  auto issue = [&](int i) {
    if (i >= 2 * tiles) return;
    const int slot = i % kStages;
    const int tile = i >> 1;
    const int row0 = (first + tile) * kRT;
    const bool second = i & 1;
    mbar_wait(sm.empty + 8 * slot, ((i / kStages) & 1) ^ 1);
    const uint32_t bar = sm.full + 8 * slot;
    mbar_arrive_expect_tx(bar, P::kSlotBytes);
    load_rows<P>(sm.ring + slot * P::kSlotBytes, second == q_second ? &tq : &tdo,
                 bar, row0, h, b, P::kRingBox);
  };
  if (loader) {
    mbar_arrive_expect_tx(sm.rbar, (for_dk ? 2 : 1) * P::kOwnBytes);
    load_rows<P>(sm.own, &tk, sm.rbar, k0, h, b, P::kOwnBox);
    if (for_dk) load_rows<P>(sm.own + P::kOwnBytes, &tv, sm.rbar, k0, h, b, P::kOwnBox);
    for (int i = 0; i < kStages; ++i) issue(i);
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = tile_row0<P>();
  const float sl = scale * kLog2e;
  float* xb = reinterpret_cast<float*>(at(sm, sm.xb));
  const unsigned char* ring_p = at(sm, sm.ring);
  const unsigned char* slot1_p = ring_p + P::kSlotBytes;
  float acc[P::kF32 ? 2 : 1][P::kAcc];  // f32: dK, dV; bf16: the role's
#pragma unroll
  for (int i = 0; i < (P::kF32 ? 2 : 1); ++i) zero<P>(acc[i]);
  mbar_wait(sm.rbar, 0);

  for (int it = 0; it < tiles; ++it) {
    const int q0 = (first + it) * kRT;
    const uint32_t par = it & 1;
    // the LSE (log2 domain) and delta of the thread's queries 8j + 2t + c,
    // read from global memory (L2) before the tile's loads are waited for
    float l2[P::kJ][2], d2[P::kJ][2];
#pragma unroll
    for (int j = 0; j < P::kJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * t + c;
        const bool in = qi < lq;
        l2[j][c] = in ? lse[(long long)bh * lq + qi] * kLog2e : 0.f;
        d2[j][c] = in && for_dk ? delta[(long long)bh * lq + qi] : 0.f;
      }
    float s[P::kJ][4], dp[P::kJ][4];
    const bool edge = q0 + kRT > lq || k0 + P::kRows > lk ||
                      (causal && k0 + r0 + 15 > q0);
    // Pᵀ in s, and with_ds dSᵀ = Pᵀ∘(dPᵀ - delta) in dp; keys are rows g (e
    // = 0, 1) and g + 8 (e = 2, 3), queries the columns 8j + 2t + (e & 1)
    auto softmax_grad = [&](bool with_ds) {
#pragma unroll
      for (int j = 0; j < P::kJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(fmaf(s[j][e], sl, -l2[j][e & 1]));
          if (edge) {
            const int qi = q0 + 8 * j + 2 * t + (e & 1);
            const int kj = k0 + r0 + g + 8 * (e >> 1);
            if (qi >= lq || kj >= lk || (causal && kj > qi)) pe = 0.f;
          }
          s[j][e] = pe;
          if (with_ds) dp[j][e] = pe * (dp[j][e] - d2[j][e & 1]);
        }
      }
    };
    if constexpr (P::kF32) {
      // Sᵀ = K·qᵀ (slot 0) and dPᵀ = V·dOᵀ (slot 1) as partial sums,
      // exchanged; dK += dSᵀ·q, then dV += Pᵀ·dO
      mbar_wait(sm.full, par);
      __syncwarp();
      products<P>(s, 0, 0, sm.data, ring_p, IsF32{});
      mbar_wait(sm.full + 8, par);
      __syncwarp();
      products<P>(dp, 0, 0, sm.data + P::kOwnBytes, slot1_p, IsF32{});
      exchange<P>(s, dp, xb + par * (P::kXBytes / 8));
      softmax_grad(true);
      add_product<P>(acc[0], dp, 0, ring_p, IsF32{});
      mbar_arrive(sm.empty);
      if (loader) issue(2 * it + 2);
      __syncwarp();  // warp 0 converged again after its loader lane
      add_product<P>(acc[P::kF32 ? 1 : 0], s, 0, slot1_p, IsF32{});
      mbar_arrive(sm.empty + 8);
      if (loader) issue(2 * it + 3);
      __syncwarp();  // warp 0 converged again after its loader lane
    } else if (for_dk) {
      // dPᵀ = V·dOᵀ (slot 0), Sᵀ = K·qᵀ (slot 1), dK += dSᵀ·q
      mbar_wait(sm.full, par);
      __syncwarp();
      products<P>(dp, sm.own + P::kOwnBytes, sm.ring, nullptr, nullptr, IsF32{});
      mbar_arrive(sm.empty);
      if (loader) issue(2 * it + 2);
      __syncwarp();  // warp 0 converged again after its loader lane
      mbar_wait(sm.full + 8, par);
      __syncwarp();
      products<P>(s, sm.own, sm.ring + P::kSlotBytes, nullptr, nullptr, IsF32{});
      softmax_grad(true);
      add_product<P>(acc[0], dp, sm.ring + P::kSlotBytes, nullptr, IsF32{});
      mbar_arrive(sm.empty + 8);
      if (loader) issue(2 * it + 3);
      __syncwarp();  // warp 0 converged again after its loader lane
    } else {
      // Sᵀ = K·qᵀ (slot 0), dV += Pᵀ·dO (slot 1)
      mbar_wait(sm.full, par);
      __syncwarp();
      products<P>(s, sm.own, sm.ring, nullptr, nullptr, IsF32{});
      mbar_arrive(sm.empty);
      if (loader) issue(2 * it + 2);
      __syncwarp();  // warp 0 converged again after its loader lane
      softmax_grad(false);
      mbar_wait(sm.full + 8, par);
      __syncwarp();
      add_product<P>(acc[0], s, sm.ring + P::kSlotBytes, nullptr, IsF32{});
      mbar_arrive(sm.empty + 8);
      if (loader) issue(2 * it + 3);
      __syncwarp();  // warp 0 converged again after its loader lane
    }
  }

  if (for_dk) store_rows<P>(dkp, sdk.l, acc[0], k0, lk, scale);
  if (for_dv) store_rows<P>(dvp, sdv.l, acc[P::kF32 ? 1 : 0], k0, lk, 1.f);
}

// ---------------------------------------------------------------------------
// Host: launches (the tensor maps are tensor_map.cuh's)
// ---------------------------------------------------------------------------

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int kW>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  using P = BwdPlan<T, kW>;
  CUtensorMap tq, tk, tv, to, tdo;
  const bool f32 = P::kF32;
  cudaError_t err = tensor_map(&tq, q, f32, kW, lq, heads, batch, st[0], st[1],
                               st[2], P::kRows);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, f32, kW, lk, heads, batch, st[3], st[4], st[5],
                     P::kRingRows);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, f32, kW, lk, heads, batch, st[6], st[7], st[8],
                     P::kRingRows);
  if (err == cudaSuccess)
    err = tensor_map(&to, o, f32, kW, lq, heads, batch, st[9], st[10], st[11],
                     P::kRows);
  if (err == cudaSuccess)
    err = tensor_map(&tdo, dout, f32, kW, lq, heads, batch, st[12], st[13],
                     st[14], P::kRows);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wide_sm90_kernel<T, kW>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + P::kRows - 1) / P::kRows, batch * heads);
  kernel<<<grid, kThreadsBwd, P::kSmem, stream>>>(
      tq, tk, tv, to, tdo, lse, delta, static_cast<T*>(dq), heads, lq, lk,
      strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <typename T, int kW>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int heads, int lq, int lk,
                       const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  using P = BwdPlan<T, kW>;
  CUtensorMap tq, tk, tv, tdo;
  const bool f32 = P::kF32;
  cudaError_t err = tensor_map(&tq, q, f32, kW, lq, heads, batch, st[0], st[1],
                               st[2], P::kRingRows);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, f32, kW, lk, heads, batch, st[3], st[4], st[5],
                     P::kRows);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, f32, kW, lk, heads, batch, st[6], st[7], st[8],
                     P::kRows);
  if (err == cudaSuccess)
    err = tensor_map(&tdo, dout, f32, kW, lq, heads, batch, st[9], st[10],
                     st[11], P::kRingRows);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wide_sm90_kernel<T, kW>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + P::kRows - 1) / P::kRows, batch * heads, P::kRoles);
  kernel<<<grid, kThreadsBwd, P::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      heads, lq, lk, strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

// The C entries below, for each width and type: f (a launcher template)
// at the head width, or cudaErrorInvalidValue for another width.
#define SFX_BY_WIDTH(call)     \
  switch (head_dim) {          \
    case 192: return call(192); \
    case 256: return call(256); \
    case 320: return call(320); \
    case 384: return call(384); \
    case 448: return call(448); \
    case 512: return call(512); \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t dq_width(int head_dim, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, int batch, int heads, int lq,
                     int lk, const long long* st, int causal, float scale,
                     cudaStream_t s) {
#define SFX_CALL(w) launch_dq<T, w>(q, k, v, o, dout, lse, delta, dq, batch, \
                                    heads, lq, lk, st, causal, scale, s)
  SFX_BY_WIDTH(SFX_CALL)
#undef SFX_CALL
}

template <typename T>
cudaError_t dkv_width(int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, void* dk, void* dv, int batch,
                      int heads, int lq, int lk, const long long* st,
                      int causal, float scale, cudaStream_t s) {
#define SFX_CALL(w) launch_dkv<T, w>(q, k, v, dout, lse, delta, dk, dv, batch, \
                                     heads, lq, lk, st, causal, scale, s)
  SFX_BY_WIDTH(SFX_CALL)
#undef SFX_CALL
}

template <typename T, int kW>
cudaError_t plan_of(int* out) {
  using P = BwdPlan<T, kW>;
  const int plan[10] = {P::kRows,   P::kRingRows, kStages,     P::kParts,
                        P::kRoles,  kThreadsBwd,  int(P::kSmem), P::kBoxCols,
                        P::kDqOps,  P::kDkvOps};
  for (int i = 0; i < 10; ++i) out[i] = plan[i];
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_width(int head_dim, int* out) {
#define SFX_CALL(w) plan_of<T, w>(out)
  SFX_BY_WIDTH(SFX_CALL)
#undef SFX_CALL
}

#undef SFX_BY_WIDTH

}  // namespace

// As flash_bwd.cu's flash_bwd_dq (the same arguments), at a head_dim that is
// a multiple of 64 from 192 to 512: writes dq and delta = rowsum(dout∘o);
// `strides` holds those of q, k, v, o, dout, dq (18 values).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for another width or a tensor
// map TMA cannot take).
extern "C" int flash_bwd_dq_wide(int dtype, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const float* lse,
                                 float* delta, void* dq, int batch, int heads,
                                 int lq, int lk, int head_dim,
                                 const long long* strides, int causal,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dq_width<float>(head_dim, q, k, v, o, dout, lse,
                                            delta, dq, batch, heads, lq, lk,
                                            strides, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(dq_width<__nv_bfloat16>(
        head_dim, q, k, v, o, dout, lse, delta, dq, batch, heads, lq, lk,
        strides, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd.cu's flash_bwd_dkv, at such a head_dim: writes dk and dv;
// `strides` holds those of q, k, v, dout, dk, dv (18 values); delta is
// flash_bwd_dq_wide's.
extern "C" int flash_bwd_dkv_wide(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int batch, int heads,
                                  int lq, int lk, int head_dim,
                                  const long long* strides, int causal,
                                  float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dkv_width<float>(head_dim, q, k, v, dout, lse,
                                             delta, dk, dv, batch, heads, lq,
                                             lk, strides, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(dkv_width<__nv_bfloat16>(
        head_dim, q, k, v, dout, lse, delta, dk, dv, batch, heads, lq, lk,
        strides, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of both kernels at (dtype, head_dim) into out[0..9]: own
// rows a block, ring rows a tile, ring slots, column parts of the outputs,
// K2b blocks a row tile (roles), threads a block, dynamic shared memory
// bytes, columns a TMA box, and K2a's and K2b's operations per (query, key)
// pair in units of the width (f32: tf32 products).  Returns 0, or -1 for a
// width or dtype it does not take.
extern "C" int flash_bwd_wide_plan(int dtype, int head_dim, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = plan_width<float>(head_dim, out);
  if (dtype == 1) err = plan_width<__nv_bfloat16>(head_dim, out);
  return err == cudaSuccess ? 0 : -1;
}
