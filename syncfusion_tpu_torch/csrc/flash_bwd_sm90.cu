// Flash-attention backward for Hopper (sm_90a) in bf16, heads of 64 and
// 128: dQ (K2a), and dK with dV (K2b), on TMA, mbarrier rings and wgmma.
//
// Replaces, for bf16 inputs at those widths, the TPU kernels of
// syncfusion_tpu/ops/attention.py that `_flash_bwd` launches through
// `pl.pallas_call`:
//   flash_bwd_dq_sm90   <- `_flash_bwd_dq_kernel` (K2a), with the XLA
//                          reduction delta = rowsum(dO∘O) that precedes it
//                          there fused into its prologue (and written out
//                          for K2b);
//   flash_bwd_dkv_sm90  <- `_flash_bwd_dkv_kernel` (K2b).
// For each (batch, head), with P = exp(q kᵀ·scale - lse) and dS = P∘(dO vᵀ
// - delta): dQ = scale·dS·K, dK = scale·dSᵀ·q, dV = Pᵀ·dO, all in f32 from
// bf16 inputs, the outputs written in bf16, with an optional causal
// (top-left aligned) mask and a ragged tail masked.  flash_bwd.cu keeps the
// f32 instances; wider heads go to flash_bwd_wide_sm90.cu (192-512) and
// flash_wide.cu (above).
//
// What bounds it on this card: per (batch, head) K2a needs 6·D·T²
// operations (S, dP, dS·K) and K2b 8·D·T² (S, dP, Pᵀ·dO, dSᵀ·q) against
// ~12·T·D bytes each (five or four (T, D) bf16 inputs read once, one or two
// written): T/2 operations a byte and more, above the H100's bf16 ridge of
// ~295 at the UNet's T = 1024 and 2048 (bound by operations), below it at
// 256 and 512 (by bytes).
//
// The design (one launch a call for each kernel; no atomics: a block owns
// its output rows, so dq, dk, dv and delta are the same bits from run to
// run):
//
// * Blocks.  One or two consumer warpgroups a block (`bwd_groups`, as
//   flash_fwd.cu's `fwd_groups`: two where the grid of 128-row blocks still
//   has a block for each SM, else one), each owning 64 rows of one side: q
//   rows in K2a (its dQ rows), keys in K2b (its dK and dV rows).  That
//   side's two operands stay in shared memory (K2a: q and dO; K2b: K and
//   V); the other side's two stream through a ring that both warpgroups
//   share (K2a: K and V in 64-key tiles; K2b: q and dO in 64-row tiles at
//   kD = 64, 32-row ones at 128).
//   A warpgroup holds its outputs at the full width in registers: K2a's dQ
//   kD / 2 a thread, K2b's dK and dV kD, so S and dP are computed once a
//   block and tile, never once per piece of output columns.  No producer
//   warp: over 8 warps ptxas caps every thread at 168 registers
//   (flash_fwd_wide_sm90.cu's note), and K2b holds 128 at kD = 128.
// * Loads.  TMA through 4-D tensor maps (D, L, H, B) of the strided
//   operands (tensor_map.cuh), so q, k and v may stay views of one packed
//   projection: 16-byte aligned, B, L and H strides in multiples of 8
//   elements (the wrapper checks this).  A tile is D / 64 boxes of 64
//   columns (128 bytes, the 128-byte swizzle), each on a 1024-byte
//   boundary; rows past L land as 0.  Each ring slot has a `full` mbarrier
//   (armed with the slot's bytes) and an `empty` one on which every thread
//   arrives once it is done with the slot.  Thread 0 issues the copies, but
//   every thread runs the loader's code, with the TMA and `expect_tx`
//   predicated in the PTX and the `empty` spin inside one asm: a branch
//   around the loads made ptxas serialize every wgmma (C7520) in the wide
//   K1.  K2b's LSE and delta vary along its products' N: each thread reads
//   its queries' values from global memory (L2) per q tile while the tile's
//   products run (as a TMA box they ended the wide f32 K2b at L = 1001 with
//   an illegal instruction: a box start not 16-byte aligned).
// * K2a, per key tile: S = q·Kᵀ and dP = dO·Vᵀ on wgmma m64n64k16, both
//   operands K-major from shared memory; dS = P∘(dP - delta) in registers;
//   dQ += dS·K on wgmma m64n64k16 with dS from registers (S's accumulator
//   layout is the A-fragment layout) and K as the MN-major B, one product
//   a 64-column piece of dQ.  Its prologue sums delta = rowsum(dO∘O) of its
//   rows in a fixed order, O loaded by TMA into the ring's last slot before
//   that slot's first tile, and writes it once.
// * K2b, per q tile, keys as M: Sᵀ = K·qᵀ and dPᵀ = V·dOᵀ on wgmma
//   m64n64k16 (kD = 64) or m64n32k16 (kD = 128), so that Pᵀ and dSᵀ come
//   out in the A-fragment layout that dV += Pᵀ·dO and dK += dSᵀ·q take from
//   registers (q and dO MN-major), with no transpose through shared memory.
//   At 128 the q tiles have 32 rows, to keep S, dP and the packed operands
//   at 64 registers beside dK and dV's 128.
// * P and dS enter the output products as hi + lo bf16, two products each,
//   as in K1 and the wide K2: rounded once to bf16 an element moves by up
//   to 2^-9, and the JAX kernel keeps P and dS in f32.  So a (query, key)
//   pair costs K2a 2·D (S) + 2·D (dP) + 2·2·D (dS·K) = 8·D operations,
//   1.33x the function's 6·D, and K2b 2·D + 2·D + 2·2·D + 2·2·D = 12·D,
//   1.5x its 8·D: the counts of the mma.sync body that flash_bwd.cu ran
//   for bf16 before, now at bf16's wgmma rate instead of tf32's.
// * Overlap (FlashAttention-3's intra-warpgroup pipelining): the next
//   tile's S and dP are issued together with this tile's output products,
//   and the elementwise work of the next tile (its P and dS) runs while
//   the output products are in flight; the slot of a tile is released,
//   and the ring's next tile issued into it, once its products are done.
//
// Shared memory (`BwdPlan`, returned by `flash_bwd_plan` and mirrored by
// ops/attention.py's `bwd_plan`): 1024 bytes for the alignment, the two own
// tiles of two warpgroups, the ring, K2a's LSE and delta of its rows, the
// barriers.  Whatever the groups, a block asks for two groups' tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"
#include "sm90_tiles.cuh"
#include "tensor_map.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxGroups = 2;  // consumer warpgroups a block
constexpr int kBoxCols = 64;   // bf16 columns of a 128-byte TMA box
constexpr int kOwnRows = 64;   // rows a warpgroup owns: one wgmma M

// The tiles of one head width.
template <int kD>
struct BwdPlan {
  static constexpr int kBoxes = kD / kBoxCols;
  static constexpr uint32_t kOwnBox = kOwnRows * 128;  // bytes of a box
  static constexpr uint32_t kOwnTile = kBoxes * kOwnBox;
  // K2a: K and V stream in tiles of 64 keys, a slot holding both
  static constexpr int kKeyTile = 64;
  static constexpr int kDqStages = 4;
  static constexpr uint32_t kKvBox = kKeyTile * 128;
  static constexpr uint32_t kKvTile = kBoxes * kKvBox;
  static constexpr uint32_t kDqSlot = 2 * kKvTile;
  static constexpr int kN = kKeyTile / 8;   // n-tiles of S
  static constexpr int kK = kKeyTile / 16;  // k-steps of dS·K
  // K2b: q and dO stream in tiles of 64 rows at kD = 64, 32 at 128 (where
  // dK and dV take 128 registers), a slot holding both
  static constexpr int kQTile = kD == 64 ? 64 : 32;
  static constexpr int kDkvStages = 4;
  static constexpr uint32_t kQBox = kQTile * 128;
  static constexpr uint32_t kQTileBytes = kBoxes * kQBox;
  static constexpr uint32_t kDkvSlot = 2 * kQTileBytes;
  static constexpr int kNq = kQTile / 8;   // n-tiles of Sᵀ
  static constexpr int kKq = kQTile / 16;  // k-steps of Pᵀ·dO, dSᵀ·q
  static constexpr uint32_t kVecBytes = 2 * kMaxGroups * kOwnRows * 4;
  static constexpr size_t kDqSmem = 1024 + 2 * kMaxGroups * size_t(kOwnTile) +
                                    kDqStages * size_t(kDqSlot) + kVecBytes +
                                    8 * (2 * kDqStages + 1);
  static constexpr size_t kDkvSmem = 1024 + 2 * kMaxGroups * size_t(kOwnTile) +
                                     kDkvStages * size_t(kDkvSlot) +
                                     8 * (2 * kDkvStages + 1);
  static_assert(kD == 64 || kD == 128, "head width");
  static_assert(kKvTile == kOwnTile, "K2a's O tiles fill the last slot");
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "shared memory");
};
// operations per (query, key) pair in units of kD (the function's: K2a 6,
// K2b 8): S 2, dP 2, each output 2 as two products (hi + lo)
constexpr int kDqOps = 8;
constexpr int kDkvOps = 12;

// Consumer warpgroups a block for `l` own rows: two, sharing every streamed
// tile, where the grid of 128-row blocks still has a block for each of the
// card's `sms` SMs; else one.  ops/attention.py's `bwd_plan` mirrors it.
__host__ __device__ inline int bwd_groups(int batch_heads, int l, int sms) {
  const long long blocks =
      (long long)((l + 2 * kOwnRows - 1) / (2 * kOwnRows)) * batch_heads;
  return blocks >= sms ? 2 : 1;
}

// The warpgroup of the calling thread, as a value the compiler knows to be
// uniform across a warp: a wgmma under a branch on a value it cannot prove
// so is serialized (ptxas C7520).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
}

// The block's dynamic shared memory, 1024-aligned: its shared address and
// its generic pointer.
struct Smem {
  uint32_t base;
  unsigned char* data;
};
__device__ __forceinline__ Smem aligned_smem(unsigned char* smem) {
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  return {base, smem + (base - raw)};
}

// d = a·bᵀ for the group's 64 own rows (a, K-major tiles of 64-row boxes)
// against a streamed tile (b, K-major tiles of `kB`-row boxes) over kD, in
// the accumulator layout d[j][e] (n-tile j: b's rows 8j ..): kD / 16 wgmma
// of N = kB; issued, not waited for.
template <int kD, int kB>
__device__ __forceinline__ void issue_rows(float (&d)[kB / 8][4], uint32_t a,
                                           uint32_t b) {
  constexpr int kBoxes = kD / kBoxCols;
  float(&dd)[kB / 2] = reinterpret_cast<float(&)[kB / 2]>(d);
#pragma unroll
  for (int kk = 0; kk < kBoxes * 4; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns, 32 bytes
    const uint64_t da = sw128_desc(a + (kk >> 2) * kOwnRows * 128 + off, 16, 1024);
    const uint64_t db = sw128_desc(b + (kk >> 2) * kB * 128 + off, 16, 1024);
    if constexpr (kB == 64)
      wgmma_64x64x16_ss(dd, da, db, kk > 0);
    else
      wgmma_64x32x16_ss(dd, da, db, kk > 0);
  }
}

// acc += x·b for x as hi + lo bf16 A fragments (kK k-steps of 16 rows of
// b) and b a streamed tile of `kB`-row boxes, MN-major: two wgmma m64n64k16
// a k-step and 64-column piece; issued, not waited for.
template <int kD, int kK, int kB>
__device__ __forceinline__ void issue_out(float (&acc)[kD / kBoxCols][32],
                                          const uint32_t (&xh)[kK][4],
                                          const uint32_t (&xl)[kK][4],
                                          uint32_t b) {
#pragma unroll
  for (int pc = 0; pc < kD / kBoxCols; ++pc) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      // rows 16kk .. 16kk + 15: two groups of 8 rows, 1024 bytes apart
      const uint64_t db = sw128_desc(b + pc * kB * 128 + kk * 16 * 128, kB * 128, 1024);
      wgmma_64x64x16_rs_mn(acc[pc], xh[kk], db);
      wgmma_64x64x16_rs_mn(acc[pc], xl[kk], db);
    }
  }
}

// x (f32, accumulator layout) as hi + lo bf16 A fragments: k-step kk takes
// n-tiles 2kk and 2kk + 1.
template <int kK>
__device__ __forceinline__ void pack(const float (&x)[2 * kK][4],
                                     uint32_t (&xh)[kK][4], uint32_t (&xl)[kK][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float(&x0)[4] = x[2 * kk];
    const float(&x1)[4] = x[2 * kk + 1];
    split_bf16(x0[0], x0[1], xh[kk][0], xl[kk][0]);
    split_bf16(x0[2], x0[3], xh[kk][1], xl[kk][1]);
    split_bf16(x1[0], x1[1], xh[kk][2], xl[kk][2]);
    split_bf16(x1[2], x1[3], xh[kk][3], xl[kk][3]);
  }
}

// After a wgmma_wait: keep the compiler from reading a result before it,
// or from reusing an operand's registers while a product may read them.
template <int kN>
__device__ __forceinline__ void fence_all(float (&x)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(x[j][e]);
}
template <int kN>
__device__ __forceinline__ void fence_all(uint32_t (&x)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(x[j][e]);
}
template <int kP>
__device__ __forceinline__ void fence_acc(float (&acc)[kP][32]) {
#pragma unroll
  for (int pc = 0; pc < kP; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[pc][i]);
}

template <int kP>
__device__ __forceinline__ void zero(float (&acc)[kP][32]) {
#pragma unroll
  for (int pc = 0; pc < kP; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pc][i] = 0.f;
}

// Rows row0 + r0 + (g, g + 8) of an output below `limit`, acc times `mul`,
// at out + row·ld: the thread's columns of each 64-column piece.
template <int kP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ld,
                                           const float (&acc)[kP][32], int row0,
                                           int limit, float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = row0 + 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int pc = 0; pc < kP; ++pc) {
      __nv_bfloat16* p = out + row * ld + kBoxCols * pc + 2 * tg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(p + 8 * n, acc[pc][4 * n + 2 * r] * mul,
               acc[pc][4 * n + 2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// K2a: one block, `groups` x 64 q rows of one (batch, head); q and dO stay,
// K and V stream (tile t in slot t mod kS, K then V).
// ---------------------------------------------------------------------------

// dS = P∘(dP - delta) in place of dP, P = 2^(S·sl - lse·log2 e), on rows g
// (e = 0, 1) and g + 8 (e = 2, 3) of the warp's 16; `lim` is each row's
// first masked key less k0 + 2·tg, `masked` whether any key of the tile
// may be (a key past the end, or after a row's query under the causal
// mask).
template <int kN>
__device__ __forceinline__ void grad_rows(const float (&s)[kN][4], float (&dp)[kN][4],
                                          const float (&lse2)[2], const float (&dl)[2],
                                          const int (&lim)[2], bool masked, float sl) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[j][e], sl, -lse2[e >> 1]));
      if (masked && 8 * j + (e & 1) >= lim[e >> 1]) p = 0.f;
      dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
    }
}

template <int kD>
__global__ void __launch_bounds__(128 * kMaxGroups, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int heads, int lq,
                             int lk, Strides sdq, int causal, float scale) {
  using P = BwdPlan<kD>;
  constexpr int kS = P::kDqStages;
  constexpr int kKT = P::kKeyTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = aligned_smem(smem);
  const uint32_t qs = sm.base;                            // q tiles of the groups
  const uint32_t dos = qs + kMaxGroups * P::kOwnTile;     // their dO tiles
  const uint32_t ring = dos + kMaxGroups * P::kOwnTile;   // slot s: K, then V
  const uint32_t vec = ring + kS * P::kDqSlot;            // lse·log2 e, delta
  const uint32_t full = vec + P::kVecBytes;
  const uint32_t empty = full + 8 * kS;
  const uint32_t qbar = empty + 8 * kS;
  const uint32_t os = ring + (kS - 1) * P::kDqSlot;  // O, until tile kS - 1

  const int groups = blockDim.x / 128;
  const int group = warpgroup();
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kOwnRows * groups;  // the block's first row
  const int qg = q0 + kOwnRows * group;           // the group's
  // keys after the block's last row are masked for every row of it
  const int kend = causal ? imin(lk, q0 + kOwnRows * groups) : lk;
  const int tiles = (kend + kKT - 1) / kKT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, blockDim.x);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  // Thread 0 issues the loads, but every thread runs the code: the waits
  // and the copies are predicated in the instructions.  K and V of tile t
  // go into slot t mod kS once every thread has released the slot's tile
  // t - kS (the wait passes at once on a fresh barrier).
  const bool loader = threadIdx.x == 0;
  auto issue = [&](int t) {
    if (t >= tiles) return;
    const int slot = t % kS;
    const uint32_t at = ring + slot * P::kDqSlot;
    mbar_wait_converged(empty + 8 * slot, ((t / kS) & 1) ^ 1);
    mbar_arrive_expect_tx_if(full + 8 * slot, P::kDqSlot, loader);
    for (int c = 0; c < P::kBoxes; ++c) {
      tma_load_4d_if(at + c * P::kKvBox, &tk, full + 8 * slot, c * kBoxCols,
                     t * kKT, h, b, loader);
      tma_load_4d_if(at + P::kKvTile + c * P::kKvBox, &tv, full + 8 * slot,
                     c * kBoxCols, t * kKT, h, b, loader);
    }
  };
  // q, dO and O of the block's rows, then the ring's tiles but the last
  // slot's, which O holds until delta is summed
  mbar_arrive_expect_tx_if(qbar, groups * 3 * P::kOwnTile, loader);
  for (int r = 0; r < groups; ++r)
    for (int c = 0; c < P::kBoxes; ++c) {
      const uint32_t off = r * P::kOwnTile + c * P::kOwnBox;
      const int row = q0 + kOwnRows * r;
      tma_load_4d_if(qs + off, &tq, qbar, c * kBoxCols, row, h, b, loader);
      tma_load_4d_if(dos + off, &tdo, qbar, c * kBoxCols, row, h, b, loader);
      tma_load_4d_if(os + off, &to, qbar, c * kBoxCols, row, h, b, loader);
    }
  for (int t = 0; t < kS - 1; ++t) issue(t);
  mbar_wait_converged(qbar, 0);

  // delta = rowsum(dO∘O): two threads a row, each over half of its column
  // pairs in order, then their sum; the row's LSE (log2 domain) beside it
  float* lse2_s = reinterpret_cast<float*>(sm.data + (vec - sm.base));
  float* delta_s = lse2_s + kMaxGroups * kOwnRows;
  {
    const int row = threadIdx.x >> 1;  // of the block
    const int half = threadIdx.x & 1;
    const uint32_t tile = (row / kOwnRows) * P::kOwnTile;
    const unsigned char* dop = sm.data + (dos - sm.base) + tile;
    const unsigned char* op = sm.data + (os - sm.base) + tile;
    float sum = 0.f;
    for (int m = half * kD / 4; m < (half + 1) * kD / 4; ++m) {
      const uint32_t off = sw128<__nv_bfloat16, kOwnRows>(row % kOwnRows, 2 * m);
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dop + off));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + off));
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      const int qi = q0 + row;
      float l2 = 0.f;
      if (qi < lq) {
        l2 = lse[(long long)bh * lq + qi] * kLog2e;
        delta[(long long)bh * lq + qi] = sum;
      }
      lse2_s[row] = l2;
      delta_s[row] = sum;
    }
  }
  // every thread done with O before TMA overwrites it
  fence_proxy_async();
  __syncthreads();
  issue(kS - 1);

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int g = lane >> 2;
  const int tg = lane & 3;
  float lse2[2], dl[2];
  // each row's end of the keys it sees, less 2·tg
  int lim0[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kOwnRows * group + r0 + g + 8 * r;
    lse2[r] = lse2_s[row];
    dl[r] = delta_s[row];
    lim0[r] = (causal ? imin(lk, q0 + row + 1) : lk) - 2 * tg;
  }
  auto masked = [&](int k0) {
    return k0 + kKT > lk || (causal && k0 + kKT - 1 > qg);
  };
  const uint32_t qsg = qs + group * P::kOwnTile;
  const uint32_t dosg = dos + group * P::kOwnTile;
  const float sl = scale * kLog2e;

  float acc[P::kBoxes][32];
  zero(acc);
  float s[P::kN][4], dp[P::kN][4];
  uint32_t dh[P::kK][4], dlo[P::kK][4];

  // key tile 0: S and dP, then dS
  mbar_wait_converged(full, 0);
  wgmma_fence();
  issue_rows<kD, kKT>(s, qsg, ring);
  issue_rows<kD, kKT>(dp, dosg, ring + P::kKvTile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(s);
  fence_all(dp);
  {
    const int lim[2] = {lim0[0], lim0[1]};
    grad_rows(s, dp, lse2, dl, lim, masked(0), sl);
  }
  pack(dp, dh, dlo);

  // tile j: S and dP of tile j issued with dQ += dS·K of tile j - 1; tile
  // j's dS under that product; then slot j - 1 released and refilled
  for (int j = 1; j < tiles; ++j) {
    const int k0 = j * kKT;
    const uint32_t cur = ring + (j % kS) * P::kDqSlot;
    const uint32_t prev = ring + ((j - 1) % kS) * P::kDqSlot;
    mbar_wait_converged(full + 8 * (j % kS), (j / kS) & 1);
    wgmma_fence();
    issue_rows<kD, kKT>(s, qsg, cur);
    issue_rows<kD, kKT>(dp, dosg, cur + P::kKvTile);
    wgmma_commit();
    issue_out<kD, P::kK, kKT>(acc, dh, dlo, prev);
    wgmma_commit();
    wgmma_wait<1>();  // S and dP have landed, dQ's product may still run
    fence_all(s);
    fence_all(dp);
    const int lim[2] = {lim0[0] - k0, lim0[1] - k0};
    grad_rows(s, dp, lse2, dl, lim, masked(k0), sl);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_all(dh);
    fence_all(dlo);
    mbar_arrive(empty + 8 * ((j - 1) % kS));
    issue(j - 1 + kS);
    pack(dp, dh, dlo);
  }

  // dQ += dS·K of the last tile
  wgmma_fence();
  issue_out<kD, P::kK, kKT>(acc, dh, dlo, ring + ((tiles - 1) % kS) * P::kDqSlot);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_all(dh);
  fence_all(dlo);
  mbar_arrive(empty + 8 * ((tiles - 1) % kS));

  store_rows(dq + b * sdq.b + h * sdq.h, sdq.l, acc, qg, lq, scale);
}

// ---------------------------------------------------------------------------
// K2b: one block, `groups` x 64 keys of one (batch, head); K and V stay, q
// and dO stream with their LSE and delta (tile t in slot t mod kS, q then
// dO).
// ---------------------------------------------------------------------------

template <int kD>
__global__ void __launch_bounds__(128 * kMaxGroups, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int heads, int lq,
                              int lk, Strides sdk, Strides sdv, int causal,
                              float scale) {
  using P = BwdPlan<kD>;
  constexpr int kS = P::kDkvStages;
  constexpr int kQT = P::kQTile;
  constexpr int kJ = P::kNq;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = aligned_smem(smem);
  const uint32_t ks = sm.base;                           // K tiles of the groups
  const uint32_t vs = ks + kMaxGroups * P::kOwnTile;     // their V tiles
  const uint32_t ring = vs + kMaxGroups * P::kOwnTile;   // slot s: q, then dO
  const uint32_t full = ring + kS * P::kDkvSlot;
  const uint32_t empty = full + 8 * kS;
  const uint32_t kbar = empty + 8 * kS;

  const int groups = blockDim.x / 128;
  const int group = warpgroup();
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.x * kOwnRows * groups;  // the block's first key
  const int kg = k0 + kOwnRows * group;           // the group's
  // q rows before the block's first key see none of its keys
  const int first = causal ? k0 / kQT : 0;
  const int tiles = (lq + kQT - 1) / kQT - first;
  __nv_bfloat16* dkp = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvp = dv + b * sdv.b + h * sdv.h;
  if (tiles <= 0) {  // no query sees these keys: dK and dV are 0
    for (int i = threadIdx.x; i < kOwnRows * groups * kD / 2; i += blockDim.x) {
      const int row = k0 + i / (kD / 2);
      const int col = 2 * (i % (kD / 2));
      if (row >= lk) continue;
      store2(dkp + row * sdk.l + col, 0.f, 0.f);
      store2(dvp + row * sdv.l + col, 0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, blockDim.x);
    }
    mbar_init(kbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  const bool loader = threadIdx.x == 0;
  auto issue = [&](int t) {
    if (t >= tiles) return;
    const int slot = t % kS;
    const uint32_t at = ring + slot * P::kDkvSlot;
    const int row = (first + t) * kQT;
    mbar_wait_converged(empty + 8 * slot, ((t / kS) & 1) ^ 1);
    mbar_arrive_expect_tx_if(full + 8 * slot, P::kDkvSlot, loader);
    for (int c = 0; c < P::kBoxes; ++c) {
      tma_load_4d_if(at + c * P::kQBox, &tq, full + 8 * slot, c * kBoxCols,
                     row, h, b, loader);
      tma_load_4d_if(at + P::kQTileBytes + c * P::kQBox, &tdo, full + 8 * slot,
                     c * kBoxCols, row, h, b, loader);
    }
  };
  mbar_arrive_expect_tx_if(kbar, groups * 2 * P::kOwnTile, loader);
  for (int r = 0; r < groups; ++r)
    for (int c = 0; c < P::kBoxes; ++c) {
      const uint32_t off = r * P::kOwnTile + c * P::kOwnBox;
      const int row = k0 + kOwnRows * r;
      tma_load_4d_if(ks + off, &tk, kbar, c * kBoxCols, row, h, b, loader);
      tma_load_4d_if(vs + off, &tv, kbar, c * kBoxCols, row, h, b, loader);
    }
  for (int t = 0; t < kS; ++t) issue(t);

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);  // the warp's first key
  const int g = lane >> 2;
  const int tg = lane & 3;
  const uint32_t ksg = ks + group * P::kOwnTile;
  const uint32_t vsg = vs + group * P::kOwnTile;
  const float sl = scale * kLog2e;
  const float* lsep = lse + (long long)bh * lq;
  const float* deltap = delta + (long long)bh * lq;

  // the LSE (log2 domain) and delta of the thread's queries 8j + 2tg + c of
  // tile t, read from global memory (L2); 0 past the end
  float l2[kJ][2], d2[kJ][2];
  auto vectors = [&](int t) {
    const int q0 = (first + t) * kQT;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = q0 + 8 * j + 2 * tg + c;
        const bool in = qi < lq;
        l2[j][c] = in ? lsep[qi] * kLog2e : 0.f;
        d2[j][c] = in ? deltap[qi] : 0.f;
      }
  };
  // Pᵀ in s and dSᵀ = Pᵀ∘(dPᵀ - delta) in dp, in place; keys are rows g (e
  // = 0, 1) and g + 8 (e = 2, 3), queries the columns 8j + 2tg + (e & 1)
  auto grad = [&](float (&s)[kJ][4], float (&dp)[kJ][4], int t) {
    const int q0 = (first + t) * kQT;
    const bool masked = q0 + kQT > lq || kg + kOwnRows > lk ||
                        (causal && kg + kOwnRows - 1 > q0);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], sl, -l2[j][e & 1]));
        if (masked) {
          const int qi = q0 + 8 * j + 2 * tg + (e & 1);
          const int kj = kg + r0 + g + 8 * (e >> 1);
          if (qi >= lq || kj >= lk || (causal && kj > qi)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - d2[j][e & 1]);
      }
  };

  float dk_acc[P::kBoxes][32], dv_acc[P::kBoxes][32];
  zero(dk_acc);
  zero(dv_acc);
  float s[kJ][4], dp[kJ][4];
  uint32_t ph[P::kKq][4], pl[P::kKq][4], dh[P::kKq][4], dlo[P::kKq][4];

  // q tile 0: Sᵀ and dPᵀ, then Pᵀ and dSᵀ
  vectors(0);
  mbar_wait_converged(kbar, 0);
  mbar_wait_converged(full, 0);
  wgmma_fence();
  issue_rows<kD, kQT>(s, ksg, ring);
  issue_rows<kD, kQT>(dp, vsg, ring + P::kQTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(s);
  fence_all(dp);
  grad(s, dp, 0);
  pack(s, ph, pl);
  pack(dp, dh, dlo);

  // tile t: Sᵀ and dPᵀ of tile t issued with dV += Pᵀ·dO and dK += dSᵀ·q
  // of tile t - 1; tile t's Pᵀ and dSᵀ under those products; then slot t -
  // 1 released and refilled
  for (int t = 1; t < tiles; ++t) {
    const uint32_t cur = ring + (t % kS) * P::kDkvSlot;
    const uint32_t prev = ring + ((t - 1) % kS) * P::kDkvSlot;
    mbar_wait_converged(full + 8 * (t % kS), (t / kS) & 1);
    wgmma_fence();
    issue_rows<kD, kQT>(s, ksg, cur);
    issue_rows<kD, kQT>(dp, vsg, cur + P::kQTileBytes);
    wgmma_commit();
    issue_out<kD, P::kKq, kQT>(dv_acc, ph, pl, prev + P::kQTileBytes);
    issue_out<kD, P::kKq, kQT>(dk_acc, dh, dlo, prev);
    wgmma_commit();
    vectors(t);
    wgmma_wait<1>();  // Sᵀ and dPᵀ have landed, the output products may run
    fence_all(s);
    fence_all(dp);
    grad(s, dp, t);
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    fence_all(ph);
    fence_all(pl);
    fence_all(dh);
    fence_all(dlo);
    mbar_arrive(empty + 8 * ((t - 1) % kS));
    issue(t - 1 + kS);
    pack(s, ph, pl);
    pack(dp, dh, dlo);
  }

  // the output products of the last tile
  {
    const uint32_t last = ring + ((tiles - 1) % kS) * P::kDkvSlot;
    wgmma_fence();
    issue_out<kD, P::kKq, kQT>(dv_acc, ph, pl, last + P::kQTileBytes);
    issue_out<kD, P::kKq, kQT>(dk_acc, dh, dlo, last);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    fence_all(ph);
    fence_all(pl);
    fence_all(dh);
    fence_all(dlo);
    mbar_arrive(empty + 8 * ((tiles - 1) % kS));
  }

  store_rows(dkp, sdk.l, dk_acc, kg, lk, scale);
  store_rows(dvp, sdv.l, dv_acc, kg, lk, 1.f);
}

// ---------------------------------------------------------------------------
// Host: launches (the tensor maps are tensor_map.cuh's)
// ---------------------------------------------------------------------------

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// The (D, L, H, B) map of operand i of `st` (its b, l, h strides), boxes of
// `rows` rows.
inline cudaError_t map_of(CUtensorMap* map, const void* base, int kd, int len,
                          int heads, int batch, const long long* st, int i,
                          int rows) {
  return tensor_map_cached(map, base, false, kd, len, heads, batch, st[3 * i],
                           st[3 * i + 1], st[3 * i + 2], rows);
}

template <int kD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  using P = BwdPlan<kD>;
  CUtensorMap tq, tk, tv, to, tdo;
  cudaError_t err = map_of(&tq, q, kD, lq, heads, batch, st, 0, kOwnRows);
  if (err == cudaSuccess) err = map_of(&tk, k, kD, lk, heads, batch, st, 1, P::kKeyTile);
  if (err == cudaSuccess) err = map_of(&tv, v, kD, lk, heads, batch, st, 2, P::kKeyTile);
  if (err == cudaSuccess) err = map_of(&to, o, kD, lq, heads, batch, st, 3, kOwnRows);
  if (err == cudaSuccess) err = map_of(&tdo, dout, kD, lq, heads, batch, st, 4, kOwnRows);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<kD>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kDqSmem, attr_set);
  if (err != cudaSuccess) return err;
  const int rows = kOwnRows * bwd_groups(batch * heads, lq, sm_count());
  const dim3 grid((lq + rows - 1) / rows, batch * heads);
  kernel<<<grid, 2 * rows, P::kDqSmem, stream>>>(
      tq, tk, tv, to, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), heads,
      lq, lk, strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int heads, int lq, int lk,
                       const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  using P = BwdPlan<kD>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = map_of(&tq, q, kD, lq, heads, batch, st, 0, P::kQTile);
  if (err == cudaSuccess) err = map_of(&tk, k, kD, lk, heads, batch, st, 1, kOwnRows);
  if (err == cudaSuccess) err = map_of(&tv, v, kD, lk, heads, batch, st, 2, kOwnRows);
  if (err == cudaSuccess) err = map_of(&tdo, dout, kD, lq, heads, batch, st, 3, P::kQTile);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<kD>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kDkvSmem, attr_set);
  if (err != cudaSuccess) return err;
  const int rows = kOwnRows * bwd_groups(batch * heads, lk, sm_count());
  const dim3 grid((lk + rows - 1) / rows, batch * heads);
  kernel<<<grid, 2 * rows, P::kDkvSmem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, lq, lk, strides_at(st, 4),
      strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <int kD>
void plan_of(int batch_heads, int lq, int lk, int sms, int* out) {
  using P = BwdPlan<kD>;
  const int gq = bwd_groups(batch_heads, lq, sms);
  const int gk = bwd_groups(batch_heads, lk, sms);
  const int rq = kOwnRows * gq, rk = kOwnRows * gk;
  const int plan[17] = {rq, gq, P::kKeyTile, P::kDqStages, 128 * gq,
                        int(P::kDqSmem), (lq + rq - 1) / rq * batch_heads,
                        rk, gk, P::kQTile, P::kDkvStages, 128 * gk,
                        int(P::kDkvSmem), (lk + rk - 1) / rk * batch_heads,
                        kBoxCols, kDqOps, kDkvOps};
  for (int i = 0; i < 17; ++i) out[i] = plan[i];
}

}  // namespace

// dtype: 1 = bfloat16 (0, float32, is flash_bwd.cu's); head_dim: 64 or 128,
// the instantiation (q, k, v, o, dout and dq are that wide).  `strides`
// holds the (b, l, h) element strides of q, k, v, o, dout, dq in that order
// (18 values).  Writes dq and delta = rowsum(dout∘o).  Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for another dtype or
// width, or an operand TMA cannot map); the caller raises on anything else.
extern "C" int flash_bwd_dq_sm90(int dtype, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const float* lse,
                                 float* delta, void* dq, int batch, int heads,
                                 int lq, int lk, int head_dim,
                                 const long long* strides, int causal,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    err = launch_dq<64>(q, k, v, o, dout, lse, delta, dq, batch, heads, lq, lk,
                        strides, causal, scale, s);
  else if (dtype == 1 && head_dim == 128)
    err = launch_dq<128>(q, k, v, o, dout, lse, delta, dq, batch, heads, lq,
                         lk, strides, causal, scale, s);
  return static_cast<int>(err);
}

// dtype and head_dim as above.  `strides` holds the (b, l, h) element
// strides of q, k, v, dout, dk, dv in that order (18 values); delta is
// flash_bwd_dq_sm90's.
extern "C" int flash_bwd_dkv_sm90(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int batch, int heads,
                                  int lq, int lk, int head_dim,
                                  const long long* strides, int causal,
                                  float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    err = launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, heads, lq,
                         lk, strides, causal, scale, s);
  else if (dtype == 1 && head_dim == 128)
    err = launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, heads, lq,
                          lk, strides, causal, scale, s);
  return static_cast<int>(err);
}

// The launch plans of both kernels at head_dim (64 or 128), B x H =
// batch_heads, lengths lq and lk, on a card of `sms` SMs, into out[0..16]:
// K2a's rows a block, warpgroups, keys a tile, ring slots, threads, dynamic
// shared memory bytes and blocks; K2b's rows (keys) a block, warpgroups, q
// rows a tile, ring slots, threads, dynamic shared memory bytes and blocks;
// the columns of a TMA box; K2a's and K2b's operations per (query, key)
// pair in units of the width.  Returns 0, or -1 for another width.
extern "C" int flash_bwd_plan(int head_dim, int batch_heads, int lq, int lk,
                              int sms, int* out) {
  if (head_dim == 64) plan_of<64>(batch_heads, lq, lk, sms, out);
  else if (head_dim == 128) plan_of<128>(batch_heads, lq, lk, sms, out);
  else return -1;
  return 0;
}
