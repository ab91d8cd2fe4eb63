// Flash-attention forward (K1) for Hopper (sm_90a), heads of 64 and 128.
//
// Replaces the TPU kernel `_flash_kernel` of syncfusion_tpu/ops/attention.py,
// launched there by `_flash_fwd` through `pl.pallas_call`.  It computes the
// same function: for each (batch, head), O = softmax(Q K^T / sqrt(D)) V with
// an f32 online softmax, O in the input dtype and the row logsumexp of the
// scaled logits in f32, with an optional causal (top-left aligned) mask.
//
// What bounds it on this card: per (batch, head) the work is 4·T²·D
// operations against 4·T·D elements moved (q, k, v read once, o written
// once), i.e. T/2 operations per byte in bf16.  Against the H100's ridge of
// ~295 bf16 operations per byte, the UNet's T = 2048 and 1024 levels are
// bound by operations and its T = 512 and 256 levels by bytes.
//
// Two kernels, chosen by the input's dtype:
//
// * bf16 (`flash_fwd_sm90_kernel`, generation's path): TMA, mbarrier rings
//   and wgmma.
//   - Loads.  q, k and v are read by TMA through 4-D tensor maps (D, L, H,
//     B) built per call from the (B, L, H, D) strides (tensor_map.cuh), so
//     they may be strided views of one qkv projection: 16-byte aligned,
//     with B, L and H strides in multiples of 8 elements (the wrapper
//     checks this).  A 64-row tile is D / 64 boxes of 64 columns (128
//     bytes, the 128-byte swizzle), each on a 1024-byte boundary; rows past
//     L land as 0 and their logits are masked.  The block's q tiles arrive
//     once; K and V each have a ring of kStages slots with `full` and
//     `empty` mbarriers, K and V of key tile t issued while tile t - 2 is
//     being computed.  Thread 0 issues the copies, but every thread runs the
//     loader's code with the TMA and `expect_tx` predicated in the PTX and
//     waits on the slot's `empty` barrier inside one asm: a branch around
//     the loads made ptxas serialize every wgmma (C7520) in the wide K1.
//   - Products.  One consumer warpgroup a 64-row q tile.  S = q Kᵀ runs on
//     wgmma m64nNk16 with q and K K-major in shared memory, N the key tile
//     (64 keys at kD = 64, 128 at kD = 128: `Bf16Plan`); O += P V on
//     wgmma m64n64k16 with P from registers (S's accumulator layout is the
//     A-fragment layout) and V MN-major as TMA lays it, one product a
//     64-column piece of O.  P enters as hi + lo bf16, two products, as the
//     mma.sync body this replaces fed it: P rounded once to bf16 moves O by
//     up to 2^-9 of |O| and flips the bf16 O of rows with few keys (|O| >= 2
//     in a causal head); so a (query, key) pair costs 2·D (S) + 2·2·D (P·V)
//     = 6·D operations, 1.5x the function's 4·D.
//   - Overlap (FlashAttention-3's intra-warpgroup pipelining).  Each key
//     tile's S is issued together with the previous tile's P·V, and the
//     softmax of the tile (f32, in registers, log2 domain: 2^(S·scale·log2 e
//     - max) by one FFMA and ex2, the row sum from the f32 P) runs while
//     that P·V is in flight; O is rescaled once P·V has landed.  Two
//     warpgroups a block (128 q rows sharing every K and V tile) where the
//     grid still gives each SM a block, else one (64 rows): `fwd_groups`,
//     mirrored by ops/attention.py's `fwd_plan`.  Registers a thread: O
//     kD / 2, S N / 2, P as hi + lo N / 2.
// * f32 (`flash_fwd_3xtf32_kernel`, the training recipe's type, which has
//   no TF32): the same forward on the tensor cores with f32-accurate
//   products, mma.sync.m16n8k8 tf32 in 3xTF32 (tf32_mma.cuh, shared with
//   K2a/K2b): q, K, V and P each enter as big + small tf32 parts, and each
//   product as small·big + big·small + big·big.  One block of 4 warps owns
//   64 query rows, 16 (one m16 tile) a warp.  Q is copied once and K/V in
//   a ring of two stages of 64 keys, all by 16-byte cp.async into tiles of
//   pitch 72 (conflict-free fragment loads); the k order of every mma is
//   permuted so that P goes from the C registers of S = q·Kᵀ into P·V with
//   no shuffle.  Each K/V tile's P·V terms go to a partial sum added to O
//   in f32 (the tensor cores truncate what they accumulate).  The online
//   softmax as in the bf16 kernel.  In f32 the function needs 4·T²·D
//   operations against 16·T·D bytes, T/4 a byte, above the 3xTF32 ridge of
//   49 at every T the UNet has: bound by operations, at a third of the
//   TF32 rate (165 TFLOP/s).  Its inputs: 16-byte aligned, B, L and H
//   strides in multiples of 4 elements (cp.async).
//
// Head widths: both kernels are templates of the head width kD and are
// built at 64 and at 128; the wrapper zero-pads a narrower head to the next
// of the two (the zero columns change no logit, and O's come out 0) and
// passes the true width's scale.  At 128 the f32 kernel takes one block an
// SM (170 KB of tiles).  A wider head goes to flash_fwd_wide_sm90.cu (up to
// 512: O at the full width in the registers of two warpgroups),
// flash_fwd_cluster_sm90.cu (up to 4096: O's columns split over the blocks
// of a thread-block cluster) or flash_wide.cu (above).
//
// Layout: q, k, v, o are (B, L, H, kD) with such element strides for B, L
// and H and a contiguous head dim; lse is a contiguous (B, H, Lq) f32 array.
// A ragged sequence tail is masked in the kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "sm90.cuh"
#include "sm90_tiles.cuh"
#include "tensor_map.cuh"
#include "tf32_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: tensor cores, mma.sync m16n8k8 tf32 in 3xTF32 (tf32_mma.cuh)
// ---------------------------------------------------------------------------

// Shared memory of flash_fwd_3xtf32_kernel: the q tile, then the ring of K/V
// tiles (two stages of K and V), f32 at pitch kD + 8.
template <int kD>
__host__ __device__ constexpr size_t f32_smem() {
  return 5 * tile_elems(kD) * sizeof(float);
}

// One block: one 64-row q tile of one (batch, head), 16 rows a warp; loops
// over the 64-key K/V tiles.
template <int kD>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(f32_smem<kD>()))
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int heads, int lq, int lk,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        int causal, float scale) {
  constexpr int kTileElems = tile_elems(kD);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + kTileElems;  // stage s: K at ring + 2s·kTileElems, then V

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the m16 tile
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of an n-tile
  const int r0 = 16 * (tid >> 5);  // the warp's first row in the tile
  const int q0 = blockIdx.x * kTile;

  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  int tiles = (lk + kTile - 1) / kTile;
  // keys after the tile's last q row are masked for every row of it
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);

  // q and the first K/V tile, one group
  cp_tile<kD>(qs, q + b * sq.b + h * sq.h, sq.l, q0, lq, tid);
  if (tiles > 0) {
    cp_tile<kD>(ring, kp, sk.l, 0, lk, tid);
    cp_tile<kD>(ring + kTileElems, vp, sv.l, 0, lk, tid);
  }
  cp_async_commit();

  const float sl = scale * kLog2e;
  float acc[kD / 8][4];  // O: kD / 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8: the row max of S·sl (log2 domain) and this thread's
  // part of the row sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    // tile it has landed, and every warp is done with tile it - 1, whose
    // stage the next load overwrites
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kTileElems;
      cp_tile<kD>(next, kp, sk.l, k0 + kTile, lk, tid);
      cp_tile<kD>(next + kTileElems, vp, sv.l, k0 + kTile, lk, tid);
      cp_async_commit();
    }
    const float* ks = ring + (it & 1) * 2 * kTileElems;
    const float* vs = ks + kTileElems;

    // S = q Kᵀ: kD / 8 k-steps over D, 8 n-tiles of 8 keys, q and K split
    float s[1][8][4];
    scores<kD, 1, true, float>(s, {qs}, {ks}, r0, g, t);

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3), in the log2
    // domain: p = 2^(S·sl - max), sl = scale·log2(e) > 0, so the max of
    // S·sl is sl times the max of S
    const bool edge = k0 + kTile > lk || (causal && k0 + kTile - 1 > q0 + r0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= lk || (causal && key > row)) s[0][j][e] = -CUDART_INF_F;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[0][j][e]);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl);
      // While every key so far is masked, m_new is -inf: shift by 0
      // instead, which leaves every p (and alpha) at exactly 0.
      shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = ex2(m[r] - shift[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[0][j][e], sl, -shift[e >> 1]));
        s[0][j][e] = p;
        l[e >> 1] += p;
      }
    }
    // O's kD / 8 n-tiles (S's 8 n-tiles are keys, O's are head columns)
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: P from the C registers, split like V; this tile's terms in
    // a partial sum added to O in f32
    product_cb<kD, true>(acc, s[0], vs, g, t);
  }
  cp_async_wait_all();  // nothing in flight (q and K/V only if tiles == 0)

  float* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the quad holding a row adds its four partial sums
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= lq) continue;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      store2(op + qi * so.l + 8 * n + 2 * t, acc[n][2 * r] * inv,
             acc[n][2 * r + 1] * inv);
    // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits
    if (t == 0)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
}

template <int kD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int heads, int lq, int lk,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<kD>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err =
      set_smem_once(flash_fwd_3xtf32_kernel<kD>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads);
  auto kernel = flash_fwd_3xtf32_kernel<kD>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, heads, lq, lk,
      sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarrier rings, wgmma (sm90.cuh)
// ---------------------------------------------------------------------------

constexpr int kMaxGroups = 2;  // consumer warpgroups a block
constexpr int kBoxCols = 64;   // bf16 columns of a 128-byte TMA box

// The tiles of one head width.  A 64-row q tile and a key tile of K or V
// are kD / 64 boxes each; key tiles of 64 at kD = 64 (S on wgmma n64: 83 KB
// a block, two blocks an SM) and of 128 at kD = 128 (S on wgmma n128, half
// the waits a key); kStages slots a ring, as many as fit a block.
template <int kD>
struct Bf16Plan {
  static constexpr int kKeyTile = kD;
  static constexpr int kStages = kD == 64 ? 4 : 3;
  static constexpr int kBoxes = kD / kBoxCols;
  static constexpr uint32_t kQBox = kQRows * 128;     // bytes of a q box
  static constexpr uint32_t kKvBox = kKeyTile * 128;  // of a K or V box
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr uint32_t kKvTile = kBoxes * kKvBox;
  static constexpr int kN = kKeyTile / 8;   // n-tiles of S
  static constexpr int kK = kKeyTile / 16;  // k-steps of P·V
  // 1024 bytes for the alignment, kMaxGroups q tiles, the K and V rings,
  // the barriers (full and empty of each ring, q's)
  static constexpr size_t kSmem = 1024 + kMaxGroups * size_t(kQTile) +
                                  2 * kStages * size_t(kKvTile) +
                                  8 * (4 * kStages + 1);
  static_assert(kD == 64 || kD == 128, "head width");
  static_assert(kSmem <= 232448, "shared memory");
};
// operations per (query, key) pair in units of kD (the function's: 4): S
// 2, P·V 2 as two products (hi + lo)
constexpr int kOpsPerPair = 6;

// Consumer warpgroups a block: two, sharing every K and V tile, where the
// grid of 128-row blocks still has a block for each of the card's `sms`
// SMs; else one, so that few heads or a short sequence spread over twice
// as many SMs.  ops/attention.py's `fwd_plan` mirrors it.
__host__ __device__ inline int fwd_groups(int batch_heads, int lq, int sms) {
  const long long blocks = (long long)((lq + 2 * kQRows - 1) / (2 * kQRows)) *
                           batch_heads;
  return blocks >= sms ? 2 : 1;
}

// Shared-memory addresses of a block: the q tiles (1024-aligned), the K
// ring, the V ring and the barriers.
struct Bf16Smem {
  uint32_t qs, ks, vs, full_k, full_v, empty_k, empty_v, qbar;
};

// S = q Kᵀ for the group's 64 q rows and a key tile in S's accumulator
// layout (s[j][e] for n-tile j, keys 8j .., as sm90.cuh describes): kD / 16
// wgmma, q and K K-major; issued, not waited for.
template <class P>
__device__ __forceinline__ void issue_scores(float (&s)[P::kN][4], uint32_t qs,
                                             uint32_t ks) {
  float(&d)[P::kKeyTile / 2] = reinterpret_cast<float(&)[P::kKeyTile / 2]>(s);
#pragma unroll
  for (int kk = 0; kk < P::kBoxes * 4; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns, 32 bytes
    const uint64_t da = sw128_desc(qs + (kk >> 2) * P::kQBox + off, 16, 1024);
    const uint64_t db = sw128_desc(ks + (kk >> 2) * P::kKvBox + off, 16, 1024);
    if constexpr (P::kKeyTile == 128)
      wgmma_64x128x16_ss(d, da, db, kk > 0);
    else
      wgmma_64x64x16_ss(d, da, db, kk > 0);
  }
}

// O += P V for a key tile, P as hi + lo bf16 A fragments, V MN-major: two
// wgmma a 16-key step and 64-column piece of O; issued, not waited for.
template <class P>
__device__ __forceinline__ void issue_pv(float (&acc)[P::kBoxes][32],
                                         const uint32_t (&ph)[P::kK][4],
                                         const uint32_t (&pl)[P::kK][4],
                                         uint32_t vs) {
#pragma unroll
  for (int pc = 0; pc < P::kBoxes; ++pc) {
#pragma unroll
    for (int kk = 0; kk < P::kK; ++kk) {
      // keys 16kk .. 16kk + 15: two groups of 8 rows, 1024 bytes apart
      const uint64_t db =
          sw128_desc(vs + pc * P::kKvBox + kk * 16 * 128, P::kKvBox, 1024);
      wgmma_64x64x16_rs_mn(acc[pc], ph[kk], db);
      wgmma_64x64x16_rs_mn(acc[pc], pl[kk], db);
    }
  }
}

// P (the f32 P in s) as hi + lo bf16 A fragments: keys 16kk .. of k-step
// kk are S's n-tiles 2kk and 2kk + 1.
template <class P>
__device__ __forceinline__ void pack_p(const float (&s)[P::kN][4],
                                       uint32_t (&ph)[P::kK][4],
                                       uint32_t (&pl)[P::kK][4]) {
#pragma unroll
  for (int kk = 0; kk < P::kK; ++kk) {
    const float(&s0)[4] = s[2 * kk];
    const float(&s1)[4] = s[2 * kk + 1];
    split_bf16(s0[0], s0[1], ph[kk][0], pl[kk][0]);
    split_bf16(s0[2], s0[3], ph[kk][1], pl[kk][1]);
    split_bf16(s1[0], s1[1], ph[kk][2], pl[kk][2]);
    split_bf16(s1[2], s1[3], ph[kk][3], pl[kk][3]);
  }
}

// After wgmma_wait: keep the compiler from reading O before it, and P's
// registers from being reused while a product may still read them.
template <class P>
__device__ __forceinline__ void fence_pv(float (&acc)[P::kBoxes][32],
                                         uint32_t (&ph)[P::kK][4],
                                         uint32_t (&pl)[P::kK][4]) {
#pragma unroll
  for (int pc = 0; pc < P::kBoxes; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[pc][i]);
#pragma unroll
  for (int kk = 0; kk < P::kK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_operand(ph[kk][i]);
      fence_operand(pl[kk][i]);
    }
}

// The online softmax of one key tile on rows g (e = 0, 1) and g + 8 (e =
// 2, 3) of the warp's 16, in place (s becomes the f32 P), in the log2
// domain: p = 2^(S·sl - max), sl = scale·log2(e) > 0.  `lim` is each
// row's first masked key less k0 + 2t; `masked` says whether any key of
// the tile may be masked (the same for the whole block).
template <int kN>
__device__ __forceinline__ void softmax(float (&s)[kN][4], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const int (&lim)[2], bool masked,
                                        float sl) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = 8 * j + (e & 1) < lim[e >> 1] ? s[j][e] : -CUDART_INF_F;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * sl);
    // while every key so far is masked, m_new is -inf: shift by 0, which
    // leaves every p (and alpha) at exactly 0
    shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[r] = ex2(m[r] - shift[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[j][e], sl, -shift[e >> 1]));
      s[j][e] = p;
      l[e >> 1] += p;
    }
}

// One block: `groups` warpgroups, group g the 64 q rows q0 + 64g .., all
// of one (batch, head); loops over the key tiles.
template <int kD>
__global__ void __launch_bounds__(128 * kMaxGroups, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                          int heads, int lq, int lk, Strides so, int causal,
                          float scale) {
  using P = Bf16Plan<kD>;
  constexpr int kKT = P::kKeyTile;
  constexpr int kS = P::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  Bf16Smem sm;
  const uint32_t raw = smem_addr(smem);
  sm.qs = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned
  sm.ks = sm.qs + kMaxGroups * P::kQTile;
  sm.vs = sm.ks + kS * P::kKvTile;
  sm.full_k = sm.vs + kS * P::kKvTile;  // kS barriers each
  sm.full_v = sm.full_k + 8 * kS;
  sm.empty_k = sm.full_v + 8 * kS;
  sm.empty_v = sm.empty_k + 8 * kS;
  sm.qbar = sm.empty_v + 8 * kS;

  const int groups = blockDim.x / 128;
  // the warpgroup as a value the compiler knows to be uniform across a
  // warp: a wgmma under a branch on a value it cannot prove so is
  // serialized (ptxas C7520)
  const int group = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * kQRows * groups;  // the block's first row
  const int qg = q0 + kQRows * group;           // the group's
  const int kend = causal ? imin(lk, q0 + kQRows * groups) : lk;
  const int tiles = (kend + kKT - 1) / kKT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(sm.full_k + 8 * s, 1);
      mbar_init(sm.full_v + 8 * s, 1);
      mbar_init(sm.empty_k + 8 * s, blockDim.x);
      mbar_init(sm.empty_v + 8 * s, blockDim.x);
    }
    mbar_init(sm.qbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  // Thread 0 issues the loads, but every thread runs the code: the waits
  // and the copies are predicated in the instructions, so no branch that
  // may diverge lies between a group's wgmma.  K and V of tile t go into
  // slot t mod kS once every thread has released the slot's tile t - kS
  // (the wait passes at once on a fresh barrier).
  const bool loader = threadIdx.x == 0;
  auto issue = [&](int t) {
    if (t >= tiles) return;
    const int slot = t % kS;
    const uint32_t parity = ((t / kS) & 1) ^ 1;
    const uint32_t at = slot * P::kKvTile;
    mbar_wait_converged(sm.empty_k + 8 * slot, parity);
    mbar_arrive_expect_tx_if(sm.full_k + 8 * slot, P::kKvTile, loader);
    for (int c = 0; c < P::kBoxes; ++c)
      tma_load_4d_if(sm.ks + at + c * P::kKvBox, &tk, sm.full_k + 8 * slot,
                     c * kBoxCols, t * kKT, h, b, loader);
    mbar_wait_converged(sm.empty_v + 8 * slot, parity);
    mbar_arrive_expect_tx_if(sm.full_v + 8 * slot, P::kKvTile, loader);
    for (int c = 0; c < P::kBoxes; ++c)
      tma_load_4d_if(sm.vs + at + c * P::kKvBox, &tv, sm.full_v + 8 * slot,
                     c * kBoxCols, t * kKT, h, b, loader);
  };
  mbar_arrive_expect_tx_if(sm.qbar, groups * P::kQTile, loader);
  for (int r = 0; r < groups; ++r)
    for (int c = 0; c < P::kBoxes; ++c)
      tma_load_4d_if(sm.qs + r * P::kQTile + c * P::kQBox, &tq, sm.qbar,
                     c * kBoxCols, q0 + kQRows * r, h, b, loader);
  for (int t = 0; t < kS - 2; ++t) issue(t);

  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int g = lane >> 2;
  const int tg = lane & 3;
  const uint32_t qs = sm.qs + group * P::kQTile;
  const float sl = scale * kLog2e;
  // each row's end of the keys it sees, less 2·tg (the thread's first
  // column of an n-tile): a key tile at k0 masks its n-tile j, column c of
  // row r where 8j + c >= lim0[r] - k0
  int lim0[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qg + r0 + g + 8 * r;
    lim0[r] = (causal ? imin(lk, row + 1) : lk) - 2 * tg;
  }
  auto masked = [&](int k0) {
    return k0 + kKT > lk || (causal && k0 + kKT - 1 > q0);
  };

  float acc[P::kBoxes][32];
#pragma unroll
  for (int pc = 0; pc < P::kBoxes; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pc][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float s[P::kN][4];
  uint32_t ph[P::kK][4], pl[P::kK][4];
  float alpha[2];

  // key tile 0: S, its softmax, P
  mbar_wait_converged(sm.qbar, 0);
  mbar_wait_converged(sm.full_k, 0);
  wgmma_fence();
  issue_scores<P>(s, qs, sm.ks);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < P::kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(s[j][e]);
  mbar_arrive(sm.empty_k);
  {
    const int lim[2] = {lim0[0], lim0[1]};
    softmax(s, m, l, alpha, lim, masked(0), sl);
  }
  pack_p<P>(s, ph, pl);
  issue(kS - 2);

  // tile j: S of tile j issued with P·V of tile j - 1; tile j's softmax
  // under that P·V; then O rescaled and P of tile j packed
  for (int j = 1; j < tiles; ++j) {
    const int k0 = j * kKT;
    const int sk = j % kS, sv = (j - 1) % kS;
    mbar_wait_converged(sm.full_k + 8 * sk, (j / kS) & 1);
    mbar_wait_converged(sm.full_v + 8 * sv, ((j - 1) / kS) & 1);
    wgmma_fence();
    issue_scores<P>(s, qs, sm.ks + sk * P::kKvTile);
    wgmma_commit();
    issue_pv<P>(acc, ph, pl, sm.vs + sv * P::kKvTile);
    wgmma_commit();
    wgmma_wait<1>();  // S has landed, P·V may still run
#pragma unroll
    for (int jj = 0; jj < P::kN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(s[jj][e]);
    mbar_arrive(sm.empty_k + 8 * sk);
    const int lim[2] = {lim0[0] - k0, lim0[1] - k0};
    softmax(s, m, l, alpha, lim, masked(k0), sl);
    wgmma_wait<0>();
    fence_pv<P>(acc, ph, pl);
    mbar_arrive(sm.empty_v + 8 * sv);
    issue(j + kS - 2);
#pragma unroll
    for (int pc = 0; pc < P::kBoxes; ++pc)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pc][i] *= alpha[(i >> 1) & 1];
    pack_p<P>(s, ph, pl);
  }

  // P·V of the last tile
  {
    const int sv = (tiles - 1) % kS;
    mbar_wait_converged(sm.full_v + 8 * sv, ((tiles - 1) / kS) & 1);
    wgmma_fence();
    issue_pv<P>(acc, ph, pl, sm.vs + sv * P::kKvTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv<P>(acc, ph, pl);
    mbar_arrive(sm.empty_v + 8 * sv);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the quad holding a row adds its four partial sums
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    inv[r] = 1.f / l_safe;
    const int qi = qg + r0 + g + 8 * r;
    // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits
    if (tg == 0 && qi < lq)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int pc = 0; pc < P::kBoxes; ++pc)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qg + r0 + g + 8 * r;
      if (row >= lq) continue;
      __nv_bfloat16* p = op + row * so.l + kBoxCols * pc + 2 * tg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(p + 8 * n, acc[pc][4 * n + 2 * r] * inv[r],
               acc[pc][4 * n + 2 * r + 1] * inv[r]);
    }
}

// The card's SM count, asked once per device (0 where the query fails).
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && sms[dev] != 0) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kMaxDevices) sms[dev] = n;
  return n;
}

template <int kD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int batch, int heads, int lq, int lk,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        int causal, float scale, cudaStream_t stream) {
  using P = Bf16Plan<kD>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map_cached(&tq, q, false, kD, lq, heads, batch,
                                      sq.b, sq.l, sq.h, kQRows);
  if (err == cudaSuccess)
    err = tensor_map_cached(&tk, k, false, kD, lk, heads, batch, sk.b, sk.l,
                            sk.h, P::kKeyTile);
  if (err == cudaSuccess)
    err = tensor_map_cached(&tv, v, false, kD, lk, heads, batch, sv.b, sv.l,
                            sv.h, P::kKeyTile);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<kD>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const int groups = fwd_groups(batch * heads, lq, sm_count());
  const int rows = kQRows * groups;
  const dim3 grid((lq + rows - 1) / rows, batch * heads);
  kernel<<<grid, 128 * groups, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, heads, lq, lk, so,
      causal, scale);
  return cudaGetLastError();
}

template <int kD>
void plan_of(int batch_heads, int lq, int sms, int* out) {
  using P = Bf16Plan<kD>;
  const int groups = fwd_groups(batch_heads, lq, sms);
  const int rows = kQRows * groups;
  const int plan[9] = {rows, groups, P::kKeyTile, P::kStages, 128 * groups,
                       int(P::kSmem), kBoxCols, kOpsPerPair,
                       (lq + rows - 1) / rows * batch_heads};
  for (int i = 0; i < 9; ++i) out[i] = plan[i];
}

}  // namespace

// dtype: 0 = float32 (tensor cores, 3xTF32), 1 = bfloat16 (TMA and wgmma);
// head_dim: 64 or 128, the instantiation (q, k, v and o are that wide;
// flash_fwd_wide_sm90.cu's flash_fwd_wide, flash_fwd_cluster_sm90.cu's
// flash_fwd_cluster and flash_wide.cu's flash_fwd_chunked take wider heads
// with these arguments).  Strides are in elements.  Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue also for a bf16 operand
// TMA cannot map); the caller raises on anything else.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch,
                         int heads, int lq, int lk, int head_dim,
                         long long q_sb, long long q_sl, long long q_sh,
                         long long k_sb, long long k_sl, long long k_sh,
                         long long v_sb, long long v_sl, long long v_sh,
                         long long o_sb, long long o_sl, long long o_sh,
                         int causal, float scale, void* stream) {
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh},
      sv{v_sb, v_sl, v_sh}, so{o_sb, o_sl, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) {
    err = launch_f32<64>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                         so, causal, scale, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch_f32<128>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                          so, causal, scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch_bf16<64>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                          so, causal, scale, s);
  } else if (dtype == 1 && head_dim == 128) {
    err = launch_bf16<128>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                           so, causal, scale, s);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory in bytes that each launch of flash_fwd asks for,
// dtype and head_dim as above; -1 for an unknown dtype or width.
extern "C" int flash_fwd_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 64) return static_cast<int>(f32_smem<64>());
  if (dtype == 0 && head_dim == 128) return static_cast<int>(f32_smem<128>());
  if (dtype == 1 && head_dim == 64) return static_cast<int>(Bf16Plan<64>::kSmem);
  if (dtype == 1 && head_dim == 128) return static_cast<int>(Bf16Plan<128>::kSmem);
  return -1;
}

// The launch plan of the bf16 kernel at head_dim (64 or 128), B x H =
// batch_heads, q length lq, on a card of `sms` SMs, into out[0..8]: q rows
// a block, warpgroups a block, keys a tile, slots a ring, threads a block,
// dynamic shared memory bytes, columns a TMA box, operations per (query,
// key) pair in units of the width, and blocks in the grid.  Returns 0, or
// -1 for another width.
extern "C" int flash_fwd_plan(int head_dim, int batch_heads, int lq, int sms,
                              int* out) {
  if (head_dim == 64) plan_of<64>(batch_heads, lq, sms, out);
  else if (head_dim == 128) plan_of<128>(batch_heads, lq, sms, out);
  else return -1;
  return 0;
}
