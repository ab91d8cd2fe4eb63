// Flash-attention forward (K1) for heads wider than 512 on Hopper (sm_90a),
// on thread-block clusters: at every head width W that is a multiple of 64
// from 576 to 4096 (`kMaxCluster` blocks of at most `kSliceMax` columns).
//
// Replaces, at those widths, the TPU kernel `_flash_kernel` of
// syncfusion_tpu/ops/attention.py (its `pl.pallas_call` in `_flash_fwd`),
// whose BlockSpecs carry the full head width.  It computes the same
// function as flash_fwd.cu and flash_fwd_wide_sm90.cu: for each (batch,
// head), O = softmax(q kᵀ·scale) V with an f32 online softmax, O in the
// input type and the row logsumexp of the scaled logits as a (B, H, Lq)
// f32 array, with an optional causal (top-left aligned) mask.  The wrapper
// zero-pads a head to W and passes the true width's scale.
//
// What bounds it: per (batch, head) 4·T²·W operations against 4·T·W
// elements moved, T / 2 operations a byte in bf16 and T / 4 in f32: the
// tensor cores' rate at any T above a few hundred.
//
// Why a cluster.  flash_fwd_wide_sm90.cu holds 64 rows of O at the full
// width in the registers of two warpgroups, at most 128 a thread; past 512
// columns that tile (64 x W x 4 bytes, 256 KB at W = 1024) fits neither
// the registers nor the shared memory of one SM.  flash_wide.cu's chunked
// K1 splits O's columns over a grid dimension instead and recomputes S in
// every chunk: (NC + 1) / 2 times the function's operations (3x at 576,
// 4.5x at 1024), on tf32 mma.sync in both types.  Here the blocks of a
// cluster (up to 8, on neighbouring SMs) split the head's columns, and S is
// computed once: each block computes the partial S of its own columns, and
// the partial sums are added across the cluster through distributed shared
// memory.
//
// The design (one launch a call; no atomics, so O and the LSE are the same
// bits from run to run):
//
// * Grid.  One cluster of N blocks for each 64-row q tile and (batch,
//   head), laid along grid x.  Block r of a cluster owns the head columns
//   [r·kSlice, (r + 1)·kSlice) (its slice; the last one may be ragged:
//   only its whole 64-column pieces below W are loaded and computed), and
//   each of its two warpgroups owns ceil or floor of half of those pieces.
//   N and kSlice follow from W and the type (`cluster_shape`): N =
//   ceil(W / target), at most 8, kSlice the least multiple of 64 with N
//   slices covering W, then N again as few as cover W with that slice.
//   The targets were picked by measurement (builds of this file with other
//   targets, timed beside each other on an NVIDIA H100 80GB HBM3, 700 W;
//   B = 2, one head, T = 1024, and bf16 16 x 1 head of 1024, T = 2048):
//   bf16 512
//   columns (N = 2 at 576-1024: 0.0802 / 0.1497 / 2.3475 ms, against
//   0.0868 / 0.1922 / 3.4420 at 256 and 0.2132 / 0.4430 / 10.48 at 128),
//   f32 256 (N = 3 at 576, 4 at 1024: 0.2642 / 0.6155, against 0.3612 /
//   0.7013 at 512 and 0.4303 / 0.7554 at 128).  bf16's blocks do little
//   tensor work a key tile, so fewer and wider blocks pay the exchange
//   less often; f32's 3xTF32 products are slow, so more blocks pay off.
// * Loads.  As flash_fwd_wide_sm90.cu: TMA through 4-D (W, L, H, B) tensor
//   maps of the strided operands, boxes of 128 bytes at columns r·kSlice +
//   ..., rows past L as 0; thread 0 loads the block's q slice once, then
//   the K and V slices of each key tile alternately into a ring of two
//   slots on `full` and `empty` mbarriers.
// * S once a key tile, summed across the cluster.  Each warpgroup computes
//   the partial S of its own pieces (bf16 on wgmma m64n64k16, or m64n32k16
//   where the slice leaves room for 32-key tiles only; f32 as 3xTF32 on
//   mma.sync m16n8k8) and writes it to shared memory in its accumulator
//   layout (thread t's fragment at slot t: every group of the cluster lays
//   S out alike).  The block adds its two groups' partials (group 0 +
//   group 1) into one of two exchange buffers; one cluster barrier
//   (arrive.release, wait.acquire) later each thread of each block reads
//   its share of the N block partials through distributed shared memory
//   (mapa + ld.shared::cluster), adds them in rank order 0 .. N - 1, and
//   writes the sum to a local tile from which both groups read S back into
//   their registers.  So every block holds the same bits of S, and with
//   them the same P, running max and sum and LSE; block 0 alone writes the
//   LSE.  Remote reads: (N - 1) tiles of 64 x key tile f32 a block a key
//   tile (an all-gather of block partials, after a local sum of the two
//   groups, so not 2N - 1 a group); a thread reads its share of a rank's
//   tile at once, one round trip a rank.  Measured as above, in builds that
//   skip the whole exchange or only its remote reads (each block then
//   keeps a wrong S), the exchange takes 24-29% of bf16's time (D = 1024,
//   B = 2 and 16: without it 0.1145 and 1.6733 ms), the remote reads 9-11%
//   (without them 0.1362, 2.0814); f32 18% and 11% at D = 1024.  A
//   reduce-scatter then all-gather would read 2(N - 1) / N tiles, no fewer
//   at N = 2.
// * Syncing.  A group's partial is written before its threads release the
//   K slot; the release's wait (every thread waits for all, see `issue`)
//   then also publishes both partials to the block.  The exchange buffers
//   alternate by key tile, so one cluster barrier a key tile is enough: a
//   block writes buffer k mod 2 again at tile k + 2, after it passed
//   barrier k + 1, which no block reaches before it has finished reading
//   its peers' buffers of tile k.  One more
//   cluster barrier before exit keeps every block's shared memory alive
//   while a peer may still read it.  The causal tile count depends only on
//   the q tile, which the blocks of a cluster share, so every block meets
//   every barrier.
// * P·V on each group's own pieces of O, held in registers, with
//   flash_fwd_wide_sm90.cu's code (sm90_tiles.cuh `add_pv`): bf16 P from
//   registers as hi + lo bf16 on wgmma (V MN-major as TMA lays it), f32 as
//   3xTF32 on mma.sync.
//
// Operations per (query, key) pair, in units of W (the function's: 4),
// leaving out the zero columns of a ragged last slice: bf16 S 2 + P·V 4 =
// 6 (1.5x); f32 3·(2 + 2) = 12 tf32 products of 2W (3x).  The chunked
// kernel does (NC + 1) / 2 times the function's: 3x at 576, 4.5x at 1024.
//
// Shared memory: the q slice (64 x kSlice), two ring slots (key tile x
// kSlice), five S tiles of 64 x key tile f32 (two group partials, two
// exchange buffers, the summed S) and the five ring barriers, with 1024
// bytes for the alignment; key tiles of 64 (bf16) or 32 (f32), halved
// where that does not fit a block.  `ClusterPlan` sets them;
// `flash_fwd_cluster_plan` returns them with N and kSlice, and
// syncfusion_tpu_torch/ops/attention.py's `cluster_fwd_plan` mirrors it.

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

constexpr int kStages = 2;      // slots of the K/V ring
constexpr int kGroups = 2;      // warpgroups a block
constexpr int kThreadsCluster = 128 * kGroups;
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable limit)
constexpr int kSliceMax = 512;  // O's columns a block: 128 registers a thread
constexpr int kMinWidth = 576;  // narrower heads: flash_fwd_wide_sm90.cu
constexpr int kMaxWidth = kMaxCluster * kSliceMax;
constexpr int kXTiles = 5;      // S tiles: 2 partials, 2 exchange, 1 sum
constexpr size_t kSmemMax = 232448;
// the slice a cluster aims for (columns a block), by type: `cluster_shape`
constexpr int kTargetBf16 = 512;
constexpr int kTargetF32 = 256;

// Dynamic shared memory of a (type, slice, key tile): 1024 bytes for the
// alignment, the q slice, the ring's slots, the S tiles, the barriers.
template <typename T>
constexpr size_t cluster_bytes(int slice, int key_tile) {
  return 1024 + size_t(kQRows) * slice * sizeof(T) +
         kStages * size_t(key_tile) * slice * sizeof(T) +
         kXTiles * size_t(kQRows) * key_tile * 4 + 64;
}

// The tiles of one (type, slice).
template <typename T, int kSlice>
struct ClusterPlan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kEsize = sizeof(T);
  static constexpr int kPieces = kSlice / kPiece;
  static constexpr int kGroupPieces = (kPieces + 1) / 2;
  static constexpr int kBoxCols = 128 / kEsize;
  static constexpr int kPieceBoxes = kPiece / kBoxCols;
  static constexpr int kFullKeyTile = kF32 ? 32 : 64;
  static constexpr int kKeyTile =
      cluster_bytes<T>(kSlice, kFullKeyTile) <= kSmemMax ? kFullKeyTile
                                                         : kFullKeyTile / 2;
  static constexpr size_t kQBytes = size_t(kQRows) * kSlice * kEsize;
  static constexpr size_t kSlotBytes = size_t(kKeyTile) * kSlice * kEsize;
  static constexpr size_t kXBytes = size_t(kQRows) * kKeyTile * 4;
  static constexpr size_t kSmem = cluster_bytes<T>(kSlice, kKeyTile);
  static constexpr uint32_t kQBox = kQRows * 128;     // bytes of a q box
  static constexpr uint32_t kKvBox = kKeyTile * 128;  // of a K or V box
  // operations per (query, key) pair in units of W (the function's: 4):
  // S (2) once, P·V (2) as two products; f32 in tf32 products, three a
  // product
  static constexpr int kOpsPerPair = kF32 ? 3 * (2 + 2) : 2 + 4;
  static_assert(kSlice % kPiece == 0 && kSlice <= kSliceMax, "slice");
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kGroupPieces * 32 <= 128, "O's registers");
};

// N blocks of `slice` columns for a head of `width` columns and this type,
// or false for a width this kernel does not take.
inline bool cluster_shape(int width, bool f32, int& cluster, int& slice) {
  if (width % kPiece != 0 || width < kMinWidth || width > kMaxWidth)
    return false;
  const int target = f32 ? kTargetF32 : kTargetBf16;
  int n = (width + target - 1) / target;
  if (n > kMaxCluster) n = kMaxCluster;
  slice = ((width + n - 1) / n + kPiece - 1) / kPiece * kPiece;
  cluster = (width + slice - 1) / slice;
  return slice <= kSliceMax && cluster <= kMaxCluster;
}

// ---------------------------------------------------------------------------
// The partial S = q kᵀ over a group's pieces first .. first + mine - 1 of
// the block's slice, for the 64 q rows and the key tile, in S's
// accumulator layout: s[j][e] for n-tile j (keys 8j ..) as sm90.cuh
// describes.  bf16 here; f32 is sm90_tiles.cuh's `scores`, as is P·V
// (`add_pv`, on the group's own pieces of O).
// ---------------------------------------------------------------------------

// bf16, one warpgroup: 4 wgmma a piece, q and K K-major from their tiles
// (a 64-column piece is one 128-byte box).
template <class P>
__device__ __forceinline__ void scores(
    float (&s)[P::kKeyTile / 8][4], uint32_t qs, uint32_t ks,
    const unsigned char*, const unsigned char*, int first, int mine,
    std::false_type) {
  constexpr int kN = P::kKeyTile / 2;  // accumulator registers
  float(&d)[kN] = reinterpret_cast<float(&)[kN]>(s);
#pragma unroll
  for (int i = 0; i < kN; ++i) d[i] = 0.f;
  if (mine == 0) return;  // the group's pieces all lie past the head
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < mine * 4; ++kk) {
    const uint32_t box = first + (kk >> 2);
    const uint32_t off = (kk & 3) * 32;  // 16 columns, 32 bytes
    const uint64_t da = sw128_desc(qs + box * P::kQBox + off, 16, 1024);
    const uint64_t db = sw128_desc(ks + box * P::kKvBox + off, 16, 1024);
    if constexpr (P::kKeyTile == 64)
      wgmma_64x64x16_ss(d, da, db, kk > 0);
    else
      wgmma_64x32x16_ss(d, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kN; ++i) fence_operand(d[i]);
}

// ---------------------------------------------------------------------------
// The exchange
// ---------------------------------------------------------------------------

// Shared-memory layout of a block: the q slice at `qs` (1024-aligned), the
// ring's slots at `ring`, the two group partials of S at `xp`, the two
// exchange buffers at `xb`, the summed S at `xs`, then the barriers; `data`
// is qs as a generic pointer.
struct Smem {
  uint32_t qs, ring, xp, xb, xs, full, empty, qbar;
  unsigned char* data;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The group's partial S into its tile of `xp`, thread t's fragment at slot
// t (float4 j·128 + t for its n-tile j).
template <class P>
__device__ __forceinline__ void put_partial(const float (&s)[P::kKeyTile / 8][4],
                                            const Smem& sm) {
  constexpr int kJ = P::kKeyTile / 8;
  const int tid = threadIdx.x;
  float4* own = reinterpret_cast<float4*>(sm.data + (sm.xp - sm.qs)) +
                (tid >> 7) * kJ * 128;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    own[j * 128 + (tid & 127)] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
}

// s becomes the cluster's S, once both groups' partials are in `xp` and
// visible to every thread of the block: the two partials added into
// exchange buffer `buf`, then, past a cluster barrier, the `cluster`
// blocks' buffers added in rank order.  Every thread of the block takes
// part; each reads its share of every rank's buffer at once, so a rank
// costs one round trip.
template <class P>
__device__ __forceinline__ void exchange(float (&s)[P::kKeyTile / 8][4],
                                         const Smem& sm, int buf,
                                         int cluster) {
  constexpr int kJ = P::kKeyTile / 8;
  constexpr int kX4 = kJ * 128;                // float4s of an S tile
  constexpr int kPer = kX4 / kThreadsCluster;  // of them a thread sums
  const int tid = threadIdx.x;
  const float4* xp = reinterpret_cast<const float4*>(sm.data + (sm.xp - sm.qs));
  float4* xb = reinterpret_cast<float4*>(sm.data + (sm.xb - sm.qs) +
                                         buf * P::kXBytes);
  float4* xs = reinterpret_cast<float4*>(sm.data + (sm.xs - sm.qs));
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = tid + kThreadsCluster * u;
    xb[i] = add4(xp[i], xp[kX4 + i]);
  }
  cluster_arrive();
  cluster_wait();
  float4 sum[kPer];
  const uint32_t xb_addr = sm.xb + buf * P::kXBytes + 16 * tid;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < cluster) {
      const uint32_t at = map_rank(xb_addr, r);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const float4 v = ld_cluster_f4(at + 16 * kThreadsCluster * u);
        sum[u] = r == 0 ? v : add4(sum[u], v);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) xs[tid + kThreadsCluster * u] = sum[u];
  __syncthreads();
  const int tg = tid & 127;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const float4 x = xs[j * 128 + tg];
    s[j][0] = x.x;
    s[j][1] = x.y;
    s[j][2] = x.z;
    s[j][3] = x.w;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Block `rank` of the cluster of q tile q0 owns the slice's `live` pieces
// (columns c0 ..); warpgroup `group` owns its pieces first .. first + mine
// - 1.  Thread 0 also issues the loads: the q slice on `qbar`, then item i
// = 2·tile (K) or 2·tile + 1 (V) into slot i mod kStages once every thread
// has released the slot's previous item (as flash_fwd_wide_sm90.cu).
template <typename T, class P>
__device__ __forceinline__ void attend(const CUtensorMap& tq,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       T* __restrict__ o,
                                       float* __restrict__ lse, const Smem& sm,
                                       int rank, int cluster, int group,
                                       int bh, int b, int h, int q0, int c0,
                                       int live, int lq, int lk, int tiles,
                                       Strides so, int causal, float scale) {
  using IsF32 = std::integral_constant<bool, P::kF32>;
  constexpr int kKT = P::kKeyTile;
  const unsigned char* q_p = sm.data;
  const unsigned char* ring_p = sm.data + P::kQBytes;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const int half = (live + 1) / 2;
  const int first = group == 0 ? 0 : half;
  const int mine = group == 0 ? half : live - half;
  const int boxes = live * P::kPieceBoxes;
  const float sl = scale * kLog2e;

  // thread 0 issues the loads, but every thread runs the code: the waits
  // and the issue are predicated in the instructions, so no branch that
  // may diverge lies between this group's wgmma (a divergent one serializes
  // them, ptxas C7520).  Every thread waits for the release of the slot's
  // last item by all (right after its own), which also makes what each
  // wrote before its release visible to all.
  const bool loader = threadIdx.x == 0;
  auto issue = [&](int i) {
    const int slot = i % kStages;
    mbar_wait_converged(sm.empty + 8 * slot, ((i / kStages) & 1) ^ 1);
    if (i >= 2 * tiles) return;
    mbar_arrive_expect_tx_if(sm.full + 8 * slot, boxes * P::kKvBox, loader);
    const CUtensorMap* map = (i & 1) ? &tv : &tk;
    const uint32_t dst = sm.ring + slot * P::kSlotBytes;
    for (int c = 0; c < boxes; ++c)
      tma_load_4d_if(dst + c * P::kKvBox, map, sm.full + 8 * slot,
                     c0 + c * P::kBoxCols, (i >> 1) * kKT, h, b, loader);
  };
  mbar_arrive_expect_tx_if(sm.qbar, boxes * P::kQBox, loader);
  for (int c = 0; c < boxes; ++c)
    tma_load_4d_if(sm.qs + c * P::kQBox, &tq, sm.qbar, c0 + c * P::kBoxCols, q0,
                   h, b, loader);
  for (int i = 0; i < kStages; ++i) issue(i);  // free slots: the waits pass

  float acc[P::kGroupPieces][32];
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pc][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  mbar_wait_converged(sm.qbar, 0);
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kKT;
    const int ik = 2 * it, iv = 2 * it + 1;  // the tile's K and V items
    const int sk = ik % kStages, sv = iv % kStages;
    float s[kKT / 8][4];
    mbar_wait_converged(sm.full + 8 * sk, (ik / kStages) & 1);
    scores<P>(s, sm.qs, sm.ring + sk * P::kSlotBytes, q_p,
                      ring_p + sk * P::kSlotBytes, first, mine, IsF32{});
    put_partial<P>(s, sm);
    mbar_arrive(sm.empty + 8 * sk);
    issue(ik + kStages);  // past it both groups' partials are in xp
    exchange<P>(s, sm, it & 1, cluster);

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3) of the
    // warp's 16, log2 domain, as flash_fwd.cu
    const bool edge = k0 + kKT > lk || (causal && k0 + kKT - 1 > q0 + r0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= lk || (causal && key > row)) s[j][e] = -CUDART_INF_F;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], shift[2];
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
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[j][e], sl, -shift[e >> 1]));
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pc][i] *= alpha[(i >> 1) & 1];

    mbar_wait_converged(sm.full + 8 * sv, (iv / kStages) & 1);
    add_pv<P>(acc, s, sm.ring + sv * P::kSlotBytes, ring_p + sv * P::kSlotBytes,
              first, mine, IsF32{});
    mbar_arrive(sm.empty + 8 * sv);
    issue(iv + kStages);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    inv[r] = 1.f / l_safe;
    const int qi = q0 + r0 + g + 8 * r;
    // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits; every
    // block holds the same bits, block 0's first group writes them
    if (rank == 0 && group == 0 && t == 0 && qi < lq)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
  T* op = o + b * so.b + h * so.h + c0;
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc) {
    if (pc >= mine) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      if (row >= lq) continue;
      T* p = op + row * so.l + kPiece * (first + pc) + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(p + 8 * n, acc[pc][4 * n + 2 * r] * inv[r],
               acc[pc][4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

template <typename T, int kSlice>
__global__ void __launch_bounds__(kThreadsCluster, 1)
    flash_fwd_cluster_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  T* __restrict__ o, float* __restrict__ lse,
                                  int heads, int width, int cluster, int lq,
                                  int lk, Strides so, int causal,
                                  float scale) {
  using P = ClusterPlan<T, kSlice>;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm;
  const uint32_t raw = smem_addr(smem);
  sm.qs = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned
  sm.ring = sm.qs + P::kQBytes;
  sm.xp = sm.ring + kStages * P::kSlotBytes;     // two S tiles
  sm.xb = sm.xp + 2 * P::kXBytes;                // two S tiles
  sm.xs = sm.xb + 2 * P::kXBytes;                // one S tile
  sm.full = sm.xs + P::kXBytes;                  // kStages barriers
  sm.empty = sm.full + 8 * kStages;              // kStages barriers
  sm.qbar = sm.empty + 8 * kStages;
  sm.data = smem + (sm.qs - raw);

  // the rank and the warpgroup as values the compiler knows to be uniform
  // across a warp: a wgmma under a branch on a value it cannot prove so is
  // serialized (ptxas C7520)
  const int rank = __shfl_sync(0xffffffffu, int(cluster_rank()), 0);
  const int group = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = int(blockIdx.x) / cluster * kQRows;  // the cluster's q tile
  const int c0 = rank * kSlice;
  const int live = imin(P::kPieces, (width - c0) / kPiece);
  const int kend = causal ? imin(lk, q0 + kQRows) : lk;
  const int tiles = (kend + P::kKeyTile - 1) / P::kKeyTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, kThreadsCluster);
    }
    mbar_init(sm.qbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  attend<T, P>(tq, tk, tv, o, lse, sm, rank, cluster, group, bh, b, h, q0, c0,
               live, lq, lk, tiles, so, causal, scale);
  // no block leaves while a peer may still read its exchange buffers
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Host: launch (the tensor maps are tensor_map.cuh's)
// ---------------------------------------------------------------------------

template <typename T, int kSlice>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int heads, int lq, int lk, int width,
                   int cluster, const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  using P = ClusterPlan<T, kSlice>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, P::kF32, width, lq, heads, batch, st[0],
                               st[1], st[2], kQRows);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, P::kF32, width, lk, heads, batch, st[3], st[4],
                     st[5], P::kKeyTile);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, P::kF32, width, lk, heads, batch, st[6], st[7],
                     st[8], P::kKeyTile);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_cluster_sm90_kernel<T, kSlice>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  // whether the card holds a cluster of this size, asked once per device
  static bool fits[kMaxDevices][kMaxCluster + 1] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(cluster * ((lq + kQRows - 1) / kQRows), batch * heads);
  return launch_cluster(kernel, grid, kThreadsCluster, P::kSmem, cluster,
                        dev < kMaxDevices ? &fits[dev][cluster] : nullptr,
                        stream, tq, tk, tv, static_cast<T*>(o), lse, heads,
                        width, cluster, lq, lk, Strides{st[9], st[10], st[11]},
                        causal, scale);
}

template <typename T>
cudaError_t launch_width(int width, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch,
                         int heads, int lq, int lk, const long long* st,
                         int causal, float scale, cudaStream_t s) {
  int cluster = 0, slice = 0;
  if (!cluster_shape(width, std::is_same<T, float>::value, cluster, slice))
    return cudaErrorInvalidValue;
#define SFX_SLICE(n)                                                         \
  case n:                                                                    \
    return launch<T, n>(q, k, v, o, lse, batch, heads, lq, lk, width, cluster, \
                        st, causal, scale, s);
  switch (slice) {
    SFX_SLICE(128) SFX_SLICE(192) SFX_SLICE(256) SFX_SLICE(320)
    SFX_SLICE(384) SFX_SLICE(448) SFX_SLICE(512)
    default: return cudaErrorInvalidValue;
  }
#undef SFX_SLICE
}

template <typename T, int kSlice>
void plan_of(int cluster, int* out) {
  using P = ClusterPlan<T, kSlice>;
  const int plan[8] = {cluster, kSlice, P::kKeyTile, kStages, kThreadsCluster,
                       int(P::kSmem), P::kBoxCols, P::kOpsPerPair};
  for (int i = 0; i < 8; ++i) out[i] = plan[i];
}

template <typename T>
int plan_width(int width, int* out) {
  int cluster = 0, slice = 0;
  if (!cluster_shape(width, std::is_same<T, float>::value, cluster, slice))
    return -1;
  switch (slice) {
    case 128: plan_of<T, 128>(cluster, out); return 0;
    case 192: plan_of<T, 192>(cluster, out); return 0;
    case 256: plan_of<T, 256>(cluster, out); return 0;
    case 320: plan_of<T, 320>(cluster, out); return 0;
    case 384: plan_of<T, 384>(cluster, out); return 0;
    case 448: plan_of<T, 448>(cluster, out); return 0;
    case 512: plan_of<T, 512>(cluster, out); return 0;
    default: return -1;
  }
}

}  // namespace

// As flash_fwd.cu's flash_fwd (the same arguments), at a head_dim that is
// a multiple of 64 from 576 to 4096: writes o and lse.  Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for another
// width or a tensor map TMA cannot take, cudaErrorInvalidConfiguration
// where the card cannot hold the cluster); the caller raises on anything
// else.
extern "C" int flash_fwd_cluster(int dtype, const void* q, const void* k,
                                 const void* v, void* o, float* lse, int batch,
                                 int heads, int lq, int lk, int head_dim,
                                 long long q_sb, long long q_sl, long long q_sh,
                                 long long k_sb, long long k_sl, long long k_sh,
                                 long long v_sb, long long v_sl, long long v_sh,
                                 long long o_sb, long long o_sl, long long o_sh,
                                 int causal, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_width<float>(
        head_dim, q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_width<__nv_bfloat16>(
        head_dim, q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of flash_fwd_cluster at (dtype, head_dim) into
// out[0..7]: blocks a cluster, columns a block (the slice), keys a tile,
// ring slots, threads a block, dynamic shared memory bytes, columns a TMA
// box, operations per (query, key) pair in units of the width (f32: tf32
// products).  Returns 0, or -1 for a width or dtype it does not take.
extern "C" int flash_fwd_cluster_plan(int dtype, int head_dim, int* out) {
  if (dtype == 0) return plan_width<float>(head_dim, out);
  if (dtype == 1) return plan_width<__nv_bfloat16>(head_dim, out);
  return -1;
}
