// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the TPU kernels of syncfusion_tpu/ops/attention.py that `_flash_bwd`
// launches through `pl.pallas_call`:
//   flash_bwd_dq   <- `_flash_bwd_dq_kernel` (K2a), together with the XLA
//                     reduction delta = rowsum(dO∘O) that precedes it there
//                     (fused into this kernel's prologue and written out for
//                     flash_bwd_dkv);
//   flash_bwd_dkv  <- `_flash_bwd_dkv_kernel` (K2b).
// They compute the same function, by recompute from the forward's row
// logsumexp: s = scale · q kᵀ, p = exp(s - lse), dp = dO vᵀ,
// ds = p∘(dp - delta), and then dQ = scale · ds k, dK = scale · dsᵀ q,
// dV = pᵀ dO, under the forward's optional causal (top-left aligned) mask.
//
// What bounds it on this card: the backward as a function needs five
// products of 2·D operations per (query, key) pair (S, dP, dV, dK, dQ), so
// 10·D·T² operations per (batch, head), against q, k, v, o and dO read once
// and dq, dk and dv written once: 8·T·D elements.  In f32 that is 0.31·T
// operations per byte.  f32-accurate products run on the tensor cores as
// 3xTF32 (below) at a third of the 495 TFLOP/s TF32 rate, 165 TFLOP/s; over
// 3.35 TB/s that is a ridge of 49, below 0.31·T at every T the UNet has
// (256-2048): bound by operations.
//
// The two-kernel design does 14·D operations per pair, not 10·D: S and dP
// are computed in both kernels.  That is the price of the rule that each
// block owns its output rows: a flash_bwd_dq block owns a 64-row q tile and
// loops over all K/V tiles; a flash_bwd_dkv block owns a 64-key tile and
// loops over all q tiles.  No atomics, so the result is bitwise the same
// from run to run, and nothing of O(T²) ever reaches device memory: S, P,
// dP and dS live in registers only.
//
// Products: every one runs on `mma.sync.m16n8k8` with tf32 operands and an
// f32 accumulator, 4 warps a block, 16 rows (one m16 tile) a warp.  TF32
// keeps 10 of f32's 23 mantissa bits, which alone misses the f32 gates by
// 4-9x, so an f32 operand x enters as two tf32 values, big = x rounded and
// small = x - big (3xTF32), and a product a·b as small·big + big·small +
// big·big, small terms first.  bf16 inputs (q, k, v, dO) are exact in tf32
// and have no small part; P and dS are f32 in both instantiations and
// always split.  One body per kernel serves both input types.  The mma of a
// step are issued pass by pass over four independent accumulators, and a
// product's terms over one 64-row tile go to a partial sum that is added
// to the running one in f32: the tensor cores truncate the sums they
// accumulate, so a chain over all 2048 keys drifts (on an H100 at T = 2048:
// 2.6e-5 of max |dq|, against 4.8e-6 with the partial sums; PERF.md §6).
//
// Fragments without transposes or shuffles: a product's sum over k may run
// in any order, so the k index of every mma is permuted, the same way in A
// and B.  Where A and B both come from shared tiles whose rows are the M or
// N index (S, dP; Sᵀ, dPᵀ), lane (g, t) takes columns 2t and 2t + 1 of its
// row as k = t and k = t + 4: one 8-byte load (f32) or 4-byte load (bf16).
// Where A is the C registers of a finished product (dS for dQ; Pᵀ and dSᵀ
// for dV and dK, whose keys are the M index, so no O(tile²) transpose is
// needed), lane (g, t) already holds columns 2t and 2t + 1 of rows g and
// g + 8; it feeds them as k = t and k = t + 4 in the order (2t + h,
// 2t + 1 - h), h = t / 2, and B reads the matching tile rows.  That order
// spreads the four lanes of a quad over four rows whose shared-memory banks
// differ, so every fragment load is free of bank conflicts at a row pitch
// of 72 elements (f32 and bf16 alike).
//
// Tiles arrive by 16-byte `cp.async` copies: the resident tiles (q and dO
// in flash_bwd_dq, K and V in flash_bwd_dkv) once, the streamed ones (K/V;
// q/dO with their lse and delta slices) in a ring of two stages, so the
// next tile's load overlaps this tile's products.  The operands therefore
// need 16-byte aligned addresses and B, L and H strides in multiples of 16
// bytes; the wrapper checks this and raises otherwise.
//
// Layout: q, k, v, o, dO and the outputs are (B, L, H, 64) with any such
// element strides for B, L and H and a contiguous head dim (q, k, v may be
// views of one qkv projection); lse and delta are contiguous (B, H, Lq) f32
// arrays.  A ragged sequence tail is masked in the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kD = 64;      // head dim
constexpr int kTile = 64;   // rows of every tile: q rows and keys alike
constexpr int kWarps = 4;   // 16 rows, one m16 tile, a warp
constexpr int kThreads = 32 * kWarps;
// Row pitch of the shared tiles, in elements, f32 and bf16 alike: with 8
// elements of padding every fragment load below hits 32 distinct banks.
constexpr int kP = kD + 8;
constexpr int kTileElems = kTile * kP;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, l, h;  // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// PTX, each instruction in its own small function
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a·b, a 16x8 (row), b 8x8 (col), tf32 in, f32 accumulate.  Lane
// (g, t) = (lane / 4, lane % 4) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b at (t, g), (t + 4, g); d at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// 3xTF32 operands and products
// ---------------------------------------------------------------------------

// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite x, in two integer operations (that
// instruction compiles to a dozen, with checks for NaN and inf).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big = x rounded to tf32 and small = x - big, exact in f32.  The
// tensor cores read the top 19 bits of a tf32 operand, so small enters
// truncated to tf32, as CUTLASS's OpMultiplyAddFastF32 feeds it: rounding
// it first would move the product by less than 2^-21 of |x·y| and cost two
// more operations a value.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = round_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// Elements p[0] and p[1] of a shared tile as the tf32 parts of two operand
// registers.  f32 is split; bf16 is exact in tf32 (its bits shifted into
// the high half) and has no small part.
__device__ __forceinline__ void load2(const float* p, uint32_t& b0,
                                      uint32_t& b1, uint32_t& s0,
                                      uint32_t& s1) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split(x.x, b0, s0);
  split(x.y, b1, s1);
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, uint32_t& b0,
                                      uint32_t& b1, uint32_t&, uint32_t&) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  b0 = w << 16;
  b1 = w & 0xffff0000u;
}
__device__ __forceinline__ void load1(const float* p, uint32_t& b,
                                      uint32_t& s) {
  split(*p, b, s);
}
__device__ __forceinline__ void load1(const __nv_bfloat16* p, uint32_t& b,
                                      uint32_t&) {
  b = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

// Four products in 3xTF32, d(u) += a(u)·b(u) for u < 4, each as small·big +
// big·small + big·big, pass by pass (every small·big, then every big·small,
// then every big·big), so that no mma waits on the one before it.  An
// operand exact in tf32 (kSa or kSb false) has no small term.  d(u) names
// the accumulator, ab(u) and am(u) the big and small parts of A; bb and bm
// hold B's.
template <bool kSa, bool kSb, typename D, typename A, typename M>
__device__ __forceinline__ void mma3_x4(D d, A ab, M am,
                                        const uint32_t (&bb)[4][2],
                                        const uint32_t (&bm)[4][2]) {
  if constexpr (kSa) {
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_1688_tf32(d(u), am(u), bb[u][0], bb[u][1]);
  }
  if constexpr (kSb) {
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_1688_tf32(d(u), ab(u), bm[u][0], bm[u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_1688_tf32(d(u), ab(u), bb[u][0], bb[u][1]);
}

// A of k-step kk from rows r0 + g and r0 + g + 8 of a shared tile whose
// columns are the k index: columns 8kk + 2t and 8kk + 2t + 1 as k = t and
// k = t + 4.
template <typename T>
__device__ __forceinline__ void a_rows(const T* tile, int r0, int kk, int g,
                                       int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  load2(tile + (r0 + g) * kP + 8 * kk + 2 * t, big[0], big[2], small[0],
        small[2]);
  load2(tile + (r0 + g + 8) * kP + 8 * kk + 2 * t, big[1], big[3], small[1],
        small[3]);
}

// B of k-step kk, n-tile j, from a shared tile whose rows are the n index
// (the product with the tile transposed): row 8j + g, columns as a_rows.
template <typename T>
__device__ __forceinline__ void b_rows(const T* tile, int j, int kk, int g,
                                       int t, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  load2(tile + (8 * j + g) * kP + 8 * kk + 2 * t, big[0], big[1], small[0],
        small[1]);
}

// A of k-step j from the C registers c of n-tile j of a finished product:
// columns 2t + h and 2t + 1 - h (h = t / 2) of rows g and g + 8, as k = t
// and k = t + 4.
__device__ __forceinline__ void a_from_c(const float (&c)[4], int t,
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  const bool h = t >> 1;
  split(h ? c[1] : c[0], big[0], small[0]);
  split(h ? c[3] : c[2], big[1], small[1]);
  split(h ? c[0] : c[1], big[2], small[2]);
  split(h ? c[2] : c[3], big[3], small[3]);
}

// B of k-step j, n-tile n, from a shared tile whose rows are the k index,
// in a_from_c's order: rows 8j + 2t + h and 8j + 2t + 1 - h, column 8n + g.
template <typename T>
__device__ __forceinline__ void b_cols(const T* tile, int j, int n, int g,
                                       int t, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  const int h = t >> 1;
  load1(tile + (8 * j + 2 * t + h) * kP + 8 * n + g, big[0], small[0]);
  load1(tile + (8 * j + 2 * t + 1 - h) * kP + 8 * n + g, big[1], small[1]);
}

// S = a·tile0ᵀ and dP = a'·tile1ᵀ for one 16-row m16 tile (sd[0], sd[1]; 8
// n-tiles of 8 rows of the shared tiles each), by 8 k-steps over D: A from
// rows r0 .. r0 + 15 of shared tiles a0 and a1, B from tiles b0 and b1, two
// n-tiles of each product at a time.
template <bool kSplit, typename T>
__device__ __forceinline__ void scores(float (&sd)[2][8][4], const T* a0,
                                       const T* a1, const T* b0, const T* b1,
                                       int r0, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sd[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[2][4], am[2][4];
    a_rows(a0, r0, kk, g, t, ab[0], am[0]);
    a_rows(a1, r0, kk, g, t, ab[1], am[1]);
#pragma unroll
    for (int jp = 0; jp < 8; jp += 2) {
      uint32_t bb[4][2], bm[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        b_rows(u < 2 ? b0 : b1, jp + (u & 1), kk, g, t, bb[u], bm[u]);
      mma3_x4<kSplit, kSplit>(
          [&](int u) -> float(&)[4] { return sd[u >> 1][jp + (u & 1)]; },
          [&](int u) -> const uint32_t(&)[4] { return ab[u >> 1]; },
          [&](int u) -> const uint32_t(&)[4] { return am[u >> 1]; }, bb, bm);
    }
  }
}

// acc += c·tile for one m16 tile: c the C registers of a finished product
// (8 n-tiles of 8 of the tile's rows), the tile's rows the k index, its 64
// columns the n index.  The products of this call go to a partial sum that
// starts at 0 and is added to acc in f32: the tensor cores truncate the sums
// they accumulate, and a chain over every key of a long sequence drifts.
template <bool kSplit, typename T>
__device__ __forceinline__ void product_cb(float (&acc)[8][4],
                                           const float (&c)[8][4],
                                           const T* tile, int g, int t) {
  float part[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ab[4], am[4];
    a_from_c(c[j], t, ab, am);
#pragma unroll
    for (int np = 0; np < 8; np += 4) {
      uint32_t bb[4][2], bm[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) b_cols(tile, j, np + u, g, t, bb[u], bm[u]);
      mma3_x4<true, kSplit>(
          [&](int u) -> float(&)[4] { return part[np + u]; },
          [&](int) -> const uint32_t(&)[4] { return ab; },
          [&](int) -> const uint32_t(&)[4] { return am; }, bb, bm);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cp.async rows row0 .. row0 + 63 of one (batch, head) slice, row r at
// src + r·ld, into a tile of pitch kP, by the block's threads; rows at or
// past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* src, long long ld,
                                          int row0, int limit, int tid) {
  constexpr int kPer = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int kChunks = kD / kPer;     // chunks a row
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async_16(tile + r * kP + c * kPer,
                in ? src + (row0 + r) * ld + c * kPer : src, in);
  }
}

// cp.async src[row0 .. row0 + 63] into dst, by threads 0-63 (i = their
// index); entries at or past `limit` are zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int limit, int i) {
  const bool in = row0 + i < limit;
  cp_async_4(dst + i, in ? src + row0 + i : src, in);
}

// Shared memory of flash_bwd_dq: q, dO, then the ring of K/V tiles (two
// stages of K and V), then lse·log2(e) and delta of the q rows.
template <typename T>
constexpr size_t dq_smem() {
  return 6 * kTileElems * sizeof(T) + 2 * kTile * sizeof(float);
}
// Shared memory of flash_bwd_dkv: K, V, the ring of q/dO tiles (two stages
// of q and dO), then per stage the lse and delta slices.
template <typename T>
constexpr size_t dkv_smem() {
  return 6 * kTileElems * sizeof(T) + 4 * kTile * sizeof(float);
}

// One block: one 64-row q tile of one (batch, head); loops over K/V tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int heads,
                    int lq, int lk, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, int causal,
                    float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;  // inputs need a split
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kTileElems;
  T* ring = dos + kTileElems;  // stage s: K at ring + 2s·kTileElems, then V
  float* lse_s = reinterpret_cast<float*>(ring + 4 * kTileElems);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5);  // the warp's first row in the tile
  const int q0 = blockIdx.x * kTile;

  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  int tiles = (lk + kTile - 1) / kTile;
  // keys after the tile's last q row are masked for every row of it
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);

  // q, dO, O (in stage 1's K slot, free until tile 1 is loaded) and the
  // first K/V tile, one group
  T* os = ring + 2 * kTileElems;
  load_tile(qs, q + b * sq.b + h * sq.h, sq.l, q0, lq, tid);
  load_tile(dos, dout + b * sdo.b + h * sdo.h, sdo.l, q0, lq, tid);
  load_tile(os, o + b * so.b + h * so.h, so.l, q0, lq, tid);
  if (tiles > 0) {
    load_tile(ring, kp, sk.l, 0, lk, tid);
    load_tile(ring + kTileElems, vp, sv.l, 0, lk, tid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (tid < kTile) {
    const int qi = q0 + tid;
    float dsum = 0.f;
#pragma unroll 8
    for (int c = 0; c < kD; ++c) {
      dsum = fmaf(to_float(dos[tid * kP + c]), to_float(os[tid * kP + c]),
                  dsum);
    }
    float l = 0.f;
    if (qi < lq) {
      l = lse[(long long)bh * lq + qi];
      delta[(long long)bh * lq + qi] = dsum;
    }
    lse_s[tid] = l * kLog2e;
    delta_s[tid] = dsum;
  }
  __syncthreads();
  // rows g and g + 8 of the warp's m16 tile
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse_s[r0 + g + 8 * r];
    dl[r] = delta_s[r0 + g + 8 * r];
  }

  const float sl = scale * kLog2e;
  float acc[8][4];  // dQ: 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    if (it > 0) {
      // tile it has landed, and every warp is done with tile it - 1, whose
      // stage the next load overwrites
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < tiles) {
      T* next = ring + ((it + 1) & 1) * 2 * kTileElems;
      load_tile(next, kp, sk.l, k0 + kTile, lk, tid);
      load_tile(next + kTileElems, vp, sv.l, k0 + kTile, lk, tid);
      cp_async_commit();
    }
    const T* ks = ring + (it & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;

    // S = q Kᵀ and dP = dO Vᵀ: 8 k-steps over D, 8 n-tiles of 8 keys
    float sd[2][8][4];
    scores<kF32>(sd, qs, dos, ks, vs, r0, g, t);

    // dS = P∘(dP - delta), P = 2^(S·scale·log2 e - lse·log2 e); masked
    // pairs (a q row or key past the end, a key after its query under the
    // causal mask) get dS = 0
    const bool edge = k0 + kTile > lk || q0 + kTile > lq ||
                      (causal && k0 + kTile - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(sd[0][j][e], sl, -lse2[r]));
        if (edge) {
          const int qi = q0 + r0 + g + 8 * r;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (qi >= lq || kj >= lk || (causal && kj > qi)) p = 0.f;
        }
        sd[1][j][e] = p * (sd[1][j][e] - dl[r]);
      }
    }

    // dQ += dS K: 8 k-steps over the tile's keys, 8 n-tiles over D
    product_cb<kF32>(acc, sd[1], ks, g, t);
  }

  T* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= lq) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(dqp + (long long)qi * sdq.l + 8 * n + 2 * t,
             acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// One block: one 64-key tile of one (batch, head); loops over q tiles.
// Keys are the M index of every product: Sᵀ = K qᵀ and dPᵀ = V dOᵀ leave
// Pᵀ and dSᵀ in C registers with keys as rows, which is A of dV = Pᵀ dO and
// dK = dSᵀ q; lse and delta are indexed by column.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int lq, int lk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, int causal, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTileElems;
  T* ring = vs + kTileElems;  // stage s: q at ring + 2s·kTileElems, then dO
  float* vecs = reinterpret_cast<float*>(ring + 4 * kTileElems);  // [s][lse|delta]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5);  // the warp's first key in the tile
  const int k0 = blockIdx.x * kTile;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* dop = dout + b * sdo.b + h * sdo.h;
  const float* lsep = lse + (long long)bh * lq;
  const float* deltap = delta + (long long)bh * lq;
  const int q_tiles = (lq + kTile - 1) / kTile;
  // q rows before the tile's first key see none of its keys
  const int first = causal ? (int)blockIdx.x : 0;

  auto load_q_tile = [&](int it) {
    const int s = (it - first) & 1;
    const int q0 = it * kTile;
    T* stage = ring + s * 2 * kTileElems;
    load_tile(stage, qp, sq.l, q0, lq, tid);
    load_tile(stage + kTileElems, dop, sdo.l, q0, lq, tid);
    if (tid < kTile) {
      load_vec(vecs + s * 2 * kTile, lsep, q0, lq, tid);
    } else {
      load_vec(vecs + s * 2 * kTile + kTile, deltap, q0, lq, tid - kTile);
    }
  };

  // K, V and the first q/dO tile, one group
  load_tile(ks, k + b * sk.b + h * sk.h, sk.l, k0, lk, tid);
  load_tile(vs, v + b * sv.b + h * sv.h, sv.l, k0, lk, tid);
  if (first < q_tiles) load_q_tile(first);
  cp_async_commit();

  const float sl = scale * kLog2e;
  float dk_acc[8][4], dv_acc[8][4];  // 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = first; it < q_tiles; ++it) {
    const int q0 = it * kTile;
    // tile it has landed, and every warp is done with the previous tile,
    // whose stage the next load overwrites
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < q_tiles) {
      load_q_tile(it + 1);
      cp_async_commit();
    }
    const int s_ = (it - first) & 1;
    const T* qs = ring + s_ * 2 * kTileElems;
    const T* dos = qs + kTileElems;
    const float* lse_s = vecs + s_ * 2 * kTile;
    const float* delta_s = lse_s + kTile;

    // Sᵀ = K qᵀ and dPᵀ = V dOᵀ: 8 k-steps over D, 8 n-tiles of 8 queries
    float sd[2][8][4];
    scores<kF32>(sd, ks, vs, qs, dos, r0, g, t);

    // Pᵀ and dSᵀ; column 8j + 2t + (e & 1) is the query, row g + 8(e >> 1)
    // the key
    const bool edge = q0 + kTile > lq || k0 + kTile > lk ||
                      (causal && k0 + r0 + 15 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq_e = (e & 1) ? l2.y : l2.x;
        const float dl_e = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(sd[0][j][e], sl, -lq_e * kLog2e));
        if (edge) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          const int kj = k0 + r0 + g + 8 * (e >> 1);
          if (qi >= lq || kj >= lk || (causal && kj > qi)) p = 0.f;
        }
        sd[0][j][e] = p;
        sd[1][j][e] = p * (sd[1][j][e] - dl_e);
      }
    }

    // dV += Pᵀ dO, then dK += dSᵀ q: 8 k-steps over the tile's queries, 8
    // n-tiles over D
    product_cb<kF32>(dv_acc, sd[0], dos, g, t);
    product_cb<kF32>(dk_acc, sd[1], qs, g, t);
  }
  cp_async_wait_all();  // nothing in flight (K/V only if no q tile ran)

  T* dkp = dk + b * sdk.b + h * sdk.h;
  T* dvp = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + g + 8 * r;
    if (kj >= lk) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(dkp + (long long)kj * sdk.l + 8 * n + 2 * t,
             dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      store2(dvp + (long long)kj * sdv.l + 8 * n + 2 * t, dv_acc[n][2 * r],
             dv_acc[n][2 * r + 1]);
    }
  }
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// Two blocks of 111 KB (f32) share an SM: ask for the largest carveout.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T>;
  constexpr size_t smem = dq_smem<T>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), heads, lq,
      lk, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int heads, int lq,
                       int lk, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T>;
  constexpr size_t smem = dkv_smem<T>();
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), heads, lq, lk,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `strides` holds the (b, l, h) element
// strides of q, k, v, o, dout, dq in that order (18 values).  Writes dq and
// delta = rowsum(dout∘o).  Returns the launch's cudaError_t (0 on success);
// the caller raises on anything else.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            int batch, int heads, int lq, int lk,
                            const long long* strides, int causal, float scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_dq<float>(q, k, v, o, dout, lse, delta, dq,
                                             batch, heads, lq, lk, strides,
                                             causal, scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dq<__nv_bfloat16>(
        q, k, v, o, dout, lse, delta, dq, batch, heads, lq, lk, strides,
        causal, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above.  `strides` holds the (b, l, h) element strides of q, k, v,
// dout, dk, dv in that order (18 values); delta is flash_bwd_dq's.
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int batch,
                             int heads, int lq, int lk,
                             const long long* strides, int causal,
                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_dkv<float>(q, k, v, dout, lse, delta, dk,
                                              dv, batch, heads, lq, lk,
                                              strides, causal, scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_dkv<__nv_bfloat16>(
        q, k, v, dout, lse, delta, dk, dv, batch, heads, lq, lk, strides,
        causal, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory in bytes that each launch of flash_bwd_dq
// (kernel 0) or flash_bwd_dkv (kernel 1) asks for, dtype as above; -1 for
// an unknown kernel or dtype.
extern "C" int flash_bwd_smem(int kernel, int dtype) {
  if (kernel == 0 && dtype == 0) return static_cast<int>(dq_smem<float>());
  if (kernel == 0 && dtype == 1) return static_cast<int>(dq_smem<__nv_bfloat16>());
  if (kernel == 1 && dtype == 0) return static_cast<int>(dkv_smem<float>());
  if (kernel == 1 && dtype == 1) return static_cast<int>(dkv_smem<__nv_bfloat16>());
  return -1;
}
