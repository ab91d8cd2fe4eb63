// f32-accurate products on the tensor cores (3xTF32), shared by the
// kernels that take f32 operands: the flash-attention kernels K1's f32
// forward (flash_fwd.cu) and K2a/K2b (flash_bwd.cu), and the fused resnet
// kernel's f32 body (fused_resblock.cu), which takes `round_tf32` and
// `split` and lays out its own tiles.
//
// Every product runs on `mma.sync.m16n8k8` with tf32 operands and an f32
// accumulator; in the attention kernels 4 warps a block, 16 rows (one m16
// tile) a warp, over shared tiles of 64 rows of kD columns, the head width
// (a template parameter of the helpers below past `split`: 64, or 128 for
// heads of 65-128 features; a narrower head is zero-padded to 64 by the
// wrapper).  TF32 keeps 10 of f32's 23 mantissa
// bits, which alone misses the f32 gates by 4-9x, so an f32 operand x
// enters as two tf32 values, big = x rounded and small = x - big, and a
// product a·b as small·big + big·small + big·big, small terms first.  bf16
// operands are exact in tf32 and have no small part.  The mma of a step
// are issued pass by pass over four independent accumulators, and a
// product's terms over one 64-row tile go to a partial sum that is added to
// the running one in f32: the tensor cores truncate the sums they
// accumulate, so a chain over all 2048 keys drifts (on an H100 at T = 2048:
// 2.6e-5 of max |dq|, against 4.8e-6 with the partial sums; PERF.md §6).
//
// Fragments without transposes or shuffles: a product's sum over k may run
// in any order, so the k index of every mma is permuted, the same way in A
// and B.  Where A and B both come from shared tiles whose rows are the M or
// N index (S = q kᵀ), lane (g, t) takes columns 2t and 2t + 1 of its row as
// k = t and k = t + 4: one 8-byte load (f32) or 4-byte load (bf16).  Where
// A is the C registers of a finished product (P for P·V, dS for dS·K), lane
// (g, t) already holds columns 2t and 2t + 1 of rows g and g + 8; it feeds
// them as k = t and k = t + 4 in the order (2t + h, 2t + 1 - h), h = t / 2,
// and B reads the matching tile rows.  That order spreads the four lanes of
// a quad over four rows whose shared-memory banks differ, so every fragment
// load is free of bank conflicts at a row pitch of kD + 8 elements (f32 and
// bf16 alike, at kD = 64 and 128: the pitch is 8 banks mod 32 in f32 and 4
// in bf16 either way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;   // rows of every tile: q rows and keys alike
constexpr int kWarps = 4;   // 16 rows, one m16 tile, a warp
constexpr int kThreads = 32 * kWarps;
// Row pitch of the shared tiles of kD columns, in elements, f32 and bf16
// alike: with 8 elements of padding every fragment load below hits 32
// distinct banks.
__host__ __device__ constexpr int tile_pitch(int kd) { return kd + 8; }
__host__ __device__ constexpr int tile_elems(int kd) {
  return kTile * tile_pitch(kd);
}
// Blocks of `smem` bytes of shared memory that fit on one SM (228 KB, of
// which the system takes 1 KB a block), capped at 2: the kernels' minimum
// for __launch_bounds__.
__host__ __device__ constexpr int blocks_per_sm(size_t smem) {
  return 2 * (smem + 1024) <= 233472 ? 2 : 1;
}
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, l, h;  // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
template <int kD, typename T>
__device__ __forceinline__ void a_rows(const T* tile, int r0, int kk, int g,
                                       int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  constexpr int kP = tile_pitch(kD);
  load2(tile + (r0 + g) * kP + 8 * kk + 2 * t, big[0], big[2], small[0],
        small[2]);
  load2(tile + (r0 + g + 8) * kP + 8 * kk + 2 * t, big[1], big[3], small[1],
        small[3]);
}

// B of k-step kk, n-tile j, from a shared tile whose rows are the n index
// (the product with the tile transposed): row 8j + g, columns as a_rows.
template <int kD, typename T>
__device__ __forceinline__ void b_rows(const T* tile, int j, int kk, int g,
                                       int t, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  constexpr int kP = tile_pitch(kD);
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
template <int kD, typename T>
__device__ __forceinline__ void b_cols(const T* tile, int j, int n, int g,
                                       int t, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  constexpr int kP = tile_pitch(kD);
  const int h = t >> 1;
  load1(tile + (8 * j + 2 * t + h) * kP + 8 * n + g, big[0], small[0]);
  load1(tile + (8 * j + 2 * t + 1 - h) * kP + 8 * n + g, big[1], small[1]);
}

// sd[i] = a[i]·b[i]ᵀ for kN = 1 or 2 products of one 16-row m16 tile (8
// n-tiles of 8 rows of the shared tiles b[i] each), by kD / 8 k-steps over
// D: A from rows r0 .. r0 + 15 of shared tiles a[i], four n-tiles at a time
// (two of each product when kN = 2).
template <int kD, int kN, bool kSplit, typename T>
__device__ __forceinline__ void scores(float (&sd)[kN][8][4],
                                       const T* const (&a)[kN],
                                       const T* const (&b)[kN], int r0, int g,
                                       int t) {
  constexpr int kPer = 4 / kN;  // n-tiles of one product per mma3_x4
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sd[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    uint32_t ab[kN][4], am[kN][4];
#pragma unroll
    for (int i = 0; i < kN; ++i) a_rows<kD>(a[i], r0, kk, g, t, ab[i], am[i]);
#pragma unroll
    for (int jp = 0; jp < 8; jp += kPer) {
      uint32_t bb[4][2], bm[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        b_rows<kD>(b[u / kPer], jp + u % kPer, kk, g, t, bb[u], bm[u]);
      mma3_x4<kSplit, kSplit>(
          [&](int u) -> float(&)[4] { return sd[u / kPer][jp + u % kPer]; },
          [&](int u) -> const uint32_t(&)[4] { return ab[u / kPer]; },
          [&](int u) -> const uint32_t(&)[4] { return am[u / kPer]; }, bb, bm);
    }
  }
}

// acc += c·tile for one m16 tile: c the C registers of a finished product
// (8 n-tiles of 8 of the tile's rows), the tile's rows the k index, its kD
// columns the n index, taken in passes of 64 columns (one at kD = 64, two
// at 128: the partial sum of a pass holds 32 registers, not 64).  The
// products of a pass go to a partial sum that starts at 0 and is added to
// acc in f32: the tensor cores truncate the sums they accumulate, and a
// chain over every key of a long sequence drifts.
template <int kD, bool kSplit, typename T>
__device__ __forceinline__ void product_cb(float (&acc)[kD / 8][4],
                                           const float (&c)[8][4],
                                           const T* tile, int g, int t) {
#pragma unroll
  for (int n0 = 0; n0 < kD / 8; n0 += 8) {
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
        for (int u = 0; u < 4; ++u)
          b_cols<kD>(tile, j, n0 + np + u, g, t, bb[u], bm[u]);
        mma3_x4<true, kSplit>(
            [&](int u) -> float(&)[4] { return part[np + u]; },
            [&](int) -> const uint32_t(&)[4] { return ab; },
            [&](int) -> const uint32_t(&)[4] { return am; }, bb, bm);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cp.async rows row0 .. row0 + 63 of one (batch, head) slice of kD
// columns, row r at src + r·ld, into a tile of pitch kD + 8, by the block's
// threads; rows at or past `limit` are zero-filled.
template <int kD, typename T>
__device__ __forceinline__ void cp_tile(T* tile, const T* src, long long ld,
                                        int row0, int limit, int tid) {
  constexpr int kP = tile_pitch(kD);
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

// Let a kernel take `bytes` of dynamic shared memory, and ask for the
// largest carveout: two blocks of ~100 KB (f32 tiles at kD = 64) share an
// SM, one of ~210 KB (K2's f32 tiles at kD = 128) fills it.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// set_smem once per device for the launcher whose own static `done` it
// is given: each attribute call is a driver round trip, and a launch at the
// UNet's short levels takes tens of microseconds.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t set_smem_once(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = set_smem(kernel, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace
