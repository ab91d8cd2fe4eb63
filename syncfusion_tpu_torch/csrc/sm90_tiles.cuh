// Helpers of the TMA-fed kernels (flash_fwd_wide_sm90.cu,
// flash_fwd_cluster_sm90.cu and flash_bwd_wide_sm90.cu) for their tiles:
// where TMA's 128-byte swizzle put an element, P or dS as hi + lo bf16
// operand pairs, and the forward kernels' f32 S and their P·V.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kPiece = 64;  // an output piece: one wgmma n64
constexpr int kQRows = 64;  // q rows a tile: one wgmma m64

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// Byte offset of element (r, c) of an R-row tile of W columns that TMA
// wrote as 128-byte boxes of R rows with the 128-byte swizzle: the 16-byte
// chunk index within a row XORed with r mod 8.
template <typename T, int R>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  constexpr int kBoxCols = 128 / sizeof(T);
  const uint32_t byte = (c % kBoxCols) * sizeof(T);
  return (c / kBoxCols) * (R * 128) + r * 128 +
         ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) as two bf16 pairs whose sum carries 16 bits of each value: hi is
// the rounded value, lo the rounded remainder.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---------------------------------------------------------------------------
// The forward kernels' products (flash_fwd_wide_sm90.cu and
// flash_fwd_cluster_sm90.cu), for a plan P with kKeyTile and kGroupPieces
// ---------------------------------------------------------------------------

// S (or a partial S) = q kᵀ over the pieces first .. first + mine - 1 of
// the contraction, for the 64 q rows and the key tile, in S's accumulator
// layout: s[j][e] for n-tile j (keys 8j ..) as sm90.cuh describes.  f32,
// one warp's 16 rows r0 ..: 3xTF32 on mma.sync, each 64-column piece a
// partial sum added in f32.  (bf16 on wgmma is each kernel's own: the
// wide one unrolls its fixed pieces, the cluster one loops over a range.)
template <class P>
__device__ __forceinline__ void scores(float (&s)[P::kKeyTile / 8][4],
                                       uint32_t, uint32_t,
                                       const unsigned char* qp,
                                       const unsigned char* kp,
                                       int first, int mine,
                                       std::true_type) {
  constexpr int kJ = P::kKeyTile / 8;
  const int tid = thread_index();  // offsets recomputed at each call
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((tid >> 5) & 3);
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int p = first; p < first + mine; ++p) {
    float part[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < 8; ++kk) {
      const int c = kPiece * p + 8 * kk + 2 * t;
      uint32_t ab[4], am[4];
      load2(reinterpret_cast<const float*>(qp + sw128<float, kQRows>(r0 + g, c)),
            ab[0], ab[2], am[0], am[2]);
      load2(reinterpret_cast<const float*>(qp + sw128<float, kQRows>(r0 + g + 8, c)),
            ab[1], ab[3], am[1], am[3]);
      uint32_t bb[kJ][2], bm[kJ][2];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        load2(reinterpret_cast<const float*>(
                  kp + sw128<float, P::kKeyTile>(8 * j + g, c)),
              bb[j][0], bb[j][1], bm[j][0], bm[j][1]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_1688_tf32(part[j], am, bb[j][0], bb[j][1]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_1688_tf32(part[j], ab, bm[j][0], bm[j][1]);
#pragma unroll
      for (int j = 0; j < kJ; ++j) mma_1688_tf32(part[j], ab, bb[j][0], bb[j][1]);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// ---------------------------------------------------------------------------
// O's pieces first .. first + mine - 1 (acc[0 ..]) += P V, P in S's
// accumulator layout, V the slot's tile.
// ---------------------------------------------------------------------------

// bf16: P as hi + lo bf16 A fragments from registers, V MN-major.
template <class P>
__device__ __forceinline__ void add_pv(float (&acc)[P::kGroupPieces][32],
                                       const float (&s)[P::kKeyTile / 8][4],
                                       uint32_t vs, const unsigned char*,
                                       int first, int mine, std::false_type) {
  constexpr int kK = P::kKeyTile / 16;
  uint32_t ph[kK][4], pl[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float(&s0)[4] = s[2 * kk];
    const float(&s1)[4] = s[2 * kk + 1];
    split_bf16(s0[0], s0[1], ph[kk][0], pl[kk][0]);
    split_bf16(s0[2], s0[3], ph[kk][1], pl[kk][1]);
    split_bf16(s1[0], s1[1], ph[kk][2], pl[kk][2]);
    split_bf16(s1[2], s1[3], ph[kk][3], pl[kk][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc) {
    if (pc < mine) {
      const uint32_t vp = vs + (first + pc) * P::kKvBox;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        // keys 16kk .. 16kk + 15: two groups of 8 rows, 1024 bytes apart
        const uint64_t db = sw128_desc(vp + kk * 16 * 128, P::kKvBox, 1024);
        wgmma_64x64x16_rs_mn(acc[pc], ph[kk], db);
        wgmma_64x64x16_rs_mn(acc[pc], pl[kk], db);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[pc][i]);
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fence_operand(ph[kk][i]);
      fence_operand(pl[kk][i]);
    }
}

// f32: 3xTF32 on mma.sync, P's n-tile j fed as the A fragment of k-step j
// in tf32_mma.cuh's permuted k order (a_from_c), V read in the matching
// rows; each 32-column pass a partial sum added in f32.
template <class P>
__device__ __forceinline__ void add_pv(float (&acc)[P::kGroupPieces][32],
                                       const float (&s)[P::kKeyTile / 8][4],
                                       uint32_t, const unsigned char* vp,
                                       int first, int mine, std::true_type) {
  constexpr int kJ = P::kKeyTile / 8;
  const int lane = thread_index() & 31;  // offsets recomputed at each call
  const int g = lane >> 2, t = lane & 3;
  const int h = t >> 1;
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc) {
    if (pc >= mine) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // no load of this pass hoisted into the one before: the fragments of
      // one pass at a time beside O's registers
      asm volatile("" ::: "memory");
      float part[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        asm volatile("" ::: "memory");  // nor a k-step's into the one before
        uint32_t ab[4], am[4];
        a_from_c(s[j], t, ab, am);
        uint32_t bb[4][2], bm[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = kPiece * (first + pc) + 8 * (4 * half + u) + g;
          load1(reinterpret_cast<const float*>(
                    vp + sw128<float, P::kKeyTile>(8 * j + 2 * t + h, col)),
                bb[u][0], bm[u][0]);
          load1(reinterpret_cast<const float*>(
                    vp + sw128<float, P::kKeyTile>(8 * j + 2 * t + 1 - h, col)),
                bb[u][1], bm[u][1]);
        }
        mma3_x4<true, true>(
            [&](int u) -> float(&)[4] { return part[u]; },
            [&](int) -> const uint32_t(&)[4] { return ab; },
            [&](int) -> const uint32_t(&)[4] { return am; }, bb, bm);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pc][4 * (4 * half + u) + e] += part[u][e];
    }
  }
}

}  // namespace
