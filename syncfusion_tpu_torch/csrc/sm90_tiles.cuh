// Helpers of the TMA-fed kernels (flash_fwd_wide_sm90.cu and
// flash_bwd_wide_sm90.cu) for their tiles: where TMA's 128-byte swizzle put
// an element, and P or dS as hi + lo bf16 operand pairs.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

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

}  // namespace
