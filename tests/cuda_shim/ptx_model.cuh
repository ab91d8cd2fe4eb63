// CPU models of the ptx.cuh instructions that flash_fwd_wide_sm90.cu
// reaches (through tf32_mma.cuh): cp.async copies at once, mma.sync
// m16n8k8 tf32, ex2.
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

namespace {

inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
inline void cp_async_16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async_4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N> inline void cp_async_wait() {}
// m16n8k8 tf32: lane (g, t) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b at (t, g), (t + 4, g); d at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).  Operands read with their low 13 bits
// dropped, the sum in double.
inline void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                          uint32_t b1) {
  ShimWarp& w = shim_warp();
  const int lane = threadIdx.x & 31;
  w.p[lane][0] = a;
  w.x[lane] = (uint64_t(b1) << 32) | b0;
  w.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double sum = d[i];
    for (int k = 0; k < 8; ++k) {
      const uint32_t* al = static_cast<const uint32_t*>(w.p[4 * (row % 8) + k % 4][0]);
      const uint32_t av = al[row / 8 + 2 * (k / 4)];
      const uint64_t bw = w.x[4 * col + k % 4];
      const uint32_t bv = k / 4 ? uint32_t(bw >> 32) : uint32_t(bw);
      sum += double(__uint_as_float(av & 0xffffe000u)) *
             double(__uint_as_float(bv & 0xffffe000u));
    }
    out[i] = float(sum);
  }
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

inline float ex2(float x) { return exp2f(x); }

}  // namespace
