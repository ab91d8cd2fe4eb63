// Fused GroupNorm/FiLM/SiLU -> conv1d(k3) of the diffusion UNet's resnet
// chain, for sm_90a: y = conv1d_k3(silu(x*scale + shift)) + bias, with an
// optional residual and the per-(batch, channel-segment) sums of y and y^2.
//
// Replaces three TPU kernels of syncfusion_tpu/ops/fused_resblock.py:
//   * K3a `_make_kernel` (halo DMA) and K3b `_block_local_kernel` (block-local
//     conv plus an XLA boundary fix): both compute the same function; the
//     block-local scheme exists only because Mosaic rejected the halo DMA.
//     Here one kernel loads its own halo rows (RESIDUAL = STATS = false).
//   * K4 `_stats_kernel_factory`: the same op plus a residual and the
//     group sums of the f32 output, so the next GroupNorm never re-reads it
//     (STATS = true, RESIDUAL either way).
//
// What bounds it: bytes, as a function.  x is read once (plus 2 halo rows
// per 128-position tile, and once per 64-channel output tile), y written
// once; the normalised and activated input never reaches device memory.
// A conv of 3·C·Cout multiply-adds per position on bf16 data is far below
// the tensor cores' rate for its 2·(C + Cout) bytes.  This kernel does its
// multiply-adds on the f32 FMA units (33.5 T/s), which take longer than the
// bytes do once C·Cout passes ~30 (every shape but the 8-channel level): as
// written it is bounded by f32 FMAs and shared-memory loads, and
// tensor-core products are its next step.
//
// Design (a simple kernel, FMA math in f32; no wgmma, no TMA):
//   * a block owns one batch row, TL = 128 positions and TCO (8-64)
//     output channels; 256 threads = 32 position lanes x 8 channel groups,
//     each thread a 4-position x TCO/8-channel register tile (positions
//     lane + 32 i, so a warp reads consecutive shared-memory words);
//   * input channels go in chunks of CK = 16: the chunk's TL + 2 rows
//     (one halo row each side) are loaded, normalised, FiLM-ed and SiLU-ed
//     in f32 into shared memory; rows outside [0, L) are 0 AFTER the
//     activation (the conv's SAME padding pads the activated signal, not
//     silu(shift)), which also masks a ragged tail;
//   * the chunk's (3, CK, TCO) weights are staged beside it, f32;
//   * the epilogue adds the bias (and the residual), writes y in x's
//     dtype, and with STATS reduces y and y^2 of the f32 values over the
//     tile's positions (warp shuffles, then shared memory) into `seg`-wide
//     channel segments: partials (B, n_tiles, Cout / seg) that the caller
//     sums (deterministic, no atomics).  seg divides both the group size and
//     TCO, so a segment never straddles a group or a tile.
// Strides are arguments: x, y and the residual may be (B, L, C) views of
// (B, C, L) tensors.  The loads follow whichever of L or C is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TL = 128;          // positions per block
constexpr int CK = 16;           // input channels per staged chunk
constexpr int THREADS = 256;     // 32 position lanes x 8 channel groups
constexpr int PL = TL / 32;      // positions per thread

struct Strides {
  long long xb, xl, xc, yb, yl, yc, rb, rl, rc;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int TCO, bool RESIDUAL, bool STATS>
__global__ void __launch_bounds__(THREADS)
fused_resblock_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, const float* __restrict__ w,
                      const float* __restrict__ bias, const T* __restrict__ r,
                      T* __restrict__ y, float* __restrict__ part_s,
                      float* __restrict__ part_ss, int L, int C, int Cout,
                      Strides st, int seg) {
  constexpr int PC = TCO / 8;  // output channels per thread
  __shared__ float hs[CK][TL + 2];
  __shared__ __align__(16) float ws[3][CK][TCO];
  __shared__ float red_s[TCO];
  __shared__ float red_ss[TCO];

  const int tid = threadIdx.x;
  const int lane = tid & 31, grp = tid >> 5;
  const int tile = blockIdx.x, b = blockIdx.z;
  const int l0 = tile * TL, co0 = blockIdx.y * TCO;
  const T* xb = x + b * st.xb;
  const float* scb = scale + (long long)b * C;
  const float* shb = shift + (long long)b * C;
  const bool c_fast = st.xc == 1 && st.xl != 1;

  float acc[PL][PC];
#pragma unroll
  for (int i = 0; i < PL; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    for (int i = tid; i < CK * (TL + 2); i += THREADS) {
      int ci, p;
      if (c_fast) {
        ci = i % CK;
        p = i / CK;
      } else {
        ci = i / (TL + 2);
        p = i % (TL + 2);
      }
      const int c = c0 + ci, pos = l0 - 1 + p;
      float v = 0.f;
      if (c < C && pos >= 0 && pos < L) {
        const float u = to_f32(xb[pos * st.xl + c * st.xc]) * scb[c] + shb[c];
        v = u / (1.f + expf(-u));
      }
      hs[ci][p] = v;
    }
    for (int i = tid; i < 3 * CK * TCO; i += THREADS) {
      const int k = i / (CK * TCO), ci = (i / TCO) % CK, co = i % TCO;
      const int c = c0 + ci, o = co0 + co;
      ws[k][ci][co] = (c < C && o < Cout) ? w[((long long)k * C + c) * Cout + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float a[PL], wv[PC];
#pragma unroll
        for (int i = 0; i < PL; ++i) a[i] = hs[ci][lane + 32 * i + k];
#pragma unroll
        for (int j = 0; j < PC; ++j) wv[j] = ws[k][ci][grp * PC + j];
#pragma unroll
        for (int i = 0; i < PL; ++i)
#pragma unroll
          for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float psum[PC], psq[PC];
#pragma unroll
  for (int j = 0; j < PC; ++j) psum[j] = psq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int l = l0 + lane + 32 * i;
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      const int o = co0 + grp * PC + j;
      if (o >= Cout) continue;
      float v = acc[i][j] + bias[o];
      if constexpr (RESIDUAL) v += to_f32(r[b * st.rb + l * st.rl + o * st.rc]);
      put(y + b * st.yb + l * st.yl + o * st.yc, v);
      if constexpr (STATS) {
        psum[j] += v;
        psq[j] += v * v;
      }
    }
  }
  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < PC; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        psum[j] += __shfl_xor_sync(0xffffffffu, psum[j], off);
        psq[j] += __shfl_xor_sync(0xffffffffu, psq[j], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < PC; ++j) {
        red_s[grp * PC + j] = psum[j];
        red_ss[grp * PC + j] = psq[j];
      }
    }
    __syncthreads();
    if (tid < TCO / seg) {
      const int o = co0 + tid * seg;
      if (o < Cout) {  // seg divides Cout: the whole segment lies inside
        float s = 0.f, q = 0.f;
        for (int k = 0; k < seg; ++k) {
          s += red_s[tid * seg + k];
          q += red_ss[tid * seg + k];
        }
        const long long at = ((long long)b * gridDim.x + tile) * (Cout / seg) + o / seg;
        part_s[at] = s;
        part_ss[at] = q;
      }
    }
  }
}

template <typename T, int TCO, bool RESIDUAL, bool STATS>
void launch(const void* x, const float* scale, const float* shift, const float* w,
            const float* bias, const void* r, void* y, float* part_s,
            float* part_ss, int B, int L, int C, int Cout, Strides st, int seg,
            cudaStream_t stream) {
  const dim3 grid((L + TL - 1) / TL, (Cout + TCO - 1) / TCO, B);
  fused_resblock_kernel<T, TCO, RESIDUAL, STATS><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, w, bias, static_cast<const T*>(r),
      static_cast<T*>(y), part_s, part_ss, L, C, Cout, st, seg);
}

template <typename T, bool RESIDUAL, bool STATS>
int by_tile(int tco, const void* x, const float* scale, const float* shift,
            const float* w, const float* bias, const void* r, void* y,
            float* part_s, float* part_ss, int B, int L, int C, int Cout,
            Strides st, int seg, cudaStream_t stream) {
  switch (tco) {
#define FUSED_RESBLOCK_TILE(N)                                                   \
  case N:                                                                      \
    launch<T, N, RESIDUAL, STATS>(x, scale, shift, w, bias, r, y, part_s,      \
                                  part_ss, B, L, C, Cout, st, seg, stream);    \
    return 0;
    FUSED_RESBLOCK_TILE(8)
    FUSED_RESBLOCK_TILE(16)
    FUSED_RESBLOCK_TILE(32)
    FUSED_RESBLOCK_TILE(64)
#undef FUSED_RESBLOCK_TILE
    default:
      return -1;
  }
}

template <typename T>
int by_mode(int residual, int stats, int tco, const void* x, const float* scale,
            const float* shift, const float* w, const float* bias, const void* r,
            void* y, float* part_s, float* part_ss, int B, int L, int C, int Cout,
            Strides st, int seg, cudaStream_t stream) {
  if (!residual && !stats)
    return by_tile<T, false, false>(tco, x, scale, shift, w, bias, r, y, part_s,
                                    part_ss, B, L, C, Cout, st, seg, stream);
  if (!residual && stats)
    return by_tile<T, false, true>(tco, x, scale, shift, w, bias, r, y, part_s,
                                   part_ss, B, L, C, Cout, st, seg, stream);
  if (residual && stats)
    return by_tile<T, true, true>(tco, x, scale, shift, w, bias, r, y, part_s,
                                  part_ss, B, L, C, Cout, st, seg, stream);
  return -1;  // a residual without the statistics is not a path of the UNet
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, the residual and y share it).  scale
// and shift: (B, C) f32 contiguous; w: (3, C, Cout) f32 contiguous; bias:
// (Cout,) f32.  strides: x, y, residual, each (batch, position, channel),
// in elements.  With stats, part_s and part_ss are (B, ceil(L / 128),
// Cout / seg) f32.  tco: 8, 16, 32 or 64 output channels per block.
// Returns -1 for an argument it does not take, else cudaGetLastError().
extern "C" int fused_resblock(int dtype, int residual, int stats, int tco,
                              const void* x, const float* scale, const float* shift,
                              const float* w, const float* bias, const void* r,
                              void* y, float* part_s, float* part_ss, int B, int L,
                              int C, int Cout, const long long* strides, int seg,
                              void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || Cout <= 0 || (stats && (seg <= 0 || tco % seg)))
    return -1;
  const Strides st = {strides[0], strides[1], strides[2], strides[3], strides[4],
                      strides[5], strides[6], strides[7], strides[8]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = by_mode<float>(residual, stats, tco, x, scale, shift, w, bias, r, y,
                         part_s, part_ss, B, L, C, Cout, st, seg, s);
  else if (dtype == 1)
    err = by_mode<__nv_bfloat16>(residual, stats, tco, x, scale, shift, w, bias, r,
                                 y, part_s, part_ss, B, L, C, Cout, st, seg, s);
  else
    err = -1;
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
