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
// logsumexp: with q pre-scaled by scale = 1/sqrt(D), s = q kᵀ,
// p = exp(s - lse), dp = dO vᵀ, ds = p∘(dp - delta), and then
// dQ = scale · ds k, dK = dsᵀ (q·scale), dV = pᵀ dO, under the forward's
// optional causal (top-left aligned) mask.
//
// What bounds it on this card: the backward as a function needs five
// products of 2·D operations per (query, key) pair (S, dP, dV, dK, dQ), so
// 10·D·T² operations per (batch, head), against q, k, v, o and dO read once
// and dq, dk and dv written once: 8·T·D elements.  In f32 that is 0.31·T
// operations per byte, above the H100 SXM's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20, published, at 700 W) at every T the UNet has (256-2048):
// bound by operations.
//
// The two-kernel design does 14·D operations per pair, not 10·D: S and dP
// are computed in both kernels.  That is the price of the rule that each
// block owns its output rows: a flash_bwd_dq block owns a 64-row q tile and
// loops over all K/V tiles; a flash_bwd_dkv block owns a 64-key tile and
// loops over all q tiles.  No atomics, no second pass, and nothing of O(T²)
// ever reaches device memory: S, P, dP and dS live in registers and shared
// memory only.
//
// Inside a block, every product is a 64x64x64 tile product in shared memory:
// 256 threads in a 16x16 grid, each accumulating a 4x4 micro-tile in
// registers from 16-byte shared-memory reads.  Products are plain f32 FMAs
// on the CUDA cores, so this first version runs at best at the f32 FMA rate;
// tensor-core products (`mma.sync`/`wgmma`) and TMA-fed tiles are the work of
// a later change.
//
// Layout: q, k, v, o, dO and the outputs are (B, L, H, 64) with any element
// strides for B, L and H and a contiguous head dim (q, k, v may be views of
// one qkv projection); lse and delta are contiguous (B, H, Lq) f32 arrays.
// A ragged sequence tail is masked in the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kTile = 64;      // rows of every tile: q rows and keys alike
constexpr int kThreads = 256;  // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int kP = kD + 4;     // row pitch of the shared tiles, in floats
typedef float Row[kP];         // one row of a shared tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, l, h;  // element strides; the head dim is contiguous
};

// Rows row0 .. row0 + 63 of one (batch, head) slice into a shared tile, as
// f32 times `mul`; rows at or past `rows` become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(Row* dst, const T* src,
                                          long long row_stride, int row0,
                                          int rows, float mul) {
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD;
    const int c = i % kD;
    const int row = row0 + r;
    dst[r][c] =
        row < rows ? to_float(src[(long long)row * row_stride + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float acc[4][4], const float a[4],
                                       const float b[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_d A[ty + 16i][d] * B[tx + 16j][d]            (A Bᵀ)
// Rows 16 apart: a warp's reads of B cover 16 rows whose 16-byte pieces fall
// in distinct bank groups.
__device__ __forceinline__ void mm_abt(const Row* A, const Row* B, int ty,
                                       int tx, float acc[4][4]) {
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(&A[ty + 16 * i][d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(&B[tx + 16 * j][d]);
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i].x;
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[j].x;
    fma4x4(acc, av, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i].y;
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[j].y;
    fma4x4(acc, av, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i].z;
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[j].z;
    fma4x4(acc, av, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i].w;
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[j].w;
    fma4x4(acc, av, bv);
  }
}

// acc[i][j] += sum_r A[4ty + i][r] * B[r][4tx + j]              (A B)
__device__ __forceinline__ void mm_ab(const Row* A, const Row* B, int ty,
                                      int tx, float acc[4][4]) {
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(&A[4 * ty + i][r]);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 b = ld4(&B[r + rr][4 * tx]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = rr == 0 ? a[i].x : rr == 1 ? a[i].y : rr == 2 ? a[i].z : a[i].w;
      }
      fma4x4(acc, av, bv);
    }
  }
}

// acc[i][j] += sum_r A[r][4ty + i] * B[r][4tx + j]              (Aᵀ B)
__device__ __forceinline__ void mm_atb(const Row* A, const Row* B, int ty,
                                       int tx, float acc[4][4]) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 a = ld4(&A[r][4 * ty]);
    const float4 b = ld4(&B[r][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
    fma4x4(acc, av, bv);
  }
}

// One 64 x 64 (q row, key) tile of the softmax gradient.  On entry s and dp
// hold S = q kᵀ and dP = dO vᵀ for rows ty + 16i and keys tx + 16j of the
// tile; on exit s holds P and dp holds dS.  Masked pairs (a q row or key past
// the end, or a key after its query under the causal mask) get P = dS = 0.
__device__ __forceinline__ void softmax_grad(float s[4][4], float dp[4][4],
                                             const float* lse_s,
                                             const float* delta_s, int q0,
                                             int k0, int lq, int lk,
                                             int causal, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      const bool keep = qi < lq && kj < lk && !(causal && kj > qi);
      const float p = keep ? expf(s[i][j] - lse_s[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// Shared memory of flash_bwd_dq: q, dO, K, V and dS tiles, then lse and delta.
constexpr size_t kDqSmem = (5 * kTile * kP + 2 * kTile) * sizeof(float);
// Shared memory of flash_bwd_dkv: K, V, q, dO, P and dS tiles, lse, delta.
constexpr size_t kDkvSmem = (6 * kTile * kP + 2 * kTile) * sizeof(float);

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
  extern __shared__ __align__(16) float smem[];
  Row* qs = reinterpret_cast<Row*>(smem);
  Row* dos = qs + kTile;
  Row* ks = dos + kTile;
  Row* vs = ks + kTile;
  Row* dss = vs + kTile;
  float* lse_s = reinterpret_cast<float*>(dss + kTile);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kTile;

  load_tile(qs, q + b * sq.b + h * sq.h, sq.l, q0, lq, scale);
  load_tile(dos, dout + b * sdo.b + h * sdo.h, sdo.l, q0, lq, 1.f);
  // O is needed only for delta: stage it in the dS tile, free until the loop
  load_tile(dss, o + b * so.b + h * so.h, so.l, q0, lq, 1.f);
  __syncthreads();
  if (tid < kTile) {
    const int qi = q0 + tid;
    float dsum = 0.f;
#pragma unroll 8
    for (int c = 0; c < kD; ++c) dsum = fmaf(dos[tid][c], dss[tid][c], dsum);
    float l = 0.f;
    if (qi < lq) {
      l = lse[(long long)bh * lq + qi];
      delta[(long long)bh * lq + qi] = dsum;
    }
    lse_s[tid] = l;
    delta_s[tid] = dsum;
  }

  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  int tiles = (lk + kTile - 1) / kTile;
  // keys after the tile's last q row are masked for every row of it
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);

  float acc[4][4] = {};
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's products are done with ks, vs, dss
    load_tile(ks, kp, sk.l, k0, lk, 1.f);
    load_tile(vs, vp, sv.l, k0, lk, 1.f);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mm_abt(qs, ks, ty, tx, s);
    mm_abt(dos, vs, ty, tx, dp);
    softmax_grad(s, dp, lse_s, delta_s, q0, k0, lq, lk, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[ty + 16 * i][tx + 16 * j] = dp[i][j];
    }
    __syncthreads();
    mm_ab(dss, ks, ty, tx, acc);  // dQ += dS K
  }

  T* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store(dqp + (long long)qi * sdq.l + 4 * tx + j, acc[i][j] * scale);
    }
  }
}

// One block: one 64-key tile of one (batch, head); loops over q tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int lq, int lk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  Row* ks = reinterpret_cast<Row*>(smem);
  Row* vs = ks + kTile;
  Row* qs = vs + kTile;
  Row* dos = qs + kTile;
  Row* ps = dos + kTile;
  Row* dss = ps + kTile;
  float* lse_s = reinterpret_cast<float*>(dss + kTile);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * kTile;

  load_tile(ks, k + b * sk.b + h * sk.h, sk.l, k0, lk, 1.f);
  load_tile(vs, v + b * sv.b + h * sv.h, sv.l, k0, lk, 1.f);

  const T* qp = q + b * sq.b + h * sq.h;
  const T* dop = dout + b * sdo.b + h * sdo.h;
  const int q_tiles = (lq + kTile - 1) / kTile;
  // q rows before the tile's first key see none of its keys
  const int first = causal ? (int)blockIdx.x : 0;

  float dk_acc[4][4] = {};
  float dv_acc[4][4] = {};
  for (int t = first; t < q_tiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // the previous tile's products are done with its tiles
    load_tile(qs, qp, sq.l, q0, lq, scale);
    load_tile(dos, dop, sdo.l, q0, lq, 1.f);
    if (tid < kTile) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < lq ? lse[(long long)bh * lq + qi] : 0.f;
      delta_s[tid] = qi < lq ? delta[(long long)bh * lq + qi] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    mm_abt(qs, ks, ty, tx, s);
    mm_abt(dos, vs, ty, tx, dp);
    softmax_grad(s, dp, lse_s, delta_s, q0, k0, lq, lk, causal, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[ty + 16 * i][tx + 16 * j] = s[i][j];
        dss[ty + 16 * i][tx + 16 * j] = dp[i][j];
      }
    }
    __syncthreads();
    mm_atb(ps, dos, ty, tx, dv_acc);   // dV += Pᵀ dO
    mm_atb(dss, qs, ty, tx, dk_acc);   // dK += dSᵀ (q·scale)
  }

  T* dkp = dk + b * sdk.b + h * sdk.h;
  T* dvp = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= lk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store(dkp + (long long)kj * sdk.l + 4 * tx + j, dk_acc[i][j]);
      store(dvp + (long long)kj * sdv.l + 4 * tx + j, dv_acc[i][j]);
    }
  }
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, kDqSmem, stream>>>(
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, kDkvSmem, stream>>>(
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
