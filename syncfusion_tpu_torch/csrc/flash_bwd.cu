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
// Products: every one runs on the tensor cores as tf32 `mma.sync`, f32
// operands as 3xTF32, with per-tile partial sums added in f32 and a
// permuted k order that needs no shuffle or transpose: the scheme and its
// helpers are in tf32_mma.cuh, shared with K1's f32 forward.  bf16 inputs
// (q, k, v, dO) are exact in tf32 and unsplit; P and dS are f32 in both
// instantiations and always split.  One body per kernel serves both input
// types.
//
// Tiles arrive by 16-byte `cp.async` copies: the resident tiles (q and dO
// in flash_bwd_dq, K and V in flash_bwd_dkv) once, the streamed ones (K/V;
// q/dO with their lse and delta slices) in a ring of two stages, so the
// next tile's load overlaps this tile's products.  The operands therefore
// need 16-byte aligned addresses and B, L and H strides in multiples of 16
// bytes; the wrapper checks this and raises otherwise.
//
// Head widths: both kernels are templates of the head width kD, built at 64
// and at 128; the wrapper zero-pads a narrower head to the next of the two
// and passes the true width's scale (the zero columns change no logit, no
// delta, and come out of dq, dk and dv as 0).  At 128 the f32 tiles take
// ~205 KB, one block an SM, and the bf16 tiles ~103 KB, two.
//
// Layout: q, k, v, o, dO and the outputs are (B, L, H, kD) with any such
// element strides for B, L and H and a contiguous head dim (q, k, v may be
// views of one qkv projection); lse and delta are contiguous (B, H, Lq) f32
// arrays.  A ragged sequence tail is masked in the kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

// cp.async src[row0 .. row0 + 63] into dst, by threads 0-63 (i = their
// index); entries at or past `limit` are zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int limit, int i) {
  const bool in = row0 + i < limit;
  cp_async_4(dst + i, in ? src + row0 + i : src, in);
}

// Shared memory of flash_bwd_dq: q, dO, then the ring of K/V tiles (two
// stages of K and V), then lse·log2(e) and delta of the q rows.
template <typename T, int kD>
__host__ __device__ constexpr size_t dq_smem() {
  return 6 * tile_elems(kD) * sizeof(T) + 2 * kTile * sizeof(float);
}
// Shared memory of flash_bwd_dkv: K, V, the ring of q/dO tiles (two stages
// of q and dO), then per stage the lse and delta slices.
template <typename T, int kD>
__host__ __device__ constexpr size_t dkv_smem() {
  return 6 * tile_elems(kD) * sizeof(T) + 4 * kTile * sizeof(float);
}

// One block: one 64-row q tile of one (batch, head); loops over K/V tiles.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(dq_smem<T, kD>()))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int heads,
                    int lq, int lk, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, int causal,
                    float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;  // inputs need a split
  constexpr int kP = tile_pitch(kD);
  constexpr int kTileElems = tile_elems(kD);
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
  cp_tile<kD>(qs, q + b * sq.b + h * sq.h, sq.l, q0, lq, tid);
  cp_tile<kD>(dos, dout + b * sdo.b + h * sdo.h, sdo.l, q0, lq, tid);
  cp_tile<kD>(os, o + b * so.b + h * so.h, so.l, q0, lq, tid);
  if (tiles > 0) {
    cp_tile<kD>(ring, kp, sk.l, 0, lk, tid);
    cp_tile<kD>(ring + kTileElems, vp, sv.l, 0, lk, tid);
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
  float acc[kD / 8][4];  // dQ: kD / 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
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
      cp_tile<kD>(next, kp, sk.l, k0 + kTile, lk, tid);
      cp_tile<kD>(next + kTileElems, vp, sv.l, k0 + kTile, lk, tid);
      cp_async_commit();
    }
    const T* ks = ring + (it & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;

    // S = q Kᵀ and dP = dO Vᵀ: kD / 8 k-steps over D, 8 n-tiles of 8 keys
    float sd[2][8][4];
    scores<kD, 2, kF32, T>(sd, {qs, dos}, {ks, vs}, r0, g, t);

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

    // dQ += dS K: 8 k-steps over the tile's keys, kD / 8 n-tiles over D
    product_cb<kD, kF32>(acc, sd[1], ks, g, t);
  }

  T* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= lq) continue;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      store2(dqp + (long long)qi * sdq.l + 8 * n + 2 * t,
             acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

// One block: one 64-key tile of one (batch, head); loops over q tiles.
// Keys are the M index of every product: Sᵀ = K qᵀ and dPᵀ = V dOᵀ leave
// Pᵀ and dSᵀ in C registers with keys as rows, which is A of dV = Pᵀ dO and
// dK = dSᵀ q; lse and delta are indexed by column.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(dkv_smem<T, kD>()))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int lq, int lk, Strides sq,
                     Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, int causal, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kTileElems = tile_elems(kD);
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
    cp_tile<kD>(stage, qp, sq.l, q0, lq, tid);
    cp_tile<kD>(stage + kTileElems, dop, sdo.l, q0, lq, tid);
    if (tid < kTile) {
      load_vec(vecs + s * 2 * kTile, lsep, q0, lq, tid);
    } else {
      load_vec(vecs + s * 2 * kTile + kTile, deltap, q0, lq, tid - kTile);
    }
  };

  // K, V and the first q/dO tile, one group
  cp_tile<kD>(ks, k + b * sk.b + h * sk.h, sk.l, k0, lk, tid);
  cp_tile<kD>(vs, v + b * sv.b + h * sv.h, sv.l, k0, lk, tid);
  if (first < q_tiles) load_q_tile(first);
  cp_async_commit();

  const float sl = scale * kLog2e;
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];  // kD / 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
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

    // Sᵀ = K qᵀ and dPᵀ = V dOᵀ: kD / 8 k-steps over D, 8 n-tiles of 8
    // queries
    float sd[2][8][4];
    scores<kD, 2, kF32, T>(sd, {ks, vs}, {qs, dos}, r0, g, t);

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

    // dV += Pᵀ dO, then dK += dSᵀ q: 8 k-steps over the tile's queries,
    // kD / 8 n-tiles over D
    product_cb<kD, kF32>(dv_acc, sd[0], dos, g, t);
    product_cb<kD, kF32>(dk_acc, sd[1], qs, g, t);
  }
  cp_async_wait_all();  // nothing in flight (K/V only if no q tile ran)

  T* dkp = dk + b * sdk.b + h * sdk.h;
  T* dvp = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + g + 8 * r;
    if (kj >= lk) continue;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
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

template <typename T, int kD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, const long long* st, int causal, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  constexpr size_t smem = dq_smem<T, kD>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, attr_set);
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

template <typename T, int kD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int heads, int lq,
                       int lk, const long long* st, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  constexpr size_t smem = dkv_smem<T, kD>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, attr_set);
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

// Launches `Launch<T, kD>::run(args...)` for dtype (0 = float32, 1 =
// bfloat16) and head_dim (64 or 128); cudaErrorInvalidValue for any other.
template <template <typename, int> class Launch, typename... Args>
cudaError_t dispatch(int dtype, int head_dim, Args... args) {
  if (dtype == 0 && head_dim == 64) return Launch<float, 64>::run(args...);
  if (dtype == 0 && head_dim == 128) return Launch<float, 128>::run(args...);
  if (dtype == 1 && head_dim == 64)
    return Launch<__nv_bfloat16, 64>::run(args...);
  if (dtype == 1 && head_dim == 128)
    return Launch<__nv_bfloat16, 128>::run(args...);
  return cudaErrorInvalidValue;
}

template <typename T, int kD>
struct DqLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dq<T, kD>(args...); }
};
template <typename T, int kD>
struct DkvLaunch {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_dkv<T, kD>(args...); }
};

template <typename T, int kD>
struct SmemOf {
  static cudaError_t run(int kernel, int* bytes) {
    *bytes = static_cast<int>(kernel == 0 ? dq_smem<T, kD>()
                                          : dkv_smem<T, kD>());
    return cudaSuccess;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64 or 128, the instantiation
// (q, k, v, o, dout and dq are that wide).  `strides` holds the (b, l, h)
// element strides of q, k, v, o, dout, dq in that order (18 values).
// Writes dq and delta = rowsum(dout∘o).  Returns the launch's cudaError_t
// (0 on success); the caller raises on anything else.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            int batch, int heads, int lq, int lk, int head_dim,
                            const long long* strides, int causal, float scale,
                            void* stream) {
  return static_cast<int>(dispatch<DqLaunch>(
      dtype, head_dim, q, k, v, o, dout, lse, delta, dq, batch, heads, lq, lk,
      strides, causal, scale, static_cast<cudaStream_t>(stream)));
}

// dtype and head_dim as above.  `strides` holds the (b, l, h) element
// strides of q, k, v, dout, dk, dv in that order (18 values); delta is
// flash_bwd_dq's.
extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int batch,
                             int heads, int lq, int lk, int head_dim,
                             const long long* strides, int causal,
                             float scale, void* stream) {
  return static_cast<int>(dispatch<DkvLaunch>(
      dtype, head_dim, q, k, v, dout, lse, delta, dk, dv, batch, heads, lq, lk,
      strides, causal, scale, static_cast<cudaStream_t>(stream)));
}

// The dynamic shared memory in bytes that each launch of flash_bwd_dq
// (kernel 0) or flash_bwd_dkv (kernel 1) asks for, dtype and head_dim as
// above; -1 for an unknown kernel, dtype or width.
extern "C" int flash_bwd_smem(int kernel, int dtype, int head_dim) {
  int bytes = -1;
  if (kernel != 0 && kernel != 1) return -1;
  if (dispatch<SmemOf>(dtype, head_dim, kernel, &bytes) != cudaSuccess)
    return -1;
  return bytes;
}
