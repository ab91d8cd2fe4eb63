// Flash-attention forward for Hopper (sm_90a).
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
// What the design does about it: nothing of O(T²) ever reaches device
// memory.  One block of 128 threads owns one 64-row Q tile of one
// (batch, head); it walks over 64-key K/V tiles staged in shared memory as
// f32, and keeps the running max, the row sum and the 64-wide f32
// accumulator in registers.  Two threads share a Q row and split each K
// tile's keys between them (even and odd keys), so the scores of one tile
// are 32 independent dot products per thread; the pair exchanges its tile
// max with one shuffle, and adds its two partial sums and accumulators once
// at the end.  Products are plain f32 FMAs on the CUDA cores: this first
// version runs at the f32 FMA rate, far below the tensor-core bound.
// `mma.sync`/`wgmma` with TMA-fed tiles is the work of a later change.
//
// Layout: q, k, v, o are (B, L, H, 64) with any element strides for B, L
// and H and a contiguous head dim (so q, k, v may be views of one qkv
// projection); lse is a contiguous (B, H, Lq) f32 array.  A ragged sequence
// tail is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBlockQ = 64;    // q rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 128;  // two threads per q row
constexpr int kKeys = kBlockK / 2;  // keys of a tile each thread scores
// Row padding of the shared tiles: the two threads of a pair read rows
// 2j and 2j+1 at once, 68 words apart, so their 16-byte reads fall in
// different banks.
constexpr int kPad = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int lq, int lk,
                 Strides sq, Strides sk, Strides sv, Strides so, int causal,
                 float scale) {
  __shared__ __align__(16) float ks[kBlockK][kD + kPad];
  __shared__ __align__(16) float vs[kBlockK][kD + kPad];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;  // this thread scores keys 2j + half of a tile
  const int qi = blockIdx.x * kBlockQ + row;
  const bool valid = qi < lq;

  const T* qp = q + b * sq.b + h * sq.h + (long long)qi * sq.l;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = valid ? to_float(qp[d]) * scale : 0.f;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;  // running max of this row (shared by the pair)
  float l = 0.f;            // this thread's part of the row sum

  int tiles = (lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // keys beyond the tile's last row contribute nothing
    tiles = min(tiles, ((blockIdx.x + 1) * kBlockQ + kBlockK - 1) / kBlockK);
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBlockK * kD; i += kThreads) {
      const int r = i / kD;
      const int c = i % kD;
      const int key = k0 + r;
      const bool in = key < lk;
      ks[r][c] = in ? to_float(kp[(long long)key * sk.l + c]) : 0.f;
      vs[r][c] = in ? to_float(vp[(long long)key * sv.l + c]) : 0.f;
    }
    __syncthreads();

    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[2 * j + half][d]);
        s[j] = fmaf(qr[d], kv.x, s[j]);
        s[j] = fmaf(qr[d + 1], kv.y, s[j]);
        s[j] = fmaf(qr[d + 2], kv.z, s[j]);
        s[j] = fmaf(qr[d + 3], kv.w, s[j]);
      }
    }

    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = k0 + 2 * j + half;
      if (key >= lk || (causal && key > qi)) s[j] = -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    // While every key so far is masked, m_new is -inf: shift by 0 instead,
    // which leaves every p (and alpha) at exactly 0.
    const float shift = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = expf(m - shift);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = expf(s[j] - shift);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[2 * j + half][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  // The pair holds one row between them: add the two halves.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], 1);

  if (!valid) return;
  const float l_safe = fmaxf(l, 1e-30f);
  const float inv = 1.f / l_safe;
  T* op = o + b * so.b + h * so.h + (long long)qi * so.l;
  // each thread of the pair writes half of the row (constant indices keep
  // acc in registers)
  if (half == 0) {
#pragma unroll
    for (int d = 0; d < kD / 2; ++d) store(op + d, acc[d] * inv);
    lse[(long long)bh * lq + qi] = m + logf(l_safe);
  } else {
#pragma unroll
    for (int d = kD / 2; d < kD; ++d) store(op + d, acc[d] * inv);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            int batch, int heads, int lq, int lk, Strides sq, Strides sk,
            Strides sv, Strides so, int causal, float scale,
            cudaStream_t stream) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads, lq, lk, sq,
      sk, sv, so, causal, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// launch's cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch,
                         int heads, int lq, int lk, long long q_sb,
                         long long q_sl, long long q_sh, long long k_sb,
                         long long k_sl, long long k_sh, long long v_sb,
                         long long v_sl, long long v_sh, long long o_sb,
                         long long o_sl, long long o_sh, int causal,
                         float scale, void* stream) {
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh},
      sv{v_sb, v_sl, v_sh}, so{o_sb, o_sl, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv, so,
                  causal, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                          so, causal, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
