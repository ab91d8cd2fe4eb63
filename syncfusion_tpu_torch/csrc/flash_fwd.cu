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
// Two instantiations, chosen by the input's dtype:
//
// * bf16 (`flash_fwd_tc_kernel`, generation's path): FlashAttention-2's
//   forward on the tensor cores.  One block of 4 warps owns 128 query rows
//   of one (batch, head), 32 rows (two m16 tiles) a warp, so each K or V
//   fragment read from shared memory feeds two products.  Q is copied once
//   into shared memory by cp.async; its mma A-fragments come from ldmatrix.
//   K and V arrive in bf16 tiles of 64 keys in a ring of two stages filled
//   by 16-byte cp.async copies, so the next tile's load overlaps this
//   tile's products; the 16-byte chunks of each 128-byte row are
//   XOR-swizzled by the row, so every ldmatrix phase hits eight different
//   bank groups.  S = Q·K^T and O += P·V run on mma.sync.m16n8k16 (bf16
//   in, f32 accumulate); the online softmax stays in registers on the f32
//   accumulators, in the log2 domain (2^(S·scale·log2 e - max) by one FFMA
//   and ex2), with the row sum taken from the f32 P.  P enters P·V as the
//   sum of two bf16 A operands (its rounding and the rounded remainder): P
//   rounded once would move a causal head's first rows, where |O| reaches
//   2-4, by a whole bf16 ulp of O.  The m16n8 accumulator layout of two
//   adjacent key tiles is the m16k16 A layout, so P never touches shared
//   memory.  Nothing of O(T²) reaches device memory and the products run
//   at the tensor-core rate; what bounds it is mma.sync's rate (the
//   operations, 1.5x the function's for the split P) and the shared-memory
//   reads of the fragments.  The inputs must be 16-byte aligned, with B, L
//   and H strides that are multiples of 8 elements (cp.async); the wrapper
//   checks this.
// * f32 (`flash_fwd_kernel<float>`, training's recipe has no TF32): plain
//   f32 FMAs on the CUDA cores.  One block of 128 threads owns a 64-row Q
//   tile; it walks over 64-key K/V tiles staged in shared memory and keeps
//   the running max, the row sum and the 64-wide f32 accumulator in
//   registers.  Two threads share a Q row and split each K tile's keys
//   between them (even and odd keys); the pair exchanges its tile max with
//   one shuffle and adds its two partial sums and accumulators at the end.
//   It runs at the f32 FMA rate, far below the tensor-core bound.
//
// Layout: q, k, v, o are (B, L, H, 64) with any element strides for B, L
// and H and a contiguous head dim (so q, k, v may be views of one qkv
// projection); lse is a contiguous (B, H, Lq) f32 array.  A ragged sequence
// tail is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBlockQ = 64;    // q rows per block (f32 kernel)
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 128;  // two threads per q row (f32 kernel)
constexpr int kKeys = kBlockK / 2;  // keys of a tile each thread scores
// Row padding of the shared tiles: the two threads of a pair read rows
// 2j and 2j+1 at once, 68 words apart, so their 16-byte reads fall in
// different banks.
constexpr int kPad = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Strides {
  long long b, l, h;  // element strides; the head dim is contiguous
};

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: tensor cores.  Each PTX instruction sits in its own small function.
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and lane l receives row l/4, columns 2(l%4) and 2(l%4)+1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: lane l receives rows 2(l%4) and 2(l%4)+1 of
// column l/4 of each matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x0, x1) as two bf16 pairs whose sum carries 16 bits of each value: hi is
// the rounded value, lo the rounded remainder.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The block: 4 warps of 32 query rows, kMt = 2 m16 tiles a warp, so every
// K/V fragment read from shared memory feeds two products.  On an H100 it
// ran 1.14x faster than 4 warps of 16 rows and 1.32x faster than 8 warps of
// 16 rows at T = 2048 (PERF.md §6).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kMt = 2;             // m16 tiles a warp
constexpr int kRowsW = 16 * kMt;   // query rows a warp
constexpr int kRowsQ = kRowsW * kTcWarps;  // query rows a block
constexpr int kChunks = kD / 8;  // 16-byte chunks of a 64-wide bf16 row

// Element offset of (row, 16-byte chunk) in a swizzled 64-wide bf16 tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

// cp.async `kRows` rows of a (., 64) bf16 matrix, row r at src + r·ld, into
// a swizzled tile, by the block's threads; rows >= limit are zero-filled.
template <int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async_16(tile + swz(r, c), in ? src + (row0 + r) * ld + c * 8 : src,
                in);
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int heads, int lq, int lk, Strides sq, Strides sk,
                    Strides sv, Strides so, int causal, float scale) {
  __shared__ __align__(128) __nv_bfloat16 qs[kRowsQ * kD];
  __shared__ __align__(128) __nv_bfloat16 kvs[2][2][kBlockK * kD];  // stage, k|v

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of an m16 tile
  const int tig = lane & 3;  // accumulator columns 2·tig, 2·tig + 1
  const int q0 = blockIdx.x * kRowsQ;
  const int qw = q0 + kRowsW * warp;  // the warp's first row

  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

  int tiles = (lk + kBlockK - 1) / kBlockK;
  if (causal) tiles = min(tiles, (q0 + kRowsQ + kBlockK - 1) / kBlockK);

  // Q and the first K/V tile, one group
  if (tiles > 0) {
    load_tile<kRowsQ>(qs, qp, sq.l, q0, lq, tid);
    load_tile<kBlockK>(kvs[0][0], kp, sk.l, 0, lk, tid);
    load_tile<kBlockK>(kvs[0][1], vp, sv.l, 0, lk, tid);
    cp_async_commit();
  }

  const float sl = scale * 1.4426950408889634f;  // scale · log2(e)
  float acc[kMt][8][4];  // O: per m16 tile, 8 n-tiles of 8 columns
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  // per m16 tile, rows g and g + 8: the row max of S·sl (log2 domain) and
  // this thread's part of the row sum
  float m[kMt][2], l[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -CUDART_INF_F;
      l[mt][r] = 0.f;
    }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBlockK;
    // tile t has landed, and every warp is done with tile t - 1, whose
    // stage the next load overwrites
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < tiles) {
      load_tile<kBlockK>(kvs[(t + 1) & 1][0], kp, sk.l, k0 + kBlockK, lk, tid);
      load_tile<kBlockK>(kvs[(t + 1) & 1][1], vp, sv.l, k0 + kBlockK, lk, tid);
      cp_async_commit();
    }
    // causal: a warp whose rows all precede the tile's keys skips it
    if (causal && k0 > qw + kRowsW - 1) continue;
    const __nv_bfloat16* ktile = kvs[t & 1][0];
    const __nv_bfloat16* vtile = kvs[t & 1][1];

    // S = Q K^T: 4 k-steps of 16 over D; in each, Q's A-fragments and the
    // B-fragments of 8 n-tiles of 8 keys, two n-tiles per ldmatrix
    float s[kMt][8][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t qa[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        ldsm_x4(qa[mt], qs + swz(kRowsW * warp + 16 * mt + (lane & 15),
                                 2 * kk + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, ktile + swz(16 * jp + (lane & 7) + 8 * (lane >> 4),
                                2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_16816(s[mt][2 * jp], qa[mt], kb[0], kb[1]);
          mma_16816(s[mt][2 * jp + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3) of each m16
    // tile, in the log2 domain: p = 2^(S·sl - max), sl = scale·log2(e) > 0,
    // so the max of S·sl is sl times the max of S
    const bool edge =
        k0 + kBlockK > lk || (causal && k0 + kBlockK - 1 > qw);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int key = k0 + 8 * j + 2 * tig + (e & 1);
            const int row = qw + 16 * mt + g + 8 * (e >> 1);
            if (key >= lk || (causal && key > row)) s[mt][j][e] = -CUDART_INF_F;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
        }
      }
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r] * sl);
        // While every key so far is masked, m_new is -inf: shift by 0
        // instead, which leaves every p (and alpha) at exactly 0.
        shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[r] = ex2(m[mt][r] - shift[r]);
        m[mt][r] = m_new;
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][j][e], sl, -shift[e >> 1]));
          s[mt][j][e] = p;
          l[mt][e >> 1] += p;
          acc[mt][j][e] *= alpha[e >> 1];
        }
      }
    }

    // O += P V.  P's A-fragment for keys 16kk.. is S's n-tiles 2kk and
    // 2kk + 1.  P goes in as hi + lo bf16 (two products): rounded once to
    // bf16 it moves O by up to 2^-9 of |O|, and that flips the bf16 O of
    // rows with few keys (|O| >= 2 in a causal head) by a whole ulp.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[kMt][4], pl[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const float(&s0)[4] = s[mt][2 * kk];
        const float(&s1)[4] = s[mt][2 * kk + 1];
        split_bf16(s0[0], s0[1], ph[mt][0], pl[mt][0]);
        split_bf16(s0[2], s0[3], ph[mt][1], pl[mt][1]);
        split_bf16(s1[0], s1[1], ph[mt][2], pl[mt][2]);
        split_bf16(s1[2], s1[3], ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vtile + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                  2 * dp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_16816(acc[mt][2 * dp], ph[mt], vb[0], vb[1]);
          mma_16816(acc[mt][2 * dp + 1], ph[mt], vb[2], vb[3]);
          mma_16816(acc[mt][2 * dp], pl[mt], vb[0], vb[1]);
          mma_16816(acc[mt][2 * dp + 1], pl[mt], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // nothing in flight into qs (only if tiles == 0)

  // Stage the warp's rows of O (bf16) in its own rows of qs, then store them
  // as 16-byte chunks; the quad holding a row adds its four partial sums.
  __nv_bfloat16* ow = qs + kRowsW * warp * kD;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float l_safe = fmaxf(sum, 1e-30f);
      const float inv = 1.f / l_safe;
      const int row = 16 * mt + g + 8 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ow + swz(row, j) + 2 * tig) =
            pack_bf16(acc[mt][j][2 * r] * inv, acc[mt][j][2 * r + 1] * inv);
      // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits
      if (tig == 0 && qw + row < lq)
        lse[(long long)bh * lq + qw + row] =
            (m[mt][r] + log2f(l_safe)) * 0.6931471805599453f;
    }
  }
  __syncwarp();
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = lane; i < kRowsW * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    if (qw + r < lq)
      *reinterpret_cast<uint4*>(op + (qw + r) * so.l + c * 8) =
          *reinterpret_cast<const uint4*>(ow + swz(r, c));
  }
}

void launch_tc(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int heads, int lq, int lk, Strides sq,
               Strides sk, Strides sv, Strides so, int causal, float scale,
               cudaStream_t stream) {
  const dim3 grid((lq + kRowsQ - 1) / kRowsQ, batch * heads);
  flash_fwd_tc_kernel<<<grid, kTcThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      heads, lq, lk, sq, sk, sv, so, causal, scale);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Strides
// are in elements.  Returns the launch's cudaError_t (0 on success); the
// caller raises on anything else.
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
    launch_tc(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv, so, causal,
              scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
