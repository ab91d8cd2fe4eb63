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
// * f32 (`flash_fwd_3xtf32_kernel`, the training recipe's type, which has
//   no TF32): the same forward on the tensor cores with f32-accurate
//   products, mma.sync.m16n8k8 tf32 in 3xTF32 (tf32_mma.cuh, shared with
//   K2a/K2b): q, K, V and P each enter as big + small tf32 parts, and each
//   product as small·big + big·small + big·big.  One block of 4 warps owns
//   64 query rows, 16 (one m16 tile) a warp.  Q is copied once and K/V in
//   a ring of two stages of 64 keys, all by 16-byte cp.async into tiles of
//   pitch 72 (conflict-free fragment loads); the k order of every mma is
//   permuted so that P goes from the C registers of S = q·Kᵀ into P·V with
//   no shuffle.  Each K/V tile's P·V terms go to a partial sum added to O
//   in f32 (the tensor cores truncate what they accumulate).  Online
//   softmax as in the bf16 kernel.  In f32 the function needs 4·T²·D
//   operations against 16·T·D bytes, T/4 a byte, above the 3xTF32 ridge of
//   49 at every T the UNet has: bound by operations, at a third of the
//   TF32 rate (165 TFLOP/s).  The same cp.async contract as bf16: 16-byte
//   aligned inputs, B, L and H strides in multiples of 4 elements.
//
// Head widths: every kernel is a template of the head width kD and is built
// at 64 and at 128; the wrapper zero-pads a narrower head to the next of
// the two (the zero columns change no logit, and O's come out 0) and passes
// the true width's scale.  At 128 the f32 kernel takes one block an SM (170
// KB of tiles) and the bf16 kernel one m16 tile a warp (64 query rows a
// block, 80 KB of tiles): two tiles a warp would hold a 128-register O
// accumulator beside S.
//
// Layout: q, k, v, o are (B, L, H, kD) with such element strides for B, L
// and H and a contiguous head dim (so q, k, v may be views of one qkv
// projection); lse is a contiguous (B, H, Lq) f32 array.  A ragged sequence
// tail is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: tensor cores, mma.sync m16n8k8 tf32 in 3xTF32 (tf32_mma.cuh)
// ---------------------------------------------------------------------------

// Shared memory of flash_fwd_3xtf32_kernel: the q tile, then the ring of K/V
// tiles (two stages of K and V), f32 at pitch kD + 8.
template <int kD>
__host__ __device__ constexpr size_t f32_smem() {
  return 5 * tile_elems(kD) * sizeof(float);
}

// One block: one 64-row q tile of one (batch, head), 16 rows a warp; loops
// over the 64-key K/V tiles.
template <int kD>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(f32_smem<kD>()))
flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int heads, int lq, int lk,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        int causal, float scale) {
  constexpr int kTileElems = tile_elems(kD);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + kTileElems;  // stage s: K at ring + 2s·kTileElems, then V

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8 of the m16 tile
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of an n-tile
  const int r0 = 16 * (tid >> 5);  // the warp's first row in the tile
  const int q0 = blockIdx.x * kTile;

  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  int tiles = (lk + kTile - 1) / kTile;
  // keys after the tile's last q row are masked for every row of it
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);

  // q and the first K/V tile, one group
  cp_tile<kD>(qs, q + b * sq.b + h * sq.h, sq.l, q0, lq, tid);
  if (tiles > 0) {
    cp_tile<kD>(ring, kp, sk.l, 0, lk, tid);
    cp_tile<kD>(ring + kTileElems, vp, sv.l, 0, lk, tid);
  }
  cp_async_commit();

  const float sl = scale * kLog2e;
  float acc[kD / 8][4];  // O: kD / 8 n-tiles of 8 columns
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8: the row max of S·sl (log2 domain) and this thread's
  // part of the row sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    // tile it has landed, and every warp is done with tile it - 1, whose
    // stage the next load overwrites
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kTileElems;
      cp_tile<kD>(next, kp, sk.l, k0 + kTile, lk, tid);
      cp_tile<kD>(next + kTileElems, vp, sv.l, k0 + kTile, lk, tid);
      cp_async_commit();
    }
    const float* ks = ring + (it & 1) * 2 * kTileElems;
    const float* vs = ks + kTileElems;

    // S = q Kᵀ: kD / 8 k-steps over D, 8 n-tiles of 8 keys, q and K split
    float s[1][8][4];
    scores<kD, 1, true, float>(s, {qs}, {ks}, r0, g, t);

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3), in the log2
    // domain: p = 2^(S·sl - max), sl = scale·log2(e) > 0, so the max of
    // S·sl is sl times the max of S
    const bool edge = k0 + kTile > lk || (causal && k0 + kTile - 1 > q0 + r0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= lk || (causal && key > row)) s[0][j][e] = -CUDART_INF_F;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[0][j][e]);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl);
      // While every key so far is masked, m_new is -inf: shift by 0
      // instead, which leaves every p (and alpha) at exactly 0.
      shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = ex2(m[r] - shift[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[0][j][e], sl, -shift[e >> 1]));
        s[0][j][e] = p;
        l[e >> 1] += p;
      }
    }
    // O's kD / 8 n-tiles (S's 8 n-tiles are keys, O's are head columns)
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: P from the C registers, split like V; this tile's terms in
    // a partial sum added to O in f32
    product_cb<kD, true>(acc, s[0], vs, g, t);
  }
  cp_async_wait_all();  // nothing in flight (q and K/V only if tiles == 0)

  float* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the quad holding a row adds its four partial sums
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    const float inv = 1.f / l_safe;
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= lq) continue;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      store2(op + qi * so.l + 8 * n + 2 * t, acc[n][2 * r] * inv,
             acc[n][2 * r + 1] * inv);
    // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits
    if (t == 0)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
}

template <int kD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int heads, int lq, int lk,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<kD>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err =
      set_smem_once(flash_fwd_3xtf32_kernel<kD>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads);
  flash_fwd_3xtf32_kernel<kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, heads, lq, lk,
      sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

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

// The block: 4 warps of kMt m16 tiles.  At kD = 64, kMt = 2 (32 query rows
// a warp), so every K/V fragment read from shared memory feeds two
// products: on an H100 it ran 1.14x faster than 4 warps of 16 rows and
// 1.32x faster than 8 warps of 16 rows at T = 2048 (PERF.md §6).  At kD =
// 128, kMt = 1: two tiles would hold 128 registers of O beside S's 64.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
// m16 tiles a warp, and query rows a block
__host__ __device__ constexpr int tc_mt(int kd) { return kd == 64 ? 2 : 1; }
__host__ __device__ constexpr int tc_rows(int kd) {
  return 16 * tc_mt(kd) * kTcWarps;
}

// Element offset of (row, 16-byte chunk) in a swizzled bf16 tile of kD
// columns: the chunk's low 3 bits XOR the row's, so the 8 rows an ldmatrix
// phase reads (each row's chunk at one bank group at pitch 128 or 256
// bytes) fall on 8 different bank groups.
template <int kD>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

// Shared memory of flash_fwd_tc_kernel: the q rows of the block, then the
// ring of K/V tiles (two stages of K and V), bf16, swizzled.
template <int kD>
__host__ __device__ constexpr size_t tc_smem() {
  return (tc_rows(kD) + 4 * kTile) * kD * sizeof(__nv_bfloat16);
}

// cp.async `kRows` rows of a (., kD) bf16 matrix, row r at src + r·ld, into
// a swizzled tile, by the block's threads; rows >= limit are zero-filled.
template <int kD, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int limit,
                                          int tid) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = row0 + r < limit;
    cp_async_16(tile + swz<kD>(r, c), in ? src + (row0 + r) * ld + c * 8 : src,
                in);
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int heads, int lq, int lk, Strides sq, Strides sk,
                    Strides sv, Strides so, int causal, float scale) {
  constexpr int kMt = tc_mt(kD);
  constexpr int kRowsW = 16 * kMt;  // query rows a warp
  constexpr int kRowsQ = tc_rows(kD);
  constexpr int kChunks = kD / 8;
  constexpr int kKv = kTile * kD;   // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char tc_smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem_raw);
  // stage s: K at kvs + 2s·kKv, then V
  __nv_bfloat16* kvs = qs + kRowsQ * kD;

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

  int tiles = (lk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (q0 + kRowsQ + kTile - 1) / kTile);

  // Q and the first K/V tile, one group
  if (tiles > 0) {
    load_tile<kD, kRowsQ>(qs, qp, sq.l, q0, lq, tid);
    load_tile<kD, kTile>(kvs, kp, sk.l, 0, lk, tid);
    load_tile<kD, kTile>(kvs + kKv, vp, sv.l, 0, lk, tid);
    cp_async_commit();
  }

  const float sl = scale * 1.4426950408889634f;  // scale · log2(e)
  float acc[kMt][kD / 8][4];  // O: per m16 tile, kD / 8 n-tiles of 8 columns
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
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
    const int k0 = t * kTile;
    // tile t has landed, and every warp is done with tile t - 1, whose
    // stage the next load overwrites
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < tiles) {
      __nv_bfloat16* next = kvs + ((t + 1) & 1) * 2 * kKv;
      load_tile<kD, kTile>(next, kp, sk.l, k0 + kTile, lk, tid);
      load_tile<kD, kTile>(next + kKv, vp, sv.l, k0 + kTile, lk, tid);
      cp_async_commit();
    }
    // causal: a warp whose rows all precede the tile's keys skips it
    if (causal && k0 > qw + kRowsW - 1) continue;
    const __nv_bfloat16* ktile = kvs + (t & 1) * 2 * kKv;
    const __nv_bfloat16* vtile = ktile + kKv;

    // S = Q K^T: kD / 16 k-steps of 16 over D; in each, Q's A-fragments and
    // the B-fragments of 8 n-tiles of 8 keys, two n-tiles per ldmatrix
    float s[kMt][8][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t qa[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        ldsm_x4(qa[mt], qs + swz<kD>(kRowsW * warp + 16 * mt + (lane & 15),
                                     2 * kk + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, ktile + swz<kD>(16 * jp + (lane & 7) + 8 * (lane >> 4),
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
        k0 + kTile > lk || (causal && k0 + kTile - 1 > qw);
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
        }
      }
      // O's kD / 8 n-tiles (S's 8 n-tiles are keys, O's are head columns)
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
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
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vtile + swz<kD>(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
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
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(ow + swz<kD>(row, j) + 2 * tig) =
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
          *reinterpret_cast<const uint4*>(ow + swz<kD>(r, c));
  }
}

template <int kD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int batch, int heads, int lq, int lk,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem<kD>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err =
      set_smem_once(flash_fwd_tc_kernel<kD>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + tc_rows(kD) - 1) / tc_rows(kD), batch * heads);
  flash_fwd_tc_kernel<kD><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      heads, lq, lk, sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (tensor cores, 3xTF32), 1 = bfloat16 (tensor cores);
// head_dim: 64 or 128, the instantiation (q, k, v and o are that wide).
// Strides are in elements.  Returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int flash_fwd(int dtype, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch,
                         int heads, int lq, int lk, int head_dim,
                         long long q_sb, long long q_sl, long long q_sh,
                         long long k_sb, long long k_sl, long long k_sh,
                         long long v_sb, long long v_sl, long long v_sh,
                         long long o_sb, long long o_sl, long long o_sh,
                         int causal, float scale, void* stream) {
  const Strides sq{q_sb, q_sl, q_sh}, sk{k_sb, k_sl, k_sh},
      sv{v_sb, v_sl, v_sh}, so{o_sb, o_sl, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) {
    err = launch_f32<64>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                         so, causal, scale, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch_f32<128>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                          so, causal, scale, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch_tc<64>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                        so, causal, scale, s);
  } else if (dtype == 1 && head_dim == 128) {
    err = launch_tc<128>(q, k, v, o, lse, batch, heads, lq, lk, sq, sk, sv,
                         so, causal, scale, s);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory in bytes that each launch of flash_fwd asks for,
// dtype and head_dim as above; -1 for an unknown dtype or width.
extern "C" int flash_fwd_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 64) return static_cast<int>(f32_smem<64>());
  if (dtype == 0 && head_dim == 128) return static_cast<int>(f32_smem<128>());
  if (dtype == 1 && head_dim == 64) return static_cast<int>(tc_smem<64>());
  if (dtype == 1 && head_dim == 128) return static_cast<int>(tc_smem<128>());
  return -1;
}
