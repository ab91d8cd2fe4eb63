// Flash attention for heads wider than 512 on Hopper (sm_90a): forward,
// dQ, and dK with dV, at any head width that is a multiple of 64 above 512.
// (The entries take any multiple of 64 above 128; ops/attention.py's
// `kernel_source` sends K2a and K2b the widths above 512, where the Hopper
// kernels of flash_fwd_wide_sm90.cu and flash_bwd_wide_sm90.cu stop: those
// hold a 64-row output tile at the full width in the registers of two
// warpgroups, at most 128 a thread, and past 512 it no longer fits.  K1
// goes here only above 4096: from 576 to 4096 it is flash_fwd_cluster_
// sm90.cu's, on thread-block clusters that split O's columns and compute S
// once.)
//
// Replaces, at those widths, the same three TPU kernels of
// syncfusion_tpu/ops/attention.py as flash_fwd.cu and flash_bwd.cu:
//   flash_fwd_chunked      <- `_flash_kernel` (K1);
//   flash_bwd_dq_chunked   <- `_flash_bwd_dq_kernel` (K2a), with the
//                             reduction delta = rowsum(dO∘O) fused in;
//   flash_bwd_dkv_chunked  <- `_flash_bwd_dkv_kernel` (K2b).
// The Pallas kernels' BlockSpecs carry the full head width, so they take
// any; the 64- and 128-wide kernels of flash_fwd.cu and flash_bwd.cu hold a
// whole row of every operand tile and every accumulator, and past 128 that
// no longer fits (the f32 K2a tiles alone would take 405,504 B at D = 256,
// above the 232,448 B a block may have on the NVIDIA H100 80GB HBM3, 700
// W).  Here shared memory (111,104 B in f32, 55,808 B in bf16) and
// registers stay fixed whatever the width W is, so every multiple of 64
// fits:
//
// * Pieces.  Every operand tile is a 64-row piece of 64 columns (pitch 72,
//   tf32_mma.cuh's layout at kD = 64).  The products that contract over the
//   head dim (S = q kᵀ, dP = dO vᵀ) stream their operands' W / 64 pieces
//   through a two-stage cp.async ring, and each piece's product goes to a
//   partial sum that is added to S (or dP) in f32, as K2's per-tile partial
//   sums are (the tensor cores truncate what they accumulate).
// * Chunks.  A third grid dimension runs over chunks of 128 output columns
//   (two pieces; the last one piece when W is an odd multiple of 64).  A
//   block owns its output rows and its chunk's columns of O (K1), dQ (K2a),
//   or dK or dV (K2b), whose accumulators are those of the 128-wide kernels.
//   The operand of the chunk's own product (V in K1, K in K2a, dO or q in
//   K2b) is loaded per key or query tile into a buffer of two pieces.
// * No atomics, so the result is bitwise the same from run to run; S, P,
//   dP and dS live in registers only.  Every chunk computes the LSE (K1)
//   and delta (K2a) by the same operations in the same order, and the
//   chunk-0 block alone writes them.
// * K2b's grid has two blocks per chunk: one for dK (S and dP over the full
//   width, then dS) and one for dV (S alone, then P), so that neither holds
//   both 64-register accumulators beside S and dP.
//
// The price is the recompute of S (and dP) once per chunk.  With NC =
// ceil(W / 128) chunks, per (query, key) pair in units of W operations:
//   K1:  NC·2 (S) + 2 (P·V), against the function's 4: (NC + 1) / 2,
//        3x at W = 576 and 640, 4.5x at 1024;
//   K2a: NC·4 (S, dP) + 2 (dS·K), against 6: (2NC + 1) / 3, 3.67x at 576
//        and 640, 5.67x at 1024;
//   K2b: NC·2 (S for dV) + 2 + NC·4 (S, dP for dK) + 2, against 8:
//        (3NC + 2) / 4, 4.25x at 576 and 640, 6.5x at 1024.
// Launches stay one a call for each kernel: the chunks are a grid
// dimension.
//
// Products: tf32_mma.cuh's helpers on mma.sync m16n8k8 tf32, one body per
// kernel for both input types: f32 operands as 3xTF32 (big + small parts),
// bf16 q, k, v, dO exact in tf32 and unsplit; P and dS are f32 and always
// split.  4 warps a block, 16 rows (one m16 tile) a warp, 64 rows or keys
// a block.
//
// Layout: q, k, v, o, dO and the outputs are (B, L, H, W) with any element
// strides for B, L and H that are multiples of 16 bytes, a contiguous head
// dim, and 16-byte aligned addresses (cp.async; the wrapper checks this);
// lse and delta are contiguous (B, H, Lq) f32 arrays.  A ragged sequence
// tail is masked in the kernels.  The wrapper zero-pads a head to W, the
// least multiple of 64 not below it, and passes the true width's scale:
// the zero columns change no logit, LSE or delta, and come out as 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kPiece = 64;                   // columns of a piece
constexpr int kPieceElems = tile_elems(kPiece);  // 64 rows at pitch 72
constexpr int kChunkPieces = 2;              // 128 output columns a block

// Shared memory of every kernel here: the ring (two stages of two pieces),
// the chunk's operand (two pieces), then two 64-row f32 vectors (K2a: lse
// and delta of its q rows; K2b: those of the current q tile).
template <typename T>
__host__ __device__ constexpr size_t wide_smem() {
  return 6 * kPieceElems * sizeof(T) + 2 * kTile * sizeof(float);
}

// The pieces of chunk `c` of a W-wide head: 2, or 1 for the last chunk of
// an odd number of pieces.
__device__ __forceinline__ int chunk_pieces(int pieces, int c) {
  return min(kChunkPieces, pieces - kChunkPieces * c);
}

// cp.async piece `p` (columns 64p .. 64p + 63) of rows row0 .. row0 + 63 of
// a (batch, head) slice at `base`, row stride ld, into a piece tile; rows
// at or past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void cp_piece(T* tile, const T* base, long long ld,
                                         int p, int row0, int limit,
                                         int tid) {
  cp_tile<kPiece>(tile, base + kPiece * p, ld, row0, limit, tid);
}

// cp.async src[row0 .. row0 + 63] into dst, by threads i = 0-63; entries
// at or past `limit` are zero-filled.
__device__ __forceinline__ void cp_vec(float* dst, const float* src, int row0,
                                       int limit, int i) {
  const bool in = row0 + i < limit;
  cp_async_4(dst + i, in ? src + row0 + i : src, in);
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

// acc += a·bᵀ over one piece: the m16 tile of rows r0 .. r0 + 15 of piece
// `a` against the 64 rows of piece `b`, as a partial sum added in f32.
template <bool kSplit, typename T>
__device__ __forceinline__ void add_scores(float (&acc)[8][4], const T* a,
                                           const T* b, int r0, int g, int t) {
  float part[1][8][4];
  scores<kPiece, 1, kSplit, T>(part, {a}, {b}, r0, g, t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[0][j][e];
}

// acc (the chunk's two 64-column halves) += c·chunk, c the C registers of
// a finished 16 x 64 product, chunk the chunk's pieces (rows the k index).
template <bool kSplit, typename T>
__device__ __forceinline__ void add_chunk(float (&acc)[kChunkPieces][8][4],
                                          const float (&c)[8][4],
                                          const T* chunk, int n_pieces, int g,
                                          int t) {
  product_cb<kPiece, kSplit>(acc[0], c, chunk, g, t);
  if (n_pieces > 1) product_cb<kPiece, kSplit>(acc[1], c, chunk + kPieceElems, g, t);
}

// Rows g and g + 8 of the warp's m16 tile, the chunk's columns of a row
// written at out + row·ld + 128c (each value times `mul`).
template <typename T>
__device__ __forceinline__ void store_chunk(
    T* out, long long ld, const float (&acc)[kChunkPieces][8][4], int n_pieces,
    int c, int row0, int limit, float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    T* p = out + row * ld + kPiece * kChunkPieces * c + 2 * t;
#pragma unroll
    for (int h = 0; h < kChunkPieces; ++h) {
      if (h >= n_pieces) break;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(p + kPiece * h + 8 * n, acc[h][n][2 * r] * mul,
               acc[h][n][2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// K1: one block, one 64-row q tile and one chunk of O; loops over the K/V
// tiles, and within each over the W / 64 pieces of q and K.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(wide_smem<T>()))
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int heads, int lq, int lk,
                      int pieces, Strides sq, Strides sk, Strides sv,
                      Strides so, int causal, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // stage s: q piece, K piece
  T* chunk = ring + 4 * kPieceElems;     // V: the chunk's pieces

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int c = blockIdx.z;
  const int n_pieces = chunk_pieces(pieces, c);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5);  // the warp's first row in the tile
  const int q0 = blockIdx.x * kTile;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  int tiles = (lk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);
  const int items = tiles * pieces;  // (K/V tile, piece) in that order

  auto fetch = [&](int i) {
    T* stage = ring + (i & 1) * 2 * kPieceElems;
    const int p = i % pieces;
    cp_piece(stage, qp, sq.l, p, q0, lq, tid);
    cp_piece(stage + kPieceElems, kp, sk.l, p, (i / pieces) * kTile, lk, tid);
  };
  if (items > 0) fetch(0);
  cp_async_commit();

  const float sl = scale * kLog2e;
  float acc[kChunkPieces][8][4];  // O's chunk: two halves of 8 n-tiles
  zero(acc[0]);
  zero(acc[1]);
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    float s[8][4];
    zero(s);
    for (int p = 0; p < pieces; ++p) {
      const int i = it * pieces + p;
      // item i has landed, and every warp is done with item i - 1, whose
      // stage the next load overwrites (and, at p = 0, with the previous
      // tile's V chunk)
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < items) fetch(i + 1);
      if (p == 0) {
        // this tile's V chunk; waited for with item 1 (pieces >= 3)
        for (int hh = 0; hh < n_pieces; ++hh)
          cp_piece(chunk + hh * kPieceElems, vp, sv.l, kChunkPieces * c + hh,
                   k0, lk, tid);
      }
      cp_async_commit();
      const T* stage = ring + (i & 1) * 2 * kPieceElems;
      add_scores<kF32>(s, stage, stage + kPieceElems, r0, g, t);
    }

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3), log2 domain,
    // as flash_fwd.cu
    const bool edge = k0 + kTile > lk || (causal && k0 + kTile - 1 > q0 + r0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= lk || (causal && key > row)) s[j][e] = -CUDART_INF_F;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], shift[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * sl);
      shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = ex2(m[r] - shift[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[j][e], sl, -shift[e >> 1]));
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int hh = 0; hh < kChunkPieces; ++hh)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[hh][n][e] *= alpha[e >> 1];

    // O's chunk += P V's chunk (landed and visible since item 1's barrier)
    add_chunk<kF32>(acc, s, chunk, n_pieces, g, t);
  }
  cp_async_wait_all();  // nothing in flight

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    inv[r] = 1.f / l_safe;
    const int qi = q0 + r0 + g + 8 * r;
    if (c == 0 && t == 0 && qi < lq)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int hh = 0; hh < kChunkPieces; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][n][e] *= inv[e >> 1];
  store_chunk(o + b * so.b + h * so.h, so.l, acc, n_pieces, c, q0 + r0, lq,
              1.f, g, t);
}

// ---------------------------------------------------------------------------
// K2a: one block, one 64-row q tile and one chunk of dQ.  Its items: the W /
// 64 pieces of (dO, O) for delta, then per K/V tile the pieces of (q, K)
// for S and of (dO, V) for dP.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(wide_smem<T>()))
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, T* __restrict__ dq,
                         int heads, int lq, int lk, int pieces, Strides sq,
                         Strides sk, Strides sv, Strides so, Strides sdo,
                         Strides sdq, int causal, float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kP = tile_pitch(kPiece);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* chunk = ring + 4 * kPieceElems;  // K: the chunk's pieces
  float* lse_s = reinterpret_cast<float*>(chunk + 2 * kPieceElems);
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int c = blockIdx.z;
  const int n_pieces = chunk_pieces(pieces, c);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const int q0 = blockIdx.x * kTile;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const T* op = o + b * so.b + h * so.h;
  const T* dop = dout + b * sdo.b + h * sdo.h;
  int tiles = (lk + kTile - 1) / kTile;
  if (causal) tiles = min(tiles, (int)blockIdx.x + 1);
  const int items = pieces + tiles * 2 * pieces;

  auto fetch = [&](int i) {
    T* stage = ring + (i & 1) * 2 * kPieceElems;
    if (i < pieces) {  // delta: dO and O
      cp_piece(stage, dop, sdo.l, i, q0, lq, tid);
      cp_piece(stage + kPieceElems, op, so.l, i, q0, lq, tid);
      return;
    }
    const int j = i - pieces;
    const int k0 = (j / (2 * pieces)) * kTile;
    const int p = j % (2 * pieces);
    if (p < pieces) {  // S: q and K
      cp_piece(stage, qp, sq.l, p, q0, lq, tid);
      cp_piece(stage + kPieceElems, kp, sk.l, p, k0, lk, tid);
    } else {  // dP: dO and V
      cp_piece(stage, dop, sdo.l, p - pieces, q0, lq, tid);
      cp_piece(stage + kPieceElems, vp, sv.l, p - pieces, k0, lk, tid);
    }
  };
  fetch(0);
  cp_async_commit();

  // delta = rowsum(dO∘O) over the full width, columns in order, by threads
  // 0-63 (one row each): the same operations in every chunk's block
  float dsum = 0.f;
  for (int p = 0; p < pieces; ++p) {
    cp_async_wait_all();
    __syncthreads();
    if (p + 1 < items) fetch(p + 1);
    if (p == 0) {
      // tile 0's K chunk, waited for with item 1 (pieces >= 3)
      for (int hh = 0; hh < n_pieces; ++hh)
        cp_piece(chunk + hh * kPieceElems, kp, sk.l, kChunkPieces * c + hh, 0,
                 lk, tid);
    }
    cp_async_commit();
    if (tid < kTile) {
      const T* stage = ring + (p & 1) * 2 * kPieceElems;
#pragma unroll 8
      for (int col = 0; col < kPiece; ++col)
        dsum = fmaf(to_float(stage[tid * kP + col]),
                    to_float(stage[kPieceElems + tid * kP + col]), dsum);
    }
  }
  if (tid < kTile) {
    const int qi = q0 + tid;
    float lv = 0.f;
    if (qi < lq) {
      lv = lse[(long long)bh * lq + qi];
      if (c == 0) delta[(long long)bh * lq + qi] = dsum;
    }
    lse_s[tid] = lv * kLog2e;
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
  float acc[kChunkPieces][8][4];  // dQ's chunk
  zero(acc[0]);
  zero(acc[1]);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int p = 0; p < 2 * pieces; ++p) {
      const int i = pieces + it * 2 * pieces + p;
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < items) fetch(i + 1);
      if (p == 0 && it > 0) {
        // this tile's K chunk (tile 0's came with the delta items)
        for (int hh = 0; hh < n_pieces; ++hh)
          cp_piece(chunk + hh * kPieceElems, kp, sk.l, kChunkPieces * c + hh,
                   k0, lk, tid);
      }
      cp_async_commit();
      const T* stage = ring + (i & 1) * 2 * kPieceElems;
      if (p < pieces)
        add_scores<kF32>(s, stage, stage + kPieceElems, r0, g, t);
      else
        add_scores<kF32>(dp, stage, stage + kPieceElems, r0, g, t);
    }

    // dS = P∘(dP - delta), masked pairs 0, as flash_bwd.cu
    const bool edge = k0 + kTile > lk || q0 + kTile > lq ||
                      (causal && k0 + kTile - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pe = ex2(fmaf(s[j][e], sl, -lse2[r]));
        if (edge) {
          const int qi = q0 + r0 + g + 8 * r;
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (qi >= lq || kj >= lk || (causal && kj > qi)) pe = 0.f;
        }
        dp[j][e] = pe * (dp[j][e] - dl[r]);
      }
    }

    // dQ's chunk += dS K's chunk
    add_chunk<kF32>(acc, dp, chunk, n_pieces, g, t);
  }
  cp_async_wait_all();

  store_chunk(dq + b * sdq.b + h * sdq.h, sdq.l, acc, n_pieces, c, q0 + r0,
              lq, scale, g, t);
}

// ---------------------------------------------------------------------------
// K2b: one block, one 64-key tile and one chunk of dK (blockIdx.z < NC) or
// of dV (the rest); loops over q tiles, and within each over the pieces of
// (K, q) for Sᵀ and, for dK, of (V, dO) for dPᵀ.  Keys are the M index of
// every product, as in flash_bwd.cu.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(wide_smem<T>()))
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int heads, int lq, int lk,
                          int pieces, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, int causal,
                          float scale) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* chunk = ring + 4 * kPieceElems;  // q (dK) or dO (dV): the chunk's pieces
  float* vecs = reinterpret_cast<float*>(chunk + 2 * kPieceElems);  // lse|delta

  const int n_chunks = (pieces + kChunkPieces - 1) / kChunkPieces;
  const bool for_dk = (int)blockIdx.z < n_chunks;
  const int c = for_dk ? blockIdx.z : blockIdx.z - n_chunks;
  const int n_pieces = chunk_pieces(pieces, c);
  const int per_tile = for_dk ? 2 * pieces : pieces;
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
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const T* dop = dout + b * sdo.b + h * sdo.h;
  const float* lsep = lse + (long long)bh * lq;
  const float* deltap = delta + (long long)bh * lq;
  const int q_tiles = (lq + kTile - 1) / kTile;
  // q rows before the tile's first key see none of its keys
  const int first = causal ? (int)blockIdx.x : 0;
  const int items = (q_tiles - first) * per_tile;
  if (items <= 0) {  // no query sees these keys: dK and dV are 0
    float acc[kChunkPieces][8][4];
    zero(acc[0]);
    zero(acc[1]);
    T* out = for_dk ? dk + b * sdk.b + h * sdk.h : dv + b * sdv.b + h * sdv.h;
    store_chunk(out, for_dk ? sdk.l : sdv.l, acc, n_pieces, c, k0 + r0, lk,
                1.f, g, t);
    return;
  }

  auto fetch = [&](int i) {
    T* stage = ring + (i & 1) * 2 * kPieceElems;
    const int q0 = (first + i / per_tile) * kTile;
    const int p = i % per_tile;
    if (p < pieces) {  // Sᵀ: K and q
      cp_piece(stage, kp, sk.l, p, k0, lk, tid);
      cp_piece(stage + kPieceElems, qp, sq.l, p, q0, lq, tid);
    } else {  // dPᵀ: V and dO
      cp_piece(stage, vp, sv.l, p - pieces, k0, lk, tid);
      cp_piece(stage + kPieceElems, dop, sdo.l, p - pieces, q0, lq, tid);
    }
  };
  fetch(0);
  cp_async_commit();

  const float sl = scale * kLog2e;
  float acc[kChunkPieces][8][4];  // dK's or dV's chunk
  zero(acc[0]);
  zero(acc[1]);

  for (int it = first; it < q_tiles; ++it) {
    const int q0 = it * kTile;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    for (int p = 0; p < per_tile; ++p) {
      const int i = (it - first) * per_tile + p;
      cp_async_wait_all();
      __syncthreads();
      if (i + 1 < items) fetch(i + 1);
      if (p == 0) {
        // this q tile's chunk operand and its lse (and delta) slices,
        // waited for with item 1 (pieces >= 3)
        const T* src = for_dk ? qp : dop;
        for (int hh = 0; hh < n_pieces; ++hh)
          cp_piece(chunk + hh * kPieceElems, src, for_dk ? sq.l : sdo.l,
                   kChunkPieces * c + hh, q0, lq, tid);
        if (tid < kTile)
          cp_vec(vecs, lsep, q0, lq, tid);
        else if (for_dk)
          cp_vec(vecs + kTile, deltap, q0, lq, tid - kTile);
      }
      cp_async_commit();
      const T* stage = ring + (i & 1) * 2 * kPieceElems;
      if (p < pieces)
        add_scores<kF32>(s, stage, stage + kPieceElems, r0, g, t);
      else
        add_scores<kF32>(dp, stage, stage + kPieceElems, r0, g, t);
    }

    // Pᵀ, and for dK dSᵀ; column 8j + 2t + (e & 1) is the query, row
    // g + 8(e >> 1) the key
    const bool edge = q0 + kTile > lq || k0 + kTile > lk ||
                      (causal && k0 + r0 + 15 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(vecs + 8 * j + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(vecs + kTile + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq_e = (e & 1) ? l2.y : l2.x;
        float pe = ex2(fmaf(s[j][e], sl, -lq_e * kLog2e));
        if (edge) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          const int kj = k0 + r0 + g + 8 * (e >> 1);
          if (qi >= lq || kj >= lk || (causal && kj > qi)) pe = 0.f;
        }
        if (for_dk) {
          const float dl_e = (e & 1) ? d2.y : d2.x;
          s[j][e] = pe * (dp[j][e] - dl_e);
        } else {
          s[j][e] = pe;
        }
      }
    }

    // dK's chunk += dSᵀ q's chunk, or dV's chunk += Pᵀ dO's chunk
    add_chunk<kF32>(acc, s, chunk, n_pieces, g, t);
  }
  cp_async_wait_all();

  if (for_dk)
    store_chunk(dk + b * sdk.b + h * sdk.h, sdk.l, acc, n_pieces, c, k0 + r0,
                lk, scale, g, t);
  else
    store_chunk(dv + b * sdv.b + h * sdv.h, sdv.l, acc, n_pieces, c, k0 + r0,
                lk, 1.f, g, t);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

int chunks_of(int pieces) {
  return (pieces + kChunkPieces - 1) / kChunkPieces;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int batch, int heads, int lq, int lk,
                       int pieces, const long long* st, int causal,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_wide_kernel<T>;
  constexpr size_t smem = wide_smem<T>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads, chunks_of(pieces));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, heads, lq, lk, pieces,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int batch, int heads, int lq,
                      int lk, int pieces, const long long* st, int causal,
                      float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_wide_kernel<T>;
  constexpr size_t smem = wide_smem<T>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTile - 1) / kTile, batch * heads, chunks_of(pieces));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), heads, lq,
      lk, pieces, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int batch, int heads, int lq,
                       int lk, int pieces, const long long* st, int causal,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_wide_kernel<T>;
  constexpr size_t smem = wide_smem<T>();
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = set_smem_once(kernel, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kTile - 1) / kTile, batch * heads,
                  2 * chunks_of(pieces));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), heads, lq, lk, pieces,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), causal, scale);
  return cudaGetLastError();
}

// The pieces of a head of head_dim features, or 0 where these kernels do
// not take it: a multiple of 64 above 128.
int pieces_of(int head_dim) {
  return head_dim > 2 * kPiece && head_dim % kPiece == 0 ? head_dim / kPiece
                                                         : 0;
}

}  // namespace

// As flash_fwd.cu's flash_fwd (the same arguments), at a head_dim that is
// a multiple of 64 above 128: writes o and lse.  Returns the launch's
// cudaError_t (0 on success); the caller raises on anything else.
extern "C" int flash_fwd_chunked(int dtype, const void* q, const void* k,
                              const void* v, void* o, float* lse, int batch,
                              int heads, int lq, int lk, int head_dim,
                              long long q_sb, long long q_sl, long long q_sh,
                              long long k_sb, long long k_sl, long long k_sh,
                              long long v_sb, long long v_sl, long long v_sh,
                              long long o_sb, long long o_sl, long long o_sh,
                              int causal, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const int pieces = pieces_of(head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_fwd<float>(q, k, v, o, lse, batch, heads,
                                              lq, lk, pieces, st, causal,
                                              scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_fwd<__nv_bfloat16>(
        q, k, v, o, lse, batch, heads, lq, lk, pieces, st, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd.cu's flash_bwd_dq, at a head_dim that is a multiple of 64
// above 128: writes dq and delta = rowsum(dout∘o); `strides` holds those of
// q, k, v, o, dout, dq (18 values).
extern "C" int flash_bwd_dq_chunked(int dtype, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const float* lse,
                                 float* delta, void* dq, int batch, int heads,
                                 int lq, int lk, int head_dim,
                                 const long long* strides, int causal,
                                 float scale, void* stream) {
  const int pieces = pieces_of(head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_dq<float>(q, k, v, o, dout, lse, delta, dq,
                                             batch, heads, lq, lk, pieces,
                                             strides, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_dq<__nv_bfloat16>(
        q, k, v, o, dout, lse, delta, dq, batch, heads, lq, lk, pieces,
        strides, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd.cu's flash_bwd_dkv, at such a head_dim: writes dk and dv;
// `strides` holds those of q, k, v, dout, dk, dv (18 values); delta is
// flash_bwd_dq_chunked's.
extern "C" int flash_bwd_dkv_chunked(int dtype, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int batch, int heads,
                                  int lq, int lk, int head_dim,
                                  const long long* strides, int causal,
                                  float scale, void* stream) {
  const int pieces = pieces_of(head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pieces == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_dkv<float>(q, k, v, dout, lse, delta, dk,
                                              dv, batch, heads, lq, lk, pieces,
                                              strides, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_dkv<__nv_bfloat16>(
        q, k, v, dout, lse, delta, dk, dv, batch, heads, lq, lk, pieces,
        strides, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory in bytes that every launch of the three asks
// for, by dtype as above; -1 for an unknown dtype.
extern "C" int flash_wide_smem(int dtype) {
  if (dtype == 0) return static_cast<int>(wide_smem<float>());
  if (dtype == 1) return static_cast<int>(wide_smem<__nv_bfloat16>());
  return -1;
}
