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
// What bounds it: bytes, as a function, at the UNet's widths.  x is read
// once (plus 2 halo rows per 128-position tile, and once per 64-channel
// output tile), y written once; the normalised and activated input never
// reaches device memory.  A conv of 3·C·Cout multiply-adds per position is
// below the tensor cores' rate for its 2·(C + Cout) values in bf16; in f32
// as 3xTF32 (three tf32 products a multiply-add) K3's calls with C >= 80
// and Cout >= 64 are bound by their products instead.
//
// Both bodies share the function's contract:
//   * a block owns one batch row, TL = 128 positions and TCO (8-64)
//     output channels;
//   * input channels go in chunks: the chunk's TL + 2 rows (one halo row
//     each side) are normalised, FiLM-ed and SiLU-ed in f32 into shared
//     memory; rows outside [0, L) are 0 AFTER the activation (the conv's
//     SAME padding pads the activated signal, not silu(shift)), which also
//     masks a ragged tail;
//   * the epilogue adds the bias (and the residual) to the f32 sums, writes
//     y in x's dtype, and with STATS reduces y and y^2 of the f32 values
//     over the tile's positions into `seg`-wide channel segments: partials
//     (B, Cout / seg, n_tiles) that the caller sums (deterministic, no
//     atomics).  seg divides both the group size and TCO, so a segment
//     never straddles a group or a tile.
// Strides are arguments: x, y and the residual may be (B, L, C) views of
// (B, C, L) tensors.
//
// * bf16 (`fused_resblock_tc_kernel`, generation's path): the conv as a
//   GEMM on the tensor cores, M = the tile's 128 positions (m16 tiles),
//   N = the TCO output channels (n8 tiles), K = the input channels,
//   mma.sync.m16n8k16 bf16 in, f32 accumulate.  The chunk's activations
//   are staged position-major ([row][channel], bf16), so tap t reads the
//   same tile shifted by t rows: its A fragments come by ldmatrix from row
//   addresses offset by 0, 1 or 2.  The activation enters as hi + lo bf16
//   (its rounding and the rounded remainder, two products a tap): rounded
//   once it moves y by ~2^-9 of a term, which breaks the group sums' 1e-5
//   gate by 6-22x and brings y within 1.5x of its own (the CPU model in
//   tests/test_torch_fused_resblock.py).  Weights arrive as bf16
//   (3, Cout, Cp), C zero-padded to whole chunks, and are staged per chunk
//   by cp.async, laid out for the B fragment ([tap][co][ci]); x is read
//   into registers by 16-byte loads (where L is contiguous and aligned)
//   while the previous chunk's products run, then activated, split and
//   stored: a two-stage ring with one barrier a chunk.  Blocks of 8 warps
//   (one m16 tile each, chunks of 32 channels) serve the 32- and 64-channel
//   tiles, blocks of 4 warps (two m16 tiles each, chunks of 16) the 8- and
//   16-channel ones, whose C is 8-16 on the UNet's path; channels past C
//   are zeros.  Each chunk's products go to a partial sum added in f32
//   (the tensor cores truncate what they accumulate).  A block walks over
//   several tiles of its batch row (the grid holds about as many blocks as
//   the card runs at once), so the next tile's first chunk, and its
//   residual (by cp.async into one of two buffers), are in flight during
//   this tile's last products and epilogue.  The epilogue stages the f32
//   tile in shared memory, so y, the residual and the sums move as 16-byte
//   rows along L.  On an H100 neither its products, its activations nor its
//   stores (each removed in turn moved its time by under 15%), nor deeper
//   prefetch or longer tiles, set its time; what does is not measured
//   (PERF.md §6).
// * f32 (`fused_resblock_3xtf32_kernel`, fused training): the same GEMM
//   and the same scheme (blocks walking tiles, the next chunk in flight
//   during this one's products, an f32 epilogue tile) on mma.sync.m16n8k8
//   tf32 in 3xTF32, with csrc/tf32_mma.cuh's split: an f32 operand enters
//   as big = x rounded to tf32 and small = x - big (read truncated), a
//   product as small·big + big·small + big·big, small terms first (plain
//   TF32 misses y's 1e-5 gate by ~30x, the CPU model in
//   tests/test_torch_fused_resblock.py).  Chunks are 16 input channels for
//   every tile, each chunk's products in a partial sum added in f32.  Both
//   operands are split once, when staged: a weight is read by every warp of
//   the block, an activation by three taps, so splitting at the fragment
//   load would cost two integer operations and a subtract per value per
//   reader.  A staged row holds (big, small) of its 16 channels interleaved
//   by channel pairs (big c, small c, big c + 1, small c + 1), so lane
//   (g, t) of an mma takes channels 2t and 2t + 1 of its k8 step (as k = t
//   and t + 4, the k order of tf32_mma.cuh) in one 16-byte load; odd rows
//   swap their halves, which keeps the loads and stores free of bank
//   conflicts without padding.  x comes by cp.async into each thread's own
//   slots of a 3-stage ring, the weights (3, Cout, Cp) f32, scale and shift
//   into registers one step ahead; the residual is read in the epilogue.
//   On an H100 neither the products (a third of them, or none, moved K3 by
//   under 25%), the loads in flight (2 or 3 stages alike), nor the
//   activations set its time alone: at 64 output channels an SM holds one
//   block, whose staging, products and epilogue follow one another
//   (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ptx.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TL = 128;          // positions per block

struct ConvStrides {
  long long xb, xl, xc, yb, yl, yc, rb, rl, rc;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int ROWS = TL + 2;     // staged rows: positions l0 - 1 .. l0 + TL
constexpr int VECS = TL / 8;     // 8-position rows of a tile along L
constexpr int YP = TL + 4;       // pitch of the f32 tile of y (conflict-free)

// Warps a block: 8 (one m16 tile of positions each) for the 32- and
// 64-channel tiles, else 4 (two m16 tiles each), so that the 8-channel
// level, whose blocks do little work between their barriers, keeps four
// blocks an SM and four tiles' loads in flight (on an H100 the 32-channel
// tile ran K4's shapes 1.3x faster per forward with 8 warps, PERF.md §6).
template <int TCO>
__host__ __device__ constexpr int tc_warps() { return TCO >= 32 ? 8 : 4; }
template <int TCO>
__host__ __device__ constexpr int tc_threads() { return 32 * tc_warps<TCO>(); }
// Input channels a chunk: one staging item (two channels x 8 positions) a
// thread, so 32 (two k16 steps) with 8 warps and 16 with 4.
template <int TCO>
__host__ __device__ constexpr int tc_chunk() { return tc_threads<TCO>() / VECS * 2; }
// Row pitch, in bf16, of the staged activations and weights: 8 channels of
// padding put the eight 16-byte rows of every ldmatrix phase in distinct
// bank groups (pitch / 8 odd).
template <int TCO>
__host__ __device__ constexpr int tc_pitch() { return tc_chunk<TCO>() + 8; }
// Elements of one ring stage: activations hi, then lo (ROWS rows each), then
// the weights (3 taps x TCO rows).
template <int TCO>
__host__ __device__ constexpr int tc_stage() { return (2 * ROWS + 3 * TCO) * tc_pitch<TCO>(); }
constexpr int RP = TL + 8;  // pitch of the staged residual tile, in bf16
// Dynamic shared memory: the two-stage ring, the f32 tile of y (TCO x YP),
// the bias and the per-channel sums of the epilogue, then (RESIDUAL) two
// buffers of the residual tile (TCO x RP, bf16).
template <int TCO, bool RESIDUAL>
constexpr size_t tc_smem() {
  return 2 * tc_stage<TCO>() * sizeof(__nv_bfloat16) +
         (TCO * YP + 3 * TCO) * sizeof(float) +
         (RESIDUAL ? 2 * TCO * RP * sizeof(__nv_bfloat16) : 0);
}

__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bits(const __nv_bfloat16& v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float silu(float u) {
  return __fdividef(u, 1.f + __expf(-u));
}

// vec bits: the tensor (x 1, y 2, residual 4) has L contiguous, a 16-byte
// aligned address and batch and channel strides in multiples of 8, so its
// 8-position rows move as 16-byte loads and stores.
//
// A block walks over the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of
// one batch row and one channel tile (the grid holds about as many blocks
// as the card runs at once), in steps of one chunk: while a step's
// products and, after a tile's last chunk, its epilogue run, the next
// step's x is in flight into registers and its weights into the other
// stage of the ring.
template <int TCO, bool RESIDUAL, bool STATS>
__global__ void __launch_bounds__(tc_threads<TCO>(), 512 / tc_threads<TCO>())
fused_resblock_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ r,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_ss, int L, int C, int Cout,
                         int Cp, ConvStrides st, int seg, int vec) {
  constexpr int CK = tc_chunk<TCO>(), PH = tc_pitch<TCO>(), NT = TCO / 8;
  constexpr int THREADS_T = tc_threads<TCO>(), MT = 8 / tc_warps<TCO>();
  constexpr int PAIRS = CK / 2;        // channel pairs of a chunk
  constexpr int ITEMS = PAIRS * VECS;  // (pair, 8-position row) staging items
  constexpr int PER_WARP = 32 / PAIRS; // 8-position rows one warp stages
  constexpr int ROT = 8 / PER_WARP;    // see the stores below
  constexpr int KH = ROWS * PH;        // elements of one activation buffer
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ys = reinterpret_cast<float*>(ring + 2 * tc_stage<TCO>());
  float* bias_s = ys + TCO * YP;
  float* red_s = bias_s + TCO;
  float* red_ss = red_s + TCO;
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(red_ss + TCO);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, co0 = blockIdx.y * TCO;
  const int n_tiles = (L + TL - 1) / TL;
  const __nv_bfloat16* xb = x + b * st.xb;
  const float* scb = scale + (long long)b * C;
  const float* shb = shift + (long long)b * C;

  // This thread's staging item: channels c0 + 2·pair and + 1 at positions
  // l0 + 8v .. l0 + 8v + 7 (rows 8v + 1 .. 8v + 8 of the stage); the first
  // and last v also stage the halo row (0 or TL + 1).
  const bool stager = tid < ITEMS;
  const int pair = tid % PAIRS, v = tid / PAIRS;
  const bool halo = v == 0 || v == VECS - 1;
  uint32_t raw[2][4];  // bf16 of the 8 positions, two a word, per channel
  uint32_t raw_halo;   // bf16 of the halo position, channel 0 low
  float sc[2], sh[2];  // the two channels' scale and shift (0 past C)

  // chunk c0 of tile l0 of x into raw, by 16-byte loads where vec allows
  auto load_x = [&](int l0, int c0) {
    const int l = l0 + 8 * v;
    const int halo_pos = v == 0 ? l0 - 1 : l0 + TL;
    raw_halo = 0;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const int c = c0 + 2 * pair + ch;
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[ch][k] = 0;
      sc[ch] = sh[ch] = 0.f;
      if (!stager || c >= C) continue;
      sc[ch] = scb[c];
      sh[ch] = shb[c];
      const __nv_bfloat16* xc = xb + c * st.xc;
      if ((vec & 1) && l + 8 <= L) {
        const uint4 u = *reinterpret_cast<const uint4*>(xc + l);
        raw[ch][0] = u.x;
        raw[ch][1] = u.y;
        raw[ch][2] = u.z;
        raw[ch][3] = u.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (l + e < L) raw[ch][e >> 1] |= bits(xc[(l + e) * st.xl]) << (16 * (e & 1));
      }
      if (halo && halo_pos >= 0 && halo_pos < L)
        raw_halo |= bits(xc[halo_pos * st.xl]) << (16 * ch);
    }
  };

  // chunk c0 of the weights into stage s, by cp.async; rows of output
  // channels past Cout are zeros
  auto load_w = [&](int c0, int s) {
    __nv_bfloat16* ws = ring + s * tc_stage<TCO>() + 2 * KH;
    constexpr int kPieces = CK / 8;  // 16-byte pieces of a row
    for (int i = tid; i < 3 * TCO * kPieces; i += THREADS_T) {
      const int row = i / kPieces, piece = i % kPieces;  // row = tap·TCO + co
      const int tap = row / TCO, co = row % TCO;
      const bool in = co0 + co < Cout;
      const __nv_bfloat16* src =
          w + ((long long)tap * Cout + co0 + co) * Cp + c0 + 8 * piece;
      cp_async_16(ws + row * PH + 8 * piece, in ? src : w, in);
    }
    cp_async_commit();
  };

  // the residual tile at l0 into buffer rb of rs by cp.async (16-byte
  // rows along L), one tile ahead of its epilogue; rows past Cout and
  // positions past L are zeros
  auto load_r = [&](int l0, int rb) {
    for (int i = tid; i < TCO * VECS; i += THREADS_T) {
      const int o = i / VECS, vv = i % VECS;
      const int l = l0 + 8 * vv;
      const bool in = co0 + o < Cout && l < L;
      const __nv_bfloat16* src = r + b * st.rb + (long long)(co0 + o) * st.rc + l;
      cp_async_16(rs + (rb * TCO + o) * RP + 8 * vv, in ? src : r, in);
    }
    cp_async_commit();
  };

  // raw (chunk c0 of tile l0) -> normalised, FiLM-ed, SiLU-ed in f32,
  // split into hi + lo bf16 and stored into stage s.  A warp stores
  // PER_WARP rows v at once; its lanes of the k-th row (k = v % PER_WARP)
  // take the elements in an order rotated by k·ROT, so the rows written
  // together lie 8 ± ROT apart and their words in distinct banks.
  auto stage_x = [&](int l0, int c0, int s) {
    if (!stager) return;
    __nv_bfloat16* hi = ring + s * tc_stage<TCO>();
    __nv_bfloat16* lo = hi + KH;
    bool cin[2];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) cin[ch] = c0 + 2 * pair + ch < C;
    float h[2][8];
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t word = raw[ch][e >> 1];
        const float xv = (e & 1) ? hi_bf16(word) : lo_bf16(word);
        const bool in = cin[ch] && l0 + 8 * v + e < L;
        h[ch][e] = in ? silu(fmaf(xv, sc[ch], sh[ch])) : 0.f;
      }
    const int k = v % PER_WARP;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = h[0][j], bb = h[1][j];
      int e = j;
#pragma unroll
      for (int kk = 1; kk < PER_WARP; ++kk) {
        if (k == kk) {
          e = (j + kk * ROT) & 7;
          a = h[0][(j + kk * ROT) & 7];
          bb = h[1][(j + kk * ROT) & 7];
        }
      }
      const uint32_t hv = pack2(a, bb);
      const int at = (8 * v + e + 1) * PH + 2 * pair;
      *reinterpret_cast<uint32_t*>(hi + at) = hv;
      *reinterpret_cast<uint32_t*>(lo + at) = pack2(a - lo_bf16(hv), bb - hi_bf16(hv));
    }
    if (halo) {
      const int halo_pos = v == 0 ? l0 - 1 : l0 + TL;
      float hh[2];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const float xv = ch ? hi_bf16(raw_halo) : lo_bf16(raw_halo);
        const bool in = cin[ch] && halo_pos >= 0 && halo_pos < L;
        hh[ch] = in ? silu(fmaf(xv, sc[ch], sh[ch])) : 0.f;
      }
      const uint32_t hv = pack2(hh[0], hh[1]);
      const int at = (v == 0 ? 0 : TL + 1) * PH + 2 * pair;
      *reinterpret_cast<uint32_t*>(hi + at) = hv;
      *reinterpret_cast<uint32_t*>(lo + at) =
          pack2(hh[0] - lo_bf16(hv), hh[1] - hi_bf16(hv));
    }
  };

  // The tile at l0 from its f32 sums acc: bias, residual, y, and with
  // STATS the partial sums of its (tile, segment) cells.
  auto epilogue = [&](int tile, int l0, int rb, const float (&acc)[MT][NT][4]) {
    // the f32 tile into shared memory as [co][position]; the last reader of
    // the previous tile's passed a barrier of the chunk loop since
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ys[(8 * j + 2 * t + (e & 1)) * YP + 16 * (MT * warp + m) + g + 8 * (e >> 1)] =
              acc[m][j][e];
    __syncthreads();
    // one (channel, 8-position row) item a thread at a time; its sums are
    // reduced over the 16 rows of the channel (the 16 lanes of a half
    // warp) in a fixed order
    for (int i = tid; i < TCO * VECS; i += THREADS_T) {
      const int o = i / VECS, vv = i % VECS;
      const int co = co0 + o, l = l0 + 8 * vv;
      const bool live = co < Cout;
      const float4 y0 = *reinterpret_cast<const float4*>(ys + o * YP + 8 * vv);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + o * YP + 8 * vv + 4);
      const float bi = bias_s[o];
      float val[8] = {y0.x + bi, y0.y + bi, y0.z + bi, y0.w + bi,
                      y1.x + bi, y1.y + bi, y1.z + bi, y1.w + bi};
      const bool full = l + 8 <= L;
      if constexpr (RESIDUAL) {
        if (live) {
          const __nv_bfloat16* rp = r + b * st.rb + co * st.rc;
          if (vec & 4) {
            const uint4 u =
                *reinterpret_cast<const uint4*>(rs + (rb * TCO + o) * RP + 8 * vv);
            const uint32_t wds[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              val[e] += (e & 1) ? hi_bf16(wds[e >> 1]) : lo_bf16(wds[e >> 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (l + e < L) val[e] += __bfloat162float(rp[(l + e) * st.rl]);
          }
        }
      }
      if (live) {
        __nv_bfloat16* yp = y + b * st.yb + co * st.yc;
        if ((vec & 2) && full) {
          uint4 u;
          u.x = pack2(val[0], val[1]);
          u.y = pack2(val[2], val[3]);
          u.z = pack2(val[4], val[5]);
          u.w = pack2(val[6], val[7]);
          *reinterpret_cast<uint4*>(yp + l) = u;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (l + e < L) yp[(l + e) * st.yl] = __float2bfloat16(val[e]);
        }
      }
      if constexpr (STATS) {
        float ps = 0.f, pq = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (live && l + e < L) {
            ps += val[e];
            pq += val[e] * val[e];
          }
        }
#pragma unroll
        for (int off = VECS / 2; off > 0; off >>= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
          pq += __shfl_xor_sync(0xffffffffu, pq, off);
        }
        if (vv == 0) {
          red_s[o] = ps;
          red_ss[o] = pq;
        }
      }
    }
    if constexpr (STATS) {
      __syncthreads();
      if (tid < TCO / seg) {
        const int o = co0 + tid * seg;
        if (o < Cout) {  // seg divides Cout: the whole segment lies inside
          float s = 0.f, q = 0.f;
          for (int k = 0; k < seg; ++k) {
            s += red_s[tid * seg + k];
            q += red_ss[tid * seg + k];
          }
          const long long at = ((long long)b * (Cout / seg) + o / seg) * n_tiles + tile;
          part_s[at] = s;
          part_ss[at] = q;
        }
      }
    }
  };

  float acc[MT][NT][4];  // the warp's MT m16 tiles x NT n8 tiles
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (tid < TCO) bias_s[tid] = co0 + tid < Cout ? bias[co0 + tid] : 0.f;
  const int chunks = Cp / CK;
  // the step: tile, chunk, ring stage; the tile's residual buffer
  int tile = blockIdx.x, c = 0, s = 0, rb = 0;
  if constexpr (RESIDUAL) {
    if (vec & 4) load_r(tile * TL, 0);
  }
  load_x(tile * TL, 0);
  load_w(0, 0);
  for (;;) {
    const int l0 = tile * TL;
    stage_x(l0, c * CK, s);
    // this step's weights have landed and every thread has staged its part
    // of x; every warp is done with the previous step, whose stage the next
    // weights overwrite
    cp_async_wait_all();
    __syncthreads();
    // the next step: the next chunk of this tile, else the first chunk of
    // the block's next tile
    const bool last = c + 1 == chunks;
    const int next_tile = last ? tile + gridDim.x : tile;
    const int next_c = last ? 0 : c + 1;
    const bool more = next_tile < n_tiles;
    if constexpr (RESIDUAL) {
      if (last && more && (vec & 4)) load_r(next_tile * TL, rb ^ 1);
    }
    if (more) {
      load_x(next_tile * TL, next_c * CK);
      load_w(next_c * CK, s ^ 1);
    }
    const __nv_bfloat16* hi = ring + s * tc_stage<TCO>();
    const __nv_bfloat16* lo = hi + KH;
    const __nv_bfloat16* ws = lo + KH;
    // this chunk's products go to a partial sum added to acc in f32
    float part[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        // B: rows co of tap `tap`, channels 16kk .. 16kk + 15, for every
        // n-tile; shared by the warp's m16 tiles
        const __nv_bfloat16* wt = ws + tap * TCO * PH + 16 * kk + 8 * ((lane >> 3) & 1);
        uint32_t bq[NT][2];
        if constexpr (NT == 1) {
          ldsm_x2(bq[0], wt + (lane & 7) * PH);
        } else {
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t q4[4];
            ldsm_x4(q4, wt + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * PH);
            bq[2 * jp][0] = q4[0];
            bq[2 * jp][1] = q4[1];
            bq[2 * jp + 1][0] = q4[2];
            bq[2 * jp + 1][1] = q4[3];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A: rows 16·(MT·warp + m) + tap .. + 15 (positions shifted by
          // the tap), the same channels
          const int at = (16 * (MT * warp + m) + tap + (lane & 15)) * PH + 16 * kk +
                         8 * (lane >> 4);
          uint32_t ah[4], al[4];
          ldsm_x4(ah, hi + at);
          ldsm_x4(al, lo + at);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16816(part[m][j], al, bq[j][0], bq[j][1]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_16816(part[m][j], ah, bq[j][0], bq[j][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
    if (last) {
      epilogue(tile, l0, rb, acc);
      rb ^= 1;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    if (!more) break;
    tile = next_tile;
    c = next_c;
    s ^= 1;
  }
}

// ---------------------------------------------------------------------------
// f32: tensor cores, mma.sync m16n8k8 tf32, 3xTF32
// ---------------------------------------------------------------------------

constexpr int FK = 16;  // input channels a chunk, every tile
// Words of a staged row: (big, small) of FK channels, no padding.  Odd rows
// keep the two 16-word halves of a row swapped (`swz`), so that the two
// rows of one 16-byte load phase (8 lanes, rows r and r + 1) fall in
// distinct banks.
constexpr int FP = 2 * FK;
__device__ __forceinline__ int swz(int row) { return (row & 1) << 4; }
// Stages of the x ring: a thread's copies of x run FD - 1 steps ahead of
// their use.
constexpr int FD = 3;
// Floats of one stage of the operand ring: the activations (ROWS rows),
// then the weights (3 taps x TCO rows).
template <int TCO>
__host__ __device__ constexpr int f32_stage() { return (ROWS + 3 * TCO) * FP; }
// Floats of one stage of the x ring: 8 positions and a halo value of each
// channel of the block's staging items.
constexpr int F32_RING = 9 * FK * VECS;
// Dynamic shared memory: the two-stage operand ring, the f32 tile of y
// (TCO x YP), the bias and the per-channel sums of the epilogue, the x ring.
template <int TCO>
__host__ __device__ constexpr size_t f32_smem() {
  return (2 * f32_stage<TCO>() + TCO * YP + 3 * TCO + FD * F32_RING) * sizeof(float);
}
// Blocks an SM holds by shared memory (228 KB an SM, 1 KB of it reserved a
// block), at most 2048 threads: the launch bound lets each block take all
// the registers its share of the SM leaves it.
template <int TCO>
__host__ __device__ constexpr int f32_blocks() {
  const int by_smem = static_cast<int>(233472 / (f32_smem<TCO>() + 1024));
  const int by_threads = 2048 / tc_threads<TCO>();
  return by_smem < by_threads ? (by_smem > 0 ? by_smem : 1) : by_threads;
}

// (big, small) of f32 values, as tf32_mma.cuh splits them, in the order a
// staged row keeps them
__device__ __forceinline__ float2 split2(float v) {
  uint32_t big, small;
  split(v, big, small);
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}
__device__ __forceinline__ float4 split4(float a, float b) {
  const float2 u = split2(a), w = split2(b);
  return make_float4(u.x, u.y, w.x, w.y);
}

// vec bits as the bf16 body's, for f32: L contiguous, a 16-byte aligned
// address, batch and channel strides in multiples of 4, so 4-position rows
// move as 16-byte copies and stores.
//
// The step loop is the bf16 body's: a block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of one batch row and one channel tile in
// steps of one chunk.  A thread stages CPI channels of 8 positions (CPI = 1
// with 8 warps, 2 with 4) and up to WP 4-channel pieces of the weights.  Its
// x comes by cp.async into its own slots of the x ring, FD - 1 steps ahead,
// so its own wait_group makes them visible and no barrier is needed; the
// weights, scale and shift (L2-resident) come into registers one step
// ahead.
template <int TCO, bool RESIDUAL, bool STATS>
__global__ void __launch_bounds__(tc_threads<TCO>(), f32_blocks<TCO>())
fused_resblock_3xtf32_kernel(const float* __restrict__ x,
                             const float* __restrict__ scale,
                             const float* __restrict__ shift,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* __restrict__ r, float* __restrict__ y,
                             float* __restrict__ part_s, float* __restrict__ part_ss,
                             int L, int C, int Cout, int Cp, ConvStrides st, int seg,
                             int vec) {
  constexpr int NT = TCO / 8, THREADS_T = tc_threads<TCO>(), MT = 8 / tc_warps<TCO>();
  constexpr int CPI = FK * VECS / THREADS_T;  // channels a staging item
  constexpr int GROUPS = FK / CPI;            // staging items along C
  constexpr int PIECES = 3 * TCO * (FK / 4);  // 4-channel pieces of the weights
  constexpr int WP = (PIECES + THREADS_T - 1) / THREADS_T;
  constexpr int JG = NT < 4 ? NT : 4;         // n-tiles a group of products
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* ys = ring + 2 * f32_stage<TCO>();
  float* bias_s = ys + TCO * YP;
  float* red_s = bias_s + TCO;
  float* red_ss = red_s + TCO;
  // x ring, stage d: float4 k·2 + h (channel k, positions 4h .. 4h + 3) of
  // thread i at xq[(d·2·CPI + 2k + h)·THREADS + i], its halo value of
  // channel k at xh[(d·CPI + k)·THREADS + i]: a phase's lanes hit
  // consecutive words
  float4* xq = reinterpret_cast<float4*>(red_ss + TCO);
  float* xh = reinterpret_cast<float*>(xq + FD * 2 * CPI * THREADS_T);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, co0 = blockIdx.y * TCO;
  const int n_tiles = (L + TL - 1) / TL;
  const float* xb = x + b * st.xb;
  const float* scb = scale + (long long)b * C;
  const float* shb = shift + (long long)b * C;

  // This thread's staging item: channels c0 + CPI·grp .. + CPI - 1 at
  // positions l0 + 8v .. l0 + 8v + 7 (rows 8v + 1 .. 8v + 8 of the stage);
  // the first and last v also stage the halo row (0 or TL + 1).
  const int grp = tid % GROUPS, v = tid / GROUPS;
  const bool halo = v == 0 || v == VECS - 1;
  float sc[CPI], sh[CPI];
  float4 wr[WP];

  // chunk c0 of tile l0 of x into stage d of the x ring, as one cp.async
  // group: 16-byte copies where vec allows and the 4 positions lie in
  // [0, L), else 4-byte ones; positions outside [0, L) and channels past C
  // are left out (stage masks them)
  auto copy_x = [&](int l0, int c0, int d) {
#pragma unroll
    for (int k = 0; k < CPI; ++k) {
      const int c = c0 + CPI * grp + k;
      if (c >= C) continue;
      const float* xc = xb + c * st.xc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + 8 * v + 4 * h;
        float* dst = reinterpret_cast<float*>(xq + (d * 2 * CPI + 2 * k + h) * THREADS_T + tid);
        if ((vec & 1) && l + 4 <= L) {
          cp_async_16(dst, xc + l, true);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (l + e < L) cp_async_4(dst + e, xc + (l + e) * st.xl, true);
        }
      }
      const int halo_pos = v == 0 ? l0 - 1 : l0 + TL;
      if (halo && halo_pos >= 0 && halo_pos < L)
        cp_async_4(xh + (d * CPI + k) * THREADS_T + tid, xc + halo_pos * st.xl, true);
    }
    cp_async_commit();
  };

  // chunk c0's scale and shift (0 past C) and weights into registers:
  // piece i of the weights is row i / 4 (tap·TCO + co) and channels
  // c0 + 4(i % 4) .. + 3; rows past Cout are zeros
  auto load_regs = [&](int c0) {
#pragma unroll
    for (int k = 0; k < CPI; ++k) {
      const int c = c0 + CPI * grp + k;
      sc[k] = c < C ? scb[c] : 0.f;
      sh[k] = c < C ? shb[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < WP; ++k) {
      const int i = tid + k * THREADS_T;
      const int row = i / 4, tap = row / TCO, co = row % TCO;
      wr[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < PIECES && co0 + co < Cout)
        wr[k] = *reinterpret_cast<const float4*>(
            w + ((long long)tap * Cout + co0 + co) * Cp + c0 + 4 * (i % 4));
    }
  };

  // the activated value (0 past C and outside [0, L))
  auto act = [&](int k, float xv, bool in) {
    return in ? silu(fmaf(xv, sc[k], sh[k])) : 0.f;
  };

  // stage d of the x ring and the registers -> normalised, FiLM-ed,
  // SiLU-ed, split, stored into stage s of the operand ring
  auto stage = [&](int l0, int c0, int s, int d) {
    float* a = ring + s * f32_stage<TCO>();
    float xv[CPI][8], xhalo[CPI];
    bool cin[CPI];
#pragma unroll
    for (int k = 0; k < CPI; ++k) {
      cin[k] = c0 + CPI * grp + k < C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q = xq[(d * 2 * CPI + 2 * k + h) * THREADS_T + tid];
        xv[k][4 * h] = q.x;
        xv[k][4 * h + 1] = q.y;
        xv[k][4 * h + 2] = q.z;
        xv[k][4 * h + 3] = q.w;
      }
      xhalo[k] = xh[(d * CPI + k) * THREADS_T + tid];
    }
    // channel CPI·grp + k of a row sits at word 4·(its pair) + 2·(its
    // parity), swizzled
    const int at = 2 * CPI * grp;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = l0 + 8 * v + e < L;
      const int row = 8 * v + e + 1;
      float* dst = a + row * FP + (at ^ swz(row));
      if constexpr (CPI == 2) {
        *reinterpret_cast<float4*>(dst) =
            split4(act(0, xv[0][e], cin[0] && in), act(1, xv[1][e], cin[1] && in));
      } else {
        *reinterpret_cast<float2*>(dst) = split2(act(0, xv[0][e], cin[0] && in));
      }
    }
    if (halo) {
      const int halo_pos = v == 0 ? l0 - 1 : l0 + TL;
      const bool in = halo_pos >= 0 && halo_pos < L;
      const int row = v == 0 ? 0 : TL + 1;
      float* dst = a + row * FP + (at ^ swz(row));
      if constexpr (CPI == 2) {
        *reinterpret_cast<float4*>(dst) =
            split4(act(0, xhalo[0], cin[0] && in), act(1, xhalo[1], cin[1] && in));
      } else {
        *reinterpret_cast<float2*>(dst) = split2(act(0, xhalo[0], cin[0] && in));
      }
    }
    // the weights: piece i's 4 channels are words 8(i % 4) .. + 7 of row
    // i / 4; odd rows store their two halves in the other order, so that
    // the rows of a store phase fall in distinct banks
    float* ws = a + ROWS * FP;
#pragma unroll
    for (int k = 0; k < WP; ++k) {
      const int i = tid + k * THREADS_T;
      if (i >= PIECES) continue;
      const int row = i / 4, odd = row & 1;
      float* dst = ws + row * FP;
      const float4 lo = split4(wr[k].x, wr[k].y), hi = split4(wr[k].z, wr[k].w);
      *reinterpret_cast<float4*>(dst + ((8 * (i % 4) + 4 * odd) ^ swz(row))) = odd ? hi : lo;
      *reinterpret_cast<float4*>(dst + ((8 * (i % 4) + 4 - 4 * odd) ^ swz(row))) =
          odd ? lo : hi;
    }
  };

  // The tile at l0 from its f32 sums acc: bias, residual, y, and with
  // STATS the partial sums of its (tile, segment) cells (the bf16 body's
  // epilogue, with f32 rows and the residual read here).
  auto epilogue = [&](int tile, int l0, const float (&acc)[MT][NT][4]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ys[(8 * j + 2 * t + (e & 1)) * YP + 16 * (MT * warp + m) + g + 8 * (e >> 1)] =
              acc[m][j][e];
    __syncthreads();
    for (int i = tid; i < TCO * VECS; i += THREADS_T) {
      const int o = i / VECS, vv = i % VECS;
      const int co = co0 + o, l = l0 + 8 * vv;
      const bool live = co < Cout;
      const bool full = l + 8 <= L;
      const float4 y0 = *reinterpret_cast<const float4*>(ys + o * YP + 8 * vv);
      const float4 y1 = *reinterpret_cast<const float4*>(ys + o * YP + 8 * vv + 4);
      const float bi = bias_s[o];
      float val[8] = {y0.x + bi, y0.y + bi, y0.z + bi, y0.w + bi,
                      y1.x + bi, y1.y + bi, y1.z + bi, y1.w + bi};
      if constexpr (RESIDUAL) {
        if (live) {
          const float* rp = r + b * st.rb + co * st.rc;
          if ((vec & 4) && full) {
            const float4 r0 = *reinterpret_cast<const float4*>(rp + l);
            const float4 r1 = *reinterpret_cast<const float4*>(rp + l + 4);
            val[0] += r0.x;
            val[1] += r0.y;
            val[2] += r0.z;
            val[3] += r0.w;
            val[4] += r1.x;
            val[5] += r1.y;
            val[6] += r1.z;
            val[7] += r1.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (l + e < L) val[e] += rp[(l + e) * st.rl];
          }
        }
      }
      if (live) {
        float* yp = y + b * st.yb + co * st.yc;
        if ((vec & 2) && full) {
          *reinterpret_cast<float4*>(yp + l) = make_float4(val[0], val[1], val[2], val[3]);
          *reinterpret_cast<float4*>(yp + l + 4) =
              make_float4(val[4], val[5], val[6], val[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (l + e < L) yp[(l + e) * st.yl] = val[e];
        }
      }
      if constexpr (STATS) {
        float ps = 0.f, pq = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (live && l + e < L) {
            ps += val[e];
            pq += val[e] * val[e];
          }
        }
#pragma unroll
        for (int off = VECS / 2; off > 0; off >>= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
          pq += __shfl_xor_sync(0xffffffffu, pq, off);
        }
        if (vv == 0) {
          red_s[o] = ps;
          red_ss[o] = pq;
        }
      }
    }
    if constexpr (STATS) {
      __syncthreads();
      if (tid < TCO / seg) {
        const int o = co0 + tid * seg;
        if (o < Cout) {  // seg divides Cout: the whole segment lies inside
          float s = 0.f, q = 0.f;
          for (int k = 0; k < seg; ++k) {
            s += red_s[tid * seg + k];
            q += red_ss[tid * seg + k];
          }
          const long long at = ((long long)b * (Cout / seg) + o / seg) * n_tiles + tile;
          part_s[at] = s;
          part_ss[at] = q;
        }
      }
    }
  };

  float acc[MT][NT][4];  // the warp's MT m16 tiles x NT n8 tiles
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (tid < TCO) bias_s[tid] = co0 + tid < Cout ? bias[co0 + tid] : 0.f;
  const int chunks = Cp / FK;
  // the step: tile, chunk, operand stage s, x stage d; the step whose x is
  // copied next: tile ni, chunk nc (FD - 1 steps ahead)
  int tile = blockIdx.x, c = 0, s = 0, d = 0;
  int ni = tile, nc = 0;
  auto advance = [&](int& tl, int& ch) {
    if (++ch == chunks) {
      ch = 0;
      tl += gridDim.x;
    }
  };
#pragma unroll
  for (int k = 0; k < FD - 1; ++k) {
    if (ni < n_tiles) copy_x(ni * TL, nc * FK, k);
    else cp_async_commit();  // one group a step, so the waits count right
    advance(ni, nc);
  }
  load_regs(0);
  for (;;) {
    const int l0 = tile * TL;
    cp_async_wait<FD - 2>();  // this step's x has landed
    stage(l0, c * FK, s, d);
    // every thread has staged its part of this step; every warp is done
    // with the previous step, whose operand stage the next one overwrites
    __syncthreads();
    // x FD - 1 steps ahead into the x stage this thread read last step
    const int dn = d == 0 ? FD - 1 : d - 1;
    if (ni < n_tiles) copy_x(ni * TL, nc * FK, dn);
    else cp_async_commit();
    advance(ni, nc);
    const bool last = c + 1 == chunks;
    const int next_tile = last ? tile + gridDim.x : tile;
    const int next_c = last ? 0 : c + 1;
    const bool more = next_tile < n_tiles;
    if (more) load_regs(next_c * FK);
    const float* a = ring + s * f32_stage<TCO>();
    const float* ws = a + ROWS * FP;
    // this chunk's products go to a partial sum added to acc in f32
    float part[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FK / 8; ++kk) {
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        // A: rows 16·(MT·warp + m) + tap + g and + 8 (positions shifted by
        // the tap, one parity), channels 8kk + 2t and + 1 as k = t and t + 4
        uint32_t ab[MT][4], am[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int row = 16 * (MT * warp + m) + tap + g;
          const float* p = a + row * FP + ((16 * kk + 4 * t) ^ swz(row));
          const float4 u0 = *reinterpret_cast<const float4*>(p);
          const float4 u1 = *reinterpret_cast<const float4*>(p + 8 * FP);
          ab[m][0] = __float_as_uint(u0.x);
          ab[m][1] = __float_as_uint(u1.x);
          ab[m][2] = __float_as_uint(u0.z);
          ab[m][3] = __float_as_uint(u1.z);
          am[m][0] = __float_as_uint(u0.y);
          am[m][1] = __float_as_uint(u1.y);
          am[m][2] = __float_as_uint(u0.w);
          am[m][3] = __float_as_uint(u1.w);
        }
#pragma unroll
        for (int jp = 0; jp < NT; jp += JG) {
          // B: rows tap·TCO + 8j + g (parity that of g), the same channels
          uint32_t bb[JG][2], bm[JG][2];
#pragma unroll
          for (int u = 0; u < JG; ++u) {
            const float4 q = *reinterpret_cast<const float4*>(
                ws + (tap * TCO + 8 * (jp + u) + g) * FP + ((16 * kk + 4 * t) ^ swz(g)));
            bb[u][0] = __float_as_uint(q.x);
            bb[u][1] = __float_as_uint(q.z);
            bm[u][0] = __float_as_uint(q.y);
            bm[u][1] = __float_as_uint(q.w);
          }
          // small·big, big·small, big·big, pass by pass over MT·JG
          // independent accumulators
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int u = 0; u < JG; ++u)
              mma_1688_tf32(part[m][jp + u], am[m], bb[u][0], bb[u][1]);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int u = 0; u < JG; ++u)
              mma_1688_tf32(part[m][jp + u], ab[m], bm[u][0], bm[u][1]);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int u = 0; u < JG; ++u)
              mma_1688_tf32(part[m][jp + u], ab[m], bb[u][0], bb[u][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
    if (last) {
      epilogue(tile, l0, acc);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
    if (!more) break;
    tile = next_tile;
    c = next_c;
    s ^= 1;
    d = d == FD - 1 ? 0 : d + 1;
  }
  cp_async_wait_all();  // nothing in flight at exit
}

// ---------------------------------------------------------------------------
// launch, and dispatch on the type, the output-channel tile and the mode
// ---------------------------------------------------------------------------

struct Args {
  const void *x;
  const float *scale, *shift;
  const void* w;
  const float* bias;
  const void* r;
  void* y;
  float *part_s, *part_ss;
  int B, L, C, Cout, Cp;
  ConvStrides st;
  int seg, vec;
  cudaStream_t stream;
};

// T: float (the 3xTF32 body) or __nv_bfloat16 (the bf16 body)
template <typename T, int TCO, bool RESIDUAL, bool STATS>
int launch(const Args& a) {
  constexpr bool F32 = std::is_same_v<T, float>;
  auto kernel = [] {
    if constexpr (F32)
      return fused_resblock_3xtf32_kernel<TCO, RESIDUAL, STATS>;
    else
      return fused_resblock_tc_kernel<TCO, RESIDUAL, STATS>;
  }();
  constexpr size_t smem = F32 ? f32_smem<TCO>() : tc_smem<TCO, RESIDUAL>();
  // as many blocks as the card runs at once (asked once per instantiation)
  static const int resident = [&] {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tc_threads<TCO>(),
                                                      smem) != cudaSuccess)
      return 0;
    return sms * per_sm;
  }();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (a.L + TL - 1) / TL;
  const int rows = (a.Cout + TCO - 1) / TCO * a.B;  // (channel tile, batch) rows
  // blocks a row: f32 never more blocks than run at once (where an SM holds
  // one block, a second, partial wave of blocks doubled a call's time on an
  // H100); bf16 rounds up
  int per_row = F32 ? resident / rows : (resident + rows - 1) / rows;
  if (per_row < 1) per_row = 1;
  const dim3 grid(per_row < n_tiles ? per_row : n_tiles, rows / a.B, a.B);
  kernel<<<grid, tc_threads<TCO>(), smem, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.shift, static_cast<const T*>(a.w), a.bias,
      static_cast<const T*>(a.r), static_cast<T*>(a.y), a.part_s, a.part_ss, a.L, a.C,
      a.Cout, a.Cp, a.st, a.seg, a.vec);
  return 0;
}

template <typename T, bool RESIDUAL, bool STATS>
int by_tile(int tco, const Args& a) {
  switch (tco) {
    case 8:
      return launch<T, 8, RESIDUAL, STATS>(a);
    case 16:
      return launch<T, 16, RESIDUAL, STATS>(a);
    case 32:
      return launch<T, 32, RESIDUAL, STATS>(a);
    case 64:
      return launch<T, 64, RESIDUAL, STATS>(a);
    default:
      return -1;
  }
}

template <typename T>
int by_mode(int residual, int stats, int tco, const Args& a) {
  if (!residual && !stats) return by_tile<T, false, false>(tco, a);
  if (!residual && stats) return by_tile<T, false, true>(tco, a);
  if (residual && stats) return by_tile<T, true, true>(tco, a);
  return -1;  // a residual without the statistics is not a path of the UNet
}

// Whether a (B, L, C) tensor of `esize`-byte elements moves as 16-byte rows
// along L: L contiguous, a 16-byte aligned address, batch and channel
// strides in multiples of 16 bytes.
bool rows16(const void* p, long long sb, long long sl, long long sc, int esize) {
  const int per = 16 / esize;
  return sl == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % per == 0 &&
         sc % per == 0;
}

int chunk_of(int dtype, int tco) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (tco) {
    case 8:
      return dtype == 0 ? FK : tc_chunk<8>();
    case 16:
      return dtype == 0 ? FK : tc_chunk<16>();
    case 32:
      return dtype == 0 ? FK : tc_chunk<32>();
    case 64:
      return dtype == 0 ? FK : tc_chunk<64>();
    default:
      return -1;
  }
}

template <bool RESIDUAL>
int tc_smem_of(int tco) {
  switch (tco) {
    case 8:
      return static_cast<int>(tc_smem<8, RESIDUAL>());
    case 16:
      return static_cast<int>(tc_smem<16, RESIDUAL>());
    case 32:
      return static_cast<int>(tc_smem<32, RESIDUAL>());
    default:
      return static_cast<int>(tc_smem<64, RESIDUAL>());
  }
}

int f32_smem_of(int tco) {
  switch (tco) {
    case 8:
      return static_cast<int>(f32_smem<8>());
    case 16:
      return static_cast<int>(f32_smem<16>());
    case 32:
      return static_cast<int>(f32_smem<32>());
    default:
      return static_cast<int>(f32_smem<64>());
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (x, the weight, the residual and y share
// it).  scale and shift: (B, C) f32 contiguous; bias: (Cout,) f32.  The
// weight is (3, Cout, Cp) contiguous, its channels zero-padded to Cp, a
// multiple of fused_resblock_chunk(dtype, tco) at least C.  strides: x, y,
// residual, each (batch, position, channel), in elements.  With stats,
// part_s and part_ss are (B, Cout / seg, ceil(L / 128)) f32.  tco: 8, 16,
// 32 or 64 output channels per block.  Returns -1 for an argument it does
// not take, else the launch's cudaError_t.
extern "C" int fused_resblock(int dtype, int residual, int stats, int tco,
                              const void* x, const float* scale, const float* shift,
                              const void* w, const float* bias, const void* r,
                              void* y, float* part_s, float* part_ss, int B, int L,
                              int C, int Cout, int Cp, const long long* strides,
                              int seg, void* stream) {
  const int chunk = chunk_of(dtype, tco);
  if (chunk < 0 || B <= 0 || L <= 0 || C <= 0 || Cout <= 0 || Cp < C ||
      Cp % chunk || (stats && (seg <= 0 || tco % seg)))
    return -1;
  Args a{x, scale, shift, w, bias, r, y, part_s, part_ss, B, L, C, Cout, Cp,
         {strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
          strides[6], strides[7], strides[8]},
         seg, 0, static_cast<cudaStream_t>(stream)};
  const ConvStrides& st = a.st;
  const int esize = dtype == 0 ? 4 : 2;
  a.vec = (rows16(x, st.xb, st.xl, st.xc, esize) ? 1 : 0) |
          (rows16(y, st.yb, st.yl, st.yc, esize) ? 2 : 0) |
          (residual && rows16(r, st.rb, st.rl, st.rc, esize) ? 4 : 0);
  const int err = dtype == 0 ? by_mode<float>(residual, stats, tco, a)
                             : by_mode<__nv_bfloat16>(residual, stats, tco, a);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The input channels of one staged chunk of the kernel for dtype and tco
// (the weight's channels are padded to a multiple of it), -1 for an
// argument it does not take.
extern "C" int fused_resblock_chunk(int dtype, int tco) { return chunk_of(dtype, tco); }

// The dynamic shared memory in bytes that a launch for dtype, tco and
// residual asks for, -1 for an argument it does not take.
extern "C" int fused_resblock_smem(int dtype, int tco, int residual) {
  if (chunk_of(dtype, tco) < 0) return -1;
  if (dtype == 0) return f32_smem_of(tco);
  return residual ? tc_smem_of<true>(tco) : tc_smem_of<false>(tco);
}
