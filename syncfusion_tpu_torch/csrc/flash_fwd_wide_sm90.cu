// Flash-attention forward (K1) for heads wider than 128 on Hopper (sm_90a),
// at every head width W that is a multiple of 64 from 192 to 512.
//
// Replaces, at those widths, the TPU kernel `_flash_kernel` of
// syncfusion_tpu/ops/attention.py (its `pl.pallas_call` in `_flash_fwd`),
// whose BlockSpecs carry the full head width.  It computes the same
// function as flash_fwd.cu: for each (batch, head), O = softmax(q kᵀ·scale)
// V with an f32 online softmax, O in the input type and the row logsumexp
// of the scaled logits as a (B, H, Lq) f32 array, with an optional causal
// (top-left aligned) mask.  The wrapper zero-pads a head to W and passes
// the true width's scale (the zero columns change no logit and come out 0).
//
// What bounds it: per (batch, head) 4·T²·W operations against 4·T·W
// elements moved, T / 2 operations a byte in bf16 and T / 4 in f32: above
// the card's ridge (~295 in bf16, ~49 for 3xTF32) at the UNet's T = 2048
// and 1024, so the tensor cores' rate.
//
// The design (one launch a call; no atomics, so O and the LSE are the same
// bits from run to run):
//
// * Loads.  q, k and v are read by TMA (cp.async.bulk.tensor, sm90.cuh)
//   through 4-D tensor maps (W, L, H, B) built on the host per call from
//   the (B, L, H, W) strides, so they may be views of one packed qkv
//   projection.  Boxes are 128 bytes wide (64 bf16 or 32 f32 columns, the
//   limit of the 128-byte swizzle) by the tile's rows; a tile of W columns
//   is W / 64 (bf16) or W / 32 (f32) boxes, each on a 1024-byte boundary.
//   Rows past L land as 0 (TMA's out-of-bounds fill) and logits past L are
//   masked.  One lane loads the block's q tiles once, then the K and V
//   tiles, alternately, into a ring of two slots; each slot has a `full`
//   mbarrier (armed with the slot's bytes) and an `empty` one on which
//   every thread arrives when it is done reading, after which that lane
//   loads the slot's next tile.  The lane is thread 0 of the first
//   warpgroup, not a producer warp of its own: a ninth warp puts three
//   warps on some SM sub-partition (16,384 registers), and ptxas then caps
//   every thread at 168 registers, where O spilled; with a producer
//   warpgroup that gives its registers away (setmaxnreg 40, the others
//   232) ptxas (CUDA 12.8) still allocated 168 and spilled.  With 8 warps
//   a thread may take 255.
// * Two warpgroups, O at the full width in registers, S once a key tile a
//   group.  Up to 256 columns: a block is two 64-row q tiles, a group each,
//   each group all of its tile's O (128 registers a thread at W = 256), one
//   grid block per 128 q rows and (batch, head); the groups share every K
//   and V tile.  Above 256: a block is one 64-row q tile, each group holds
//   ceil or floor of half of O's 64-column pieces (at most 128 registers)
//   and computes the tile's S and online softmax itself (S twice a tile, no
//   exchange between the groups); neither recomputes S per chunk of O.
// * bf16: S and P·V on wgmma m64n64k16 (bf16 in, f32 accumulate), the
//   softmax in registers on S's accumulator (log2 domain, as flash_fwd.cu).
//   q and K enter S from shared memory, K-major; P enters P·V from
//   registers (S's accumulator layout is wgmma's A-fragment layout) as hi
//   + lo bf16, two products, as flash_fwd.cu's bf16 kernel feeds it (P
//   rounded once to bf16 moves O by up to 2^-9 of |O|); V is the B operand
//   as TMA lays it, MN-major.  Key tiles of 64.  Operations per (query,
//   key) pair, in units of W: S 2 a column group, P·V 2 x 2 = 4; with the
//   groups over the rows 6 against the function's 4 (1.5x, W = 192 and
//   256), over the columns 8 (2x, W = 320 to 512).
// * f32: 3xTF32 as flash_fwd.cu's f32 kernel (q, K, V and P as big + small
//   tf32 parts, each product as small·big + big·small + big·big, per-tile
//   partial sums added in f32) on mma.sync m16n8k8 tf32, 16 q rows a warp,
//   fragments read by the threads from the swizzled TMA tiles.  Not on
//   wgmma: a tf32 wgmma reads both operands K-major from shared memory, so
//   V would need a transposed copy, and q, K and Vᵀ each a small part,
//   written by threads beside the TMA tiles: 6 x 64·W·4 bytes at 64-key
//   tiles (295 KB at W = 192), above the 232,448 B of a block at every
//   width.  Key tiles of 32 (16 at W = 512, where the q tile alone takes
//   128 KB).  Operations, in tf32 products of 2·W per pair: S 3 a column
//   group, P·V 3; up to 256 columns 3·(2 + 2)W = 12W against the function's
//   4W (3x), above 3·(2·2 + 2)W = 18W (4.5x).  At the 2 x 256 UNet's
//   training call (4 x 2 heads, T = 2048, NVIDIA H100 80GB HBM3, 700 W) the
//   groups over the rows took 0.90 ms against 1.30 over the columns; over
//   the rows a block takes 128 q rows, so a short sequence fills fewer SMs
//   (B = 2 x 2 heads, T = 1024: 0.45 against 0.33).
//
// Shared memory: the q tiles (64·W elements each), two slots of a key
// tile, and the five barriers, with 1024 bytes for the alignment; `Plan`
// below sets each width's tiles (`flash_fwd_wide_plan` returns them, and
// syncfusion_tpu_torch/ops/attention.py's `wide_fwd_plan` mirrors them).
// Wider than 512, O of 64 rows no longer fits two groups' registers: heads
// that wide go to flash_wide.cu's chunked K1 (ops/attention.py's
// `kernel_source` picks the source by width).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"
#include "sm90_tiles.cuh"
#include "tensor_map.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kStages = 2;    // slots of the K/V ring
constexpr int kGroups = 2;    // warpgroups a block
constexpr int kThreadsWide = 128 * kGroups;
constexpr int kMaxWidth = 512;
constexpr size_t kSmemMax = 232448;

// Dynamic shared memory of a (type, width, q tiles, key tile): 1024 bytes
// for the alignment, the q tiles, the ring's slots, the five barriers.
template <typename T>
constexpr size_t wide_bytes(int width, int q_tiles, int key_tile) {
  return 1024 + size_t(q_tiles) * kQRows * width * sizeof(T) +
         kStages * size_t(key_tile) * width * sizeof(T) + 64;
}

// The tiles of one (type, width).  The two warpgroups split either the
// rows (up to 256 columns: a block of two 64-row q tiles, each group all
// of O's columns of its own tile) or O's columns (above 256: one q tile,
// each group ceil or floor of half of O's 64-column pieces, each computing
// the tile's S itself).
template <typename T, int kW>
struct Plan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kEsize = sizeof(T);
  static constexpr int kPieces = kW / kPiece;
  static constexpr int kRowGroups = kW <= 256 ? 2 : 1;
  static constexpr int kColGroups = kGroups / kRowGroups;
  static constexpr int kGroupPieces = (kPieces + kColGroups - 1) / kColGroups;
  static constexpr int kBlockRows = kQRows * kRowGroups;
  static constexpr int kBoxCols = 128 / kEsize;
  static constexpr int kBoxes = kW / kBoxCols;
  static constexpr size_t kQBytes = size_t(kQRows) * kW * kEsize;  // a tile
  static constexpr int kKeyTile =
      !kF32 ? 64 : (wide_bytes<T>(kW, kRowGroups, 32) <= kSmemMax ? 32 : 16);
  static constexpr size_t kSlotBytes = size_t(kKeyTile) * kW * kEsize;
  static constexpr size_t kSmem = wide_bytes<T>(kW, kRowGroups, kKeyTile);
  static constexpr uint32_t kQBox = kQRows * 128;        // bytes of a q box
  static constexpr uint32_t kKvBox = kKeyTile * 128;     // of a K or V box
  // operations per (query, key) pair in units of W (the function's: 4):
  // S (2) once a column group, P·V (2) as two products; f32 in tf32
  // products, three a product
  static constexpr int kOpsPerPair =
      kF32 ? 3 * (2 * kColGroups + 2) : 2 * kColGroups + 4;
  static_assert(kW % kPiece == 0 && kW > 128 && kW <= kMaxWidth, "width");
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kGroupPieces * 32 <= 128, "O's registers");
};

// ---------------------------------------------------------------------------
// S = q kᵀ for the 64 q rows and the key tile, in S's accumulator layout:
// s[j][e] for n-tile j (keys 8j ..) as sm90.cuh describes.
// ---------------------------------------------------------------------------

// bf16, one warpgroup: W / 16 wgmma, q and K K-major from their tiles;
// always all the pieces (the f32 overload of sm90_tiles.cuh takes a range).
template <class P>
__device__ __forceinline__ void scores(float (&s)[P::kKeyTile / 8][4],
                                       uint32_t qs, uint32_t ks,
                                       const unsigned char*,
                                       const unsigned char*, int, int,
                                       std::false_type) {
  float(&d)[32] = reinterpret_cast<float(&)[32]>(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P::kPieces * 4; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // 16 columns, 32 bytes
    wgmma_64x64x16_ss(d, sw128_desc(qs + (kk >> 2) * P::kQBox + off, 16, 1024),
                      sw128_desc(ks + (kk >> 2) * P::kKvBox + off, 16, 1024),
                      kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_operand(d[i]);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Shared-memory layout of a block: the q tiles at `qs` (1024-aligned), the
// ring's slots at `ring`, then the barriers; `data` is qs as a generic
// pointer.
struct Smem {
  uint32_t qs, ring, full, empty, qbar;
  const unsigned char* data;
};

// Warpgroup `group` owns q tile rg (rows qg ..) and O's pieces first ..
// first + mine - 1 of it.  Thread 0 also issues the loads: the block's q
// tiles on `qbar`, then item i = 2·tile (K) or 2·tile + 1 (V) into slot i
// mod kStages once every thread has released the slot's previous item
// (items 0 and 1 at the start, item i + 2 right after this thread's own
// release of item i).
template <typename T, class P>
__device__ __forceinline__ void attend(const CUtensorMap& tq,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       T* __restrict__ o,
                                       float* __restrict__ lse, const Smem& sm,
                                       int group, int bh, int b, int h, int q0,
                                       int lq, int lk, int tiles, Strides so,
                                       int causal, float scale) {
  using IsF32 = std::integral_constant<bool, P::kF32>;
  constexpr int kKT = P::kKeyTile;
  const int rg = P::kRowGroups > 1 ? group : 0;
  const int cg = P::kColGroups > 1 ? group : 0;
  const int qg = q0 + rg * kQRows;
  const uint32_t qs_g = sm.qs + rg * P::kQBytes;
  const unsigned char* q_p = sm.data + rg * P::kQBytes;
  const unsigned char* ring_p = sm.data + P::kRowGroups * P::kQBytes;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);  // the warp's first row
  const int g = lane >> 2;
  const int t = lane & 3;
  const int first = cg * P::kGroupPieces;
  const int mine = imin(P::kGroupPieces, P::kPieces - first);
  // causal: the key tiles past the group's own rows are all masked; it
  // only releases them
  const int tiles_g = causal ? (imin(lk, qg + kQRows) + kKT - 1) / kKT : tiles;
  const float sl = scale * kLog2e;

  const bool loader = threadIdx.x == 0;
  auto issue = [&](int i) {
    if (i >= 2 * tiles) return;
    const int slot = i % kStages;
    mbar_wait(sm.empty + 8 * slot, ((i / kStages) & 1) ^ 1);
    mbar_arrive_expect_tx(sm.full + 8 * slot, P::kSlotBytes);
    const CUtensorMap* map = (i & 1) ? &tv : &tk;
    const uint32_t dst = sm.ring + slot * P::kSlotBytes;
    for (int c = 0; c < P::kBoxes; ++c)
      tma_load_4d(dst + c * P::kKvBox, map, sm.full + 8 * slot,
                  c * P::kBoxCols, (i >> 1) * kKT, h, b);
  };
  if (loader) {
    mbar_arrive_expect_tx(sm.qbar, P::kRowGroups * P::kQBytes);
    for (int r = 0; r < P::kRowGroups; ++r)
      for (int c = 0; c < P::kBoxes; ++c)
        tma_load_4d(sm.qs + r * P::kQBytes + c * P::kQBox, &tq, sm.qbar,
                    c * P::kBoxCols, q0 + r * kQRows, h, b);
    for (int i = 0; i < kStages; ++i) issue(i);
  }

  float acc[P::kGroupPieces][32];
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pc][i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  mbar_wait(sm.qbar, 0);
  __syncwarp();  // converged again for the warp-wide products
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kKT;
    const int ik = 2 * it, iv = 2 * it + 1;  // the tile's K and V items
    const int sk = ik % kStages, sv = iv % kStages;
    if (it >= tiles_g) {
      for (const int i : {ik, iv}) {
        mbar_wait(sm.full + 8 * (i % kStages), (i / kStages) & 1);
        mbar_arrive(sm.empty + 8 * (i % kStages));
        if (loader) issue(i + kStages);
      }
      continue;
    }
    float s[kKT / 8][4];
    mbar_wait(sm.full + 8 * sk, (ik / kStages) & 1);
    __syncwarp();
    scores<P>(s, qs_g, sm.ring + sk * P::kSlotBytes, q_p,
              ring_p + sk * P::kSlotBytes, 0, P::kPieces, IsF32{});
    mbar_arrive(sm.empty + 8 * sk);
    if (loader) issue(ik + kStages);

    // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3) of the
    // warp's 16, log2 domain, as flash_fwd.cu
    const bool edge = k0 + kKT > lk || (causal && k0 + kKT - 1 > qg + r0);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = qg + r0 + g + 8 * (e >> 1);
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
      // while every key so far is masked, m_new is -inf: shift by 0, which
      // leaves every p (and alpha) at exactly 0
      shift[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = ex2(m[r] - shift[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(s[j][e], sl, -shift[e >> 1]));
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int pc = 0; pc < P::kGroupPieces; ++pc)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pc][i] *= alpha[(i >> 1) & 1];

    mbar_wait(sm.full + 8 * sv, (iv / kStages) & 1);
    __syncwarp();
    add_pv<P>(acc, s, sm.ring + sv * P::kSlotBytes, ring_p + sv * P::kSlotBytes,
              first, mine, IsF32{});
    mbar_arrive(sm.empty + 8 * sv);
    if (loader) issue(iv + kStages);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-30f);
    inv[r] = 1.f / l_safe;
    const int qi = qg + r0 + g + 8 * r;
    // LSE = (m2 + log2 l)·ln 2, the natural log of the scaled logits
    if (cg == 0 && t == 0 && qi < lq)
      lse[(long long)bh * lq + qi] = (m[r] + log2f(l_safe)) * 0.6931471805599453f;
  }
  T* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int pc = 0; pc < P::kGroupPieces; ++pc) {
    if (pc >= mine) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qg + r0 + g + 8 * r;
      if (row >= lq) continue;
      T* p = op + row * so.l + kPiece * (first + pc) + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(p + 8 * n, acc[pc][4 * n + 2 * r] * inv[r],
               acc[pc][4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

template <typename T, int kW>
__global__ void __launch_bounds__(kThreadsWide, 1)
    flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               T* __restrict__ o, float* __restrict__ lse,
                               int heads, int lq, int lk, Strides so,
                               int causal, float scale) {
  using P = Plan<T, kW>;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm;
  const uint32_t raw = smem_addr(smem);
  sm.qs = raw + ((1024 - (raw & 1023)) & 1023);  // 1024-aligned
  sm.ring = sm.qs + P::kRowGroups * P::kQBytes;
  sm.full = sm.ring + kStages * P::kSlotBytes;   // kStages barriers
  sm.empty = sm.full + 8 * kStages;              // kStages barriers
  sm.qbar = sm.empty + 8 * kStages;
  sm.data = smem + (sm.qs - raw);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * P::kBlockRows;
  const int kend = causal ? imin(lk, q0 + P::kBlockRows) : lk;
  const int tiles = (kend + P::kKeyTile - 1) / P::kKeyTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 128 * kGroups);
    }
    mbar_init(sm.qbar, 1);
    fence_mbar_init();
    fence_proxy_async();
  }
  __syncthreads();

  attend<T, P>(tq, tk, tv, o, lse, sm, int(threadIdx.x) / 128, bh, b, h, q0,
               lq, lk, tiles, so, causal, scale);
}

// ---------------------------------------------------------------------------
// Host: launch (the tensor maps are tensor_map.cuh's)
// ---------------------------------------------------------------------------

template <typename T, int kW>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int batch, int heads, int lq, int lk,
                   const long long* st, int causal, float scale,
                   cudaStream_t stream) {
  using P = Plan<T, kW>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, P::kF32, kW, lq, heads, batch, st[0],
                               st[1], st[2], kQRows);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, P::kF32, kW, lk, heads, batch, st[3], st[4],
                     st[5], P::kKeyTile);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, P::kF32, kW, lk, heads, batch, st[6], st[7],
                     st[8], P::kKeyTile);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wide_sm90_kernel<T, kW>;
  static bool attr_set[kMaxDevices] = {};
  err = set_smem_once(kernel, P::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + P::kBlockRows - 1) / P::kBlockRows, batch * heads);
  kernel<<<grid, kThreadsWide, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, heads, lq, lk,
      Strides{st[9], st[10], st[11]}, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int width, const void* q, const void* k,
                         const void* v, void* o, float* lse, int batch,
                         int heads, int lq, int lk, const long long* st,
                         int causal, float scale, cudaStream_t s) {
  switch (width) {
    case 192: return launch<T, 192>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    case 320: return launch<T, 320>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    case 384: return launch<T, 384>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    case 448: return launch<T, 448>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    case 512: return launch<T, 512>(q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int kW>
void plan_of(int* out) {
  using P = Plan<T, kW>;
  const int plan[9] = {P::kBlockRows, P::kKeyTile, kStages, P::kRowGroups,
                       P::kColGroups, kThreadsWide, int(P::kSmem), P::kBoxCols,
                       P::kOpsPerPair};
  for (int i = 0; i < 9; ++i) out[i] = plan[i];
}

template <typename T>
int plan_width(int width, int* out) {
  switch (width) {
    case 192: plan_of<T, 192>(out); return 0;
    case 256: plan_of<T, 256>(out); return 0;
    case 320: plan_of<T, 320>(out); return 0;
    case 384: plan_of<T, 384>(out); return 0;
    case 448: plan_of<T, 448>(out); return 0;
    case 512: plan_of<T, 512>(out); return 0;
    default: return -1;
  }
}

}  // namespace

// As flash_fwd.cu's flash_fwd (the same arguments), at a head_dim that is
// a multiple of 64 from 192 to 512: writes o and lse.  Returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for another width or a
// tensor map TMA cannot take); the caller raises on anything else.
extern "C" int flash_fwd_wide(int dtype, const void* q, const void* k,
                              const void* v, void* o, float* lse, int batch,
                              int heads, int lq, int lk, int head_dim,
                              long long q_sb, long long q_sl, long long q_sh,
                              long long k_sb, long long k_sl, long long k_sh,
                              long long v_sb, long long v_sl, long long v_sh,
                              long long o_sb, long long o_sl, long long o_sh,
                              int causal, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_width<float>(
        head_dim, q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch_width<__nv_bfloat16>(
        head_dim, q, k, v, o, lse, batch, heads, lq, lk, st, causal, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of flash_fwd_wide at (dtype, head_dim) into out[0..8]:
// q rows a block, keys a tile, ring slots, warpgroups over the rows
// and over O's columns, threads a block, dynamic shared memory bytes,
// columns a TMA box, operations per (query, key) pair in units of the
// width (f32: tf32 products).  Returns 0, or -1 for a width or dtype it
// does not take.
extern "C" int flash_fwd_wide_plan(int dtype, int head_dim, int* out) {
  if (dtype == 0) return plan_width<float>(head_dim, out);
  if (dtype == 1) return plan_width<__nv_bfloat16>(head_dim, out);
  return -1;
}
