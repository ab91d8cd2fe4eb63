// The Hopper (sm_90a) instructions of the port's TMA-fed wgmma kernels, each
// in its own small function, as ptx.cuh holds those of the mma.sync
// kernels: mbarrier phases, TMA tile copies, the async-proxy fences, the
// thread-block cluster's rank, barrier and shared-memory reads (with the
// host helper that launches a grid of clusters), the wgmma shared-memory
// descriptor and the wgmma products at the shapes used.  Nothing else
// lives here, so that a CPU model of a kernel can stand
// in lane-exact versions of exactly these functions.
//
// Conventions.  A shared-memory address is the 32-bit address of the
// shared window (`smem_addr` of ptx.cuh).  Tiles that TMA writes with the
// 128-byte swizzle lie on 1024-byte boundaries, so that the swizzle (bits 4-6
// of the byte address XOR bits 7-9) starts each tile at row 0, which is
// what the descriptors below assume (their base-offset field is 0).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// mbarrier: a 64-bit barrier in shared memory with an arrival count, a
// transaction (byte) count and a phase bit.  A phase completes when every
// expected arrival has come and every expected byte has landed; the phase
// bit then flips and the counts rearm.
// ---------------------------------------------------------------------------

// Arm the barrier at `bar` for `count` arrivals a phase; its phase is 0.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the block's barrier inits visible before any thread or TMA uses
// them (with the fence below and a __syncthreads).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's shared-memory accesses of the generic proxy (plain
// loads and stores, barrier inits) before later ones of the async proxy
// (TMA, wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival on the barrier (release: this thread's earlier shared-memory
// reads are done before the phase can complete).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` more to land in this phase (the
// TMA copies that name this barrier count them down).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Whether the phase of parity `parity` has completed (acquire: what the
// phase covered is then visible to this thread).  A barrier starts in
// phase 0, so parity 1 reads as completed until phase 0 completes.
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for that phase.  A wait that never ends (a phase nobody completes)
// traps after some 2^28 tries, seconds at least, so that a fault ends the
// launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries)
    if (tries == (1u << 28)) __trap();
}

// As mbar_wait, with the loop inside the asm: to the compiler the wait is
// one instruction, not a branch that may diverge, so wgmma accumulators
// live across it do not force wgmma serialization (ptxas C7520).  Traps
// after 2^28 tries.
__device__ __forceinline__ void mbar_wait_converged(uint32_t bar,
                                                    uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 268435456;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// mbar_arrive_expect_tx by the threads where `pred` holds, predicated in
// the instruction, not branched around.
__device__ __forceinline__ void mbar_arrive_expect_tx_if(uint32_t bar,
                                                         uint32_t bytes,
                                                         bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes), "r"(int(pred))
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D tensor map at element coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at `dst`; elements outside the
// tensor land as 0.  The box's bytes count down the transaction count of
// the barrier at `bar`.  `map` is a kernel parameter (__grid_constant__).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// tma_load_4d by the threads where `pred` holds, predicated in the
// instruction.
__device__ __forceinline__ void tma_load_4d_if(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      "}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(int(pred))
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters: a few blocks on neighbouring SMs that can read
// each other's shared memory (distributed shared memory) and meet at a
// cluster-wide barrier.
// ---------------------------------------------------------------------------

// This block's rank in its cluster (0 .. cluster size - 1).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Arrive on the cluster barrier (release: this thread's earlier shared-
// memory writes are visible to every thread of the cluster that passes the
// matching wait).  Every thread of every block of the cluster arrives once
// a phase; warps must be converged.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// Wait until every thread of the cluster has arrived on the phase this
// thread arrived on last (acquire).
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of the byte at shared address `addr` of
// this block in the block of rank `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Four floats at a shared::cluster address (16-byte aligned), read from
// whichever block of the cluster holds them.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Launch `kernel` on a grid whose x dimension is cut into clusters of
// `cluster` blocks (a multiple of it), with `smem` bytes of dynamic shared
// memory a block.  Returns cudaErrorInvalidConfiguration where the card
// cannot hold one such cluster at once (cudaOccupancyMaxActiveClusters
// reads 0), else the launch's error; it never falls back to another shape.
// `fits`, where given, is the caller's flag for this kernel, device and
// cluster size: the query runs while it is false and sets it.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           size_t smem, int cluster, bool* fits,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err;
  if (fits == nullptr || !*fits) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorInvalidConfiguration;
    if (fits != nullptr) *fits = true;
  }
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Thread index
// ---------------------------------------------------------------------------

// threadIdx.x read anew at each call: values derived from it (shared-memory
// offsets of fragments) are then recomputed inside a loop instead of being
// hoisted out of it and held in registers for its whole length.
__device__ __forceinline__ uint32_t thread_index() {
  uint32_t tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  return tid;
}

// ---------------------------------------------------------------------------
// wgmma: a product of a 64-row tile by the 4 warps of a warpgroup, issued
// asynchronously.  Warp w of the group holds rows 16w .. 16w + 15 of the
// f32 accumulator; lane (g, t) = (lane / 4, lane % 4) holds, for each
// 8-column n-tile j, d[4j] = (g, 8j + 2t), d[4j + 1] = (g, 8j + 2t + 1),
// d[4j + 2] = (g + 8, 8j + 2t), d[4j + 3] = (g + 8, 8j + 2t + 1): the
// layout of mma.sync's C, n-tile by n-tile.
// ---------------------------------------------------------------------------

// Before the first wgmma that reads registers other instructions wrote
// (accumulators, A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the group of the wgmma issued since the last commit.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight: the older ones
// have written their accumulators and read their operands.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving uses of an accumulator or an A register
// across the wgmma that writes or reads it: call on each after
// wgmma_wait, so that nothing reads a result before the wait and no
// register is reused while a product still reads it.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// The 64-bit descriptor of an operand tile in shared memory with the
// 128-byte swizzle: rows of 128 bytes in groups of 8 rows (1024 bytes),
// `sbo` bytes from one group of 8 rows to the next, `lbo` bytes from one
// 128-byte column block to the next (read only for an MN-major operand
// wider than 128 bytes).  Address and offsets in 16-byte units; layout
// type 1 (SW128) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

#define SFX_WGMMA_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SFX_WGMMA_D32_OUT(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d (+)= a·b, m64n64k16, bf16 in, f32 accumulate (d = a·b when
// `accumulate` is 0): a the 64 x 16 tile of descriptor `da`, K-major (its
// rows the M index, 16 contiguous k values each); b the 16 x 64 tile of
// descriptor `db`, K-major (64 rows of the N index, 16 contiguous k each).
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[32], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFX_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SFX_WGMMA_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// As wgmma_64x64x16_ss at n32: d (+)= a·b with b the 16 x 32 tile of
// descriptor `db`, K-major (32 rows of the N index), d 4 n-tiles of 8.
__device__ __forceinline__ void wgmma_64x32x16_ss(float (&d)[16], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SFX_WGMMA_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"

// As wgmma_64x64x16_ss at n128: d (+)= a·b with b the 16 x 128 tile of
// descriptor `db`, K-major (128 rows of the N index), d 16 n-tiles of 8.
__device__ __forceinline__ void wgmma_64x128x16_ss(float (&d)[64], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SFX_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SFX_WGMMA_D32_OUT(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SFX_WGMMA_D64

// d += a·b, m64n64k16, bf16 in, f32 accumulate: a from registers, lane (g,
// t) of warp w holding rows 16w + g and 16w + g + 8 as mma.sync m16n8k16's
// A: a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
// a[3] = (g + 8, 2t + 8..), the lower k in the low half; b the 16 x 64 tile
// of descriptor `db`, MN-major (16 rows of the k index, 64 contiguous N
// values each).
__device__ __forceinline__ void wgmma_64x64x16_rs_mn(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SFX_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SFX_WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SFX_WGMMA_D32
#undef SFX_WGMMA_D32_OUT

}  // namespace
