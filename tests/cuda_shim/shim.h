// CPU stand-in for the CUDA language features the port's kernels use: one
// std::thread per CUDA thread, blocks one after another (the blocks of a
// thread-block cluster together), __syncthreads as a std::barrier, warp and
// warpgroup collectives through exchange buffers.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct shim_uint3 {
  unsigned x, y, z;
};
inline thread_local shim_uint3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
using std::max;
using std::min;
using std::fmaxf;
using std::fminf;
using std::fmaf;
using std::log2f;
using std::exp2f;

[[noreturn]] inline void shim_fail(const char* what) {
  std::fprintf(stderr, "SHIM FAILURE: %s\n", what);
  std::fflush(stderr);
  std::abort();
}
#define SHIM_CHECK(c, what) \
  do {                      \
    if (!(c)) shim_fail(what); \
  } while (0)

// ---------------------------------------------------------------------------
// the block: shared window, barriers, exchange buffers
// ---------------------------------------------------------------------------

constexpr size_t kShimWindow = 256 * 1024;
// where the dynamic shared memory starts in the window: 16-byte aligned
// only, so that a kernel's own alignment of its tiles is exercised
constexpr size_t kShimDynOff = 0x410;

struct ShimWarp {
  std::barrier<> bar{32};
  uint64_t x[32];
  const void* p[32][4];
};
struct ShimGroup {
  std::barrier<> bar{128};
  void* d[128];
  const uint32_t* a[128];
  struct Op {
    int kind;  // 0: ss, 1: rs, MN-major B
    uint64_t da, db;
    int accumulate;
    int n;  // the product's N: 128, 64 or 32
    std::vector<float*> d;
    std::vector<const uint32_t*> a;
  };
  std::vector<std::vector<Op>> groups;  // committed groups, oldest first
  std::vector<Op> open;
};
struct ShimBlock {
  alignas(4096) unsigned char window[kShimWindow];
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<ShimWarp>> warps;
  std::vector<std::unique_ptr<ShimGroup>> groups;
  struct Mbar {
    int expected = 0, pending = 0;
    long long tx = 0;
    int phase = 0;
  };
  std::mutex mu;
  std::condition_variable phase_done;  // a barrier's phase completed
  std::unordered_map<uint32_t, Mbar> mbars;
  std::atomic<int> exited{0};  // threads of the block that have returned
};
// the block of the calling thread
inline thread_local ShimBlock* g_block = nullptr;

// The blocks of one thread-block cluster, run together: their shared
// windows, and the cluster barrier over all of their threads.
struct ShimCluster {
  std::vector<ShimBlock*> blocks;
  int threads = 0;  // a block's
  std::unique_ptr<std::barrier<>> bar;
};
inline thread_local ShimCluster* g_cluster = nullptr;
inline thread_local int g_cluster_rank = 0;

inline unsigned char* shim_dynamic_smem() {
  return g_block->window + kShimDynOff;
}
inline size_t __cvta_generic_to_shared(const void* p) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  SHIM_CHECK(c >= g_block->window && c < g_block->window + kShimWindow,
             "a shared address outside the window");
  return static_cast<size_t>(c - g_block->window);
}
inline unsigned char* shim_smem(uint32_t addr) {
  SHIM_CHECK(addr < kShimWindow, "shared address out of the window");
  return g_block->window + addr;
}

inline void __syncthreads() { g_block->bar->arrive_and_wait(); }
inline ShimWarp& shim_warp() { return *g_block->warps[threadIdx.x / 32]; }
inline void __syncwarp() { shim_warp().bar.arrive_and_wait(); }

template <typename T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) <= 8, "shfl");
  ShimWarp& w = shim_warp();
  const int lane = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.x[lane] = bits;
  w.bar.arrive_and_wait();
  const uint64_t got = w.x[lane ^ mask];
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

struct __nv_bfloat16 {
  uint16_t x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = __float_as_uint(f);
  if (std::isnan(f)) return {uint16_t(0x7fc0)};
  u += 0x7fffu + ((u >> 16) & 1u);  // to nearest, ties to even
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  return __uint_as_float(uint32_t(b.x) << 16);
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float __low2float(__nv_bfloat162 h) { return __bfloat162float(h.x); }
inline float __high2float(__nv_bfloat162 h) { return __bfloat162float(h.y); }
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__low2float(h), __high2float(h)};
}

// ---------------------------------------------------------------------------
// runtime
// ---------------------------------------------------------------------------

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorNotSupported = 801
};
using cudaStream_t = void*;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
constexpr int cudaSharedmemCarveoutMaxShared = 100;
inline thread_local cudaError_t g_last_error = cudaSuccess;
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// The SM count the shim reports: a card of 4 SMs, so that the small grids
// of a test reach both of a launch plan's choices (flash_fwd.cu's
// `fwd_groups`).
constexpr int kShimSmCount = 4;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = kShimSmCount;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  cudaError_t e = g_last_error;
  g_last_error = cudaSuccess;
  return e;
}

// A fresh block in `blk` for `threads` threads: the shared window filled
// with 0xff (reads of unwritten shared memory show as NaN), its barriers,
// warps and warpgroups.
inline void shim_reset_block(ShimBlock* blk, int threads) {
  std::memset(blk->window, 0xff, kShimWindow);
  blk->bar = std::make_unique<std::barrier<>>(threads);
  blk->warps.clear();
  for (int w = 0; w < threads / 32; ++w)
    blk->warps.push_back(std::make_unique<ShimWarp>());
  blk->groups.clear();
  for (int w = 0; w < (threads + 127) / 128; ++w)
    blk->groups.push_back(std::make_unique<ShimGroup>());
  blk->mbars.clear();
  blk->exited = 0;
}

// What a block must not leave behind: bytes a barrier still expects, a
// wgmma in flight.
inline void shim_check_block(ShimBlock* blk) {
  for (auto& kv : blk->mbars)
    SHIM_CHECK(kv.second.tx == 0, "a barrier ends with bytes outstanding");
  for (auto& grp : blk->groups)
    SHIM_CHECK(grp->open.empty() && grp->groups.empty(),
               "a wgmma left in flight at the end of the block");
}

inline bool shim_refuses(size_t smem, int threads) {
  return smem + kShimDynOff > kShimWindow || smem > 232448 || threads > 1024 ||
         threads % 32;
}

// Runs the grid (x fastest, then y, then z): blocks one after another, one
// std::thread per CUDA thread.
template <typename F>
void shim_launch(dim3 grid, int threads, size_t smem, cudaStream_t, F body) {
  if (shim_refuses(smem, threads)) {
    g_last_error = cudaErrorInvalidValue;
    return;
  }
  auto blk = std::make_unique<ShimBlock>();
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      shim_reset_block(blk.get(), threads);
      std::vector<std::thread> ts;
      for (int i = 0; i < threads; ++i)
        ts.emplace_back([&, i] {
          g_block = blk.get();
          threadIdx = {unsigned(i), 0, 0};
          blockIdx = {bx, by, bz};
          body();
        });
      for (auto& t : ts) t.join();
      shim_check_block(blk.get());
    }
}

// Runs the grid as clusters of `cluster` blocks along x (grid.x a multiple
// of it), one cluster after another: the blocks of a cluster together, each
// with its own shared window, barriers and warps, all of their threads on
// one cluster barrier.  A block's rank is blockIdx.x mod `cluster`.
template <typename F>
void shim_launch_cluster(dim3 grid, int threads, size_t smem, int cluster,
                         F body) {
  if (shim_refuses(smem, threads) || cluster < 1 || cluster > 8 ||
      grid.x % unsigned(cluster)) {
    g_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  std::vector<std::unique_ptr<ShimBlock>> blks;
  for (int r = 0; r < cluster; ++r) blks.push_back(std::make_unique<ShimBlock>());
  ShimCluster cl;
  for (auto& b : blks) cl.blocks.push_back(b.get());
  cl.threads = threads;
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned cx = 0; cx < grid.x; cx += cluster) {
      for (auto& b : blks) shim_reset_block(b.get(), threads);
      cl.bar = std::make_unique<std::barrier<>>(cluster * threads);
      std::vector<std::thread> ts;
      for (int r = 0; r < cluster; ++r)
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, r, i] {
            g_block = blks[r].get();
            g_cluster = &cl;
            g_cluster_rank = r;
            threadIdx = {unsigned(i), 0, 0};
            blockIdx = {cx + unsigned(r), by, bz};
            body();
            ++g_block->exited;
          });
      for (auto& t : ts) t.join();
      for (auto& b : blks) shim_check_block(b.get());
    }
}

template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8, "shfl");
  ShimWarp& w = shim_warp();
  const int lane = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.x[lane] = bits;
  w.bar.arrive_and_wait();
  const uint64_t got = w.x[src & 31];
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
