// CPU models of sm90.cuh's instructions: mbarrier phases, the TMA tile copy
// with zero fill and the 128-byte swizzle, the thread-block cluster (rank,
// barrier, mapa and ld.shared::cluster into a peer's window, and the launch
// helper, which runs the blocks of a cluster together), the wgmma
// descriptor and the m64n128k16, m64n64k16 and m64n32k16 bf16
// products (run when their group is waited for, so a result read early or
// an operand released early shows).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <chrono>
#include <cstdint>

namespace {

inline ShimBlock::Mbar& shim_mbar(uint32_t bar) {
  auto it = g_block->mbars.find(bar);
  SHIM_CHECK(it != g_block->mbars.end(), "an mbarrier used before its init");
  return it->second;
}
inline void shim_mbar_maybe_complete(ShimBlock::Mbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.expected;
    g_block->phase_done.notify_all();
  }
}
inline void mbar_init(uint32_t bar, uint32_t count) {
  SHIM_CHECK(bar % 8 == 0, "mbarrier not 8-byte aligned");
  std::lock_guard<std::mutex> lk(g_block->mu);
  ShimBlock::Mbar m;
  m.expected = m.pending = int(count);
  g_block->mbars[bar] = m;
}
inline void fence_mbar_init() {}
inline void fence_proxy_async() {}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lk(g_block->mu);
  ShimBlock::Mbar& m = shim_mbar(bar);
  SHIM_CHECK(m.pending > 0, "more arrivals than the barrier expects");
  --m.pending;
  shim_mbar_maybe_complete(m);
}
inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(g_block->mu);
  ShimBlock::Mbar& m = shim_mbar(bar);
  SHIM_CHECK(m.pending > 0, "more arrivals than the barrier expects");
  m.tx += bytes;
  --m.pending;
  shim_mbar_maybe_complete(m);
}
inline void shim_complete_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(g_block->mu);
  ShimBlock::Mbar& m = shim_mbar(bar);
  m.tx -= bytes;
  SHIM_CHECK(m.tx >= 0, "more bytes landed than the barrier expects");
  shim_mbar_maybe_complete(m);
}
inline bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  bool done;
  {
    std::lock_guard<std::mutex> lk(g_block->mu);
    done = uint32_t(shim_mbar(bar).phase) != (parity & 1);
  }
  if (!done) std::this_thread::sleep_for(std::chrono::microseconds(50));
  return done;
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(g_block->mu);
  if (!g_block->phase_done.wait_for(lk, std::chrono::seconds(60), [&] {
        return uint32_t(shim_mbar(bar).phase) != (parity & 1);
      }))
    shim_fail("an mbarrier wait did not end in 60 s (deadlock)");
}

inline void mbar_wait_converged(uint32_t bar, uint32_t parity) { mbar_wait(bar, parity); }
inline void mbar_arrive_expect_tx_if(uint32_t bar, uint32_t bytes, bool pred) {
  if (pred) mbar_arrive_expect_tx(bar, bytes);
}

inline uint32_t shim_swizzle(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

inline void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                        int c0, int c1, int c2, int c3) {
  ShimMap m;
  std::memcpy(&m, map, sizeof(m));
  SHIM_CHECK(m.esize != 0, "a tensor map that was never encoded");
  const bool sw = m.swizzle == CU_TENSOR_MAP_SWIZZLE_128B;
  SHIM_CHECK(!sw || dst % 1024 == 0, "a 128B-swizzled box off a 1024-byte boundary");
  SHIM_CHECK(dst % 128 == 0, "a TMA box off a 128-byte boundary");
  SHIM_CHECK((long long)c0 * m.esize % 16 == 0,
             "a TMA box whose innermost start is not 16-byte aligned");
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t row = m.box[0] * m.esize;
  uint32_t off = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1, off += row)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0) {
          using ll = long long;
          const ll idx[4] = {c[0] + ll(i0), c[1] + ll(i1), c[2] + ll(i2), c[3] + ll(i3)};
          bool in = true;
          long long src = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && idx[d] >= 0 && idx[d] < (long long)m.dims[d];
            src += idx[d] * (long long)m.strides[d];
          }
          uint32_t a = dst + off + i0 * m.esize;
          if (sw) a = shim_swizzle(a);
          unsigned char* p = shim_smem(a);
          if (in) std::memcpy(p, m.base + src, m.esize);
          else std::memset(p, 0, m.esize);
        }
  shim_complete_tx(bar, off);
}

inline void tma_load_4d_if(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                           int c1, int c2, int c3, bool pred) {
  if (pred) tma_load_4d(dst, map, bar, c0, c1, c2, c3);
}

// -- thread-block clusters
inline uint32_t cluster_rank() {
  SHIM_CHECK(g_cluster != nullptr, "a cluster instruction outside a cluster launch");
  return uint32_t(g_cluster_rank);
}
// the token of this thread's last arrival on the cluster barrier
inline thread_local std::unique_ptr<std::barrier<>::arrival_token> g_cluster_token;
inline void cluster_arrive() {
  SHIM_CHECK(g_cluster != nullptr, "a cluster barrier outside a cluster launch");
  SHIM_CHECK(!g_cluster_token, "two cluster arrivals without a wait between");
  g_cluster_token = std::make_unique<std::barrier<>::arrival_token>(g_cluster->bar->arrive());
}
inline void cluster_wait() {
  SHIM_CHECK(g_cluster_token != nullptr, "a cluster wait without an arrival");
  g_cluster->bar->wait(std::move(*g_cluster_token));
  g_cluster_token.reset();
}
// A shared::cluster address: the block's window offset, with rank + 1 in
// the bits above the window (a plain shared address names the own block).
constexpr uint32_t kShimRankShift = 20;
static_assert(kShimWindow <= (1u << kShimRankShift), "window");
inline uint32_t map_rank(uint32_t addr, uint32_t rank) {
  SHIM_CHECK(g_cluster != nullptr, "mapa outside a cluster launch");
  SHIM_CHECK(addr < kShimWindow, "mapa of an address outside the window");
  SHIM_CHECK(rank < g_cluster->blocks.size(), "mapa to a rank outside the cluster");
  return addr | ((rank + 1) << kShimRankShift);
}
inline float4 ld_cluster_f4(uint32_t addr) {
  SHIM_CHECK(g_cluster != nullptr, "ld.shared::cluster outside a cluster launch");
  SHIM_CHECK(addr % 16 == 0, "ld.shared::cluster.v4 off a 16-byte boundary");
  ShimBlock* blk = g_block;
  if (addr >> kShimRankShift) {
    const uint32_t rank = (addr >> kShimRankShift) - 1;
    SHIM_CHECK(rank < g_cluster->blocks.size(), "a cluster address of no block");
    blk = g_cluster->blocks[rank];
    addr &= (1u << kShimRankShift) - 1;
  }
  SHIM_CHECK(addr + 16 <= kShimWindow, "ld.shared::cluster outside the window");
  SHIM_CHECK(blk->exited.load() < g_cluster->threads,
             "a read of a peer's shared memory after the peer exited");
  float4 v;
  std::memcpy(&v, blk->window + addr, 16);
  return v;
}
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           size_t smem, int cluster, bool* fits, cudaStream_t,
                           Args... args) {
  shim_launch_cluster(grid, threads, smem, cluster, [&] { kernel(args...); });
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && fits != nullptr) *fits = true;
  return err;
}

inline uint32_t thread_index() { return threadIdx.x; }

// -- wgmma
inline void wgmma_fence() {}
inline void fence_operand(float&) {}
inline void fence_operand(uint32_t&) {}

inline uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}
struct ShimDesc {
  uint32_t start, lbo, sbo;
};
inline ShimDesc shim_desc(uint64_t d) {
  SHIM_CHECK((d >> 62) == 1, "a wgmma descriptor not of the 128-byte swizzle");
  SHIM_CHECK(((d >> 49) & 7) == 0, "a wgmma descriptor with a base offset");
  ShimDesc s{uint32_t(d & 0x3fff) << 4, uint32_t((d >> 16) & 0x3fff) << 4,
             uint32_t((d >> 32) & 0x3fff) << 4};
  SHIM_CHECK((s.start & 0x380) == 0, "a swizzled operand not starting at row 0 of its 1024-byte atom");
  return s;
}
inline float shim_bf16_at(uint32_t a) {
  uint16_t v;
  std::memcpy(&v, shim_smem(shim_swizzle(a)), 2);
  return __uint_as_float(uint32_t(v) << 16);
}
// K-major: element (row r, k) at start + (r / 8)·sbo + (r % 8)·128 + 2k
inline float shim_kmajor(const ShimDesc& s, int r, int k) {
  SHIM_CHECK(s.start % 128 + 2 * k < 128, "a K-major operand crossing its 128-byte row");
  return shim_bf16_at(s.start + (r / 8) * s.sbo + (r % 8) * 128 + 2 * k);
}
// MN-major: element (k, n) at start + (k / 8)·sbo + (k % 8)·128 + (n / 64)·lbo + 2(n % 64)
inline float shim_mnmajor(const ShimDesc& s, int k, int n) {
  return shim_bf16_at(s.start + (k / 8) * s.sbo + (k % 8) * 128 + (n / 64) * s.lbo + 2 * (n % 64));
}
inline void shim_run(const ShimGroup::Op& op) {
  float A[64][16], B[16][128];
  const ShimDesc db = shim_desc(op.db);
  for (int k = 0; k < 16; ++k)
    for (int n = 0; n < op.n; ++n)
      B[k][n] = op.kind == 0 ? shim_kmajor(db, n, k) : shim_mnmajor(db, k, n);
  if (op.kind == 0) {
    const ShimDesc da = shim_desc(op.da);
    for (int m = 0; m < 64; ++m)
      for (int k = 0; k < 16; ++k) A[m][k] = shim_kmajor(da, m, k);
  } else {
    for (int m = 0; m < 64; ++m)
      for (int k = 0; k < 16; ++k) {
        const int tw = 32 * (m / 16) + 4 * (m % 8) + (k % 8) / 2;
        const uint32_t reg = op.a[tw][(m % 16) / 8 + 2 * (k / 8)];
        A[m][k] = __uint_as_float(((reg >> (16 * (k % 2))) & 0xffffu) << 16);
      }
  }
  for (int m = 0; m < 64; ++m)
    for (int n = 0; n < op.n; ++n) {
      const int tw = 32 * (m / 16) + 4 * (m % 8) + (n % 8) / 2;
      float& d = op.d[tw][4 * (n / 8) + 2 * ((m % 16) / 8) + (n % 2)];
      double sum = op.accumulate ? d : 0.0;
      for (int k = 0; k < 16; ++k) sum += double(A[m][k]) * double(B[k][n]);
      d = float(sum);
    }
}
inline ShimGroup& shim_group() {
  return *g_block->groups[threadIdx.x / 128];
}
inline void shim_issue(int kind, float* d, const uint32_t* a, uint64_t da,
                       uint64_t db, int accumulate, int n = 64) {
  ShimGroup& G = shim_group();
  const int tw = threadIdx.x % 128;
  G.d[tw] = d;
  G.a[tw] = a;
  G.bar.arrive_and_wait();
  if (tw == 0) {
    ShimGroup::Op op{kind, da, db, accumulate, n, {}, {}};
    for (int i = 0; i < 128; ++i) {
      op.d.push_back(static_cast<float*>(G.d[i]));
      op.a.push_back(G.a[i]);
    }
    G.open.push_back(std::move(op));
  }
  G.bar.arrive_and_wait();
}
inline void wgmma_64x64x16_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  shim_issue(0, d, nullptr, da, db, accumulate);
}
inline void wgmma_64x32x16_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  shim_issue(0, d, nullptr, da, db, accumulate, 32);
}
inline void wgmma_64x128x16_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  shim_issue(0, d, nullptr, da, db, accumulate, 128);
}
inline void wgmma_64x64x16_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  shim_issue(1, d, a, 0, db, 1);
}
inline void wgmma_commit() {
  ShimGroup& G = shim_group();
  G.bar.arrive_and_wait();
  if (threadIdx.x % 128 == 0) {
    G.groups.push_back(std::move(G.open));
    G.open.clear();
  }
  G.bar.arrive_and_wait();
}
template <int N>
inline void wgmma_wait() {
  ShimGroup& G = shim_group();
  G.bar.arrive_and_wait();
  if (threadIdx.x % 128 == 0)
    while (G.groups.size() > size_t(N)) {
      for (const auto& op : G.groups.front()) shim_run(op);
      G.groups.erase(G.groups.begin());
    }
  G.bar.arrive_and_wait();
}

}  // namespace