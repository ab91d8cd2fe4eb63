// Host code of the TMA-fed kernels (flash_fwd.cu's bf16 K1,
// flash_fwd_wide_sm90.cu, flash_fwd_cluster_sm90.cu and
// flash_bwd_wide_sm90.cu): the tensor maps their loads read, built per call
// with cuTensorMapEncodeTiled from the operands' strides, or taken from a
// cache of the maps built before.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query (so no -lcuda at link time), or null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (W, L, H, B) of a (B, L, H, W) operand at `base` with element
// strides sb, sl, sh (a dim of size 1 gets a stride TMA takes; it is never
// stepped), boxes of 128 bytes by `rows` rows, 128-byte swizzle, rows past
// L read as 0.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, bool f32,
                              int width, int len, int heads, int batch,
                              long long sb, long long sl, long long sh,
                              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long es = f32 ? 4 : 2;
  const long long row_bytes = width * es;
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(len),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {
      cuuint64_t(len > 1 ? sl * es : row_bytes),
      cuuint64_t(heads > 1 ? sh * es : row_bytes),
      cuuint64_t(batch > 1 ? sb * es : row_bytes)};
  const cuuint32_t box[4] = {cuuint32_t(128 / es), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// tensor_map's arguments, the key of a cached map.
struct MapKey {
  const void* base;
  long long sb, sl, sh;
  int f32, width, len, heads, batch, rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && sb == o.sb && sl == o.sl && sh == o.sh &&
           f32 == o.f32 && width == o.width && len == o.len &&
           heads == o.heads && batch == o.batch && rows == o.rows;
  }
};

// tensor_map through a cache of the last kMapCache maps it built: a map is
// a function of its arguments alone, so one built before is copied, not
// encoded again (the encoding is host work on every call of a short
// kernel).  Entries are replaced in turn; a mutex guards the cache, since
// ctypes releases Python's lock during a call.
inline cudaError_t tensor_map_cached(CUtensorMap* map, const void* base,
                                     bool f32, int width, int len, int heads,
                                     int batch, long long sb, long long sl,
                                     long long sh, int rows) {
  constexpr int kMapCache = 64;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  static std::mutex mu;
  const MapKey key{base, sb, sl, sh, int(f32), width, len, heads, batch, rows};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (keys[i] == key) {
      *map = maps[i];
      return cudaSuccess;
    }
  }
  const cudaError_t err =
      tensor_map(map, base, f32, width, len, heads, batch, sb, sl, sh, rows);
  if (err != cudaSuccess) return err;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  if (used < kMapCache) ++used;
  return cudaSuccess;
}

}  // namespace
