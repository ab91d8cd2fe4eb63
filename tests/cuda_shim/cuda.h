// CPU stand-in for cuda.h's tensor maps: cuTensorMapEncodeTiled checks
// TMA's limits and records the map for the cp.async.bulk.tensor model.
#pragma once
#include <cstdint>
#include <cstring>

using cuuint32_t = uint32_t;
using cuuint64_t = uint64_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
struct alignas(64) CUtensorMap {
  uint64_t opaque[16];
};
enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_256B = 3 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// what the model keeps in a map
struct ShimMap {
  const unsigned char* base;
  uint64_t dims[4];
  uint64_t strides[4];  // bytes; strides[0] = the element size
  uint32_t box[4];
  uint32_t esize;
  uint32_t swizzle;
};
static_assert(sizeof(ShimMap) <= sizeof(CUtensorMap), "map");

inline CUresult shim_encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                                  cuuint32_t rank, void* base,
                                  const cuuint64_t* dims,
                                  const cuuint64_t* strides,
                                  const cuuint32_t* box, const cuuint32_t* es,
                                  CUtensorMapInterleave il,
                                  CUtensorMapSwizzle sw, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill fill) {
  ShimMap m{};
  m.esize = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 0;
  if (m.esize == 0 || rank != 4 || il != CU_TENSOR_MAP_INTERLEAVE_NONE ||
      fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
    return CUDA_ERROR_INVALID_VALUE;
  if (reinterpret_cast<uintptr_t>(base) % 16) return CUDA_ERROR_INVALID_VALUE;
  m.base = static_cast<const unsigned char*>(base);
  m.strides[0] = m.esize;
  for (int i = 0; i < 4; ++i) {
    if (dims[i] == 0 || dims[i] > (1ull << 32)) return CUDA_ERROR_INVALID_VALUE;
    if (box[i] == 0 || box[i] > 256 || es[i] != 1) return CUDA_ERROR_INVALID_VALUE;
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40))
        return CUDA_ERROR_INVALID_VALUE;
      m.strides[i] = strides[i - 1];
    }
  }
  if ((box[0] * m.esize) % 16) return CUDA_ERROR_INVALID_VALUE;
  if (sw == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * m.esize > 128)
    return CUDA_ERROR_INVALID_VALUE;
  m.swizzle = sw;
  std::memset(map, 0, sizeof(*map));
  std::memcpy(map, &m, sizeof(m));
  return CUDA_SUCCESS;
}

#define CUDART_VERSION 12080
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
constexpr unsigned long long cudaEnableDefault = 0;
inline int shim_entry(const char* name, void** fn, cudaDriverEntryPointQueryResult* r) {
  if (std::strcmp(name, "cuTensorMapEncodeTiled") != 0) {
    *r = cudaDriverEntryPointSymbolNotFound;
    return 0;
  }
  *fn = reinterpret_cast<void*>(&shim_encode_tiled);
  *r = cudaDriverEntryPointSuccess;
  return 0;
}
#define cudaGetDriverEntryPointByVersion(name, fn, ver, flags, r) \
  static_cast<cudaError_t>(shim_entry(name, fn, r))
#define cudaGetDriverEntryPoint(name, fn, flags, r) \
  static_cast<cudaError_t>(shim_entry(name, fn, r))
