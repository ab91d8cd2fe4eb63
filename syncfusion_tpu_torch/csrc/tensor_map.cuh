// Host code of the TMA-fed kernels (flash_fwd_wide_sm90.cu and
// flash_bwd_wide_sm90.cu): the tensor maps their loads read, built per call
// with cuTensorMapEncodeTiled from the operands' strides.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

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

}  // namespace
