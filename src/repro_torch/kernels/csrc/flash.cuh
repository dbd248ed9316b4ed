// Pieces the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share: the mask's tile range, the fast
// exponentials, the bf16 packing of an accumulator into the A layout of
// a register product, and the TMA tensor map of a [B, T, heads, D] bf16
// tensor whose box lands swizzled as the wgmma descriptors read it.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace flash {

// masked scores, as in both JAX versions (not -inf: exp(s - m) never sees
// inf - inf)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// tiles of width bk along the other axis that a tile [q0, q0 + bq) of
// queries may see: keys first..last with last - window < first
__device__ __forceinline__ void kv_range(long long q0, int bq, int bk,
                                         long long T, long long window,
                                         int* lo, int* hi) {
  long long first = q0 - window + 1;
  if (first < 0) first = 0;
  long long last = q0 + bq - 1;
  if (last > T - 1) last = T - 1;
  *lo = static_cast<int>(first / bk);
  *hi = static_cast<int>(last / bk);  // inclusive
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1): two special-function ops, absolute error
// ~1e-7 (tanhf takes some twenty instructions); +-1 where e^2x is 0 or
// inf
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.f - __fdividef(2.f, fast_exp2(x * (2.f * kLog2e)) + 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the swizzle of rows of `cols` bf16 columns (32, 64 or 128 bytes)
__host__ __device__ constexpr hop::Swizzle swizzle_of(int cols) {
  return cols * 2 == 128 ? hop::kSwizzle128
         : cols * 2 == 64 ? hop::kSwizzle64 : hop::kSwizzle32;
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled is a driver API: fetched through the runtime,
// so that the library links only the runtime
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 [B, T, heads, D] tensor as the 4-d map (D, heads, T, B), whose
// box is `cols` columns x `rows` positions of one head, swizzled by the
// row's bytes; rows at or past T arrive as zeros
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, long long B,
                            long long T, int heads, int D, int cols,
                            int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
          dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace flash
