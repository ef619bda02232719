// Shared helpers of the port's CUDA kernels: element loads/stores that
// compute in fp32 whatever the storage type (float or bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace eqt {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// dtype codes passed from Python (kernels/_build.py: dtype_code)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace eqt
