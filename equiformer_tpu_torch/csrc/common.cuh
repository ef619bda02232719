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

// out[i] = sum over the rows of part [n_parts, numel], in row order: the
// second step of a reduction across blocks that each own one fp32 partial
// row, so the result does not depend on the schedule (K2's and K5c's dW).
constexpr int kReduceThreads = 256;

static __global__ void __launch_bounds__(kReduceThreads)
sum_partial_rows_kernel(const float* __restrict__ part, int n_parts, int numel,
                        float* __restrict__ out) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= numel) return;
  float acc = 0.f;
  for (int b = 0; b < n_parts; ++b) acc += part[(long long)b * numel + i];
  out[i] = acc;
}

inline cudaError_t sum_partial_rows(const float* part, int n_parts, int numel, float* out,
                                    cudaStream_t stream) {
  sum_partial_rows_kernel<<<(numel + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                            stream>>>(part, n_parts, numel, out);
  return cudaGetLastError();
}

}  // namespace eqt
