// The CUDA-core FMA probe (S2): K dependent multiply-adds per element,
//   out[i] = f^K(x[i]),  f(a) = a * m + c,
// with m and c runtime arguments already rounded to the operand type.
//
// Replaces: scripts/chip_peaks.py, _vpu_kernel under bench_vpu (the
// [64 * 512, 128] call, K = 512) and bench_vpu_wide ([64 * 256, 1024],
// K = 64): a measurement of the rate at which the card's vector units
// (here the CUDA cores, not the tensor cores) run elementwise FMAs, which
// is what the DTP kernels' term loops spend.  Wrapper and plain version:
// equiformer_tpu_torch/kernels/peaks.py.
//
// What bounds it on the card: operations.  Per element it reads and writes
// one value and does 2K floating-point operations (K = 512: 256 fp32
// operations per byte; the card's fp32 balance is ~20).
//
// Design: each thread owns kVecs 16-byte vectors of consecutive elements
// (8 fp32 or 16 bf16), so each thread carries 8 independent dependency
// chains (fp32: fmaf; bf16: __hfma2 on __nv_bfloat162 pairs, the CUDA
// cores' bf16 rate): one chain a thread would measure the FMA's latency,
// not its throughput.  m and c arrive as kernel arguments: a multiplier of
// exactly 1 (JAX's weakly typed 1.000001 rounds to 1.0 in bf16) known at
// compile time would be folded away, leaving an add chain.  Every result is
// stored, so no iteration is dead.  A ragged tail of fewer than one
// thread's elements runs element by element.

#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-byte vectors per thread

__global__ void __launch_bounds__(kThreads)
fma_f32_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int k,
               float m, float c) {
  constexpr int kPer = kVecs * 4;
  const long long chunks = n / kPer;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < chunks) {
    const float4* src = reinterpret_cast<const float4*>(x) + i * kVecs;
    float v[kPer];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 a = src[q];
      v[4 * q + 0] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
#pragma unroll 4
    for (int it = 0; it < k; ++it)
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = fmaf(v[j], m, c);
    float4* dst = reinterpret_cast<float4*>(out) + i * kVecs;
#pragma unroll
    for (int q = 0; q < kVecs; ++q)
      dst[q] = make_float4(v[4 * q + 0], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if (i - chunks < n - chunks * kPer) {  // the tail, one element a thread
    const long long e = chunks * kPer + (i - chunks);
    float v = x[e];
    for (int it = 0; it < k; ++it) v = fmaf(v, m, c);
    out[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
fma_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                long long n, int k, float mf, float cf) {
  constexpr int kPairs = kVecs * 4;  // __nv_bfloat162 pairs a thread
  constexpr int kPer = 2 * kPairs;
  const __nv_bfloat162 m = __float2bfloat162_rn(mf);
  const __nv_bfloat162 c = __float2bfloat162_rn(cf);
  const long long chunks = n / kPer;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < chunks) {
    const uint4* src = reinterpret_cast<const uint4*>(x) + i * kVecs;
    __nv_bfloat162 v[kPairs];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const uint4 a = src[q];
      memcpy(&v[4 * q], &a, sizeof(a));
    }
#pragma unroll 4
    for (int it = 0; it < k; ++it)
#pragma unroll
      for (int j = 0; j < kPairs; ++j) v[j] = __hfma2(v[j], m, c);
    uint4* dst = reinterpret_cast<uint4*>(out) + i * kVecs;
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      uint4 a;
      memcpy(&a, &v[4 * q], sizeof(a));
      dst[q] = a;
    }
  } else if (i - chunks < n - chunks * kPer) {
    const long long e = chunks * kPer + (i - chunks);
    __nv_bfloat16 v = x[e];
    for (int it = 0; it < k; ++it) v = __hfma(v, m.x, c.x);
    out[e] = v;
  }
}

}  // namespace

// x and out: n contiguous elements, 16-byte aligned; m and c already
// rounded to the dtype (the wrapper does it).
extern "C" int fma_probe(const void* x, void* out, long long n, int k, float m, float c,
                         int dtype, void* stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int per = dtype == eqt::kFloat32 ? kVecs * 4 : kVecs * 8;
  const long long threads = n / per + n % per;  // one a chunk, one a tail element
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32)
    fma_f32_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                        static_cast<float*>(out), n, k, m, c);
  else if (dtype == eqt::kBFloat16)
    fma_bf16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, k, m, c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
