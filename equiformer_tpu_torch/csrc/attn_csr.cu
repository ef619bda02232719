// Fused attention combine over dst-sorted edges, forward (K4).
//
// Replaces: equiformer_tpu/kernels/attn_csr_pallas.py, csr_attention_combine
// (which reaches its pallas_call through the CSR segment-sum kernel).
// Wrapper: equiformer_tpu_torch/kernels/attn_csr.py.
//
// What it computes, for node u, head h = c / D:
//   out[u, c] = sum_e exp(s[e,h] - m[h]) * drop[e,h] * v[e,c]
//               / max(sum_e exp(s[e,h] - m[h]), 1e-16)
// over e in [rowptr[u], rowptr[u+1]).  m is the global per-head max, floored,
// computed by the wrapper as on the TPU; masked scores arrive as -1e30 and
// contribute exp(...) == 0.
//
// What bounds it on the card: device memory.  value (flagship ~40k x 480) is
// read once; the [E, H] scores are tiny and stay in L1/L2.
//
// Design: one pass per destination node.  A block of 128 threads takes one
// node and 128 consecutive value columns; each thread keeps the numerator
// and denominator of its head in fp32 registers and divides at the end, so
// neither the probabilities nor the weighted values go to device memory and
// no second segment pass is needed.  The TPU version rounds the weighted
// values and exponentials to the value dtype before its segment sum
// (attn_csr_pallas.py:64-67); this kernel keeps them in fp32, so bf16
// results differ from it at bf16 rounding level.

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_combine_kernel(const T* __restrict__ scores, const T* __restrict__ value,
                    const T* __restrict__ dropmul, const float* __restrict__ shift,
                    const int* __restrict__ rowptr, T* __restrict__ out, int H, int D) {
  const int n = blockIdx.x;
  const int HD = H * D;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= HD) return;
  const int h = c / D;
  const float m = shift[h];
  const int begin = rowptr[n], end = rowptr[n + 1];
  float num = 0.f, den = 0.f;
  for (int e = begin; e < end; ++e) {
    const float ex = expf(to_f(scores[(long long)e * H + h]) - m);
    den += ex;
    const float d = dropmul == nullptr ? 1.f : to_f(dropmul[(long long)e * H + h]);
    num += ex * d * to_f(value[(long long)e * HD + c]);
  }
  out[(long long)n * HD + c] = from_f<T>(num / fmaxf(den, 1e-16f));
}

template <typename T>
int launch(const void* scores, const void* value, const void* dropmul, const void* shift,
           const void* rowptr, void* out, int N, int H, int D, cudaStream_t stream) {
  const dim3 grid(N, (H * D + kThreads - 1) / kThreads);
  attn_combine_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<const T*>(value),
      static_cast<const T*>(dropmul), static_cast<const float*>(shift),
      static_cast<const int*>(rowptr), static_cast<T*>(out), H, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attn_combine(const void* scores, const void* value, const void* dropmul,
                            const void* shift, const void* rowptr, void* out, int N, int H,
                            int D, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(scores, value, dropmul, shift, rowptr, out, N, H, D, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(scores, value, dropmul, shift, rowptr, out, N, H, D, s);
  return (int)cudaErrorInvalidValue;
}
