// CSR segment sum over dst-sorted edges (K3).
//
// Replaces: equiformer_tpu/kernels/segment_csr_pallas.py, _kernel (via
// _csr_call / csr_segment_sum).  Wrapper: equiformer_tpu_torch/kernels/segment_csr.py.
//
// What it computes: out[u, c] = sum over e in [rowptr[u], rowptr[u+1]) with
// mask[e] set of val[e, c], accumulated in fp32, written in val's dtype.
//
// What bounds it on the card: device memory.  Every val element is read
// once and each output written once (flagship edge-degree scatter: ~40k x 480
// in, 3840 x 480 out), with one add per element read.
//
// Design: the TPU kernel builds a membership matrix per node tile and sums on
// the matrix unit, because its grid runs in order on one core.  Here the row
// pointers give each node its own edge range, so one block of 128 threads
// takes one node and 128 consecutive columns: loads are coalesced along the
// columns, each thread keeps one fp32 sum in a register, and there are no
// atomics, so the result does not depend on the schedule.  Masked edges are
// skipped (the JAX code zeroes them first, which is the same sum).

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_segment_sum_kernel(const T* __restrict__ val, int C, const int* __restrict__ rowptr,
                       const unsigned char* __restrict__ mask, T* __restrict__ out) {
  const int n = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const int begin = rowptr[n], end = rowptr[n + 1];
  float acc = 0.f;
  for (int e = begin; e < end; ++e)
    if (mask == nullptr || mask[e]) acc += to_f(val[(long long)e * C + c]);
  out[(long long)n * C + c] = from_f<T>(acc);
}

template <typename T>
int launch(const void* val, int C, const void* rowptr, const void* mask, void* out, int N,
           cudaStream_t stream) {
  const dim3 grid(N, (C + kThreads - 1) / kThreads);
  csr_segment_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(val), C, static_cast<const int*>(rowptr),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int csr_segment_sum(const void* val, int C, const void* rowptr, const void* mask,
                               void* out, int N, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return launch<float>(val, C, rowptr, mask, out, N, s);
  if (dtype == eqt::kBFloat16) return launch<__nv_bfloat16>(val, C, rowptr, mask, out, N, s);
  return (int)cudaErrorInvalidValue;
}
