// The depthwise tensor product's primitive R (K6-R):
//   col[e, j] = sum over the terms of column j of c * sum_u a[e, i+u] * b[e, p+u] * d[e, o+u]
// [E, d_col].  The column (SH) leg of the T / R family: the position
// gradient of the force models through the SH, at every order.
//
// Replaces: equiformer_tpu/kernels/dtp_pallas.py, _r_kernel (built by
// _r_call, bound by _t_transpose for the col cotangent).  Term tables:
// equiformer_tpu_torch/kernels/dtp.py (TermList.r_tables).
//
// What bounds it on the card: bytes.  It reads a, b and d (3 operations per
// term element per edge) and writes only d_col (9 or 16) values per edge.
//
// Design (csrc/dtp_tr.cuh): grid (edge tiles of 32, columns); a warp owns an
// (edge, column), each lane a running sum over the column's terms, the
// lanes added by a fixed shuffle butterfly: the same bits on every run.

#include <stdint.h>

#include "dtp_tr.cuh"

namespace {

using namespace eqt::dtp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_r_kernel(const T* __restrict__ a, long long sa, const T* __restrict__ b, long long sb,
             const T* __restrict__ d, int d_d, T* __restrict__ out, int d_col, int E,
             const int* __restrict__ ranges, const int* __restrict__ terms,
             const float* __restrict__ coeffs) {
  r_column<T>(a, sa, b, sb, d, d_d, out, d_col, E, blockIdx.x * kTile, blockIdx.y, ranges, terms,
              coeffs);
}

template <typename T>
int launch(const void* a, long long sa, const void* b, long long sb, const void* d, int d_d,
           void* out, int d_col, int E, const void* ranges, const void* terms,
           const void* coeffs, cudaStream_t stream) {
  const dim3 grid((E + kTile - 1) / kTile, d_col);
  dtp_r_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), sa, static_cast<const T*>(b), sb, static_cast<const T*>(d),
      d_d, static_cast<T*>(out), d_col, E, static_cast<const int*>(ranges),
      static_cast<const int*>(terms), static_cast<const float*>(coeffs));
  return (int)cudaGetLastError();
}

}  // namespace

// a, b [E, d] with row strides sa, sb (0: one broadcast row), d [E, d_d]
// contiguous, out [E, d_col]; ranges [d_col, 2], terms [n, 5], coeffs [n]
// from TermList.r_tables.
extern "C" int dtp_r(const void* a, long long sa, const void* b, long long sb, const void* d,
                     int d_d, void* out, int d_col, int E, const void* ranges,
                     const void* terms, const void* coeffs, int dtype, void* stream) {
  if (d_col < 1 || d_col > kMaxGridY) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(a, sa, b, sb, d, d_d, out, d_col, E, ranges, terms, coeffs, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(a, sa, b, sb, d, d_d, out, d_col, E, ranges, terms, coeffs, s);
  return (int)cudaErrorInvalidValue;
}
