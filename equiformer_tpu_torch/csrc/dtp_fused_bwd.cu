// The depthwise tensor product's first-order backward in one launch (K6-FB):
// for the cotangent g of z = T(x, sh, w),
//   dx[e, i+u]  = sum c * sh[e, j] * w[e, p+u] * g[e, o+u]    (grouped by a_off)
//   dw[e, p+u]  = sum c * sh[e, j] * x[e, i+u] * g[e, o+u]    (grouped by b_off)
//   dsh[e, j]   = sum c * sum_u x[e, i+u] * w[e, p+u] * g[e, o+u]
// each per edge; a broadcast x or w (row stride 0) gets its gradient per
// edge and the wrapper sums it.  dsh is computed even when the caller
// discards it, as in JAX.
//
// Replaces: equiformer_tpu/kernels/dtp_pallas.py, _fused_bwd_kernel (built
// by make_first_order_dtp's bwd_call; opt-in there through
// EQUIFORMER_TPU_FUSED_BWD=1).  Term tables: equiformer_tpu_torch/kernels/dtp.py
// (dx: the a <-> out permutation's T tables, dw: the b <-> out one's, dsh:
// R's).
//
// What bounds it on the card: bytes, as T and R: it reads x, sh, w and g and
// writes dx, dw and dsh, with 3 operations per term element for each.
//
// Design (csrc/dtp_tr.cuh): grid (edge tiles of 32, dx segments + dw
// segments + SH columns); a block runs T's body on a dx or dw segment or
// R's on one column, so every element has one writer and no atomics are
// needed.  A simple kernel first: the three outputs share one launch but not
// one read of the inputs.

#include <stdint.h>

#include "dtp_tr.cuh"

namespace {

using namespace eqt::dtp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_fused_bwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                     const T* __restrict__ w, long long sw, const T* __restrict__ g, int d_g,
                     T* __restrict__ dx, int d_x, T* __restrict__ dsh, T* __restrict__ dw,
                     int d_w, int E, const int* __restrict__ dx_segs, int n_dx,
                     const int* __restrict__ dx_terms, const float* __restrict__ dx_coeffs,
                     const int* __restrict__ dw_segs, int n_dw, const int* __restrict__ dw_terms,
                     const float* __restrict__ dw_coeffs, const int* __restrict__ r_ranges,
                     const int* __restrict__ r_terms, const float* __restrict__ r_coeffs) {
  __shared__ float s_col[kTile * kMaxCol];
  const int e0 = blockIdx.x * kTile;
  const int y = blockIdx.y;
  if (y < n_dx)  // dx = T(g, sh, w) on the a <-> out permutation
    t_segment<T>(g, d_g, sh, d_sh, w, sw, dx, d_x, E, e0, dx_segs + y * kSegFields, dx_terms,
                 dx_coeffs, s_col);
  else if (y < n_dx + n_dw)  // dw = T(x, sh, g) on the b <-> out permutation
    t_segment<T>(x, sx, sh, d_sh, g, d_g, dw, d_w, E, e0, dw_segs + (y - n_dx) * kSegFields,
                 dw_terms, dw_coeffs, s_col);
  else  // dsh = R(x, w, g)
    r_column<T>(x, sx, w, sw, g, d_g, dsh, d_sh, E, e0, y - n_dx - n_dw, r_ranges, r_terms,
                r_coeffs);
}

template <typename T>
int launch(const void* x, long long sx, const void* sh, int d_sh, const void* w, long long sw,
           const void* g, int d_g, void* dx, int d_x, void* dsh, void* dw, int d_w, int E,
           const void* dx_segs, int n_dx, const void* dx_terms, const void* dx_coeffs,
           const void* dw_segs, int n_dw, const void* dw_terms, const void* dw_coeffs,
           const void* r_ranges, const void* r_terms, const void* r_coeffs,
           cudaStream_t stream) {
  const dim3 grid((E + kTile - 1) / kTile, n_dx + n_dw + d_sh);
  dtp_fused_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      sw, static_cast<const T*>(g), d_g, static_cast<T*>(dx), d_x, static_cast<T*>(dsh),
      static_cast<T*>(dw), d_w, E, static_cast<const int*>(dx_segs), n_dx,
      static_cast<const int*>(dx_terms), static_cast<const float*>(dx_coeffs),
      static_cast<const int*>(dw_segs), n_dw, static_cast<const int*>(dw_terms),
      static_cast<const float*>(dw_coeffs), static_cast<const int*>(r_ranges),
      static_cast<const int*>(r_terms), static_cast<const float*>(r_coeffs));
  return (int)cudaGetLastError();
}

}  // namespace

// x, w [E, d] with row strides sx, sw (0: one broadcast row); sh [E, d_sh]
// and g [E, d_g] contiguous; dx [E, d_x], dsh [E, d_sh], dw [E, d_w].
extern "C" int dtp_fused_bwd(const void* x, long long sx, const void* sh, int d_sh,
                             const void* w, long long sw, const void* g, int d_g, void* dx,
                             int d_x, void* dsh, void* dw, int d_w, int E, const void* dx_segs,
                             int n_dx, const void* dx_terms, const void* dx_coeffs,
                             const void* dw_segs, int n_dw, const void* dw_terms,
                             const void* dw_coeffs, const void* r_ranges, const void* r_terms,
                             const void* r_coeffs, int dtype, void* stream) {
  if (d_sh > kMaxCol || n_dx < 1 || n_dw < 1 || n_dx + n_dw + d_sh > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x, dsh, dw, d_w, E, dx_segs,
                         n_dx, dx_terms, dx_coeffs, dw_segs, n_dw, dw_terms, dw_coeffs,
                         r_ranges, r_terms, r_coeffs, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x, dsh, dw, d_w, E,
                                 dx_segs, n_dx, dx_terms, dx_coeffs, dw_segs, n_dw, dw_terms,
                                 dw_coeffs, r_ranges, r_terms, r_coeffs, s);
  return (int)cudaErrorInvalidValue;
}
