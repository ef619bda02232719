// The depthwise tensor product's primitive T (K6-T):
//   out[e, o+u] = sum over the terms writing output tile o of
//                 c * col[e, j] * a[e, i+u] * b[e, p+u]
// [E, d_out], zero where no term writes.  The forward of every DTP call site
// on the unfused route (a = x, col = sh, b = w) and every derivative leg of
// the T / R family but the column one.
//
// Replaces: equiformer_tpu/kernels/dtp_pallas.py, _t_kernel (built by
// _t_call; also the forward of make_first_order_dtp's fwd_call), and its
// lane-packed variant _t_kernel_packed (PackedPallasDTP), which computes the
// same function.  Term tables: equiformer_tpu_torch/kernels/dtp.py.
//
// What bounds it on the card: bytes.  Per edge it writes d_out values (3136
// at the QM9 sites, 9408 at the MD17 L3 sep_act site) and does 3 operations
// per term element (6848 / 31808 per edge), about 2-3.5 per byte written in
// fp32: far below the card's ~20 fp32 operations per byte.
//
// Design (csrc/dtp_tr.cuh): grid (edge tiles of 32, output segments); one
// writer per output element, terms summed in table order, a and b read
// coalesced along u.  A row stride of 0 broadcasts a or b.  A simple kernel
// first: a and b are re-read from L2 by every segment's block, and the
// terms of one tile are not fused into one pass.

#include <stdint.h>

#include "dtp_tr.cuh"

namespace {

using namespace eqt::dtp;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_t_kernel(const T* __restrict__ a, long long sa, const T* __restrict__ col, int d_col,
             const T* __restrict__ b, long long sb, T* __restrict__ out, int d_out, int E,
             const int* __restrict__ segs, const int* __restrict__ terms,
             const float* __restrict__ coeffs) {
  __shared__ float s_col[kTile * kMaxCol];
  t_segment<T>(a, sa, col, d_col, b, sb, out, d_out, E, blockIdx.x * kTile,
               segs + blockIdx.y * kSegFields, terms, coeffs, s_col);
}

template <typename T>
int launch(const void* a, long long sa, const void* col, int d_col, const void* b, long long sb,
           void* out, int d_out, int E, const void* segs, int n_seg, const void* terms,
           const void* coeffs, cudaStream_t stream) {
  const dim3 grid((E + kTile - 1) / kTile, n_seg);
  dtp_t_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), sa, static_cast<const T*>(col), d_col,
      static_cast<const T*>(b), sb, static_cast<T*>(out), d_out, E,
      static_cast<const int*>(segs), static_cast<const int*>(terms),
      static_cast<const float*>(coeffs));
  return (int)cudaGetLastError();
}

}  // namespace

// a [E, d_a] with row stride sa (0: one broadcast row), col [E, d_col]
// contiguous, b likewise with sb, out [E, d_out]; segs [n_seg, 4], terms
// [n, 5], coeffs [n] from TermList.t_tables.
extern "C" int dtp_t(const void* a, long long sa, const void* col, int d_col, const void* b,
                     long long sb, void* out, int d_out, int E, const void* segs, int n_seg,
                     const void* terms, const void* coeffs, int dtype, void* stream) {
  if (d_col > kMaxCol || n_seg < 1 || n_seg > kMaxGridY) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(a, sa, col, d_col, b, sb, out, d_out, E, segs, n_seg, terms, coeffs, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(a, sa, col, d_col, b, sb, out, d_out, E, segs, n_seg, terms,
                                 coeffs, s);
  return (int)cudaErrorInvalidValue;
}
