// The depthwise tensor product's primitive R (K6-R):
//   col[e, j] = sum over the terms of column j of c * sum_u a[e, i+u] * b[e, p+u] * d[e, o+u]
// [E, d_col].  The column (SH) leg of the T / R family: the position
// gradient of the force models through the SH, at every order.
//
// Replaces: equiformer_tpu/kernels/dtp_pallas.py, _r_kernel (built by
// _r_call, bound by _t_transpose for the col cotangent).  Term tables:
// equiformer_tpu_torch/kernels/dtp.py (TermList.r_plan: fb_plan's dw
// chunks, slots and column lists).
//
// What bounds it on the card: bytes.  It reads a, b and d (3 operations per
// term element per edge) and writes only d_col (9 or 16) values per edge.
//
// Design: R(a, b, d) is K6-FB's dsh for x = a, w = b, g = d, so K6-R is
// K6-FB's block with dsh alone (csrc/dtp_fb.cuh, `fb_block` without kFull):
// a block per edge tile (TermList.r_tile), a (one row where broadcast)
// staged once by cp.async, b and d read through L1 / L2 (a lane reads its
// column of b once an item; d is read by the few terms of its output tile);
// the warps take the b <-> out permutation's chunks, whose lanes each hold
// one column of b, add c * sum a b d per term (four terms at a time) by a
// butterfly into a (row, term, piece) slot, and each (row, column) sums its slots in fb_plan's
// order after a barrier.  The same slots summed in the same order: K6-FB's
// dsh in every bit, on every run; no atomics.

#include "dtp_fb.cuh"

namespace {

using namespace eqt::dtp;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dtp_r_kernel(const T* __restrict__ a, long long sa, const T* __restrict__ b, long long sb,
             const T* __restrict__ d, int d_d, T* __restrict__ out, int d_col, int d_a, int d_b,
             int E, int tile, const int4* __restrict__ chunks, const int4* __restrict__ terms,
             int n_terms, int n_slots, const int* __restrict__ ranges,
             const int* __restrict__ slots, const int* __restrict__ items, int n_items) {
  extern __shared__ __align__(16) unsigned char smem[];
  fb_block<T, V, false, false>(smem, a, sa, nullptr, d_col, b, sb, d, d_d, nullptr, d_a, out,
                               nullptr, d_b, E, tile, chunks, 0, nullptr, terms, n_terms, n_slots,
                               ranges, slots, items, n_items);
}

template <typename T, int V>
int launch(const void* a, long long sa, const void* b, long long sb, const void* d, int d_d,
           void* out, int d_col, int d_a, int d_b, int E, int tile, const void* chunks,
           const void* terms, int n_terms, int n_slots, const void* ranges, const void* slots,
           const void* items, int n_items, cudaStream_t stream) {
  static long long allowed = 48 << 10;  // this instantiation's dynamic shared memory limit
  const FbLayout lay =
      fb_layout(tile, sizeof(T), sa == 0, sb == 0, false, d_a, 0, d_d, 0, n_slots);
  return launch_tiles(dtp_r_kernel<T, V>, allowed, lay.bytes, E, tile, stream,
                   static_cast<const T*>(a), sa, static_cast<const T*>(b), sb,
                   static_cast<const T*>(d), d_d, static_cast<T*>(out), d_col, d_a, d_b, E, tile,
                   static_cast<const int4*>(chunks), static_cast<const int4*>(terms), n_terms,
                   n_slots, static_cast<const int*>(ranges), static_cast<const int*>(slots),
                   static_cast<const int*>(items), n_items);
}

template <typename T>
int launch_vec(int vec, const void* a, long long sa, const void* b, long long sb, const void* d,
               int d_d, void* out, int d_col, int d_a, int d_b, int E, int tile,
               const void* chunks, const void* terms, int n_terms, int n_slots,
               const void* ranges, const void* slots, const void* items, int n_items,
               cudaStream_t s) {
  if (vec == 4)
    return launch<T, 4>(a, sa, b, sb, d, d_d, out, d_col, d_a, d_b, E, tile, chunks, terms,
                        n_terms, n_slots, ranges, slots, items, n_items, s);
  if (vec == 1)
    return launch<T, 1>(a, sa, b, sb, d, d_d, out, d_col, d_a, d_b, E, tile, chunks, terms,
                        n_terms, n_slots, ranges, slots, items, n_items, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a [E, d_a], b [E, d_b] with row strides sa, sb (0: one broadcast row),
// d [E, d_d] contiguous, out [E, d_col]; the edge tile (at most 255 rows),
// then TermList.r_plan's tables:
// chunks [n, 4] (the b <-> out permutation's), their term records [n_terms,
// 4] (a_off, col_off, b_off, coeff's bits), n_slots (the slots a row), each
// column's range [d_col, 2] of slots, the items [n_items]; vec 4 or 1.
extern "C" int dtp_r(const void* a, long long sa, const void* b, long long sb, const void* d,
                     int d_d, void* out, int d_col, int d_a, int d_b, int E, int tile,
                     const void* chunks, const void* terms, int n_terms,
                     int n_slots, const void* ranges, const void* slots, const void* items,
                     int n_items, int vec, int dtype, void* stream) {
  if (d_col < 1 || d_col > kMaxCol || tile < 1 || tile > 255 || n_items < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_vec<float>(vec, a, sa, b, sb, d, d_d, out, d_col, d_a, d_b, E, tile, chunks,
                             terms, n_terms, n_slots, ranges, slots, items, n_items, s);
  if (dtype == eqt::kBFloat16)
    return launch_vec<__nv_bfloat16>(vec, a, sa, b, sb, d, d_d, out, d_col, d_a, d_b, E, tile,
                                     chunks, terms, n_terms, n_slots, ranges, slots, items,
                                     n_items, s);
  return (int)cudaErrorInvalidValue;
}
