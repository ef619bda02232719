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
// (TermList.fb_plan: dx on the a <-> out permutation's chunks, dw on the
// b <-> out one's, dsh from the dw chunks' slots).
//
// What bounds it on the card: bytes, as T and R: it reads x, sh, w and g and
// writes dx, dw and dsh, with 3 operations per term element for each.
//
// Design (csrc/dtp_fb.cuh, `fb_block` with kFull): one read of the inputs
// a tile.  A block takes `tile` edges (TermList.fb_tile: the largest of 8,
// 4 or 2 whose rows fit 40 KB, five blocks an SM: small tiles and many
// blocks measured faster than large ones) and copies their x, w, sh and g
// rows into shared memory once with cp.async (g read through L1 / L2
// instead, kGs false, where no tile fits with it: MD17 L3).  Its 8 warps
// then take the tile's dx and dw items; the dw chunks' lanes also fill the
// dsh slots, which each (row, SH column) sums after a barrier.  dx and dw
// are summed as K6-T sums them, so they are the bits of K6-T's x and w legs
// on the same operands; dsh is K6-R's (csrc/dtp_r.cu, the same block
// without dx and dw).

#include "dtp_fb.cuh"

namespace {

using namespace eqt::dtp;

template <typename T, int V, bool kGs>
__global__ void __launch_bounds__(kThreads)
dtp_fused_bwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                     const T* __restrict__ w, long long sw, const T* __restrict__ g, int d_g,
                     T* __restrict__ dx, int d_x, T* __restrict__ dsh, T* __restrict__ dw,
                     int d_w, int E, int tile, const int4* __restrict__ chunks, int n_dx,
                     const int4* __restrict__ dx_terms, const int4* __restrict__ dw_terms,
                     int n_dw_terms, int n_slots, const int* __restrict__ dsh_ranges,
                     const int* __restrict__ dsh_slots, const int* __restrict__ items,
                     int n_items) {
  extern __shared__ __align__(16) unsigned char smem[];
  fb_block<T, V, kGs, true>(smem, x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x, dsh, dw, d_w, E, tile,
                            chunks, n_dx, dx_terms, dw_terms, n_dw_terms, n_slots, dsh_ranges,
                            dsh_slots, items, n_items);
}

template <typename T, int V, bool kGs>
int launch(const void* x, long long sx, const void* sh, int d_sh, const void* w, long long sw,
           const void* g, int d_g, void* dx, int d_x, void* dsh, void* dw, int d_w, int E,
           int tile, const void* chunks, int n_dx, const void* dx_terms, const void* dw_terms,
           int n_dw_terms, int n_slots, const void* dsh_ranges, const void* dsh_slots,
           const void* items, int n_items, cudaStream_t stream) {
  static long long allowed = 48 << 10;  // this instantiation's dynamic shared memory limit
  const FbLayout lay =
      fb_layout(tile, sizeof(T), sx == 0, sw == 0, kGs, d_x, d_w, d_g, d_sh, n_slots);
  return launch_tiles(
      dtp_fused_bwd_kernel<T, V, kGs>, allowed, lay.bytes, E, tile, stream,
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      sw, static_cast<const T*>(g), d_g, static_cast<T*>(dx), d_x, static_cast<T*>(dsh),
      static_cast<T*>(dw), d_w, E, tile, static_cast<const int4*>(chunks), n_dx,
      static_cast<const int4*>(dx_terms), static_cast<const int4*>(dw_terms), n_dw_terms,
      n_slots, static_cast<const int*>(dsh_ranges), static_cast<const int*>(dsh_slots),
      static_cast<const int*>(items), n_items);
}

template <typename T>
int launch_variant(int vec, int stage_g, const void* x, long long sx, const void* sh, int d_sh,
                   const void* w, long long sw, const void* g, int d_g, void* dx, int d_x,
                   void* dsh, void* dw, int d_w, int E, int tile, const void* chunks, int n_dx,
                   const void* dx_terms, const void* dw_terms, int n_dw_terms, int n_slots,
                   const void* dsh_ranges, const void* dsh_slots, const void* items,
                   int n_items, cudaStream_t s) {
#define EQT_FB_LAUNCH(V, GS)                                                                    \
  return launch<T, V, GS>(x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x, dsh, dw, d_w, E, tile, chunks, \
                          n_dx, dx_terms, dw_terms, n_dw_terms, n_slots, dsh_ranges, dsh_slots,   \
                          items, n_items, s)
  if (vec == 4 && stage_g) EQT_FB_LAUNCH(4, true);
  if (vec == 4) EQT_FB_LAUNCH(4, false);
  if (vec == 1 && stage_g) EQT_FB_LAUNCH(1, true);
  if (vec == 1) EQT_FB_LAUNCH(1, false);
#undef EQT_FB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, w [E, d] with row strides sx, sw (0: one broadcast row); sh [E, d_sh]
// and g [E, d_g] contiguous; dx [E, d_x], dsh [E, d_sh], dw [E, d_w]; the
// edge tile (at most 255 rows), stage_g (1: g staged in shared memory),
// then TermList.fb_plan's tables: chunks [n, 4] (the n_dx dx chunks, then
// the dw chunks), dx and dw terms [n, 4] (a_off, col_off, b_off, coeff's
// bits), n_dw_terms and n_slots (the dsh slots a row), each SH column's
// range [d_sh, 2] of dsh_slots, the items [n_items]; vec 4 or 1.
extern "C" int dtp_fused_bwd(const void* x, long long sx, const void* sh, int d_sh,
                             const void* w, long long sw, const void* g, int d_g, void* dx,
                             int d_x, void* dsh, void* dw, int d_w, int E, int tile,
                             int stage_g, const void* chunks, int n_dx, const void* dx_terms,
                             const void* dw_terms, int n_dw_terms, int n_slots,
                             const void* dsh_ranges, const void* dsh_slots, const void* items,
                             int n_items, int vec, int dtype, void* stream) {
  if (d_sh > kMaxCol || tile < 1 || tile > 255 || n_items < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_variant<float>(vec, stage_g, x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x, dsh, dw,
                                 d_w, E, tile, chunks, n_dx, dx_terms, dw_terms, n_dw_terms,
                                 n_slots, dsh_ranges, dsh_slots, items, n_items, s);
  if (dtype == eqt::kBFloat16)
    return launch_variant<__nv_bfloat16>(vec, stage_g, x, sx, sh, d_sh, w, sw, g, d_g, dx, d_x,
                                         dsh, dw, d_w, E, tile, chunks, n_dx, dx_terms, dw_terms,
                                         n_dw_terms, n_slots, dsh_ranges, dsh_slots, items,
                                         n_items, s);
  return (int)cudaErrorInvalidValue;
}
