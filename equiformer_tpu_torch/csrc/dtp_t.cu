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
// same function.  Term tables: equiformer_tpu_torch/kernels/dtp.py
// (TermList.t_plan).
//
// What bounds it on the card: bytes.  Per edge it writes d_out values (3136
// at the QM9 sites, 9408 at the MD17 L3 sep_act site) and does 3 operations
// per term element (6848 / 31808 per edge), about 2-3.5 per byte written in
// fp32: far below the card's ~20 fp32 operations per byte.
//
// Design (csrc/dtp_tr.cuh for the lane mapping): a block takes a tile of
// kTile edges and a run of the member's output segments: all of them
// where the tiles alone fill the card (the QM9 sites), a cut into up to 16
// runs of equal work where they do not (MD17 L3, 92 tiles); the host picks
// the cut per term list and edge count (TermList.t_runs).  The block stages
// the tile's col rows in shared memory once, then its 8 warps take the
// run's warp items in turn: items are listed row group by row group (4
// rows, every chunk of the run), so the warps of a block read the same few
// rows of a and b at a time and find them in L1.  A lane owns V = 4
// consecutive columns of one row (16-byte loads and stores in fp32, 8-byte
// in bf16) where every offset, width and row stride is a multiple of 4 and
// the operands are 16-byte aligned, else V = 1; the host says which (vec).
// Each output element is summed in table order, as the first design
// (a block per (tile, segment)) summed it, so the bits are the same.

#include <stdint.h>

#include "dtp_tr.cuh"

namespace {

using namespace eqt::dtp;
using eqt::from_f;
using eqt::to_f;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dtp_t_kernel(const T* __restrict__ a, long long sa, const T* __restrict__ col, int d_col,
             const T* __restrict__ b, long long sb, T* __restrict__ out, int d_out, int E,
             const int4* __restrict__ chunks, const int4* __restrict__ terms,
             const int* __restrict__ items, const int* __restrict__ run_items) {
  __shared__ float s_col[kTile * kMaxCol];
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  for (int i = threadIdx.x; i < n_rows * d_col; i += kThreads)
    s_col[i] = to_f(col[(long long)e0 * d_col + i]);
  __syncthreads();
  const int i_end = run_items[blockIdx.y + 1];
  for (int it = run_items[blockIdx.y] + (threadIdx.x >> 5); it < i_end; it += kWarps) {
    const int item = __ldg(items + it);
    const int4 ch = __ldg(chunks + (item >> 8));
    const Lane l = item_lane<V>(item & 255, ch.y);
    if (!l.live || l.row >= n_rows) continue;
    const long long e = e0 + l.row;
    const int u = (ch.y >> 11) + l.u;
    t_lane<V>(a + e * sa + u, b + e * sb + u, s_col + l.row * d_col, terms, ch.z, ch.w,
              out + e * d_out + ch.x + l.u);
  }
}

template <typename T, int V>
int launch(const void* a, long long sa, const void* col, int d_col, const void* b, long long sb,
           void* out, int d_out, int E, const void* chunks, const void* terms, const void* items,
           const void* run_items, int n_runs, cudaStream_t stream) {
  const dim3 grid((E + kTile - 1) / kTile, n_runs);
  dtp_t_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), sa, static_cast<const T*>(col), d_col,
      static_cast<const T*>(b), sb, static_cast<T*>(out), d_out, E,
      static_cast<const int4*>(chunks), static_cast<const int4*>(terms),
      static_cast<const int*>(items), static_cast<const int*>(run_items));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* a, long long sa, const void* col, int d_col, const void* b,
               long long sb, void* out, int d_out, int E, const void* chunks, const void* terms,
               const void* items, const void* run_items, int n_runs, cudaStream_t s) {
  if (vec == 4)
    return launch<T, 4>(a, sa, col, d_col, b, sb, out, d_out, E, chunks, terms, items, run_items,
                        n_runs, s);
  if (vec == 1)
    return launch<T, 1>(a, sa, col, d_col, b, sb, out, d_out, E, chunks, terms, items, run_items,
                        n_runs, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a [E, d_a] with row stride sa (0: one broadcast row), col [E, d_col]
// contiguous, b likewise with sb, out [E, d_out]; chunks [n, 4], terms
// [n_t, 4] (a_off, col_off, b_off, coeff's bits), items [n_i] and
// run_items [n_runs + 1] (each run's item range) from TermList.t_plan;
// vec 4 or 1 (the columns a lane owns).
extern "C" int dtp_t(const void* a, long long sa, const void* col, int d_col, const void* b,
                     long long sb, void* out, int d_out, int E, const void* chunks,
                     const void* terms, const void* items, const void* run_items, int n_runs,
                     int vec, int dtype, void* stream) {
  if (d_col > kMaxCol || n_runs < 1 || n_runs > kMaxGridY) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_vec<float>(vec, a, sa, col, d_col, b, sb, out, d_out, E, chunks, terms, items,
                             run_items, n_runs, s);
  if (dtype == eqt::kBFloat16)
    return launch_vec<__nv_bfloat16>(vec, a, sa, col, d_col, b, sb, out, d_out, E, chunks, terms,
                                     items, run_items, n_runs, s);
  return (int)cudaErrorInvalidValue;
}
