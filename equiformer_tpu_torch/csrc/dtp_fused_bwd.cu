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
// b <-> out one's, dsh on R's column ranges).
//
// What bounds it on the card: bytes, as T and R: it reads x, sh, w and g and
// writes dx, dw and dsh, with 3 operations per term element for each.
//
// Design: one read of the inputs a tile.  A block takes `tile` edges
// (TermList.fb_tile: the largest of 8, 4 or 2 whose rows fit 40 KB, five
// blocks an SM: small tiles and many blocks measured faster than large
// ones) and copies their x, w, sh and g rows into shared memory once with
// cp.async (one row of a broadcast x or w; g read through L1 / L2 instead,
// kGs false, where no tile fits with it: MD17 L3).  Its 8
// warps then take the tile's warp items in turn: dx chunks (K6-T's lane on
// the a <-> out permutation with a = g, b = w) and dw chunks (the b <-> out
// one, a = x, b = g).  A dw chunk is one instruction's w tile, so its lane
// also holds w[p+u]: per term it adds sum_u x g w over its columns, the
// row's lanes add theirs by a fixed butterfly, and the first writes
// c * sum into the term's slot of the row (one slot per (row, term,
// chunk)); after a barrier each (row, SH column) sums its slots in a fixed
// order (TermList.fb_plan's dsh lists).  Every element has one writer and
// a fixed order, so the bits repeat; dx and dw are summed as K6-T sums
// them, so they are the bits of K6-T's x and w legs on the same operands.

#include <stdint.h>

#include "dtp_tr.cuh"

namespace {

using namespace eqt::dtp;
using eqt::from_f;
using eqt::to_f;

__host__ __device__ constexpr long long align16(long long n) { return (n + 15) & ~15LL; }

// Shared memory: x rows, w rows, g rows (if staged), sh rows and the dsh
// slots (fp32).
struct Layout {
  long long x, w, g, sh, part, bytes;
};

__host__ __device__ inline Layout fb_layout(int tile, int size, bool bx, bool bw, bool gs,
                                            int d_x, int d_w, int d_g, int d_sh, int n_slots) {
  Layout l;
  l.x = 0;
  l.w = l.x + align16((long long)(bx ? 1 : tile) * d_x * size);
  l.g = l.w + align16((long long)(bw ? 1 : tile) * d_w * size);
  l.sh = l.g + (gs ? align16((long long)tile * d_g * size) : 0);
  l.part = l.sh + align16((long long)tile * d_sh * 4);
  l.bytes = l.part + (long long)tile * n_slots * 4;
  return l;
}

// n elements from src to dst (dst 16-byte aligned): cp.async by 16 bytes
// where src and n allow (the caller waits), else loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long long n) {
  if (((uintptr_t)src & 15) == 0 && (n * sizeof(T)) % 16 == 0) {
    const long long n16 = n * sizeof(T) / 16;
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    for (long long i = threadIdx.x; i < n16; i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + (unsigned)(i * 16)),
                   "l"(reinterpret_cast<const uint4*>(src) + i));
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

// The sum of v over each aligned group of 2^lg lanes (a fixed butterfly).
__device__ __forceinline__ float group_sum(float v, int lg) {
  for (int off = (1 << lg) >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A dw chunk's lane: dw as K6-T's t_lane sums it (a = x, b = g), and per
// term c * sum over the row's columns of x g w into the row's slot
// part[t].  Every lane of the warp calls it (the butterfly); a dead lane
// reads row 0, column 0 and adds nothing.
template <int V, typename T, typename TG>
__device__ __forceinline__ void dw_lane(const T* xr, const TG* gr, const T* wr, const float* cr,
                                        const int4* __restrict__ terms, int t_begin, int t_end,
                                        int lg, bool live, bool first, float* part, T* orow) {
  float acc[V], wv[V];
  load_vec<V>(wr, wv);
  const float keep = live ? 1.f : 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f, wv[v] *= keep;
  for (int t = t_begin; t < t_end; ++t) {
    const int4 tt = __ldg(terms + t);
    const float c = __int_as_float(tt.w);
    const float cc = c * cr[tt.y];
    float av[V], bv[V];
    load_vec<V>(xr + tt.x, av);
    load_vec<V>(gr + tt.z, bv);
    float p = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] = fmaf(cc * av[v], bv[v], acc[v]);
      p = fmaf(av[v] * bv[v], wv[v], p);
    }
    p = group_sum(p, lg);
    if (first) part[t] = c * p;
  }
  if (live) store_vec<V>(orow, acc);
}

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
  const int e0 = blockIdx.x * tile;
  const int n_rows = min(tile, E - e0);
  const Layout lay =
      fb_layout(tile, sizeof(T), sx == 0, sw == 0, kGs, d_x, d_w, d_g, d_sh, n_slots);
  T* s_x = reinterpret_cast<T*>(smem + lay.x);
  T* s_w = reinterpret_cast<T*>(smem + lay.w);
  T* s_g = reinterpret_cast<T*>(smem + lay.g);
  float* s_sh = reinterpret_cast<float*>(smem + lay.sh);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);
  stage(s_x, x + e0 * sx, (long long)(sx ? n_rows : 1) * d_x);
  stage(s_w, w + e0 * sw, (long long)(sw ? n_rows : 1) * d_w);
  if constexpr (kGs) stage(s_g, g + (long long)e0 * d_g, (long long)n_rows * d_g);
  for (int i = threadIdx.x; i < n_rows * d_sh; i += kThreads)
    s_sh[i] = to_f(sh[(long long)e0 * d_sh + i]);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int rx = sx ? d_x : 0, rw = sw ? d_w : 0;  // shared row strides
  for (int it = threadIdx.x >> 5; it < n_items; it += kWarps) {
    const int item = __ldg(items + it);
    const int k = item >> 8;
    const int4 ch = __ldg(chunks + k);
    const Lane l = item_lane<V>(item & 255, ch.y);
    const bool live = l.live && l.row < n_rows;
    const int row = live ? l.row : 0, lu = live ? l.u : 0;
    const long long e = e0 + row;
    const int u = (ch.y >> 11) + lu;
    const T* gr = (kGs ? s_g + row * d_g : g + e * d_g) + u;
    const float* cr = s_sh + row * d_sh;
    if (k < n_dx) {  // dx = T(g, sh, w) on the a <-> out permutation
      if (live)
        t_lane<V>(gr, s_w + row * rw + u, cr, dx_terms, ch.z, ch.w, dx + e * d_x + ch.x + lu);
    } else {  // dw = T(x, sh, g) on the b <-> out permutation, and the dsh slots
      const int lg = (ch.y >> 8) & 7;
      const int piece = (ch.y >> 11) / (32 * V);
      dw_lane<V>(s_x + row * rx + u, gr, s_w + row * rw + ch.x + lu, cr, dw_terms, ch.z, ch.w,
                 lg, live, live && (threadIdx.x & ((1 << lg) - 1)) == 0,
                 s_part + row * n_slots + piece * n_dw_terms, dw + e * d_w + ch.x + lu);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * d_sh; i += kThreads) {  // dsh: each row's slots in order
    const int r = i / d_sh, j = i - r * d_sh;
    float v = 0.f;
    for (int q = dsh_ranges[2 * j]; q < dsh_ranges[2 * j + 1]; ++q)
      v += s_part[r * n_slots + dsh_slots[q]];
    dsh[(long long)(e0 + r) * d_sh + j] = from_f<T>(v);
  }
}

template <typename T, int V, bool kGs>
int launch(const void* x, long long sx, const void* sh, int d_sh, const void* w, long long sw,
           const void* g, int d_g, void* dx, int d_x, void* dsh, void* dw, int d_w, int E,
           int tile, const void* chunks, int n_dx, const void* dx_terms, const void* dw_terms,
           int n_dw_terms, int n_slots, const void* dsh_ranges, const void* dsh_slots,
           const void* items, int n_items, cudaStream_t stream) {
  const Layout lay =
      fb_layout(tile, sizeof(T), sx == 0, sw == 0, kGs, d_x, d_w, d_g, d_sh, n_slots);
  auto kernel = dtp_fused_bwd_kernel<T, V, kGs>;
  static long long allowed = 48 << 10;  // this instantiation's dynamic shared memory limit
  if (lay.bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not the next launch's error
      return (int)err;
    }
    allowed = lay.bytes;
  }
  const dim3 grid((E + tile - 1) / tile);
  kernel<<<grid, kThreads, lay.bytes, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      sw, static_cast<const T*>(g), d_g, static_cast<T*>(dx), d_x, static_cast<T*>(dsh),
      static_cast<T*>(dw), d_w, E, tile, static_cast<const int4*>(chunks), n_dx,
      static_cast<const int4*>(dx_terms), static_cast<const int4*>(dw_terms), n_dw_terms,
      n_slots, static_cast<const int*>(dsh_ranges), static_cast<const int*>(dsh_slots),
      static_cast<const int*>(items), n_items);
  return (int)cudaGetLastError();
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
