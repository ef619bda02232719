// K6-FB's block, shared by csrc/dtp_fused_bwd.cu (K6-FB: dx, dsh and dw)
// and csrc/dtp_r.cu (K6-R: dsh alone), the output set a template argument.
// Term tables: equiformer_tpu_torch/kernels/dtp.py (TermList.fb_plan, and
// r_plan, its dw chunks alone).
//
// For the cotangent g of z = T(x, sh, w):
//   dx[e, i+u]  = sum c * sh[e, j] * w[e, p+u] * g[e, o+u]    (grouped by a_off)
//   dw[e, p+u]  = sum c * sh[e, j] * x[e, i+u] * g[e, o+u]    (grouped by b_off)
//   dsh[e, j]   = sum c * sum_u x[e, i+u] * w[e, p+u] * g[e, o+u]
// and R(a, b, d) is dsh for x = a, w = b, g = d.  A block takes `tile`
// edges and copies their x rows (one row of a broadcast x) and, for dx and
// dw, their w rows (likewise), their g rows where they fit (kGs) and their sh
// rows into shared memory once, with cp.async.  Its 8 warps then take the tile's warp items
// in turn: dx chunks (K6-T's lane on the a <-> out permutation with a = g,
// b = w), then dw chunks (the b <-> out one, a = x, b = g).  A dw chunk is
// one instruction's w tile, so its lane also holds w[p+u]: per term it adds
// sum_u x g w over its columns, the row's lanes add theirs by a fixed
// butterfly, and the first writes c * sum into the term's slot of the row
// (one slot per (row, term, chunk)); after a barrier each (row, SH column)
// sums its slots in a fixed order (fb_plan's dsh lists).  K6-R runs only
// the dw items, four terms at a time, and stores no dw; each slot is the
// same operations on the same operands in the same order, so its dsh is
// K6-FB's in every bit.
// Every element has one writer and a fixed order, so the bits repeat.
#pragma once

#include "dtp_tr.cuh"

namespace eqt {
namespace dtp {

constexpr int kRTerms = 4;  // the terms a K6-R lane sums at a time

// Shared memory: x rows, w rows, g rows (if staged), sh rows (fp32, if
// staged) and the dsh slots (fp32).
struct FbLayout {
  long long x, w, g, sh, part, bytes;
};

// d_sh 0: no sh rows (K6-R).
__host__ __device__ inline FbLayout fb_layout(int tile, int size, bool bx, bool bw, bool gs,
                                              int d_x, int d_w, int d_g, int d_sh, int n_slots) {
  FbLayout l;
  l.x = 0;
  l.w = l.x + align16((long long)(bx ? 1 : tile) * d_x * size);
  l.g = l.w + align16((long long)(bw ? 1 : tile) * d_w * size);
  l.sh = l.g + (gs ? align16((long long)tile * d_g * size) : 0);
  l.part = l.sh + align16((long long)tile * d_sh * 4);
  l.bytes = l.part + (long long)tile * n_slots * 4;
  return l;
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

// A K6-R lane: dw_lane's slots without dw, kU terms at a time: each term's
// sum is the same operations in the same order as dw_lane's (so the same
// bits), but the kU terms' loads and butterflies overlap.
template <int V, int kU, typename T, typename TG>
__device__ __forceinline__ void r_lane(const T* xr, const TG* gr, const T* wr,
                                       const int4* __restrict__ terms, int t_begin, int t_end,
                                       int lg, bool live, float* part) {
  float wv[V];
  load_vec<V>(wr, wv);
  const float keep = live ? 1.f : 0.f;
  const bool first = live && (threadIdx.x & ((1 << lg) - 1)) == 0;
#pragma unroll
  for (int v = 0; v < V; ++v) wv[v] *= keep;
  int t = t_begin;
  for (; t + kU <= t_end; t += kU) {
    float p[kU], c[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int4 tt = __ldg(terms + t + q);
      c[q] = __int_as_float(tt.w);
      float av[V], bv[V];
      load_vec<V>(xr + tt.x, av);
      load_vec<V>(gr + tt.z, bv);
      p[q] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) p[q] = fmaf(av[v] * bv[v], wv[v], p[q]);
    }
    for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < kU; ++q) p[q] += __shfl_xor_sync(0xffffffffu, p[q], off);
    if (first)
#pragma unroll
      for (int q = 0; q < kU; ++q) part[t + q] = c[q] * p[q];
  }
  for (; t < t_end; ++t) {
    const int4 tt = __ldg(terms + t);
    float av[V], bv[V];
    load_vec<V>(xr + tt.x, av);
    load_vec<V>(gr + tt.z, bv);
    float p = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) p = fmaf(av[v] * bv[v], wv[v], p);
    p = group_sum(p, lg);
    if (first) part[t] = __int_as_float(tt.w) * p;
  }
}

// One block of K6-FB (kFull: dx and dw chunks, x, w, sh and g (kGs)
// staged, dx, dsh and dw written) or of K6-R (the dw chunks alone, x
// staged, w and g read from global memory, dsh written; sh, dx and dw
// unused).  A dw chunk's lane reads its own columns of w once, so only
// K6-FB's dx chunks, which read w per term, need it staged.
template <typename T, int V, bool kGs, bool kFull>
__device__ __forceinline__ void fb_block(
    unsigned char* smem, const T* __restrict__ x, long long sx, const T* __restrict__ sh,
    int d_sh, const T* __restrict__ w, long long sw, const T* __restrict__ g, int d_g,
    T* __restrict__ dx, int d_x, T* __restrict__ dsh, T* __restrict__ dw, int d_w, int E,
    int tile, const int4* __restrict__ chunks, int n_dx, const int4* __restrict__ dx_terms,
    const int4* __restrict__ dw_terms, int n_dw_terms, int n_slots,
    const int* __restrict__ dsh_ranges, const int* __restrict__ dsh_slots,
    const int* __restrict__ items, int n_items) {
  const int e0 = blockIdx.x * tile;
  const int n_rows = min(tile, E - e0);
  const FbLayout lay = fb_layout(tile, sizeof(T), sx == 0, sw == 0, kGs, d_x, kFull ? d_w : 0,
                                 d_g, kFull ? d_sh : 0, n_slots);
  T* s_x = reinterpret_cast<T*>(smem + lay.x);
  T* s_w = reinterpret_cast<T*>(smem + lay.w);
  T* s_g = reinterpret_cast<T*>(smem + lay.g);
  float* s_sh = reinterpret_cast<float*>(smem + lay.sh);
  float* s_part = reinterpret_cast<float*>(smem + lay.part);
  stage(s_x, x + e0 * sx, (long long)(sx ? n_rows : 1) * d_x);
  if constexpr (kFull) stage(s_w, w + e0 * sw, (long long)(sw ? n_rows : 1) * d_w);
  if constexpr (kGs) stage(s_g, g + (long long)e0 * d_g, (long long)n_rows * d_g);
  if constexpr (kFull)
    for (int i = threadIdx.x; i < n_rows * d_sh; i += kThreads)
      s_sh[i] = to_f(sh[(long long)e0 * d_sh + i]);
  stage_wait();
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
    if (kFull && k < n_dx) {  // dx = T(g, sh, w) on the a <-> out permutation
      if constexpr (kFull) {
        if (live)
          t_lane<V>(gr, s_w + row * rw + u, cr, dx_terms, ch.z, ch.w, dx + e * d_x + ch.x + lu);
      }
    } else {  // dw = T(x, sh, g) on the b <-> out permutation (kFull), and the dsh slots
      const int lg = (ch.y >> 8) & 7;
      const int piece = (ch.y >> 11) / (32 * V);
      const T* wr = (kFull ? s_w + row * rw : w + e * sw) + ch.x + lu;
      float* part = s_part + row * n_slots + piece * n_dw_terms;
      if constexpr (kFull)
        dw_lane<V>(s_x + row * rx + u, gr, wr, cr, dw_terms, ch.z, ch.w, lg, live,
                   live && (threadIdx.x & ((1 << lg) - 1)) == 0, part,
                   dw + e * d_w + ch.x + lu);
      else
        r_lane<V, kRTerms>(s_x + row * rx + u, gr, wr, dw_terms, ch.z, ch.w, lg, live, part);
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

}  // namespace dtp
}  // namespace eqt
