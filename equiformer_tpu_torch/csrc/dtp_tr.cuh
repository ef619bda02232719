// The bodies of the depthwise tensor product's sparse trilinear primitives
// T and R (K6), shared by csrc/dtp_t.cu, csrc/dtp_r.cu and
// csrc/dtp_fused_bwd.cu.  Term lists and tables:
// equiformer_tpu_torch/kernels/dtp.py (TermList.t_plan, r_tables,
// fb_plan).
//
// Per edge e, over the terms (c, a_off i, col_off j, b_off p, out_off o, mul):
//   T: out[e, o+u] += c * col[e, j] * a[e, i+u] * b[e, p+u]      (u < mul)
//   R: col[e, j]   += c * sum_u a[e, i+u] * b[e, p+u] * d[e, o+u]
// A lane operand read with a row stride of 0 is one row broadcast over the
// edges.  Everything accumulates in fp32 and is rounded once to the storage
// type.
//
// T is cut into output segments: each segment is one output tile (the terms
// that write columns [o, o + mul), in table order) or a run of columns that
// no term writes (an empty term range: zeros).  The host cuts each segment
// into chunks of at most 32 * V columns and lists warp items (chunk, first
// row): a warp takes one item, lane (row, q) owns the V consecutive
// columns u = q V.. of one row, with 2^lg lanes a row (lg from the chunk
// record), so 32 / 2^lg rows share a warp and no element needs a division.
// The lane sums the chunk's terms in table order,
//   acc = fmaf((c * col[j]) * a[i+u], b[p+u], acc)   from acc = 0,
// so every element has one writer and is the same bits on every run and
// for any grid the host picks; V = 4 reads a and b with one 8- or 16-byte
// load a term and writes out with one store.  A term is one 16-byte record
// (a_off, col_off, b_off, coeff), read once a term by the whole warp (a
// broadcast).  R is a reduction over u: a warp owns an (edge, column),
// each lane keeps a running sum over the column's terms (copies u = lane
// mod 32) and the warp adds the lanes with a fixed butterfly of shuffles,
// as K5a's dsh does (csrc/dtp_lin_bwd.cu).  No atomics anywhere.
#pragma once

#include "common.cuh"

namespace eqt {
namespace dtp {

constexpr int kTile = 32;              // edges per block (T and R)
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCol = 64;            // widest col operand (SH up to l = 7)
constexpr int kTermFields = 5;         // R: a_off, col_off, b_off, out_off, mul
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// V consecutive elements at p as fp32 (p aligned to V elements).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// A chunk record (int4): x output column, y width | lg << 8 | du << 11 (du
// the chunk's column within its segment, added to the terms' a and b
// offsets), z, w the segment's term range.  An item (int): chunk << 8 |
// first row.
struct Lane {
  int row;  // row within the edge tile
  int u;    // column within the chunk (a multiple of V)
  bool live;
};

template <int V>
__device__ __forceinline__ Lane item_lane(int row0, int y) {
  const int lg = (y >> 8) & 7;
  const int q = threadIdx.x & ((1 << lg) - 1);
  Lane l;
  l.row = row0 + ((threadIdx.x & 31) >> lg);
  l.u = q * V;
  l.live = l.u < (y & 255);
  return l;
}

// One lane's V elements of a T chunk: ar, br point at the lane's first
// column of a's and b's row (shared or global memory), cr at its col row
// (fp32), orow at its output.
template <int V, typename TA, typename TB, typename TO>
__device__ __forceinline__ void t_lane(const TA* ar, const TB* br, const float* cr,
                                       const int4* __restrict__ terms, int t_begin, int t_end,
                                       TO* orow) {
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int4 tt = __ldg(terms + t);
    const float cc = __int_as_float(tt.w) * cr[tt.y];
    float av[V], bv[V];
    load_vec<V>(ar + tt.x, av);
    load_vec<V>(br + tt.z, bv);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(cc * av[v], bv[v], acc[v]);
  }
  store_vec<V>(orow, acc);
}

// R for column j of the edge tile starting at e0: warp w takes rows w,
// w + kWarps, ...  `ranges` holds each column's term range.
template <typename T>
__device__ __forceinline__ void r_column(const T* __restrict__ a, long long sa,
                                         const T* __restrict__ b, long long sb,
                                         const T* __restrict__ d, int d_d,
                                         T* __restrict__ out, int d_col, int E, int e0, int j,
                                         const int* __restrict__ ranges,
                                         const int* __restrict__ terms,
                                         const float* __restrict__ coeffs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rows = min(kTile, E - e0);
  const int t_begin = ranges[2 * j], t_end = ranges[2 * j + 1];
  for (int r = warp; r < n_rows; r += kWarps) {
    const long long e = e0 + r;
    float run = 0.f;  // this lane's part of col[e, j]
    for (int t = t_begin; t < t_end; ++t) {
      const int* tt = terms + t * kTermFields;
      const float c = coeffs[t];
      const int mul = tt[4];
      const T* ar = a + e * sa + tt[0];
      const T* br = b + e * sb + tt[2];
      const T* dr = d + e * d_d + tt[3];
      for (int u = lane; u < mul; u += 32)
        run = fmaf(c * to_f(ar[u]) * to_f(br[u]), to_f(dr[u]), run);
    }
    const float v = warp_sum(run);
    if (lane == 0) out[e * d_col + j] = from_f<T>(v);
  }
}

}  // namespace dtp
}  // namespace eqt
