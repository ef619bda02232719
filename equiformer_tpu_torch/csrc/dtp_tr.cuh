// The bodies of the depthwise tensor product's sparse trilinear primitives
// T and R (K6), shared by csrc/dtp_t.cu, csrc/dtp_r.cu and
// csrc/dtp_fused_bwd.cu.  Term lists and tables:
// equiformer_tpu_torch/kernels/dtp.py (TermList.t_tables, r_tables).
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
// no term writes (an empty term range: zeros).  A block takes one segment
// of one tile of kTile edges and a thread owns output elements (e, o + u):
// it sums the segment's terms in order, so every element has one writer and
// is the same bits on every run; neighbouring threads take neighbouring u,
// so a and b are read coalesced.  The tile's col rows (at most kMaxCol
// columns) sit in shared memory.  R is a reduction over u: a warp owns an
// (edge, column), each lane keeps a running sum over the column's terms
// (copies u = lane mod 32) and the warp adds the lanes with a fixed
// butterfly of shuffles, as K5a's dsh does (csrc/dtp_lin_bwd.cu).  No
// atomics anywhere.
#pragma once

#include "common.cuh"

namespace eqt {
namespace dtp {

constexpr int kTile = 32;              // edges per block
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCol = 64;            // widest col operand (SH up to l = 7)
constexpr int kSegFields = 4;          // output column, width, term begin, term end
constexpr int kTermFields = 5;         // a_off, col_off, b_off, out_off, mul
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// T on output segment `seg` of the edge tile starting at e0; s_col holds
// kTile * kMaxCol floats.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void t_segment(const T* __restrict__ a, long long sa,
                                          const T* __restrict__ col, int d_col,
                                          const T* __restrict__ b, long long sb,
                                          T* __restrict__ out, int d_out, int E, int e0,
                                          const int* __restrict__ seg,
                                          const int* __restrict__ terms,
                                          const float* __restrict__ coeffs, float* s_col) {
  const int tid = threadIdx.x;
  const int n_rows = min(kTile, E - e0);
  for (int i = tid; i < n_rows * d_col; i += kThreads)
    s_col[i] = to_f(col[(long long)e0 * d_col + i]);
  __syncthreads();
  const int o = seg[0], width = seg[1], t_begin = seg[2], t_end = seg[3];
  for (int i = tid; i < n_rows * width; i += kThreads) {
    const int r = i / width;
    const int u = i - r * width;
    const long long e = e0 + r;
    const float* cr = s_col + r * d_col;
    const T* ar = a + e * sa + u;
    const T* br = b + e * sb + u;
    float acc = 0.f;
    for (int t = t_begin; t < t_end; ++t) {
      const int* tt = terms + t * kTermFields;
      acc = fmaf(coeffs[t] * cr[tt[1]] * to_f(ar[tt[0]]), to_f(br[tt[2]]), acc);
    }
    out[e * d_out + o + u] = from_f<T>(acc);
  }
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
