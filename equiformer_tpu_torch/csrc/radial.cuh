// The radial fold of the fused DTP kernels (K7): the pieces that the folded
// variants of K1 (csrc/dtp_lin.cu), K2 (csrc/dtp_lin_bwd.cu) and K5a
// (csrc/dtp_lin_bwd3.cu) add to their bodies.
//
// Replaces: equiformer_tpu/kernels/dtp_lin_pallas.py, _radial_h_packed /
// _radial_w_fill (w built in the kernel), _radial_write_dw / _radial_dh
// (dh = dw Wr^T) and the d[Wr; offset] outputs of _bwd_kernel; the dh output
// of equiformer_tpu/kernels/dtp_lin_ho.py's _bwd3_kernel.
//
// With the fold, a kernel's per-edge operand is the radial MLP's last hidden
// activation h [E, hd] instead of the TP weights w [E, d_w], and
//   w[e, col] = offset[col] + sum_j h[e, j] * Wr[j, col]
// is built in shared memory, one irrep group's w columns at a time: every w
// column feeds exactly one group (its TP path has one output irrep), and a
// group's columns are the consecutive local columns [sb, sb + span) of
// DTPLinPlan.bwd_tables' dwmap.  The wrapper gathers [Wr; offset] into that
// local order once per call (Wl [hd + 1, n_loc], row hd the offset), so the
// kernels read Wl rows contiguously.  w is rounded to the storage type
// before use, as the unfolded route's w is stored, and rows past the real
// edges are zero.  The backward keeps dw in shared memory and contracts it
// there: dh = dw Wr^T into a [tile, hd] fp32 tile, and [h, 1]^T dw into the
// block's own fp32 partial rows of d[Wr; offset], which a fixed-order
// second pass sums (eqt::sum_partial_rows).  No atomics: each dh element
// has one warp, each partial element one thread.
//
// What bounds it: the h @ Wr product adds 2 * 65 * d_w operations per edge
// (QM9: 125k against K1's 420k); the fold removes w's write and read
// (d_w * 4 bytes per edge, twice in the backward) from device memory.
#pragma once

#include "common.cuh"

namespace eqt {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s_h [kT, hd] <- rows e0 .. e0 + kT of h, zero past the n_live real edges
template <int kT, int kThreads, typename T>
__device__ __forceinline__ void load_h(float* s_h, const T* __restrict__ h, int hd,
                                       long long e0, int n_live) {
  for (int i = threadIdx.x; i < kT * hd; i += kThreads) {
    const int r = i / hd;
    s_h[i] = r < n_live ? to_f(h[e0 * hd + i]) : 0.f;
  }
}

// s_w [kT, span] <- the group's w columns sb .. sb + span: thread per column,
// accumulating all kT rows in registers; Wl read once per tile, coalesced.
// hd % 4 == 0 (the wrapper checks), s_h 16-byte aligned.
template <int kT, int kThreads, typename T>
__device__ __forceinline__ void build_w(float* s_w, const float* s_h, int hd,
                                        const T* __restrict__ Wl, int n_loc, int sb, int span,
                                        int n_live) {
  for (int c = threadIdx.x; c < span; c += kThreads) {
    const T* wc = Wl + sb + c;
    const float off = to_f(wc[(long long)hd * n_loc]);
    float acc[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) acc[r] = off;
    for (int j = 0; j < hd; j += 4) {
      const float w0 = to_f(wc[(long long)j * n_loc]);
      const float w1 = to_f(wc[(long long)(j + 1) * n_loc]);
      const float w2 = to_f(wc[(long long)(j + 2) * n_loc]);
      const float w3 = to_f(wc[(long long)(j + 3) * n_loc]);
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        const float4 hq = *reinterpret_cast<const float4*>(s_h + r * hd + j);
        float v = acc[r];
        v = fmaf(hq.x, w0, v);
        v = fmaf(hq.y, w1, v);
        v = fmaf(hq.z, w2, v);
        v = fmaf(hq.w, w3, v);
        acc[r] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < kT; ++r)
      s_w[r * span + c] = r < n_live ? to_f(from_f<T>(acc[r])) : 0.f;
  }
}

// s_dh[r, j] += sum_{c < span} s_dw[r, c] * Wl[j, sb + c] for j < hd: a warp
// per j, lanes over c, a fixed butterfly of shuffles, lane 0 writes.
template <int kT, int kThreads, typename T>
__device__ __forceinline__ void add_dh(float* s_dh, const float* s_dw, int span, int hd,
                                       const T* __restrict__ Wl, int n_loc, int sb) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < hd; j += kThreads / 32) {
    const T* wj = Wl + (long long)j * n_loc + sb;
    float acc[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) acc[r] = 0.f;
    for (int c = lane; c < span; c += 32) {
      const float wv = to_f(wj[c]);
#pragma unroll
      for (int r = 0; r < kT; ++r) acc[r] = fmaf(s_dw[r * span + c], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const float v = warp_sum(acc[r]);
      if (lane == 0) s_dh[r * hd + j] += v;
    }
  }
}

// part[j, sb + c] += sum_r [h, 1][r, j] * s_dw[r, c] for j <= hd: the block's
// own fp32 partial rows of d[Wr; offset] (row stride n_loc); a thread per
// column.  Rows past the real edges have h = 0 and dw = 0, so the ones
// column adds nothing for them.
template <int kT, int kThreads>
__device__ __forceinline__ void add_dWr(float* __restrict__ part, int n_loc, const float* s_h,
                                        int hd, const float* s_dw, int span, int sb) {
  for (int c = threadIdx.x; c < span; c += kThreads) {
    float d[kT];
    float dsum = 0.f;
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      d[r] = s_dw[r * span + c];
      dsum += d[r];
    }
    float* pc = part + sb + c;
    for (int j = 0; j < hd; j += 4) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        const float4 hq = *reinterpret_cast<const float4*>(s_h + r * hd + j);
        a0 = fmaf(hq.x, d[r], a0);
        a1 = fmaf(hq.y, d[r], a1);
        a2 = fmaf(hq.z, d[r], a2);
        a3 = fmaf(hq.w, d[r], a3);
      }
      pc[(long long)j * n_loc] += a0;
      pc[(long long)(j + 1) * n_loc] += a1;
      pc[(long long)(j + 2) * n_loc] += a2;
      pc[(long long)(j + 3) * n_loc] += a3;
    }
    pc[(long long)hd * n_loc] += dsum;
  }
}

}  // namespace eqt
