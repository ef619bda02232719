// Fused depthwise tensor product + per-irrep linear heads, forward (K1).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_pallas.py, _fwd_kernel (built by
// make_fused_dtp_lin / fwd_call).  Plan, term table and weight packing:
// equiformer_tpu_torch/kernels/dtp_lin.py.
//
// What it computes, per edge e and irrep group g, component k:
//   z[g,k][fc+u] = sum over the (g,k) terms of c * sh[e,col] * x[e,a+u] * w[e,b+u]
//   out[e, out_col(g,k) + c] = sum_f z[g,k][f] * W_g[f, c]
// with w absent (taken as 1) when shared weights were folded into W_g.
// Rows e >= *n_edges are written as zeros.
//
// What bounds it on the card: the z @ W_g products.  At the flagship shapes
// (fans 224/384/352, 352/64/32 columns for the two-head call site) that is
// ~209k multiply-adds per edge against ~8.6 KB of operands read and written
// per edge, so the kernel is arithmetic-bound, not memory-bound.
//
// Design: one block of 256 threads per tile of 32 edges.  For each (g, k) the
// block builds z[g,k] (32 x fan, fp32, <= 48 KB) in shared memory from the
// term table and multiplies it by W_g right there, so the 3136-wide z of the
// flagship never goes to device memory (the point of the TPU kernel too).
// In the product each warp owns 4 edges and each lane 2 columns per pass;
// a lane reads z as float4 broadcasts (all lanes of a warp read the same
// address) and W_g rows coalesced from L1/L2.  Everything accumulates in
// fp32 on the CUDA cores; moving the product onto the tensor cores (mma /
// wgmma on bf16 tiles) is the next step for speed.
//
// The terms of one (g, k) are sorted by fan column, and a term maps flat
// index i to (row, u) by i / mul, so every z element is only ever touched by
// one thread across all terms: the FMA phase needs no atomics and no
// barriers between terms.
//
// The radial-folded variant (K7-F, kRad; replaces the radial branch of
// _fwd_kernel, dtp_lin_pallas.py:604-611 with _radial_w_fill :482) reads
// the radial hidden activation h [E, hd] in place of w and builds each irrep
// group's w columns in shared memory before the group's first component
// (csrc/radial.cuh), so w [E, d_w] never goes to device memory.  It walks
// DTPLinPlan.bwd_tables (12 ints per (g, k), 6 per term: the group's w span
// and each term's local w column).  Shared memory per block: z [32, fs_max],
// w [32, span_max] and h [32, hd] in fp32, 106 KB at the QM9 sites (2 blocks
// per SM), 180 KB at MD17 L3 (1 block per SM); a full [32, d_w] w tile would
// not fit at L3.

#include <stdint.h>

#include "common.cuh"
#include "radial.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kTile = 32;                      // edges per block
constexpr int kThreads = 256;                  // 8 warps
constexpr int kRows = kTile / (kThreads / 32); // edges per warp in the product
constexpr int kColsPerLane = 2;
constexpr int kColChunk = 32 * kColsPerLane;   // columns per pass of a warp
// ints per (g, k) table entry and per term: DTPLinPlan.device_tables
// (a_off, sh col, b_off, fan col, mul), or with the fold bwd_tables (the
// same first fields; the group's w span at 8-10, a term's local w column at 5)
constexpr int kGkFields = 8;
constexpr int kTermFields = 5;
constexpr int kRadGkFields = 12;
constexpr int kRadTermFields = 6;

template <typename T, bool kRad>
__global__ void __launch_bounds__(kThreads)
dtp_lin_fwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                   const T* __restrict__ w, int d_w, const T* __restrict__ W,
                   T* __restrict__ out, int d_out, const int* __restrict__ n_edges_ptr,
                   int E, const int* __restrict__ gk, int n_gk,
                   const int* __restrict__ terms, const float* __restrict__ coeffs, int fs_max,
                   const T* __restrict__ h, int hd, const T* __restrict__ Wl, int n_loc,
                   int span_max) {
  constexpr int kGk = kRad ? kRadGkFields : kGkFields;
  constexpr int kTf = kRad ? kRadTermFields : kTermFields;
  extern __shared__ float4 smem4[];
  float* z = reinterpret_cast<float*>(smem4);
  float* s_w = z + kTile * fs_max;        // kRad: [kTile, span] of the current group
  float* s_h = s_w + kTile * span_max;    // kRad: [kTile, hd]
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);  // rows of this tile inside [0, E)
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));  // real edges

  if (n_live == 0) {
    for (int i = tid; i < n_rows * d_out; i += kThreads) {
      const int r = i / d_out;
      out[(long long)(e0 + r) * d_out + (i - r * d_out)] = from_f<T>(0.f);
    }
    return;
  }
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;
  if constexpr (kRad) {
    eqt::load_h<kTile, kThreads>(s_h, h, hd, e0, n_live);
    __syncthreads();
  }

  for (int q = 0; q < n_gk; ++q) {
    const int* g = gk + q * kGk;
    const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
    const int t_begin = g[4], t_end = g[5];
    int span = 0;
    if constexpr (kRad) {
      span = g[9];
      if (g[10])  // the group's first component: build its w columns
        eqt::build_w<kTile, kThreads>(s_w, s_h, hd, Wl, n_loc, g[8], span, n_live);
    }

    for (int i = tid; i < kTile * fs; i += kThreads) z[i] = 0.f;
    __syncthreads();

    // ---- z[g,k] from the term table (rows >= n_live stay zero)
    for (int t = t_begin; t < t_end; ++t) {
      const int* tt = terms + t * kTf;
      const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4];
      const float c = coeffs[t];
      for (int i = tid; i < n_live * mul; i += kThreads) {
        const int r = i / mul;
        const int u = i - r * mul;
        const long long e = e0 + r;
        float v = c * to_f(sh[e * d_sh + col]) * to_f(x[e * sx + a + u]);
        if constexpr (kRad) {
          v *= s_w[r * span + tt[5] + u];
        } else {
          if (w != nullptr) v *= to_f(w[e * d_w + b + u]);
        }
        z[r * fs + fc + u] += v;
      }
    }
    __syncthreads();

    // ---- out tile = z[g,k] @ W_g
    const T* Wg = W + w_off;
    for (int c0 = 0; c0 < cols; c0 += kColChunk) {
      float acc[kRows][kColsPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = 0.f;

      for (int f = 0; f < fs; f += 4) {
        float4 zq[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          zq[r] = *reinterpret_cast<const float4*>(z + (r0 + r) * fs + f);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < cols) {
            const T* wp = Wg + (long long)f * cols + c;
            const float w0 = to_f(wp[0]);
            const float w1 = to_f(wp[cols]);
            const float w2 = to_f(wp[2 * cols]);
            const float w3 = to_f(wp[3 * cols]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float s = acc[r][j];
              s = fmaf(zq[r].x, w0, s);
              s = fmaf(zq[r].y, w1, s);
              s = fmaf(zq[r].z, w2, s);
              s = fmaf(zq[r].w, w3, s);
              acc[r][j] = s;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = r0 + r;
        if (row >= n_rows) continue;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < cols)
            out[(long long)(e0 + row) * d_out + out_col + c] = from_f<T>(acc[r][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kRad>
int launch(const void* x, long long sx, const void* sh, const void* w, const void* W,
           void* out, const void* n_edges, int E, int d_sh, int d_w, int d_out,
           const void* gk, int n_gk, const void* terms, const void* coeffs, int max_fs,
           const void* h, int hd, const void* Wl, int n_loc, int span_max,
           cudaStream_t stream) {
  const int smem = kTile * (max_fs + (kRad ? span_max + hd : 0)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_fwd_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (E + kTile - 1) / kTile;
  dtp_lin_fwd_kernel<T, kRad><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(W), static_cast<T*>(out), d_out,
      static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs), max_fs,
      static_cast<const T*>(h), hd, static_cast<const T*>(Wl), n_loc, kRad ? span_max : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dtp_lin_fwd(const void* x, long long sx, const void* sh, const void* w,
                           const void* W, void* out, const void* n_edges, int E, int d_sh,
                           int d_w, int d_out, const void* gk, int n_gk, const void* terms,
                           const void* coeffs, int max_fs, int dtype, void* stream) {
  if (max_fs % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, false>(x, sx, sh, w, W, out, n_edges, E, d_sh, d_w, d_out, gk, n_gk,
                                terms, coeffs, max_fs, nullptr, 0, nullptr, 0, 0, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, false>(x, sx, sh, w, W, out, n_edges, E, d_sh, d_w, d_out,
                                        gk, n_gk, terms, coeffs, max_fs, nullptr, 0, nullptr,
                                        0, 0, s);
  return (int)cudaErrorInvalidValue;
}

// K7-F: the forward with w = [h, 1] @ Wl built in the kernel.  gk / terms are
// DTPLinPlan.bwd_tables'; Wl [hd + 1, n_loc] is [Wr; offset] with its columns
// in the tables' local (dwmap) order.
extern "C" int dtp_lin_rad_fwd(const void* x, long long sx, const void* sh, const void* W,
                               void* out, const void* n_edges, int E, int d_sh, int d_out,
                               const void* gk, int n_gk, const void* terms, const void* coeffs,
                               int max_fs, const void* h, int hd, const void* Wl, int n_loc,
                               int span_max, int dtype, void* stream) {
  if (max_fs % 4 != 0 || hd % 4 != 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, true>(x, sx, sh, nullptr, W, out, n_edges, E, d_sh, 0, d_out, gk,
                               n_gk, terms, coeffs, max_fs, h, hd, Wl, n_loc, span_max, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, sx, sh, nullptr, W, out, n_edges, E, d_sh, 0, d_out,
                                       gk, n_gk, terms, coeffs, max_fs, h, hd, Wl, n_loc,
                                       span_max, s);
  return (int)cudaErrorInvalidValue;
}
