// Fused depthwise tensor product + per-irrep linear heads in the kron basis:
// the forward (K8-F).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_kron.py, _fwd_kernel (:191),
// built by make_fused_dtp_lin_kron (fwd_call :385).  Layout, tables and G:
// equiformer_tpu_torch/kernels/dtp_lin_kron.py (KronMeta).  The backward
// (K8-B) runs on K2's two launches (csrc/dtp_lin_bwd.cu, k2::kron_dxdw_kernel
// and k2::kron_dG_kernel).
//
// What it computes, per edge e and flat Kop column r of irrep group g,
// component k (r walks the CG triples of (g, k), mul columns each):
//   Kop[e, r] = sh[e, col_r] * x[e, xi_r] * w[e, wi_r]   (w = 1 when a shared w is in G)
//   out[e, out_col(g,k) + c] = sum over the rows r of (g, k) of Kop[e, r] * G[r, c]
// Rows e >= *n_edges are written as zeros.
//
// What bounds it on the card: the product with G.  At the QM9 flagship's
// sep_act site G has 453,632 elements: 0.9 MFLOP per edge against ~6 KB of
// operands per edge, so it is arithmetic-bound on the fp32 CUDA cores (0.49
// ms at E = 36352); on the tensor cores in bf16 it would be memory-bound.
// This kernel runs the product on the CUDA cores in fp32; moving it onto
// the tensor cores (mma / wgmma, TMA for G), as K8-B's products are, is
// later work, and the reason the kron layout exists.
//
// Design: one block of 256 threads per tile of 64 edges, a tiled product
// per (g, k) and pass of 128, 64 or 32 output columns (wide groups take 128,
// the narrow ones the rest, so few threads idle).  Per step of 16 Kop
// columns the block stages Kop^T [16, 64] (built from x, w and sh) and G
// [16, pass] (read from L2: G is 1.8 MB in fp32 at the flagship, too large
// for shared memory, and every tile reads all of it) in shared memory, and
// each thread adds an 8 x 4, 4 x 4 or 4 x 2 block of edges x columns; the
// next step's loads start before the products.  Kop is formed as sh * x * w
// per element: JAX caches each x * w pair over the triples (_pair_val)
// because the TPU's vector unit bounds its kernel; here building Kop is
// under 2% of the operations.

#include <stdint.h>

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 256;                  // 8 warps
constexpr int kFwdTile = 64;                   // edges per K8-F block
constexpr int kFwdN = 128;                     // output columns per K8-F pass, at most
constexpr int kFwdK = 16;                      // Kop columns (G rows) per K8-F step
constexpr int kFwdAPitch = kFwdTile + 4;       // row pitch of the staged Kop^T
// int fields per table entry: KronMeta.device_tables
constexpr int kGkFields = 12;
constexpr int kRowFields = 4;
static_assert(kThreads % kFwdK == 0 && kThreads % kFwdN == 0, "thread maps");

// Kop[e, r] from the row's (x column, SH column, w column)
template <typename T, bool kW>
__device__ __forceinline__ float kop_at(const T* __restrict__ x, long long sx,
                                        const T* __restrict__ sh, int d_sh,
                                        const T* __restrict__ w, int d_w, int4 rr, long long e) {
  float v = to_f(sh[e * d_sh + rr.y]) * to_f(x[e * sx + rr.x]);
  if constexpr (kW) v *= to_f(w[e * d_w + rr.z]);
  return v;
}

__device__ __forceinline__ int4 row_at(const int* __restrict__ rows, int r) {
  return *reinterpret_cast<const int4*>(rows + r * kRowFields);
}

// One pass of K8-F: out[tile, cb : cb + BN] of component (g, k) of the
// group, BN = 128, 64 or 32 columns.  A thread owns TM edges x TN columns:
// for TM = 8 the edges ty * 4 ... + 4 and 32 + ty * 4 ... + 4, for TM = 4
// the edges ty * 4 ... + 4; the columns tx * TN ... + TN.  Per step of kFwdK
// Kop columns the block stages Kop^T [kFwdK, kFwdTile] and G [kFwdK, BN] in
// shared memory, the next step's loads already in flight in registers.
template <typename T, bool kW, int TM, int TN>
__device__ __forceinline__ void fwd_pass(const T* __restrict__ x, long long sx,
                                         const T* __restrict__ sh, int d_sh,
                                         const T* __restrict__ w, int d_w,
                                         const int* __restrict__ rows, const T* __restrict__ Gb,
                                         T* __restrict__ out, int d_out, int e0, int n_rows,
                                         int n_live, int row0, int n_k, int cols, int cb,
                                         int out_col, float* As, float* Bs) {
  constexpr int kThreadCols = kThreads / (kFwdTile / TM);  // threads along the columns
  constexpr int BN = kThreadCols * TN;
  static_assert((TM == 8 || TM == 4) && (TN == 4 || TN == 2) && BN <= kFwdN, "pass shape");
  constexpr int kALoads = kFwdK * kFwdTile / kThreads;
  constexpr int kBLoads = kFwdK * kFwdN / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % kThreadCols, ty = tid / kThreadCols;
  const int nc = min(BN, cols - cb);
  const int a_col = tid % kFwdK, a_edge = tid / kFwdK;    // this thread's Kop^T loads
  const int b_col = tid % kFwdN, b_row = tid / kFwdN;     // and G loads

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  float pa[kALoads], pb[kBLoads];
  auto load = [&](int k0) {
    const int r = k0 + a_col;
    const int4 rr = r < n_k ? row_at(rows, row0 + r) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int it = 0; it < kALoads; ++it) {
      const int m = a_edge + it * (kThreads / kFwdK);
      pa[it] = r < n_k && m < n_live ? kop_at<T, kW>(x, sx, sh, d_sh, w, d_w, rr, e0 + m) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBLoads; ++it) {
      const int kr = k0 + b_row + it * (kThreads / kFwdN);
      pb[it] = kr < n_k && b_col < nc ? to_f(Gb[(long long)kr * cols + cb + b_col]) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < n_k; k0 += kFwdK) {
#pragma unroll
    for (int it = 0; it < kALoads; ++it)
      As[a_col * kFwdAPitch + a_edge + it * (kThreads / kFwdK)] = pa[it];
#pragma unroll
    for (int it = 0; it < kBLoads; ++it)
      Bs[(b_row + it * (kThreads / kFwdN)) * kFwdN + b_col] = pb[it];
    __syncthreads();
    if (k0 + kFwdK < n_k) load(k0 + kFwdK);
#pragma unroll
    for (int kk = 0; kk < kFwdK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kFwdAPitch + ty * 4);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      if constexpr (TM == 8) {
        const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kFwdAPitch + 32 + ty * 4);
        a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
      }
      if constexpr (TN == 4) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kFwdN + tx * 4);
        b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
      } else {
        const float2 b0 = *reinterpret_cast<const float2*>(Bs + kk * kFwdN + tx * 2);
        b[0] = b0.x, b[1] = b0.y;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = (r < 4 ? 0 : 32 - 4) + ty * 4 + r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx * TN + c;
      if (col < nc) out[(long long)(e0 + row) * d_out + out_col + cb + col] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T, bool kW>
__global__ void __launch_bounds__(kThreads)
kron_fwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                const T* __restrict__ w, int d_w, const T* __restrict__ G, T* __restrict__ out,
                int d_out, const int* __restrict__ n_edges_ptr, int E,
                const int* __restrict__ gk, int n_gk, const int* __restrict__ rows) {
  __shared__ float4 a4[kFwdK * kFwdAPitch / 4];  // Kop^T step [kFwdK, kFwdTile]
  __shared__ float4 b4[kFwdK * kFwdN / 4];       // G step [kFwdK, kFwdN]
  float* As = reinterpret_cast<float*>(a4);
  float* Bs = reinterpret_cast<float*>(b4);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kFwdTile;
  const int n_rows = min(kFwdTile, E - e0);                          // rows inside [0, E)
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));  // real edges

  if (n_live == 0) {
    for (int i = tid; i < n_rows * d_out; i += kThreads) {
      const int r = i / d_out;
      out[(long long)(e0 + r) * d_out + (i - r * d_out)] = from_f<T>(0.f);
    }
    return;
  }
  for (int q = 0; q < n_gk; ++q) {
    const int* b = gk + q * kGkFields;
    const int row0 = b[0], n_k = b[1] - b[0], cols = b[2], out_col = b[3];
    const T* Gb = G + b[4];
    for (int cb = 0; cb < cols;) {  // passes of 128, 64 or 32 columns
      const int left = cols - cb;
      if (left > 64) {
        fwd_pass<T, kW, 8, 4>(x, sx, sh, d_sh, w, d_w, rows, Gb, out, d_out, e0, n_rows, n_live,
                              row0, n_k, cols, cb, out_col, As, Bs);
        cb += 128;
      } else if (left > 32) {
        fwd_pass<T, kW, 4, 4>(x, sx, sh, d_sh, w, d_w, rows, Gb, out, d_out, e0, n_rows, n_live,
                              row0, n_k, cols, cb, out_col, As, Bs);
        cb += 64;
      } else {
        fwd_pass<T, kW, 4, 2>(x, sx, sh, d_sh, w, d_w, rows, Gb, out, d_out, e0, n_rows, n_live,
                              row0, n_k, cols, cb, out_col, As, Bs);
        cb += 32;
      }
    }
  }
}

template <typename T, bool kW>
int launch_fwd(const void* x, long long sx, const void* sh, int d_sh, const void* w, int d_w,
               const void* G, void* out, int d_out, const void* n_edges, int E, const void* gk,
               int n_gk, const void* rows, cudaStream_t stream) {
  kron_fwd_kernel<T, kW><<<(E + kFwdTile - 1) / kFwdTile, kThreads, 0, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      d_w, static_cast<const T*>(G), static_cast<T*>(out), d_out,
      static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(rows));
  return (int)cudaGetLastError();
}

}  // namespace

// K8-F.  gk / rows are KronMeta.device_tables'; G the flat build_G; w null
// when a shared w is folded into G.
extern "C" int dtp_lin_kron_fwd(const void* x, long long sx, const void* sh, int d_sh,
                                const void* w, int d_w, const void* G, void* out, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* rows, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define EQT_KRON_FWD(T, kW) \
  launch_fwd<T, kW>(x, sx, sh, d_sh, w, d_w, G, out, d_out, n_edges, E, gk, n_gk, rows, s)
  if (dtype == eqt::kFloat32) return w != nullptr ? EQT_KRON_FWD(float, true) : EQT_KRON_FWD(float, false);
  if (dtype == eqt::kBFloat16)
    return w != nullptr ? EQT_KRON_FWD(__nv_bfloat16, true) : EQT_KRON_FWD(__nv_bfloat16, false);
#undef EQT_KRON_FWD
  return (int)cudaErrorInvalidValue;
}
