// Fused depthwise tensor product + per-irrep linear heads in the kron basis:
// forward (K8-F) and first-order backward (K8-B).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_kron.py, _fwd_kernel (:191) and
// _bwd_kernel (:231), built by make_fused_dtp_lin_kron (fwd_call :385,
// bwd_call :431).  Layout, tables and G: equiformer_tpu_torch/kernels/
// dtp_lin_kron.py (KronMeta).
//
// What it computes, per edge e and flat Kop column r of irrep group g,
// component k (r walks the CG triples of (g, k), mul columns each):
//   Kop[e, r] = sh[e, col_r] * x[e, xi_r] * w[e, wi_r]   (w = 1 when a shared w is in G)
//   out[e, out_col(g,k) + c] = sum over the rows r of (g, k) of Kop[e, r] * G[r, c]
// and backward, for the cotangent g:
//   dkop[e, r] = sum_c g[e, out_col + c] * G[r, c]
//   dx[e, xi_r] += sh[e, col_r] * dkop[e, r] * w[e, wi_r]
//   dw[e, wi_r] += sh[e, col_r] * dkop[e, r] * x[e, xi_r]
//   dG[r, c] = sum over edges of Kop[e, r] * g[e, out_col + c]   (fp32)
// Rows e >= *n_edges are written as zeros and add nothing to dG.
//
// What bounds it on the card: the products with G.  At the QM9 flagship's
// sep_act site G has 453,632 elements: 0.9 MFLOP per edge forward and twice
// that backward against ~6 KB of operands per edge, so both are
// arithmetic-bound on the fp32 CUDA cores (0.49 ms forward at E = 36352); on
// the tensor cores in bf16 they would be memory-bound.  These kernels run the
// products on the CUDA cores in fp32; moving them onto the tensor cores (mma /
// wgmma, TMA for G) is later work, and the reason the kron layout exists.
//
// Design.
// K8-F: one block of 256 threads per tile of 64 edges, a tiled product per
//   (g, k) and pass of 128, 64 or 32 output columns (wide groups take 128,
//   the narrow ones the rest, so few threads idle).  Per step of 16 Kop
//   columns the block stages Kop^T [16, 64] (built from x, w and sh) and
//   G [16, pass] (read from L2: G is 1.8 MB in fp32 at the flagship, too
//   large for shared memory, and every tile reads all of it) in shared
//   memory, and each thread adds an 8 x 4, 4 x 4 or 4 x 2 block of edges x
//   columns; the next step's loads start before the products.  Kop is
//   formed as sh * x * w per element: JAX caches each x * w pair over the
//   triples (_pair_val) because the TPU's vector unit bounds its kernel;
//   here building Kop is under 2% of the operations.
// K8-B, launch 1 (dx, dw): one block of 256 threads per tile of 32 edges (16
//   where 32 would not fit in shared memory).  dx [tile, d_x] and the current
//   group's dw [tile, span] sum in shared memory; every w column feeds one
//   group, so dw is written out after the group's last component.  Per (g, k)
//   the cotangent's columns go to shared memory; per chunk of whole triples,
//   dkop = g G^T: the block stages 16 rows x 128 columns of G^T (a transposed
//   copy of G, read coalesced, once per block where every warp would read it
//   from L2) in shared memory at a time, each warp then computing 4 edges x
//   128 dkop columns; then each triple adds its rows to dx and dw.  A triple maps
//   flat index i to (edge m, u) by i / mul, and an x (or w) column belongs to
//   one x slot (w slot) of one mul, so each dx and dw element is only ever
//   touched by one thread: no atomics.  JAX sums dxw per (x slot, w slot) pair
//   first; adding each triple's share to dx and dw directly is the same sum
//   and needs no pair buffer.
// K8-B, launch 2 (dG): JAX carries dG in one resident block across its
//   sequential grid; here blocks own disjoint dG tiles (64 rows of one (g, k)
//   by 32 columns) and walk a range of the edges in order, 32 edges at a
//   time, Kop and g chunks in shared memory (a thread builds one Kop column:
//   its table row is read once), 4 x 2 sums per thread.  With
//   several ranges (enough tiles x ranges to fill the card, at most 16) each
//   writes its own fp32 partial copy of dG and eqt::sum_partial_rows adds them
//   in range order.  No float atomics anywhere, so the result is the same bits
//   on every run.

#include <stdint.h>

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 256;                  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFwdTile = 64;                   // edges per K8-F block
constexpr int kFwdN = 128;                     // output columns per K8-F pass, at most
constexpr int kFwdK = 16;                      // Kop columns (G rows) per K8-F step
constexpr int kFwdAPitch = kFwdTile + 4;       // row pitch of the staged Kop^T
constexpr int kRowsPerLane = 4;                // K8-B launch 1: G^T columns per lane per pass
// int fields per table entry: KronMeta.device_tables
constexpr int kGkFields = 12;
constexpr int kRowFields = 4;
constexpr int kChunkFields = 4;
constexpr int kTripFields = 8;
constexpr int kTileFields = 8;
// K8-B launch 2: dG tile rows x columns, edges per step, Kop chunk row pitch
constexpr int kDgRows = 64;
constexpr int kDgCols = 32;
constexpr int kDgEdges = 32;
constexpr int kDgPitch = kDgRows + 4;
// K8-B launch 1: rows of G^T staged in shared memory per step of the dkop product
constexpr int kGtRows = 16;
constexpr int kGtCols = 32 * kRowsPerLane;
static_assert(kThreads % kFwdK == 0 && kThreads % kFwdN == 0 && kThreads % kDgRows == 0,
              "thread maps");

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

// K8-B launch 1: dx and dw of a tile of kT edges
template <typename T, bool kW, int kT>
__global__ void __launch_bounds__(kThreads)
kron_bwd_dx_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh,
                   int d_sh, const T* __restrict__ w, int d_w, const T* __restrict__ GT,
                   const T* __restrict__ g, int d_out, const int* __restrict__ n_edges_ptr, int E,
                   const int* __restrict__ gk, int n_gk, const int* __restrict__ chunks,
                   const int* __restrict__ trips, const int* __restrict__ dwmap,
                   T* __restrict__ dx, T* __restrict__ dw, int span_max, int cp_max,
                   int ch_max) {
  constexpr int kRows = kT / kWarps;  // edges per warp in the dkop product
  extern __shared__ float4 smem4[];
  float* s_g = reinterpret_cast<float*>(smem4);  // [kT, cp_max] the cotangent's (g, k) columns
  float* s_dk = s_g + kT * cp_max;                // [kT, ch_max] dkop of one chunk
  float* s_dx = s_dk + kT * ch_max;               // [kT, d_x]
  float* s_dw = s_dx + kT * d_x;                  // [kT, span_max] the current group's dw
  float* s_gt = s_dw + (kW ? kT * span_max : 0);  // [kGtRows, kGtCols] a stage of G^T
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kT;
  const int n_rows = min(kT, E - e0);
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));

  if (n_live == 0) {
    for (int i = tid; i < n_rows * d_x; i += kThreads) dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
    if constexpr (kW)
      for (int i = tid; i < n_rows * d_w; i += kThreads) dw[(long long)e0 * d_w + i] = from_f<T>(0.f);
    return;
  }
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;
  for (int i = tid; i < kT * d_x; i += kThreads) s_dx[i] = 0.f;

  for (int q = 0; q < n_gk; ++q) {
    const int* b = gk + q * kGkFields;
    const int row0 = b[0], n_k = b[1] - b[0], cols = b[2], out_col = b[3];
    const int span_b = b[7], span_n = b[8];
    const int cp = (cols + 3) & ~3;
    if (kW && b[9])  // the group's first component
      for (int i = tid; i < kT * span_max; i += kThreads) s_dw[i] = 0.f;
#pragma unroll 4
    for (int i = tid; i < kT * cp; i += kThreads) {
      const int m = i / cp;
      const int c = i - m * cp;
      s_g[m * cp_max + c] =
          (m < n_live && c < cols) ? to_f(g[(long long)(e0 + m) * d_out + out_col + c]) : 0.f;
    }
    __syncthreads();

    const T* GTb = GT + b[4];  // this (g, k)'s G^T [cols, n_k]
    for (int ch = b[5]; ch < b[6]; ++ch) {
      const int* cc = chunks + ch * kChunkFields;
      const int kbase = cc[2] - row0, cn = cc[3];
      // ---- dkop chunk [kT, cn] = g[:, (g, k)] @ G^T[:, kbase : kbase + cn]
      for (int kb = 0; kb < cn; kb += kGtCols) {
        const int kw = min(kGtCols, cn - kb);
        float acc[kRows][kRowsPerLane];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) acc[r][j] = 0.f;
        for (int c0 = 0; c0 < cp; c0 += kGtRows) {
          // G^T rows c0 ... c0 + kGtRows, columns kb ... kb + kw of the chunk,
          // loaded once for the block (zero past cols and kw)
#pragma unroll
          for (int i = tid; i < kGtRows * kGtCols; i += kThreads) {
            const int c = c0 + i / kGtCols;
            const int kr = i % kGtCols;
            s_gt[i] = c < cols && kr < kw ? to_f(GTb[(long long)c * n_k + kbase + kb + kr]) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int cc = 0; cc < kGtRows; cc += 4) {
            if (c0 + cc >= cp) break;  // s_g holds cp columns
            float4 gq[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              gq[r] = *reinterpret_cast<const float4*>(s_g + (r0 + r) * cp_max + c0 + cc);
#pragma unroll
            for (int j = 0; j < kRowsPerLane; ++j) {
              const float* tp = s_gt + cc * kGtCols + lane + 32 * j;
              const float t0 = tp[0], t1 = tp[kGtCols], t2 = tp[2 * kGtCols],
                          t3 = tp[3 * kGtCols];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                float s = acc[r][j];
                s = fmaf(gq[r].x, t0, s);
                s = fmaf(gq[r].y, t1, s);
                s = fmaf(gq[r].z, t2, s);
                s = fmaf(gq[r].w, t3, s);
                acc[r][j] = s;
              }
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kRowsPerLane; ++j) {
            const int kr = kb + lane + 32 * j;
            if (kr < cn) s_dk[(r0 + r) * ch_max + kr] = acc[r][j];
          }
      }
      __syncthreads();

      // ---- each triple of the chunk adds its rows to dx and dw
      for (int t = cc[0]; t < cc[1]; ++t) {
        const int* tt = trips + t * kTripFields;
        const int a = tt[0], col = tt[1], bw = tt[2], bl = tt[3], mul = tt[4], off = tt[5];
#pragma unroll 4
        for (int i = tid; i < n_live * mul; i += kThreads) {
          const int m = i / mul;
          const int u = i - m * mul;
          const long long e = e0 + m;
          const float d = s_dk[m * ch_max + off + u] * to_f(sh[e * d_sh + col]);
          if constexpr (kW) {
            s_dx[m * d_x + a + u] += d * to_f(w[e * d_w + bw + u]);
            s_dw[m * span_max + bl + u] += d * to_f(x[e * sx + a + u]);
          } else {
            s_dx[m * d_x + a + u] += d;
          }
        }
      }
      __syncthreads();
    }

    if (kW && b[10]) {  // the group's last component: its dw columns are final
      for (int i = tid; i < n_rows * span_n; i += kThreads) {
        const int m = i / span_n;
        const int j = i - m * span_n;
        dw[(long long)(e0 + m) * d_w + dwmap[span_b + j]] = from_f<T>(s_dw[m * span_max + j]);
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n_rows * d_x; i += kThreads) dx[(long long)e0 * d_x + i] = from_f<T>(s_dx[i]);
}

// K8-B launch 2: one dG tile over the edge range blockIdx.y * per ...
template <typename T, bool kW>
__global__ void __launch_bounds__(kThreads)
kron_dG_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
               const T* __restrict__ w, int d_w, const T* __restrict__ g, int d_out,
               const int* __restrict__ n_edges_ptr, int E, const int* __restrict__ rows,
               const int* __restrict__ tiles, int per, float* __restrict__ part, int numel) {
  __shared__ float4 s_k4[kDgEdges * kDgPitch / 4];  // Kop [edges, rows]
  __shared__ float2 s_g2[kDgEdges * kDgCols / 2];   // g [edges, cols]
  float* s_k = reinterpret_cast<float*>(s_k4);
  float* s_g = reinterpret_cast<float*>(s_g2);
  const int* tl = tiles + blockIdx.x * kTileFields;
  const int row0 = tl[0], nr = tl[1], col0 = tl[2], nc = tl[3], cols = tl[4];
  const int g_elem = tl[5], out_col = tl[6];
  const int tid = threadIdx.x;
  const int tr = tid & 15;  // rows tr * 4 ... + 4
  const int tc = tid >> 4;  // columns tc * 2 ... + 2
  const int n_live = min(E, __ldg(n_edges_ptr));
  const int e_begin = blockIdx.y * per;
  const int e_end = min(n_live, e_begin + per);

  // a thread builds one Kop column of every edge chunk: its table row, once
  const int kcol = tid % kDgRows;
  const bool live_col = kcol < nr;
  const int4 rr = live_col ? row_at(rows, row0 + kcol) : make_int4(0, 0, 0, 0);
  float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  for (int eb = e_begin; eb < e_end; eb += kDgEdges) {
#pragma unroll
    for (int m = tid / kDgRows; m < kDgEdges; m += kThreads / kDgRows) {
      const int e = eb + m;
      s_k[m * kDgPitch + kcol] =
          live_col && e < e_end ? kop_at<T, kW>(x, sx, sh, d_sh, w, d_w, rr, e) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < kDgEdges * kDgCols; i += kThreads) {
      const int m = i / kDgCols;
      const int c = i - m * kDgCols;
      const int e = eb + m;
      s_g[i] = (e < e_end && c < nc) ? to_f(g[(long long)e * d_out + out_col + col0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < kDgEdges; ++m) {
      const float4 kq = *reinterpret_cast<const float4*>(s_k + m * kDgPitch + tr * 4);
      const float2 gq = *reinterpret_cast<const float2*>(s_g + m * kDgCols + tc * 2);
      acc[0][0] = fmaf(kq.x, gq.x, acc[0][0]);
      acc[0][1] = fmaf(kq.x, gq.y, acc[0][1]);
      acc[1][0] = fmaf(kq.y, gq.x, acc[1][0]);
      acc[1][1] = fmaf(kq.y, gq.y, acc[1][1]);
      acc[2][0] = fmaf(kq.z, gq.x, acc[2][0]);
      acc[2][1] = fmaf(kq.z, gq.y, acc[2][1]);
      acc[3][0] = fmaf(kq.w, gq.x, acc[3][0]);
      acc[3][1] = fmaf(kq.w, gq.y, acc[3][1]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.y * numel;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int rr = tr * 4 + r, cc = tc * 2 + c;
      if (rr < nr && cc < nc) out[g_elem + (long long)rr * cols + col0 + cc] = acc[r][c];
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

template <typename T, bool kW, int kT>
int launch_dx(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
              int d_w, const void* GT, const void* g, int d_out, const void* n_edges, int E,
              const void* gk, int n_gk, const void* chunks, const void* trips, const void* dwmap,
              void* dx, void* dw, int span_max, int cp_max, int ch_max, int smem,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kron_bwd_dx_kernel<T, kW, kT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kron_bwd_dx_kernel<T, kW, kT><<<(E + kT - 1) / kT, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, d_x, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(GT), static_cast<const T*>(g), d_out,
      static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(chunks), static_cast<const int*>(trips),
      static_cast<const int*>(dwmap), static_cast<T*>(dx), static_cast<T*>(dw), span_max, cp_max,
      ch_max);
  return (int)cudaGetLastError();
}

template <typename T, bool kW>
int launch_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
               int d_w, const void* GT, const void* g, int d_out, const void* n_edges, int E,
               const void* gk, int n_gk, const void* rows, const void* chunks, const void* trips,
               const void* dwmap, void* dx, void* dw, int span_max, int cp_max, int ch_max,
               const void* tiles, int n_tiles, int n_split, void* part, void* dG, int numel,
               cudaStream_t stream) {
  // launch 1 on tiles of 32 edges, or of 16 where 32 would not fit
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int per_row = (cp_max + ch_max + d_x + (kW ? span_max : 0)) * (int)sizeof(float);
  const int stage = kGtRows * kGtCols * (int)sizeof(float);
  int err;
  if (32 * per_row + stage <= smem_max)
    err = launch_dx<T, kW, 32>(x, sx, d_x, sh, d_sh, w, d_w, GT, g, d_out, n_edges, E, gk, n_gk,
                               chunks, trips, dwmap, dx, dw, span_max, cp_max, ch_max,
                               32 * per_row + stage, stream);
  else
    err = launch_dx<T, kW, 16>(x, sx, d_x, sh, d_sh, w, d_w, GT, g, d_out, n_edges, E, gk, n_gk,
                               chunks, trips, dwmap, dx, dw, span_max, cp_max, ch_max,
                               16 * per_row + stage, stream);
  if (err != 0) return err;

  // launch 2: dG tiles x edge ranges, then the ranges' partial copies in order
  const int per = ((E + n_split - 1) / n_split + kDgEdges - 1) / kDgEdges * kDgEdges;
  float* out = n_split > 1 ? static_cast<float*>(part) : static_cast<float*>(dG);
  kron_dG_kernel<T, kW><<<dim3(n_tiles, n_split), kThreads, 0, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w), d_w,
      static_cast<const T*>(g), d_out, static_cast<const int*>(n_edges), E,
      static_cast<const int*>(rows), static_cast<const int*>(tiles), per, out, numel);
  cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  if (n_split > 1)
    return (int)eqt::sum_partial_rows(static_cast<const float*>(part), n_split, numel,
                                      static_cast<float*>(dG), stream);
  return 0;
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

// K8-B: dx, dw (w and dw null with a shared w) and dG (fp32).  GT is each
// (g, k) block of G transposed in place; part [n_split, numel] fp32 holds the
// edge ranges' partial copies of dG when n_split > 1.
extern "C" int dtp_lin_kron_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* w, int d_w, const void* GT, const void* g, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* rows, const void* chunks, const void* trips,
                                const void* dwmap, void* dx, void* dw, int span_max, int cp_max,
                                int ch_max, const void* tiles, int n_tiles, int n_split,
                                void* part, void* dG, int numel, int dtype, void* stream) {
  if (cp_max % 4 != 0 || n_split < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define EQT_KRON_BWD(T, kW)                                                                    \
  launch_bwd<T, kW>(x, sx, d_x, sh, d_sh, w, d_w, GT, g, d_out, n_edges, E, gk, n_gk, rows,    \
                    chunks, trips, dwmap, dx, dw, span_max, cp_max, ch_max, tiles, n_tiles,    \
                    n_split, part, dG, numel, s)
  if (dtype == eqt::kFloat32) return w != nullptr ? EQT_KRON_BWD(float, true) : EQT_KRON_BWD(float, false);
  if (dtype == eqt::kBFloat16)
    return w != nullptr ? EQT_KRON_BWD(__nv_bfloat16, true) : EQT_KRON_BWD(__nv_bfloat16, false);
#undef EQT_KRON_BWD
  return (int)cudaErrorInvalidValue;
}
