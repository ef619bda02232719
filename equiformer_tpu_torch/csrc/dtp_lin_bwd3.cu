// Fused depthwise tensor product + per-irrep linear heads: the force
// backward (K5a), dx, dsh and dw in one pass.
//
// Replaces: equiformer_tpu/kernels/dtp_lin_ho.py, _bwd3_kernel (built by
// _bwd3_pallas, bound through _bwd3_p by the transpose of the grouped edge
// tangents of the higher-order DTP).  Plan and tables:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.bwd_tables) with the
// term rows of each (group, component) sorted by SH column
// (kernels/dtp_lin_ho.py, bwd3_tables).
//
// What it computes, for the forward of csrc/dtp_lin.cu and the cotangent G
// of its output, per edge e < *n_edges:
//   dz[g,k][f]   = sum_j G[e, out_col(g,k) + j] * W_g[f, j]
//   and per term (c, a, col, b, fc, mul), u < mul:
//   dx[e, a+u]  += c * sh[e,col] * w[e,b+u] * dz[g,k][fc+u]
//   dw[e, b+u]  += c * sh[e,col] * x[e,a+u] * dz[g,k][fc+u]
//   dsh[e, col] += c * x[e,a+u] * w[e,b+u] * dz[g,k][fc+u]
// With shared weights folded into W_g there is no w (taken as 1) and no dw.
// There is no z and no dW: the force path never asks for the gradient of
// the head weights.  Rows e >= *n_edges get zeros.  Each of dx, dsh and dw
// may be null (not needed); the launch is the same.
//
// What bounds it on the card: arithmetic.  Per real edge of the MD17 L3
// sep_act site the dz product is ~0.6M multiply-adds and the term
// transposes ~32k x 3, against ~12 KB of operands read and written.
//
// Design: one block of 256 threads per tile of 16 edges.  Per (g, k) the
// block stages the cotangent slice G[g,k] in shared memory and computes
// dz = G W_g^T there with the same loop as K2 (csrc/dtp_lin_bwd.cu; W_g^T is
// packed by the wrapper so lanes read it coalesced).  In the term pass warp
// w owns rows w and w + 8 of the tile and lane l the copies u = l (mod 32)
// of every term.  A dx or dw element is touched only by terms of one x
// block component (one a_off and mul) or one TP path (one b_off and mul),
// so it always falls to the same lane of the same warp: every accumulator
// in shared memory has one writer, and the term pass needs no barrier.
// dsh is a reduction over u and over terms: each lane keeps a running sum
// while the terms share an SH column (the table is sorted so they do), and
// at a column change the warp adds it up with a fixed butterfly of
// shuffles and lane 0 adds it to the row's dsh in shared memory.  No
// atomics anywhere, so the result is the same bits on every run.  dx
// accumulates over the whole tile, dw over one group (every w column feeds
// exactly one group) and is flushed when the group's last component is
// done, as in K2.  Everything accumulates in fp32 on the CUDA cores;
// tensor cores and TMA are later work.
//
// The radial-folded variant (K7-B3, kRad; replaces the radial branch of
// _bwd3_kernel, dtp_lin_ho.py:458-526: w rebuilt :492-493, dh :522-526)
// reads h [E, hd] in place of w, rebuilds each group's w columns in shared
// memory (csrc/radial.cuh), accumulates the group's dw there as the dw
// output does, and at the group's last component adds dw Wr^T into the
// tile's dh: it writes dx, dsh and dh [E, hd], never w or dw.  Shared
// memory: the dw tile always, plus w [16, span_max], h and dh [16, hd];
// 221 KB at the MD17 L3 sep_act site (one block per SM).

#include <stdint.h>

#include "common.cuh"
#include "radial.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;
using eqt::warp_sum;

constexpr int kTile = 16;                         // edges per block
constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                          // edges per warp in the dz product
constexpr int kRowGroups = kTile / kRows;         // 4 warps cover the tile's rows
constexpr int kColGroups = kWarps / kRowGroups;   // 2 column groups of warps
constexpr int kColsPerLane = 2;
constexpr int kColChunk = 32 * kColsPerLane;      // fan columns per pass of a warp
constexpr int kGkFields = 12;                     // ints per (g, k) table entry
constexpr int kTermFields = 6;                    // a_off, sh col, b_off, fan col, mul, local dw col

// fp32 shared memory: dx [kTile, d_x_s], dw [kTile, span_s], G [kTile, cp],
// dz [kTile, fs], sh [kTile, d_sh], dsh [kTile, d_sh]; with the fold (hd > 0)
// also w [kTile, span_s], h [kTile, hd] and dh [kTile, hd]
__host__ __device__ inline int smem_floats(int d_x_s, int span_s, int cols_pad_max, int fs_max,
                                           int d_sh, int hd) {
  return kTile * (d_x_s + span_s + cols_pad_max + fs_max + 2 * d_sh
                  + (hd > 0 ? span_s + 2 * hd : 0));
}

template <typename T, bool kRad>
__global__ void __launch_bounds__(kThreads)
dtp_lin_bwd3_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh,
                    int d_sh, const T* __restrict__ w, int d_w, const T* __restrict__ WT,
                    const T* __restrict__ G, int d_out, const int* __restrict__ n_edges_ptr,
                    int E, const int* __restrict__ gk, int n_gk, const int* __restrict__ terms,
                    const float* __restrict__ coeffs, const int* __restrict__ dwmap,
                    T* __restrict__ dx, T* __restrict__ dsh, T* __restrict__ dw, int span_max,
                    int cols_pad_max, int fs_max, const T* __restrict__ h, int hd,
                    const T* __restrict__ Wl, int n_loc, T* __restrict__ dh) {
  extern __shared__ float4 smem4[];
  const bool acc_dw = kRad || dw != nullptr;  // the group's dw is accumulated
  const int d_x_s = dx != nullptr ? d_x : 0;
  const int span_s = acc_dw ? span_max : 0;
  float* s_dx = reinterpret_cast<float*>(smem4);
  float* s_dw = s_dx + kTile * d_x_s;
  float* s_gt = s_dw + kTile * span_s;   // offset a multiple of 16 floats: float4 rows
  float* s_dz = s_gt + kTile * cols_pad_max;
  float* s_sh = s_dz + kTile * fs_max;
  float* s_dsh = s_sh + kTile * d_sh;
  float* s_w = s_dsh + kTile * d_sh;     // kRad: [kTile, span] of the current group
  float* s_h = s_w + kTile * span_s;     // kRad: [kTile, hd]
  float* s_dh = s_h + kTile * hd;        // kRad: [kTile, hd]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % kRowGroups) * kRows;
  const int fw = (warp / kRowGroups) * kColChunk;
  const int n_edges = __ldg(n_edges_ptr);
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  const int n_live = max(0, min(n_rows, n_edges - e0));

  if (n_live == 0) {  // past the real edges: zero gradients
    if (dx != nullptr)
      for (int i = tid; i < n_rows * d_x; i += kThreads) dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
    if (dsh != nullptr)
      for (int i = tid; i < n_rows * d_sh; i += kThreads)
        dsh[(long long)e0 * d_sh + i] = from_f<T>(0.f);
    if (dw != nullptr)
      for (int i = tid; i < n_rows * d_w; i += kThreads) dw[(long long)e0 * d_w + i] = from_f<T>(0.f);
    if constexpr (kRad)
      for (int i = tid; i < n_rows * hd; i += kThreads) dh[(long long)e0 * hd + i] = from_f<T>(0.f);
    return;
  }

  for (int i = tid; i < kTile * d_x_s; i += kThreads) s_dx[i] = 0.f;
  for (int i = tid; i < kTile * d_sh; i += kThreads) {
    const int r = i / d_sh;
    s_sh[i] = r < n_live ? to_f(sh[(long long)e0 * d_sh + i]) : 0.f;
    s_dsh[i] = 0.f;
  }
  if constexpr (kRad) {
    eqt::load_h<kTile, kThreads>(s_h, h, hd, e0, n_live);
    for (int i = tid; i < kTile * hd; i += kThreads) s_dh[i] = 0.f;
    __syncthreads();
  }

  for (int q = 0; q < n_gk; ++q) {
    const int* g = gk + q * kGkFields;
    const int fs = g[0], cols = g[1], out_col = g[2];
    const int t_begin = g[4], t_end = g[5], wt_off = g[6], cp = g[7];
    const int span_begin = g[8], span = g[9], first = g[10], last = g[11];

    if (acc_dw && first)
      for (int i = tid; i < kTile * span; i += kThreads) s_dw[i] = 0.f;
    if constexpr (kRad)
      if (first) eqt::build_w<kTile, kThreads>(s_w, s_h, hd, Wl, n_loc, span_begin, span, n_live);
    // ---- stage G[g,k] (zero rows past the real edges, zero pad columns)
    for (int i = tid; i < kTile * cp; i += kThreads) {
      const int r = i / cp;
      const int c = i - r * cp;
      float v = 0.f;
      if (r < n_live && c < cols) v = to_f(G[(long long)(e0 + r) * d_out + out_col + c]);
      s_gt[i] = v;
    }
    __syncthreads();

    // ---- dz[r, f] = sum_j G[r, j] W_g^T[j, f]  (W_g^T: [cp, fs], zero pad rows)
    {
      const T* Wt = WT + wt_off;
      for (int f0 = fw; f0 < fs; f0 += kColGroups * kColChunk) {
        float acc[kRows][kColsPerLane];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int jj = 0; jj < kColsPerLane; ++jj) acc[r][jj] = 0.f;
        for (int j = 0; j < cp; j += 4) {
          float4 gq[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            gq[r] = *reinterpret_cast<const float4*>(s_gt + (r0 + r) * cp + j);
#pragma unroll
          for (int jj = 0; jj < kColsPerLane; ++jj) {
            const int f = f0 + lane + 32 * jj;
            if (f < fs) {
              const T* wp = Wt + (long long)j * fs + f;
              const float w0 = to_f(wp[0]);
              const float w1 = to_f(wp[fs]);
              const float w2 = to_f(wp[2 * fs]);
              const float w3 = to_f(wp[3 * fs]);
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                float v = acc[r][jj];
                v = fmaf(gq[r].x, w0, v);
                v = fmaf(gq[r].y, w1, v);
                v = fmaf(gq[r].z, w2, v);
                v = fmaf(gq[r].w, w3, v);
                acc[r][jj] = v;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int jj = 0; jj < kColsPerLane; ++jj) {
            const int f = f0 + lane + 32 * jj;
            if (f < fs) s_dz[(r0 + r) * fs + f] = acc[r][jj];
          }
      }
    }
    __syncthreads();

    // ---- term transposes off dz: warp owns rows, lane owns copies u = lane (mod 32)
    for (int r = warp; r < n_live; r += kWarps) {
      const long long e = e0 + r;
      const float* dzr = s_dz + r * fs;
      const float* shr = s_sh + r * d_sh;
      float* dxr = s_dx + r * d_x_s;
      float* dwr = s_dw + r * span;
      const float* wr = s_w + r * span;
      float run = 0.f;  // this lane's part of dsh[r, cur]
      int cur = -1;
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4], bl = tt[5];
        const float c = coeffs[t];
        if (dsh != nullptr && col != cur) {  // warp-uniform: every lane walks the same t
          if (cur >= 0) {
            const float v = warp_sum(run);
            if (lane == 0) s_dsh[r * d_sh + cur] += v;
          }
          run = 0.f;
          cur = col;
        }
        const float cs = c * shr[col];
        for (int u = lane; u < mul; u += 32) {
          const float d = dzr[fc + u];
          const float xv = to_f(x[e * sx + a + u]);
          float wv;
          if constexpr (kRad) {
            wv = wr[bl + u];
          } else {
            wv = w != nullptr ? to_f(w[e * d_w + b + u]) : 1.f;
          }
          if (dx != nullptr) dxr[a + u] += cs * wv * d;
          if (acc_dw) dwr[bl + u] += cs * xv * d;
          run = fmaf(c * xv * wv, d, run);
        }
      }
      if (dsh != nullptr && cur >= 0) {
        const float v = warp_sum(run);
        if (lane == 0) s_dsh[r * d_sh + cur] += v;
      }
    }
    __syncthreads();

    // ---- a group's last component: its dw columns are complete
    if constexpr (kRad) {
      if (last) {  // dh += dw Wr^T
        eqt::add_dh<kTile, kThreads>(s_dh, s_dw, span, hd, Wl, n_loc, span_begin);
        __syncthreads();
      }
    } else if (dw != nullptr && last) {
      for (int i = tid; i < n_rows * span; i += kThreads) {
        const int r = i / span;
        const int jl = i - r * span;
        dw[(long long)(e0 + r) * d_w + dwmap[span_begin + jl]] = from_f<T>(s_dw[i]);
      }
      __syncthreads();
    }
  }

  if (dx != nullptr)
    for (int i = tid; i < n_rows * d_x; i += kThreads)
      dx[(long long)e0 * d_x + i] = from_f<T>(s_dx[i]);
  if (dsh != nullptr)
    for (int i = tid; i < n_rows * d_sh; i += kThreads)
      dsh[(long long)e0 * d_sh + i] = from_f<T>(s_dsh[i]);
  if constexpr (kRad)
    for (int i = tid; i < n_rows * hd; i += kThreads)
      dh[(long long)e0 * hd + i] = from_f<T>(s_dh[i]);
}

template <typename T, bool kRad>
int launch(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
           int d_w, const void* WT, const void* G, int d_out, const void* n_edges, int E,
           const void* gk, int n_gk, const void* terms, const void* coeffs, const void* dwmap,
           void* dx, void* dsh, void* dw, int span_max, int cols_pad_max, int fs_max,
           const void* h, int hd, const void* Wl, int n_loc, void* dh, cudaStream_t stream) {
  const int smem = smem_floats(dx != nullptr ? d_x : 0,
                               (kRad || dw != nullptr) ? span_max : 0, cols_pad_max, fs_max,
                               d_sh, kRad ? hd : 0) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_bwd3_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (E + kTile - 1) / kTile;
  dtp_lin_bwd3_kernel<T, kRad><<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, d_x, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(WT), static_cast<const T*>(G),
      d_out, static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs),
      static_cast<const int*>(dwmap), static_cast<T*>(dx), static_cast<T*>(dsh),
      static_cast<T*>(dw), span_max, cols_pad_max, fs_max, static_cast<const T*>(h), hd,
      static_cast<const T*>(Wl), n_loc, static_cast<T*>(dh));
  return (int)cudaGetLastError();
}

template <typename T, bool kRad>
int occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_bwd3_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dtp_lin_bwd3_kernel<T, kRad>,
                                                      kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// One block per 16-edge tile.  dx, dsh and dw may each be null.
extern "C" int dtp_lin_bwd3(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                            const void* w, int d_w, const void* WT, const void* G, int d_out,
                            const void* n_edges, int E, const void* gk, int n_gk,
                            const void* terms, const void* coeffs, const void* dwmap, void* dx,
                            void* dsh, void* dw, int span_max, int cols_pad_max, int fs_max,
                            int dtype, void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || (dw != nullptr && w == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, false>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk,
                                n_gk, terms, coeffs, dwmap, dx, dsh, dw, span_max, cols_pad_max,
                                fs_max, nullptr, 0, nullptr, 0, nullptr, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, false>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges,
                                        E, gk, n_gk, terms, coeffs, dwmap, dx, dsh, dw,
                                        span_max, cols_pad_max, fs_max, nullptr, 0, nullptr, 0,
                                        nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// K7-B3: the force backward of dtp_lin_rad_fwd, dx, dsh and dh [E, hd] in
// one pass; h and Wl [hd + 1, n_loc] (columns in the tables' local order) in
// place of w.  dx and dsh may each be null.
extern "C" int dtp_lin_rad_bwd3(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* WT, const void* G, int d_out, const void* n_edges,
                                int E, const void* gk, int n_gk, const void* terms,
                                const void* coeffs, void* dx, void* dsh, int span_max,
                                int cols_pad_max, int fs_max, const void* h, int hd,
                                const void* Wl, int n_loc, void* dh, int dtype, void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || hd % 4 != 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, true>(x, sx, d_x, sh, d_sh, nullptr, 0, WT, G, d_out, n_edges, E, gk,
                               n_gk, terms, coeffs, nullptr, dx, dsh, nullptr, span_max,
                               cols_pad_max, fs_max, h, hd, Wl, n_loc, dh, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, sx, d_x, sh, d_sh, nullptr, 0, WT, G, d_out, n_edges,
                                       E, gk, n_gk, terms, coeffs, nullptr, dx, dsh, nullptr,
                                       span_max, cols_pad_max, fs_max, h, hd, Wl, n_loc, dh, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM at the shared memory of a launch with these widths
// (d_x_s = 0 without dx, span_s = 0 without dw; hd > 0: the folded K7-B3,
// which always keeps the dw tile), or minus a cudaError_t.
extern "C" int dtp_lin_bwd3_occupancy(int d_x_s, int d_sh, int span_s, int cols_pad_max,
                                      int fs_max, int hd, int dtype) {
  const int smem =
      smem_floats(d_x_s, span_s, cols_pad_max, fs_max, d_sh, hd) * (int)sizeof(float);
  if (dtype == eqt::kFloat32)
    return hd > 0 ? occupancy<float, true>(smem) : occupancy<float, false>(smem);
  if (dtype == eqt::kBFloat16)
    return hd > 0 ? occupancy<__nv_bfloat16, true>(smem) : occupancy<__nv_bfloat16, false>(smem);
  return -(int)cudaErrorInvalidValue;
}
