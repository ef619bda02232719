// Fused depthwise tensor product + per-irrep linear heads: one edge leg
// (K5b), dx or dsh or dw alone.
//
// Replaces: equiformer_tpu/kernels/dtp_lin_ho.py, _edge_leg_kernel (built by
// _leg_call for the legs x, sh and w; bound through _leg_p by the JVP of
// _bwd3_p and by the transposes of the other legs in the grad-of-grad of
// force training).  Plan and tables:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.bwd_tables) with the
// term rows of each (group, component) sorted by SH column
// (kernels/dtp_lin_ho.py, bwd3_tables), the tables of csrc/dtp_lin_bwd3.cu.
//
// What it computes.  The fused op out = Linear_W(DTP(x, sh, w)) is
// multilinear in its legs (out, x, sh, w, W); with G in the out leg, per
// edge e < *n_edges:
//   dz[g,k][f] = sum_j G[e, out_col(g,k) + j] * W_g[f, j]
//   and per term (c, a, col, b, fc, mul), u < mul, one of
//   x leg:   dx[e, a+u]  += c * sh[e,col] * w[e,b+u] * dz[g,k][fc+u]
//   sh leg:  dsh[e, col] += c * x[e,a+u] * w[e,b+u] * dz[g,k][fc+u]
//   w leg:   dw[e, b+u]  += c * sh[e,col] * x[e,a+u] * dz[g,k][fc+u]
// With shared weights folded into W_g there is no w (taken as 1) and no w
// leg.  The x leg never reads x, the sh leg never sh, the w leg never w:
// the operand of the output leg does not exist for the caller (in the
// grad-of-grad its slot holds the cotangent that became G or another
// operand).  Rows e >= *n_edges get zeros.
//
// What bounds it on the card: arithmetic.  Per real edge of the MD17 L3
// sep_act site the dz product is ~0.6M multiply-adds and one term
// transpose ~32k, against ~8 KB of operands read and written.
//
// Design: csrc/dtp_lin_bwd3.cu with two of its three accumulators removed
// and the leg fixed at compile time, so the loads a leg does not need are
// not in its code.  One block of 256 threads per tile of 16 edges; per
// (g, k) the block stages the slice G[g,k] in shared memory and computes
// dz = G W_g^T there (W_g^T packed by the wrapper so lanes read it
// coalesced); in the term pass warp w owns rows w and w + 8 of the tile and
// lane l the copies u = l (mod 32) of every term.  A dx or dw element is
// touched only by terms of one x block component (one a_off and mul) or one
// TP path (one b_off and mul), so it always falls to the same lane of the
// same warp: one writer per accumulator, no barrier inside the term pass.
// dsh is a reduction over u and over terms: each lane keeps a running sum
// while consecutive terms share an SH column (the table is sorted so they
// do), and at a column change the warp adds it up with a fixed butterfly of
// shuffles and lane 0 adds it to the row's dsh.  No atomics anywhere: the
// same bits on every run.  dx and dsh accumulate over the whole tile, dw
// over one group (every w column feeds exactly one group) and is flushed at
// the group's last component.  Everything accumulates in fp32 on the CUDA
// cores; tensor cores and TMA are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

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

enum Leg : int { kLegX = 0, kLegSh = 1, kLegW = 2 };

// width of the leg's accumulator rows in shared memory
__host__ __device__ inline int acc_width(int leg, int d_x, int d_sh, int span_max) {
  return leg == kLegX ? d_x : (leg == kLegSh ? d_sh : span_max);
}

// fp32 shared memory: acc [kTile, acc_w], G [kTile, cp], dz [kTile, fs],
// and sh [kTile, d_sh] for the legs that read it
__host__ __device__ inline int smem_floats(int leg, int d_x, int d_sh, int span_max,
                                           int cols_pad_max, int fs_max) {
  return kTile * (acc_width(leg, d_x, d_sh, span_max) + cols_pad_max + fs_max +
                  (leg == kLegSh ? 0 : d_sh));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int LEG>
__global__ void __launch_bounds__(kThreads)
dtp_lin_leg_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh,
                   int d_sh, const T* __restrict__ w, int d_w, const T* __restrict__ WT,
                   const T* __restrict__ G, int d_out, const int* __restrict__ n_edges_ptr,
                   int E, const int* __restrict__ gk, int n_gk, const int* __restrict__ terms,
                   const float* __restrict__ coeffs, const int* __restrict__ dwmap,
                   T* __restrict__ out, int span_max, int cols_pad_max, int fs_max) {
  extern __shared__ float4 smem4[];
  const int acc_w = acc_width(LEG, d_x, d_sh, span_max);
  const int d_leg = LEG == kLegX ? d_x : (LEG == kLegSh ? d_sh : d_w);  // output row width
  float* s_acc = reinterpret_cast<float*>(smem4);
  float* s_gt = s_acc + kTile * acc_w;   // offset a multiple of 16 floats: float4 rows
  float* s_dz = s_gt + kTile * cols_pad_max;
  float* s_sh = s_dz + kTile * fs_max;   // not there for the sh leg

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % kRowGroups) * kRows;
  const int fw = (warp / kRowGroups) * kColChunk;
  const int n_edges = __ldg(n_edges_ptr);
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  const int n_live = max(0, min(n_rows, n_edges - e0));

  if (n_live == 0) {  // past the real edges: zeros
    for (int i = tid; i < n_rows * d_leg; i += kThreads)
      out[(long long)e0 * d_leg + i] = from_f<T>(0.f);
    return;
  }

  if (LEG != kLegW)
    for (int i = tid; i < kTile * acc_w; i += kThreads) s_acc[i] = 0.f;
  if (LEG != kLegSh)
    for (int i = tid; i < kTile * d_sh; i += kThreads) {
      const int r = i / d_sh;
      s_sh[i] = r < n_live ? to_f(sh[(long long)e0 * d_sh + i]) : 0.f;
    }

  for (int q = 0; q < n_gk; ++q) {
    const int* g = gk + q * kGkFields;
    const int fs = g[0], cols = g[1], out_col = g[2];
    const int t_begin = g[4], t_end = g[5], wt_off = g[6], cp = g[7];
    const int span_begin = g[8], span = g[9], first = g[10], last = g[11];

    if (LEG == kLegW && first)
      for (int i = tid; i < kTile * span; i += kThreads) s_acc[i] = 0.f;
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

    // ---- the leg's term transpose off dz: warp owns rows, lane owns copies u = lane (mod 32)
    for (int r = warp; r < n_live; r += kWarps) {
      const long long e = e0 + r;
      const float* dzr = s_dz + r * fs;
      const float* shr = s_sh + r * d_sh;
      float* accr = s_acc + r * (LEG == kLegW ? span : acc_w);
      float run = 0.f;  // sh leg: this lane's part of dsh[r, cur]
      int cur = -1;
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4], bl = tt[5];
        const float c = coeffs[t];
        if (LEG == kLegSh) {
          if (col != cur) {  // warp-uniform: every lane walks the same t
            if (cur >= 0) {
              const float v = warp_sum(run);
              if (lane == 0) accr[cur] += v;
            }
            run = 0.f;
            cur = col;
          }
          for (int u = lane; u < mul; u += 32) {
            const float xv = to_f(x[e * sx + a + u]);
            const float wv = w != nullptr ? to_f(w[e * d_w + b + u]) : 1.f;
            run = fmaf(c * xv * wv, dzr[fc + u], run);
          }
        } else if (LEG == kLegX) {
          const float cs = c * shr[col];
          for (int u = lane; u < mul; u += 32) {
            const float wv = w != nullptr ? to_f(w[e * d_w + b + u]) : 1.f;
            accr[a + u] += cs * wv * dzr[fc + u];
          }
        } else {
          const float cs = c * shr[col];
          for (int u = lane; u < mul; u += 32)
            accr[bl + u] += cs * to_f(x[e * sx + a + u]) * dzr[fc + u];
        }
      }
      if (LEG == kLegSh && cur >= 0) {
        const float v = warp_sum(run);
        if (lane == 0) accr[cur] += v;
      }
    }
    __syncthreads();

    // ---- w leg, a group's last component: its dw columns are complete
    if (LEG == kLegW && last) {
      for (int i = tid; i < n_rows * span; i += kThreads) {
        const int r = i / span;
        const int jl = i - r * span;
        out[(long long)(e0 + r) * d_w + dwmap[span_begin + jl]] = from_f<T>(s_acc[i]);
      }
      __syncthreads();
    }
  }

  if (LEG != kLegW)
    for (int i = tid; i < n_rows * d_leg; i += kThreads)
      out[(long long)e0 * d_leg + i] = from_f<T>(s_acc[i]);
}

template <typename T, int LEG>
int launch(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
           int d_w, const void* WT, const void* G, int d_out, const void* n_edges, int E,
           const void* gk, int n_gk, const void* terms, const void* coeffs, const void* dwmap,
           void* out, int span_max, int cols_pad_max, int fs_max, cudaStream_t stream) {
  const int smem =
      smem_floats(LEG, d_x, d_sh, span_max, cols_pad_max, fs_max) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_leg_kernel<T, LEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (E + kTile - 1) / kTile;
  dtp_lin_leg_kernel<T, LEG><<<n_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, d_x, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(WT), static_cast<const T*>(G),
      d_out, static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs),
      static_cast<const int*>(dwmap), static_cast<T*>(out), span_max, cols_pad_max, fs_max);
  return (int)cudaGetLastError();
}

template <typename T, int LEG>
int occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_leg_kernel<T, LEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dtp_lin_leg_kernel<T, LEG>,
                                                      kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T>
int launch_leg(int leg, const void* x, long long sx, int d_x, const void* sh, int d_sh,
               const void* w, int d_w, const void* WT, const void* G, int d_out,
               const void* n_edges, int E, const void* gk, int n_gk, const void* terms,
               const void* coeffs, const void* dwmap, void* out, int span_max,
               int cols_pad_max, int fs_max, cudaStream_t s) {
  if (leg == kLegX)
    return launch<T, kLegX>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk, n_gk,
                            terms, coeffs, dwmap, out, span_max, cols_pad_max, fs_max, s);
  if (leg == kLegSh)
    return launch<T, kLegSh>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk, n_gk,
                             terms, coeffs, dwmap, out, span_max, cols_pad_max, fs_max, s);
  return launch<T, kLegW>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk, n_gk,
                          terms, coeffs, dwmap, out, span_max, cols_pad_max, fs_max, s);
}

template <typename T>
int occupancy_leg(int leg, int smem) {
  if (leg == kLegX) return occupancy<T, kLegX>(smem);
  if (leg == kLegSh) return occupancy<T, kLegSh>(smem);
  return occupancy<T, kLegW>(smem);
}

}  // namespace

// One block per 16-edge tile.  leg: 0 = x (out [E, d_x]; x is not read and
// may be null), 1 = sh (out [E, d_sh]; sh may be null), 2 = w (out [E, d_w];
// w is not read, and the plan must have per-edge weights).
extern "C" int dtp_lin_leg(int leg, const void* x, long long sx, int d_x, const void* sh,
                           int d_sh, const void* w, int d_w, const void* WT, const void* G,
                           int d_out, const void* n_edges, int E, const void* gk, int n_gk,
                           const void* terms, const void* coeffs, const void* dwmap, void* out,
                           int span_max, int cols_pad_max, int fs_max, int dtype,
                           void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || leg < kLegX || leg > kLegW ||
      out == nullptr || (leg != kLegX && x == nullptr) || (leg != kLegSh && sh == nullptr) ||
      (leg == kLegW && span_max == 0))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_leg<float>(leg, x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk,
                             n_gk, terms, coeffs, dwmap, out, span_max, cols_pad_max, fs_max,
                             s);
  if (dtype == eqt::kBFloat16)
    return launch_leg<__nv_bfloat16>(leg, x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges,
                                     E, gk, n_gk, terms, coeffs, dwmap, out, span_max,
                                     cols_pad_max, fs_max, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of one leg's kernel at the shared memory of a launch
// with these widths, or minus a cudaError_t.
extern "C" int dtp_lin_leg_occupancy(int leg, int d_x, int d_sh, int span_max,
                                     int cols_pad_max, int fs_max, int dtype) {
  if (leg < kLegX || leg > kLegW) return -(int)cudaErrorInvalidValue;
  const int smem =
      smem_floats(leg, d_x, d_sh, span_max, cols_pad_max, fs_max) * (int)sizeof(float);
  if (dtype == eqt::kFloat32) return occupancy_leg<float>(leg, smem);
  if (dtype == eqt::kBFloat16) return occupancy_leg<__nv_bfloat16>(leg, smem);
  return -(int)cudaErrorInvalidValue;
}
