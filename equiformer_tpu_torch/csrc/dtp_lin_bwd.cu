// Fused depthwise tensor product + per-irrep linear heads, backward (K2).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_pallas.py, _bwd_kernel / _bwd_body
// (built by make_bwd_call).  Plan, term tables and weight packing:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.bwd_tables).
//
// What it computes, for the forward of csrc/dtp_lin.cu
//   z[g,k][fc+u] = sum over the (g,k) terms of c * sh[e,col] * x[e,a+u] * w[e,b+u]
//   out[e, out_col(g,k) + j] = sum_f z[g,k][f] * W_g[f, j]
// and the cotangent G of out, per edge e < *n_edges:
//   dz[g,k][f]   = sum_j G[e, out_col(g,k) + j] * W_g[f, j]
//   dW_g[f, j]  += sum_k z[g,k][f] * G[e, out_col(g,k) + j]      (fp32, over all edges)
//   dx[e, a+u]  += c * sh[e,col] * w[e,b+u] * dz[g,k][fc+u]       per term
//   dw[e, b+u]  += c * sh[e,col] * x[e,a+u] * dz[g,k][fc+u]       per term (per-edge w only)
// With shared weights folded into W_g there is no w (taken as 1) and no dw:
// autograd takes dW of the folded W back to W and w outside the kernel.
// dsh is not computed: the QM9 path never differentiates through positions
// (the wrapper raises when sh needs a gradient).  Rows e >= *n_edges get
// zero dx / dw and add nothing to dW.
//
// What bounds it on the card: arithmetic.  Per real edge of the flagship's
// sep_act site, the dz product and the dW product each repeat the forward's
// ~209k multiply-adds (the z recompute and the term transposes add ~15k),
// against ~11 KB of operands read and written per edge.
//
// Design: persistent blocks of 256 threads, each walking edge tiles of 16
// (tile t = blockIdx.x + i * gridDim.x).  Per tile and (g, k) the block
// stages the cotangent slice G[g,k] (16 x cols) in shared memory, recomputes
// z[g,k] there from the term table (z is never saved by the forward: the
// 3136-wide z would be ~228 MB bf16 per call at the flagship's edge count),
// adds z^T G into the block's own fp32 partial of dW in device memory, then
// overwrites z with dz = G W_g^T (W_g^T is packed by the wrapper so lanes
// read it coalesced) and applies the term transposes.  dx of the tile
// accumulates in shared memory over all (g, k); dw over the components of
// one group, since every w column feeds exactly one group (its path has one
// output irrep), and is flushed when the group ends.  Within one (g, k) a
// dx / dw / z element is only ever touched by one thread: a term maps flat
// index i to (row, u) by i / mul, and terms that share a column share mul.
// So there are no atomics anywhere.  dW is a reduction across all edges:
// each block keeps its own partial row, and eqt::sum_partial_rows
// (common.cuh) sums the rows in a fixed order, so the result does not depend on the schedule.
// Everything accumulates in fp32 on the CUDA cores; tensor cores are later
// work.

#include <stdint.h>

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kTile = 16;                         // edges per tile
constexpr int kThreads = 256;                     // 8 warps
constexpr int kRows = 4;                          // edges per warp in the dz product
constexpr int kRowGroups = kTile / kRows;         // 4 warps cover the tile's rows
constexpr int kColGroups = (kThreads / 32) / kRowGroups;  // 2 column groups of warps
constexpr int kColsPerLane = 2;
constexpr int kColChunk = 32 * kColsPerLane;      // fan columns per pass of a warp
constexpr int kGkFields = 12;                     // ints per (g, k) table entry
constexpr int kTermFields = 6;                    // a_off, sh col, b_off, fan col, mul, local dw col

struct Smem {
  float* dx;   // [kTile, d_x]
  float* dw;   // [kTile, span_max]
  float* gt;   // [kTile, cols_pad]
  float* z;    // [kTile, fs_max]: z, then dz
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_lin_bwd_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh,
                   int d_sh, const T* __restrict__ w, int d_w, const T* __restrict__ WT,
                   const T* __restrict__ G, int d_out, const int* __restrict__ n_edges_ptr,
                   int E, const int* __restrict__ gk, int n_gk, const int* __restrict__ terms,
                   const float* __restrict__ coeffs, const int* __restrict__ dwmap,
                   T* __restrict__ dx, T* __restrict__ dw, float* __restrict__ part,
                   int w_numel, int span_max, int cols_pad_max) {
  extern __shared__ float4 smem4[];
  Smem s;
  s.dx = reinterpret_cast<float*>(smem4);
  s.dw = s.dx + kTile * d_x;
  s.gt = s.dw + kTile * span_max;
  s.z = s.gt + kTile * cols_pad_max;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % kRowGroups) * kRows;
  const int fw = (warp / kRowGroups) * kColChunk;
  const int n_edges = __ldg(n_edges_ptr);
  const int n_tiles = (E + kTile - 1) / kTile;
  float* my_part = part + (long long)blockIdx.x * w_numel;

  for (int i = tid; i < w_numel; i += kThreads) my_part[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int n_rows = min(kTile, E - e0);
    const int n_live = max(0, min(n_rows, n_edges - e0));

    if (n_live == 0) {  // past the real edges: zero gradients, nothing to dW
      for (int i = tid; i < n_rows * d_x; i += kThreads) {
        const int r = i / d_x;
        dx[(long long)(e0 + r) * d_x + (i - r * d_x)] = from_f<T>(0.f);
      }
      if (w != nullptr)
        for (int i = tid; i < n_rows * d_w; i += kThreads) {
          const int r = i / d_w;
          dw[(long long)(e0 + r) * d_w + (i - r * d_w)] = from_f<T>(0.f);
        }
      continue;
    }

    for (int i = tid; i < kTile * d_x; i += kThreads) s.dx[i] = 0.f;

    for (int q = 0; q < n_gk; ++q) {
      const int* g = gk + q * kGkFields;
      const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
      const int t_begin = g[4], t_end = g[5], wt_off = g[6], cp = g[7];
      const int span_begin = g[8], span = g[9], first = g[10], last = g[11];

      if (w != nullptr && first)
        for (int i = tid; i < kTile * span; i += kThreads) s.dw[i] = 0.f;
      // ---- stage G[g,k] (zero rows past the real edges, zero pad columns)
      for (int i = tid; i < kTile * cp; i += kThreads) {
        const int r = i / cp;
        const int c = i - r * cp;
        float v = 0.f;
        if (r < n_live && c < cols) v = to_f(G[(long long)(e0 + r) * d_out + out_col + c]);
        s.gt[i] = v;
      }
      for (int i = tid; i < kTile * fs; i += kThreads) s.z[i] = 0.f;
      __syncthreads();

      // ---- recompute z[g,k] from the term table (rows >= n_live stay zero)
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4];
        const float c = coeffs[t];
        for (int i = tid; i < n_live * mul; i += kThreads) {
          const int r = i / mul;
          const int u = i - r * mul;
          const long long e = e0 + r;
          float v = c * to_f(sh[e * d_sh + col]) * to_f(x[e * sx + a + u]);
          if (w != nullptr) v *= to_f(w[e * d_w + b + u]);
          s.z[r * fs + fc + u] += v;
        }
      }
      __syncthreads();

      // ---- dW_g[f, j] += sum_r z[r, f] G[r, j]: a thread owns 4 fan rows x 1 column
      {
        float* pg = my_part + w_off;
        const int items = (fs / 4) * cols;
        for (int o = tid; o < items; o += kThreads) {
          const int fq = o / cols;
          const int j = o - fq * cols;
          const int f = fq * 4;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
          for (int r = 0; r < kTile; ++r) {
            const float4 zq = *reinterpret_cast<const float4*>(s.z + r * fs + f);
            const float gv = s.gt[r * cp + j];
            a0 = fmaf(zq.x, gv, a0);
            a1 = fmaf(zq.y, gv, a1);
            a2 = fmaf(zq.z, gv, a2);
            a3 = fmaf(zq.w, gv, a3);
          }
          pg[(f + 0) * cols + j] += a0;
          pg[(f + 1) * cols + j] += a1;
          pg[(f + 2) * cols + j] += a2;
          pg[(f + 3) * cols + j] += a3;
        }
      }
      __syncthreads();  // z is overwritten by dz below

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
              gq[r] = *reinterpret_cast<const float4*>(s.gt + (r0 + r) * cp + j);
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
              if (f < fs) s.z[(r0 + r) * fs + f] = acc[r][jj];
            }
        }
      }
      __syncthreads();

      // ---- term transposes off dz
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4], bl = tt[5];
        const float c = coeffs[t];
        for (int i = tid; i < n_live * mul; i += kThreads) {
          const int r = i / mul;
          const int u = i - r * mul;
          const long long e = e0 + r;
          const float d = c * to_f(sh[e * d_sh + col]) * s.z[r * fs + fc + u];
          if (w != nullptr) {
            s.dx[r * d_x + a + u] += d * to_f(w[e * d_w + b + u]);
            s.dw[r * span + bl + u] += d * to_f(x[e * sx + a + u]);
          } else {
            s.dx[r * d_x + a + u] += d;
          }
        }
      }
      __syncthreads();

      // ---- a group's last component: its dw columns are complete
      if (w != nullptr && last) {
        for (int i = tid; i < n_rows * span; i += kThreads) {
          const int r = i / span;
          const int jl = i - r * span;
          dw[(long long)(e0 + r) * d_w + dwmap[span_begin + jl]] = from_f<T>(s.dw[i]);
        }
        __syncthreads();
      }
    }

    for (int i = tid; i < n_rows * d_x; i += kThreads) {
      const int r = i / d_x;
      dx[(long long)(e0 + r) * d_x + (i - r * d_x)] = from_f<T>(s.dx[i]);
    }
    __syncthreads();  // s.dx is zeroed for the next tile
  }
}

template <typename T>
int launch(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
           int d_w, const void* WT, const void* G, int d_out, const void* n_edges, int E,
           const void* gk, int n_gk, const void* terms, const void* coeffs, const void* dwmap,
           void* dx, void* dw, void* part, int n_parts, void* dW, int w_numel, int span_max,
           int cols_pad_max, int fs_max, cudaStream_t stream) {
  const int smem =
      kTile * (d_x + span_max + cols_pad_max + fs_max) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dtp_lin_bwd_kernel<T><<<n_parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, d_x, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(WT), static_cast<const T*>(G),
      d_out, static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs),
      static_cast<const int*>(dwmap), static_cast<T*>(dx), static_cast<T*>(dw),
      static_cast<float*>(part), w_numel, span_max, cols_pad_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW = the blocks' partial rows summed in block order
  return (int)eqt::sum_partial_rows(static_cast<const float*>(part), n_parts, w_numel,
                                    static_cast<float*>(dW), stream);
}

}  // namespace

// n_parts blocks (at most the number of tiles) each own one fp32 partial row
// of part [n_parts, w_numel]; dW [w_numel] fp32 receives their sum.
extern "C" int dtp_lin_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                           const void* w, int d_w, const void* WT, const void* G, int d_out,
                           const void* n_edges, int E, const void* gk, int n_gk,
                           const void* terms, const void* coeffs, const void* dwmap, void* dx,
                           void* dw, void* part, int n_parts, void* dW, int w_numel,
                           int span_max, int cols_pad_max, int fs_max, int dtype,
                           void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || n_parts < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk, n_gk,
                         terms, coeffs, dwmap, dx, dw, part, n_parts, dW, w_numel, span_max,
                         cols_pad_max, fs_max, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk,
                                 n_gk, terms, coeffs, dwmap, dx, dw, part, n_parts, dW,
                                 w_numel, span_max, cols_pad_max, fs_max, s);
  return (int)cudaErrorInvalidValue;
}
