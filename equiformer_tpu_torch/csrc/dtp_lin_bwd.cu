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
//
// The radial-folded variant (K7-B, kRad; replaces the radial branch of
// _bwd_kernel / _bwd_body, dtp_lin_pallas.py:675-745, :754-756, :865-887,
// with _radial_write_dw :497 and _radial_dh :521) reads h [E, hd] in place
// of w, rebuilds each group's w columns in shared memory as K7-F does
// (csrc/radial.cuh), and keeps the group's dw there: at the group's last
// component it adds dw Wr^T into the tile's dh (fp32, shared memory) and
// [h, 1]^T dw into the block's partial rows of d[Wr; offset], which follow
// the dW partial in the same row, so one fixed-order pass sums both.  dw
// and w never go to device memory; dh does ([E, hd]).  Rows past the real
// edges get dh = 0 and add nothing to d[Wr; offset] (their h and dw are
// zero, so the offset's ones column adds nothing either).  Shared memory:
// K2's plus w [16, span_max], h and dh [16, hd], 135 KB at the QM9 sep_act
// site: one block per SM (RAD_BWD_BLOCKS_PER_SM in kernels/dtp_lin.py).

#include <stdint.h>

#include "common.cuh"
#include "radial.cuh"

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
  float* w;    // kRad: [kTile, span_max], the current group's w
  float* h;    // kRad: [kTile, hd]
  float* dh;   // kRad: [kTile, hd]
};

// fp32 shared memory of one block
__host__ __device__ inline int smem_floats(int d_x, int span_max, int cols_pad_max, int fs_max,
                                           int rad_floats) {
  return kTile * (d_x + span_max + cols_pad_max + fs_max) + rad_floats;
}

template <typename T, bool kRad>
__global__ void __launch_bounds__(kThreads)
dtp_lin_bwd_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh,
                   int d_sh, const T* __restrict__ w, int d_w, const T* __restrict__ WT,
                   const T* __restrict__ G, int d_out, const int* __restrict__ n_edges_ptr,
                   int E, const int* __restrict__ gk, int n_gk, const int* __restrict__ terms,
                   const float* __restrict__ coeffs, const int* __restrict__ dwmap,
                   T* __restrict__ dx, T* __restrict__ dw, float* __restrict__ part,
                   int w_numel, int span_max, int cols_pad_max, int fs_max,
                   const T* __restrict__ h, int hd, const T* __restrict__ Wl, int n_loc,
                   T* __restrict__ dh) {
  extern __shared__ float4 smem4[];
  Smem s;
  s.dx = reinterpret_cast<float*>(smem4);
  s.dw = s.dx + kTile * d_x;
  s.gt = s.dw + kTile * span_max;
  s.z = s.gt + kTile * cols_pad_max;
  s.w = s.z + kTile * fs_max;
  s.h = s.w + kTile * span_max;
  s.dh = s.h + kTile * hd;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % kRowGroups) * kRows;
  const int fw = (warp / kRowGroups) * kColChunk;
  const int n_edges = __ldg(n_edges_ptr);
  const int n_tiles = (E + kTile - 1) / kTile;
  // a partial row: dW [w_numel], then (kRad) d[Wr; offset] [hd + 1, n_loc]
  const int part_row = w_numel + (kRad ? (hd + 1) * n_loc : 0);
  float* my_part = part + (long long)blockIdx.x * part_row;

  for (int i = tid; i < part_row; i += kThreads) my_part[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int n_rows = min(kTile, E - e0);
    const int n_live = max(0, min(n_rows, n_edges - e0));

    if (n_live == 0) {  // past the real edges: zero gradients, nothing to dW
      for (int i = tid; i < n_rows * d_x; i += kThreads) {
        const int r = i / d_x;
        dx[(long long)(e0 + r) * d_x + (i - r * d_x)] = from_f<T>(0.f);
      }
      if constexpr (kRad) {
        for (int i = tid; i < n_rows * hd; i += kThreads)
          dh[(long long)e0 * hd + i] = from_f<T>(0.f);
      } else if (w != nullptr) {
        for (int i = tid; i < n_rows * d_w; i += kThreads) {
          const int r = i / d_w;
          dw[(long long)(e0 + r) * d_w + (i - r * d_w)] = from_f<T>(0.f);
        }
      }
      continue;
    }

    for (int i = tid; i < kTile * d_x; i += kThreads) s.dx[i] = 0.f;
    if constexpr (kRad) {
      eqt::load_h<kTile, kThreads>(s.h, h, hd, e0, n_live);
      for (int i = tid; i < kTile * hd; i += kThreads) s.dh[i] = 0.f;
      __syncthreads();
    }

    for (int q = 0; q < n_gk; ++q) {
      const int* g = gk + q * kGkFields;
      const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
      const int t_begin = g[4], t_end = g[5], wt_off = g[6], cp = g[7];
      const int span_begin = g[8], span = g[9], first = g[10], last = g[11];

      if ((kRad || w != nullptr) && first)
        for (int i = tid; i < kTile * span; i += kThreads) s.dw[i] = 0.f;
      if constexpr (kRad)
        if (first) eqt::build_w<kTile, kThreads>(s.w, s.h, hd, Wl, n_loc, span_begin, span, n_live);
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
          if constexpr (kRad) {
            v *= s.w[r * span + tt[5] + u];
          } else {
            if (w != nullptr) v *= to_f(w[e * d_w + b + u]);
          }
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
          if constexpr (kRad) {
            s.dx[r * d_x + a + u] += d * s.w[r * span + bl + u];
            s.dw[r * span + bl + u] += d * to_f(x[e * sx + a + u]);
          } else if (w != nullptr) {
            s.dx[r * d_x + a + u] += d * to_f(w[e * d_w + b + u]);
            s.dw[r * span + bl + u] += d * to_f(x[e * sx + a + u]);
          } else {
            s.dx[r * d_x + a + u] += d;
          }
        }
      }
      __syncthreads();

      // ---- a group's last component: its dw columns are complete
      if constexpr (kRad) {
        if (last) {  // dh += dw Wr^T; partial d[Wr; offset] += [h, 1]^T dw
          eqt::add_dh<kTile, kThreads>(s.dh, s.dw, span, hd, Wl, n_loc, span_begin);
          eqt::add_dWr<kTile, kThreads>(my_part + w_numel, n_loc, s.h, hd, s.dw, span,
                                        span_begin);
          __syncthreads();
        }
      } else if (w != nullptr && last) {
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
    if constexpr (kRad)
      for (int i = tid; i < n_rows * hd; i += kThreads)
        dh[(long long)e0 * hd + i] = from_f<T>(s.dh[i]);
    __syncthreads();  // s.dx (and s.dh) are zeroed for the next tile
  }
}

template <typename T, bool kRad>
int launch(const void* x, long long sx, int d_x, const void* sh, int d_sh, const void* w,
           int d_w, const void* WT, const void* G, int d_out, const void* n_edges, int E,
           const void* gk, int n_gk, const void* terms, const void* coeffs, const void* dwmap,
           void* dx, void* dw, void* part, int n_parts, void* dW, int w_numel, int span_max,
           int cols_pad_max, int fs_max, const void* h, int hd, const void* Wl, int n_loc,
           void* dh, cudaStream_t stream) {
  const int rad_floats = kRad ? kTile * (span_max + 2 * hd) : 0;
  const int smem =
      smem_floats(d_x, span_max, cols_pad_max, fs_max, rad_floats) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_bwd_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dtp_lin_bwd_kernel<T, kRad><<<n_parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, d_x, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(WT), static_cast<const T*>(G),
      d_out, static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs),
      static_cast<const int*>(dwmap), static_cast<T*>(dx), static_cast<T*>(dw),
      static_cast<float*>(part), w_numel, span_max, cols_pad_max, fs_max,
      static_cast<const T*>(h), hd, static_cast<const T*>(Wl), n_loc, static_cast<T*>(dh));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW (and d[Wr; offset]) = the blocks' partial rows summed in block order
  const int part_row = w_numel + (kRad ? (hd + 1) * n_loc : 0);
  return (int)eqt::sum_partial_rows(static_cast<const float*>(part), n_parts, part_row,
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
    return launch<float, false>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges, E, gk,
                                n_gk, terms, coeffs, dwmap, dx, dw, part, n_parts, dW, w_numel,
                                span_max, cols_pad_max, fs_max, nullptr, 0, nullptr, 0,
                                nullptr, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, false>(x, sx, d_x, sh, d_sh, w, d_w, WT, G, d_out, n_edges,
                                        E, gk, n_gk, terms, coeffs, dwmap, dx, dw, part,
                                        n_parts, dW, w_numel, span_max, cols_pad_max, fs_max,
                                        nullptr, 0, nullptr, 0, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// K7-B: the backward of dtp_lin_rad_fwd.  h [E, hd] and Wl [hd + 1, n_loc]
// (columns in the tables' local order) in place of w; writes dx and dh, and
// dWred [w_numel + (hd + 1) * n_loc] fp32: dW, then d[Wr; offset] in local
// column order, from part [n_parts, the same width].
extern "C" int dtp_lin_rad_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                               const void* WT, const void* G, int d_out, const void* n_edges,
                               int E, const void* gk, int n_gk, const void* terms,
                               const void* coeffs, void* dx, void* part, int n_parts,
                               void* dWred, int w_numel, int span_max, int cols_pad_max,
                               int fs_max, const void* h, int hd, const void* Wl, int n_loc,
                               void* dh, int dtype, void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || n_parts < 1 || hd % 4 != 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, true>(x, sx, d_x, sh, d_sh, nullptr, 0, WT, G, d_out, n_edges, E, gk,
                               n_gk, terms, coeffs, nullptr, dx, nullptr, part, n_parts, dWred,
                               w_numel, span_max, cols_pad_max, fs_max, h, hd, Wl, n_loc, dh,
                               s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, sx, d_x, sh, d_sh, nullptr, 0, WT, G, d_out, n_edges,
                                       E, gk, n_gk, terms, coeffs, nullptr, dx, nullptr, part,
                                       n_parts, dWred, w_numel, span_max, cols_pad_max, fs_max,
                                       h, hd, Wl, n_loc, dh, s);
  return (int)cudaErrorInvalidValue;
}
