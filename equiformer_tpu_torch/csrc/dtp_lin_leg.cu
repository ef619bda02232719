// Fused depthwise tensor product + per-irrep linear heads: the
// radial-folded edge legs x, sh and h (K7-L: dx, dsh or dh), on the first
// K5b design.  K5b's x, sh and w legs run on K2's launch 1
// (csrc/dtp_lin_bwd.cu, k2::edge_leg_kernel and k2::sh_leg_kernel), and so
// does the fold's Wr leg (K7-Wr: K5b's w leg, then the d[Wr; offset] tiles
// of k2::Wr_leg_kernel); this file keeps the first design for K7-L,
// instruction for instruction until its own redesign (its unfolded legs
// are no longer instantiated).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_ho.py, _edge_leg_kernel_rad
// (:255, the legs x, sh and h of a radial-folded plan; _leg_call :613-621;
// bound through _leg_p by the JVP of _bwd3_p and by the transposes of the
// other legs in the grad-of-grad of force training).  Plan and tables:
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
// The x leg never reads x, the sh leg never sh: the operand of the output
// leg does not exist for the caller (in the grad-of-grad its slot holds the
// cotangent that became G or another operand).  Rows e >= *n_edges get
// zeros.
//
// With the radial fold (kRad) w = [h, 1] @ [Wr; offset] and the legs are
// (out, x, sh, h, Wr, W): the x and sh legs build each group's w columns in
// shared memory (csrc/radial.cuh) instead of reading w; the h leg
// accumulates the group's dw as the w leg does and at the group's last
// component adds dh += dw Wr^T into a [16, hd] fp32 tile (written as dh
// [E, hd]).  w and dw never reach device memory.
//
// What bounds it on the card: arithmetic.  Per real edge of the MD17 L3
// sep_act site the dz product is ~0.6M multiply-adds and one term
// transpose ~32k, against ~8 KB of operands read and written; the fold adds
// 2 * (hd + 1) * d_w operations per edge for each product with [Wr; offset].
//
// Design: csrc/dtp_lin_bwd3.cu with two of its three accumulators removed
// and the leg fixed at compile time, so the loads a leg does not need are
// not in its code.  Blocks of 256 threads walk tiles of 16 edges, one tile
// a block; per (g, k) the block stages the slice G[g,k] in shared memory
// and computes dz = G W_g^T there (W_g^T packed by the wrapper so lanes
// read it coalesced); in the term pass warp w owns rows w and w + 8 of the
// tile and lane l the copies u = l (mod 32) of every term.  A dx or dw
// element is touched only by terms of one x block component (one a_off and
// mul) or one TP path (one b_off and mul), so it always falls to the same
// lane of the same warp: one writer per accumulator, no barrier inside the
// term pass.  dsh is a reduction over u and over terms: each lane keeps a
// running sum while consecutive terms share an SH column (the table is
// sorted so they do), and at a column change the warp adds it up with a
// fixed butterfly of shuffles and lane 0 adds it to the row's dsh.  No
// atomics anywhere: the same bits on every run.  dx and dsh accumulate over
// the whole tile, dw over one group (every w column feeds exactly one
// group) and is contracted against Wr at the group's last component.
// Everything accumulates in fp32 on the CUDA cores; tensor cores and TMA
// are later work.

#include <stdint.h>

#include "common.cuh"
#include "radial.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;
using eqt::warp_sum;

constexpr int kTile = 16;                         // edges per tile
constexpr int kThreads = 256;                     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                          // edges per warp in the dz product
constexpr int kRowGroups = kTile / kRows;         // 4 warps cover the tile's rows
constexpr int kColGroups = kWarps / kRowGroups;   // 2 column groups of warps
constexpr int kColsPerLane = 2;
constexpr int kColChunk = 32 * kColsPerLane;      // fan columns per pass of a warp
constexpr int kGkFields = 12;                     // ints per (g, k) table entry
constexpr int kTermFields = 6;                    // a_off, sh col, b_off, fan col, mul, local dw col

// the legs; h exists only with the radial fold
enum Leg : int { kLegX = 0, kLegSh = 1, kLegW = 2, kLegH = 3 };

// the operands of one launch (kernel parameters by value)
struct LegArgs {
  const void* x; long long sx; int d_x;
  const void* sh; int d_sh;
  const void* w; int d_w;
  const void* WT; const void* G; int d_out;
  const int* n_edges; int E;
  const int* gk; int n_gk; const int* terms; const float* coeffs; const int* dwmap;
  void* out;                   // [E, width] of the per-edge legs
  int span_max, cols_pad_max, fs_max;
  const void* h; int hd;       // the fold: h [E, hd], Wl [hd + 1, n_loc]
  const void* Wl; int n_loc;
};

__host__ __device__ constexpr bool accumulates_dw(int leg) {
  return leg == kLegW || leg == kLegH;
}
__host__ __device__ constexpr bool builds_w(int leg, bool rad) {
  return rad && (leg == kLegX || leg == kLegSh);
}
__host__ __device__ constexpr bool reads_h(int leg, bool rad) {
  return rad && leg != kLegH;
}

// width of the leg's accumulator rows in shared memory
__host__ __device__ inline int acc_width(int leg, int d_x, int d_sh, int span_max) {
  return leg == kLegX ? d_x : (leg == kLegSh ? d_sh : span_max);
}

// fp32 shared memory: acc [kTile, acc_w], G [kTile, cp], dz [kTile, fs],
// sh [kTile, d_sh] for the legs that read it; with the fold w [kTile,
// span_max] and h [kTile, hd] (x, sh legs), dh [kTile, hd] (h leg)
__host__ __device__ inline int smem_floats(int leg, bool rad, int d_x, int d_sh, int span_max,
                                           int cols_pad_max, int fs_max, int hd) {
  return kTile * (acc_width(leg, d_x, d_sh, span_max) + cols_pad_max + fs_max +
                  (leg == kLegSh ? 0 : d_sh) + (builds_w(leg, rad) ? span_max : 0) +
                  (reads_h(leg, rad) ? hd : 0) + (leg == kLegH ? hd : 0));
}

template <typename T, int LEG, bool kRad>
__global__ void __launch_bounds__(kThreads) dtp_lin_leg_kernel(const LegArgs p) {
  constexpr bool kDw = accumulates_dw(LEG);
  constexpr bool kBuildW = builds_w(LEG, kRad);
  constexpr bool kReadH = reads_h(LEG, kRad);
  extern __shared__ float4 smem4[];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ sh = static_cast<const T*>(p.sh);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const T* __restrict__ G = static_cast<const T*>(p.G);
  const T* __restrict__ Wl = static_cast<const T*>(p.Wl);
  T* __restrict__ out = static_cast<T*>(p.out);
  const long long sx = p.sx;
  const int d_sh = p.d_sh, d_w = p.d_w, d_out = p.d_out, hd = p.hd, E = p.E;
  const int acc_w = acc_width(LEG, p.d_x, d_sh, p.span_max);
  // output row width of the leg
  const int d_leg = LEG == kLegX ? p.d_x : LEG == kLegSh ? d_sh : LEG == kLegW ? d_w : hd;
  float* s_acc = reinterpret_cast<float*>(smem4);
  float* s_gt = s_acc + kTile * acc_w;   // offsets multiples of 16 floats: float4 rows
  float* s_dz = s_gt + kTile * p.cols_pad_max;
  float* s_sh = s_dz + kTile * p.fs_max;                      // not there for the sh leg
  float* s_w = s_sh + (LEG == kLegSh ? 0 : kTile * d_sh);     // kBuildW
  float* s_h = s_w + (kBuildW ? kTile * p.span_max : 0);      // kReadH
  float* s_dh = s_h + (kReadH ? kTile * hd : 0);              // the h leg

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (warp % kRowGroups) * kRows;
  const int fw = (warp / kRowGroups) * kColChunk;
  const int n_edges = __ldg(p.n_edges);
  const int n_tiles = (E + kTile - 1) / kTile;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int n_rows = min(kTile, E - e0);
    const int n_live = max(0, min(n_rows, n_edges - e0));

    if (n_live == 0) {  // past the real edges: zeros
      for (int i = tid; i < n_rows * d_leg; i += kThreads)
        out[(long long)e0 * d_leg + i] = from_f<T>(0.f);
      continue;
    }

    if constexpr (!kDw)
      for (int i = tid; i < kTile * acc_w; i += kThreads) s_acc[i] = 0.f;
    if constexpr (LEG == kLegH)
      for (int i = tid; i < kTile * hd; i += kThreads) s_dh[i] = 0.f;
    if constexpr (LEG != kLegSh)
      for (int i = tid; i < kTile * d_sh; i += kThreads) {
        const int r = i / d_sh;
        s_sh[i] = r < n_live ? to_f(sh[(long long)e0 * d_sh + i]) : 0.f;
      }
    if constexpr (kReadH) {
      eqt::load_h<kTile, kThreads>(s_h, static_cast<const T*>(p.h), hd, e0, n_live);
      __syncthreads();  // build_w reads s_h
    }

    for (int q = 0; q < p.n_gk; ++q) {
      const int* g = p.gk + q * kGkFields;
      const int fs = g[0], cols = g[1], out_col = g[2];
      const int t_begin = g[4], t_end = g[5], wt_off = g[6], cp = g[7];
      const int span_begin = g[8], span = g[9], first = g[10], last = g[11];

      if (kDw && first)
        for (int i = tid; i < kTile * span; i += kThreads) s_acc[i] = 0.f;
      if constexpr (kBuildW)
        if (first) eqt::build_w<kTile, kThreads>(s_w, s_h, hd, Wl, p.n_loc, span_begin, span,
                                                 n_live);
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
        const T* Wt = static_cast<const T*>(p.WT) + wt_off;
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
        const float* wr = s_w + r * span;  // kBuildW: the group's w columns of row r
        float* accr = s_acc + r * (kDw ? span : acc_w);
        float run = 0.f;  // sh leg: this lane's part of dsh[r, cur]
        int cur = -1;
        for (int t = t_begin; t < t_end; ++t) {
          const int* tt = p.terms + t * kTermFields;
          const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4], bl = tt[5];
          const float c = p.coeffs[t];
          if constexpr (LEG == kLegSh) {
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
              float wv;
              if constexpr (kBuildW) {
                wv = wr[bl + u];
              } else {
                wv = w != nullptr ? to_f(w[e * d_w + b + u]) : 1.f;
              }
              run = fmaf(c * xv * wv, dzr[fc + u], run);
            }
          } else if constexpr (LEG == kLegX) {
            const float cs = c * shr[col];
            for (int u = lane; u < mul; u += 32) {
              float wv;
              if constexpr (kBuildW) {
                wv = wr[bl + u];
              } else {
                wv = w != nullptr ? to_f(w[e * d_w + b + u]) : 1.f;
              }
              accr[a + u] += cs * wv * dzr[fc + u];
            }
          } else {  // dw: the w and h legs
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

      // ---- a group's last component: its dw columns are complete
      if (kDw && last) {
        if constexpr (LEG == kLegW) {
          for (int i = tid; i < n_rows * span; i += kThreads) {
            const int r = i / span;
            const int jl = i - r * span;
            out[(long long)(e0 + r) * d_w + p.dwmap[span_begin + jl]] = from_f<T>(s_acc[i]);
          }
        } else if constexpr (LEG == kLegH) {  // dh += dw Wr^T
          eqt::add_dh<kTile, kThreads>(s_dh, s_acc, span, hd, Wl, p.n_loc, span_begin);
        }
        __syncthreads();
      }
    }

    if constexpr (LEG == kLegX || LEG == kLegSh)
      for (int i = tid; i < n_rows * d_leg; i += kThreads)
        out[(long long)e0 * d_leg + i] = from_f<T>(s_acc[i]);
    if constexpr (LEG == kLegH)
      for (int i = tid; i < n_rows * hd; i += kThreads)
        out[(long long)e0 * hd + i] = from_f<T>(s_dh[i]);
    __syncthreads();  // the next tile overwrites shared memory
  }
}

template <typename T, int LEG, bool kRad>
int launch(const LegArgs& a, int n_blocks, cudaStream_t stream) {
  const int smem = smem_floats(LEG, kRad, a.d_x, a.d_sh, a.span_max, a.cols_pad_max, a.fs_max,
                               a.hd) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_leg_kernel<T, LEG, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dtp_lin_leg_kernel<T, LEG, kRad><<<n_blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int LEG, bool kRad>
int occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_leg_kernel<T, LEG, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dtp_lin_leg_kernel<T, LEG, kRad>,
                                                      kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// the one template of each (leg, fold) pair: launch (n_blocks > 0) or, with
// n_blocks == 0, the occupancy at smem bytes
template <typename T>
int dispatch(int leg, bool rad, const LegArgs& a, int n_blocks, int smem, cudaStream_t s) {
#define EQT_LEG(L, R) \
  return n_blocks > 0 ? launch<T, L, R>(a, n_blocks, s) : occupancy<T, L, R>(smem)
  if (rad) {
    if (leg == kLegX) EQT_LEG(kLegX, true);
    if (leg == kLegSh) EQT_LEG(kLegSh, true);
    if (leg == kLegH) EQT_LEG(kLegH, true);
  }
#undef EQT_LEG
  return n_blocks > 0 ? (int)cudaErrorInvalidValue : -(int)cudaErrorInvalidValue;
}

int run(int leg, bool rad, const LegArgs& a, int n_blocks, int dtype, void* stream) {
  if (a.fs_max % 4 != 0 || a.cols_pad_max % 4 != 0 || (rad && (a.hd <= 0 || a.hd % 4 != 0)) ||
      (leg != kLegX && a.x == nullptr) || (leg != kLegSh && a.sh == nullptr) ||
      (accumulates_dw(leg) && a.span_max == 0) || (reads_h(leg, rad) && a.h == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return dispatch<float>(leg, rad, a, n_blocks, 0, s);
  if (dtype == eqt::kBFloat16) return dispatch<__nv_bfloat16>(leg, rad, a, n_blocks, 0, s);
  return (int)cudaErrorInvalidValue;
}

LegArgs edge_args(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                  const void* WT, const void* G, int d_out, const void* n_edges, int E,
                  const void* gk, int n_gk, const void* terms, const void* coeffs,
                  int span_max, int cols_pad_max, int fs_max) {
  LegArgs a{};
  a.x = x; a.sx = sx; a.d_x = d_x; a.sh = sh; a.d_sh = d_sh; a.WT = WT; a.G = G;
  a.d_out = d_out; a.n_edges = static_cast<const int*>(n_edges); a.E = E;
  a.gk = static_cast<const int*>(gk); a.n_gk = n_gk; a.terms = static_cast<const int*>(terms);
  a.coeffs = static_cast<const float*>(coeffs); a.span_max = span_max;
  a.cols_pad_max = cols_pad_max; a.fs_max = fs_max;
  return a;
}

}  // namespace

// K7-L.  One block per 16-edge tile; h [E, hd] and Wl [hd + 1, n_loc] (the
// tables' local column order) in place of w.  leg: 0 = x (out [E, d_x]), 1
// = sh (out [E, d_sh]), 2 = h (out [E, hd]; h is not read and may be null);
// the slot of the output leg is not read.
extern "C" int dtp_lin_rad_leg(int leg, const void* x, long long sx, int d_x, const void* sh,
                               int d_sh, const void* WT, const void* G, int d_out,
                               const void* n_edges, int E, const void* gk, int n_gk,
                               const void* terms, const void* coeffs, void* out, int span_max,
                               int cols_pad_max, int fs_max, const void* h, int hd,
                               const void* Wl, int n_loc, int dtype, void* stream) {
  if (leg < 0 || leg > 2 || out == nullptr || Wl == nullptr) return (int)cudaErrorInvalidValue;
  LegArgs a = edge_args(x, sx, d_x, sh, d_sh, WT, G, d_out, n_edges, E, gk, n_gk, terms, coeffs,
                        span_max, cols_pad_max, fs_max);
  a.out = out; a.h = h; a.hd = hd; a.Wl = Wl; a.n_loc = n_loc;
  return run(leg == 2 ? kLegH : leg, true, a, (E + kTile - 1) / kTile, dtype, stream);
}

// Resident blocks per SM of one leg's kernel at the shared memory of a launch
// with these widths, or minus a cudaError_t.  leg, with the fold (hd > 0): 0
// x, 1 sh, 3 h.
extern "C" int dtp_lin_leg_occupancy(int leg, int d_x, int d_sh, int span_max,
                                     int cols_pad_max, int fs_max, int hd, int dtype) {
  const bool rad = hd > 0;
  if (leg < kLegX || leg > kLegH || leg == kLegW || !rad)
    return -(int)cudaErrorInvalidValue;
  const int smem = smem_floats(leg, rad, d_x, d_sh, span_max, cols_pad_max, fs_max, hd) *
                   (int)sizeof(float);
  if (dtype == eqt::kFloat32) return dispatch<float>(leg, rad, LegArgs{}, 0, smem, nullptr);
  if (dtype == eqt::kBFloat16)
    return dispatch<__nv_bfloat16>(leg, rad, LegArgs{}, 0, smem, nullptr);
  return -(int)cudaErrorInvalidValue;
}
