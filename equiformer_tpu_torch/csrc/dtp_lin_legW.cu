// Fused depthwise tensor product + per-irrep linear heads, radial-folded:
// the head-weight leg (K7-LW), dW alone.
//
// Replaces: the radial branch of equiformer_tpu/kernels/dtp_lin_ho.py,
// _W_leg_kernel (:402-449: the h operand :415, _radial_w_fill :439-440;
// built by _leg_call for the leg W of a radial-folded plan).  Plan and
// term tables: equiformer_tpu_torch/kernels/dtp_lin.py
// (DTPLinPlan.bwd_tables), the tables of the first K2 design.  The
// unfolded leg (K5c) runs on K2's launch 2 (csrc/dtp_lin_bwd.cu,
// k2::W_leg_kernel); this is the first K5c design with kRad, kept
// instruction for instruction until its own redesign (its kRad = false
// paths are no longer instantiated).
//
// What it computes, with G in the out leg of out = Linear_W(DTP(x, sh, w)),
// w = [h, 1] @ [Wr; offset], over the edges e < *n_edges:
//   z[g,k][fc+u] = sum over the (g,k) terms of c * sh[e,col] * x[e,a+u] * w[e,b+u]
//   dW_g[f, j]  += sum_k z[g,k][f] * G[e, out_col(g,k) + j]        (fp32)
// in the packed layout of W ([fan_stride, cols] per group, pad rows zero).
// z and w are recomputed from the operands and never written to device
// memory.  Tiles past *n_edges are skipped.
//
// What bounds it on the card: arithmetic.  Per real edge of the MD17 L3
// sep_act site the z^T G product is ~0.6M multiply-adds and the z recompute
// ~32k, against ~6 KB of operands read; the fold adds 2 * (hd + 1) * d_w.
//
// Design: persistent blocks of 256 threads, each walking edge tiles of 16
// (tile t = blockIdx.x + i * gridDim.x).  Per tile the block loads h [16,
// hd]; at each group's first component it builds the group's w columns
// from h and [Wr; offset] in shared memory (csrc/radial.cuh).  Per (g, k)
// it stages the slice G[g,k] (16 x cols) in shared memory, recomputes
// z[g,k] there from the term table (within one (g, k) a z element is only
// ever touched by one thread: a term maps flat index i to (row, u) by i /
// mul, and terms that share a column share mul), and adds z^T G into the
// block's own fp32 partial of dW in device memory, a thread owning 4 fan
// rows of one column.  eqt::sum_partial_rows (common.cuh) sums the blocks'
// rows in a fixed order: no float atomics, and the result does not depend
// on the schedule.  Everything accumulates in fp32 on the CUDA cores.
// Shared memory: G [16, cols_pad_max], z [16, fs_max], w [16, span_max]
// and h [16, hd].

#include <stdint.h>

#include "common.cuh"
#include "radial.cuh"

namespace {

using eqt::to_f;

constexpr int kTile = 16;       // edges per tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kGkFields = 12;   // ints per (g, k) table entry
constexpr int kTermFields = 6;  // a_off, sh col, b_off, fan col, mul, local dw col

// fp32 shared memory: G [kTile, cols_pad_max], z [kTile, fs_max]; with the
// fold (hd > 0) also w [kTile, span_max] and h [kTile, hd]
__host__ __device__ inline int smem_floats(int cols_pad_max, int fs_max, int span_max, int hd) {
  return kTile * (cols_pad_max + fs_max + (hd > 0 ? span_max + hd : 0));
}

template <typename T, bool kRad>
__global__ void __launch_bounds__(kThreads)
dtp_lin_legW_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                    const T* __restrict__ w, int d_w, const T* __restrict__ G, int d_out,
                    const int* __restrict__ n_edges_ptr, int E, const int* __restrict__ gk,
                    int n_gk, const int* __restrict__ terms, const float* __restrict__ coeffs,
                    float* __restrict__ part, int w_numel, int cols_pad_max, int fs_max,
                    int span_max, const T* __restrict__ h, int hd, const T* __restrict__ Wl,
                    int n_loc) {
  extern __shared__ float4 smem4[];
  float* s_gt = reinterpret_cast<float*>(smem4);
  float* s_z = s_gt + kTile * cols_pad_max;  // offsets multiples of 16 floats: float4 rows
  float* s_w = s_z + kTile * fs_max;         // kRad: [kTile, span] of the current group
  float* s_h = s_w + kTile * span_max;       // kRad: [kTile, hd]

  const int tid = threadIdx.x;
  const int n_edges = __ldg(n_edges_ptr);
  const int n_tiles = (E + kTile - 1) / kTile;
  float* my_part = part + (long long)blockIdx.x * w_numel;

  for (int i = tid; i < w_numel; i += kThreads) my_part[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int n_live = max(0, min(min(kTile, E - e0), n_edges - e0));
    if (n_live == 0) continue;  // past the real edges: nothing to dW
    if constexpr (kRad) {
      eqt::load_h<kTile, kThreads>(s_h, h, hd, e0, n_live);
      __syncthreads();  // build_w reads s_h
    }

    for (int q = 0; q < n_gk; ++q) {
      const int* g = gk + q * kGkFields;
      const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
      const int t_begin = g[4], t_end = g[5], cp = g[7];
      const int span = g[9];

      if constexpr (kRad)
        if (g[10]) eqt::build_w<kTile, kThreads>(s_w, s_h, hd, Wl, n_loc, g[8], span, n_live);

      // ---- stage G[g,k] (zero rows past the real edges, zero pad columns)
      for (int i = tid; i < kTile * cp; i += kThreads) {
        const int r = i / cp;
        const int c = i - r * cp;
        float v = 0.f;
        if (r < n_live && c < cols) v = to_f(G[(long long)(e0 + r) * d_out + out_col + c]);
        s_gt[i] = v;
      }
      for (int i = tid; i < kTile * fs; i += kThreads) s_z[i] = 0.f;
      __syncthreads();

      // ---- recompute z[g,k] from the term table (rows >= n_live stay zero)
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4], bl = tt[5];
        const float c = coeffs[t];
        for (int i = tid; i < n_live * mul; i += kThreads) {
          const int r = i / mul;
          const int u = i - r * mul;
          const long long e = e0 + r;
          float v = c * to_f(sh[e * d_sh + col]) * to_f(x[e * sx + a + u]);
          if constexpr (kRad) {
            v *= s_w[r * span + bl + u];
          } else if (w != nullptr) {
            v *= to_f(w[e * d_w + b + u]);
          }
          s_z[r * fs + fc + u] += v;
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
            const float4 zq = *reinterpret_cast<const float4*>(s_z + r * fs + f);
            const float gv = s_gt[r * cp + j];
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
      __syncthreads();  // G and z are overwritten by the next (g, k)
    }
  }
}

template <typename T, bool kRad>
int launch(const void* x, long long sx, const void* sh, int d_sh, const void* w, int d_w,
           const void* G, int d_out, const void* n_edges, int E, const void* gk, int n_gk,
           const void* terms, const void* coeffs, void* part, int n_parts, void* dW,
           int w_numel, int cols_pad_max, int fs_max, int span_max, const void* h, int hd,
           const void* Wl, int n_loc, cudaStream_t stream) {
  const int smem = smem_floats(cols_pad_max, fs_max, span_max, hd) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_legW_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dtp_lin_legW_kernel<T, kRad><<<n_parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      d_w, static_cast<const T*>(G), d_out, static_cast<const int*>(n_edges), E,
      static_cast<const int*>(gk), n_gk, static_cast<const int*>(terms),
      static_cast<const float*>(coeffs), static_cast<float*>(part), w_numel, cols_pad_max,
      fs_max, span_max, static_cast<const T*>(h), hd, static_cast<const T*>(Wl), n_loc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW = the blocks' partial rows summed in block order
  return (int)eqt::sum_partial_rows(static_cast<const float*>(part), n_parts, w_numel,
                                    static_cast<float*>(dW), stream);
}

template <typename T, bool kRad>
int occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_legW_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dtp_lin_legW_kernel<T, kRad>,
                                                      kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// K7-LW: the head-weight leg of dtp_lin_rad_fwd, h [E, hd] and Wl [hd + 1,
// n_loc] (columns in the tables' local order) in place of w; span_max the
// widest group's w columns.
extern "C" int dtp_lin_rad_legW(const void* x, long long sx, const void* sh, int d_sh,
                                const void* G, int d_out, const void* n_edges, int E,
                                const void* gk, int n_gk, const void* terms, const void* coeffs,
                                void* part, int n_parts, void* dW, int w_numel,
                                int cols_pad_max, int fs_max, int span_max, const void* h,
                                int hd, const void* Wl, int n_loc, int dtype, void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || n_parts < 1 || hd <= 0 || hd % 4 != 0 ||
      h == nullptr || Wl == nullptr)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, true>(x, sx, sh, d_sh, nullptr, 0, G, d_out, n_edges, E, gk, n_gk,
                               terms, coeffs, part, n_parts, dW, w_numel, cols_pad_max, fs_max,
                               span_max, h, hd, Wl, n_loc, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, sx, sh, d_sh, nullptr, 0, G, d_out, n_edges, E, gk,
                                       n_gk, terms, coeffs, part, n_parts, dW, w_numel,
                                       cols_pad_max, fs_max, span_max, h, hd, Wl, n_loc, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of K7-LW at the shared memory of a launch with these
// widths (hd > 0), or minus a cudaError_t.
extern "C" int dtp_lin_legW_occupancy(int cols_pad_max, int fs_max, int span_max, int hd,
                                      int dtype) {
  const int smem = smem_floats(cols_pad_max, fs_max, span_max, hd) * (int)sizeof(float);
  if (hd <= 0) return -(int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32) return occupancy<float, true>(smem);
  if (dtype == eqt::kBFloat16) return occupancy<__nv_bfloat16, true>(smem);
  return -(int)cudaErrorInvalidValue;
}
