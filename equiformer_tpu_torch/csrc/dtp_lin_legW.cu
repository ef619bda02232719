// Fused depthwise tensor product + per-irrep linear heads: the head-weight
// leg (K5c), dW alone.
//
// Replaces: equiformer_tpu/kernels/dtp_lin_ho.py, _W_leg_kernel (built by
// _leg_call for the leg W; bound through _legW_p by the transpose of the out
// leg in the parameter pass of force training, and by the JVP of _bwd3_p in
// its grad-of-grad).  Plan, term tables and weight packing:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.bwd_tables), the
// tables of csrc/dtp_lin_bwd.cu.
//
// What it computes, with G in the out leg of out = Linear_W(DTP(x, sh, w)),
// over the edges e < *n_edges:
//   z[g,k][fc+u] = sum over the (g,k) terms of c * sh[e,col] * x[e,a+u] * w[e,b+u]
//   dW_g[f, j]  += sum_k z[g,k][f] * G[e, out_col(g,k) + j]        (fp32)
// in the packed layout of W ([fan_stride, cols] per group, pad rows zero).
// With shared weights folded into W_g there is no w (taken as 1).  z is
// recomputed from the operands and never written to device memory.  Tiles
// past *n_edges are skipped.
//
// What bounds it on the card: arithmetic.  Per real edge of the MD17 L3
// sep_act site the z^T G product is ~0.6M multiply-adds and the z recompute
// ~32k, against ~6 KB of operands read.
//
// Design: csrc/dtp_lin_bwd.cu without dx, dw and dz.  Persistent blocks of
// 256 threads, each walking edge tiles of 16 (tile t = blockIdx.x + i *
// gridDim.x).  Per tile and (g, k) the block stages the slice G[g,k]
// (16 x cols) in shared memory, recomputes z[g,k] there from the term table
// (within one (g, k) a z element is only ever touched by one thread: a term
// maps flat index i to (row, u) by i / mul, and terms that share a column
// share mul), and adds z^T G into the block's own fp32 partial of dW in
// device memory, a thread owning 4 fan rows of one column.  dW is a
// reduction across all edges: each block keeps its own partial row, and
// eqt::sum_partial_rows (common.cuh, shared with K2) sums the rows in a
// fixed order, so there are no float atomics and the result does not
// depend on the schedule.  Everything accumulates in fp32 on the CUDA
// cores; tensor cores are later work.

#include <stdint.h>

#include "common.cuh"

namespace {

using eqt::to_f;

constexpr int kTile = 16;       // edges per tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kGkFields = 12;   // ints per (g, k) table entry
constexpr int kTermFields = 6;  // a_off, sh col, b_off, fan col, mul, local dw col

// fp32 shared memory: G [kTile, cols_pad_max], z [kTile, fs_max]
__host__ __device__ inline int smem_floats(int cols_pad_max, int fs_max) {
  return kTile * (cols_pad_max + fs_max);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_lin_legW_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                    const T* __restrict__ w, int d_w, const T* __restrict__ G, int d_out,
                    const int* __restrict__ n_edges_ptr, int E, const int* __restrict__ gk,
                    int n_gk, const int* __restrict__ terms, const float* __restrict__ coeffs,
                    float* __restrict__ part, int w_numel, int cols_pad_max) {
  extern __shared__ float4 smem4[];
  float* s_gt = reinterpret_cast<float*>(smem4);
  float* s_z = s_gt + kTile * cols_pad_max;  // offset a multiple of 16 floats: float4 rows

  const int tid = threadIdx.x;
  const int n_edges = __ldg(n_edges_ptr);
  const int n_tiles = (E + kTile - 1) / kTile;
  float* my_part = part + (long long)blockIdx.x * w_numel;

  for (int i = tid; i < w_numel; i += kThreads) my_part[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * kTile;
    const int n_live = max(0, min(min(kTile, E - e0), n_edges - e0));
    if (n_live == 0) continue;  // past the real edges: nothing to dW

    for (int q = 0; q < n_gk; ++q) {
      const int* g = gk + q * kGkFields;
      const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
      const int t_begin = g[4], t_end = g[5], cp = g[7];

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
        const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4];
        const float c = coeffs[t];
        for (int i = tid; i < n_live * mul; i += kThreads) {
          const int r = i / mul;
          const int u = i - r * mul;
          const long long e = e0 + r;
          float v = c * to_f(sh[e * d_sh + col]) * to_f(x[e * sx + a + u]);
          if (w != nullptr) v *= to_f(w[e * d_w + b + u]);
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

template <typename T>
int launch(const void* x, long long sx, const void* sh, int d_sh, const void* w, int d_w,
           const void* G, int d_out, const void* n_edges, int E, const void* gk, int n_gk,
           const void* terms, const void* coeffs, void* part, int n_parts, void* dW,
           int w_numel, int cols_pad_max, int fs_max, cudaStream_t stream) {
  const int smem = smem_floats(cols_pad_max, fs_max) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_legW_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dtp_lin_legW_kernel<T><<<n_parts, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      d_w, static_cast<const T*>(G), d_out, static_cast<const int*>(n_edges), E,
      static_cast<const int*>(gk), n_gk, static_cast<const int*>(terms),
      static_cast<const float*>(coeffs), static_cast<float*>(part), w_numel, cols_pad_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW = the blocks' partial rows summed in block order
  return (int)eqt::sum_partial_rows(static_cast<const float*>(part), n_parts, w_numel,
                                    static_cast<float*>(dW), stream);
}

template <typename T>
int occupancy(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_legW_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dtp_lin_legW_kernel<T>,
                                                      kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// n_parts blocks (at most the number of tiles) each own one fp32 partial row
// of part [n_parts, w_numel]; dW [w_numel] fp32 receives their sum.
extern "C" int dtp_lin_legW(const void* x, long long sx, const void* sh, int d_sh,
                            const void* w, int d_w, const void* G, int d_out,
                            const void* n_edges, int E, const void* gk, int n_gk,
                            const void* terms, const void* coeffs, void* part, int n_parts,
                            void* dW, int w_numel, int cols_pad_max, int fs_max, int dtype,
                            void* stream) {
  if (fs_max % 4 != 0 || cols_pad_max % 4 != 0 || n_parts < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float>(x, sx, sh, d_sh, w, d_w, G, d_out, n_edges, E, gk, n_gk, terms,
                         coeffs, part, n_parts, dW, w_numel, cols_pad_max, fs_max, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16>(x, sx, sh, d_sh, w, d_w, G, d_out, n_edges, E, gk, n_gk,
                                 terms, coeffs, part, n_parts, dW, w_numel, cols_pad_max,
                                 fs_max, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM at the shared memory of a launch with these widths,
// or minus a cudaError_t.
extern "C" int dtp_lin_legW_occupancy(int cols_pad_max, int fs_max, int dtype) {
  const int smem = smem_floats(cols_pad_max, fs_max) * (int)sizeof(float);
  if (dtype == eqt::kFloat32) return occupancy<float>(smem);
  if (dtype == eqt::kBFloat16) return occupancy<__nv_bfloat16>(smem);
  return -(int)cudaErrorInvalidValue;
}
