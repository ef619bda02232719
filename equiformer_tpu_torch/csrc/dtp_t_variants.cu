// Two variants of the depthwise tensor product's primitive T (K6-T), for
// measuring K6-T against what its shapes allow (S1; the tool
// equiformer_tpu_torch/tools/kbench.py, wrappers and plain versions in
// equiformer_tpu_torch/kernels/dtp_t_variants.py).
//
// S1-F, dtp_t_floor: K6-T's byte floor.  out [E, d_out] is zero except
//   out[e, :128] = (x[e, :128] + sh[e, 0]) + w[e, :128]
// Replaces: scripts/kbench.py, dma_kernel (dma_call).  On the TPU the
// BlockSpecs move whole x / sh / w tiles whatever the body reads; a CUDA
// kernel moves only what it loads, so this one loads every element of x,
// sh and w once (16-byte loads where the row width allows, neighbouring
// threads on neighbouring addresses) and stores every element of out once.
// To keep the loads live it ORs "is NaN" over every loaded value; a tile
// whose inputs hold a NaN writes NaN everywhere.  For inputs without a NaN
// (finite ones among them) the output is exactly the function above.
// What bounds it: bytes, by construction: its time is K6-T's floor at
// these shapes.
//
// S1-A, dtp_t_staged: T itself, on the term tables of K6-T (TermList's
//   out[e, o+u] = sum over the terms of output segment o of
//                 c * col[e, j] * a[e, i+u] * b[e, p+u]
// in the same order, so the dense layout gives K6-T's bits).
// Replaces: scripts/kbench.py, aligned_kernel (aligned_call, both
// layouts): stage the edge tile once, then compute.  A block takes kRows
// edges, copies their a, b and col rows into shared memory once (16-byte
// copies), and writes every output segment of the tile from there, where
// K6-T's grid of (tile, segment) blocks re-reads a and b from L2 for each
// segment (csrc/dtp_t.cu).  The segment table sets the output layout: the
// dense z, or z in 128-column slots with zero padding (kbench's aligned
// output); the TPU's 128-lane alignment of the staged rows is not carried
// over.  What bounds it: bytes (K6-T's, see csrc/dtp_t.cu); shared memory
// is kRows * (d_a + d_b) elements plus the col rows, 92 KB fp32 at the
// flagship's widths: two blocks per SM.

#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 256;
constexpr int kLead = 128;        // S1-F: the columns of x and w that reach out
constexpr int kFloorRows = 16;    // S1-F: edges per block
constexpr int kRows = 16;         // S1-A: edges per block
constexpr int kSegFields = 4;     // output column, width, term begin, term end
constexpr int kTermFields = 5;    // a_off, col_off, b_off, out_off, mul

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // elements in 16 bytes
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// Loads rows x d elements starting at p (row-major, contiguous) once each;
// the first kLead columns of each row land in lead [rows, kLead] as fp32.
// Returns whether this thread saw a NaN.
template <typename T>
__device__ __forceinline__ bool floor_scan(const T* __restrict__ p, int rows, int d,
                                           float* __restrict__ lead) {
  constexpr int V = Vec<T>::n;
  bool nan = false;
  if (d % V == 0) {  // the wrapper guarantees 16-byte aligned rows then
    const int per_row = d / V;
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row;
      const int cv = i - r * per_row;
      const uint4 raw = pv[i];
      T v[V];
      memcpy(v, &raw, sizeof(raw));
#pragma unroll
      for (int j = 0; j < V; ++j) nan |= is_nan(to_f(v[j]));
      if (cv * V < kLead)
#pragma unroll
        for (int j = 0; j < V; ++j) lead[r * kLead + cv * V + j] = to_f(v[j]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * d; i += kThreads) {
      const int r = i / d;
      const int col = i - r * d;
      const float v = to_f(p[i]);
      nan |= is_nan(v);
      if (col < kLead) lead[r * kLead + col] = v;
    }
  }
  return nan;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_t_floor_kernel(const T* __restrict__ x, int d_x, const T* __restrict__ sh, int d_sh,
                   const T* __restrict__ w, int d_w, T* __restrict__ out, int d_out, int E) {
  __shared__ float s_x[kFloorRows * kLead];
  __shared__ float s_w[kFloorRows * kLead];
  __shared__ float s_sh[kFloorRows];
  const long long e0 = (long long)blockIdx.x * kFloorRows;
  const int rows = min((long long)kFloorRows, E - e0);

  bool nan = floor_scan<T>(x + e0 * d_x, rows, d_x, s_x);
  nan |= floor_scan<T>(w + e0 * d_w, rows, d_w, s_w);
  for (int i = threadIdx.x; i < rows * d_sh; i += kThreads) {
    const float v = to_f(sh[e0 * d_sh + i]);
    nan |= is_nan(v);
    if (i % d_sh == 0) s_sh[i / d_sh] = v;
  }
  const bool poisoned = __syncthreads_or(nan);  // also publishes s_x, s_w, s_sh
  const float fill = poisoned ? __int_as_float(0x7fc00000) : 0.f;  // quiet NaN

  auto value = [&](int r, int col) -> T {
    if (col >= kLead || poisoned) return from_f<T>(fill);
    // JAX's order, each sum rounded to the storage type: (x + sh) + w
    const float xs = to_f(from_f<T>(s_x[r * kLead + col] + s_sh[r]));
    return from_f<T>(xs + s_w[r * kLead + col]);
  };
  constexpr int V = Vec<T>::n;
  T* o = out + e0 * d_out;
  if (d_out % V == 0) {
    const int per_row = d_out / V;
    uint4* ov = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row;
      const int c0 = (i - r * per_row) * V;
      T v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = value(r, c0 + j);
      uint4 raw;
      memcpy(&raw, v, sizeof(raw));
      ov[i] = raw;
    }
  } else {
    for (int i = threadIdx.x; i < rows * d_out; i += kThreads) {
      const int r = i / d_out;
      o[i] = value(r, i - r * d_out);
    }
  }
}

// Copies n elements of T from global p to shared s (both 16-byte aligned).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ p, T* __restrict__ s, int n) {
  constexpr int V = Vec<T>::n;
  const int nv = n / V;
  const uint4* pv = reinterpret_cast<const uint4*>(p);
  uint4* sv = reinterpret_cast<uint4*>(s);
  for (int i = threadIdx.x; i < nv; i += kThreads) sv[i] = pv[i];
  for (int i = nv * V + threadIdx.x; i < n; i += kThreads) s[i] = p[i];
}

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
__host__ __device__ inline int staged_smem(int d_a, int d_col, int d_b) {
  return round16(kRows * d_col * (int)sizeof(float)) + round16(kRows * d_a * (int)sizeof(T)) +
         round16(kRows * d_b * (int)sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dtp_t_staged_kernel(const T* __restrict__ a, int d_a, const T* __restrict__ col, int d_col,
                    const T* __restrict__ b, int d_b, T* __restrict__ out, int d_out, int E,
                    const int* __restrict__ segs, int n_seg, const int* __restrict__ terms,
                    const float* __restrict__ coeffs) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* s_col = reinterpret_cast<float*>(base);
  T* s_a = reinterpret_cast<T*>(base + round16(kRows * d_col * (int)sizeof(float)));
  T* s_b = reinterpret_cast<T*>(reinterpret_cast<char*>(s_a) + round16(kRows * d_a * (int)sizeof(T)));

  const long long e0 = (long long)blockIdx.x * kRows;
  const int rows = min((long long)kRows, E - e0);
  stage<T>(a + e0 * d_a, s_a, rows * d_a);
  stage<T>(b + e0 * d_b, s_b, rows * d_b);
  for (int i = threadIdx.x; i < rows * d_col; i += kThreads) s_col[i] = to_f(col[e0 * d_col + i]);
  __syncthreads();

  for (int s = 0; s < n_seg; ++s) {
    const int* seg = segs + s * kSegFields;
    const int o = seg[0], width = seg[1], t_begin = seg[2], t_end = seg[3];
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width;
      const int u = i - r * width;
      const float* cr = s_col + r * d_col;
      const T* ar = s_a + r * d_a + u;
      const T* br = s_b + r * d_b + u;
      float acc = 0.f;
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        acc = fmaf(coeffs[t] * cr[tt[1]] * to_f(ar[tt[0]]), to_f(br[tt[2]]), acc);
      }
      out[(e0 + r) * d_out + o + u] = from_f<T>(acc);
    }
  }
}

template <typename T>
int launch_floor(const void* x, int d_x, const void* sh, int d_sh, const void* w, int d_w,
                 void* out, int d_out, int E, cudaStream_t stream) {
  const int blocks = (E + kFloorRows - 1) / kFloorRows;
  dtp_t_floor_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), d_x, static_cast<const T*>(sh), d_sh, static_cast<const T*>(w),
      d_w, static_cast<T*>(out), d_out, E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const void* a, int d_a, const void* col, int d_col, const void* b, int d_b,
                  void* out, int d_out, int E, const void* segs, int n_seg, const void* terms,
                  const void* coeffs, cudaStream_t stream) {
  const int smem = staged_smem<T>(d_a, d_col, d_b);
  cudaError_t err = cudaFuncSetAttribute(dtp_t_staged_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (E + kRows - 1) / kRows;
  dtp_t_staged_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), d_a, static_cast<const T*>(col), d_col,
      static_cast<const T*>(b), d_b, static_cast<T*>(out), d_out, E,
      static_cast<const int*>(segs), n_seg, static_cast<const int*>(terms),
      static_cast<const float*>(coeffs));
  return (int)cudaGetLastError();
}

}  // namespace

// x [E, d_x], sh [E, d_sh], w [E, d_w], out [E, d_out], contiguous and
// 16-byte aligned; d_x, d_w and d_out at least 128.
extern "C" int dtp_t_floor(const void* x, int d_x, const void* sh, int d_sh, const void* w,
                           int d_w, void* out, int d_out, int E, int dtype, void* stream) {
  if (d_x < kLead || d_w < kLead || d_out < kLead || d_sh < 1 || E < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_floor<float>(x, d_x, sh, d_sh, w, d_w, out, d_out, E, s);
  if (dtype == eqt::kBFloat16)
    return launch_floor<__nv_bfloat16>(x, d_x, sh, d_sh, w, d_w, out, d_out, E, s);
  return (int)cudaErrorInvalidValue;
}

// a [E, d_a], col [E, d_col], b [E, d_b] contiguous and 16-byte aligned,
// out [E, d_out]; segs [n_seg, 4], terms [n, 5], coeffs [n] from
// kernels/dtp_t_variants.py (K6-T's tables, the segments laid out densely
// or in 128-column slots).
extern "C" int dtp_t_staged(const void* a, int d_a, const void* col, int d_col, const void* b,
                            int d_b, void* out, int d_out, int E, const void* segs, int n_seg,
                            const void* terms, const void* coeffs, int dtype, void* stream) {
  if (E < 1 || n_seg < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_staged<float>(a, d_a, col, d_col, b, d_b, out, d_out, E, segs, n_seg, terms,
                                coeffs, s);
  if (dtype == eqt::kBFloat16)
    return launch_staged<__nv_bfloat16>(a, d_a, col, d_col, b, d_b, out, d_out, E, segs, n_seg,
                                        terms, coeffs, s);
  return (int)cudaErrorInvalidValue;
}
