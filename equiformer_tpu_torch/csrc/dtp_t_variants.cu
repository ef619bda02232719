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
// S1-A, dtp_t_staged: T itself on K6-T's chunks and term records
// (TermList.chunks), each output element summed in K6-T's table order, so
// the dense layout gives K6-T's bits.
// Replaces: scripts/kbench.py, aligned_kernel (aligned_call, both
// layouts): stage the edge tile once, then compute.  A block takes `tile`
// edges (2-4: the staged_tile of kernels/dtp_t_variants.py, several blocks
// an SM), copies their a and b rows into shared memory once with cp.async
// and their col rows as fp32, then its 8 warps take the tile's warp items
// (chunk, first row) and run K6-T's lane (csrc/dtp_tr.cuh, t_lane) with a
// and b read from shared memory, where K6-T reads them through L1 / L2 from
// global memory (csrc/dtp_t.cu): the pair measures what staging a and b
// buys.  The chunk table sets the output layout: K6-T's chunks for the
// dense z, or each chunk at its tile's 128-column slot with chunks of no
// terms writing the slots' zero padding (kbench's aligned output); the
// TPU's 128-lane alignment of the staged rows is not carried over.  What
// bounds it: bytes (K6-T's, see csrc/dtp_t.cu).

#include <stdint.h>
#include <string.h>

#include "dtp_tr.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kThreads = 256;
constexpr int kLead = 128;        // S1-F: the columns of x and w that reach out
constexpr int kFloorRows = 16;    // S1-F: edges per block

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

// S1-A's shared memory: a rows, b rows, col rows (fp32).
__host__ __device__ inline long long staged_bytes(int tile, int size, int d_a, int d_b,
                                                  int d_col, long long* b_off,
                                                  long long* col_off) {
  *b_off = eqt::dtp::align16((long long)tile * d_a * size);
  *col_off = *b_off + eqt::dtp::align16((long long)tile * d_b * size);
  return *col_off + (long long)tile * d_col * 4;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dtp_t_staged_kernel(const T* __restrict__ a, int d_a, const T* __restrict__ col, int d_col,
                    const T* __restrict__ b, int d_b, T* __restrict__ out, int d_out, int E,
                    int tile, const int4* __restrict__ chunks, const int4* __restrict__ terms,
                    const int* __restrict__ items, int n_items) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long b_off, col_off;
  staged_bytes(tile, sizeof(T), d_a, d_b, d_col, &b_off, &col_off);
  T* s_a = reinterpret_cast<T*>(smem);
  T* s_b = reinterpret_cast<T*>(smem + b_off);
  float* s_col = reinterpret_cast<float*>(smem + col_off);
  const int e0 = blockIdx.x * tile;
  const int n_rows = min(tile, E - e0);
  eqt::dtp::stage(s_a, a + (long long)e0 * d_a, (long long)n_rows * d_a);
  eqt::dtp::stage(s_b, b + (long long)e0 * d_b, (long long)n_rows * d_b);
  for (int i = threadIdx.x; i < n_rows * d_col; i += kThreads)
    s_col[i] = to_f(col[(long long)e0 * d_col + i]);
  eqt::dtp::stage_wait();
  __syncthreads();
  for (int it = threadIdx.x >> 5; it < n_items; it += kThreads / 32) {
    const int item = __ldg(items + it);
    const int4 ch = __ldg(chunks + (item >> 8));
    const eqt::dtp::Lane l = eqt::dtp::item_lane<V>(item & 255, ch.y);
    if (!l.live || l.row >= n_rows) continue;
    const int u = (ch.y >> 11) + l.u;
    eqt::dtp::t_lane<V>(s_a + l.row * d_a + u, s_b + l.row * d_b + u, s_col + l.row * d_col,
                        terms, ch.z, ch.w, out + (long long)(e0 + l.row) * d_out + ch.x + l.u);
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

template <typename T, int V>
int launch_staged(const void* a, int d_a, const void* col, int d_col, const void* b, int d_b,
                  void* out, int d_out, int E, int tile, const void* chunks, const void* terms,
                  const void* items, int n_items, cudaStream_t stream) {
  static long long allowed = 48 << 10;  // this instantiation's dynamic shared memory limit
  long long b_off, col_off;
  const long long bytes = staged_bytes(tile, sizeof(T), d_a, d_b, d_col, &b_off, &col_off);
  return eqt::dtp::launch_tiles(
      dtp_t_staged_kernel<T, V>, allowed, bytes, E, tile, stream, static_cast<const T*>(a), d_a,
      static_cast<const T*>(col), d_col, static_cast<const T*>(b), d_b, static_cast<T*>(out),
      d_out, E, tile, static_cast<const int4*>(chunks), static_cast<const int4*>(terms),
      static_cast<const int*>(items), n_items);
}

template <typename T>
int launch_staged_vec(int vec, const void* a, int d_a, const void* col, int d_col, const void* b,
                      int d_b, void* out, int d_out, int E, int tile, const void* chunks,
                      const void* terms, const void* items, int n_items, cudaStream_t s) {
  if (vec == 4)
    return launch_staged<T, 4>(a, d_a, col, d_col, b, d_b, out, d_out, E, tile, chunks, terms,
                               items, n_items, s);
  if (vec == 1)
    return launch_staged<T, 1>(a, d_a, col, d_col, b, d_b, out, d_out, E, tile, chunks, terms,
                               items, n_items, s);
  return (int)cudaErrorInvalidValue;
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
// out [E, d_out]; the edge tile (at most 255 rows); chunks [n, 4], terms
// [n_t, 4] (K6-T's records) and items [n_items] (chunk << 8 | first row)
// from kernels/dtp_t_variants.py (staged_plan: K6-T's chunks for the dense
// z, or laid out in 128-column slots); vec 4 or 1.
extern "C" int dtp_t_staged(const void* a, int d_a, const void* col, int d_col, const void* b,
                            int d_b, void* out, int d_out, int E, int tile, const void* chunks,
                            const void* terms, const void* items, int n_items, int vec,
                            int dtype, void* stream) {
  if (E < 1 || tile < 1 || tile > 255 || n_items < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_staged_vec<float>(vec, a, d_a, col, d_col, b, d_b, out, d_out, E, tile, chunks,
                                    terms, items, n_items, s);
  if (dtype == eqt::kBFloat16)
    return launch_staged_vec<__nv_bfloat16>(vec, a, d_a, col, d_col, b, d_b, out, d_out, E, tile,
                                            chunks, terms, items, n_items, s);
  return (int)cudaErrorInvalidValue;
}
