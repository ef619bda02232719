// The bodies of the depthwise tensor product's sparse trilinear primitives
// T and R (K6), shared by csrc/dtp_t.cu, csrc/dtp_fused_bwd.cu, csrc/dtp_r.cu
// (through csrc/dtp_fb.cuh) and S1-A in csrc/dtp_t_variants.cu.  Term lists
// and tables: equiformer_tpu_torch/kernels/dtp.py (TermList.t_plan, fb_plan,
// r_plan).
//
// Per edge e, over the terms (c, a_off i, col_off j, b_off p, out_off o, mul):
//   T: out[e, o+u] += c * col[e, j] * a[e, i+u] * b[e, p+u]      (u < mul)
//   R: col[e, j]   += c * sum_u a[e, i+u] * b[e, p+u] * d[e, o+u]
// A lane operand read with a row stride of 0 is one row broadcast over the
// edges.  Everything accumulates in fp32 and is rounded once to the storage
// type.
//
// T is cut into output segments: each segment is one output tile (the terms
// that write columns [o, o + mul), in table order) or a run of columns that
// no term writes (an empty term range: zeros).  The host cuts each segment
// into chunks of at most 32 * V columns and lists warp items (chunk, first
// row): a warp takes one item, lane (row, q) owns the V consecutive
// columns u = q V.. of one row, with 2^lg lanes a row (lg from the chunk
// record), so 32 / 2^lg rows share a warp and no element needs a division.
// The lane sums the chunk's terms in table order,
//   acc = fmaf((c * col[j]) * a[i+u], b[p+u], acc)   from acc = 0,
// so every element has one writer and is the same bits on every run and
// for any grid the host picks; V = 4 reads a and b with one 8- or 16-byte
// load a term and writes out with one store.  A term is one 16-byte record
// (a_off, col_off, b_off, coeff), read once a term by the whole warp (a
// broadcast).  R is summed from the chunks of T's b <-> out permutation,
// whose lanes each hold one column of b (csrc/dtp_fb.cuh).  No atomics
// anywhere.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace eqt {
namespace dtp {

constexpr int kTile = 32;              // edges per K6-T block
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCol = 64;            // widest col operand (SH up to l = 7)
constexpr int kMaxGridY = 65535;

__host__ __device__ constexpr long long align16(long long n) { return (n + 15) & ~15LL; }

// n elements from src to dst (dst 16-byte aligned): cp.async by 16 bytes
// where src and n allow (the caller waits), else loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long long n) {
  if (((uintptr_t)src & 15) == 0 && (n * sizeof(T)) % 16 == 0) {
    const long long n16 = n * sizeof(T) / 16;
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    for (long long i = threadIdx.x; i < n16; i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + (unsigned)(i * 16)),
                   "l"(reinterpret_cast<const uint4*>(src) + i));
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  }
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// V consecutive elements at p as fp32 (p aligned to V elements).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// A chunk record (int4): x output column, y width | lg << 8 | du << 11 (du
// the chunk's column within its segment, added to the terms' a and b
// offsets), z, w the segment's term range.  An item (int): chunk << 8 |
// first row.
struct Lane {
  int row;  // row within the edge tile
  int u;    // column within the chunk (a multiple of V)
  bool live;
};

template <int V>
__device__ __forceinline__ Lane item_lane(int row0, int y) {
  const int lg = (y >> 8) & 7;
  const int q = threadIdx.x & ((1 << lg) - 1);
  Lane l;
  l.row = row0 + ((threadIdx.x & 31) >> lg);
  l.u = q * V;
  l.live = l.u < (y & 255);
  return l;
}

// One lane's V elements of a T chunk: ar, br point at the lane's first
// column of a's and b's row (shared or global memory), cr at its col row
// (fp32), orow at its output.
template <int V, typename TA, typename TB, typename TO>
__device__ __forceinline__ void t_lane(const TA* ar, const TB* br, const float* cr,
                                       const int4* __restrict__ terms, int t_begin, int t_end,
                                       TO* orow) {
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int4 tt = __ldg(terms + t);
    const float cc = __int_as_float(tt.w) * cr[tt.y];
    float av[V], bv[V];
    load_vec<V>(ar + tt.x, av);
    load_vec<V>(br + tt.z, bv);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(cc * av[v], bv[v], acc[v]);
  }
  store_vec<V>(orow, acc);
}

// Launches `kernel` with a block of kThreads per `tile` edges and `bytes`
// of dynamic shared memory, raising the kernel's limit past the default 48 KB once where it
// must (`allowed`: the instantiation's limit so far).
template <typename K, typename... Args>
int launch_tiles(K kernel, long long& allowed, long long bytes, int E, int tile,
              cudaStream_t stream, Args... args) {
  if (bytes > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not the next launch's error
      return (int)err;
    }
    allowed = bytes;
  }
  kernel<<<(E + tile - 1) / tile, kThreads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dtp
}  // namespace eqt
