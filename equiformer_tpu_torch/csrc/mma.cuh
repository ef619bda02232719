// Shared pieces of the kernels that run their products on the tensor cores
// with mma.sync (K2, csrc/dtp_lin_bwd.cu; K1, csrc/dtp_lin.cu): the fragment
// products in bf16 (m16n8k16) and in fp32 as 3xTF32 (two m16n8k8 halves),
// a [16, K] tile in shared memory times a B packed in fragment order (the
// radial fold's w build and dh product), and 16-byte staging of rows into
// shared memory.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace eqt {
namespace mma {

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // elements in a 16-byte load

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
// the least stride >= n that is r modulo m
__host__ __device__ inline int stride_mod(int n, int m, int r) { return n + ((r - n % m) + m) % m; }

// ---------------------------------------------------------------- mma
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both tf32: hi*hi + hi*lo + lo*hi keeps ~fp32's accuracy (3xTF32)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One K = 16 step of C[i][16 x 8] += A[16 x 16] B_i[16 x 8] for the n-tiles
// i < n (n <= kN, warp-uniform) sharing one A, with fp32 fragments.  Lane
// (g, q) = (lane / 4, lane % 4) holds, for s = 0, 1 and k_s = 2q + 8s,
//   a[s]    = {A[g][k_s], A[g + 8][k_s], A[g][k_s + 1], A[g + 8][k_s + 1]},
//   b[i][s] = {B_i[k_s][g], B_i[k_s + 1][g]};
// that is m16n8k16's bf16 layout, and for tf32 the two m16n8k8 halves with
// their k permuted the same way in A and B (a sum over k does not see the
// order).  bf16: the operands rounded to bf16, one mma per n-tile.  fp32:
// 3xTF32, A split once; each kind of product (lo * hi, hi * lo, hi * hi)
// is issued across the n-tiles in turn, so the mma's that share an
// accumulator are n apart.
template <typename T, int kN>
__device__ __forceinline__ void mma16n(float (&c)[kN][4], const float (&a)[2][4],
                                       const float (&b)[kN][2][2], int n) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ah[4], al[4], bh[kN][2], bl[kN][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(a[s][j], ah[j], al[j]);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) {
          split_tf32(b[i][s][0], bh[i][0], bl[i][0]);
          split_tf32(b[i][s][1], bh[i][1], bl[i][1]);
        }
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[i], al, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[i], ah, bh[i][0], bh[i][1]);
    }
  } else {
    const uint32_t A[4] = {pack_bf16(a[0][0], a[0][2]), pack_bf16(a[0][1], a[0][3]),
                           pack_bf16(a[1][0], a[1][2]), pack_bf16(a[1][1], a[1][3])};
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (i < n)
        mma_bf16(c[i], A, pack_bf16(b[i][0][0], b[i][0][1]), pack_bf16(b[i][1][0], b[i][1][1]));
  }
}

// v = hi + lo with hi, lo tf32 by masking: hi keeps v's top 19 bits (its
// tf32 truncation), lo = v - hi is exact in fp32 and is truncated to tf32
// in turn.  Two integer ops and a subtraction where split_tf32 takes two
// conversions (cvt.rna.tf32.f32), on whose throughput K1's fp32 product
// waited (0.95 ms at QM9 sep_act against 1.04); hi*hi + hi*lo + lo*hi then
// misses v's value by < 2^-20 relative.
__device__ __forceinline__ void split_tf32_mask(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// mma16n for kM m-tiles that share the n-tiles' B fragments, fp32 only
// (3xTF32 with the masking split; bf16 callers issue mma_bf16 on their
// packed fragments): A is split once per m-tile, B once per n-tile, and
// each kind of product runs over all (m, n) pairs in turn.
template <int kM, int kN>
__device__ __forceinline__ void mma16mn_tf32(float (&c)[kM][kN][4], const float (&a)[kM][2][4],
                                             const float (&b)[kN][2][2], int n) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t ah[kM][4], al[kM][4], bh[kN][2], bl[kN][2];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32_mask(a[m][s][j], ah[m][j], al[m][j]);
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (i < n) {
        split_tf32_mask(b[i][s][0], bh[i][0], bl[i][0]);
        split_tf32_mask(b[i][s][1], bh[i][1], bl[i][1]);
      }
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[m][i], al[m], bh[i][0], bh[i][1]);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[m][i], ah[m], bl[i][0], bl[i][1]);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (i < n) mma_tf32(c[m][i], ah[m], bh[i][0], bh[i][1]);
  }
}

// -------------------------------------------- tiles in shared memory
// the A fragment (m16n8k16 layout, fp32 values) of rows [0, 16) and K step
// at column c0 = 16 ks + 2q of a row-major tile in shared memory (row stride
// ld, even): a[s] = {A[g][k], A[g + 8][k], A[g][k + 1], A[g + 8][k + 1]}, k =
// c0 + 8s
template <typename TA>
__device__ __forceinline__ void load_a(float (&a)[2][4], const TA* s_a, int ld, int c0, int gq) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const TA* lo = s_a + gq * ld + c0 + 8 * s;
    const TA* hi = lo + 8 * ld;
    if constexpr (sizeof(TA) == 4) {
      const float2 l = *reinterpret_cast<const float2*>(lo);
      const float2 h = *reinterpret_cast<const float2*>(hi);
      a[s][0] = l.x;
      a[s][1] = h.x;
      a[s][2] = l.y;
      a[s][3] = h.y;
    } else {
      const float2 l = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lo));
      const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi));
      a[s][0] = l.x;
      a[s][1] = h.x;
      a[s][2] = l.y;
      a[s][3] = h.y;
    }
  }
}

// a lane's B fragment of one (n-tile, K step) packed in fragment order
// (b_fragment_index): 16 bytes in fp32, 8 in bf16, read through L2
template <typename T>
__device__ __forceinline__ void load_b(float (&b)[2][2], const T* __restrict__ p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    b[0][0] = v.x;
    b[0][1] = v.y;
    b[1][0] = v.z;
    b[1][1] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    b[0][0] = lo.x;
    b[0][1] = lo.y;
    b[1][0] = hi.x;
    b[1][1] = hi.y;
  }
}

// one K step of C[i] += A B_i for the n-tiles i < n: bf16 operands, or fp32
// as 3xTF32 split by masking
template <typename T, int kN>
__device__ __forceinline__ void mma_fold(float (&c)[kN][4], const float (&a)[2][4],
                                         const float (&b)[kN][2][2], int n) {
  if constexpr (sizeof(T) == 4)
    mma16mn_tf32<1, kN>(reinterpret_cast<float (&)[1][kN][4]>(c),
                        reinterpret_cast<const float (&)[1][2][4]>(a), b, n);
  else
    mma16n<T, kN>(c, a, b, n);
}

// out[16, n-tiles nt0 + i * step (i < n)] = A[16, K] B over n_ks K steps:
// A a row-major tile in shared memory (row stride ld), B packed in fragment
// order with ks_ld K steps an n-tile
template <typename T, int kN, typename TA>
__device__ __forceinline__ void mma_tile(float (&acc)[kN][4], const TA* s_a, int ld,
                                         const T* __restrict__ Bp, int n_ks, int ks_ld, int nt0,
                                         int step, int n, int lane) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < n_ks; ++ks) {
    float a[2][4], b[kN][2][2];
    load_a(a, s_a, ld, ks * 16 + 2 * (lane & 3), lane >> 2);
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (i < n) load_b(b[i], Bp + ((long long)((nt0 + i * step) * ks_ld + ks) * 32 + lane) * 4);
    mma_fold<T, kN>(acc, a, b, n);
  }
}

// ------------------------------------------------------ 16-byte staging
template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return ((uintptr_t)p & 15) == 0;
}

// dst[r * ld_dst + c] = src[r * ld_src + c] (src row stride 0: one row), r <
// rows, c < n, dtype T on both sides; 16 bytes a thread when vec
template <typename T, int kThreads>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, int ld_dst,
                                          const T* __restrict__ src, long long ld_src, int rows,
                                          int n, bool vec) {
  if (vec) {
    const int nv = n / kVec<T>;
    for (int i = threadIdx.x; i < rows * nv; i += kThreads) {
      const int r = i / nv;
      const int c = (i - r * nv) * kVec<T>;
      *reinterpret_cast<uint4*>(dst + r * ld_dst + c) =
          __ldg(reinterpret_cast<const uint4*>(src + r * ld_src + c));
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += kThreads) {
      const int r = i / n;
      const int c = i - r * n;
      dst[r * ld_dst + c] = src[r * ld_src + c];
    }
  }
}

}  // namespace mma
}  // namespace eqt
