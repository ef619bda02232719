// Fused depthwise tensor product + per-irrep linear heads, forward (K1).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_pallas.py, _fwd_kernel (built by
// make_fused_dtp_lin / fwd_call).  Plan, term tables and weight packing:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.k1_tables).
//
// What it computes, per edge e and irrep group g, component k:
//   z[g,k][fc+u] = sum over the (g,k) terms of c * sh[e,col] * x[e,a+u] * w[e,b+u]
//   out[e, out_col(g,k) + c] = sum_f z[g,k][f] * W_g[f, c]
// with w absent (taken as 1) when shared weights were folded into W_g.
// Rows e >= *n_edges are written as zeros.
//
// What bounds it on the card.  At the flagship's sep_act site (fans
// 224 / 384 / 352, 352 / 64 / 32 columns) the head products are 208,896
// multiply-adds an edge against ~8.6 KB of operands read and written: by
// the table's rates (67 TFLOP/s fp32, 989 bf16) fp32 is bound by
// operations (0.22 ms at QM9) and bf16 by bytes (0.044 ms).  What held the
// first design back was neither: each of its 8 warps read all of W_g from
// L1 / L2 for 4 edges, four scalar loads per 16 CUDA-core FMAs a lane
// (~6.9 GB through L1 / L2 a QM9 call), and its z walk divided an index
// and read x, sh and w from device memory once per term.  Measured on the
// first design at QM9 sep_act on an H100 80GB HBM3 at 700 W (fp32 / bf16,
// 2.24 / 1.75 ms): with the product cut 0.60 / 0.63 ms remain, with the z
// walk cut 1.18 / 0.88.
//
// Design: a block of 8 warps per (edge tile, irrep group): groups write
// disjoint output columns, so the blocks are independent and each builds
// only its own group's z (MD17's 184 16-edge tiles make 736 blocks).
// - The block stages the tile's x (16-byte loads; one row for a
//   row-broadcast x) and sh (fp32) in shared memory.
// - Per component k it writes z[g,k] [tile, fan] to shared memory in the
//   compute dtype (bf16 z is what the plain version rounds to): one run per
//   fan block (its fan columns, its w block and the terms of its TP path,
//   DTPLinPlan.k1_tables), each element (row, 4 consecutive u) owned by one
//   thread that sums the run's terms in registers and scales by w (read
//   once, 16 / 8 bytes a lane, from device memory) before one store.  Rows
//   follow from the element index by a shift (mul / 4 is a power of two at
//   every site); rows past the real edges are written as zeros.
// - Then out = z[g,k] W_g on the tensor cores (mma.sync m16n8k16): M = the
//   tile's edges, K = the fan (zero-padded to 16), N = the group's columns
//   (padded to 8).  Warp i takes the column n-tiles i, i + 8, ..., four at
//   a time, across all the tile's m-tiles, so each W element is read once
//   per block and component, from W_g packed in B-fragment order by the
//   wrapper (one 16-byte (fp32) or 8-byte (bf16) load a lane and K step);
//   a group with fewer (m-tile, n-tile) pairs than warps (QM9's 2e: 32
//   columns) gives a warp one pair, so that no warp idles.  bf16 takes
//   bf16 operands with fp32 accumulators; fp32 must stay within 1e-4 of the
//   plain version, which plain TF32 misses, so it splits each operand into
//   tf32 hi + lo and sums three products (3xTF32, as K2), splitting by
//   masking bits (eqt::mma::split_tf32_mask) rather than by conversions,
//   whose throughput held the product back.  On an H100 80GB HBM3 at 700 W
//   the fp32 QM9 sep_act call takes 0.95 ms, 1.09 without the pairs and
//   1.04 with conversions.
// - The edge tile is 32 in fp32 (two m-tiles share each B fragment's split:
//   1.01 ms at QM9 sep_act with 16) where two blocks fit an SM and the grid
//   fills the card's two blocks an SM at least 4 times; else 16: MD17's
//   864-wide fp32 x tile and its 2944 edges (92 32-edge tiles are 1.4
//   waves), and bf16, whose product is cheap and whose twice as many blocks
//   run faster (QM9 sep_act 0.49 ms against 0.54).  The wrapper picks it
//   (kernels/dtp_lin.py k1_tile); 64 would hold one block an SM at QM9 fp32
//   (x alone 123 KB).
// No atomics: every output element has one writer, and the same inputs
// give the same bits.
//
// The radial-folded variant (K7-F, dtp_lin_fwd_kernel<T, kRad = true>;
// replaces the radial branch of _fwd_kernel, dtp_lin_pallas.py:604-611 with
// _radial_w_fill :482) is still the first K1 design, kept instruction for
// instruction until its own redesign; its kRad = false paths are no longer
// instantiated.  It reads the radial hidden activation h [E, hd] in place
// of w and builds each irrep group's w columns in shared memory before the
// group's first component (csrc/radial.cuh), so w [E, d_w] never goes to
// device memory.  It walks DTPLinPlan.bwd_tables (12 ints per (g, k), 6
// per term: the group's w span and each term's local w column).  Shared
// memory per block: z [32, fs_max], w [32, span_max] and h [32, hd] in
// fp32, 106 KB at the QM9 sites (2 blocks per SM), 180 KB at MD17 L3 (1
// block per SM).  One block of 256 threads per tile of 32 edges builds
// z[g,k] in shared memory (a term maps flat index i to (row, u) by i /
// mul) and multiplies it by W_g on the CUDA cores, each warp owning 4 edges
// and each lane 2 columns per pass.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "radial.cuh"

namespace {

using eqt::from_f;
using eqt::to_f;

constexpr int kTile = 32;                      // edges per block
constexpr int kThreads = 256;                  // 8 warps
constexpr int kRows = kTile / (kThreads / 32); // edges per warp in the product
constexpr int kColsPerLane = 2;
constexpr int kColChunk = 32 * kColsPerLane;   // columns per pass of a warp
// ints per (g, k) table entry and per term: the first K1's (kRad = false, no
// longer instantiated), or with the fold DTPLinPlan.bwd_tables (fan stride,
// cols, out col, W offset, term range, ...; the group's w span at 8-10; per
// term a_off, sh col, b_off, fan col, mul, and its local w column at 5)
constexpr int kGkFields = 8;
constexpr int kTermFields = 5;
constexpr int kRadGkFields = 12;
constexpr int kRadTermFields = 6;

template <typename T, bool kRad>
__global__ void __launch_bounds__(kThreads)
dtp_lin_fwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                   const T* __restrict__ w, int d_w, const T* __restrict__ W,
                   T* __restrict__ out, int d_out, const int* __restrict__ n_edges_ptr,
                   int E, const int* __restrict__ gk, int n_gk,
                   const int* __restrict__ terms, const float* __restrict__ coeffs, int fs_max,
                   const T* __restrict__ h, int hd, const T* __restrict__ Wl, int n_loc,
                   int span_max) {
  constexpr int kGk = kRad ? kRadGkFields : kGkFields;
  constexpr int kTf = kRad ? kRadTermFields : kTermFields;
  extern __shared__ float4 smem4[];
  float* z = reinterpret_cast<float*>(smem4);
  float* s_w = z + kTile * fs_max;        // kRad: [kTile, span] of the current group
  float* s_h = s_w + kTile * span_max;    // kRad: [kTile, hd]
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);  // rows of this tile inside [0, E)
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));  // real edges

  if (n_live == 0) {
    for (int i = tid; i < n_rows * d_out; i += kThreads) {
      const int r = i / d_out;
      out[(long long)(e0 + r) * d_out + (i - r * d_out)] = from_f<T>(0.f);
    }
    return;
  }
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;
  if constexpr (kRad) {
    eqt::load_h<kTile, kThreads>(s_h, h, hd, e0, n_live);
    __syncthreads();
  }

  for (int q = 0; q < n_gk; ++q) {
    const int* g = gk + q * kGk;
    const int fs = g[0], cols = g[1], out_col = g[2], w_off = g[3];
    const int t_begin = g[4], t_end = g[5];
    int span = 0;
    if constexpr (kRad) {
      span = g[9];
      if (g[10])  // the group's first component: build its w columns
        eqt::build_w<kTile, kThreads>(s_w, s_h, hd, Wl, n_loc, g[8], span, n_live);
    }

    for (int i = tid; i < kTile * fs; i += kThreads) z[i] = 0.f;
    __syncthreads();

    // ---- z[g,k] from the term table (rows >= n_live stay zero)
    for (int t = t_begin; t < t_end; ++t) {
      const int* tt = terms + t * kTf;
      const int a = tt[0], col = tt[1], b = tt[2], fc = tt[3], mul = tt[4];
      const float c = coeffs[t];
      for (int i = tid; i < n_live * mul; i += kThreads) {
        const int r = i / mul;
        const int u = i - r * mul;
        const long long e = e0 + r;
        float v = c * to_f(sh[e * d_sh + col]) * to_f(x[e * sx + a + u]);
        if constexpr (kRad) {
          v *= s_w[r * span + tt[5] + u];
        } else {
          if (w != nullptr) v *= to_f(w[e * d_w + b + u]);
        }
        z[r * fs + fc + u] += v;
      }
    }
    __syncthreads();

    // ---- out tile = z[g,k] @ W_g
    const T* Wg = W + w_off;
    for (int c0 = 0; c0 < cols; c0 += kColChunk) {
      float acc[kRows][kColsPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) acc[r][j] = 0.f;

      for (int f = 0; f < fs; f += 4) {
        float4 zq[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          zq[r] = *reinterpret_cast<const float4*>(z + (r0 + r) * fs + f);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < cols) {
            const T* wp = Wg + (long long)f * cols + c;
            const float w0 = to_f(wp[0]);
            const float w1 = to_f(wp[cols]);
            const float w2 = to_f(wp[2 * cols]);
            const float w3 = to_f(wp[3 * cols]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float s = acc[r][j];
              s = fmaf(zq[r].x, w0, s);
              s = fmaf(zq[r].y, w1, s);
              s = fmaf(zq[r].z, w2, s);
              s = fmaf(zq[r].w, w3, s);
              acc[r][j] = s;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = r0 + r;
        if (row >= n_rows) continue;
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < cols)
            out[(long long)(e0 + row) * d_out + out_col + c] = from_f<T>(acc[r][j]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kRad>
int launch(const void* x, long long sx, const void* sh, const void* w, const void* W,
           void* out, const void* n_edges, int E, int d_sh, int d_w, int d_out,
           const void* gk, int n_gk, const void* terms, const void* coeffs, int max_fs,
           const void* h, int hd, const void* Wl, int n_loc, int span_max,
           cudaStream_t stream) {
  const int smem = kTile * (max_fs + (kRad ? span_max + hd : 0)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dtp_lin_fwd_kernel<T, kRad>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (E + kTile - 1) / kTile;
  dtp_lin_fwd_kernel<T, kRad><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(sh), d_sh,
      static_cast<const T*>(w), d_w, static_cast<const T*>(W), static_cast<T*>(out), d_out,
      static_cast<const int*>(n_edges), E, static_cast<const int*>(gk), n_gk,
      static_cast<const int*>(terms), static_cast<const float*>(coeffs), max_fs,
      static_cast<const T*>(h), hd, static_cast<const T*>(Wl), n_loc, kRad ? span_max : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// K7-F: the forward with w = [h, 1] @ Wl built in the kernel.  gk / terms are
// DTPLinPlan.bwd_tables'; Wl [hd + 1, n_loc] is [Wr; offset] with its columns
// in the tables' local (dwmap) order.
extern "C" int dtp_lin_rad_fwd(const void* x, long long sx, const void* sh, const void* W,
                               void* out, const void* n_edges, int E, int d_sh, int d_out,
                               const void* gk, int n_gk, const void* terms, const void* coeffs,
                               int max_fs, const void* h, int hd, const void* Wl, int n_loc,
                               int span_max, int dtype, void* stream) {
  if (max_fs % 4 != 0 || hd % 4 != 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch<float, true>(x, sx, sh, nullptr, W, out, n_edges, E, d_sh, 0, d_out, gk,
                               n_gk, terms, coeffs, max_fs, h, hd, Wl, n_loc, span_max, s);
  if (dtype == eqt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, sx, sh, nullptr, W, out, n_edges, E, d_sh, 0, d_out,
                                       gk, n_gk, terms, coeffs, max_fs, h, hd, Wl, n_loc,
                                       span_max, s);
  return (int)cudaErrorInvalidValue;
}

// ======================================================================
// K1: dtp_lin_fwd (design in the header note)
// ======================================================================
namespace k1 {

using namespace eqt::mma;
using eqt::from_f;
using eqt::to_f;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;          // column n-tiles (8 wide) a warp holds at once
constexpr int kGkFields = 8;    // DTPLinPlan.k1_tables gk: fan16, cols, out col, packed-W
                                // offset, run range, n-tiles, fan
constexpr int kRunFields = 5;   // fan col, mul, w col, term range
constexpr int kTermFields = 5;  // DTPLinPlan.device_tables terms: a_off, sh col, b_off, fan col, mul
constexpr int kRowPad = 8;      // staged x rows: multiples of 8 elements (16 bytes in bf16)

// z's row stride in elements, so that a warp's A-fragment loads hit 32
// distinct banks: 8 words mod 32 in fp32 (float2 a lane), 4 in bf16 (a word)
template <typename T>
__host__ __device__ inline int ld_z(int fz_max) {
  return sizeof(T) == 4 ? stride_mod(fz_max, 32, 8) : stride_mod(fz_max, 64, 8);
}

// byte offsets of the shared memory: x (dtype), sh (fp32), z (dtype)
struct Layout {
  int x, sh, z, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int tile, int d_x, int d_sh, int fz_max, bool x_rows) {
  Layout l;
  l.x = 0;
  l.sh = l.x + align16((x_rows ? tile : 1) * round_up(d_x, kRowPad) * (int)sizeof(T));
  l.z = l.sh + align16(tile * d_sh * 4);
  l.total = l.z + align16(tile * ld_z<T>(fz_max) * (int)sizeof(T));
  return l;
}

// V consecutive elements as fp32: one load of 4 (16 bytes fp32, 8 bf16), or one
template <typename T, int V, bool kGlobal>
__device__ __forceinline__ void load_v(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(kGlobal ? __ldg(p) : p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "4 fp32 a load");
    const float4 q = kGlobal ? __ldg(reinterpret_cast<const float4*>(p))
                             : *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    static_assert(V == 4, "4 bf16 a load");
    const uint2 q = kGlobal ? __ldg(reinterpret_cast<const uint2*>(p))
                            : *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f(t[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 q;
    q.x = pack_bf16(v[0], v[1]);
    q.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  }
}

// columns j, j + 1 of one output row (j even); a pair store when both lie
// inside the group's columns and the row's element offset is even
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ o, float a, float b, int j, int cols,
                                           bool pair) {
  if (pair && j + 1 < cols) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(o) = make_float2(a, b);
    } else {
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
    }
  } else {
    if (j < cols) o[0] = from_f<T>(a);
    if (j + 1 < cols) o[1] = from_f<T>(b);
  }
}

// out[rows of the m-tiles m0 .. m0 + kMW - 1, columns of the n-tiles nt0 +
// i nt_step, i < n_mine] = z W_g on the tensor cores, in a warp: per K step
// of 16 fan columns the A fragments from z in shared memory, the B
// fragments from W_g packed in fragment order (Wg: the group's block),
// one 16-byte (fp32) or 8-byte (bf16) load a lane and n-tile.  Rows at or
// past n_rows are not written (those past the real edges hold zeros: z's
// rows are).
template <typename T, int kMW>
__device__ __forceinline__ void head_product(const T* __restrict__ s_z, int ldz,
                                             const T* __restrict__ Wg, int n_ks, int m0, int nt0,
                                             int nt_step, int n_mine, int lane,
                                             T* __restrict__ out, int d_out, int n_rows,
                                             int cols, bool pair) {
  const int gq = lane >> 2, q = lane & 3;
  float acc[kMW][kNT][4];
#pragma unroll
  for (int m = 0; m < kMW; ++m)
#pragma unroll
    for (int i = 0; i < kNT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
  const T* wp = Wg + ((long long)nt0 * n_ks * 32 + lane) * 4;
  const long long step = (long long)nt_step * n_ks * 32 * 4;  // the warp's next n-tile
  for (int ks = 0; ks < n_ks; ++ks) {
    const int c0 = ks * 16 + 2 * q;
    const T* wk = wp + ks * 32 * 4;
    if constexpr (sizeof(T) == 4) {
      float a[kMW][2][4];
#pragma unroll
      for (int m = 0; m < kMW; ++m)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* zr = s_z + ((m0 + m) * 16 + gq) * ldz + c0 + 8 * s;
          const float2 lo = *reinterpret_cast<const float2*>(zr);
          const float2 hi = *reinterpret_cast<const float2*>(zr + 8 * ldz);
          a[m][s][0] = lo.x;
          a[m][s][1] = hi.x;
          a[m][s][2] = lo.y;
          a[m][s][3] = hi.y;
        }
      float b[kNT][2][2];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        if (i < n_mine) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(wk + i * step));
          b[i][0][0] = v.x;
          b[i][0][1] = v.y;
          b[i][1][0] = v.z;
          b[i][1][1] = v.w;
        }
      mma16mn_tf32<kMW, kNT>(acc, a, b, n_mine);
    } else {
      const uint32_t* z32 = reinterpret_cast<const uint32_t*>(s_z);
      uint32_t a[kMW][4];
#pragma unroll
      for (int m = 0; m < kMW; ++m) {
        const int o = ((m0 + m) * 16 + gq) * ldz + c0;
        a[m][0] = z32[o / 2];
        a[m][1] = z32[(o + 8 * ldz) / 2];
        a[m][2] = z32[(o + 8) / 2];
        a[m][3] = z32[(o + 8 * ldz + 8) / 2];
      }
      uint2 v[kNT];
#pragma unroll
      for (int i = 0; i < kNT; ++i)
        if (i < n_mine) v[i] = __ldg(reinterpret_cast<const uint2*>(wk + i * step));
#pragma unroll
      for (int m = 0; m < kMW; ++m)
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          if (i < n_mine) mma_bf16(acc[m][i], a[m], v[i].x, v[i].y);
    }
  }
#pragma unroll
  for (int m = 0; m < kMW; ++m)
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      if (i >= n_mine) continue;
      const int j = (nt0 + i * nt_step) * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (m0 + m) * 16 + gq + 8 * h;
        if (row < n_rows)
          store_pair<T>(out + (long long)row * d_out + j, acc[m][i][2 * h], acc[m][i][2 * h + 1],
                        j, cols, pair);
      }
    }
}

// Block (edge tile of 16 kM edges, irrep group blockIdx.y): x and sh
// staged, then per component z[g,k] in shared memory and out = z W_g on
// the tensor cores.  V: the u elements a thread of the z walk takes at once
// (4, or 1 where the tables' offsets are not multiples of 4).
template <typename T, int kM, int V>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh, int d_sh,
           const T* __restrict__ w, int d_w, const T* __restrict__ Wp, T* __restrict__ out,
           int d_out, const int* __restrict__ n_edges_ptr, int E, const int* __restrict__ gk,
           const int* __restrict__ groups, const int* __restrict__ runs,
           const int* __restrict__ terms, const float* __restrict__ coeffs, int fz_max) {
  constexpr int kTile = 16 * kM;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = layout<T>(kTile, d_x, d_sh, fz_max, sx != 0);
  T* s_x = reinterpret_cast<T*>(smem + L.x);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  T* s_z = reinterpret_cast<T*>(smem + L.z);
  const int dxs = round_up(d_x, kRowPad), ldz = ld_z<T>(fz_max);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));
  const int q0 = __ldg(groups + 2 * blockIdx.y), n_comp = __ldg(groups + 2 * blockIdx.y + 1);

  if (n_live == 0) {  // past the real edges: the group's columns of the tile are zero
    for (int k = 0; k < n_comp; ++k) {
      const int* gr = gk + (q0 + k) * kGkFields;
      const int cols = __ldg(gr + 1), out_col = __ldg(gr + 2);
      for (int i = tid; i < n_rows * cols; i += kThreads) {
        const int r = i / cols;
        out[(long long)(e0 + r) * d_out + out_col + (i - r * cols)] = from_f<T>(0.f);
      }
    }
    return;
  }

  // ---- the tile's x (16-byte loads; one row for a row-broadcast x), sh in
  // fp32, and z's pad columns [fan, fan16), zero for every component
  copy_rows<T, kThreads>(s_x, dxs, x + (long long)e0 * sx, sx, sx ? n_live : 1, d_x,
                         d_x % kVec<T> == 0 && sx % kVec<T> == 0 && aligned16(x));
  for (int i = tid; i < n_live * d_sh; i += kThreads)
    s_sh[i] = to_f(sh[(long long)e0 * d_sh + i]);
  {
    const int fan = __ldg(gk + q0 * kGkFields + 7), np = __ldg(gk + q0 * kGkFields) - fan;
    for (int i = tid; i < kTile * np; i += kThreads) {
      const int r = i / np;
      s_z[r * ldz + fan + (i - r * np)] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  for (int k = 0; k < n_comp; ++k) {
    const int* gr = gk + (q0 + k) * kGkFields;
    const int f16 = __ldg(gr), cols = __ldg(gr + 1), out_col = __ldg(gr + 2);
    const int wp_off = __ldg(gr + 3), run_begin = __ldg(gr + 4), run_end = __ldg(gr + 5);
    const int n_nt = __ldg(gr + 6);

    // ---- z[g,k]: a run (one fan block) at a time; element (row, u..u+V-1)
    // by one thread, its terms summed in registers, times w, one store
    for (int ri = run_begin; ri < run_end; ++ri) {
      const int* rn = runs + ri * kRunFields;
      const int fc = __ldg(rn), nv = __ldg(rn + 1) / V, b = __ldg(rn + 2);
      const int t_begin = __ldg(rn + 3), t_end = __ldg(rn + 4);
      const bool pow2 = (nv & (nv - 1)) == 0;
      const int lg = __ffs(nv) - 1;
      for (int i = tid; i < kTile * nv; i += kThreads) {
        const int r = pow2 ? i >> lg : i / nv;
        const int u = (i - r * nv) * V;
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
        if (r < n_live) {
          const T* xr = s_x + (sx ? r : 0) * dxs + u;
          const float* shr = s_sh + r * d_sh;
          for (int t = t_begin; t < t_end; ++t) {
            const int* tt = terms + t * kTermFields;
            const float c = __ldg(coeffs + t) * shr[__ldg(tt + 1)];
            float xv[V];
            load_v<T, V, false>(xr + __ldg(tt), xv);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(c, xv[j], acc[j]);
          }
          if (w != nullptr) {
            float wv[V];
            load_v<T, V, true>(w + (long long)(e0 + r) * d_w + b + u, wv);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] *= wv[j];
          }
        }
        store_v<T, V>(s_z + r * ldz + fc + u, acc);
      }
    }
    __syncthreads();

    // ---- out[:, out_col + j] = z[g,k] W_g: warp i takes the n-tiles i, i +
    // 8, ..., kNT at a time, over all the tile's m-tiles; where the group has
    // fewer (m-tile, n-tile) pairs than warps, a warp takes one pair
    const int n_ks = f16 / 16;
    const bool pair = ((d_out | out_col) & 1) == 0;
    T* o = out + (long long)e0 * d_out + out_col;
    if (n_nt * kM <= kWarps) {
      if (warp < n_nt * kM)
        head_product<T, 1>(s_z, ldz, Wp + wp_off, n_ks, warp / n_nt, warp % n_nt, 1, 1, lane, o,
                           d_out, n_rows, cols, pair);
    } else {
      for (int nt0 = warp; nt0 < n_nt; nt0 += kWarps * kNT)
        head_product<T, kM>(s_z, ldz, Wp + wp_off, n_ks, 0, nt0, kWarps,
                            min(kNT, (n_nt - nt0 + kWarps - 1) / kWarps), lane, o, d_out,
                            n_rows, cols, pair);
    }
    __syncthreads();  // z is rewritten by the next component
  }
}

struct Args {
  const void *x, *sh, *w, *Wp, *n_edges, *gk, *groups, *runs, *terms, *coeffs;
  long long sx;
  int d_x, d_sh, d_w, d_out, E, n_groups, fz_max;
  void* out;
};

template <typename T, int kM, int V>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kTile = 16 * kM;
  const Layout L = layout<T>(kTile, a.d_x, a.d_sh, a.fz_max, a.sx != 0);
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, kM, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.E + kTile - 1) / kTile, a.n_groups);
  fwd_kernel<T, kM, V><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(a.x), a.sx, a.d_x, static_cast<const T*>(a.sh), a.d_sh,
      static_cast<const T*>(a.w), a.d_w, static_cast<const T*>(a.Wp), static_cast<T*>(a.out),
      a.d_out, static_cast<const int*>(a.n_edges), a.E, static_cast<const int*>(a.gk),
      static_cast<const int*>(a.groups), static_cast<const int*>(a.runs),
      static_cast<const int*>(a.terms), static_cast<const float*>(a.coeffs), a.fz_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(int tile, int vec, const Args& a, cudaStream_t s) {
  if (tile == 32 && vec == 4) return launch<T, 2, 4>(a, s);
  if (tile == 32 && vec == 1) return launch<T, 2, 1>(a, s);
  if (tile == 16 && vec == 4) return launch<T, 1, 4>(a, s);
  if (tile == 16 && vec == 1) return launch<T, 1, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace k1

// K1: out [E, d_out] for x [E, d_x] (row stride sx: 0 or d_x), sh, w [E,
// d_w] (null with shared weights folded into W) and Wp, each group's W_g
// in mma B-fragment order (DTPLinPlan.k1_tables' wp_index); gk [n_gk, 8]
// per (g, k), groups [n_groups, 2] (first gk row, components), runs [n_runs,
// 5], terms / coeffs of DTPLinPlan.device_tables; fz_max the widest fan
// padded to 16; tile 32 or 16 edges a block; vec 4 or 1 (k1_tables' vec).
extern "C" int dtp_lin_fwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                           const void* w, int d_w, const void* Wp, void* out, int d_out,
                           const void* n_edges, int E, const void* gk, const void* groups,
                           int n_groups, const void* runs, const void* terms,
                           const void* coeffs, int fz_max, int tile, int vec, int dtype,
                           void* stream) {
  if (fz_max % 16 != 0 || n_groups < 1) return (int)cudaErrorInvalidValue;
  const k1::Args a{x,      sh, w,    Wp,  n_edges, gk,       groups, runs,   terms,
                   coeffs, sx, d_x, d_sh, d_w,    d_out, E, n_groups, fz_max, out};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return k1::launch_tile<float>(tile, vec, a, s);
  if (dtype == eqt::kBFloat16) return k1::launch_tile<__nv_bfloat16>(tile, vec, a, s);
  return (int)cudaErrorInvalidValue;
}
