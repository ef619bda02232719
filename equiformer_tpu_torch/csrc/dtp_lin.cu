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
// The radial fold (K7-F, dtp_lin_rad_fwd; replaces the radial branch of
// _fwd_kernel, dtp_lin_pallas.py:604-611 with _radial_w_fill :482) is K1's
// block with w built on chip: its operand is the radial MLP's last hidden
// activation h [E, hd] and w = [h, 1] @ [Wr; offset].  Every w column feeds
// one irrep group, and a group's fan column f is its local w column
// (DTPLinPlan.k7_tables checks it), so a block builds only its group's w:
// it stages h [tile, hd] in the dtype, and before the first component w_g
// [tile, span] = h Wr_g + offset_g on mma.sync into shared memory, rounded
// to the dtype as the plain version rounds it (Wr_g packed in B-fragment
// order and the offsets in local order by the wrapper's one gather,
// DTPLinPlan.k1_tables(fold=True)); the runs then read w there at their fan
// column instead of device memory.  The z walk and the head product are
// K1's.  Shared memory grows by the h and w tiles, so kernels/dtp_lin.py
// (k1_tile, k1_x_global) keeps two blocks an SM: at QM9 sep_act in fp32 the
// 16-edge tile (86 KB; the 32-edge tile's 172 KB, one block an SM, took
// 1.45 ms against 1.02 on an H100 80GB HBM3 at 700 W), and at MD17 L3 in
// fp32, where the 16-edge tile is 145 KB with x staged, x read through L2
// (kXg: 91 KB; 0.33 ms against 0.48 staged).  The first design (one block
// of 8 warps per 32-edge tile walking every (group, component), z W_g and
// the w build on the CUDA cores) took 3.10 / 2.50 ms fp32 / bf16 at QM9
// sep_act and 1.63 / 1.66 at MD17 L3 sep_act, this one 1.02 / 0.61 and 0.33
// / 0.18.
//
// The kron route's forward (K8-F, dtp_lin_kron_fwd; replaces
// equiformer_tpu/kernels/dtp_lin_kron.py, _fwd_kernel :191 with _fill_kop
// :179 and _pair_val :167, built by fwd_call :385) is K1's function on
// other tables: per (g, k)
//   out[e, out_col(g,k) + c] = sum_r Kop[e, r] G[r, c],
//   Kop[e, r] = sh[e, col_r] x[e, xi_r] w[e, wi_r]    (no w with a shared w in G),
// which is K1's with each (g, k) a group of one component whose fan is its
// Kop rows, each CG triple a run of one term of coefficient 1, and its block
// of G the head weight (KronMeta.k1_tables; G packed in B-fragment order by
// one gather a call).  What bounds it: 2 operations per G element and real
// edge (453,632 elements at the QM9 flagship's sep_act, 2.17x K1's product),
// so fp32 by operations (0.452 ms at QM9 sep_act), bf16 by bytes (0.044).
// What K1's block does not cover is G's size: every edge tile reads all of G
// from L2 (1.8 MB in fp32), 2272 x 1.8 MB a call with 16-edge tiles.  So
// k1::kron_fwd_kernel is K1's product on a 64-edge tile: a block per (tile,
// (g, k), chunk of 128 columns) builds Kop 32 rows at a time (the row
// table, each Kop row's x / sh / w column and coefficient, made from the
// runs in shared memory; x, sh and w read a quad of rows at a time through
// L2) into one of two shared slices while the other slice goes through
// the tensor cores (mma.sync; bf16 operands, fp32 as 3xTF32 split by
// masking), and keeps out = Kop G in registers over the K walk: four
// m-tiles share each B fragment, so G crosses L2 once per 64 edges.  A
// chunk of 5-16 n-tiles gives a warp all four m-tiles and n-tiles w, w + 8;
// of 3-4, two m-tiles and one n-tile; of 1-2, one of each.  Rows past the
// real edges get a zero Kop, so a zero out.  On an H100 80GB HBM3 at 700 W
// (wrapper, device time) at QM9 sep_act it took 1.40-1.41 / 0.96-0.98 ms
// fp32 / bf16, against 2.18-2.23 / 0.99-1.00 for K1's block unchanged on
// the same tables (16-edge tiles, Kop [16, 896] in shared memory) and
// 2.76-2.77 / 2.93-2.99 for the first design (csrc/dtp_lin_kron.cu: 64-edge
// tiles, the product on the fp32 CUDA cores); K1 on the same inputs 0.94 /
// 0.49.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// byte offsets of the shared memory: x (dtype), sh (fp32), z (dtype); with
// the fold (hd > 0) also h [tile, ld_z(hd16)] and w [tile, ld_z(span_max8)]
// (dtype), and with x_global no x (read through L2)
struct Layout {
  int x, sh, z, h, w, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int tile, int d_x, int d_sh, int fz_max, bool x_rows,
                                         int hd = 0, int span_max = 0, bool x_global = false) {
  Layout l;
  l.x = 0;
  l.sh = l.x + (x_global ? 0
                         : align16((x_rows ? tile : 1) * round_up(d_x, kRowPad) * (int)sizeof(T)));
  l.z = l.sh + align16(tile * d_sh * 4);
  l.h = l.z + align16(tile * ld_z<T>(fz_max) * (int)sizeof(T));
  l.w = l.h + (hd ? align16(tile * ld_z<T>(round_up(hd, 16)) * (int)sizeof(T)) : 0);
  l.total = l.w + (hd ? align16(tile * ld_z<T>(round_up(span_max, 8)) * (int)sizeof(T)) : 0);
  return l;
}

// the fold's operands of a block (K7-F): h [E, hd], the packed Wr and the
// offsets (pk: each group's Wr in B-fragment order, K = hd, N = its span,
// and the offsets in local column order), and per group rg [n_groups, 3]:
// the offsets in pk of its packing and of its offsets, its span
struct RadF {
  const void* h;
  int hd;
  const void* pk;
  const int* rg;
  int span_max;
};

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

#define EQT_K1_PARAMS                                                                            \
  const T *__restrict__ x, long long sx, int d_x, const T *__restrict__ sh, int d_sh,            \
      const T *__restrict__ w, int d_w, const T *__restrict__ Wp, T *__restrict__ out,           \
      int d_out, const int *__restrict__ n_edges_ptr, int E, const int *__restrict__ gk,         \
      const int *__restrict__ groups, const int *__restrict__ runs,                              \
      const int *__restrict__ terms, const float *__restrict__ coeffs, int fz_max
#define EQT_K1_ARGS \
  x, sx, d_x, sh, d_sh, w, d_w, Wp, out, d_out, n_edges_ptr, E, gk, groups, runs, terms, coeffs, fz_max

// Block (edge tile of 16 kM edges, irrep group blockIdx.y): x and sh
// staged, then per component z[g,k] in shared memory and out = z W_g on
// the tensor cores.  V: the u elements a thread of the z walk takes at once
// (4, or 1 where the tables' offsets are not multiples of 4).  kRad (K7-F):
// w null, h staged and the group's w built from it in shared memory before
// the first component (the runs' w column is the group's local one); kXg:
// x read through L2 instead of staged.
template <typename T, int kM, int V, bool kRad = false, bool kXg = false>
__device__ __forceinline__ void fwd_body(EQT_K1_PARAMS, const RadF rad = {}) {
  constexpr int kTile = 16 * kM;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = layout<T>(kTile, d_x, d_sh, fz_max, sx != 0, rad.hd, rad.span_max, kXg);
  T* s_x = reinterpret_cast<T*>(smem + L.x);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  T* s_z = reinterpret_cast<T*>(smem + L.z);
  T* s_h = reinterpret_cast<T*>(smem + L.h);
  T* s_w = reinterpret_cast<T*>(smem + L.w);
  const int dxs = round_up(d_x, kRowPad), ldz = ld_z<T>(fz_max);
  const int hd = rad.hd, hd16 = round_up(hd, 16), ldh = ld_z<T>(hd16);
  const int ldw = ld_z<T>(round_up(rad.span_max, 8));

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
  if constexpr (!kXg)
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
  if constexpr (kRad) {  // the tile's h, zero past the real edges and hd
    const T* h = static_cast<const T*>(rad.h);
    for (int i = tid; i < kTile * hd16; i += kThreads) {
      const int r = i / hd16, c = i - r * hd16;
      s_h[r * ldh + c] = r < n_live && c < hd ? h[(long long)(e0 + r) * hd + c] : from_f<T>(0.f);
    }
  }
  __syncthreads();

  if constexpr (kRad) {
    // ---- w_g [tile, span] = h Wr_g + offset_g on the tensor cores, rounded
    // to the dtype: per m-tile, warp i takes the span's n-tiles i, i + 8, ...
    const int* rg = rad.rg + 3 * blockIdx.y;
    const T* pk = static_cast<const T*>(rad.pk);
    const T* Bp = pk + __ldg(rg);
    const T* off = pk + __ldg(rg + 1);
    const int span = __ldg(rg + 2), n_wt = round_up(span, 8) / 8;
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int m = 0; m < kM; ++m)
      for (int nt0 = warp; nt0 < n_wt; nt0 += kWarps * kNT) {
        const int n_mine = min(kNT, (n_wt - nt0 + kWarps - 1) / kWarps);
        float acc[kNT][4];
        mma_tile<T, kNT>(acc, s_h + m * 16 * ldh, ldh, Bp, hd16 / 16, hd16 / 16, nt0, kWarps,
                         n_mine, lane);
#pragma unroll
        for (int i = 0; i < kNT; ++i)
          if (i < n_mine)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = m * 16 + gq + 8 * (u >> 1), c = (nt0 + i * kWarps) * 8 + 2 * q + (u & 1);
              if (c < span) s_w[r * ldw + c] = from_f<T>(acc[i][u] + to_f(off[c]));
            }
      }
    __syncthreads();
  }

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
          const T* xr = kXg ? x + (long long)(e0 + r) * sx + u : s_x + (sx ? r : 0) * dxs + u;
          const float* shr = s_sh + r * d_sh;
          for (int t = t_begin; t < t_end; ++t) {
            const int* tt = terms + t * kTermFields;
            const float c = __ldg(coeffs + t) * shr[__ldg(tt + 1)];
            float xv[V];
            load_v<T, V, kXg>(xr + __ldg(tt), xv);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(c, xv[j], acc[j]);
          }
          if (kRad || w != nullptr) {
            float wv[V];
            if constexpr (kRad)
              load_v<T, V, false>(s_w + r * ldw + b + u, wv);
            else
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

// K1
template <typename T, int kM, int V>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(EQT_K1_PARAMS) {
  fwd_body<T, kM, V>(EQT_K1_ARGS);
}

// K7-F: K1 with w built from h in the block (kXg: x through L2)
template <typename T, int kM, int V, bool kXg>
__global__ void __launch_bounds__(kThreads, 2) rad_fwd_kernel(EQT_K1_PARAMS, const RadF rad) {
  fwd_body<T, kM, V, true, kXg>(EQT_K1_ARGS, rad);
}

// ------------------------------------------------------------------ K8-F
// (design in the header note) A block per (64-edge tile, (g, k), chunk of
// 128 columns): Kop is built kKronKS rows at a time into one of two shared
// slices (the next slice's x, sh and w loads in flight in registers during
// the current slice's product), and out = Kop G is held in the warps'
// registers across the K walk: four m-tiles share each B fragment (and its
// 3xTF32 split), so G crosses L2 once per 64 edges.
constexpr int kKronM = 4;        // m-tiles a block: 64 edges
constexpr int kKronKS = 32;      // Kop rows a slice: two mma K steps
constexpr int kKronCols = 128;   // output columns a block: 16 n-tiles

// byte offsets of the shared memory: sh (fp32) of the tile, the row table
// (x column, sh column, w column, coefficient bits) of the (g, k)'s Kop
// rows, two Kop slices [64, ld_z(kKronKS)] in the dtype
struct KronLayout {
  int sh, rows, kop, total;
};

template <typename T>
__host__ __device__ inline KronLayout kron_layout(int d_sh, int fz_max) {
  KronLayout l;
  l.sh = 0;
  l.rows = l.sh + align16(16 * kKronM * d_sh * 4);
  l.kop = l.rows + align16(fz_max * 16);
  l.total = l.kop + align16(2 * 16 * kKronM * ld_z<T>(kKronKS) * (int)sizeof(T));
  return l;
}

// the block's (g, k) row of gk and its column chunk: chunks of kKronCols
// columns, (g, k) after (g, k)
__device__ __forceinline__ void kron_chunk(const int* __restrict__ gk, int y, int& qi,
                                           int& chunk) {
  qi = 0;
  chunk = y;
  for (;; ++qi) {
    const int n = (__ldg(gk + qi * kGkFields + 1) + kKronCols - 1) / kKronCols;
    if (chunk < n) return;
    chunk -= n;
  }
}

// the K walk of one block: warp w takes kMW m-tiles from m0 and kN n-tiles
// (its n-tile, + 8 for kN = 2) of the chunk's n_nt; each slice's V-wide row
// quads built by the threads in turn
template <typename T, int V, int kMW, int kN>
__device__ __forceinline__ void kron_walk(const T* __restrict__ x, long long sx,
                                          const T* __restrict__ w, int d_w,
                                          const T* __restrict__ Gp, int n_ks, int nt_base,
                                          int n_nt, int n_k, int e0, int n_live, int d_sh,
                                          const float* __restrict__ s_sh,
                                          const int4* __restrict__ s_rows, T* __restrict__ s_kop,
                                          float (&acc)[kMW][kN][4]) {
  constexpr int kTile = 16 * kKronM, kQuads = kKronKS / V;
  constexpr int kItems = kTile * kQuads / kThreads;  // row quads a thread builds a slice
  static_assert(kItems * kThreads == kTile * kQuads, "slice map");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int ldk = ld_z<T>(kKronKS), slice = kTile * ldk;
  constexpr int kSlots = kKronM / kMW, kCols = kWarps / kSlots;  // m groups, n-tile lanes
  const int nt0 = warp % kCols, m0 = (warp / kCols) * kMW;
  const int n_mine = nt0 >= n_nt ? 0 : min(kN, (n_nt - nt0 + kCols - 1) / kCols);
  const int n_slices = (n_k + kKronKS - 1) / kKronKS;
#pragma unroll
  for (int m = 0; m < kMW; ++m)
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;

  // Kop[e, r .. r + V) of slice s, item it of this thread: coeff * sh * x * w
  auto load = [&](int s, float (&v)[kItems][V]) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads, e = i / kQuads, r = s * kKronKS + (i % kQuads) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) v[it][j] = 0.f;
      if (e < n_live && r < n_k) {
        const int4 rr = s_rows[r];
        const float c = __int_as_float(rr.w) * s_sh[e * d_sh + rr.y];
        float xv[V];
        load_v<T, V, true>(x + (long long)(e0 + e) * sx + rr.x, xv);
#pragma unroll
        for (int j = 0; j < V; ++j) v[it][j] = c * xv[j];
        if (w != nullptr) {
          float wv[V];
          load_v<T, V, true>(w + (long long)(e0 + e) * d_w + rr.z, wv);
#pragma unroll
          for (int j = 0; j < V; ++j) v[it][j] *= wv[j];
        }
      }
    }
  };
  auto store = [&](int buf, const float (&v)[kItems][V]) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads, e = i / kQuads, c = (i % kQuads) * V;
      store_v<T, V>(s_kop + buf * slice + e * ldk + c, v[it]);
    }
  };

  {
    float v[kItems][V];
    load(0, v);
    store(0, v);
  }
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    const bool more = s + 1 < n_slices;
    float nv[kItems][V];
    if (more) load(s + 1, nv);
    const T* sk = s_kop + (s & 1) * slice;
    if (n_mine > 0) {
#pragma unroll
      for (int kl = 0; kl < kKronKS / 16; ++kl) {
        const int ks = s * (kKronKS / 16) + kl;
        if (ks >= n_ks) break;
        const int c0 = kl * 16 + 2 * q;
        const T* bk = Gp + ((long long)((nt_base + nt0) * n_ks + ks) * 32 + lane) * 4;
        const long long step = (long long)kCols * n_ks * 32 * 4;  // the warp's next n-tile
        if constexpr (sizeof(T) == 4) {
          float a[kMW][2][4], b[kN][2][2];
#pragma unroll
          for (int m = 0; m < kMW; ++m) load_a(a[m], sk + (m0 + m) * 16 * ldk, ldk, c0, gq);
#pragma unroll
          for (int i = 0; i < kN; ++i)
            if (i < n_mine) load_b(b[i], bk + i * step);
          mma16mn_tf32<kMW, kN>(acc, a, b, n_mine);
        } else {
          const uint32_t* k32 = reinterpret_cast<const uint32_t*>(sk);
          uint32_t a[kMW][4];
#pragma unroll
          for (int m = 0; m < kMW; ++m) {
            const int o = ((m0 + m) * 16 + gq) * ldk + c0;
            a[m][0] = k32[o / 2];
            a[m][1] = k32[(o + 8 * ldk) / 2];
            a[m][2] = k32[(o + 8) / 2];
            a[m][3] = k32[(o + 8 * ldk + 8) / 2];
          }
          uint2 bv[kN];
#pragma unroll
          for (int i = 0; i < kN; ++i)
            if (i < n_mine) bv[i] = __ldg(reinterpret_cast<const uint2*>(bk + i * step));
#pragma unroll
          for (int m = 0; m < kMW; ++m)
#pragma unroll
            for (int i = 0; i < kN; ++i)
              if (i < n_mine) mma_bf16(acc[m][i], a[m], bv[i].x, bv[i].y);
        }
      }
    }
    if (more) store((s + 1) & 1, nv);
    __syncthreads();
  }
}

// out[rows of the warp's m-tiles, its n-tiles' columns of the chunk] from
// kron_walk's accumulators; rows at or past n_rows are not written
template <int kMW, int kN, typename T>
__device__ __forceinline__ void kron_store(const float (&acc)[kMW][kN][4], int n_nt,
                                           T* __restrict__ o, int d_out, int n_rows, int ncol,
                                           bool pair) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  constexpr int kSlots = kKronM / kMW, kCols = kWarps / kSlots;
  const int nt0 = warp % kCols, m0 = (warp / kCols) * kMW;
#pragma unroll
  for (int m = 0; m < kMW; ++m)
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int nt = nt0 + i * kCols;
      if (nt >= n_nt) continue;
      const int j = nt * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (m0 + m) * 16 + gq + 8 * h;
        if (row < n_rows)
          store_pair<T>(o + (long long)row * d_out + j, acc[m][i][2 * h], acc[m][i][2 * h + 1],
                        j, ncol, pair);
      }
    }
}

// K8-F: grid (64-edge tiles, the (g, k)'s column chunks)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
kron_fwd_kernel(const T* __restrict__ x, long long sx, const T* __restrict__ sh, int d_sh,
                const T* __restrict__ w, int d_w, const T* __restrict__ Wp, T* __restrict__ out,
                int d_out, const int* __restrict__ n_edges_ptr, int E,
                const int* __restrict__ gk, const int* __restrict__ runs,
                const int* __restrict__ terms, const float* __restrict__ coeffs, int fz_max) {
  constexpr int kTile = 16 * kKronM;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const KronLayout L = kron_layout<T>(d_sh, fz_max);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  int4* s_rows = reinterpret_cast<int4*>(smem + L.rows);
  T* s_kop = reinterpret_cast<T*>(smem + L.kop);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));
  int qi, chunk;
  kron_chunk(gk, blockIdx.y, qi, chunk);
  const int* gr = gk + qi * kGkFields;
  const int f16 = __ldg(gr), cols = __ldg(gr + 1), out_col = __ldg(gr + 2);
  const int wp_off = __ldg(gr + 3), run_begin = __ldg(gr + 4), run_end = __ldg(gr + 5);
  const int n_k = __ldg(gr + 7);
  const int j0 = chunk * kKronCols, ncol = min(kKronCols, cols - j0), n_nt = (ncol + 7) / 8;
  T* o = out + (long long)e0 * d_out + out_col + j0;

  if (n_live == 0) {  // past the real edges: the chunk's columns of the tile are zero
    for (int i = tid; i < n_rows * ncol; i += kThreads) {
      const int r = i / ncol;
      o[(long long)r * d_out + (i - r * ncol)] = from_f<T>(0.f);
    }
    return;
  }
  for (int i = tid; i < n_live * d_sh; i += kThreads) s_sh[i] = to_f(sh[(long long)e0 * d_sh + i]);
  for (int ri = run_begin + warp; ri < run_end; ri += kWarps) {  // each Kop row's operands
    const int* rn = runs + ri * kRunFields;
    const int fc = __ldg(rn), mul = __ldg(rn + 1), b = __ldg(rn + 2), t = __ldg(rn + 3);
    const int a = __ldg(terms + t * kTermFields), col = __ldg(terms + t * kTermFields + 1);
    const int c = __float_as_int(__ldg(coeffs + t));
    for (int u = lane; u < mul; u += 32) s_rows[fc + u] = make_int4(a + u, col, b + u, c);
  }
  __syncthreads();

  const T* Gp = Wp + wp_off;
  const bool pair = ((d_out | (out_col + j0)) & 1) == 0;
  const int n_ks = f16 / 16, nt_base = j0 / 8;
  if (n_nt > 4) {
    float acc[4][2][4];
    kron_walk<T, V, 4, 2>(x, sx, w, d_w, Gp, n_ks, nt_base, n_nt, n_k, e0, n_live, d_sh, s_sh,
                          s_rows, s_kop, acc);
    kron_store<4, 2>(acc, n_nt, o, d_out, n_rows, ncol, pair);
  } else if (n_nt > 2) {
    float acc[2][1][4];
    kron_walk<T, V, 2, 1>(x, sx, w, d_w, Gp, n_ks, nt_base, n_nt, n_k, e0, n_live, d_sh, s_sh,
                          s_rows, s_kop, acc);
    kron_store<2, 1>(acc, n_nt, o, d_out, n_rows, ncol, pair);
  } else {
    float acc[1][1][4];
    kron_walk<T, V, 1, 1>(x, sx, w, d_w, Gp, n_ks, nt_base, n_nt, n_k, e0, n_live, d_sh, s_sh,
                          s_rows, s_kop, acc);
    kron_store<1, 1>(acc, n_nt, o, d_out, n_rows, ncol, pair);
  }
}

struct Args {
  const void *x, *sh, *w, *Wp, *n_edges, *gk, *groups, *runs, *terms, *coeffs;
  long long sx;
  int d_x, d_sh, d_w, d_out, E, n_groups, fz_max;
  void* out;
};

// K1, or with kRad K7-F on the fold's operands
template <typename T, int kM, int V, bool kRad = false, bool kXg = false>
int launch(const Args& a, const RadF& r, cudaStream_t stream) {
  constexpr int kTile = 16 * kM;
  const Layout L = layout<T>(kTile, a.d_x, a.d_sh, a.fz_max, a.sx != 0, kRad ? r.hd : 0,
                             r.span_max, kXg);
  const void* kernel;
  if constexpr (kRad)
    kernel = (const void*)&rad_fwd_kernel<T, kM, V, kXg>;
  else
    kernel = (const void*)&fwd_kernel<T, kM, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.E + kTile - 1) / kTile, a.n_groups);
  const T* x = static_cast<const T*>(a.x);
  const T* sh = static_cast<const T*>(a.sh);
  const T* w = static_cast<const T*>(a.w);
  const T* Wp = static_cast<const T*>(a.Wp);
  T* out = static_cast<T*>(a.out);
  const int* n_edges = static_cast<const int*>(a.n_edges);
  const int* gk = static_cast<const int*>(a.gk);
  const int* groups = static_cast<const int*>(a.groups);
  const int* runs = static_cast<const int*>(a.runs);
  const int* terms = static_cast<const int*>(a.terms);
  const float* coeffs = static_cast<const float*>(a.coeffs);
  if constexpr (kRad)
    rad_fwd_kernel<T, kM, V, kXg><<<grid, kThreads, L.total, stream>>>(
        x, a.sx, a.d_x, sh, a.d_sh, w, a.d_w, Wp, out, a.d_out, n_edges, a.E, gk, groups, runs,
        terms, coeffs, a.fz_max, r);
  else
    fwd_kernel<T, kM, V><<<grid, kThreads, L.total, stream>>>(
        x, a.sx, a.d_x, sh, a.d_sh, w, a.d_w, Wp, out, a.d_out, n_edges, a.E, gk, groups, runs,
        terms, coeffs, a.fz_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(int tile, int vec, const Args& a, cudaStream_t s) {
  const RadF r{};
  if (tile == 32 && vec == 4) return launch<T, 2, 4>(a, r, s);
  if (tile == 32 && vec == 1) return launch<T, 2, 1>(a, r, s);
  if (tile == 16 && vec == 4) return launch<T, 1, 4>(a, r, s);
  if (tile == 16 && vec == 1) return launch<T, 1, 1>(a, r, s);
  return (int)cudaErrorInvalidValue;
}

// K8-F: a block per (64-edge tile, column chunk of a (g, k)); n_chunks,
// the grid's second dimension (K1's Args: groups and n_groups unused)
template <typename T, int V>
int launch_kron(const Args& a, int n_chunks, cudaStream_t stream) {
  const KronLayout L = kron_layout<T>(a.d_sh, a.fz_max);
  const auto kernel = &kron_fwd_kernel<T, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  constexpr int kTile = 16 * kKronM;
  kernel<<<dim3((a.E + kTile - 1) / kTile, n_chunks), kThreads, L.total, stream>>>(
      static_cast<const T*>(a.x), a.sx, static_cast<const T*>(a.sh), a.d_sh,
      static_cast<const T*>(a.w), a.d_w, static_cast<const T*>(a.Wp), static_cast<T*>(a.out),
      a.d_out, static_cast<const int*>(a.n_edges), a.E, static_cast<const int*>(a.gk),
      static_cast<const int*>(a.runs), static_cast<const int*>(a.terms),
      static_cast<const float*>(a.coeffs), a.fz_max);
  return (int)cudaGetLastError();
}

// K7-F: x through L2 (x_global) only with the 16-edge tile, where the x tile
// is what keeps a second block off the SM
template <typename T>
int launch_rad_tile(int tile, int vec, bool x_global, const Args& a, const RadF& r,
                    cudaStream_t s) {
  if (x_global) {
    if (tile == 16 && vec == 4) return launch<T, 1, 4, true, true>(a, r, s);
    if (tile == 16 && vec == 1) return launch<T, 1, 1, true, true>(a, r, s);
    return (int)cudaErrorInvalidValue;
  }
  if (tile == 32 && vec == 4) return launch<T, 2, 4, true>(a, r, s);
  if (tile == 32 && vec == 1) return launch<T, 2, 1, true>(a, r, s);
  if (tile == 16 && vec == 4) return launch<T, 1, 4, true>(a, r, s);
  if (tile == 16 && vec == 1) return launch<T, 1, 1, true>(a, r, s);
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

// K7-F: out [E, d_out] of the radial-folded op on dtp_lin_fwd's arguments (w
// null) over DTPLinPlan.k1_tables(fold=True) (the runs' w column is the
// group's local column), then h [E, hd], hd (a positive multiple of 4), pk
// (each group's Wr packed in B-fragment order and the offsets in local
// column order), rg [n_groups, 3] (per group the offsets in pk of its
// packing and of its offsets, its span), span_max, and x_global (1: x read
// through L2, with the 16-edge tile only).
extern "C" int dtp_lin_rad_fwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                               const void* w, int d_w, const void* Wp, void* out, int d_out,
                               const void* n_edges, int E, const void* gk, const void* groups,
                               int n_groups, const void* runs, const void* terms,
                               const void* coeffs, int fz_max, int tile, int vec, const void* h,
                               int hd, const void* pk, const void* rg, int span_max,
                               int x_global, int dtype, void* stream) {
  if (fz_max % 16 != 0 || n_groups < 1 || w != nullptr || h == nullptr || pk == nullptr ||
      rg == nullptr || hd <= 0 || hd % 4 != 0 || span_max < 1)
    return (int)cudaErrorInvalidValue;
  const k1::Args a{x,      sh, w,    Wp,  n_edges, gk,       groups, runs,   terms,
                   coeffs, sx, d_x, d_sh, d_w,    d_out, E, n_groups, fz_max, out};
  const k1::RadF r{h, hd, pk, static_cast<const int*>(rg), span_max};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return k1::launch_rad_tile<float>(tile, vec, x_global, a, r, s);
  if (dtype == eqt::kBFloat16)
    return k1::launch_rad_tile<__nv_bfloat16>(tile, vec, x_global, a, r, s);
  return (int)cudaErrorInvalidValue;
}

// K8-F: out [E, d_out] of the kron-basis op for x (row stride sx: 0 or its
// width), sh, w [E, d_w] (null when a shared w is folded into G) and Wp,
// each (g, k)'s block of G in mma B-fragment order (KronMeta.k1_tables'
// gp_index over the flat G), over k1_tables' gk [n_gk, 8], runs and terms
// (K1's layout: each (g, k) a group of one component whose fan is its Kop
// rows; each CG triple a run of one term of coefficient 1); fz_max the
// most Kop rows of a (g, k) padded to 16; x, w and sh read through L2; vec
// 4 (x and w 16-byte aligned, the tables' offsets multiples of 4) or 1;
// n_chunks the (g, k)'s column chunks of 128 (k1_tables' n_chunks).
extern "C" int dtp_lin_kron_fwd(const void* x, long long sx, const void* sh, int d_sh,
                                const void* w, int d_w, const void* Wp, void* out, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* runs, const void* terms, const void* coeffs,
                                int fz_max, int vec, int n_chunks, int dtype, void* stream) {
  if (fz_max % 16 != 0 || n_gk < 1 || n_chunks < n_gk) return (int)cudaErrorInvalidValue;
  const k1::Args a{x,      sh, w,   Wp,   n_edges, gk,    nullptr, runs, terms,
                   coeffs, sx, 0,   d_sh, d_w,     d_out, E,       n_gk, fz_max, out};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return vec == 4 ? k1::launch_kron<float, 4>(a, n_chunks, s)
                    : k1::launch_kron<float, 1>(a, n_chunks, s);
  if (dtype == eqt::kBFloat16)
    return vec == 4 ? k1::launch_kron<__nv_bfloat16, 4>(a, n_chunks, s)
                    : k1::launch_kron<__nv_bfloat16, 1>(a, n_chunks, s);
  return (int)cudaErrorInvalidValue;
}
