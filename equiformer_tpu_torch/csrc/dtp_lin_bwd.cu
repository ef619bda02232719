// Fused depthwise tensor product + per-irrep linear heads, backward (K2).
//
// Replaces: equiformer_tpu/kernels/dtp_lin_pallas.py, _bwd_kernel / _bwd_body
// (built by make_bwd_call).  Plan, term tables and weight packing:
// equiformer_tpu_torch/kernels/dtp_lin.py (DTPLinPlan.bwd_tables, k2_tables).
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
// dsh is not computed by K2: the QM9 path never differentiates through
// positions (the wrapper raises when sh needs a gradient); the force
// models' K5a below adds it.  Rows e >= *n_edges get zero dx / dw and add
// nothing to dW.
//
// What bounds it on the card.  Per real edge of the flagship's sep_act site
// the dz product and the dW product each repeat the forward's 208,896
// multiply-adds (the z recompute and the term transposes add ~15k) against
// ~11 KB of operands read and written: by the table's rates (67 TFLOP/s
// fp32, 989 bf16) fp32 is bound by operations (0.44 ms at QM9) and bf16 by
// bytes (0.074 ms).  What held the first design back was neither:
// its dW product read and wrote a 121 MB set of fp32 partial rows in device
// memory every 16 edges (~3.4 GB a call), its dz product re-read W_g^T
// from L2 for every 4 edges on the CUDA cores, and its bf16 transposes read
// x and w one 2-byte value at a time.
//
// Design (two launches and the fixed-order reduction; no atomics):
// - Launch 1, dx and dw: one block of 512 threads per 16-edge tile (an mma
//   M tile).  It stages the tile's x, sh and, per irrep group, the group's
//   w columns in shared memory with 16-byte loads, then per (g, k) the
//   cotangent slice G[g,k] [16, cols padded to 16], and computes dz = G
//   W_g^T on the tensor cores (mma.sync): warp i takes the fan's 8-wide
//   n-tiles i, i + 16, ..., and reads W_g in fragment order (packed by the
//   wrapper, DTPLinPlan.k2_tables: one 16-byte load a lane and K step in
//   fp32, 8 bytes in bf16, coalesced), each W element once per tile.  The
//   term transposes then read dz, x and w from shared memory (a thread
//   steps over rows with a fixed u when mul, a power of two, divides the
//   block: no division an element).  dx of the tile accumulates in shared
//   memory over all (g, k), dw over the components of one group (every w
//   column feeds exactly one group), and each is flushed once with 16-byte
//   stores.  Within one (g, k) a dx / dw element is only ever touched by
//   one thread: element (row, u) of a term goes to thread (row * mul + u)
//   % 512, and terms that share a column share mul.  (Summing each
//   column's terms in one thread instead, so that every element is written
//   once, took twice as long: it leaves fewer independent elements in
//   flight.)
// - Launch 2, dW: block (tile, range) owns a 64 x 128 tile of one group's
//   dW (fan rows x columns) and walks one edge range in steps of 64 edges.
//   Per step and component it recomputes z's fan slice from the terms that
//   reach it (the forward never saves z: 3136 x 32888 values at sep_act,
//   206 MB bf16, would be written and read once; the recompute costs each
//   z column 1.14 times, the 0e group being cut in 3 column tiles), stages
//   G's column slice, and adds z^T G on the tensor cores into registers.
//   The fp32 partial goes to device memory once per range, to row `range`
//   of part [n_ranges, w_numel]; eqt::sum_partial_rows (common.cuh) sums
//   the rows in order, so dW does not depend on the schedule.
// - Precision: bf16 takes bf16 operands with fp32 accumulators (the plain
//   version rounds z and dz to bf16 too).  fp32 must stay within 1e-4 of
//   the plain version, which plain TF32 (10-bit mantissa) would not: each
//   operand is split into tf32 hi + lo and three products are summed (lo *
//   hi, hi * lo, hi * hi), which keeps about fp32's accuracy at 3x the
//   tensor-core work (still ~0.1 ms at QM9).  The same inputs give the same
//   bits: each sum has one fixed order.
// Rows e >= *n_edges: launch 1 writes zero dx / dw; launch 2 stops its
// ranges at *n_edges.
//
// The force models' fused op (k2::edge_leg_kernel, k2::sh_leg_kernel,
// k2::bwd3_kernel and k2::W_leg_kernel below; replace
// equiformer_tpu/kernels/dtp_lin_ho.py, _edge_leg_kernel :163 for the x, sh
// and w legs, _W_leg_kernel :402, built by _leg_call :562-633, and
// _bwd3_kernel :451, built by _bwd3_pallas :647) computes the same
// functions on the operands of the grad-of-grad, where the operand of the
// output leg does not exist, and the force backward's dsh:
// - K5b's x leg, F_x(g, sh, w, W) = launch 1 with dx alone (x never staged
//   or read, no dw); its w leg, F_w(g, x, sh, W) = launch 1 with dw alone
//   (w never staged or read, no dx); its sh leg, F_sh(g, x, w, W) = launch
//   1 with dsh alone (sh never staged or read, no dx or dw):
//     dsh[e, col] += c * sum_u x[e,a+u] * w[e,b+u] * dz[g,k][fc+u].
//   The leg is a compile-time argument of launch 1's body, so K2's own
//   instantiation is the code it was.
// - K5a, the force backward, (F_x, F_sh, F_w)(g, ...) of one g = launch 1
//   with dx, dsh and dw together, one dz product for all three; the set of
//   outputs a caller asks for is a template argument (kNeed: the two- and
//   three-output sets; null pointers for the rest were 9-22% slower on an
//   H100).  Its fp32 tile at MD17's sep_act (dx, dw, dz, G, x, w: ~270 KB)
//   does not fit a block's 227 KB, so there it reads x through L2 (kXg)
//   instead of staging it.
// - The dsh sum has one fixed order and no float atomics.  In the dsh legs'
//   term pass a term of mul a multiple of 32 goes a row a warp (warp r takes
//   row r, lane l its u = l, l + 32, ...: the lane sums them in order, a
//   fixed __shfl_xor butterfly sums the lanes); a power-of-two mul < 32
//   keeps K2's element (row, u) on thread row * mul + u, a row's u in
//   consecutive lanes summed by a butterfly; any other mul takes K2's
//   mapping for dx / dw and one thread a row for dsh.  Either way dx and dw
//   stay owned by one thread within a (g, k) (the mapping depends on (row,
//   u, mul) alone, and terms that share an x or w column share mul).  Each
//   row sum goes once to the term's slot of the row; after the term pass's
//   barrier one thread per (row, column) adds the slots of its column's
//   terms in term order.  (Terms of one column need not share mul, so no
//   thread owns a dsh element across terms.)
// - At MD17's 2944 edges one 16-edge tile a block gives 184 blocks of one
//   per SM (132 SMs: 1.4 waves), so a leg launch cuts its tiles by irrep
//   group (grid.y; the wrapper takes one split a group): a w column feeds
//   one group, so the blocks of one tile write disjoint dw columns; dx and
//   dsh sum over groups, so each (tile, group) block writes fp32 partials
//   [n_split, E, d_x] and [n_split, E, d_sh] and one more launch sums the
//   partials in split order (rows past *n_edges: zeros).
// - K5c's F_W(g, x, sh, w) = launch 2 and the row sum (dW in the packed
//   [fan_stride, cols] layout at each group's w_off, pad rows zero), under
//   a kernel name of its own so that a profile tells it from K2's.
// They share K2's tables (DTPLinPlan.k2_tables), its fragment-packed W and
// its edge ranges, and keep its numerics: no float atomics anywhere.
//
// The radial fold (K7-B, replaces the radial branch of _bwd_kernel /
// _bwd_body, dtp_lin_pallas.py:675-745, :754-756, :865-887, with
// _radial_write_dw :497 and _radial_dh :521; K7-Wr, replaces
// equiformer_tpu/kernels/dtp_lin_ho.py's _Wr_leg_kernel :344, built by
// _leg_call :594-603; K7-L, K7-B3 and K7-LW below).  The per-edge operand is h [E, hd], and w = [h, 1]
// @ [Wr; offset] (Wl [hd + 1, n_loc], columns in the tables' local order,
// row hd the offset).  Every w column feeds one group, and a group's fan
// column f is its local w column sb + f (DTPLinPlan.k7_tables checks it),
// so one packing of each group's Wr in fragment order serves every product
// below (k7_tables: [hd, span] for w, [span, hd] for dh).
// - K7-B, launch 1 (k2::rad_dxdw_kernel): K2's launch 1 with the fold as
//   its leg (kRadB).  It stages the tile's h; at each group's first
//   component w_g = [h, 1] Wl_g goes into the group's w tile on mma.sync,
//   rounded to T as the plain version rounds it; then K2's dz product and
//   term transposes, unchanged; at the group's last component dh += dw_g
//   Wr_g^T on mma.sync into an fp32 [16, hd] tile (the span's K steps in
//   two halves on the two halves of the warps, added in turn), and the
//   group's dw columns go to a workspace [E, d_w] in T through dwmap, as K2
//   writes dw.  dx and dh are written once a tile.
// - K7-B, launch 2 (k2::rad_dW_kernel): K2's dW tiles with w rebuilt per
//   64-edge step from h on mma.sync (h staged over G's buffer, the tile's w
//   fan slice [64, 64] in T), so that w never reaches device memory, at two
//   blocks an SM; and in the same grid the tiles of d[Wr; offset] = [h,
//   one]^T dw (dWr_body):
//   per (64-row hd slice, 128 local columns) and edge range, h^T and the
//   dw slice staged per 64-edge step, their product on mma.sync into
//   registers, the offset row a column sum of dw in edge order.  The
//   d[Wr; offset] partial follows dW's in the range's partial row, so one
//   eqt::sum_partial_rows gives both.
// - K7-Wr (dtp_lin_rad_legWr): K5b's w leg (k2::edge_leg_kernel<T, kLegW>,
//   the instantiation K5b runs) writes dw [E, d_w] in T to a workspace;
//   the d[Wr; offset] tiles alone (k2::Wr_leg_kernel) and the row sum.
// - K7-L (dtp_lin_rad_leg; replaces equiformer_tpu/kernels/dtp_lin_ho.py's
//   _edge_leg_kernel_rad :255, built by _leg_call :613-621): K5b's x, sh
//   and w legs with the fold (k2::rad_leg_kernel<T, kLeg>: dxdw_body's
//   kRad), a block per (16-edge tile, irrep group).  The x and sh legs
//   build the group's w from the staged h as K7-B's launch 1 does (w never
//   read); the fold's h leg is K5b's w leg with dw kept in shared memory
//   and, at the group's last component, dh += dw_g Wr_g^T as K7-B adds it
//   (dw never written, h never read).  dx, dsh and dh sum over groups, so
//   each (tile, group) block writes fp32 partials and one launch sums them
//   in split order, as K5b's x and sh legs do (whole tiles took 0.60 ms
//   against 0.49 for the h leg at MD17's sep_act in fp32).  The fp32 dz
//   product splits by masking.  On an H100 the x / sh / h legs took 0.51 /
//   0.54 / 0.49 ms fp32 and 0.41 / 0.44 / 0.40 bf16 at MD17's sep_act; the
//   first design (csrc/dtp_lin_leg.cu: 8 warps per 16-edge tile walking
//   every group, dz and w on the CUDA cores) 1.72 / 2.07 / 1.85 and 1.65 /
//   1.66 / 1.56.
// - K7-B3 (dtp_lin_rad_bwd3; replaces the radial branch of
//   dtp_lin_ho.py's _bwd3_kernel :451, :488-526: w rebuilt by
//   _radial_w_fill, dh by _radial_dh; built by _bwd3_pallas, pallas_call
//   :696): K5a with the fold (k2::rad_bwd3_kernel<T, kXg, kNeed>:
//   dxdw_body's kBwd3 with kRad), a block per (16-edge tile, irrep group).
//   Each group's w is built from the staged h as K7-B's launch 1 builds it,
//   then K5a's dz product and term pass with its fixed-order dsh sum; with
//   dh asked for (the dw bit of kNeed) dw stays in shared memory and, at the
//   group's last component, dh += dw_g Wr_g^T as the h leg adds it.  The
//   output set (two or three of dx, dsh, dh) is a template argument; dx,
//   dsh and dh split partials are summed in group order by one launch
//   (k2::split_sum_kernel); the fp32 products split by masking; x goes
//   through L2 where the tile (with the h and dh tiles) would not fit the
//   block (fp32 at MD17 L3: kXg).  The offset is read from Wl's row hd: 0
//   when h's slot holds a tangent.  On an H100 at MD17 L3 sep_act (dx, dsh,
//   dh) took 0.85-0.86 / 0.64 ms fp32 / bf16 (its unfolded pair, cuBLAS w +
//   K5a + cuBLAS dh, 1.02-1.05 / 0.70-0.71), the first design (one
//   256-thread block per 16-edge tile walking every group, dz on the CUDA
//   cores, csrc/dtp_lin_bwd3.cu) 2.36-2.41 / 2.34-2.35.
// - K7-LW (dtp_lin_rad_legW; replaces the radial branch of
//   dtp_lin_ho.py's _W_leg_kernel :402-449, h :415, _radial_w_fill
//   :439-440): K7-B's launch 2 without the d[Wr; offset] tiles
//   (k2::rad_W_leg_kernel: K5c's dW tiles with each step's w fan slice
//   rebuilt from h on mma.sync, the offset read from Wl's row hd, which the
//   caller zeroes when h's slot holds a tangent) and the row sum; its fp32
//   dW product split by masking (7% off the conversion split at MD17's
//   sep_act: 0.72 ms against 0.78; the first design, csrc/dtp_lin_legW.cu,
//   CUDA cores with a device-memory partial per tile, 2.6 ms).
// What bounds them: K2's and K5b's work plus three products of [E, hd + 1]
// by [hd + 1, d_w] (the w build, dh, d[Wr; offset]) and the rebuild of w
// in launch 2 (~2.2 more at QM9: each fan slice is rebuilt for every
// column tile of its group); the dw workspace costs its write and one read.
// On an H100 at QM9 sep_act K7-B took 5.47-5.62 / 3.54-3.57 ms fp32 /
// bf16 (launch 1 2.14-2.19 / 1.48, launch 2 3.32-3.42 / 2.06-2.07; the
// first design 15.4 / 14.7), K7-Wr at MD17 sep_act 0.61 / 0.43 (2.77 /
// 2.42).  Writing w from launch 1 to a workspace read by launch 2 took
// 4.89-4.94 / 3.51-3.52; it would put w in device memory and was 1% slower
// in bf16.  Rebuilding w on the CUDA cores, staging the tile's Wr in shared
// memory (less L1 for the z recompute) and one n-tile at a time were each
// slower.
// Products: bf16 operands and fp32 accumulators; fp32 as 3xTF32 split by
// masking (eqt::mma::split_tf32_mask).  No float atomics: each sum has one
// order.  Rows past the real edges: launch 1 writes zero dx and dh; launch
// 2 stops its ranges at *n_edges, so they add nothing to either partial;
// ``one`` is 1 for the primal h, 0 when h's slot holds a tangent or a
// cotangent (the offset row is then 0).
//
// The kron route's backward (K8-B, dtp_lin_kron_bwd; replaces
// equiformer_tpu/kernels/dtp_lin_kron.py, _bwd_kernel :231, built by
// bwd_call :431) is K2's two launches on other tables (KronMeta.bwd_tables,
// kernels/dtp_lin_kron.py), under kernel names of their own
// (k2::kron_dxdw_kernel, k2::kron_dG_kernel).  In the kron basis
//   out[e, out_col(g,k) + c] = sum_r Kop[e, r] G[r, c],
//   Kop[e, r] = sh[e, col_r] x[e, xi_r] w[e, wi_r],
// r over the rows of (g, k)'s block of G, the CG coefficients folded into G.
// That is K2's function with each (g, k) a group of one component whose
// fan is its Kop rows and whose W is its block of G, and with each CG
// triple a term of coefficient 1 whose fan column is its first Kop row: so
// launch 1 computes dkop = g G^T on the tensor cores (each (g, k)'s G^T in
// fragment order, packed by one gather a call) and the triples' transposes
// into dx and dw, and launch 2 dG = Kop^T g per (64 Kop rows x 128 columns)
// tile of one (g, k) and edge range, Kop rebuilt per 64-edge step, one fp32
// partial row per range and the fixed-order row sum.  A 128-column (g, k)
// builds its Kop slice once a step.  Both fp32 products split by masking
// (13% off the conversion split at the QM9 flagship's sep_act), launch 2 at
// three blocks an SM.  What bounds it: 4 operations per G element and real
// edge (2.17x K2's products at the QM9 flagship's sep_act: 453,632
// multiply-adds an edge against 208,896) against ~12 KB of operands an
// edge, so fp32 by operations, bf16 by bytes (0.914 / 0.074 ms at QM9
// sep_act); on an H100 it took 4.47-4.53 / 3.26-3.27 ms there (launch 1
// 2.08-2.13 / 1.50, launch 2 2.39 / 1.76), K2 on the same inputs 4.14 /
// 3.06.  The first design (csrc/dtp_lin_kron.cu) ran both products on the
// fp32 CUDA cores and read G^T through a transposed copy: 8.2 / 7.9 ms.
//
// The staged variant (S3, dtp_lin_bwd_stage; replaces scripts/bwd_attr.py's
// kernels, build(stage)): kStage cuts K2 after one of its phases (k2::
// kFullStage below), to time each (equiformer_tpu_torch/tools/bwd_attr.py).
// The cut phases are left out at compile time; the zeroed shared-memory
// accumulators are still flushed, so dx and dw come out zero before stage
// 3, and dW stays zero before the last stage.  Launch 1 from stage 3 on,
// and both launches at the last stage, are K2's own instantiations.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

// ======================================================================
// K2: dtp_lin_bwd, and S3: dtp_lin_bwd_stage (design in the header note)
// ======================================================================
namespace k2 {

using namespace eqt::mma;
using eqt::from_f;
using eqt::to_f;

constexpr int kTile = 16;                // edges per block of launch 1: one mma M tile
constexpr int kWarps1 = 16;
constexpr int kThreads1 = 32 * kWarps1;
constexpr int kNT = 4;                   // fan n-tiles (8 wide) a warp holds at once
constexpr int kGkFields = 12;            // ints per (g, k) entry of DTPLinPlan.k2_tables
constexpr int kTermFields = 6;           // a_off, sh col, b_off, fan col, mul, local dw col
constexpr int kTileFields = 6;           // dW tile: gk row of component 0, k count, f0, fm, j0, fn
constexpr int kEdges2 = 64;              // edges per step of launch 2: four mma K steps of 16
constexpr int kFanTile = 64;             // dW tile rows (fan): 4 mma M tiles
constexpr int kColTile = 128;            // dW tile columns: 16 mma N tiles
constexpr int kThreads2 = 256;
constexpr int kLdz2 = kFanTile + 4;      // row strides = 4 mod 32 words: the fragment loads of
constexpr int kLdg2 = kColTile + 4;      // lanes (q, g) hit banks 8q + g, conflict-free
constexpr int kRowPad = 8;               // staged x / w / dw rows: multiples of 8 elements

// phases, in order (kernels/dtp_lin.py BWD_STAGES): launch 1: 0 loop, zeroing,
// x / w staged; 1 + G staged; 2 + the dz product; 3 + the term transposes and
// the dx / dw flush (launch 1 whole); launch 2: 4 loop and G staged; 5 + z
// recomputed; 6 + the dW product (K2 whole)
constexpr int kFullStage = 6;

// what launch 1's code computes: an edge leg of the fused op (K5b, in
// EDGE_LEGS' order of kernels/dtp_lin_ho.py: the x leg 0, the sh leg 1, the
// w leg 2), K2's dx and dw together, K5a's dx, dsh and dw together (each
// null when not asked for; with the fold K7-B3's dx, dsh and dh), or K7-B's
// dx, dw and dh with w built from h
enum Leg1 : int { kLegX = 0, kLegSh = 1, kLegW = 2, kDxDw = 3, kBwd3 = 4, kRadB = 5 };

// K5a's outputs asked for (bits of `need`; with the fold the dw bit is dh)
constexpr int kNeedDx = 1, kNeedDsh = 2, kNeedDw = 4, kNeedAll = 7;

// the legs with a dsh accumulator
__host__ __device__ constexpr bool sums_dsh(int leg) { return leg == kLegSh || leg == kBwd3; }
// the legs that compute dx and dw together over whole tiles (K2, K7-B)
__host__ __device__ constexpr bool pairs_dxdw(int leg) { return leg == kDxDw || leg == kRadB; }
// with the radial fold (rad: K7-L's legs kLegX, kLegSh and kLegW, the last
// one its h leg, and K7-B3, kBwd3): the legs that build w from h (K7-B; the
// x and sh legs; K7-B3), and those that contract dw into dh (K7-B; the h
// leg; K7-B3 when dh is asked for)
__host__ __device__ constexpr bool builds_w(int leg, bool rad) {
  return leg == kRadB || (rad && leg != kLegW);
}
__host__ __device__ constexpr bool sums_dh(int leg, bool rad, int need = kNeedAll) {
  return leg == kRadB || (rad && (leg == kLegW || (leg == kBwd3 && (need & kNeedDw))));
}

// the row stride of launch 1's w and dw tiles: multiples of 8 elements; the
// dh legs read dw as the A operand of their dh product, K steps of 16,
// float2 a lane (8 words mod 32: conflict-free)
template <int kLeg, bool kRad = false>
__host__ __device__ inline int span_stride(int span_max, int need = kNeedAll) {
  return sums_dh(kLeg, kRad, need) ? stride_mod(round_up(span_max, 16), 32, 8)
                                   : round_up(span_max, kRowPad);
}

// one term of the backward tables (DTPLinPlan.bwd_tables: a_off, sh col,
// b_off, fan col, mul, local dw col) and its coefficient
struct Term {
  int a, col, fc, mul, bl;
  float c;
};

__device__ __forceinline__ Term load_term(const int* __restrict__ terms,
                                          const float* __restrict__ coeffs, int t) {
  const int* tt = terms + t * kTermFields;
  return {__ldg(tt), __ldg(tt + 1), __ldg(tt + 3), __ldg(tt + 4), __ldg(tt + 5), __ldg(coeffs + t)};
}

// launch 1's row strides, so that a warp's fragment loads and stores hit 32
// distinct banks: G 8 words mod 32 in fp32 (float2 per lane), 4 in bf16 (one
// word per lane); dz (fp32, float2 stores) 8 words mod 32
template <typename T>
__host__ __device__ inline int ld_g1(int cp_max) {
  return sizeof(T) == 4 ? stride_mod(cp_max, 32, 8) : stride_mod(cp_max, 64, 8);
}
__host__ __device__ inline int ld_dz1(int fd_max) { return stride_mod(fd_max, 32, 8); }

// byte offsets of launch 1's shared memory: dx, dw (fp32), dz (fp32), G, x, w
// (dtype), sh, dsh and the dsh slots (fp32), h (dtype) and dh (fp32); the x
// leg keeps no dw and stages no x, the w leg keeps no dx and stages no w,
// the sh leg keeps neither and stages no sh; K5a keeps what `need` asks for,
// and with x_global reads x through L2 instead of staging it; h where w is
// built from it, dh where dw is contracted into it (builds_w, sums_dh).
// has_w: the plan has per-edge w.
struct Layout1 {
  int dx, dw, dz, g, x, w, sh, dsh, slot, h, dh, total;
};

// K7-B's h tile: [kTile, hd rounded to 16] in the dtype, G's strides
template <typename T>
__host__ __device__ inline int ld_h(int hd) {
  return ld_g1<T>(round_up(hd, 16));
}

template <typename T, int kLeg = kDxDw, bool kRad = false>
__host__ __device__ inline Layout1 layout1(int d_x, int d_sh, int span_max, int cp_max,
                                           int fd_max, bool has_w, bool x_rows,
                                           int need = kNeedAll, int slot_max = 0,
                                           bool x_global = false, int hd = 0) {
  const int dxs = round_up(d_x, kRowPad), sps = span_stride<kLeg, kRad>(span_max, need);
  const bool dsh = sums_dsh(kLeg) && (need & kNeedDsh);
  Layout1 l;
  l.dx = 0;
  l.dw = l.dx + (kLeg != kLegW && kLeg != kLegSh && (need & kNeedDx) ? align16(kTile * dxs * 4)
                                                                      : 0);
  l.dz = l.dw + (kLeg != kLegX && kLeg != kLegSh && (need & kNeedDw) && has_w
                     ? align16(kTile * sps * 4)
                     : 0);
  l.g = l.dz + align16(kTile * ld_dz1(fd_max) * 4);
  l.x = l.g + align16(kTile * ld_g1<T>(cp_max) * (int)sizeof(T));
  l.w = l.x + (kLeg != kLegX && !x_global
                   ? align16((x_rows ? kTile : 1) * dxs * (int)sizeof(T))
                   : 0);
  l.sh = l.w + (kLeg != kLegW && has_w ? align16(kTile * sps * (int)sizeof(T)) : 0);
  l.dsh = l.sh + (kLeg != kLegSh ? align16(kTile * d_sh * 4) : 0);
  l.slot = l.dsh + (dsh ? align16(kTile * d_sh * 4) : 0);
  l.h = l.slot + (dsh ? align16(kTile * slot_max * 4) : 0);
  l.dh = l.h + (builds_w(kLeg, kRad) ? align16(kTile * ld_h<T>(hd) * (int)sizeof(T)) : 0);
  l.total = l.dh + (sums_dh(kLeg, kRad, need) ? align16(2 * kTile * hd * 4) : 0);  // dh, scratch
  return l;
}

// the dw span of a group in local order: columns dwmap[sb + jl] of w (or dw);
// a chunk of kVec local columns moves with one 16-byte access when its w
// columns are consecutive and aligned
template <typename T>
__device__ __forceinline__ bool span_chunk_vec(const int* __restrict__ dwmap, int sb, int jl,
                                               int span, bool row_vec) {
  constexpr int V = kVec<T>;
  if (!row_vec || jl + V > span) return false;
  const int g0 = __ldg(dwmap + sb + jl);
  return g0 % V == 0 && __ldg(dwmap + sb + jl + V - 1) == g0 + V - 1;
}

// ------------------------------------------------- the radial fold (K7)
// The fold's operands (kernel parameters by value): both launches build w
// from h, Wl, pk and rgk; launch 1 writes dh; launch 2's first n_dw_tiles
// blocks are dW tiles, the rest d[Wr; offset] tiles of dw, written at
// `base` of a partial row of part_ld floats (K7-Wr: those tiles alone).
struct RadOps {
  const void* h;        // [E, hd] in T
  int hd;
  const void* Wl;       // [hd + 1, n_loc] in T: [Wr; offset], columns in local order
  int n_loc;
  const void* pk;       // each group's Wr in fragment order, for w, then for dh (k7_tables)
  const int* rgk;       // [n_gk, 2]: the offsets in pk of the row's group's two packings
  void* dh;             // launch 1: [E, hd] in T
  const void* dw;       // launch 2: the dw workspace [E, d_w] in T
  const int* dwmap;     // local column -> dw column
  int n_dw_tiles, base, part_ld;
  float one;            // h's ones column: 1, or 0 for a tangent or cotangent in h's slot
  float* part_dh;       // K7-B3 cut in more than one split: dh's partials [n_split, E, hd]
};

// the d[Wr; offset] tiles: 64 hd rows (kFanTile) by 128 local columns (kColTile)
__host__ __device__ inline int wr_tiles(int hd, int n_loc) {
  return ((hd + kFanTile - 1) / kFanTile) * ((n_loc + kColTile - 1) / kColTile);
}

// ----------------------------------------------------------- launch 1
// the gk rows of the irrep groups that split s of n_split takes: groups
// [s * n / n_split, (s + 1) * n / n_split) of the plan's n (a group's rows
// are consecutive, its first flagged)
__device__ __forceinline__ void group_rows(const int* __restrict__ gk, int n_gk, int s,
                                           int n_split, int& begin, int& end) {
  int n_groups = 0;
  for (int qi = 0; qi < n_gk; ++qi) n_groups += __ldg(gk + qi * kGkFields + 10);
  const int g0 = s * n_groups / n_split, g1 = (s + 1) * n_groups / n_split;
  begin = end = n_gk;
  for (int qi = 0, gi = -1; qi < n_gk; ++qi) {
    gi += __ldg(gk + qi * kGkFields + 10);
    if (gi >= g0 && begin == n_gk) begin = qi;
    if (gi >= g1) {
      end = qi;
      break;
    }
  }
}

// dx and dw of one 16-edge tile a block: G[g,k] staged, dz = G W_g^T on the
// tensor cores (W_g packed in fragment order by the wrapper, read from L2
// with one 16-byte (fp32) or 8-byte (bf16) load per lane and step), then
// the term transposes off dz in shared memory.  kLeg: K2's dx and dw
// (kDxDw), or one edge leg (K5b) that never reads its own operand; a leg
// block takes the groups of its split blockIdx.y, and the x leg cut in
// more than one split writes its fp32 dx partial to part [n_split, E, d_x].
// K7-B (kRadB) builds each group's w from the staged h instead of reading
// w, and adds dw Wr^T into its dh tile at the group's last component.
// The sh leg (kLegSh, sh never staged or read) and K5a (kBwd3: the outputs
// in kNeed, the others null) also sum dsh: each term's row sum goes once to
// its slot of s_slot [kTile, slot_max] (a warp a row for a mul that is a
// multiple of 32, then a fixed butterfly of shuffles), and after the term
// pass one thread per (row, column) adds its column's slots in term order;
// cut in more than one split, dsh goes to part_sh [n_split, E, d_sh].  With
// kXg K5a reads x through L2 (its fp32 tile does not fit beside the rest).
// kMask: the fp32 dz product's 3xTF32 split by masking (mma_fold; K8-B,
// K7-L), else by conversion (mma16n; K2 and the instantiations that share
// its code).  kRad: K7-L, the x, sh or w leg (kLegX, kLegSh, kLegW) of the
// radial fold, w never read: the x and sh legs build each group's w from
// the staged h as K7-B does; the w leg is the fold's h leg, which never
// writes dw but adds dw Wr^T into its dh tile as K7-B does (cut in more
// than one split: an fp32 dh partial to part [n_split, E, hd]).  kRad with
// kBwd3: K7-B3, K5a with the fold: w built from h as K7-B builds it, dw
// kept in shared memory (never written) and, with dh asked for (the dw bit
// of kNeed), added into dh as the h leg adds it (cut in more than one
// split: an fp32 dh partial to rad.part_dh [n_split, E, hd]).
template <typename T, int kStage, int kLeg, bool kXg = false, int kNeed = kNeedAll,
          bool kMask = false, bool kRad = false>
__device__ __forceinline__ void dxdw_body(
    const T* __restrict__ x, long long sx, int d_x, const T* __restrict__ sh, int d_sh,
    const T* __restrict__ w, int d_w, const T* __restrict__ Wp, const T* __restrict__ G,
    int d_out, const int* __restrict__ n_edges_ptr, int E, const int* __restrict__ gk, int n_gk,
    const int* __restrict__ terms, const float* __restrict__ coeffs,
    const int* __restrict__ dwmap, T* __restrict__ dx, T* __restrict__ dw, int span_max,
    int cp_max, int fd_max, float* __restrict__ part, T* __restrict__ dsh = nullptr,
    float* __restrict__ part_sh = nullptr, int slot_max = 0, const RadOps rad = {}) {
  constexpr int V = kVec<T>;
  constexpr bool kSh = sums_dsh(kLeg);
  // what K5a keeps (the other legs: what their leg computes)
  constexpr int need = kLeg == kBwd3 ? kNeed : kNeedAll;
  constexpr bool kBuildW = builds_w(kLeg, kRad), kDh = sums_dh(kLeg, kRad, need);
  constexpr bool kHLeg = kRad && kLeg == kLegW;  // K7-L's h leg: dh, no dw
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  // the plan has per-edge w (K7-B, K7-L, K7-B3: built from h)
  const bool has_w = kLeg == kLegW || kLeg == kRadB || kRad || w != nullptr;
  constexpr bool keep_dx = kLeg == kBwd3 ? (kNeed & kNeedDx) != 0 : kLeg != kLegW && !kSh;
  constexpr bool keep_dw = kLeg == kBwd3 ? (kNeed & kNeedDw) != 0 : kLeg != kLegX && !kSh;
  constexpr bool keep_dsh = kSh && (need & kNeedDsh) != 0;
  const Layout1 L = layout1<T, kLeg, kRad>(d_x, d_sh, span_max, cp_max, fd_max, has_w, sx != 0,
                                           need, slot_max, kXg, rad.hd);
  float* s_dx = reinterpret_cast<float*>(smem + L.dx);
  float* s_dw = reinterpret_cast<float*>(smem + L.dw);
  float* s_dz = reinterpret_cast<float*>(smem + L.dz);
  T* s_g = reinterpret_cast<T*>(smem + L.g);
  T* s_x = reinterpret_cast<T*>(smem + L.x);
  T* s_w = reinterpret_cast<T*>(smem + L.w);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  float* s_dsh = reinterpret_cast<float*>(smem + L.dsh);
  float* s_slot = reinterpret_cast<float*>(smem + L.slot);
  const int dxs = round_up(d_x, kRowPad), sps = span_stride<kLeg, kRad>(span_max, need);
  const int ldg = ld_g1<T>(cp_max), ldz = ld_dz1(fd_max);
  // the fold: h [kTile, ldh] (dtype), dh and a scratch tile [kTile, hd] (fp32)
  const int hd = rad.hd, hd16 = round_up(hd, 16), ldh = ld_h<T>(hd);
  T* s_h = reinterpret_cast<T*>(smem + L.h);
  float* s_dh = reinterpret_cast<float*>(smem + L.dh);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int e0 = blockIdx.x * kTile;
  const int n_rows = min(kTile, E - e0);
  const int n_live = max(0, min(n_rows, __ldg(n_edges_ptr) - e0));
  const bool dx_vec = d_x % V == 0 && aligned16(dx);
  const bool dw_vec = d_w % V == 0 && aligned16(dw) && aligned16(w);
  // dx (and dsh; dh of the h leg and K7-B3) as fp32 partials
  const bool split = (kLeg == kLegX || kSh || kHLeg) && gridDim.y > 1;
  float* part_dh = kHLeg ? part : rad.part_dh;

  if (n_live == 0) {  // past the real edges: zero gradients
    if constexpr (kLeg == kRadB) {  // (no dw: the workspace's rows past *n_edges are not read)
      for (int i = tid; i < n_rows * d_x; i += kThreads1)
        dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
      T* dh = static_cast<T*>(rad.dh);
      for (int i = tid; i < n_rows * hd; i += kThreads1)
        dh[(long long)e0 * hd + i] = from_f<T>(0.f);
    } else if constexpr (kHLeg) {
      if (!split) {  // else the sum of the partials writes them
        T* dh = static_cast<T*>(rad.dh);
        for (int i = tid; i < n_rows * hd; i += kThreads1)
          dh[(long long)e0 * hd + i] = from_f<T>(0.f);
      }
    } else if constexpr (kLeg == kDxDw) {
      for (int i = tid; i < n_rows * d_x; i += kThreads1)
        dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
      if (has_w)
        for (int i = tid; i < n_rows * d_w; i += kThreads1)
          dw[(long long)e0 * d_w + i] = from_f<T>(0.f);
    } else if constexpr (kLeg == kLegX) {
      if (!split)  // else the sum of the partials writes them
        for (int i = tid; i < n_rows * d_x; i += kThreads1)
          dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
    } else if constexpr (kSh) {
      if (!split) {  // else the sum of the partials writes them
        if (keep_dx)
          for (int i = tid; i < n_rows * d_x; i += kThreads1)
            dx[(long long)e0 * d_x + i] = from_f<T>(0.f);
        if (keep_dsh)
          for (int i = tid; i < n_rows * d_sh; i += kThreads1)
            dsh[(long long)e0 * d_sh + i] = from_f<T>(0.f);
        if constexpr (kDh) {  // K7-B3's dh
          T* dh = static_cast<T*>(rad.dh);
          for (int i = tid; i < n_rows * hd; i += kThreads1)
            dh[(long long)e0 * hd + i] = from_f<T>(0.f);
        }
      }
      if constexpr (!kRad)
        if (keep_dw && blockIdx.y == 0)
          for (int i = tid; i < n_rows * d_w; i += kThreads1)
            dw[(long long)e0 * d_w + i] = from_f<T>(0.f);
    } else {
      if (blockIdx.y == 0)
        for (int i = tid; i < n_rows * d_w; i += kThreads1)
          dw[(long long)e0 * d_w + i] = from_f<T>(0.f);
    }
    return;
  }

  if constexpr (kSh) {
    if (keep_dx)
      for (int i = tid; i < kTile * dxs; i += kThreads1) s_dx[i] = 0.f;
    if (keep_dsh)
      for (int i = tid; i < kTile * d_sh; i += kThreads1) s_dsh[i] = 0.f;
  } else if constexpr (kLeg != kLegW) {
    for (int i = tid; i < kTile * dxs; i += kThreads1) s_dx[i] = 0.f;
  }
  if constexpr (kLeg != kLegSh)
    for (int i = tid; i < n_live * d_sh; i += kThreads1) {
      const int r = i / d_sh;
      s_sh[r * d_sh + (i - r * d_sh)] = to_f(sh[(long long)(e0 + r) * d_sh + (i - r * d_sh)]);
    }
  if constexpr (kLeg != kLegX && !kXg)
    copy_rows<T, kThreads1>(s_x, dxs, x + (long long)e0 * sx, sx, sx ? n_live : 1, d_x,
                            d_x % V == 0 && sx % V == 0 && aligned16(x));
  int q_begin = 0, q_end = n_gk;
  if constexpr (!pairs_dxdw(kLeg)) group_rows(gk, n_gk, blockIdx.y, gridDim.y, q_begin, q_end);
  if constexpr (kBuildW || kDh) {
    if constexpr (kBuildW) {  // the tile's h (zero past the real edges and hd)
      const T* h = static_cast<const T*>(rad.h);
      for (int i = tid; i < kTile * hd16; i += kThreads1) {
        const int r = i / hd16, c = i - r * hd16;
        s_h[r * ldh + c] =
            r < n_live && c < hd ? h[(long long)(e0 + r) * hd + c] : from_f<T>(0.f);
      }
    }
    if constexpr (kDh)
      for (int i = tid; i < kTile * hd; i += kThreads1) s_dh[i] = 0.f;
    __syncthreads();  // the w build reads s_h
  }

  for (int qi = q_begin; qi < q_end; ++qi) {
    const int* gr = gk + qi * kGkFields;
    const int fs = gr[0], cols = gr[1], out_col = gr[2];
    const int t_begin = gr[4], t_end = gr[5], wp_off = gr[6], cp = gr[7];
    const int sb = gr[8], span = gr[9], first = gr[10], last = gr[11];
    const int n_nt = round_up(fs, 8) / 8, n_ks = cp / 16;

    if (has_w && first) {  // the group's w columns (not the w leg's), its dw accumulator
      if constexpr (kSh) {
        if (keep_dw)
          for (int i = tid; i < kTile * sps; i += kThreads1) s_dw[i] = 0.f;
      } else if constexpr (kLeg != kLegX) {
        for (int i = tid; i < kTile * sps; i += kThreads1) s_dw[i] = 0.f;
      }
      const int nv = kLeg != kLegW && !kBuildW ? sps / V : 0;
      for (int i = tid; i < n_live * nv; i += kThreads1) {
        const int r = i / nv;
        const int jl = (i - r * nv) * V;
        if (jl >= span) continue;
        const T* wr = w + (long long)(e0 + r) * d_w;
        T* sw = s_w + r * sps + jl;
        if (span_chunk_vec<T>(dwmap, sb, jl, span, dw_vec)) {
          *reinterpret_cast<uint4*>(sw) =
              __ldg(reinterpret_cast<const uint4*>(wr + __ldg(dwmap + sb + jl)));
        } else {
          for (int j = 0; j < V && jl + j < span; ++j) sw[j] = wr[__ldg(dwmap + sb + jl + j)];
        }
      }
      if constexpr (kBuildW) {
        // w[16, span] = h Wr_g + offset_g on the tensor cores, rounded to the
        // dtype: warp w takes the span's n-tiles w, w + 16, ...
        const T* Bp = static_cast<const T*>(rad.pk) + __ldg(rad.rgk + 2 * qi);
        const T* off = static_cast<const T*>(rad.Wl) + (long long)hd * rad.n_loc + sb;
        const int n_wt = round_up(span, 8) / 8;
        for (int nt0 = warp; nt0 < n_wt; nt0 += kWarps1 * kNT) {
          const int n_mine = min(kNT, (n_wt - nt0 + kWarps1 - 1) / kWarps1);
          float acc[kNT][4];
          mma_tile<T, kNT>(acc, s_h, ldh, Bp, hd16 / 16, hd16 / 16, nt0, kWarps1, n_mine, lane);
#pragma unroll
          for (int i = 0; i < kNT; ++i)
            if (i < n_mine)
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int r = gq + 8 * (u >> 1), c = (nt0 + i * kWarps1) * 8 + 2 * q + (u & 1);
                if (c < span) s_w[r * sps + c] = from_f<T>(acc[i][u] + to_f(off[c]));
              }
        }
      }
    }
    // ---- stage G[g,k] [16, cp] (zero rows past the real edges, zero pad columns)
    if constexpr (kStage >= 1) {
      const bool g_vec = out_col % V == 0 && d_out % V == 0 && aligned16(G);
      const int nv = cp / V;
      for (int i = tid; i < kTile * nv; i += kThreads1) {
        const int r = i / nv;
        const int c = (i - r * nv) * V;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_live) {
          const T* gp = G + (long long)(e0 + r) * d_out + out_col + c;
          if (g_vec && c + V <= cols) {
            u = __ldg(reinterpret_cast<const uint4*>(gp));
          } else {
            T* t = reinterpret_cast<T*>(&u);
            for (int j = 0; j < V && c + j < cols; ++j) t[j] = gp[j];
          }
        }
        *reinterpret_cast<uint4*>(s_g + r * ldg + c) = u;
      }
    }
    __syncthreads();

    // ---- dz[16, fan] = G[16, cp] W_g^T[cp, fan]: warp w takes n-tiles w, w + 16, ...
    if constexpr (kStage >= 2) {
      for (int nt0 = warp; nt0 < n_nt; nt0 += kWarps1 * kNT) {
        const int n_mine = min(kNT, (n_nt - nt0 + kWarps1 - 1) / kWarps1);  // live n-tiles
        float acc[kNT][4];
#pragma unroll
        for (int i = 0; i < kNT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int ks = 0; ks < n_ks; ++ks) {
          const int c0 = ks * 16 + 2 * q;
          if constexpr (sizeof(T) == 4) {
            float a[2][4];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float2 lo = *reinterpret_cast<const float2*>(s_g + gq * ldg + c0 + 8 * s);
              const float2 hi =
                  *reinterpret_cast<const float2*>(s_g + (gq + 8) * ldg + c0 + 8 * s);
              a[s][0] = lo.x;
              a[s][1] = hi.x;
              a[s][2] = lo.y;
              a[s][3] = hi.y;
            }
            float b[kNT][2][2];
#pragma unroll
            for (int i = 0; i < kNT; ++i)
              if (i < n_mine) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(
                    Wp + wp_off + ((long long)((nt0 + i * kWarps1) * n_ks + ks) * 32 + lane) * 4));
                b[i][0][0] = v.x;
                b[i][0][1] = v.y;
                b[i][1][0] = v.z;
                b[i][1][1] = v.w;
              }
            if constexpr (kMask)
              mma_fold<T, kNT>(acc, a, b, n_mine);
            else
              mma16n<T, kNT>(acc, a, b, n_mine);
          } else {
            const uint32_t* g32 = reinterpret_cast<const uint32_t*>(s_g);
            const uint32_t a[4] = {g32[(gq * ldg + c0) / 2], g32[((gq + 8) * ldg + c0) / 2],
                                   g32[(gq * ldg + c0 + 8) / 2],
                                   g32[((gq + 8) * ldg + c0 + 8) / 2]};
            uint2 v[kNT];
#pragma unroll
            for (int i = 0; i < kNT; ++i)
              if (i < n_mine)
                v[i] = __ldg(reinterpret_cast<const uint2*>(
                    Wp + wp_off + ((long long)((nt0 + i * kWarps1) * n_ks + ks) * 32 + lane) * 4));
#pragma unroll
            for (int i = 0; i < kNT; ++i)
              if (i < n_mine) mma_bf16(acc[i], a, v[i].x, v[i].y);
          }
        }
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          if (i < n_mine) {
            const int f = (nt0 + i * kWarps1) * 8 + 2 * q;
            *reinterpret_cast<float2*>(s_dz + gq * ldz + f) = make_float2(acc[i][0], acc[i][1]);
            *reinterpret_cast<float2*>(s_dz + (gq + 8) * ldz + f) =
                make_float2(acc[i][2], acc[i][3]);
          }
        }
      }
    }
    __syncthreads();

    // ---- term transposes off dz: within one (g, k) a dx / dw element is only
    // touched by one thread: element (row, u) of a term goes to thread
    // (row * mul + u) % kThreads1, and terms that share a column share mul.
    // The dsh legs add each term's row sums (c x w dz over u) to the term's
    // slots of s_slot, each slot written once.
    if constexpr (kStage >= 3 && kSh) {
      // x[r, col]: staged, or (kXg) through L2
      auto x_at = [&](int r, int col) -> float {
        if constexpr (kXg)
          return to_f(__ldg(x + (long long)(e0 + r) * sx + col));
        else
          return to_f(s_x[(sx ? r * dxs : 0) + col]);
      };
      // the next term's fields, loaded a term ahead (a warp takes only a few
      // elements of a term: the loads' latency would stall it)
      Term nx = t_begin < t_end ? load_term(terms, coeffs, t_begin) : Term{};
      for (int t = t_begin; t < t_end; ++t) {
        const Term tm = nx;
        if (t + 1 < t_end) nx = load_term(terms, coeffs, t + 1);
        const int a = tm.a, col = tm.col, fc = tm.fc, mul = tm.mul, bl = tm.bl;
        const float c = tm.c;
        float* slot = s_slot + (t - t_begin);  // the term's slot in each row
        if (mul % 32 == 0) {
          // warp r takes row r, lane l its u = l, l + 32, ...: the lane sums
          // them in order, then one butterfly sums the row
          const int r = warp;
          if (r < n_live) {  // warp-uniform
            float s = 0.f;
            for (int u = lane; u < mul; u += 32) {
              const float dzv = s_dz[r * ldz + fc + u];
              const float xv = x_at(r, a + u);
              const float wv = has_w ? to_f(s_w[r * sps + bl + u]) : 1.f;
              if constexpr (keep_dx || keep_dw) {
                const float d = c * s_sh[r * d_sh + col] * dzv;
                if constexpr (keep_dx) s_dx[r * dxs + a + u] += d * wv;
                if constexpr (keep_dw) s_dw[r * sps + bl + u] += d * xv;
              }
              if constexpr (keep_dsh) s = fmaf(c * xv * wv, dzv, s);
            }
            if constexpr (keep_dsh) {
              for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
              if (lane == 0) slot[r * slot_max] = s;
            }
          }
        } else if ((mul & (mul - 1)) == 0) {
          // a power of two below 32: K2's element (row, u) on thread row *
          // mul + u, one pass, a row's u in mul consecutive lanes
          const int lg = __ffs(mul) - 1, u = tid & (mul - 1), r = tid >> lg;
          float s = 0.f;
          if (r < n_live) {
            const float dzv = s_dz[r * ldz + fc + u];
            const float xv = x_at(r, a + u);
            const float wv = has_w ? to_f(s_w[r * sps + bl + u]) : 1.f;
            if constexpr (keep_dx || keep_dw) {
              const float d = c * s_sh[r * d_sh + col] * dzv;
              if constexpr (keep_dx) s_dx[r * dxs + a + u] += d * wv;
              if constexpr (keep_dw) s_dw[r * sps + bl + u] += d * xv;
            }
            if constexpr (keep_dsh) s = c * xv * wv * dzv;
          }
          if constexpr (keep_dsh) {  // the row's sum over its lanes: a fixed butterfly
            for (int o = mul >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if (r < n_live && u == 0) slot[r * slot_max] = s;
          }
        } else {
          if constexpr (keep_dx || keep_dw)
            for (int i = tid; i < n_live * mul; i += kThreads1) {
              const int r = i / mul, u = i - r * mul;
              const float d = c * s_sh[r * d_sh + col] * s_dz[r * ldz + fc + u];
              if constexpr (keep_dx)
                s_dx[r * dxs + a + u] += has_w ? d * to_f(s_w[r * sps + bl + u]) : d;
              if constexpr (keep_dw) s_dw[r * sps + bl + u] += d * x_at(r, a + u);
            }
          if constexpr (keep_dsh)  // one thread a row sums its u in order
            for (int r = tid; r < n_live; r += kThreads1) {
              float s = 0.f;
              for (int u = 0; u < mul; ++u) {
                const float wv = has_w ? to_f(s_w[r * sps + bl + u]) : 1.f;
                s = fmaf(c * x_at(r, a + u) * wv, s_dz[r * ldz + fc + u], s);
              }
              slot[r * slot_max] = s;
            }
        }
      }
    } else if constexpr (kStage >= 3) {
      for (int t = t_begin; t < t_end; ++t) {
        const int* tt = terms + t * kTermFields;
        const int a = tt[0], col = tt[1], fc = tt[3], mul = tt[4], bl = tt[5];
        const float c = coeffs[t];
        if ((mul & (mul - 1)) == 0 && mul <= kThreads1) {  // a power of two: no division
          const int lg = __ffs(mul) - 1, u = tid & (mul - 1);
          const float* dz = s_dz + fc + u;
          const float* shc = s_sh + col;
          float* dxp = s_dx + a + u;
          float* dwp = s_dw + bl + u;
          const T* wp = s_w + bl + u;
          const T* xp = s_x + a + u;
          for (int r = tid >> lg; r < n_live; r += kThreads1 >> lg) {
            const float d = c * shc[r * d_sh] * dz[r * ldz];
            if constexpr (kLeg == kLegX) {
              dxp[r * dxs] += has_w ? d * to_f(wp[r * sps]) : d;
            } else if constexpr (kLeg == kLegW) {
              dwp[r * sps] += d * to_f(xp[(sx ? r : 0) * dxs]);
            } else if (has_w) {
              dxp[r * dxs] += d * to_f(wp[r * sps]);
              dwp[r * sps] += d * to_f(xp[(sx ? r : 0) * dxs]);
            } else {
              dxp[r * dxs] += d;
            }
          }
        } else {
          for (int i = tid; i < n_live * mul; i += kThreads1) {
            const int r = i / mul, u = i - r * mul;
            const float d = c * s_sh[r * d_sh + col] * s_dz[r * ldz + fc + u];
            if constexpr (kLeg == kLegX) {
              s_dx[r * dxs + a + u] += has_w ? d * to_f(s_w[r * sps + bl + u]) : d;
            } else if constexpr (kLeg == kLegW) {
              s_dw[r * sps + bl + u] += d * to_f(s_x[(sx ? r : 0) * dxs + a + u]);
            } else if (has_w) {
              s_dx[r * dxs + a + u] += d * to_f(s_w[r * sps + bl + u]);
              s_dw[r * sps + bl + u] += d * to_f(s_x[(sx ? r : 0) * dxs + a + u]);
            } else {
              s_dx[r * dxs + a + u] += d;
            }
          }
        }
      }
    }
    __syncthreads();

    if constexpr (keep_dsh && kStage >= 3) {
      // dsh[r, col] += the slots of the terms of column col, in term order
      for (int i = tid; i < n_live * d_sh; i += kThreads1) {
        const int r = i / d_sh, col = i - r * d_sh;
        const float* sr = s_slot + r * slot_max;
        float acc = s_dsh[i];
#pragma unroll 4
        for (int t = t_begin; t < t_end; ++t)
          if (__ldg(terms + t * kTermFields + 1) == col) acc += sr[t - t_begin];
        s_dsh[i] = acc;
      }
    }

    if (kLeg != kLegX && (kSh ? keep_dw : true) && has_w && last) {  // the group's dw is complete
      if constexpr (!kRad) {  // (the fold's legs keep dw on chip)
        const int nv = sps / V;
        for (int i = tid; i < n_rows * nv; i += kThreads1) {
          const int r = i / nv;
          const int jl = (i - r * nv) * V;
          if (jl >= span) continue;
          T* dr = dw + (long long)(e0 + r) * d_w;
          const float* sd = s_dw + r * sps + jl;
          if (span_chunk_vec<T>(dwmap, sb, jl, span, dw_vec)) {
            uint4 u;
            T* t = reinterpret_cast<T*>(&u);
#pragma unroll
            for (int j = 0; j < V; ++j) t[j] = from_f<T>(sd[j]);
            *reinterpret_cast<uint4*>(dr + __ldg(dwmap + sb + jl)) = u;
          } else {
            for (int j = 0; j < V && jl + j < span; ++j)
              dr[__ldg(dwmap + sb + jl + j)] = from_f<T>(sd[j]);
          }
        }
      }
      if constexpr (kDh) {
        // dh[16, hd] += dw_g Wr_g^T on the tensor cores: dh's n-tile i goes
        // to warps i and i + 8, which take the first and the second half of
        // the span's K steps; the second half's sum goes through a scratch
        // tile and is added after the first's (each dh element one lane's,
        // one order)
        const T* Bp = static_cast<const T*>(rad.pk) + __ldg(rad.rgk + 2 * qi + 1);
        const int n_ht = round_up(hd, 8) / 8, n_kd = round_up(span, 16) / 16;
        const int half = warp / (kWarps1 / 2), k_lo = half ? n_kd / 2 : 0;
        const int k_n = half ? n_kd - n_kd / 2 : n_kd / 2;
        float acc[1][4];
        for (int nt = warp % (kWarps1 / 2); nt < n_ht; nt += kWarps1 / 2) {
          mma_tile<T, 1>(acc, s_dw + 16 * k_lo, sps, Bp + (long long)k_lo * 128, k_n, n_kd, nt,
                         0, 1, lane);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = gq + 8 * (u >> 1), j = nt * 8 + 2 * q + (u & 1);
            if (j >= hd) continue;
            if (half)
              s_dh[(kTile + r) * hd + j] = acc[0][u];
            else
              s_dh[r * hd + j] += acc[0][u];
          }
        }
        __syncthreads();
        for (int i = tid; i < kTile * hd; i += kThreads1) s_dh[i] += s_dh[kTile * hd + i];
      }
      __syncthreads();  // s_dw is zeroed by the next group
    }
  }

  if constexpr (kLeg == kLegW && !kHLeg) return;
  if constexpr (kDh) {  // dh once a tile (rows past the real edges: zero dw, zero dh)
    if (split) {  // this split's fp32 partial of dh (the h leg, K7-B3)
      float* pr = part_dh + ((long long)blockIdx.y * E + e0) * hd;
      for (int i = tid; i < n_rows * hd; i += kThreads1) pr[i] = s_dh[i];
    } else {
      T* dh = static_cast<T*>(rad.dh);
      for (int i = tid; i < n_rows * hd; i += kThreads1)
        dh[(long long)e0 * hd + i] = from_f<T>(s_dh[i]);
    }
    if constexpr (kHLeg) return;
  }
  if constexpr (kSh) {
    if (keep_dsh) {
      if (split) {  // this split's fp32 partial of dsh
        float* pr = part_sh + ((long long)blockIdx.y * E + e0) * d_sh;
        for (int i = tid; i < n_rows * d_sh; i += kThreads1) pr[i] = s_dsh[i];
      } else {
        for (int i = tid; i < n_rows * d_sh; i += kThreads1)
          dsh[(long long)e0 * d_sh + i] = from_f<T>(s_dsh[i]);
      }
    }
    if (!keep_dx) return;
  }
  if (split) {  // this split's fp32 partial of dx
    float* pr = part + ((long long)blockIdx.y * E + e0) * d_x;
    for (int i = tid; i < n_rows * d_x; i += kThreads1) {
      const int r = i / d_x;
      pr[i] = s_dx[r * dxs + (i - r * d_x)];
    }
    return;
  }
  const int nv = dx_vec ? d_x / V : 0;
  for (int i = tid; i < n_rows * nv; i += kThreads1) {
    const int r = i / nv;
    const int c = (i - r * nv) * V;
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = from_f<T>(s_dx[r * dxs + c + j]);
    *reinterpret_cast<uint4*>(dx + (long long)(e0 + r) * d_x + c) = u;
  }
  if (!dx_vec)
    for (int i = tid; i < n_rows * d_x; i += kThreads1) {
      const int r = i / d_x;
      dx[(long long)(e0 + r) * d_x + (i - r * d_x)] = from_f<T>(s_dx[r * dxs + (i - r * d_x)]);
    }
}

#define EQT_K2_DXDW_PARAMS                                                                       \
  const T *__restrict__ x, long long sx, int d_x, const T *__restrict__ sh, int d_sh,            \
      const T *__restrict__ w, int d_w, const T *__restrict__ Wp, const T *__restrict__ G,       \
      int d_out, const int *__restrict__ n_edges_ptr, int E, const int *__restrict__ gk,         \
      int n_gk, const int *__restrict__ terms, const float *__restrict__ coeffs,                 \
      const int *__restrict__ dwmap, T *__restrict__ dx, T *__restrict__ dw, int span_max,       \
      int cp_max, int fd_max
#define EQT_K2_DXDW_ARGS                                                                         \
  x, sx, d_x, sh, d_sh, w, d_w, Wp, G, d_out, n_edges_ptr, E, gk, n_gk, terms, coeffs, dwmap,    \
      dx, dw, span_max, cp_max, fd_max

// K2's launch 1 (S3: cut after phase kStage)
template <typename T, int kStage>
__global__ void __launch_bounds__(kThreads1, 1) dxdw_kernel(EQT_K2_DXDW_PARAMS) {
  dxdw_body<T, kStage, kDxDw>(EQT_K2_DXDW_ARGS, nullptr);
}

// K8-B's launch 1 (dx, dw): K2's on the kron tables, under its own name
template <typename T>
__global__ void __launch_bounds__(kThreads1, 1) kron_dxdw_kernel(EQT_K2_DXDW_PARAMS) {
  dxdw_body<T, kFullStage, kDxDw, false, kNeedAll, true>(EQT_K2_DXDW_ARGS, nullptr);
}

// K5b: the x leg (x null, dw null) or the w leg (w null, dx null), grid
// (tiles, splits)
template <typename T, int kLeg>
__global__ void __launch_bounds__(kThreads1, 1)
edge_leg_kernel(EQT_K2_DXDW_PARAMS, float* __restrict__ part) {
  dxdw_body<T, kFullStage, kLeg>(EQT_K2_DXDW_ARGS, part);
}

// K5a: the outputs in kNeed (two or three of dx, dsh, dw; the others
// null), grid (tiles, splits); kXg: x read through L2
template <typename T, bool kXg, int kNeed>
__global__ void __launch_bounds__(kThreads1, 1)
bwd3_kernel(EQT_K2_DXDW_PARAMS, float* __restrict__ part, T* __restrict__ dsh,
            float* __restrict__ part_sh, int slot_max) {
  dxdw_body<T, kFullStage, kBwd3, kXg, kNeed>(EQT_K2_DXDW_ARGS, part, dsh, part_sh, slot_max);
}

// K7-B3: K5a with the fold, the outputs in kNeed (two or three of dx, dsh
// and dh, its dw bit; w and dw null), grid (tiles, splits); kXg: x read
// through L2; the fp32 products split by masking
template <typename T, bool kXg, int kNeed>
__global__ void __launch_bounds__(kThreads1, 1)
rad_bwd3_kernel(EQT_K2_DXDW_PARAMS, float* __restrict__ part, T* __restrict__ dsh,
                float* __restrict__ part_sh, int slot_max, const RadOps rad) {
  dxdw_body<T, kFullStage, kBwd3, kXg, kNeed, true, true>(EQT_K2_DXDW_ARGS, part, dsh, part_sh,
                                                          slot_max, rad);
}

// K5b's sh leg: dsh alone (sh, dx and dw null), grid (tiles, splits)
template <typename T>
__global__ void __launch_bounds__(kThreads1, 1)
sh_leg_kernel(EQT_K2_DXDW_PARAMS, T* __restrict__ dsh, float* __restrict__ part_sh,
              int slot_max) {
  dxdw_body<T, kFullStage, kLegSh>(EQT_K2_DXDW_ARGS, nullptr, dsh, part_sh, slot_max);
}

// K7-B's launch 1: dx, dw (to the workspace) and dh, w built from h
template <typename T>
__global__ void __launch_bounds__(kThreads1, 1)
rad_dxdw_kernel(EQT_K2_DXDW_PARAMS, const RadOps rad) {
  dxdw_body<T, kFullStage, kRadB>(EQT_K2_DXDW_ARGS, nullptr, nullptr, nullptr, 0, rad);
}

// K7-L: the folded x, sh and h legs (kLegX, kLegSh and kLegW with the fold),
// grid (tiles, splits); the fp32 products split by masking
template <typename T, int kLeg>
__global__ void __launch_bounds__(kThreads1, 1)
rad_leg_kernel(EQT_K2_DXDW_PARAMS, float* __restrict__ part, T* __restrict__ dsh,
               float* __restrict__ part_sh, int slot_max, const RadOps rad) {
  dxdw_body<T, kFullStage, kLeg, false, kNeedAll, true, true>(EQT_K2_DXDW_ARGS, part, dsh,
                                                              part_sh, slot_max, rad);
}

// the split partials of a leg launch summed in split order, rows at or past
// *n_edges zeros (their tiles wrote no partial): out[k] [E, d[k]] from
// part[k] [n_split, E, d[k]], k = 0, 1, 2 in turn (each pair null when the
// launch keeps no such output), one thread an element.  (The kernel takes
// them as separate arguments: a struct argument indexed by k went to a
// 64-byte stack frame and the sums took ~2.5x as long on an H100.)
struct SplitSums {
  const float* part[3];
  int d[3];
  void* out[3];
};

// the elements of the outputs a SplitSums sums
inline long long split_numel(const SplitSums& p, int E) {
  long long n = 0;
  for (int k = 0; k < 3; ++k) n += p.out[k] != nullptr ? (long long)E * p.d[k] : 0;
  return n;
}

// dx of K5b's x leg; dx, dsh and dh of K5a and K7-B3, or dsh of the sh leg,
// in one launch
template <typename T>
__global__ void __launch_bounds__(eqt::kReduceThreads)
split_sum_kernel(const float* __restrict__ part_a, int d_a, T* __restrict__ out_a,
                 const float* __restrict__ part_b, int d_b, T* __restrict__ out_b,
                 const float* __restrict__ part_c, int d_c, T* __restrict__ out_c, int n_split,
                 int E, const int* __restrict__ n_edges_ptr) {
  const long long n_a = out_a != nullptr ? (long long)E * d_a : 0;
  const long long n_b = out_b != nullptr ? (long long)E * d_b : 0;
  const long long n_c = out_c != nullptr ? (long long)E * d_c : 0;
  long long i = (long long)blockIdx.x * eqt::kReduceThreads + threadIdx.x;
  if (i >= n_a + n_b + n_c) return;
  const int k = i < n_a ? 0 : i < n_a + n_b ? 1 : 2;
  const float* part = k == 0 ? part_a : k == 1 ? part_b : part_c;
  T* out = k == 0 ? out_a : k == 1 ? out_b : out_c;
  const long long numel = k == 0 ? n_a : k == 1 ? n_b : n_c;
  i -= k == 0 ? 0 : k == 1 ? n_a : n_a + n_b;
  float acc = 0.f;
  if (i / (k == 0 ? d_a : k == 1 ? d_b : d_c) < __ldg(n_edges_ptr))
    for (int s = 0; s < n_split; ++s) acc += part[s * numel + i];
  out[i] = from_f<T>(acc);
}

// launch split_sum_kernel<T> over the outputs of p (none: nothing to do)
template <typename T>
int launch_split_sum(const SplitSums& p, int n_split, int E, const void* n_edges,
                     cudaStream_t stream) {
  const long long numel = split_numel(p, E);
  if (numel == 0) return 0;
  split_sum_kernel<T><<<(unsigned)((numel + eqt::kReduceThreads - 1) / eqt::kReduceThreads),
                        eqt::kReduceThreads, 0, stream>>>(
      p.part[0], p.d[0], static_cast<T*>(p.out[0]), p.part[1], p.d[1], static_cast<T*>(p.out[1]),
      p.part[2], p.d[2], static_cast<T*>(p.out[2]), n_split, E, static_cast<const int*>(n_edges));
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- launch 2
// Block (tile, range): the fp32 partial of dW_g[f0 : f0 + fm, j0 : j0 + fn]
// over the edges of one range, summed on the tensor cores in registers:
// per step of 64 edges and component k, z[g,k]'s fan slice is recomputed
// from the terms that reach it and G[g,k]'s column slice staged (16-byte
// loads), then acc += z^T G.  The partial is written once, to row `range`
// of part.
#define EQT_K2_DW_PARAMS                                                                         \
  const T *__restrict__ x, long long sx, const T *__restrict__ sh, int d_sh,                     \
      const T *__restrict__ w, int d_w, const T *__restrict__ G, int d_out,                      \
      const int *__restrict__ n_edges_ptr, int E, const int *__restrict__ gk,                    \
      const int *__restrict__ tiles, const int *__restrict__ terms,                              \
      const float *__restrict__ coeffs, float *__restrict__ part, int w_numel, int range_len
#define EQT_K2_DW_ARGS \
  x, sx, sh, d_sh, w, d_w, G, d_out, n_edges_ptr, E, gk, tiles, terms, coeffs, part, w_numel, range_len

// K7-B's w fan slice of a dW tile: [kEdges2][kLdw2] in the dtype
constexpr int kLdw2 = kFanTile + 8;

// the shared memory of a launch-2 block (bytes): K2's; with the fold also
// the w fan slice
template <typename T>
__host__ __device__ inline int smem2(int d_sh, bool rad) {
  return (kEdges2 * (kLdz2 + kLdg2) + kEdges2 * d_sh) * 4 +
         (rad ? kEdges2 * kLdw2 * (int)sizeof(T) : 0);
}

// kMask: the fp32 dW product's 3xTF32 split by masking (mma_fold; K8-B,
// K7-LW), else by conversion (mma16n; K2, K5c, K7-B)
template <typename T, int kStage, bool kRad = false, bool kMask = false>
__device__ __forceinline__ void dW_body(EQT_K2_DW_PARAMS, const RadOps* rad = nullptr) {
  constexpr int V = kVec<T>;
  extern __shared__ float4 smem4[];
  float* s_z = reinterpret_cast<float*>(smem4);  // [kEdges2][kLdz2]: z[e][f - f0]
  float* s_g = s_z + kEdges2 * kLdz2;              // [kEdges2][kLdg2]: G[e][j - j0]
  float* s_sh = s_g + kEdges2 * kLdg2;             // [kEdges2][d_sh]
  // K7-B: the step's h [kEdges2][ldh] (dtype) over G's buffer before G, and
  // w's fan slice [kEdges2][kLdw2] (dtype) after sh
  T* s_h = reinterpret_cast<T*>(s_g);
  T* s_w = reinterpret_cast<T*>(s_sh + kEdges2 * d_sh);

  const int* tl = tiles + blockIdx.x * kTileFields;
  const int q0 = tl[0], n_comp = tl[1], f0 = tl[2], fm = tl[3], j0 = tl[4], fn = tl[5];
  const int cols = gk[q0 * kGkFields + 1], w_off = gk[q0 * kGkFields + 3];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int mt = warp & 3;          // 16 fan rows
  const int nt0 = (warp >> 2) * 8;  // 8 n-tiles: 64 columns, in two halves of 4
  const bool live_m = mt * 16 < fm;
  const int n_mine = min(8, max(0, (fn - nt0 * 8 + 7) / 8));  // live n-tiles
  const int r_begin = blockIdx.y * range_len;
  const int r_end = min(min(E, r_begin + range_len), __ldg(n_edges_ptr));
  const bool g_vec = d_out % V == 0 && fn % V == 0 && aligned16(G);
  const int hd = kRad ? rad->hd : 0, hd16 = round_up(hd, 16), ldh = ld_h<T>(hd);

  float acc[2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;

  for (int e0 = r_begin; e0 < r_end; e0 += kEdges2) {
    const int n_live = min(kEdges2, r_end - e0);
    for (int i = tid; i < n_live * d_sh; i += kThreads2)
      s_sh[i] = to_f(sh[(long long)e0 * d_sh + i]);
    if constexpr (kRad) {
      // w[e, f0 : f0 + fm] = [h, 1] Wl on the tensor cores, rounded to the
      // dtype: warp (mt, half) takes 16 edges by 4 n-tiles, 2 at a time
      // (fewer live registers: two blocks an SM), fan column f the group's
      // local w column sb + f
      const T* h = static_cast<const T*>(rad->h);
      for (int i = tid; i < kEdges2 * hd16; i += kThreads2) {
        const int r = i / hd16, c = i - r * hd16;
        s_h[r * ldh + c] = r < n_live && c < hd ? h[(long long)(e0 + r) * hd + c] : from_f<T>(0.f);
      }
      __syncthreads();
      const int sb = gk[q0 * kGkFields + 8], span = gk[q0 * kGkFields + 9];
      const T* Bp = static_cast<const T*>(rad->pk) + __ldg(rad->rgk + 2 * q0);
      const T* off = static_cast<const T*>(rad->Wl) + (long long)hd * rad->n_loc + sb + f0;
      for (int p2 = 0; p2 < 2; ++p2) {
        const int n_wt = min(2, max(0, (fm - (warp >> 2) * 32 - p2 * 16 + 7) / 8));
        if (n_wt == 0) continue;
        float acc[2][4];
        mma_tile<T, 2>(acc, s_h + mt * 16 * ldh, ldh, Bp, hd16 / 16, hd16 / 16,
                       f0 / 8 + (warp >> 2) * 4 + 2 * p2, 1, n_wt, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < n_wt)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = mt * 16 + gq + 8 * (u >> 1);
              const int c = ((warp >> 2) * 4 + 2 * p2 + i) * 8 + 2 * q + (u & 1);
              if (c < fm)  // (fan pad rows past the span: no term reads them)
                s_w[r * kLdw2 + c] = f0 + c < span ? from_f<T>(acc[i][u] + to_f(off[c]))
                                                   : from_f<T>(0.f);
            }
      }
      __syncthreads();  // G is staged over h below
    }
    for (int k = 0; k < n_comp; ++k) {
      const int* gr = gk + (q0 + k) * kGkFields;
      const int out_col = gr[2], t_begin = gr[4], t_end = gr[5];
      for (int i = tid; i < kEdges2 * kFanTile / 4; i += kThreads2) {
        const int r = i / (kFanTile / 4);
        *reinterpret_cast<float4*>(s_z + r * kLdz2 + (i - r * (kFanTile / 4)) * 4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      // G[e, out_col + j0 + c] as fp32, zero past n_live and fn
      const bool vec = g_vec && (out_col + j0) % V == 0;
      for (int i = tid; i < kEdges2 * (kColTile / V); i += kThreads2) {
        const int r = i / (kColTile / V);
        const int c = (i - r * (kColTile / V)) * V;
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
        if (r < n_live && c < fn) {
          const T* gp = G + (long long)(e0 + r) * d_out + out_col + j0 + c;
          if (vec) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(gp));
            const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = to_f(t[j]);
          } else {
            for (int j = 0; j < V && c + j < fn; ++j) v[j] = to_f(gp[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(s_g + r * kLdg2 + c + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
      __syncthreads();

      // ---- z[g,k][e, f0 : f0 + fm] from the terms that reach the slice (a
      // fan column is written by terms of one fc and mul: one thread each;
      // stepping over rows with a fixed column, as the transposes do, made
      // this phase ~25% slower)
      if constexpr (kStage >= 5) {
        for (int t = t_begin; t < t_end; ++t) {
          const int* tt = terms + t * kTermFields;
          const int fc = tt[3], mul = tt[4];
          const int lo = max(fc, f0), hi = min(fc + mul, f0 + fm);
          if (lo >= hi) continue;
          const int a = tt[0], col = tt[1], b = tt[2];
          const float c = coeffs[t];
          const int cnt = hi - lo;
          for (int i = tid; i < n_live * cnt; i += kThreads2) {
            const int r = i / cnt;
            const int f = lo + (i - r * cnt);
            const long long e = e0 + r;
            float v = c * s_sh[r * d_sh + col] * to_f(x[e * sx + a + f - fc]);
            if constexpr (kRad)
              v *= to_f(s_w[r * kLdw2 + f - f0]);
            else if (w != nullptr)
              v *= to_f(w[e * d_w + b + f - fc]);
            s_z[r * kLdz2 + f - f0] += v;
          }
        }
      }
      __syncthreads();

      // ---- acc[f, j] += sum_e z[e, f] G[e, j]: M = fan, N = columns, K = edges
      if constexpr (kStage >= 6) {
        if (live_m) {
#pragma unroll
          for (int ks = 0; ks < kEdges2 / 16; ++ks) {
            float a[2][4];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float* z0 = s_z + (ks * 16 + 2 * q + 8 * s) * kLdz2 + mt * 16 + gq;
              a[s][0] = z0[0];
              a[s][1] = z0[8];
              a[s][2] = z0[kLdz2];
              a[s][3] = z0[kLdz2 + 8];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n_h = min(4, max(0, n_mine - 4 * h));
              if (n_h == 0) continue;
              float b[4][2][2];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (i < n_h)
#pragma unroll
                  for (int s = 0; s < 2; ++s) {
                    const float* g0 =
                        s_g + (ks * 16 + 2 * q + 8 * s) * kLdg2 + (nt0 + 4 * h + i) * 8 + gq;
                    b[i][s][0] = g0[0];
                    b[i][s][1] = g0[kLdg2];
                  }
              if constexpr (kMask)
                mma_fold<T, 4>(acc[h], a, b, n_h);
              else
                mma16n<T, 4>(acc[h], a, b, n_h);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- the partial, once per range: row blockIdx.y, this tile's slice
  if (!live_m) return;
  float* pr = part + (long long)blockIdx.y * (kRad ? rad->part_ld : w_numel) + w_off;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (nt0 + 4 * h + i) * 8 + 2 * q;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int f = mt * 16 + gq + 8 * u;
        if (f >= fm) continue;
        if (j < fn) pr[(long long)(f0 + f) * cols + j0 + j] = acc[h][i][2 * u];
        if (j + 1 < fn) pr[(long long)(f0 + f) * cols + j0 + j + 1] = acc[h][i][2 * u + 1];
      }
    }
}

// K2's launch 2 (S3: cut after phase kStage)
template <typename T, int kStage>
__global__ void __launch_bounds__(kThreads2) dW_kernel(EQT_K2_DW_PARAMS) {
  dW_body<T, kStage>(EQT_K2_DW_ARGS);
}

// K5c: launch 2 on the head-weight leg's operands (x with any row stride, w
// null for shared weights folded into W).  Three blocks an SM (80 registers,
// ~300 bytes of spills in fp32) take 6-7% off K2's two at MD17's sites: the
// z recompute waits on its loads, and more warps hide them
template <typename T>
__global__ void __launch_bounds__(kThreads2, 3) W_leg_kernel(EQT_K2_DW_PARAMS) {
  dW_body<T, kFullStage>(EQT_K2_DW_ARGS);
}

// K8-B's launch 2 (dG): K2's dW tiles on the kron tables, under its own
// name; three blocks an SM (80 registers, ~400 bytes of spills in fp32)
// took 5-6% off two at the QM9 flagship's sep_act and edge degree
template <typename T>
__global__ void __launch_bounds__(kThreads2, 3) kron_dG_kernel(EQT_K2_DW_PARAMS) {
  dW_body<T, kFullStage, false, true>(EQT_K2_DW_ARGS);
}

// d[Wr; offset] tile t (rows j0 = 64 (t / column tiles) + [0, 64) of hd,
// local columns c0 = 128 (t % column tiles) + [0, 128)) of [h, one]^T dw over
// the edges of range blockIdx.y, below *n_edges: per step of 64 edges h's
// slice (A^T, as launch 2's z) and dw's (B, through dwmap, as launch 2's G)
// staged in fp32, the product on the tensor cores into registers (launch
// 2's warp tiles); the offset row, one x the column sums of dw, added in
// edge order by a thread a column of the tiles with j0 = 0.  Written once
// per range to row blockIdx.y of part at rad.base: [hd + 1, n_loc].
template <typename T>
__device__ __forceinline__ void dWr_body(const RadOps& rad, const int* __restrict__ n_edges_ptr,
                                         int E, int d_w, float* __restrict__ part, int range_len,
                                         int t) {
  extern __shared__ float4 smem4[];
  float* s_z = reinterpret_cast<float*>(smem4);  // [kEdges2][kLdz2]: h[e][j0 + f]
  float* s_g = s_z + kEdges2 * kLdz2;              // [kEdges2][kLdg2]: dw[e][c0 + j]
  const T* __restrict__ h = static_cast<const T*>(rad.h);
  const T* __restrict__ dw = static_cast<const T*>(rad.dw);
  const int hd = rad.hd, n_loc = rad.n_loc;
  const int n_ct = (n_loc + kColTile - 1) / kColTile;
  const int j0 = (t / n_ct) * kFanTile, c0 = (t % n_ct) * kColTile;
  const int fm = min(kFanTile, hd - j0), fn = min(kColTile, n_loc - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int mt = warp & 3;          // 16 hd rows
  const int nt0 = (warp >> 2) * 8;  // 8 n-tiles: 64 columns, in two halves of 4
  const bool live_m = mt * 16 < fm;
  const int n_mine = min(8, max(0, (fn - nt0 * 8 + 7) / 8));
  const int r_begin = blockIdx.y * range_len;
  const int r_end = min(min(E, r_begin + range_len), __ldg(n_edges_ptr));
  // each thread stages one column of each slice (tid % 64 of h's, tid % 128
  // of dw's), stepping over rows
  const int hc = tid & (kFanTile - 1), dc = tid & (kColTile - 1);
  const int dcol = dc < fn ? __ldg(rad.dwmap + c0 + dc) : 0;
  const bool offset_row = j0 == 0 && tid < fn;

  float acc[2][4][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][i][j] = 0.f;
  float dsum = 0.f;

  for (int e0 = r_begin; e0 < r_end; e0 += kEdges2) {
    const int n_live = min(kEdges2, r_end - e0);
    for (int r = tid / kFanTile; r < kEdges2; r += kThreads2 / kFanTile)
      s_z[r * kLdz2 + hc] =
          r < n_live && hc < fm ? to_f(h[(long long)(e0 + r) * hd + j0 + hc]) : 0.f;
    for (int r = tid / kColTile; r < kEdges2; r += kThreads2 / kColTile)
      s_g[r * kLdg2 + dc] = r < n_live && dc < fn ? to_f(dw[(long long)(e0 + r) * d_w + dcol]) : 0.f;
    __syncthreads();

    // ---- acc[j, c] += sum_e h[e, j] dw[e, c]: M = hd, N = columns, K = edges
    if (live_m) {
#pragma unroll
      for (int ks = 0; ks < kEdges2 / 16; ++ks) {
        float a[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* z0 = s_z + (ks * 16 + 2 * q + 8 * s) * kLdz2 + mt * 16 + gq;
          a[s][0] = z0[0];
          a[s][1] = z0[8];
          a[s][2] = z0[kLdz2];
          a[s][3] = z0[kLdz2 + 8];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n_h = min(4, max(0, n_mine - 4 * hh));
          if (n_h == 0) continue;
          float b[4][2][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < n_h)
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                const float* g0 =
                    s_g + (ks * 16 + 2 * q + 8 * s) * kLdg2 + (nt0 + 4 * hh + i) * 8 + gq;
                b[i][s][0] = g0[0];
                b[i][s][1] = g0[kLdg2];
              }
          mma_fold<T, 4>(acc[hh], a, b, n_h);
        }
      }
    }
    if (offset_row)  // the offset row: dw's column sum, in edge order
      for (int r = 0; r < n_live; ++r) dsum += s_g[r * kLdg2 + tid];
    __syncthreads();
  }

  // ---- the partial, once per range: row blockIdx.y, this tile's slice
  float* pr = part + (long long)blockIdx.y * rad.part_ld + rad.base;
  if (offset_row) pr[(long long)hd * n_loc + c0 + tid] = rad.one * dsum;
  if (!live_m) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (nt0 + 4 * hh + i) * 8 + 2 * q;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int f = mt * 16 + gq + 8 * u;
        if (f >= fm) continue;
        if (j < fn) pr[(long long)(j0 + f) * n_loc + c0 + j] = acc[hh][i][2 * u];
        if (j + 1 < fn) pr[(long long)(j0 + f) * n_loc + c0 + j + 1] = acc[hh][i][2 * u + 1];
      }
    }
}

// K7-B's launch 2: K2's dW tiles with w rebuilt from h (the first
// rad.n_dw_tiles blocks of x), then the d[Wr; offset] tiles; two blocks an
// SM (at most 128 registers: at one, 213 in fp32, it took 4.2 ms at QM9
// sep_act against 3.4)
template <typename T>
__global__ void __launch_bounds__(kThreads2, 2) rad_dW_kernel(EQT_K2_DW_PARAMS, const RadOps rad) {
  if ((int)blockIdx.x < rad.n_dw_tiles)
    dW_body<T, kFullStage, true>(EQT_K2_DW_ARGS, &rad);
  else
    dWr_body<T>(rad, n_edges_ptr, E, d_w, part, range_len, blockIdx.x - rad.n_dw_tiles);
}

// K7-LW: K7-B's launch 2 without the d[Wr; offset] tiles, under its own
// name; two blocks an SM (at most 128 registers), as rad_dW_kernel: three
// (K5c's) took 12% more in fp32 at MD17's sep_act and the same in bf16
template <typename T>
__global__ void __launch_bounds__(kThreads2, 2)
rad_W_leg_kernel(EQT_K2_DW_PARAMS, const RadOps rad) {
  dW_body<T, kFullStage, true, true>(EQT_K2_DW_ARGS, &rad);
}

// K7-Wr: the d[Wr; offset] tiles alone, on K5b's w leg's dw
template <typename T>
__global__ void __launch_bounds__(kThreads2)
Wr_leg_kernel(const RadOps rad, const int* __restrict__ n_edges_ptr, int E, int d_w,
              float* __restrict__ part, int range_len) {
  dWr_body<T>(rad, n_edges_ptr, E, d_w, part, range_len, blockIdx.x);
}

struct Args {
  const void *x, *sh, *w, *Wp, *G, *n_edges, *gk, *terms, *coeffs, *dwmap, *tiles;
  long long sx;
  int d_x, d_sh, d_w, d_out, E, n_gk, span_max, cp_max, fd_max, n_tiles, n_ranges, range_len,
      w_numel;
  void *dx, *dw, *part, *dW;
};

// K2's launch 1 (S3: cut after phase kStage1), or with kKron K8-B's
template <typename T, int kStage1, bool kKron = false>
int launch1(const Args& a, cudaStream_t stream) {
  const Layout1 L =
      layout1<T>(a.d_x, a.d_sh, a.span_max, a.cp_max, a.fd_max, a.w != nullptr, a.sx != 0);
  const auto kernel = kKron ? &kron_dxdw_kernel<T> : &dxdw_kernel<T, kStage1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.E + kTile - 1) / kTile, kThreads1, L.total, stream>>>(
      static_cast<const T*>(a.x), a.sx, a.d_x, static_cast<const T*>(a.sh), a.d_sh,
      static_cast<const T*>(a.w), a.d_w, static_cast<const T*>(a.Wp),
      static_cast<const T*>(a.G), a.d_out, static_cast<const int*>(a.n_edges), a.E,
      static_cast<const int*>(a.gk), a.n_gk, static_cast<const int*>(a.terms),
      static_cast<const float*>(a.coeffs), static_cast<const int*>(a.dwmap),
      static_cast<T*>(a.dx), static_cast<T*>(a.dw), a.span_max, a.cp_max, a.fd_max);
  return (int)cudaGetLastError();
}

// K5b: one edge leg on launch 1's code, the tiles cut by irrep group into
// n_split (the x leg's partials then summed in split order into dx)
template <typename T, int kLeg>
int launch_leg(const Args& a, int n_split, cudaStream_t stream) {
  const Layout1 L = layout1<T, kLeg>(a.d_x, a.d_sh, a.span_max, a.cp_max, a.fd_max,
                                     kLeg == kLegW || a.w != nullptr, a.sx != 0);
  cudaError_t err = cudaFuncSetAttribute(edge_leg_kernel<T, kLeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  edge_leg_kernel<T, kLeg><<<dim3((a.E + kTile - 1) / kTile, n_split), kThreads1, L.total,
                             stream>>>(
      static_cast<const T*>(a.x), a.sx, a.d_x, static_cast<const T*>(a.sh), a.d_sh,
      static_cast<const T*>(a.w), a.d_w, static_cast<const T*>(a.Wp),
      static_cast<const T*>(a.G), a.d_out, static_cast<const int*>(a.n_edges), a.E,
      static_cast<const int*>(a.gk), a.n_gk, static_cast<const int*>(a.terms),
      static_cast<const float*>(a.coeffs), static_cast<const int*>(a.dwmap),
      static_cast<T*>(a.dx), static_cast<T*>(a.dw), a.span_max, a.cp_max, a.fd_max,
      static_cast<float*>(a.part));
  err = cudaGetLastError();
  if (err != cudaSuccess || kLeg != kLegX || n_split == 1) return (int)err;
  const SplitSums p{{static_cast<const float*>(a.part)}, {a.d_x}, {a.dx}};
  return launch_split_sum<T>(p, n_split, a.E, a.n_edges, stream);
}

// the dsh legs' outputs and scratch: dsh [E, d_sh] (null: not asked for),
// part_sh [n_split, E, d_sh] fp32, slot_max dsh slots a row
struct DshArgs {
  void *dsh, *part_sh;
  int slot_max;
};

// K5a's (K7-B3's) outputs asked for: the non-null ones (K7-B3's dh for dw)
int need_of(const Args& a, const DshArgs& d, const RadOps& r) {
  return (a.dx != nullptr ? kNeedDx : 0) | (d.dsh != nullptr ? kNeedDsh : 0) |
         (a.dw != nullptr || r.dh != nullptr ? kNeedDw : 0);
}

// the shared memory of a dsh leg's launch (kLegSh reads x, w and G, K5a
// what kNeed asks for; x_global: K5a's x through L2; kRad: K7-B3, h and
// w built from it, dh's tiles with dh asked for)
template <typename T, int kLeg, int kNeed, bool kRad>
Layout1 dsh_layout(const Args& a, const DshArgs& d, bool x_global, int hd) {
  return layout1<T, kLeg, kRad>(a.d_x, a.d_sh, a.span_max, a.cp_max, a.fd_max,
                                kRad || a.w != nullptr, a.sx != 0, kNeed, d.slot_max, x_global,
                                hd);
}

// K5a and K7-B3 stage x in shared memory where the whole tile fits the
// block's limit (bf16 at MD17's sites), else (fp32 at sep_act) read it
// through L2
template <typename T, int kLeg, int kNeed, bool kRad>
bool x_global(const Args& a, const DshArgs& d, int hd) {
  if (kLeg != kBwd3) return false;
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return false;  // the launch then reports the error
  return dsh_layout<T, kLeg, kNeed, kRad>(a, d, false, hd).total > limit;
}

// the kernel of a dsh leg's launch
template <typename T, int kLeg, bool kXg, int kNeed, bool kRad>
auto dsh_kernel() {
  if constexpr (kLeg == kLegSh)
    return &sh_leg_kernel<T>;
  else if constexpr (kRad)
    return &rad_bwd3_kernel<T, kXg, kNeed>;
  else
    return &bwd3_kernel<T, kXg, kNeed>;
}

// K5a (kBwd3), K7-B3 (kBwd3 with kRad) or the sh leg (kLegSh) on launch 1's
// code, the tiles cut by irrep group into n_split (the dx, dsh and dh
// partials then summed in split order by one launch)
template <typename T, int kLeg, bool kXg, int kNeed, bool kRad>
int launch_dsh(const Args& a, const DshArgs& d, const RadOps& r, int n_split,
               cudaStream_t stream) {
  const int smem = dsh_layout<T, kLeg, kNeed, kRad>(a, d, kXg, r.hd).total;
  const auto kernel = dsh_kernel<T, kLeg, kXg, kNeed, kRad>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.E + kTile - 1) / kTile, n_split);
  const T* x = static_cast<const T*>(a.x);
  const T* sh = static_cast<const T*>(a.sh);
  const T* w = static_cast<const T*>(a.w);
  const T* Wp = static_cast<const T*>(a.Wp);
  const T* G = static_cast<const T*>(a.G);
  const int* n_edges = static_cast<const int*>(a.n_edges);
  const int* gk = static_cast<const int*>(a.gk);
  const int* terms = static_cast<const int*>(a.terms);
  const float* coeffs = static_cast<const float*>(a.coeffs);
  const int* dwmap = static_cast<const int*>(a.dwmap);
  T* dx = static_cast<T*>(a.dx);
  T* dw = static_cast<T*>(a.dw);
  T* dsh = static_cast<T*>(d.dsh);
  float* part_sh = static_cast<float*>(d.part_sh);
  if constexpr (kLeg == kLegSh)
    sh_leg_kernel<T><<<grid, kThreads1, smem, stream>>>(
        x, a.sx, a.d_x, sh, a.d_sh, w, a.d_w, Wp, G, a.d_out, n_edges, a.E, gk, a.n_gk, terms,
        coeffs, dwmap, dx, dw, a.span_max, a.cp_max, a.fd_max, dsh, part_sh, d.slot_max);
  else if constexpr (kRad)
    rad_bwd3_kernel<T, kXg, kNeed><<<grid, kThreads1, smem, stream>>>(
        x, a.sx, a.d_x, sh, a.d_sh, w, a.d_w, Wp, G, a.d_out, n_edges, a.E, gk, a.n_gk, terms,
        coeffs, dwmap, dx, dw, a.span_max, a.cp_max, a.fd_max, static_cast<float*>(a.part), dsh,
        part_sh, d.slot_max, r);
  else
    bwd3_kernel<T, kXg, kNeed><<<grid, kThreads1, smem, stream>>>(
        x, a.sx, a.d_x, sh, a.d_sh, w, a.d_w, Wp, G, a.d_out, n_edges, a.E, gk, a.n_gk, terms,
        coeffs, dwmap, dx, dw, a.span_max, a.cp_max, a.fd_max, static_cast<float*>(a.part), dsh,
        part_sh, d.slot_max);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const SplitSums p{{static_cast<const float*>(a.part), part_sh, r.part_dh},
                    {a.d_x, a.d_sh, r.hd},
                    {dx, dsh, kRad ? r.dh : nullptr}};
  return launch_split_sum<T>(p, n_split, a.E, a.n_edges, stream);
}

template <typename T, int kLeg, int kNeed = kNeedAll, bool kRad = false>
int dispatch_dsh(const Args& a, const DshArgs& d, const RadOps& r, int n_split, cudaStream_t s) {
  if constexpr (kLeg == kBwd3)
    if (x_global<T, kLeg, kNeed, kRad>(a, d, r.hd))
      return launch_dsh<T, kLeg, true, kNeed, kRad>(a, d, r, n_split, s);
  return launch_dsh<T, kLeg, false, kNeed, kRad>(a, d, r, n_split, s);
}

// K5a (K7-B3 with kRad) with the outputs asked for: each two- and
// three-output set on its own compile-time code (one output alone is that
// edge leg's launch, K5b's or K7-L's, which the Python wrapper calls)
template <typename T, bool kRad = false>
int dispatch_bwd3(const Args& a, const DshArgs& d, const RadOps& r, int n_split, cudaStream_t s) {
  switch (need_of(a, d, r)) {
    case kNeedAll: return dispatch_dsh<T, kBwd3, kNeedAll, kRad>(a, d, r, n_split, s);
    case kNeedDx | kNeedDsh:
      return dispatch_dsh<T, kBwd3, kNeedDx | kNeedDsh, kRad>(a, d, r, n_split, s);
    case kNeedDsh | kNeedDw:
      return dispatch_dsh<T, kBwd3, kNeedDsh | kNeedDw, kRad>(a, d, r, n_split, s);
    case kNeedDx | kNeedDw:
      return dispatch_dsh<T, kBwd3, kNeedDx | kNeedDw, kRad>(a, d, r, n_split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// resident blocks per SM of a dsh leg's launch, or minus a cudaError_t
template <typename T, int kLeg, int kNeed = kNeedAll, bool kRad = false>
int dsh_occupancy(const Args& a, const DshArgs& d, int hd) {
  const bool xg = x_global<T, kLeg, kNeed, kRad>(a, d, hd);
  const int smem = dsh_layout<T, kLeg, kNeed, kRad>(a, d, xg, hd).total;
  const auto kernel = xg ? dsh_kernel<T, kLeg, true, kNeed, kRad>()
                         : dsh_kernel<T, kLeg, false, kNeed, kRad>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads1, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename T, bool kRad = false>
int occupancy_bwd3(const Args& a, const DshArgs& d, const RadOps& r) {
  switch (need_of(a, d, r)) {
    case kNeedAll: return dsh_occupancy<T, kBwd3, kNeedAll, kRad>(a, d, r.hd);
    case kNeedDx | kNeedDsh: return dsh_occupancy<T, kBwd3, kNeedDx | kNeedDsh, kRad>(a, d, r.hd);
    case kNeedDsh | kNeedDw: return dsh_occupancy<T, kBwd3, kNeedDsh | kNeedDw, kRad>(a, d, r.hd);
    case kNeedDx | kNeedDw: return dsh_occupancy<T, kBwd3, kNeedDx | kNeedDw, kRad>(a, d, r.hd);
  }
  return -(int)cudaErrorInvalidValue;
}

// the kernel of a launch 2: K2's (S3: cut after phase kStage2), K5c's or
// K8-B's, each under its own name
enum Dw2 : int { kDwK2 = 0, kDwLegW = 1, kDwKron = 2 };

// launch 2 and the row sum
template <typename T, int kStage2, int kKind = kDwK2>
int launch2(const Args& a, cudaStream_t stream) {
  const int smem = (kEdges2 * (kLdz2 + kLdg2) + kEdges2 * a.d_sh) * (int)sizeof(float);
  const auto kernel = kKind == kDwLegW   ? &W_leg_kernel<T>
                      : kKind == kDwKron ? &kron_dG_kernel<T>
                                         : &dW_kernel<T, kStage2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.n_tiles, a.n_ranges), kThreads2, smem, stream>>>(
      static_cast<const T*>(a.x), a.sx, static_cast<const T*>(a.sh), a.d_sh,
      static_cast<const T*>(a.w), a.d_w, static_cast<const T*>(a.G), a.d_out,
      static_cast<const int*>(a.n_edges), a.E, static_cast<const int*>(a.gk),
      static_cast<const int*>(a.tiles), static_cast<const int*>(a.terms),
      static_cast<const float*>(a.coeffs), static_cast<float*>(a.part), a.w_numel,
      a.range_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW = the ranges' partial rows summed in range order
  return (int)eqt::sum_partial_rows(static_cast<const float*>(a.part), a.n_ranges, a.w_numel,
                                    static_cast<float*>(a.dW), stream);
}

// K2 cut after phase `stage` (kFullStage: K2 itself).  Launch 1 is K2's own
// from stage 3 on; launch 2 (and the reduction) runs from stage 4 on, so dW
// stays the wrapper's zeros before it.
template <typename T>
int launch_stage(int stage, const Args& a, cudaStream_t s) {
  int err = 0;
  switch (stage) {
    case 0: return launch1<T, 0>(a, s);
    case 1: return launch1<T, 1>(a, s);
    case 2: return launch1<T, 2>(a, s);
    case 3: return launch1<T, kFullStage>(a, s);
    case 4: err = launch1<T, kFullStage>(a, s); return err ? err : launch2<T, 4>(a, s);
    case 5: err = launch1<T, kFullStage>(a, s); return err ? err : launch2<T, 5>(a, s);
    case 6: err = launch1<T, kFullStage>(a, s); return err ? err : launch2<T, kFullStage>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// launch 2's edge ranges: whole steps, covering every row
bool ranges_ok(const Args& a) {
  return a.cp_max % 16 == 0 && a.n_ranges >= 1 && a.range_len % kEdges2 == 0 &&
         (long long)a.n_ranges * a.range_len >= a.E;
}

int run(int stage, const Args& a, int dtype, void* stream) {
  if (!ranges_ok(a)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return launch_stage<float>(stage, a, s);
  if (dtype == eqt::kBFloat16) return launch_stage<__nv_bfloat16>(stage, a, s);
  return (int)cudaErrorInvalidValue;
}

int run_leg(int leg, int n_split, const Args& a, int dtype, void* stream) {
  if (a.cp_max % 16 != 0 || n_split < 1 ||
      !(leg == kLegX ? a.dx != nullptr && (n_split == 1 || a.part != nullptr)
                     : leg == kLegW && a.dw != nullptr && a.x != nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return leg == kLegX ? launch_leg<float, kLegX>(a, n_split, s)
                        : launch_leg<float, kLegW>(a, n_split, s);
  if (dtype == eqt::kBFloat16)
    return leg == kLegX ? launch_leg<__nv_bfloat16, kLegX>(a, n_split, s)
                        : launch_leg<__nv_bfloat16, kLegW>(a, n_split, s);
  return (int)cudaErrorInvalidValue;
}

int run_legW(const Args& a, int dtype, void* stream) {
  if (!ranges_ok(a)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return launch2<float, kFullStage, kDwLegW>(a, s);
  if (dtype == eqt::kBFloat16) return launch2<__nv_bfloat16, kFullStage, kDwLegW>(a, s);
  return (int)cudaErrorInvalidValue;
}

// K8-B: K2's two launches and the row sum on the kron tables
template <typename T>
int launch_kron(const Args& a, cudaStream_t stream) {
  const int err = launch1<T, kFullStage, true>(a, stream);
  return err != 0 ? err : launch2<T, kFullStage, kDwKron>(a, stream);
}

int run_kron(const Args& a, int dtype, void* stream) {
  if (!ranges_ok(a) || a.dx == nullptr || (a.w == nullptr) != (a.dw == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return launch_kron<float>(a, s);
  if (dtype == eqt::kBFloat16) return launch_kron<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// K7-B: launch 1 (dx, dh, dw into the workspace a.dw, w built from h), launch
// 2 (the dW tiles with w rebuilt, then the d[Wr; offset] tiles: their
// partials in one row [w_numel + (hd + 1) n_loc] per range) and the row sum
// into a.dW
template <typename T>
int launch_rad(const Args& a, RadOps r, cudaStream_t stream) {
  const Layout1 L = layout1<T, kRadB>(a.d_x, a.d_sh, a.span_max, a.cp_max, a.fd_max, true,
                                      a.sx != 0, kNeedAll, 0, false, r.hd);
  cudaError_t err = cudaFuncSetAttribute(rad_dxdw_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return (int)err;
  rad_dxdw_kernel<T><<<(a.E + kTile - 1) / kTile, kThreads1, L.total, stream>>>(
      static_cast<const T*>(a.x), a.sx, a.d_x, static_cast<const T*>(a.sh), a.d_sh, nullptr,
      a.d_w, static_cast<const T*>(a.Wp), static_cast<const T*>(a.G), a.d_out,
      static_cast<const int*>(a.n_edges), a.E, static_cast<const int*>(a.gk), a.n_gk,
      static_cast<const int*>(a.terms), static_cast<const float*>(a.coeffs),
      static_cast<const int*>(a.dwmap), static_cast<T*>(a.dx), static_cast<T*>(a.dw),
      a.span_max, a.cp_max, a.fd_max, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  r.dw = a.dw;
  r.dwmap = static_cast<const int*>(a.dwmap);
  r.n_dw_tiles = a.n_tiles;
  r.base = a.w_numel;
  r.part_ld = a.w_numel + (r.hd + 1) * r.n_loc;
  r.one = 1.f;
  const int smem = smem2<T>(a.d_sh, true);
  err = cudaFuncSetAttribute(rad_dW_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rad_dW_kernel<T><<<dim3(a.n_tiles + wr_tiles(r.hd, r.n_loc), a.n_ranges), kThreads2, smem,
                     stream>>>(
      static_cast<const T*>(a.x), a.sx, static_cast<const T*>(a.sh), a.d_sh, nullptr, a.d_w,
      static_cast<const T*>(a.G), a.d_out, static_cast<const int*>(a.n_edges), a.E,
      static_cast<const int*>(a.gk), static_cast<const int*>(a.tiles),
      static_cast<const int*>(a.terms), static_cast<const float*>(a.coeffs),
      static_cast<float*>(a.part), a.w_numel, a.range_len, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)eqt::sum_partial_rows(static_cast<const float*>(a.part), a.n_ranges, r.part_ld,
                                    static_cast<float*>(a.dW), stream);
}

// K7-Wr: K5b's w leg into the workspace a.dw, the d[Wr; offset] tiles alone
// (partial rows [(hd + 1) n_loc] per range), the row sum into a.dW
template <typename T>
int launch_legWr(const Args& a, RadOps r, int n_split, cudaStream_t stream) {
  int status = launch_leg<T, kLegW>(a, n_split, stream);
  if (status != 0) return status;
  r.dw = a.dw;
  r.dwmap = static_cast<const int*>(a.dwmap);
  r.base = 0;
  r.part_ld = (r.hd + 1) * r.n_loc;
  const int smem = smem2<T>(0, false);
  cudaError_t err = cudaFuncSetAttribute(Wr_leg_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Wr_leg_kernel<T><<<dim3(wr_tiles(r.hd, r.n_loc), a.n_ranges), kThreads2, smem, stream>>>(
      r, static_cast<const int*>(a.n_edges), a.E, a.d_w, static_cast<float*>(a.part),
      a.range_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)eqt::sum_partial_rows(static_cast<const float*>(a.part), a.n_ranges, r.part_ld,
                                    static_cast<float*>(a.dW), stream);
}

// K7-LW: the w-rebuilding dW tiles alone (partial rows [w_numel] per
// range), the row sum into a.dW
template <typename T>
int launch_legW_rad(const Args& a, RadOps r, cudaStream_t stream) {
  r.part_ld = a.w_numel;
  const int smem = smem2<T>(a.d_sh, true);
  cudaError_t err = cudaFuncSetAttribute(rad_W_leg_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rad_W_leg_kernel<T><<<dim3(a.n_tiles, a.n_ranges), kThreads2, smem, stream>>>(
      static_cast<const T*>(a.x), a.sx, static_cast<const T*>(a.sh), a.d_sh, nullptr, a.d_w,
      static_cast<const T*>(a.G), a.d_out, static_cast<const int*>(a.n_edges), a.E,
      static_cast<const int*>(a.gk), static_cast<const int*>(a.tiles),
      static_cast<const int*>(a.terms), static_cast<const float*>(a.coeffs),
      static_cast<float*>(a.part), a.w_numel, a.range_len, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)eqt::sum_partial_rows(static_cast<const float*>(a.part), a.n_ranges, a.w_numel,
                                    static_cast<float*>(a.dW), stream);
}

// K7-L: one folded edge leg on launch 1's code (kLegX, kLegSh, or kLegW for
// the h leg), the tiles cut by irrep group into n_split; the splits' fp32
// partials of dx, dsh or dh then summed in split order by one launch
template <typename T, int kLeg>
int launch_rad_leg(const Args& a, const DshArgs& d, const RadOps& r, int n_split,
                   cudaStream_t stream) {
  const int smem = layout1<T, kLeg, true>(a.d_x, a.d_sh, a.span_max, a.cp_max, a.fd_max, true,
                                          a.sx != 0, kNeedAll, d.slot_max, false, r.hd)
                       .total;
  cudaError_t err = cudaFuncSetAttribute(rad_leg_kernel<T, kLeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rad_leg_kernel<T, kLeg><<<dim3((a.E + kTile - 1) / kTile, n_split), kThreads1, smem,
                            stream>>>(
      static_cast<const T*>(a.x), a.sx, a.d_x, static_cast<const T*>(a.sh), a.d_sh, nullptr,
      a.d_w, static_cast<const T*>(a.Wp), static_cast<const T*>(a.G), a.d_out,
      static_cast<const int*>(a.n_edges), a.E, static_cast<const int*>(a.gk), a.n_gk,
      static_cast<const int*>(a.terms), static_cast<const float*>(a.coeffs),
      static_cast<const int*>(a.dwmap), static_cast<T*>(a.dx), nullptr, a.span_max, a.cp_max,
      a.fd_max, static_cast<float*>(a.part), static_cast<T*>(d.dsh),
      static_cast<float*>(d.part_sh), d.slot_max, r);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const SplitSums p =
      kLeg == kLegSh ? SplitSums{{static_cast<const float*>(d.part_sh)}, {a.d_sh}, {d.dsh}}
                     : SplitSums{{static_cast<const float*>(a.part)},
                                 {kLeg == kLegX ? a.d_x : r.hd},
                                 {kLeg == kLegX ? a.dx : r.dh}};
  return launch_split_sum<T>(p, n_split, a.E, a.n_edges, stream);
}

template <typename T>
int dispatch_rad_leg(int leg, const Args& a, const DshArgs& d, const RadOps& r, int n_split,
                     cudaStream_t s) {
  if (leg == kLegX) return launch_rad_leg<T, kLegX>(a, d, r, n_split, s);
  if (leg == kLegSh) return launch_rad_leg<T, kLegSh>(a, d, r, n_split, s);
  return launch_rad_leg<T, kLegW>(a, d, r, n_split, s);
}

// K7-L's operands: the leg's output (and its partials when the tiles are
// cut), every operand but the leg's own, the fold's tables; w and dw null
int run_rad_leg(int leg, int n_split, const Args& a, const DshArgs& d, const RadOps& r,
                int dtype, void* stream) {
  const bool cut = n_split > 1;
  const bool outs =
      leg == kLegX    ? a.dx != nullptr && a.sh != nullptr && (!cut || a.part != nullptr)
      : leg == kLegSh ? d.dsh != nullptr && a.x != nullptr && d.slot_max >= 1 &&
                            (!cut || d.part_sh != nullptr)
      : leg == kLegW  ? r.dh != nullptr && a.x != nullptr && a.sh != nullptr &&
                            (!cut || a.part != nullptr)
                      : false;
  const bool fold = r.hd > 0 && r.hd % 4 == 0 && r.n_loc > 0 && r.Wl != nullptr &&
                    r.pk != nullptr && r.rgk != nullptr && (leg == kLegW || r.h != nullptr);
  if (!outs || !fold || a.w != nullptr || a.dw != nullptr || a.cp_max % 16 != 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return dispatch_rad_leg<float>(leg, a, d, r, n_split, s);
  if (dtype == eqt::kBFloat16) return dispatch_rad_leg<__nv_bfloat16>(leg, a, d, r, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// h with hd a positive multiple of 4 whose staged slice fits launch 2's G
// buffer, and [Wr; offset] of n_loc local columns
template <typename T>
bool rad_h_ok(const RadOps& r) {
  return r.h != nullptr && r.hd > 0 && r.hd % 4 == 0 && r.n_loc > 0 &&
         ld_h<T>(r.hd) * (int)sizeof(T) <= kLdg2 * 4;
}

// the fold's operands: h and [Wr; offset] (rad_h_ok), the dw workspace, the
// partials
template <typename T>
bool rad_ok(const Args& a, const RadOps& r) {
  return rad_h_ok<T>(r) && a.dw != nullptr && a.dwmap != nullptr && a.part != nullptr &&
         a.dW != nullptr;
}

int run_legW_rad(const Args& a, const RadOps& r, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!ranges_ok(a) || a.x == nullptr || a.w != nullptr || a.part == nullptr ||
      a.dW == nullptr || r.Wl == nullptr || r.pk == nullptr || r.rgk == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32)
    return rad_h_ok<float>(r) ? launch_legW_rad<float>(a, r, s) : (int)cudaErrorInvalidValue;
  if (dtype == eqt::kBFloat16)
    return rad_h_ok<__nv_bfloat16>(r) ? launch_legW_rad<__nv_bfloat16>(a, r, s)
                                      : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

int run_rad(const Args& a, const RadOps& r, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const bool ops = a.dx != nullptr && r.dh != nullptr && r.Wl != nullptr && r.pk != nullptr &&
                   r.rgk != nullptr;
  if (!ranges_ok(a) || !ops) return (int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32)
    return rad_ok<float>(a, r) ? launch_rad<float>(a, r, s) : (int)cudaErrorInvalidValue;
  if (dtype == eqt::kBFloat16)
    return rad_ok<__nv_bfloat16>(a, r) ? launch_rad<__nv_bfloat16>(a, r, s)
                                       : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

int run_legWr(const Args& a, const RadOps& r, int n_split, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!ranges_ok(a) || n_split < 1 || a.x == nullptr || a.w != nullptr || a.dx != nullptr ||
      (r.one != 0.f && r.one != 1.f))
    return (int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32)
    return rad_ok<float>(a, r) ? launch_legWr<float>(a, r, n_split, s)
                               : (int)cudaErrorInvalidValue;
  if (dtype == eqt::kBFloat16)
    return rad_ok<__nv_bfloat16>(a, r) ? launch_legWr<__nv_bfloat16>(a, r, n_split, s)
                                       : (int)cudaErrorInvalidValue;
  return (int)cudaErrorInvalidValue;
}

// the operands a dsh leg's launch takes: the sh leg dsh alone (x read, sh,
// dx and dw null); K5a two or three outputs, x and sh read, dw only with w;
// the partials of each output kept when the tiles are cut
bool dsh_args_ok(int leg, int n_split, const Args& a, const DshArgs& d) {
  const bool dsh = d.dsh != nullptr;
  const int n_out = (int)dsh + (int)(a.dx != nullptr) + (int)(a.dw != nullptr);
  const bool outs = leg == kLegSh ? dsh && a.dx == nullptr && a.dw == nullptr && a.sh == nullptr
                                  : leg == kBwd3 && a.sh != nullptr &&
                                        (a.dw == nullptr || a.w != nullptr) && n_out >= 2;
  return outs && a.x != nullptr && a.cp_max % 16 == 0 && n_split >= 1 &&
         (!dsh || d.slot_max >= 1) &&
         (n_split == 1 || ((a.dx == nullptr || a.part != nullptr) &&
                           (!dsh || d.part_sh != nullptr)));
}

int run_dsh(int leg, int n_split, const Args& a, const DshArgs& d, int dtype, void* stream) {
  if (!dsh_args_ok(leg, n_split, a, d)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const RadOps r{};
  if (dtype == eqt::kFloat32)
    return leg == kLegSh ? dispatch_dsh<float, kLegSh>(a, d, r, n_split, s)
                         : dispatch_bwd3<float>(a, d, r, n_split, s);
  if (dtype == eqt::kBFloat16)
    return leg == kLegSh ? dispatch_dsh<__nv_bfloat16, kLegSh>(a, d, r, n_split, s)
                         : dispatch_bwd3<__nv_bfloat16>(a, d, r, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// the operands K7-B3 takes: two or three of dx, dsh and dh (r.dh), x and sh
// read, w and dw null, the fold's operands (h, hd a positive multiple of 4,
// Wl, the packings), the partials of each output kept when the tiles are cut
bool rad_bwd3_args_ok(int n_split, const Args& a, const DshArgs& d, const RadOps& r) {
  const bool dsh = d.dsh != nullptr;
  const int n_out = (int)dsh + (int)(a.dx != nullptr) + (int)(r.dh != nullptr);
  const bool fold = r.h != nullptr && r.hd > 0 && r.hd % 4 == 0 && r.n_loc > 0 &&
                    r.Wl != nullptr && r.pk != nullptr && r.rgk != nullptr;
  return fold && n_out >= 2 && a.x != nullptr && a.sh != nullptr && a.w == nullptr &&
         a.dw == nullptr && a.cp_max % 16 == 0 && n_split >= 1 && (!dsh || d.slot_max >= 1) &&
         (n_split == 1 || ((a.dx == nullptr || a.part != nullptr) &&
                           (!dsh || d.part_sh != nullptr) &&
                           (r.dh == nullptr || r.part_dh != nullptr)));
}

int run_rad_bwd3(int n_split, const Args& a, const DshArgs& d, const RadOps& r, int dtype,
                 void* stream) {
  if (!rad_bwd3_args_ok(n_split, a, d, r)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32) return dispatch_bwd3<float, true>(a, d, r, n_split, s);
  if (dtype == eqt::kBFloat16) return dispatch_bwd3<__nv_bfloat16, true>(a, d, r, n_split, s);
  return (int)cudaErrorInvalidValue;
}

// resident blocks per SM of K5b's sh leg (leg kLegSh), K5a (kBwd3), or
// with r.hd > 0 K7-B3, or minus a cudaError_t
int run_dsh_occupancy(int leg, const Args& a, const DshArgs& d, const RadOps& r, int dtype) {
  const bool rad = r.hd > 0;
  if (rad ? leg != kBwd3 || !rad_bwd3_args_ok(1, a, d, r) : !dsh_args_ok(leg, 1, a, d))
    return -(int)cudaErrorInvalidValue;
  if (dtype == eqt::kFloat32)
    return leg == kLegSh ? dsh_occupancy<float, kLegSh>(a, d, 0)
           : rad         ? occupancy_bwd3<float, true>(a, d, r)
                         : occupancy_bwd3<float>(a, d, r);
  if (dtype == eqt::kBFloat16)
    return leg == kLegSh ? dsh_occupancy<__nv_bfloat16, kLegSh>(a, d, 0)
           : rad         ? occupancy_bwd3<__nv_bfloat16, true>(a, d, r)
                         : occupancy_bwd3<__nv_bfloat16>(a, d, r);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace k2

// K2: dx [E, d_x], dw [E, d_w] (null without a per-edge w) and dW [w_numel]
// fp32 for the cotangent G of dtp_lin_fwd.  Wp: each group's W_g in mma
// fragment order (DTPLinPlan.k2_tables' wp_index); gk: [n_gk, 12] per (g,
// k); tiles: [n_tiles, 6] dW tiles; part: [n_ranges, w_numel] fp32 scratch
// (each edge range of range_len edges writes one row, every element once).
extern "C" int dtp_lin_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                           const void* w, int d_w, const void* Wp, const void* G, int d_out,
                           const void* n_edges, int E, const void* gk, int n_gk,
                           const void* terms, const void* coeffs, const void* dwmap, void* dx,
                           void* dw, int span_max, int cp_max, int fd_max, const void* tiles,
                           int n_tiles, void* part, int n_ranges, int range_len, void* dW,
                           int w_numel, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run(k2::kFullStage, a, dtype, stream);
}

// S3: K2 cut after phase `stage` (0-6, k2::kFullStage is dtp_lin_bwd itself),
// on dtp_lin_bwd's arguments: the phases' times for tools/bwd_attr.py.  The
// outputs: stages 0-2 dx = dw = 0 and dW = 0; stages 3-5 K2's dx and dw, dW
// = 0; stage 6 K2's outputs.
extern "C" int dtp_lin_bwd_stage(const void* x, long long sx, int d_x, const void* sh,
                                 int d_sh, const void* w, int d_w, const void* Wp,
                                 const void* G, int d_out, const void* n_edges, int E,
                                 const void* gk, int n_gk, const void* terms, const void* coeffs,
                                 const void* dwmap, void* dx, void* dw, int span_max, int cp_max,
                                 int fd_max, const void* tiles, int n_tiles, void* part,
                                 int n_ranges, int range_len, void* dW, int w_numel, int stage,
                                 int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run(stage, a, dtype, stream);
}

// K7-B: the backward of dtp_lin_rad_fwd on dtp_lin_bwd's arguments (w null:
// w = [h, 1] @ [Wr; offset] is built on chip; dw the workspace [E, d_w] in
// the dtype; part [n_ranges, w_numel + (hd + 1) * n_loc] fp32; dW [w_numel +
// (hd + 1) * n_loc] fp32: dW, then d[Wr; offset] in local column order),
// then h [E, hd], Wl [hd + 1, n_loc] ([Wr; offset] in local column order),
// pk and rgk (DTPLinPlan.k7_tables: each group's Wr in fragment order, and
// the offsets of a gk row's group in it), dh [E, hd].
extern "C" int dtp_lin_rad_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                               const void* w, int d_w, const void* Wp, const void* G, int d_out,
                               const void* n_edges, int E, const void* gk, int n_gk,
                               const void* terms, const void* coeffs, const void* dwmap,
                               void* dx, void* dw, int span_max, int cp_max, int fd_max,
                               const void* tiles, int n_tiles, void* part, int n_ranges,
                               int range_len, void* dW, int w_numel, const void* h, int hd,
                               const void* Wl, int n_loc, const void* pk, const void* rgk,
                               void* dh, int dtype, void* stream) {
  if (w != nullptr) return (int)cudaErrorInvalidValue;
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  k2::RadOps r{};
  r.h = h; r.hd = hd; r.Wl = Wl; r.n_loc = n_loc; r.pk = pk;
  r.rgk = static_cast<const int*>(rgk); r.dh = dh;
  return k2::run_rad(a, r, dtype, stream);
}

// K7-Wr: d[Wr; offset] = [h, one]^T F_w(G, x, sh, W) [(hd + 1) * n_loc] fp32
// (local column order) into dW, on dtp_lin_bwd's arguments (w null, dx null,
// dw the workspace [E, d_w] in the dtype, part [n_ranges, (hd + 1) * n_loc]
// fp32; tiles, n_tiles and w_numel unused), then h [E, hd], hd, n_loc, one
// (1, or 0 when h's slot holds a tangent or cotangent) and n_split, the
// irrep-group splits of the w leg's tiles.
extern "C" int dtp_lin_rad_legWr(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                 const void* w, int d_w, const void* Wp, const void* G, int d_out,
                                 const void* n_edges, int E, const void* gk, int n_gk,
                                 const void* terms, const void* coeffs, const void* dwmap,
                                 void* dx, void* dw, int span_max, int cp_max, int fd_max,
                                 const void* tiles, int n_tiles, void* part, int n_ranges,
                                 int range_len, void* dW, int w_numel, const void* h, int hd,
                                 int n_loc, int one, int n_split, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  k2::RadOps r{};
  r.h = h; r.hd = hd; r.n_loc = n_loc; r.one = (float)one;
  return k2::run_legWr(a, r, n_split, dtype, stream);
}

// K7-L: one edge leg of the radial-folded op, F_x(G, sh, h, [Wr; offset],
// W), F_sh(G, x, h, ...) or F_h(G, x, sh, [Wr; offset], W), on
// dtp_lin_bwd's arguments (w and dw null; tiles, n_tiles, n_ranges,
// range_len, dW and w_numel unused), then h [E, hd] (null for the h leg),
// hd, Wl [hd + 1, n_loc] ([Wr; offset] in local column order: the offset is
// read from its row hd, 0 when h's slot holds a tangent), n_loc, pk and rgk
// (DTPLinPlan.k7_tables), dh [E, hd], dsh [E, d_sh], part_sh, slot_max
// (DTPLinPlan.k2_dsh_slots), the leg (0 x: dx, x null; 1 sh: dsh, sh null;
// 2 h: dh) and n_split, the irrep-group splits of each tile; cut in more
// than one, the x and h legs need part [n_split, E, d_x or hd] and the sh
// leg part_sh [n_split, E, d_sh], fp32.
extern "C" int dtp_lin_rad_leg(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                               const void* w, int d_w, const void* Wp, const void* G, int d_out,
                               const void* n_edges, int E, const void* gk, int n_gk,
                               const void* terms, const void* coeffs, const void* dwmap,
                               void* dx, void* dw, int span_max, int cp_max, int fd_max,
                               const void* tiles, int n_tiles, void* part, int n_ranges,
                               int range_len, void* dW, int w_numel, const void* h, int hd,
                               const void* Wl, int n_loc, const void* pk, const void* rgk,
                               void* dh, void* dsh, void* part_sh, int slot_max, int leg,
                               int n_split, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  k2::RadOps r{};
  r.h = h; r.hd = hd; r.Wl = Wl; r.n_loc = n_loc; r.pk = pk;
  r.rgk = static_cast<const int*>(rgk); r.dh = dh;
  if (leg < 0 || leg > 2) return (int)cudaErrorInvalidValue;
  return k2::run_rad_leg(leg == 2 ? k2::kLegW : leg, n_split, a,
                         k2::DshArgs{dsh, part_sh, slot_max}, r, dtype, stream);
}

// K5b's x and w legs on dtp_lin_bwd's arguments (tiles, n_ranges, range_len,
// dW and w_numel unused).  leg 0: dx alone (x and dw null); leg 2: dw alone
// (w and dx null).  n_split: the irrep-group splits of each tile; the x leg
// cut in more than one needs part [n_split, E, d_x] fp32.
extern "C" int dtp_lin_edge_leg(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* w, int d_w, const void* Wp, const void* G, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* terms, const void* coeffs, const void* dwmap,
                                void* dx, void* dw, int span_max, int cp_max, int fd_max,
                                const void* tiles, int n_tiles, void* part, int n_ranges,
                                int range_len, void* dW, int w_numel, int leg, int n_split,
                                int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run_leg(leg, n_split, a, dtype, stream);
}

// K5c: dW [w_numel] fp32 of the head-weight leg F_W(G, x, sh, w) on
// dtp_lin_bwd's arguments (Wp, dwmap, dx, dw, span_max and fd_max unused;
// w null for shared weights folded into W); part [n_ranges, w_numel].
extern "C" int dtp_lin_legW(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                            const void* w, int d_w, const void* Wp, const void* G, int d_out,
                            const void* n_edges, int E, const void* gk, int n_gk,
                            const void* terms, const void* coeffs, const void* dwmap, void* dx,
                            void* dw, int span_max, int cp_max, int fd_max, const void* tiles,
                            int n_tiles, void* part, int n_ranges, int range_len, void* dW,
                            int w_numel, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run_legW(a, dtype, stream);
}

// K7-LW: dW [w_numel] fp32 of the radial-folded head-weight leg F_W(G, x,
// sh, h, [Wr; offset]) on dtp_lin_bwd's arguments (w null: w = [h, 1] @
// [Wr; offset] is rebuilt on chip; Wp, dwmap, dx, dw, span_max and fd_max
// unused; part [n_ranges, w_numel]), then h [E, hd], hd, Wl [hd + 1, n_loc]
// ([Wr; offset] in local column order: the offset is read from its row hd,
// 0 when h's slot holds a tangent), n_loc, pk and rgk (DTPLinPlan.k7_tables).
extern "C" int dtp_lin_rad_legW(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* w, int d_w, const void* Wp, const void* G, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* terms, const void* coeffs, const void* dwmap,
                                void* dx, void* dw, int span_max, int cp_max, int fd_max,
                                const void* tiles, int n_tiles, void* part, int n_ranges,
                                int range_len, void* dW, int w_numel, const void* h, int hd,
                                const void* Wl, int n_loc, const void* pk, const void* rgk,
                                int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  k2::RadOps r{};
  r.h = h; r.hd = hd; r.Wl = Wl; r.n_loc = n_loc; r.pk = pk;
  r.rgk = static_cast<const int*>(rgk);
  return k2::run_legW_rad(a, r, dtype, stream);
}

// K8-B: dx [E, d_x], dw [E, d_w] (w and dw null when a shared w is folded
// into G) and dG [numel] fp32 for the cotangent g of dtp_lin_kron_fwd, on
// dtp_lin_bwd's arguments over KronMeta.bwd_tables: Wp each (g, k)'s G^T
// packed in fragment order, gk / terms / coeffs / tiles the kron tables in
// K2's layout, w_numel the numel of G, part [n_ranges, numel].
extern "C" int dtp_lin_kron_bwd(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* w, int d_w, const void* Wp, const void* G, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* terms, const void* coeffs, const void* dwmap,
                                void* dx, void* dw, int span_max, int cp_max, int fd_max,
                                const void* tiles, int n_tiles, void* part, int n_ranges,
                                int range_len, void* dW, int w_numel, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run_kron(a, dtype, stream);
}

// K5a (leg 4) and K5b's sh leg (leg 1) on dtp_lin_bwd's arguments (tiles,
// n_ranges, range_len, dW and w_numel unused), then dsh [E, d_sh], its
// partials part_sh and slot_max, the most terms of a (group, component)
// (DTPLinPlan.k2_dsh_slots: a dsh slot a term and row).  K5a: two or three of
// dx, dsh and dw, each null when not asked for (dw only with w); the sh leg:
// dsh alone, sh null.
// n_split: the irrep-group splits of each tile; cut in more than one, dx
// needs part [n_split, E, d_x] and dsh part_sh [n_split, E, d_sh] fp32.
extern "C" int dtp_lin_bwd3(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                            const void* w, int d_w, const void* Wp, const void* G, int d_out,
                            const void* n_edges, int E, const void* gk, int n_gk,
                            const void* terms, const void* coeffs, const void* dwmap, void* dx,
                            void* dw, int span_max, int cp_max, int fd_max, const void* tiles,
                            int n_tiles, void* part, int n_ranges, int range_len, void* dW,
                            int w_numel, void* dsh, void* part_sh, int slot_max, int leg,
                            int n_split, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  return k2::run_dsh(leg, n_split, a, k2::DshArgs{dsh, part_sh, slot_max}, dtype, stream);
}

// K7-B3: two or three of dx, dsh and dh [E, hd] (each null when not asked
// for) for the cotangent G of dtp_lin_rad_fwd, on dtp_lin_bwd's arguments (w
// and dw null; tiles, n_tiles, n_ranges, range_len, dW and w_numel unused),
// then h [E, hd], hd, Wl [hd + 1, n_loc] ([Wr; offset] in local column
// order: the offset is read from its row hd, 0 when h's slot holds a
// tangent), n_loc, pk and rgk (DTPLinPlan.k7_tables), dh, dsh, part_sh,
// slot_max (DTPLinPlan.k2_dsh_slots), part_dh and n_split, the irrep-group
// splits of each tile; cut in more than one, dx needs part [n_split, E,
// d_x], dsh part_sh [n_split, E, d_sh] and dh part_dh [n_split, E, hd] fp32.
extern "C" int dtp_lin_rad_bwd3(const void* x, long long sx, int d_x, const void* sh, int d_sh,
                                const void* w, int d_w, const void* Wp, const void* G, int d_out,
                                const void* n_edges, int E, const void* gk, int n_gk,
                                const void* terms, const void* coeffs, const void* dwmap,
                                void* dx, void* dw, int span_max, int cp_max, int fd_max,
                                const void* tiles, int n_tiles, void* part, int n_ranges,
                                int range_len, void* dW, int w_numel, const void* h, int hd,
                                const void* Wl, int n_loc, const void* pk, const void* rgk,
                                void* dh, void* dsh, void* part_sh, int slot_max, void* part_dh,
                                int n_split, int dtype, void* stream) {
  const k2::Args a{x,      sh,     w,        Wp,       G,      n_edges,   gk,
                   terms,  coeffs, dwmap,    tiles,    sx,     d_x,       d_sh,
                   d_w,    d_out,  E,        n_gk,     span_max, cp_max,  fd_max,
                   n_tiles, n_ranges, range_len, w_numel, dx,   dw,        part, dW};
  k2::RadOps r{};
  r.h = h; r.hd = hd; r.Wl = Wl; r.n_loc = n_loc; r.pk = pk;
  r.rgk = static_cast<const int*>(rgk); r.dh = dh;
  r.part_dh = static_cast<float*>(part_dh);
  return k2::run_rad_bwd3(n_split, a, k2::DshArgs{dsh, part_sh, slot_max}, r, dtype, stream);
}

// Resident blocks per SM of dtp_lin_bwd3's launch at these widths (leg 4
// K5a with the outputs in need: 1 dx, 2 dsh, 4 dw; leg 1 the sh leg), or
// with hd > 0 of dtp_lin_rad_bwd3's (leg 4, need's 4 dh, has_w unused), or
// minus a cudaError_t.
extern "C" int dtp_lin_dsh_occupancy(int leg, int d_x, int d_sh, int span_max, int cp_max,
                                     int fd_max, int has_w, int x_rows, int need, int slot_max,
                                     int hd, int dtype) {
  void* some = reinterpret_cast<void*>(16);  // a non-null pointer: the operand exists
  const bool k5a = leg == k2::kBwd3, rad = hd > 0;
  const k2::Args a{some, k5a ? some : nullptr, has_w && !rad ? some : nullptr, some, some, some,
                   some, some, some, some, nullptr, x_rows ? (long long)d_x : 0, d_x, d_sh, 0, 0,
                   0, 0, span_max, cp_max, fd_max, 0, 0, 0, 0,
                   k5a && (need & k2::kNeedDx) ? some : nullptr,
                   k5a && !rad && (need & k2::kNeedDw) ? some : nullptr, some, nullptr};
  const k2::DshArgs d{!k5a || (need & k2::kNeedDsh) ? some : nullptr, some, slot_max};
  k2::RadOps r{};
  if (rad) {
    r.h = r.Wl = r.pk = some;
    r.rgk = static_cast<const int*>(some);
    r.hd = hd;
    r.n_loc = 1;
    r.dh = need & k2::kNeedDw ? some : nullptr;
  }
  return k2::run_dsh_occupancy(leg, a, d, r, dtype);
}
