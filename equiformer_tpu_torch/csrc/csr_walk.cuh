// The block walk over dst-sorted edges that the CSR kernels share: K3
// (csrc/segment_csr.cu, a segment sum) and K4 (csrc/attn_csr.cu, the
// attention combine).
//
// A block of 16 warps owns a range of nodes and one chunk of columns (a
// lane's V consecutive columns: 16 bytes' worth, or one).  It finds its edge
// range itself, by a 32-way search of the sorted dst (int64 or int32, read
// in its own type), and cuts it into 16 equal slices, one a warp, whatever
// the degrees: the 3464 padding edges that every QM9 batch puts on its last
// node cost 16 warps 217 edges each, not one warp 3464 edges in sequence.  A
// warp walks its slice node run by node run; per run it reads the mask in
// rounds of 512 edges (16 bytes a lane with one load, so a byte is read once
// per warp) and visits the live edges four at a time, so that a lane keeps
// four independent loads in flight.  Nodes wholly inside a slice are written
// by its warp, with the nodes without edges; a node cut by a slice boundary
// leaves its pieces in shared memory, and the slice where it starts combines
// them in slice order.  No atomics and a fixed order: the same inputs give
// the same bits.  What a run sums, and how a node is written, is the
// kernel's Op (block_walk below).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace eqt {
namespace csr {

using eqt::from_f;
using eqt::to_f;

constexpr int kWarps = 16;  // edge slices a block's range is cut into
constexpr int kThreads = 32 * kWarps;
constexpr int kRound = 512;  // edges whose mask bytes a warp reads at once: 16 a lane
constexpr int kInFlight = 4;  // independent edge loads (and partial sums) per lane
constexpr unsigned kFull = 0xffffffffu;

// first index in [lo, hi] whose dst is >= key, hi if none: a 32-way search
// of the whole warp (every lane gets the result)
template <typename I>
__device__ __forceinline__ int lower_bound_warp(const I* __restrict__ dst, int lo, int hi,
                                                long long key, int lane) {
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + lane * stride;
    const int c = __popc(__ballot_sync(kFull, p < hi && (long long)dst[p] < key));
    const int nlo = c > 0 ? lo + (c - 1) * stride + 1 : lo;
    hi = min(hi, lo + c * stride);
    lo = nlo;
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && (long long)dst[p] < key));
}

__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return (unsigned)((w & 0xffu) != 0) | ((unsigned)((w & 0xff00u) != 0) << 1) |
         ((unsigned)((w & 0xff0000u) != 0) << 2) | ((unsigned)((w & 0xff000000u) != 0) << 3);
}

// one lane's V consecutive elements as fp32 (V = 1, or one 16-byte load)
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(t[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// visit(es) for the live edges of [rb, re) in order, kInFlight at a time
// (es[j] = -1 past the last; warp-uniform): the mask in rounds of 512 edges,
// 16 bytes a lane with one load, so a byte is read once per warp
template <class Visit>
__device__ __forceinline__ void live_edges(const unsigned char* __restrict__ mask, int E, int rb,
                                           int re, int lane, Visit&& visit) {
  const bool mask_vec = ((uintptr_t)mask & 15) == 0;
  for (int base = rb & ~15; base < re; base += kRound) {
    // bit i of this lane's word: edge e0 + i is in [rb, re) and live
    const int e0 = base + 16 * lane;
    unsigned bits = 0;
    if (e0 < re) {
      if (mask == nullptr) {
        bits = 0xffffu;
      } else if (mask_vec && e0 + 16 <= E) {
        const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + e0));
        bits = byte_bits(m.x) | (byte_bits(m.y) << 4) | (byte_bits(m.z) << 8) |
               (byte_bits(m.w) << 12);
      } else {
        for (int i = 0; i < 16 && e0 + i < E; ++i) bits |= (unsigned)(mask[e0 + i] != 0) << i;
      }
      if (rb > e0) bits &= 0xffffu << (rb - e0);
      if (re - e0 < 16) bits &= (1u << (re - e0)) - 1u;
    }
    for (unsigned lanes = __ballot_sync(kFull, bits != 0); lanes; lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      unsigned b = __shfl_sync(kFull, bits, src);  // warp-uniform from here
      const int eb = base + 16 * src;
      while (b) {
        int es[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          es[j] = b ? eb + __ffs(b) - 1 : -1;
          b &= b - 1;
        }
        visit(es);
      }
    }
  }
}

// The walk of a block over the edges of nodes [n0, n1): kWarps equal slices,
// one a warp; a warp walks its slice node run by node run and writes the
// nodes it holds whole; the first and last run of a slice may continue into
// the slices around it, and their sums go to shared memory, where the slice
// in which such a node starts adds the others' in slice order.  Op, for
// this lane's columns:
//   static constexpr int kPart: the floats a lane sums over a run;
//   void sum(int rb, int re, float (&s)[kPart]): the sums over the live
//     edges of [rb, re), one node's run;
//   void store(int node, const float (&s)[kPart]): a node's sums, written;
//   void zero(int m0, int m1): the nodes [m0, m1), which have no edges.
template <class Op, typename I>
__device__ __forceinline__ void block_walk(const Op& op, const I* __restrict__ dst, int E,
                                           int n0, int n1) {
  constexpr int P = Op::kPart;
  __shared__ int s_range[2];
  __shared__ int s_meta[kWarps][2];  // a slice's last node, and whether it continues after
  __shared__ float s_part[kWarps][2][32 * P];  // the first / last run's sums, when partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (warp < 2) {
    const int r = lower_bound_warp(dst, 0, E, warp ? n1 : n0, lane);
    if (lane == 0) s_range[warp] = r;
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  if (lo == hi) {  // no edges: every node is written as empty
    if (warp == 0) op.zero(n0, n1);
    return;
  }
  const int len = (hi - lo + kWarps - 1) / kWarps;
  const int sb = min(hi, lo + warp * len), se = min(hi, sb + len);
  int first = -1, last = -1;
  bool cont_before = false, cont_after = false;
  if (sb < se) {
    first = (int)dst[sb];
    last = (int)dst[se - 1];
    const int prev = sb > lo ? (int)dst[sb - 1] : n0 - 1;
    cont_before = prev == first;
    cont_after = se < hi && (int)dst[se] == last;
    op.zero(prev + 1, first);
    for (int e = sb; e < se;) {
      const int node = (int)dst[e];
      int re;  // the run's end: the first edge of a later node, or the slice's end
      {
        const int p = e + lane;
        const unsigned b = __ballot_sync(kFull, p < se && (int)dst[p] == node);
        re = b != kFull ? e + __popc(b) : lower_bound_warp(dst, e + 32, se, node + 1, lane);
      }
      float s[P];
      op.sum(e, re, s);
      const int slot = node == first && cont_before ? 0 : (re == se && cont_after ? 1 : -1);
      if (slot >= 0) {
#pragma unroll
        for (int i = 0; i < P; ++i) s_part[warp][slot][lane * P + i] = s[i];
      } else {
        op.store(node, s);
      }
      if (re < se) op.zero(node + 1, (int)dst[re]);
      e = re;
    }
    if (se == hi) op.zero(last + 1, n1);
  }
  if (lane == 0) {
    s_meta[warp][0] = last;
    s_meta[warp][1] = cont_after;
  }
  __syncthreads();
  // a node that starts in this slice and continues past it: its sums over
  // the slices, in slice order (a slice holding one continued node only
  // passes it on)
  if (cont_after && !(cont_before && first == last)) {
    float s[P];
#pragma unroll
    for (int i = 0; i < P; ++i) s[i] = s_part[warp][1][lane * P + i];
    for (int w = warp + 1; w < kWarps; ++w) {
#pragma unroll
      for (int i = 0; i < P; ++i) s[i] += s_part[w][0][lane * P + i];
      if (!(s_meta[w][1] && s_meta[w][0] == last)) break;  // the node ends in slice w
    }
    op.store(last, s);
  }
}

}  // namespace csr
}  // namespace eqt
