// CSR segment sum over dst-sorted edges (K3).
//
// Replaces: equiformer_tpu/kernels/segment_csr_pallas.py, _kernel (via
// _csr_call / csr_segment_sum).  Wrapper: equiformer_tpu_torch/kernels/segment_csr.py.
//
// What it computes: out[u, c] = sum over the edges e with dst[e] == u and
// mask[e] set of val[e, c], accumulated in fp32, written in val's dtype.
// dst is non-decreasing (int64 or int32, read in its own type).
//
// What bounds it on the card: device memory, and at the MD17 shapes the
// latency of a few dependent loads.  Every live val element is read once
// and each output written once (QM9 edge-degree scatter: 32888 x 480 in,
// 3840 x 480 out: 0.021 ms fp32 at 3.35 TB/s), one add per element read.
//
// Design: the TPU kernel builds a membership matrix per node tile and sums
// on the matrix unit, with the tile starts scalar-prefetched ahead of its
// sequential grid.  Here one launch does everything.  A block of 16 warps
// owns a range of nodes (about 256 edges' worth on average, chosen by the
// wrapper) and one chunk of up to 32 16-byte vectors of columns (4 fp32 or
// 8 bf16 a lane); it finds its edge range itself, by a 32-way search of the
// sorted dst (four dependent probes at 36k edges), and cuts it into 16
// equal slices, one a warp, whatever the degrees: the 3464 padding edges
// that every QM9 batch puts on its last node, summed unmasked by the
// gathers' backward, cost 16 warps 217 edges each, not one warp 3464 edges
// in sequence.  A warp walks its slice node run by node run; per run it
// reads the mask in rounds of 512 edges (16 bytes a lane with one load, so
// a byte is read once per warp) and visits the live edges four at a time,
// four independent 16-byte loads in flight a lane into four partial sums
// combined in a fixed order.  Nodes wholly inside a slice are written by
// its warp, with the zeros of the nodes without edges; a node cut by a
// slice boundary leaves its pieces in shared memory, and the slice where it
// starts adds them in slice order.  No atomics and a fixed order: the same
// inputs give the same bits.  Rows whose width or start is not a multiple
// of 16 bytes take the same walk with one scalar column a lane (vec = 1,
// chosen by the wrapper).

#include <stdint.h>

#include "common.cuh"

namespace {

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

// out rows [m0, m1) = 0 (the nodes without edges), this lane's columns
template <typename T, int V>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, int C, int col, bool active,
                                          int m0, int m1) {
  float z[V];
#pragma unroll
  for (int i = 0; i < V; ++i) z[i] = 0.f;
  if (active)
    for (int m = m0; m < m1; ++m) store_vec<T, V>(out + (long long)m * C + col, z);
}

// s = the sum of val's live rows [rb, rb + n) (one node's run) in this
// lane's columns: the mask in rounds of 512 edges (16 bytes a lane, so a
// byte is read once per warp), the live edges four at a time, four
// independent loads in flight into four partial sums, combined in a fixed
// order
template <typename T, int V>
__device__ __forceinline__ void sum_run(const T* __restrict__ val, int C, int col, bool active,
                                        const unsigned char* __restrict__ mask, int E, int rb,
                                        int re, int lane, float (&s)[V]) {
  const bool mask_vec = ((uintptr_t)mask & 15) == 0;
  float acc[kInFlight][V];
#pragma unroll
  for (int j = 0; j < kInFlight; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
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
        float v[kInFlight][V];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          if (active && es[j] >= 0) {
            load_vec<T, V>(val + (long long)es[j] * C + col, v[j]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) v[j][i] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[j][i] += v[j][i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
}

// Block (node range, column chunk): the edges of nodes [n0, n1) are cut
// into kWarps equal slices, one a warp, whatever the nodes' degrees (a
// 3464-edge padding node costs one block 16 slices, not one warp 3464
// edges).  A warp walks its slice node run by node run and writes the
// nodes it holds whole; the first and last run of a slice may continue
// into the slices around it, and their sums go to shared memory, where the
// slice in which such a node starts adds the others' in slice order.
// (two blocks an SM fit 64 registers a thread: enough for 16-byte fp32
// vectors; the bf16 ones, eight fp32 sums a load, take one block an SM
// rather than spill)
template <typename T, typename I, int V>
__global__ void __launch_bounds__(kThreads, V == 8 ? 1 : 2)
csr_segment_sum_kernel(const T* __restrict__ val, int C, const I* __restrict__ dst, int E,
                       const unsigned char* __restrict__ mask, T* __restrict__ out, int N,
                       int n_chunks, int nodes_per_block) {
  __shared__ int s_range[2];
  __shared__ int s_meta[kWarps][2];  // a slice's last node, and whether it continues after
  __shared__ float s_part[kWarps][2][32 * V];  // the first / last run's sum, when partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = blockIdx.x / n_chunks;
  const int col = ((blockIdx.x - nb * n_chunks) * 32 + lane) * V;
  const bool active = col < C;
  const int n0 = nb * nodes_per_block, n1 = min(N, n0 + nodes_per_block);

  if (warp < 2) {
    const int r = lower_bound_warp(dst, 0, E, warp ? n1 : n0, lane);
    if (lane == 0) s_range[warp] = r;
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  if (lo == hi) {  // no edges: every node's row is zero
    if (warp == 0) zero_rows<T, V>(out, C, col, active, n0, n1);
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
    zero_rows<T, V>(out, C, col, active, prev + 1, first);
    for (int e = sb; e < se;) {
      const int node = (int)dst[e];
      int re;  // the run's end: the first edge of a later node, or the slice's end
      {
        const int p = e + lane;
        const unsigned b = __ballot_sync(kFull, p < se && (int)dst[p] == node);
        re = b != kFull ? e + __popc(b) : lower_bound_warp(dst, e + 32, se, node + 1, lane);
      }
      float s[V];
      sum_run<T, V>(val, C, col, active, mask, E, e, re, lane, s);
      const int slot = node == first && cont_before ? 0 : (re == se && cont_after ? 1 : -1);
      if (slot >= 0) {
#pragma unroll
        for (int i = 0; i < V; ++i) s_part[warp][slot][lane * V + i] = s[i];
      } else if (active) {
        store_vec<T, V>(out + (long long)node * C + col, s);
      }
      if (re < se) zero_rows<T, V>(out, C, col, active, node + 1, (int)dst[re]);
      e = re;
    }
    if (se == hi) zero_rows<T, V>(out, C, col, active, last + 1, n1);
  }
  if (lane == 0) {
    s_meta[warp][0] = last;
    s_meta[warp][1] = cont_after;
  }
  __syncthreads();
  // a node that starts in this slice and continues past it: its sum over
  // the slices, in slice order (a slice holding one continued node only
  // passes it on)
  if (cont_after && !(cont_before && first == last)) {
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = s_part[warp][1][lane * V + i];
    for (int w = warp + 1; w < kWarps; ++w) {
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] += s_part[w][0][lane * V + i];
      if (!(s_meta[w][1] && s_meta[w][0] == last)) break;  // the node ends in slice w
    }
    if (active) store_vec<T, V>(out + (long long)last * C + col, s);
  }
}

template <typename T, typename I, int V>
int launch(const void* val, int C, const void* dst, int E, const void* mask, void* out, int N,
           int nodes_per_block, cudaStream_t stream) {
  const int n_chunks = ((C + V - 1) / V + 31) / 32;
  const long long blocks = (long long)((N + nodes_per_block - 1) / nodes_per_block) * n_chunks;
  csr_segment_sum_kernel<T, I, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(val), C, static_cast<const I*>(dst), E,
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), N, n_chunks,
      nodes_per_block);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_vec(int vec, const void* val, int C, const void* dst, int E, const void* mask,
               void* out, int N, int npb, cudaStream_t s) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (vec == 1) return launch<T, I, 1>(val, C, dst, E, mask, out, N, npb, s);
  if (vec == kVec && C % kVec == 0 && ((uintptr_t)val & 15) == 0 && ((uintptr_t)out & 15) == 0)
    return launch<T, I, kVec>(val, C, dst, E, mask, out, N, npb, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_idx(int idx_bytes, int vec, const void* val, int C, const void* dst, int E,
               const void* mask, void* out, int N, int npb, cudaStream_t s) {
  if (npb < 1) return (int)cudaErrorInvalidValue;
  if (idx_bytes == 8) return launch_vec<T, long long>(vec, val, C, dst, E, mask, out, N, npb, s);
  if (idx_bytes == 4) return launch_vec<T, int>(vec, val, C, dst, E, mask, out, N, npb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// val [E, C], dst [E] non-decreasing (idx_bytes 8: int64, 4: int32), mask
// [E] bool or null, out [N, C].  vec: elements a lane loads at once, 1 or 16
// bytes' worth (C a multiple of it, val and out 16-byte aligned);
// nodes_per_block: the node range of a block (kernels/segment_csr.py).
extern "C" int csr_segment_sum(const void* val, int C, const void* dst, int idx_bytes, int E,
                               const void* mask, void* out, int N, int vec, int nodes_per_block,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_idx<float>(idx_bytes, vec, val, C, dst, E, mask, out, N, nodes_per_block, s);
  if (dtype == eqt::kBFloat16)
    return launch_idx<__nv_bfloat16>(idx_bytes, vec, val, C, dst, E, mask, out, N,
                                     nodes_per_block, s);
  return (int)cudaErrorInvalidValue;
}
