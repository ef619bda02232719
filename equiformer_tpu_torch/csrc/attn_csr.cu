// Fused attention combine over dst-sorted edges, forward (K4).
//
// Replaces: equiformer_tpu/kernels/attn_csr_pallas.py, csr_attention_combine
// (_fwd_impl :54-70, which reaches its pallas_call through the CSR
// segment-sum kernel).  Wrapper: equiformer_tpu_torch/kernels/attn_csr.py.
//
// What it computes, for node u, head h = c / D:
//   out[u, c] = sum_e exp(s[e,h] - m[h]) * drop[e,h] * v[e,c]
//               / max(sum_e exp(s[e,h] - m[h]), 1e-16)
// over the live edges e (mask set, or all without a mask) with dst[e] == u,
// dst non-decreasing (int64 or int32).  m is the global per-head max,
// floored, computed by the wrapper as on the TPU; masked scores arrive as
// -1e30 and would contribute exp(...) == 0 to both sums, so skipping masked
// edges is exact.  drop is the alpha-dropout multiplier (keep mask / keep
// rate, or 1).  The denominator, max(sum_e exp(...), 1e-16), is also
// written in fp32 to den[u, h]: the backward (torch ops in
// kernels/attn_csr.py, as JAX writes it in jnp) reads it instead of
// recomputing it.
//
// What bounds it on the card: device memory.  The live rows of value are
// read once and out written once (QM9: 32888 x 480 in, 3840 x 480 out:
// 0.021 ms fp32 at 3.35 TB/s); scores and drop are [E, H].  The first
// design walked each node's edges in sequence, one thread a column, with
// scalar loads: the 3464 masked padding edges that every QM9 batch puts on
// its last node set the time (1.98 ms with dropout, 0.76 without; ~95x the
// bound, and 2-4x the plain version).
//
// Design: one launch on K3's block walk (csrc/csr_walk.cuh): a block of 16
// warps owns a node range and one chunk of 16-byte column vectors (4 fp32
// or 8 bf16 a lane, all in one head: the wrapper takes vec = 1 where D is
// not a multiple of the vector), searches the sorted dst for its edges and
// cuts them into 16 equal warp slices.  Per live edge (the mask's bits;
// masked edges are skipped) a lane reads its head's score and drop
// multiplier and its value vector, four edges in flight, forms ex =
// exp(s - m) and adds ex * drop * v into fp32 numerators and ex into the
// head's denominator, four partial sums each combined in a fixed order.
// Nodes cut by a slice boundary combine their (numerators, denominator)
// pieces in slice order; then out = num / max(den, 1e-16), and the lane
// whose vector starts head h writes den[u, h].  Nodes without live edges
// get out = 0 and den = 1e-16.  No atomics: the same inputs give the same
// bits.  The TPU version rounds the weighted values and exponentials to the
// value dtype before its segment sum (attn_csr_pallas.py:64-67); this
// kernel keeps them in fp32, so bf16 results differ from it at bf16
// rounding level.

#include <stdint.h>

#include "common.cuh"
#include "csr_walk.cuh"

namespace {

using namespace eqt::csr;

constexpr float kDenFloor = 1e-16f;

// The combine's part of the walk, for this lane's V columns of head h: a
// run's numerators [V] and denominator
template <typename T, int V>
struct CombineOp {
  static constexpr int kPart = V + 1;
  const T* __restrict__ scores;
  const T* __restrict__ value;
  const T* __restrict__ drop;
  const unsigned char* __restrict__ mask;
  T* __restrict__ out;
  float* __restrict__ den;
  int H, C, E, col, h, lane;
  float m;          // the head's shift
  bool active;      // col < C
  bool den_lane;    // this lane's vector starts head h: it writes den[u, h]

  __device__ __forceinline__ void sum(int rb, int re, float (&s)[kPart]) const {
    float num[kInFlight][V], dsum[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      dsum[j] = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) num[j][i] = 0.f;
    }
    live_edges(mask, E, rb, re, lane, [&](const int (&es)[kInFlight]) {
      float sc[kInFlight], dr[kInFlight], v[kInFlight][V];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        if (active && es[j] >= 0) {
          const long long eh = (long long)es[j] * H + h;
          sc[j] = to_f(scores[eh]);
          dr[j] = drop == nullptr ? 1.f : to_f(drop[eh]);
          load_vec<T, V>(value + (long long)es[j] * C + col, v[j]);
        } else {
          sc[j] = 0.f;
          dr[j] = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) v[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const float ex = active && es[j] >= 0 ? expf(sc[j] - m) : 0.f;
        const float p = ex * dr[j];
        dsum[j] += ex;
#pragma unroll
        for (int i = 0; i < V; ++i) num[j][i] += p * v[j][i];
      }
    });
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = (num[0][i] + num[1][i]) + (num[2][i] + num[3][i]);
    s[V] = (dsum[0] + dsum[1]) + (dsum[2] + dsum[3]);
  }

  __device__ __forceinline__ void store(int node, const float (&s)[kPart]) const {
    const float d = fmaxf(s[V], kDenFloor);
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = s[i] / d;
    if (active) store_vec<T, V>(out + (long long)node * C + col, o);
    if (den_lane) den[(long long)node * H + h] = d;
  }

  __device__ __forceinline__ void zero(int m0, int m1) const {
    float z[V];
#pragma unroll
    for (int i = 0; i < V; ++i) z[i] = 0.f;
    if (active)
      for (int u = m0; u < m1; ++u) {
        store_vec<T, V>(out + (long long)u * C + col, z);
        if (den_lane) den[(long long)u * H + h] = kDenFloor;
      }
  }
};

// Block (node range, column chunk) on the shared walk (csr_walk.cuh); the
// bf16 vectors (eight fp32 numerators a load) take one block an SM, as K3's
template <typename T, typename I, int V>
__global__ void __launch_bounds__(kThreads, V == 8 ? 1 : 2)
attn_combine_kernel(const T* __restrict__ scores, const T* __restrict__ value,
                    const T* __restrict__ drop, const float* __restrict__ shift,
                    const I* __restrict__ dst, const unsigned char* __restrict__ mask, int E,
                    T* __restrict__ out, float* __restrict__ den, int N, int H, int D,
                    int n_chunks, int nodes_per_block) {
  const int lane = threadIdx.x & 31;
  const int nb = blockIdx.x / n_chunks;
  const int col = ((blockIdx.x - nb * n_chunks) * 32 + lane) * V;
  const int C = H * D;
  const bool active = col < C;
  const int h = active ? col / D : 0;
  const CombineOp<T, V> op{scores, value, drop, mask, out, den, H, C, E, col, h, lane,
                           active ? __ldg(shift + h) : 0.f, active, active && col == h * D};
  const int n0 = nb * nodes_per_block, n1 = min(N, n0 + nodes_per_block);
  block_walk(op, dst, E, n0, n1);
}

template <typename T, typename I, int V>
int launch(const void* scores, const void* value, const void* drop, const void* shift,
           const void* dst, const void* mask, int E, void* out, void* den, int N, int H, int D,
           int nodes_per_block, cudaStream_t stream) {
  const int n_chunks = ((H * D + V - 1) / V + 31) / 32;
  const long long blocks = (long long)((N + nodes_per_block - 1) / nodes_per_block) * n_chunks;
  attn_combine_kernel<T, I, V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(scores), static_cast<const T*>(value), static_cast<const T*>(drop),
      static_cast<const float*>(shift), static_cast<const I*>(dst),
      static_cast<const unsigned char*>(mask), E, static_cast<T*>(out), static_cast<float*>(den),
      N, H, D, n_chunks, nodes_per_block);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_vec(int vec, const void* scores, const void* value, const void* drop,
               const void* shift, const void* dst, const void* mask, int E, void* out,
               void* den, int N, int H, int D, int npb, cudaStream_t s) {
  constexpr int kVec = 16 / (int)sizeof(T);
  if (vec == 1)
    return launch<T, I, 1>(scores, value, drop, shift, dst, mask, E, out, den, N, H, D, npb, s);
  if (vec == kVec && D % kVec == 0 && ((uintptr_t)value & 15) == 0 &&
      ((uintptr_t)out & 15) == 0)
    return launch<T, I, kVec>(scores, value, drop, shift, dst, mask, E, out, den, N, H, D, npb,
                              s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_idx(int idx_bytes, int vec, const void* scores, const void* value, const void* drop,
               const void* shift, const void* dst, const void* mask, int E, void* out,
               void* den, int N, int H, int D, int npb, cudaStream_t s) {
  if (npb < 1) return (int)cudaErrorInvalidValue;
  if (idx_bytes == 8)
    return launch_vec<T, long long>(vec, scores, value, drop, shift, dst, mask, E, out, den, N,
                                    H, D, npb, s);
  if (idx_bytes == 4)
    return launch_vec<T, int>(vec, scores, value, drop, shift, dst, mask, E, out, den, N, H, D,
                              npb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// scores [E, H], value [E, H, D], dropmul [E, H] or null (the value dtype),
// shift [H] fp32, dst [E] non-decreasing (idx_bytes 8: int64, 4: int32),
// mask [E] bool or null; out [N, H, D], den [N, H] fp32.  vec: elements a
// lane loads at once, 1 or 16 bytes' worth (D a multiple of it, value and
// out 16-byte aligned); nodes_per_block: the node range of a block
// (kernels/segment_csr.py nodes_per_block).
extern "C" int attn_combine(const void* scores, const void* value, const void* dropmul,
                            const void* shift, const void* dst, int idx_bytes, const void* mask,
                            int E, void* out, void* den, int N, int H, int D, int vec,
                            int nodes_per_block, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == eqt::kFloat32)
    return launch_idx<float>(idx_bytes, vec, scores, value, dropmul, shift, dst, mask, E, out,
                             den, N, H, D, nodes_per_block, s);
  if (dtype == eqt::kBFloat16)
    return launch_idx<__nv_bfloat16>(idx_bytes, vec, scores, value, dropmul, shift, dst, mask,
                                     E, out, den, N, H, D, nodes_per_block, s);
  return (int)cudaErrorInvalidValue;
}
