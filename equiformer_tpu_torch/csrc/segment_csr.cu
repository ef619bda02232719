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
// sequential grid.  Here one launch does everything, on the block walk of
// csrc/csr_walk.cuh (shared with K4): a block of 16 warps owns a range of
// nodes (about 256 edges' worth on average, chosen by the wrapper) and one
// chunk of up to 32 16-byte vectors of columns (4 fp32 or 8 bf16 a lane),
// finds its edges by a search of the sorted dst (four dependent probes at
// 36k edges) and cuts them into 16 equal warp slices whatever the degrees
// (the padding node that the gathers' backward sums unmasked costs 16 warps
// 217 edges each).  A lane keeps four independent 16-byte loads in flight,
// into four partial sums combined in a fixed order; nodes cut by a slice
// boundary are summed in slice order.  No atomics: the same inputs give the
// same bits.  Rows whose width or start is not a multiple of 16 bytes take
// the same walk with one scalar column a lane (vec = 1, chosen by the
// wrapper).

#include <stdint.h>

#include "common.cuh"
#include "csr_walk.cuh"

namespace {

using namespace eqt::csr;

// The segment sum's part of the walk: a run's sum of val's live rows in
// this lane's columns, four partial sums combined in a fixed order
template <typename T, int V>
struct SumOp {
  static constexpr int kPart = V;
  const T* __restrict__ val;
  const unsigned char* __restrict__ mask;
  T* __restrict__ out;
  int C, E, col, lane;
  bool active;

  __device__ __forceinline__ void sum(int rb, int re, float (&s)[V]) const {
    float acc[kInFlight][V];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    live_edges(mask, E, rb, re, lane, [&](const int (&es)[kInFlight]) {
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
    });
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
  }

  __device__ __forceinline__ void store(int node, const float (&s)[V]) const {
    if (active) store_vec<T, V>(out + (long long)node * C + col, s);
  }

  __device__ __forceinline__ void zero(int m0, int m1) const {
    float z[V];
#pragma unroll
    for (int i = 0; i < V; ++i) z[i] = 0.f;
    if (active)
      for (int m = m0; m < m1; ++m) store_vec<T, V>(out + (long long)m * C + col, z);
  }
};

// Block (node range, column chunk) on the shared walk (csr_walk.cuh).  (two
// blocks an SM fit 64 registers a thread: enough for 16-byte fp32 vectors;
// the bf16 ones, eight fp32 sums a load, take one block an SM rather than
// spill)
template <typename T, typename I, int V>
__global__ void __launch_bounds__(kThreads, V == 8 ? 1 : 2)
csr_segment_sum_kernel(const T* __restrict__ val, int C, const I* __restrict__ dst, int E,
                       const unsigned char* __restrict__ mask, T* __restrict__ out, int N,
                       int n_chunks, int nodes_per_block) {
  const int lane = threadIdx.x & 31;
  const int nb = blockIdx.x / n_chunks;
  const int col = ((blockIdx.x - nb * n_chunks) * 32 + lane) * V;
  const int n0 = nb * nodes_per_block, n1 = min(N, n0 + nodes_per_block);
  const SumOp<T, V> op{val, mask, out, C, E, col, lane, col < C};
  block_walk(op, dst, E, n0, n1);
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
