// Host-side runtime of the port: batch collation and radius-graph
// statistics over a contiguous dataset arena, and the atom-count balanced
// shard assignment.  Counterpart of equiformer_tpu/native/host_ops.cpp with
// the port's index type: species and graph ids are int64.
//
// Exposed through ctypes (equiformer_tpu_torch/native/__init__.py); plain C
// ABI.

#include <cstdint>
#include <cstring>

extern "C" {

// Fill a padded fixed-slot batch (collate_dense's layout: graph b occupies
// node slots [b*M, b*M + n_b)).
//   pos_arena     [total_nodes, 3] float32, graphs contiguous
//   species_arena [total_nodes] int64
//   forces_arena  [total_nodes, 3] float32 or nullptr
//   offsets       [n_total_graphs + 1] int64 node offsets into the arena
//   y_arena       [n_total_graphs] float32 or nullptr
//   indices       [batch] int64 graph ids to collate
// Outputs (allocated by the caller, zero-filled here):
//   pos_out [B*M, 3], species_out [B*M] int64, node_mask [B*M] (one byte),
//   batch_out [B*M] int64, graph_mask [B] (one byte), y_out [B],
//   forces_out [B*M, 3] or nullptr
// Returns 0 on success, -1 if a graph has more than M nodes.
int collate_dense_batch(
    const float* pos_arena, const int64_t* species_arena,
    const float* forces_arena, const int64_t* offsets, const float* y_arena,
    const int64_t* indices, int64_t batch, int64_t slots,
    float* pos_out, int64_t* species_out, uint8_t* node_mask,
    int64_t* batch_out, uint8_t* graph_mask, float* y_out, float* forces_out) {
  const int64_t n_cap = batch * slots;
  memset(pos_out, 0, sizeof(float) * n_cap * 3);
  memset(species_out, 0, sizeof(int64_t) * n_cap);
  memset(node_mask, 0, n_cap);
  memset(graph_mask, 0, batch);
  if (y_out) memset(y_out, 0, sizeof(float) * batch);
  if (forces_out) memset(forces_out, 0, sizeof(float) * n_cap * 3);
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t g = indices[b];
    const int64_t s = offsets[g], e = offsets[g + 1];
    const int64_t n = e - s;
    if (n > slots) return -1;
    const int64_t base = b * slots;
    memcpy(pos_out + base * 3, pos_arena + s * 3, sizeof(float) * n * 3);
    memcpy(species_out + base, species_arena + s, sizeof(int64_t) * n);
    if (forces_out && forces_arena)
      memcpy(forces_out + base * 3, forces_arena + s * 3, sizeof(float) * n * 3);
    for (int64_t i = 0; i < n; ++i) node_mask[base + i] = 1;
    graph_mask[b] = 1;
    if (y_out && y_arena) y_out[b] = y_arena[g];
  }
  for (int64_t b = 0; b < batch; ++b)
    for (int64_t i = 0; i < slots; ++i) batch_out[b * slots + i] = b;
  return 0;
}

// Radius-graph edge counts per graph of an arena (squared distances in
// float32, strictly below radius^2, no self loops).  Returns the total;
// fills edges_per_graph when given.
int64_t radius_graph_stats(
    const float* pos_arena, const int64_t* offsets, int64_t n_graphs,
    float radius, int64_t* edges_per_graph) {
  const float r2 = radius * radius;
  int64_t total = 0;
  for (int64_t g = 0; g < n_graphs; ++g) {
    const int64_t s = offsets[g], e = offsets[g + 1];
    int64_t cnt = 0;
    for (int64_t i = s; i < e; ++i) {
      const float xi = pos_arena[i * 3], yi = pos_arena[i * 3 + 1],
                  zi = pos_arena[i * 3 + 2];
      for (int64_t j = s; j < e; ++j) {
        if (i == j) continue;
        const float dx = xi - pos_arena[j * 3];
        const float dy = yi - pos_arena[j * 3 + 1];
        const float dz = zi - pos_arena[j * 3 + 2];
        if (dx * dx + dy * dy + dz * dz < r2) ++cnt;
      }
    }
    if (edges_per_graph) edges_per_graph[g] = cnt;
    total += cnt;
  }
  return total;
}

// Greedy atom-count balancing: graphs in order of decreasing size, each to
// the lightest shard (the lowest index on a tie).  out_shard[i] = shard id.
void balanced_assign(const int64_t* order_by_size_desc, const int64_t* sizes,
                     int64_t n, int64_t shards, int64_t* out_shard) {
  int64_t* load = new int64_t[shards]();
  for (int64_t idx = 0; idx < n; ++idx) {
    const int64_t g = order_by_size_desc[idx];
    int64_t best = 0;
    for (int64_t s2 = 1; s2 < shards; ++s2)
      if (load[s2] < load[best]) best = s2;
    out_shard[g] = best;
    load[best] += sizes[g];
  }
  delete[] load;
}

// balanced_assign with at most cap[s] graphs on shard s, so that every
// shard keeps the round-robin item count; when every shard is full the
// rest go to shard 0.
void balanced_assign_capped(const int64_t* order_by_size_desc,
                            const int64_t* sizes, int64_t n, int64_t shards,
                            const int64_t* cap, int64_t* out_shard) {
  int64_t* load = new int64_t[shards]();
  int64_t* count = new int64_t[shards]();
  for (int64_t idx = 0; idx < n; ++idx) {
    const int64_t g = order_by_size_desc[idx];
    int64_t best = -1;
    for (int64_t s2 = 0; s2 < shards; ++s2) {
      if (count[s2] >= cap[s2]) continue;
      if (best < 0 || load[s2] < load[best]) best = s2;
    }
    if (best < 0) best = 0;
    out_shard[g] = best;
    load[best] += sizes[g];
    count[best] += 1;
  }
  delete[] load;
  delete[] count;
}

}  // extern "C"
