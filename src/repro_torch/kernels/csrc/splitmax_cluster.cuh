// Cluster split-K pieces shared by the decode (splitmax_decode.cu) and the
// verify (splitmax_verify.cu): a thread-block cluster of kRanks blocks per
// (slot, KV head), rank r taking the live tiles t_first + r, t_first + r +
// kRanks, ...; each rank leaves exact integer partials in its shared memory,
// and after cluster.sync() the ranks add them through distributed shared
// memory.  The sums are exact integers (splitmax_common.cuh), so the split
// and the order of the combine do not change a bit.
#pragma once

#include <cooperative_groups.h>

namespace splitmax {

constexpr int kRanks = 8;   // blocks per cluster = split of the keys

// The first tile of ``tile`` positions holding a key that a query seeing
// ``len`` positions attends: with a window, tile t is dead when its last key
// t * tile + tile - 1 < len - window.  A query seeing fewer positions starts
// no earlier, so ``len`` is the shortest of the block's queries.
__device__ __forceinline__ int first_live_tile(int len, int window, int tile) {
  return (window > 0 && len > window) ? (len - window) / tile : 0;
}

// x[i] summed over the shared memory of every rank of the cluster.
template <typename T>
__device__ __forceinline__ T cluster_sum(cooperative_groups::cluster_group& cluster,
                                         T* x, int i) {
  T a = 0;
#pragma unroll
  for (int r = 0; r < kRanks; ++r) a += cluster.map_shared_rank(x, r)[i];
  return a;
}

// x[i] and x[i + 1] (i even) summed over every rank: one 16-byte load a rank.
__device__ __forceinline__ longlong2 cluster_sum_pair(cooperative_groups::cluster_group& cluster,
                                                      long long* x, int i) {
  longlong2 a = make_longlong2(0, 0);
#pragma unroll
  for (int r = 0; r < kRanks; ++r) {
    const longlong2 y = *reinterpret_cast<const longlong2*>(cluster.map_shared_rank(x, r) + i);
    a.x += y.x;
    a.y += y.y;
  }
  return a;
}

}  // namespace splitmax
