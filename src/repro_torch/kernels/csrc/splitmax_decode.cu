// Split-softmax decode: the query of one new token per slot vs the int8 KV
// cache.  Four entries share one kernel body, two compile-time variants:
//   fused    (kQuantizeQ = true):  f32 q, quantized in-kernel with s_q[b];
//   composed (kQuantizeQ = false): int8 q_q already quantized by the caller;
//   paged    (kDense = false): the pool (num_blocks, Hkv, block_k, D), read
//                              through each slot's block-table row;
//   dense    (kDense = true):  the slot's own (Hkv, S_max, D) rows of a
//                              (B, Hkv, S_max, D) cache, walked in tiles of
//                              block_k positions, the last one ragged;
// and each has a kExactRecip instance (the exact_recip option: the
// finalize divides in place of the reciprocal LUT).  The dense entries also
// have the tile instances that the tile sweep (kernels/autotune.py) times
// and kernels/ops.py launches for a swept winner: kStage in {1, 2, 4, 8, 16}
// tiles of 32 keys a rank holds in flight, the reference's block_k = 32 *
// kStage (no kExactRecip tile instances; kStage 0 is the default instance,
// whose launcher picks the stage).
//
// Replaces: repro/kernels/splitmax_decode.py::splitmax_decode_fused_paged_pallas,
//           ::splitmax_decode_paged_pallas (_paged_decode_call,
//           _paged_decode_kernel), ::splitmax_decode_fused_pallas and
//           ::splitmax_decode_pallas (_dense_decode_call, _decode_kernel),
//           each with fused=True / fused=False, and _quantize_q_tile,
//           _accumulate_tile, _finalize_tile.
//
// What bounds it on an H100: every decode step reads each live slot's int8
// K and V once (2 * Hkv * len * D bytes per slot per layer, ~1.1 MB for 8
// slots at ~270 tokens) and does ~6 int8-equivalent operations per byte:
// bytes bound it (~0.3 us at 3.35 TB/s), far below launch cost.  At 8 slots
// x 4 KV heads there are only 32 (slot, head) pairs for 132 SMs, so what
// sets the pace is the latency of one pair's walk over its ~9 tiles.
//
// Design: cluster split-K.
//  * a thread-block cluster of kRanks = 8 blocks per (slot, KV head), fixed
//    by __cluster_dims__ (grid x = Hkv * 8): 256 blocks at 8 slots x 4 heads.
//    Rank r takes the live tiles t_first + r, t_first + r + 8, ...; each
//    block holds the GQA group's Hq / Hkv query rows; the fused entry
//    quantizes them in-kernel with the slot's own s_q (round half to even of
//    an IEEE division, then clip), bit for bit what the composed entry's
//    caller does with torch.round(q / s_q);
//  * a block issues the cp.async copies of all its tiles (up to a stage of
//    kMaxStage that fits the shared-memory budget, or kStage in a tile
//    instance) at once and waits once: at the churn shape a rank has 1 or 2
//    tiles, so one round;
//  * each block loads its own cache length and table entries (no scalar
//    prefetch) and touches only live tiles: past the length, window-dead
//    and trash-block (id 0) tiles are never read.  A live slot never has a
//    trash entry inside its length; only an idle slot (length 0) does, and
//    its output row is 0;
//  * QK^T with __dp4a (K rows padded by one word, so the 32 keys of a warp
//    read different banks); e as an integer; e * V on CUDA cores, one
//    packed V word (4 outputs) per thread and key, in int32 over at most
//    kIntChunk keys and int64 across chunks; s the same way.  The per-tile
//    math is small at group 8 (8 x 32 scores), so the tensor cores are not
//    used here;
//  * exact partials: each block leaves its int64 (acc, s) partials in its
//    shared memory; after cluster.sync() rank r adds all eight blocks'
//    partials for its eighth of the outputs through distributed shared
//    memory and writes them (splitmax_cluster.cuh, shared with the
//    verify).  No atomics, no second launch, and since the
//    sums are exact integers the bits do not depend on the partition, on
//    the batch or on the table width (splitmax_common.cuh's contract);
//  * dense: the tile at k0 is the contiguous rows k0 .. k0 + block_k - 1 of
//    the slot's (S_max, D) head slab.  S_max need not be a multiple of
//    block_k (the TPU kernel asserts it): the last tile is zero-filled past
//    S_max by the copy and its lanes there are dead.  A dense slot equals a
//    paged slot holding the same K/V bit for bit, at any block_k.
#include <cooperative_groups.h>

#include "splitmax_cluster.cuh"
#include "splitmax_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace splitmax;

constexpr int kMaxStage = 4;              // tiles a block holds in flight (default)
constexpr int kMaxWords = kMaxOut / 4;    // packed V words (4 outputs) per thread
constexpr size_t kSmemBudget = 48 * 1024; // a stage larger than 1 tile stays under it
constexpr size_t kSmemMax = 227 * 1024;   // an H100 block's dynamic shared memory

struct Smem {
  size_t exp, recip, q, part_acc, part_s, tile_off, tile_in, e, k, v, total;
  size_t e_tile, k_tile, v_tile;           // bytes per tile of each staged region
};

__host__ __device__ inline Smem smem_layout(int group, int d, int block_k, int recip_bits,
                                            int stage) {
  Smem m;
  m.e_tile = static_cast<size_t>(group) * (block_k + 1) * 4;
  m.k_tile = static_cast<size_t>(block_k) * (d / 4 + 1) * 4;
  m.v_tile = static_cast<size_t>(block_k) * d;
  size_t off = 0;
  m.exp = off;       off += align16(256 * 4);
  m.recip = off;     off += align16((1u << recip_bits) * 4);
  m.q = off;         off += align16(static_cast<size_t>(group) * d);
  m.part_acc = off;  off += align16(static_cast<size_t>(group) * d * 8);
  m.part_s = off;    off += align16(static_cast<size_t>(group) * 8);
  const size_t slots = stage > kMaxStage ? stage : kMaxStage;
  m.tile_off = off;  off += align16(slots * 8);
  m.tile_in = off;   off += align16(slots * 4);
  m.e = off;         off += align16(stage * m.e_tile);
  m.k = off;         off += align16(stage * m.k_tile);
  m.v = off;         off += stage * align16(m.v_tile);
  m.total = off;
  return m;
}

// ``extent`` is the table width (paged) or S_max (dense); ``table`` is
// unused when dense.  ``kStage`` > 0 fixes the tiles in flight (a tile
// instance); 0 takes the launcher's ``stage``.
template <bool kQuantizeQ, bool kDense, bool kExactRecip, int kStage>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q_in, const int8_t* __restrict__ k_cache,
              const int8_t* __restrict__ v_cache, const int* __restrict__ table,
              const float* __restrict__ m_z, const float* __restrict__ s_q,
              const float* __restrict__ s_v_ptr, const int* __restrict__ cache_len,
              const int* __restrict__ exp_lut, const int* __restrict__ recip_lut_g,
              float* __restrict__ out, int hq, int hkv, int d, int block_k, int extent,
              int window, int recip_bits, int recip_frac_bits, int stage_arg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage = kStage > 0 ? kStage : stage_arg;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = hq / hkv;
  const int dw = d / 4;
  const int n_words = group * dw;
  const int n_out = group * d;
  const int e_stride = block_k + 1;
  const Smem L = smem_layout(group, d, block_k, recip_bits, stage);
  int* exp_s = reinterpret_cast<int*>(smem + L.exp);
  int* recip_s = reinterpret_cast<int*>(smem + L.recip);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + L.q);
  long long* part_acc = reinterpret_cast<long long*>(smem + L.part_acc);
  long long* part_s = reinterpret_cast<long long*>(smem + L.part_s);
  long long* tile_off_s = reinterpret_cast<long long*>(smem + L.tile_off);
  int* tile_in_s = reinterpret_cast<int*>(smem + L.tile_in);
  int* e_s = reinterpret_cast<int*>(smem + L.e);
  int* k_s = reinterpret_cast<int*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);
  const int k_tile_words = static_cast<int>(L.k_tile / 4);
  const int e_tile_ints = static_cast<int>(L.e_tile / 4);
  const size_t v_tile_bytes = align16(L.v_tile);

  const int tid = threadIdx.x;
  const int hk = blockIdx.x / kRanks;
  const int b = blockIdx.y;
  const int len = cache_len[b];
  const float mz = m_z[b];
  const float s_v = *s_v_ptr;
  const int n_recip = 1 << recip_bits;

  for (int i = tid; i < 256; i += kThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += kThreads) recip_s[i] = recip_lut_g[i];
  const size_t q0 = (static_cast<size_t>(b) * hq + hk * group) * d;
  if constexpr (kQuantizeQ) {
    // stage 0 of the fused datapath: this slot's f32 query rows -> int8 grid
    const float* qg = static_cast<const float*>(q_in) + q0;
    const float sq = s_q[b];
    for (int i = tid; i < n_out; i += kThreads) q_s[i] = quantize_i8(qg[i], sq);
  } else {
    const int8_t* qg = static_cast<const int8_t*>(q_in) + q0;
    for (int i = tid; i < n_out; i += kThreads) q_s[i] = qg[i];
  }

  long long acc[kMaxWords][4], s_acc[kMaxWords];
#pragma unroll
  for (int u = 0; u < kMaxWords; ++u) {
    s_acc[u] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0;
  }

  const int n_tiles = kDense ? (min(len, extent) + block_k - 1) / block_k
                             : min((len + block_k - 1) / block_k, extent);
  const int t_first = first_live_tile(len, window, block_k);
  const int* row_ids = kDense ? nullptr : table + static_cast<size_t>(b) * extent;
  for (int base = t_first + rank; base < n_tiles; base += kRanks * stage) {
    const int n_here = min(stage, (n_tiles - base + kRanks - 1) / kRanks);
    __syncthreads();  // the previous round's readers are done
    if (tid < n_here) {
      const int t = base + tid * kRanks;
      long long off;
      int in_cache = block_k;  // positions of this tile that exist in the cache
      if constexpr (kDense) {
        off = ((static_cast<long long>(b) * hkv + hk) * extent + t * block_k) * d;
        in_cache = min(block_k, extent - t * block_k);
      } else {
        const int blk = row_ids[t];
        off = blk == kTrashBlock
                  ? -1
                  : (static_cast<long long>(blk) * hkv + hk) * block_k * d;
      }
      tile_off_s[tid] = off;
      tile_in_s[tid] = in_cache;
    }
    __syncthreads();

    // every copy of the round in flight at once, then one wait
    const int kw = block_k * dw;
    for (int c = tid; c < n_here * kw; c += kThreads) {
      const int s = c / kw, w = c % kw, row = w / dw;
      const long long off = tile_off_s[s];
      if (off < 0) continue;
      const bool in = row < tile_in_s[s];
      cp_async4(k_s + s * k_tile_words + row * (dw + 1) + w % dw,
                k_cache + off + (in ? w * 4 : 0), in ? 4 : 0);
    }
    const int vc = block_k * d / 16;
    for (int c = tid; c < n_here * vc; c += kThreads) {
      const int s = c / vc, w = c % vc;
      const long long off = tile_off_s[s];
      if (off < 0) continue;
      const bool in = w * 16 / d < tile_in_s[s];
      cp_async16(v_s + s * v_tile_bytes + w * 16, v_cache + off + (in ? w * 16 : 0),
                 in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int per_tile = group * block_k;
    for (int i = tid; i < n_here * per_tile; i += kThreads) {
      const int s = i / per_tile, r = i % per_tile;
      const int g = r / block_k, j = r % block_k;
      const int col = (base + s * kRanks) * block_k + j;
      bool live = tile_off_s[s] >= 0 && col < len && j < tile_in_s[s];
      if (window > 0) live = live && col > len - 1 - window;
      int e = 0;
      if (live)
        e = requant_exp(dot_i8(reinterpret_cast<const int*>(q_s + g * d),
                               k_s + s * k_tile_words + j * (dw + 1), dw),
                        mz, exp_s);
      e_s[s * e_tile_ints + g * e_stride + j] = e;
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < kMaxWords; ++u) {
      const int wi = tid + u * kThreads;
      if (wi < n_words) {
        const int g = wi / dw, c4 = wi % dw;
        for (int s = 0; s < n_here; ++s) {
          if (tile_off_s[s] < 0) continue;
          const int* e = e_s + s * e_tile_ints + g * e_stride;
          const int* vw = reinterpret_cast<const int*>(v_s + s * v_tile_bytes) + c4;
          for (int j0 = 0; j0 < block_k; j0 += kIntChunk) {
            const int jn = min(block_k, j0 + kIntChunk);
            int a0 = 0, a1 = 0, a2 = 0, a3 = 0, es = 0;
            for (int j = j0; j < jn; ++j) {
              const int ej = e[j], w = vw[j * dw];
              a0 += ej * sbyte(w, 0);
              a1 += ej * sbyte(w, 1);
              a2 += ej * sbyte(w, 2);
              a3 += ej * sbyte(w, 3);
              es += ej;
            }
            acc[u][0] += a0;
            acc[u][1] += a1;
            acc[u][2] += a2;
            acc[u][3] += a3;
            s_acc[u] += es;
          }
        }
      }
    }
  }

  // this block's exact partials -> its shared memory
#pragma unroll
  for (int u = 0; u < kMaxWords; ++u) {
    const int wi = tid + u * kThreads;
    if (wi < n_words) {
      const int g = wi / dw, c4 = wi % dw;
#pragma unroll
      for (int i = 0; i < 4; ++i) part_acc[g * d + c4 * 4 + i] = acc[u][i];
      if (c4 == 0) part_s[g] = s_acc[u];
    }
  }
  cluster.sync();  // every rank's partials are written

  // rank r sums the eight blocks' partials of its share of the outputs
  float* og = out + q0;
  const int per_rank = (n_out + kRanks - 1) / kRanks;
  const int o_end = min(n_out, (rank + 1) * per_rank);
  for (int o = rank * per_rank + tid; o < o_end; o += kThreads) {
    og[o] = finalize<kExactRecip>(cluster_sum(cluster, part_acc, o),
                                  cluster_sum(cluster, part_s, o / d), s_v, recip_s,
                                  recip_bits, recip_frac_bits);
  }
  cluster.sync();  // no block exits while another still reads its partials
}

template <bool kQuantizeQ, bool kDense, bool kExactRecip, int kStage>
int launch_one(const void* q, const void* k_cache, const void* v_cache, const void* table,
               const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
               const void* exp_lut, const void* recip_lut, void* out, int b, int hq,
               int hkv, int d, int block_k, int extent, int window, int recip_bits,
               int recip_frac_bits, void* stream) {
  const int group = hq / hkv;
  int stage = kStage;
  if (kStage == 0) {  // the default instance: as many tiles as the budget takes
    const Smem one = smem_layout(group, d, block_k, recip_bits, 1);
    const size_t per_tile = align16(one.e_tile) + align16(one.k_tile) + align16(one.v_tile);
    stage = 1;
    while (stage < kMaxStage && one.total + stage * per_tile <= kSmemBudget) ++stage;
  }
  const size_t smem = smem_layout(group, d, block_k, recip_bits, stage).total;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 48 * 1024;  // raised once per size, never inside a capture
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kQuantizeQ, kDense, kExactRecip, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(hkv * kRanks, b);
  decode_kernel<kQuantizeQ, kDense, kExactRecip, kStage>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          q, static_cast<const int8_t*>(k_cache), static_cast<const int8_t*>(v_cache),
          static_cast<const int*>(table), static_cast<const float*>(m_z),
          static_cast<const float*>(s_q), static_cast<const float*>(s_v),
          static_cast<const int*>(cache_len), static_cast<const int*>(exp_lut),
          static_cast<const int*>(recip_lut), static_cast<float*>(out), hq, hkv, d,
          block_k, extent, window, recip_bits, recip_frac_bits, stage);
  return static_cast<int>(cudaGetLastError());
}

// exact_recip != 0 launches the kExactRecip instance; stage > 0 (dense, not
// exact_recip) the tile instance of that stage.
template <bool kQuantizeQ, bool kDense>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* table,
           const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
           const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
           int d, int block_k, int extent, int window, int recip_bits,
           int recip_frac_bits, int exact_recip, int stage, void* stream) {
  using Launch = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const void*, const void*, const void*, const void*, const void*,
                         void*, int, int, int, int, int, int, int, int, int, void*);
  Launch fn = nullptr;
  if (stage == 0) {
    fn = exact_recip ? launch_one<kQuantizeQ, kDense, true, 0>
                     : launch_one<kQuantizeQ, kDense, false, 0>;
  } else if constexpr (kDense) {
    if (!exact_recip) {
      switch (stage) {
        case 1: fn = launch_one<kQuantizeQ, kDense, false, 1>; break;
        case 2: fn = launch_one<kQuantizeQ, kDense, false, 2>; break;
        case 4: fn = launch_one<kQuantizeQ, kDense, false, 4>; break;
        case 8: fn = launch_one<kQuantizeQ, kDense, false, 8>; break;
        case 16: fn = launch_one<kQuantizeQ, kDense, false, 16>; break;
        default: break;
      }
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k_cache, v_cache, table, m_z, s_q, s_v, cache_len, exp_lut, recip_lut, out,
            b, hq, hkv, d, block_k, extent, window, recip_bits, recip_frac_bits, stream);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess); the dense
// entries' ``stage`` names a tile instance (0: the default instance).
int splitmax_decode_fused_paged_launch(const void* q, const void* k_pages,
                                       const void* v_pages, const void* table,
                                       const void* m_z, const void* s_q, const void* s_v,
                                       const void* cache_len, const void* exp_lut,
                                       const void* recip_lut, void* out, int b, int hq,
                                       int hkv, int d, int block_k, int max_blocks,
                                       int window, int recip_bits, int recip_frac_bits,
                                       int exact_recip, void* stream) {
  return launch<true, false>(q, k_pages, v_pages, table, m_z, s_q, s_v, cache_len,
                             exp_lut, recip_lut, out, b, hq, hkv, d, block_k, max_blocks,
                             window, recip_bits, recip_frac_bits, exact_recip, 0, stream);
}

int splitmax_decode_paged_launch(const void* q_q, const void* k_pages, const void* v_pages,
                                 const void* table, const void* m_z, const void* s_v,
                                 const void* cache_len, const void* exp_lut,
                                 const void* recip_lut, void* out, int b, int hq, int hkv,
                                 int d, int block_k, int max_blocks, int window,
                                 int recip_bits, int recip_frac_bits, int exact_recip,
                                 void* stream) {
  return launch<false, false>(q_q, k_pages, v_pages, table, m_z, nullptr, s_v, cache_len,
                              exp_lut, recip_lut, out, b, hq, hkv, d, block_k, max_blocks,
                              window, recip_bits, recip_frac_bits, exact_recip, 0, stream);
}

int splitmax_decode_fused_dense_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* m_z,
                                       const void* s_q, const void* s_v,
                                       const void* cache_len, const void* exp_lut,
                                       const void* recip_lut, void* out, int b, int hq,
                                       int hkv, int d, int block_k, int s_max, int window,
                                       int recip_bits, int recip_frac_bits, int exact_recip,
                                       int stage, void* stream) {
  return launch<true, true>(q, k_cache, v_cache, nullptr, m_z, s_q, s_v, cache_len,
                            exp_lut, recip_lut, out, b, hq, hkv, d, block_k, s_max,
                            window, recip_bits, recip_frac_bits, exact_recip, stage, stream);
}

int splitmax_decode_dense_launch(const void* q_q, const void* k_cache, const void* v_cache,
                                 const void* m_z, const void* s_v, const void* cache_len,
                                 const void* exp_lut, const void* recip_lut, void* out,
                                 int b, int hq, int hkv, int d, int block_k, int s_max,
                                 int window, int recip_bits, int recip_frac_bits,
                                 int exact_recip, int stage, void* stream) {
  return launch<false, true>(q_q, k_cache, v_cache, nullptr, m_z, nullptr, s_v, cache_len,
                             exp_lut, recip_lut, out, b, hq, hkv, d, block_k, s_max,
                             window, recip_bits, recip_frac_bits, exact_recip, stage, stream);
}

const char* splitmax_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
