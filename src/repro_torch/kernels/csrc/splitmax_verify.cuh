// The fused speculative verify kernel: the T draft queries of every slot vs
// the int8 KV cache in one launch.  splitmax_verify.cu launches its default
// instances, splitmax_verify_tiles.cu the tile instances that the tile sweep
// (kernels/autotune.py) times.  Two entries, one compile-time variant apart:
//   paged (kDense = false): the pool, read through each slot's block table;
//   dense (kDense = true):  the slot's rows of a (B, Hkv, S_max, D) cache;
// each with a kExactRecip instance (the exact_recip option: the finalize
// divides in place of the reciprocal LUT).
//
// Replaces: repro/kernels/splitmax_decode.py::
//           splitmax_decode_fused_verify_paged_pallas (_paged_verify_call,
//           _paged_verify_kernel, _verify_body, _per_row) and
//           ::splitmax_decode_fused_verify_pallas (_dense_verify_call,
//           _verify_kernel).
//
// Contract: token t of slot b sees the first eff_t = cache_len[b] - (T-1-t)
// cache positions (and, with a window, only those > eff_t - 1 - window),
// is quantized with its own s_q[b, t] and requantized with its own
// m_z[b, t].  Each output row is bit for bit the decode kernel
// (splitmax_decode.cu, fused entry, same layout) at length eff_t with scale
// s_q[b, t]: acc and s are exact integer sums (splitmax_common.cuh's
// contract), so a row is the decode kernel's result whatever the split of
// the keys; a key that is dead for row t but live for another row adds
// exact zeros.
//
// What bounds it on an H100: one verify reads each live slot's int8 K and V
// once for all T queries (2 * Hkv * len * D bytes per slot per layer) and
// does 3 * T * group int8-equivalent operations per K/V byte (96 at T 4,
// group 8; 192 at T 8): still under the card's ~590 int8 operations per
// byte, so bytes bound it (~0.5 us at the churn shape), far below launch
// cost.  The real limit is latency: at 8 slots x 4 KV heads there are 32
// (slot, head) pairs for 132 SMs, and one block per pair walking its ~9
// tiles in turn, with three barriers a tile and the math on CUDA cores (the
// first design), took 0.070 ms on an H100.  This one spreads a pair's tiles
// over a cluster and puts its math on the tensor cores.
//
// Design: the decode's cluster split-K with the prefill's tensor cores.
//  * a cluster of kRanks = 8 blocks per (slot, KV head) (splitmax_cluster.cuh,
//    as the decode): 256 blocks at 8 slots x 4 heads.  The keys are cut into
//    tiles of kTileK = 32 positions, whatever the pool's block_k; rank r
//    takes the live tiles t_first + r, t_first + r + 8, ...  At the churn
//    shape a rank holds 1 or 2 tiles;
//  * a block issues the cp.async copies of all its tiles (up to a stage of
//    kMaxStage that fits the shared-memory budget; a tile instance fixes the
//    stage at kStage) at once and waits once.
//    Each key row is copied from its own address (the slot's table entry for
//    it, or its dense row): trash-block (id 0) rows, rows past the length or
//    the cache and rows dead under the window for every token are never read
//    (zero-filled and masked);
//  * the block holds all T x group query rows of its KV head, row r = head-
//    in-group * T + t (so its q and out slabs are contiguous in (B, Hq, T,
//    D)), each quantized in-kernel with its own s_q[b, t] (a thread's loads
//    all in flight before it divides), in m16 row tiles (32 rows at T 4, 64
//    at T 8, group 8), padded with zero rows to a multiple of kRowPad (16 by
//    default, 32 in the tile instances of g_pad_min 16), D zero-padded to k32;
//  * work units of (16 rows, 32 output columns) go to the block's 8 warps;
//    three blocks share an SM where shared memory allows (kBlocksPerSm), so
//    the churn shape's 32 clusters run in one wave.
//    A unit's warp runs QK^T as mma.sync.m16n8k32 s8 x s8 -> s32 over each
//    32-key tile, computes each row's requant, exp-LUT read and mask in
//    registers from its own eff_t, m_z and the window, keeps its row sums of
//    e, and runs e . V as u8 x s8 mma.sync on the bytes of e = 256 * e_hi +
//    e_lo (one k32 step a tile), the score C fragment reused as the A
//    fragment with V^T written in the matching key order
//    (splitmax_mma.cuh, shared with the prefill);
//  * exact partials: a unit sums e . V of at most kExactTiles tiles (128
//    keys) exactly in int32, the high bytes' products shifted in after each
//    tile; then the sums are added into the block's int64 (acc, s)
//    partials in shared memory, one owner per output; after cluster.sync()
//    rank r adds all ranks' partials for its eighth of the rows through
//    distributed shared memory (16-byte loads, two outputs a thread) and
//    writes them.  No atomics, no second launch;
//  * no cap from thread counts: the units loop over the warps, and only the
//    int64 partials (T x group x D x 8 bytes) grow with the rows; the wrapper
//    takes T x group x D <= kMaxRowsD (128 KB of partials) and D up to 256.
// Not carried over from the TPU kernel: the token-major layout of its g_pad
// row padding and its pad/unpad copies, the per-row concat of scalar-prefetch values,
// the 128-lane replicated tables, and a grid that walks every table entry
// and relies on pl.when.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "splitmax_cluster.cuh"
#include "splitmax_common.cuh"
#include "splitmax_mma.cuh"

namespace splitmax_verify {
namespace {  // each library keeps its own instances

namespace cg = cooperative_groups;
using namespace splitmax;

constexpr int kTileK = 32;                  // keys per tile: one k32 step of e . V
constexpr int kVtPitch = kTileK + 16;       // V^T rows, padded: no bank conflicts
constexpr int kWarps = 8;
constexpr int kVerifyThreads = 32 * kWarps;
constexpr int kQBatch = 4;                  // q words a thread loads before quantizing
constexpr int kColTiles = 4;                // n8 output tiles of a unit
constexpr int kUnitCols = 8 * kColTiles;    // output columns of a unit
constexpr int kMaxStage = 4;                // tiles in flight, the default instance
                                            // (at most kExactTiles)
constexpr int kExactTiles = 4;              // tiles a unit sums in int32: 4 * 32 keys
                                            // keep the sums of e . v exact
constexpr int kMaxRowsD = 16384;            // T * group * D: 128 KB of int64 partials
constexpr int kMaxD = 256;
// Blocks an SM.  At two (128 registers a thread), fewer clusters of 8 than
// the churn shape's 32 fit on the card's GPCs at once, and the rest run in a
// second wave; three cap a thread at 80 registers.  A block takes three
// where its shared memory lets three share an SM (kSmemBudget3: the churn's
// T 4 and 8 at D 64), else two (larger partials, which fill the SM anyway).
constexpr size_t kSmemBudget3 = 72 * 1024;
constexpr size_t kSmemBudget2 = 112 * 1024;
constexpr size_t kSmemMax = 227 * 1024;     // an H100 block's dynamic shared memory

struct Smem {
  size_t exp, recip, q, part_acc, part_s, s_tot, row_off, k, v, vt, total;
  size_t k_tile, v_tile, vt_tile;           // bytes per tile of each staged region
};

// ``dp`` is D padded to k32; the row pitch of q and K is dp + 16 bytes; the
// query rows are padded to a multiple of ``row_pad`` (16: one m16 tile).
__host__ __device__ inline Smem smem_layout(int rows, int d, int dp, int recip_bits,
                                            int stage, int row_pad) {
  Smem m;
  const size_t pitch = dp + 16;
  const size_t rows_pad = static_cast<size_t>(rows + row_pad - 1) / row_pad * row_pad;
  m.k_tile = kTileK * pitch;
  m.v_tile = static_cast<size_t>(kTileK) * d;
  m.vt_tile = static_cast<size_t>(d) * kVtPitch;
  size_t off = 0;
  m.exp = off;       off += align16(256 * 4);
  m.recip = off;     off += align16((1u << recip_bits) * 4);
  m.q = off;         off += align16(rows_pad * pitch);
  m.part_acc = off;  off += align16(static_cast<size_t>(rows) * d * 8);
  m.part_s = off;    off += align16(static_cast<size_t>(rows) * 8);
  m.s_tot = off;     off += align16(static_cast<size_t>((rows + kRanks - 1) / kRanks) * 8);
  m.row_off = off;   off += align16(static_cast<size_t>(stage) * kTileK * 8);
  m.k = off;         off += align16(stage * m.k_tile);
  m.v = off;         off += align16(stage * m.v_tile);
  m.vt = off;        off += align16(stage * m.vt_tile);
  m.total = off;
  return m;
}

// ``extent`` is the table width (paged) or S_max (dense); ``table`` and the
// pool's ``block_k`` are unused when dense.  ``kStage`` > 0 fixes the tiles a
// rank holds in flight (a tile instance); 0 takes the launcher's ``stage``.
// The query rows are padded to a multiple of ``kRowPad`` (16 or 32).
template <int kKSteps, bool kDense, int kBlocksPerSm, bool kExactRecip, int kStage,
          int kRowPad>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kVerifyThreads, kBlocksPerSm)
verify_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_cache,
              const int8_t* __restrict__ v_cache, const int* __restrict__ table,
              const float* __restrict__ m_z, const float* __restrict__ s_q,
              const float* __restrict__ s_v_ptr, const int* __restrict__ cache_len,
              const int* __restrict__ exp_lut, const int* __restrict__ recip_lut_g,
              float* __restrict__ out, int hq, int hkv, int n_tok, int d, int block_k,
              int extent, int window, int recip_bits, int recip_frac_bits, int stage_arg) {
  constexpr int kDp = 32 * kKSteps, kP = kDp + 16;
  const int stage = kStage > 0 ? kStage : stage_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = hq / hkv;
  const int rows = group * n_tok;
  const int rows_pad = (rows + kRowPad - 1) / kRowPad * kRowPad;
  const int col_units = (d + kUnitCols - 1) / kUnitCols;
  const int units = rows_pad / 16 * col_units;
  const Smem L = smem_layout(rows, d, kDp, recip_bits, stage, kRowPad);
  int* exp_s = reinterpret_cast<int*>(smem + L.exp);
  int* recip_s = reinterpret_cast<int*>(smem + L.recip);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + L.q);
  long long* part_acc = reinterpret_cast<long long*>(smem + L.part_acc);
  long long* part_s = reinterpret_cast<long long*>(smem + L.part_s);
  long long* s_tot = reinterpret_cast<long long*>(smem + L.s_tot);
  long long* row_off_s = reinterpret_cast<long long*>(smem + L.row_off);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);
  int8_t* vt_s = reinterpret_cast<int8_t*>(smem + L.vt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;          // mma fragment coordinates
  const int hk = blockIdx.x / kRanks;
  const int b = blockIdx.y;
  const int len = cache_len[b];                     // counts all T verify tokens
  const int shortest = len - (n_tok - 1);           // token 0's effective length
  const float s_v = *s_v_ptr;
  const float* sq_b = s_q + static_cast<size_t>(b) * n_tok;
  const float* mz_b = m_z + static_cast<size_t>(b) * n_tok;
  const int n_recip = 1 << recip_bits;

  for (int i = tid; i < 256; i += kVerifyThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += kVerifyThreads) recip_s[i] = recip_lut_g[i];
  for (int i = tid; i < rows * d / 2; i += kVerifyThreads)
    reinterpret_cast<longlong2*>(part_acc)[i] = make_longlong2(0, 0);
  for (int i = tid; i < rows; i += kVerifyThreads) part_s[i] = 0;
  // this head group's q slab, (group, T, D) contiguous -> int8 rows, each
  // with its own (slot, token) scale; rows past ``rows`` and columns past D
  // are zeros (exact: they add nothing to a dot product)
  const size_t q0 = (static_cast<size_t>(b) * hq + hk * group) * n_tok * d;
  const float* qg = q + q0;
  const int q_words = rows_pad * (kDp / 4);
  for (int i0 = tid; i0 < q_words; i0 += kQBatch * kVerifyThreads) {
    float4 x[kQBatch];                              // every load in flight first
    float sq[kQBatch];
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int i = i0 + u * kVerifyThreads;
      const int r = i / (kDp / 4), c = (i % (kDp / 4)) * 4;
      const bool in = i < q_words && r < rows && c < d;
      x[u] = in ? *reinterpret_cast<const float4*>(qg + static_cast<size_t>(r) * d + c)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      sq[u] = in ? sq_b[r % n_tok] : 1.f;
    }
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int i = i0 + u * kVerifyThreads;
      if (i < q_words)
        *reinterpret_cast<unsigned*>(q_s + i / (kDp / 4) * kP + (i % (kDp / 4)) * 4) =
            pack4(quantize_i8(x[u].x, sq[u]) & 255, quantize_i8(x[u].y, sq[u]) & 255,
                  quantize_i8(x[u].z, sq[u]) & 255, quantize_i8(x[u].w, sq[u]) & 255);
    }
  }

  // positions that exist: the cache (dense) or the table (paged) cut them
  const int n_pos = kDense ? min(len, extent) : min(len, extent * block_k);
  const int n_tiles = n_pos > 0 ? (n_pos + kTileK - 1) / kTileK : 0;
  const int t_first = first_live_tile(shortest, window, kTileK);
  const int lo_live = window > 0 ? shortest - window : 0;   // live for some token
  const int* row_ids = kDense ? nullptr : table + static_cast<size_t>(b) * extent;
  const long long dense0 = kDense ? (static_cast<long long>(b) * hkv + hk) * extent * d : 0;
  const int chunks = d / 16;

  for (int base = t_first + rank; base < n_tiles; base += kRanks * stage) {
    const int n_here = min(stage, (n_tiles - base + kRanks - 1) / kRanks);
    __syncthreads();  // the previous round's readers are done
    for (int i = tid; i < n_here * kTileK; i += kVerifyThreads) {
      const int pos = (base + (i / kTileK) * kRanks) * kTileK + i % kTileK;
      long long off = -1;                           // -1: not read, zero-filled
      if (pos < n_pos && pos >= lo_live) {
        if constexpr (kDense) {
          off = dense0 + static_cast<long long>(pos) * d;
        } else {
          const int blk = row_ids[pos / block_k];
          if (blk != kTrashBlock)
            off = ((static_cast<long long>(blk) * hkv + hk) * block_k + pos % block_k) * d;
        }
      }
      row_off_s[i] = off;
    }
    __syncthreads();

    // every copy of the round in flight at once, then one wait
    for (int c = tid; c < n_here * kTileK * chunks; c += kVerifyThreads) {
      const int row = c / chunks, ch = c % chunks;
      const long long off = row_off_s[row];
      const long long src = off >= 0 ? off + ch * 16 : 0;
      const int n = off >= 0 ? 16 : 0;
      cp_async16(k_s + row * kP + ch * 16, k_cache + src, n);
      cp_async16(v_s + row * d + ch * 16, v_cache + src, n);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // V^T of every tile of the round, keys in the score fragments' order
    for (int c = tid; c < n_here * 8 * (d / 4); c += kVerifyThreads) {
      const int dq = c % (d / 4), rest = c / (d / 4);
      const int tq = rest % 4, half = (rest / 4) % 2, s = rest / 8;
      transpose_v_quad(v_s + s * L.v_tile + (half * 16 + 2 * tq) * d + dq * 4, d,
                       vt_s + s * L.vt_tile + (dq * 4) * kVtPitch + half * 16 + tq * 4,
                       kVtPitch);
    }
    __syncthreads();

    for (int u = warp; u < units; u += kWarps) {
      const int r0 = (u / col_units) * 16, dbase = (u % col_units) * kUnitCols;
      int qa[kKSteps][4];
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const int8_t* p = q_s + (r0 + g) * kP + ks * 32 + tig * 4;
        qa[ks][0] = *reinterpret_cast<const int*>(p);
        qa[ks][1] = *reinterpret_cast<const int*>(p + 8 * kP);
        qa[ks][2] = *reinterpret_cast<const int*>(p + 16);
        qa[ks][3] = *reinterpret_cast<const int*>(p + 8 * kP + 16);
      }
      int eff[2];                                   // rows g and g + 8
      float mz[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        const int t = r % n_tok;
        eff[h] = r < rows ? len - (n_tok - 1 - t) : 0;   // a padding row sees nothing
        mz[h] = mz_b[t];
      }
      // sum e * v over kExactTiles tiles of the round at a time:
      // |sum| <= kExactTiles * 32 keys * 2^22 < 2^31; an instance holding
      // no more tiles than that (the default one too) sums its round in one
      // pass
      constexpr bool kOnePass = kStage == 0 || kStage <= kExactTiles;
      for (int s0 = 0; kOnePass ? s0 == 0 : s0 < n_here; s0 += kExactTiles) {
        int acc[kColTiles][4];
#pragma unroll
        for (int n = 0; n < kColTiles; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0;
        int s_row[2] = {0, 0};

        const int s_end = kOnePass ? n_here : min(n_here, s0 + kExactTiles);
        for (int s = s0; s < s_end; ++s) {
          const int k0 = (base + s * kRanks) * kTileK;
          int sc[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0;
            const int8_t* p = k_s + (s * kTileK + nt * 8 + g) * kP + tig * 4;
#pragma unroll
            for (int ks = 0; ks < kKSteps; ++ks)
              mma_s8s8(sc[nt], qa[ks], *reinterpret_cast<const int*>(p + ks * 32),
                       *reinterpret_cast<const int*>(p + ks * 32 + 16));
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int h = i >> 1, j = nt * 8 + 2 * tig + (i & 1);
              const int col = k0 + j;
              bool live = col < eff[h] && row_off_s[s * kTileK + j] >= 0;
              if (window > 0) live = live && col > eff[h] - 1 - window;
              const int e = live ? requant_exp(sc[nt][i], mz[h], exp_s) : 0;
              sc[nt][i] = e;
              s_row[h] += e;
            }
          unsigned a_lo[4], a_hi[4];
          pack_e_frags(sc[0], sc[1], sc[2], sc[3], a_lo, a_hi);
#pragma unroll
          for (int dn = 0; dn < kColTiles; ++dn) {
            if (dbase + dn * 8 < d) {
              const int8_t* p = vt_s + s * L.vt_tile + (dbase + dn * 8 + g) * kVtPitch + tig * 4;
              const int b0 = *reinterpret_cast<const int*>(p);
              const int b1 = *reinterpret_cast<const int*>(p + 16);
              int hi[4] = {0, 0, 0, 0};
              mma_u8s8(acc[dn], a_lo, b0, b1);
              mma_u8s8(hi, a_hi, b0, b1);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[dn][i] += 256 * hi[i];
            }
          }
        }

        // the exact int32 sums -> this block's int64 partials; each
        // output has one owner (this thread), so no atomics
#pragma unroll
        for (int dn = 0; dn < kColTiles; ++dn) {
          const int col = dbase + dn * 8 + 2 * tig;
          if (col >= d) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h;
            if (r >= rows) continue;
            long long* p = part_acc + static_cast<size_t>(r) * d + col;
            p[0] += acc[dn][2 * h];
            p[1] += acc[dn][2 * h + 1];
          }
        }
        if (dbase == 0) {  // each row's denominator is spread over its quad
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 1);
            s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 2);
            const int r = r0 + g + 8 * h;
            if (tig == 0 && r < rows) part_s[r] += s_row[h];
          }
        }
      }
    }
  }
  cluster.sync();  // every rank's partials are written

  // rank r sums the eight blocks' partials of its share of the rows
  const int per_rank = (rows + kRanks - 1) / kRanks;
  const int r_begin = rank * per_rank, r_end = min(rows, r_begin + per_rank);
  for (int i = tid; i < r_end - r_begin; i += kVerifyThreads)
    s_tot[i] = cluster_sum(cluster, part_s, r_begin + i);
  __syncthreads();
  float* og = out + q0;
  for (int o = r_begin * d + 2 * tid; o < r_end * d; o += 2 * kVerifyThreads) {
    const longlong2 a = cluster_sum_pair(cluster, part_acc, o);
    const long long st = s_tot[o / d - r_begin];
    *reinterpret_cast<float2*>(og + o) =
        make_float2(
            finalize<kExactRecip>(a.x, st, s_v, recip_s, recip_bits, recip_frac_bits),
            finalize<kExactRecip>(a.y, st, s_v, recip_s, recip_bits, recip_frac_bits));
  }
  cluster.sync();  // no block exits while another still reads its partials
}

template <int kKSteps, bool kDense, int kBlocksPerSm, bool kExactRecip, int kStage,
          int kRowPad>
int run(size_t smem, int stage, const void* q, const void* k_cache, const void* v_cache,
        const void* table, const void* m_z, const void* s_q, const void* s_v,
        const void* cache_len, const void* exp_lut, const void* recip_lut, void* out, int b,
        int hq, int hkv, int n_tok, int d, int block_k, int extent, int window,
        int recip_bits, int recip_frac_bits, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // raised once per size, never inside a capture
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_kernel<kKSteps, kDense, kBlocksPerSm, kExactRecip, kStage, kRowPad>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid(hkv * kRanks, b);
  verify_kernel<kKSteps, kDense, kBlocksPerSm, kExactRecip, kStage, kRowPad>
      <<<grid, kVerifyThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_cache),
      static_cast<const int8_t*>(v_cache), static_cast<const int*>(table),
      static_cast<const float*>(m_z), static_cast<const float*>(s_q),
      static_cast<const float*>(s_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(exp_lut), static_cast<const int*>(recip_lut),
      static_cast<float*>(out), hq, hkv, n_tok, d, block_k, extent, window, recip_bits,
      recip_frac_bits, stage);
  return static_cast<int>(cudaGetLastError());
}

// The default instance (kStage 0): the stage, up to kMaxStage tiles, and
// three or two blocks an SM, from the shared-memory budgets.  A tile
// instance (kStage > 0) holds kStage tiles and runs two blocks an SM;
// it refuses a layout past kSmemMax.
template <int kKSteps, bool kDense, bool kExactRecip, int kStage, int kRowPad>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* table,
           const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
           const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
           int n_tok, int d, int block_k, int extent, int window, int recip_bits,
           int recip_frac_bits, cudaStream_t stream) {
  const int rows = hq / hkv * n_tok;
  const Smem one = smem_layout(rows, d, 32 * kKSteps, recip_bits, 1, kRowPad);
  const size_t per_tile = kTileK * 8 + align16(one.k_tile) + align16(one.v_tile) +
                          align16(one.vt_tile);
  const bool three = kStage == 0 && one.total <= kSmemBudget3;
  const size_t budget = three ? kSmemBudget3 : kSmemBudget2;
  int stage = kStage;
  if (kStage == 0) {
    stage = 1;
    while (stage < kMaxStage && one.total + stage * per_tile <= budget) ++stage;
  }
  const size_t smem =
      smem_layout(rows, d, 32 * kKSteps, recip_bits, stage, kRowPad).total;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kStage == 0) {
    if (three)
      return run<kKSteps, kDense, 3, kExactRecip, kStage, kRowPad>(
          smem, stage, q, k_cache, v_cache, table, m_z, s_q, s_v, cache_len, exp_lut,
          recip_lut, out, b, hq, hkv, n_tok, d, block_k, extent, window, recip_bits,
          recip_frac_bits, stream);
  }
  return run<kKSteps, kDense, 2, kExactRecip, kStage, kRowPad>(
      smem, stage, q, k_cache, v_cache, table, m_z, s_q, s_v, cache_len, exp_lut, recip_lut,
      out, b, hq, hkv, n_tok, d, block_k, extent, window, recip_bits, recip_frac_bits,
      stream);
}

// D is a multiple of 16 up to kMaxD and T * group * D <= kMaxRowsD (the
// wrapper checks both); instance(n) launches the instance of kKSteps = n.
template <typename Instance>
int by_ksteps(int hq, int hkv, int n_tok, int d, Instance instance) {
  if (d % 16 || d > kMaxD || hq / hkv * n_tok * d > kMaxRowsD)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + 31) / 32) {
    case 1: return instance(std::integral_constant<int, 1>());
    case 2: return instance(std::integral_constant<int, 2>());
    case 3: return instance(std::integral_constant<int, 3>());
    case 4: return instance(std::integral_constant<int, 4>());
    case 5: return instance(std::integral_constant<int, 5>());
    case 6: return instance(std::integral_constant<int, 6>());
    case 7: return instance(std::integral_constant<int, 7>());
    case 8: return instance(std::integral_constant<int, 8>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace splitmax_verify
