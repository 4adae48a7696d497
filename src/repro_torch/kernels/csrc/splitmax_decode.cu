// Split-softmax decode: the query of one new token per slot vs the int8 KV
// cache.  Four entries share one kernel body, two compile-time variants:
//   fused    (kQuantizeQ = true):  f32 q, quantized in-kernel with s_q[b];
//   composed (kQuantizeQ = false): int8 q_q already quantized by the caller;
//   paged    (kDense = false): the pool (num_blocks, Hkv, block_k, D), read
//                              through each slot's block-table row;
//   dense    (kDense = true):  the slot's own (Hkv, S_max, D) rows of a
//                              (B, Hkv, S_max, D) cache, walked in tiles of
//                              block_k positions, the last one ragged.
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
// bytes bound it (~0.3 us at 3.35 TB/s), far below launch cost at this size.
//
// Design, simple and right first:
//  * one block of 128 threads per (slot, KV head) with its GQA group of
//    Hq / Hkv query rows; the fused entry quantizes its rows in-kernel with
//    the slot's own s_q (round half to even of an IEEE division, then clip),
//    which is bit for bit what the composed entry's caller does with
//    torch.round(q / s_q), so both entries give equal outputs;
//  * each block loads its own cache length and table row (no scalar
//    prefetch) and loops over only the ceil(len / block_k) live table
//    entries: no tile past the length is touched;
//  * the trash block (id 0) is never read: a table entry equal to it marks a
//    dead tile.  A live slot never has one inside its length; only an idle
//    slot (length 0, row all trash) does, and its output row is 0;
//  * QK^T with __dp4a, e * V and the denominator on CUDA cores in f32, in a
//    fixed order; LUTs in shared memory, read by index;
//  * the 16-byte-aligned (block_k, D) pool tile of one (block, head) pair is
//    contiguous, so the gather through the table is one coalesced load;
//  * dense: the tile at k0 is the contiguous rows k0 .. k0 + block_k - 1 of
//    the slot's (S_max, D) head slab.  S_max need not be a multiple of
//    block_k (the TPU kernel asserts it): the last tile is zero-filled past
//    S_max and its lanes there are dead.  The tiles run in the paged
//    kernel's order with the same per-tile sums and the same e * V helper,
//    so a dense slot equals a paged slot holding the same K/V bit for bit
//    when block_k equals the pool's.
// A split-K pass over long caches (fixed partition, fixed-order combine)
// comes in later work.
#include "splitmax_common.cuh"

namespace {

using namespace splitmax;

// ``extent`` is the table width (paged) or S_max (dense); ``table`` is
// unused when dense.
template <bool kQuantizeQ, bool kDense>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q_in, const int8_t* __restrict__ k_cache,
              const int8_t* __restrict__ v_cache, const int* __restrict__ table,
              const float* __restrict__ m_z, const float* __restrict__ s_q,
              const float* __restrict__ s_v_ptr, const int* __restrict__ cache_len,
              const int* __restrict__ exp_lut, const int* __restrict__ recip_lut_g,
              float* __restrict__ out, int hq, int hkv, int d, int block_k, int extent,
              int window, int recip_bits, int recip_frac_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = hq / hkv;
  const int n_recip = 1 << recip_bits;
  const int dw = d / 4;
  const int e_stride = block_k + 1;
  size_t off = 0;
  int* exp_s = reinterpret_cast<int*>(smem + off);    off += align16(256 * 4);
  int* recip_s = reinterpret_cast<int*>(smem + off);  off += align16(n_recip * 4);
  float* e_s = reinterpret_cast<float*>(smem + off);  off += align16(group * e_stride * 4);
  float* s_s = reinterpret_cast<float*>(smem + off);  off += align16(group * 4);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + off); off += align16(group * d);
  int* k_s = reinterpret_cast<int*>(smem + off);      off += align16(block_k * (dw + 1) * 4);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + off);

  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int len = cache_len[b];
  const float mz = m_z[b];
  const float s_v = *s_v_ptr;

  for (int i = tid; i < 256; i += kThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += kThreads) recip_s[i] = recip_lut_g[i];
  for (int i = tid; i < group; i += kThreads) s_s[i] = 0.f;
  const size_t q0 = (static_cast<size_t>(b) * hq + hk * group) * d;
  if constexpr (kQuantizeQ) {
    // stage 0 of the fused datapath: this slot's f32 query rows -> int8 grid
    const float* qg = static_cast<const float*>(q_in) + q0;
    const float sq = s_q[b];
    for (int i = tid; i < group * d; i += kThreads) q_s[i] = quantize_i8(qg[i], sq);
  } else {
    const int8_t* qg = static_cast<const int8_t*>(q_in) + q0;
    for (int i = tid; i < group * d; i += kThreads) q_s[i] = qg[i];
  }

  const int n_out = group * d;
  float acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;

  const int n_tiles = kDense ? (min(len, extent) + block_k - 1) / block_k
                             : min((len + block_k - 1) / block_k, extent);
  const int* row_ids = kDense ? nullptr : table + static_cast<size_t>(b) * extent;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * block_k;
    if (window > 0 && k0 + block_k - 1 < len - window) continue;  // window-dead
    size_t tile;
    int in_cache = block_k;  // positions of this tile that exist in the cache
    if constexpr (kDense) {
      tile = ((static_cast<size_t>(b) * hkv + hk) * extent + k0) * d;
      in_cache = min(block_k, extent - k0);
    } else {
      const int blk = row_ids[t];
      if (blk == kTrashBlock) continue;
      tile = (static_cast<size_t>(blk) * hkv + hk) * block_k * d;
    }
    __syncthreads();  // the previous tile's readers are done
    const int* kg = reinterpret_cast<const int*>(k_cache + tile);
    const int* vg = reinterpret_cast<const int*>(v_cache + tile);
    for (int c = tid; c < block_k * dw; c += kThreads) {
      const bool in = c < in_cache * dw;
      k_s[(c / dw) * (dw + 1) + c % dw] = in ? kg[c] : 0;
      reinterpret_cast<int*>(v_s)[c] = in ? vg[c] : 0;
    }
    __syncthreads();

    for (int i = tid; i < group * block_k; i += kThreads) {
      const int g = i / block_k, j = i % block_k;
      const int col = k0 + j;
      bool live = col < len && j < in_cache;
      if (window > 0) live = live && col > len - 1 - window;
      const int z = dot_i8(reinterpret_cast<const int*>(q_s + g * d),
                           k_s + j * (dw + 1), dw);
      e_s[g * e_stride + j] = live ? requant_exp(z, mz, exp_s) : 0.f;
    }
    __syncthreads();

    for (int g = tid; g < group; g += kThreads) {
      int tsum = 0;
      for (int j = 0; j < block_k; ++j) tsum += static_cast<int>(e_s[g * e_stride + j]);
      s_s[g] += static_cast<float>(tsum);
    }
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = tid + u * kThreads;
      if (o < n_out) {
        const int g = o / d, c = o % d;
        acc[u] = accumulate_ev(acc[u], e_s + g * e_stride, v_s + c, d, block_k);
      }
    }
  }
  __syncthreads();

  float* og = out + q0;
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = tid + u * kThreads;
    if (o < n_out) {
      const float s = fmaxf(s_s[o / d], 1.f);
      og[o] = acc[u] * recip_lut(s, recip_s, recip_bits, recip_frac_bits) * s_v;
    }
  }
}

size_t smem_bytes(int group, int d, int block_k, int recip_bits) {
  return align16(256 * 4) + align16((1 << recip_bits) * 4) +
         align16(group * (block_k + 1) * 4) + align16(group * 4) + align16(group * d) +
         align16(block_k * (d / 4 + 1) * 4) + block_k * d;
}

template <bool kQuantizeQ, bool kDense>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* table,
           const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
           const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
           int d, int block_k, int extent, int window, int recip_bits,
           int recip_frac_bits, void* stream) {
  const size_t smem = smem_bytes(hq / hkv, d, block_k, recip_bits);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<kQuantizeQ, kDense>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(hkv, b);
  decode_kernel<kQuantizeQ, kDense>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          q, static_cast<const int8_t*>(k_cache), static_cast<const int8_t*>(v_cache),
          static_cast<const int*>(table), static_cast<const float*>(m_z),
          static_cast<const float*>(s_q), static_cast<const float*>(s_v),
          static_cast<const int*>(cache_len), static_cast<const int*>(exp_lut),
          static_cast<const int*>(recip_lut), static_cast<float*>(out), hq, hkv, d,
          block_k, extent, window, recip_bits, recip_frac_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).
int splitmax_decode_fused_paged_launch(const void* q, const void* k_pages,
                                       const void* v_pages, const void* table,
                                       const void* m_z, const void* s_q, const void* s_v,
                                       const void* cache_len, const void* exp_lut,
                                       const void* recip_lut, void* out, int b, int hq,
                                       int hkv, int d, int block_k, int max_blocks,
                                       int window, int recip_bits, int recip_frac_bits,
                                       void* stream) {
  return launch<true, false>(q, k_pages, v_pages, table, m_z, s_q, s_v, cache_len,
                             exp_lut, recip_lut, out, b, hq, hkv, d, block_k, max_blocks,
                             window, recip_bits, recip_frac_bits, stream);
}

int splitmax_decode_paged_launch(const void* q_q, const void* k_pages, const void* v_pages,
                                 const void* table, const void* m_z, const void* s_v,
                                 const void* cache_len, const void* exp_lut,
                                 const void* recip_lut, void* out, int b, int hq, int hkv,
                                 int d, int block_k, int max_blocks, int window,
                                 int recip_bits, int recip_frac_bits, void* stream) {
  return launch<false, false>(q_q, k_pages, v_pages, table, m_z, nullptr, s_v, cache_len,
                              exp_lut, recip_lut, out, b, hq, hkv, d, block_k, max_blocks,
                              window, recip_bits, recip_frac_bits, stream);
}

int splitmax_decode_fused_dense_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* m_z,
                                       const void* s_q, const void* s_v,
                                       const void* cache_len, const void* exp_lut,
                                       const void* recip_lut, void* out, int b, int hq,
                                       int hkv, int d, int block_k, int s_max, int window,
                                       int recip_bits, int recip_frac_bits, void* stream) {
  return launch<true, true>(q, k_cache, v_cache, nullptr, m_z, s_q, s_v, cache_len,
                            exp_lut, recip_lut, out, b, hq, hkv, d, block_k, s_max,
                            window, recip_bits, recip_frac_bits, stream);
}

int splitmax_decode_dense_launch(const void* q_q, const void* k_cache, const void* v_cache,
                                 const void* m_z, const void* s_v, const void* cache_len,
                                 const void* exp_lut, const void* recip_lut, void* out,
                                 int b, int hq, int hkv, int d, int block_k, int s_max,
                                 int window, int recip_bits, int recip_frac_bits,
                                 void* stream) {
  return launch<false, true>(q_q, k_cache, v_cache, nullptr, m_z, nullptr, s_v, cache_len,
                             exp_lut, recip_lut, out, b, hq, hkv, d, block_k, s_max,
                             window, recip_bits, recip_frac_bits, stream);
}

const char* splitmax_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
