// Fused speculative verify: the T draft queries of every slot vs the int8
// KV cache in one launch.  Two entries, one compile-time variant apart:
//   paged (kDense = false): the pool, read through each slot's block table;
//   dense (kDense = true):  the slot's rows of a (B, Hkv, S_max, D) cache,
//                           in tiles of block_k positions, the last one
//                           ragged (zero-filled past S_max, its lanes dead).
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
// s_q[b, t]:
// acc and s are exact integer sums (splitmax_common.cuh's contract), so a
// row is the decode kernel's result whatever the split of the keys; a tile
// that is dead for row t but live for another row adds exact zeros.
//
// What bounds it on an H100: one verify reads each live slot's int8 K and V
// once for all T queries (2 * Hkv * len * D bytes per slot per layer) and
// does 3 * T * group int8-equivalent operations per K/V byte (96 at T 4,
// group 8; 192 at T 8): still under the card's ~590 int8 operations per
// byte, so bytes bound it, as they do the decode kernel.  One pass over the cache serving
// all T queries is the point of the kernel: T decode launches read it T
// times.
//
// Design (the first, simple structure; only the accumulation has moved to
// the exact contract):
//  * one block per (slot, KV head) holding all T x group query rows of that
//    head, row r = head-in-group * T + t, so the block's q and out slabs are
//    contiguous in the (B, Hq, T, D) layout;
//  * accumulator room: T * group * D reaches 8 * 8 * 64 = 4096 values,
//    twice what kMaxOut (16) x 128 threads hold, so this kernel runs 256
//    threads a block with the same 16 accumulators a thread (more threads,
//    rather than more registers a thread or acc in shared memory);
//  * each row is quantized in-kernel with its own s_q[b, t] (round half to
//    even of an IEEE division, then clip);
//  * one loop over the ceil(cache_len / block_k) live table entries; each
//    K/V tile is loaded once into shared memory for all rows; a tile dead
//    for every row (window) and the trash block (id 0) are never read;
//  * QK^T with __dp4a; e * V and the denominator on CUDA cores, exact: an
//    int32 sum per tile (at most kIntChunk keys) added into int64 per
//    output; no atomics; LUTs in shared memory, read by index.
// Not carried over from the TPU kernel: the token-major g_pad row padding
// and its pad/unpad copies, the per-row concat of scalar-prefetch values,
// the 128-lane replicated tables, and a grid that walks every table entry
// and relies on pl.when.
#include "splitmax_common.cuh"

namespace {

using namespace splitmax;

constexpr int kVerifyThreads = 256;  // T * group * D <= kVerifyThreads * kMaxOut

// ``extent`` is the table width (paged) or S_max (dense); ``table`` is
// unused when dense.
template <bool kDense>
__global__ void __launch_bounds__(kVerifyThreads, 2)
verify_kernel(const float* __restrict__ q, const int8_t* __restrict__ k_cache,
              const int8_t* __restrict__ v_cache, const int* __restrict__ table,
              const float* __restrict__ m_z, const float* __restrict__ s_q,
              const float* __restrict__ s_v_ptr, const int* __restrict__ cache_len,
              const int* __restrict__ exp_lut, const int* __restrict__ recip_lut_g,
              float* __restrict__ out, int hq, int hkv, int n_tok, int d, int block_k,
              int extent, int window, int recip_bits, int recip_frac_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = hq / hkv;
  const int rows = group * n_tok;
  const int n_recip = 1 << recip_bits;
  const int dw = d / 4;
  const int e_stride = block_k + 1;
  size_t off = 0;
  int* exp_s = reinterpret_cast<int*>(smem + off);    off += align16(256 * 4);
  int* recip_s = reinterpret_cast<int*>(smem + off);  off += align16(n_recip * 4);
  int* e_s = reinterpret_cast<int*>(smem + off);      off += align16(rows * e_stride * 4);
  long long* s_s = reinterpret_cast<long long*>(smem + off); off += align16(rows * 8);
  float* mz_s = reinterpret_cast<float*>(smem + off); off += align16(rows * 4);
  int* eff_s = reinterpret_cast<int*>(smem + off);    off += align16(rows * 4);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + off); off += align16(rows * d);
  int* k_s = reinterpret_cast<int*>(smem + off);      off += align16(block_k * (dw + 1) * 4);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + off);

  const int tid = threadIdx.x;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int len = cache_len[b];              // counts all T verify tokens
  const float s_v = *s_v_ptr;
  const float* sq_b = s_q + static_cast<size_t>(b) * n_tok;
  const float* mz_b = m_z + static_cast<size_t>(b) * n_tok;

  for (int i = tid; i < 256; i += kVerifyThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += kVerifyThreads) recip_s[i] = recip_lut_g[i];
  for (int r = tid; r < rows; r += kVerifyThreads) {
    const int t = r % n_tok;
    s_s[r] = 0;
    mz_s[r] = mz_b[t];
    eff_s[r] = len - (n_tok - 1 - t);
  }
  // this head group's q slab, (group, T, D) contiguous -> int8 grid, each
  // row with its own (slot, token) scale
  const size_t q0 = (static_cast<size_t>(b) * hq + hk * group) * n_tok * d;
  const float* qg = q + q0;
  for (int i = tid; i < rows * d; i += kVerifyThreads)
    q_s[i] = quantize_i8(qg[i], sq_b[(i / d) % n_tok]);

  const int n_out = rows * d;
  long long acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0;

  const int n_tiles = kDense ? (min(len, extent) + block_k - 1) / block_k
                             : min((len + block_k - 1) / block_k, extent);
  const int shortest = len - (n_tok - 1);    // token 0's effective length
  const int* row_ids = kDense ? nullptr : table + static_cast<size_t>(b) * extent;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * block_k;
    // window-dead for every row: token 0's window starts furthest left
    if (window > 0 && k0 + block_k - 1 < shortest - window) continue;
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
    for (int c = tid; c < block_k * dw; c += kVerifyThreads) {
      const bool in = c < in_cache * dw;
      k_s[(c / dw) * (dw + 1) + c % dw] = in ? kg[c] : 0;
      reinterpret_cast<int*>(v_s)[c] = in ? vg[c] : 0;
    }
    __syncthreads();

    for (int i = tid; i < rows * block_k; i += kVerifyThreads) {
      const int r = i / block_k, j = i % block_k;
      const int col = k0 + j;
      const int eff = eff_s[r];
      bool live = col < eff && j < in_cache;
      if (window > 0) live = live && col > eff - 1 - window;
      const int z = dot_i8(reinterpret_cast<const int*>(q_s + r * d),
                           k_s + j * (dw + 1), dw);
      e_s[r * e_stride + j] = live ? requant_exp(z, mz_s[r], exp_s) : 0;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += kVerifyThreads) {
      long long tsum = 0;
      for (int j = 0; j < block_k; ++j) tsum += e_s[r * e_stride + j];
      s_s[r] += tsum;
    }
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = tid + u * kVerifyThreads;
      if (o < n_out) {
        const int r = o / d, c = o % d;
        for (int j0 = 0; j0 < block_k; j0 += kIntChunk)
          acc[u] += dot_ev(e_s + r * e_stride + j0, v_s + j0 * d + c, d,
                           min(kIntChunk, block_k - j0));
      }
    }
  }
  __syncthreads();

  float* og = out + q0;
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = tid + u * kVerifyThreads;
    if (o < n_out)
      og[o] = finalize(acc[u], s_s[o / d], s_v, recip_s, recip_bits, recip_frac_bits);
  }
}

size_t smem_bytes(int rows, int d, int block_k, int recip_bits) {
  return align16(256 * 4) + align16((1 << recip_bits) * 4) +
         align16(rows * (block_k + 1) * 4) + align16(rows * 8) + 2 * align16(rows * 4) +
         align16(rows * d) +
         align16(block_k * (d / 4 + 1) * 4) + block_k * d;
}

template <bool kDense>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* table,
           const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
           const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
           int n_tok, int d, int block_k, int extent, int window, int recip_bits,
           int recip_frac_bits, void* stream) {
  const size_t smem = smem_bytes(hq / hkv * n_tok, d, block_k, recip_bits);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_kernel<kDense>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(hkv, b);
  verify_kernel<kDense><<<grid, kVerifyThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k_cache),
      static_cast<const int8_t*>(v_cache), static_cast<const int*>(table),
      static_cast<const float*>(m_z), static_cast<const float*>(s_q),
      static_cast<const float*>(s_v), static_cast<const int*>(cache_len),
      static_cast<const int*>(exp_lut), static_cast<const int*>(recip_lut),
      static_cast<float*>(out), hq, hkv, n_tok, d, block_k, extent, window, recip_bits,
      recip_frac_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).
int splitmax_verify_paged_launch(const void* q, const void* k_pages, const void* v_pages,
                                 const void* table, const void* m_z, const void* s_q,
                                 const void* s_v, const void* cache_len,
                                 const void* exp_lut, const void* recip_lut, void* out,
                                 int b, int hq, int hkv, int n_tok, int d, int block_k,
                                 int max_blocks, int window, int recip_bits,
                                 int recip_frac_bits, void* stream) {
  return launch<false>(q, k_pages, v_pages, table, m_z, s_q, s_v, cache_len, exp_lut,
                       recip_lut, out, b, hq, hkv, n_tok, d, block_k, max_blocks, window,
                       recip_bits, recip_frac_bits, stream);
}

int splitmax_verify_dense_launch(const void* q, const void* k_cache, const void* v_cache,
                                 const void* m_z, const void* s_q, const void* s_v,
                                 const void* cache_len, const void* exp_lut,
                                 const void* recip_lut, void* out, int b, int hq, int hkv,
                                 int n_tok, int d, int block_k, int s_max, int window,
                                 int recip_bits, int recip_frac_bits, void* stream) {
  return launch<true>(q, k_cache, v_cache, nullptr, m_z, s_q, s_v, cache_len, exp_lut,
                      recip_lut, out, b, hq, hkv, n_tok, d, block_k, s_max, window,
                      recip_bits, recip_frac_bits, stream);
}

const char* splitmax_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
