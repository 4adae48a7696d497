// Split-softmax attention for prefill: int8 Q/K/V -> f32 output.
//
// Replaces: repro/kernels/splitmax_attn.py::splitmax_attention_pallas
//           (body _splitmax_kernel, epilogue _recip_lut_inline).
//
// What bounds it on an H100: at the serving prefill shape (one 250-token
// prompt, 32 query heads, 4 KV heads, D = 64) the function reads ~0.6 MB of
// int8 Q/K/V and writes 2 MB of f32 output, and does ~0.4 G int8-equivalent
// operations: bytes bound it (~0.8 us at 3.35 TB/s), far below launch cost.
//
// Design, simple and right first:
//  * one block of 128 threads per (batch, query head, block of BQ query rows);
//    GQA maps query head h to KV head h / (Hq / Hkv);
//  * K/V stream through shared memory in 32-row tiles; causally dead, window-
//    dead and padding-dead tiles are never loaded (the loop bounds skip them);
//  * ragged Sq / Sk: rows and columns past the end are zero-filled on load and
//    masked, so no multiple-of-tile assertion is needed;
//  * the 256-entry exp table and the reciprocal table sit in shared memory and
//    are read by index (the TPU's one-hot matmul read is a layout choice);
//  * QK^T with __dp4a (D = 16 at the smoke size is below the int8 MMA depth);
//    e * V and the denominator on CUDA cores in f32, in a fixed order;
//  * the K tile is stored with a one-word row pad and the score tile with a
//    one-float row pad, so the dot products and row sums are free of shared-
//    memory bank conflicts.
// wgmma/TMA tiles come in later work.
#include "splitmax_common.cuh"

namespace {

using namespace splitmax;

constexpr int kBlockK = 32;           // K/V rows per tile
constexpr int kEStride = kBlockK + 1; // padded score-tile row

__global__ void __launch_bounds__(kThreads)
splitmax_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ m_z_ptr,
                     const float* __restrict__ s_v_ptr, const int* __restrict__ exp_lut,
                     const int* __restrict__ recip_lut_g, float* __restrict__ out,
                     int hq, int hkv, int sq, int sk, int d, int block_q, int kv_valid,
                     int causal, int window, int recip_bits, int recip_frac_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_recip = 1 << recip_bits;
  const int dw = d / 4;                               // int32 words per row
  size_t off = 0;
  int* exp_s = reinterpret_cast<int*>(smem + off);    off += align16(256 * 4);
  int* recip_s = reinterpret_cast<int*>(smem + off);  off += align16(n_recip * 4);
  float* e_s = reinterpret_cast<float*>(smem + off);  off += align16(block_q * kEStride * 4);
  float* s_s = reinterpret_cast<float*>(smem + off);  off += align16(block_q * 4);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + off); off += align16(block_q * d);
  int* k_s = reinterpret_cast<int*>(smem + off);      off += align16(kBlockK * (dw + 1) * 4);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + off);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;                 // b * hq + h
  const int b = bh / hq;
  const int hk = (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * block_q;
  const float m_z = *m_z_ptr;
  const float s_v = *s_v_ptr;

  for (int i = tid; i < 256; i += kThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += kThreads) recip_s[i] = recip_lut_g[i];
  for (int i = tid; i < block_q; i += kThreads) s_s[i] = 0.f;
  const int8_t* qg = q + (static_cast<size_t>(bh) * sq + q0) * d;
  for (int c = tid; c < block_q * d / 16; c += kThreads) {
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + c * 16 / d < sq) val = reinterpret_cast<const int4*>(qg)[c];
    reinterpret_cast<int4*>(q_s)[c] = val;
  }

  // live key range of this query block
  const int q_last = min(q0 + block_q, sq) - 1;
  const int k_valid = min(sk, kv_valid);
  int k_end = k_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  const int n_out = block_q * d;
  float acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;

  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * sk;
  for (int t = k_begin / kBlockK; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    const int* kg = reinterpret_cast<const int*>(k + (kv_base + k0) * d);
    const int* vg = reinterpret_cast<const int*>(v + (kv_base + k0) * d);
    for (int c = tid; c < kBlockK * dw; c += kThreads) {
      const int row = c / dw;
      const bool in = k0 + row < sk;
      k_s[row * (dw + 1) + c % dw] = in ? kg[c] : 0;
      reinterpret_cast<int*>(v_s)[c] = in ? vg[c] : 0;
    }
    __syncthreads();

    for (int i = tid; i < block_q * kBlockK; i += kThreads) {
      const int r = i / kBlockK, j = i % kBlockK;
      const int row = q0 + r, col = k0 + j;
      bool live = row < sq && col < k_valid;
      if (causal) live = live && col <= row;
      if (window > 0) live = live && col > row - window;
      const int z = dot_i8(reinterpret_cast<const int*>(q_s + r * d),
                           k_s + j * (dw + 1), dw);
      e_s[r * kEStride + j] = live ? requant_exp(z, m_z, exp_s) : 0.f;
    }
    __syncthreads();

    // denominator: exact integer tile sum, added in f32 (tile order)
    for (int r = tid; r < block_q; r += kThreads) {
      int tsum = 0;
      for (int j = 0; j < kBlockK; ++j) tsum += static_cast<int>(e_s[r * kEStride + j]);
      s_s[r] += static_cast<float>(tsum);
    }
    // numerator: acc += e . V
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = tid + u * kThreads;
      if (o < n_out) {
        const int r = o / d, c = o % d;
        float a = acc[u];
        for (int j = 0; j < kBlockK; ++j)
          a += e_s[r * kEStride + j] * static_cast<float>(v_s[j * d + c]);
        acc[u] = a;
      }
    }
  }
  __syncthreads();

  float* og = out + (static_cast<size_t>(bh) * sq + q0) * d;
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = tid + u * kThreads;
    if (o < n_out && q0 + o / d < sq) {
      const float s = fmaxf(s_s[o / d], 1.f);
      og[o] = acc[u] * recip_lut(s, recip_s, recip_bits, recip_frac_bits) * s_v;
    }
  }
}

size_t smem_bytes(int d, int block_q, int recip_bits) {
  return align16(256 * 4) + align16((1 << recip_bits) * 4) +
         align16(block_q * kEStride * 4) + align16(block_q * 4) + align16(block_q * d) +
         align16(kBlockK * (d / 4 + 1) * 4) + kBlockK * d;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).
int splitmax_attention_launch(const void* q, const void* k, const void* v, const void* m_z,
                              const void* s_v, const void* exp_lut, const void* recip_lut,
                              void* out, int b, int hq, int hkv, int sq, int sk, int d,
                              int block_q, int kv_valid, int causal, int window,
                              int recip_bits, int recip_frac_bits, void* stream) {
  const dim3 grid((sq + block_q - 1) / block_q, b * hq);
  splitmax_attn_kernel<<<grid, kThreads, smem_bytes(d, block_q, recip_bits),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(m_z),
      static_cast<const float*>(s_v), static_cast<const int*>(exp_lut),
      static_cast<const int*>(recip_lut), static_cast<float*>(out), hq, hkv, sq, sk, d,
      block_q, kv_valid, causal, window, recip_bits, recip_frac_bits);
  return static_cast<int>(cudaGetLastError());
}

const char* splitmax_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
