// Split-softmax attention for prefill: int8 Q/K/V -> f32 output, on the int8
// tensor cores.
//
// Replaces: repro/kernels/splitmax_attn.py::splitmax_attention_pallas
//           (body _splitmax_kernel, epilogue _recip_lut_inline).
//
// What bounds it on an H100: at the serving prefill shape (one 250-token
// prompt, 32 query heads, 4 KV heads, D = 64) the function reads ~0.6 MB of
// int8 Q/K/V and writes 2 MB of f32 output, and does ~0.4 G int8-equivalent
// operations: bytes bound it (~0.8 us at 3.35 TB/s), far below launch cost,
// so what sets the pace is the latency of each block's chain of tiles.
//
// Design:
//  * one block per (batch, query head, 64 query rows); GQA maps query head
//    h to KV head h / (Hq / Hkv).  Each query head reads its KV head's tiles
//    from L2: sharing a tile across the group's heads would cut the blocks
//    of a one-prompt prefill from 128 to 16 on 132 SMs;
//  * a warp owns 16 query rows (the m16 of mma.sync); a block of 4 such
//    warps covers 64 rows.  For D > 64 the output columns are split across
//    warps, 64 each (the warps of one row group repeat its small QK^T), and
//    above D 128 the block narrows to 32 rows, so no warp holds more than
//    16 x 64 outputs;
//  * QK^T on the int8 tensor cores, mma.sync.m16n8k32 s8 x s8 -> s32, Q
//    fragments in registers for the whole block; D is zero-padded to a
//    multiple of 32 in shared memory (exact), so D 16 runs too;
//  * in registers: z_q = clip(rint(f32(z32) * m_z)), e from the shared
//    exp LUT, the causal / window / padding masks, and the row sums of e;
//  * e . V on the tensor cores as well, u8 x s8 -> s32, on the bytes of
//    e = 256 * e_hi + e_lo, two int32 accumulators per output carried across
//    tiles and joined in int64 at the end (splitmax_common.cuh's contract);
//    kExactRecip instances divide in the epilogue (the exact_recip option).
//    The QK^T C fragment becomes the e . V A fragment in place: the key
//    order inside the k32 contraction is free, so V^T is written to shared
//    memory in the order each thread already holds its scores in (keys
//    {2t, 2t+1, 8+2t, 9+2t} at A positions 4t..4t+3), with a __byte_perm
//    4x4 transpose (splitmax_mma.cuh, shared with the verify); no shuffle
//    and no shared round trip of the scores;
//  * K/V tiles of 64 keys double-buffered with cp.async: the next tile's
//    copy is in flight during the current tile's math; causally, window-
//    and padding-dead tiles are never loaded; ragged Sq / Sk are masked
//    (rows past Sk are zero-filled by the copy), not asserted;
//  * shared rows are padded by 16 bytes, which makes every fragment read
//    free of bank conflicts.
#include "splitmax_common.cuh"
#include "splitmax_mma.cuh"

namespace {

using namespace splitmax;

constexpr int kBlockK = 64;            // keys per tile
constexpr int kScoreTiles = kBlockK / 8;
constexpr int kDChunk = 64;            // output columns per warp
constexpr int kOutTiles = kDChunk / 8;

template <int kKSteps>
struct Shape {
  static constexpr int kDp = 32 * kKSteps;                 // D padded to k32
  static constexpr int kDChunks = (kDp + kDChunk - 1) / kDChunk;
  static constexpr int kRowWarps = kDChunks <= 2 ? 4 : 2;
  static constexpr int kBlockQ = 16 * kRowWarps;
  static constexpr int kThreads = 32 * kRowWarps * kDChunks;
  static constexpr int kRowPitch = kDp + 16;               // q_s, k_s rows
  static constexpr int kVtPitch = kBlockK + 16;            // vt_s rows
};

struct Smem {
  size_t exp, recip, q, k0, k1, v0, v1, vt, total;
};

template <int kKSteps>
__host__ __device__ Smem smem_layout(int d, int recip_bits) {
  using S = Shape<kKSteps>;
  Smem m;
  size_t off = 0;
  m.exp = off;    off += align16(256 * 4);
  m.recip = off;  off += align16((1u << recip_bits) * 4);
  m.q = off;      off += align16(static_cast<size_t>(S::kBlockQ) * S::kRowPitch);
  m.k0 = off;     off += align16(static_cast<size_t>(kBlockK) * S::kRowPitch);
  m.k1 = off;     off += align16(static_cast<size_t>(kBlockK) * S::kRowPitch);
  m.v0 = off;     off += align16(static_cast<size_t>(kBlockK) * d);
  m.v1 = off;     off += align16(static_cast<size_t>(kBlockK) * d);
  m.vt = off;     off += align16(static_cast<size_t>(d) * S::kVtPitch);
  m.total = off;
  return m;
}

template <int kKSteps, bool kExactRecip>
__global__ void __launch_bounds__(Shape<kKSteps>::kThreads)
splitmax_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v, const float* __restrict__ m_z_ptr,
                     const float* __restrict__ s_v_ptr, const int* __restrict__ exp_lut,
                     const int* __restrict__ recip_lut_g, float* __restrict__ out,
                     int hq, int hkv, int sq, int sk, int d, int kv_valid, int causal,
                     int window, int recip_bits, int recip_frac_bits) {
  using S = Shape<kKSteps>;
  constexpr int kDp = S::kDp, kP = S::kRowPitch, kVtP = S::kVtPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout<kKSteps>(d, recip_bits);
  int* exp_s = reinterpret_cast<int*>(smem + L.exp);
  int* recip_s = reinterpret_cast<int*>(smem + L.recip);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + L.q);
  // the two buffers of each double-buffered tile, buf * stride apart
  int8_t* const k_s0 = reinterpret_cast<int8_t*>(smem + L.k0);
  int8_t* const v_s0 = reinterpret_cast<int8_t*>(smem + L.v0);
  const size_t k_stride = L.k1 - L.k0, v_stride = L.v1 - L.v0;
  int8_t* vt_s = reinterpret_cast<int8_t*>(smem + L.vt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;          // mma fragment coordinates
  const int r0 = (warp % S::kRowWarps) * 16;        // this warp's rows in the block
  const int dbase = (warp / S::kRowWarps) * kDChunk; // and its output columns
  const int bh = blockIdx.y;                        // b * hq + h
  const int b = bh / hq;
  const int hk = (bh % hq) / (hq / hkv);
  const int q0 = blockIdx.x * S::kBlockQ;
  const float m_z = *m_z_ptr;
  const float s_v = *s_v_ptr;
  const int n_recip = 1 << recip_bits;
  const int dchunks16 = d / 16;                     // 16-byte chunks of a row

  for (int i = tid; i < 256; i += S::kThreads) exp_s[i] = exp_lut[i];
  for (int i = tid; i < n_recip; i += S::kThreads) recip_s[i] = recip_lut_g[i];
  const int8_t* qg = q + (static_cast<size_t>(bh) * sq + q0) * d;
  for (int c = tid; c < S::kBlockQ * (kDp / 16); c += S::kThreads) {
    const int row = c / (kDp / 16), ch = c % (kDp / 16);
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + row < sq && ch < dchunks16)
      val = *reinterpret_cast<const int4*>(qg + static_cast<size_t>(row) * d + ch * 16);
    *reinterpret_cast<int4*>(q_s + row * kP + ch * 16) = val;
  }
  if (kDp > d) {  // the K tiles' zero padding past D, never overwritten
    for (int c = tid; c < 2 * kBlockK * (kDp / 16 - dchunks16); c += S::kThreads) {
      const int buf = c / (kBlockK * (kDp / 16 - dchunks16));
      const int rc = c % (kBlockK * (kDp / 16 - dchunks16));
      const int row = rc / (kDp / 16 - dchunks16);
      const int ch = dchunks16 + rc % (kDp / 16 - dchunks16);
      *reinterpret_cast<int4*>(k_s0 + buf * k_stride + row * kP + ch * 16) = make_int4(0, 0, 0, 0);
    }
  }

  // live key range of this query block
  const int q_last = min(q0 + S::kBlockQ, sq) - 1;
  const int k_valid = min(sk, kv_valid);
  int k_end = k_valid;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  const size_t kv_base = (static_cast<size_t>(b) * hkv + hk) * sk;
  auto issue_tile = [&](int t, int buf) {
    const int k0 = t * kBlockK;
    const int8_t* kg = k + (kv_base + k0) * d;
    const int8_t* vg = v + (kv_base + k0) * d;
    for (int c = tid; c < kBlockK * dchunks16; c += S::kThreads) {
      const int row = c / dchunks16, ch = c % dchunks16;
      const bool in = k0 + row < sk;
      const size_t src = in ? static_cast<size_t>(row) * d + ch * 16 : 0;
      cp_async16(k_s0 + buf * k_stride + row * kP + ch * 16, kg + src, in ? 16 : 0);
      cp_async16(v_s0 + buf * v_stride + row * d + ch * 16, vg + src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (t_begin < t_end) issue_tile(t_begin, 0);
  __syncthreads();

  int qa[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int8_t* p = q_s + (r0 + g) * kP + ks * 32 + tig * 4;
    qa[ks][0] = *reinterpret_cast<const int*>(p);
    qa[ks][1] = *reinterpret_cast<const int*>(p + 8 * kP);
    qa[ks][2] = *reinterpret_cast<const int*>(p + 16);
    qa[ks][3] = *reinterpret_cast<const int*>(p + 8 * kP + 16);
  }

  int acc_hi[kOutTiles][4], acc_lo[kOutTiles][4];
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_hi[n][i] = acc_lo[n][i] = 0;
  int s_row[2] = {0, 0};                            // rows g and g + 8
  const int row_a = q0 + r0 + g;                    // absolute rows of c0/c1
  const int row_max = q0 + r0 + 15;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    const int k0 = t * kBlockK;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed for all; every reader of t - 1 is done
    if (t + 1 < t_end) issue_tile(t + 1, buf ^ 1);

    // V^T into vt_s, keys in the order the score fragments hold them
    for (int c = tid; c < (kBlockK / 16) * 4 * (d / 4); c += S::kThreads) {
      const int dq = c % (d / 4), rest = c / (d / 4);
      const int tq = rest % 4, half = rest / 4;      // half: 16-key group
      const int key0 = half * 16 + 2 * tq;           // keys key0, +1, +8, +9
      transpose_v_quad(v_s0 + buf * v_stride + key0 * d + dq * 4, d,
                       vt_s + (dq * 4) * kVtP + half * 16 + tq * 4, kVtP);
    }

    // a warp whose rows are all past the block's end or all before the
    // tile's first key (causal) has e = 0 everywhere: it skips the math
    const bool warp_live = q0 + r0 < sq && !(causal && k0 > row_max);
    int sc[kScoreTiles][4];
    if (warp_live) {
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0;
        const int8_t* p = k_s0 + buf * k_stride + (nt * 8 + g) * kP + tig * 4;
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          mma_s8s8(sc[nt], qa[ks], *reinterpret_cast<const int*>(p + ks * 32),
                   *reinterpret_cast<const int*>(p + ks * 32 + 16));
      }
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row_a + (i >> 1) * 8;
          const int col = k0 + nt * 8 + 2 * tig + (i & 1);
          bool live = row < sq && col < k_valid;
          if (causal) live = live && col <= row;
          if (window > 0) live = live && col > row - window;
          const int e = live ? requant_exp(sc[nt][i], m_z, exp_s) : 0;
          sc[nt][i] = e;
          s_row[i >> 1] += e;
        }
    }
    __syncthreads();  // vt_s is complete

    if (warp_live) {
#pragma unroll
      for (int ks = 0; ks < kBlockK / 32; ++ks) {
        unsigned a_lo[4], a_hi[4];
        pack_e_frags(sc[4 * ks], sc[4 * ks + 1], sc[4 * ks + 2], sc[4 * ks + 3], a_lo,
                     a_hi);
#pragma unroll
        for (int dn = 0; dn < kOutTiles; ++dn) {
          if (dbase + dn * 8 < d) {
            const int8_t* p = vt_s + (dbase + dn * 8 + g) * kVtP + ks * 32 + tig * 4;
            const int b0 = *reinterpret_cast<const int*>(p);
            const int b1 = *reinterpret_cast<const int*>(p + 16);
            mma_u8s8(acc_lo[dn], a_lo, b0, b1);
            mma_u8s8(acc_hi[dn], a_hi, b0, b1);
          }
        }
      }
    }
  }

  // each row's denominator is spread over the 4 threads of its quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 1);
    s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 2);
  }
  float* og = out + static_cast<size_t>(bh) * sq * d;
#pragma unroll
  for (int dn = 0; dn < kOutTiles; ++dn) {
    const int col = dbase + dn * 8 + 2 * tig;
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + h * 8;
      if (row >= sq) continue;
      float2 o;
      o.x = finalize<kExactRecip>(256LL * acc_hi[dn][2 * h] + acc_lo[dn][2 * h],
                                  s_row[h], s_v, recip_s, recip_bits, recip_frac_bits);
      o.y = finalize<kExactRecip>(256LL * acc_hi[dn][2 * h + 1] + acc_lo[dn][2 * h + 1],
                                  s_row[h], s_v, recip_s, recip_bits, recip_frac_bits);
      *reinterpret_cast<float2*>(og + static_cast<size_t>(row) * d + col) = o;
    }
  }
}

template <int kKSteps, bool kExactRecip>
int launch(const void* q, const void* k, const void* v, const void* m_z, const void* s_v,
           const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
           int sq, int sk, int d, int kv_valid, int causal, int window, int recip_bits,
           int recip_frac_bits, cudaStream_t stream) {
  using S = Shape<kKSteps>;
  const size_t smem = smem_layout<kKSteps>(d, recip_bits).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        splitmax_attn_kernel<kKSteps, kExactRecip>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + S::kBlockQ - 1) / S::kBlockQ, b * hq);
  splitmax_attn_kernel<kKSteps, kExactRecip><<<grid, S::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(m_z),
      static_cast<const float*>(s_v), static_cast<const int*>(exp_lut),
      static_cast<const int*>(recip_lut), static_cast<float*>(out), hq, hkv, sq, sk, d,
      kv_valid, causal, window, recip_bits, recip_frac_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).  D is a multiple
// of 16 in [16, 256]; the wrapper checks it, and that at most
// kMaxExactKeys keys are attended.  exact_recip != 0 launches the
// kExactRecip instance.
int splitmax_attention_launch(const void* q, const void* k, const void* v, const void* m_z,
                              const void* s_v, const void* exp_lut, const void* recip_lut,
                              void* out, int b, int hq, int hkv, int sq, int sk, int d,
                              int kv_valid, int causal, int window, int recip_bits,
                              int recip_frac_bits, int exact_recip, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define SPLITMAX_ATTN_CASE(n)                                                           \
  case n:                                                                               \
    return (exact_recip ? launch<n, true> : launch<n, false>)(                          \
        q, k, v, m_z, s_v, exp_lut, recip_lut, out, b, hq, hkv, sq, sk, d, kv_valid,    \
        causal, window, recip_bits, recip_frac_bits, s);
  switch ((d + 31) / 32) {
    SPLITMAX_ATTN_CASE(1)
    SPLITMAX_ATTN_CASE(2)
    SPLITMAX_ATTN_CASE(3)
    SPLITMAX_ATTN_CASE(4)
    SPLITMAX_ATTN_CASE(5)
    SPLITMAX_ATTN_CASE(6)
    SPLITMAX_ATTN_CASE(7)
    SPLITMAX_ATTN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPLITMAX_ATTN_CASE
}

const char* splitmax_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
