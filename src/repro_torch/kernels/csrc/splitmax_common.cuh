// Shared device code of the split-softmax kernels (prefill, decode, verify).
//
// The arithmetic is the reference's, stage for stage:
//   q_q = clip(rint(q / s_q), -128, 127)               fused entries only
//   z32 = q . k            int8 x int8 dot, int32 accumulation
//   z_q = clip(rint(f32(z32) * m_z), -128, 127)       32b -> 8b requant unit
//   e   = ExpLUT[z_q + 128]                            an integer in [0, 2^15]
//
// The accumulation contract, one for every split-softmax kernel:
//   acc = sum e * v    exactly, in integers
//   s   = sum e        exactly, in integers
//   out = f32(acc) * RecipLUT(max(f32(s), 1)) * s_v
// (the exact_recip instances, kExactRecip: 1 / max(f32(s), 1), an IEEE
// division, in place of RecipLUT, multiplied in the same order).
// Each term e * v is an integer with |e * v| <= 2^22, so the sums are
// exact whatever the order or the partition of the keys: a split-K
// decode, a verify row and the decode at its length, a dense slot and a
// paged one give the same bits by construction.  Both conversions round
// to nearest (__ll2float_rn, __int2float_rn); the epilogue multiplies in
// the order written, with the bit-pattern reciprocal of recip_lut.  The
// plain versions' ``exact=True`` mode computes the same function (f64
// sums of integers below 2^53, cast to f32 once).
//
// How each kernel keeps the integers exact:
//   decode, verify  int32 sums over at most kIntChunk keys (|sum| < 2^31),
//                   added into int64 running sums;
//   prefill         the byte split e = 256 * e_hi + e_lo (e_hi, e_lo in
//                   [0, 255] when e <= 2^15) on u8 x s8 tensor cores, two
//                   int32 sums exact up to kMaxExactKeys keys
//                   (65535 * 255 * 128 < 2^31), combined in int64.
// The prefill keeps s in int32 (65535 * 2^15 < 2^31); decode and verify
// keep it in int64.
// The wrappers raise for exp_frac_bits > 15 and for a prefill over more
// than kMaxExactKeys keys.
//
// Rounding is IEEE round-to-nearest-even everywhere (rintf, __fmul_rn,
// __fdiv_rn); the build must not use --use_fast_math.  No atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splitmax {

constexpr int kThreads = 128;          // threads per block (decode)
constexpr int kMaxOut = 16;            // outputs per thread (decode)
constexpr int kTrashBlock = 0;         // paged pool: block 0 is never live data
constexpr int kIntChunk = 256;         // keys per exact int32 partial sum
constexpr int kMaxExactKeys = 65535;   // the prefill's byte-split range

// 2^e for integer e in [-126, 127], assembled from the exponent field.
__device__ __forceinline__ float exp2_int(int e) {
  return __int_as_float((e + 127) << 23);
}

// 1/s for s >= 1 from the reciprocal-mantissa LUT; the index and the power of
// two come from the f32 bit pattern, as lut.recip_lookup does.
__device__ __forceinline__ float recip_lut(float s, const int* recip, int mbits,
                                           int frac_bits) {
  const int bits = __float_as_int(s);
  const int expo = ((bits >> 23) & 0xFF) - 127;
  const int idx = (bits >> (23 - mbits)) & ((1 << mbits) - 1);
  return static_cast<float>(recip[idx]) * exp2_int(-expo - frac_bits);
}

// The contract's epilogue: f32(acc) * RecipLUT(max(f32(s), 1)) * s_v, or
// with kExactRecip (the reference's exact_recip ablation) the correctly
// rounded 1 / max(f32(s), 1) in place of the LUT.
template <bool kExactRecip>
__device__ __forceinline__ float finalize(long long acc, long long s, float s_v,
                                          const int* recip, int mbits,
                                          int frac_bits) {
  const float sf = fmaxf(__ll2float_rn(s), 1.f);
  float r;
  if constexpr (kExactRecip) {
    r = __fdiv_rn(1.f, sf);
  } else {
    r = recip_lut(sf, recip, mbits, frac_bits);
  }
  return __fmul_rn(__fmul_rn(__ll2float_rn(acc), r), s_v);
}

// int8 dot of two rows held as packed 32-bit words.
__device__ __forceinline__ int dot_i8(const int* a, const int* b, int words) {
  int z = 0;
  for (int w = 0; w < words; ++w) z = __dp4a(a[w], b[w], z);
  return z;
}

// float -> int8 as core.quantization.quantize: IEEE division by the scale,
// round half to even, saturate.
__device__ __forceinline__ int8_t quantize_i8(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -128.f), 127.f));
}

// The 32b -> 8b quantization unit followed by the exp-LUT read: e as an int.
__device__ __forceinline__ int requant_exp(int z32, float m_z, const int* exp_lut) {
  float z = rintf(__fmul_rn(__int2float_rn(z32), m_z));
  z = fminf(fmaxf(z, -128.f), 127.f);
  return exp_lut[static_cast<int>(z) + 128];
}

// Byte i (0..3) of a packed word, sign-extended.
__device__ __forceinline__ int sbyte(int w, int i) {
  return (w << (24 - 8 * i)) >> 24;
}

// Exact e * V of one output lane over n <= kIntChunk keys:
// sum_j e[j] * v[j * stride], in int32.  Integer sums take any order, so
// four independent partial sums keep four multiply-adds in flight.
__device__ __forceinline__ int dot_ev(const int* e, const int8_t* v, int stride, int n) {
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0, j = 0;
  for (; j + 4 <= n; j += 4) {
    a0 += e[j] * static_cast<int>(v[j * stride]);
    a1 += e[j + 1] * static_cast<int>(v[(j + 1) * stride]);
    a2 += e[j + 2] * static_cast<int>(v[(j + 2) * stride]);
    a3 += e[j + 3] * static_cast<int>(v[(j + 3) * stride]);
  }
  for (; j < n; ++j) a0 += e[j] * static_cast<int>(v[j * stride]);
  return (a0 + a1) + (a2 + a3);
}

// ---- asynchronous copies (cp.async, sm_80+) --------------------------------

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes a zero word.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared-memory carve-up, each region aligned to 16 bytes.
__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

}  // namespace splitmax
