// Shared device code of the split-softmax kernels (prefill, paged decode and
// paged verify).
//
// The arithmetic is the reference's, stage for stage:
//   q_q = clip(rint(q / s_q), -128, 127)               fused entries only
//   z32 = q . k            int8 x int8 dot, int32 accumulation (__dp4a)
//   z_q = clip(rint(f32(z32) * m_z), -128, 127)       32b -> 8b requant unit
//   e   = ExpLUT[z_q + 128]                            exact table read
//   acc += e * V (f32),  s += sum e (exact integer tile sums added in f32)
//   out = acc * RecipLUT(max(s, 1)) * s_v
// Rounding is IEEE round-to-nearest-even everywhere (rintf, __fmul_rn,
// __fdiv_rn); the build must not use --use_fast_math.  No atomics: every
// sum runs in a fixed order, so results do not depend on batch size or on
// which slots share a launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace splitmax {

constexpr int kThreads = 128;   // threads per block
constexpr int kMaxOut = 16;     // f32 accumulators per thread (rows * D <= 2048)
constexpr int kTrashBlock = 0;  // paged pool: block id 0 is never live data

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

// The 32b -> 8b quantization unit followed by the exp-LUT read.
__device__ __forceinline__ float requant_exp(int z32, float m_z, const int* exp_lut) {
  float z = rintf(__fmul_rn(static_cast<float>(z32), m_z));
  z = fminf(fmaxf(z, -128.f), 127.f);
  return static_cast<float>(exp_lut[static_cast<int>(z) + 128]);
}

// One output lane's e * V over a tile: a += e[j] * v[j * d], j in order, one
// explicit fused multiply-add each.  The decode and verify kernels both take
// it, so a verify row accumulates exactly as the decode kernel does; a masked
// lane (e = 0) leaves a unchanged.
__device__ __forceinline__ float accumulate_ev(float a, const float* e, const int8_t* v,
                                               int d, int n) {
  for (int j = 0; j < n; ++j) a = __fmaf_rn(e[j], static_cast<float>(v[j * d]), a);
  return a;
}

// Shared-memory carve-up, each region aligned to 16 bytes.
__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

}  // namespace splitmax
