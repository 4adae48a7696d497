// The tile instances of the fused speculative verify that the tile sweep
// (kernels/autotune.py) times and kernels/ops.py launches for a swept
// winner (splitmax_verify.cuh has the kernel and its design; no kExactRecip
// instances), for one row padding SPLITMAX_VERIFY_ROW_PAD, which the source
// that includes this file defines (splitmax_verify_tiles.cu: 16, the
// reference's g_pad_min 8; splitmax_verify_tiles_pad.cu: 32, g_pad_min 16;
// two sources, so that nvcc builds the two halves in parallel):
//   dense (kernel 7): kStage in {1, 2, 4, 8, 16} tiles of 32 keys a rank
//     holds in flight (the reference's block_k = 32 * kStage);
//   paged (kernel 3), row padding 32 only: its stage stays the launcher's,
//     its tile the pool's block_k.
// Each launcher returns cudaErrorInvalidValue for a stage or row padding it
// has no instance of, or whose shared memory passes 227 KB.
//
// Replaces: repro/kernels/splitmax_decode.py::_dense_verify_call and
//           ::_paged_verify_call at their (block_k, g_pad_min) parameters.
#pragma once

#include "splitmax_verify.cuh"

namespace {

using namespace splitmax_verify;

template <bool kDense, int kStage, int kRowPad>
int launch_tile(const void* q, const void* k_cache, const void* v_cache, const void* table,
                const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
                const void* exp_lut, const void* recip_lut, void* out, int b, int hq,
                int hkv, int n_tok, int d, int block_k, int extent, int window,
                int recip_bits, int recip_frac_bits, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return by_ksteps(hq, hkv, n_tok, d, [&](auto n) {
    constexpr int kKSteps = decltype(n)::value;
    return launch<kKSteps, kDense, false, kStage, kRowPad>(
        q, k_cache, v_cache, table, m_z, s_q, s_v, cache_len, exp_lut, recip_lut, out, b,
        hq, hkv, n_tok, d, block_k, extent, window, recip_bits, recip_frac_bits, st);
  });
}

template <int kStage>
int dense_stage(int row_pad, const void* q, const void* k_cache, const void* v_cache,
                const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
                const void* exp_lut, const void* recip_lut, void* out, int b, int hq,
                int hkv, int n_tok, int d, int block_k, int s_max, int window,
                int recip_bits, int recip_frac_bits, void* stream) {
  if (row_pad != SPLITMAX_VERIFY_ROW_PAD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<true, kStage, SPLITMAX_VERIFY_ROW_PAD>(
      q, k_cache, v_cache, nullptr, m_z, s_q, s_v, cache_len, exp_lut, recip_lut, out, b,
      hq, hkv, n_tok, d, block_k, s_max, window, recip_bits, recip_frac_bits, stream);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = cudaSuccess).
int splitmax_verify_tile_dense_launch(const void* q, const void* k_cache,
                                      const void* v_cache, const void* m_z,
                                      const void* s_q, const void* s_v,
                                      const void* cache_len, const void* exp_lut,
                                      const void* recip_lut, void* out, int b, int hq,
                                      int hkv, int n_tok, int d, int block_k, int s_max,
                                      int window, int recip_bits, int recip_frac_bits,
                                      int stage, int row_pad, void* stream) {
#define SPLITMAX_VERIFY_STAGE(n)                                                          \
  case n:                                                                                 \
    return dense_stage<n>(row_pad, q, k_cache, v_cache, m_z, s_q, s_v, cache_len,        \
                          exp_lut, recip_lut, out, b, hq, hkv, n_tok, d, block_k, s_max, \
                          window, recip_bits, recip_frac_bits, stream);
  switch (stage) {
    SPLITMAX_VERIFY_STAGE(1)
    SPLITMAX_VERIFY_STAGE(2)
    SPLITMAX_VERIFY_STAGE(4)
    SPLITMAX_VERIFY_STAGE(8)
    SPLITMAX_VERIFY_STAGE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPLITMAX_VERIFY_STAGE
}

#if SPLITMAX_VERIFY_ROW_PAD == 32
int splitmax_verify_tile_paged_launch(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* m_z, const void* s_q, const void* s_v,
                                      const void* cache_len, const void* exp_lut,
                                      const void* recip_lut, void* out, int b, int hq,
                                      int hkv, int n_tok, int d, int block_k,
                                      int max_blocks, int window, int recip_bits,
                                      int recip_frac_bits, int row_pad, void* stream) {
  if (row_pad != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<false, 0, 32>(q, k_pages, v_pages, table, m_z, s_q, s_v, cache_len,
                                   exp_lut, recip_lut, out, b, hq, hkv, n_tok, d, block_k,
                                   max_blocks, window, recip_bits, recip_frac_bits, stream);
}
#endif

const char* SPLITMAX_VERIFY_TILES_ERROR_FN(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
