// Fused speculative verify, the default instances (splitmax_verify.cuh has
// the kernel and its design): the paged and the dense entry, each with a
// kExactRecip instance, the stage and the blocks an SM chosen by the
// launcher from the shared-memory budgets, the rows padded to m16 tiles.
//
// Replaces: repro/kernels/splitmax_decode.py::
//           splitmax_decode_fused_verify_paged_pallas (_paged_verify_call,
//           _paged_verify_kernel, _verify_body, _per_row) and
//           ::splitmax_decode_fused_verify_pallas (_dense_verify_call,
//           _verify_kernel).
#include "splitmax_verify.cuh"

namespace {

using namespace splitmax_verify;

// exact_recip != 0 launches the kExactRecip instance.
template <bool kDense>
int launch_d(const void* q, const void* k_cache, const void* v_cache, const void* table,
             const void* m_z, const void* s_q, const void* s_v, const void* cache_len,
             const void* exp_lut, const void* recip_lut, void* out, int b, int hq, int hkv,
             int n_tok, int d, int block_k, int extent, int window, int recip_bits,
             int recip_frac_bits, int exact_recip, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return by_ksteps(hq, hkv, n_tok, d, [&](auto n) {
    constexpr int kKSteps = decltype(n)::value;
    return (exact_recip ? launch<kKSteps, kDense, true, 0, 16>
                        : launch<kKSteps, kDense, false, 0, 16>)(
        q, k_cache, v_cache, table, m_z, s_q, s_v, cache_len, exp_lut, recip_lut, out, b,
        hq, hkv, n_tok, d, block_k, extent, window, recip_bits, recip_frac_bits, st);
  });
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
                                 int recip_frac_bits, int exact_recip, void* stream) {
  return launch_d<false>(q, k_pages, v_pages, table, m_z, s_q, s_v, cache_len, exp_lut,
                         recip_lut, out, b, hq, hkv, n_tok, d, block_k, max_blocks, window,
                         recip_bits, recip_frac_bits, exact_recip, stream);
}

int splitmax_verify_dense_launch(const void* q, const void* k_cache, const void* v_cache,
                                 const void* m_z, const void* s_q, const void* s_v,
                                 const void* cache_len, const void* exp_lut,
                                 const void* recip_lut, void* out, int b, int hq, int hkv,
                                 int n_tok, int d, int block_k, int s_max, int window,
                                 int recip_bits, int recip_frac_bits, int exact_recip,
                                 void* stream) {
  return launch_d<true>(q, k_cache, v_cache, nullptr, m_z, s_q, s_v, cache_len, exp_lut,
                        recip_lut, out, b, hq, hkv, n_tok, d, block_k, s_max, window,
                        recip_bits, recip_frac_bits, exact_recip, stream);
}

const char* splitmax_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
