// int8 x int8 -> int32 GEMM ("the CIM core"), optionally fused with the
// 32b -> 8b quantization unit:
//   out = x_q (M, K) @ w_q (K, N)                        int32, or
//   out = clip(rint(f32(acc) * m), -128, 127)            int8 (requant)
//
// Replaces: repro/kernels/int8_matmul.py::int8_matmul_pallas
//           (_int8_matmul_kernel; reference numerics kernels/ref.py::
//           int8_matmul_ref / int8_matmul_requant_ref).
//
// What bounds it on an H100: 2 * M * K * N int8 operations against
// M * K + K * N + (4 or 1) * M * N bytes.  At the TinyLlama width (M 2048,
// K 2048, N 5632) that is 47.2 G operations, ~24 us at 1,979 TOPS, against
// ~59 MB, ~18 us at 3.35 TB/s: operations bound it, so the tensor cores
// must do the multiplies.
//
// Design (the first, simple one; no model calls this kernel, so it has
// not been redesigned for the card):
//  * one 256-thread block per 128 x 128 output tile; 8 warps in a 4 x 2
//    grid, each warp 32 x 64 outputs in int32 registers (2 x 8 fragments of
//    mma.sync.m16n8k32 s8 x s8 -> s32), exact integer accumulation;
//  * K walks in steps of 32: the A tile (128 x 32) is copied row-major into
//    shared memory, the B tile (32 x 128) transposed to (128 x 32) so both
//    operands' fragments are 4-byte reads with k contiguous; rows are
//    padded to 48 bytes, which makes the fragment reads conflict-free;
//  * interior tiles load 16 bytes (A) and 4 x 4 bytes (B, transposed in
//    registers with __byte_perm) a thread; edge tiles load byte by byte
//    with bounds checks and zero fill, so any M, N, K works (the TPU kernel
//    asserts divisibility by its blocks);
//  * the requant epilogue is the reference's jnp.round(f32(acc) * m):
//    __int2float_rn (|acc| passes 2^24 for K >= 1024), __fmul_rn (no FMA
//    contraction), rintf (half to even), then the int8 clamp.
// No pipelining of loads against the tensor cores (cp.async / TMA) and no
// wgmma.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kPitch = kBK + 16;  // shared row pitch in bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int load_word(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

template <bool kRequant>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ mult, void* __restrict__ out, int m, int n,
                   int k, int vec_ok) {
  __shared__ __align__(16) int8_t a_s[kBM * kPitch];
  __shared__ __align__(16) int8_t b_s[kBN * kPitch];  // b_s[n][k]: B transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool interior = vec_ok && m0 + kBM <= m && n0 + kBN <= n;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();  // the previous step's fragment reads are done
    if (interior && k0 + kBK <= k) {
      {  // A: 128 rows x 32 bytes, one 16-byte vector a thread
        const int r = tid >> 1, c = (tid & 1) * 16;
        *reinterpret_cast<int4*>(a_s + r * kPitch + c) =
            *reinterpret_cast<const int4*>(x + static_cast<size_t>(m0 + r) * k + k0 + c);
      }
      {  // B: a 4 (k) x 4 (n) byte block a thread, transposed in registers
        const int nq = tid >> 3, kq = tid & 7;
        const int8_t* src = w + static_cast<size_t>(k0 + kq * 4) * n + n0 + nq * 4;
        const unsigned r0 = load_word(src), r1 = load_word(src + n);
        const unsigned r2 = load_word(src + 2 * n), r3 = load_word(src + 3 * n);
        const unsigned lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
        const unsigned lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
        int8_t* dst = b_s + (nq * 4) * kPitch + kq * 4;
        *reinterpret_cast<unsigned*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<unsigned*>(dst + kPitch) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<unsigned*>(dst + 2 * kPitch) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<unsigned*>(dst + 3 * kPitch) = __byte_perm(hi01, hi23, 0x7632);
      }
    } else {  // an edge tile: bounds-checked bytes, zeros outside
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int gr = m0 + r, gc = k0 + c;
        a_s[r * kPitch + c] = (gr < m && gc < k) ? x[static_cast<size_t>(gr) * k + gc] : 0;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;  // r along k, c along n
        const int gr = k0 + r, gc = n0 + c;
        b_s[c * kPitch + r] = (gr < k && gc < n) ? w[static_cast<size_t>(gr) * n + gc] : 0;
      }
    }
    __syncthreads();

    int af[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = a_s + (wm + i * 16 + g) * kPitch + tig * 4;
      af[i][0] = load_word(p);                    // row g,     k tig*4 ..
      af[i][1] = load_word(p + 8 * kPitch);       // row g + 8, k tig*4 ..
      af[i][2] = load_word(p + 16);               // row g,     k 16 + tig*4 ..
      af[i][3] = load_word(p + 8 * kPitch + 16);  // row g + 8, k 16 + tig*4 ..
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* p = b_s + (wn + j * 8 + g) * kPitch + tig * 4;
      bf[j][0] = load_word(p);                    // col g, k tig*4 ..
      bf[j][1] = load_word(p + 16);               // col g, k 16 + tig*4 ..
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }

  const float mlt = kRequant ? *mult : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + j * 8 + tig * 2 + (e & 1);
        if (row >= m || col >= n) continue;
        const size_t o = static_cast<size_t>(row) * n + col;
        if constexpr (kRequant) {
          float y = rintf(__fmul_rn(__int2float_rn(acc[i][j][e]), mlt));
          y = fminf(fmaxf(y, -128.f), 127.f);
          static_cast<int8_t*>(out)[o] = static_cast<int8_t>(y);
        } else {
          static_cast<int*>(out)[o] = acc[i][j][e];
        }
      }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess).  ``mult`` is a
// device f32 scalar, or null for the int32 output; ``vec_ok`` says that K
// is a multiple of 16, N of 4 and both bases 16-byte aligned.
int int8_matmul_launch(const void* x, const void* w, const void* mult, void* out, int m,
                       int n, int k, int vec_ok, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xp = static_cast<const int8_t*>(x);
  const auto wp = static_cast<const int8_t*>(w);
  const auto mp = static_cast<const float*>(mult);
  if (mult != nullptr)
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(xp, wp, mp, out, m, n, k, vec_ok);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(xp, wp, mp, out, m, n, k, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
