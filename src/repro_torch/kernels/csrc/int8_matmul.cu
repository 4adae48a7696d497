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
// ~59 MB, ~18 us at 3.35 TB/s: operations bound it, so the work must reach
// the tensor cores through wgmma, the only way to their full rate.
//
// Two launches:
//  * pack_k_major_kernel, the pre-pass: wgmma takes 8-bit operands K-major
//    only (the transpose immediates exist for f16 and bf16 alone), and w_q
//    is (K, N) row-major, N-major.  A tiled transpose through shared memory
//    writes w_t (N, Kp), Kp = round_up(K, 16) so that a row pitch is a
//    multiple of 16 bytes, as TMA needs; the pad columns are zero, so they
//    add nothing to the sums.  It moves 2 * K * N bytes (23 MB, ~7 us at
//    3.35 TB/s at the width above), counted in the GEMM's time.  The
//    wrapper pads x_q to (M, Kp) with zeros only when K % 16 != 0 or its
//    base is not 16-byte aligned.
//  * gemm_kernel, the body: one block per 128 x 256 output tile (not
//    persistent), 3 warpgroups.  One thread of the producer warpgroup
//    issues TMA loads (cp.async.bulk.tensor.2d) of the x tile (128 rows x
//    128 bytes of k) and the w_t tile (256 rows x 128 bytes) into a ring of
//    kStages stages (48 KB each) with full and empty mbarriers.  The two
//    consumer warpgroups each run wgmma.m64n256k32.s32.s8.s8 over their 64
//    rows, four k32 steps a stage, the descriptors' start addresses
//    advanced 32 bytes a step in the 128-byte swizzle that the tensor maps
//    write (the byte geometry of a bf16 k16 step).  A stage is released to
//    the producer once the next stage's wgmma group is issued and the
//    previous one has completed.  TMA zero-fills the out-of-bounds rows
//    and k columns of ragged tiles.
//  * exact integer accumulation: 128 int32 accumulators a consumer thread.
//    The epilogue stores straight from the fragments (the m16n8 C layout of
//    each 8-column slice) with bounds checks, in pairs where N is even; the
//    requant is the reference's jnp.round(f32(acc) * m): __int2float_rn
//    (|acc| passes 2^24 for K >= 1024), __fmul_rn (no FMA contraction),
//    rintf (half to even), then the int8 clamp.
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPointByVersion (CUDA 12.5+), so the
// library needs no -lcuda.
// Left for later: persistent tiles (352 blocks at the width above run in
// 2.7 waves of 132), a TMA-store epilogue, clusters with multicast.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- the pre-pass: w (K, N) -> w_t (N, Kp) ---------------------------------

constexpr int kPackK = 64, kPackN = 128, kPackThreads = 256;
constexpr int kPackPitch = kPackN + 4;  // shared row pitch in bytes (a word apart)

__device__ __forceinline__ unsigned load_word(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__global__ void __launch_bounds__(kPackThreads)
pack_k_major_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ w_t, int k, int n,
                    int kp, int vec_ok) {
  __shared__ __align__(16) int8_t tile[kPackK * kPackPitch];  // tile[k][n]
  const int tid = threadIdx.x;
  const int k0 = blockIdx.y * kPackK, n0 = blockIdx.x * kPackN;

  if (vec_ok && n0 + kPackN <= n) {  // a row of the tile is one warp's 32 words
    for (int i = tid; i < kPackK * kPackN / 4; i += kPackThreads) {
      const int r = i / (kPackN / 4), c = (i % (kPackN / 4)) * 4;
      const unsigned v =
          k0 + r < k ? load_word(w + static_cast<size_t>(k0 + r) * n + n0 + c) : 0u;
      *reinterpret_cast<unsigned*>(tile + r * kPackPitch + c) = v;
    }
  } else {  // ragged N, or an unaligned w: bytes, zeros outside
    for (int i = tid; i < kPackK * kPackN; i += kPackThreads) {
      const int r = i / kPackN, c = i % kPackN;
      tile[r * kPackPitch + c] = (k0 + r < k && n0 + c < n)
                                     ? w[static_cast<size_t>(k0 + r) * n + n0 + c]
                                     : int8_t(0);
    }
  }
  __syncthreads();

  // 4 (k) x 4 (n) byte blocks transposed in registers; a warp's stores are
  // two rows of w_t, 64 contiguous bytes each
  for (int b = tid; b < (kPackK / 4) * (kPackN / 4); b += kPackThreads) {
    const int kq = b % (kPackK / 4), nq = b / (kPackK / 4);
    const int kk = k0 + kq * 4;
    if (kk >= kp) continue;
    const int8_t* src = tile + (kq * 4) * kPackPitch + nq * 4;
    const unsigned r0 = load_word(src), r1 = load_word(src + kPackPitch);
    const unsigned r2 = load_word(src + 2 * kPackPitch), r3 = load_word(src + 3 * kPackPitch);
    const unsigned lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
    const unsigned lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
    const unsigned col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + nq * 4 + j;
      if (nn < n) *reinterpret_cast<unsigned*>(w_t + static_cast<size_t>(nn) * kp + kk) = col[j];
    }
  }
}

// ---- the body: TMA ring -> int8 wgmma ---------------------------------------

constexpr int kConsumers = 2;               // consumer warpgroups, 64 rows each
constexpr int kStages = 4;
constexpr int kBM = 64 * kConsumers, kBN = 256, kBK = 128;  // kBK in bytes of k
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kATile = kBM * kBK, kBTile = kBN * kBK, kStageBytes = kATile + kBTile;
// the ring, 1024 bytes of slack to align it for the 128-byte swizzle, and
// the full and empty barriers
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the phase of ``parity`` has completed.  A wait past ~10 s at
// the card's clock traps: a fault in the ring shows as an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > 20'000'000'000LL) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

#define ACC8(i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),     \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256, int32) += A (64 x 32, s8, K-major) @ B (32 x 256, s8, K-major)
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef ACC8

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma's issue and completion.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <bool kRequant>
__device__ __forceinline__ void store_pair(void* out, int row, int col, int n, bool pairs,
                                           int v0, int v1, float mlt) {
  const size_t o = static_cast<size_t>(row) * n + col;
  if constexpr (kRequant) {
    const auto rq = [mlt](int v) {
      const float y = rintf(__fmul_rn(__int2float_rn(v), mlt));
      return static_cast<signed char>(fminf(fmaxf(y, -128.f), 127.f));
    };
    signed char* p = static_cast<signed char*>(out) + o;
    if (pairs && col + 1 < n) {
      *reinterpret_cast<char2*>(p) = make_char2(rq(v0), rq(v1));
    } else {
      if (col < n) p[0] = rq(v0);
      if (col + 1 < n) p[1] = rq(v1);
    }
  } else {
    int* p = static_cast<int*>(out) + o;
    if (pairs && col + 1 < n) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      if (col < n) p[0] = v0;
      if (col + 1 < n) p[1] = v1;
    }
  }
}

template <bool kRequant>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
            const float* __restrict__ mult, void* __restrict__ out, int m, int n, int kp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~uint32_t{1023};
  const uint32_t full = ring + kStages * kStageBytes, empty = full + kStages * 8;
  const int wg = threadIdx.x / 128;  // 0: the producer
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (kp + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        const uint32_t a = ring + s * kStageBytes, bar = full + 8 * s;
        mbar_expect_tx(bar, kStageBytes);
        tma_load_2d(a, &tm_x, kt * kBK, m0, bar);
        tma_load_2d(a + kATile, &tm_w, kt * kBK, n0, bar);
      }
    }
    return;
  }

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  fence_acc(acc);
  const uint32_t a_rows = ring + (wg - 1) * 64 * kBK;  // this warpgroup's 64 rows
  const bool lead = threadIdx.x % 128 == 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    const uint64_t da = smem_desc(a_rows + s * kStageBytes);
    const uint64_t db = smem_desc(ring + s * kStageBytes + kATile);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kBK / 32; ++j) wgmma_m64n256k32(acc, da + 2 * j, db + 2 * j);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's group is done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0 && lead) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row0 = m0 + (wg - 1) * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
  const bool pairs = n % 2 == 0;
  const float mlt = kRequant ? *mult : 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < m)
        store_pair<kRequant>(out, row, col0 + 8 * j, n, pairs, acc[4 * j + 2 * h],
                             acc[4 * j + 2 * h + 1], mlt);
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kNoEntryPoint = -1;
constexpr int kEncodeFailed = -1000;  // minus the CUresult

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, kp) int8 row-major matrix read as (box_rows, kBK) tiles in the
// 128-byte swizzle; out-of-bounds elements are read as zeros.
int encode_map(CUtensorMap* map, const void* base, int rows, int kp, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - static_cast<int>(r);
}

template <bool kRequant>
int launch_gemm(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const float* mult, void* out,
                int m, int n, int kp, cudaStream_t stream) {
  static bool raised = false;  // once per instantiation, never inside a capture
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<kRequant>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<kRequant><<<grid, kThreads, kSmem, stream>>>(tm_x, tm_w, mult, out, m, n, kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The pre-pass: w (k, n) row-major -> w_t (n, kp), zeros in columns k..kp.
// ``vec_ok`` says that n is a multiple of 4 and w 4-byte aligned.  Returns
// the cudaError_t of the launch (0 = cudaSuccess).
int int8_pack_k_major_launch(const void* w, void* w_t, int k, int n, int kp, int vec_ok,
                             void* stream) {
  const dim3 grid((n + kPackN - 1) / kPackN, (kp + kPackK - 1) / kPackK);
  pack_k_major_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(w_t), k, n, kp, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// The body: out (m, n) = x (m, kp) @ w_t (n, kp)^T, both K-major with
// 16-byte aligned bases and kp a multiple of 16.  ``mult`` is a device f32
// scalar, or null for the int32 output.  Returns 0, a cudaError_t, or a
// negative code for a tensor map that could not be encoded.
int int8_matmul_kmajor_launch(const void* x, const void* w_t, const void* mult, void* out,
                              int m, int n, int kp, void* stream) {
  CUtensorMap tm_x, tm_w;
  int err = encode_map(&tm_x, x, m, kp, kBM);
  if (err == 0) err = encode_map(&tm_w, w_t, n, kp, kBN);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mp = static_cast<const float*>(mult);
  return mult != nullptr ? launch_gemm<true>(tm_x, tm_w, mp, out, m, n, kp, s)
                         : launch_gemm<false>(tm_x, tm_w, mp, out, m, n, kp, s);
}

const char* int8_matmul_error_string(int code) {
  if (code == kNoEntryPoint) return "cuTensorMapEncodeTiled: no driver entry point";
  if (code <= kEncodeFailed) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
