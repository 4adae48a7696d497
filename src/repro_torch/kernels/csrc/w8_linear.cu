// The int8-weight linear of a decode step, dequantized in registers:
//   out (M, N) bf16 = x (M, K) bf16 @ bf16(f32(w_q) * w_s),   w_q (K, N) int8,
// summed in f32 on the tensor cores, M <= 64 rows.
//
// Replaces: no TPU kernel.  The reference left the dequant-then-matmul to
// XLA (repro/models/layers.py: w_q.astype(dtype) * w_s, then x @ w); the
// port did the same as two passes on the card (models/layers.py::
// linear_weight's torch.mul into a bf16 weight, then cuBLAS), which reads
// the int8 payload, writes it out as bf16 and reads the bf16 again: about
// five bytes of traffic a parameter where one will do.
//
// What bounds it on an H100: at 16 rows a weight byte carries 32 FLOPs,
// an order below bf16's ridge (~295), so the int8 payload at 3.35 TB/s is
// the least time: 67.1 MB (8192 x 8192) in 20.0 us, a DeepSeek-67B decode
// step's 65.7 GB of layer weights in 19.6 ms.  The design reads each int8
// byte from HBM once and moves nothing else of size:
//  * each warp streams its own k16 slices (16 rows of w_q x the block's
//    columns, and the 16 columns of x) with 16-byte cp.async loads into a
//    private ring of kStages slots, so up to three slices a warp are in
//    flight and no block barrier sits in the loop; rows of w_q are read
//    whole (coalesced, marked evict-first in L2), stored in shared memory
//    under an XOR swizzle of 16-byte chunks so that the fragment reads
//    below are conflict-free;
//  * where a slice lands, each thread takes 4 k rows x CW columns of bytes
//    and dequantizes them in registers, exactly as linear_weight does:
//    the byte (biased by 0x80) permuted into the mantissa of 2^23, minus
//    2^23 + 128 gives f32(q) exactly; times the f32 scale (__fmul_rn, one
//    rounding); cvt.rn.bf16x2.f32 rounds to nearest even, two at a time.
//    These are the bits torch.mul(w_q, w_s, out=bf16) writes;
//  * the bf16 weight fragments are the A operand of mma.sync m16n8k16
//    (16 output columns on the m side), the tokens the n side (8 a tile):
//    the operand swap that keeps 1-8 tokens from wasting a 16-row tile.
//    Within a slice, thread t's four k slots {2t, 2t+1, 2t+8, 2t+9} are
//    the rows 4t..4t+3 in both operands (a permutation of the sum's terms
//    that the fragment layout makes free);
//  * the columns a block owns follow the rows: 128 at <= 16 rows, 64 at
//    <= 32, 32 at <= 64, so that a thread keeps 64 f32 sums or fewer.
// Determinism and batch invariance: where each k16 slice is summed depends
// on (K, N) alone.  The wrapper's split of K over blocks (split_rows)
// reads only K and N; within a block, slice q goes to warp q % 4, which
// sums its slices in order; the four warps' sums are added in warp order
// through shared memory, and the splits' f32 partials in split order by
// w8_linear_reduce_kernel.  No atomics; a row's bits do not depend on how
// many rows came with it, on the columns a block owns, or on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps, kStages = 4;
constexpr int kMaxRows = 64;

// NT token tiles of 8 rows; CW bytes (columns) of a w_q row a thread
// reads; BN = 8 CW columns a block; a warp's slot is its slice of w_q (16
// rows x BN bytes) then of x (MP rows x 16 bf16).
template <int NT>
struct Tile {
  static constexpr int CW = NT <= 2 ? 16 : 32 / NT;
  static constexpr int BN = 8 * CW, MP = 8 * NT;
  static constexpr int kWBytes = 16 * BN, kXBytes = MP * 32;
  static constexpr int kSlot = kWBytes + kXBytes, kRing = kStages * kSlot;
  static constexpr int kRedPitch = BN + 4;  // floats: a row of a warp's sums
  static constexpr int kRed = MP * kRedPitch * 4;
  static constexpr int kSmem = kWarps * (kRing > kRed ? kRing : kRed);
  static_assert(kSmem <= 48 * 1024, "dynamic shared memory past the default limit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing).
// ``policy`` is an L2 cache policy (createpolicy): w_q is read once, so
// its lines go first, and x and the partials, read again, stay.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid,
                                           uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset in a warp's w_q slice of 16-byte chunk c of row r: rows of
// BN bytes packed into 128-byte lines, each chunk's place in its line
// XORed with 2 * ((r >> 2) & 3).  A fragment read (rows 4t + i, chunk of
// column CW g) then meets every bank once per phase, for all three BN.
template <int BN>
__device__ __forceinline__ int swizzle(int r, int c) {
  const int lin = r * BN + 16 * c;
  return (lin & ~127) | ((((lin >> 4) & 7) ^ (((r >> 2) & 3) << 1)) << 4);
}

// f32(q) * s rounded to bf16, for q the byte of u (biased by 0x80) that
// the selector picks: 0x4B0000uu is 2^23 + u as an f32, exactly.
__device__ __forceinline__ float dequant(uint32_t u, uint32_t sel, float s) {
  const float big = __uint_as_float(__byte_perm(u, 0x4B000000u, sel));
  return __fmul_rn(__fsub_rn(big, 8388736.0f), s);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four f32 sums rounded to bf16 (to nearest even) and stored as 8 bytes.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  uint2 pk;
  pk.x = pack_bf16(v.x, v.y);
  pk.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = pk;
}

// CW bytes of shared memory into CW / 4 words.
template <int CW>
__device__ __forceinline__ void load_row(uint32_t (&w)[CW / 4], const uint8_t* p) {
  if constexpr (CW == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (CW == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Grid (ceil(N / BN), splits): block (x, y) owns columns [x BN, x BN + BN)
// and rows [y split_rows, (y + 1) split_rows) of K.  With one split it
// writes bf16 out; otherwise its f32 partial into part[y] (M x N).
template <int NT>
__global__ void __launch_bounds__(kThreads, 4)
w8_linear_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w_q,
                 const float* __restrict__ w_s, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part, int m, int k, int n, int split_rows) {
  using T = Tile<NT>;
  constexpr int CW = T::CW, BN = T::BN, MP = T::MP, JJ = CW / 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int q_lo = blockIdx.y * (split_rows / 16);
  const int q_hi = min(k, (blockIdx.y + 1) * split_rows) / 16;
  // this warp's slices: q_lo + warp, q_lo + warp + 4, ... (q_lo % 4 == 0)
  const int nq = q_hi - q_lo > warp ? (q_hi - q_lo - warp + kWarps - 1) / kWarps : 0;
  uint8_t* ring = smem + warp * T::kRing;
  const uint32_t ring_s = smem_u32(ring);
  const float s = __ldg(w_s);
  uint64_t evict_first, evict_normal;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(evict_normal));

  auto load = [&](int i) {  // the warp's i-th slice into slot i % kStages
    const int q = q_lo + warp + kWarps * i;
    const uint32_t slot = ring_s + (i % kStages) * T::kSlot;
    constexpr int kChunksW = BN, kPerRow = BN / 16;
#pragma unroll
    for (int id = lane; id < kChunksW; id += 32) {
      const int r = id / kPerRow, c = id % kPerRow;
      const bool ok = n0 + 16 * c < n;
      const int8_t* src = w_q + (static_cast<size_t>(16 * q + r) * n + (ok ? n0 + 16 * c : 0));
      cp_async16(slot + swizzle<BN>(r, c), src, ok, evict_first);
    }
#pragma unroll
    for (int id = lane; id < 2 * MP; id += 32) {
      const int row = id >> 1, h = id & 1;
      const bool ok = row < m;
      const __nv_bfloat16* src = x + (ok ? static_cast<size_t>(row) * k + 16 * q + 8 * h : 0);
      cp_async16(slot + T::kWBytes + 32 * row + 16 * h, src, ok, evict_normal);
    }
  };

  float acc[JJ][NT][4];
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nq) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < nq; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // every lane's copies of slice i landed; slot i - 1 is read
    if (i + kStages - 1 < nq) load(i + kStages - 1);
    cp_async_commit();

    const uint8_t* slot = ring + (i % kStages) * T::kSlot;
    uint32_t wv[4][CW / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = CW * g;
      load_row<CW>(wv[r], slot + swizzle<BN>(4 * t + r, col >> 4) + (col & 15));
    }
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(slot + T::kWBytes + 32 * (8 * j + g) + 8 * t);
      b[j][0] = v.x, b[j][1] = v.y;
    }
#pragma unroll
    for (int wd = 0; wd < CW / 4; ++wd) {
      uint32_t u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) u[r] = wv[r][wd] ^ 0x80808080u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // A tile jj: row g is column CW g + 2 jj (byte 2h of word wd), row
        // g + 8 the next column; k slots 2t, 2t+1 are rows 4t, 4t+1 and
        // slots 2t+8, 2t+9 rows 4t+2, 4t+3
        const uint32_t s0 = 0x7440u + 2 * h, s1 = s0 + 1;
        const uint32_t a0 = pack_bf16(dequant(u[0], s0, s), dequant(u[1], s0, s));
        const uint32_t a1 = pack_bf16(dequant(u[0], s1, s), dequant(u[1], s1, s));
        const uint32_t a2 = pack_bf16(dequant(u[2], s0, s), dequant(u[3], s0, s));
        const uint32_t a3 = pack_bf16(dequant(u[2], s1, s), dequant(u[3], s1, s));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[2 * wd + h][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the shared memory is the sums' now

  // warp w's sums, token-major: red[token][column]
  float* red = reinterpret_cast<float*>(smem) + warp * (T::kRed / 4);
#pragma unroll
  for (int jj = 0; jj < JJ; ++jj) {
    const int f0 = CW * g + 2 * jj;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int tok = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(red + tok * T::kRedPitch + f0) =
          make_float2(acc[jj][j][0], acc[jj][j][2]);
      *reinterpret_cast<float2*>(red + (tok + 1) * T::kRedPitch + f0) =
          make_float2(acc[jj][j][1], acc[jj][j][3]);
    }
  }
  __syncthreads();

  const float* red0 = reinterpret_cast<const float*>(smem);
  const bool whole = gridDim.y == 1;
  for (int e = 4 * threadIdx.x; e < MP * BN; e += 4 * kThreads) {
    const int tok = e / BN, col = e % BN;
    if (tok >= m || n0 + col >= n) continue;
    float4 v = *reinterpret_cast<const float4*>(red0 + tok * T::kRedPitch + col);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {  // warp order
      const float4 o = *reinterpret_cast<const float4*>(red0 + w * (T::kRed / 4) +
                                                        tok * T::kRedPitch + col);
      v.x = __fadd_rn(v.x, o.x), v.y = __fadd_rn(v.y, o.y);
      v.z = __fadd_rn(v.z, o.z), v.w = __fadd_rn(v.w, o.w);
    }
    const size_t o = static_cast<size_t>(tok) * n + n0 + col;
    if (whole) {
      store_bf16x4(out + o, v);
    } else {
      *reinterpret_cast<float4*>(part + static_cast<size_t>(blockIdx.y) * m * n + o) = v;
    }
  }
}

// out = bf16(part[0] + part[1] + ... + part[splits - 1]), in split order,
// four elements a thread (M N is a multiple of 16).
__global__ void __launch_bounds__(256)
w8_linear_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                        int mn, int splits) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int y = 1; y < splits; ++y) {
    const float4 o = *reinterpret_cast<const float4*>(part + static_cast<size_t>(y) * mn + i);
    v.x = __fadd_rn(v.x, o.x), v.y = __fadd_rn(v.y, o.y);
    v.z = __fadd_rn(v.z, o.z), v.w = __fadd_rn(v.w, o.w);
  }
  store_bf16x4(out + i, v);
}

template <int NT>
int launch(const void* x, const void* w_q, const void* w_s, void* out, void* part, int m,
           int k, int n, int split_rows, cudaStream_t stream) {
  using T = Tile<NT>;
  const int splits = (k + split_rows - 1) / split_rows;
  const dim3 grid((n + T::BN - 1) / T::BN, splits);
  w8_linear_kernel<NT><<<grid, kThreads, T::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(w_s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), m, k, n, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int mn = m * n, blocks = (mn / 4 + 255) / 256;
  w8_linear_reduce_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), mn, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (m, n) bf16 = x (m, k) bf16 @ bf16(f32(w_q (k, n) int8) * *w_s), for
// 1 <= m <= 64, k and n multiples of 16, every base 16-byte aligned,
// split_rows a multiple of 64.  ``part`` holds ceil(k / split_rows) f32
// (m, n) partials (unused, may be null, for one split).  Two launches
// with more than one split.  Returns 0 or the cudaError_t of a launch;
// -1 for a shape it does not take.
int w8_linear_launch(const void* x, const void* w_q, const void* w_s, void* out, void* part,
                     int m, int k, int n, int split_rows, void* stream) {
  if (m < 1 || m > kMaxRows || k < 16 || k % 16 || n < 16 || n % 16 || split_rows < 64 ||
      split_rows % 64)
    return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (m <= 8) return launch<1>(x, w_q, w_s, out, part, m, k, n, split_rows, st);
  if (m <= 16) return launch<2>(x, w_q, w_s, out, part, m, k, n, split_rows, st);
  if (m <= 32) return launch<4>(x, w_q, w_s, out, part, m, k, n, split_rows, st);
  return launch<8>(x, w_q, w_s, out, part, m, k, n, split_rows, st);
}

const char* w8_linear_error_string(int code) {
  if (code == -1) return "w8_linear_launch: a shape the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
