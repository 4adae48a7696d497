// int8 tensor-core pieces shared by the prefill (splitmax_attn.cu) and the
// verify (splitmax_verify.cu): mma.sync.m16n8k32 for QK^T (s8 x s8) and for
// the byte-split e . V (u8 x s8), and the two layout moves that let the QK^T
// C fragment serve as the e . V A fragment in place.
//
// A score C fragment (m16n8, one n8 tile of keys) gives thread (g, tig) the
// keys 2*tig, 2*tig + 1 of rows g and g + 8.  Four such tiles (32 keys) fill
// one k32 A fragment if the contraction runs in a permuted key order: A
// position 4*tig + j holds key 2*tig + j (j < 2) or 8 + 2*tig + j - 2, and
// the same again 16 keys on.  The order inside a contraction is free, so
// V^T is written to shared memory in that order (transpose_v_quad) and the
// scores are only packed into bytes (pack_e_frags): no shuffle and no shared
// round trip of the scores.
#pragma once

#include <stdint.h>

namespace splitmax {

__device__ __forceinline__ void mma_s8s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], const unsigned (&a)[4], int b0,
                                         int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack4(int x0, int x1, int x2, int x3) {
  return static_cast<unsigned>(x0) | (static_cast<unsigned>(x1) << 8) |
         (static_cast<unsigned>(x2) << 16) | (static_cast<unsigned>(x3) << 24);
}

// The e . V A fragments of one k32 step from the four score tiles c0..c3
// (keys 0-7, 8-15, 16-23, 24-31 of the step), each e in [0, 2^15] split into
// bytes: e = 256 * hi + lo.
__device__ __forceinline__ void pack_e_frags(const int* c0, const int* c1, const int* c2,
                                             const int* c3, unsigned (&a_lo)[4],
                                             unsigned (&a_hi)[4]) {
  a_lo[0] = pack4(c0[0] & 255, c0[1] & 255, c1[0] & 255, c1[1] & 255);
  a_lo[1] = pack4(c0[2] & 255, c0[3] & 255, c1[2] & 255, c1[3] & 255);
  a_lo[2] = pack4(c2[0] & 255, c2[1] & 255, c3[0] & 255, c3[1] & 255);
  a_lo[3] = pack4(c2[2] & 255, c2[3] & 255, c3[2] & 255, c3[3] & 255);
  a_hi[0] = pack4(c0[0] >> 8, c0[1] >> 8, c1[0] >> 8, c1[1] >> 8);
  a_hi[1] = pack4(c0[2] >> 8, c0[3] >> 8, c1[2] >> 8, c1[3] >> 8);
  a_hi[2] = pack4(c2[0] >> 8, c2[1] >> 8, c3[0] >> 8, c3[1] >> 8);
  a_hi[3] = pack4(c2[2] >> 8, c2[3] >> 8, c3[2] >> 8, c3[3] >> 8);
}

// One 4 x 4 byte block of V^T in the score fragments' key order: ``src``
// points at column 4*dq of key row key0 = 16*half + 2*tq of V (row pitch
// ``src_pitch``), ``dst`` at key position 16*half + 4*tq of V^T row 4*dq
// (row pitch ``dst_pitch``).  Rows key0, key0 + 1, key0 + 8, key0 + 9 go to
// four consecutive positions of four V^T rows (a __byte_perm transpose).
__device__ __forceinline__ void transpose_v_quad(const int8_t* src, int src_pitch,
                                                 int8_t* dst, int dst_pitch) {
  const unsigned x0 = *reinterpret_cast<const unsigned*>(src);
  const unsigned x1 = *reinterpret_cast<const unsigned*>(src + src_pitch);
  const unsigned x2 = *reinterpret_cast<const unsigned*>(src + 8 * src_pitch);
  const unsigned x3 = *reinterpret_cast<const unsigned*>(src + 9 * src_pitch);
  const unsigned lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
  const unsigned lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
  *reinterpret_cast<unsigned*>(dst) = __byte_perm(lo01, lo23, 0x5410);
  *reinterpret_cast<unsigned*>(dst + dst_pitch) = __byte_perm(lo01, lo23, 0x7632);
  *reinterpret_cast<unsigned*>(dst + 2 * dst_pitch) = __byte_perm(hi01, hi23, 0x5410);
  *reinterpret_cast<unsigned*>(dst + 3 * dst_pitch) = __byte_perm(hi01, hi23, 0x7632);
}

}  // namespace splitmax
