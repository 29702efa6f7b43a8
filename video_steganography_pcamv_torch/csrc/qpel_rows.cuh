// The qpel block rows of an 8x8 block, built from its 1 KB window, and
// the 4x4 transforms on the int8 tensor cores (Hopper, sm_90a): the
// device functions shared by the analyse tail (analyse_tail.cu: B3, B4)
// and B2's standalone entry (qpel_tables.cu), each of which includes
// this header (every .cu is compiled by its own nvcc).
//
// They are the body of the TPU kernel qpel_tables_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:221, body
// _tables_kernel). A window is [4][16][16] u8: the four hpel phase planes
// (0 = F, 1 = H, 2 = V, 3 = C) around the 8x8 block's full-pel MV, with
// the block's origin at (MARGIN, MARGIN). The row of qpel offset
// (oy, ox) in [-6, 6]^2 is the (a + b + 1) >> 1 average of the two
// phase-plane slices that qpel_table._phase_slices names; its WHT row is
// the 4x4 Walsh-Hadamard transform of each of its four 4x4 sub-blocks s
// (s = 2*(y >= 4) + (x >= 4)), coefficient order 4*vr + vc.

#pragma once

#include <stdint.h>

namespace qpel {

constexpr int kMargin = 4;          // qpel_table.MARGIN

// qpel_table._phase_slices: plane/row/col of the two averaged slices
__device__ __forceinline__ void phase_slices(int oy, int ox, int& p1,
                                             int& y1, int& x1, int& p2,
                                             int& y2, int& x2) {
  const int fx = ox & 3, fy = oy & 3;
  const int bx = (ox >> 2) + kMargin, by = (oy >> 2) + kMargin;
  if ((fx & 1) == 0 && (fy & 1) == 0) {
    p1 = p2 = (fx >> 1) + 2 * (fy >> 1);
    y1 = y2 = by;
    x1 = x2 = bx;
  } else if ((fx & 1) == 1 && (fy & 1) == 0) {
    p1 = 1 + 2 * (fy >> 1); y1 = by; x1 = bx;
    p2 = 2 * (fy >> 1); y2 = by; x2 = bx + (fx == 3 ? 1 : 0);
  } else if ((fx & 1) == 0) {
    p1 = (fx >> 1) + 2; y1 = by; x1 = bx;
    p2 = fx >> 1; y2 = by + (fy == 3 ? 1 : 0); x2 = bx;
  } else {
    p1 = 1; y1 = by + (fy == 3 ? 1 : 0); x1 = bx;
    p2 = 2; y2 = by; x2 = bx + (fx == 3 ? 1 : 0);
  }
}

// A window staged in shared memory: each 256-byte phase plane padded to
// kPlaneStride bytes, so that the same (row, col) of the four planes fall
// in different banks; of four windows side by side, windows 2 and 3 sit
// 8 bytes further (win_base), so that a tile's four blocks do too.
constexpr int kPlaneStride = 272;
constexpr int kWinStride = 4 * kPlaneStride;

__device__ __forceinline__ int win_base(int b) {
  return b * kWinStride + (b >> 1) * 8;
}

// Copy 16 bytes, chunk c in [0, 64), of a [4][16][16] window from device
// memory into its staged copy at s_win (8-byte aligned).
__device__ __forceinline__ void stage_chunk(uint8_t* s_win,
                                            const uint8_t* win, int c) {
  const uint4 v = reinterpret_cast<const uint4*>(win)[c];
  uint2* dst = reinterpret_cast<uint2*>(s_win + (c >> 4) * kPlaneStride +
                                        (c & 15) * 16);
  dst[0] = make_uint2(v.x, v.y);
  dst[1] = make_uint2(v.z, v.w);
}

// The staged-window byte offsets of the two slices of offset (oy, ox),
// packed a | b << 16.
__device__ __forceinline__ uint32_t phase_offsets(int oy, int ox) {
  int p1, y1, x1, p2, y2, x2;
  phase_slices(oy, ox, p1, y1, x1, p2, y2, x2);
  return (p1 * kPlaneStride + y1 * 16 + x1) |
         (p2 * kPlaneStride + y2 * 16 + x2) << 16;
}

// Four bytes of a 4-byte-aligned buffer from byte offset `off` on.
__device__ __forceinline__ uint32_t load4(const uint8_t* base, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  return __funnelshift_r(w[0], w[1], 8 * (off & 3));
}

// Four pixels of the row of offset ph (phase_offsets), from pixel
// (y, x) on, off = 16 * y + x, out of the staged window w: four bytes
// of each slice and one per-byte rounding average (__vavgu4 is
// (a + b + 1) >> 1 on each byte). This word is one pixel row of a 4x4,
// as the tensor cores' A fragment holds it.
__device__ __forceinline__ uint32_t row4(const uint8_t* w, uint32_t ph,
                                         int off) {
  return __vavgu4(load4(w, (ph & 0xffffu) + off), load4(w, (ph >> 16) + off));
}

// D = A x B on the int8 tensor cores: A [16 x 32] u8 (rows g and g+8 of
// the lane's group g, K 4t..4t+3 in a0/a1 and 16+4t.. in a2/a3), B
// [32 x 8] s8 (column g, K 4t.. in b0, 16+4t.. in b1), D [16 x 8] s32
// (d0/d1: row g, columns 2t, 2t+1; d2/d3: row g+8).
__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(0));
}

// The lane's B fragments of [M; -M] for a 16x16 map M (row j = output
// coefficient, column i = input pixel): n-tile 0 (j = g) in bm[0..1],
// n-tile 1 (j = 8 + g) in bm[2..3]. With A rows [x | y] the product is
// M x - M y = M (x - y).
__device__ __forceinline__ void kron_frag(const int8_t (&m)[16][16], int g,
                                          int tq, uint32_t (&bm)[4]) {
  bm[0] = *reinterpret_cast<const uint32_t*>(&m[g][4 * tq]);
  bm[1] = __vneg4(bm[0]);
  bm[2] = *reinterpret_cast<const uint32_t*>(&m[8 + g][4 * tq]);
  bm[3] = __vneg4(bm[2]);
}

}  // namespace qpel
