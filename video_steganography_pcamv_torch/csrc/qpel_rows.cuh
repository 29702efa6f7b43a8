// The qpel block rows of an 8x8 block, built from its 1 KB window
// (Hopper, sm_90a): the device functions shared by B3 (subpel.cu), B4
// (probe_maps.cu) and the standalone B2 entry (qpel_tables.cu), each of
// which includes this header (every .cu is compiled by its own nvcc).
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
// kPlaneStride bytes, so that the same (row, col) of the four planes,
// and of the windows of neighbouring blocks, fall in different banks.
constexpr int kPlaneStride = 272;
constexpr int kWinStride = 4 * kPlaneStride;

// Copy 16 bytes, chunk i in [0, 64), of a [4][16][16] window from device
// memory into its padded shared-memory copy.
__device__ __forceinline__ void stage16(uint8_t* s_win, const uint8_t* win,
                                        int i) {
  *reinterpret_cast<uint4*>(s_win + (i >> 4) * kPlaneStride +
                            (i & 15) * 16) =
      reinterpret_cast<const uint4*>(win)[i];
}

// Four bytes of a 4-byte-aligned buffer from byte offset `off` on.
__device__ __forceinline__ uint32_t load4(const uint8_t* base, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  return __funnelshift_r(w[0], w[1], 8 * (off & 3));
}

// The 4x4 sub-block s of the row of offset (oy, ox), from a staged
// window `w` (shared memory, kPlaneStride layout): px[r][c]. One row is
// four bytes of each slice and one per-byte rounding average
// (__vavgu4 is (a + b + 1) >> 1 on each byte).
__device__ __forceinline__ void avg4x4(const uint8_t* w, int oy, int ox,
                                       int s, int (&px)[4][4]) {
  int p1, y1, x1, p2, y2, x2;
  phase_slices(oy, ox, p1, y1, x1, p2, y2, x2);
  const int ry = 4 * (s >> 1), rx = 4 * (s & 1);
  const int a = p1 * kPlaneStride + (y1 + ry) * 16 + x1 + rx;
  const int b = p2 * kPlaneStride + (y2 + ry) * 16 + x2 + rx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t v = __vavgu4(load4(w, a + 16 * r), load4(w, b + 16 * r));
#pragma unroll
    for (int c = 0; c < 4; ++c) px[r][c] = (v >> (8 * c)) & 0xff;
  }
}

// hadamard4x4's butterfly: [s01+s23, s01-s23, d01-d23, d01+d23]
__device__ __forceinline__ void wht_bf(int& v0, int& v1, int& v2, int& v3) {
  const int s01 = v0 + v1, d01 = v0 - v1, s23 = v2 + v3, d23 = v2 - v3;
  v0 = s01 + s23;
  v1 = s01 - s23;
  v2 = d01 - d23;
  v3 = d01 + d23;
}

// In place: rows (along c), then columns (along r): a[vr][vc].
// |coef| <= 16 * 255, so a coefficient fits int16.
__device__ __forceinline__ void wht4x4(int (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) wht_bf(a[r][0], a[r][1], a[r][2], a[r][3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) wht_bf(a[0][c], a[1][c], a[2][c], a[3][c]);
}

}  // namespace qpel
