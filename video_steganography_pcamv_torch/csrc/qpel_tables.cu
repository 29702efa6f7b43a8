// Kernel B2: the per-8x8 qpel block and WHT tables (Hopper, sm_90a).
//
// Replaces the TPU kernel qpel_tables_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:221, body
// _tables_kernel). For every 8x8 block and every qpel offset (oy, ox) in
// [-6, 6]^2 (table index o = (oy+6)*13 + (ox+6)) it writes
//   blocks8[o][n] = (a + b + 1) >> 1 of the two hpel phase-plane slices
//                   that qpel_table._phase_slices names, and
//   wht8[o][n]    = the 4x4 Walsh-Hadamard transform of each of its four
//                   4x4 sub-blocks, in wht8_flat order s*16 + 4*vr + vc.
// Layout: windows [N8][4][16][16] u8, blocks8 [169][N8][64] u8, wht8
// [169][N8][64] i16, N8 in spatial order (the TPU's z-order lanes and
// 128-lane padding are dropped). The TPU's bf16 MXU matmul for the WHT
// is a 4x4 integer butterfly in registers here; |coef| <= 16*255 fits
// int16.
//
// Design: one thread block per four consecutive 8x8 blocks; their four
// windows (4 KB) are staged in shared memory with one 16-byte load per
// thread. Threads stride over the (offset, block, sub-block) items,
// 169*4*4 = 2704 per thread block, sub-block fastest, so a warp writes
// 256 contiguous bytes of a blocks8 row and 512 of a wht8 row. What
// bounds it: its writes, 169*64*3 B per 8x8 (1.06 GB a 1080p frame,
// ~0.32 ms at 3.35 TB/s); the reads are 1 KB per 8x8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 4;          // 8x8 blocks per thread block
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

// hadamard4x4's butterfly: [s01+s23, s01-s23, d01-d23, d01+d23]
__device__ __forceinline__ void wht_bf(int& v0, int& v1, int& v2, int& v3) {
  const int s01 = v0 + v1, d01 = v0 - v1, s23 = v2 + v3, d23 = v2 - v3;
  v0 = s01 + s23;
  v1 = s01 - s23;
  v2 = d01 - d23;
  v3 = d01 + d23;
}

__global__ void __launch_bounds__(kThreads)
qpel_tables_kernel(const uint8_t* __restrict__ windows, int n8,
                   uint8_t* __restrict__ blocks8,
                   int16_t* __restrict__ wht8) {
  __shared__ __align__(16) uint8_t s_win[kBlocks * 1024];
  const int n0 = blockIdx.x * kBlocks;
  const int tid = threadIdx.x;
  reinterpret_cast<uint4*>(s_win)[tid] =
      reinterpret_cast<const uint4*>(windows + (size_t)n0 * 1024)[tid];
  __syncthreads();

  for (int item = tid; item < 169 * kBlocks * 4; item += kThreads) {
    const int s = item & 3;                 // 4x4 sub-block
    const int j = (item >> 2) & 3;          // block within the group
    const int o = item >> 4;                // table index
    const int oy = o / 13 - 6, ox = o % 13 - 6;
    int p1, y1, x1, p2, y2, x2;
    phase_slices(oy, ox, p1, y1, x1, p2, y2, x2);
    const int ry = 4 * (s >> 1), rx = 4 * (s & 1);
    const uint8_t* w = s_win + j * 1024;
    const uint8_t* a = w + p1 * 256 + (y1 + ry) * 16 + x1 + rx;
    const uint8_t* b = w + p2 * 256 + (y2 + ry) * 16 + x2 + rx;
    int px[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        px[r][c] = (a[r * 16 + c] + b[r * 16 + c] + 1) >> 1;

    const size_t row = (size_t)o * n8 + n0 + j;
    uint8_t* bo = blocks8 + row * 64 + ry * 8 + rx;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t v = (uint32_t)px[r][0] | ((uint32_t)px[r][1] << 8) |
                         ((uint32_t)px[r][2] << 16) |
                         ((uint32_t)px[r][3] << 24);
      *reinterpret_cast<uint32_t*>(bo + r * 8) = v;
    }

    // rows (along c), then columns (along r): out[vr][vc]
#pragma unroll
    for (int r = 0; r < 4; ++r) wht_bf(px[r][0], px[r][1], px[r][2], px[r][3]);
#pragma unroll
    for (int c = 0; c < 4; ++c) wht_bf(px[0][c], px[1][c], px[2][c], px[3][c]);
    __align__(16) int16_t co[16];
#pragma unroll
    for (int vr = 0; vr < 4; ++vr)
#pragma unroll
      for (int vc = 0; vc < 4; ++vc) co[4 * vr + vc] = (int16_t)px[vr][vc];
    uint4* wo = reinterpret_cast<uint4*>(wht8 + row * 64 + s * 16);
    wo[0] = reinterpret_cast<const uint4*>(co)[0];
    wo[1] = reinterpret_cast<const uint4*>(co)[1];
  }
}

}  // namespace

extern "C" int pcamv_qpel_tables(const void* windows, int n8, void* blocks8,
                                 void* wht8, void* stream) {
  qpel_tables_kernel<<<n8 / kBlocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(windows), n8,
      static_cast<uint8_t*>(blocks8), static_cast<int16_t*>(wht8));
  return static_cast<int>(cudaGetLastError());
}
