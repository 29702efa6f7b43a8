// Kernel B2's standalone entry: the per-8x8 qpel block and WHT tables
// (Hopper, sm_90a).
//
// Replaces the TPU kernel qpel_tables_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:221, body
// _tables_kernel) as a check entry: on the serving path its rows are
// built inside B3 (subpel.cu) and B4 (probe_maps.cu) from the same
// windows, with the device functions of qpel_rows.cuh, and these tables
// are never allocated. This kernel is a thin loop over those functions,
// so a fault in the shared row code shows up against the plain tables
// on its own. For every 8x8 block and every qpel offset (oy, ox) in
// [-6, 6]^2 (table index o = (oy+6)*13 + (ox+6)) it writes
//   blocks8[o][n] = the averaged row (qpel::avg4x4), and
//   wht8[o][n]    = the 4x4 WHT of each of its four 4x4 sub-blocks, in
//                   wht8_flat order s*16 + 4*vr + vc (qpel::wht4x4).
// Layout: windows [N8][4][16][16] u8, blocks8 [169][N8][64] u8, wht8
// [169][N8][64] i16, N8 in spatial order.
//
// Design: one thread block per four consecutive 8x8 blocks; their four
// windows (4 KB) are staged in shared memory with one 16-byte load per
// thread (qpel::stage16). Threads stride over the (offset, block,
// sub-block) items, 169*4*4 = 2704 per thread block, sub-block fastest,
// so a warp writes 256 contiguous bytes of a blocks8 row and 512 of a
// wht8 row. What bounds it: its writes, 169*64*3 B per 8x8 (1.06 GB a
// 1080p frame, ~0.32 ms at 3.35 TB/s); the reads are 1 KB per 8x8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qpel_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 4;          // 8x8 blocks per thread block

__global__ void __launch_bounds__(kThreads)
qpel_tables_kernel(const uint8_t* __restrict__ windows, int n8,
                   uint8_t* __restrict__ blocks8,
                   int16_t* __restrict__ wht8) {
  __shared__ __align__(16) uint8_t s_win[kBlocks * qpel::kWinStride];
  const int n0 = blockIdx.x * kBlocks;
  const int tid = threadIdx.x;
  qpel::stage16(s_win + (tid >> 6) * qpel::kWinStride,
                windows + (size_t)(n0 + (tid >> 6)) * 1024, tid & 63);
  __syncthreads();

  for (int item = tid; item < 169 * kBlocks * 4; item += kThreads) {
    const int s = item & 3;                 // 4x4 sub-block
    const int j = (item >> 2) & 3;          // block within the group
    const int o = item >> 4;                // table index
    const int oy = o / 13 - 6, ox = o % 13 - 6;
    int px[4][4];
    qpel::avg4x4(s_win + j * qpel::kWinStride, oy, ox, s, px);
    const int ry = 4 * (s >> 1), rx = 4 * (s & 1);

    const size_t row = (size_t)o * n8 + n0 + j;
    uint8_t* bo = blocks8 + row * 64 + ry * 8 + rx;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t v = (uint32_t)px[r][0] | ((uint32_t)px[r][1] << 8) |
                         ((uint32_t)px[r][2] << 16) |
                         ((uint32_t)px[r][3] << 24);
      *reinterpret_cast<uint32_t*>(bo + r * 8) = v;
    }

    qpel::wht4x4(px);
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
