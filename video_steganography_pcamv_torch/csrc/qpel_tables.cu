// Kernel B2's standalone entry: the per-8x8 qpel block and WHT tables
// (Hopper, sm_90a).
//
// Replaces the TPU kernel qpel_tables_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:221, body
// _tables_kernel) as a check entry: on the serving path its rows are
// built inside the analyse tail (analyse_tail.cu) from the same windows,
// and transformed there on the tensor cores, with the device functions of
// qpel_rows.cuh, and these tables are never allocated. This kernel is a
// thin loop over those functions, so a fault in the shared row or
// transform code shows up against the plain tables on its own. For every
// 8x8 block and every qpel offset (oy, ox) in [-6, 6]^2 (table index
// o = (oy+6)*13 + (ox+6)) it writes
//   blocks8[o][n] = the averaged row (qpel::row4), and
//   wht8[o][n]    = the 4x4 WHT of each of its four 4x4 sub-blocks, in
//                   wht8_flat order s*16 + 4*vr + vc (qpel::mma with the
//                   kron WHT matrix, the y half of each A row zero).
// Layout: windows [N8][4][16][16] u8, blocks8 [169][N8][64] u8, wht8
// [169][N8][64] i16, N8 in spatial order.
//
// Design: one thread block per four consecutive 8x8 blocks, staged as the
// analyse tail stages an MB's (qpel::stage_chunk, qpel::win_base); a warp
// an offset at a time, its 16 tile rows the four blocks' 16 sub-blocks,
// as in the tail's tiles. What bounds it: its writes, 169*64*3 B per 8x8
// (1.06 GB a 1080p frame, ~0.32 ms at 3.35 TB/s); the reads are 1 KB per
// 8x8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qpel_rows.cuh"

namespace {

#include "tail_tables.inc"

constexpr int kThreads = 256;
constexpr int kBlocks = 4;          // 8x8 blocks per thread block

// two int16 coefficients in a word, lo first
__device__ __forceinline__ uint32_t pack(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         static_cast<uint32_t>(hi) << 16;
}

__global__ void __launch_bounds__(kThreads)
qpel_tables_kernel(const uint8_t* __restrict__ windows, int n8,
                   uint8_t* __restrict__ blocks8,
                   int16_t* __restrict__ wht8) {
  __shared__ __align__(16) uint8_t s_win[kBlocks * qpel::kWinStride + 16];
  __shared__ uint32_t s_ph[169];
  const int n0 = blockIdx.x * kBlocks;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  qpel::stage_chunk(s_win + qpel::win_base(t >> 6),
                    windows + (size_t)(n0 + (t >> 6)) * 1024, t & 63);
  for (int i = t; i < 169; i += kThreads)
    s_ph[i] = qpel::phase_offsets(i / 13 - 6, i % 13 - 6);
  // a tile lane: group g = its rows g, g+8: block bl = g >> 1, sub-block
  // sl (row g) and sl + 2 (row g+8); tq its pixel row / coefficient pair
  const int g = lane >> 2, tq = lane & 3;
  const int bl = g >> 1, sl = g & 1;
  uint32_t bw[4];
  qpel::kron_frag(kWhtKron, g, tq, bw);
  __syncthreads();

  const uint8_t* w = s_win + qpel::win_base(bl);
  const int off = 4 * sl + 16 * tq;
  for (int o = warp; o < 169; o += kThreads / 32) {
    const uint32_t x0 = qpel::row4(w, s_ph[o], off);
    const uint32_t x1 = qpel::row4(w, s_ph[o], off + 64);
    const size_t row = (size_t)o * n8 + n0 + bl;
    uint8_t* bo = blocks8 + row * 64 + tq * 8 + 4 * sl;
    *reinterpret_cast<uint32_t*>(bo) = x0;
    *reinterpret_cast<uint32_t*>(bo + 32) = x1;
    int c[4], e[4];
    qpel::mma(c, x0, x1, 0u, 0u, bw[0], bw[1]);
    qpel::mma(e, x0, x1, 0u, 0u, bw[2], bw[3]);
    // coefficients 2tq, 2tq + 1 (c) and 8 + 2tq, 9 + 2tq (e) of
    // sub-block sl (d0, d1) and sl + 2 (d2, d3)
    uint32_t* wo = reinterpret_cast<uint32_t*>(wht8 + row * 64);
    wo[8 * sl + tq] = pack(c[0], c[1]);
    wo[8 * sl + 4 + tq] = pack(e[0], e[1]);
    wo[8 * (sl + 2) + tq] = pack(c[2], c[3]);
    wo[8 * (sl + 2) + 4 + tq] = pack(e[2], e[3]);
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
