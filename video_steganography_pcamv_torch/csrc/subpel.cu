// Kernel B3: subpel=2 refinement per partition unit, with B2 fused in
// (Hopper, sm_90a).
//
// Replaces the TPU kernel subpel_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:301, body
// _subpel_kernel), and builds the 49 rows of the TPU kernel
// qpel_tables_pallas (probe_pallas.py:221) that it reads itself, from the
// per-8x8 windows (qpel_rows.cuh). For every 8x8 block and each of the
// 49 qpel offsets (oy, ox) in [-3, 3]^2 around its full-pel MV (oy
// outer, ox inner):
//   satd  = sum over the 4 sub-blocks of (sum |WHT(cur) - WHT(row)|) >> 1,
//           row the (oy, ox) average of the block's window;
//   cost  = satd summed over the block's partition unit (16x16: all four
//           blocks; 16x8: pairs (0,1),(2,3); 8x16: pairs (0,2),(1,3);
//           8x8: the block alone) + lam * (bits(se(dx)) + bits(se(dy))),
//           dx = clamp(4*mvx + ox - pred_x, -2048, 2048), likewise dy,
//           pred the MB's qpel predictor;
// and keeps the FIRST strict-< minimum. Outputs r_idx8 (the table index
// (oy+6)*13 + (ox+6)) and mv8 = 4*mv + (ox, oy), N8 in spatial order,
// and, where mb_cost is not null (the stego-off analysis), each MB's
// inter cost: every unit's minimum cost counted once, at the unit's
// first 8x8 (the reference's subpel_parts, partition.py:354-362).
// The TPU's bf16 MXU WHT is integer adds here and its lane rolls for the
// partition coupling are a shared-memory exchange.
//
// Design: one thread block per MB, 128 threads. The MB's four 1 KB
// windows are staged in shared memory (two 16-byte loads a thread; the
// planes padded against bank conflicts) and the WHT of its 16 current
// 4x4 sub-blocks is computed once. Then the threads stride over the
// 4 x 4 x 49 (block, sub-block, offset) items: each averages its 4x4 of
// the row from the staged window (a word per row and slice, one
// per-byte average), transforms it in registers and writes its
// sub-block SATD to shared memory. The 4x49
// block SATDs are summed there, and threads 0-3 run the per-block
// argmin. What bounds it: the row building, ~250 int ops per item (~1.6
// G a 1080p frame, ~0.1 ms at the int32 rate), ahead of its reads of
// the windows (1 KB per 8x8, 33 MB a frame) and of cur.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qpel_rows.cuh"

namespace {

constexpr int kOffsets = 49;

// bits(se(v)) = 2 * floor(log2(ue(v) + 1)) + 1 (me.mv_bits_table)
__device__ __forceinline__ int se_bits(int v) {
  const int ue = v <= 0 ? -2 * v : 2 * v - 1;
  return 2 * (31 - __clz(ue + 1)) + 1;
}

__global__ void __launch_bounds__(128)
subpel_kernel(const int* __restrict__ cur, const uint8_t* __restrict__ windows,
              const int* __restrict__ part, const int* __restrict__ mvf,
              const int* __restrict__ pred, int lam, int mbh, int mbw,
              int* __restrict__ mv8, int* __restrict__ r_idx8,
              int* __restrict__ mb_cost) {
  __shared__ __align__(16) uint8_t s_win[4][qpel::kWinStride];
  __shared__ int s_wc[4][4][16];            // [block][sub-block][coef]
  __shared__ int s_sub[4][kOffsets][4];     // [block][offset][sub-block]
  __shared__ int s_sat[4][kOffsets];
  const int mb = blockIdx.x;
  const int my = mb / mbw, mx = mb - my * mbw;
  const int t = threadIdx.x;
  const int w8 = 2 * mbw;

  // the windows of the MB's z-order blocks; TL/TR and BL/BR are
  // neighbours in the spatial N8 order
  for (int i = t; i < 256; i += 128) {
    const int b = i >> 6;
    const int nb = (2 * my + (b >> 1)) * w8 + 2 * mx + (b & 1);
    qpel::stage16(s_win[b], windows + (size_t)nb * 1024, i & 63);
  }
  if (t < 16) {
    const int b = t >> 2, s = t & 3;
    const int* c0 = cur + (size_t)(16 * my + 8 * (b >> 1) + 4 * (s >> 1)) *
                              (16 * mbw) +
                    16 * mx + 8 * (b & 1) + 4 * (s & 1);
    int px[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) px[r][c] = c0[r * 16 * mbw + c];
    qpel::wht4x4(px);
#pragma unroll
    for (int i = 0; i < 16; ++i) s_wc[b][s][i] = px[i >> 2][i & 3];
  }
  __syncthreads();

  // offset fastest: a warp's lanes share (block, sub-block), so their
  // reads of cur's WHT are broadcasts
  for (int item = t; item < kOffsets * 16; item += 128) {
    const int bs = item / kOffsets, k = item - bs * kOffsets;
    const int b = bs >> 2, s = bs & 3;
    int px[4][4];
    qpel::avg4x4(s_win[b], k / 7 - 3, k % 7 - 3, s, px);
    qpel::wht4x4(px);
    int d = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) d += abs(s_wc[b][s][i] - px[i >> 2][i & 3]);
    s_sub[b][k][s] = d >> 1;
  }
  __syncthreads();
  for (int i = t; i < 4 * kOffsets; i += 128) {
    const int b = i / kOffsets, k = i - b * kOffsets;
    s_sat[b][k] = (s_sub[b][k][0] + s_sub[b][k][1]) +
                  (s_sub[b][k][2] + s_sub[b][k][3]);
  }
  __syncthreads();

  if (threadIdx.x < 4) {
    const int bb = threadIdx.x;
    const int bn = (2 * my + (bb >> 1)) * w8 + 2 * mx + (bb & 1);
    const int pt = part[mb];
    const int mvx = mvf[2 * bn], mvy = mvf[2 * bn + 1];
    const int prx = pred[2 * mb], pry = pred[2 * mb + 1];
    int best = 1 << 30, kbest = 0;
    for (int k = 0; k < kOffsets; ++k) {
      const int oy = k / 7 - 3, ox = k % 7 - 3;
      int sat;
      if (pt == 0)
        sat = (s_sat[0][k] + s_sat[1][k]) + (s_sat[2][k] + s_sat[3][k]);
      else if (pt == 1)
        sat = s_sat[bb][k] + s_sat[bb ^ 1][k];
      else if (pt == 2)
        sat = s_sat[bb][k] + s_sat[bb ^ 2][k];
      else
        sat = s_sat[bb][k];
      const int dx = min(max(4 * mvx + ox - prx, -2048), 2048);
      const int dy = min(max(4 * mvy + oy - pry, -2048), 2048);
      const int cost = sat + (se_bits(dx) + se_bits(dy)) * lam;
      if (cost < best) {
        best = cost;
        kbest = k;
      }
    }
    const int oy = kbest / 7 - 3, ox = kbest % 7 - 3;
    r_idx8[bn] = (oy + 6) * 13 + (ox + 6);
    mv8[2 * bn] = 4 * mvx + ox;
    mv8[2 * bn + 1] = 4 * mvy + oy;
    if (mb_cost != nullptr) {
      // a unit's first 8x8: 16x16 block 0, 16x8 blocks 0 and 2, 8x16
      // blocks 0 and 1, 8x8 every block; lanes 0-3 sum their shares
      const bool first = pt == 0 ? bb == 0
                       : pt == 1 ? (bb & 1) == 0
                       : pt == 2 ? bb < 2 : true;
      int c = first ? best : 0;
      c += __shfl_xor_sync(0xFu, c, 1);
      c += __shfl_xor_sync(0xFu, c, 2);
      if (bb == 0) mb_cost[mb] = c;
    }
  }
}

}  // namespace

extern "C" int pcamv_subpel(const void* cur, const void* windows,
                            const void* part, const void* mvf,
                            const void* pred, int lam, int mbh, int mbw,
                            void* mv8, void* r_idx8, void* mb_cost,
                            void* stream) {
  subpel_kernel<<<mbh * mbw, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur),
      static_cast<const uint8_t*>(windows),
      static_cast<const int*>(part), static_cast<const int*>(mvf),
      static_cast<const int*>(pred), lam, mbh, mbw, static_cast<int*>(mv8),
      static_cast<int*>(r_idx8), static_cast<int*>(mb_cost));
  return static_cast<int>(cudaGetLastError());
}
