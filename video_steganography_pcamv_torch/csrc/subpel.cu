// Kernel B3: subpel=2 refinement per partition unit (Hopper, sm_90a).
//
// Replaces the TPU kernel subpel_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:301, body
// _subpel_kernel). For every 8x8 block and each of the 49 qpel offsets
// (oy, ox) in [-3, 3]^2 around its full-pel MV (oy outer, ox inner):
//   satd  = sum over the 4 sub-blocks of (sum |WHT(cur) - wht8[o]|) >> 1
//   cost  = satd summed over the block's partition unit (16x16: all four
//           blocks; 16x8: pairs (0,1),(2,3); 8x16: pairs (0,2),(1,3);
//           8x8: the block alone) + lam * (bits(se(dx)) + bits(se(dy))),
//           dx = clamp(4*mvx + ox - pred_x, -2048, 2048), likewise dy,
//           pred the MB's qpel predictor;
// and keeps the FIRST strict-< minimum. Outputs r_idx8 (the table index
// (oy+6)*13 + (ox+6)) and mv8 = 4*mv + (ox, oy), N8 in spatial order.
// The TPU's bf16 MXU WHT is integer adds here and its lane rolls for the
// partition coupling are a shared-memory exchange.
//
// Design: one thread block per MB, one warp per 8x8 block (z-order
// b = 2*by + bx). Each lane owns two of the 64 WHT coefficients: it
// computes them for the current block once, then for every offset reads
// its 4-byte pair of the table row (128 contiguous bytes per warp),
// reduces |diff| over the 8 lanes of a sub-block, shifts, and reduces
// over the 4 sub-blocks. The 4x49 SATDs meet in shared memory, where
// lanes 0-3 of warp 0 run the per-block argmin. What bounds it: its
// reads of the table rows, 49*128 B per 8x8 (205 MB a 1080p frame,
// ~0.06 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsets = 49;

__device__ __forceinline__ int h4(int v, int k) {
  // hadamard4x4 row map: [[1,1,1,1],[1,1,-1,-1],[1,-1,-1,1],[1,-1,1,-1]]
  const int m = (v == 0) ? 0x0 : (v == 1) ? 0xC : (v == 2) ? 0x6 : 0xA;
  return ((m >> k) & 1) ? -1 : 1;
}

// bits(se(v)) = 2 * floor(log2(ue(v) + 1)) + 1 (me.mv_bits_table)
__device__ __forceinline__ int se_bits(int v) {
  const int ue = v <= 0 ? -2 * v : 2 * v - 1;
  return 2 * (31 - __clz(ue + 1)) + 1;
}

__global__ void __launch_bounds__(128)
subpel_kernel(const int* __restrict__ cur, const int16_t* __restrict__ wht8,
              const int* __restrict__ part, const int* __restrict__ mvf,
              const int* __restrict__ pred, int lam, int mbh, int mbw,
              int* __restrict__ mv8, int* __restrict__ r_idx8) {
  __shared__ int s_cur[4][64];
  __shared__ int s_sat[4][kOffsets];
  const int mb = blockIdx.x;
  const int my = mb / mbw, mx = mb - my * mbw;
  const int b = threadIdx.x >> 5;           // z-order block of the MB
  const int lane = threadIdx.x & 31;
  const int by = b >> 1, bx = b & 1;
  const int w8 = 2 * mbw;
  const int n8 = 4 * mbh * mbw;
  const int nb = (2 * my + by) * w8 + 2 * mx + bx;   // spatial index

  const int cur_w = 16 * mbw;
  for (int p = lane; p < 64; p += 32)
    s_cur[b][p] = cur[(16 * my + 8 * by + (p >> 3)) * cur_w + 16 * mx +
                      8 * bx + (p & 7)];
  __syncwarp();

  // this lane's two coefficients, wht8_flat index c = s*16 + 4*vr + vc
  int wc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 2 * lane + h;
    const int s = c >> 4, vr = (c >> 2) & 3, vc = c & 3;
    const int oy = 4 * (s >> 1), ox = 4 * (s & 1);
    int acc = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc += h4(vr, r) * h4(vc, q) * s_cur[b][(oy + r) * 8 + ox + q];
    wc[h] = acc;
  }

  for (int k = 0; k < kOffsets; ++k) {
    const int oy = k / 7 - 3, ox = k % 7 - 3;
    const int o = (oy + 6) * 13 + (ox + 6);
    const uint32_t pair = reinterpret_cast<const uint32_t*>(
        wht8 + ((size_t)o * n8 + nb) * 64)[lane];
    const int w0 = (int16_t)(pair & 0xffffu);
    const int w1 = (int16_t)(pair >> 16);
    int d = abs(wc[0] - w0) + abs(wc[1] - w1);
    // the 16 coefficients of sub-block s sit in lanes 8s .. 8s+7
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    d >>= 1;
    d += __shfl_xor_sync(0xffffffffu, d, 8);
    d += __shfl_xor_sync(0xffffffffu, d, 16);
    if (lane == 0) s_sat[b][k] = d;
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
  }
}

}  // namespace

extern "C" int pcamv_subpel(const void* cur, const void* wht8,
                            const void* part, const void* mvf,
                            const void* pred, int lam, int mbh, int mbw,
                            void* mv8, void* r_idx8, void* stream) {
  subpel_kernel<<<mbh * mbw, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), static_cast<const int16_t*>(wht8),
      static_cast<const int*>(part), static_cast<const int*>(mvf),
      static_cast<const int*>(pred), lam, mbh, mbw, static_cast<int*>(mv8),
      static_cast<int*>(r_idx8));
  return static_cast<int>(cudaGetLastError());
}
