// Kernel B4: the RCA probe SATD maps (Hopper, sm_90a).
//
// Replaces the TPU kernel probe_maps_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:481, body
// _probe_kernel). For every 8x8 block (chosen table index r = r_idx8[n])
// and each of the 13 probe versions v (the centre, then the 12 D_MV
// deltas; centre (cy, cx)), on each 4x4 sub-block:
//   pred  = blocks8[r + 13*cy + cx][n]
//   lev   = quant4x4(dct4x4(cur - pred)) (inter tables at qp)
//   score = x264 decimate score of lev in zigzag order (9 if |lev| > 1)
//   rec   = clip(pred + (idct4x4(dequant4x4(lev)) + 32) >> 6, 0, 255)
// then over the 9 D_NB neighbours (ny, nx) of the version, with
// row = wht8[r + 13*(cy+ny) + (cx+nx)][n]:
//   SK[v][k] = satd(WHT(rec), row),  SP[v][k] = satd(WHT(pred), row)
//   sc8[v]   = the four sub-blocks' scores summed
// (decimate off: SP = SK, sc8 = 0). Outputs SK/SP [13][9][n][4] and
// sc8 [13][n][4] int32 with the z-order block axis b = 2*by + bx.
//
// The TPU's constant bf16 matmuls (_m_dct_pix, _m_pix_to_pcf, _m_wht_*)
// are 4x4 integer butterflies in registers here, and its masked two-stage
// row selects (_mask_select, _stage2_select) are direct reads of the row
// r + offset. r lies in the +-3 subpel box, so every row is in
// [-6, 6]^2 (the plain version asserts it). Signed shifts are arithmetic
// int32 shifts, as in torch.
//
// Design: one thread block per MB, one thread per (block, version,
// 4x4 sub-block): 4*13*4 = 208 threads (7 warps, the last 16 lanes
// idle). The four threads of an 8x8 sit in adjacent lanes and combine
// their sums with two shuffles. Every thread reads 16 pred pixels and,
// per neighbour, its 32-byte slice of a WHT row (a 128-byte row per
// 8x8). What bounds it: its integer operations, ~1450 per (version,
// 4x4 sub-block), most of them the 18 SATDs against the lattice rows
// (~2.5 G a 1080p frame, ~0.15 ms at the int32 rate), ahead of its
// reads of the 45 distinct WHT rows (128 B) and 13 pred rows (64 B) of
// the probe lattice per 8x8 (~6.6 KB, ~215 MB a 1080p frame, ~0.07 ms
// at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVersions = 13;
constexpr int kThreads = 224;

// (dy, dx) of the versions: (0, 0), then stego.cost.D_MV as (dy, dx)
__constant__ int kCenter[kVersions][2] = {
    {0, 0}, {-1, 0}, {0, 1}, {1, 0}, {0, -1}, {1, -2}, {2, -1},
    {2, 1}, {1, 2}, {-1, 2}, {-2, 1}, {-2, -1}, {-1, -2}};
// (dy, dx) of stego.cost.D_NB
__constant__ int kNb[9][2] = {
    {-1, 0}, {0, 1}, {1, 0}, {0, -1}, {-1, -1}, {1, -1}, {-1, 1},
    {1, 1}, {0, 0}};
// zigzag scan k -> 4*r + c (transform.ZIGZAG_4x4)
__constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};

__device__ __forceinline__ void wht_bf(int& v0, int& v1, int& v2, int& v3) {
  const int s01 = v0 + v1, d01 = v0 - v1, s23 = v2 + v3, d23 = v2 - v3;
  v0 = s01 + s23;
  v1 = s01 - s23;
  v2 = d01 - d23;
  v3 = d01 + d23;
}

// transform._fwd_butterfly
__device__ __forceinline__ void dct_bf(int& x0, int& x1, int& x2, int& x3) {
  const int s03 = x0 + x3, s12 = x1 + x2, d03 = x0 - x3, d12 = x1 - x2;
  x0 = s03 + s12;
  x1 = 2 * d03 + d12;
  x2 = s03 - s12;
  x3 = d03 - 2 * d12;
}

// transform._inv_butterfly
__device__ __forceinline__ void idct_bf(int& x0, int& x1, int& x2, int& x3) {
  const int s02 = x0 + x2, d02 = x0 - x2;
  const int s13 = x1 + (x3 >> 1), d13 = (x1 >> 1) - x3;
  x0 = s02 + s13;
  x1 = d02 + d13;
  x2 = d02 - d13;
  x3 = s02 - s13;
}

__device__ __forceinline__ void wht4x4(int (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) wht_bf(a[r][0], a[r][1], a[r][2], a[r][3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) wht_bf(a[0][c], a[1][c], a[2][c], a[3][c]);
}

// (sum over the 16 coefficients of |w - row|) >> 1 for one sub-block
__device__ __forceinline__ int sub_satd(const int (&w)[4][4],
                                        const int16_t* row) {
  __align__(16) int16_t t[16];
  reinterpret_cast<uint4*>(t)[0] = reinterpret_cast<const uint4*>(row)[0];
  reinterpret_cast<uint4*>(t)[1] = reinterpret_cast<const uint4*>(row)[1];
  int d = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) d += abs(w[i >> 2][i & 3] - (int)t[i]);
  return d >> 1;
}

__device__ __forceinline__ int sum4(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__global__ void __launch_bounds__(kThreads)
probe_maps_kernel(const int* __restrict__ cur,
                  const uint8_t* __restrict__ blocks8,
                  const int16_t* __restrict__ wht8,
                  const int* __restrict__ r_idx8,
                  const int* __restrict__ qtab, int qbits, int decimate,
                  int mbh, int mbw, int* __restrict__ sk,
                  int* __restrict__ sp, int* __restrict__ sc8) {
  const int mb = blockIdx.x;
  const int my = mb / mbw, mx = mb - my * mbw;
  const int n = mbh * mbw;
  const int n8 = 4 * n;
  const int t = threadIdx.x;
  const int s = t & 3;                      // 4x4 sub-block of the 8x8
  const int q = t >> 2;
  const bool active = q < 4 * kVersions;
  const int b = active ? q / kVersions : 0; // z-order 8x8 of the MB
  const int v = active ? q % kVersions : 0;
  const int by = b >> 1, bx = b & 1;
  const int nb = (2 * my + by) * (2 * mbw) + 2 * mx + bx;
  const int ry = 4 * (s >> 1), rx = 4 * (s & 1);
  const int r0 = r_idx8[nb];
  const int cy = kCenter[v][0], cx = kCenter[v][1];

  // pred and residual of this sub-block
  const uint8_t* prow =
      blocks8 + ((size_t)(r0 + 13 * cy + cx) * n8 + nb) * 64 + ry * 8 + rx;
  const int* crow = cur + (size_t)(16 * my + 8 * by + ry) * (16 * mbw) +
                    16 * mx + 8 * bx + rx;
  int pred[4][4], c[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t pv = *reinterpret_cast<const uint32_t*>(prow + r * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pred[r][k] = (pv >> (8 * k)) & 0xff;
      c[r][k] = crow[r * 16 * mbw + k] - pred[r][k];
    }
  }
  // forward DCT: along c, then along r -> c[vr][vh]
#pragma unroll
  for (int r = 0; r < 4; ++r) dct_bf(c[r][0], c[r][1], c[r][2], c[r][3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) dct_bf(c[0][k], c[1][k], c[2][k], c[3][k]);
  // quant (inter), dequant
  int lev[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int x = c[i >> 2][i & 3];
    const int mag = ((qtab[16 + i] + abs(x)) * qtab[i]) >> 16;
    lev[i] = x > 0 ? mag : (x < 0 ? -mag : 0);
  }
  int score = 0;
  if (decimate) {
    int run = 0;
    bool big = false;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int a = abs(lev[kZigzag[k]]);
      big |= a > 1;
      if (a > 0) {
        score += (run < 1) + (run < 3) + (run < 6);
        run = 0;
      } else {
        ++run;
      }
    }
    if (big) score = 9;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = lev[i] * qtab[32 + i];
    c[i >> 2][i & 3] = qbits >= 0 ? (d << qbits)
                                  : ((d + (1 << (-qbits - 1))) >> -qbits);
  }
  // inverse DCT: along c, then along r; recon
#pragma unroll
  for (int r = 0; r < 4; ++r) idct_bf(c[r][0], c[r][1], c[r][2], c[r][3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) idct_bf(c[0][k], c[1][k], c[2][k], c[3][k]);
  int wk[4][4], wp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wk[r][k] = min(max(pred[r][k] + ((c[r][k] + 32) >> 6), 0), 255);
      wp[r][k] = pred[r][k];
    }
  wht4x4(wk);
  wht4x4(wp);

  const size_t plane = (size_t)n * 4;       // one [n][4] map
  const size_t cell = (size_t)mb * 4 + b;
  for (int k = 0; k < 9; ++k) {
    const int row = r0 + 13 * (cy + kNb[k][0]) + (cx + kNb[k][1]);
    const int16_t* wrow = wht8 + ((size_t)row * n8 + nb) * 64 + s * 16;
    const int skv = sum4(sub_satd(wk, wrow));
    const int spv = decimate ? sum4(sub_satd(wp, wrow)) : skv;
    if (active && s == 0) {
      sk[(v * 9 + k) * plane + cell] = skv;
      sp[(v * 9 + k) * plane + cell] = spv;
    }
  }
  score = sum4(score);
  if (active && s == 0) sc8[v * plane + cell] = score;
}

}  // namespace

extern "C" int pcamv_probe_maps(const void* cur, const void* blocks8,
                                const void* wht8, const void* r_idx8,
                                const void* qtab, int qbits, int decimate,
                                int mbh, int mbw, void* sk, void* sp,
                                void* sc8, void* stream) {
  probe_maps_kernel<<<mbh * mbw, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), static_cast<const uint8_t*>(blocks8),
      static_cast<const int16_t*>(wht8), static_cast<const int*>(r_idx8),
      static_cast<const int*>(qtab), qbits, decimate, mbh, mbw,
      static_cast<int*>(sk), static_cast<int*>(sp), static_cast<int*>(sc8));
  return static_cast<int>(cudaGetLastError());
}
