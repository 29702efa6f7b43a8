// Kernel B4: the RCA probe SATD maps, with B2 fused in (Hopper, sm_90a).
//
// Replaces the TPU kernel probe_maps_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:481, body
// _probe_kernel), and builds the rows of the TPU kernel
// qpel_tables_pallas (probe_pallas.py:221) that it reads itself, from the
// per-8x8 windows (qpel_rows.cuh). For every 8x8 block (chosen subpel
// offset r = (roy, rox) from r_idx8[n]) and each of the 13 probe
// versions v (the centre, then the 12 D_MV deltas; centre (cy, cx)), on
// each 4x4 sub-block:
//   pred  = the row of offset r + (cy, cx)
//   lev   = quant4x4(dct4x4(cur - pred)) (the encoder's inter tables at
//           qp, qtab: its CQM list and inter deadzone)
//   score = x264 decimate score of lev in zigzag order (9 if |lev| > 1)
//   rec   = clip(pred + (idct4x4(dequant4x4(lev)) + 32) >> 6, 0, 255)
// then over the 9 D_NB neighbours (ny, nx) of the version, with
// row = the WHT row of offset r + (cy+ny, cx+nx):
//   SK[v][k] = satd(WHT(rec), row),  SP[v][k] = satd(WHT(pred), row)
//   sc8[v]   = the four sub-blocks' scores summed
// (decimate off: SP = SK, sc8 = 0). Outputs SK/SP [13][9][n][4] and
// sc8 [13][n][4] int32 with the z-order block axis b = 2*by + bx.
//
// The TPU's constant bf16 matmuls (_m_dct_pix, _m_pix_to_pcf, _m_wht_*)
// are 4x4 integer butterflies in registers here, and its masked two-stage
// row selects (_mask_select, _stage2_select) are direct reads of the
// rows built in shared memory. r lies in the +-3 subpel box (the kernel
// traps otherwise; the plain version raises), so every row is in
// [-6, 6]^2. Signed shifts are arithmetic int32 shifts, as in torch.
//
// Design: one thread block per MB, 224 threads. The lattice deltas
// (cy+ny, cx+nx) fill the 7x7 box but its four corners: 45 WHT rows per
// 8x8. The block first stages the MB's four 1 KB windows in shared
// memory, then builds, per 8x8, the 45 WHT rows (int16) and the 13 pred
// rows (u8) around r there (6.6 KB per 8x8), one (8x8, 4x4 sub-block,
// delta) item per thread and step, delta fastest. Then one thread per (block,
// version, 4x4 sub-block), 4*13*4 = 208 threads (the last 16 lanes
// idle), runs the probe chain on its 16 pred pixels and reads its 32-byte
// slice of each neighbour's WHT row from shared memory. The four threads
// of an 8x8 sit in adjacent lanes and combine their sums with two
// shuffles. What bounds it: its integer operations, ~1450 per (version,
// 4x4 sub-block), most of them the 18 SATDs against the lattice rows,
// plus ~200 a (delta, 4x4 sub-block) to build the rows (~3.4 G a 1080p
// frame, ~0.2 ms at the int32 rate); it reads 1 KB of windows per 8x8
// (33 MB a frame) and cur.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qpel_rows.cuh"

namespace {

constexpr int kVersions = 13;
constexpr int kThreads = 224;
constexpr int kBox = 7;            // the lattice deltas' box, [-3, 3]^2
// a WHT row in shared memory: 64 int16 padded to 72, so that the
// 16-byte stores of 8 lanes building neighbouring rows hit 32 banks
constexpr int kRow = 72;

// (dy, dx) of the versions: (0, 0), then stego.cost.D_MV as (dy, dx)
__constant__ int kCenter[kVersions][2] = {
    {0, 0}, {-1, 0}, {0, 1}, {1, 0}, {0, -1}, {1, -2}, {2, -1},
    {2, 1}, {1, 2}, {-1, 2}, {-2, 1}, {-2, -1}, {-1, -2}};
// (dy, dx) of stego.cost.D_NB
__constant__ int kNb[9][2] = {
    {-1, 0}, {0, 1}, {1, 0}, {0, -1}, {-1, -1}, {1, -1}, {-1, 1},
    {1, 1}, {0, 0}};
// the version whose centre is lattice delta slot (dy+3)*7 + (dx+3), or -1
__constant__ int kSlotVersion[kBox * kBox] = {
    -1, -1, -1, -1, -1, -1, -1,
    -1, -1, 11, -1, 10, -1, -1,
    -1, 12, -1, 1, -1, 9, -1,
    -1, -1, 4, 0, 2, -1, -1,
    -1, 5, -1, 3, -1, 8, -1,
    -1, -1, 6, -1, 7, -1, -1,
    -1, -1, -1, -1, -1, -1, -1};
// zigzag scan k -> 4*r + c (transform.ZIGZAG_4x4)
__constant__ int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                9, 12, 13, 10, 7, 11, 14, 15};

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
                  const uint8_t* __restrict__ windows,
                  const int* __restrict__ r_idx8,
                  const int* __restrict__ qtab, int qbits, int decimate,
                  int mbh, int mbw, int* __restrict__ sk,
                  int* __restrict__ sp, int* __restrict__ sc8) {
  __shared__ __align__(16) uint8_t s_win[4][qpel::kWinStride];
  __shared__ __align__(16) int16_t s_wht[4][kBox * kBox][kRow];
  __shared__ __align__(16) uint8_t s_pred[4][kVersions][64];
  __shared__ int s_r[4][2];
  __shared__ int s_slot_version[kBox * kBox];
  const int mb = blockIdx.x;
  const int my = mb / mbw, mx = mb - my * mbw;
  const int n = mbh * mbw;
  const int t = threadIdx.x;
  const int w8 = 2 * mbw;

  // the windows and chosen offsets of the MB's z-order blocks
  for (int i = t; i < 256; i += kThreads) {
    const int b = i >> 6;
    const int nb = (2 * my + (b >> 1)) * w8 + 2 * mx + (b & 1);
    qpel::stage16(s_win[b], windows + (size_t)nb * 1024, i & 63);
  }
  if (t < kBox * kBox) s_slot_version[t] = kSlotVersion[t];
  if (t < 4) {
    const int r = r_idx8[(2 * my + (t >> 1)) * w8 + 2 * mx + (t & 1)];
    const int roy = r / 13 - 6, rox = r % 13 - 6;
    if (r < 0 || r > 168 || abs(roy) > 3 || abs(rox) > 3) __trap();
    s_r[t][0] = roy;
    s_r[t][1] = rox;
  }
  __syncthreads();

  // the rows around r: WHT rows for the 45 deltas, pred rows for the 13
  // version centres
  for (int item = t; item < 4 * kBox * kBox * 4; item += kThreads) {
    const int bs = item / (kBox * kBox), slot = item - bs * (kBox * kBox);
    const int b = bs >> 2, s = bs & 3;
    const int dy = slot / kBox - 3, dx = slot % kBox - 3;
    if (abs(dy) == 3 && abs(dx) == 3) continue;
    int px[4][4];
    qpel::avg4x4(s_win[b], s_r[b][0] + dy, s_r[b][1] + dx, s, px);
    const int ry = 4 * (s >> 1), rx = 4 * (s & 1);
    const int v = s_slot_version[slot];
    if (v >= 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_pred[b][v][(ry + r) * 8 + rx + c] = (uint8_t)px[r][c];
    }
    qpel::wht4x4(px);
    __align__(16) int16_t co[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) co[i] = (int16_t)px[i >> 2][i & 3];
    uint4* dst = reinterpret_cast<uint4*>(s_wht[b][slot] + s * 16);
    dst[0] = reinterpret_cast<const uint4*>(co)[0];
    dst[1] = reinterpret_cast<const uint4*>(co)[1];
  }
  __syncthreads();

  const int s = t & 3;                      // 4x4 sub-block of the 8x8
  const int q = t >> 2;
  const bool active = q < 4 * kVersions;
  const int b = active ? q / kVersions : 0; // z-order 8x8 of the MB
  const int v = active ? q % kVersions : 0;
  const int by = b >> 1, bx = b & 1;
  const int ry = 4 * (s >> 1), rx = 4 * (s & 1);
  const int cy = kCenter[v][0], cx = kCenter[v][1];

  // pred and residual of this sub-block
  const uint8_t* prow = s_pred[b][v] + ry * 8 + rx;
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
    // the products wrap as the reference's int32 ones (a custom list's
    // mf can reach ~70000 at low qp)
    const int mag =
        static_cast<int>(static_cast<uint32_t>(qtab[16 + i] + abs(x)) *
                         static_cast<uint32_t>(qtab[i])) >> 16;
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
    const uint32_t d = static_cast<uint32_t>(lev[i]) *
                       static_cast<uint32_t>(qtab[32 + i]);
    c[i >> 2][i & 3] =
        qbits >= 0 ? static_cast<int>(d << qbits)
                   : static_cast<int>(d + (1u << (-qbits - 1))) >> -qbits;
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
  qpel::wht4x4(wk);
  qpel::wht4x4(wp);

  const size_t plane = (size_t)n * 4;       // one [n][4] map
  const size_t cell = (size_t)mb * 4 + b;
  for (int k = 0; k < 9; ++k) {
    const int slot = (cy + kNb[k][0] + 3) * kBox + (cx + kNb[k][1] + 3);
    const int16_t* wrow = s_wht[b][slot] + s * 16;
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

extern "C" int pcamv_probe_maps(const void* cur, const void* windows,
                                const void* r_idx8, const void* qtab,
                                int qbits, int decimate, int mbh, int mbw,
                                void* sk, void* sp, void* sc8, void* stream) {
  probe_maps_kernel<<<mbh * mbw, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), static_cast<const uint8_t*>(windows),
      static_cast<const int*>(r_idx8), static_cast<const int*>(qtab), qbits,
      decimate, mbh, mbw, static_cast<int*>(sk), static_cast<int*>(sp),
      static_cast<int*>(sc8));
  return static_cast<int>(cudaGetLastError());
}
