// Fused 4x4 residual transform pair of the inter luma encode (Hopper,
// sm_90a).
//
// pcamv_dct_quant replaces the TPU kernel dct_quant_pallas
// (video_steganography_pcamv_tpu/ops/pallas_kernels.py:175, kernel
// _dct_quant_kernel :88): residual cur - pred, forward 4x4 core
// transform, quant sign(c) * ((bias + |c|) * mf >> 16), row 0 zeroed
// when zero_dc.
//
// pcamv_deq_idct replaces deq_idct_pallas (:204, kernel _deq_idct_kernel
// :123): dequant lev * dmf, << qb for qb >= 0 or (+ 2^(-qb-1)) >> -qb
// below (qp < 24), row 0 replaced by the pre-dequantized dc row when
// use_dc, inverse 4x4 transform, (x + 32) >> 6, pred add, clip to
// [0, 255].
//
// Layout [16, L] int32: row i = coefficient position 4*r + c, lane l =
// one 4x4 block. One thread per lane keeps its 16 values in registers;
// a warp's loads and stores of a row are 128 contiguous bytes. Both
// kernels are bound by device memory: B8a moves 12 bytes per
// coefficient, B8b 12 (16 with the dc row), against ~10 integer
// operations per coefficient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void dct_quant_kernel(const int* __restrict__ cur,
                                 const int* __restrict__ pred,
                                 const int* __restrict__ mf,
                                 const int* __restrict__ bias, int lanes,
                                 int zero_dc, int* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t L = static_cast<size_t>(lanes);
  int x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = cur[i * L + l] - pred[i * L + l];
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // horizontal pass over c within row r
    const int s03 = x[4 * r] + x[4 * r + 3], s12 = x[4 * r + 1] + x[4 * r + 2];
    const int d03 = x[4 * r] - x[4 * r + 3], d12 = x[4 * r + 1] - x[4 * r + 2];
    t[4 * r + 0] = s03 + s12;
    t[4 * r + 1] = 2 * d03 + d12;
    t[4 * r + 2] = s03 - s12;
    t[4 * r + 3] = d03 - 2 * d12;
  }
  int coef[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // vertical pass over r within column c
    const int s03 = t[c] + t[12 + c], s12 = t[4 + c] + t[8 + c];
    const int d03 = t[c] - t[12 + c], d12 = t[4 + c] - t[8 + c];
    coef[c] = s03 + s12;
    coef[4 + c] = 2 * d03 + d12;
    coef[8 + c] = s03 - s12;
    coef[12 + c] = d03 - 2 * d12;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int cc = coef[i];
    const int mag = ((__ldg(&bias[i]) + abs(cc)) * __ldg(&mf[i])) >> 16;
    int v = cc > 0 ? mag : (cc < 0 ? -mag : 0);
    if (i == 0 && zero_dc) v = 0;
    out[i * L + l] = v;
  }
}

__global__ void deq_idct_kernel(const int* __restrict__ lev,
                                const int* __restrict__ pred,
                                const int* __restrict__ dmf, int qb,
                                const int* __restrict__ dc, int use_dc,
                                int lanes, int* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  const size_t L = static_cast<size_t>(lanes);
  const int shl = qb > 0 ? qb : 0;
  const int shr = qb < 0 ? -qb : 0;
  const int f = qb < 0 ? (1 << (shr - 1)) : 0;
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int v = lev[i * L + l] * __ldg(&dmf[i]);
    // a left shift as a product: defined for negative levels
    d[i] = qb >= 0 ? v * (1 << shl) : (v + f) >> shr;
  }
  if (use_dc) d[0] = dc[l];
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // horizontal pass
    const int x0 = d[4 * r], x1 = d[4 * r + 1], x2 = d[4 * r + 2],
              x3 = d[4 * r + 3];
    const int s02 = x0 + x2, d02 = x0 - x2;
    const int s13 = x1 + (x3 >> 1), d13 = (x1 >> 1) - x3;
    t[4 * r + 0] = s02 + s13;
    t[4 * r + 1] = d02 + d13;
    t[4 * r + 2] = d02 - d13;
    t[4 * r + 3] = s02 - s13;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // vertical pass, then recon
    const int x0 = t[c], x1 = t[4 + c], x2 = t[8 + c], x3 = t[12 + c];
    const int s02 = x0 + x2, d02 = x0 - x2;
    const int s13 = x1 + (x3 >> 1), d13 = (x1 >> 1) - x3;
    const int vals[4] = {s02 + s13, d02 + d13, d02 - d13, s02 - s13};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * k + c;
      const int rec = pred[i * L + l] + ((vals[k] + 32) >> 6);
      out[i * L + l] = rec < 0 ? 0 : (rec > 255 ? 255 : rec);
    }
  }
}

}  // namespace

extern "C" int pcamv_dct_quant(const void* cur, const void* pred,
                               const void* mf, const void* bias, int lanes,
                               int zero_dc, void* out, void* stream) {
  if (lanes <= 0) return 0;
  dct_quant_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), static_cast<const int*>(pred),
      static_cast<const int*>(mf), static_cast<const int*>(bias), lanes,
      zero_dc, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcamv_deq_idct(const void* lev, const void* pred,
                              const void* dmf, int qb, const void* dc,
                              int use_dc, int lanes, void* out,
                              void* stream) {
  if (lanes <= 0) return 0;
  deq_idct_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lev), static_cast<const int*>(pred),
      static_cast<const int*>(dmf), qb, static_cast<const int*>(dc), use_dc,
      lanes, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
