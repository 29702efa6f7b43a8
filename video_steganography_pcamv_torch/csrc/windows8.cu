// Per-8x8-block window fetch of the four half-pel planes (Hopper, sm_90a).
//
// Replaces the TPU kernel gather_windows8_banked
// (video_steganography_pcamv_tpu/ops/pallas_kernels.py:259, kernel
// _window8_kernel :239): for 8x8 block b at (by, bx) of the
// [2mbh, 2mbw] block grid with full-pel MV (mvx, mvy), copy
// planes[:, ys:ys+16, xs:xs+16] to out[b], where ys = 8*by + PAD - MARGIN
// + mvy and xs = 8*bx + PAD - MARGIN + mvx (PAD 24, MARGIN 4).
//
// The TPU kernel's eight pre-shifted plane banks are an alignment device
// of its DMA engine and are not carried over: each thread reads one
// 16-byte window row straight from the uint8 planes (byte loads, served
// by L1/L2 since neighbouring windows overlap) and writes it as one
// aligned 16-byte store. A CTA of 256 threads covers four blocks (4
// blocks x 4 planes x 16 rows). The copy is bound by device memory (a
// 1080p frame writes 33.4 MB) and, at small frames, by launch latency.
// A window that would leave the planes traps the launch instead of
// reading outside them (the fault surfaces at the next synchronisation):
// the encoder admits only search ranges that keep every window inside,
// so a trap means a broken caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;
constexpr int kMargin = 4;
constexpr int kWin = 16;
constexpr int kRowsPerBlock = 4 * kWin;   // 4 planes x 16 rows
constexpr int kBlocksPerCta = 4;
constexpr int kThreads = kRowsPerBlock * kBlocksPerCta;

__global__ void windows8_kernel(const uint8_t* __restrict__ planes, int hp,
                                int wp, const int* __restrict__ mv, int n8,
                                int nbw, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * kBlocksPerCta + threadIdx.x / kRowsPerBlock;
  if (b >= n8) return;
  const int pr = threadIdx.x % kRowsPerBlock;
  const int p = pr / kWin;
  const int r = pr - p * kWin;
  const int by = b / nbw;
  const int bx = b - by * nbw;
  const int ys = 8 * by + kPad - kMargin + mv[2 * b + 1];
  const int xs = 8 * bx + kPad - kMargin + mv[2 * b];
  if (ys < 0 || xs < 0 || ys + kWin > hp || xs + kWin > wp) __trap();
  const uint8_t* src = planes + static_cast<size_t>(p) * hp * wp +
                       static_cast<size_t>(ys + r) * wp + xs;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    w[k] = static_cast<uint32_t>(__ldg(src + 4 * k)) |
           static_cast<uint32_t>(__ldg(src + 4 * k + 1)) << 8 |
           static_cast<uint32_t>(__ldg(src + 4 * k + 2)) << 16 |
           static_cast<uint32_t>(__ldg(src + 4 * k + 3)) << 24;
  }
  uint4* dst = reinterpret_cast<uint4*>(
      out + (static_cast<size_t>(b) * kRowsPerBlock + pr) * kWin);
  *dst = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

extern "C" int pcamv_gather_windows8(const void* planes, int hp, int wp,
                                     const void* mv, int mbh, int mbw,
                                     void* out, void* stream) {
  const int n8 = 4 * mbh * mbw;
  if (n8 <= 0) return 0;
  const int grid = (n8 + kBlocksPerCta - 1) / kBlocksPerCta;
  windows8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), n8, 2 * mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
