// Per-MB window fetch of the four half-pel planes (Hopper, sm_90a).
//
// Replaces the TPU kernel gather_windows
// (video_steganography_pcamv_tpu/encoder/qpel_table.py:64, kernel
// _window_kernel :54, one DMA per MB): for MB n at (my, mx) with
// full-pel MV (mvx, mvy), copy planes[:, ys:ys+24, xs:xs+24] to
// out[n], where ys = 16*my + PAD - MARGIN + mvy and
// xs = 16*mx + PAD - MARGIN + mvx (PAD 24, MARGIN 4).
//
// One block per MB; its threads copy the 4 x 24 x 24 bytes, a row of 24
// contiguous bytes per group of threads. The copy is bound by device
// memory (2304 bytes read and written per MB), and at 1080p by launch
// latency. A window that would leave the planes traps the launch (the
// fault surfaces at the next synchronisation) instead of reading
// outside them: the encoder admits only search ranges that keep every
// window inside, so a trap means a broken caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;
constexpr int kMargin = 4;
constexpr int kWin = 24;
constexpr int kThreads = 192;

__global__ void windows_kernel(const uint8_t* __restrict__ planes, int hp,
                               int wp, const int* __restrict__ mv, int mbw,
                               uint8_t* __restrict__ out) {
  const int n = blockIdx.x;
  const int my = n / mbw;
  const int mx = n - my * mbw;
  const int ys = 16 * my + kPad - kMargin + mv[2 * n + 1];
  const int xs = 16 * mx + kPad - kMargin + mv[2 * n];
  if (ys < 0 || xs < 0 || ys + kWin > hp || xs + kWin > wp) __trap();
  const size_t plane = static_cast<size_t>(hp) * wp;
  uint8_t* dst = out + static_cast<size_t>(n) * 4 * kWin * kWin;
  for (int t = threadIdx.x; t < 4 * kWin * kWin; t += blockDim.x) {
    const int p = t / (kWin * kWin);
    const int rc = t - p * kWin * kWin;
    const int r = rc / kWin;
    const int c = rc - r * kWin;
    dst[t] = planes[p * plane + static_cast<size_t>(ys + r) * wp + xs + c];
  }
}

}  // namespace

extern "C" int pcamv_gather_windows(const void* planes, int hp, int wp,
                                    const void* mv, int mbh, int mbw,
                                    void* out, void* stream) {
  if (mbh * mbw <= 0) return 0;
  windows_kernel<<<mbh * mbw, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
