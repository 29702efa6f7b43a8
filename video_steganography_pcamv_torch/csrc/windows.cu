// Per-MB window fetch of the four half-pel planes (Hopper, sm_90a).
//
// Replaces the TPU kernel gather_windows
// (video_steganography_pcamv_tpu/encoder/qpel_table.py:64, kernel
// _window_kernel :54, one DMA per MB): for MB n at (my, mx) with
// full-pel MV (mvx, mvy), copy planes[:, ys:ys+24, xs:xs+24] to
// out[n], where ys = 16*my + PAD - MARGIN + mvy and
// xs = 16*mx + PAD - MARGIN + mvx (PAD 24, MARGIN 4).
//
// The copy is bound by device memory: at 1080p it reads the 8.9 MB of
// planes and writes 18.8 MB of windows. Design (after the per-8x8 fetch,
// csrc/windows8.cu): a warp copies one MB's window, 96 rows (4 planes x
// 24) of 24 bytes, a lane three rows. A row is read as the aligned
// 16-byte chunks it spans (two, or three when it starts past byte 8 of
// its chunk; all inside the row, the planes' width being a multiple of
// 16), its six words aligned to the window start with funnel shifts and
// put in shared memory; the warp then writes the MB's 2304 contiguous
// bytes as 16-byte stores, 512 bytes a warp instruction. xs is the same
// for the whole warp, so picking the words does not diverge.
//
// Not a tensor-map TMA load: on the H100 this port is measured on every
// cp.async.bulk.tensor load stops the kernel with an illegal instruction
// (tools/torch_kernel_probe.py).
//
// A window that would leave the planes traps the launch (the fault
// surfaces at the next synchronisation) instead of reading outside them:
// the encoder admits only search ranges that keep every window inside,
// so a trap means a broken caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;
constexpr int kMargin = 4;
constexpr int kWin = 24;
constexpr int kRows = 4 * kWin;                 // 4 planes x 24 rows
constexpr int kBytes = kRows * kWin;            // 2304 a window
constexpr int kWarps = 8;                       // MBs (warps) per CTA

__global__ void __launch_bounds__(32 * kWarps) windows_kernel(
    const uint8_t* __restrict__ planes, int hp, int wp,
    const int* __restrict__ mv, int n, int mbw, uint8_t* __restrict__ out) {
  __shared__ uint4 s_win[kWarps][kBytes / 16];
  const int warp = threadIdx.x >> 5;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= n) return;
  const int lane = threadIdx.x & 31;
  const int my = m / mbw;
  const int mx = m - my * mbw;
  const int ys = 16 * my + kPad - kMargin + mv[2 * m + 1];
  const int xs = 16 * mx + kPad - kMargin + mv[2 * m];
  if (ys < 0 || xs < 0 || ys + kWin > hp || xs + kWin > wp) __trap();
  const int off = xs & 15;                      // window start in its chunk
  const int sh = 8 * (off & 3);
  const size_t plane = static_cast<size_t>(hp) * wp;
  uint2* srow = reinterpret_cast<uint2*>(s_win[warp]);
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    const int pr = lane + 32 * h;               // plane * 24 + row
    const int p = pr / kWin;
    const uint4* src = reinterpret_cast<const uint4*>(
        planes + p * plane + static_cast<size_t>(ys + pr - p * kWin) * wp +
        (xs - off));
    const uint4 a = __ldg(src);
    const uint4 b = __ldg(src + 1);
    const uint4 c = off > 8 ? __ldg(src + 2) : make_uint4(0, 0, 0, 0);
    unsigned w[7];                              // words off/4 .. off/4 + 6
    switch (off >> 2) {
      case 0:
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z;
        break;
      case 1:
        w[0] = a.y; w[1] = a.z; w[2] = a.w; w[3] = b.x;
        w[4] = b.y; w[5] = b.z; w[6] = b.w;
        break;
      case 2:
        w[0] = a.z; w[1] = a.w; w[2] = b.x; w[3] = b.y;
        w[4] = b.z; w[5] = b.w; w[6] = c.x;
        break;
      default:
        w[0] = a.w; w[1] = b.x; w[2] = b.y; w[3] = b.z;
        w[4] = b.w; w[5] = c.x; w[6] = c.y;
        break;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      srow[3 * pr + k] = make_uint2(__funnelshift_r(w[2 * k], w[2 * k + 1], sh),
                                    __funnelshift_r(w[2 * k + 1], w[2 * k + 2],
                                                    sh));
  }
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * kBytes);
  for (int i = lane; i < kBytes / 16; i += 32) dst[i] = s_win[warp][i];
}

}  // namespace

extern "C" int pcamv_gather_windows(const void* planes, int hp, int wp,
                                    const void* mv, int mbh, int mbw,
                                    void* out, void* stream) {
  const int n = mbh * mbw;
  if (n <= 0) return 0;
  const int grid = (n + kWarps - 1) / kWarps;
  windows_kernel<<<grid, 32 * kWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), n, mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
