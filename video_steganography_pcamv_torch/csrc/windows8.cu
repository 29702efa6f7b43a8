// Per-8x8-block window fetch of the four half-pel planes (Hopper, sm_90a).
//
// Replaces the TPU kernel gather_windows8_banked
// (video_steganography_pcamv_tpu/ops/pallas_kernels.py:259, kernel
// _window8_kernel :239): for 8x8 block b at (by, bx) of the
// [2mbh, 2mbw] block grid with full-pel MV (mvx, mvy), copy
// planes[:, ys:ys+16, xs:xs+16] to out[b], where ys = 8*by + PAD - MARGIN
// + mvy and xs = 8*bx + PAD - MARGIN + mvx (PAD 24, MARGIN 4). With
// multiple references (the multi-reference P analysis, the reference's
// gather_windows8_mref, video_steganography_pcamv_tpu/encoder/
// partition.py:792) the planes are a stack [R][4][Hp][Wp] and block b
// reads entry ref8[b] of it.
//
// The TPU kernel's eight pre-shifted plane banks are an alignment device
// of its DMA engine and are not carried over. A warp copies one block's
// window (1 KB: 4 planes x 16 rows of 16 bytes), a lane two rows: each
// row is read as the aligned 16-byte chunk that holds its start and, if
// the row is not 16-aligned, the chunk after it (both inside the row:
// the planes' width is a multiple of 16), aligned to the window start
// with four funnel shifts, and written as one 16-byte store; a warp's
// stores cover the window's 1 KB contiguously. xs is the same for the
// whole warp, so picking the words does not diverge. The copy is bound
// by device memory (a 1080p frame writes 33.4 MB); reading each row as
// five aligned 4-byte words measured slower
// (tools/torch_kernel_probe.py).
//
// Not a tensor-map TMA load (one cp.async.bulk.tensor of a 16 x 16 x 4
// box a block): on the H100 this port is measured on (NVIDIA 580.159.03,
// CUDA 13.0; kernels built with the CUDA 12.8 toolkit) every
// cp.async.bulk.tensor load stops the kernel with
// cudaErrorIllegalInstruction, through libcu++'s
// cp_async_bulk_tensor_3d_global_to_shared too, while 1D cp.async.bulk
// copies run (tools/torch_kernel_probe.py).
//
// A window that would leave the planes traps the launch instead of
// reading outside them (the fault surfaces at the next synchronisation):
// the encoder admits only search ranges that keep every window inside,
// so a trap means a broken caller. A reference index outside [0, R)
// traps the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;
constexpr int kMargin = 4;
constexpr int kWin = 16;
constexpr int kRows = 4 * kWin;            // 4 planes x 16 rows
constexpr int kWarps = 8;                  // blocks (warps) per CTA

__global__ void __launch_bounds__(32 * kWarps) windows8_kernel(
    const uint8_t* __restrict__ planes, int hp, int wp,
    const int* __restrict__ mv, const int* __restrict__ ref8, int nref,
    int n8, int nbw, uint8_t* __restrict__ out) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n8) return;
  const int lane = threadIdx.x & 31;
  const int by = b / nbw;
  const int bx = b - by * nbw;
  const int ys = 8 * by + kPad - kMargin + mv[2 * b + 1];
  const int xs = 8 * bx + kPad - kMargin + mv[2 * b];
  const int r = ref8 ? ref8[b] : 0;
  if (ys < 0 || xs < 0 || ys + kWin > hp || xs + kWin > wp || r < 0 ||
      r >= nref)
    __trap();
  const int off = xs & 15;                 // window start in its chunk
  const int sh = 8 * (off & 3);
  const size_t plane = static_cast<size_t>(hp) * wp;
  const uint8_t* base = planes + static_cast<size_t>(4 * r) * plane;
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) *
                                        kRows * kWin);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pr = lane + 32 * h;          // plane * 16 + row
    const uint4* src = reinterpret_cast<const uint4*>(
        base + (pr >> 4) * plane +
        static_cast<size_t>(ys + (pr & 15)) * wp + (xs - off));
    const uint4 a = __ldg(src);
    const uint4 c = off ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
    unsigned w0, w1, w2, w3, w4;           // words off/4 .. off/4 + 4
    switch (off >> 2) {
      case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = c.x; break;
      case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = c.x; w4 = c.y; break;
      case 2: w0 = a.z; w1 = a.w; w2 = c.x; w3 = c.y; w4 = c.z; break;
      default: w0 = a.w; w1 = c.x; w2 = c.y; w3 = c.z; w4 = c.w; break;
    }
    dst[pr] = make_uint4(__funnelshift_r(w0, w1, sh),
                         __funnelshift_r(w1, w2, sh),
                         __funnelshift_r(w2, w3, sh),
                         __funnelshift_r(w3, w4, sh));
  }
}

}  // namespace

extern "C" int pcamv_gather_windows8(const void* planes, int hp, int wp,
                                     const void* mv, const void* ref8,
                                     int nref, int mbh, int mbw, void* out,
                                     void* stream) {
  const int n8 = 4 * mbh * mbw;
  if (n8 <= 0) return 0;
  const int grid = (n8 + kWarps - 1) / kWarps;
  windows8_kernel<<<grid, 32 * kWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hp, wp,
      static_cast<const int*>(mv), static_cast<const int*>(ref8), nref, n8,
      2 * mbw, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
