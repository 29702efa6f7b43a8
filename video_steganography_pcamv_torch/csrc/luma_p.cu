// Fused inter luma encode of 16x16 MBs (Hopper, sm_90a): kernel B8 in
// one launch.
//
// pcamv_luma_p_encode replaces the TPU kernels dct_quant_pallas
// (video_steganography_pcamv_tpu/ops/pallas_kernels.py:175, kernel
// _dct_quant_kernel :88) and deq_idct_pallas (:204, kernel
// _deq_idct_kernel :123) together with the JVT-B118 decimation that the
// reference runs between them (encoder/inter.py luma_p_encode_fast
// :124, the arithmetic of luma_p_encode :225):
//   residual cur - pred, forward 4x4 core transform, inter quant
//   sign(c) * ((bias + |c|) * mf >> 16); the decimate score of each 4x4
//   over the zigzag scan (the run table, 9 if any |level| > 1), summed
//   per 8x8 (kept where >= 4) and over the kept 8x8s of the MB (kept
//   where >= 6); levels zeroed where not kept or where the MB is forced
//   to zero; dequant lev * dmf, << qb for qb >= 0 or (+ 2^(-qb-1)) >>
//   -qb below (qp < 24); inverse 4x4 transform, (x + 32) >> 6, pred add,
//   clip to [0, 255]; cbp_luma, one bit per 8x8 with a nonzero level.
//
// Layout: a half-warp per MB, a lane per 4x4 block, the lanes ordered
// so that the four blocks of an 8x8 are adjacent (lane 4 * b8 + sub):
// the 8x8 sums are two __shfl_xor_sync, the MB sum two more, the cbp
// one __ballot_sync. A lane reads its 4x4 of cur (from the luma plane,
// through the MB index) and of pred as four 16-byte rows, writes its
// recon as four 16-byte rows, and the 16 lanes of an MB write each
// coefficient's 16 levels as 64 contiguous bytes ([N, 4(r), 4(c),
// 4(by), 4(bx)]). Bound by device memory: 1 KB of cur and of pred read
// and 1 KB of levels and of recon written per MB (4 KB), against ~400
// integer operations per 4x4 block (6.4 K per MB).
//
// pcamv_luma_p_recon is the same kernel entered with the levels given
// (the trellis quantizer's, computed before the launch): it reads pred
// and the [N, 4(r), 4(c), 4(by), 4(bx)] levels instead of cur, skips
// the transform and the quant, and runs the decimation, force-zero,
// dequant, inverse transform, recon and cbp as above. It serves the
// reference's luma_p_encode(..., trellis=True) (encoder/inter.py:225,
// :252-253). Bound by device memory: 1 KB of pred and of levels read,
// 1 KB of levels and of recon written per MB.
//
// With nr_off given, pcamv_luma_p_encode runs its noise-reduction
// instance (the reference's luma_p_encode(..., nr_offset=),
// encoder/inter.py:241-253, x264_denoise_dct): after the transform each
// lane takes |coef| of its 4x4, the 16 lanes of an MB reduce them to
// one sum per position by a reduce-scatter of four __shfl_xor_sync
// rounds (lane k ends with position k), a fifth joins the warp's two
// MBs, the CTA's warps add theirs in shared memory and 16 atomicAdd a
// CTA put them into nr_sum (int32 [16], zeroed by the caller; integer
// atomics, so the sums are exact in any order); then every AC
// coefficient becomes sign(c) * max(|c| - nr_off[pos], 0) before the
// quant (nr_off's DC entry is not read).
//
// pcamv_luma_p_encode_grid and pcamv_luma_p_recon_grid are the same two
// entries under a per-MB qp (adaptive quantization, the reference's
// luma_p_encode(cur, pred, qp[N], ...), encoder/inter.py:233-238): each
// MB reads its qp from qp_mb [N] and its mf, bias and dmf rows from one
// [52][48] int32 slab (the qtab of every qp), and takes the dequant shift
// qp / 6 - 4; everything else is as above. Still one launch a call; the
// slab stays in L1/L2, so the bytes per MB grow by the 4-byte qp and the
// 192 bytes of its rows.
//
// The quant product (bias + |c|) * mf and the dequant product lev * dmf
// (and its left shift) are computed as uint32_t and reinterpreted, so
// that they wrap as the reference's int32 arithmetic does: under a
// custom scaling list at low qp mf reaches ~70000 and the product can
// leave int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 MBs a block
constexpr unsigned kFull = 0xffffffffu;

// a * b with int32 wrap-around (no signed overflow)
__device__ __forceinline__ int mul_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

template <bool kLevelsIn, bool kNr, bool kGrid = false>
__global__ void __launch_bounds__(kThreads)
    luma_p_kernel(const int* __restrict__ y, const int* __restrict__ pred,
                  int width, int n_plane, const int* __restrict__ idx,
                  const unsigned char* __restrict__ fz, int n,
                  const int* __restrict__ mf, const int* __restrict__ bias,
                  const int* __restrict__ dmf, int qb,
                  const int* __restrict__ lev_in,
                  const int* __restrict__ nr_off, int* __restrict__ nr_sum,
                  int* __restrict__ lev, int* __restrict__ rec,
                  int* __restrict__ cbp, const int* __restrict__ qp_mb,
                  const int* __restrict__ qtab_all) {
  const int mb_raw = (blockIdx.x * kThreads + threadIdx.x) >> 4;
  const bool active = mb_raw < n;
  // the idle half-warp of an odd N repeats the last MB, so that every
  // lane of the warp takes part in the shuffles and the ballot
  const int mb = active ? mb_raw : n - 1;
  if constexpr (kGrid) {
    // the MB's own qp: its rows of the [52][48] slab (mf | bias | dmf)
    const int q = __ldg(&qp_mb[mb]);
    if (q < 0 || q > 51) __trap();
    mf = qtab_all + 48 * q;
    bias = mf + 16;
    dmf = mf + 32;
    qb = q / 6 - 4;
  }
  const int k = threadIdx.x & 15;
  const int b8 = k >> 2, sub = k & 3;
  const int by = (b8 & 2) | (sub >> 1);
  const int bx = ((b8 & 1) << 1) | (sub & 1);
  const int* pred_p = pred + (static_cast<size_t>(mb) * 256 + 64 * by + 4 * bx);

  int p[16], t[16], lv[16];
  if (kLevelsIn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(pred_p + 16 * i));
      p[4 * i] = q.x, p[4 * i + 1] = q.y, p[4 * i + 2] = q.z,
      p[4 * i + 3] = q.w;
    }
    const int* in_p = lev_in + (static_cast<size_t>(mb) * 256 + 4 * by + bx);
#pragma unroll
    for (int i = 0; i < 16; ++i) lv[i] = __ldg(&in_p[16 * i]);
  } else {
    const int m = idx ? __ldg(&idx[mb]) : mb % n_plane;
    if (m < 0 || m >= n_plane) __trap();
    const int mbw = width >> 4;
    const int mby = m / mbw, mbx = m - mby * mbw;
    const int* cur_p =
        y + (static_cast<size_t>(16 * mby + 4 * by) * width + 16 * mbx +
             4 * bx);

    int x[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(cur_p + i * width));
      const int4 q = __ldg(reinterpret_cast<const int4*>(pred_p + 16 * i));
      p[4 * i] = q.x, p[4 * i + 1] = q.y, p[4 * i + 2] = q.z,
      p[4 * i + 3] = q.w;
      x[4 * i] = c.x - q.x, x[4 * i + 1] = c.y - q.y, x[4 * i + 2] = c.z - q.z,
      x[4 * i + 3] = c.w - q.w;
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {  // horizontal pass over c within row r
      const int s03 = x[4 * r] + x[4 * r + 3];
      const int s12 = x[4 * r + 1] + x[4 * r + 2];
      const int d03 = x[4 * r] - x[4 * r + 3];
      const int d12 = x[4 * r + 1] - x[4 * r + 2];
      t[4 * r + 0] = s03 + s12;
      t[4 * r + 1] = 2 * d03 + d12;
      t[4 * r + 2] = s03 - s12;
      t[4 * r + 3] = d03 - 2 * d12;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // vertical pass over r within column c
      const int s03 = t[c] + t[12 + c], s12 = t[4 + c] + t[8 + c];
      const int d03 = t[c] - t[12 + c], d12 = t[4 + c] - t[8 + c];
      lv[c] = s03 + s12;
      lv[4 + c] = 2 * d03 + d12;
      lv[8 + c] = s03 - s12;
      lv[12 + c] = d03 - 2 * d12;
    }
    if constexpr (kNr) {
      // the MB's |coef| sums per position, before the denoise
      int a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = active ? abs(lv[i]) : 0;
#pragma unroll
      for (int s = 3; s >= 0; --s) {
        const int half = 1 << s;
        const bool up = (k & half) != 0;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const int send = up ? a[i] : a[i + half];
          const int keep = up ? a[i + half] : a[i];
          a[i] = keep + __shfl_xor_sync(kFull, send, half);
        }
      }
      const int sum = a[0] + __shfl_xor_sync(kFull, a[0], 16);
      __shared__ int s_nr[16];
      if (threadIdx.x < 16) s_nr[threadIdx.x] = 0;
      __syncthreads();
      if ((threadIdx.x & 31) < 16) atomicAdd(&s_nr[k], sum);
      __syncthreads();
      if (threadIdx.x < 16) atomicAdd(&nr_sum[threadIdx.x], s_nr[threadIdx.x]);
#pragma unroll
      for (int i = 1; i < 16; ++i) {
        const int cc = lv[i];
        const int mg = max(abs(cc) - __ldg(&nr_off[i]), 0);
        lv[i] = cc > 0 ? mg : (cc < 0 ? -mg : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int cc = lv[i];
      const int mag = mul_wrap(__ldg(&bias[i]) + abs(cc), __ldg(&mf[i])) >> 16;
      lv[i] = cc > 0 ? mag : (cc < 0 ? -mag : 0);
    }
  }

  // decimate score over the zigzag scan (positions as 4r + c): each
  // nonzero level adds the table entry of the zero run before it
  const int zz[16] = {lv[0], lv[1],  lv[4],  lv[8],  lv[5],  lv[2],
                      lv[3], lv[6],  lv[9],  lv[12], lv[13], lv[10],
                      lv[7], lv[11], lv[14], lv[15]};
  int score = 0, last = -1;
  bool big = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int a = abs(zz[i]);
    big |= a > 1;
    if (a != 0) {
      const int run = i - last - 1;
      score += run == 0 ? 3 : (run <= 2 ? 2 : (run <= 5 ? 1 : 0));
      last = i;
    }
  }
  if (big) score = 9;
  int s8 = score + __shfl_xor_sync(kFull, score, 1);
  s8 += __shfl_xor_sync(kFull, s8, 2);
  int kept = s8 >= 4 ? s8 : 0;
  kept += __shfl_xor_sync(kFull, kept, 4);
  kept += __shfl_xor_sync(kFull, kept, 8);
  const bool keep =
      s8 >= 4 && kept >= 6 && !(fz != nullptr && fz[mb] != 0);
  bool nz = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lv[i] = keep ? lv[i] : 0;
    nz |= lv[i] != 0;
  }
  const unsigned bal = __ballot_sync(kFull, nz) >> (threadIdx.x & 16);
  if (active) {
    if (lev != nullptr) {
      int* lev_p = lev + (static_cast<size_t>(mb) * 256 + 4 * by + bx);
#pragma unroll
      for (int i = 0; i < 16; ++i) lev_p[16 * i] = lv[i];
    }
    if (k == 0)
      cbp[mb] = ((bal & 0xfu) ? 1 : 0) | ((bal & 0xf0u) ? 2 : 0) |
                ((bal & 0xf00u) ? 4 : 0) | ((bal & 0xf000u) ? 8 : 0);
  }

  const int shl = qb > 0 ? qb : 0;
  const int shr = qb < 0 ? -qb : 0;
  const int f = qb < 0 ? (1 << (shr - 1)) : 0;
  int d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int v = mul_wrap(lv[i], __ldg(&dmf[i]));
    // a left shift as a product: defined for negative levels
    d[i] = qb >= 0 ? mul_wrap(v, 1 << shl)
                   : static_cast<int>(static_cast<uint32_t>(v) +
                                      static_cast<uint32_t>(f)) >> shr;
  }
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
  int o[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // vertical pass, then recon
    const int x0 = t[c], x1 = t[4 + c], x2 = t[8 + c], x3 = t[12 + c];
    const int s02 = x0 + x2, d02 = x0 - x2;
    const int s13 = x1 + (x3 >> 1), d13 = (x1 >> 1) - x3;
    const int vals[4] = {s02 + s13, d02 + d13, d02 - d13, s02 - s13};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int v = p[4 * r + c] + ((vals[r] + 32) >> 6);
      o[4 * r + c] = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
  }
  if (active) {
    int* rec_p = rec + (static_cast<size_t>(mb) * 256 + 64 * by + 4 * bx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<int4*>(rec_p + 16 * i) =
          make_int4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
}

template <bool kNr, bool kGrid>
void launch_encode(const void* y, const void* pred, int width, int n_plane,
                   const void* idx, const void* fz, int n, const void* mf,
                   const void* bias, const void* dmf, int qb,
                   const void* nr_off, void* nr_sum, void* lev, void* rec,
                   void* cbp, const void* qp_mb, const void* qtab_all,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads / 16 - 1) / (kThreads / 16);
  luma_p_kernel<false, kNr, kGrid><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(y), static_cast<const int*>(pred), width,
      n_plane, static_cast<const int*>(idx),
      static_cast<const unsigned char*>(fz), n, static_cast<const int*>(mf),
      static_cast<const int*>(bias), static_cast<const int*>(dmf), qb,
      nullptr, static_cast<const int*>(nr_off), static_cast<int*>(nr_sum),
      static_cast<int*>(lev), static_cast<int*>(rec), static_cast<int*>(cbp),
      static_cast<const int*>(qp_mb), static_cast<const int*>(qtab_all));
}

template <bool kGrid>
void launch_recon(const void* pred, const void* lev_in, const void* fz, int n,
                  const void* dmf, int qb, void* lev, void* rec, void* cbp,
                  const void* qp_mb, const void* qtab_all,
                  cudaStream_t stream) {
  const int blocks = (n + kThreads / 16 - 1) / (kThreads / 16);
  luma_p_kernel<true, false, kGrid><<<blocks, kThreads, 0, stream>>>(
      nullptr, static_cast<const int*>(pred), 16, 1, nullptr,
      static_cast<const unsigned char*>(fz), n, nullptr, nullptr,
      static_cast<const int*>(dmf), qb, static_cast<const int*>(lev_in),
      nullptr, nullptr, static_cast<int*>(lev), static_cast<int*>(rec),
      static_cast<int*>(cbp), static_cast<const int*>(qp_mb),
      static_cast<const int*>(qtab_all));
}

}  // namespace

// nr_off (int32 [16], 4r + c order) and nr_sum (int32 [16], zeroed) select
// the noise-reduction instance; both null, the plain one.
extern "C" int pcamv_luma_p_encode(const void* y, const void* pred, int width,
                                   int n_plane, const void* idx,
                                   const void* fz, int n, const void* mf,
                                   const void* bias, const void* dmf, int qb,
                                   const void* nr_off, void* nr_sum,
                                   void* lev, void* rec, void* cbp,
                                   void* stream) {
  if (n <= 0) return 0;
  if ((nr_off == nullptr) != (nr_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nr_off != nullptr)
    launch_encode<true, false>(y, pred, width, n_plane, idx, fz, n, mf, bias,
                               dmf, qb, nr_off, nr_sum, lev, rec, cbp,
                               nullptr, nullptr, st);
  else
    launch_encode<false, false>(y, pred, width, n_plane, idx, fz, n, mf, bias,
                                dmf, qb, nullptr, nullptr, lev, rec, cbp,
                                nullptr, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// The per-MB qp instance (adaptive quantization): qp_mb int32 [n] in
// [0, 51] (a value outside traps), qtab_all int32 [52][48] the qtab rows
// of every qp; the kernel reads its MB's rows and computes the shift
// qp / 6 - 4 itself.
extern "C" int pcamv_luma_p_encode_grid(
    const void* y, const void* pred, int width, int n_plane, const void* idx,
    const void* fz, int n, const void* qp_mb, const void* qtab_all,
    const void* nr_off, void* nr_sum, void* lev, void* rec, void* cbp,
    void* stream) {
  if (n <= 0) return 0;
  if ((nr_off == nullptr) != (nr_sum == nullptr) || qp_mb == nullptr ||
      qtab_all == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nr_off != nullptr)
    launch_encode<true, true>(y, pred, width, n_plane, idx, fz, n, nullptr,
                              nullptr, nullptr, 0, nr_off, nr_sum, lev, rec,
                              cbp, qp_mb, qtab_all, st);
  else
    launch_encode<false, true>(y, pred, width, n_plane, idx, fz, n, nullptr,
                               nullptr, nullptr, 0, nullptr, nullptr, lev,
                               rec, cbp, qp_mb, qtab_all, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcamv_luma_p_recon(const void* pred, const void* lev_in,
                                  const void* fz, int n, const void* dmf,
                                  int qb, void* lev, void* rec, void* cbp,
                                  void* stream) {
  if (n <= 0) return 0;
  launch_recon<false>(pred, lev_in, fz, n, dmf, qb, lev, rec, cbp, nullptr,
                      nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcamv_luma_p_recon_grid(const void* pred, const void* lev_in,
                                       const void* fz, int n,
                                       const void* qp_mb,
                                       const void* qtab_all, void* lev,
                                       void* rec, void* cbp, void* stream) {
  if (n <= 0) return 0;
  if (qp_mb == nullptr || qtab_all == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_recon<true>(pred, lev_in, fz, n, nullptr, 0, lev, rec, cbp, qp_mb,
                     qtab_all, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
