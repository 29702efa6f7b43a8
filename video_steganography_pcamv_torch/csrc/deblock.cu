// In-loop deblocking filter, H.264 spec 8.7 (Hopper, sm_90a).
//
// Replaces the TPU kernel deblock_frame_pallas
// (video_steganography_pcamv_tpu/ops/deblock_pallas.py:469, run by _run
// with the body from _make_kernel). The per-MB edge parameters (bS,
// alpha, beta, tc0, active masks, strong flags) come precomputed in the
// reference's [n_mb, 128] int32 row layout (edge_params); this kernel
// does only the normative pixel arithmetic: the bS < 4 filter and the
// strong (intra MB edge) filter, luma and chroma.
//
// Order: the reference filters MBs in raster order, each MB's vertical
// edges then its horizontal edges, writing up to 3 pixels into the left
// and top neighbours. MBs of one knight wave d = mx + 2*my depend only
// on earlier waves and their 20x20 luma / 12x12 chroma tiles are
// disjoint, so the host loop launches one grid per wave on the stream
// (the stream orders the waves; each sees the previous wave's writes)
// and every block filters one MB's tiles in shared memory. This is the
// order of deblock_jax.deblock_frame_device and gives the raster-order
// result. Bound by launch latency (~mbw + 2*mbh waves of at most a few
// dozen MBs each), not by memory traffic.
//
// Planes are int32 with a 4-pixel zero border (PAD = 4); the filter
// works in place.

#include <cuda_runtime.h>

namespace {

constexpr int kPad = 4;

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return max(lo, min(v, hi));
}

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// One luma line across an edge: s[0..7] = p3 p2 p1 p0 q0 q1 q2 q3,
// updated in place (p2..q2).
__device__ void luma_line(int* s, int a, int b, int tc0, int bs,
                          bool strong, bool active) {
  const int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3];
  const int q0 = s[4], q1 = s[5], q2 = s[6], q3 = s[7];
  const bool base = active && abs(p0 - q0) < a && abs(p1 - p0) < b &&
                    abs(q1 - q0) < b;
  if (!base) return;
  const bool ap = abs(p2 - p0) < b;
  const bool aq = abs(q2 - q0) < b;
  if (strong) {
    const bool lum = abs(p0 - q0) < ((a >> 2) + 2);
    if (lum && ap) {
      s[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      s[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      s[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      s[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (lum && aq) {
      s[4] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      s[5] = (p0 + q0 + q1 + q2 + 2) >> 2;
      s[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      s[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  if (bs <= 0) return;
  const int tc = tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) s[2] = p1 + clip3(((p2 + avg) >> 1) - p1, -tc0, tc0);
  if (aq) s[5] = q1 + clip3(((q2 + avg) >> 1) - q1, -tc0, tc0);
  const int delta = clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
  s[3] = clip255(p0 + delta);
  s[4] = clip255(q0 - delta);
}

// One chroma line: s[0..3] = p1 p0 q0 q1, p0/q0 updated in place.
__device__ void chroma_line(int* s, int a, int b, int tc0, int bs,
                            bool strong, bool active) {
  const int p1 = s[0], p0 = s[1], q0 = s[2], q1 = s[3];
  const bool base = active && abs(p0 - q0) < a && abs(p1 - p0) < b &&
                    abs(q1 - q0) < b;
  if (!base) return;
  if (strong) {
    s[1] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[2] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  if (bs <= 0) return;
  const int tc = tc0 + 1;
  const int delta = clip3((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
  s[1] = clip255(p0 + delta);
  s[2] = clip255(q0 - delta);
}

__global__ void deblock_wave_kernel(int* __restrict__ yp,
                                    int* __restrict__ up,
                                    int* __restrict__ vp,
                                    const int* __restrict__ par, int mbh,
                                    int mbw, int d, int my_lo) {
  __shared__ int ty[20][20];
  __shared__ int tc[2][12][12];
  __shared__ int prm[128];

  const int my = my_lo + blockIdx.x;
  const int mx = d - 2 * my;
  const int t = threadIdx.x;
  const int wy = 16 * mbw + 2 * kPad;   // padded luma row length
  const int wc = 8 * mbw + 2 * kPad;    // padded chroma row length
  const int* row = par + (my * mbw + mx) * 128;

  for (int i = t; i < 128; i += blockDim.x) prm[i] = row[i];
  for (int i = t; i < 400; i += blockDim.x) {
    const int r = i / 20, c = i - 20 * (i / 20);
    ty[r][c] = yp[(16 * my + r) * wy + 16 * mx + c];
  }
  for (int i = t; i < 288; i += blockDim.x) {
    const int pl = i / 144, k = i - 144 * pl;
    const int r = k / 12, c = k - 12 * (k / 12);
    const int* src = pl ? vp : up;
    tc[pl][r][c] = src[(8 * my + r) * wc + 8 * mx + c];
  }
  __syncthreads();

  int s[8];
  // luma: vertical edges (dir 0) then horizontal (dir 1), 16 lines each
  for (int dir = 0; dir < 2; ++dir) {
    for (int e = 0; e < 4; ++e) {
      if (t < 16) {
        const int pos = 4 + 4 * e;
        const int g = t >> 2;
        const int a = prm[dir * 4 + e];
        const int b = prm[8 + dir * 4 + e];
        const bool act = prm[16 + dir * 4 + e] > 0;
        const bool strong = e == 0 && prm[24 + dir] > 0;
        const int bs = prm[32 + dir * 16 + e * 4 + g];
        const int tc0 = prm[64 + dir * 16 + e * 4 + g];
        if (act) {
          for (int k = 0; k < 8; ++k)
            s[k] = dir == 0 ? ty[4 + t][pos - 4 + k] : ty[pos - 4 + k][4 + t];
          luma_line(s, a, b, tc0, bs, strong, act);
          for (int k = 1; k < 7; ++k) {
            if (dir == 0) ty[4 + t][pos - 4 + k] = s[k];
            else ty[pos - 4 + k][4 + t] = s[k];
          }
        }
      }
      __syncthreads();
    }
  }
  // chroma: edges 0 and 2, vertical then horizontal; 8 lines x 2 planes
  for (int dir = 0; dir < 2; ++dir) {
    for (int ei = 0; ei < 2; ++ei) {
      if (t < 16) {
        const int e = 2 * ei;
        const int pos = 4 + 2 * e;
        const int pl = t >> 3;
        const int line = t & 7;
        const int g = line >> 1;
        const int a = prm[96 + dir * 2 + ei];
        const int b = prm[100 + dir * 2 + ei];
        const bool act = prm[104 + dir * 2 + ei] > 0;
        const bool strong = e == 0 && prm[24 + dir] > 0;
        const int bs = prm[32 + dir * 16 + e * 4 + g];
        const int tc0 = prm[108 + dir * 8 + ei * 4 + g];
        if (act) {
          for (int k = 0; k < 4; ++k)
            s[k] = dir == 0 ? tc[pl][4 + line][pos - 2 + k]
                            : tc[pl][pos - 2 + k][4 + line];
          chroma_line(s, a, b, tc0, bs, strong, act);
          for (int k = 1; k < 3; ++k) {
            if (dir == 0) tc[pl][4 + line][pos - 2 + k] = s[k];
            else tc[pl][pos - 2 + k][4 + line] = s[k];
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = t; i < 400; i += blockDim.x) {
    const int r = i / 20, c = i - 20 * (i / 20);
    yp[(16 * my + r) * wy + 16 * mx + c] = ty[r][c];
  }
  for (int i = t; i < 288; i += blockDim.x) {
    const int pl = i / 144, k = i - 144 * pl;
    const int r = k / 12, c = k - 12 * (k / 12);
    int* dst = pl ? vp : up;
    dst[(8 * my + r) * wc + 8 * mx + c] = tc[pl][r][c];
  }
}

}  // namespace

extern "C" int pcamv_deblock_frame(void* yp, void* up, void* vp,
                                   const void* par, int mbh, int mbw,
                                   void* stream) {
  const int n_waves = mbw + 2 * (mbh - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int d = 0; d < n_waves; ++d) {
    const int my_lo = max(0, (d - mbw + 2) / 2);
    const int my_hi = min(mbh - 1, d / 2);
    if (my_hi < my_lo) continue;
    deblock_wave_kernel<<<my_hi - my_lo + 1, 32, 0, st>>>(
        static_cast<int*>(yp), static_cast<int*>(up), static_cast<int*>(vp),
        static_cast<const int*>(par), mbh, mbw, d, my_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
