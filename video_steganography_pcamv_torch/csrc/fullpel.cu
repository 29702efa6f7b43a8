// Full-pel motion search (Hopper, sm_90a): two entry points over one
// kernel template.
//
// pcamv_fullpel_parts replaces the TPU kernel fullpel_parts_pallas
// (video_steganography_pcamv_tpu/ops/pallas_kernels.py:435, kernels
// _fullpel_parts_kernel2 / _fullpel_parts_kernel). For every MB and
// every full-pel displacement (dx, dy) in [-rng, rng]^2 it computes the
// SAD of the MB's four 8x8 blocks and, for the 9 partition units
// (16x16; 16x8 top/bottom; 8x16 left/right; 8x8 x4 in z-order),
//   cost = unit SAD + lam * (bits(4dx - 4pmx) + bits(4dy - 4pmy))
// against the MB's full-pel predictor (pmx, pmy).
//
// pcamv_fullpel_search16 replaces the TPU kernel fullpel_search_pallas
// (pallas_kernels.py:549, kernel _fullpel_kernel :42): the 16x16 unit
// alone against a zero predictor, written as (mv, cost). Its template
// instance keeps one running minimum instead of nine.
//
// The winner per unit is the FIRST strict-< minimum in dy-outer,
// dx-inner scan order: the block reduction takes the minimum of
// (cost << 32 | scan index).
//
// Design: one block per MB. The 16x16 current block and the
// (16+2rng)^2 reference window sit in shared memory; threads stride
// over the displacements keeping their running (cost, index) minima,
// then reduce with warp shuffles and one shared-memory pass. At 1080p
// (8160 MBs, rng 16, 1089 displacements) the search is ~2.3 G
// abs-differences a frame, bound by integer ALU work and shared-memory
// reads, not by device memory (each MB reads ~10 KB once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;       // full-pel border of the reference plane
constexpr int kThreads = 256;

// kUnits 9: all partition units, out_a = cost [n, 9], out_b = scan
// index [n, 9]. kUnits 1: the 16x16 unit, out_a = mv [n, 2] (x, y),
// out_b = cost [n]. pred == nullptr is the zero predictor.
template <int kUnits>
__global__ void fullpel_kernel(
    const int* __restrict__ cur, int cur_w,
    const int* __restrict__ ref, int ref_w,
    const int* __restrict__ pred, const int* __restrict__ bits,
    int bits_len, int rng, int lam, int mbw,
    int* __restrict__ out_a, int* __restrict__ out_b) {
  extern __shared__ int smem[];
  const int side = 2 * rng + 1;
  const int ws = 16 + 2 * rng;
  int* s_cur = smem;
  int* s_win = smem + 256;
  unsigned long long* s_red =
      reinterpret_cast<unsigned long long*>(s_win + ws * ws);

  const int mb = blockIdx.x;
  const int my = mb / mbw;
  const int mx = mb - my * mbw;
  const int tid = threadIdx.x;

  for (int t = tid; t < 256; t += blockDim.x) {
    s_cur[t] = cur[(16 * my + (t >> 4)) * cur_w + 16 * mx + (t & 15)];
  }
  const int wy0 = kPad + 16 * my - rng;
  const int wx0 = kPad + 16 * mx - rng;
  for (int t = tid; t < ws * ws; t += blockDim.x) {
    const int r = t / ws;
    const int c = t - r * ws;
    s_win[t] = ref[(wy0 + r) * ref_w + wx0 + c];
  }
  __syncthreads();

  const int pmx = pred ? pred[2 * mb] : 0;
  const int pmy = pred ? pred[2 * mb + 1] : 0;
  const int off = (bits_len - 1) / 2;
  unsigned long long best[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) best[u] = ~0ull;

  for (int i = tid; i < side * side; i += blockDim.x) {
    const int dyo = i / side;            // dy + rng
    const int dxo = i - dyo * side;      // dx + rng
    int q0 = 0, q1 = 0, q2 = 0, q3 = 0;
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int* crow = s_cur + r * 16;
      const int* wrow = s_win + (r + dyo) * ws + dxo;
      int a = 0, b = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) a += abs(crow[c] - wrow[c]);
#pragma unroll
      for (int c = 8; c < 16; ++c) b += abs(crow[c] - wrow[c]);
      if (r < 8) { q0 += a; q1 += b; } else { q2 += a; q3 += b; }
    }
    const int dx = dxo - rng;
    const int dy = dyo - rng;
    int ix = 4 * dx - 4 * pmx + off;
    int iy = 4 * dy - 4 * pmy + off;
    ix = min(max(ix, 0), bits_len - 1);
    iy = min(max(iy, 0), bits_len - 1);
    const int mvc = (bits[ix] + bits[iy]) * lam;
    const int all9[9] = {
        q0 + q1 + q2 + q3 + mvc,
        q0 + q1 + mvc, q2 + q3 + mvc,
        q0 + q2 + mvc, q1 + q3 + mvc,
        q0 + mvc, q1 + mvc, q2 + mvc, q3 + mvc};
    const int* cost = all9;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned>(cost[u]))
           << 32) | static_cast<unsigned>(i);
      best[u] = key < best[u] ? key : best[u];
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    unsigned long long v = best[u];
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_down_sync(0xffffffffu, v, o);
      v = w < v ? w : v;
    }
    if (lane == 0) s_red[warp * kUnits + u] = v;
  }
  __syncthreads();
  if (tid < kUnits) {
    unsigned long long v = ~0ull;
    const int n_warps = blockDim.x >> 5;
    for (int w = 0; w < n_warps; ++w) {
      const unsigned long long x = s_red[w * kUnits + tid];
      v = x < v ? x : v;
    }
    const int cost = static_cast<int>(v >> 32);
    const int idx = static_cast<int>(v & 0xffffffffu);
    if constexpr (kUnits == 1) {
      const int dyo = idx / side;
      out_a[2 * mb] = idx - dyo * side - rng;
      out_a[2 * mb + 1] = dyo - rng;
      out_b[mb] = cost;
    } else {
      out_a[mb * kUnits + tid] = cost;
      out_b[mb * kUnits + tid] = idx;
    }
  }
}

template <int kUnits>
int launch(const void* cur, int cur_w, const void* ref, int ref_w,
           const void* pred, const void* bits, int bits_len, int rng,
           int lam, int mbh, int mbw, void* out_a, void* out_b,
           void* stream) {
  const int ws = 16 + 2 * rng;
  const size_t smem = (256 + ws * ws) * sizeof(int)
      + (kThreads / 32) * kUnits * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fullpel_kernel<kUnits>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  fullpel_kernel<kUnits><<<mbh * mbw, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), cur_w, static_cast<const int*>(ref),
      ref_w, static_cast<const int*>(pred),
      static_cast<const int*>(bits), bits_len, rng, lam, mbw,
      static_cast<int*>(out_a), static_cast<int*>(out_b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcamv_fullpel_parts(
    const void* cur, int cur_w, const void* ref, int ref_w,
    const void* pred, const void* bits, int bits_len, int rng, int lam,
    int mbh, int mbw, void* out_cost, void* out_idx, void* stream) {
  return launch<9>(cur, cur_w, ref, ref_w, pred, bits, bits_len, rng, lam,
                   mbh, mbw, out_cost, out_idx, stream);
}

extern "C" int pcamv_fullpel_search16(
    const void* cur, int cur_w, const void* ref, int ref_w,
    const void* bits, int bits_len, int rng, int lam, int mbh, int mbw,
    void* out_mv, void* out_cost, void* stream) {
  return launch<1>(cur, cur_w, ref, ref_w, nullptr, bits, bits_len, rng,
                   lam, mbh, mbw, out_mv, out_cost, stream);
}
