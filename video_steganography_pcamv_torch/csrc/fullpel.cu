// Full-pel motion search (Hopper, sm_90a), as packed-byte SAD: two
// entry points over one kernel template and a third, sub-8x8 kernel;
// the two kernels share their staging of the MB and the window and
// their two-level minimum (the device helpers below).
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
// pcamv_fullpel_sub serves the sub-8x8 analysis' search
// (video_steganography_pcamv_tpu/encoder/partition.py:896,
// fullpel_search_sub, plain jnp in the reference: no TPU kernel). It
// keeps the sixteen 4x4 SADs of every displacement and forms 41 units:
// B1's 9, then per 8x8 block (z-order) its two 8x4 (top, bottom), its
// two 4x8 (left, right) and its four 4x4 (z-order), each against the
// MB's predictor as above. Its CTA walks its (dx group, dy) items in a
// loop (one dy an item, at most 256 threads), so that the 64 sums of an
// item and the 41 running minima stay in registers.
//
// pcamv_fullpel_search16 replaces the TPU kernel fullpel_search_pallas
// (pallas_kernels.py:549, kernel _fullpel_kernel :42): the 16x16 unit
// alone against a zero predictor, written as (mv, cost). Its template
// instance keeps one running minimum instead of nine. The lowres
// lookahead check entry (B10, slicetype.lowres_costs_kernel) runs
// pcamv_fullpel_parts.
//
// The winner per unit is the FIRST strict-< minimum in dy-outer,
// dx-inner scan order: the block reduction takes the minimum of the
// 32-bit key (cost << 12 | scan index), with scan index dyo * side + dxo
// whatever thread computed it. The wrapper holds the key exact: rng <=
// PAD 24 keeps the index below 2^12, and it refuses a lam for which a
// cost (at most 16 x 16 x 255 + lam x twice the table's largest bit
// count) could reach 2^20.
//
// Inputs: cur int32 (8-bit samples, packed to bytes while loading) and
// the PAD-padded reference plane as uint8.
//
// What bounds it: per MB and displacement 256 absolute differences (a
// 1080p frame at rng 16: 8160 x 1089 x 256 = 2.27 G). Design: one CTA
// per MB; the current MB sits in shared memory as 64 words of four
// pixels (packed from int32 while loading), the (16+2rng)^2 window as
// bytes (2.3 KB at rng 16). A thread owns four consecutive dx of two
// consecutive dy: ceil(side/4) * ceil(side/2) threads, one item each,
// so only the last warp has idle lanes (153 of 160 lanes at rng 16).
// It walks the 17 window rows its two dy need; each row's five window
// words are loaded once, aligned for its four dx with three funnel
// shifts each, and serve MB row t of the first dy and t - 1 of the
// second. Every four byte differences take one VABSDIFF4 that also adds
// them into the running quadrant sum (at most 64 x 255, so quadrant
// costs stay exact). Per thread at rng 16, in the SASS of the 9-unit
// instance: 512 VABSDIFF4 for its 2048 absolute differences, 215 SHF and
// 131 LDS of window and row traffic, of 1672 instructions in all. The
// per-thread minima over its 8 displacements then reduce across the CTA
// with warp shuffles and one shared-memory pass, one 32-bit min a step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 24;       // full-pel border of the reference plane

constexpr int kDy = 2;         // consecutive dy per thread
constexpr int kIdxBits = 12;   // scan index bits of a key (side^2 <= 4096)

// |a - b| summed over the four bytes, added to acc: one VABSDIFF4 with
// accumulate in the SASS (__vabsdiffu4 + __dp4a and __vsadu4 + add take
// two instructions)
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// The MB (my, mx) of cur packed to bytes: s_cur[r] holds its row r as
// four words of four pixels.
__device__ __forceinline__ void stage_cur(const int* __restrict__ cur,
                                          int cur_w, int my, int mx,
                                          uint4* s_cur) {
  for (int t = threadIdx.x; t < 64; t += blockDim.x) {
    const int4 v = *reinterpret_cast<const int4*>(
        cur + (16 * my + (t >> 2)) * cur_w + 16 * mx + 4 * (t & 3));
    reinterpret_cast<unsigned*>(s_cur)[t] =
        static_cast<unsigned>(v.x) | static_cast<unsigned>(v.y) << 8 |
        static_cast<unsigned>(v.z) << 16 | static_cast<unsigned>(v.w) << 24;
  }
}

// The search window of the MB, rows x nw words: word k of row r holds
// columns 4k..4k+3 of the window at (wy0, wx0). Rows past ws - 1 and
// words past column ws - 1 only feed dy or dx >= side, whose results
// are dropped, and are written as 0. Aligned 32-bit loads (rows start
// 4-aligned): the word after is read only when one of its bytes is a
// used column, and then it lies inside the row.
__device__ __forceinline__ void stage_window(const uint8_t* __restrict__ ref,
                                             int ref_w, int wy0, int wx0,
                                             int ws, int rows, int nw,
                                             unsigned* s_win) {
  for (int t = threadIdx.x; t < rows * nw; t += blockDim.x) {
    const int r = t / nw;
    const int k = t - r * nw;
    unsigned word = 0;
    if (4 * k < ws && r < ws) {
      const uint8_t* p = ref + static_cast<size_t>(wy0 + r) * ref_w + wx0 +
                         4 * k;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
      const unsigned* a = reinterpret_cast<const unsigned*>(p - sh);
      const unsigned lo = __ldg(a);
      const unsigned hi = (sh != 0 && 4 * k + 4 - sh < ws) ? __ldg(a + 1)
                                                           : 0u;
      word = __funnelshift_r(lo, hi, 8 * sh);
    }
    s_win[t] = word;
  }
}

// First level of the CTA's minimum of every unit's key: each warp's
// minimum by shuffles into s_red[warp * kU + u], then a barrier.
template <int kU>
__device__ __forceinline__ void warp_mins(const unsigned (&best)[kU],
                                          unsigned* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    unsigned v = best[u];
    for (int o = 16; o > 0; o >>= 1) {
      v = min(v, __shfl_down_sync(0xffffffffu, v, o));
    }
    if (lane == 0) s_red[warp * kU + u] = v;
  }
  __syncthreads();
}

// Second level: the CTA's minimum key of unit u over the warps' minima.
template <int kU>
__device__ __forceinline__ unsigned cta_min(const unsigned* s_red, int u) {
  unsigned v = ~0u;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) v = min(v, s_red[w * kU + u]);
  return v;
}

// kUnits 9: all partition units, out_a = cost [n, 9], out_b = scan
// index [n, 9]. kUnits 1: the 16x16 unit, out_a = mv [n, 2] (x, y),
// out_b = cost [n]. pred == nullptr is the zero predictor.
template <int kUnits>
__global__ void fullpel_kernel(
    const int* __restrict__ cur, int cur_w,
    const uint8_t* __restrict__ ref, int ref_w,
    const int* __restrict__ pred, const int* __restrict__ bits,
    int bits_len, int rng, int lam, int mbw,
    int* __restrict__ out_a, int* __restrict__ out_b) {
  extern __shared__ uint4 smem[];
  const int side = 2 * rng + 1;
  const int ws = 16 + 2 * rng;          // window rows and used columns
  const int groups = (side + 3) >> 2;   // dx groups of four
  const int dy_sets = (side + kDy - 1) / kDy;
  const int rows = kDy * dy_sets + 15;  // window rows held (>= ws)
  const int nw = groups + 4;            // words per window row
  uint4* s_cur = smem;                  // 16 rows x 4 packed words
  unsigned* s_win = reinterpret_cast<unsigned*>(smem + 16);
  unsigned* s_red = s_win + rows * nw;

  const int mb = blockIdx.x;
  const int my = mb / mbw;
  const int mx = mb - my * mbw;
  const int tid = threadIdx.x;

  stage_cur(cur, cur_w, my, mx, s_cur);
  stage_window(ref, ref_w, kPad + 16 * my - rng, kPad + 16 * mx - rng, ws,
               rows, nw, s_win);
  __syncthreads();

  // a thread owns dx group grp (4 dx) of kDy consecutive dy from dyo0
  const int grp = tid % groups;
  const int dyo0 = (tid / groups) * kDy;  // dy + rng of its first dy
  unsigned q[kDy][4][4];                  // [dy][dx in group][quadrant]
  if (dyo0 < side) {
    const unsigned* w = s_win + dyo0 * nw + grp;
    unsigned al[kDy][4], ar[kDy][4];
#pragma unroll
    for (int j = 0; j < kDy; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) al[j][k] = ar[j][k] = 0;
    }
    // window row t serves MB row t - j of the j-th dy
#pragma unroll
    for (int t = 0; t < 15 + kDy; ++t) {
      const unsigned* wr = w + t * nw;
      const unsigned w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3],
                     w4 = wr[4];
      unsigned x[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k][0] = k ? __funnelshift_r(w0, w1, 8 * k) : w0;
        x[k][1] = k ? __funnelshift_r(w1, w2, 8 * k) : w1;
        x[k][2] = k ? __funnelshift_r(w2, w3, 8 * k) : w2;
        x[k][3] = k ? __funnelshift_r(w3, w4, 8 * k) : w3;
      }
#pragma unroll
      for (int j = 0; j < kDy; ++j) {
        const int r = t - j;
        if (r < 0 || r > 15) continue;
        const uint4 c = s_cur[r];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          al[j][k] = sad4(c.y, x[k][1], sad4(c.x, x[k][0], al[j][k]));
          ar[j][k] = sad4(c.w, x[k][3], sad4(c.z, x[k][2], ar[j][k]));
        }
        if (r == 7 || r == 15) {
          const int h = r == 7 ? 0 : 2;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            q[j][k][h] = al[j][k];
            q[j][k][h + 1] = ar[j][k];
            al[j][k] = ar[j][k] = 0;
          }
        }
      }
    }
  }

  const int pmx = pred ? pred[2 * mb] : 0;
  const int pmy = pred ? pred[2 * mb + 1] : 0;
  const int off = (bits_len - 1) / 2;
  unsigned best[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) best[u] = ~0u;
  int bx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ix = min(max(4 * (4 * grp + k - rng) - 4 * pmx + off, 0),
                       bits_len - 1);
    bx[k] = __ldg(bits + ix);
  }
#pragma unroll
  for (int j = 0; j < kDy; ++j) {
    const int dyo = dyo0 + j;           // dy + rng
    if (dyo >= side) continue;
    const int iy = min(max(4 * (dyo - rng) - 4 * pmy + off, 0),
                       bits_len - 1);
    const int by = __ldg(bits + iy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dxo = 4 * grp + k;        // dx + rng
      if (dxo >= side) continue;
      const int mvc = (bx[k] + by) * lam;
      const int q0 = q[j][k][0], q1 = q[j][k][1], q2 = q[j][k][2],
                q3 = q[j][k][3];
      const int all9[9] = {
          q0 + q1 + q2 + q3 + mvc,
          q0 + q1 + mvc, q2 + q3 + mvc,
          q0 + q2 + mvc, q1 + q3 + mvc,
          q0 + mvc, q1 + mvc, q2 + mvc, q3 + mvc};
      const unsigned i = static_cast<unsigned>(dyo * side + dxo);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        best[u] = min(best[u], static_cast<unsigned>(all9[u]) << kIdxBits |
                                   i);
      }
    }
  }

  warp_mins<kUnits>(best, s_red);
  if (tid < kUnits) {
    const unsigned v = cta_min<kUnits>(s_red, tid);
    const int cost = static_cast<int>(v >> kIdxBits);
    const int idx = static_cast<int>(v & ((1u << kIdxBits) - 1));
    if constexpr (kUnits == 1) {
      const int dyw = idx / side;
      out_a[2 * mb] = idx - dyw * side - rng;
      out_a[2 * mb + 1] = dyw - rng;
      out_b[mb] = cost;
    } else {
      out_a[mb * kUnits + tid] = cost;
      out_b[mb * kUnits + tid] = idx;
    }
  }
}

// The sub-8x8 kernel: out_cost / out_idx [n, 41], unit order as in the
// header. It shares the 9-unit kernel's staging and two-level minimum;
// an item is one dx group of one dy: its 16 MB rows accumulate the four
// 4x4 column sums of each of its four dx, banked every four rows into
// s[dx][4 x band + column].
constexpr int kSubUnits = 41;
constexpr int kSubThreads = 256;

__global__ void __launch_bounds__(kSubThreads) fullpel_sub_kernel(
    const int* __restrict__ cur, int cur_w,
    const uint8_t* __restrict__ ref, int ref_w,
    const int* __restrict__ pred, const int* __restrict__ bits,
    int bits_len, int rng, int lam, int mbw,
    int* __restrict__ out_cost, int* __restrict__ out_idx) {
  extern __shared__ uint4 smem[];
  const int side = 2 * rng + 1;
  const int ws = 16 + 2 * rng;
  const int groups = (side + 3) >> 2;
  const int nw = groups + 4;
  uint4* s_cur = smem;
  unsigned* s_win = reinterpret_cast<unsigned*>(smem + 16);
  unsigned* s_red = s_win + ws * nw;

  const int mb = blockIdx.x;
  const int my = mb / mbw;
  const int mx = mb - my * mbw;
  const int tid = threadIdx.x;

  stage_cur(cur, cur_w, my, mx, s_cur);
  stage_window(ref, ref_w, kPad + 16 * my - rng, kPad + 16 * mx - rng, ws,
               ws, nw, s_win);
  __syncthreads();

  const int pmx = pred[2 * mb];
  const int pmy = pred[2 * mb + 1];
  const int off = (bits_len - 1) / 2;
  unsigned best[kSubUnits];
#pragma unroll
  for (int u = 0; u < kSubUnits; ++u) best[u] = ~0u;
  for (int it = tid; it < groups * side; it += blockDim.x) {
    const int grp = it % groups;
    const int dyo = it / groups;        // dy + rng
    const unsigned* w = s_win + dyo * nw + grp;
    unsigned a[4][4], s[4][16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[k][c] = 0;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const unsigned* wr = w + r * nw;
      const unsigned w0 = wr[0], w1 = wr[1], w2 = wr[2], w3 = wr[3],
                     w4 = wr[4];
      const uint4 c = s_cur[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k][0] = sad4(c.x, k ? __funnelshift_r(w0, w1, 8 * k) : w0, a[k][0]);
        a[k][1] = sad4(c.y, k ? __funnelshift_r(w1, w2, 8 * k) : w1, a[k][1]);
        a[k][2] = sad4(c.z, k ? __funnelshift_r(w2, w3, 8 * k) : w2, a[k][2]);
        a[k][3] = sad4(c.w, k ? __funnelshift_r(w3, w4, 8 * k) : w3, a[k][3]);
      }
      if ((r & 3) == 3) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            s[k][4 * (r >> 2) + cc] = a[k][cc];
            a[k][cc] = 0;
          }
        }
      }
    }
    const int iy = min(max(4 * (dyo - rng) - 4 * pmy + off, 0),
                       bits_len - 1);
    const int by = __ldg(bits + iy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dxo = 4 * grp + k;      // dx + rng
      if (dxo >= side) continue;
      const int ix = min(max(4 * (dxo - rng) - 4 * pmx + off, 0),
                         bits_len - 1);
      const int mvc = (__ldg(bits + ix) + by) * lam;
      // q[b][j]: the 4x4 SAD of 8x8 block b, sub-block j (both z-order)
      int q[4][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int band = 2 * (b >> 1) + (j >> 1);
          const int col = 2 * (b & 1) + (j & 1);
          q[b][j] = static_cast<int>(s[k][4 * band + col]);
        }
      }
      int q8[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        q8[b] = q[b][0] + q[b][1] + q[b][2] + q[b][3];
      }
      int cost[kSubUnits];
      cost[0] = q8[0] + q8[1] + q8[2] + q8[3] + mvc;
      cost[1] = q8[0] + q8[1] + mvc;
      cost[2] = q8[2] + q8[3] + mvc;
      cost[3] = q8[0] + q8[2] + mvc;
      cost[4] = q8[1] + q8[3] + mvc;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        cost[5 + b] = q8[b] + mvc;
        cost[9 + 2 * b] = q[b][0] + q[b][1] + mvc;        // 8x4 top
        cost[10 + 2 * b] = q[b][2] + q[b][3] + mvc;       // 8x4 bottom
        cost[17 + 2 * b] = q[b][0] + q[b][2] + mvc;       // 4x8 left
        cost[18 + 2 * b] = q[b][1] + q[b][3] + mvc;       // 4x8 right
#pragma unroll
        for (int j = 0; j < 4; ++j) cost[25 + 4 * b + j] = q[b][j] + mvc;
      }
      const unsigned i = static_cast<unsigned>(dyo * side + dxo);
#pragma unroll
      for (int u = 0; u < kSubUnits; ++u) {
        best[u] = min(best[u], static_cast<unsigned>(cost[u]) << kIdxBits |
                                   i);
      }
    }
  }

  warp_mins<kSubUnits>(best, s_red);
  // a single warp (small rng) has fewer threads than units
  for (int u = tid; u < kSubUnits; u += blockDim.x) {
    const unsigned v = cta_min<kSubUnits>(s_red, u);
    out_cost[mb * kSubUnits + u] = static_cast<int>(v >> kIdxBits);
    out_idx[mb * kSubUnits + u] = static_cast<int>(v & ((1u << kIdxBits) - 1));
  }
}

template <int kUnits>
int launch(const void* cur, int cur_w, const void* ref, int ref_w,
           const void* pred, const void* bits, int bits_len, int rng,
           int lam, int mbh, int mbw, void* out_a, void* out_b,
           void* stream) {
  const int side = 2 * rng + 1;
  const int groups = (side + 3) / 4;
  const int dy_sets = (side + kDy - 1) / kDy;
  const int rows = kDy * dy_sets + 15;
  const int threads = (groups * dy_sets + 31) / 32 * 32;
  const size_t smem = 16 * sizeof(uint4)
      + (rows * (groups + 4) + (threads / 32) * kUnits) * sizeof(unsigned);
  fullpel_kernel<kUnits><<<mbh * mbw, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), cur_w, static_cast<const uint8_t*>(ref),
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

extern "C" int pcamv_fullpel_sub(
    const void* cur, int cur_w, const void* ref, int ref_w,
    const void* pred, const void* bits, int bits_len, int rng, int lam,
    int mbh, int mbw, void* out_cost, void* out_idx, void* stream) {
  const int side = 2 * rng + 1;
  const int items = ((side + 3) / 4) * side;
  // as few passes as 256 threads allow, the items spread evenly
  const int passes = (items + kSubThreads - 1) / kSubThreads;
  const int threads = ((items + passes - 1) / passes + 31) / 32 * 32;
  const size_t smem = 16 * sizeof(uint4)
      + ((16 + 2 * rng) * ((side + 3) / 4 + 4) + (threads / 32) * kSubUnits)
      * sizeof(unsigned);
  fullpel_sub_kernel<<<mbh * mbw, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cur), cur_w, static_cast<const uint8_t*>(ref),
      ref_w, static_cast<const int*>(pred), static_cast<const int*>(bits),
      bits_len, rng, lam, mbw, static_cast<int*>(out_cost),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
