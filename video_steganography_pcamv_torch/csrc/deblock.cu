// In-loop deblocking filter, H.264 spec 8.7 (Hopper, sm_90a): the whole
// frame in one launch, edge parameters included.
//
// Replaces the TPU kernel deblock_frame_pallas
// (video_steganography_pcamv_tpu/ops/deblock_pallas.py:469): its
// per-MB parameter precompute (edge_params, :61), the pads, the wave
// loop (_run, :449, with the body from _make_kernel) and the uint8
// slices. Inputs: u8 planes y [16mbh][16mbw], u/v [8mbh][8mbw], filtered
// in place; per MB intra, skip, trans8 (null: none); per 4x4 nnz, mv and
// the L0 reference index ref4 (int32; ref4 null: all 0, one reference);
// the spec tables (alpha[76] | beta[76] | tc0[76][4], parsed
// from native/deblock_tables.inc by ops/deblock.py); the frame's qp and
// qpc, or under adaptive quantization per-MB qp and qpc maps (int32
// [mbh][mbw], the decoder-visible chain; null: the frame's), qp_thresh
// and the slice's alpha/beta offsets. An MB edge takes (qp[p] + qp[q] +
// 1) >> 1, and the inner edges' low-qp gate reads the MB's own qp. The result is
// bit-equal to deblock_frame_plain(edge_params(...)).
//
// Order. The reference filters MBs in raster order, each MB's vertical
// edges then its horizontal edges, writing up to 3 pixels into the left
// and top neighbours. MB (mx, my)'s vertical edges touch only its own
// rows and the left MB's columns 12-15. Its horizontal edges read and
// write the 4 rows above it, which MB (mx, my-1) and the left edge of MB
// (mx+1, my-1) (columns 16mx+13..15) write last. So they may run once
// row my-1 has finished MB mx and the vertical edges of MB mx+1: the
// knight dependency of the reference's waves d = mx + 2*my, at half-MB
// grain. The critical path is mbw + 2(mbh-1) MB steps (254 at 1080p).
//
// Design: one thread block (CTA) per MB row, persistent over the row.
// - A CTA takes its row as a ticket from an atomic counter, so rows go
//   to CTAs in the order the CTAs start: a CTA only ever waits on a row
//   held by a CTA that started before it, which cannot deadlock for any
//   mbh, however many CTAs the card holds at once.
// - Warps 2-3 compute the 128-value edge_params row of every MB of the
//   row into shared memory (one lane per (dir, edge, 4-line group), the
//   layout of ops/deblock.py) and flag each MB ready; they depend on no
//   pixel, so they run ahead of the filter.
// - Warp 0 filters the row's luma, warp 1 its chroma: the two planes'
//   filters are independent, so they are two chains, each with its own
//   progress counters, and neither waits on the other. A warp filters
//   the MBs left to right, a line per lane in registers (lanes 0-15:
//   the 16 luma lines, or the 2 x 8 chroma lines), the MB's own rows
//   prefetched during the previous MB, the left 4 samples of each line
//   carried over from it. Per MB: wait for its parameters; filter the
//   vertical edges along the rows; store the left MB's columns they
//   changed and publish the row's progress counter (MBs 0..mx-1
//   complete, MB mx's vertical edges stored); wait for the row above's
//   counter to reach min(mx+1, mbw) and load the top 4 rows (unless
//   they were prefetched, when the row above was already far enough
//   ahead); prefetch the next MB's rows; transpose through shared
//   memory and filter the horizontal edges along the columns; store the
//   MB's rows and the changed top rows.
// - Memory ordering: every lane fences (__threadfence) its stores and,
//   after __syncwarp(), lane 0 stores the row's counter; the reader polls
//   it with acquire loads and reads the rows above with ld.global.cg
//   (L2, not the SM's L1, which may hold stale lines of pixels another
//   SM wrote).
// - No border: frame-edge MB edges are off in their parameters (active
//   = 0 for mx == 0 / my == 0) and tile loads and stores stay inside the
//   planes.
// What bounds it: the latency of the 254-step chain (a step is an MB's
// 8 dependent edge filters on one warp and, between rows, a cross-SM
// handoff and the load of the rows above), not its bytes (~6 MB of u8
// planes and maps at 1080p).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return max(lo, min(v, hi));
}

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// One luma line across an edge: s[0..7] = p3 p2 p1 p0 q0 q1 q2 q3,
// updated in place (p2..q2).
__device__ __forceinline__ void luma_line(int* s, int a, int b, int tc0,
                                          int bs, bool strong) {
  const int p3 = s[0], p2 = s[1], p1 = s[2], p0 = s[3];
  const int q0 = s[4], q1 = s[5], q2 = s[6], q3 = s[7];
  const bool base = abs(p0 - q0) < a && abs(p1 - p0) < b &&
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
__device__ __forceinline__ void chroma_line(int* s, int a, int b, int tc0,
                                            int bs, bool strong) {
  const int p1 = s[0], p0 = s[1], q0 = s[2], q1 = s[3];
  const bool base = abs(p0 - q0) < a && abs(p1 - p0) < b &&
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

constexpr int kThreads = 128;       // warps 0-1 filter, warps 2-3 parameters
constexpr int kFilterWarps = 2;     // luma, chroma
constexpr int kParamWarps = 2;
constexpr int kTabs = 76 * 6;       // alpha[76] | beta[76] | tc0[76][4]
constexpr int kSpinLimit = 1 << 28;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

struct Frame {
  const int* intra;
  const int* skip;
  const int* trans8;                // may be null
  const int* nnz4;
  const int* mv4;
  const int* ref4;                  // may be null (all 0)
  const int* qp_map;                // per-MB qp, or null: qp everywhere
  const int* qpc_map;               // per-MB chroma qp, or null: qpc
  int qp, qpc, qp_thresh, off_a, off_b, mbh, mbw;
};

// An MB's qp from its map (adaptive quantization) or the frame's; a value
// outside the spec's tables traps.
__device__ __forceinline__ int mb_qp(const int* map, int q, int mb) {
  if (map == nullptr) return q;
  const int v = map[mb];
  if (v < 0 || v > 51) __trap();
  return v;
}

// One lane's share of edge_params' row for MB (mx, my): lane = dir*16 +
// e*4 + g (dir 0 = vertical edges, e the edge, g the 4-line group).
// Layout (ops/deblock.py): 0:8 alpha_l [d*4+e] | 8:16 beta_l | 16:24
// active_l | 24:26 strong [d] | 32:64 bs_l [d*16+e*4+g] | 64:96 tc0_l |
// 96:100 alpha_c [d*2+ei] | 100:104 beta_c | 104:108 active_c | 108:124
// tc0_c [d*8+ei*4+g]. Every value fits a byte.
__device__ void edge_params_lane(uint8_t* prm, const Frame& f,
                                 const int* tab, int mx, int my, int lane) {
  const int d = lane >> 4, e = (lane >> 2) & 3, g = lane & 3;
  const int w4 = 4 * f.mbw;
  const int mb = my * f.mbw + mx;
  // q: the edge's own 4x4; p: the one before it (left / top), in the
  // neighbour MB for e == 0, zeros where that MB does not exist
  int qy, qx, py, px;
  if (d == 0) {
    qy = py = 4 * my + g;
    qx = 4 * mx + e;
    px = qx - 1;
  } else {
    qy = 4 * my + e;
    qx = px = 4 * mx + g;
    py = qy - 1;
  }
  const bool has_nb = d == 0 ? mx > 0 : my > 0;
  const bool p_in = e > 0 || has_nb;
  const int qi = qy * w4 + qx, pi = py * w4 + px;
  const int qn = f.nnz4[qi];
  const int qmx = f.mv4[2 * qi], qmy = f.mv4[2 * qi + 1];
  const int pn = p_in ? f.nnz4[pi] : 0;
  const int pmx = p_in ? f.mv4[2 * pi] : 0;
  const int pmy = p_in ? f.mv4[2 * pi + 1] : 0;
  const int qr = f.ref4 ? f.ref4[qi] : 0;
  const int pr = f.ref4 && p_in ? f.ref4[pi] : 0;
  const bool cur_i = f.intra[mb] > 0;
  const bool nb_i = has_nb && f.intra[d == 0 ? mb - 1 : mb - f.mbw] > 0;
  int bs = (qn > 0 || pn > 0) ? 2 : 0;
  if (bs == 0 && (abs(qmx - pmx) >= 4 || abs(qmy - pmy) >= 4 || qr != pr))
    bs = 1;
  if (e == 0 ? (cur_i || nb_i) : cur_i) bs = 3;

  // the MB edge averages the two MBs' qp (the neighbour's reads as 0
  // where it does not exist, as the reference's shifted grids do); under
  // per-MB maps each MB brings its own
  const int nbm = d == 0 ? mb - 1 : mb - f.mbw;
  const int qp_q = mb_qp(f.qp_map, f.qp, mb);
  const int qp_p = has_nb ? mb_qp(f.qp_map, f.qp, nbm) : 0;
  const int eq = e == 0 ? (qp_p + qp_q + 1) >> 1 : qp_q;
  const int ia = eq + f.off_a + 12;
  const int a_e = tab[ia];
  const int b_e = tab[76 + eq + f.off_b + 12];
  const bool gate = e == 0 ? has_nb
                           : (f.skip[mb] <= 0 && qp_q > f.qp_thresh);
  const bool act = gate && a_e > 0 && b_e > 0;
  const bool t8 = f.trans8 != nullptr && f.trans8[mb] > 0;
  const int bsc = min(bs, 3);
  prm[32 + lane] = (uint8_t)bs;
  prm[64 + lane] = (uint8_t)tab[152 + 4 * ia + bsc];
  if (g == 0) {
    prm[d * 4 + e] = (uint8_t)a_e;
    prm[8 + d * 4 + e] = (uint8_t)b_e;
    prm[16 + d * 4 + e] = (uint8_t)(act && !((e & 1) && t8));
    if (e == 0) prm[24 + d] = (uint8_t)(cur_i || nb_i);
  }
  if ((e & 1) == 0) {
    const int ei = e >> 1;
    const int qpc_q = mb_qp(f.qpc_map, f.qpc, mb);
    const int qpc_p = has_nb ? mb_qp(f.qpc_map, f.qpc, nbm) : 0;
    const int eqc = e == 0 ? (qpc_p + qpc_q + 1) >> 1 : qpc_q;
    const int iac = eqc + f.off_a + 12;
    prm[108 + d * 8 + ei * 4 + g] = (uint8_t)tab[152 + 4 * iac + bsc];
    if (g == 0) {
      prm[96 + d * 2 + ei] = (uint8_t)tab[iac];
      prm[100 + d * 2 + ei] = (uint8_t)tab[76 + eqc + f.off_b + 12];
      prm[104 + d * 2 + ei] = (uint8_t)act;
    }
  }
}

// The 4 luma edges of direction dir (0: vertical) across one line of 20
// samples in registers (v[4] is the MB's first sample; edge e sits
// between v[4e+3] and v[4e+4]), in order; g is the line's 4-line group.
__device__ __forceinline__ void luma_edges(int (&v)[20], int dir, int g,
                                           const uint8_t* prm) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (prm[16 + dir * 4 + e] == 0) continue;
    luma_line(v + 4 * e, prm[dir * 4 + e], prm[8 + dir * 4 + e],
              prm[64 + dir * 16 + e * 4 + g], prm[32 + dir * 16 + e * 4 + g],
              e == 0 && prm[24 + dir] > 0);
  }
}

// The chroma edges 0 and 2 of direction dir across one line of 12
// samples in registers (v[4] is the MB's first sample).
__device__ __forceinline__ void chroma_edges(int (&v)[20], int dir, int g,
                                             const uint8_t* prm) {
#pragma unroll
  for (int ei = 0; ei < 2; ++ei) {
    if (prm[104 + dir * 2 + ei] == 0) continue;
    chroma_line(v + 2 + 4 * ei, prm[96 + dir * 2 + ei],
                prm[100 + dir * 2 + ei], prm[108 + dir * 8 + ei * 4 + g],
                prm[32 + dir * 16 + 2 * ei * 4 + g],
                ei == 0 && prm[24 + dir] > 0);
  }
}

__device__ __forceinline__ void unpack_bytes(int* v, uint32_t w) {
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = (w >> (8 * c)) & 0xff;
}

__device__ __forceinline__ uint32_t pack_bytes(const int* v) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
         ((uint32_t)v[3] << 24);
}

__global__ void __launch_bounds__(kThreads)
deblock_rows_kernel(uint8_t* __restrict__ yp, uint8_t* __restrict__ up,
                    uint8_t* __restrict__ vp, Frame f,
                    const int* __restrict__ tabs, int* __restrict__ sync) {
  // prm [mbw][128] | ready [mbw]
  extern __shared__ __align__(16) uint8_t s_dyn[];
  __shared__ int s_tab[kTabs];
  // the transpose between the vertical and horizontal edges, rows
  // padded by one word against bank conflicts
  __shared__ int ty[20][21];
  __shared__ int tc[2][12][13];
  __shared__ int s_row;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int mbw = f.mbw;
  uint8_t* prm_all = s_dyn;
  int* ready = reinterpret_cast<int*>(s_dyn + 128 * mbw);
  if (t == 0) s_row = atomicAdd(sync, 1);   // the ticket
  for (int i = t; i < kTabs; i += kThreads) s_tab[i] = tabs[i];
  for (int i = t; i < mbw; i += kThreads) ready[i] = 0;
  __syncthreads();
  const int my = s_row;

  if (warp >= kFilterWarps) {
    for (int mx = warp - kFilterWarps; mx < mbw; mx += kParamWarps) {
      edge_params_lane(prm_all + 128 * mx, f, s_tab, mx, my, lane);
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        reinterpret_cast<volatile int*>(ready)[mx] = 1;
      }
    }
    return;
  }

  // Warp 0 filters luma, warp 1 chroma: two independent chains, each
  // with its own progress counters (sync[1 + my] luma, sync[1 + mbh +
  // my] chroma). Lanes 0-15 own a line of the tile: luma line 4+lane;
  // chroma line 4+cl of plane cp. Top rows (the row above) are loaded
  // by lanes 0-3 (luma row tr) or 0-7 (chroma row tr of plane lane/4).
  const bool luma = warp == 0;
  int* progress = sync + 1 + (luma ? 0 : f.mbh);
  const bool own = lane < 16;
  const bool ltop = luma ? lane < 4 : lane < 8;
  const int cp = (lane >> 3) & 1;
  const int cl = lane & 7, tr = lane & 3;
  const int wy = 16 * mbw, wc = 8 * mbw;
  uint8_t* cplane = cp ? vp : up;
  int v[20];                      // this lane's line; v[0..3] carried over
  int w[20];                      // its column, for the horizontal edges
  uint4 nxt = make_uint4(0, 0, 0, 0);   // the next MB's own row
  uint4 top = make_uint4(0, 0, 0, 0);   // a top row
  // the lane's own row / top row of MB mx in device memory
  auto own_row = [&](int mx) -> uint8_t* {
    return luma ? yp + (size_t)(16 * my + lane) * wy + 16 * mx
                : cplane + (size_t)(8 * my + cl) * wc + 8 * mx;
  };
  auto top_row = [&](int mx) -> uint8_t* {
    return luma ? yp + (size_t)(16 * my - 4 + tr) * wy + 16 * mx
                : (((lane >> 2) & 1) ? vp : up) +
                      (size_t)(8 * my - 4 + tr) * wc + 8 * mx;
  };
  // issue the loads of MB mx's own rows and (with `with_top`) top rows
  auto fetch = [&](int mx, bool with_own, bool with_top) {
    if (with_own && own) {
      if (luma) {
        nxt = __ldcg(reinterpret_cast<const uint4*>(own_row(mx)));
      } else {
        const uint2 c = __ldcg(reinterpret_cast<const uint2*>(own_row(mx)));
        nxt.x = c.x;
        nxt.y = c.y;
      }
    }
    if (with_top && my > 0 && ltop) {
      if (luma) {
        top = __ldcg(reinterpret_cast<const uint4*>(top_row(mx)));
      } else {
        const uint2 c = __ldcg(reinterpret_cast<const uint2*>(top_row(mx)));
        top.x = c.x;
        top.y = c.y;
      }
    }
  };
  // MBs 0 .. done-1 of this row are in device memory: every lane fences
  // its own stores, then lane 0 publishes the count
  auto publish = [&](int done) {
    __threadfence();
    __syncwarp();
    if (lane == 0) st_relaxed(progress + my, done);
  };
#pragma unroll
  for (int c = 0; c < 20; ++c) v[c] = 0;

  int seen = 0;                   // the row above's progress, last read
  bool have_top = my == 0;        // `top` holds this MB's top row
  fetch(0, true, false);
  for (int mx = 0; mx < mbw; ++mx) {
    // a wait that outlasts kSpinLimit sleeps (seconds) is a fault: trap
    for (int n = 0; reinterpret_cast<volatile int*>(ready)[mx] == 0; ++n)
      if (n > kSpinLimit) __trap();
    __threadfence_block();
    const uint8_t* prm = prm_all + 128 * mx;
    // the top rows may be read once the row above has published
    // min(mx+1, mbw): its MB mx complete and MB mx+1's vertical edges,
    // which write columns 16mx+13..15, done. Poll now, look later.
    const int need = min(mx + 1, mbw);
    int polled = seen;
    if (!have_top && seen < need) polled = ld_acquire(progress + my - 1);

    // vertical edges, in registers: they need nothing of the row above;
    // then the left MB's columns 12-15 (chroma 4-7), which the left edge
    // changed, go to device memory and the line to the transpose tile
    if (own) {
      unpack_bytes(v + 4, nxt.x);
      unpack_bytes(v + 8, nxt.y);
      if (luma) {
        unpack_bytes(v + 12, nxt.z);
        unpack_bytes(v + 16, nxt.w);
        luma_edges(v, 0, lane >> 2, prm);
#pragma unroll
        for (int c = 4; c < 20; ++c) ty[4 + lane][c] = v[c];
      } else {
        chroma_edges(v, 0, cl >> 1, prm);
#pragma unroll
        for (int c = 4; c < 12; ++c) tc[cp][4 + cl][c] = v[c];
      }
      if (mx > 0)
        *reinterpret_cast<uint32_t*>(own_row(mx) - 4) = pack_bytes(v);
    }
    // MBs 0 .. mx-1 complete, MB mx's vertical edges stored
    if (mx > 0) publish(mx);

    // the top rows
    if (!have_top) {
      seen = max(seen, polled);
      for (int n = 0; seen < need; ++n) {
        __nanosleep(32);
        seen = ld_acquire(progress + my - 1);
        if (n > kSpinLimit) __trap();
      }
      // every lane acquired at least the warp's minimum
      seen = __reduce_min_sync(0xffffffffu, seen);
      fetch(mx, false, true);
    }
    if (my > 0 && ltop) {
      int t[16];
      unpack_bytes(t, top.x);
      unpack_bytes(t + 4, top.y);
      if (luma) {
        unpack_bytes(t + 8, top.z);
        unpack_bytes(t + 12, top.w);
#pragma unroll
        for (int c = 0; c < 16; ++c) ty[tr][4 + c] = t[c];
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) tc[(lane >> 2) & 1][tr][4 + c] = t[c];
      }
    }
    // prefetch the next MB's own rows, and its top rows where the row
    // above is already far enough ahead; they land during this MB's
    // horizontal edges
    if (mx + 1 < mbw) {
      have_top = my == 0 || seen >= min(mx + 2, mbw);
      fetch(mx + 1, true, have_top);
    }
    __syncwarp();

    // horizontal edges, in registers, on the transposed tile
    if (own) {
      if (luma) {
#pragma unroll
        for (int r = 0; r < 20; ++r) w[r] = ty[r][4 + lane];
        luma_edges(w, 1, lane >> 2, prm);
#pragma unroll
        for (int r = 1; r < 19; ++r) ty[r][4 + lane] = w[r];
      } else {
#pragma unroll
        for (int r = 0; r < 12; ++r) w[r] = tc[cp][r][4 + cl];
        chroma_edges(w, 1, cl >> 1, prm);
        tc[cp][3][4 + cl] = w[3];
        tc[cp][4][4 + cl] = w[4];
        tc[cp][7][4 + cl] = w[7];
        tc[cp][8][4 + cl] = w[8];
      }
    }
    __syncwarp();

    // store the MB's own rows and the top rows the filter changed (luma
    // 1-3, chroma 3); carry columns 16-19 (8-11) over as the next MB's
    // columns 0-3
    if (own) {
      if (luma) {
#pragma unroll
        for (int c = 4; c < 20; ++c) v[c] = ty[4 + lane][c];
        *reinterpret_cast<uint4*>(own_row(mx)) =
            make_uint4(pack_bytes(v + 4), pack_bytes(v + 8),
                       pack_bytes(v + 12), pack_bytes(v + 16));
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = v[16 + c];
      } else {
#pragma unroll
        for (int c = 4; c < 12; ++c) v[c] = tc[cp][4 + cl][c];
        *reinterpret_cast<uint2*>(own_row(mx)) =
            make_uint2(pack_bytes(v + 4), pack_bytes(v + 8));
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = v[8 + c];
      }
    }
    if (my > 0 && ltop && (luma ? tr > 0 : tr == 3)) {
      int t[16];
      if (luma) {
#pragma unroll
        for (int c = 0; c < 16; ++c) t[c] = ty[tr][4 + c];
        *reinterpret_cast<uint4*>(top_row(mx)) =
            make_uint4(pack_bytes(t), pack_bytes(t + 4), pack_bytes(t + 8),
                       pack_bytes(t + 12));
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) t[c] = tc[(lane >> 2) & 1][3][4 + c];
        *reinterpret_cast<uint2*>(top_row(mx)) =
            make_uint2(pack_bytes(t), pack_bytes(t + 4));
      }
    }
    __syncwarp();
  }
  publish(mbw);
}

}  // namespace

extern "C" int pcamv_deblock_frame(
    const void* y_in, const void* u_in, const void* v_in, void* y, void* u,
    void* v, const void* intra, const void* skip, const void* trans8,
    const void* nnz4, const void* mv4, const void* ref4, const void* qp_map,
    const void* qpc_map, const void* tabs, int qp, int qpc, int qp_thresh, int off_a, int off_b, int mbh, int mbw,
    void* sync, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ny = (size_t)256 * mbh * mbw, nc = ny / 4;
  const void* src[3] = {y_in, u_in, v_in};
  void* dst[3] = {y, u, v};
  for (int i = 0; i < 3; ++i) {
    if (src[i] == dst[i]) continue;
    const cudaError_t err = cudaMemcpyAsync(
        dst[i], src[i], i ? nc : ny, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err =
      cudaMemsetAsync(sync, 0, sizeof(int) * (2 * mbh + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (128 + 4) * mbw;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(deblock_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Frame f{static_cast<const int*>(intra), static_cast<const int*>(skip),
          static_cast<const int*>(trans8), static_cast<const int*>(nnz4),
          static_cast<const int*>(mv4), static_cast<const int*>(ref4),
          static_cast<const int*>(qp_map), static_cast<const int*>(qpc_map),
          qp, qpc, qp_thresh, off_a, off_b, mbh, mbw};
  deblock_rows_kernel<<<mbh, kThreads, smem, st>>>(
      static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
      static_cast<uint8_t*>(v), f, static_cast<const int*>(tabs),
      static_cast<int*>(sync));
  return static_cast<int>(cudaGetLastError());
}

// How many of the kernel's CTAs the card holds at once for a row of mbw
// MBs (CTAs per SM x SMs); a frame with more MB rows has CTAs that start
// only after others have finished.
extern "C" int pcamv_deblock_resident_ctas(int mbw) {
  const int smem = (128 + 4) * mbw;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(deblock_rows_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int per_sm = 0, dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, deblock_rows_kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

namespace {

// Two CTAs on two SMs (each asks for more than half an SM's shared
// memory) pass a counter back and forth `rounds` times with the
// deblocker's handoff: fence + store, acquire spin with __nanosleep.
// Its time over 2 * rounds is one cross-SM handoff, the unit of the
// deblocker's latency bound.
__global__ void handoff_pingpong_kernel(int* flag, int rounds) {
  extern __shared__ uint8_t s_pad[];
  if (threadIdx.x != 0) return;
  s_pad[0] = 0;
  const int me = blockIdx.x;
  for (int i = 0; i < rounds; ++i) {
    const int want = 2 * i + me;
    for (int n = 0; ld_acquire(flag) < want; ++n) {
      if (n > kSpinLimit) __trap();
      __nanosleep(32);
    }
    __threadfence();
    st_relaxed(flag, want + 1);
  }
}

}  // namespace

extern "C" int pcamv_handoff_pingpong(void* flag, int rounds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 160 * 1024;
  cudaError_t err = cudaFuncSetAttribute(
      handoff_pingpong_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(flag, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  handoff_pingpong_kernel<<<2, 32, smem, st>>>(static_cast<int*>(flag),
                                               rounds);
  return static_cast<int>(cudaGetLastError());
}
