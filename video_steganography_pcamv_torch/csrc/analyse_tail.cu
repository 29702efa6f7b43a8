// Kernels B3 (subpel refine) and B4 (RCA probe SATD maps), and the
// analyse tail that fuses them, with B2's qpel rows built inside
// (Hopper, sm_90a).
//
// Replaces the TPU kernels subpel_pallas and probe_maps_pallas
// (video_steganography_pcamv_tpu/ops/probe_pallas.py:301 and :481,
// bodies _subpel_kernel and _probe_kernel, run back to back by
// analyse_tail_pallas, :574), and builds the rows it reads of
// qpel_tables_pallas (:221) from the per-8x8 windows (qpel_rows.cuh).
// One template, three entries:
//   pcamv_subpel        B3 alone (stego off, B frames; its optional
//                       per-MB inter cost);
//   pcamv_analyse_tail  B3 -> B4 in one launch (every stego P path);
//   pcamv_probe_maps    B4 on given rows r_idx8 (the check entry: on no
//                       path).
//
// B3, for every 8x8 block and each of the 49 qpel offsets (oy, ox) in
// [-3, 3]^2 around its full-pel MV (oy outer, ox inner):
//   satd  = sum over the 4 sub-blocks of (sum |WHT(cur) - WHT(row)|) >> 1,
//           row the (oy, ox) average of the block's window;
//   cost  = satd summed over the block's partition unit (16x16: all four
//           blocks; 16x8: pairs (0,1),(2,3); 8x16: pairs (0,2),(1,3);
//           8x8: the block alone) + lam * (bits(se(dx)) + bits(se(dy))),
//           dx = clamp(4*mvx + ox - pred_x, -2048, 2048), likewise dy,
//           pred the MB's qpel predictor;
// keeps the FIRST minimum and writes r_idx8 (the table index (oy+6)*13 +
// (ox+6)) and mv8 = 4*mv + (ox, oy), N8 in spatial order, and, where
// mb_cost is not null, each MB's inter cost: every unit's minimum counted
// once, at the unit's first 8x8 (the reference's subpel_parts,
// partition.py:354-362).
//
// B4, for every 8x8 block (chosen offset r) and each of the 13 probe
// versions v (the centre, then the 12 D_MV deltas; centre c_v), on each
// 4x4 sub-block:
//   pred  = the row of offset r + c_v
//   lev   = quant4x4(dct4x4(cur - pred)) (the encoder's inter tables at
//           qp, qtab: its CQM list and inter deadzone)
//   score = x264 decimate score of lev in zigzag order (9 if |lev| > 1)
//   rec   = clip(pred + (idct4x4(dequant4x4(lev)) + 32) >> 6, 0, 255)
// and with L(d) the WHT row of offset r + d, over the 9 D_NB
// neighbours nb_k:
//   SK[v][k] = satd(WHT(rec), L(c_v + nb_k)),
//   SP[v][k] = satd(L(c_v), L(c_v + nb_k)),  sc8[v] = the scores summed
// (decimate off: SP = SK, sc8 = 0). Outputs SK/SP [13][9][n][4] and sc8
// [13][n][4] int32 with the z-order block axis b = 2*by + bx. r lies in
// the +-3 box (the check entry traps otherwise), so every row is in
// [-6, 6]^2.
//
// Design: one thread block per MB; 128 threads for B3 alone, 256 with
// B4. The MB's four 1 KB windows and its 16x16 cur (as bytes) are staged
// in shared memory once.
//   * The linear 4x4 maps run on the int8 tensor cores, exactly:
//     mma.m16n8k32 u8 x s8 -> s32. Every operand is 8-bit pixels (qpel
//     rows, cur, the clipped recon) and the 2-D WHT and core DCT are
//     16x16 integer matrices with entries in {+-1, +-2, +-4}
//     (tail_tables.inc). An A row is [x (16 px) | y (16 px)] and B is
//     [M; -M], so one product gives M x - M y = M (x - y) in int32: the
//     SATD's subtraction, and the residual cur - pred of the DCT, are
//     folded into the product. A lane's A register is one pixel row of a
//     4x4, four bytes: the qpel row builder's __vavgu4 word is the
//     fragment itself. A tile is 16 rows: 4 units (block b = the lane's
//     group / 2) x the 4 sub-blocks; each lane holds 8 coefficients,
//     takes their absolute values on the ALU, and three shuffles give
//     each block's SATD.
//   * B3: 49 tiles, one an offset; then one thread a (block, offset)
//     cost and a warp a block, whose first minimum is one redux.sync on
//     keys cost << 6 | offset (cost < 2^26: the wrapper bounds lam).
//   * B4: the 45 lattice rows around r are built once, as pixels, into
//     64-byte slots beside the 13 versions' recon slots (16 KB a MB);
//     a warp takes the next tile from a shared counter: a version's DCT
//     tile (quant, decimate mask and dequant in the fragment, then the
//     IDCT and recon a lane an item: the IDCT's >> 1 keeps them on the
//     ALU) or one of the 84 distinct SP pairs (SP[v][(0,0)] is 0 without
//     work); then the 117 SK tiles; the maps are staged in shared memory
//     and written as 16-byte rows.
// What bounds it: its integer work (the row builds, the SATDs' absolute
// values and sums, the probe chain), ahead of its reads of the windows
// (1 KB per 8x8, 33 MB a 1080p frame) and its 32 MB of maps; the tensor
// work is ~30 G int8 ops a frame, ~0.02 ms at the int8 rate. On the
// H100 (tools/tail_sections.py) the probe chain and the SP tiles take
// about half the time, the SK tiles a fifth, B3 a fifth.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qpel_rows.cuh"

namespace {

#include "tail_tables.inc"

constexpr int kOffsets = 49;
constexpr int kBox = 7;
constexpr int kSlots = kBox * kBox;
constexpr int kVersions = 13;
constexpr int kNbs = 9;
constexpr int kSkRows = kVersions * kNbs;       // 117 (v, k) rows
constexpr int kPairs = 84;                      // kSpPair's rows

// shared-memory layout: the MB's four windows staged side by side
// (qpel::win_base)
constexpr int kWin = qpel::kWinStride;
// Block b's pixel rows: 64-byte slots, sub-block s at 16*s and its pixel
// row at 4*row; slots 0-48 the lattice (delta (dy, dx) at (dy+3)*7 +
// dx+3), slots 49-61 the recon of each version. 4000 bytes = 1000 words,
// 8 mod 32, keep a tile's four blocks in distinct banks.
constexpr int kRecSlot = kSlots;
constexpr int kRows = 4000;
// a dequantized item: 16 int32 padded to 20
constexpr int kDeq = 20;

struct SearchSmem {
  __align__(16) uint8_t win[4 * kWin + 16];
  uint32_t cur[4][4][4];          // [b][s][row]: four pixels of cur
  uint32_t ph[169];               // phase-slice byte offsets a | b << 16
  int sat[4][kOffsets];
  int r[4][2];
  int best[4];
  int next;                       // the next probe tile to take
};

struct ProbeSmem : SearchSmem {
  __align__(16) uint8_t rows[4 * kRows];
  __align__(16) int deq[8][16][kDeq];     // a warp's DCT tile
  __align__(16) int maps[kSkRows + kPairs][4];
  __align__(16) int sc[kVersions][4];
};

template <bool kProbe>
struct Cfg {
  static constexpr int kThreads = kProbe ? 256 : 128;
  // blocks an SM: 5 for the probe instances (48 registers, 16 bytes
  // spilled) measured faster than 4 (64 registers, no spills)
  static constexpr int kMinBlocks = kProbe ? 5 : 8;
  using Smem = typename std::conditional<kProbe, ProbeSmem,
                                         SearchSmem>::type;
};

// bits(se(v)) = 2 * floor(log2(ue(v) + 1)) + 1 (me.mv_bits_table)
__device__ __forceinline__ int se_bits(int v) {
  const int ue = v <= 0 ? -2 * v : 2 * v - 1;
  return 2 * (31 - __clz(ue + 1)) + 1;
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One SATD tile: rows g, g+8 of the lane's group are the x/y pixel rows
// (x0, y0: sub-block s, x1, y1: sub-block s + 2; row t of each), the
// lane's group pair (g, g^1) one 8x8 block. Returns that block's SATD
// against y, sum over its 4 sub-blocks of (sum |WHT(x - y)|) >> 1, in
// each lane of the group pair. The 16 WHT coefficients of a 4x4 share
// the parity of its pixel sum, so a sub-block's sum is even and the
// four shifts are one.
__device__ __forceinline__ int satd_tile(uint32_t x0, uint32_t x1,
                                         uint32_t y0, uint32_t y1,
                                         const uint32_t (&bm)[4]) {
  int c[4], e[4];
  qpel::mma(c, x0, x1, y0, y1, bm[0], bm[1]);
  qpel::mma(e, x0, x1, y0, y1, bm[2], bm[3]);
  int v = ((abs(c[0]) + abs(c[1])) + (abs(c[2]) + abs(c[3]))) +
          ((abs(e[0]) + abs(e[1])) + (abs(e[2]) + abs(e[3])));
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v >> 1;
}

// x264's decimate score of one 4x4 from its nonzero mask m (bit k: the
// level at zigzag position k is nonzero): each nonzero level adds
// (run < 1) + (run < 3) + (run < 6), run the zeros just before it (a
// run from position 0 counts every zero). Positions -1..-6 count as
// set, so M bit k + 6 is position k.
__device__ __forceinline__ int decimate_score(uint32_t m) {
  const uint32_t M = (m << 6) | 0x3fu;
  const uint32_t a1 = M >> 5;
  const uint32_t a3 = a1 | (M >> 4) | (M >> 3);
  const uint32_t a6 = a3 | (M >> 2) | (M >> 1) | M;
  return __popc(m & a1) + __popc(m & a3) + __popc(m & a6);
}

// the reference's quant of one coefficient (the products wrap as its
// int32 ones: a custom list's mf can reach ~70000 at low qp)
__device__ __forceinline__ int quant(int x, int mf, int bias) {
  const int mag = static_cast<int>(static_cast<uint32_t>(bias + abs(x)) *
                                   static_cast<uint32_t>(mf)) >> 16;
  return x > 0 ? mag : (x < 0 ? -mag : 0);
}

__device__ __forceinline__ int dequant(int lev, int dmf, int qbits) {
  const uint32_t d = static_cast<uint32_t>(lev) * static_cast<uint32_t>(dmf);
  return qbits >= 0 ? static_cast<int>(d << qbits)
                    : static_cast<int>(d + (1u << (-qbits - 1))) >> -qbits;
}

// transform._inv_butterfly
__device__ __forceinline__ void idct_bf(int& x0, int& x1, int& x2, int& x3) {
  const int s02 = x0 + x2, d02 = x0 - x2;
  const int s13 = x1 + (x3 >> 1), d13 = (x1 >> 1) - x3;
  x0 = s02 + s13;
  x1 = d02 + d13;
  x2 = d02 - d13;
  x3 = s02 - s13;
}

__device__ __forceinline__ int centre_slot(int v) {
  return (kCenter[v][0] + 3) * kBox + kCenter[v][1] + 3;
}

template <bool kSearch, bool kProbe>
__global__ void __launch_bounds__(Cfg<kProbe>::kThreads,
                                  Cfg<kProbe>::kMinBlocks)
tail_kernel(const int* __restrict__ cur, const uint8_t* __restrict__ windows,
            const int* __restrict__ part, const int* __restrict__ mvf,
            const int* __restrict__ pred, int lam,
            const int* __restrict__ r_in, const int* __restrict__ qtab,
            int qbits, int decimate, int mbh, int mbw, int* __restrict__ mv8,
            int* __restrict__ r_idx8, int* __restrict__ mb_cost,
            int* __restrict__ sk, int* __restrict__ sp,
            int* __restrict__ sc8) {
  constexpr int kThreads = Cfg<kProbe>::kThreads;
  constexpr int kWarps = kThreads / 32;
  using Smem = typename Cfg<kProbe>::Smem;
  __shared__ __align__(16) uint8_t raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int mb = blockIdx.x;
  const int my = mb / mbw, mx = mb - my * mbw;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int w8 = 2 * mbw;
  // a tile lane: group g = its rows g, g+8; block bl = g >> 1; row g is
  // sub-block sl, row g+8 sub-block sl + 2; tq its pixel row / its
  // coefficient pair
  const int g = lane >> 2, tq = lane & 3;
  const int bl = g >> 1, sl = g & 1;

  // stage the windows of the MB's z-order blocks (TL/TR and BL/BR are
  // neighbours in the spatial N8 order), cur as bytes and the
  // phase-slice offsets of the 169 rows
  for (int i = t; i < 256; i += kThreads) {
    const int b = i >> 6;
    const int nb = (2 * my + (b >> 1)) * w8 + 2 * mx + (b & 1);
    qpel::stage_chunk(sm.win + qpel::win_base(b), windows + (size_t)nb * 1024,
                      i & 63);
  }
  if (t < 64) {
    const int b = t >> 4, s = (t >> 2) & 3, row = t & 3;
    const int4 v = *reinterpret_cast<const int4*>(
        cur + (size_t)(16 * my + 8 * (b >> 1) + 4 * (s >> 1) + row) *
                  (16 * mbw) +
        16 * mx + 8 * (b & 1) + 4 * (s & 1));
    sm.cur[b][s][row] = (v.x & 0xff) | (v.y & 0xff) << 8 |
                        (v.z & 0xff) << 16 | static_cast<uint32_t>(v.w) << 24;
  }
  for (int i = t; i < 169; i += kThreads)
    sm.ph[i] = qpel::phase_offsets(i / 13 - 6, i % 13 - 6);
  if (t == 0) sm.next = 0;
  if (!kSearch && t < 4) {
    const int r = r_in[(2 * my + (t >> 1)) * w8 + 2 * mx + (t & 1)];
    const int roy = r / 13 - 6, rox = r % 13 - 6;
    if (r < 0 || r > 168 || abs(roy) > 3 || abs(rox) > 3) __trap();
    sm.r[t][0] = roy;
    sm.r[t][1] = rox;
  }
  uint32_t bw[4];
  qpel::kron_frag(kWhtKron, g, tq, bw);
  __syncthreads();
  const uint32_t cur0 = sm.cur[bl][sl][tq], cur1 = sm.cur[bl][sl + 2][tq];

  if constexpr (kSearch) {
    // B3: a tile per offset k; lanes build their two pixel rows of it
    const uint8_t* w = sm.win + qpel::win_base(bl);
    const int o = 4 * sl + 16 * tq;
    for (int k = warp; k < kOffsets; k += kWarps) {
      const uint32_t ph = sm.ph[(k / 7 + 3) * 13 + k % 7 + 3];
      const int v = satd_tile(cur0, cur1, qpel::row4(w, ph, o),
                              qpel::row4(w, ph, o + 64), bw);
      if ((lane & 7) == 0) sm.sat[bl][k] = v;
    }
    __syncthreads();
    // the partition-coupled costs, a thread an offset, a warp a block;
    // the first minimum is the least key cost << 6 | k
    if (warp < 4) {
      const int b = warp;
      const int bn = (2 * my + (b >> 1)) * w8 + 2 * mx + (b & 1);
      const int pt = part[mb];
      const int mvx = mvf[2 * bn], mvy = mvf[2 * bn + 1];
      const int prx = pred[2 * mb], pry = pred[2 * mb + 1];
      uint32_t key = 0xffffffffu;
      for (int k = lane; k < kOffsets; k += 32) {
        const int oy = k / 7 - 3, ox = k % 7 - 3;
        int sat;
        if (pt == 0)
          sat = (sm.sat[0][k] + sm.sat[1][k]) + (sm.sat[2][k] + sm.sat[3][k]);
        else if (pt == 1)
          sat = sm.sat[b][k] + sm.sat[b ^ 1][k];
        else if (pt == 2)
          sat = sm.sat[b][k] + sm.sat[b ^ 2][k];
        else
          sat = sm.sat[b][k];
        const int dx = min(max(4 * mvx + ox - prx, -2048), 2048);
        const int dy = min(max(4 * mvy + oy - pry, -2048), 2048);
        const int cost = sat + (se_bits(dx) + se_bits(dy)) * lam;
        key = min(key, static_cast<uint32_t>(cost) << 6 | k);
      }
      key = __reduce_min_sync(0xffffffffu, key);
      if (lane == 0) {
        const int kb = key & 63;
        const int oy = kb / 7 - 3, ox = kb % 7 - 3;
        r_idx8[bn] = (oy + 6) * 13 + (ox + 6);
        mv8[2 * bn] = 4 * mvx + ox;
        mv8[2 * bn + 1] = 4 * mvy + oy;
        sm.r[b][0] = oy;
        sm.r[b][1] = ox;
        // a unit's first 8x8: 16x16 block 0, 16x8 blocks 0 and 2, 8x16
        // blocks 0 and 1, 8x8 every block
        const bool first = pt == 0 ? b == 0
                         : pt == 1 ? (b & 1) == 0
                         : pt == 2 ? b < 2 : true;
        sm.best[b] = first ? static_cast<int>(key >> 6) : 0;
      }
    }
    __syncthreads();
    if (mb_cost != nullptr && t == 0)
      mb_cost[mb] = sm.best[0] + sm.best[1] + sm.best[2] + sm.best[3];
  }

  if constexpr (kProbe) {
    // the lattice around r: pixel rows of the 45 deltas (the box's
    // corners are never read), a (block, slot, sub-block) an item
    for (int i = t; i < 4 * kSlots * 4; i += kThreads) {
      const int b = i / (kSlots * 4), rem = i - b * (kSlots * 4);
      const int slot = rem >> 2, s = rem & 3;
      const int dy = slot / kBox - 3, dx = slot % kBox - 3;
      if (abs(dy) == 3 && abs(dx) == 3) continue;
      const uint32_t ph =
          sm.ph[(sm.r[b][0] + dy + 6) * 13 + sm.r[b][1] + dx + 6];
      const uint8_t* w = sm.win + qpel::win_base(b);
      const int o = 64 * (s >> 1) + 4 * (s & 1);
      uint32_t q[4];
#pragma unroll
      for (int row = 0; row < 4; ++row)
        q[row] = qpel::row4(w, ph, o + 16 * row);
      *reinterpret_cast<uint4*>(sm.rows + b * kRows + slot * 64 + s * 16) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
    // the lane's quant constants: coefficients 2t, 2t+1, 8+2t, 9+2t
    int mf[4], bias[4], dmf[4];
    uint32_t zb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * (i >> 1) + 2 * tq + (i & 1);
      mf[i] = qtab[j];
      bias[i] = qtab[16 + j];
      dmf[i] = qtab[32 + j];
      zb[i] = 1u << kZigzagRank[j];
    }
    uint32_t bd[4];
    qpel::kron_frag(kDctKron, g, tq, bd);
    const uint8_t* my_rows = sm.rows + bl * kRows + 16 * sl + 4 * tq;
    __syncthreads();

    // a warp takes the next tile: the 13 versions' DCT tiles, each with
    // its probe chain, then the 84 SP pairs (decimate on)
    const int n_first = kVersions + (decimate ? kPairs : 0);
    for (;;) {
      int T = 0;
      if (lane == 0) T = atomicAdd(&sm.next, 1);
      T = __shfl_sync(0xffffffffu, T, 0);
      if (T >= n_first) break;
      if (T >= kVersions) {
        const int p = T - kVersions;
        const uint8_t* xa = my_rows + kSpPair[p][0] * 64;
        const uint8_t* ya = my_rows + kSpPair[p][1] * 64;
        const int v = satd_tile(ld32(xa), ld32(xa + 32), ld32(ya),
                                ld32(ya + 32), bw);
        if ((lane & 7) == 0) sm.maps[kSkRows + p][bl] = v;
        continue;
      }
      // DCT(cur - pred) of version v = T, quant / decimate mask / dequant
      // in the fragment
      const int v = T;
      const uint8_t* pl = my_rows + centre_slot(v) * 64;
      const uint32_t p0 = ld32(pl), p1 = ld32(pl + 32);
      int c[2][4];
      qpel::mma(c[0], cur0, cur1, p0, p1, bd[0], bd[1]);
      qpel::mma(c[1], cur0, cur1, p0, p1, bd[2], bd[3]);
      // c[h][i]: row g + 8 * (i >> 1), the lane's coefficient 2 * h + (i & 1)
      uint32_t m = 0, big = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = 2 * h + (i & 1), hi = i >> 1;
          const int lev = quant(c[h][i], mf[q], bias[q]);
          m |= lev != 0 ? zb[q] << (16 * hi) : 0u;
          big |= abs(lev) > 1 ? 1u << hi : 0u;
          c[h][i] = dequant(lev, dmf[q], qbits);
        }
      int score = 0;
      if (decimate) {
        m |= __shfl_xor_sync(0xffffffffu, m, 1);
        m |= __shfl_xor_sync(0xffffffffu, m, 2);
        big |= __shfl_xor_sync(0xffffffffu, big, 1);
        big |= __shfl_xor_sync(0xffffffffu, big, 2);
        score = ((big & 1u) ? 9 : decimate_score(m & 0xffffu)) +
                ((big & 2u) ? 9 : decimate_score(m >> 16));
        score += __shfl_xor_sync(0xffffffffu, score, 4);
      }
      if ((lane & 7) == 0) sm.sc[v][bl] = score;
      // the warp's 16 items (b, s) = (g >> 1, sub-block of row g / g+8)
      int (&deq)[16][kDeq] = sm.deq[warp];
      int* d0 = deq[4 * bl + sl];
      int* d1 = deq[4 * bl + sl + 2];
      *reinterpret_cast<int2*>(d0 + 2 * tq) = make_int2(c[0][0], c[0][1]);
      *reinterpret_cast<int2*>(d1 + 2 * tq) = make_int2(c[0][2], c[0][3]);
      *reinterpret_cast<int2*>(d0 + 8 + 2 * tq) = make_int2(c[1][0], c[1][1]);
      *reinterpret_cast<int2*>(d1 + 8 + 2 * tq) = make_int2(c[1][2], c[1][3]);
      __syncwarp();
      // IDCT and recon, a lane an item (the IDCT's >> 1 keeps it on the
      // ALU): recon slot 49 + v of block b
      if (lane < 16) {
        const int b = lane >> 2, s = lane & 3;
        int x[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int4 q = reinterpret_cast<const int4*>(deq[lane])[r];
          x[r][0] = q.x;
          x[r][1] = q.y;
          x[r][2] = q.z;
          x[r][3] = q.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) idct_bf(x[r][0], x[r][1], x[r][2], x[r][3]);
#pragma unroll
        for (int k = 0; k < 4; ++k) idct_bf(x[0][k], x[1][k], x[2][k], x[3][k]);
        uint8_t* base = sm.rows + b * kRows + s * 16;
        const uint4 pv =
            *reinterpret_cast<const uint4*>(base + centre_slot(v) * 64);
        const uint32_t pw[4] = {pv.x, pv.y, pv.z, pv.w};
        uint32_t rw[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int px = (pw[r] >> (8 * k)) & 0xff;
            word |= static_cast<uint32_t>(
                        min(max(px + ((x[r][k] + 32) >> 6), 0), 255))
                    << (8 * k);
          }
          rw[r] = word;
        }
        *reinterpret_cast<uint4*>(base + (kRecSlot + v) * 64) =
            make_uint4(rw[0], rw[1], rw[2], rw[3]);
      }
      __syncwarp();
    }
    __syncthreads();

    // the SK tiles (v, k): WHT(rec_v) against L(c_v + nb_k)
    for (int T = warp; T < kSkRows; T += kWarps) {
      const uint8_t* xa = my_rows + (kRecSlot + T / kNbs) * 64;
      const uint8_t* ya = my_rows + kSkSlot[T] * 64;
      const int v = satd_tile(ld32(xa), ld32(xa + 32), ld32(ya),
                              ld32(ya + 32), bw);
      if ((lane & 7) == 0) sm.maps[T][bl] = v;
    }
    __syncthreads();

    // the maps, a 16-byte row (the MB's four blocks) a store
    const size_t n = (size_t)mbh * mbw;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = t; i < 2 * kSkRows + kVersions; i += kThreads) {
      uint4 val;
      int* dst;
      if (i < kSkRows) {
        val = *reinterpret_cast<const uint4*>(sm.maps[i]);
        dst = sk + ((size_t)i * n + mb) * 4;
      } else if (i < 2 * kSkRows) {
        const int r = i - kSkRows;
        const int p = decimate ? kSpIndex[r] : -1;
        const int* src = !decimate ? sm.maps[r]
                       : p >= 0    ? sm.maps[kSkRows + p] : nullptr;
        val = src ? *reinterpret_cast<const uint4*>(src) : zero;
        dst = sp + ((size_t)r * n + mb) * 4;
      } else {
        const int v = i - 2 * kSkRows;
        val = decimate ? *reinterpret_cast<const uint4*>(sm.sc[v]) : zero;
        dst = sc8 + ((size_t)v * n + mb) * 4;
      }
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
}

template <bool kSearch, bool kProbe>
int launch(const void* cur, const void* windows, const void* part,
           const void* mvf, const void* pred, int lam, const void* r_in,
           const void* qtab, int qbits, int decimate, int mbh, int mbw,
           void* mv8, void* r_idx8, void* mb_cost, void* sk, void* sp,
           void* sc8, void* stream) {
  tail_kernel<kSearch, kProbe>
      <<<mbh * mbw, Cfg<kProbe>::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(cur), static_cast<const uint8_t*>(windows),
          static_cast<const int*>(part), static_cast<const int*>(mvf),
          static_cast<const int*>(pred), lam, static_cast<const int*>(r_in),
          static_cast<const int*>(qtab), qbits, decimate, mbh, mbw,
          static_cast<int*>(mv8), static_cast<int*>(r_idx8),
          static_cast<int*>(mb_cost), static_cast<int*>(sk),
          static_cast<int*>(sp), static_cast<int*>(sc8));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pcamv_subpel(const void* cur, const void* windows,
                            const void* part, const void* mvf,
                            const void* pred, int lam, int mbh, int mbw,
                            void* mv8, void* r_idx8, void* mb_cost,
                            void* stream) {
  return launch<true, false>(cur, windows, part, mvf, pred, lam, nullptr,
                             nullptr, 0, 0, mbh, mbw, mv8, r_idx8, mb_cost,
                             nullptr, nullptr, nullptr, stream);
}

extern "C" int pcamv_analyse_tail(const void* cur, const void* windows,
                                  const void* part, const void* mvf,
                                  const void* pred, int lam, const void* qtab,
                                  int qbits, int decimate, int mbh, int mbw,
                                  void* mv8, void* r_idx8, void* sk, void* sp,
                                  void* sc8, void* stream) {
  return launch<true, true>(cur, windows, part, mvf, pred, lam, nullptr, qtab,
                            qbits, decimate, mbh, mbw, mv8, r_idx8, nullptr,
                            sk, sp, sc8, stream);
}

extern "C" int pcamv_probe_maps(const void* cur, const void* windows,
                                const void* r_idx8, const void* qtab,
                                int qbits, int decimate, int mbh, int mbw,
                                void* sk, void* sp, void* sc8, void* stream) {
  return launch<false, true>(cur, windows, nullptr, nullptr, nullptr, 0,
                             r_idx8, qtab, qbits, decimate, mbh, mbw, nullptr,
                             nullptr, nullptr, sk, sp, sc8, stream);
}
