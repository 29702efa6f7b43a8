// Native host back-end of the port: CAVLC slice writer, the MVP / P_SKIP
// scans and the STC embedder.
//
// A copy of the reference package's native/pcamv_native.cpp cut to the
// seven entry points the port calls (pcamv_write_slice,
// pcamv_write_slice_b, pcamv_scan_p_parts, pcamv_scan_p_parts_forced,
// pcamv_host_scan_p, pcamv_host_scan_p_forced, pcamv_stc_embed) and to the
// port's slice: I slices (I16x16, I4x4 and, with the 8x8 transform, I8x8),
// P slices with or without partitions, one or more references (ref_idx_l0
// per partition, the MVP's same-ref rules), the 4x4 or the adaptive 8x8
// transform, and B slices of 16x16 MBs at one reference. Twins of the
// reference's serial host paths:
//   - encoder/cavlc.c:288-717 (MB + residual writers) and common/bs.h
//   - common/macroblock.c:28-165 (median MVP / pskip derivation)
//   - embed.h:309-548 (STC Viterbi)
//
// Built with g++ at first use by native/__init__.py; C ABI via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <limits>
#include <vector>

#include "vlc_tables.inc"

namespace {

// ---------------------------------------------------------------- bits ----
struct BitWriter {
  uint8_t* buf;
  long cap;
  long bytes = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  BitWriter(uint8_t* b, long c) : buf(b), cap(c) {}

  inline void put(int n, uint32_t v) {
    if (n == 0) return;
    acc = (acc << n) | v;
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      if (bytes >= cap) { overflow = true; return; }
      buf[bytes++] = (uint8_t)((acc >> nbits) & 0xFF);
    }
    acc &= (1ULL << nbits) - 1;
  }
  inline void put_ue(uint32_t v) {
    uint32_t x = v + 1;
    int n = 32 - __builtin_clz(x);
    put(2 * n - 1, x);
  }
  inline void put_se(int32_t v) {
    put_ue(v <= 0 ? (uint32_t)(-2 * v) : (uint32_t)(2 * v - 1));
  }
  inline void put_vlc(const Vlc& c) { put(c.len, c.val); }
  inline void trailing() {
    put(1, 1);
    if (nbits) put(8 - nbits, 0);
  }
};

// scan index -> raster position (r*4+c), frame zigzag
static const int ZIG[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                            9, 12, 13, 10, 7, 11, 14, 15};
// luma blkIdx -> block raster (by*4+bx)
static const int LSCAN[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                              8, 9, 12, 13, 10, 11, 14, 15};

// ------------------------------------------------------------- residual ---
static void write_level(BitWriter& bw, int code, int suffix_len) {
  if (suffix_len == 0) {
    if (code < 14) { bw.put(code + 1, 1); return; }
    if (code < 30) { bw.put(15, 1); bw.put(4, code - 14); return; }
    code -= 15;  // decoder adds 15 when prefix>=15 && suffix_len==0
  } else {
    if (code < (15 << suffix_len)) {
      int prefix = code >> suffix_len;
      bw.put(prefix + 1, 1);
      bw.put(suffix_len, code & ((1 << suffix_len) - 1));
      return;
    }
  }
  int sl = suffix_len;  // effective (0 after the -=15 path)
  int prefix = 15;
  for (;;) {
    int sz = prefix - 3;
    long base = (long)(15 << sl) + (prefix > 15 ? ((1L << sz) - 4096) : 0);
    if (code - base < (1L << sz)) {
      bw.put(prefix + 1, 1);
      bw.put(sz, (uint32_t)(code - base));
      return;
    }
    prefix++;
    if (prefix >= 32) { bw.overflow = true; return; }
  }
}

// levels in scan order; returns total_coeff
static int write_residual(BitWriter& bw, const int* levels, int max_coeff,
                          int nc) {
  int nz_pos[16], total = 0;
  for (int i = 0; i < max_coeff; i++)
    if (levels[i]) nz_pos[total++] = i;

  int tab = nc == -1 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
  if (total == 0) { bw.put_vlc(COEFF0[tab]); return 0; }

  int t1s = 0;
  for (int k = total - 1; k >= 0 && t1s < 3; k--) {
    if (levels[nz_pos[k]] == 1 || levels[nz_pos[k]] == -1) t1s++;
    else break;
  }
  bw.put_vlc(COEFF_TOKEN[tab][(total - 1) * 4 + t1s]);

  for (int k = total - 1; k >= total - t1s; k--)
    bw.put(1, levels[nz_pos[k]] < 0 ? 1 : 0);

  int suffix_len = (total > 10 && t1s < 3) ? 1 : 0;
  bool first = true;
  for (int k = total - t1s - 1; k >= 0; k--) {
    int val = levels[nz_pos[k]];
    int code = val > 0 ? 2 * val - 2 : -2 * val - 1;
    if (first && t1s < 3) code -= 2;
    first = false;
    write_level(bw, code, suffix_len);
    if (suffix_len == 0) suffix_len = 1;
    if (std::abs(val) > (3 << (suffix_len - 1)) && suffix_len < 6)
      suffix_len++;
  }

  if (total < max_coeff) {
    int tz = nz_pos[total - 1] + 1 - total;
    if (max_coeff == 4) bw.put_vlc(TOTAL_ZEROS_DC[total - 1][tz]);
    else bw.put_vlc(TOTAL_ZEROS[total - 1][tz]);
    int zeros_left = tz;
    for (int k = total - 1; k > 0; k--) {
      if (zeros_left <= 0) break;
      int run = nz_pos[k] - nz_pos[k - 1] - 1;
      int row = zeros_left < 7 ? zeros_left - 1 : 6;
      bw.put_vlc(RUN_BEFORE[row][run]);
      zeros_left -= run;
    }
  }
  return total;
}

// ------------------------------------------------------------ frame ctx ---
struct FrameCtx {
  int mbw, mbh;
  std::vector<int32_t> nnz_y;       // [4mbh][4mbw]
  std::vector<int32_t> nnz_c;      // [2][2mbh][2mbw]
  std::vector<int32_t> modes4;     // [4mbh][4mbw], 2 = not i4x4-coded
  FrameCtx(int w, int h) : mbw(w), mbh(h),
      nnz_y(16 * w * h, 0), nnz_c(2 * 4 * w * h, 0),
      modes4(16 * w * h, 2) {}
  inline int m4(int by, int bx) const { return modes4[by * 4 * mbw + bx]; }
  inline void set_m4(int by, int bx, int v) { modes4[by * 4 * mbw + bx] = v; }
  // predIntra4x4PredMode (spec 8.3.1.1)
  inline int pred_i4(int by, int bx) const {
    if (bx == 0 || by == 0) return 2;
    int a = m4(by, bx - 1), b = m4(by - 1, bx);
    return a < b ? a : b;
  }
  inline int ny(int by, int bx) const { return nnz_y[by * 4 * mbw + bx]; }
  inline void set_ny(int by, int bx, int v) { nnz_y[by * 4 * mbw + bx] = v; }
  inline int ncc(int ch, int by, int bx) const {
    return nnz_c[(ch * 2 * mbh + by) * 2 * mbw + bx];
  }
  inline void set_nc(int ch, int by, int bx, int v) {
    nnz_c[(ch * 2 * mbh + by) * 2 * mbw + bx] = v;
  }
  inline int ctx(bool luma, int ch, int by, int bx) const {
    bool hl = bx > 0, ht = by > 0;
    int l = hl ? (luma ? ny(by, bx - 1) : ncc(ch, by, bx - 1)) : 0;
    int t = ht ? (luma ? ny(by - 1, bx) : ncc(ch, by - 1, bx)) : 0;
    if (hl && ht) return (l + t + 1) >> 1;
    if (hl) return l;
    if (ht) return t;
    return 0;
  }
};

static void zigzag16(const int32_t* raster, int* out) {
  for (int i = 0; i < 16; i++) out[i] = raster[ZIG[i]];
}

static void write_chroma(BitWriter& bw, FrameCtx& fc, int mx, int my,
                         int cbp_chroma, const int32_t* cdc,
                         const int32_t* cac) {
  // cdc: [2][4] raster; cac: [2][4][16] blk-raster x coeff-raster
  if (cbp_chroma) {
    for (int ch = 0; ch < 2; ch++) {
      int lv[4] = {cdc[ch * 4 + 0], cdc[ch * 4 + 1], cdc[ch * 4 + 2],
                   cdc[ch * 4 + 3]};
      write_residual(bw, lv, 4, -1);
    }
  }
  for (int ch = 0; ch < 2; ch++) {
    for (int blk = 0; blk < 4; blk++) {
      int by = blk >> 1, bx = blk & 1;
      int yy = 2 * my + by, xx = 2 * mx + bx;
      if (cbp_chroma == 2) {
        int z[16];
        zigzag16(&cac[(ch * 4 + blk) * 16], z);
        int nc = fc.ctx(false, ch, yy, xx);
        fc.set_nc(ch, yy, xx, write_residual(bw, z + 1, 15, nc));
      } else {
        fc.set_nc(ch, yy, xx, 0);
      }
    }
  }
}

// 8x8-transform luma residual: four interleaved 4x4 CAVLC blocks per
// coded 8x8 (spec 7.4.5.3.3 level8x8 split). scan: [4][64]
// zigzag-ordered levels per 8x8 block in z-order (0,0),(0,1),(1,0),
// (1,1); sub-block j carries zigzag positions 4k + j and its TotalCoeff
// lands in its 4x4 nnz cell (spec 9.2.1).
static void write_luma8(BitWriter& bw, FrameCtx& fc, int mx, int my,
                        int cbp_luma, const int32_t* scan) {
  static const int BY8[4] = {0, 0, 1, 1}, BX8[4] = {0, 1, 0, 1};
  static const int SY[4] = {0, 0, 1, 1}, SX[4] = {0, 1, 0, 1};
  for (int b = 0; b < 4; b++) {
    for (int j = 0; j < 4; j++) {
      int yy = 4 * my + 2 * BY8[b] + SY[j];
      int xx = 4 * mx + 2 * BX8[b] + SX[j];
      if (cbp_luma & (1 << b)) {
        int lv[16];
        for (int i = 0; i < 16; i++) lv[i] = scan[b * 64 + 4 * i + j];
        int nc = fc.ctx(true, 0, yy, xx);
        fc.set_ny(yy, xx, write_residual(bw, lv, 16, nc));
      } else {
        fc.set_ny(yy, xx, 0);
      }
    }
  }
}

}  // namespace

// The mb_qp_delta chain of adaptive quantization (spec 7.4.5): each MB
// that codes the syntax element sends its qp minus the last coded one,
// folded into [-26, 25] ((d + 26) mod 52 - 26), and becomes the last; MBs
// that code none leave the chain where it is. Without a grid every delta
// is 0.
namespace {
struct QpDelta {
  const int32_t* grid;
  int last;
  QpDelta(const int32_t* g, int slice_qp) : grid(g), last(slice_qp) {}
  int next(int a) {
    if (grid == nullptr) return 0;
    const int q = grid[a];
    const int d = ((q - last + 26) % 52 + 52) % 52 - 26;
    last = q;
    return d;
  }
};
}  // namespace

// ------------------------------------------------------------ slice API ---
extern "C" long pcamv_write_slice(
    uint8_t* out, long out_cap, const uint8_t* header, int header_nbits,
    int slice_type, int mbw, int mbh,
    const uint8_t* skip, const int32_t* mode, const int32_t* cmode,
    const int32_t* cbp_luma, const int32_t* cbp_chroma,
    const int32_t* luma_dc, const int32_t* luma_blocks,
    const int32_t* chroma_dc, const int32_t* chroma_ac,
    const uint8_t* mb_i4, const int32_t* i4_modes,
    const int32_t* part, const int32_t* mvd4,
    // multiple references: refs [n][4] the L0 index of each ref slot
    // (unused slots 0), coded as te(v) when num_ref > 1
    const int32_t* refs, int num_ref,
    // sub-8x8 partitions: sub_type [n][4] each P_8x8 block's
    // sub_mb_type (null: all P_L0_8x8); mvd4 then holds mvd_stride units
    // an MB, in coding order
    const int32_t* sub_type, int mvd_stride,
    // High-profile 8x8 transform (PPS transform_8x8_mode_flag):
    // mb_i8 [n] I_NxN-8x8 flags; i8_modes [n][4] z-order pred modes;
    // luma8_scan [n][4][64] zigzag-ordered 8x8 levels; trans8 [n]
    // per-MB inter transform flags; trans8_mode = PPS flag
    const uint8_t* mb_i8, const int32_t* i8_modes,
    const int32_t* luma8_scan, const uint8_t* trans8, int trans8_mode,
    // adaptive quantization: qp_grid [n] each MB's qp (null: every
    // mb_qp_delta is 0), slice_qp the slice header's QP
    const int32_t* qp_grid, int slice_qp,
    // intra MBs in a P slice (stego off): p_intra [n] marks them (null:
    // none); they take the I-slice arrays (mode, cmode, luma_dc, mb_i4,
    // i4_modes and the residual arrays at their index), with the P
    // slice's mb_type offset 5 (spec 7.4.5, Table 7-13)
    const uint8_t* p_intra) {
  BitWriter bw(out, out_cap);
  for (int i = 0; i < header_nbits; i++)
    bw.put(1, (header[i >> 3] >> (7 - (i & 7))) & 1);

  FrameCtx fc(mbw, mbh);
  QpDelta dq(qp_grid, slice_qp);
  int n = mbw * mbh;
  int skip_run = 0;
  for (int a = 0; a < n; a++) {
    int my = a / mbw, mx = a % mbw;
    if (slice_type == 0 && skip[a]) {  // P_SKIP
      skip_run++;
      for (int b = 0; b < 4; b++)
        for (int c = 0; c < 4; c++) fc.set_ny(4 * my + b, 4 * mx + c, 0);
      for (int ch = 0; ch < 2; ch++)
        for (int b = 0; b < 2; b++)
          for (int c = 0; c < 2; c++) fc.set_nc(ch, 2 * my + b, 2 * mx + c, 0);
      continue;
    }
    const bool intra_p = slice_type == 0 && p_intra && p_intra[a];
    const int intra_off = slice_type == 0 ? 5 : 0;
    if (slice_type == 0) {
      bw.put_ue(skip_run);
      skip_run = 0;
    }
    if (slice_type == 0 && !intra_p) {
      // mb_type 0..3 (16x16/16x8/8x16/8x8, spec 7.3.5.2); P_8x8 codes
      // its four sub_mb_type (spec Table 7-17)
      int p = part[a];
      static const int NU[4] = {1, 2, 2, 4};
      static const int NUS[4] = {1, 2, 2, 4};  // units per sub_mb_type
      bw.put_ue(p);
      int n_units = NU[p];
      // noSubMbPartSizeLessThan8x8Flag (spec 7.3.5): no
      // transform_size_8x8_flag on an MB with a sub-partition under 8x8
      bool t8_allowed = true;
      if (p == 3) {
        n_units = 0;
        for (int s = 0; s < 4; s++) {
          int sv = sub_type ? sub_type[a * 4 + s] : 0;
          bw.put_ue((uint32_t)sv);
          n_units += NUS[sv];
          if (sv != 0) t8_allowed = false;
        }
      }
      if (num_ref > 1) {  // ref_idx_l0 te(v), one per ref slot
        int n_refs = p == 3 ? 4 : NU[p];
        for (int k = 0; k < n_refs; k++) {
          int r = refs ? refs[a * 4 + k] : 0;
          if (num_ref == 2) bw.put(1, 1 - r);
          else bw.put_ue((uint32_t)r);
        }
      }
      const int st = mvd_stride > 0 ? mvd_stride : 4;
      for (int u = 0; u < n_units; u++) {
        bw.put_se(mvd4[(a * st + u) * 2]);
        bw.put_se(mvd4[(a * st + u) * 2 + 1]);
      }
      int cbp = (cbp_chroma[a] << 4) | cbp_luma[a];
      bw.put_ue(CBP_INTER_TO_GOLOMB[cbp]);
      // transform_size_8x8_flag between cbp and dqp (spec 7.3.5), only
      // when luma residual exists and no sub-partition is under 8x8
      int t8 = (trans8 && trans8[a]) ? 1 : 0;
      if (trans8_mode && cbp_luma[a] && t8_allowed) bw.put(1, t8);
      if (cbp) bw.put_se(dq.next(a));  // mb_qp_delta
      if (t8 && cbp_luma[a]) {
        write_luma8(bw, fc, mx, my, cbp_luma[a], &luma8_scan[a * 256]);
      } else {
        for (int blk = 0; blk < 16; blk++) {
          int braster = LSCAN[blk];
          int by = braster >> 2, bx = braster & 3;
          int yy = 4 * my + by, xx = 4 * mx + bx;
          if (cbp_luma[a] & (1 << (blk >> 2))) {
            int z[16];
            zigzag16(&luma_blocks[(a * 16 + braster) * 16], z);
            int nc = fc.ctx(true, 0, yy, xx);
            fc.set_ny(yy, xx, write_residual(bw, z, 16, nc));
          } else {
            fc.set_ny(yy, xx, 0);
          }
        }
      }
      if (cbp) {
        write_chroma(bw, fc, mx, my, cbp_chroma[a], &chroma_dc[a * 8],
                     &chroma_ac[a * 128]);
      } else {
        for (int ch = 0; ch < 2; ch++)
          for (int b = 0; b < 2; b++)
            for (int c = 0; c < 2; c++)
              fc.set_nc(ch, 2 * my + b, 2 * mx + c, 0);
      }
    } else if (mb_i8 && mb_i8[a]) {  // I_NxN (Intra_8x8), High profile
      bw.put_ue(0);                  // mb_type (I slice)
      bw.put(1, 1);                  // transform_size_8x8_flag
      static const int GY8[4] = {0, 0, 2, 2}, GX8[4] = {0, 2, 0, 2};
      for (int b = 0; b < 4; b++) {
        int gy = 4 * my + GY8[b], gx = 4 * mx + GX8[b];
        int m = i8_modes[a * 4 + b];
        int pm = fc.pred_i4(gy, gx);
        if (m == pm) {
          bw.put(1, 1);
        } else {
          bw.put(1, 0);
          bw.put(3, m - (m > pm ? 1 : 0));
        }
        // replicate into the 2x2 ctx cells (x264 cache layout)
        for (int dy = 0; dy < 2; dy++)
          for (int dx = 0; dx < 2; dx++)
            fc.set_m4(gy + dy, gx + dx, m);
      }
      bw.put_ue(cmode[a]);
      int cbp = (cbp_chroma[a] << 4) | cbp_luma[a];
      bw.put_ue(CBP_INTRA_TO_GOLOMB[cbp]);
      if (cbp) bw.put_se(dq.next(a));  // mb_qp_delta
      write_luma8(bw, fc, mx, my, cbp_luma[a], &luma8_scan[a * 256]);
      write_chroma(bw, fc, mx, my, cbp_chroma[a], &chroma_dc[a * 8],
                   &chroma_ac[a * 128]);
    } else if (mb_i4 && mb_i4[a]) {  // I_NxN (Intra_4x4), spec 7.3.5.1
      bw.put_ue(intra_off);  // mb_type I_NxN: 0 in an I slice, 5 in a P
      if (trans8_mode) bw.put(1, 0);  // transform_size_8x8_flag
      for (int blk = 0; blk < 16; blk++) {
        int braster = LSCAN[blk];
        int by = braster >> 2, bx = braster & 3;
        int gy = 4 * my + by, gx = 4 * mx + bx;
        int m = i4_modes[a * 16 + blk];
        int pm = fc.pred_i4(gy, gx);
        if (m == pm) {
          bw.put(1, 1);
        } else {
          bw.put(1, 0);
          bw.put(3, m - (m > pm ? 1 : 0));
        }
        fc.set_m4(gy, gx, m);
      }
      bw.put_ue(cmode[a]);
      int cbp = (cbp_chroma[a] << 4) | cbp_luma[a];
      bw.put_ue(CBP_INTRA_TO_GOLOMB[cbp]);
      if (cbp) bw.put_se(dq.next(a));  // mb_qp_delta
      for (int blk = 0; blk < 16; blk++) {
        int braster = LSCAN[blk];
        int by = braster >> 2, bx = braster & 3;
        int yy = 4 * my + by, xx = 4 * mx + bx;
        if (cbp_luma[a] & (1 << (blk >> 2))) {
          int z[16];
          zigzag16(&luma_blocks[(a * 16 + braster) * 16], z);
          int nc = fc.ctx(true, 0, yy, xx);
          fc.set_ny(yy, xx, write_residual(bw, z, 16, nc));
        } else {
          fc.set_ny(yy, xx, 0);
        }
      }
      write_chroma(bw, fc, mx, my, cbp_chroma[a], &chroma_dc[a * 8],
                   &chroma_ac[a * 128]);
    } else {  // I16x16
      int cbp01 = cbp_luma[a] ? 1 : 0;
      int mb_type = intra_off + 1 + mode[a] + 4 * cbp_chroma[a] + 12 * cbp01;
      bw.put_ue(mb_type);
      bw.put_ue(cmode[a]);
      bw.put_se(dq.next(a));  // mb_qp_delta (I16 always)
      int z[16];
      zigzag16(&luma_dc[a * 16], z);
      int nc = fc.ctx(true, 0, 4 * my, 4 * mx);
      write_residual(bw, z, 16, nc);
      for (int blk = 0; blk < 16; blk++) {
        int braster = LSCAN[blk];
        int by = braster >> 2, bx = braster & 3;
        int yy = 4 * my + by, xx = 4 * mx + bx;
        if (cbp_luma[a]) {
          zigzag16(&luma_blocks[(a * 16 + braster) * 16], z);
          int ncb = fc.ctx(true, 0, yy, xx);
          fc.set_ny(yy, xx, write_residual(bw, z + 1, 15, ncb));
        } else {
          fc.set_ny(yy, xx, 0);
        }
      }
      write_chroma(bw, fc, mx, my, cbp_chroma[a], &chroma_dc[a * 8],
                   &chroma_ac[a * 128]);
    }
  }
  if (slice_type == 0 && skip_run) bw.put_ue(skip_run);
  bw.trailing();
  return bw.overflow ? -1 : bw.bytes;
}

// ------------------------------------------------------------------ STC ---
// Bit-parity twin of the reference stc_embed (upstream embed.h:
// 309-548): toolbox mats[] table for w in [2,20] (stc_mats.inc,
// generated from stego/stc_mats.py), MSVC-rand LCG fallback whose
// state persists across calls (embed.h:134-139), shorter/longer width
// schedule (embed.h:377-391), f32 prices with the flip transition
// winning ties (embed.h:436-467).
#include "stc_mats.inc"

namespace {

static inline int msvc_rand(uint32_t* hold) {
  *hold = *hold * 214013u + 2531011u;  // embed.h:136-139
  return (int)((*hold >> 16) & 0x7fff);
}

static int stc_get_matrix(int width, int height, uint32_t* hold,
                          std::vector<uint32_t>& out) {
  out.resize(width);
  if (width >= 2 && width <= 20 && height >= 7 && height <= 12) {
    for (int i = 0; i < width; i++)
      out[i] = STC_MATS[height - 7][width - 2][i];
    return 0;
  }
  if ((1 << (height - 2)) < width) return -4;
  uint32_t mask = (1u << (height - 2)) - 1;
  uint32_t bop = (1u << (height - 1)) + 1u;
  int got = 0;
  while (got < width) {
    uint32_t r = ((uint32_t)(msvc_rand(hold)) & mask) * 2u + bop;
    bool dup = false;
    for (int j = 0; j < got; j++)
      if (out[j] == r) { dup = true; break; }
    if (!dup) out[got++] = r;
  }
  return 0;
}
}  // namespace

// B slice, 16x16 subset (spec 7.4.5 B table: direct=0/L0=1/L1=2/BI=3;
// B_SKIP = direct with empty cbp, coded in mb_skip_run). Python twin:
// encoder/core.py _write_b_slice_cavlc with encoder/cavlc.py.
extern "C" long pcamv_write_slice_b(
    uint8_t* out, long out_cap, const uint8_t* header, int header_nbits,
    int mbw, int mbh, const int32_t* mode, const int32_t* mvd0,
    const int32_t* mvd1, const int32_t* cbp_luma,
    const int32_t* cbp_chroma, const int32_t* luma_blocks,
    const int32_t* chroma_dc, const int32_t* chroma_ac) {
  BitWriter bw(out, out_cap);
  for (int i = 0; i < header_nbits; i++)
    bw.put(1, (header[i >> 3] >> (7 - (i & 7))) & 1);
  FrameCtx fc(mbw, mbh);
  int n = mbw * mbh;
  int skip_run = 0;
  for (int a = 0; a < n; a++) {
    int my = a / mbw, mx = a % mbw;
    int m = mode[a];
    int cbpl = cbp_luma[a], cbpc = cbp_chroma[a];
    if (m == 0 && cbpl == 0 && cbpc == 0) {  // B_SKIP
      skip_run++;
      for (int b = 0; b < 4; b++)
        for (int c = 0; c < 4; c++) fc.set_ny(4 * my + b, 4 * mx + c, 0);
      for (int ch = 0; ch < 2; ch++)
        for (int b = 0; b < 2; b++)
          for (int c = 0; c < 2; c++)
            fc.set_nc(ch, 2 * my + b, 2 * mx + c, 0);
      continue;
    }
    bw.put_ue(skip_run);
    skip_run = 0;
    bw.put_ue((uint32_t)m);
    if (m == 1 || m == 3) {
      bw.put_se(mvd0[a * 2]);
      bw.put_se(mvd0[a * 2 + 1]);
    }
    if (m == 2 || m == 3) {
      bw.put_se(mvd1[a * 2]);
      bw.put_se(mvd1[a * 2 + 1]);
    }
    int cbp = (cbpc << 4) | cbpl;
    bw.put_ue(CBP_INTER_TO_GOLOMB[cbp]);
    if (cbp) bw.put_se(0);  // qp_delta (CQP)
    for (int blk = 0; blk < 16; blk++) {
      int braster = LSCAN[blk];
      int by = braster >> 2, bx = braster & 3;
      int yy = 4 * my + by, xx = 4 * mx + bx;
      if (cbpl & (1 << (blk >> 2))) {
        int z[16];
        zigzag16(&luma_blocks[(a * 16 + braster) * 16], z);
        int nc = fc.ctx(true, 0, yy, xx);
        fc.set_ny(yy, xx, write_residual(bw, z, 16, nc));
      } else {
        fc.set_ny(yy, xx, 0);
      }
    }
    if (cbp) {
      write_chroma(bw, fc, mx, my, cbpc, &chroma_dc[a * 8],
                   &chroma_ac[a * 128]);
    } else {
      for (int ch = 0; ch < 2; ch++)
        for (int b = 0; b < 2; b++)
          for (int c = 0; c < 2; c++)
            fc.set_nc(ch, 2 * my + b, 2 * mx + c, 0);
    }
  }
  if (skip_run) bw.put_ue(skip_run);
  bw.trailing();
  return bw.overflow ? -1 : bw.bytes;
}

extern "C" int pcamv_stc_embed(const uint8_t* cover, long n,
                               const uint8_t* msg, long k,
                               const float* rho, int h,
                               uint32_t* holdrand, uint8_t* stego,
                               double* cost_out) {
  if (k <= 0) { std::memcpy(stego, cover, n); *cost_out = 0; return 0; }
  if (k > n || h < 2 || h > 24) return -1;
  // self-consistent effective height for k < h (stc.py _eff_h): the
  // reference's k<h traceback mask diverges from its forward mask and
  // frames fail non-deterministically; min(h, k) makes them identical
  if (k < h) h = k < 2 ? 2 : (int)k;
  const float INF = std::numeric_limits<float>::infinity();
  long n_states = 1L << h;

  // layout: invalpha floor/ceil widths + worm schedule (embed.h:377-391)
  double invalpha = (double)n / (double)k;
  int shorter = (int)std::floor(invalpha);
  int longer = (int)std::ceil(invalpha);
  std::vector<uint32_t> cols_s, cols_l;
  // the reference calls getMatrix TWICE even when longer == shorter
  // (embed.h:362-376): on the LCG-fallback path the second call
  // consumes (and may differ from) the first, and every block then
  // uses the SECOND set (matrices[i]=1 for all i when invalpha is
  // integral) — shortcutting would desync the persistent myholdrand
  int rc = stc_get_matrix(shorter, h, holdrand, cols_s);
  if (rc) return rc;
  if ((rc = stc_get_matrix(longer, h, holdrand, cols_l))) return rc;
  std::vector<int> widths(k);
  std::vector<uint8_t> use_l(k);
  long worm = 0;
  for (long j = 0; j < k; j++) {
    if ((double)(worm + longer) <= (double)(j + 1) * invalpha + 0.5) {
      use_l[j] = 1; widths[j] = longer; worm += longer;
    } else {
      use_l[j] = 0; widths[j] = shorter; worm += shorter;
    }
  }

  std::vector<float> price(n_states, INF), nxt(n_states);
  price[0] = 0.0f;
  std::vector<uint8_t> path((size_t)n * n_states);

  uint32_t colmask = (uint32_t)(n_states - 1);
  long i = 0;
  for (long j = 0; j < k; j++) {
    const uint32_t* cols = use_l[j] ? cols_l.data() : cols_s.data();
    for (int t = 0; t < widths[j]; t++) {
      uint32_t col = cols[t] & colmask;
      float c_keep = cover[i] == 1 ? rho[i] : 0.0f;  // y_i = 0
      float c_flip = cover[i] == 0 ? rho[i] : 0.0f;  // y_i = 1
      uint8_t* p = &path[(size_t)i * n_states];
      for (long s = 0; s < n_states; s++) {
        float v0 = price[s] + c_keep;
        float v1 = price[s ^ col] + c_flip;
        // reference tie rule: flip wins equal prices (embed.h:458-467)
        if (v1 <= v0) { nxt[s] = v1; p[s] = 1; }
        else { nxt[s] = v0; p[s] = 0; }
      }
      price.swap(nxt);
      i++;
    }
    int mb = msg[j];
    for (long s = 0; s < n_states; s++) {
      long src = (s << 1) | mb;
      nxt[s] = src < n_states ? price[src] : INF;
    }
    price.swap(nxt);
    if (k - j <= h) colmask >>= 1;
  }
  if (!(price[0] < INF)) return -2;
  *cost_out = (double)price[0];

  // backtrack (embed.h:508-538)
  long state = 0;
  colmask = 0;
  i = n - 1;
  for (long j = k - 1; j >= 0; j--) {
    const uint32_t* cols = use_l[j] ? cols_l.data() : cols_s.data();
    state = (state << 1) | msg[j];
    if (k - j <= h) colmask = (colmask << 1) | 1u;
    for (int t = widths[j] - 1; t >= 0; t--) {
      if (path[(size_t)i * n_states + state]) {
        stego[i] = 1;
        state ^= (long)(cols[t] & colmask);
      } else {
        stego[i] = 0;
      }
      i--;
    }
  }
  return state == 0 && i == -1 ? 0 : -3;
}

// ------------------------------------------------- partition host scan ---
// C++ twin of encoder/scan.py (spec 8.4.1.3 / 8.4.1.1 at 4x4
// granularity; reference x264_mb_predict_mv common/macroblock.c:28-145).
namespace {

struct Grid4 {
  int h4, w4;
  std::vector<int32_t> mv;   // [h4][w4][2]
  std::vector<int32_t> ref;  // [h4][w4] (-1 = none)
  std::vector<uint8_t> dec;  // [h4][w4]
  Grid4(int mbw, int mbh)
      : h4(4 * mbh), w4(4 * mbw), mv(2 * h4 * w4, 0),
        ref(h4 * w4, -1), dec(h4 * w4, 0) {}
  inline bool nb(int y4, int x4, int32_t out[2], int* r) const {
    if (y4 < 0 || x4 < 0 || y4 >= h4 || x4 >= w4 || !dec[y4 * w4 + x4]) {
      out[0] = out[1] = 0;
      *r = -1;
      return false;
    }
    out[0] = mv[(y4 * w4 + x4) * 2];
    out[1] = mv[(y4 * w4 + x4) * 2 + 1];
    *r = ref[y4 * w4 + x4];
    return true;
  }
  inline void commit(int y4, int x4, int h, int w, const int32_t m[2],
                     int r = 0) {
    for (int y = y4; y < y4 + h; y++)
      for (int x = x4; x < x4 + w; x++) {
        mv[(y * w4 + x) * 2] = m[0];
        mv[(y * w4 + x) * 2 + 1] = m[1];
        ref[y * w4 + x] = r;
        dec[y * w4 + x] = 1;
      }
  }
};

inline int32_t med3i(int32_t a, int32_t b, int32_t c) {
  int32_t mn = a < b ? (a < c ? a : c) : (b < c ? b : c);
  int32_t mx = a > b ? (a > c ? a : c) : (b > c ? b : c);
  return a + b + c - mn - mx;
}

// unit geometry per partition type: {y4off, x4off, w4, h4} x units
static const int UGEOM[4][4][4] = {
    {{0, 0, 4, 4}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 4, 2}, {2, 0, 4, 2}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 4}, {0, 2, 2, 4}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 2}, {0, 2, 2, 2}, {2, 0, 2, 2}, {2, 2, 2, 2}}};
static const int NUNITS[4] = {1, 2, 2, 4};

void unit_mvp4(const Grid4& g, int y4, int x4, int w4, int part, int unit,
               int32_t out[2], int ref = 0) {
  // spec 8.4.1.3 with the multi-ref same-ref rules (scan.py unit_mvp)
  int32_t a[2], b[2], c[2];
  int ra, rb, rc;
  bool av_a = g.nb(y4, x4 - 1, a, &ra);
  bool av_b = g.nb(y4 - 1, x4, b, &rb);
  bool av_c = g.nb(y4 - 1, x4 + w4, c, &rc);
  if (!av_c) av_c = g.nb(y4 - 1, x4 - 1, c, &rc);
  if (part == 1) {  // D_16x8
    if (unit == 0 && av_b && rb == ref) { out[0] = b[0]; out[1] = b[1]; return; }
    if (unit == 1 && av_a && ra == ref) { out[0] = a[0]; out[1] = a[1]; return; }
  } else if (part == 2) {  // D_8x16
    if (unit == 0 && av_a && ra == ref) { out[0] = a[0]; out[1] = a[1]; return; }
    if (unit == 1 && av_c && rc == ref) { out[0] = c[0]; out[1] = c[1]; return; }
  }
  bool m_a = av_a && ra == ref, m_b = av_b && rb == ref,
       m_c = av_c && rc == ref;
  if ((int)m_a + (int)m_b + (int)m_c == 1) {
    const int32_t* m = m_a ? a : m_b ? b : c;
    out[0] = m[0]; out[1] = m[1];
    return;
  }
  if (!av_b && !av_c && av_a) { out[0] = a[0]; out[1] = a[1]; return; }
  out[0] = med3i(a[0], b[0], c[0]);
  out[1] = med3i(a[1], b[1], c[1]);
}

void pskip_mv4(const Grid4& g, int y4, int x4, int32_t out[2]) {
  // zero when A/B missing or a zero-MV *ref-0* neighbour (8.4.1.1)
  int32_t a[2], b[2];
  int ra, rb;
  bool av_a = g.nb(y4, x4 - 1, a, &ra);
  bool av_b = g.nb(y4 - 1, x4, b, &rb);
  if (!av_a || !av_b || (ra == 0 && a[0] == 0 && a[1] == 0)
      || (rb == 0 && b[0] == 0 && b[1] == 0)) {
    out[0] = out[1] = 0;
    return;
  }
  unit_mvp4(g, y4, x4, 4, 0, 0, out, 0);
}

}  // namespace

extern "C" void pcamv_scan_p_parts(
    const int32_t* part, const int32_t* mv8, const int32_t* cbp_luma,
    const int32_t* cbp_chroma, int mbw, int mbh, const uint8_t* intra,
    uint8_t* skip, int32_t* mvd, int32_t* mvp_out, int32_t* final8,
    const int32_t* ref8) {
  // mv8/final8: [2mbh][2mbw][2]; mvd/mvp_out: [mbh][mbw][4][2]; ref8
  // (nullable: all 0) [2mbh][2mbw]; intra (nullable): intra MBs carry no
  // MVs, unavailable to neighbours
  Grid4 g(mbw, mbh);
  const int w8 = 2 * mbw;
  memcpy(final8, mv8, sizeof(int32_t) * 2 * w8 * 2 * mbh);
  for (int my = 0; my < mbh; my++)
    for (int mx = 0; mx < mbw; mx++) {
      int a = my * mbw + mx;
      if (intra && intra[a]) {
        // intra neighbours are AVAILABLE with mv 0 / ref -1 (x264
        // cache -1 vs -2 outside, macroblock.c:28-46): they join the
        // MVP median and do NOT trigger the C->D fallback, the
        // lone-A rule, or the P_SKIP zero-forcing
        static const int32_t z[2] = {0, 0};
        g.commit(4 * my, 4 * mx, 4, 4, z, -1);
        continue;
      }
      int y4 = 4 * my, x4 = 4 * mx;
      int p = part[a];
      if (p == 0) {
        int32_t ps[2];
        pskip_mv4(g, y4, x4, ps);
        const int32_t* here = &mv8[((2 * my) * w8 + 2 * mx) * 2];
        int r0 = ref8 ? ref8[(2 * my) * w8 + 2 * mx] : 0;
        if (cbp_luma[a] == 0 && cbp_chroma[a] == 0 && r0 == 0
            && here[0] == ps[0] && here[1] == ps[1])
          skip[a] = 1;
      }
      for (int u = 0; u < NUNITS[p]; u++) {
        const int* gg = UGEOM[p][u];
        int g8 = (2 * my + gg[0] / 2) * w8 + 2 * mx + gg[1] / 2;
        int r = ref8 ? ref8[g8] : 0;
        int32_t mvp[2];
        unit_mvp4(g, y4 + gg[0], x4 + gg[1], gg[2], p, u, mvp, r);
        const int32_t* mv = &mv8[g8 * 2];
        mvd[(a * 4 + u) * 2] = mv[0] - mvp[0];
        mvd[(a * 4 + u) * 2 + 1] = mv[1] - mvp[1];
        mvp_out[(a * 4 + u) * 2] = mvp[0];
        mvp_out[(a * 4 + u) * 2 + 1] = mvp[1];
        g.commit(y4 + gg[0], x4 + gg[1], gg[3], gg[2], mv, r);
      }
    }
}

extern "C" void pcamv_scan_p_parts_forced(
    const int32_t* part, const int32_t* mv8, const uint8_t* skip,
    int mbw, int mbh, int32_t* final8, int32_t* mvd, int32_t* mvp_out,
    const int32_t* ref8) {
  Grid4 g(mbw, mbh);
  const int w8 = 2 * mbw;
  memcpy(final8, mv8, sizeof(int32_t) * 2 * w8 * 2 * mbh);
  for (int my = 0; my < mbh; my++)
    for (int mx = 0; mx < mbw; mx++) {
      int a = my * mbw + mx;
      int y4 = 4 * my, x4 = 4 * mx;
      int p = part[a];
      if (skip[a]) {
        int32_t ps[2];
        pskip_mv4(g, y4, x4, ps);
        for (int b = 0; b < 4; b++) {
          int gy = 2 * my + (b >> 1), gx = 2 * mx + (b & 1);
          final8[(gy * w8 + gx) * 2] = ps[0];
          final8[(gy * w8 + gx) * 2 + 1] = ps[1];
        }
        g.commit(y4, x4, 4, 4, ps);
        continue;
      }
      for (int u = 0; u < NUNITS[p]; u++) {
        const int* gg = UGEOM[p][u];
        int g8 = (2 * my + gg[0] / 2) * w8 + 2 * mx + gg[1] / 2;
        int r = ref8 ? ref8[g8] : 0;
        int32_t mvp[2];
        unit_mvp4(g, y4 + gg[0], x4 + gg[1], gg[2], p, u, mvp, r);
        const int32_t* mv = &final8[g8 * 2];
        mvd[(a * 4 + u) * 2] = mv[0] - mvp[0];
        mvd[(a * 4 + u) * 2 + 1] = mv[1] - mvp[1];
        mvp_out[(a * 4 + u) * 2] = mvp[0];
        mvp_out[(a * 4 + u) * 2 + 1] = mvp[1];
        g.commit(y4 + gg[0], x4 + gg[1], gg[3], gg[2], mv, r);
      }
    }
}

// ------------------------------------------------------ 16x16 host scan ---
// MVP / P_SKIP scans of the unpartitioned P path: the reference
// package's pcamv_host_scan_p and pcamv_host_scan_p_forced, copied.
namespace {
inline void median3(const int32_t* a, const int32_t* b, const int32_t* c,
                    int32_t* out) {
  for (int i = 0; i < 2; i++) {
    int x = a[i], y = b[i], z = c[i];
    int mx = x > y ? (x > z ? x : z) : (y > z ? y : z);
    int mn = x < y ? (x < z ? x : z) : (y < z ? y : z);
    out[i] = x + y + z - mx - mn;
  }
}

static const int32_t ZERO2[2] = {0, 0};

// spec 8.4.1.3 reduced to single-ref all-inter frames (the reference
// encoder/inter.py median_mvp derives the rule)
static void mvp_16x16(const int32_t* mv, const uint8_t* avail, int mbw,
                      int mbh, int my, int mx, int32_t* out) {
  bool a_ok = mx > 0 && avail[my * mbw + mx - 1];
  bool b_ok = my > 0 && avail[(my - 1) * mbw + mx];
  bool c_ok = my > 0 && mx + 1 < mbw && avail[(my - 1) * mbw + mx + 1];
  bool d_ok = my > 0 && mx > 0 && avail[(my - 1) * mbw + mx - 1];
  const int32_t* A = a_ok ? &mv[(my * mbw + mx - 1) * 2] : ZERO2;
  const int32_t* B = b_ok ? &mv[((my - 1) * mbw + mx) * 2] : ZERO2;
  const int32_t* C = ZERO2;
  bool c_use = false;
  if (c_ok) { C = &mv[((my - 1) * mbw + mx + 1) * 2]; c_use = true; }
  else if (d_ok) { C = &mv[((my - 1) * mbw + mx - 1) * 2]; c_use = true; }
  if (!b_ok && !c_use && a_ok) { out[0] = A[0]; out[1] = A[1]; return; }
  int n_ok = (int)a_ok + (int)b_ok + (int)c_use;
  if (n_ok == 1) {
    const int32_t* s = a_ok ? A : b_ok ? B : C;
    out[0] = s[0]; out[1] = s[1];
    return;
  }
  median3(A, B, C, out);
}

static void pskip_16x16(const int32_t* mv, const uint8_t* avail, int mbw,
                        int mbh, int my, int mx, int32_t* out) {
  bool a_ok = mx > 0 && avail[my * mbw + mx - 1];
  bool b_ok = my > 0 && avail[(my - 1) * mbw + mx];
  if (!a_ok || !b_ok) { out[0] = out[1] = 0; return; }
  const int32_t* A = &mv[(my * mbw + mx - 1) * 2];
  const int32_t* B = &mv[((my - 1) * mbw + mx) * 2];
  if ((A[0] == 0 && A[1] == 0) || (B[0] == 0 && B[1] == 0)) {
    out[0] = out[1] = 0;
    return;
  }
  mvp_16x16(mv, avail, mbw, mbh, my, mx, out);
}
}  // namespace

extern "C" void pcamv_host_scan_p(const int32_t* mv, const int32_t* cbp_luma,
                                  const int32_t* cbp_chroma, int mbw,
                                  int mbh, uint8_t* skip_out,
                                  int32_t* mvd_out, int32_t* mvp_out) {
  std::vector<uint8_t> avail(mbw * mbh, 0);
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      int a = my * mbw + mx;
      int32_t mvp[2], ps[2];
      mvp_16x16(mv, avail.data(), mbw, mbh, my, mx, mvp);
      pskip_16x16(mv, avail.data(), mbw, mbh, my, mx, ps);
      const int32_t* here = &mv[a * 2];
      skip_out[a] = (cbp_luma[a] == 0 && cbp_chroma[a] == 0 &&
                     here[0] == ps[0] && here[1] == ps[1]);
      mvd_out[a * 2] = here[0] - mvp[0];
      mvd_out[a * 2 + 1] = here[1] - mvp[1];
      mvp_out[a * 2] = mvp[0];
      mvp_out[a * 2 + 1] = mvp[1];
      avail[a] = 1;
    }
  }
}

extern "C" void pcamv_host_scan_p_forced(const int32_t* mv,
                                         const uint8_t* skip, int mbw,
                                         int mbh, int32_t* final_mv,
                                         int32_t* mvd_out) {
  int n = mbw * mbh;
  std::memcpy(final_mv, mv, n * 2 * sizeof(int32_t));
  std::vector<uint8_t> avail(n, 0);
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      int a = my * mbw + mx;
      if (skip[a]) {
        pskip_16x16(final_mv, avail.data(), mbw, mbh, my, mx,
                    &final_mv[a * 2]);
        mvd_out[a * 2] = mvd_out[a * 2 + 1] = 0;
      } else {
        int32_t mvp[2];
        mvp_16x16(final_mv, avail.data(), mbw, mbh, my, mx, mvp);
        mvd_out[a * 2] = final_mv[a * 2] - mvp[0];
        mvd_out[a * 2 + 1] = final_mv[a * 2 + 1] - mvp[1];
      }
      avail[a] = 1;
    }
  }
}
