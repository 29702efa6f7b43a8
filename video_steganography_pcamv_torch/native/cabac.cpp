// Native CABAC entropy coder for I, P and 16x16 B slices: the port's copy
// of the reference package's native/cabac.cpp. C++
// twin of encoder/cabac.py's CabacSliceWriter (the tests hold them
// bit-identical). After x264's encoder/cabac.c:781 and the
// common/cabac.c engine; implements the spec 9.3 algorithms with the
// normative tables in cabac_tables.inc.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

#include "cabac_tables.inc"

namespace {

struct CabacBits {
  uint8_t* buf;
  long cap;
  long bytes = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  CabacBits(uint8_t* b, long c) : buf(b), cap(c) {}
  inline void bit(int b) {
    acc = (acc << 1) | (unsigned)b;
    if (++nbits == 8) {
      nbits = 0;
      if (bytes >= cap) { overflow = true; return; }
      buf[bytes++] = (uint8_t)(acc & 0xFF);
      acc = 0;
    }
  }
};

struct Cabac {
  uint8_t state[460];
  uint8_t mps[460];
  int low = 0, range = 510;
  bool first = true;
  int outstanding = 0;
  CabacBits* out;

  void init(int qp, bool is_i, int model) {
    const int8_t(*tab)[2] =
        is_i ? CTX_INIT_I : CTX_INIT_PB[model];
    for (int i = 0; i < 460; i++) {
      int pre = ((tab[i][0] * qp) >> 4) + tab[i][1];
      pre = pre < 1 ? 1 : pre > 126 ? 126 : pre;
      if (pre > 63) { state[i] = pre - 64; mps[i] = 1; }
      else { state[i] = 63 - pre; mps[i] = 0; }
    }
  }
  inline void put(int b) {
    if (first) first = false;
    else out->bit(b);
    while (outstanding > 0) { out->bit(1 - b); outstanding--; }
  }
  inline void renorm() {
    while (range < 256) {
      if (low >= 512) { put(1); low -= 512; }
      else if (low < 256) put(0);
      else { outstanding++; low -= 256; }
      low <<= 1; range <<= 1;
    }
  }
  inline void dec(int ctx, int b) {
    int st = state[ctx];
    int rlps = RANGE_LPS[st][(range >> 6) & 3];
    range -= rlps;
    if (b != mps[ctx]) {
      low += range;
      range = rlps;
      if (st == 0) mps[ctx] ^= 1;
      state[ctx] = TRANS_LPS[st];
    } else {
      state[ctx] = TRANS_MPS[st];
    }
    renorm();
  }
  inline void bypass(int b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 1024) { put(1); low -= 1024; }
    else if (low < 512) put(0);
    else { outstanding++; low -= 512; }
  }
  inline void terminal(int b) {
    range -= 2;
    if (b) {
      low += range;
      range = 2;
      renorm();
      put((low >> 9) & 1);
      out->bit((low >> 8) & 1);
      out->bit(1);
    } else {
      renorm();
    }
  }
  inline void ue_bypass(int k, int val) {
    while (val >= (1 << k)) { bypass(1); val -= 1 << k; k++; }
    bypass(0);
    while (k > 0) { k--; bypass((val >> k) & 1); }
  }
};

// ---- slice-level context maps (mirrors CabacSliceWriter) ----
struct CabacCtxMaps {
  int mbw, mbh;
  std::vector<int32_t> nnz_y, nnz_c, dc_nz_y, dc_nz_c, mb_kind, cbp,
      modes4, mvd4, mvd4_1, ref4, cmode_map;
  std::vector<uint8_t> bdirect;
  CabacCtxMaps(int w, int h) : mbw(w), mbh(h),
      nnz_y(16 * w * h, 0), nnz_c(8 * w * h, 0), dc_nz_y(w * h, 0),
      dc_nz_c(2 * w * h, 0), mb_kind(w * h, -1), cbp(w * h, 0),
      modes4(16 * w * h, 2), mvd4(32 * w * h, 0), mvd4_1(32 * w * h, 0),
      ref4(16 * w * h, 0), cmode_map(w * h, 0), bdirect(w * h, 0) {}
  inline int kind(int my, int mx) const { return mb_kind[my * mbw + mx]; }
  inline int& ny(int y, int x) { return nnz_y[y * 4 * mbw + x]; }
  inline int& nc(int ch, int y, int x) {
    return nnz_c[(ch * 2 * mbh + y) * 2 * mbw + x];
  }
  inline int& m4(int y, int x) { return modes4[y * 4 * mbw + x]; }
  inline int32_t& md(int y, int x, int c) {
    return mvd4[(y * 4 * mbw + x) * 2 + c];
  }
  inline int32_t& md1(int y, int x, int c) {
    return mvd4_1[(y * 4 * mbw + x) * 2 + c];
  }
  inline int32_t& rf(int y, int x) { return ref4[y * 4 * mbw + x]; }
};

static const int LSCAN[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                              8, 9, 12, 13, 10, 11, 14, 15};
static const int ZIG[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                            9, 12, 13, 10, 7, 11, 14, 15};
static const int CAT_MAXC[6] = {16, 15, 16, 4, 15, 64};
static const int SIG_OFF[6] = {105, 120, 134, 149, 152, 402};
static const int LAST_OFF[6] = {166, 181, 195, 210, 213, 417};
static const int ABS_OFF[6] = {227, 237, 247, 257, 266, 426};
// cat-5 significance maps, frame-coded (encoder/cabac.c:551-568)
static const int SIG8_CTX[63] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12};
static const int LAST8_CTX[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};
// 8x8 frame zigzag (raster indices per scan position)
static const int ZIG8[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
static const int LV1_CTX[8] = {1, 2, 3, 4, 0, 0, 0, 0};
static const int LVG_CTX[8] = {5, 5, 5, 5, 6, 7, 8, 9};
static const int LV_TR[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                {4, 4, 4, 4, 5, 6, 7, 7}};

struct CabacSlice {
  Cabac cb;
  CabacCtxMaps m;
  bool is_i;
  bool is_b = false;
  bool trans8_mode = false;
  std::vector<int> t8map;   // per-MB transform_size flag as coded
  // adaptive quantization: each MB's qp (null: every delta 0), the last
  // coded qp and the previous MB's coded delta (0 where it coded none)
  const int32_t* qp_grid = nullptr;
  int last_qp = 0;
  int last_dqp = 0;
  CabacSlice(int w, int h, int qp, bool slice_is_i, int model)
      : m(w, h), is_i(slice_is_i), t8map(w * h, 0), last_qp(qp) {
    cb.init(qp, slice_is_i, model);
  }

  // mb_qp_delta of MB a (x264_cabac_mb_qp_delta, encoder/cabac.c:265):
  // the delta to the last coded qp folded into [-26, 25] (spec 7.4.5),
  // unary of its se mapping on ctx 60 + (previous MB coded a nonzero
  // delta), then 62, then 63; the Python twin is encoder/cabac.py's
  // qp_delta
  void qp_delta(int a) {
    int dqp = 0;
    if (qp_grid != nullptr) {
      const int q = qp_grid[a];
      dqp = ((q - last_qp + 26) % 52 + 52) % 52 - 26;
      last_qp = q;
    }
    int ctx = last_dqp ? 1 : 0;
    if (dqp != 0) {
      int val = dqp <= 0 ? -2 * dqp : 2 * dqp - 1;
      if (val >= 51 && val != 52) val = 103 - val;  // cabac.c:288
      for (; val > 0; --val) {
        cb.dec(60 + ctx, 1);
        ctx = 2 + (ctx >> 1);
      }
    }
    cb.dec(60 + ctx, 0);
    last_dqp = dqp;
  }

  // transform_size_8x8_flag: ctx 399 + available-neighbour flags
  // (x264_cabac_mb_transform_size, encoder/cabac.c:369-373)
  void transform_size_flag(int my, int mx, int flag) {
    int ctx = 399;
    if (mx > 0 && m.kind(my, mx - 1) >= 0 &&
        t8map[my * m.mbw + mx - 1]) ctx++;
    if (my > 0 && m.kind(my - 1, mx) >= 0 &&
        t8map[(my - 1) * m.mbw + mx]) ctx++;
    cb.dec(ctx, flag ? 1 : 0);
    t8map[my * m.mbw + mx] = flag ? 1 : 0;
  }

  // A sibling block inside the current MB (my,mx) is always available
  // with its already-coded cbf (spec 9.3.3.1.1.9; z-scan order writes
  // left/top siblings first) even though mb_kind is stamped at MB end.
  int nz_nb(bool luma, int ch, int y, int x, bool cur_intra,
            int my, int mx) {
    int H = luma ? 4 * m.mbh : 2 * m.mbh;
    int W = luma ? 4 * m.mbw : 2 * m.mbw;
    if (y < 0 || x < 0 || y >= H || x >= W) return cur_intra ? 1 : 0;
    int step = luma ? 4 : 2;
    if ((y / step != my || x / step != mx) &&
        m.kind(y / step, x / step) < 0) return cur_intra ? 1 : 0;
    int v = luma ? m.ny(y, x) : m.nc(ch, y, x);
    return v ? 1 : 0;
  }

  int cbf_ctx(int cat, int my, int mx, int by, int bx, int ch,
              bool cur_intra) {
    int a, b;
    if (cat == 1 || cat == 2) {
      a = nz_nb(true, 0, by, bx - 1, cur_intra, my, mx);
      b = nz_nb(true, 0, by - 1, bx, cur_intra, my, mx);
    } else if (cat == 4) {
      a = nz_nb(false, ch, by, bx - 1, cur_intra, my, mx);
      b = nz_nb(false, ch, by - 1, bx, cur_intra, my, mx);
    } else if (cat == 0) {
      a = (mx > 0 && m.kind(my, mx - 1) >= 0)
              ? m.dc_nz_y[my * m.mbw + mx - 1] : 1;
      b = (my > 0 && m.kind(my - 1, mx) >= 0)
              ? m.dc_nz_y[(my - 1) * m.mbw + mx] : 1;
    } else {  // chroma DC
      a = (mx > 0 && m.kind(my, mx - 1) >= 0)
              ? m.dc_nz_c[(ch * m.mbh + my) * m.mbw + mx - 1]
              : (cur_intra ? 1 : 0);
      b = (my > 0 && m.kind(my - 1, mx) >= 0)
              ? m.dc_nz_c[(ch * m.mbh + my - 1) * m.mbw + mx]
              : (cur_intra ? 1 : 0);
    }
    return 85 + 4 * cat + 2 * b + a;
  }

  // levels in scan order; returns total_coeff
  int residual(int cat, const int* lv, int my, int mx, int by, int bx,
               int ch, bool cur_intra) {
    int count = CAT_MAXC[cat];
    int nz[64], total = 0, last = -1;
    for (int i = 0; i < count; i++)
      if (lv[i]) { nz[total++] = i; last = i; }
    bool is8 = cat == 5;   // cat 5: no coded_block_flag (cbp gates)
    if (!is8) {
      int ctx = cbf_ctx(cat, my, mx, by, bx, ch, cur_intra);
      if (!total) { cb.dec(ctx, 0); return 0; }
      cb.dec(ctx, 1);
    }
    if (is8 && !total) return 0;   // cbp gates cat-5 calls
    int sb = SIG_OFF[cat], lb = LAST_OFF[cat], ab = ABS_OFF[cat];
    int lim = last + 1 < count - 1 ? last + 1 : count - 1;
    for (int i = 0; i < lim; i++) {
      int sig = lv[i] ? 1 : 0;
      cb.dec(sb + (is8 ? SIG8_CTX[i] : i), sig);
      if (sig) cb.dec(lb + (is8 ? LAST8_CTX[i] : i), i == last ? 1 : 0);
    }
    int node = 0;
    for (int k = total - 1; k >= 0; k--) {
      int v = lv[nz[k]];
      int am1 = (v < 0 ? -v : v) - 1;
      int prefix = am1 < 14 ? am1 : 14;
      int c = ab + LV1_CTX[node];
      if (prefix) {
        cb.dec(c, 1);
        c = ab + LVG_CTX[node];
        for (int i = 0; i < prefix - 1; i++) cb.dec(c, 1);
        if (prefix < 14) cb.dec(c, 0);
        else cb.ue_bypass(0, am1 - 14);
        node = LV_TR[1][node];
      } else {
        cb.dec(c, 0);
        node = LV_TR[0][node];
      }
      cb.bypass(v < 0 ? 1 : 0);
    }
    return total;
  }

  void skip_flag(int my, int mx, int b_skip) {
    int ctx = is_b ? 24 : 11;  // encoder/cabac.c:300-306
    if (mx > 0 && m.kind(my, mx - 1) > 0) ctx++;
    if (my > 0 && m.kind(my - 1, mx) > 0) ctx++;
    cb.dec(ctx, b_skip);
  }

  // B mb_type, 16x16 subset (encoder/cabac.c:123-192 B branch)
  void mb_type_b(int my, int mx, int btype) {
    int ctx = 0;
    if (mx > 0 && m.kind(my, mx - 1) > 0 &&
        !m.bdirect[my * m.mbw + mx - 1]) ctx++;
    if (my > 0 && m.kind(my - 1, mx) > 0 &&
        !m.bdirect[(my - 1) * m.mbw + mx]) ctx++;
    if (btype == 0) { cb.dec(27 + ctx, 0); return; }
    cb.dec(27 + ctx, 1);
    if (btype == 1) { cb.dec(30, 0); cb.dec(32, 0); return; }
    if (btype == 2) { cb.dec(30, 0); cb.dec(32, 1); return; }
    cb.dec(30, 1); cb.dec(31, 0);                 // BI: "110000"
    cb.dec(32, 0); cb.dec(32, 0); cb.dec(32, 0);
  }

  // ref_idx_l0 unary (x264_cabac_mb_ref, encoder/cabac.c:375-395)
  void ref_one(int gy4, int gx4, int h4, int w4, int ref) {
    int a = gx4 > 0 ? m.rf(gy4, gx4 - 1) : 0;
    int b = gy4 > 0 ? m.rf(gy4 - 1, gx4) : 0;
    int ctx = (a > 0 ? 1 : 0) + (b > 0 ? 2 : 0);
    int k = ref;
    while (k) {
      cb.dec(54 + ctx, 1);
      ctx = ctx < 4 ? 4 : 5;
      k--;
    }
    cb.dec(54 + ctx, 0);
    for (int y = gy4; y < gy4 + h4; y++)
      for (int x = gx4; x < gx4 + w4; x++) m.rf(y, x) = ref;
  }

  void mb_type_intra(bool i4, int mode16, int cbpl, int cbpc, int c0,
                     int c1, int c2, int c3, int c4, int c5) {
    if (i4) { cb.dec(c0, 0); return; }
    cb.dec(c0, 1);
    cb.terminal(0);
    cb.dec(c1, cbpl ? 1 : 0);
    if (cbpc == 0) cb.dec(c2, 0);
    else { cb.dec(c2, 1); cb.dec(c3, cbpc != 1); }
    cb.dec(c4, (mode16 >> 1) & 1);
    cb.dec(c5, mode16 & 1);
  }

  void mvd_one(int gy4, int gx4, int h4, int w4, int mdx, int mdy,
               int lst = 0) {
    static const int ctxes[9] = {0, 3, 4, 5, 6, 6, 6, 6, 6};
    int vals[2] = {mdx, mdy};
    for (int comp = 0; comp < 2; comp++) {
      int a = gx4 > 0 ? std::abs(lst ? m.md1(gy4, gx4 - 1, comp)
                                     : m.md(gy4, gx4 - 1, comp)) : 0;
      int b = gy4 > 0 ? std::abs(lst ? m.md1(gy4 - 1, gx4, comp)
                                     : m.md(gy4 - 1, gx4, comp)) : 0;
      int amvd = a + b;
      int base = comp ? 47 : 40;
      int ctx = (amvd > 2) + (amvd > 32);
      int v = vals[comp];
      int iabs = std::abs(v);
      if (iabs == 0) {
        cb.dec(base + ctx, 0);
      } else if (iabs < 9) {
        cb.dec(base + ctx, 1);
        for (int i = 1; i < iabs; i++) cb.dec(base + ctxes[i], 1);
        cb.dec(base + ctxes[iabs], 0);
        cb.bypass(v < 0);
      } else {
        cb.dec(base + ctx, 1);
        for (int i = 1; i < 9; i++) cb.dec(base + ctxes[i], 1);
        cb.ue_bypass(3, iabs - 9);
        cb.bypass(v < 0);
      }
    }
    for (int y = gy4; y < gy4 + h4; y++)
      for (int x = gx4; x < gx4 + w4; x++) {
        if (lst) { m.md1(y, x, 0) = mdx; m.md1(y, x, 1) = mdy; }
        else { m.md(y, x, 0) = mdx; m.md(y, x, 1) = mdy; }
      }
  }

  void cbp_luma(int my, int mx, int cbp) {
    int cl = (mx > 0 && m.kind(my, mx - 1) >= 0)
                 ? m.cbp[my * m.mbw + mx - 1] : 0x3f;
    int ct = (my > 0 && m.kind(my - 1, mx) >= 0)
                 ? m.cbp[(my - 1) * m.mbw + mx] : 0x3f;
    cb.dec(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2), (cbp >> 0) & 1);
    cb.dec(76 - ((cbp >> 0) & 1) - ((ct >> 2) & 2), (cbp >> 1) & 1);
    cb.dec(76 - ((cl >> 3) & 1) - ((cbp << 1) & 2), (cbp >> 2) & 1);
    cb.dec(76 - ((cbp >> 2) & 1) - ((cbp >> 0) & 2), (cbp >> 3) & 1);
  }

  void cbp_chroma(int my, int mx, int cbpc) {
    bool al = mx > 0 && m.kind(my, mx - 1) >= 0;
    bool at = my > 0 && m.kind(my - 1, mx) >= 0;
    int ca = al ? (m.cbp[my * m.mbw + mx - 1] >> 4) : 0;
    int ct = at ? (m.cbp[(my - 1) * m.mbw + mx] >> 4) : 0;
    int ctx = ((al && ca) ? 1 : 0) + ((at && ct) ? 2 : 0);
    cb.dec(77 + ctx, cbpc ? 1 : 0);
    if (cbpc) {
      int ctx2 = 4 + ((al && ca == 2) ? 1 : 0) + ((at && ct == 2) ? 2 : 0);
      cb.dec(77 + ctx2, cbpc > 1);
    }
  }

  void chroma_pred_mode(int my, int mx, int cmode) {
    int ctx = 0;
    if (mx > 0 && m.kind(my, mx - 1) >= 0 &&
        m.cmode_map[my * m.mbw + mx - 1] != 0)
      ctx++;
    if (my > 0 && m.kind(my - 1, mx) >= 0 &&
        m.cmode_map[(my - 1) * m.mbw + mx] != 0)
      ctx++;
    cb.dec(64 + ctx, cmode > 0);
    if (cmode > 0) {
      cb.dec(67, cmode > 1);
      if (cmode > 1) cb.dec(67, cmode > 2);
    }
    m.cmode_map[my * m.mbw + mx] = cmode;
  }

  void intra4x4_modes(int my, int mx, const int32_t* modes) {
    for (int blk = 0; blk < 16; blk++) {
      int braster = LSCAN[blk];
      int by = braster >> 2, bx = braster & 3;
      int gy = 4 * my + by, gx = 4 * mx + bx;
      int mode = modes[blk];
      int pm = (gx == 0 || gy == 0)
                   ? 2
                   : std::min(m.m4(gy, gx - 1), m.m4(gy - 1, gx));
      if (mode == pm) {
        cb.dec(68, 1);
      } else {
        cb.dec(68, 0);
        int rem = mode - (mode > pm ? 1 : 0);
        cb.dec(69, rem & 1);
        cb.dec(69, (rem >> 1) & 1);
        cb.dec(69, (rem >> 2) & 1);
      }
      m.m4(gy, gx) = mode;
    }
  }

  void intra8_modes(int my, int mx, const int32_t* modes8) {
    // 4 Intra_8x8 modes on the i4 ctx pair, 2x2-replicated cache
    // cells (encoder/cabac.c:827-838 di=4 loop)
    static const int Z8[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
    for (int b = 0; b < 4; b++) {
      int gy = 4 * my + 2 * Z8[b][0], gx = 4 * mx + 2 * Z8[b][1];
      int mode = modes8[b];
      int pm = (gx == 0 || gy == 0)
                   ? 2
                   : std::min(m.m4(gy, gx - 1), m.m4(gy - 1, gx));
      if (mode == pm) {
        cb.dec(68, 1);
      } else {
        cb.dec(68, 0);
        int rem = mode - (mode > pm ? 1 : 0);
        cb.dec(69, rem & 1);
        cb.dec(69, (rem >> 1) & 1);
        cb.dec(69, (rem >> 2) & 1);
      }
      for (int y = 0; y < 2; y++)
        for (int x = 0; x < 2; x++) m.m4(gy + y, gx + x) = mode;
    }
  }

  void fill_m4(int my, int mx, int v) {
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) m.m4(4 * my + y, 4 * mx + x) = v;
  }
  void clear_mvd(int my, int mx) {
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) {
        m.md(4 * my + y, 4 * mx + x, 0) = 0;
        m.md(4 * my + y, 4 * mx + x, 1) = 0;
      }
  }
  void clear_mvd1(int my, int mx) {
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) {
        m.md1(4 * my + y, 4 * mx + x, 0) = 0;
        m.md1(4 * my + y, 4 * mx + x, 1) = 0;
      }
  }
  void clear_nnz(int my, int mx, bool luma_too) {
    if (luma_too)
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) m.ny(4 * my + y, 4 * mx + x) = 0;
    for (int ch = 0; ch < 2; ch++)
      for (int y = 0; y < 2; y++)
        for (int x = 0; x < 2; x++) m.nc(ch, 2 * my + y, 2 * mx + x) = 0;
  }
};

static const int UGEOM_C[4][4][4] = {
    {{0, 0, 4, 4}, {0}, {0}, {0}},
    {{0, 0, 4, 2}, {2, 0, 4, 2}, {0}, {0}},
    {{0, 0, 2, 4}, {0, 2, 2, 4}, {0}, {0}},
    {{0, 0, 2, 2}, {0, 2, 2, 2}, {2, 0, 2, 2}, {2, 2, 2, 2}}};
static const int NUNITS_C[4] = {1, 2, 2, 4};

void luma_res_i16(CabacSlice& S, int my, int mx, const int32_t* dc,
                  const int32_t* blocks, int cbpl) {
  int z[16];
  for (int i = 0; i < 16; i++) z[i] = dc[ZIG[i]];
  int nzdc = S.residual(0, z, my, mx, 0, 0, 0, true);
  S.m.dc_nz_y[my * S.m.mbw + mx] = nzdc ? 1 : 0;
  for (int blk = 0; blk < 16; blk++) {
    int braster = LSCAN[blk];
    int by = braster >> 2, bx = braster & 3;
    int yy = 4 * my + by, xx = 4 * mx + bx;
    if (cbpl) {
      int zz[16];
      for (int i = 0; i < 16; i++) zz[i] = blocks[braster * 16 + ZIG[i]];
      S.m.ny(yy, xx) = S.residual(1, zz + 1, my, mx, yy, xx, 0, true);
    } else {
      S.m.ny(yy, xx) = 0;
    }
  }
}

void luma_res_4x4(CabacSlice& S, int my, int mx, const int32_t* blocks,
                  int cbpl, bool intra) {
  for (int blk = 0; blk < 16; blk++) {
    int braster = LSCAN[blk];
    int by = braster >> 2, bx = braster & 3;
    int yy = 4 * my + by, xx = 4 * mx + bx;
    if (cbpl & (1 << (blk >> 2))) {
      int zz[16];
      for (int i = 0; i < 16; i++) zz[i] = blocks[braster * 16 + ZIG[i]];
      S.m.ny(yy, xx) = S.residual(2, zz, my, mx, yy, xx, 0, intra);
    } else {
      S.m.ny(yy, xx) = 0;
    }
  }
}

void luma_res_8x8(CabacSlice& S, int my, int mx,
                  const int32_t* lev8 /* [4][64] raster z-order */,
                  int cbpl, bool intra) {
  // one cat-5 block per coded 8x8 (cabac.c:994-999); nnz cells take
  // the 8x8's nonzero flag replicated 2x2 (STORE_8x8_NNZ)
  static const int Z8[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}};
  for (int b = 0; b < 4; b++) {
    int cy = 4 * my + 2 * Z8[b][0], cx = 4 * mx + 2 * Z8[b][1];
    if (cbpl & (1 << b)) {
      int zz[64];
      for (int i = 0; i < 64; i++) zz[i] = lev8[b * 64 + ZIG8[i]];
      int n = S.residual(5, zz, my, mx, 0, 0, 0, intra);
      for (int y = 0; y < 2; y++)
        for (int x = 0; x < 2; x++) S.m.ny(cy + y, cx + x) = n ? 1 : 0;
    } else {
      for (int y = 0; y < 2; y++)
        for (int x = 0; x < 2; x++) S.m.ny(cy + y, cx + x) = 0;
    }
  }
}

void chroma_res(CabacSlice& S, int my, int mx, int cbpc,
                const int32_t* cdc, const int32_t* cac, bool intra) {
  for (int ch = 0; ch < 2; ch++) {
    if (cbpc) {
      int lv[4] = {cdc[ch * 4 + 0], cdc[ch * 4 + 1], cdc[ch * 4 + 2],
                   cdc[ch * 4 + 3]};
      int nz = S.residual(3, lv, my, mx, 0, 0, ch, intra);
      S.m.dc_nz_c[(ch * S.m.mbh + my) * S.m.mbw + mx] = nz ? 1 : 0;
    } else {
      S.m.dc_nz_c[(ch * S.m.mbh + my) * S.m.mbw + mx] = 0;
    }
  }
  for (int ch = 0; ch < 2; ch++) {
    for (int blk = 0; blk < 4; blk++) {
      int by = blk >> 1, bx = blk & 1;
      int yy = 2 * my + by, xx = 2 * mx + bx;
      if (cbpc == 2) {
        int zz[16];
        for (int i = 0; i < 16; i++)
          zz[i] = cac[(ch * 4 + blk) * 16 + ZIG[i]];
        S.m.nc(ch, yy, xx) = S.residual(4, zz + 1, my, mx, yy, xx, ch,
                                        intra);
      } else {
        S.m.nc(ch, yy, xx) = 0;
      }
    }
  }
}

}  // namespace

extern "C" long pcamv_write_slice_cabac(
    uint8_t* out, long out_cap, const uint8_t* header, int header_nbits,
    int slice_type, int mbw, int mbh, int qp, int model,
    const uint8_t* skip, const int32_t* part, const int32_t* mvd4,
    const int32_t* mode, const int32_t* cmode, const int32_t* cbp_luma,
    const int32_t* cbp_chroma, const int32_t* luma_dc,
    const int32_t* luma_blocks, const int32_t* chroma_dc,
    const int32_t* chroma_ac, const uint8_t* mb_i4,
    const int32_t* i4_modes, const int32_t* refs, int num_ref,
    const int32_t* sub_type, int mvd_stride,
    const uint8_t* mb_i8, const int32_t* i8_modes,
    const int32_t* luma8_lev, const int32_t* trans8,
    int trans8_mode, const int32_t* qp_grid,
    // intra MBs in a P slice (stego off): p_intra [n] marks them (null:
    // none); they take the I-slice arrays at their index, after the P
    // slice's skip flag and intra prefix (encoder/cabac.c:123-140)
    const uint8_t* p_intra) {
  CabacBits bits(out, out_cap);
  for (int i = 0; i < header_nbits; i++)
    bits.bit((header[i >> 3] >> (7 - (i & 7))) & 1);
  while (bits.nbits) bits.bit(1);  // cabac_alignment_one_bit

  bool is_i = slice_type != 0;
  CabacSlice S(mbw, mbh, qp, is_i, model);
  S.trans8_mode = trans8_mode != 0;
  S.qp_grid = qp_grid;
  S.cb.out = &bits;
  int n = mbw * mbh;
  for (int a = 0; a < n; a++) {
    int my = a / mbw, mx = a % mbw;
    if (!is_i && skip[a]) {
      S.skip_flag(my, mx, 1);
      S.clear_nnz(my, mx, true);
      S.clear_mvd(my, mx);
      S.m.dc_nz_y[a] = 0;
      S.m.dc_nz_c[my * mbw + mx] = 0;
      S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
      S.m.mb_kind[a] = 0;
      S.m.cbp[a] = 0;
      S.m.cmode_map[a] = 0;
      S.fill_m4(my, mx, 2);
      S.last_dqp = 0;
      S.cb.terminal(a == n - 1);
      continue;
    }
    bool i8 = mb_i8 && mb_i8[a];
    bool i4 = (mb_i4 && mb_i4[a]) || i8;   // I_NxN covers both
    const bool intra_p = !is_i && p_intra && p_intra[a];
    if (is_i || intra_p) {
      int cbpl = cbp_luma[a], cbpc = cbp_chroma[a];
      if (intra_p) {
        // the P slice's mb_skip_flag 0, then the intra prefix bin and
        // the I binarization on ctx 17-20
        S.skip_flag(my, mx, 0);
        S.cb.dec(14, 1);
        S.mb_type_intra(i4, mode ? mode[a] : 0, cbpl, cbpc, 17, 18, 19, 19,
                        20, 20);
      } else {
        // mb_type ctx from neighbours
        int ctx = 0;
        if (mx > 0 && S.m.kind(my, mx - 1) >= 0 &&
            S.m.kind(my, mx - 1) != 2)
          ctx++;
        if (my > 0 && S.m.kind(my - 1, mx) >= 0 &&
            S.m.kind(my - 1, mx) != 2)
          ctx++;
        S.mb_type_intra(i4, mode ? mode[a] : 0, cbpl, cbpc, 3 + ctx, 6, 7,
                        8, 9, 10);
      }
      S.clear_mvd(my, mx);
      if (i8) {
        // I_NxN with transform flag 1: i8 modes + cat-5 residual
        S.transform_size_flag(my, mx, 1);
        S.intra8_modes(my, mx, &i8_modes[a * 4]);
        S.chroma_pred_mode(my, mx, cmode[a]);
        S.cbp_luma(my, mx, cbpl);
        S.cbp_chroma(my, mx, cbpc);
        S.m.mb_kind[a] = 2;
        S.m.cbp[a] = (cbpc << 4) | cbpl;
        S.m.dc_nz_y[a] = 0;
        S.m.dc_nz_c[my * mbw + mx] = 0;
        S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
        if (cbpl || cbpc) {
          S.qp_delta(a);
          luma_res_8x8(S, my, mx, &luma8_lev[a * 256], cbpl, true);
          chroma_res(S, my, mx, cbpc, &chroma_dc[a * 8],
                     &chroma_ac[a * 128], true);
        } else {
          S.clear_nnz(my, mx, true);
          S.last_dqp = 0;
        }
        S.cb.terminal(a == n - 1);
        continue;
      }
      if (i4 && trans8_mode)
        S.transform_size_flag(my, mx, 0);
      if (i4) {
        S.intra4x4_modes(my, mx, &i4_modes[a * 16]);
        S.chroma_pred_mode(my, mx, cmode[a]);
        S.cbp_luma(my, mx, cbpl);
        S.cbp_chroma(my, mx, cbpc);
        S.m.mb_kind[a] = 2;
        S.m.cbp[a] = (cbpc << 4) | cbpl;
        S.m.dc_nz_y[a] = 0;
        S.m.dc_nz_c[my * mbw + mx] = 0;
        S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
        if (cbpl || cbpc) {
          S.qp_delta(a);
          luma_res_4x4(S, my, mx, &luma_blocks[a * 256], cbpl, true);
          chroma_res(S, my, mx, cbpc, &chroma_dc[a * 8],
                     &chroma_ac[a * 128], true);
        } else {
          S.clear_nnz(my, mx, true);
          S.last_dqp = 0;
        }
      } else {
        S.chroma_pred_mode(my, mx, cmode[a]);
        S.qp_delta(a);  // I16 always
        luma_res_i16(S, my, mx, &luma_dc[a * 16], &luma_blocks[a * 256],
                     cbpl);
        chroma_res(S, my, mx, cbpc, &chroma_dc[a * 8],
                   &chroma_ac[a * 128], true);
        S.m.mb_kind[a] = 3;
        S.m.cbp[a] = (cbpc << 4) | (cbpl ? 15 : 0);
        S.fill_m4(my, mx, 2);
      }
    } else {
      S.skip_flag(my, mx, 0);
      int p = part ? part[a] : 0;
      if (p == 0) { S.cb.dec(14, 0); S.cb.dec(15, 0); S.cb.dec(16, 0); }
      else if (p == 1) { S.cb.dec(14, 0); S.cb.dec(15, 1); S.cb.dec(17, 1); }
      else if (p == 2) { S.cb.dec(14, 0); S.cb.dec(15, 1); S.cb.dec(17, 0); }
      else { S.cb.dec(14, 0); S.cb.dec(15, 0); S.cb.dec(16, 1); }
      if (p == 3) {
        if (sub_type) {
          // sub_mb_type bins (x264_cabac_mb_sub_p_partition,
          // encoder/cabac.c:309-330)
          for (int s = 0; s < 4; s++) {
            int sv = sub_type[a * 4 + s];
            if (sv == 0) { S.cb.dec(21, 1); }
            else if (sv == 1) { S.cb.dec(21, 0); S.cb.dec(22, 0); }
            else if (sv == 2) { S.cb.dec(21, 0); S.cb.dec(22, 1);
                                S.cb.dec(23, 1); }
            else { S.cb.dec(21, 0); S.cb.dec(22, 1); S.cb.dec(23, 0); }
          }
        } else {
          for (int s = 0; s < 4; s++) S.cb.dec(21, 1);  // P_L0_8x8
        }
      }
      if (num_ref > 1) {  // ref_idx before mvds (encoder/cabac.c order)
        int n_refs = NUNITS_C[p];
        for (int k = 0; k < n_refs; k++) {
          const int* g = UGEOM_C[p][k];
          S.ref_one(4 * my + g[0], 4 * mx + g[1], g[3], g[2],
                    refs ? refs[a * 4 + k] : 0);
        }
      }
      int mst = mvd_stride > 0 ? mvd_stride : 4;
      if (p == 3 && sub_type) {
        // per-sub-unit geometry in coding order (scan.py SUB_GEOM)
        static const int SG[4][4][4] = {
            {{0, 0, 2, 2}, {0}, {0}, {0}},
            {{0, 0, 2, 1}, {1, 0, 2, 1}, {0}, {0}},
            {{0, 0, 1, 2}, {0, 1, 1, 2}, {0}, {0}},
            {{0, 0, 1, 1}, {0, 1, 1, 1}, {1, 0, 1, 1}, {1, 1, 1, 1}}};
        static const int NUS[4] = {1, 2, 2, 4};
        int u = 0;
        for (int b = 0; b < 4; b++) {
          int boy = 2 * (b >> 1), box = 2 * (b & 1);
          int sv = sub_type[a * 4 + b];
          for (int k = 0; k < NUS[sv]; k++) {
            const int* g = SG[sv][k];
            S.mvd_one(4 * my + boy + g[0], 4 * mx + box + g[1],
                      g[3], g[2], mvd4[(a * mst + u) * 2],
                      mvd4[(a * mst + u) * 2 + 1]);
            u++;
          }
        }
      } else {
        for (int u = 0; u < NUNITS_C[p]; u++) {
          const int* g = UGEOM_C[p][u];
          S.mvd_one(4 * my + g[0], 4 * mx + g[1], g[3], g[2],
                    mvd4[(a * mst + u) * 2],
                    mvd4[(a * mst + u) * 2 + 1]);
        }
      }
      int cbpl = cbp_luma[a], cbpc = cbp_chroma[a];
      S.cbp_luma(my, mx, cbpl);
      S.cbp_chroma(my, mx, cbpc);
      int t8 = trans8 ? trans8[a] : 0;
      // noSubMbPartSizeLessThan8x8Flag (spec 7.3.5): no flag on an MB
      // with a sub-partition under 8x8
      bool t8_allowed = true;
      if (p == 3 && sub_type)
        for (int s = 0; s < 4; s++)
          if (sub_type[a * 4 + s] != 0) t8_allowed = false;
      if (trans8_mode && cbpl && t8_allowed)
        S.transform_size_flag(my, mx, t8);
      S.m.mb_kind[a] = 1;
      S.m.cbp[a] = (cbpc << 4) | cbpl;
      S.m.cmode_map[a] = 0;
      S.fill_m4(my, mx, 2);
      S.m.dc_nz_y[a] = 0;
      S.m.dc_nz_c[my * mbw + mx] = 0;
      S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
      if (cbpl || cbpc) {
        S.qp_delta(a);
        if (t8 && cbpl)
          luma_res_8x8(S, my, mx, &luma8_lev[a * 256], cbpl, false);
        else
          luma_res_4x4(S, my, mx, &luma_blocks[a * 256], cbpl, false);
        chroma_res(S, my, mx, cbpc, &chroma_dc[a * 8],
                   &chroma_ac[a * 128], false);
      } else {
        S.clear_nnz(my, mx, true);
        S.last_dqp = 0;
      }
    }
    S.cb.terminal(a == n - 1);
  }
  // pad the rbsp to a byte boundary
  while (bits.nbits) bits.bit(0);
  return bits.overflow ? -1 : bits.bytes;
}


extern "C" long pcamv_write_slice_cabac_b(
    uint8_t* out, long out_cap, const uint8_t* header, int header_nbits,
    int mbw, int mbh, int qp, int model, const int32_t* mode,
    const int32_t* mvd0, const int32_t* mvd1, const int32_t* cbp_luma,
    const int32_t* cbp_chroma, const int32_t* luma_blocks,
    const int32_t* chroma_dc, const int32_t* chroma_ac) {
  // CABAC B slice, 16x16 subset; Python twin:
  // encoder/core.py _write_b_slice_cabac
  CabacBits bits(out, out_cap);
  for (int i = 0; i < header_nbits; i++)
    bits.bit((header[i >> 3] >> (7 - (i & 7))) & 1);
  while (bits.nbits) bits.bit(1);

  CabacSlice S(mbw, mbh, qp, false, model);
  S.is_b = true;
  S.cb.out = &bits;
  int n = mbw * mbh;
  for (int a = 0; a < n; a++) {
    int my = a / mbw, mx = a % mbw;
    int btype = mode[a];
    int cbpl = cbp_luma[a], cbpc = cbp_chroma[a];
    if (btype == 0 && cbpl == 0 && cbpc == 0) {  // B_SKIP
      S.skip_flag(my, mx, 1);
      S.clear_nnz(my, mx, true);
      S.clear_mvd(my, mx);
      S.clear_mvd1(my, mx);
      S.m.dc_nz_y[a] = 0;
      S.m.dc_nz_c[my * mbw + mx] = 0;
      S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
      S.m.mb_kind[a] = 0;
      S.m.bdirect[a] = 1;
      S.m.cbp[a] = 0;
      S.m.cmode_map[a] = 0;
      S.fill_m4(my, mx, 2);
      S.cb.terminal(a == n - 1);
      continue;
    }
    S.skip_flag(my, mx, 0);
    S.mb_type_b(my, mx, btype);
    if (btype == 1 || btype == 3)
      S.mvd_one(4 * my, 4 * mx, 4, 4, mvd0[a * 2], mvd0[a * 2 + 1], 0);
    else
      S.clear_mvd(my, mx);
    if (btype == 2 || btype == 3)
      S.mvd_one(4 * my, 4 * mx, 4, 4, mvd1[a * 2], mvd1[a * 2 + 1], 1);
    else
      S.clear_mvd1(my, mx);
    S.cbp_luma(my, mx, cbpl);
    S.cbp_chroma(my, mx, cbpc);
    S.m.mb_kind[a] = 1;
    S.m.bdirect[a] = btype == 0;
    S.m.cbp[a] = (cbpc << 4) | cbpl;
    S.m.cmode_map[a] = 0;
    S.fill_m4(my, mx, 2);
    S.m.dc_nz_y[a] = 0;
    S.m.dc_nz_c[my * mbw + mx] = 0;
    S.m.dc_nz_c[(mbh + my) * mbw + mx] = 0;
    if (cbpl || cbpc) {
      S.cb.dec(60, 0);  // mb_qp_delta == 0
      luma_res_4x4(S, my, mx, &luma_blocks[a * 256], cbpl, false);
      chroma_res(S, my, mx, cbpc, &chroma_dc[a * 8],
                 &chroma_ac[a * 128], false);
    } else {
      S.clear_nnz(my, mx, true);
    }
    S.cb.terminal(a == n - 1);
  }
  while (bits.nbits) bits.bit(0);
  return bits.overflow ? -1 : bits.bytes;
}
