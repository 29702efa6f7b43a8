"""CABAC decoding engine + I/P/B slice parser (verification decoder;
the port's copy of the reference's decoder/cabac_dec.py).

Spec 9.3.3.2 arithmetic decoder (InitDecoding/DecodeDecision/
DecodeBypass/DecodeTerminate) with the same normative tables as the
encoder (encoder/cabac_tables.py), and the inverse of every
binarization/context rule in encoder/cabac.py. Cross-checks the
encoder: encode -> this decoder -> bit-exact reconstruction.
"""

from __future__ import annotations

import numpy as np

from ..encoder.cabac_tables import (init_states, RANGE_TAB_LPS,
                                    TRANS_IDX_MPS, TRANS_IDX_LPS)
from ..encoder.cabac import (_SIG_OFF, _LAST_OFF, _ABS_OFF, _MAXC,
                             _LEVEL1_CTX, _LEVELGT1_CTX, _LEVEL_TRANS,
                             CAT_LUMA_DC, CAT_LUMA_AC, CAT_LUMA_4x4,
                             CAT_CHROMA_DC, CAT_CHROMA_AC, CAT_LUMA_8x8,
                             SIG8_CTX, LAST8_CTX, LUMA_SCAN, CHROMA_SCAN,
                             B_TYPE_BINS, _B_GEOM)
from ..encoder.vlc_tables import B_CODE_USES, B_SUB_USES
from .decoder import mb_units

# bins tuple -> B mb_type ue code (the writer's B_TYPE_BINS inverted; the
# binarization is prefix-free)
_B_TYPE_INV = {tuple(v): k for k, v in B_TYPE_BINS.items()}


class CabacDecoder:
    """Arithmetic decoding engine (spec 9.3.3.2)."""

    def __init__(self, br, qp: int, slice_is_i: bool, model: int = 0):
        st, mps = init_states(qp, slice_is_i, model)
        self.state = st.copy()
        self.mps = mps.copy()
        self.br = br
        self.range = 510
        self.offset = br.read(9)

    def _renorm(self):
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.br.read1()

    def decision(self, ctx: int) -> int:
        st = int(self.state[ctx])
        rlps = int(RANGE_TAB_LPS[st][(self.range >> 6) & 3])
        self.range -= rlps
        if self.offset >= self.range:
            b = 1 - int(self.mps[ctx])
            self.offset -= self.range
            self.range = rlps
            if st == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = TRANS_IDX_LPS[st]
        else:
            b = int(self.mps[ctx])
            self.state[ctx] = TRANS_IDX_MPS[st]
        self._renorm()
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self.br.read1()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminal(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        self._renorm()
        return 0

    def ue_bypass(self, k: int) -> int:
        val = 0
        while self.bypass():
            val += 1 << k
            k += 1
        while k > 0:
            k -= 1
            val += self.bypass() << k
        return val


class CabacSliceParser:
    """Context bookkeeping + syntax parse, exact inverse of
    encoder/cabac.py's CabacSliceWriter."""

    def __init__(self, br, mbw, mbh, qp, slice_is_i, model=0,
                 num_ref=1, slice_is_b=False, trans8_mode=False,
                 b_t8_present=None):
        """b_t8_present(mb_type, subs): whether a coded B MB with luma
        residual carries transform_size_8x8_flag (the decoder's
        `b_t8_present`)."""
        self.cd = CabacDecoder(br, qp, slice_is_i, model)
        self.b_t8_present = b_t8_present
        self.slice_is_b = slice_is_b
        self.qp = qp                 # running luma QP (mb_qp_delta)
        self.last_dqp = 0
        self.prev_coded = 0
        self.num_ref = num_ref
        self.trans8_mode = trans8_mode
        self.trans8_map = np.zeros((mbh, mbw), np.int32)
        self.mbw, self.mbh = mbw, mbh
        self.nnz_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.nnz_c = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        self.dc_nz_y = np.zeros((mbh, mbw), np.int32)
        self.dc_nz_c = np.zeros((2, mbh, mbw), np.int32)
        self.mb_kind = np.full((mbh, mbw), -1, np.int32)
        self.cbp = np.zeros((mbh, mbw), np.int32)
        self.modes4 = np.full((4 * mbh, 4 * mbw), 2, np.int32)
        self.mvd4 = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)
        self.mvd4_1 = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)
        self.ref4 = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.bdirect = np.zeros((mbh, mbw), bool)
        self.cmode_map = np.zeros((mbh, mbw), np.int32)

    # context helpers (identical derivations to the writer)
    def _nz(self, luma, ch, by, bx, cur_intra, my=-1, mx=-1):
        """Sibling blocks inside the current MB (my,mx) are always
        available with their already-parsed cbf (spec 9.3.3.1.1.9);
        mb_kind is only stamped at the end of the MB."""
        arr = self.nnz_y if luma else self.nnz_c[ch]
        h, w = arr.shape

        def one(y, x):
            if y < 0 or x < 0 or y >= h or x >= w:
                return 1 if cur_intra else 0
            step = 4 if luma else 2
            if (y // step, x // step) != (my, mx) \
                    and self.mb_kind[y // step, x // step] < 0:
                return 1 if cur_intra else 0
            return 1 if arr[y, x] else 0
        return one(by, bx - 1), one(by - 1, bx)

    def _cbf_ctx(self, cat, my, mx, by, bx, ch, cur_intra):
        if cat in (CAT_LUMA_AC, CAT_LUMA_4x4):
            a, b = self._nz(True, 0, by, bx, cur_intra, my, mx)
        elif cat == CAT_CHROMA_AC:
            a, b = self._nz(False, ch, by, bx, cur_intra, my, mx)
        elif cat == CAT_LUMA_DC:
            a = (self.dc_nz_y[my, mx - 1] if mx > 0
                 and self.mb_kind[my, mx - 1] >= 0 else 1)
            b = (self.dc_nz_y[my - 1, mx] if my > 0
                 and self.mb_kind[my - 1, mx] >= 0 else 1)
        else:
            a = (self.dc_nz_c[ch, my, mx - 1] if mx > 0
                 and self.mb_kind[my, mx - 1] >= 0
                 else (1 if cur_intra else 0))
            b = (self.dc_nz_c[ch, my - 1, mx] if my > 0
                 and self.mb_kind[my - 1, mx] >= 0
                 else (1 if cur_intra else 0))
        return 85 + 4 * cat + 2 * int(b) + int(a)

    def residual(self, cat, my, mx, by=0, bx=0, ch=0, cur_intra=False):
        """Returns levels list (scan order, cat's max length)."""
        cd = self.cd
        count = _MAXC[cat]
        out = [0] * count
        if cat != CAT_LUMA_8x8:   # cat 5 has no coded_block_flag
            if not cd.decision(self._cbf_ctx(cat, my, mx, by, bx, ch,
                                             cur_intra)):
                return out
        sig_base, last_base, lvl_base = \
            _SIG_OFF[cat], _LAST_OFF[cat], _ABS_OFF[cat]
        is8 = cat == CAT_LUMA_8x8
        sig = []
        last_found = False
        for i in range(count - 1):
            if cd.decision(sig_base + (SIG8_CTX[i] if is8 else i)):
                sig.append(i)
                if cd.decision(last_base + (LAST8_CTX[i] if is8 else i)):
                    last_found = True
                    break
        if not last_found:
            # the final position's significance is inferred (the writer
            # never codes sig/last for count-1)
            sig.append(count - 1)
        node = 0
        for i in reversed(sig):
            prefix = 0
            ctx = lvl_base + _LEVEL1_CTX[node]
            if cd.decision(ctx):
                prefix = 1
                ctx = lvl_base + _LEVELGT1_CTX[node]
                while prefix < 14 and cd.decision(ctx):
                    prefix += 1
                if prefix == 14:
                    prefix += cd.ue_bypass(0)
                node = _LEVEL_TRANS[1][node]
            else:
                node = _LEVEL_TRANS[0][node]
            mag = prefix + 1
            sign = cd.bypass()
            out[i] = -mag if sign else mag
        return out

    def transform_size_flag(self, my, mx) -> int:
        """transform_size_8x8_flag (inverse of the writer's; ctx 399 +
        available-neighbour trans8 flags)."""
        ctx = 399
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.trans8_map[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.trans8_map[my - 1, mx]:
            ctx += 1
        flag = self.cd.decision(ctx)
        self.trans8_map[my, mx] = flag
        return flag

    def skip_flag(self, my, mx):
        ctx = 24 if self.slice_is_b else 11
        if mx > 0 and self.mb_kind[my, mx - 1] > 0:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0:
            ctx += 1
        return self.cd.decision(ctx)

    def mb_type_i_slice(self, my, mx):
        """Returns (i4, mode16, cbp_luma_flag, cbp_chroma) — i16 header
        fields are inside mb_type for I_16x16."""
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.mb_kind[my, mx - 1] != 2:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.mb_kind[my - 1, mx] != 2:
            ctx += 1
        return self._mb_type_intra(3 + ctx, 6, 7, 8, 9, 10)

    def _mb_type_intra(self, c0, c1, c2, c3, c4, c5):
        cd = self.cd
        if not cd.decision(c0):
            return True, 0, 0, 0
        t = cd.terminal()
        assert t == 0, "I_PCM unsupported"
        cbp_l = cd.decision(c1)
        if cd.decision(c2):
            cbp_c = 2 if cd.decision(c3) else 1
        else:
            cbp_c = 0
        m = cd.decision(c4) << 1
        m |= cd.decision(c5)
        return False, m, cbp_l, cbp_c

    def mb_type_p(self):
        """Returns (is_intra, part or intra tuple)."""
        cd = self.cd
        if cd.decision(14):
            return True, self._mb_type_intra(17, 18, 19, 19, 20, 20)
        if cd.decision(15):
            return False, 1 if cd.decision(17) else 2
        return False, 3 if cd.decision(16) else 0

    def sub_mb_type(self):
        """P sub_mb_type (inverse of x264_cabac_mb_sub_p_partition,
        encoder/cabac.c:309-330): 0=8x8, 1=8x4, 2=4x8, 3=4x4."""
        if self.cd.decision(21):
            return 0
        if not self.cd.decision(22):
            return 1
        return 2 if self.cd.decision(23) else 3

    def ref_idx(self, gy4, gx4, h4, w4):
        """ref_idx_l0 (inverse of x264_cabac_mb_ref,
        encoder/cabac.c:375-395)."""
        a = int(self.ref4[gy4, gx4 - 1]) if gx4 > 0 else 0
        b = int(self.ref4[gy4 - 1, gx4]) if gy4 > 0 else 0
        ctx = (1 if a > 0 else 0) + (2 if b > 0 else 0)
        ref = 0
        while self.cd.decision(54 + ctx):
            ctx = 4 if ctx < 4 else 5
            ref += 1
            assert ref < 32
        self.ref4[gy4:gy4 + h4, gx4:gx4 + w4] = ref
        return ref

    def intra4x4_modes(self, my, mx):
        cd = self.cd
        modes = np.zeros(16, np.int32)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            gy, gx = 4 * my + by, 4 * mx + bx
            pm = 2 if (gx == 0 or gy == 0) else \
                int(min(self.modes4[gy, gx - 1], self.modes4[gy - 1, gx]))
            if cd.decision(68):
                m = pm
            else:
                rem = cd.decision(69)
                rem |= cd.decision(69) << 1
                rem |= cd.decision(69) << 2
                m = rem + (1 if rem >= pm else 0)
            modes[blk] = m
            self.modes4[gy, gx] = m
        return modes

    _Z8 = ((0, 0), (0, 1), (1, 0), (1, 1))

    def intra8_modes(self, my, mx):
        """4 Intra_8x8 pred modes (di=4 loop, reference cabac.c:833);
        modes replicate into the 2x2 ctx cells."""
        cd = self.cd
        modes = np.zeros(4, np.int32)
        for b, (by8, bx8) in enumerate(self._Z8):
            gy, gx = 4 * my + 2 * by8, 4 * mx + 2 * bx8
            pm = 2 if (gx == 0 or gy == 0) else \
                int(min(self.modes4[gy, gx - 1], self.modes4[gy - 1, gx]))
            if cd.decision(68):
                m = pm
            else:
                rem = cd.decision(69)
                rem |= cd.decision(69) << 1
                rem |= cd.decision(69) << 2
                m = rem + (1 if rem >= pm else 0)
            modes[b] = m
            self.modes4[gy:gy + 2, gx:gx + 2] = m
        return modes

    def chroma_pred_mode(self, my, mx):
        cd = self.cd
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.cmode_map[my, mx - 1] != 0:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.cmode_map[my - 1, mx] != 0:
            ctx += 1
        if not cd.decision(64 + ctx):
            cmode = 0
        elif not cd.decision(67):
            cmode = 1
        elif not cd.decision(67):
            cmode = 2
        else:
            cmode = 3
        self.cmode_map[my, mx] = cmode
        return cmode

    def mvd(self, gy4, gx4, h4, w4, lst: int = 0):
        cd = self.cd
        cache = self.mvd4 if lst == 0 else self.mvd4_1
        out = []
        for comp in range(2):
            a = (abs(int(cache[gy4, gx4 - 1, comp]))
                 if gx4 > 0 else 0)
            b = (abs(int(cache[gy4 - 1, gx4, comp]))
                 if gy4 > 0 else 0)
            amvd = a + b
            ctxbase = 40 if comp == 0 else 47
            ctx = (1 if amvd > 2 else 0) + (1 if amvd > 32 else 0)
            ctxes = [0, 3, 4, 5, 6, 6, 6, 6, 6]
            if not cd.decision(ctxbase + ctx):
                out.append(0)
                continue
            iabs = 1
            while iabs < 9 and cd.decision(ctxbase + ctxes[iabs]):
                iabs += 1
            if iabs == 9:
                iabs += cd.ue_bypass(3)
            sign = cd.bypass()
            out.append(-iabs if sign else iabs)
        cache[gy4:gy4 + h4, gx4:gx4 + w4] = out
        return out

    def cbp_luma(self, my, mx):
        cd = self.cd
        cl = self.cbp[my, mx - 1] if mx > 0 \
            and self.mb_kind[my, mx - 1] >= 0 else 0x3f
        ct = self.cbp[my - 1, mx] if my > 0 \
            and self.mb_kind[my - 1, mx] >= 0 else 0x3f
        cbp = 0
        cbp |= cd.decision(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2))
        cbp |= cd.decision(76 - ((cbp >> 0) & 1) - ((ct >> 2) & 2)) << 1
        cbp |= cd.decision(76 - ((cl >> 3) & 1) - ((cbp << 1) & 2)) << 2
        cbp |= cd.decision(76 - ((cbp >> 2) & 1) - ((cbp >> 0) & 2)) << 3
        return cbp

    def cbp_chroma(self, my, mx):
        cd = self.cd
        al = mx > 0 and self.mb_kind[my, mx - 1] >= 0
        at = my > 0 and self.mb_kind[my - 1, mx] >= 0
        ca = (self.cbp[my, mx - 1] >> 4) if al else 0
        ct = (self.cbp[my - 1, mx] >> 4) if at else 0
        ctx = (1 if (al and ca) else 0) + (2 if (at and ct) else 0)
        if not cd.decision(77 + ctx):
            return 0
        ctx2 = 4 + (1 if (al and ca == 2) else 0) \
            + (2 if (at and ct == 2) else 0)
        return 2 if cd.decision(77 + ctx2) else 1

    def qp_delta_zero(self):
        return self.qp_delta()

    def qp_delta(self):
        """mb_qp_delta parse (inverse of the writer's qp_delta): unary
        on ctx 60 + (prev coded nonzero dqp), then 62, then 63; updates
        the running QP chain."""
        ctx = 1 if (self.last_dqp and self.prev_coded) else 0
        val = 0
        while self.cd.decision(60 + ctx):
            val += 1
            ctx = 2 + (ctx >> 1)
            # legal max is 52: dqp = -26 (spec 7.4.5 range [-26,25])
            # is the one value the writer's 103-fold exempts
            assert val <= 52, "mb_qp_delta unary overrun"
        dqp = (val + 1) >> 1 if val & 1 else -(val >> 1)
        self.last_dqp = dqp
        self.qp = (self.qp + dqp + 52) % 52   # spec 7.4.5 QP chain
        return dqp

    def end_mb(self):
        return self.cd.terminal()

    # ------------------------------------------------------------------
    # Whole-MB parsers (exact inverses of CabacSliceWriter's writers,
    # with identical context-map bookkeeping)
    # ------------------------------------------------------------------
    _UGEOM = {0: [(0, 0, 4, 4)],
              1: [(0, 0, 4, 2), (2, 0, 4, 2)],
              2: [(0, 0, 2, 4), (0, 2, 2, 4)],
              3: [(0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2),
                  (2, 2, 2, 2)]}

    def _luma_residual_i16(self, my, mx, cbp_luma):
        gy, gx = 4 * my, 4 * mx
        dc = self.residual(CAT_LUMA_DC, my, mx, cur_intra=True)
        self.dc_nz_y[my, mx] = 1 if any(dc) else 0
        acs = np.zeros((4, 4, 16), np.int64)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma:
                lv = self.residual(CAT_LUMA_AC, my, mx, yy, xx,
                                   cur_intra=True)
                self.nnz_y[yy, xx] = sum(1 for x in lv if x)
                acs[by, bx, 1:] = lv
            else:
                self.nnz_y[yy, xx] = 0
        return dc, acs

    def _luma_residual_4x4(self, my, mx, cbp_luma, intra):
        gy, gx = 4 * my, 4 * mx
        blocks = np.zeros((4, 4, 16), np.int64)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                lv = self.residual(CAT_LUMA_4x4, my, mx, yy, xx,
                                   cur_intra=intra)
                self.nnz_y[yy, xx] = sum(1 for x in lv if x)
                blocks[by, bx] = lv
            else:
                self.nnz_y[yy, xx] = 0
        return blocks

    def _luma_residual_8x8(self, my, mx, cbp_luma, intra):
        """Returns lev8 [2,2,64] zigzag8-order levels; nnz cells get
        the 8x8's nonzero flag replicated 2x2 (STORE_8x8_NNZ)."""
        gy, gx = 4 * my, 4 * mx
        lev8 = np.zeros((2, 2, 64), np.int64)
        for b, (by8, bx8) in enumerate(self._Z8):
            ys = slice(gy + 2 * by8, gy + 2 * by8 + 2)
            xs = slice(gx + 2 * bx8, gx + 2 * bx8 + 2)
            if cbp_luma & (1 << b):
                lv = self.residual(CAT_LUMA_8x8, my, mx,
                                   cur_intra=intra)
                lev8[by8, bx8] = lv
                self.nnz_y[ys, xs] = 1 if any(lv) else 0
            else:
                self.nnz_y[ys, xs] = 0
        return lev8

    def parse_i8_mb(self, my, mx):
        """After mb_type + transform flag 1: returns (modes8, cmode,
        cbp_luma, cbp_chroma, lev8, cdcs, cacs)."""
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        if self.slice_is_b:
            self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        modes8 = self.intra8_modes(my, mx)
        cmode = self.chroma_pred_mode(my, mx)
        cbp_luma = self.cbp_luma(my, mx)
        cbp_chroma = self.cbp_chroma(my, mx)
        self.mb_kind[my, mx] = 2
        self.cbp[my, mx] = (cbp_chroma << 4) | cbp_luma
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp_luma or cbp_chroma:
            self.qp_delta_zero()
            lev8 = self._luma_residual_8x8(my, mx, cbp_luma, True)
            cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma, True)
        else:
            self.last_dqp = 0
            lev8 = np.zeros((2, 2, 64), np.int64)
            cdcs = np.zeros((2, 4), np.int64)
            cacs = np.zeros((2, 2, 2, 16), np.int64)
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if (cbp_luma or cbp_chroma) else 0
        return modes8, cmode, cbp_luma, cbp_chroma, lev8, cdcs, cacs

    def _chroma_residual(self, my, mx, cbp_chroma, intra):
        gy, gx = 2 * my, 2 * mx
        dcs = np.zeros((2, 4), np.int64)
        acs = np.zeros((2, 2, 2, 16), np.int64)
        for ch in range(2):
            if cbp_chroma:
                lv = self.residual(CAT_CHROMA_DC, my, mx, ch=ch,
                                   cur_intra=intra)
                dcs[ch] = lv
                self.dc_nz_c[ch, my, mx] = 1 if any(lv) else 0
            else:
                self.dc_nz_c[ch, my, mx] = 0
        for ch in range(2):
            for blk in range(4):
                by, bx = CHROMA_SCAN[blk]
                yy, xx = gy + by, gx + bx
                if cbp_chroma == 2:
                    lv = self.residual(CAT_CHROMA_AC, my, mx, yy, xx,
                                       ch=ch, cur_intra=intra)
                    self.nnz_c[ch, yy, xx] = sum(1 for x in lv if x)
                    acs[ch, by, bx, 1:] = lv
                else:
                    self.nnz_c[ch, yy, xx] = 0
        return dcs, acs

    def _clear_mb_ctx(self, my, mx):
        self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0

    def parse_i16_mb(self, my, mx, mode16, cbpl_flag, cbp_chroma):
        """After mb_type: returns (cmode, dc, acs, cdcs, cacs)."""
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        if self.slice_is_b:
            self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        cmode = self.chroma_pred_mode(my, mx)
        self.qp_delta_zero()
        dc, acs = self._luma_residual_i16(my, mx, cbpl_flag)
        cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma, True)
        self.mb_kind[my, mx] = 3
        self.prev_coded = 1            # I_16x16 (cabac.c:282)
        self.cbp[my, mx] = (cbp_chroma << 4) | (15 if cbpl_flag else 0)
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2
        return cmode, dc, acs, cdcs, cacs

    def parse_i4_mb(self, my, mx):
        """After mb_type bin: returns (modes, cmode, cbp_luma,
        cbp_chroma, blocks, cdcs, cacs)."""
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        if self.slice_is_b:
            self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        modes = self.intra4x4_modes(my, mx)
        cmode = self.chroma_pred_mode(my, mx)
        cbp_luma = self.cbp_luma(my, mx)
        cbp_chroma = self.cbp_chroma(my, mx)
        self.mb_kind[my, mx] = 2
        self.cbp[my, mx] = (cbp_chroma << 4) | cbp_luma
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp_luma or cbp_chroma:
            self.qp_delta_zero()
            blocks = self._luma_residual_4x4(my, mx, cbp_luma, True)
            cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma, True)
        else:
            self.last_dqp = 0
            blocks = np.zeros((4, 4, 16), np.int64)
            cdcs = np.zeros((2, 4), np.int64)
            cacs = np.zeros((2, 2, 2, 16), np.int64)
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if (cbp_luma or cbp_chroma) else 0
        return modes, cmode, cbp_luma, cbp_chroma, blocks, cdcs, cacs

    def parse_p_mb(self, my, mx, part):
        """After mb_type: returns (mvds [units][2], cbp_luma,
        cbp_chroma, blocks, cdcs, cacs)."""
        if part == 3:
            subs = [self.sub_mb_type() for _ in range(4)]
            geom = mb_units(3, subs)
            ref_geom = self._UGEOM[3]
        else:
            subs = None
            geom = self._UGEOM[part]
            ref_geom = geom
        refs = [0] * len(ref_geom)
        if self.num_ref > 1:
            refs = [self.ref_idx(4 * my + oy, 4 * mx + ox, h4, w4)
                    for (oy, ox, w4, h4) in ref_geom]
        mvds = []
        for (oy, ox, w4, h4) in geom:
            mvds.append(self.mvd(4 * my + oy, 4 * mx + ox, h4, w4))
        cbp_luma = self.cbp_luma(my, mx)
        cbp_chroma = self.cbp_chroma(my, mx)
        trans8 = 0
        # flag absent when any sub-partition is < 8x8 (spec 7.3.5
        # noSubMbPartSizeLessThan8x8Flag; sub_mb_type 0 is P_L0_8x8)
        if self.trans8_mode and cbp_luma \
                and (subs is None or all(st == 0 for st in subs)):
            trans8 = self.transform_size_flag(my, mx)
        self.mb_kind[my, mx] = 1
        self.cbp[my, mx] = (cbp_chroma << 4) | cbp_luma
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        lev8 = None
        if cbp_luma or cbp_chroma:
            self.qp_delta_zero()
            if trans8:
                blocks = np.zeros((4, 4, 16), np.int64)
                lev8 = self._luma_residual_8x8(my, mx, cbp_luma, False)
            else:
                blocks = self._luma_residual_4x4(my, mx, cbp_luma,
                                                 False)
            cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma, False)
        else:
            self.last_dqp = 0
            blocks = np.zeros((4, 4, 16), np.int64)
            cdcs = np.zeros((2, 4), np.int64)
            cacs = np.zeros((2, 2, 2, 16), np.int64)
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if (cbp_luma or cbp_chroma) else 0
        return ((mvds, subs, refs), cbp_luma, cbp_chroma, blocks, cdcs,
                cacs, lev8)

    def parse_skip_mb(self, my, mx):
        self._clear_mb_ctx(my, mx)
        self.last_dqp = 0
        self.prev_coded = 0
        self.mb_kind[my, mx] = 0
        self.cbp[my, mx] = 0
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2

    # ------------------------------------------------------------------
    # B slices (inverse of the writer's mb_type_b(_bins) / write_b_mb(_ext)
    # / write_b_skip_mb)
    # ------------------------------------------------------------------
    def mb_type_b(self, my, mx) -> int:
        """Returns the spec Table 7-14 ue code: 0 direct, 1-3 16x16
        L0/L1/BI, 4-21 two-partition list combos, 22 B_8x8 (inverse of
        the writer's mb_type_b/mb_type_b_bins; reference
        encoder/cabac.c:123-192 i_mb_bits). Returns 23 on the
        intra-in-B prefix 111101 (the caller parses the intra suffix with
        `mb_type_b_intra_suffix`)."""
        cd = self.cd
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] > 0 \
                and not self.bdirect[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0 \
                and not self.bdirect[my - 1, mx]:
            ctx += 1
        if not cd.decision(27 + ctx):
            return 0
        b1 = cd.decision(30)
        b2 = cd.decision(32 - b1)
        bins = (1, b1, b2)
        while bins not in _B_TYPE_INV:
            if bins == (1, 1, 1, 1, 0, 1):   # intra-in-B prefix
                return 23
            assert len(bins) < 7, \
                f"unsupported B mb_type bins {bins}"
            bins = bins + (cd.decision(32),)
        return _B_TYPE_INV[bins]

    def mb_type_b_intra_suffix(self):
        """The intra suffix after the B intra prefix (inverse of the
        writer's mb_type_b_intra): the I slice's binarization on ctx 32 +
        0/1/2/2/3/3. Returns (i4, mode16, cbpl_flag, cbp_chroma)."""
        return self._mb_type_intra(32, 33, 34, 34, 35, 35)

    def sub_mb_type_b(self) -> int:
        """B sub_mb_type, 8x8 subset (inverse of the writer's
        sub_mb_type_b; reference x264_cabac_mb_sub_b_partition,
        encoder/cabac.c:332-367): 0 direct / 1 L0 / 2 L1 / 3 BI.
        Asserts on sub-8x8 splits (not emitted)."""
        cd = self.cd
        if not cd.decision(36):
            return 0
        if not cd.decision(37):
            return 2 if cd.decision(39) else 1
        assert not cd.decision(38), "B sub-8x8 splits unsupported"
        bits = (cd.decision(39), cd.decision(39))
        assert bits == (0, 0), \
            f"B sub-8x8 splits unsupported (suffix {bits})"
        return 3

    def parse_b_mb_parts(self, my, mx, code):
        """After a partition mb_type (codes 4-22): returns (subs,
        mvds [2][n_units] of (x, y) or None, cbp_luma, cbp_chroma,
        blocks, cdcs, cacs). Twin of the writer's write_b_mb_ext
        (all-L0-then-all-L1 mvd order)."""
        y4, x4 = 4 * my, 4 * mx
        if code == 22:
            subs = [self.sub_mb_type_b() for _ in range(4)]
            geom = _B_GEOM[3]
            uses = ([B_SUB_USES[s][0] for s in subs],
                    [B_SUB_USES[s][1] for s in subs])
            dirs = {b for b in range(4) if subs[b] == 0}
        else:
            _n, u0, u1 = B_CODE_USES[code]
            geom = _B_GEOM[1 if code % 2 == 0 else 2]
            uses = (list(u0), list(u1))
            dirs = set()
            subs = None
        # ref_idx_l0 per L0-using non-direct unit (multi-ref B lists;
        # refs before mvds, spec 7.3.5.1/7.3.5.2). The ref ctx cache
        # stays 0 for direct/L1-only units (spec 9.3.3.1.1.6).
        refs_u = [0] * len(geom)
        for u, ((oy, ox), h4, w4) in enumerate(geom):
            if uses[0][u] and u not in dirs and self.num_ref > 1:
                refs_u[u] = self.ref_idx(y4 + oy, x4 + ox, h4, w4)
            else:
                self.ref4[y4 + oy:y4 + oy + h4,
                          x4 + ox:x4 + ox + w4] = 0
        mvds = [[None] * len(geom), [None] * len(geom)]
        for li in (0, 1):
            cache = self.mvd4 if li == 0 else self.mvd4_1
            for u, ((oy, ox), h4, w4) in enumerate(geom):
                if uses[li][u] and u not in dirs:
                    mvds[li][u] = self.mvd(y4 + oy, x4 + ox, h4, w4,
                                           lst=li)
                else:
                    cache[y4 + oy:y4 + oy + h4,
                          x4 + ox:x4 + ox + w4] = 0
        cbp_luma = self.cbp_luma(my, mx)
        cbp_chroma = self.cbp_chroma(my, mx)
        self._b_transform_flag(my, mx, code, subs, cbp_luma)
        self.mb_kind[my, mx] = 1
        self.bdirect[my, mx] = False
        self.cbp[my, mx] = (cbp_chroma << 4) | cbp_luma
        self.cmode_map[my, mx] = 0
        self.modes4[y4:y4 + 4, x4:x4 + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp_luma or cbp_chroma:
            self.qp_delta_zero()
            blocks = self._luma_residual_4x4(my, mx, cbp_luma, False)
            cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma,
                                               False)
        else:
            self.last_dqp = 0
            blocks = np.zeros((4, 4, 16), np.int64)
            cdcs = np.zeros((2, 4), np.int64)
            cacs = np.zeros((2, 2, 2, 16), np.int64)
            self.nnz_y[y4:y4 + 4, x4:x4 + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if (cbp_luma or cbp_chroma) else 0
        return (subs, mvds, cbp_luma, cbp_chroma, blocks, cdcs,
                cacs, refs_u)

    def parse_b_skip_mb(self, my, mx):
        self._clear_mb_ctx(my, mx)
        self.last_dqp = 0
        self.prev_coded = 0
        self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.mb_kind[my, mx] = 0
        self.bdirect[my, mx] = True
        self.cbp[my, mx] = 0
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2

    def _b_transform_flag(self, my, mx, mb_type, subs, cbp_luma):
        """A coded B MB's transform_size_8x8_flag, where the spec puts
        one; the 8x8 transform itself is refused (neither encoder codes
        it in a B MB)."""
        if self.trans8_mode and cbp_luma \
                and self.b_t8_present(mb_type, subs) \
                and self.transform_size_flag(my, mx):
            raise NotImplementedError("the 8x8 transform in B MBs")

    def parse_b_mb(self, my, mx, btype):
        """After mb_type: returns (mvd0, mvd1, cbp_luma, cbp_chroma,
        blocks, cdcs, cacs, ref0). ref_idx_l0 parsed before the mvds
        when the slice's L0 list has >1 entry (multi-ref B lists);
        the ref ctx cache stays 0 for direct/L1-only MBs (spec
        9.3.3.1.1.6)."""
        y4, x4 = 4 * my, 4 * mx
        mvd0 = [0, 0]
        mvd1 = [0, 0]
        ref0 = 0
        if btype in (1, 3):
            if self.num_ref > 1:
                ref0 = self.ref_idx(y4, x4, 4, 4)
            else:
                self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        else:
            self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        if btype in (1, 3):
            mvd0 = self.mvd(y4, x4, 4, 4, lst=0)
        else:
            self.mvd4[y4:y4 + 4, x4:x4 + 4] = 0
        if btype in (2, 3):
            mvd1 = self.mvd(y4, x4, 4, 4, lst=1)
        else:
            self.mvd4_1[y4:y4 + 4, x4:x4 + 4] = 0
        cbp_luma = self.cbp_luma(my, mx)
        cbp_chroma = self.cbp_chroma(my, mx)
        self._b_transform_flag(my, mx, btype, None, cbp_luma)
        self.mb_kind[my, mx] = 1
        self.bdirect[my, mx] = btype == 0
        self.cbp[my, mx] = (cbp_chroma << 4) | cbp_luma
        self.cmode_map[my, mx] = 0
        self.modes4[y4:y4 + 4, x4:x4 + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp_luma or cbp_chroma:
            self.qp_delta_zero()
            blocks = self._luma_residual_4x4(my, mx, cbp_luma, False)
            cdcs, cacs = self._chroma_residual(my, mx, cbp_chroma,
                                               False)
        else:
            self.last_dqp = 0
            blocks = np.zeros((4, 4, 16), np.int64)
            cdcs = np.zeros((2, 4), np.int64)
            cacs = np.zeros((2, 2, 2, 16), np.int64)
            self.nnz_y[y4:y4 + 4, x4:x4 + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if (cbp_luma or cbp_chroma) else 0
        return (mvd0, mvd1, cbp_luma, cbp_chroma, blocks, cdcs, cacs,
                ref0)
