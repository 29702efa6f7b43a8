"""Host-side CABAC entropy coder for I, P and B slices (the port's copy
of the reference's encoder/cabac.py).

After x264's encoder/cabac.c (x264_macroblock_write_cabac :781,
binarizations + context increments) and common/cabac.c:787-927 (the
arithmetic engine), written from the normative algorithms (ITU-T H.264
9.3): the arithmetic core follows the spec's flowcharts (9.3.4.2
EncodeDecision / PutBit with firstBitFlag and bitsOutstanding), the
binarizations follow Tables 9-36..9-39, and the context increments
follow 9.3.3.1.

Coverage: I slices (I_16x16, I_NxN with the 4x4 or 8x8 transform), P
slices (P_SKIP, P_L0 16x16/16x8/8x16, P_8x8 with L0_8x8 subs, the 8x8
transform, ref_idx, intra in P), B slices (B_Skip, B_Direct_16x16,
the 16x16 L0/L1/BI types, the 16x8/8x16 list combos and B_8x8 with
direct/L0/L1/BI subs, ref_idx_l0, intra MBs), 4:2:0. The I/P part is the Python
twin of the native writer (`native.write_slice_cabac`), which the
encoder calls for I and P slices; B slices take this writer, as in the
reference when its B MBs carry a reference index.
"""
from __future__ import annotations

import numpy as np
from .cabac_tables import (init_states, RANGE_TAB_LPS, TRANS_IDX_MPS,
                           TRANS_IDX_LPS)
from ..utils.bitstream import BitWriter
from .vlc_tables import B_CODE_USES, B_SUB_USES
from ..ops.transform import ZIGZAG_4x4

# luma blkIdx -> (by, bx) and chroma blkIdx -> (by, bx) (spec 6.4.3)
LUMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
             (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
CHROMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1)]


def zigzag(block4x4: np.ndarray) -> list[int]:
    return [int(block4x4[r, c]) for r, c in ZIGZAG_4x4]



# ctxBlockCat (spec Table 9-42; cat 5 = 8x8 luma, High profile)
(CAT_LUMA_DC, CAT_LUMA_AC, CAT_LUMA_4x4, CAT_CHROMA_DC, CAT_CHROMA_AC,
 CAT_LUMA_8x8) = range(6)
_SIG_OFF = [105, 120, 134, 149, 152, 402]   # significant_coeff_flag
_LAST_OFF = [166, 181, 195, 210, 213, 417]  # last_significant_coeff_flag
_ABS_OFF = [227, 237, 247, 257, 266, 426]   # coeff_abs_level_minus1
_MAXC = [16, 15, 16, 4, 15, 64]             # coeffs per cat

# cat-5 significance-map context mappings, frame-coded (spec Table 9-43
# scanning-position -> ctx increment; reference encoder/cabac.c:551-568
# significant_coeff_flag_offset_8x8[0] / last_coeff_flag_offset_8x8).
# Interlace is formally waived (frame_mbs_only), so only the frame rows.
SIG8_CTX = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12)
LAST8_CTX = (
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8)

# node-context chains for coeff_abs_level (spec 9.3.3.1.1.9 semantics)
_LEVEL1_CTX = [1, 2, 3, 4, 0, 0, 0, 0]
_LEVELGT1_CTX = [5, 5, 5, 5, 6, 7, 8, 9]
_LEVEL_TRANS = [[1, 2, 3, 3, 4, 5, 6, 7],
                [4, 4, 4, 4, 5, 6, 7, 7]]


class CabacEncoder:
    """Arithmetic encoding engine (spec 9.3.4.2-9.3.4.6)."""

    def __init__(self, qp: int, slice_is_i: bool, model: int = 0):
        st, mps = init_states(qp, slice_is_i, model)
        self.state = st.copy()
        self.mps = mps.copy()
        self.low = 0
        self.range = 510
        self.first = True
        self.outstanding = 0
        self.bits: list[int] = []

    # ---- bit plumbing (PutBit, 9.3.4.2) ----
    def _put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.bits.append(b)
        while self.outstanding > 0:
            self.bits.append(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    # ---- coding primitives ----
    def decision(self, ctx: int, b: int):
        st = int(self.state[ctx])
        rlps = int(RANGE_TAB_LPS[st][(self.range >> 6) & 3])
        self.range -= rlps
        if b != int(self.mps[ctx]):
            self.low += self.range
            self.range = rlps
            if st == 0:
                self.mps[ctx] ^= 1
            self.state[ctx] = TRANS_IDX_LPS[st]
        else:
            self.state[ctx] = TRANS_IDX_MPS[st]
        self._renorm()

    def bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def terminal(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            # EncodeFlush (9.3.4.6)
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bits.append((self.low >> 8) & 1)
            self.bits.append(1)  # stop bit
        else:
            self._renorm()

    def ue_bypass(self, k: int, val: int):
        """Exp-Golomb-k suffix in bypass mode (UEGk suffix)."""
        while val >= (1 << k):
            self.bypass(1)
            val -= 1 << k
            k += 1
        self.bypass(0)
        while k > 0:
            k -= 1
            self.bypass((val >> k) & 1)

    def flush_to(self, bw: BitWriter):
        for b in self.bits:
            bw.write1(b)
        # cabac slice data ends with the flush's stop bit; pad the rbsp
        # to a byte boundary with zero bits (spec 7.3.2.10)
        while bw.bit_length() % 8:
            bw.write1(0)


# B mb_type binarizations beyond the 16x16 subset, keyed by the spec
# Table 7-14 ue code (reference i_mb_bits / mb_type_b_to_golomb tables,
# encoder/cabac.c:157-181 + cavlc.c:44-49). Rows (selA*3+selB) order.
_I_MB_BITS = (
    ((1, 1, 0, 0, 0, 1), (1, 1, 0, 0, 1, 0)),       # L0 L0
    ((1, 1, 0, 1, 0, 1), (1, 1, 0, 1, 1, 0)),       # L0 L1
    ((1, 1, 1, 0, 0, 0, 0), (1, 1, 1, 0, 0, 0, 1)),  # L0 BI
    ((1, 1, 0, 1, 1, 1), (1, 1, 1, 1, 1, 0)),       # L1 L0
    ((1, 1, 0, 0, 1, 1), (1, 1, 0, 1, 0, 0)),       # L1 L1
    ((1, 1, 1, 0, 0, 1, 0), (1, 1, 1, 0, 0, 1, 1)),  # L1 BI
    ((1, 1, 1, 0, 1, 0, 0), (1, 1, 1, 0, 1, 0, 1)),  # BI L0
    ((1, 1, 1, 0, 1, 1, 0), (1, 1, 1, 0, 1, 1, 1)),  # BI L1
    ((1, 1, 1, 1, 0, 0, 0), (1, 1, 1, 1, 0, 0, 1)),  # BI BI
)
_GOLOMB_16X8 = (4, 8, 12, 10, 6, 14, 16, 18, 20)
_GOLOMB_8X16 = (5, 9, 13, 11, 7, 15, 17, 19, 21)
B_TYPE_BINS = {1: (1, 0, 0), 2: (1, 0, 1), 3: (1, 1, 0, 0, 0, 0),
               22: (1, 1, 1, 1, 1, 1)}
for _r in range(9):
    B_TYPE_BINS[_GOLOMB_16X8[_r]] = _I_MB_BITS[_r][0]
    B_TYPE_BINS[_GOLOMB_8X16[_r]] = _I_MB_BITS[_r][1]

# unit geometry per B shape: ((oy4, ox4), h4, w4) per unit
_B_GEOM = {
    1: [((0, 0), 2, 4), ((2, 0), 2, 4)],
    2: [((0, 0), 4, 2), ((0, 2), 4, 2)],
    3: [((0, 0), 2, 2), ((0, 2), 2, 2), ((2, 0), 2, 2),
        ((2, 2), 2, 2)],
}


class CabacSliceWriter:
    """Per-frame CABAC syntax writer (x264_macroblock_write_cabac)."""

    def __init__(self, mbw: int, mbh: int, qp: int, slice_is_i: bool,
                 model: int = 0, slice_is_b: bool = False,
                 trans8_mode: bool = False):
        self.mbw, self.mbh = mbw, mbh
        self.cb = CabacEncoder(qp, slice_is_i, model)
        self.slice_is_i = slice_is_i
        self.slice_is_b = slice_is_b
        self.trans8_mode = trans8_mode   # PPS transform_8x8_mode_flag
        self.trans8_map = np.zeros((mbh, mbw), np.int32)
        self.last_dqp = 0                # mb_qp_delta ctx chain state
        self.prev_coded = 0              # prev MB I16-or-cbp flag
        # context maps
        self.nnz_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.nnz_c = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        self.dc_nz_y = np.zeros((mbh, mbw), np.int32)       # i16 DC cbf
        self.dc_nz_c = np.zeros((2, mbh, mbw), np.int32)    # chroma DC cbf
        self.mb_kind = np.full((mbh, mbw), -1, np.int32)    # -1 none,
        # 0 skip, 1 inter, 2 intra-i4, 3 intra-i16
        self.cbp = np.zeros((mbh, mbw), np.int32)           # (chroma<<4)|luma
        self.modes4 = np.full((4 * mbh, 4 * mbw), 2, np.int32)
        self.mvd4 = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)
        self.mvd4_1 = np.zeros((4 * mbh, 4 * mbw, 2), np.int32)  # B L1
        self.ref4 = np.zeros((4 * mbh, 4 * mbw), np.int32)  # L0 refs
        self.bdirect = np.zeros((mbh, mbw), bool)   # B_Skip/B_Direct
        self.cmode_map = np.zeros((mbh, mbw), np.int32)

    # ------------------------------------------------------------------
    def _intra(self, my, mx) -> bool:
        return self.mb_kind[my, mx] >= 2

    def _nz(self, luma: bool, ch: int, by: int, bx: int, cur_intra: bool,
            my: int = -1, mx: int = -1):
        """Neighbour nnz for coded_block_flag ctx (AC/4x4 cats):
        unavailable-or-outside -> intra flag of the CURRENT MB. A
        sibling block inside the current MB (my,mx) is always available
        with its already-coded cbf (spec 9.3.3.1.1.9; z-scan order
        guarantees left/top siblings are written first) even though
        mb_kind is only stamped at the end of the MB."""
        arr = self.nnz_y if luma else self.nnz_c[ch]
        h = arr.shape[0]
        w = arr.shape[1]

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
        else:  # CAT_CHROMA_DC
            a = (self.dc_nz_c[ch, my, mx - 1] if mx > 0
                 and self.mb_kind[my, mx - 1] >= 0
                 else (1 if cur_intra else 0))
            b = (self.dc_nz_c[ch, my - 1, mx] if my > 0
                 and self.mb_kind[my - 1, mx] >= 0
                 else (1 if cur_intra else 0))
        return 85 + 4 * cat + 2 * int(b) + int(a)

    def residual(self, cat, levels, my, mx, by=0, bx=0, ch=0,
                 cur_intra=False):
        """One residual block; levels in scan order (len = cat's max).
        Returns total_coeff (for nnz maps)."""
        cb = self.cb
        count = _MAXC[cat]
        nz = [i for i, x in enumerate(levels) if x]
        if cat == CAT_LUMA_8x8:
            # cat 5 carries no coded_block_flag — presence is implied
            # by the CBP bit (spec 7.4.5.3.3 / reference cabac.c:602)
            assert nz, "cat-5 residual requires nonzero levels"
        else:
            cbf_ctx = self._cbf_ctx(cat, my, mx, by, bx, ch, cur_intra)
            if not nz:
                cb.decision(cbf_ctx, 0)
                return 0
            cb.decision(cbf_ctx, 1)
        last = nz[-1]
        sig_base = _SIG_OFF[cat]
        last_base = _LAST_OFF[cat]
        lvl_base = _ABS_OFF[cat]
        is8 = cat == CAT_LUMA_8x8
        for i in range(min(last + 1, count - 1)):
            sig = 1 if levels[i] else 0
            cb.decision(sig_base + (SIG8_CTX[i] if is8 else i), sig)
            if sig:
                cb.decision(last_base + (LAST8_CTX[i] if is8 else i),
                            1 if i == last else 0)
        node = 0
        for i in reversed(nz):
            v = int(levels[i])
            am1 = abs(v) - 1
            prefix = min(am1, 14)
            ctx = lvl_base + _LEVEL1_CTX[node]
            if prefix:
                cb.decision(ctx, 1)
                ctx = lvl_base + _LEVELGT1_CTX[node]
                for _ in range(prefix - 1):
                    cb.decision(ctx, 1)
                if prefix < 14:
                    cb.decision(ctx, 0)
                else:
                    cb.ue_bypass(0, am1 - 14)
                node = _LEVEL_TRANS[1][node]
            else:
                cb.decision(ctx, 0)
                node = _LEVEL_TRANS[0][node]
            cb.bypass(1 if v < 0 else 0)
        return len(nz)

    # ------------------------------------------------------------------
    def transform_size_flag(self, my, mx, flag: int):
        """transform_size_8x8_flag (reference
        x264_cabac_mb_transform_size, encoder/cabac.c:369-373): ctx
        399 + available-neighbour trans8 flags
        (common/macroblock.c:1044 i_neighbour_transform_size)."""
        ctx = 399
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.trans8_map[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.trans8_map[my - 1, mx]:
            ctx += 1
        self.cb.decision(ctx, 1 if flag else 0)
        self.trans8_map[my, mx] = 1 if flag else 0

    def skip_flag(self, my, mx, b_skip):
        """mb_skip_flag (x264_cabac_mb_skip, encoder/cabac.c:300-306):
        ctx base 11 for P, 24 for B."""
        ctx = 24 if self.slice_is_b else 11
        if mx > 0 and self.mb_kind[my, mx - 1] > 0:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0:
            ctx += 1
        self.cb.decision(ctx, 1 if b_skip else 0)

    def _mb_type_intra(self, i4: bool, mode16, cbp_luma, cbp_chroma,
                       c0, c1, c2, c3, c4, c5):
        cb = self.cb
        if i4:
            cb.decision(c0, 0)
            return
        cb.decision(c0, 1)
        cb.terminal(0)
        cb.decision(c1, 1 if cbp_luma else 0)
        if cbp_chroma == 0:
            cb.decision(c2, 0)
        else:
            cb.decision(c2, 1)
            cb.decision(c3, 1 if cbp_chroma != 1 else 0)
        cb.decision(c4, (mode16 >> 1) & 1)
        cb.decision(c5, mode16 & 1)

    def mb_type_i_slice(self, my, mx, i4, mode16, cbpl, cbpc):
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.mb_kind[my, mx - 1] != 2:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.mb_kind[my - 1, mx] != 2:
            ctx += 1
        self._mb_type_intra(i4, mode16, cbpl, cbpc,
                            3 + ctx, 6, 7, 8, 9, 10)

    def mb_type_p_inter(self, part: int):
        cb = self.cb
        if part == 0:     # 16x16
            cb.decision(14, 0)
            cb.decision(15, 0)
            cb.decision(16, 0)
        elif part == 1:   # 16x8
            cb.decision(14, 0)
            cb.decision(15, 1)
            cb.decision(17, 1)
        elif part == 2:   # 8x16
            cb.decision(14, 0)
            cb.decision(15, 1)
            cb.decision(17, 0)
        else:             # 8x8
            cb.decision(14, 0)
            cb.decision(15, 0)
            cb.decision(16, 1)

    def mb_type_p_intra(self, i4, mode16, cbpl, cbpc):
        self.cb.decision(14, 1)
        self._mb_type_intra(i4, mode16, cbpl, cbpc,
                            17, 18, 19, 19, 20, 20)

    def mb_type_b(self, my, mx, btype: int):
        """B mb_type, 16x16 subset (reference encoder/cabac.c:123-192
        B branch, D_16x16 columns of i_mb_bits): 0 direct, 1 L0,
        2 L1, 3 BI. bin0 ctx 27 + (neighbours coded non-direct)."""
        cb = self.cb
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] > 0 \
                and not self.bdirect[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0 \
                and not self.bdirect[my - 1, mx]:
            ctx += 1
        if btype == 0:                      # B_Direct_16x16: "0"
            cb.decision(27 + ctx, 0)
        elif btype == 1:                    # B_L0_16x16: "100"
            cb.decision(27 + ctx, 1)
            cb.decision(30, 0)
            cb.decision(32, 0)
        elif btype == 2:                    # B_L1_16x16: "101"
            cb.decision(27 + ctx, 1)
            cb.decision(30, 0)
            cb.decision(32, 1)
        else:                               # B_Bi_16x16: "110000"
            cb.decision(27 + ctx, 1)
            cb.decision(30, 1)
            cb.decision(31, 0)
            cb.decision(32, 0)
            cb.decision(32, 0)
            cb.decision(32, 0)

    def mb_type_b_intra(self, my, mx, i4, mode16, cbpl, cbpc):
        """Intra mb_type in a B slice (x264's encoder/cabac.c:146-156):
        the prefix bins 111101 on the B mb_type contexts, then the I
        slice's binarization on ctx 32 + 0/1/2/2/3/3."""
        cb = self.cb
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] > 0 \
                and not self.bdirect[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0 \
                and not self.bdirect[my - 1, mx]:
            ctx += 1
        cb.decision(27 + ctx, 1)
        cb.decision(30, 1)
        cb.decision(31, 1)
        cb.decision(32, 1)
        cb.decision(32, 0)
        cb.decision(32, 1)
        self._mb_type_intra(i4, mode16, cbpl, cbpc, 32, 33, 34, 34, 35, 35)

    def _b_intra_prefix(self, my, mx, i4, mode16, cbpl, cbpc):
        """An intra MB's skip flag and mb_type in a B slice; it carries no
        L1 mvd and is not direct."""
        self.skip_flag(my, mx, False)
        self.mb_type_b_intra(my, mx, i4, mode16, cbpl, cbpc)
        self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.bdirect[my, mx] = False

    def mb_type_b_bins(self, my, mx, bins) -> None:
        """General B mb_type binarization (reference i_mb_bits table
        emission, encoder/cabac.c:183-190): bin0 ctx 27+nbr, bin1 ctx
        30, bin2 ctx 32-bin1, rest ctx 32."""
        cb = self.cb
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] > 0 \
                and not self.bdirect[my, mx - 1]:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] > 0 \
                and not self.bdirect[my - 1, mx]:
            ctx += 1
        cb.decision(27 + ctx, bins[0])
        cb.decision(30, bins[1])
        cb.decision(32 - bins[1], bins[2])
        for b in bins[3:]:
            cb.decision(32, b)

    def sub_mb_type_b(self, code: int) -> None:
        """B sub_mb_type bins, 8x8 subset (reference
        x264_cabac_mb_sub_b_partition, encoder/cabac.c:332-367).
        code: spec ue value 0 direct / 1 L0 / 2 L1 / 3 BI."""
        cb = self.cb
        if code == 0:
            cb.decision(36, 0)
            return
        cb.decision(36, 1)
        if code == 1:                  # D_L0_8x8: 1,0,0
            cb.decision(37, 0)
            cb.decision(39, 0)
        elif code == 2:                # D_L1_8x8: 1,0,1
            cb.decision(37, 0)
            cb.decision(39, 1)
        else:                          # D_BI_8x8: 1,1,0,0,0
            cb.decision(37, 1)
            cb.decision(38, 0)
            cb.decision(39, 0)
            cb.decision(39, 0)


    def sub_mb_type_l0_8x8(self):
        """P sub_mb_type P_L0_8x8 (x264_cabac_mb_sub_p_partition,
        encoder/cabac.c:309-330): one bin."""
        self.cb.decision(21, 1)

    def intra4x4_modes(self, my, mx, modes):
        cb = self.cb
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            gy, gx = 4 * my + by, 4 * mx + bx
            mode = int(modes[blk])
            if gx == 0 or gy == 0:
                pm = 2
            else:
                pm = int(min(self.modes4[gy, gx - 1],
                             self.modes4[gy - 1, gx]))
            if mode == pm:
                cb.decision(68, 1)
            else:
                cb.decision(68, 0)
                rem = mode - (1 if mode > pm else 0)
                cb.decision(69, rem & 1)
                cb.decision(69, (rem >> 1) & 1)
                cb.decision(69, (rem >> 2) & 1)
            self.modes4[gy, gx] = mode

    def chroma_pred_mode(self, my, mx, cmode):
        """ctx inc counts available neighbours with nonzero chroma mode
        (x264: chroma_pred_mode cache holds 0 for inter MBs)."""
        cb = self.cb
        ctx = 0
        if mx > 0 and self.mb_kind[my, mx - 1] >= 0 \
                and self.cmode_map[my, mx - 1] != 0:
            ctx += 1
        if my > 0 and self.mb_kind[my - 1, mx] >= 0 \
                and self.cmode_map[my - 1, mx] != 0:
            ctx += 1
        cb.decision(64 + ctx, 1 if cmode > 0 else 0)
        if cmode > 0:
            cb.decision(67, 1 if cmode > 1 else 0)
            if cmode > 1:
                cb.decision(67, 1 if cmode > 2 else 0)
        self.cmode_map[my, mx] = cmode

    def ref_idx(self, gy4, gx4, h4, w4, ref: int):
        """ref_idx_l0 (reference x264_cabac_mb_ref): unary bins, ctx
        54 + (refA>0) + 2*(refB>0) for bin 0, then 58, then 59; fills
        the ref cache over the partition area."""
        cb = self.cb
        a = int(self.ref4[gy4, gx4 - 1]) if gx4 > 0 else 0
        b = int(self.ref4[gy4 - 1, gx4]) if gy4 > 0 else 0
        ctx = (1 if a > 0 else 0) + (2 if b > 0 else 0)
        k = ref
        while k:
            cb.decision(54 + ctx, 1)
            ctx = 4 if ctx < 4 else 5
            k -= 1
        cb.decision(54 + ctx, 0)
        self.ref4[gy4:gy4 + h4, gx4:gx4 + w4] = ref

    def mvd(self, gy4, gx4, h4, w4, mdx, mdy, lst: int = 0):
        """One partition's mvd; (gy4,gx4) top-left 4x4, fills the mvd
        cache over the partition area (h4 x w4). lst selects the
        per-list neighbour cache (x264 cache.mvd[i_list]); the ctx
        block (40/47) is shared between lists."""
        cb = self.cb
        cache = self.mvd4 if lst == 0 else self.mvd4_1
        for comp, val in ((0, mdx), (1, mdy)):
            a = (abs(int(cache[gy4, gx4 - 1, comp]))
                 if gx4 > 0 else 0)
            b = (abs(int(cache[gy4 - 1, gx4, comp]))
                 if gy4 > 0 else 0)
            amvd = a + b
            ctxbase = 40 if comp == 0 else 47
            ctx = (1 if amvd > 2 else 0) + (1 if amvd > 32 else 0)
            iabs = abs(int(val))
            ctxes = [0, 3, 4, 5, 6, 6, 6, 6, 6]
            if iabs == 0:
                cb.decision(ctxbase + ctx, 0)
            elif iabs < 9:
                cb.decision(ctxbase + ctx, 1)
                for i in range(1, iabs):
                    cb.decision(ctxbase + ctxes[i], 1)
                cb.decision(ctxbase + ctxes[iabs], 0)
                cb.bypass(1 if val < 0 else 0)
            else:
                cb.decision(ctxbase + ctx, 1)
                for i in range(1, 9):
                    cb.decision(ctxbase + ctxes[i], 1)
                cb.ue_bypass(3, iabs - 9)
                cb.bypass(1 if val < 0 else 0)
        cache[gy4:gy4 + h4, gx4:gx4 + w4] = (mdx, mdy)

    def cbp_luma(self, my, mx, cbp):
        cb = self.cb
        # neighbour cbp with unavailable -> 0x0f (x264 cache init -1)
        cl = self.cbp[my, mx - 1] if mx > 0 \
            and self.mb_kind[my, mx - 1] >= 0 else 0x3f
        ct = self.cbp[my - 1, mx] if my > 0 \
            and self.mb_kind[my - 1, mx] >= 0 else 0x3f
        cb.decision(76 - ((cl >> 1) & 1) - ((ct >> 1) & 2), (cbp >> 0) & 1)
        cb.decision(76 - ((cbp >> 0) & 1) - ((ct >> 2) & 2), (cbp >> 1) & 1)
        cb.decision(76 - ((cl >> 3) & 1) - ((cbp << 1) & 2), (cbp >> 2) & 1)
        cb.decision(76 - ((cbp >> 2) & 1) - ((cbp >> 0) & 2), (cbp >> 3) & 1)

    def cbp_chroma(self, my, mx, cbpc):
        """x264 cbp_chroma ctx: available neighbour with nonzero chroma
        cbp increments bin0's ctx; bin1's ctx counts neighbours whose
        chroma cbp == 2 exactly (unavailable contributes nothing —
        the reference's `cbp_a && i_cbp_left != -1` guard)."""
        cb = self.cb
        al = mx > 0 and self.mb_kind[my, mx - 1] >= 0
        at = my > 0 and self.mb_kind[my - 1, mx] >= 0
        ca = (self.cbp[my, mx - 1] >> 4) if al else 0
        ct = (self.cbp[my - 1, mx] >> 4) if at else 0
        ctx = (1 if (al and ca) else 0) + (2 if (at and ct) else 0)
        cb.decision(77 + ctx, 1 if cbpc else 0)
        if cbpc:
            ctx2 = 4 + (1 if (al and ca == 2) else 0) \
                + (2 if (at and ct == 2) else 0)
            cb.decision(77 + ctx2, 1 if cbpc > 1 else 0)

    def qp_delta_zero(self, has_residual: bool):
        """dqp == 0 (CQP frame-level rate control)."""
        self.qp_delta(0, has_residual)

    def qp_delta(self, dqp: int, has_residual: bool):
        """mb_qp_delta (x264_cabac_mb_qp_delta, encoder/cabac.c:265):
        unary of the se-mapped value on ctx 60 + (prev MB coded a
        nonzero dqp and had residual), then 62, then 63. Tracks the
        last_dqp / previous-MB state the ctx derivation reads."""
        if not has_residual:
            self.last_dqp = 0
            return
        cb = self.cb
        ctx = 1 if (self.last_dqp and self.prev_coded) else 0
        if dqp != 0:
            val = -2 * dqp if dqp <= 0 else 2 * dqp - 1
            if val >= 51 and val != 52:   # dqp modulo 52 (cabac.c:288)
                val = 103 - val
            while val:
                cb.decision(60 + ctx, 1)
                ctx = 2 + (ctx >> 1)
                val -= 1
        cb.decision(60 + ctx, 0)
        self.last_dqp = dqp

    def end_mb(self, last: bool):
        self.cb.terminal(1 if last else 0)

    # ------------------------------------------------------------------
    # Whole-MB writers (mirror FrameCavlc's; encoder/cabac.c:781-927)
    # ------------------------------------------------------------------
    def _zig(self, block4x4):
        return zigzag(np.asarray(block4x4))

    def _luma_residual_i16(self, my, mx, luma_dc, luma_ac, cbp_luma):
        gy, gx = 4 * my, 4 * mx
        nz_dc = self.residual(CAT_LUMA_DC, self._zig(luma_dc), my, mx,
                              cur_intra=True)
        self.dc_nz_y[my, mx] = 1 if nz_dc else 0
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma:
                lv = self._zig(luma_ac[by, bx])[1:]
                self.nnz_y[yy, xx] = self.residual(
                    CAT_LUMA_AC, lv, my, mx, yy, xx, cur_intra=True)
            else:
                self.nnz_y[yy, xx] = 0

    def _luma_residual_4x4(self, my, mx, luma_blocks, cbp_luma, intra):
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                lv = self._zig(luma_blocks[by, bx])
                self.nnz_y[yy, xx] = self.residual(
                    CAT_LUMA_4x4, lv, my, mx, yy, xx, cur_intra=intra)
            else:
                self.nnz_y[yy, xx] = 0

    _Z8 = ((0, 0), (0, 1), (1, 0), (1, 1))

    def _luma_residual_8x8(self, my, mx, cbp_luma, luma8_lev, intra):
        """8x8-transform luma residual: one cat-5 block per coded 8x8
        (reference cabac.c:994-999). nnz cells take the 8x8's nonzero
        flag replicated 2x2 (STORE_8x8_NNZ, encoder/macroblock.c:150)."""
        from ..ops.transform8 import ZIGZAG_8x8
        gy, gx = 4 * my, 4 * mx
        for b, (by8, bx8) in enumerate(self._Z8):
            ys = slice(gy + 2 * by8, gy + 2 * by8 + 2)
            xs = slice(gx + 2 * bx8, gx + 2 * bx8 + 2)
            if cbp_luma & (1 << b):
                blk = np.asarray(luma8_lev[by8, bx8])
                lv = blk[ZIGZAG_8x8[:, 0], ZIGZAG_8x8[:, 1]]
                n = self.residual(CAT_LUMA_8x8, lv, my, mx,
                                  cur_intra=intra)
                self.nnz_y[ys, xs] = 1 if n else 0
            else:
                self.nnz_y[ys, xs] = 0

    def _chroma_residual(self, my, mx, cbp_chroma, chroma_dc, chroma_ac,
                         intra):
        gy, gx = 2 * my, 2 * mx
        for ch in range(2):
            if cbp_chroma:
                dc = chroma_dc[ch]
                lv = [int(dc[0, 0]), int(dc[0, 1]), int(dc[1, 0]),
                      int(dc[1, 1])]
                nz = self.residual(CAT_CHROMA_DC, lv, my, mx, ch=ch,
                                   cur_intra=intra)
                self.dc_nz_c[ch, my, mx] = 1 if nz else 0
            else:
                self.dc_nz_c[ch, my, mx] = 0
        for ch in range(2):
            for blk in range(4):
                by, bx = CHROMA_SCAN[blk]
                yy, xx = gy + by, gx + bx
                if cbp_chroma == 2:
                    lv = self._zig(chroma_ac[ch, by, bx])[1:]
                    self.nnz_c[ch, yy, xx] = self.residual(
                        CAT_CHROMA_AC, lv, my, mx, yy, xx, ch=ch,
                        cur_intra=intra)
                else:
                    self.nnz_c[ch, yy, xx] = 0

    def _clear_mb_ctx(self, my, mx):
        self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0

    def write_i16_mb(self, my, mx, mode16, cmode, cbp_luma, cbp_chroma,
                     luma_dc, luma_ac, chroma_dc, chroma_ac,
                     in_p: bool = False, dqp: int = 0, in_b: bool = False):
        if in_b:
            self._b_intra_prefix(my, mx, False, mode16, cbp_luma, cbp_chroma)
        elif in_p:
            self.skip_flag(my, mx, False)
            self.mb_type_p_intra(False, mode16, cbp_luma, cbp_chroma)
        else:
            self.mb_type_i_slice(my, mx, False, mode16, cbp_luma,
                                 cbp_chroma)
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.chroma_pred_mode(my, mx, cmode)
        self.qp_delta(dqp, True)  # I16 always carries mb_qp_delta
        self._luma_residual_i16(my, mx, luma_dc, luma_ac, cbp_luma)
        self._chroma_residual(my, mx, cbp_chroma, chroma_dc, chroma_ac,
                              True)
        self.mb_kind[my, mx] = 3
        self.prev_coded = 1            # I_16x16 (cabac.c:282)
        self.cbp[my, mx] = (cbp_chroma << 4) | (15 if cbp_luma else 0)
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2

    def write_i4_mb(self, my, mx, modes, cmode, cbp_luma, cbp_chroma,
                    luma_blocks, chroma_dc, chroma_ac,
                    in_p: bool = False, dqp: int = 0, in_b: bool = False):
        if in_b:
            self._b_intra_prefix(my, mx, True, 0, cbp_luma, cbp_chroma)
        elif in_p:
            self.skip_flag(my, mx, False)
            self.mb_type_p_intra(True, 0, cbp_luma, cbp_chroma)
        else:
            self.mb_type_i_slice(my, mx, True, 0, cbp_luma, cbp_chroma)
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        if self.trans8_mode:
            # I_NxN carries the flag right after mb_type (cabac.c:827)
            self.transform_size_flag(my, mx, 0)
        self.intra4x4_modes(my, mx, modes)
        self.chroma_pred_mode(my, mx, cmode)
        cbp = (cbp_chroma << 4) | cbp_luma
        self.cbp_luma(my, mx, cbp_luma)
        self.cbp_chroma(my, mx, cbp_chroma)
        self.mb_kind[my, mx] = 2   # after cbp ctx derivation
        self.cbp[my, mx] = cbp
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp:
            self.qp_delta(dqp, True)
            self._luma_residual_4x4(my, mx, luma_blocks, cbp_luma, True)
            self._chroma_residual(my, mx, cbp_chroma, chroma_dc,
                                  chroma_ac, True)
        else:
            self.last_dqp = 0
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if cbp else 0

    def write_i8_mb(self, my, mx, modes8, cmode, cbp_luma, cbp_chroma,
                    luma8_lev, chroma_dc, chroma_ac,
                    in_p: bool = False, dqp: int = 0):
        """One I_NxN (Intra_8x8) macroblock: I_NxN mb_type, transform
        flag 1 right after it, 4 pred modes on the i4 ctx pair
        (reference cabac.c:827-838, di=4 loop), cat-5 luma residual.
        modes8: [4] z-order 8x8 modes; luma8_lev: [2,2,8,8]."""
        if in_p:
            self.skip_flag(my, mx, False)
            self.mb_type_p_intra(True, 0, cbp_luma, cbp_chroma)
        else:
            self.mb_type_i_slice(my, mx, True, 0, cbp_luma, cbp_chroma)
        self.mvd4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.transform_size_flag(my, mx, 1)
        cb = self.cb
        for b, (by8, bx8) in enumerate(self._Z8):
            gy, gx = 4 * my + 2 * by8, 4 * mx + 2 * bx8
            mode = int(modes8[b])
            if gx == 0 or gy == 0:
                pm = 2
            else:
                pm = int(min(self.modes4[gy, gx - 1],
                             self.modes4[gy - 1, gx]))
            if mode == pm:
                cb.decision(68, 1)
            else:
                cb.decision(68, 0)
                rem = mode - (1 if mode > pm else 0)
                cb.decision(69, rem & 1)
                cb.decision(69, (rem >> 1) & 1)
                cb.decision(69, (rem >> 2) & 1)
            # i8x8 modes replicate into the 2x2 ctx cells (x264 cache)
            self.modes4[gy:gy + 2, gx:gx + 2] = mode
        self.chroma_pred_mode(my, mx, cmode)
        cbp = (cbp_chroma << 4) | cbp_luma
        self.cbp_luma(my, mx, cbp_luma)
        self.cbp_chroma(my, mx, cbp_chroma)
        self.mb_kind[my, mx] = 2   # I_NxN, after cbp ctx derivation
        self.cbp[my, mx] = cbp
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp:
            self.qp_delta(dqp, True)
            self._luma_residual_8x8(my, mx, cbp_luma, luma8_lev, True)
            self._chroma_residual(my, mx, cbp_chroma, chroma_dc,
                                  chroma_ac, True)
        else:
            self.last_dqp = 0
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if cbp else 0

    def write_skip_mb(self, my, mx):
        self.skip_flag(my, mx, True)
        self._clear_mb_ctx(my, mx)
        self.last_dqp = 0
        self.prev_coded = 0
        self.mb_kind[my, mx] = 0
        self.cbp[my, mx] = 0
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2

    # unit geometry (y4off, x4off, w4, h4) per P partition 0..3
    _UGEOM = {0: [(0, 0, 4, 4)],
              1: [(0, 0, 4, 2), (2, 0, 4, 2)],
              2: [(0, 0, 2, 4), (0, 2, 2, 4)],
              3: [(0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2),
                  (2, 2, 2, 2)]}

    def write_p_mb(self, my, mx, part, mvds, cbp_luma, cbp_chroma,
                   luma_blocks, chroma_dc, chroma_ac, refs=None,
                   num_ref: int = 1, trans8: bool = False,
                   luma8_lev=None, dqp: int = 0):
        """mvds: one row per partition unit in coding order (P_8x8
        with its four P_L0_8x8 subs; sub-8x8 splits are not written).
        refs: per-ref-slot L0 refs (parts 0-2: one per unit; P_8x8:
        one per 8x8 block), coded when num_ref > 1 — refs before mvds,
        matching the reference's order (encoder/cabac.c:846-893).
        trans8: the MB's transform_size_8x8_flag (luma8_lev [2,2,8,8]
        replaces luma_blocks when set)."""
        self.skip_flag(my, mx, False)
        self.mb_type_p_inter(part)
        if part == 3:
            for _ in range(4):
                self.sub_mb_type_l0_8x8()
        geom = self._UGEOM[part]
        if num_ref > 1:
            for k, (oy, ox, w4, h4) in enumerate(geom):
                self.ref_idx(4 * my + oy, 4 * mx + ox, h4, w4,
                             0 if refs is None else int(refs[k]))
        for u, (oy, ox, w4, h4) in enumerate(geom):
            self.mvd(4 * my + oy, 4 * mx + ox, h4, w4,
                     int(mvds[u, 0]), int(mvds[u, 1]))
        cbp = (cbp_chroma << 4) | cbp_luma
        self.cbp_luma(my, mx, cbp_luma)
        self.cbp_chroma(my, mx, cbp_chroma)
        # inter MBs carry the flag after cbp when luma residual exists
        # (and no sub-partition is < 8x8: x264 cabac.c:974-976 via
        # x264_mb_transform_8x8_allowed)
        if self.trans8_mode and cbp_luma:
            self.transform_size_flag(my, mx, 1 if trans8 else 0)
        self.mb_kind[my, mx] = 1
        self.cbp[my, mx] = cbp
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp:
            self.qp_delta(dqp, True)
            if trans8 and cbp_luma:
                self._luma_residual_8x8(my, mx, cbp_luma, luma8_lev,
                                        False)
            else:
                self._luma_residual_4x4(my, mx, luma_blocks, cbp_luma,
                                        False)
            self._chroma_residual(my, mx, cbp_chroma, chroma_dc,
                                  chroma_ac, False)
        else:
            self.last_dqp = 0
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if cbp else 0

    def write_b_skip_mb(self, my, mx):
        self.skip_flag(my, mx, True)
        self._clear_mb_ctx(my, mx)
        self.last_dqp = 0
        self.prev_coded = 0
        self.mvd4_1[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.mb_kind[my, mx] = 0
        self.bdirect[my, mx] = True
        self.cbp[my, mx] = 0
        self.cmode_map[my, mx] = 0
        self.modes4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 2

    def write_b_mb(self, my, mx, btype, mvd0, mvd1, cbp_luma,
                   cbp_chroma, luma_blocks, chroma_dc, chroma_ac,
                   dqp: int = 0, ref0: int = 0, num_ref: int = 1):
        """Coded B MB, 16x16 subset (direct/L0/L1/BI). Syntax order:
        ref_idx_l0 (multi-ref B lists, L0/BI when num_ref > 1), then
        all mvd_l0 then all mvd_l1 (spec 7.3.5.1). The ref ctx cache
        stays 0 for direct/L1-only MBs (spec 9.3.3.1.1.6 condTermFlag
        is 0 for direct/skip/not-predicted-from-L0 neighbours)."""
        self.skip_flag(my, mx, False)
        self.mb_type_b(my, mx, btype)
        y4, x4 = 4 * my, 4 * mx
        if btype in (1, 3):
            if num_ref > 1:
                self.ref_idx(y4, x4, 4, 4, int(ref0))
            else:
                self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        else:
            self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        if btype in (1, 3):
            self.mvd(y4, x4, 4, 4, int(mvd0[0]), int(mvd0[1]), lst=0)
        else:
            self.mvd4[y4:y4 + 4, x4:x4 + 4] = 0
        if btype in (2, 3):
            self.mvd(y4, x4, 4, 4, int(mvd1[0]), int(mvd1[1]), lst=1)
        else:
            self.mvd4_1[y4:y4 + 4, x4:x4 + 4] = 0
        cbp = (cbp_chroma << 4) | cbp_luma
        self.cbp_luma(my, mx, cbp_luma)
        self.cbp_chroma(my, mx, cbp_chroma)
        if self.trans8_mode and cbp_luma:
            # B MBs never choose the 8x8 transform yet; the flag is
            # still mandatory syntax under PPS transform mode
            self.transform_size_flag(my, mx, 0)
        self.mb_kind[my, mx] = 1
        self.bdirect[my, mx] = btype == 0
        self.cbp[my, mx] = cbp
        self.cmode_map[my, mx] = 0
        self.modes4[y4:y4 + 4, x4:x4 + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp:
            self.qp_delta(dqp, True)
            self._luma_residual_4x4(my, mx, luma_blocks, cbp_luma,
                                    False)
            self._chroma_residual(my, mx, cbp_chroma, chroma_dc,
                                  chroma_ac, False)
        else:
            self.last_dqp = 0
            self.nnz_y[y4:y4 + 4, x4:x4 + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if cbp else 0

    def write_b_mb_ext(self, my, mx, code: int, subs, mvd0, mvd1,
                       cbp_luma, cbp_chroma, luma_blocks, chroma_dc,
                       chroma_ac, dqp: int = 0, ref0: int = 0,
                       num_ref: int = 1):
        """B partition MB (codes 4-22): mb_type bins, B_8x8 sub types,
        ref_idx_l0 per L0-using non-direct unit (multi-ref B lists,
        num_ref > 1 — refs before mvds per spec 7.3.5.1/7.3.5.2),
        per-unit mvds all-L0-then-all-L1 (reference encoder/cabac.c
        B_8x8 / 'All B mode' branches :894-975). mvd0/mvd1: [4,2]
        per-unit in coding order."""
        self.skip_flag(my, mx, False)
        self.mb_type_b_bins(my, mx, B_TYPE_BINS[code])
        y4, x4 = 4 * my, 4 * mx
        if code == 22:
            for b in range(4):
                self.sub_mb_type_b(int(subs[b]))
            geom = _B_GEOM[3]
            uses = ([B_SUB_USES[int(subs[b])][0] for b in range(4)],
                    [B_SUB_USES[int(subs[b])][1] for b in range(4)])
            dirs = [b for b in range(4) if int(subs[b]) == 0]
        else:
            _, u0, u1 = B_CODE_USES[code]
            geom = _B_GEOM[1 if code % 2 == 0 else 2]
            uses = (list(u0), list(u1))
            dirs = []
        for u, ((oy, ox), h4, w4) in enumerate(geom):
            if uses[0][u] and u not in dirs and num_ref > 1:
                self.ref_idx(y4 + oy, x4 + ox, h4, w4, int(ref0))
            else:
                # spec 9.3.3.1.1.6: direct/L1-only neighbours
                # contribute 0 to the ref ctx
                self.ref4[y4 + oy:y4 + oy + h4,
                          x4 + ox:x4 + ox + w4] = 0
        for li, mvd in ((0, mvd0), (1, mvd1)):
            cache = self.mvd4 if li == 0 else self.mvd4_1
            for u, ((oy, ox), h4, w4) in enumerate(geom):
                if uses[li][u] and u not in dirs:
                    self.mvd(y4 + oy, x4 + ox, h4, w4,
                             int(mvd[u][0]), int(mvd[u][1]), lst=li)
                else:
                    cache[y4 + oy:y4 + oy + h4,
                          x4 + ox:x4 + ox + w4] = 0
        cbp = (cbp_chroma << 4) | cbp_luma
        self.cbp_luma(my, mx, cbp_luma)
        self.cbp_chroma(my, mx, cbp_chroma)
        if self.trans8_mode and cbp_luma:
            self.transform_size_flag(my, mx, 0)
        self.mb_kind[my, mx] = 1
        self.bdirect[my, mx] = False
        self.cbp[my, mx] = cbp
        self.cmode_map[my, mx] = 0
        self.modes4[y4:y4 + 4, x4:x4 + 4] = 2
        self.dc_nz_y[my, mx] = 0
        self.dc_nz_c[:, my, mx] = 0
        if cbp:
            self.qp_delta(dqp, True)
            self._luma_residual_4x4(my, mx, luma_blocks, cbp_luma,
                                    False)
            self._chroma_residual(my, mx, cbp_chroma, chroma_dc,
                                  chroma_ac, False)
        else:
            self.last_dqp = 0
            self.nnz_y[y4:y4 + 4, x4:x4 + 4] = 0
            self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.prev_coded = 1 if cbp else 0

    def end_slice(self, bw: BitWriter):
        self.cb.flush_to(bw)
