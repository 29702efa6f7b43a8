"""The Python CAVLC B-slice writer (port of the B parts of the
reference's encoder/cavlc.py: `write_residual`, `_write_level`, and
`FrameCavlc` with `write_b_mb`, the intra MBs of a B slice
(`write_i16x16_mb`, `write_i4x4_mb`), `set_mb_nnz_zero` and the chroma
residual).

The port writes its I and P slices natively (`native.write_slice`); a B
slice whose MBs are all inter 16x16 (codes 0-3) at one reference is
written by the native twin `native.write_slice_b`, every other B slice
(the partition codes 4-22, a ref_idx_l0 at more than one reference, or
intra MBs) here.
`FrameCavlc` tracks the per-4x4 total_coeff maps that give each block's
nC context (spec 9.2.1), as the reference's does.
"""

from __future__ import annotations

import numpy as np

from ..ops.transform import ZIGZAG_4x4
from ..utils.bitstream import BitWriter
from . import vlc_tables as VT
from .cabac import CHROMA_SCAN, LUMA_SCAN
from .vlc_tables import B_CODE_USES, B_SUB_USES


def _write_vlc(bw: BitWriter, code: str) -> None:
    if not code:
        raise ValueError("invalid VLC entry")
    bw.write(len(code), int(code, 2))


def zigzag(block4x4: np.ndarray) -> list[int]:
    return [int(block4x4[r, c]) for r, c in ZIGZAG_4x4]


def write_residual(bw: BitWriter, levels: list[int], max_coeff: int,
                   nc: int) -> int:
    """One CAVLC residual block (spec 9.2; x264's
    block_residual_write_cavlc). `levels` in scan order, len ==
    max_coeff. Returns total_coeff (for the nC maps)."""
    nz_pos = [i for i, lv in enumerate(levels) if lv != 0]
    total_coeff = len(nz_pos)
    if nc == -1:
        tab = 4
    elif nc < 2:
        tab = 0
    elif nc < 4:
        tab = 1
    elif nc < 8:
        tab = 2
    else:
        tab = 3
    if total_coeff == 0:
        _write_vlc(bw, VT.COEFF0[tab])
        return 0
    # trailing ones: up to 3 consecutive |1|s at the high-frequency end
    t1s = 0
    for i in reversed(nz_pos):
        if abs(levels[i]) == 1 and t1s < 3:
            t1s += 1
        else:
            break
    _write_vlc(bw, VT.COEFF_TOKEN[tab][(total_coeff - 1) * 4 + t1s])
    for i in reversed(nz_pos[total_coeff - t1s:]):
        bw.write1(1 if levels[i] < 0 else 0)
    suffix_len = 1 if (total_coeff > 10 and t1s < 3) else 0
    first = True
    for k in range(total_coeff - t1s - 1, -1, -1):
        val = levels[nz_pos[k]]
        code = 2 * val - 2 if val > 0 else -2 * val - 1
        if first and t1s < 3:
            code -= 2
        first = False
        _write_level(bw, code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(val) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    if total_coeff < max_coeff:
        tz = nz_pos[-1] + 1 - total_coeff
        if max_coeff == 4:
            _write_vlc(bw, VT.TOTAL_ZEROS_DC[total_coeff - 1][tz])
        else:
            _write_vlc(bw, VT.TOTAL_ZEROS[total_coeff - 1][tz])
        zeros_left = tz
        for k in range(total_coeff - 1, 0, -1):
            if zeros_left <= 0:
                break
            run = nz_pos[k] - nz_pos[k - 1] - 1
            _write_vlc(bw, VT.RUN_BEFORE[min(zeros_left, 7) - 1][run])
            zeros_left -= run
    return total_coeff


def _write_level(bw: BitWriter, code: int, suffix_len: int) -> None:
    """Level prefix/suffix (spec 9.2.2.1 inverted)."""
    if suffix_len == 0:
        if code < 14:
            bw.write(code + 1, 1)        # `code` zeros, then a 1
            return
        if code < 30:
            bw.write(15, 1)              # prefix 14
            bw.write(4, code - 14)
            return
        code -= 15   # the decoder adds 15 when prefix >= 15, suffix_len 0
        suffix_len_eff = 0
    else:
        suffix_len_eff = suffix_len
        if code < (15 << suffix_len):
            bw.write((code >> suffix_len) + 1, 1)
            bw.write(suffix_len, code & ((1 << suffix_len) - 1))
            return
    # escape: prefix >= 15 with a suffix of prefix - 3 bits
    prefix = 15
    while True:
        sz = prefix - 3
        base = (15 << suffix_len_eff) + (
            ((1 << (prefix - 3)) - 4096) if prefix > 15 else 0)
        if code - base < (1 << sz):
            bw.write(prefix + 1, 1)
            bw.write(sz, code - base)
            return
        prefix += 1
        if prefix >= 32:
            raise ValueError("level too large for CAVLC")


class FrameCavlc:
    """Per-slice CAVLC state: the nC context maps of luma and chroma, the
    Intra_4x4 mode map (2 wherever no I_NxN MB set it), and the PPS's
    transform_8x8_mode_flag (`trans8_mode`)."""

    def __init__(self, mbw: int, mbh: int, trans8_mode: bool = False):
        self.mbw, self.mbh = mbw, mbh
        self.trans8_mode = trans8_mode
        self.nnz_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.nnz_c = np.zeros((2, 2 * mbh, 2 * mbw), np.int32)
        self.modes4 = np.full((4 * mbh, 4 * mbw), 2, np.int32)

    def _nc(self, arr, by, bx) -> int:
        """nC (spec 9.2.1): the mean of the available left / top
        total_coeff."""
        has_l, has_t = bx > 0, by > 0
        if has_l and has_t:
            return int(arr[by, bx - 1] + arr[by - 1, bx] + 1) >> 1
        if has_l:
            return int(arr[by, bx - 1])
        if has_t:
            return int(arr[by - 1, bx])
        return 0

    @staticmethod
    def _write_te_ref(bw: BitWriter, ref: int, num_ref: int):
        """ref_idx_l0 te(v) (spec 9.1.1): nothing at one reference, one
        inverted bit at two, ue(v) above."""
        if num_ref > 1:
            bw.write_te(num_ref - 1, int(ref))

    def write_b_mb(self, bw: BitWriter, mx: int, my: int, btype: int,
                   mvd0, mvd1, cbp_luma: int, cbp_chroma: int,
                   luma_lev: np.ndarray, chroma_dc: np.ndarray,
                   chroma_ac: np.ndarray, qp_delta: int = 0, subs=None,
                   ref0: int = 0, num_ref: int = 1) -> None:
        """One B macroblock (spec Table 7-14: the ue code itself, 0
        direct, 1-3 16x16 L0/L1/BI, 4-21 the two-partition list combos,
        22 B_8x8 with `subs` its four sub_mb_type codes; x264's
        encoder/cavlc.c:463-560). mvd0/mvd1: per-unit (x, y) in coding
        order, [2] or [U, 2]. Syntax order: ref_idx_l0 of every L0-using
        non-direct unit (num_ref > 1), all L0 mvds, all L1 mvds, cbp,
        transform_size_8x8_flag (0: under `trans8_mode` wherever cbp_luma
        is nonzero, as the reference writes it), qp_delta, the residual.
        luma_lev [4,4,4,4] (by,bx,r,c); chroma_dc [2,2,2]; chroma_ac
        [2,2,2,4,4]."""
        bw.write_ue(btype)
        mvd0 = np.asarray(mvd0).reshape(-1, 2)
        mvd1 = np.asarray(mvd1).reshape(-1, 2)
        if btype in (1, 3):
            self._write_te_ref(bw, ref0, num_ref)
        if btype == 22:
            for b in range(4):
                bw.write_ue(int(subs[b]))
            for b in range(4):
                sb = int(subs[b])
                if sb != 0 and B_SUB_USES[sb][0]:
                    self._write_te_ref(bw, ref0, num_ref)
            for mvd, li in ((mvd0, 0), (mvd1, 1)):
                for b in range(4):
                    if B_SUB_USES[int(subs[b])][li]:
                        bw.write_se(int(mvd[b, 0]))
                        bw.write_se(int(mvd[b, 1]))
        else:
            n_units, u0, u1 = B_CODE_USES[btype]
            if btype > 3:
                for u in range(n_units):
                    if u0[u]:
                        self._write_te_ref(bw, ref0, num_ref)
            for mvd, uses in ((mvd0, u0), (mvd1, u1)):
                for u in range(n_units):
                    if uses[u]:
                        bw.write_se(int(mvd[u, 0]))
                        bw.write_se(int(mvd[u, 1]))
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTER_TO_GOLOMB[cbp])
        if self.trans8_mode and cbp_luma:
            bw.write1(0)
        if cbp:
            bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, yy, xx)
                self.nnz_y[yy, xx] = write_residual(
                    bw, zigzag(luma_lev[by, bx]), 16, nc)
            else:
                self.nnz_y[yy, xx] = 0
        if cbp:
            self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)
        else:
            self.set_mb_nnz_zero(mx, my, luma_too=False)

    def write_i16x16_mb(self, bw: BitWriter, mx: int, my: int, mode: int,
                        cmode: int, cbp_luma: int, cbp_chroma: int,
                        luma_dc: np.ndarray, luma_ac: np.ndarray,
                        chroma_dc: np.ndarray, chroma_ac: np.ndarray,
                        qp_delta: int = 0) -> None:
        """One I_16x16 MB of a B slice (the reference's cavlc.py:189-227
        with in_b_slice): mb_type 23 + the I-slice type, the chroma pred
        mode, mb_qp_delta, the DC block at blk 0's nC, the AC blocks
        where cbp_luma. luma_dc [4,4]; luma_ac [4,4,4,4] (by,bx,r,c);
        chroma_dc [2,2,2]; chroma_ac [2,2,2,4,4]."""
        cbp01 = 1 if cbp_luma else 0
        bw.write_ue(23 + 1 + mode + 4 * cbp_chroma + 12 * cbp01)
        bw.write_ue(cmode)
        bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        write_residual(bw, zigzag(luma_dc), 16, self._nc(self.nnz_y, gy, gx))
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma:
                nc = self._nc(self.nnz_y, yy, xx)
                self.nnz_y[yy, xx] = write_residual(
                    bw, zigzag(luma_ac[by, bx])[1:], 15, nc)
            else:
                self.nnz_y[yy, xx] = 0
        self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)

    def write_i4x4_mb(self, bw: BitWriter, mx: int, my: int, modes,
                      cmode: int, cbp_luma: int, cbp_chroma: int,
                      luma_blocks: np.ndarray, chroma_dc: np.ndarray,
                      chroma_ac: np.ndarray, qp_delta: int = 0) -> None:
        """One I_NxN (Intra_4x4) MB of a B slice (the reference's
        cavlc.py:229-275 with in_b_slice): mb_type 23, under `trans8_mode`
        transform_size_8x8_flag 0, the sixteen modes against their
        predictor (the lesser of the left and top modes, 2 at the frame
        edge or next to an MB that is not I_NxN), the chroma pred mode,
        the intra cbp, mb_qp_delta where it is nonzero, the residual.
        modes [16] in blkIdx order; luma_blocks [4,4,4,4] (by,bx,r,c)."""
        bw.write_ue(23)
        if self.trans8_mode:
            bw.write1(0)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            gy4, gx4 = 4 * my + by, 4 * mx + bx
            mode = int(modes[blk])
            pm = 2 if gx4 == 0 or gy4 == 0 else int(min(
                self.modes4[gy4, gx4 - 1], self.modes4[gy4 - 1, gx4]))
            if mode == pm:
                bw.write1(1)
            else:
                bw.write1(0)
                bw.write(3, mode - (1 if mode > pm else 0))
            self.modes4[gy4, gx4] = mode
        bw.write_ue(cmode)
        cbp = (cbp_chroma << 4) | cbp_luma
        bw.write_ue(VT.CBP_INTRA_TO_GOLOMB[cbp])
        if cbp:
            bw.write_se(qp_delta)
        gy, gx = 4 * my, 4 * mx
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = gy + by, gx + bx
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, yy, xx)
                self.nnz_y[yy, xx] = write_residual(
                    bw, zigzag(luma_blocks[by, bx]), 16, nc)
            else:
                self.nnz_y[yy, xx] = 0
        self._write_chroma(bw, mx, my, cbp_chroma, chroma_dc, chroma_ac)

    def set_mb_nnz_zero(self, mx: int, my: int, luma_too: bool = True):
        """Clear the nC maps of a skipped (or residual-free) MB."""
        if luma_too:
            self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0

    def _write_chroma(self, bw, mx, my, cbp_chroma, chroma_dc, chroma_ac):
        gy, gx = 2 * my, 2 * mx
        if cbp_chroma:
            for ch in range(2):
                dc = chroma_dc[ch]
                write_residual(bw, [int(dc[0, 0]), int(dc[0, 1]),
                                    int(dc[1, 0]), int(dc[1, 1])], 4, -1)
        for ch in range(2):
            for blk in range(4):
                by, bx = CHROMA_SCAN[blk]
                yy, xx = gy + by, gx + bx
                if cbp_chroma == 2:
                    nc = self._nc(self.nnz_c[ch], yy, xx)
                    self.nnz_c[ch, yy, xx] = write_residual(
                        bw, zigzag(chroma_ac[ch, by, bx])[1:], 15, nc)
                else:
                    self.nnz_c[ch, yy, xx] = 0
