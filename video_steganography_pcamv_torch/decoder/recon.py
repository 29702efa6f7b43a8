"""Decoder-side reconstruction math (numpy, scalar per MB): the port's
copy of the reference's decoder/recon.py for the 4x4 and 8x8 transforms.
The dequant reads the stream's scaling lists through a `Dequant` made
per decode from its SPS (the reference installs them in module state;
the module-level functions here are the flat lists' `Dequant`).

Deliberately an *independent* implementation of the normative H.264
inverse transforms / prediction (spec 8.3, 8.5) — not a reuse of the
device ops — so encoder and decoder cross-check each other (the
regression model of upstream doc/regression_test.txt: encoder
recon must equal an independent decoder's output bit-exactly).
"""

from __future__ import annotations

import numpy as np

# dequant V table, rows qp%6, cols position-class (0,0)/(1,1)/other
_V = np.array([
    [10, 13, 16], [11, 14, 18], [13, 16, 20],
    [14, 18, 23], [16, 20, 25], [18, 23, 29]], dtype=np.int64)
# position class: 0 = both-even (V col 10), 1 = mixed (13), 2 = both-odd (16)
_POS = np.array([[(r & 1) + (c & 1) for c in range(4)] for r in range(4)])

ZIG4 = [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
        (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3)]


def dezigzag(levels) -> np.ndarray:
    out = np.zeros((4, 4), np.int64)
    for i, (r, c) in enumerate(ZIG4):
        out[r, c] = levels[i]
    return out


def _list(v, n: int) -> np.ndarray:
    return (np.full((n, n), 16, np.int64) if v is None
            else np.asarray(v, np.int64).reshape(n, n))


class Dequant:
    """The dequant of one stream (spec 8.5.9: LevelScale = V * the
    scaling list of the block's class): lists = (intra4, inter4, intra8,
    inter8) raster, None = flat. Chroma takes the 4x4 list of its class
    (the SPS's lists 1, 2 and 4, 5 fall back to 0 and 3)."""

    def __init__(self, lists=None):
        i4, p4, i8, p8 = lists if lists is not None else (None,) * 4
        self.sc4 = {True: _list(i4, 4), False: _list(p4, 4)}
        self.sc8 = {True: _list(i8, 8), False: _list(p8, 8)}

    def dequant4x4(self, block: np.ndarray, qp: int,
                   intra: bool = False) -> np.ndarray:
        v = _V[qp % 6][_POS] * self.sc4[intra]
        qbits = qp // 6 - 4
        if qbits >= 0:
            return (block * v) << qbits
        f = 1 << (-qbits - 1)
        return (block * v + f) >> (-qbits)

    def dequant_dc_luma(self, dc: np.ndarray, qp: int) -> np.ndarray:
        dmf = int(_V[qp % 6][0]) * int(self.sc4[True][0, 0])  # i16: intra
        qbits = qp // 6 - 6
        if qbits >= 0:
            return dc * (dmf << qbits)
        f = 1 << (-qbits - 1)
        return (dc * dmf + f) >> (-qbits)

    def dequant_dc_chroma(self, dc: np.ndarray, qp: int,
                          intra: bool = False) -> np.ndarray:
        dmf = int(_V[qp % 6][0]) * int(self.sc4[intra][0, 0])
        qbits = qp // 6 - 5
        if qbits > 0:
            return dc * (dmf << qbits)
        return (dc * dmf) >> (-qbits)

    def dequant8x8(self, block: np.ndarray, qp: int,
                   intra: bool) -> np.ndarray:
        from ..ops.transform8 import _DEQUANT8_SCALE, pos_class8
        dmf = _DEQUANT8_SCALE[qp % 6][pos_class8()] * self.sc8[intra]
        qbits = qp // 6 - 6
        v = block.astype(np.int64) * dmf
        if qbits >= 0:
            return v << qbits
        f = 1 << (-qbits - 1)
        return (v + f) >> (-qbits)


FLAT = Dequant()
dequant4x4 = FLAT.dequant4x4
dequant_dc_luma = FLAT.dequant_dc_luma
dequant_dc_chroma = FLAT.dequant_dc_chroma
dequant8x8 = FLAT.dequant8x8


def idct4x4(c: np.ndarray) -> np.ndarray:
    """Normative inverse core transform (spec 8.5.12.2): horizontal pass
    then vertical, both with the >>1 on odd terms; final (x+32)>>6 done
    by caller."""
    tmp = np.zeros((4, 4), np.int64)
    for i in range(4):
        s02 = c[i][0] + c[i][2]
        d02 = c[i][0] - c[i][2]
        s13 = c[i][1] + (c[i][3] >> 1)
        d13 = (c[i][1] >> 1) - c[i][3]
        tmp[i] = [s02 + s13, d02 + d13, d02 - d13, s02 - s13]
    out = np.zeros((4, 4), np.int64)
    for j in range(4):
        s02 = tmp[0][j] + tmp[2][j]
        d02 = tmp[0][j] - tmp[2][j]
        s13 = tmp[1][j] + (tmp[3][j] >> 1)
        d13 = (tmp[1][j] >> 1) - tmp[3][j]
        out[0][j], out[1][j] = s02 + s13, d02 + d13
        out[2][j], out[3][j] = d02 - d13, s02 - s13
    return out


def ihadamard4x4(c: np.ndarray) -> np.ndarray:
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                  [1, -1, 1, -1]], dtype=np.int64)
    return h @ c @ h.T


def ihadamard2x2(c: np.ndarray) -> np.ndarray:
    h = np.array([[1, 1], [1, -1]], dtype=np.int64)
    return h @ c @ h.T


def recon_block4x4(pred: np.ndarray, coef: np.ndarray) -> np.ndarray:
    r = (idct4x4(coef) + 32) >> 6
    return np.clip(pred.astype(np.int64) + r, 0, 255)


# ------------------------- intra prediction --------------------------------

def pred_4x4(mode: int, t: np.ndarray, l: np.ndarray, lt: int,
             at: bool, al: bool) -> np.ndarray:
    """Scalar i4x4 prediction (spec 8.3.1.2; reference
    common/predict.c:302-600). t: t0..t7 (top-right already substituted
    by the caller where unavailable), l: l0..l3, lt: top-left sample."""
    p = np.zeros((4, 4), np.int64)

    def f2(a, b, c):
        return (int(a) + 2 * int(b) + int(c) + 2) >> 2

    def f1(a, b):
        return (int(a) + int(b) + 1) >> 1

    if mode == 2:  # DC
        if at and al:
            dc = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
        elif at:
            dc = (int(t[:4].sum()) + 2) >> 2
        elif al:
            dc = (int(l.sum()) + 2) >> 2
        else:
            dc = 128
        p[:] = dc
        return p

    tt = lambda j: lt if j == -1 else t[j]
    ll = lambda j: lt if j == -1 else l[j]
    for y in range(4):
        for x in range(4):
            if mode == 0:          # V
                p[y, x] = t[x]
            elif mode == 1:        # H
                p[y, x] = l[y]
            elif mode == 3:        # DDL
                i = x + y
                p[y, x] = ((int(t[6]) + 3 * int(t[7]) + 2) >> 2 if i == 6
                           else f2(t[i], t[i + 1], t[i + 2]))
            elif mode == 4:        # DDR
                if x > y:
                    k = x - y
                    p[y, x] = f2(tt(k - 2), tt(k - 1), t[k])
                elif x < y:
                    k = y - x
                    p[y, x] = f2(ll(k - 2), ll(k - 1), l[k])
                else:
                    p[y, x] = f2(t[0], lt, l[0])
            elif mode == 5:        # VR
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = f1(tt(i - 1), tt(i))
                elif z >= 0:
                    p[y, x] = f2(tt(i - 2), tt(i - 1), tt(i))
                elif z == -1:
                    p[y, x] = f2(l[0], lt, t[0])
                else:
                    p[y, x] = f2(ll(y - 1), ll(y - 2), ll(y - 3))
            elif mode == 6:        # HD
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = f1(ll(i - 1), ll(i))
                elif z >= 0:
                    p[y, x] = f2(ll(i - 2), ll(i - 1), ll(i))
                elif z == -1:
                    p[y, x] = f2(t[0], lt, l[0])
                else:
                    p[y, x] = f2(tt(x - 1), tt(x - 2), tt(x - 3))
            elif mode == 7:        # VL
                i = x + (y >> 1)
                p[y, x] = (f1(t[i], t[i + 1]) if y % 2 == 0
                           else f2(t[i], t[i + 1], t[i + 2]))
            elif mode == 8:        # HU
                z = x + 2 * y
                i = y + (x >> 1)
                if z < 5 and z % 2 == 0:
                    p[y, x] = f1(l[i], l[i + 1])
                elif z < 5:
                    p[y, x] = f2(l[i], l[i + 1], l[i + 2])
                elif z == 5:
                    p[y, x] = (int(l[2]) + 3 * int(l[3]) + 2) >> 2
                else:
                    p[y, x] = l[3]
            else:
                raise ValueError(f"bad i4x4 mode {mode}")
    return p


# ------------------------- inter prediction --------------------------------

def np_pad(plane: np.ndarray, pad: int = 24) -> np.ndarray:
    return np.pad(plane.astype(np.int64), pad, mode="edge")


def _filt6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def np_hpel_planes(fp: np.ndarray):
    """Half-pel planes over a padded full plane (spec 8.4.2.2.1)."""
    def sx(img, k):
        return np.roll(img, -k, axis=1)

    def sy(img, k):
        return np.roll(img, -k, axis=0)

    th = _filt6(sx(fp, -2), sx(fp, -1), fp, sx(fp, 1), sx(fp, 2), sx(fp, 3))
    h = np.clip((th + 16) >> 5, 0, 255)
    tv = _filt6(sy(fp, -2), sy(fp, -1), fp, sy(fp, 1), sy(fp, 2), sy(fp, 3))
    v = np.clip((tv + 16) >> 5, 0, 255)
    tc = _filt6(sy(th, -2), sy(th, -1), th, sy(th, 1), sy(th, 2), sy(th, 3))
    c = np.clip((tc + 512) >> 10, 0, 255)
    return np.stack([fp, h, v, c])


def np_mc_luma(planes: np.ndarray, y0: int, x0: int, mvx: int, mvy: int,
               bh: int = 16, bw: int = 16, pad: int = 24) -> np.ndarray:
    """One block, quarter-pel (same spec phase rules as ops/mc.py but an
    independent scalar derivation for cross-checking)."""
    ix = x0 + pad + (mvx >> 2)
    iy = y0 + pad + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3

    def blk(p, dy, dx):
        return planes[p, iy + dy: iy + dy + bh, ix + dx: ix + dx + bw]

    if fx % 2 == 0 and fy % 2 == 0:
        return blk((fx >> 1) + 2 * (fy >> 1), 0, 0)
    if fx % 2 == 1 and fy % 2 == 0:
        a = blk(1 + 2 * (fy >> 1), 0, 0)
        b = blk(0 + 2 * (fy >> 1), 0, 1 if fx == 3 else 0)
        return (a + b + 1) >> 1
    if fx % 2 == 0 and fy % 2 == 1:
        a = blk((fx >> 1) + 2, 0, 0)
        b = blk((fx >> 1), 1 if fy == 3 else 0, 0)
        return (a + b + 1) >> 1
    a = blk(1, 1 if fy == 3 else 0, 0)   # H plane
    b = blk(2, 0, 1 if fx == 3 else 0)   # V plane
    return (a + b + 1) >> 1


def np_mc_chroma(plane_padded: np.ndarray, y0: int, x0: int,
                 mvx: int, mvy: int, bh: int = 8, bw: int = 8,
                 pad: int = 24) -> np.ndarray:
    ix = x0 + pad + (mvx >> 3)
    iy = y0 + pad + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    a = plane_padded[iy: iy + bh, ix: ix + bw]
    b = plane_padded[iy: iy + bh, ix + 1: ix + 1 + bw]
    c = plane_padded[iy + 1: iy + 1 + bh, ix: ix + bw]
    d = plane_padded[iy + 1: iy + 1 + bh, ix + 1: ix + 1 + bw]
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def pred_16x16(mode: int, top, left, topleft, at: bool, al: bool):
    if mode == 0:
        return np.tile(top, (16, 1))
    if mode == 1:
        return np.tile(left[:, None], (1, 16))
    if mode == 2:
        if at and al:
            dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif at:
            dc = (int(top.sum()) + 8) >> 4
        elif al:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = 128
        return np.full((16, 16), dc, np.int64)
    # planar
    hg = sum(x * (int(top[7 + x]) - int(topleft if x == 8 else top[7 - x]))
             for x in range(1, 9))
    vg = sum(y * (int(left[7 + y]) - int(topleft if y == 8 else left[7 - y]))
             for y in range(1, 9))
    b = (5 * hg + 32) >> 6
    c = (5 * vg + 32) >> 6
    a = 16 * (int(top[15]) + int(left[15]))
    ys, xs = np.mgrid[0:16, 0:16]
    return np.clip((a + b * (xs - 7) + c * (ys - 7) + 16) >> 5, 0, 255)


def pred_chroma(mode: int, top, left, topleft, at: bool, al: bool):
    if mode == 1:
        return np.tile(left[:, None], (1, 8))
    if mode == 2:
        return np.tile(top, (8, 1))
    if mode == 3:
        hg = sum(x * (int(top[3 + x]) - int(topleft if x == 4 else top[3 - x]))
                 for x in range(1, 5))
        vg = sum(y * (int(left[3 + y]) - int(topleft if y == 4 else left[3 - y]))
                 for y in range(1, 5))
        b = (17 * hg + 16) >> 5
        c = (17 * vg + 16) >> 5
        a = 16 * (int(top[7]) + int(left[7]))
        ys, xs = np.mgrid[0:8, 0:8]
        return np.clip((a + b * (xs - 3) + c * (ys - 3) + 16) >> 5, 0, 255)
    # DC, per-quadrant (spec 8.3.4.1)
    out = np.zeros((8, 8), np.int64)
    t = [int(top[:4].sum()), int(top[4:].sum())]
    l = [int(left[:4].sum()), int(left[4:].sum())]

    def q(sum_t, sum_l, have_t, have_l):
        if have_t and have_l:
            return (sum_t + sum_l + 4) >> 3
        if have_t:
            return (sum_t + 2) >> 2
        if have_l:
            return (sum_l + 2) >> 2
        return 128

    out[:4, :4] = q(t[0], l[0], at, al)
    out[:4, 4:] = (t[1] + 2) >> 2 if at else ((l[0] + 2) >> 2 if al else 128)
    out[4:, :4] = (l[1] + 2) >> 2 if al else ((t[0] + 2) >> 2 if at else 128)
    out[4:, 4:] = q(t[1], l[1], at, al)
    return out


# ---------------------------------------------------------------- 8x8 ---
# High-profile 8x8 decode path (spec 8.3.2 Intra_8x8 + 8.5.12.2; x264's
# IDCT8_1D and dequant_8x8), scalar numpy. Only the spec's constant
# tables come from the port's ops.

def dezigzag8(levels) -> np.ndarray:
    from ..ops.transform8 import ZIGZAG_8x8
    out = np.zeros((8, 8), np.int64)
    for i, (r, c) in enumerate(ZIGZAG_8x8):
        out[r, c] = levels[i]
    return out


def idct8x8_add(pred: np.ndarray, coef: np.ndarray) -> np.ndarray:
    # coef in the spec orientation C[r][c]; the passes mirror x264's
    # add8x8_idct8, which runs on the transpose
    dct = coef.T.astype(np.int64).copy()
    dct[0][0] += 32

    def pass1d(get, put):
        s = [get(x) for x in range(8)]
        a0, a2 = s[0] + s[4], s[0] - s[4]
        a4, a6 = (s[2] >> 1) - s[6], (s[6] >> 1) + s[2]
        b0, b2, b4, b6 = a0 + a6, a2 + a4, a2 - a4, a0 - a6
        a1 = -s[3] + s[5] - s[7] - (s[7] >> 1)
        a3 = s[1] + s[7] - s[3] - (s[3] >> 1)
        a5 = -s[1] + s[7] + s[5] + (s[5] >> 1)
        a7 = s[3] + s[5] + s[1] + (s[1] >> 1)
        b1, b3 = (a7 >> 2) + a1, a3 + (a5 >> 2)
        b5, b7 = (a3 >> 2) - a5, a7 - (a1 >> 2)
        for k, val in enumerate([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                                 b6 - b1, b4 - b3, b2 - b5, b0 - b7]):
            put(k, val)

    for i in range(8):
        pass1d(lambda x: dct[x][i],
               lambda x, val: dct.__setitem__((x, i), val))
    tr = np.zeros((8, 8), np.int64)
    for i in range(8):
        pass1d(lambda x: dct[i][x],
               lambda x, val: tr.__setitem__((x, i), val))
    return np.clip(pred.astype(np.int64) + (tr >> 6), 0, 255)


def filter_edge8(lt, t, left, have_lt, have_tr):
    """x264_predict_8x8_filter, scalar. t: [16] raw with t8.. already
    substituted when the top-right is absent; left: [8]."""
    def f2(a, b, c):
        return (a + 2 * b + c + 2) >> 2
    e = np.zeros(33, np.int64)
    e[15] = (t[0] + 2 * lt + left[0] + 2) >> 2
    e[14] = ((lt if have_lt else left[0]) + 2 * left[0] + left[1] + 2) >> 2
    for y in range(1, 7):
        e[14 - y] = f2(left[y - 1], left[y], left[y + 1])
    e[7] = (left[6] + 3 * left[7] + 2) >> 2
    e[16] = ((lt if have_lt else t[0]) + 2 * t[0] + t[1] + 2) >> 2
    for x in range(1, 7):
        e[16 + x] = f2(t[x - 1], t[x], t[x + 1])
    e[23] = (t[6] + 2 * t[7] + (t[8] if have_tr else t[7]) + 2) >> 2
    if have_tr:
        for x in range(8, 15):
            e[16 + x] = f2(t[x - 1], t[x], t[x + 1])
        e[31] = e[32] = (t[14] + 3 * t[15] + 2) >> 2
    else:
        e[24:32] = t[7]
        e[32] = t[7]
    return e


def pred_8x8(mode: int, edge: np.ndarray, at: bool, al: bool):
    """One Intra_8x8 prediction from the filtered edge (spec 8.3.2.2;
    the directional modes through ops.predict8's [6, 64, 3] table)."""
    from ..ops.predict8 import I8_TABLES
    e = edge.astype(np.int64)
    out = np.zeros((8, 8), np.int64)
    lcol = e[14:6:-1]
    trow = e[16:24]
    if mode == 0:
        out[:, :] = trow[None, :]
    elif mode == 1:
        out[:, :] = lcol[:, None]
    elif mode == 2:
        if at and al:
            out[:, :] = (lcol.sum() + trow.sum() + 8) >> 4
        elif al:
            out[:, :] = (lcol.sum() + 4) >> 3
        elif at:
            out[:, :] = (trow.sum() + 4) >> 3
        else:
            out[:, :] = 128
    else:
        g = e[I8_TABLES[mode - 3]]                          # [64, 3]
        out = ((g[:, 0] + 2 * g[:, 1] + g[:, 2] + 2) >> 2).reshape(8, 8)
    return out
