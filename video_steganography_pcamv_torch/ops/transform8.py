"""High-profile 8x8 transform (port of ops/transform8.py): the integer
DCT8/IDCT8, quant/dequant with the 8x8 tables, the 8x8 zigzag and
x264's 64-coefficient decimation score.

`build_tables8` reproduces x264_cqm_init for any pair of 8x8 lists; the
quant and dequant take the encoder's `ops.cqm.QuantTables` (None: flat
lists, default deadzones). Arithmetic is int32, as the reference
computes it with 64-bit types off: the quant and dequant products wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from . import const
from .transform import _tables

_I32 = torch.int32

# position-class scan for 8x8 (x264 set.c quant8_scan): the class of
# raster position i is _QUANT8_SCAN[((i >> 1) & 12) | (i & 3)]
_QUANT8_SCAN = np.array([0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1],
                        np.int64)
_DEQUANT8_SCALE = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], np.int64)
_QUANT8_SCALE = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], np.int64)


def pos_class8() -> np.ndarray:
    i = np.arange(64)
    return _QUANT8_SCAN[((i >> 1) & 12) | (i & 3)].reshape(8, 8)


def build_tables8(scaling_intra=None, scaling_inter=None,
                  dz_intra: int = 21, dz_inter: int = 11):
    """(quant_mf [2,52,8,8], bias [2,52,8,8], dequant_mf [2,6,8,8])
    int32, list 0 intra and 1 inter, for the given [64] raster lists
    (None: flat 16): quant8_mf = SHIFT(DIV(def * 16, scale), q / 6),
    dequant8_mf = def * scale, bias = min(DIV(deadzone << 10, mf),
    (1 << 15) / mf)."""
    cls = pos_class8()
    out_q = np.zeros((2, 52, 8, 8), np.int64)
    out_bi = np.zeros((2, 52, 8, 8), np.int64)
    out_dq = np.zeros((2, 6, 8, 8), np.int64)
    for li, (lst, dz) in enumerate(((scaling_intra, dz_intra),
                                    (scaling_inter, dz_inter))):
        sc = (np.full((8, 8), 16, np.int64) if lst is None
              else np.asarray(lst, np.int64).reshape(8, 8))
        for q in range(52):
            base = (_QUANT8_SCALE[q % 6][cls] * 16 + sc // 2) // sc
            s = q // 6
            mf = (base + (1 << (s - 1))) >> s if s > 0 else base
            out_q[li, q] = mf
            out_bi[li, q] = np.minimum((dz * (1 << 10) + mf // 2) // mf,
                                       (1 << 15) // mf)
        for q in range(6):
            out_dq[li, q] = _DEQUANT8_SCALE[q][cls] * sc
    return (out_q.astype(np.int32), out_bi.astype(np.int32),
            out_dq.astype(np.int32))


QUANT8_MF, QUANT8_BIAS, DEQUANT8_MF = build_tables8()


def _zigzag8() -> np.ndarray:
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[1] if (p[0] + p[1]) % 2 == 0
                                  else p[0]))
    return np.array(order, np.int32)


ZIGZAG_8x8 = _zigzag8()
# zigzag position -> raster index 8r + c
ZIGZAG_8x8_FLAT = (8 * ZIGZAG_8x8[:, 0] + ZIGZAG_8x8[:, 1]).astype(np.int64)


def _dct1d(x: torch.Tensor) -> torch.Tensor:
    s0, s1, s2, s3, s4, s5, s6, s7 = x.unbind(-1)
    s07, s16, s25, s34 = s0 + s7, s1 + s6, s2 + s5, s3 + s4
    a0, a1 = s07 + s34, s16 + s25
    a2, a3 = s07 - s34, s16 - s25
    d07, d16, d25, d34 = s0 - s7, s1 - s6, s2 - s5, s3 - s4
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    return torch.stack([
        a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
        a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7], dim=-1)


def dct8x8(res: torch.Tensor) -> torch.Tensor:
    """Forward 8x8 integer transform of [..., 8, 8] residual blocks
    (columns, then rows). The output is in the spec orientation C[r][c],
    r the vertical frequency, not x264's transposed store."""
    x = res.to(_I32)
    t = _dct1d(x.transpose(-1, -2)).transpose(-1, -2)
    return _dct1d(t)


def _idct1d(x: torch.Tensor) -> torch.Tensor:
    s0, s1, s2, s3, s4, s5, s6, s7 = x.unbind(-1)
    a0, a2 = s0 + s4, s0 - s4
    a4, a6 = (s2 >> 1) - s6, (s6 >> 1) + s2
    b0, b2, b4, b6 = a0 + a6, a2 + a4, a2 - a4, a0 - a6
    a1 = -s3 + s5 - s7 - (s7 >> 1)
    a3 = s1 + s7 - s3 - (s3 >> 1)
    a5 = -s1 + s7 + s5 + (s5 >> 1)
    a7 = s3 + s5 + s1 + (s1 >> 1)
    b1, b3 = (a7 >> 2) + a1, a3 + (a5 >> 2)
    b5, b7 = (a3 >> 2) - a5, a7 - (a1 >> 2)
    return torch.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1,
                        b6 - b1, b4 - b3, b2 - b5, b0 - b7], dim=-1)


def idct8x8_add(pred: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Inverse 8x8 transform + reconstruction of spec-orientation
    coefficients: dc += 32, the two passes on the transpose (x264's
    add8x8_idct8), >> 6, add to pred, clip to [0, 255]."""
    x = coef.to(_I32).transpose(-1, -2).clone()
    x[..., 0, 0] += 32
    t = _idct1d(x.transpose(-1, -2)).transpose(-1, -2)
    r = _idct1d(t).transpose(-1, -2)
    return torch.clamp(pred.to(_I32) + (r >> 6), 0, 255)


def _per_mb8(tab: torch.Tensor, qp: torch.Tensor, ndim: int):
    """tab[qp] [N, 8, 8] of a per-MB qp [N], shaped [N, 1.., 8, 8] to
    broadcast over an ndim-D [N, ..., 8, 8] operand."""
    t = tab[qp.reshape(-1).long()]
    return t.reshape(t.shape[:1] + (1,) * (ndim - 3) + t.shape[1:])


def quant8x8(coef: torch.Tensor, qp, intra: bool,
             tables=None) -> torch.Tensor:
    """sign(c) * (((bias + |c|) * mf) >> 16) over [..., 8, 8], int32. qp
    an int, or a per-MB [N] tensor over dim 0 of coef ([N, 8, 8] or
    [N, 2, 2, 8, 8])."""
    qt, li = _tables(tables), 0 if intra else 1
    if isinstance(qp, torch.Tensor):
        mf = _per_mb8(qt.dev("mf8", coef.device)[li], qp, coef.dim())
        bias = _per_mb8(qt.dev("bias8", coef.device)[li], qp, coef.dim())
    else:
        mf = qt.dev("mf8", coef.device)[li, qp]
        bias = qt.dev("bias8", coef.device)[li, qp]
    c = coef.to(_I32)
    mag = ((bias + torch.abs(c)) * mf) >> 16
    return torch.sign(c) * mag


def dequant8x8(level: torch.Tensor, qp, intra: bool = False,
               tables=None) -> torch.Tensor:
    """x264 dequant_8x8: qbits = qp / 6 - 6; a left shift, or a rounded
    right shift below qp 36. qp an int or a per-MB [N] tensor, as for
    `quant8x8`."""
    qt, li = _tables(tables), 0 if intra else 1
    if isinstance(qp, torch.Tensor):
        dmf = _per_mb8(qt.dev("dmf8", level.device)[li], qp % 6,
                       level.dim())
        qbits = (qp // 6 - 6).reshape((-1,) + (1,) * (level.dim() - 1))
        lvl = level.to(_I32) * dmf
        shl = lvl << torch.clamp(qbits, min=0)
        f = 1 << torch.clamp(-qbits - 1, min=0)
        shr = (lvl + f) >> torch.clamp(-qbits, min=0)
        return torch.where(qbits >= 0, shl, shr)
    dmf = qt.dev("dmf8", level.device)[li, qp % 6]
    lvl = level.to(_I32) * dmf
    qbits = qp // 6 - 6
    if qbits >= 0:
        return lvl << qbits
    return (lvl + (1 << (-qbits - 1))) >> -qbits


# x264_decimate_table8 (JVT-B118 run table for 64 coefficients)
DECIMATE_TABLE8 = np.array(
    [3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1] + [0] * 40, np.int32)


def zigzag8(lev8: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] -> [..., 64] in zigzag scan order."""
    flat = lev8.reshape(*lev8.shape[:-2], 64)
    return flat[..., const(ZIGZAG_8x8_FLAT, lev8.device)]


def decimate_score64(lev8: torch.Tensor) -> torch.Tensor:
    """x264_decimate_score64 over [..., 8, 8] levels -> [...] (9 when
    any |level| > 1)."""
    dev = lev8.device
    a = torch.abs(zigzag8(lev8))
    anybig = (a > 1).any(-1)
    nz = a > 0
    idx = torch.arange(64, device=dev, dtype=_I32)
    marked = torch.where(nz, idx, -1)
    prev = torch.cummax(marked, dim=-1).values
    prev_excl = torch.cat([torch.full_like(prev[..., :1], -1),
                           prev[..., :-1]], dim=-1)
    run = idx - prev_excl - 1
    tab = const(DECIMATE_TABLE8, dev)
    contrib = torch.where(nz, tab[torch.clamp(run, 0, 63).long()], 0)
    return torch.where(anybig, 9, contrib.sum(-1, dtype=_I32))
