"""H.264 integer transforms + quantization (port of ops/transform.py).

The quant and dequant functions take the encoder's `ops.cqm.QuantTables`
(`tables`; None: the flat lists and default deadzones) and pick the
intra or inter class. All arithmetic is int32 so that wrap-around
matches the reference: under a custom list the quant product (bias +
|c|) * mf and the dequant product level * dmf can leave int32 and wrap.
Tensors use the coefficient-plane layout [..., 4(r), 4(c), BY, BX].
"""

from __future__ import annotations

import numpy as np
import torch


_DEQUANT4_SCALE = np.array([
    [10, 13, 16], [11, 14, 18], [13, 16, 20],
    [14, 18, 23], [16, 20, 25], [18, 23, 29]], dtype=np.int64)
_QUANT4_SCALE = np.array([
    [13107, 8066, 5243], [11916, 7490, 4660], [10082, 6554, 4194],
    [9362, 5825, 3647], [8192, 5243, 3355], [7282, 4559, 2893]],
    dtype=np.int64)


def _build_tables(scaling=None, deadzone_intra: int = 21,
                  deadzone_inter: int = 11):
    """4x4 quant/dequant tables for one scaling list (x264_cqm_init,
    common/set.c:68-151: quant_mf = SHIFT(DIV(def * 16, scale), q / 6 -
    1), dequant_mf = def * scale, bias = min(DIV(deadzone << 10, mf),
    (1 << 15) / mf)). scaling: [16] raster list, None = flat 16.
    Returns (quant_mf [52,4,4], bias_intra, bias_inter, dequant_mf
    [6,4,4]) int32."""
    i = np.arange(16)
    cls = ((i & 1) + ((i >> 2) & 1)).reshape(4, 4)
    def_quant = _QUANT4_SCALE[:, cls]
    def_dequant = _DEQUANT4_SCALE[:, cls]
    sc = (np.full((4, 4), 16, np.int64) if scaling is None
          else np.asarray(scaling, np.int64).reshape(4, 4))
    quant_mf = np.zeros((52, 4, 4), np.int64)
    bias_intra = np.zeros((52, 4, 4), np.int64)
    bias_inter = np.zeros((52, 4, 4), np.int64)
    base = (def_quant * 16 + sc // 2) // sc
    for q in range(52):
        s = q // 6 - 1
        mf = (base[q % 6] + (1 << (s - 1))) >> s if s > 0 \
            else base[q % 6] << (-s)
        quant_mf[q] = mf
        for dz, out in ((deadzone_intra, bias_intra),
                        (deadzone_inter, bias_inter)):
            out[q] = np.minimum((dz * (1 << 10) + mf // 2) // mf,
                                (1 << 15) // mf)
    dequant_mf = def_dequant * sc
    return (quant_mf.astype(np.int32), bias_intra.astype(np.int32),
            bias_inter.astype(np.int32), dequant_mf.astype(np.int32))


QUANT4_MF, QUANT4_BIAS_INTRA, QUANT4_BIAS_INTER, DEQUANT4_MF = \
    _build_tables()

CHROMA_QP_TABLE = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39]),
]).astype(np.int32)

ZIGZAG_4x4 = np.array([
    (0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
    (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3),
], dtype=np.int32)


def chroma_qp(qp: int, offset: int = 0) -> int:
    return int(CHROMA_QP_TABLE[min(51, max(0, qp + offset))])


def _fwd_butterfly(x: torch.Tensor, dim: int) -> torch.Tensor:
    x0, x1, x2, x3 = x.unbind(dim)
    s03, s12 = x0 + x3, x1 + x2
    d03, d12 = x0 - x3, x1 - x2
    return torch.stack([s03 + s12, 2 * d03 + d12, s03 - s12,
                        d03 - 2 * d12], dim=dim)


def _inv_butterfly(x: torch.Tensor, dim: int) -> torch.Tensor:
    x0, x1, x2, x3 = x.unbind(dim)
    s02, d02 = x0 + x2, x0 - x2
    s13 = x1 + (x3 >> 1)
    d13 = (x1 >> 1) - x3
    return torch.stack([s02 + s13, d02 + d13, d02 - d13, s02 - s13],
                       dim=dim)


def dct4x4(res: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 core transform on [..., 4, 4, BY, BX]."""
    return _fwd_butterfly(_fwd_butterfly(res, -3), -4)


def idct4x4(coef: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 transform before the final (x + 32) >> 6."""
    return _inv_butterfly(_inv_butterfly(coef, -3), -4)


def idct4x4_add(pred: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    r = (idct4x4(coef) + 32) >> 6
    return torch.clamp(pred + r, 0, 255)


def hadamard4x4(x: torch.Tensor, final_shift: bool = False) -> torch.Tensor:
    """4x4 Walsh-Hadamard over axes (-4, -3)."""
    def bf(v, dim):
        v0, v1, v2, v3 = v.unbind(dim)
        s01, d01 = v0 + v1, v0 - v1
        s23, d23 = v2 + v3, v2 - v3
        return torch.stack([s01 + s23, s01 - s23, d01 - d23, d01 + d23],
                           dim=dim)
    out = bf(bf(x, -3), -4)
    if final_shift:
        out = (out + 1) >> 1
    return out


def hadamard2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard on [..., 2, 2, Y, X]."""
    a, b = x[..., 0, 0, :, :], x[..., 0, 1, :, :]
    c, d = x[..., 1, 0, :, :], x[..., 1, 1, :, :]
    o00 = a + b + c + d
    o01 = a - b + c - d
    o10 = a + b - c - d
    o11 = a - b - c + d
    return torch.stack([torch.stack([o00, o01], dim=-3),
                        torch.stack([o10, o11], dim=-3)], dim=-4)


def _tables(tables):
    """The encoder's `ops.cqm.QuantTables`, or the flat one for None."""
    if tables is None:
        from .cqm import FLAT
        return FLAT
    return tables


def _per_mb(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-MB [N] tensor shaped to broadcast over dim 0 of an ndim-D
    operand."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 1))


def _per_mb_tab(tab: torch.Tensor, qp: torch.Tensor, ndim: int):
    """tab[qp] [N, 4, 4] of a per-MB qp [N], shaped to broadcast over an
    ndim-D [N, 4, 4, ...] operand."""
    t = tab[qp.reshape(-1).long()]
    return t.reshape(t.shape + (1,) * (ndim - 3))


def _shift_both(x: torch.Tensor, qbits: torch.Tensor) -> torch.Tensor:
    """x << qbits where qbits >= 0, else (x + 2^(-qbits-1)) >> -qbits,
    per element of a qbits tensor."""
    shl = x << torch.clamp(qbits, min=0)
    f = 1 << torch.clamp(-qbits - 1, min=0)
    shr = (x + f) >> torch.clamp(-qbits, min=0)
    return torch.where(qbits >= 0, shl, shr)


def _dc_factor(tab: np.ndarray, qp, x: torch.Tensor):
    """tab[qp] as an int, or for a per-MB qp as a tensor broadcasting
    over dim 0 of x."""
    if isinstance(qp, torch.Tensor):
        t = torch.as_tensor(np.ascontiguousarray(tab), device=x.device)
        return _per_mb(t[qp.reshape(-1).long()], x.dim())
    return int(tab[qp])


def quant4x4(coef: torch.Tensor, qp, intra: bool,
             tables=None) -> torch.Tensor:
    """sign(c) * ((bias + |c|) * mf >> 16) with the class's tables. coef
    [N, 4, 4, ...]; qp an int, or a per-MB int32 [N] tensor (adaptive
    quantization) that broadcasts over the block coordinates."""
    qt, li = _tables(tables), 0 if intra else 1
    if isinstance(qp, torch.Tensor):
        mf = _per_mb_tab(qt.dev("mf4", coef.device)[li], qp, coef.dim())
        bias = _per_mb_tab(qt.dev("bias4", coef.device)[li], qp, coef.dim())
    else:
        mf = qt.dev("mf4", coef.device)[li, qp][:, :, None, None]
        bias = qt.dev("bias4", coef.device)[li, qp][:, :, None, None]
    mag = (bias + torch.abs(coef)) * mf >> 16
    return torch.sign(coef) * mag


def dequant4x4(level: torch.Tensor, qp, intra: bool = False,
               tables=None) -> torch.Tensor:
    """Normative AC dequant with the class's list: level * dmf <<
    qbits, or (level * dmf + 2^(-qbits-1)) >> -qbits below qp 24
    (qbits = qp/6 - 4; flat lists round nothing there, custom ones
    do). qp an int or a per-MB [N] tensor, as for `quant4x4`."""
    qt, li = _tables(tables), 0 if intra else 1
    if isinstance(qp, torch.Tensor):
        dmf = _per_mb_tab(qt.dev("dmf4", level.device)[li], qp % 6,
                          level.dim())
        return _shift_both(level * dmf, _per_mb(qp // 6 - 4, level.dim()))
    dmf = qt.dev("dmf4", level.device)[li, qp % 6][:, :, None, None]
    qbits = qp // 6 - 4
    if qbits >= 0:
        return (level * dmf) << qbits
    return (level * dmf + (1 << (-qbits - 1))) >> (-qbits)


def quant_dc(coef: torch.Tensor, qp, intra: bool,
             tables=None) -> torch.Tensor:
    """DC quant: mf[0] >> 1, bias[0] << 1 (encoder/macroblock.c:252).
    qp an int or a per-MB [N] tensor over dim 0 of coef."""
    qt, li = _tables(tables), 0 if intra else 1
    mf = _dc_factor(qt.mf4[li, :, 0, 0] >> 1, qp, coef)
    bias = _dc_factor(qt.bias4[li, :, 0, 0] << 1, qp, coef)
    mag = (bias + torch.abs(coef)) * mf >> 16
    return torch.sign(coef) * mag


def dequant_dc_luma(dc: torch.Tensor, qp, tables=None) -> torch.Tensor:
    """Intra 16x16 DC dequant (always the intra list), qbits = qp/6 -
    6, after the inverse Hadamard. qp an int or a per-MB [N] tensor."""
    dmf = _dc_factor(_tables(tables).dmf4[0, :, 0, 0], qp % 6, dc)
    if isinstance(qp, torch.Tensor):
        return _shift_both(dc * dmf, _per_mb(qp // 6 - 6, dc.dim()))
    qbits = qp // 6 - 6
    if qbits >= 0:
        return (dc * dmf) << qbits
    return (dc * dmf + (1 << (-qbits - 1))) >> (-qbits)


def dequant_dc_chroma(dc: torch.Tensor, qp, intra: bool = False,
                      tables=None) -> torch.Tensor:
    """Chroma DC dequant with the class's list, qbits = qp/6 - 5, no
    rounding term. qp an int or a per-MB [N] tensor."""
    dmf = _dc_factor(_tables(tables).dmf4[0 if intra else 1, :, 0, 0],
                     qp % 6, dc)
    if isinstance(qp, torch.Tensor):
        qbits = _per_mb(qp // 6 - 5, dc.dim())
        return torch.where(qbits > 0,
                           (dc * dmf) << torch.clamp(qbits, min=0),
                           (dc * dmf) >> torch.clamp(-qbits, min=0))
    qbits = qp // 6 - 5
    if qbits > 0:
        return (dc * dmf) << qbits
    return (dc * dmf) >> (-qbits)
