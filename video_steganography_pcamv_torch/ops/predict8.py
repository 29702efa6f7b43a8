"""Intra 8x8 prediction (port of ops/predict8.py): x264's reference-edge
filter and all nine Intra_8x8 modes, batched over blocks.

The six directional modes are a static [6, 64, 3] index table into the
33-sample filtered edge, evaluated as (a + 2b + c + 2) >> 2. Edge layout
(x264 predict_8x8_filter): edge[7..14] = l7..l0, edge[15] = lt,
edge[16..31] = t0..t15, edge[32] = t15.
"""

from __future__ import annotations

import numpy as np
import torch

from . import const

_I32 = torch.int32


def _L(i):
    return 15 if i == -1 else 14 - i


_LT = 15


def _T(i):
    return 15 if i == -1 else 16 + i


def _build_i8_tables() -> np.ndarray:
    """[6 modes (DDL, DDR, VR, HD, VL, HU), 64 pixels, 3] edge indices."""
    out = np.zeros((6, 64, 3), np.int64)
    for y in range(8):
        for x in range(8):
            px = 8 * y + x
            i = x + y
            out[0, px] = ((_T(14), _T(15), _T(15)) if i == 14
                          else (_T(i), _T(i + 1), _T(i + 2)))
            d = x - y
            out[1, px] = (14 + d, 15 + d, 16 + d)
            z = 2 * x - y
            i = x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                out[2, px] = (_T(i - 1), _T(i), _T(i - 1))
            elif z >= 0:
                out[2, px] = (_T(i - 2), _T(i - 1), _T(i))
            elif z == -1:
                out[2, px] = (_L(0), _LT, _T(0))
            else:
                out[2, px] = (_L(y - 2 * x - 1), _L(y - 2 * x - 2),
                              _L(y - 2 * x - 3))
            z = 2 * y - x
            i = y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                out[3, px] = (_L(i - 1), _L(i), _L(i - 1))
            elif z >= 0:
                out[3, px] = (_L(i - 2), _L(i - 1), _L(i))
            elif z == -1:
                out[3, px] = (_T(0), _LT, _L(0))
            else:
                out[3, px] = (_T(x - 2 * y - 1), _T(x - 2 * y - 2),
                              _T(x - 2 * y - 3))
            i = x + (y >> 1)
            if y % 2 == 0:
                out[4, px] = (_T(i), _T(i + 1), _T(i))
            else:
                out[4, px] = (_T(i), _T(i + 1), _T(i + 2))
            z = x + 2 * y
            i = y + (x >> 1)
            if z < 13 and z % 2 == 0:
                out[5, px] = (_L(i), _L(i + 1), _L(i))
            elif z < 13:
                out[5, px] = (_L(i), _L(i + 1), _L(i + 2))
            elif z == 13:
                out[5, px] = (_L(6), _L(7), _L(7))
            else:
                out[5, px] = (_L(7), _L(7), _L(7))
    return out


I8_TABLES = _build_i8_tables()

# mode numbering (spec 8.3.2.1): 0 V, 1 H, 2 DC, 3 DDL, 4 DDR, 5 VR,
# 6 HD, 7 VL, 8 HU
I8_NEEDS_TOP = np.array([1, 0, 0, 1, 1, 1, 1, 1, 0], bool)
I8_NEEDS_LEFT = np.array([0, 1, 0, 0, 1, 1, 1, 0, 1], bool)


def _f2(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def filter_edges(lt, top, left, have_lt, have_tr) -> torch.Tensor:
    """x264_predict_8x8_filter, batched. lt [N]; top [N, 16] raw (t8..
    t15 already replaced by t7 by the caller when the top-right is
    absent); left [N, 8]; have_lt/have_tr [N] bool. Returns edge [N, 33]
    int32; entries of absent neighbours are computed from whatever the
    caller passed (the caller masks those modes)."""
    lt = lt.to(_I32)
    t = top.to(_I32)
    lf = left.to(_I32)
    n = lt.shape[0]
    e = torch.zeros((n, 33), dtype=_I32, device=lt.device)
    e[:, 15] = (t[:, 0] + 2 * lt + lf[:, 0] + 2) >> 2
    lt_or_l0 = torch.where(have_lt, lt, lf[:, 0])
    e[:, 14] = (lt_or_l0 + 2 * lf[:, 0] + lf[:, 1] + 2) >> 2
    for yy in range(1, 7):
        e[:, 14 - yy] = _f2(lf[:, yy - 1], lf[:, yy], lf[:, yy + 1])
    e[:, 7] = (lf[:, 6] + 3 * lf[:, 7] + 2) >> 2
    lt_or_t0 = torch.where(have_lt, lt, t[:, 0])
    e[:, 16] = (lt_or_t0 + 2 * t[:, 0] + t[:, 1] + 2) >> 2
    for xx in range(1, 7):
        e[:, 16 + xx] = _f2(t[:, xx - 1], t[:, xx], t[:, xx + 1])
    t8_or_t7 = torch.where(have_tr, t[:, 8], t[:, 7])
    e[:, 23] = (t[:, 6] + 2 * t[:, 7] + t8_or_t7 + 2) >> 2
    tr = torch.zeros((n, 9), dtype=_I32, device=lt.device)
    for xx in range(8, 15):
        tr[:, xx - 8] = _f2(t[:, xx - 1], t[:, xx], t[:, min(xx + 1, 15)])
    last = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    tr[:, 7] = last
    tr[:, 8] = last
    e[:, 24:33] = torch.where(have_tr[:, None], tr,
                              t[:, 7:8].expand(n, 9))
    return e


def predict_i8x8_all(edge, avail_top, avail_left) -> torch.Tensor:
    """All nine 8x8 predictions [N, 9, 8, 8] int32 from the filtered
    edges [N, 33]; DC falls back to left-only, top-only or 128."""
    n = edge.shape[0]
    g = edge[:, const(I8_TABLES, edge.device)]             # [N,6,64,3]
    diag = ((g[..., 0] + 2 * g[..., 1] + g[..., 2] + 2) >> 2) \
        .reshape(n, 6, 8, 8)
    lcol = edge[:, 7:15].flip(1)                           # l0..l7
    trow = edge[:, 16:24]
    v = trow[:, None, :].expand(n, 8, 8)
    h = lcol[:, :, None].expand(n, 8, 8)
    suml = lcol.sum(1, dtype=_I32)
    sumt = trow.sum(1, dtype=_I32)
    dcv = torch.where(avail_top & avail_left, (suml + sumt + 8) >> 4,
                      torch.where(avail_left, (suml + 4) >> 3,
                                  torch.where(avail_top, (sumt + 4) >> 3,
                                              128)))
    dc = dcv[:, None, None].expand(n, 8, 8)
    return torch.stack([v, h, dc] + list(diag.unbind(1)), dim=1)
