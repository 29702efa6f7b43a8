"""Intra predictors batched over N blocks (port of ops/predict.py).

Mode numbering follows the bitstream (spec 8.3.1 / 8.3.3 / 8.3.4):
  i16x16: 0=V 1=H 2=DC 3=Planar      chroma: 0=DC 1=H 2=V 3=Planar
  i4x4:   0=V 1=H 2=DC 3=DDL 4=DDR 5=VR 6=HD 7=VL 8=HU
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import const

_I32 = torch.int32


def _dc_pred(top, left, avail_top, avail_left, n: int):
    st = top.sum(-1, dtype=_I32)
    sl = left.sum(-1, dtype=_I32)
    lg = int(math.log2(n))
    both = (st + sl + n) >> (lg + 1)
    only_t = (st + n // 2) >> lg
    only_l = (sl + n // 2) >> lg
    return torch.where(avail_top & avail_left, both,
                       torch.where(avail_top, only_t,
                                   torch.where(avail_left, only_l, 128)))


def _planar(top, left, topleft, n: int):
    half = n // 2
    xs = torch.arange(1, half + 1, device=top.device, dtype=_I32)
    hi = (half - 1 + xs).long()
    lo = (half - 1 - xs[:-1]).long()
    top_hi = top[:, hi]
    top_lo = torch.cat([top[:, lo], topleft[:, None]], dim=1)
    hgrad = (xs * (top_hi - top_lo)).sum(-1, dtype=_I32)
    left_hi = left[:, hi]
    left_lo = torch.cat([left[:, lo], topleft[:, None]], dim=1)
    vgrad = (xs * (left_hi - left_lo)).sum(-1, dtype=_I32)
    if n == 16:
        b = (5 * hgrad + 32) >> 6
        c = (5 * vgrad + 32) >> 6
    else:
        b = (17 * hgrad + 16) >> 5
        c = (17 * vgrad + 16) >> 5
    a = 16 * (top[:, n - 1] + left[:, n - 1])
    x = torch.arange(n, device=top.device, dtype=_I32)
    grid = (a[:, None, None]
            + b[:, None, None] * (x[None, None, :] - (half - 1))
            + c[:, None, None] * (x[None, :, None] - (half - 1)) + 16) >> 5
    return torch.clamp(grid, 0, 255)


def predict_i16x16_all(top, left, topleft, avail_top, avail_left):
    """[N, 4, 16, 16] (V, H, DC, Planar)."""
    n = top.shape[0]
    v = top[:, None, :].expand(n, 16, 16)
    h = left[:, :, None].expand(n, 16, 16)
    dc = _dc_pred(top, left, avail_top, avail_left, 16)[:, None, None] \
        .expand(n, 16, 16)
    pl = _planar(top, left, topleft, 16)
    return torch.stack([v, h, dc.to(v.dtype), pl], dim=1)


def _chroma_dc(top, left, avail_top, avail_left):
    t0 = top[:, :4].sum(-1, dtype=_I32)
    t1 = top[:, 4:].sum(-1, dtype=_I32)
    l0 = left[:, :4].sum(-1, dtype=_I32)
    l1 = left[:, 4:].sum(-1, dtype=_I32)
    at, al = avail_top, avail_left

    def q(sum_t, sum_l):
        return torch.where(at & al, (sum_t + sum_l + 4) >> 3,
                           torch.where(at, (sum_t + 2) >> 2,
                                       torch.where(al, (sum_l + 2) >> 2,
                                                   128)))

    q00 = q(t0, l0)
    q01 = torch.where(at, (t1 + 2) >> 2,
                      torch.where(al, (l0 + 2) >> 2, 128))
    q10 = torch.where(al, (l1 + 2) >> 2,
                      torch.where(at, (t0 + 2) >> 2, 128))
    q11 = q(t1, l1)
    quad = torch.stack([torch.stack([q00, q01], -1),
                        torch.stack([q10, q11], -1)], -2)
    return quad.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)


def predict_chroma_all(top, left, topleft, avail_top, avail_left):
    """[N, 4, 8, 8] (DC, H, V, Planar)."""
    n = top.shape[0]
    dc = _chroma_dc(top, left, avail_top, avail_left)
    h = left[:, :, None].expand(n, 8, 8)
    v = top[:, None, :].expand(n, 8, 8)
    pl = _planar(top, left, topleft, 8)
    return torch.stack([dc.to(h.dtype), h, v, pl], dim=1)


def _build_i4_tables() -> np.ndarray:
    """[6 modes (DDL..HU), 16 pixels, 3] indices into the 13-sample
    border vector c = [l3,l2,l1,l0,lt,t0..t7] (spec 8.3.1.2.4-9)."""
    def L(i):
        return 4 if i == -1 else 3 - i

    LT = 4

    def T(i):
        return 4 if i == -1 else 5 + i

    out = np.zeros((6, 16, 3), np.int64)
    for y in range(4):
        for x in range(4):
            px = 4 * y + x
            i = x + y
            out[0, px] = ((T(6), T(7), T(7)) if i == 6
                          else (T(i), T(i + 1), T(i + 2)))
            k = 4 + x - y
            out[1, px] = (k - 1, k, k + 1)
            z = 2 * x - y
            i = x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                out[2, px] = (T(i - 1), T(i), T(i - 1))
            elif z >= 0:
                out[2, px] = (T(i - 2), T(i - 1), T(i))
            elif z == -1:
                out[2, px] = (L(0), LT, T(0))
            else:
                out[2, px] = (L(y - 1), L(y - 2), L(y - 3))
            z = 2 * y - x
            i = y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                out[3, px] = (L(i - 1), L(i), L(i - 1))
            elif z >= 0:
                out[3, px] = (L(i - 2), L(i - 1), L(i))
            elif z == -1:
                out[3, px] = (T(0), LT, L(0))
            else:
                out[3, px] = (T(x - 1), T(x - 2), T(x - 3))
            i = x + (y >> 1)
            if y % 2 == 0:
                out[4, px] = (T(i), T(i + 1), T(i))
            else:
                out[4, px] = (T(i), T(i + 1), T(i + 2))
            z = x + 2 * y
            i = y + (x >> 1)
            if z < 5 and z % 2 == 0:
                out[5, px] = (L(i), L(i + 1), L(i))
            elif z < 5:
                out[5, px] = (L(i), L(i + 1), L(i + 2))
            elif z == 5:
                out[5, px] = (L(2), L(3), L(3))
            else:
                out[5, px] = (L(3), L(3), L(3))
    return out


_I4_TABLES = _build_i4_tables()

I4_NEEDS_TOP = np.array([1, 0, 0, 1, 1, 1, 1, 1, 0], bool)
I4_NEEDS_LEFT = np.array([0, 1, 0, 0, 1, 1, 1, 0, 1], bool)


def predict_i4x4_all(top8, left, topleft, avail_top, avail_left):
    """[N, 9, 4, 4]; top8 = t0..t7 (top-right already substituted)."""
    n = top8.shape[0]
    c = torch.cat([left.flip(1), topleft[:, None], top8], dim=1)
    v = top8[:, None, :4].expand(n, 4, 4)
    h = left[:, :, None].expand(n, 4, 4)
    dc = _dc_pred(top8[:, :4], left, avail_top, avail_left, 4) \
        [:, None, None].expand(n, 4, 4).to(v.dtype)
    g = c[:, const(_I4_TABLES, c.device)]                 # [N,6,16,3]
    dirs = ((g[..., 0] + 2 * g[..., 1] + g[..., 2] + 2) >> 2) \
        .reshape(n, 6, 4, 4)
    return torch.cat([torch.stack([v, h, dc], dim=1), dirs], dim=1)
