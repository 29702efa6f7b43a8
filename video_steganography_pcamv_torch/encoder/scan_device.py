"""Pass-1 MVP / P_SKIP scan on the device (port of `_scan_p_device`,
single reference, no intra MBs).

In pass 1 the committed MV grid is just the analysed field at 4x4
granularity and a neighbour cell is available iff it is in bounds and
its MB does not follow the current MB in raster order, so the spec
8.4.1.3 MVP and the 8.4.1.1 P_SKIP vector are batched gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const

_I32 = torch.int32

_OY = np.array([[0, 0, 0, 0], [0, 2, 0, 0], [0, 0, 0, 0], [0, 0, 2, 2]],
               np.int32)
_OX = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 2, 0, 0], [0, 2, 0, 2]],
               np.int32)
_W4 = np.array([[4, 4, 4, 4], [4, 4, 4, 4], [2, 2, 4, 4], [2, 2, 2, 2]],
               np.int32)
_USED = np.array([[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0],
                  [1, 1, 1, 1]], bool)


def _median3(a, b, c):
    return a + b + c - torch.minimum(a, torch.minimum(b, c)) \
        - torch.maximum(a, torch.maximum(b, c))


def _gather_cell(mv4, ny4, nx4, cur_idx, h4, w4):
    """(mv, ref, avail) of neighbour cells; every in-bounds cell of an
    earlier-or-current MB is an inter cell with ref 0."""
    inb = (ny4 >= 0) & (nx4 >= 0) & (ny4 < h4) & (nx4 < w4)
    cy = torch.clamp(ny4, 0, h4 - 1)
    cx = torch.clamp(nx4, 0, w4 - 1)
    mbw = w4 // 4
    cell_idx = torch.div(cy, 4, rounding_mode="floor") * mbw \
        + torch.div(cx, 4, rounding_mode="floor")
    avail = inb & (cell_idx <= cur_idx)
    mv = torch.where(avail[..., None], mv4[cy.long(), cx.long()], 0)
    ref = torch.where(avail, 0, -1)
    return mv, ref, avail


def _mvp_units(mv4, part, y4u, x4u, w4u, mbh, mbw):
    """MVP of every unit slot [mbh, mbw, k] (spec 8.4.1.3), ref 0."""
    h4, w4 = 4 * mbh, 4 * mbw
    dev = mv4.device
    my = torch.arange(mbh, device=dev, dtype=_I32)[:, None, None]
    mx = torch.arange(mbw, device=dev, dtype=_I32)[None, :, None]
    cur_idx = my * mbw + mx
    mva, ra, av_a = _gather_cell(mv4, y4u, x4u - 1, cur_idx, h4, w4)
    mvb, rb, av_b = _gather_cell(mv4, y4u - 1, x4u, cur_idx, h4, w4)
    mvc, rc, av_c = _gather_cell(mv4, y4u - 1, x4u + w4u, cur_idx, h4, w4)
    mvd, rd, av_d = _gather_cell(mv4, y4u - 1, x4u - 1, cur_idx, h4, w4)
    mvc = torch.where(av_c[..., None], mvc, mvd)
    rc = torch.where(av_c, rc, rd)
    av_c = av_c | av_d

    ma = av_a & (ra == 0)
    mb = av_b & (rb == 0)
    mc = av_c & (rc == 0)
    nmatch = ma.to(_I32) + mb.to(_I32) + mc.to(_I32)
    med = _median3(mva, mvb, mvc)
    one = torch.where(ma[..., None], mva,
                      torch.where(mb[..., None], mvb, mvc))
    base = torch.where((nmatch == 1)[..., None], one, med)
    only_a = (~av_b) & (~av_c) & av_a
    base = torch.where(only_a[..., None], mva, base)

    u = torch.arange(4, device=dev)[None, None, :]
    p3 = part[..., None]
    mvp = torch.where(((p3 == 1) & (u == 0) & mb)[..., None], mvb, base)
    mvp = torch.where(((p3 == 1) & (u == 1) & ma)[..., None], mva, mvp)
    mvp = torch.where(((p3 == 2) & (u == 0) & ma)[..., None], mva, mvp)
    mvp = torch.where(((p3 == 2) & (u == 1) & mc)[..., None], mvc, mvp)
    return mvp


def scan_p_device(part, mv8, cbp_luma, cbp_chroma, mbh: int, mbw: int):
    """Returns (skip [mbh,mbw] bool, mvd [mbh,mbw,4,2], mvp [mbh,mbw,4,2],
    mv8) for a single-reference P frame without intra MBs."""
    dev = mv8.device
    mv4 = mv8.repeat_interleave(2, 0).repeat_interleave(2, 1)
    partc = torch.clamp(part, 0, 3).long()
    oy = const(_OY, dev)[partc]
    ox = const(_OX, dev)[partc]
    w4u = const(_W4, dev)[partc]
    ar_h = torch.arange(mbh, device=dev, dtype=_I32)
    ar_w = torch.arange(mbw, device=dev, dtype=_I32)
    y4u = 4 * ar_h[:, None, None] + oy
    x4u = 4 * ar_w[None, :, None] + ox
    mvp = _mvp_units(mv4, part, y4u, x4u, w4u, mbh, mbw)

    uy = torch.clamp(torch.div(y4u, 2, rounding_mode="floor"),
                     0, 2 * mbh - 1).long()
    ux = torch.clamp(torch.div(x4u, 2, rounding_mode="floor"),
                     0, 2 * mbw - 1).long()
    umv = mv8[uy, ux]
    used = const(_USED, dev)[partc]
    mvd = torch.where(used[..., None], umv - mvp, 0)
    mvp = torch.where(used[..., None], mvp, 0)

    cur_idx = (ar_h[:, None] * mbw + ar_w[None, :])[..., None]
    ya = (4 * ar_h[:, None]).expand(mbh, mbw)[..., None]
    xa = (4 * ar_w[None, :]).expand(mbh, mbw)[..., None]
    h4, w4 = 4 * mbh, 4 * mbw
    mva, ra, av_a = _gather_cell(mv4, ya, xa - 1, cur_idx, h4, w4)
    mvb, rb, av_b = _gather_cell(mv4, ya - 1, xa, cur_idx, h4, w4)
    mva, ra, av_a = mva[..., 0, :], ra[..., 0], av_a[..., 0]
    mvb, rb, av_b = mvb[..., 0, :], rb[..., 0], av_b[..., 0]
    zero_a = (ra == 0) & (mva[..., 0] == 0) & (mva[..., 1] == 0)
    zero_b = (rb == 0) & (mvb[..., 0] == 0) & (mvb[..., 1] == 0)
    force0 = (~av_a) | (~av_b) | zero_a | zero_b
    p16 = torch.zeros((mbh, mbw), dtype=part.dtype, device=dev)
    mvp16 = _mvp_units(mv4, p16, ya, xa,
                       torch.full((mbh, mbw, 1), 4, dtype=_I32, device=dev),
                       mbh, mbw)[..., 0, :]
    pskip = torch.where(force0[..., None], 0, mvp16)

    here = mv8[::2, ::2]
    skip = ((part == 0) & (cbp_luma == 0) & (cbp_chroma == 0)
            & (here[..., 0] == pskip[..., 0])
            & (here[..., 1] == pskip[..., 1]))
    return skip, mvd, mvp, mv8
