"""Table-based 16x16 P-frame analysis (port of encoder/analyse2.py):
full-pel search (kernel B6) -> window fetch (kernel B7) -> qpel block
tables -> subpel argmin, then the stego costs from the same tables.

The reference picks B6 on a TPU and the plain `fullpel_search` with a
zero predictor elsewhere; the two are equal, so one path serves every
device here: `ops.fullpel.fullpel_search16` launches B6 on a CUDA
tensor and runs the plain search on a CPU one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import lumap as LP
from ..ops.fullpel import fullpel_search16
from ..stego.cost import D_MV, D_NB, rca_decide
from . import qpel_table as QT
from .inter import mb_tiles
from .me import mv_bits_table

_I32 = torch.int32

# subpel=2: the qpel offset box around 4 * mv_fp, oy outer
_OFFSETS = np.array([(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)],
                    np.int32)
_BITS = mv_bits_table(4 * 512)
# the probe versions (centre, then the 12 D_MV deltas) and the 9
# lattice neighbours of a version, as (dy, dx)
_CENTERS = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0])) for c in range(12)]
_NB = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]


def _didx(dy: int, dx: int) -> int:
    return dy * 13 + dx


def subpel_from_table(cur_y, wht169, mv_fp, prev_mv, mbh: int, mbw: int,
                      lam: int = 1):
    """The best qpel offset in [-3,3]^2 around 4*mv_fp by SATD +
    lam*bits(mv - prev_mv), first minimum in (oy, ox) order. Returns
    (mv [mbh,mbw,2] qpel, r_idx [N] table index of the chosen offset)."""
    mv, r_idx, _cost = subpel_cost_from_table(cur_y, wht169, mv_fp, prev_mv,
                                              mbh, mbw, lam)
    return mv, r_idx


def subpel_cost_from_table(cur_y, wht169, mv_fp, prev_mv, mbh: int,
                           mbw: int, lam: int = 1):
    """`subpel_from_table` that also returns the winning cost [mbh, mbw]
    (the reference's bslice `_subpel_cost` at subpel 2)."""
    dev = cur_y.device
    n = mbh * mbw
    wcur = QT.wht16(mb_tiles(cur_y, 16))
    mvf = mv_fp.reshape(n, 2)
    pred = prev_mv.reshape(n, 2)
    bits_t = const(_BITS, dev)
    off = 4 * 512
    costs = []
    for oy, ox in _OFFSETS.tolist():
        sat = QT.satd_tables(wcur, wht169[QT.off_index(oy, ox)])
        ix = torch.clamp(4 * mvf[:, 0] + ox - pred[:, 0], -off, off) + off
        iy = torch.clamp(4 * mvf[:, 1] + oy - pred[:, 1], -off, off) + off
        costs.append(sat + (bits_t[ix.long()] + bits_t[iy.long()]) * lam)
    costs = torch.stack(costs)
    sel = torch.argmin(costs, dim=0)
    best = costs.min(0).values
    offs = const(_OFFSETS, dev)[sel]                       # [N, 2] (oy, ox)
    mv = torch.stack([4 * mvf[:, 0] + offs[:, 1],
                      4 * mvf[:, 1] + offs[:, 0]], dim=-1)
    r_idx = (offs[:, 0] + 6) * 13 + (offs[:, 1] + 6)
    return (mv.reshape(mbh, mbw, 2).to(_I32), r_idx.to(_I32),
            best.reshape(mbh, mbw).to(_I32))


def analyse_p_frame(y, ref_luma, prev_mv, rng: int, mbh: int, mbw: int,
                    lam: int):
    """Full-pel ME (B6, zero predictor) -> window fetch (B7) -> qpel
    block table -> subpel argmin. Returns (mv [mbh,mbw,2] qpel, r_idx
    [N], blocks [169,N,16,16] int16, wht [169,N,4,4,4,4] int16); the
    tables stay on the device for the stego pass."""
    ref8 = ref_luma.to(torch.uint8)          # B6 reads plane 0, B7 all 4
    mv_fp, _cost = fullpel_search16(y, ref8[0], rng, mbh, mbw, lam)
    windows = QT.gather_windows(ref8, mv_fp, mbh, mbw)
    blocks = QT.block_table(windows)
    wht = QT.wht_table(blocks)
    mv_q, r_idx = subpel_from_table(y, wht, mv_fp, prev_mv, mbh, mbw, lam)
    return mv_q, r_idx, blocks, wht


def stego_costs_from_table(cur_y, blocks169, wht169, r_idx, mv, mvp,
                           cost_mv, qp: int, mbh: int, mbw: int,
                           tables=None):
    """Table-based x264_ih_get_mv_cost: each MB is encoded at its chosen
    offset and at the 12 D_MV candidates (one fused luma encode launch
    for all 13 versions, the current MBs read from the plane), and each
    recon is probed against its 9 lattice neighbours (quantized with
    the inter class of `tables`; no noise reduction, as in the
    reference). r_idx [N]; mv
    [mbh,mbw,2] qpel; mvp [mbh,mbw,2] the probe mv-cost predictor.
    Returns (rho [mbh,mbw] f32, alt_mv [mbh,mbw,2], flags [mbh,mbw,3])."""
    n = mbh * mbw
    ncm = cost_mv.shape[0]
    mvf = mv.reshape(n, 2)
    mvpf = mvp.reshape(n, 2)
    sel_wht = {(dy, dx): QT.select_rows(wht169, r_idx + _didx(dy, dx))
               for dy in range(-3, 4) for dx in range(-3, 4)}

    def mvcost(dq):
        ix = torch.abs(mvf[:, 0] + dq[1] - mvpf[:, 0])
        iy = torch.abs(mvf[:, 1] + dq[0] - mvpf[:, 1])
        return (cost_mv[torch.clamp(ix, max=ncm - 1).long()]
                + cost_mv[torch.clamp(iy, max=ncm - 1).long()])

    blk = torch.cat([QT.select_rows(blocks169, r_idx + _didx(*c))
                     for c in _CENTERS]).to(_I32)          # [13N,16,16]
    _, rec, _ = LP.luma_p_encode(cur_y, blk, qp, lev=False, tables=tables)
    wrec = QT.wht16(rec).reshape(len(_CENTERS), n, 4, 4, 4, 4)
    nbs = []
    for v, (cy, cx) in enumerate(_CENTERS):
        nbs.append(torch.stack([
            QT.satd_tables(wrec[v], sel_wht[(cy + d0, cx + d1)])
            + mvcost((cy + d0, cx + d1)) for d0, d1 in _NB], dim=1))
    nb0 = nbs[0]                                            # [N, 9]
    orig_cost = nb0[:, 8]
    orig_opt = nb0.min(1).values >= orig_cost
    cand_cost = torch.stack([nb[:, 8] for nb in nbs[1:]], dim=1)
    cand_opt = torch.stack([nb.min(1).values >= nb[:, 8] for nb in nbs[1:]],
                           dim=1)
    rho, sel_delta, flags = rca_decide(nb0, orig_cost, orig_opt, cand_cost,
                                       cand_opt)
    alt = (mvf + sel_delta).reshape(mbh, mbw, 2)
    return rho.reshape(mbh, mbw), alt.to(_I32), flags.reshape(mbh, mbw, 3)
