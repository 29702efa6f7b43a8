"""P-frame transform/quant/recon at given MVs (port of the serving
subset of encoder/inter.py): decimation on; trellis, 8x8 transform,
rd and noise reduction off; gather MC only."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import to_blocks

_I32 = torch.int32

# JVT-B118 decimation table (quant.c x264_mb_decimate_score)
_DS_TAB = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                   np.int32)


def mb_tiles(plane: torch.Tensor, b: int) -> torch.Tensor:
    """[b*mbh, b*mbw] plane -> [mbh*mbw, b, b] MB tiles (raster)."""
    h, w = plane.shape
    return plane.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3) \
        .reshape(-1, b, b)


def untile(t: torch.Tensor, mbh: int, mbw: int) -> torch.Tensor:
    b = t.shape[-1]
    return t.reshape(mbh, mbw, b, b).permute(0, 2, 1, 3) \
        .reshape(mbh * b, mbw * b)


def _zigzag_gather(levels: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4, BY, BX] -> [N, 16, BY, BX] in zigzag order."""
    zz = const(T.ZIGZAG_4x4, levels.device).long()
    return levels[:, zz[:, 0], zz[:, 1]]


def decimate_score(levels: torch.Tensor) -> torch.Tensor:
    """x264_mb_decimate_score over zigzag levels [N, 16, BY, BX]."""
    a = torch.abs(levels)
    anybig = (a > 1).any(1)
    nz = a > 0
    idx = torch.arange(16, device=levels.device,
                       dtype=_I32)[None, :, None, None]
    marked = torch.where(nz, idx, -1)
    prev = torch.cummax(marked, dim=1).values
    prev_excl = torch.cat([torch.full_like(prev[:, :1], -1),
                           prev[:, :-1]], dim=1)
    run = idx - prev_excl - 1
    tab = const(_DS_TAB, levels.device)
    contrib = torch.where(nz, tab[torch.clamp(run, 0, 15).long()], 0)
    return torch.where(anybig, 9, contrib.sum(1, dtype=_I32))


def luma_p_encode(cur, pred, qp: int):
    """Inter luma encode of [N,16,16] MBs: levels [N,4(r),4(c),4(by),
    4(bx)] after decimation, and the recon [N,16,16]."""
    n = cur.shape[0]
    coef = T.dct4x4(to_blocks(cur - pred, 4))
    lev = T.quant4x4(coef, qp, intra=False)
    sc = decimate_score(_zigzag_gather(lev))                 # [N,4,4]
    sc8 = sc.reshape(n, 2, 2, 2, 2).sum((2, 4), dtype=_I32)
    keep8 = sc8 >= 4
    keep_mb = torch.where(keep8, sc8, 0).sum((1, 2), dtype=_I32) >= 6
    keep = keep8 & keep_mb[:, None, None]
    keep_blk = keep.repeat_interleave(2, 1).repeat_interleave(2, 2)
    lev = lev * keep_blk[:, None, None, :, :]
    deq = T.dequant4x4(lev, qp)
    rec = T.idct4x4_add(to_blocks(pred, 4), deq)
    rec = rec.permute(0, 3, 1, 4, 2).reshape(n, 16, 16)
    return lev, rec


def cbp_luma_of(lev: torch.Tensor) -> torch.Tensor:
    n = lev.shape[0]
    nz_blk = (lev != 0).any(2).any(1)                        # [N,4,4]
    cbp8 = nz_blk.reshape(n, 2, 2, 2, 2).any(4).any(2)       # [N,2,2]
    return (cbp8[:, 0, 0].to(_I32) + 2 * cbp8[:, 0, 1].to(_I32)
            + 4 * cbp8[:, 1, 0].to(_I32) + 8 * cbp8[:, 1, 1].to(_I32))


def chroma_encode(curc, predc, qpc: int, fz):
    """Inter chroma encode of one plane's [N,8,8] MBs. Returns (dc_lev
    [N,2,2], ac_lev [N,4,4,2,2], recon [N,8,8])."""
    n = curc.shape[0]
    coef = T.dct4x4(to_blocks(curc - predc, 4))
    dch = T.hadamard2x2(coef[:, 0, 0][..., None, None])[..., 0, 0]
    ac = coef.clone()
    ac[:, 0, 0] = 0
    dc_lev = T.quant_dc(dch, qpc, intra=False)
    ac_lev = T.quant4x4(ac, qpc, intra=False)
    scc = decimate_score(_zigzag_gather(ac_lev)).sum((1, 2), dtype=_I32)
    ac_lev = ac_lev * (scc >= 7)[:, None, None, None, None]
    dc_lev = dc_lev * ~fz[:, None, None]
    ac_lev = ac_lev * ~fz[:, None, None, None, None]
    deqc = T.dequant4x4(ac_lev, qpc)
    dc_rec = T.hadamard2x2(dc_lev[..., None, None])[..., 0, 0]
    deqc[:, 0, 0] = T.dequant_dc_chroma(dc_rec, qpc)
    rc = T.idct4x4_add(to_blocks(predc, 4), deqc)
    return dc_lev, ac_lev, rc.permute(0, 3, 1, 4, 2).reshape(n, 8, 8)


def cbp_chroma_of(chroma) -> torch.Tensor:
    ac_nz = (chroma[0][1] != 0).flatten(1).any(1) \
        | (chroma[1][1] != 0).flatten(1).any(1)
    dc_nz = (chroma[0][0] != 0).flatten(1).any(1) \
        | (chroma[1][0] != 0).flatten(1).any(1)
    return torch.where(ac_nz, 2, torch.where(dc_nz, 1, 0)).to(_I32)


def pack_chroma(chroma, n: int):
    """(chroma_dc [n,8], chroma_ac [n,128]) int16 as the reference packs
    them: (uv, by, bx) and (uv, by, bx, r, c)."""
    dc = torch.stack([chroma[0][0], chroma[1][0]], dim=1).reshape(n, 8)
    ac = torch.stack([chroma[0][1].movedim((1, 2), (3, 4)),
                      chroma[1][1].movedim((1, 2), (3, 4))], dim=1) \
        .reshape(n, 128)
    return dc.to(torch.int16), ac.to(torch.int16)


def assemble_pred_luma(ref_luma, mv8, mbh: int, mbw: int):
    """Per-8x8-block MC -> [n,16,16] MB predictions (mv8 [2mbh,2mbw,2]
    qpel)."""
    n8 = 4 * mbh * mbw
    ar = torch.arange(n8, device=mv8.device, dtype=_I32)
    ys8 = torch.div(ar, 2 * mbw, rounding_mode="floor") * 8
    xs8 = (ar % (2 * mbw)) * 8
    p8 = mc.mc_luma(ref_luma, ys8, xs8, mv8.reshape(n8, 2), 8, 8)
    pred = p8.reshape(2 * mbh, 2 * mbw, 8, 8).permute(0, 2, 1, 3) \
        .reshape(16 * mbh, 16 * mbw)
    return mb_tiles(pred, 16)


def encode_p_frame_device8(y, u, v, ref_luma, ref_u, ref_v, mv8,
                           qp: int, qpc: int, mbh: int, mbw: int,
                           force_zero=None) -> dict:
    """Partitioned P encode at per-8x8 MVs ([2mbh,2mbw,2] qpel)."""
    n = mbh * mbw
    dev = y.device
    fz = (torch.zeros(n, dtype=torch.bool, device=dev)
          if force_zero is None else force_zero.reshape(n).to(torch.bool))

    cur = mb_tiles(y, 16)
    pred = assemble_pred_luma(ref_luma, mv8, mbh, mbw)
    lev, rec = luma_p_encode(cur, pred, qp)
    lev = lev * ~fz[:, None, None, None, None]
    rec = torch.where(fz[:, None, None], pred, rec)
    cbp_luma = cbp_luma_of(lev)

    n8 = 4 * mbh * mbw
    ar = torch.arange(n8, device=dev, dtype=_I32)
    ysc = torch.div(ar, 2 * mbw, rounding_mode="floor") * 4
    xsc = (ar % (2 * mbw)) * 4
    mvf8 = mv8.reshape(n8, 2)
    chroma = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        pc4 = mc.mc_chroma(refp, ysc, xsc, mvf8, 4, 4)
        predc = pc4.reshape(2 * mbh, 2 * mbw, 4, 4).permute(0, 2, 1, 3) \
            .reshape(8 * mbh, 8 * mbw)
        chroma.append(chroma_encode(mb_tiles(plane, 8), mb_tiles(predc, 8),
                                    qpc, fz))
    cbp_chroma = cbp_chroma_of(chroma)
    cdc, cac = pack_chroma(chroma, n)
    return dict(
        cbp_luma=cbp_luma.reshape(mbh, mbw).to(torch.uint8),
        cbp_chroma=cbp_chroma.reshape(mbh, mbw).to(torch.uint8),
        luma_lev=lev.movedim((1, 2), (3, 4)).reshape(mbh, mbw, 256)
        .to(torch.int16),
        chroma_dc=cdc.reshape(mbh, mbw, 8),
        chroma_ac=cac.reshape(mbh, mbw, 128),
        recon_y=untile(rec, mbh, mbw).to(torch.uint8),
        recon_u=untile(chroma[0][2], mbh, mbw).to(torch.uint8),
        recon_v=untile(chroma[1][2], mbh, mbw).to(torch.uint8))
