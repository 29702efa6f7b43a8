"""P-frame transform/quant/recon at given MVs (port of the serving
subset of encoder/inter.py): decimation on; trellis, 8x8 transform,
rd and noise reduction off; gather MC only.

Two encodes: `encode_p_frame_device8` at per-8x8 MVs (the partitioned
path, luma through the plain `luma_p_encode`) and
`encode_p_frame_device` at one MV per MB (the 16x16-only path, luma
through `luma_p_encode_fast`: kernel B8a -> decimation -> kernel B8b in
the reference's [16, L] layout)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import mc
from ..ops import transform as T
from ..ops import tq4 as TQ
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


def _mb_to_coef16(x):
    """[n,16,16] pixels -> [16 (pos 4r+c), n*16 (blocks, (n,by,bx)
    raster)], the layout of kernels B8a/B8b."""
    n = x.shape[0]
    return x.reshape(n, 4, 4, 4, 4).permute(2, 4, 0, 1, 3).reshape(16, n * 16)


def _coef16_to_lev(x, n: int):
    """[16, n*16] -> [n, 4(r), 4(c), 4(by), 4(bx)] (luma_p_encode's lev
    layout)."""
    return x.reshape(4, 4, n, 4, 4).permute(2, 0, 1, 3, 4)


def _coef16_to_mb(x, n: int):
    """[16, n*16] pixel rows -> [n, 16, 16]."""
    return x.reshape(4, 4, n, 4, 4).permute(2, 3, 0, 4, 1).reshape(n, 16, 16)


# zigzag scan position -> coef row (4*r + c) in the [16, L] layout
_ZIG_ROWS = np.array([4 * r + c for r, c in T.ZIGZAG_4x4], np.int64)


def _decimate_keep16(lev16, n: int):
    """JVT-B118 decimation mask [1, n*16] in the [16, L] layout: the
    per-4x4 score (static row permutation + cummax over 16 rows),
    grouped per 8x8 and per MB exactly like decimate_score."""
    dev = lev16.device
    a = torch.abs(lev16[const(_ZIG_ROWS, dev)])             # scan order
    anybig = (a > 1).any(0)
    nz = a > 0
    idx = torch.arange(16, device=dev, dtype=_I32)[:, None]
    marked = torch.where(nz, idx, -1)
    prev = torch.cummax(marked, dim=0).values
    prev_excl = torch.cat([torch.full_like(prev[:1], -1), prev[:-1]])
    run = idx - prev_excl - 1
    tab = const(_DS_TAB, dev)
    contrib = torch.where(nz, tab[torch.clamp(run, 0, 15).long()], 0)
    score = torch.where(anybig, 9, contrib.sum(0, dtype=_I32))  # [L]
    sc8 = score.reshape(n, 2, 2, 2, 2).sum((2, 4), dtype=_I32)  # [n,2,2]
    keep8 = sc8 >= 4
    keep_mb = torch.where(keep8, sc8, 0).sum((1, 2), dtype=_I32) >= 6
    keep = keep8 & keep_mb[:, None, None]
    keep_blk = keep.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return keep_blk.reshape(1, n * 16).to(_I32)


# per-qp [16] tables in (4r + c) order: quant mf, inter bias, dequant mf
_MF16 = [T.QUANT4_MF[q].reshape(16).copy() for q in range(52)]
_BIAS16 = [T.QUANT4_BIAS_INTER[q].reshape(16).copy() for q in range(52)]
_DMF16 = [T.DEQUANT4_MF[q].reshape(16).copy() for q in range(6)]


def luma_p_encode_fast(cur, pred, qp: int, decimate: bool = True):
    """The reference's bit-identical kernel twin of luma_p_encode: B8a
    (DCT + quant) and B8b (dequant + IDCT + recon) over [16, L] lanes,
    the decimation between them as plain row ops. cur/pred [N,16,16]
    int32 -> (lev [N,4,4,4,4], rec [N,16,16])."""
    n = cur.shape[0]
    dev = cur.device
    pred16 = _mb_to_coef16(pred)
    lev16 = TQ.dct_quant(_mb_to_coef16(cur), pred16, const(_MF16[qp], dev),
                         const(_BIAS16[qp], dev))
    if decimate:
        lev16 = lev16 * _decimate_keep16(lev16, n)
    rec16 = TQ.deq_idct(lev16, pred16, const(_DMF16[qp % 6], dev),
                        qp // 6 - 4)
    return _coef16_to_lev(lev16, n), _coef16_to_mb(rec16, n)


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


def _force_zero(force_zero, n: int, dev):
    if force_zero is None:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return force_zero.reshape(n).to(torch.bool)


def _p_result(lev, rec, pred, chroma, fz, mbh: int, mbw: int) -> dict:
    """The per-frame result dict of a P encode; MBs in `fz` keep no
    luma residual and reconstruct as their prediction."""
    n = mbh * mbw
    lev = lev * ~fz[:, None, None, None, None]
    rec = torch.where(fz[:, None, None], pred, rec)
    cdc, cac = pack_chroma(chroma, n)
    return dict(
        cbp_luma=cbp_luma_of(lev).reshape(mbh, mbw).to(torch.uint8),
        cbp_chroma=cbp_chroma_of(chroma).reshape(mbh, mbw).to(torch.uint8),
        luma_lev=lev.movedim((1, 2), (3, 4)).reshape(mbh, mbw, 256)
        .to(torch.int16),
        chroma_dc=cdc.reshape(mbh, mbw, 8),
        chroma_ac=cac.reshape(mbh, mbw, 128),
        recon_y=untile(rec, mbh, mbw).to(torch.uint8),
        recon_u=untile(chroma[0][2], mbh, mbw).to(torch.uint8),
        recon_v=untile(chroma[1][2], mbh, mbw).to(torch.uint8))


def encode_p_frame_device(y, u, v, ref_luma, ref_u, ref_v, mv, qp: int,
                          qpc: int, mbh: int, mbw: int,
                          force_zero=None) -> dict:
    """16x16 P encode at one qpel MV per MB (mv [mbh,mbw,2]); MBs in
    force_zero [mbh,mbw] drop their residual (the stego pass 2's forced
    P_SKIPs). Luma runs through kernels B8a/B8b on CUDA."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)
    ar = torch.arange(n, device=dev, dtype=_I32)
    ys = torch.div(ar, mbw, rounding_mode="floor") * 16
    xs = (ar % mbw) * 16
    mvf = mv.reshape(n, 2)
    pred = mc.mc_luma(ref_luma, ys, xs, mvf)
    lev, rec = luma_p_encode_fast(mb_tiles(y, 16), pred, qp)
    chroma = [chroma_encode(mb_tiles(plane, 8),
                            mc.mc_chroma(refp, ys // 2, xs // 2, mvf),
                            qpc, fz)
              for plane, refp in ((u, ref_u), (v, ref_v))]
    return _p_result(lev, rec, pred, chroma, fz, mbh, mbw)


def encode_p_frame_device8(y, u, v, ref_luma, ref_u, ref_v, mv8,
                           qp: int, qpc: int, mbh: int, mbw: int,
                           force_zero=None) -> dict:
    """Partitioned P encode at per-8x8 MVs ([2mbh,2mbw,2] qpel)."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)

    cur = mb_tiles(y, 16)
    pred = assemble_pred_luma(ref_luma, mv8, mbh, mbw)
    lev, rec = luma_p_encode(cur, pred, qp)

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
    return _p_result(lev, rec, pred, chroma, fz, mbh, mbw)
