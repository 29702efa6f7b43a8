"""P-frame transform/quant/recon at given MVs (port of the serving
subset of encoder/inter.py): decimation on; the High-profile adaptive
8x8 transform and its RD decision, trellis quantization of the luma
(4x4 and the 8x8 candidate) and chroma levels, and noise reduction of
the 4x4 luma (`nr_offset`), as options; gather MC only. Every quant
takes the encoder's `ops.cqm.QuantTables` (`tables`, its inter class;
None: flat).

Two encodes: `encode_p_frame_device8` at per-8x8 MVs (the partitioned
path, with `trans8`/`rd` the 8x8-transform candidate and its choice per
MB) and `encode_p_frame_device` at one MV per MB (the 16x16-only path).
The 4x4 luma encode of both, and of the incremental re-encode and the
16x16 path's probe, is the fused kernel `ops/lumap.luma_p_encode`.
`luma_p_encode_fast` keeps the earlier chain (kernel B8a -> decimation
-> kernel B8b in the reference's [16, L] layout) as the fused kernel's
yardstick; no path calls it."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import mc
from ..ops import transform as T
from ..ops import transform8 as T8
from ..ops import trellis as TR
from ..ops import tq4 as TQ
from ..ops import lumap as LP
from ..ops.blocks import mb_tiles, to_blocks
from ..ops.lumap import decimate_score, zigzag_gather
from ..ops.pixel import sa8d_16x16
from ..ops.rdcost import cavlc_block_bits, se_len, ue_len

_I32 = torch.int32

# lambda2 = lambda^2 * 0.9 * 256 (x264_lambda2_tab); RD cost = ssd +
# (lambda2 * bits + 128) >> 8 (x264 rdo.c)
LAMBDA2_TAB = np.array([
    14, 18, 22, 28, 36, 45, 57, 72,
    91, 115, 145, 182, 230, 290, 365, 460,
    580, 731, 921, 1161, 1462, 1843, 2322, 2925,
    3686, 4644, 5851, 7372, 9289, 11703, 14745, 18578,
    23407, 29491, 37156, 46814, 58982, 74313, 93628, 117964,
    148626, 187257, 235929, 297252, 374514, 471859, 594505, 749029,
    943718, 1189010, 1498059, 1887436], np.int32)

def untile(t: torch.Tensor, mbh: int, mbw: int) -> torch.Tensor:
    b = t.shape[-1]
    return t.reshape(mbh, mbw, b, b).permute(0, 2, 1, 3) \
        .reshape(mbh * b, mbw * b)


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
    tab = const(LP.DS_TAB, dev)
    contrib = torch.where(nz, tab[torch.clamp(run, 0, 15).long()], 0)
    score = torch.where(anybig, 9, contrib.sum(0, dtype=_I32))  # [L]
    sc8 = score.reshape(n, 2, 2, 2, 2).sum((2, 4), dtype=_I32)  # [n,2,2]
    keep8 = sc8 >= 4
    keep_mb = torch.where(keep8, sc8, 0).sum((1, 2), dtype=_I32) >= 6
    keep = keep8 & keep_mb[:, None, None]
    keep_blk = keep.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return keep_blk.reshape(1, n * 16).to(_I32)


def luma_p_encode_fast(cur, pred, qp: int, decimate: bool = True):
    """The reference's bit-identical kernel twin of its luma_p_encode,
    as the fused kernel's yardstick: B8a (DCT + quant) and B8b (dequant
    + IDCT + recon) over [16, L] lanes, the decimation between them as
    plain row ops. cur/pred [N,16,16] int32 -> (lev [N,4,4,4,4], rec
    [N,16,16])."""
    n = cur.shape[0]
    dev = cur.device
    pred16 = _mb_to_coef16(pred)
    lev16 = TQ.dct_quant(_mb_to_coef16(cur), pred16, const(LP.MF16[qp], dev),
                         const(LP.BIAS16[qp], dev))
    if decimate:
        lev16 = lev16 * _decimate_keep16(lev16, n)
    rec16 = TQ.deq_idct(lev16, pred16, const(LP.DMF16[qp % 6], dev),
                        qp // 6 - 4)
    return _coef16_to_lev(lev16, n), _coef16_to_mb(rec16, n)


# zigzag scan position -> raster (r, c) of a 4x4 block, and its inverse
_IZIG4 = np.zeros((4, 4), np.int64)
_IZIG4[T.ZIGZAG_4x4[:, 0], T.ZIGZAG_4x4[:, 1]] = np.arange(16)


def _from_zig_planes(lev, n: int, by: int, bx: int):
    """[n * by * bx, 16] zigzag levels -> [n, 4, 4, by, bx] planes."""
    lev = lev.reshape(n, by, bx, 16).permute(0, 3, 1, 2)    # [n,16,by,bx]
    return lev[:, const(_IZIG4, lev.device)]


def rows_qp(qp, rows: int):
    """The trellis's per-row qp: an int as it is, a per-MB [N] tensor
    repeated over each MB's rows (rows / N of them, MB-major)."""
    if not isinstance(qp, torch.Tensor):
        return qp
    q = qp.reshape(-1)
    return q.repeat_interleave(rows // max(1, q.numel()))


def trellis_quant4x4_planes(coef, qp, intra: bool, tables=None):
    """Trellis-quantize [N,4,4,BY,BX] coefficient planes (the luma 4x4
    cat); levels in the same layout. qp an int or a per-MB [N] tensor."""
    n, _, _, by, bx = coef.shape
    v = zigzag_gather(coef).permute(0, 2, 3, 1).reshape(n * by * bx, 16)
    lev = TR.trellis_quant(v, rows_qp(qp, v.shape[0]), TR.CAT_LUMA_4x4,
                           intra, tables)
    return _from_zig_planes(lev, n, by, bx)


def trellis_quant8x8(coef8, qp, intra: bool, tables=None):
    """Trellis-quantize [..., 8, 8] coefficient blocks (the cat-5 8x8
    luma trellis: x264's quant_8x8_trellis); levels in the same
    layout."""
    zz8 = const(T8.ZIGZAG_8x8_FLAT, coef8.device)
    flat = coef8.reshape(-1, 64)
    lv = TR.trellis_quant(flat[:, zz8], rows_qp(qp, flat.shape[0]),
                          TR.CAT_LUMA_8x8, intra, tables)
    lev = torch.zeros_like(lv)
    lev[:, zz8] = lv
    return lev.reshape(coef8.shape)


def trellis_quant_chroma_dc(dch, qpc, intra: bool = False, tables=None):
    """Chroma-DC trellis (2x2 Hadamard domain, raster scan; rdo.c
    x264_quant_dc_trellis DCT_CHROMA_DC). dch: [N,2,2]."""
    n = dch.shape[0]
    lev = TR.trellis_quant(dch.reshape(n, 4), qpc, TR.CAT_CHROMA_DC, intra,
                           tables)
    return lev.reshape(n, 2, 2)


def trellis_quant_luma_dc(dct, qp, tables=None):
    """i16x16 luma-DC trellis (4x4 Hadamard domain, zigzag scan; rdo.c
    x264_quant_dc_trellis DCT_LUMA_DC, intra only). dct: [N,4,4]."""
    zz = const(T.ZIGZAG_4x4, dct.device).long()
    lev = TR.trellis_quant(dct[:, zz[:, 0], zz[:, 1]], qp, TR.CAT_LUMA_DC,
                           True, tables)
    return lev[:, const(_IZIG4, dct.device)]


def _trellis_ac_planes(ac, qp, cat: int, intra: bool, tables=None):
    n, _, _, by, bx = ac.shape
    v = zigzag_gather(ac)[:, 1:].permute(0, 2, 3, 1).reshape(n * by * bx, 15)
    lev = TR.trellis_quant(v, rows_qp(qp, v.shape[0]), cat, intra, tables)
    lev = torch.cat([torch.zeros_like(lev[:, :1]), lev], dim=1)
    return _from_zig_planes(lev, n, by, bx)


def trellis_quant_luma_ac(ac, qp, intra: bool = True, tables=None):
    """i16x16 luma-AC trellis (DCT_LUMA_AC cat, 15 coefs). ac:
    [N,4,4,BY,BX] coefficient planes with DC already zeroed."""
    return _trellis_ac_planes(ac, qp, TR.CAT_LUMA_AC, intra, tables)


def trellis_quant_chroma_ac(ac, qpc, intra: bool = False, tables=None):
    """Chroma-AC trellis (DCT_CHROMA_AC cat, 15 coefs). ac:
    [N,4,4,BY,BX] coefficient planes with DC already zeroed."""
    return _trellis_ac_planes(ac, qpc, TR.CAT_CHROMA_AC, intra, tables)


def trellis_luma_levels(y, pred, qp, tables=None, nr_offset=None):
    """The inter trellis's 4x4 levels [N, 4, 4, 4, 4] of a frame's MBs
    (y the plane, pred [N,16,16] of its MBs in raster order): the fused
    luma kernel's `levels` under trellis. With `nr_offset` the DCT
    coefficients are denoised before the trellis, where the reference
    puts it (encoder/inter.py:242-253), and the result is (levels, the
    denoise's [4, 4] sums)."""
    coef = T.dct4x4(to_blocks(mb_tiles(y, 16) - pred, 4))
    if nr_offset is None:
        return trellis_quant4x4_planes(coef, qp, intra=False,
                                       tables=tables).contiguous()
    nr_sum, coef = LP.denoise(coef, nr_offset)
    return trellis_quant4x4_planes(coef, qp, intra=False,
                                   tables=tables).contiguous(), nr_sum


def luma_encode(y, pred, qp, fz=None, trellis: bool = False,
                tables=None, nr_offset=None):
    """The 4x4 luma encode of a frame's MBs: the fused kernel (its
    noise-reduction instance with `nr_offset`), which with `trellis`
    starts from `trellis_luma_levels` (the reference's
    `luma_p_encode(..., trellis=True)`). Returns (lev, rec, cbp_luma),
    and with `nr_offset` also the denoise's [4, 4] sums."""
    if not trellis:
        return LP.luma_p_encode(y, pred, qp, fz=fz, tables=tables,
                                nr_offset=nr_offset)
    if nr_offset is None:
        levels = trellis_luma_levels(y, pred, qp, tables)
        return LP.luma_p_encode(y, pred, qp, fz=fz, levels=levels,
                                tables=tables)
    levels, nr_sum = trellis_luma_levels(y, pred, qp, tables, nr_offset)
    return LP.luma_p_encode(y, pred, qp, fz=fz, levels=levels,
                            tables=tables) + (nr_sum,)


def _luma_encode_nr(y, pred, qp, fz, trellis: bool, tables,
                    nr_offset):
    """`luma_encode` as (lev, rec, cbp_luma, nr_sum or None)."""
    out = luma_encode(y, pred, qp, fz, trellis, tables, nr_offset)
    return out if nr_offset is not None else out + (None,)


def chroma_encode(curc, predc, qpc, fz, trellis: bool = False,
                  tables=None):
    """Inter chroma encode of one plane's [N,8,8] MBs (`trellis`: the
    DC and AC levels by the inter trellis) with the inter class of
    `tables`. Returns (dc_lev [N,2,2], ac_lev [N,4,4,2,2], recon
    [N,8,8])."""
    n = curc.shape[0]
    coef = T.dct4x4(to_blocks(curc - predc, 4))
    dch = T.hadamard2x2(coef[:, 0, 0][..., None, None])[..., 0, 0]
    ac = coef.clone()
    ac[:, 0, 0] = 0
    if trellis:
        dc_lev = trellis_quant_chroma_dc(dch, qpc, tables=tables)
        ac_lev = trellis_quant_chroma_ac(ac, qpc, tables=tables)
    else:
        dc_lev = T.quant_dc(dch, qpc, intra=False, tables=tables)
        ac_lev = T.quant4x4(ac, qpc, intra=False, tables=tables)
    scc = decimate_score(zigzag_gather(ac_lev)).sum((1, 2), dtype=_I32)
    ac_lev = ac_lev * (scc >= 7)[:, None, None, None, None]
    dc_lev = dc_lev * ~fz[:, None, None]
    ac_lev = ac_lev * ~fz[:, None, None, None, None]
    deqc = T.dequant4x4(ac_lev, qpc, tables=tables)
    dc_rec = T.hadamard2x2(dc_lev[..., None, None])[..., 0, 0]
    deqc[:, 0, 0] = T.dequant_dc_chroma(dc_rec, qpc, tables=tables)
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


def _grain_origins(mbh: int, mbw: int, g: int, dev):
    """Top-left (y, x) [N] of every g x g block of a 16mbh x 16mbw plane,
    raster order."""
    k = 16 // g
    ar = torch.arange(k * k * mbh * mbw, device=dev, dtype=_I32)
    return (torch.div(ar, k * mbw, rounding_mode="floor") * g,
            (ar % (k * mbw)) * g)


def assemble_pred_luma(ref_luma, mv8, mbh: int, mbw: int, ref8=None,
                       g: int = 8):
    """Per-block MC -> [n,16,16] MB predictions: g 8 (mv8 [2mbh,2mbw,2]
    qpel) or 4 (the sub-8x8 path's per-4x4 [4mbh,4mbw,2]); with `ref8` (a
    map of the same grain) each block from its own entry of the stacked
    DPB ref_luma [R,4,Hp,Wp]."""
    ys, xs = _grain_origins(mbh, mbw, g, mv8.device)
    nb = ys.shape[0]
    if ref8 is None:
        pb = mc.mc_luma(ref_luma, ys, xs, mv8.reshape(nb, 2), g, g)
    else:
        pb = mc.mc_luma_multi(ref_luma, ref8.reshape(nb), ys, xs,
                              mv8.reshape(nb, 2), g, g)
    k = 16 // g
    pred = pb.reshape(k * mbh, k * mbw, g, g).permute(0, 2, 1, 3) \
        .reshape(16 * mbh, 16 * mbw)
    return mb_tiles(pred, 16)


def mb_qps(qp, qpc, n: int, dev):
    """The encodes' qp/qpc: ints as they are, per-MB grid tensors
    (adaptive quantization, [mbh, mbw] or [n]) as int32 [n] on `dev` (the
    reference reshapes them the same way, encoder/inter.py:441-445)."""
    if not isinstance(qp, torch.Tensor):
        return qp, qpc
    return tuple(q.to(dev, _I32).reshape(n).contiguous() for q in (qp, qpc))


def _force_zero(force_zero, n: int, dev):
    if force_zero is None:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return force_zero.reshape(n).to(torch.bool)


def _p_result(lev, rec, cbp_luma, chroma, mbh: int, mbw: int,
              nr_sum=None) -> dict:
    """The per-frame result dict of a P encode from its luma levels,
    recon and cbp (force-zero already applied) and its chroma (and the
    noise reduction's sums, as `nr_sum`)."""
    n = mbh * mbw
    cdc, cac = pack_chroma(chroma, n)
    extra = {} if nr_sum is None else {"nr_sum": nr_sum}
    return dict(extra,
        cbp_luma=cbp_luma.reshape(mbh, mbw).to(torch.uint8),
        cbp_chroma=cbp_chroma_of(chroma).reshape(mbh, mbw).to(torch.uint8),
        luma_lev=lev.movedim((1, 2), (3, 4)).reshape(mbh, mbw, 256)
        .to(torch.int16),
        chroma_dc=cdc.reshape(mbh, mbw, 8),
        chroma_ac=cac.reshape(mbh, mbw, 128),
        recon_y=untile(rec, mbh, mbw).to(torch.uint8),
        recon_u=untile(chroma[0][2], mbh, mbw).to(torch.uint8),
        recon_v=untile(chroma[1][2], mbh, mbw).to(torch.uint8))


def encode_p_frame_device(y, u, v, ref_luma, ref_u, ref_v, mv, qp,
                          qpc, mbh: int, mbw: int,
                          force_zero=None, trellis: bool = False,
                          tables=None, nr_offset=None) -> dict:
    """16x16 P encode at one qpel MV per MB (mv [mbh,mbw,2]); MBs in
    force_zero [mbh,mbw] drop their residual (the stego pass 2's forced
    P_SKIPs); `trellis` quantizes luma and chroma by the trellis;
    `nr_offset` denoises the 4x4 luma (the result then carries
    `nr_sum`)."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)
    qp, qpc = mb_qps(qp, qpc, n, dev)
    ar = torch.arange(n, device=dev, dtype=_I32)
    ys = torch.div(ar, mbw, rounding_mode="floor") * 16
    xs = (ar % mbw) * 16
    mvf = mv.reshape(n, 2)
    pred = mc.mc_luma(ref_luma, ys, xs, mvf)
    lev, rec, cbp_l, nr_sum = _luma_encode_nr(y, pred, qp, fz, trellis,
                                              tables, nr_offset)
    chroma = [chroma_encode(mb_tiles(plane, 8),
                            mc.mc_chroma(refp, ys // 2, xs // 2, mvf),
                            qpc, fz, trellis, tables)
              for plane, refp in ((u, ref_u), (v, ref_v))]
    return _p_result(lev, rec, cbp_l, chroma, mbh, mbw, nr_sum)


def _luma8_select(cur, pred, lev, rec, cbp_luma, fz, qp, rd: bool,
                  trellis: bool = False, tables=None):
    """The 8x8-transform candidate of every MB and the per-MB choice
    between it and the 4x4 encode (lev, rec, cbp_luma, after `fz`):
    x264's sa8d < satd rule (x264_mb_analyse_transform), or with `rd`
    SSD + lambda2 * CAVLC bits at nC 0 with strict < (the first minimum
    wins ties). The 8x8 levels are the deadzone quant's, or with
    `trellis` the cat-5 inter trellis's (x264's quant_8x8_trellis), and
    keep x264's decimation (per 8x8 >= 4, per MB >= 6 over the coded
    8x8s). Returns (lev, rec, cbp_luma, t8 [n] bool, lev8 [n,2,2,8,8])."""
    n = cur.shape[0]
    dev = cur.device
    d4 = to_blocks(cur - pred, 4)
    satd16 = torch.abs(T.hadamard4x4(d4)).sum((1, 2, 3, 4),
                                              dtype=_I32) >> 1
    t8 = (sa8d_16x16(cur, pred) < satd16) & ~fz

    blk8 = (cur - pred).reshape(n, 2, 8, 2, 8).transpose(2, 3)
    pred8 = pred.reshape(n, 2, 8, 2, 8).transpose(2, 3)
    coef8 = T8.dct8x8(blk8)
    lev8 = (trellis_quant8x8(coef8, qp, intra=False, tables=tables)
            if trellis else T8.quant8x8(coef8, qp, intra=False,
                                        tables=tables))
    nz8 = (lev8 != 0).any(4).any(3)                              # [n,2,2]
    sc8 = T8.decimate_score64(lev8)
    tot = torch.where(nz8, sc8, 0).sum((1, 2), dtype=_I32)
    keep8 = nz8 & (sc8 >= 4) & (tot >= 6)[:, None, None]
    lev8 = lev8 * keep8[:, :, :, None, None]
    rec8 = T8.idct8x8_add(pred8, T8.dequant8x8(lev8, qp, intra=False,
                                               tables=tables)) \
        .transpose(2, 3).reshape(n, 16, 16)
    k = keep8.to(_I32)
    cbp8 = k[:, 0, 0] + 2 * k[:, 0, 1] + 4 * k[:, 1, 0] + 8 * k[:, 1, 1]

    if rd:
        lam2 = (const(LAMBDA2_TAB, dev)[qp.long()]
                if isinstance(qp, torch.Tensor) else int(LAMBDA2_TAB[qp]))
        nc0 = torch.zeros(n * 16, dtype=_I32, device=dev)
        v4 = zigzag_gather(lev).permute(0, 2, 3, 1).reshape(n * 16, 16)
        bits4 = cavlc_block_bits(v4, nc0).reshape(n, 16).sum(1, dtype=_I32)
        sub = T8.zigzag8(lev8).reshape(n, 2, 2, 16, 4).transpose(3, 4) \
            .reshape(n * 16, 16)
        bits8 = cavlc_block_bits(sub, nc0).reshape(n, 16).sum(1, dtype=_I32)
        d4r, d8r = rec - cur, rec8 - cur
        cost4 = (d4r * d4r).sum((1, 2), dtype=_I32) \
            + ((lam2 * bits4 + 128) >> 8)
        cost8 = (d8r * d8r).sum((1, 2), dtype=_I32) \
            + ((lam2 * bits8 + 128) >> 8)
        t8 = (cost8 < cost4) & ~fz

    lev = lev * ~t8[:, None, None, None, None]
    lev8 = lev8 * t8[:, None, None, None, None]
    rec = torch.where(t8[:, None, None], rec8, rec)
    cbp_luma = torch.where(t8, cbp8, cbp_luma)
    return lev, rec, cbp_luma, t8, lev8


def encode_p_frame_device8(y, u, v, ref_luma, ref_u, ref_v, mv8,
                           qp, qpc, mbh: int, mbw: int,
                           force_zero=None, trans8: bool = False,
                           rd: bool = False, cbp_only: bool = False,
                           trellis: bool = False, tables=None,
                           nr_offset=None) -> dict:
    """Partitioned P encode at per-8x8 MVs ([2mbh,2mbw,2] qpel). With
    `trans8` each MB also tries the 8x8 transform (`rd`: by RD cost) and
    the result carries `trans8` [mbh,mbw] bool and `luma8_lev` [mbh,mbw,
    256] int16 ((by8, bx8, r, c) order). `cbp_only` returns just the
    cbp maps (the stego pass 1 when the pass 2 is a full re-encode).
    `trellis` quantizes every luma candidate and the chroma by the
    trellis; `nr_offset` denoises the 4x4 luma (the result, cbp_only's
    too, then carries `nr_sum`). qp/qpc are ints, or per-MB [mbh, mbw]
    grids under adaptive quantization (every encode here takes either)."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)
    qp, qpc = mb_qps(qp, qpc, n, dev)

    pred = assemble_pred_luma(ref_luma, mv8, mbh, mbw)
    lev, rec, cbp_l, nr_sum = _luma_encode_nr(y, pred, qp, fz, trellis,
                                              tables, nr_offset)
    if trans8:
        lev, rec, cbp_l, t8, lev8 = _luma8_select(
            mb_tiles(y, 16), pred, lev, rec, cbp_l, fz, qp, rd, trellis,
            tables)

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
                                    qpc, fz, trellis, tables))
    if cbp_only:
        return dict(
            {} if nr_sum is None else {"nr_sum": nr_sum},
            cbp_luma=cbp_l.reshape(mbh, mbw).to(torch.uint8),
            cbp_chroma=cbp_chroma_of(chroma).reshape(mbh, mbw)
            .to(torch.uint8))
    out = _p_result(lev, rec, cbp_l, chroma, mbh, mbw, nr_sum)
    if trans8:
        out["trans8"] = t8.reshape(mbh, mbw)
        out["luma8_lev"] = lev8.reshape(mbh, mbw, 256).to(torch.int16)
    return out


def encode_p_frame_device8_mref(y, u, v, refs_luma, refs_u, refs_v, mv8,
                                ref8, qp, qpc, mbh: int, mbw: int,
                                force_zero=None, trellis: bool = False,
                                tables=None, nr_offset=None) -> dict:
    """Multi-reference partitioned P encode, the reference's
    `encode_p_frame_device8_mref` (encoder/inter.py:642): refs_* the
    stacked DPB ([R,4,Hp,Wp] luma, [R,Hp,Wp] chroma), ref8 [2mbh,2mbw]
    each 8x8 block's L0 index, otherwise `encode_p_frame_device8`
    without the 8x8 transform (the 4x4 luma encode is the fused kernel,
    fed each block's prediction from its own reference)."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)
    qp, qpc = mb_qps(qp, qpc, n, dev)
    pred = assemble_pred_luma(refs_luma, mv8, mbh, mbw, ref8=ref8)
    lev, rec, cbp_l, nr_sum = _luma_encode_nr(y, pred, qp, fz, trellis,
                                              tables, nr_offset)
    n8 = 4 * mbh * mbw
    ar = torch.arange(n8, device=dev, dtype=_I32)
    ysc = torch.div(ar, 2 * mbw, rounding_mode="floor") * 4
    xsc = (ar % (2 * mbw)) * 4
    mvf8 = mv8.reshape(n8, 2)
    reff = ref8.reshape(n8)
    chroma = []
    for plane, refp in ((u, refs_u), (v, refs_v)):
        pc4 = mc.mc_chroma_multi(refp, reff, ysc, xsc, mvf8, 4, 4)
        predc = pc4.reshape(2 * mbh, 2 * mbw, 4, 4).permute(0, 2, 1, 3) \
            .reshape(8 * mbh, 8 * mbw)
        chroma.append(chroma_encode(mb_tiles(plane, 8), mb_tiles(predc, 8),
                                    qpc, fz, trellis, tables))
    return _p_result(lev, rec, cbp_l, chroma, mbh, mbw, nr_sum)


def encode_p_frame_device4(y, u, v, ref_luma, ref_u, ref_v, mv4, qp, qpc,
                           mbh: int, mbw: int, ref4=None, force_zero=None,
                           trellis: bool = False, tables=None,
                           nr_offset=None) -> dict:
    """The sub-8x8 P encode, the reference's `encode_p_frame_device4`
    (encoder/inter.py:905) and, with ref4 [4mbh,4mbw] and the stacked DPB
    in ref_*, its `encode_p_frame_device4_mref` (:834): per-4x4 luma MC
    (mv4 [4mbh,4mbw,2] qpel) into the fused luma kernel, chroma MC at
    2x2 grain, no 8x8 transform; otherwise `encode_p_frame_device8`."""
    n = mbh * mbw
    dev = y.device
    fz = _force_zero(force_zero, n, dev)
    qp, qpc = mb_qps(qp, qpc, n, dev)
    pred = assemble_pred_luma(ref_luma, mv4, mbh, mbw, ref8=ref4, g=4)
    lev, rec, cbp_l, nr_sum = _luma_encode_nr(y, pred, qp, fz, trellis,
                                              tables, nr_offset)
    ysc, xsc = _grain_origins(mbh, mbw, 4, dev)
    ysc, xsc = ysc // 2, xsc // 2
    n4 = ysc.shape[0]
    mvf4 = mv4.reshape(n4, 2)
    chroma = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        if ref4 is None:
            pc2 = mc.mc_chroma(refp, ysc, xsc, mvf4, 2, 2)
        else:
            pc2 = mc.mc_chroma_multi(refp, ref4.reshape(n4), ysc, xsc, mvf4,
                                     2, 2)
        predc = pc2.reshape(4 * mbh, 4 * mbw, 2, 2).permute(0, 2, 1, 3) \
            .reshape(8 * mbh, 8 * mbw)
        chroma.append(chroma_encode(mb_tiles(plane, 8), mb_tiles(predc, 8),
                                    qpc, fz, trellis, tables))
    return _p_result(lev, rec, cbp_l, chroma, mbh, mbw, nr_sum)


def merge_res_trans8(res4, res8, elig, mbh: int, mbw: int) -> dict:
    """The reference's `_merge_res_trans8` (encoder/core.py:200): on the
    MBs of `elig` [mbh,mbw] bool (every partition at least 8x8) the
    8x8-capable encode res8 whole, elsewhere the sub-8x8 encode res4
    (whose `nr_sum` the result keeps); trans8 and luma8_lev only on
    eligible MBs."""
    out = dict(res4)
    for k in ("luma_lev", "cbp_luma", "cbp_chroma", "chroma_dc",
              "chroma_ac"):
        mm = elig.reshape(mbh, mbw, *([1] * (res4[k].dim() - 2)))
        out[k] = torch.where(mm, res8[k], res4[k])
    for k, b in (("recon_y", 16), ("recon_u", 8), ("recon_v", 8)):
        mm = elig.repeat_interleave(b, 0).repeat_interleave(b, 1)
        out[k] = torch.where(mm, res8[k], res4[k])
    out["luma8_lev"] = res8["luma8_lev"] * elig[:, :, None]
    out["trans8"] = res8["trans8"] & elig
    return out


def encode_p_frame_sub(y, u, v, ref, mv4, qp, qpc, mbh: int, mbw: int,
                       elig=None, force_zero=None, rd: bool = False,
                       trellis: bool = False, tables=None,
                       nr_offset=None) -> dict:
    """A final sub-8x8 P encode at one reference (`ref` the reference
    dict): `encode_p_frame_device4`, and with `elig` [mbh,mbw] bool
    device (the 8x8 transform: the MBs with no partition under 8x8) the
    8x8-capable `encode_p_frame_device8` at their per-8x8 MVs merged in
    on them (`merge_res_trans8`), as the reference's `_encode_p_sub`
    (core.py:2592-2612) and its stego pass 2 do."""
    res = encode_p_frame_device4(y, u, v, ref["luma"], ref["u"], ref["v"],
                                 mv4, qp, qpc, mbh, mbw,
                                 force_zero=force_zero, trellis=trellis,
                                 tables=tables, nr_offset=nr_offset)
    if elig is None:
        return res
    res8 = encode_p_frame_device8(
        y, u, v, ref["luma"], ref["u"], ref["v"],
        mv4[::2, ::2].contiguous(), qp, qpc, mbh, mbw,
        force_zero=force_zero, trans8=True, rd=rd, trellis=trellis,
        tables=tables, nr_offset=nr_offset)
    return merge_res_trans8(res, res8, elig, mbh, mbw)


# ---------------------------------------------------------------------------
# The exact RD costs of the stego-off re-ranks (the reference's
# encoder/inter.py:1081-1173). The reference computes them in int32 (its
# int64 casts are int32 while x64 is off), so every product and sum here
# wraps at 32 bits as its do.
# ---------------------------------------------------------------------------

# partition units of each mb_type (16x16, 16x8, 8x16, 8x8)
_N_UNITS = np.array([1, 2, 2, 4], np.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(_I32)


def rd_total(ssd, bits, qp: int):
    """ssd + ((lambda2 * bits + 128) >> 8), each step wrapping at 32
    bits (x264_rd_cost_mb's form)."""
    lam2 = int(LAMBDA2_TAB[qp])
    scaled = _wrap32(_wrap32(lam2 * bits.to(torch.int64)).to(torch.int64)
                     + 128) >> 8
    return _wrap32(ssd.to(torch.int64) + scaled.to(torch.int64))


def _ssd_mb(y, u, v, recon_y, recon_u, recon_v, mbh: int, mbw: int):
    """Per-MB SSD [n] int32 of the luma 16x16 and both chroma 8x8."""
    tot = 0
    for a, b, k in ((recon_y, y, 16), (recon_u, u, 8), (recon_v, v, 8)):
        d = mb_tiles(a.to(_I32), k) - mb_tiles(b.to(_I32), k)
        tot = tot + (d * d).sum((1, 2), dtype=_I32)
    return tot


def rd_coded_cost(y, u, v, luma_lev, chroma_dc, chroma_ac, recon_y,
                  recon_u, recon_v, mvd, part, qp: int, mbh: int, mbw: int):
    """RD cost of a coded P configuration per MB [mbh, mbw] int32, the
    reference's `rd_coded_cost` (encoder/inter.py:1081-1135): SSD(recon,
    source) + lambda2 * (the exact CAVLC residual bits at nC 0 + the
    mb_type ue + every unit's mvd se bits). luma_lev [mbh,mbw,256]
    ((by, bx, r, c) order), chroma_dc [mbh,mbw,8], chroma_ac
    [mbh,mbw,128] as the encodes return them; mvd [mbh,mbw,4,2] and part
    [mbh,mbw] tensors (or host arrays) on any device."""
    n = mbh * mbw
    dev = y.device
    ssd = _ssd_mb(y, u, v, recon_y, recon_u, recon_v, mbh, mbw)
    zz = const(T.ZIGZAG_4x4, dev).long()
    blk = luma_lev.reshape(n * 16, 4, 4).to(_I32)
    nc0 = torch.zeros(n * 16, dtype=_I32, device=dev)
    bits = cavlc_block_bits(blk[:, zz[:, 0], zz[:, 1]], nc0) \
        .reshape(n, 16).sum(1, dtype=_I32)
    cdc = chroma_dc.reshape(n * 2, 4).to(_I32)
    bits = bits + cavlc_block_bits(
        cdc, torch.full((n * 2,), -1, dtype=_I32, device=dev),
        max_coeff=4).reshape(n, 2).sum(1, dtype=_I32)
    cac = chroma_ac.reshape(n * 8, 4, 4).to(_I32)
    caz = cac[:, zz[:, 0], zz[:, 1]][:, 1:]
    bits = bits + cavlc_block_bits(
        caz, torch.zeros(n * 8, dtype=_I32, device=dev),
        max_coeff=15).reshape(n, 8).sum(1, dtype=_I32)
    pt = torch.as_tensor(part).to(dev, _I32).reshape(n)
    nu = const(_N_UNITS, dev)[pt.long()]
    used = torch.arange(4, device=dev)[None, :] < nu[:, None]
    md = torch.as_tensor(mvd).to(dev, _I32).reshape(n, 4, 2)
    mvd_bits = torch.where(used, se_len(md[..., 0]) + se_len(md[..., 1]),
                           0).sum(1, dtype=_I32)
    cost = rd_total(ssd, bits + ue_len(pt) + mvd_bits, qp)
    return cost.reshape(mbh, mbw)


def rd_skip_eval(y, u, v, ref_luma, ref_u, ref_v, pskip_mv, luma_lev,
                 chroma_dc, chroma_ac, recon_y, recon_u, recon_v, mvd, part,
                 qp: int, mbh: int, mbw: int):
    """The P_SKIP RD probe of `rd` 2, the reference's `rd_skip_eval`
    (encoder/inter.py:1137-1173): per MB the coded configuration's
    `rd_coded_cost` and the cost of coding it as P_SKIP at pskip_mv
    [mbh,mbw,2] (its MC SSD + lambda2 * 1 bit). Returns (cost_coded,
    cost_skip) [mbh, mbw] int32."""
    n = mbh * mbw
    dev = y.device
    cost_coded = rd_coded_cost(y, u, v, luma_lev, chroma_dc, chroma_ac,
                               recon_y, recon_u, recon_v, mvd, part, qp,
                               mbh, mbw)
    ar = torch.arange(n, device=dev, dtype=_I32)
    ys = torch.div(ar, mbw, rounding_mode="floor") * 16
    xs = (ar % mbw) * 16
    mvf = torch.as_tensor(pskip_mv).to(dev, _I32).reshape(n, 2)
    d = mc.mc_luma(ref_luma, ys, xs, mvf, 16, 16) - mb_tiles(y, 16)
    ssd = (d * d).sum((1, 2), dtype=_I32)
    for plane, refp in ((u, ref_u), (v, ref_v)):
        d = mc.mc_chroma(refp, ys // 2, xs // 2, mvf, 8, 8) \
            - mb_tiles(plane, 8)
        ssd = ssd + (d * d).sum((1, 2), dtype=_I32)
    cost_skip = rd_total(ssd, torch.ones_like(ssd), qp)
    return cost_coded, cost_skip.reshape(mbh, mbw)
