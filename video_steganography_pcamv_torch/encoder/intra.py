"""I-frame encoder on the knight wavefront (port of encoder/intra.py).

Every MB of wave d = mx + 2*my only depends on MBs of earlier waves
(left, top, top-left and the i4x4 top-right), so a wave is one batch.
The reference pads each wave to a fixed width and drops inactive lanes;
here a wave is exactly its active MBs, which gives the same values.
Scope of the port: i16x16 + i4x4 + chroma, with the High-profile i8x8,
the RD choice between the three and trellis quantization of the chosen
modes' levels (luma DC/AC, 4x4, 8x8 and chroma) as options (`i8x8`,
`rd`, `trellis`); the mode choices stay SATD (or RD) as in the
reference. Every quant and dequant takes the intra class of the
encoder's `ops.cqm.QuantTables` (its intra lists and deadzone).
`refine_p_intra` runs the same wavefront over an encoded P frame (the
intra compare of the stego-off P paths).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import predict as P
from ..ops import predict8 as P8
from ..ops import transform as T
from ..ops import transform8 as T8
from ..ops.blocks import to_blocks
from ..ops.rdcost import cavlc_block_bits, ue_len

_I32 = torch.int32
BIG = 1 << 30

LUMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
             (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
_SCAN_IDX = {pos: i for i, pos in enumerate(LUMA_SCAN)}
_UE_SIZE4 = np.array([1, 3, 3, 5], np.int32)


def wave_tables(mbw: int, mbh: int):
    """Knight-move wave membership (d = mx + 2*my): (mx, my, active)
    arrays of shape [n_waves, W], as in the reference."""
    n_waves = mbw + 2 * (mbh - 1)
    rows = [[] for _ in range(n_waves)]
    for my in range(mbh):
        for mx in range(mbw):
            rows[mx + 2 * my].append((mx, my))
    w = max(len(r) for r in rows)
    mx_t = np.zeros((n_waves, w), np.int32)
    my_t = np.zeros((n_waves, w), np.int32)
    act = np.zeros((n_waves, w), bool)
    for d, r in enumerate(rows):
        for lane, (x, y) in enumerate(r):
            mx_t[d, lane] = x
            my_t[d, lane] = y
            act[d, lane] = True
    return mx_t, my_t, act


_WAVES: dict = {}


def waves(mbw: int, mbh: int, device) -> list:
    """Per wave, the (my, mx) long tensors of its MBs on `device`."""
    key = (mbw, mbh, str(torch.device(device)))
    if key not in _WAVES:
        mx_t, my_t, act = wave_tables(mbw, mbh)
        out = []
        for d in range(mx_t.shape[0]):
            a = act[d]
            out.append((torch.as_tensor(my_t[d][a], device=device).long(),
                        torch.as_tensor(mx_t[d][a], device=device).long()))
        _WAVES[key] = out
    return _WAVES[key]


def _tile(img: torch.Tensor, n: int) -> torch.Tensor:
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).permute(0, 2, 1, 3)


def _untile(t: torch.Tensor) -> torch.Tensor:
    mh, mw, n, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(mh * n, mw * n)


def _take_mode(preds, mode):
    return preds[torch.arange(preds.shape[0], device=preds.device), mode]


def _i16_mb(enc, top, left, topleft, at, al, qp: int, lam: int,
            trellis: bool = False, tables=None):
    preds = P.predict_i16x16_all(top, left, topleft, at, al)
    satd = _satd_modes(enc, preds) + lam * const(_UE_SIZE4,
                                                 enc.device)[None, :]
    valid = torch.stack([at, al, torch.ones_like(at), at & al], dim=1)
    cost = torch.where(valid, satd, BIG)
    mode = torch.argmin(cost, dim=1)
    best_cost = cost.min(dim=1).values
    pred = _take_mode(preds, mode)

    coef = T.dct4x4(to_blocks(enc - pred, 4))
    dc = coef[:, 0, 0, :, :]
    dc_t = T.hadamard4x4(dc[..., None, None], final_shift=True)[..., 0, 0]
    ac = coef.clone()
    ac[:, 0, 0] = 0
    if trellis:
        from .inter import trellis_quant_luma_dc, trellis_quant_luma_ac
        dc_lev = trellis_quant_luma_dc(dc_t, qp, tables)
        ac_lev = trellis_quant_luma_ac(ac, qp, intra=True, tables=tables)
    else:
        dc_lev = T.quant_dc(dc_t, qp, intra=True, tables=tables)
        ac_lev = T.quant4x4(ac, qp, intra=True, tables=tables)
    cbp_luma = (ac_lev != 0).any(4).any(3).any(2).any(1)

    deq = T.dequant4x4(ac_lev, qp, intra=True, tables=tables)
    dc_rec = T.hadamard4x4(dc_lev[..., None, None])[..., 0, 0]
    deq[:, 0, 0] = T.dequant_dc_luma(dc_rec, qp, tables)
    recon = T.idct4x4_add(to_blocks(pred, 4), deq)
    recon = recon.permute(0, 3, 1, 4, 2).reshape(-1, 16, 16)
    return mode.to(_I32), dc_lev, ac_lev, cbp_luma, recon, best_cost


def _satd4(a, b):
    d = (a[:, None] - b)[..., None, None]
    return torch.abs(T.hadamard4x4(d)).sum((-4, -3, -2, -1),
                                           dtype=_I32) >> 1


def _i4_mb(enc, top20, left, topleft, at, al, atr, qp: int, lam: int,
           nb_left_modes, nb_top_modes, trellis: bool = False,
           tables=None):
    """Batched i4x4 encode: the 16-block z-scan chain per MB."""
    dev = enc.device
    W = enc.shape[0]
    ones = torch.ones(W, dtype=torch.bool, device=dev)
    wt = torch.zeros((W, 16, 16), dtype=_I32, device=dev)
    m4 = torch.full((W, 4, 4), 2, dtype=_I32, device=dev)
    lev_out = torch.zeros((W, 4, 4, 4, 4), dtype=_I32, device=dev)
    modes_out = []
    cost = torch.zeros(W, dtype=_I32, device=dev)
    modebits = torch.zeros(W, dtype=_I32, device=dev)
    needs_t = const(P.I4_NEEDS_TOP, dev)
    needs_l = const(P.I4_NEEDS_LEFT, dev)
    nine = torch.arange(9, device=dev)

    for by, bx in LUMA_SCAN:
        if by == 0:
            t8 = top20[:, 4 * bx:4 * bx + 8]
            t_av = at
            if bx == 3:
                rep = t8[:, 3:4].expand(W, 4)
                t8 = torch.where(atr[:, None], t8,
                                 torch.cat([t8[:, :4], rep], 1))
        else:
            row = wt[:, 4 * by - 1, :]
            t4 = row[:, 4 * bx:4 * bx + 4]
            tr_ok = (bx < 3
                     and _SCAN_IDX[(by - 1, bx + 1)] < _SCAN_IDX[(by, bx)])
            if tr_ok:
                t8 = row[:, 4 * bx:4 * bx + 8]
            else:
                t8 = torch.cat([t4, t4[:, 3:4].expand(W, 4)], 1)
            t_av = ones
        if bx == 0:
            l4 = left[:, 4 * by:4 * by + 4]
            l_av = al
        else:
            l4 = wt[:, 4 * by:4 * by + 4, 4 * bx - 1]
            l_av = ones
        if by == 0 and bx == 0:
            lt = topleft
        elif by == 0:
            lt = top20[:, 4 * bx - 1]
        elif bx == 0:
            lt = left[:, 4 * by - 1]
        else:
            lt = wt[:, 4 * by - 1, 4 * bx - 1]

        preds = P.predict_i4x4_all(t8, l4, lt, t_av, l_av)
        eblk = enc[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4]
        satd = _satd4(eblk, preds)

        mA = nb_left_modes[:, by] if bx == 0 else m4[:, by, bx - 1]
        mB = nb_top_modes[:, bx] if by == 0 else m4[:, by - 1, bx]
        av_a = al if bx == 0 else ones
        av_b = at if by == 0 else ones
        pm = torch.where(av_a & av_b, torch.minimum(mA, mB), 2)
        bits = torch.where(nine[None, :] == pm[:, None], 1, 4).to(_I32)
        valid = ~((needs_t[None, :] & ~t_av[:, None])
                  | (needs_l[None, :] & ~l_av[:, None]))
        mcost = torch.where(valid, satd + lam * bits, BIG)
        mode = torch.argmin(mcost, dim=1)
        cost = cost + mcost.min(dim=1).values
        modebits = modebits + torch.where(mode == pm, 1, 4).to(_I32)
        pred = _take_mode(preds, mode)

        coef = T.dct4x4((eblk - pred)[..., None, None])
        if trellis:
            from .inter import trellis_quant4x4_planes
            lev = trellis_quant4x4_planes(coef, qp, intra=True,
                                          tables=tables)
        else:
            lev = T.quant4x4(coef, qp, intra=True, tables=tables)
        deq = T.dequant4x4(lev, qp, intra=True, tables=tables)
        rec = T.idct4x4_add(pred[..., None, None], deq)[..., 0, 0]
        wt[:, 4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = rec
        m4[:, by, bx] = mode.to(_I32)
        lev_out[:, by, bx] = lev[..., 0, 0]
        modes_out.append(mode.to(_I32))

    cost = cost + 24 * lam
    nz = (lev_out != 0).any(4).any(3)                        # [W,4,4]
    cbp8 = nz.reshape(W, 2, 2, 2, 2).any(4).any(2)           # [W,2,2]
    cbp_luma = (cbp8[:, 0, 0].to(_I32) * 1 + cbp8[:, 0, 1] * 2
                + cbp8[:, 1, 0] * 4 + cbp8[:, 1, 1] * 8).to(_I32)
    return (torch.stack(modes_out, dim=1), lev_out, cbp_luma, wt, cost,
            modebits)


def _satd_modes(enc, preds):
    """[W, M] SATD of enc [W, b, b] against preds [W, M, b, b]."""
    d = to_blocks(enc[:, None] - preds, 4)
    return torch.abs(T.hadamard4x4(d)).sum((-4, -3, -2, -1),
                                           dtype=_I32) >> 1


_Z8 = ((0, 0), (0, 1), (1, 0), (1, 1))


def _i8_mb(enc, top24, left, topleft, at, al, atr, qp: int, lam: int,
           nb_left_modes, nb_top_modes, trellis: bool = False,
           tables=None):
    """Batched Intra_8x8 encode: the MB's four 8x8 blocks in z-order,
    each one's borders from the blocks before it (x264's i8x8 sweep +
    x264_mb_encode_i8x8). top24 [W, 24]: the above MB's row 15 and the
    above-right MB's first 8 samples. Returns (modes [W,4], lev
    [W,2,2,8,8], cbp_luma [W], recon [W,16,16], cost [W], ctx4 [W,4,4]
    (each mode replicated into its 2x2 cells, as x264 caches it),
    modebits [W])."""
    dev = enc.device
    W = enc.shape[0]
    ones = torch.ones(W, dtype=torch.bool, device=dev)
    wt = torch.zeros((W, 16, 16), dtype=_I32, device=dev)
    ctx4 = torch.full((W, 4, 4), 2, dtype=_I32, device=dev)
    lev_out = torch.zeros((W, 2, 2, 8, 8), dtype=_I32, device=dev)
    modes_out = []
    cost = torch.zeros(W, dtype=_I32, device=dev)
    modebits = torch.zeros(W, dtype=_I32, device=dev)
    needs_t = const(P8.I8_NEEDS_TOP, dev)
    needs_l = const(P8.I8_NEEDS_LEFT, dev)
    nine = torch.arange(9, device=dev)

    for by8, bx8 in _Z8:
        y0, x0 = 8 * by8, 8 * bx8
        if by8 == 0:
            t16 = top24[:, x0:x0 + 16]
            t_av = at
            have_tr = at if bx8 == 0 else atr
        else:
            row = wt[:, 7, :]
            if bx8 == 0:
                t16 = row[:, 0:16]
                have_tr = ones
            else:
                t16 = torch.cat([row[:, 8:16], row[:, 15:16].expand(W, 8)],
                                1)
                have_tr = ~ones
            t_av = ones
        if bx8 == 0:
            l8 = left[:, y0:y0 + 8]
            l_av = al
        else:
            l8 = wt[:, y0:y0 + 8, 7]
            l_av = ones
        if by8 == 0 and bx8 == 0:
            lt, have_lt = topleft, at & al
        elif by8 == 0:
            lt, have_lt = top24[:, 7], at
        elif bx8 == 0:
            lt, have_lt = left[:, 7], al
        else:
            lt, have_lt = wt[:, 7, 7], ones
        t16 = torch.where(have_tr[:, None], t16,
                          torch.cat([t16[:, :8], t16[:, 7:8].expand(W, 8)],
                                    1))

        edge = P8.filter_edges(lt, t16, l8, have_lt, have_tr)
        preds = P8.predict_i8x8_all(edge, t_av, l_av)        # [W,9,8,8]
        eblk = enc[:, y0:y0 + 8, x0:x0 + 8]
        satd = _satd_modes(eblk, preds)

        cy, cx = 2 * by8, 2 * bx8
        mA = nb_left_modes[:, cy] if bx8 == 0 else ctx4[:, cy, cx - 1]
        mB = nb_top_modes[:, cx] if by8 == 0 else ctx4[:, cy - 1, cx]
        av_a = al if bx8 == 0 else ones
        av_b = at if by8 == 0 else ones
        pm = torch.where(av_a & av_b, torch.minimum(mA, mB), 2)
        bits = torch.where(nine[None, :] == pm[:, None], 1, 4).to(_I32)
        valid = ~((needs_t[None, :] & ~t_av[:, None])
                  | (needs_l[None, :] & ~l_av[:, None]))
        mcost = torch.where(valid, satd + lam * bits, BIG)
        mode = torch.argmin(mcost, dim=1)
        cost = cost + mcost.min(dim=1).values
        modebits = modebits + torch.where(mode == pm, 1, 4).to(_I32)
        pred = _take_mode(preds, mode)

        coef = T8.dct8x8(eblk - pred)
        if trellis:
            from .inter import trellis_quant8x8
            lev = trellis_quant8x8(coef, qp, intra=True, tables=tables)
        else:
            lev = T8.quant8x8(coef, qp, intra=True, tables=tables)
        rec = T8.idct8x8_add(pred, T8.dequant8x8(lev, qp, intra=True,
                                                 tables=tables))
        wt[:, y0:y0 + 8, x0:x0 + 8] = rec
        ctx4[:, cy:cy + 2, cx:cx + 2] = mode.to(_I32)[:, None, None]
        lev_out[:, by8, bx8] = lev
        modes_out.append(mode.to(_I32))

    nz8 = (lev_out != 0).any(4).any(3).to(_I32)                 # [W,2,2]
    cbp_luma = (nz8[:, 0, 0] + 2 * nz8[:, 0, 1] + 4 * nz8[:, 1, 0]
                + 8 * nz8[:, 1, 1])
    return (torch.stack(modes_out, dim=1), lev_out, cbp_luma, wt, cost,
            ctx4, modebits)


def _rd_costs(enc, qp: int, mode16, dc_lev, ac_lev, cbpl16, rec16, lev4,
              mb4bits, rec4, cost4, lev8, mb8bits, rec8):
    """True-RD intra costs (x264_intra_rd): SSD + lambda2 * the exact
    CAVLC bits at nC 0 of each candidate's residual plus its mode bits.
    Returns (c16, c4, c8) [W] int32."""
    from .inter import LAMBDA2_TAB
    from ..ops.lumap import zigzag_gather
    dev = enc.device
    W = enc.shape[0]
    lam2 = (const(LAMBDA2_TAB, dev)[qp.long()]
            if isinstance(qp, torch.Tensor) else int(LAMBDA2_TAB[qp]))

    def rdc(rec, bits):
        d = rec - enc
        return (d * d).sum((1, 2), dtype=_I32) + ((lam2 * bits + 128) >> 8)

    def bits16(v):
        nc0 = torch.zeros(v.shape[0], dtype=_I32, device=dev)
        return cavlc_block_bits(v, nc0, max_coeff=v.shape[1]) \
            .reshape(W, -1).sum(1, dtype=_I32)

    zz = const(T.ZIGZAG_4x4, dev).long()
    bits_dc = cavlc_block_bits(dc_lev[:, zz[:, 0], zz[:, 1]],
                               torch.zeros(W, dtype=_I32, device=dev))
    vac = zigzag_gather(ac_lev)[:, 1:].permute(0, 2, 3, 1) \
        .reshape(W * 16, 15)
    c16 = cbpl16.to(_I32)
    b16 = (bits_dc + torch.where(cbpl16, bits16(vac), 0)
           + ue_len(1 + mode16 + 12 * c16))
    v4 = zigzag_gather(lev4.movedim((1, 2), (3, 4))).permute(0, 2, 3, 1) \
        .reshape(W * 16, 16)
    c4 = torch.where(cost4 < (1 << 29),
                     rdc(rec4, bits16(v4) + mb4bits + 1 + 6), BIG)
    v8 = T8.zigzag8(lev8).reshape(W, 2, 2, 16, 4).transpose(3, 4) \
        .reshape(W * 16, 16)
    c8 = rdc(rec8, bits16(v8) + mb8bits + 2 + 6)
    return rdc(rec16, b16), c4, c8


def _chroma_mb(enc_u, enc_v, tops, lefts, tl_u, tl_v, at, al, qpc: int,
               lam: int, trellis: bool = False, tables=None):
    """Batched chroma encode with a joint U+V mode decision."""
    (top_u, top_v), (left_u, left_v) = tops, lefts
    pu = P.predict_chroma_all(top_u, left_u, tl_u, at, al)
    pv = P.predict_chroma_all(top_v, left_v, tl_v, at, al)
    du = to_blocks(enc_u[:, None] - pu, 4)
    dv = to_blocks(enc_v[:, None] - pv, 4)
    axes = (-4, -3, -2, -1)
    satd = (torch.abs(T.hadamard4x4(du)).sum(axes, dtype=_I32)
            + torch.abs(T.hadamard4x4(dv)).sum(axes, dtype=_I32)) >> 1
    satd = satd + lam * const(_UE_SIZE4, enc_u.device)[None, :]
    valid = torch.stack([torch.ones_like(at), al, at, at & al], dim=1)
    mode = torch.argmin(torch.where(valid, satd, BIG), dim=1)

    def encode_plane(enc, preds):
        pred = _take_mode(preds, mode)
        coef = T.dct4x4(to_blocks(enc - pred, 4))             # [W,4,4,2,2]
        dc_t = T.hadamard2x2(coef[:, 0, 0][..., None, None])[..., 0, 0]
        ac = coef.clone()
        ac[:, 0, 0] = 0
        if trellis:
            from .inter import (trellis_quant_chroma_dc,
                                trellis_quant_chroma_ac)
            dc_lev = trellis_quant_chroma_dc(dc_t, qpc, intra=True,
                                             tables=tables)
            ac_lev = trellis_quant_chroma_ac(ac, qpc, intra=True,
                                             tables=tables)
        else:
            dc_lev = T.quant_dc(dc_t, qpc, intra=True,
                                tables=tables)                 # [W,2,2]
            ac_lev = T.quant4x4(ac, qpc, intra=True, tables=tables)
        deq = T.dequant4x4(ac_lev, qpc, intra=True, tables=tables)
        dc_rec = T.hadamard2x2(dc_lev[..., None, None])[..., 0, 0]
        deq[:, 0, 0] = T.dequant_dc_chroma(dc_rec, qpc, intra=True,
                                           tables=tables)
        recon = T.idct4x4_add(to_blocks(pred, 4), deq)
        recon = recon.permute(0, 3, 1, 4, 2).reshape(-1, 8, 8)
        return dc_lev, ac_lev, recon

    dcu, acu, ru = encode_plane(enc_u, pu)
    dcv, acv, rv = encode_plane(enc_v, pv)
    dc_lev = torch.stack([dcu, dcv], dim=1)                   # [W,2,2,2]
    ac_lev = torch.stack([acu, acv], dim=1)                   # [W,2,4,4,2,2]
    ac_nz = (ac_lev != 0).flatten(1).any(1)
    dc_nz = (dc_lev != 0).flatten(1).any(1)
    cbp_chroma = torch.where(ac_nz, 2, torch.where(dc_nz, 1, 0)).to(_I32)
    return mode.to(_I32), dc_lev, ac_lev, cbp_chroma, ru, rv


def _z_to_grid(m4_z):
    g = torch.empty((m4_z.shape[0], 4, 4), dtype=m4_z.dtype,
                    device=m4_z.device)
    for blk, (by, bx) in enumerate(LUMA_SCAN):
        g[:, by, bx] = m4_z[:, blk]
    return g


def encode_i_frame(y, u, v, qp, qpc, mbw: int, mbh: int,
                   lam: int = 0, i8x8: bool = False, rd: bool = False,
                   trellis: bool = False, tables=None) -> dict:
    """Encode one I frame. y: [16mbh, 16mbw] int32; u, v half size.
    Returns the reference's dict of per-MB decisions, levels and recon
    planes (i4x4 on; `i8x8` adds the Intra_8x8 candidate, `rd` chooses
    between the candidates by RD cost instead of SATD, `trellis`
    quantizes every candidate's levels by the intra trellis; every
    quant takes the intra class of `tables`, None: flat). qp/qpc are
    ints, or under adaptive quantization int32 [mbh, mbw] grids of
    per-MB qps (every quant, trellis and RD lambda2 of an MB at its own
    qp; the mode decisions' lambda stays `lam`)."""
    grid = isinstance(qp, torch.Tensor)
    dev = y.device
    ty, tu, tv = _tile(y, 16), _tile(u, 8), _tile(v, 8)

    def z(*shape, fill=0, dtype=_I32):
        return torch.full((mbh, mbw) + shape, fill, dtype=dtype, device=dev)

    st = dict(
        ry=z(16, 16), ru=z(8, 8), rv=z(8, 8), mode=z(), cmode=z(),
        mb_i4=z(dtype=torch.bool), i4_modes=z(16, fill=2),
        modes4=z(4, 4, fill=2), cbp_luma=z(), cbp_chroma=z(),
        luma_dc=z(4, 4), luma_ac=z(4, 4, 4, 4), chroma_dc=z(2, 2, 2),
        chroma_ac=z(2, 2, 2, 4, 4), mb_i8=z(dtype=torch.bool),
        i8_modes=z(4, fill=2),
        luma8_lev=z(2, 2, 8, 8, dtype=_I32 if i8x8 else torch.int8))

    for my, mx in waves(mbw, mbh, dev):
        at = my > 0
        al = mx > 0
        atr = at & (mx < mbw - 1)
        mxc = torch.clamp(mx - 1, min=0)
        myc = torch.clamp(my - 1, min=0)
        mxr = torch.clamp(mx + 1, max=mbw - 1)

        enc = ty[my, mx]
        qpw, qpcw = (qp[my, mx], qpc[my, mx]) if grid else (qp, qpc)
        top = st["ry"][myc, mx, 15, :]
        left = st["ry"][my, mxc, :, 15]
        tl = st["ry"][myc, mxc, 15, 15]
        mode16, dc_lev, ac_lev, cbpl16, rec16, cost16 = _i16_mb(
            enc, top, left, tl, at, al, qpw, lam, trellis, tables)

        nb_lm = st["modes4"][my, mxc, :, 3]
        nb_tm = st["modes4"][myc, mx, 3, :]
        top20 = torch.cat([top, st["ry"][myc, mxr, 15, 0:4]], dim=1)
        m4, lev4, cbpl4, rec4, cost4, mb4bits = _i4_mb(
            enc, top20, left, tl, at, al, atr, qpw, lam, nb_lm, nb_tm,
            trellis, tables)
        use4 = cost4 < cost16
        W = enc.shape[0]
        if i8x8:
            top24 = torch.cat([top, st["ry"][myc, mxr, 15, 0:8]], dim=1)
            m8, lev8, cbpl8, rec8, cost8, ctx8, mb8bits = _i8_mb(
                enc, top24, left, tl, at, al, atr, qpw, lam, nb_lm, nb_tm,
                trellis, tables)
            use8 = (cost8 < cost16) & (cost8 <= cost4)
            use4 = use4 & ~use8
        else:
            use8 = torch.zeros_like(use4)
            m8 = torch.full((W, 4), 2, dtype=_I32, device=dev)
            lev8 = torch.zeros((W, 2, 2, 8, 8), dtype=_I32, device=dev)
            cbpl8 = torch.zeros(W, dtype=_I32, device=dev)
            rec8 = rec16
            ctx8 = torch.full((W, 4, 4), 2, dtype=_I32, device=dev)
            mb8bits = torch.zeros(W, dtype=_I32, device=dev)
        if rd:
            c16r, c4r, c8r = _rd_costs(
                enc, qpw, mode16, dc_lev, ac_lev, cbpl16, rec16, lev4,
                mb4bits, rec4, cost4, lev8, mb8bits, rec8)
            if not i8x8:
                c8r = torch.full_like(c16r, BIG)
            use8 = (c8r < c16r) & (c8r <= c4r)
            use4 = (c4r < c16r) & ~use8

        u4 = use4[:, None, None]
        u8 = use8[:, None, None]
        rec = torch.where(u8, rec8, torch.where(u4, rec4, rec16))
        luma_ac = torch.where(use4[:, None, None, None, None], lev4,
                              ac_lev.movedim((1, 2), (3, 4)))
        luma_ac = torch.where(use8[:, None, None, None, None], 0, luma_ac)
        cbp_luma = torch.where(use8, cbpl8,
                               torch.where(use4, cbpl4, cbpl16.to(_I32) * 15))
        dc_out = torch.where(u4 | u8, torch.zeros_like(dc_lev), dc_lev)
        ctx4 = torch.where(u8, ctx8, torch.where(u4, _z_to_grid(m4), 2))

        cmode, cdc, cac, cbpc, ruu, rvv = _chroma_mb(
            tu[my, mx], tv[my, mx],
            (st["ru"][myc, mx, 7, :], st["rv"][myc, mx, 7, :]),
            (st["ru"][my, mxc, :, 7], st["rv"][my, mxc, :, 7]),
            st["ru"][myc, mxc, 7, 7], st["rv"][myc, mxc, 7, 7], at, al,
            qpcw, lam, trellis, tables)

        st["ry"][my, mx] = rec
        st["ru"][my, mx] = ruu
        st["rv"][my, mx] = rvv
        st["mode"][my, mx] = mode16
        st["cmode"][my, mx] = cmode
        st["mb_i4"][my, mx] = use4
        st["i4_modes"][my, mx] = m4
        st["mb_i8"][my, mx] = use8
        st["i8_modes"][my, mx] = m8
        st["luma8_lev"][my, mx] = lev8.to(st["luma8_lev"].dtype)
        st["modes4"][my, mx] = ctx4.to(_I32)
        st["cbp_luma"][my, mx] = cbp_luma
        st["cbp_chroma"][my, mx] = cbpc
        st["luma_dc"][my, mx] = dc_out
        st["luma_ac"][my, mx] = luma_ac
        st["chroma_dc"][my, mx] = cdc
        st["chroma_ac"][my, mx] = cac.movedim((2, 3), (4, 5))

    out = dict(st)
    out.pop("modes4")
    out["recon_y"] = _untile(out.pop("ry"))
    out["recon_u"] = _untile(out.pop("ru"))
    out["recon_v"] = _untile(out.pop("rv"))
    return out


def refine_p_intra(y, u, v, recon_y, recon_u, recon_v, inter_cost, qp: int,
                   qpc: int, mbw: int, mbh: int, lam: int = 0,
                   trellis: bool = False, tables=None) -> dict:
    """The intra-vs-inter compare of a P frame with stego off, the
    reference's `refine_p_intra` (encoder/intra.py:637-779; x264's final
    intra compare, analyse.c:2812-2825): the knight wavefront over the
    encoded inter frame, each wave's MBs evaluating i16x16, i4x4 and
    chroma against the true neighbour recon (inter recon, or the intra
    recon of an earlier switched MB). An MB becomes intra where its intra
    SATD cost is below `inter_cost` [mbh, mbw] (B3's per-MB cost), and
    its recon is committed. recon_* are the inter recon planes. Returns
    intra_kind [mbh, mbw] (0 inter, 1 i16x16, 2 i4x4), the decisions and
    levels of `encode_i_frame`'s dict (valid where intra_kind > 0, no
    i8x8) and the merged recon planes as uint8."""
    dev = y.device
    ty, tu, tv = _tile(y, 16), _tile(u, 8), _tile(v, 8)

    def z(*shape, fill=0):
        return torch.full((mbh, mbw) + shape, fill, dtype=_I32, device=dev)

    st = dict(
        ry=_tile(recon_y.to(_I32), 16).clone(),
        ru=_tile(recon_u.to(_I32), 8).clone(),
        rv=_tile(recon_v.to(_I32), 8).clone(),
        kind=z(), mode=z(), cmode=z(), i4_modes=z(16, fill=2),
        modes4=z(4, 4, fill=2), cbp_luma=z(), cbp_chroma=z(),
        luma_dc=z(4, 4), luma_ac=z(4, 4, 4, 4), chroma_dc=z(2, 2, 2),
        chroma_ac=z(2, 2, 2, 4, 4))

    for my, mx in waves(mbw, mbh, dev):
        at = my > 0
        al = mx > 0
        atr = at & (mx < mbw - 1)
        mxc = torch.clamp(mx - 1, min=0)
        myc = torch.clamp(my - 1, min=0)
        mxr = torch.clamp(mx + 1, max=mbw - 1)

        enc = ty[my, mx]
        inter_rec = st["ry"][my, mx]
        top = st["ry"][myc, mx, 15, :]
        left = st["ry"][my, mxc, :, 15]
        tl = st["ry"][myc, mxc, 15, 15]
        mode16, dc_lev, ac_lev, cbpl16, rec16, cost16 = _i16_mb(
            enc, top, left, tl, at, al, qp, lam, trellis, tables)
        top20 = torch.cat([top, st["ry"][myc, mxr, 15, 0:4]], dim=1)
        m4, lev4, cbpl4, rec4, cost4, _bits = _i4_mb(
            enc, top20, left, tl, at, al, atr, qp, lam,
            st["modes4"][my, mxc, :, 3], st["modes4"][myc, mx, 3, :],
            trellis, tables)
        use4 = cost4 < cost16
        use_intra = torch.minimum(cost4, cost16) < inter_cost[my, mx]

        rec_i = torch.where(use4[:, None, None], rec4, rec16)
        rec = torch.where(use_intra[:, None, None], rec_i, inter_rec)
        luma_ac = torch.where(use4[:, None, None, None, None], lev4,
                              ac_lev.movedim((1, 2), (3, 4)))
        cbp_luma = torch.where(use4, cbpl4, cbpl16.to(_I32) * 15)
        dc_out = torch.where(use4[:, None, None], torch.zeros_like(dc_lev),
                             dc_lev)
        ctx4 = torch.where((use_intra & use4)[:, None, None],
                           _z_to_grid(m4), 2)

        cmode, cdc, cac, cbpc, ruu, rvv = _chroma_mb(
            tu[my, mx], tv[my, mx],
            (st["ru"][myc, mx, 7, :], st["rv"][myc, mx, 7, :]),
            (st["ru"][my, mxc, :, 7], st["rv"][my, mxc, :, 7]),
            st["ru"][myc, mxc, 7, 7], st["rv"][myc, mxc, 7, 7], at, al,
            qpc, lam, trellis, tables)
        ui = use_intra[:, None, None]
        st["ru"][my, mx] = torch.where(ui, ruu, st["ru"][my, mx])
        st["rv"][my, mx] = torch.where(ui, rvv, st["rv"][my, mx])
        st["ry"][my, mx] = rec
        st["kind"][my, mx] = torch.where(
            use_intra, torch.where(use4, 2, 1), 0).to(_I32)
        st["mode"][my, mx] = mode16
        st["cmode"][my, mx] = cmode
        st["i4_modes"][my, mx] = m4
        st["modes4"][my, mx] = ctx4.to(_I32)
        st["cbp_luma"][my, mx] = cbp_luma
        st["cbp_chroma"][my, mx] = cbpc
        st["luma_dc"][my, mx] = dc_out
        st["luma_ac"][my, mx] = luma_ac
        st["chroma_dc"][my, mx] = cdc
        st["chroma_ac"][my, mx] = cac.movedim((2, 3), (4, 5))

    out = dict(st)
    out.pop("modes4")
    out["intra_kind"] = out.pop("kind")
    for k, key in (("recon_y", "ry"), ("recon_u", "ru"), ("recon_v", "rv")):
        out[k] = _untile(out.pop(key)).to(torch.uint8)
    return out
