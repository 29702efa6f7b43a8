"""P-frame partition analysis + fused stego stage 1 (port of the serving
subset of encoder/partition.py).

One exhaustive full-pel scan (kernel B1) gives every partition unit's
best MV; the partition decision is a 4-way argmin with the mb_type
header-bit terms. Per 8x8 block, a 16x16 window of the four hpel planes
around its full-pel MV yields all 169 qpel offsets in [-6, 6]^2 as
static slice-averages (`block_table8`), and SATD against any of them
uses the WHT-linearity trick. The analyse tail (tables, subpel, RCA
probe maps) is plain tensor code here, as in the reference off the TPU.

Block index convention per MB: 8x8 blocks b in {0: TL, 1: TR, 2: BL,
3: BR} (z-order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import mc
from ..ops import transform as T
from ..ops.blocks import from_blocks, to_blocks
from ..ops.fullpel import fullpel_parts
from ..stego.cost import D_MV, D_NB, rca_decide
from . import inter as INTER
from . import qpel_table as QT
from .me import mv_bits_table
from .scan_device import scan_p_device

_I32 = torch.int32

D_16x16, D_16x8, D_8x16, D_8x8 = 0, 1, 2, 3
_HDR_BITS = np.array([1, 3, 3, 9], np.int32)
UNIT_BLOCKS = {
    D_16x16: [(0, 1, 2, 3)],
    D_16x8: [(0, 1), (2, 3)],
    D_8x16: [(0, 2), (1, 3)],
    D_8x8: [(0,), (1,), (2,), (3,)],
}
N_UNITS = np.array([1, 2, 2, 4], np.int32)
BLOCK_UNIT = np.array([[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1],
                       [0, 1, 2, 3]], np.int32)
_SUBPEL_BITS = mv_bits_table(4 * 512)


def decide_partition(st: dict, mbh: int, mbw: int, lam: int = 1):
    """4-way partition decision from the full-pel unit costs plus header
    lambda terms. Returns (part [mbh,mbw] int32, mvfp8 [2mbh,2mbw,2])."""
    hdr = _HDR_BITS
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        st["c8"].sum(-1, dtype=_I32) + lam * int(hdr[3]),
    ])
    part = torch.argmin(tot, dim=0)
    mv_by_part = torch.stack([
        st["mv16"][:, :, None, :].expand(mbh, mbw, 4, 2),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])
    mv8 = torch.gather(mv_by_part, 0,
                       part[None, :, :, None, None].expand(1, mbh, mbw, 4, 2)
                       )[0]
    mvsp = mv8.reshape(mbh, mbw, 2, 2, 2).permute(0, 2, 1, 3, 4) \
        .reshape(2 * mbh, 2 * mbw, 2)
    return part.to(_I32), mvsp


def gather_windows8(planes, mvfp8, mbh: int, mbw: int):
    """Per-8x8-block [N8, 4, 16, 16] window at (block + mv - MARGIN)."""
    n8 = 4 * mbh * mbw
    dev = planes.device
    ar = torch.arange(n8, device=dev)
    bys = torch.div(ar, 2 * mbw, rounding_mode="floor") * 8
    bxs = (ar % (2 * mbw)) * 8
    mvf = mvfp8.reshape(n8, 2).long()
    ys = bys + mc.PAD - QT.MARGIN + mvf[:, 1]
    xs = bxs + mc.PAD - QT.MARGIN + mvf[:, 0]
    w16 = torch.arange(16, device=dev)
    yy = ys[:, None] + w16
    xx = xs[:, None] + w16
    return planes[:, yy[:, :, None], xx[:, None, :]].permute(1, 0, 2, 3)


def block_table8(windows):
    """[N8, 4, 16, 16] uint8 -> [169, N8, 8, 8] uint8: every qpel offset
    in [-6, 6]^2 as a static slice-average of two phase planes."""
    w16 = windows.to(torch.int16)
    outs = []
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = QT._phase_slices(oy, ox)
            a = w16[:, p1, y1:y1 + 8, x1:x1 + 8]
            b = w16[:, p2, y2:y2 + 8, x2:x2 + 8]
            outs.append(((a + b + 1) >> 1).to(torch.uint8))
    return torch.stack(outs)


def wht8_flat(blocks):
    """Per-8x8 WHT, [..., 8, 8] -> [..., 64] ordered (sub-block by, bx,
    then r, c)."""
    w = QT.wht16(blocks.to(_I32))                     # [..., 4,4,2,2]
    w = w.movedim((-4, -3), (-2, -1))                 # [..., 2,2,4,4]
    return w.reshape(*w.shape[:-4], 64)


def wht8_table(blocks8):
    """wht8_flat of the [169, N8, 8, 8] table as int16, in chunks of 13
    offsets (bounds the int32 intermediates)."""
    return torch.cat([wht8_flat(blocks8[k:k + 13]).to(torch.int16)
                      for k in range(0, blocks8.shape[0], 13)])


def satd_flat(wa, wb):
    """SATD between flat WHT tensors [..., 64]."""
    d = torch.abs(wa.to(_I32) - wb.to(_I32))
    per_sub = d.reshape(*d.shape[:-1], 4, 16).sum(-1, dtype=_I32) >> 1
    return per_sub.sum(-1, dtype=_I32)


def _mb_blocks8(y, mbh: int, mbw: int):
    return y.reshape(2 * mbh, 8, 2 * mbw, 8).permute(0, 2, 1, 3) \
        .reshape(4 * mbh * mbw, 8, 8)


def sp_to_z(a, mbh: int, mbw: int):
    """[2mbh, 2mbw, *rest] spatial 8x8-block grid -> [mbh, mbw, 4, *rest]
    with the z-order block axis."""
    rest = a.shape[2:]
    r = len(rest)
    return a.reshape(mbh, 2, mbw, 2, *rest) \
        .permute(0, 2, 1, 3, *range(4, 4 + r)).reshape(mbh, mbw, 4, *rest)


def z_to_sp(a, mbh: int, mbw: int):
    """[mbh, mbw, 4, *rest] -> [2mbh, 2mbw, *rest]."""
    rest = a.shape[3:]
    r = len(rest)
    return a.reshape(mbh, mbw, 2, 2, *rest) \
        .permute(0, 2, 1, 3, *range(4, 4 + r)) \
        .reshape(2 * mbh, 2 * mbw, *rest)


# subpel=2: the qpel offset box around each full-pel MV
_SUBPEL_OFFSETS = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]


def subpel_parts(cur_y, wht8, part, mvfp8, prev_mv, mbh: int, mbw: int,
                 lam: int = 1):
    """Subpel refinement (subpel=2) per partition unit from the qpel
    tables. Returns (mv8 [2mbh,2mbw,2] qpel, r_idx8 [N8] chosen table
    index)."""
    dev = cur_y.device
    n8 = 4 * mbh * mbw
    wcur = wht8_flat(_mb_blocks8(cur_y, mbh, mbw))
    mvf = mvfp8.reshape(n8, 2)
    bits_t = const(_SUBPEL_BITS, dev)
    off = 4 * 512
    pred8 = prev_mv.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .reshape(n8, 2)
    offsets = _SUBPEL_OFFSETS
    satds, mvcs = [], []
    for oy, ox in offsets:
        satds.append(satd_flat(wcur, wht8[QT.off_index(oy, ox)]))
        qx = 4 * mvf[:, 0] + ox
        qy = 4 * mvf[:, 1] + oy
        ix = torch.clamp(qx - pred8[:, 0], -off, off) + off
        iy = torch.clamp(qy - pred8[:, 1], -off, off) + off
        mvcs.append((bits_t[ix.long()] + bits_t[iy.long()]) * lam)
    K = len(offsets)

    def k_to_z(s):
        return s.reshape(K, mbh, 2, mbw, 2).permute(0, 1, 3, 2, 4) \
            .reshape(K, mbh, mbw, 4)

    satz = k_to_z(torch.stack(satds))
    mvcz = k_to_z(torch.stack(mvcs))
    sums = torch.stack([
        satz.sum(-1, keepdim=True, dtype=_I32).expand_as(satz),
        satz[..., [0, 0, 2, 2]] + satz[..., [1, 1, 3, 3]],
        satz[..., [0, 1, 0, 1]] + satz[..., [2, 3, 2, 3]],
        satz,
    ])                                          # [4, K, mbh, mbw, 4]
    idx = part.long()[None, None, :, :, None].expand(1, K, mbh, mbw, 4)
    cost = torch.gather(sums, 0, idx)[0] + mvcz
    sel = torch.argmin(cost, dim=0)
    offs = torch.as_tensor(np.array(offsets, np.int32), device=dev)
    oy_sel = offs[sel, 0]
    ox_sel = offs[sel, 1]
    mvz = sp_to_z(mvfp8, mbh, mbw)
    mvq = torch.stack([4 * mvz[..., 0] + ox_sel,
                       4 * mvz[..., 1] + oy_sel], dim=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)
    mv8 = z_to_sp(mvq, mbh, mbw)
    r_idx8 = z_to_sp(r_idx[..., None], mbh, mbw)[..., 0].reshape(n8)
    return mv8.to(_I32), r_idx8.to(_I32)


def _didx(dy: int, dx: int) -> int:
    return dy * 13 + dx


def _select_rows(table, idx):
    """out[n] = table[idx[n], n] for a [K, N, ...] table."""
    return table[idx.long(), torch.arange(table.shape[1],
                                          device=table.device)]


def probe_maps(cur_y, blocks8, wht8, r_idx8, qp: int, mbh: int, mbw: int):
    """Per-version probe SATD maps and decimate scores (the heavy half
    of the RCA probe stage). Returns (SK [13,9,n,4], SP [13,9,n,4],
    sc8 [13,n,4])."""
    n = mbh * mbw
    cur = INTER.mb_tiles(cur_y, 16)
    centers = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                          for c in range(12)]
    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]

    sel_whtz = {}
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            w = _select_rows(wht8, r_idx8 + _didx(dy, dx))     # [N8,64]
            sel_whtz[(dy, dx)] = sp_to_z(
                w.reshape(2 * mbh, 2 * mbw, 64), mbh, mbw).reshape(n, 4, 64)

    curz = cur.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n * 4, 8, 8)
    SK, SP, sc8 = [], [], []
    for cen in centers:
        b8 = _select_rows(blocks8, r_idx8 + _didx(*cen)).to(_I32)
        pv = sp_to_z(b8.reshape(2 * mbh, 2 * mbw, 8, 8), mbh, mbw) \
            .reshape(n * 4, 8, 8)
        lev = T.quant4x4(T.dct4x4(to_blocks(curz - pv, 4)), qp, intra=False)
        rec = T.idct4x4_add(to_blocks(pv, 4), T.dequant4x4(lev, qp))
        wk = wht8_flat(from_blocks(rec)).reshape(n, 4, 64)
        wp = wht8_flat(pv).reshape(n, 4, 64)
        sc = INTER.decimate_score(INTER._zigzag_gather(lev))
        sc8.append(sc.sum((1, 2), dtype=_I32).reshape(n, 4))
        sels = torch.stack([sel_whtz[(cen[0] + d0, cen[1] + d1)]
                            for d0, d1 in nb_d])              # [9,n,4,64]
        SK.append(satd_flat(wk[None], sels))
        SP.append(satd_flat(wp[None], sels))
    return torch.stack(SK), torch.stack(SP), torch.stack(sc8)


def probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv, mbh: int,
                  mbw: int):
    """Per-unit RCA selection from the probe maps (analyse.c:2391-2550).
    Returns (rho [mbh,mbw,4] f32, alt [mbh,mbw,4,2], valid)."""
    dev = SK.device
    n = mbh * mbw
    mvz = sp_to_z(mv8, mbh, mbw).reshape(n, 4, 2)
    block_unit = const(BLOCK_UNIT, dev)[part.reshape(n).long()]
    mvpz = mvp_u.reshape(n, 4, 2)
    ncm = cost_mv.shape[0]
    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]
    centers = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                          for c in range(12)]

    keep8 = [sc8[v] >= 4 for v in range(13)]
    keep_mb0 = torch.where(keep8[0], sc8[0], 0).sum(1, dtype=_I32) >= 6
    kept0 = keep8[0] & keep_mb0[:, None]
    P0 = torch.where(kept0[None], SK[0], SP[0])
    ar = torch.arange(n, device=dev)

    out_rho, out_alt, out_valid = [], [], []
    for u in range(4):
        mem = block_unit == u
        valid_u = mem.any(1)
        first = torch.argmax(mem.to(_I32), dim=1)
        mvu = mvz[ar, first]
        mvpu = mvpz[:, u]

        def mvcost(dq):
            ix = torch.abs(mvu[:, 0] + dq[1] - mvpu[:, 0])
            iy = torch.abs(mvu[:, 1] + dq[0] - mvpu[:, 1])
            return (cost_mv[torch.clamp(ix, max=ncm - 1).long()]
                    + cost_mv[torch.clamp(iy, max=ncm - 1).long()])

        def probes_from(per_blk, center):
            sat = (per_blk * mem[None]).sum(2, dtype=_I32)        # [9,n]
            mvc = torch.stack([mvcost((center[0] + d0, center[1] + d1))
                               for d0, d1 in nb_d])
            return (sat + mvc).T

        def per_blk_for(c):
            sc_sel = torch.where(mem, sc8[c + 1], sc8[0])
            k8_sel = torch.where(mem, keep8[c + 1], keep8[0])
            keep_mb = torch.where(k8_sel, sc_sel, 0).sum(1, dtype=_I32) >= 6
            kept = k8_sel & keep_mb[:, None]
            return torch.where(kept[None], SK[c + 1], SP[c + 1])

        nb0 = probes_from(P0, (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = nb0.min(1).values >= orig_cost
        cand_cost, cand_opt = [], []
        for c in range(12):
            nbc = probes_from(per_blk_for(c), centers[c + 1])
            cand_cost.append(nbc[:, 8])
            cand_opt.append(nbc.min(1).values >= nbc[:, 8])
        rho, sel_delta, _flags = rca_decide(
            nb0, orig_cost, orig_opt, torch.stack(cand_cost, 1),
            torch.stack(cand_opt, 1))
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(valid_u)
    rho = torch.stack(out_rho, 1).reshape(mbh, mbw, 4)
    alt = torch.stack(out_alt, 1).reshape(mbh, mbw, 4, 2)
    valid = torch.stack(out_valid, 1).reshape(mbh, mbw, 4)
    return rho, alt, valid


def stego_costs_parts(cur_y, blocks8, wht8, r_idx8, part, mv8, mvp_u,
                      cost_mv, qp: int, mbh: int, mbw: int):
    """probe_maps + probe_combine."""
    SK, SP, sc8 = probe_maps(cur_y, blocks8, wht8, r_idx8, qp, mbh, mbw)
    return probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv, mbh, mbw)


def analyse_p_frame_parts(y, ref_luma, prev_mv, rng: int, mbh: int,
                          mbw: int, lam: int):
    """Full-pel scan (B1, predictor prev_mv >> 2) -> partition decision
    -> per-8x8 windows -> qpel tables -> per-unit subpel.
    Returns (part, mv8 qpel, r_idx8, blocks8, wht8)."""
    st = fullpel_parts(y, ref_luma[0], (prev_mv >> 2).contiguous(), rng,
                       mbh, mbw, lam)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam)
    windows = gather_windows8(ref_luma.to(torch.uint8), mvfp8, mbh, mbw)
    blocks8 = block_table8(windows)
    wht8 = wht8_table(blocks8)
    mv8, r_idx8 = subpel_parts(y, wht8, part, mvfp8, prev_mv, mbh, mbw,
                               lam)
    return part, mv8, r_idx8, blocks8, wht8


def p_stage1_stego(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp: int,
                   qpc: int, lam: int, cost_mv, rng: int, mbh: int,
                   mbw: int, extra=None):
    """Fused P stage 1: analyse -> pass-1 encode -> device scan -> RCA
    stego costs. Returns (packed f32, res) with the reference's layout
      [part n | mv8 8n | cbp_l n | cbp_c n | skip n | alt 8n | rho 4n
       | extra]."""
    part, mv8, r_idx8, blocks8, wht8 = analyse_p_frame_parts(
        y, ref_luma, prev_mv, rng, mbh, mbw, lam)
    res = INTER.encode_p_frame_device8(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw)
    cbp_l = res["cbp_luma"].to(_I32)
    cbp_c = res["cbp_chroma"].to(_I32)
    skip, _mvd, mvp_u, _ = scan_p_device(part, mv8, cbp_l, cbp_c, mbh, mbw)
    rho, alt, _valid = stego_costs_parts(y, blocks8, wht8, r_idx8, part,
                                         mv8, mvp_u, cost_mv, qp, mbh, mbw)
    f32 = torch.float32
    pieces = [part, mv8, cbp_l, cbp_c, skip, alt, rho]
    if extra is not None:
        pieces.append(extra)
    packed = torch.cat([p.reshape(-1).to(f32) for p in pieces])
    return packed, res
