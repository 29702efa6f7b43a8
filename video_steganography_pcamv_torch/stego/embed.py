"""Stego engine, serving subset (port of stego/embed.py: `StegoEngine`
construction, `_next_message`, `embed_frame`, `embed_frame_parts` and
`apply_costs`).

`apply_costs` is the host half of the partition embedding: MVC cost
adjustment, cover assembly in coding order, STC (native library), flip
application and the forced rescan (with references on the
multi-reference path), all numpy. `embed_frame` is the 16x16-only path's
whole embedding: the RCA costs from the analysis tables on the device,
then the same host steps and the pass-2 re-encode (trellised when pass 1
was: the pass 2 mirrors pass 1's configuration, as in the reference). `embed_frame_parts`
is the multi-reference path's: `probe_combine` on the probe maps of the
analysis with the host scan's predictors, `apply_costs`, then the full
multi-reference pass-2 re-encode. `embed_frame_sub` and
`apply_costs_sub` are the sub-8x8 path's (the reference's stego/embed.py:
318-540): the cover spans every unit slot, 8x4/4x8/4x4 sub-units
included.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..encoder.partition import N_UNITS, UNIT_BLOCKS
from .stc import StcState, stc_feasible_k


# unit-start slots of MB partitions 0..2 (16x16 / 16x8 / 8x16) and, per
# sub_mb_type, within an 8x8 block; the extent (h4, w4) of a unit by
# partition, and by sub_mb_type
_PART_START = np.zeros((3, 16), bool)
_PART_START[0, 0] = True
_PART_START[1, [0, 8]] = True
_PART_START[2, [0, 4]] = True
_SUB_START = np.array([[1, 0, 0, 0], [1, 0, 1, 0], [1, 1, 0, 0],
                       [1, 1, 1, 1]], bool)
_PART_H4 = np.array([4, 2, 4], np.int64)
_PART_W4 = np.array([4, 4, 2], np.int64)
_SUB_H4 = np.array([2, 1, 2, 1], np.int64)
_SUB_W4 = np.array([2, 2, 1, 1], np.int64)
# (oy, ox) in 4x4 cells of each z slot's top-left cell
_SLOT_OY = np.array([2 * (s >> 3) + ((s >> 1) & 1) for s in range(16)])
_SLOT_OX = np.array([2 * ((s >> 2) & 1) + (s & 1) for s in range(16)])


def unit_start_mask(part, sub_type):
    """[mbh, mbw, 16] bool: the slots that start a coding unit (ascending
    slot order is the units' coding order)."""
    mbh, mbw = part.shape
    u = _PART_START[np.clip(part, 0, 2)].copy()
    is8 = part == 3
    u[is8] = _SUB_START[sub_type.astype(np.int64)].reshape(mbh, mbw, 16)[is8]
    return u


def unit_extents(part, sub_type):
    """(h4, w4) of every slot's unit [mbh, mbw, 16] (read at unit
    starts)."""
    mbh, mbw = part.shape
    pc = np.clip(part, 0, 2)
    h4 = np.repeat(_PART_H4[pc][..., None], 16, -1)
    w4 = np.repeat(_PART_W4[pc][..., None], 16, -1)
    is8 = part == 3
    st = sub_type.astype(np.int64)
    h4[is8] = np.repeat(_SUB_H4[st], 4, -1)[is8]
    w4[is8] = np.repeat(_SUB_W4[st], 4, -1)[is8]
    return h4, w4


def slot_unit_mvs(mv4, mbh: int, mbw: int):
    """[mbh, mbw, 16, 2]: the MV at each slot's top-left 4x4 cell."""
    ys = 4 * np.arange(mbh)[:, None, None] + _SLOT_OY[None, None, :]
    xs = 4 * np.arange(mbw)[None, :, None] + _SLOT_OX[None, None, :]
    return mv4[ys, xs]


class StegoEngine:
    def __init__(self, params):
        self.p = params
        self._rng = np.random.RandomState(
            params.stego.key & 0x7FFFFFFF or 0x5EED)
        self.sent_messages: list = []
        self._stc_state = StcState()

    def _next_message(self, an: int) -> np.ndarray:
        return self._rng.randint(0, 2, an).astype(np.uint8)

    def _message_len(self, n_cov: int) -> int:
        """Payload bits for a cover of n_cov MVs: em_rate bits (or that
        share of the cover), reduced to what the STC matrix can embed."""
        st = self.p.stego
        rate = st.em_rate
        an = min(int(rate) if rate > 1 else int(rate * n_cov), n_cov)
        return stc_feasible_k(n_cov, an, st.stc_h, self._stc_state)

    def _cover_size(self, enc, n_cov: int) -> int:
        enc.stats.mv_covers += n_cov
        return self._message_len(n_cov)

    def _embed(self, enc, cov, rho_cov, an: int) -> np.ndarray:
        """STC-embed the next message into the cover bits; returns the
        flip mask over the cover."""
        message = self._next_message(an)
        stego_bits, _cost = native.stc_embed(
            cov, message, rho_cov, h=self.p.stego.stc_h,
            state=self._stc_state)
        flips = (cov ^ stego_bits).astype(bool)
        self.sent_messages.append(message)
        enc.stats.message_bits += an
        enc.stats.mv_flips += int(flips.sum())
        return flips

    def embed_frame(self, enc, y, u, v, qp: int, mv, skip1, mvp1, tables):
        """16x16-only P frame: cover = LSB(mvx + mvy) of the coded MBs in
        raster order, RCA costs from the analysis tables (`blocks`,
        `wht`, `r_idx` on the device), STC, flipped MBs take their
        alternative MV, the forced rescan and the pass-2 re-encode with
        pass 1's skips forced (at the encoder's quant tables and its
        noise-reduction offsets as they stand after pass 1's update).
        mv/skip1/mvp1 are host arrays from pass 1. Returns (final_mv,
        skip, mvd, res2), or None when nothing is embedded this frame."""
        from ..encoder import inter as INTER
        from ..encoder.analyse2 import stego_costs_from_table
        from ..encoder.me import lambda_tab
        from ..ops.transform import chroma_qp
        from .cost import cost_mv_table
        p, st = self.p, self.p.stego
        mbh, mbw = p.mb_height, p.mb_width
        cover_mask = ~skip1
        n_cov = int(cover_mask.sum())
        an = self._cover_size(enc, n_cov)
        if an <= 0 or n_cov == 0:
            self.sent_messages.append(np.zeros(0, np.uint8))
            return None

        dev = enc.device
        rho, alt_mv, _flags = stego_costs_from_table(
            y, tables["blocks"], tables["wht"], tables["r_idx"],
            torch.as_tensor(mv).to(dev), torch.as_tensor(mvp1).to(dev),
            enc._cost_mv_dev(qp, lambda_tab(qp)), qp, mbh, mbw,
            tables=enc.qt)
        rho = rho.cpu().numpy()
        alt_mv = alt_mv.cpu().numpy()
        cov = ((mv[..., 0] + mv[..., 1]) & 1).astype(np.uint8)[cover_mask]
        rho_cov = st.alpha_loc * rho[cover_mask].astype(np.float64)
        flip_cov = self._embed(enc, cov, rho_cov, an)

        flip_full = np.zeros((mbh, mbw), bool)
        flip_full[cover_mask] = flip_cov
        mv2 = mv.copy()
        mv2[flip_full] = alt_mv[flip_full]
        final_mv, mvd2 = native.host_scan_p_forced(mv2, skip1)
        res2 = INTER.encode_p_frame_device(
            y, u, v, enc.ref["luma"], enc.ref["u"], enc.ref["v"],
            torch.as_tensor(final_mv).to(dev), qp,
            chroma_qp(qp, p.chroma_qp_offset), mbh, mbw,
            force_zero=torch.as_tensor(skip1).to(dev),
            trellis=bool(p.trellis), tables=enc.qt,
            nr_offset=enc.nr_offset())
        return final_mv, skip1, mvd2, res2

    def embed_frame_parts(self, enc, y, u, v, qp: int, part, mv8, skip1,
                          mvp_u, ref8, maps, refs, grids=None):
        """Partition embedding of an unfused P frame (the reference's
        `embed_frame_parts`, stego/embed.py:242): the RCA costs from the
        analysis' probe maps (`maps` = SK, SP, sc8 and the device
        part/mv8) against the host scan's unit predictors mvp_u
        [mbh,mbw,4,2], one pull of rho and alt, `apply_costs` (with ref8
        on the multi-reference path), and the pass-2 re-encode at the
        final MVs with pass 1's skips forced: multi-reference at `refs`
        (the stacked DPB) and ref8, or with both None at one reference
        (`enc.ref`, the 8x8 transform and `rd` as the Params say); the
        quant tables and noise-reduction offsets as for `embed_frame`.
        `grids` is the (qp, chroma qp) pass 1 quantized with, the frame's
        or under adaptive quantization its per-MB grids (None: the
        frame's), and pass 2 quantizes with it too; rho stays at the
        frame qp's lambda (the reference's embed.py:294-313).
        part/mv8/skip1/ref8 are host arrays. Returns (final_mv8, skip,
        mvd4, res2), or None when nothing is embedded this frame."""
        from ..encoder import inter as INTER
        from ..encoder.me import lambda_tab
        from ..encoder.partition import probe_combine
        from ..ops.transform import chroma_qp
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n_cov = int(((~skip1) * N_UNITS[part]).sum())
        if self._message_len(n_cov) <= 0 or n_cov == 0:
            enc.stats.mv_covers += n_cov
            self.sent_messages.append(np.zeros(0, np.uint8))
            return None
        dev = enc.device
        SK, SP, sc8, part_t, mv8_t = maps
        rho, alt, _valid = probe_combine(
            SK, SP, sc8, part_t, mv8_t, torch.as_tensor(mvp_u).to(dev),
            enc._cost_mv_dev(qp, lambda_tab(qp)), mbh, mbw)
        n = mbh * mbw
        packed = torch.cat([rho.reshape(-1).to(torch.float32),
                            alt.reshape(-1).to(torch.float32)]).cpu().numpy()
        rho_np = packed[:4 * n].reshape(mbh, mbw, 4)
        alt_np = packed[4 * n:].reshape(mbh, mbw, 4, 2).astype(np.int32)
        final8, skip1, mvd2 = self.apply_costs(enc, part, mv8, skip1, rho_np,
                                               alt_np, ref8=ref8)
        qp_enc, qpc_enc = grids if grids is not None else (
            qp, chroma_qp(qp, p.chroma_qp_offset))
        final8_t = torch.as_tensor(np.ascontiguousarray(final8)).to(dev)
        fz = torch.as_tensor(skip1).to(dev)
        if refs is None:
            res2 = INTER.encode_p_frame_device8(
                y, u, v, enc.ref["luma"], enc.ref["u"], enc.ref["v"],
                final8_t, qp_enc, qpc_enc, mbh, mbw, force_zero=fz,
                trans8=bool(p.transform_8x8), rd=bool(p.rd),
                trellis=bool(p.trellis), tables=enc.qt,
                nr_offset=enc.nr_offset())
        else:
            res2 = INTER.encode_p_frame_device8_mref(
                y, u, v, *refs, final8_t, torch.as_tensor(ref8).to(dev),
                qp_enc, qpc_enc, mbh, mbw, force_zero=fz,
                trellis=bool(p.trellis), tables=enc.qt,
                nr_offset=enc.nr_offset())
        return final8, skip1, mvd2, res2

    def apply_costs(self, enc, part, mv8, skip1, rho_u, alt_u, ref8=None):
        """MVC adjustment, cover assembly, STC, flips, forced rescan (with
        the per-8x8 references ref8 [2mbh, 2mbw] on the multi-reference
        path: flips change MVs, never references). Returns (final_mv8,
        skip, mvd4)."""
        p, st = self.p, self.p.stego
        mbh, mbw = p.mb_height, p.mb_width
        nu = N_UNITS[part]
        rho_u = rho_u.astype(np.float64).copy()
        covered = (~skip1) * nu
        n_cov = int(covered.sum())
        an = self._cover_size(enc, n_cov)
        if an <= 0 or n_cov == 0:
            self.sent_messages.append(np.zeros(0, np.uint8))
            f8, md, _ = native.scan_p_parts_forced(part, mv8, skip1,
                                                   ref8=ref8)
            return f8, skip1, md

        mvz = mv8.reshape(mbh, 2, mbw, 2, 2).transpose(0, 2, 1, 3, 4) \
            .reshape(mbh, mbw, 4, 2)
        unit_mv = np.zeros((mbh, mbw, 4, 2), np.int32)
        for pt, units in UNIT_BLOCKS.items():
            sel = part == pt
            for ui, blks in enumerate(units):
                unit_mv[sel, ui] = mvz[sel, blks[0]]

        c1, c2 = st.mvc_c1, st.mvc_c2
        coded = ~skip1
        pair = coded & ((part == 1) | (part == 2))
        d01 = np.abs(unit_mv[:, :, 0] - unit_mv[:, :, 1]).sum(-1)
        near = pair & (d01 < 2)
        rho_u[near, 0] *= c1
        rho_u[near, 1] *= c1
        quad = coded & (part == 3)
        cnt = np.zeros((mbh, mbw), np.int64)
        for a, b in ((0, 1), (1, 3), (3, 2), (2, 0)):
            for comp in range(2):
                cnt += (np.abs(unit_mv[:, :, a, comp].astype(np.int64)
                               - unit_mv[:, :, b, comp]) <= 1)
        rho_u[quad] *= (c2 * cnt[quad] + 1.0)[:, None]
        rho_u *= st.alpha_loc

        valid = coded[:, :, None] & (np.arange(4)[None, None, :]
                                     < nu[:, :, None])
        cov_idx = np.nonzero(valid.reshape(-1))[0]
        umv_f = unit_mv.reshape(-1, 2)[cov_idx]
        cov = ((umv_f[:, 0] + umv_f[:, 1]) & 1).astype(np.uint8)
        rho_cov = rho_u.reshape(-1)[cov_idx].astype(np.float64)

        flips = self._embed(enc, cov, rho_cov, an)

        mv8_2 = mv8.copy()
        for fi in cov_idx[flips]:
            my, rem = divmod(int(fi), mbw * 4)
            mx, ui = divmod(rem, 4)
            for b in UNIT_BLOCKS[int(part[my, mx])][ui]:
                mv8_2[2 * my + (b >> 1), 2 * mx + (b & 1)] = alt_u[my, mx, ui]
        final8, mvd2, _mvp2 = native.scan_p_parts_forced(part, mv8_2, skip1,
                                                         ref8=ref8)
        return final8, skip1, mvd2

    def embed_frame_sub(self, enc, y, u, v, qp: int, part, sub_type, mv4,
                        skip1, mvp16, tables4, ref8=None, refs=None,
                        grids=None):
        """Sub-8x8 embedding, the reference's `embed_frame_sub` (stego/
        embed.py:318): the cover is every coded unit's MV, sub-units
        included; each slot's predictor from the scan's coding-order
        mvp16 [mbh,mbw,16,2]; the RCA costs by `partition.
        stego_costs_sub` on the analysis tables `tables4` (blocks,
        wht, r_idx), one pull of rho and alt, `apply_costs_sub`, then the
        pass-2 re-encode at the final per-4x4 MVs with pass 1's skips
        forced: `inter.encode_p_frame_device4` on the stacked DPB `refs`
        with ref8 on the multi-reference path, else
        `inter.encode_p_frame_sub` (under the 8x8 transform its eligible
        MBs through the 8x8-capable encode). `grids` as for
        `embed_frame_parts`. Host arrays in and out. Returns (final_mv4,
        skip, mvd16, res2), or None when nothing is embedded."""
        from ..encoder import inter as INTER
        from ..encoder.me import lambda_tab
        from ..encoder.partition import stego_costs_sub
        from ..ops.transform import chroma_qp
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        U = unit_start_mask(part, sub_type)
        n_cov = int(((~skip1) * U.sum(-1)).sum())
        if self._message_len(n_cov) <= 0 or n_cov == 0:
            enc.stats.mv_covers += n_cov
            self.sent_messages.append(np.zeros(0, np.uint8))
            return None
        dev = enc.device
        # coding-order predictors -> slot-indexed (ascending slot order is
        # coding order: a unit's rank is the exclusive count of starts)
        rank = np.cumsum(U, axis=-1) - U
        mvp_s = np.where(U[..., None], np.take_along_axis(
            mvp16, np.minimum(rank, 15)[..., None].repeat(2, -1), axis=2),
            0).astype(np.int32)
        rho, alt, _valid = stego_costs_sub(
            y, tables4["blocks"], tables4["wht"], tables4["r_idx"], part,
            sub_type, torch.as_tensor(mv4).to(dev),
            torch.as_tensor(mvp_s).to(dev),
            enc._cost_mv_dev(qp, lambda_tab(qp)), qp, mbh, mbw,
            tables=enc.qt)
        n = mbh * mbw
        packed = torch.cat([rho.reshape(-1),
                            alt.reshape(-1).to(torch.float32)]).cpu().numpy()
        rho_np = packed[:16 * n].reshape(mbh, mbw, 16)
        alt_np = packed[16 * n:].reshape(mbh, mbw, 16, 2).astype(np.int32)
        final4, skip1, mvd2 = self.apply_costs_sub(
            enc, part, sub_type, mv4, skip1, rho_np, alt_np, ref8=ref8)
        qp_enc, qpc_enc = grids if grids is not None else (
            qp, chroma_qp(qp, p.chroma_qp_offset))
        final4_t = torch.as_tensor(np.ascontiguousarray(final4)).to(dev)
        fz = torch.as_tensor(skip1).to(dev)
        if refs is not None:
            ref4 = torch.as_tensor(np.repeat(np.repeat(ref8, 2, 0), 2, 1)
                                   .astype(np.int32)).to(dev)
            res2 = INTER.encode_p_frame_device4(
                y, u, v, *refs, final4_t, qp_enc, qpc_enc, mbh, mbw,
                ref4=ref4, force_zero=fz, trellis=bool(p.trellis),
                tables=enc.qt, nr_offset=enc.nr_offset())
        else:
            res2 = INTER.encode_p_frame_sub(
                y, u, v, enc.ref, final4_t, qp_enc, qpc_enc, mbh, mbw,
                elig=enc.trans8_elig(part, sub_type), force_zero=fz,
                rd=bool(p.rd), trellis=bool(p.trellis), tables=enc.qt,
                nr_offset=enc.nr_offset())
        return final4, skip1, mvd2, res2

    def apply_costs_sub(self, enc, part, sub_type, mv4, skip1, rho_s,
                        alt_s, ref8=None):
        """The host half of the sub-8x8 embedding, the reference's
        `apply_costs_sub` (stego/embed.py:420): the MVC adjustment (the
        pair rule on 16x8/8x16 and on 8x4/4x8 pairs, the quad cycle over
        the four 8x8 MVs of a P_8x8 MB and over each 4x4 quad), the cover
        in coding order, the STC, the flips and the forced rescan (with
        ref8 on the multi-reference path). Returns (final_mv4, skip,
        mvd16)."""
        from ..encoder import scan as SCAN
        p, st = self.p, self.p.stego
        mbh, mbw = p.mb_height, p.mb_width
        rho_s = rho_s.astype(np.float64).copy()
        U = unit_start_mask(part, sub_type)
        n_cov = int(((~skip1) * U.sum(-1)).sum())
        an = self._cover_size(enc, n_cov)
        if an <= 0 or n_cov == 0:
            self.sent_messages.append(np.zeros(0, np.uint8))
            f4, md, _ = SCAN.scan_p_frame_sub_forced(part, sub_type, mv4,
                                                     skip1, ref8=ref8)
            return f4, skip1, md

        c1, c2 = st.mvc_c1, st.mvc_c2
        umv = slot_unit_mvs(mv4, mbh, mbw).astype(np.int64)
        coded = ~skip1
        for pt, (a, b) in ((1, (0, 8)), (2, (0, 4))):
            near = coded & (part == pt) & (
                np.abs(umv[:, :, a] - umv[:, :, b]).sum(-1) < 2)
            rho_s[near, a] *= c1
            rho_s[near, b] *= c1
        cycle = ((0, 1), (1, 3), (3, 2), (2, 0))
        quad = coded & (part == 3)

        def cycle_count(m):
            """Close pairs, per component, around the quad m[..., 4, 2]."""
            return sum((np.abs(m[:, :, a, c] - m[:, :, b, c]) <= 1)
                       .astype(np.int64) for a, b in cycle for c in range(2))

        if quad.any():
            cnt = cycle_count(umv[:, :, ::4])
            rho_s[quad] *= (c2 * cnt[quad] + 1.0)[:, None]
            for blk in range(4):
                base = 4 * blk
                stb = sub_type[:, :, blk]
                for stv, other in ((1, 2), (2, 1)):
                    near = quad & (stb == stv) & (np.abs(
                        umv[:, :, base] - umv[:, :, base + other]).sum(-1)
                        < 2)
                    rho_s[near, base] *= c1
                    rho_s[near, base + other] *= c1
                sel4 = quad & (stb == 3)
                if sel4.any():
                    cnt4 = cycle_count(umv[:, :, base:base + 4])
                    rho_s[sel4, base:base + 4] *= \
                        (c2 * cnt4[sel4] + 1.0)[:, None]
        rho_s *= st.alpha_loc

        # the cover in coding order: raster MBs, ascending slots
        cov_idx = np.nonzero((coded[:, :, None] & U).reshape(-1))[0]
        umv_f = umv.reshape(-1, 2)[cov_idx]
        cov = ((umv_f[:, 0] + umv_f[:, 1]) & 1).astype(np.uint8)
        flips = self._embed(enc, cov, rho_s.reshape(-1)[cov_idx], an)

        mv4_2 = mv4.copy()
        h4u, w4u = unit_extents(part, sub_type)
        for fi in cov_idx[flips]:
            my, rem = divmod(int(fi), mbw * 16)
            mx, slot = divmod(rem, 16)
            oy, ox = 4 * my + int(_SLOT_OY[slot]), 4 * mx + int(_SLOT_OX[slot])
            mv4_2[oy:oy + int(h4u[my, mx, slot]),
                  ox:ox + int(w4u[my, mx, slot])] = alt_s[my, mx, slot]
        final4, mvd2, _mvp2 = SCAN.scan_p_frame_sub_forced(
            part, sub_type, mv4_2, skip1, ref8=ref8)
        return final4, skip1, mvd2
