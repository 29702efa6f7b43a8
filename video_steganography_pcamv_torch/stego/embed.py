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
multi-reference pass-2 re-encode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..encoder.partition import N_UNITS, UNIT_BLOCKS
from .stc import StcState, stc_feasible_k


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
