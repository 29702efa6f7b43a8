"""Stego engine, serving subset (port of stego/embed.py: `StegoEngine`
construction, `_next_message` and `apply_costs`).

Host half of the partition embedding: MVC cost adjustment, cover
assembly in coding order, STC (native library), flip application and
the forced rescan. Pure numpy; the STC and the forced scan run in the
port's native library.
"""

from __future__ import annotations

import numpy as np

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

    def apply_costs(self, enc, part, mv8, skip1, rho_u, alt_u):
        """MVC adjustment, cover assembly, STC, flips, forced rescan.
        Returns (final_mv8, skip, mvd4)."""
        p, st = self.p, self.p.stego
        mbh, mbw = p.mb_height, p.mb_width
        nu = N_UNITS[part]
        rho_u = rho_u.astype(np.float64).copy()
        covered = (~skip1) * nu
        n_cov = int(covered.sum())
        rate = st.em_rate
        an = int(rate) if rate > 1 else int(rate * n_cov)
        an = min(an, n_cov)
        an = stc_feasible_k(n_cov, an, st.stc_h, self._stc_state)
        enc.stats.mv_covers += n_cov
        if an <= 0 or n_cov == 0:
            self.sent_messages.append(np.zeros(0, np.uint8))
            f8, md, _ = native.scan_p_parts_forced(part, mv8, skip1)
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

        message = self._next_message(an)
        stego_bits, _cost = native.stc_embed(
            cov, message, rho_cov, h=st.stc_h, state=self._stc_state)
        flips = (cov ^ stego_bits).astype(bool)
        self.sent_messages.append(message)
        enc.stats.message_bits += an
        enc.stats.mv_flips += int(flips.sum())

        mv8_2 = mv8.copy()
        for fi in cov_idx[flips]:
            my, rem = divmod(int(fi), mbw * 4)
            mx, ui = divmod(rem, 4)
            for b in UNIT_BLOCKS[int(part[my, mx])][ui]:
                mv8_2[2 * my + (b >> 1), 2 * mx + (b & 1)] = alt_u[my, mx, ui]
        final8, mvd2, _mvp2 = native.scan_p_parts_forced(part, mv8_2, skip1)
        return final8, skip1, mvd2
