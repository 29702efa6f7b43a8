"""Exact CAVLC residual bit counts for the RD decisions (port of
ops/rdcost.py): coeff_token, trailing-one signs, the level-suffix chain,
total_zeros and run_before of every block, batched; the tables are the
bit lengths of the port's `encoder/vlc_tables.py`.

Callers approximate the nC context as 0, as the reference does."""

from __future__ import annotations

import numpy as np
import torch

from . import const
from ..encoder import vlc_tables as VT

_I32 = torch.int32


def _len_tab2(rows, row_len):
    out = np.zeros((len(rows), row_len), np.int32)
    for i, row in enumerate(rows):
        for j, code in enumerate(row):
            out[i, j] = len(code) if code else 0
    return out


LEN_COEFF0 = np.array([len(c) for c in VT.COEFF0], np.int32)
LEN_COEFF_TOKEN = _len_tab2(VT.COEFF_TOKEN, 64)
LEN_TOTAL_ZEROS = _len_tab2(VT.TOTAL_ZEROS, 16)
LEN_TOTAL_ZEROS_DC = _len_tab2(VT.TOTAL_ZEROS_DC, 4)
LEN_RUN_BEFORE = _len_tab2(VT.RUN_BEFORE, 15)


def _level_bits(code, sl):
    """Bit length of one level code at suffix length sl; codes beyond
    the prefix-15 escape are costed at the prefix-16 size."""
    b0 = torch.where(code < 14, code + 1,
                     torch.where(code < 30, 19, 16 + 12))
    b1 = torch.where(code < (15 << sl), (code >> sl) + 1 + sl, 16 + 12)
    return torch.where(sl == 0, b0, b1)


def cavlc_block_bits(lev_zz: torch.Tensor, nc: torch.Tensor,
                     max_coeff: int = 16) -> torch.Tensor:
    """Exact CAVLC bits per block: lev_zz [N, max_coeff] levels in scan
    order, nc [N] the neighbour context (-1 for chroma DC). [N] int32."""
    dev = lev_zz.device
    lev = lev_zz.to(_I32)
    n, mc = lev.shape
    nz = lev != 0
    total = nz.sum(1, dtype=_I32)
    pos = torch.arange(mc, device=dev, dtype=_I32)
    last = torch.where(nz, pos[None, :], -1).max(1).values
    tz = last + 1 - total

    # trailing ones: capped at 3, zeros between them do not break the run
    rev = lev.flip(1)
    nzr = (rev != 0).to(_I32)
    bad = nzr * (torch.abs(rev) != 1).to(_I32)
    seen_bad = torch.cumsum(bad, 1, dtype=_I32) - bad
    rank = torch.cumsum(nzr, 1, dtype=_I32) - nzr
    is_t1 = (nzr > 0) & (torch.abs(rev) == 1) & (seen_bad == 0) & (rank < 3)
    t1s = torch.clamp(is_t1.sum(1, dtype=_I32), max=3)

    tab = torch.where(nc < 0, 4, torch.where(
        nc < 2, 0, torch.where(nc < 4, 1, torch.where(nc < 8, 2, 3)))).long()
    tok_idx = torch.clamp((total - 1) * 4 + t1s, 0, 63).long()
    bits = torch.where(total == 0, const(LEN_COEFF0, dev)[tab],
                       const(LEN_COEFF_TOKEN, dev)[tab, tok_idx])
    bits = bits + torch.minimum(total, t1s)

    # reverse scan: the level-suffix chain and run_before
    lrtab = const(LEN_RUN_BEFORE, dev)
    sl = torch.where((total > 10) & (t1s < 3), 1, 0).to(_I32)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    t1c = torch.zeros(n, dtype=_I32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    zl = tz
    prev = torch.full((n,), -1, dtype=_I32, device=dev)
    for i in range(mc - 1, -1, -1):
        v = lev[:, i]
        isnz = v != 0
        is_t = isnz & (torch.abs(v) == 1) & ~blocked & (t1c < 3)
        is_lvl = isnz & ~is_t
        code = torch.where(v > 0, 2 * v - 2, -2 * v - 1)
        code = torch.where(first & (t1s < 3), code - 2, code)
        lb = _level_bits(code, sl)
        sl_next = torch.where(sl == 0, 1, sl)
        sl_next = torch.where(
            (torch.abs(v) > (3 << torch.clamp(sl_next - 1, min=0)))
            & (sl_next < 6), sl_next + 1, sl_next)
        bits = bits + torch.where(is_lvl, lb, 0)
        sl = torch.where(is_lvl, sl_next, sl)
        first = first & ~is_lvl
        t1c = t1c + is_t.to(_I32)
        blocked = blocked | is_lvl
        # run_before of the previously seen non-zero (higher position)
        run = torch.clamp(prev - i - 1, 0, 14)
        emit = isnz & (prev >= 0) & (zl > 0)
        rb = lrtab[torch.clamp(torch.clamp(zl, max=7) - 1, 0, 6).long(),
                   run.long()]
        bits = bits + torch.where(emit, rb, 0)
        zl = torch.where(emit, zl - run, zl)
        prev = torch.where(isnz, i, prev)

    tztab = const(LEN_TOTAL_ZEROS_DC if max_coeff == 4 else LEN_TOTAL_ZEROS,
                  dev)
    tzb = tztab[torch.clamp(total - 1, 0, tztab.shape[0] - 1).long(),
                torch.clamp(tz, 0, tztab.shape[1] - 1).long()]
    bits = bits + torch.where((total > 0) & (total < max_coeff), tzb, 0)
    return bits.to(_I32)


def ue_len(v: torch.Tensor) -> torch.Tensor:
    """Bit length of ue(v): 2 floor(log2(v + 1)) + 1, for v < 2^23."""
    w = v.to(_I32) + 1
    n = sum((w >= (1 << k)).to(_I32) for k in range(1, 24))
    return 2 * n + 1


def se_len(v: torch.Tensor) -> torch.Tensor:
    return ue_len(torch.where(v > 0, 2 * v - 1, -2 * v))
