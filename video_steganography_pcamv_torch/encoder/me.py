"""Motion-cost tables and the exhaustive 16x16 full-pel search (port of
encoder/me.py: `lambda_tab`, `mv_bits_table`, `fullpel_search`)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mc
from ..ops.blocks import to_blocks

_I32 = torch.int32


def lambda_tab(qp: int) -> int:
    """SAD lambda: 0.85 * 2^((qp-12)/6), min 1."""
    return max(1, int(round(0.85 * 2.0 ** ((qp - 12) / 6.0))))


def mv_bits_table(max_abs: int) -> np.ndarray:
    """bits(se(v)) for v in [-max_abs, max_abs] (index v + max_abs)."""
    out = np.zeros(2 * max_abs + 1, np.int32)
    for v in range(-max_abs, max_abs + 1):
        ue = -2 * v if v <= 0 else 2 * v - 1
        out[v + max_abs] = 2 * int(np.floor(np.log2(ue + 1))) + 1
    return out


def fullpel_search(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int, mbw: int,
                   lam: int = 1):
    """Exhaustive +-rng full-pel 16x16 search, the plain version of
    kernel B6: cost = SAD + lam * (bits(4dx - 4pmx) + bits(4dy - 4pmy)),
    the first strict-< minimum in dy-outer, dx-inner order.

    cur_y [16mbh,16mbw]; ref_fp the PAD-padded full-pel plane;
    pred_mv_fp [mbh,mbw,2] full-pel predictor. Returns (mv [mbh,mbw,2]
    full-pel (x, y), cost [mbh,mbw]) int32."""
    dev = cur_y.device
    h, w = 16 * mbh, 16 * mbw
    off = 4 * (rng + 64)
    bits_t = torch.as_tensor(mv_bits_table(off), device=dev)
    nb = bits_t.shape[0]
    best = torch.full((mbh, mbw), 1 << 30, dtype=_I32, device=dev)
    best_mv = torch.zeros((mbh, mbw, 2), dtype=_I32, device=dev)
    for dy in range(-rng, rng + 1):
        iy = torch.clamp(4 * dy - 4 * pred_mv_fp[..., 1] + off, 0, nb - 1)
        for dx in range(-rng, rng + 1):
            win = ref_fp[mc.PAD + dy:mc.PAD + dy + h,
                         mc.PAD + dx:mc.PAD + dx + w]
            sad = to_blocks(torch.abs(cur_y - win), 16).sum((-4, -3),
                                                           dtype=_I32)
            ix = torch.clamp(4 * dx - 4 * pred_mv_fp[..., 0] + off, 0,
                             nb - 1)
            cost = sad + (bits_t[ix.long()] + bits_t[iy.long()]) * lam
            better = cost < best
            best = torch.where(better, cost, best)
            best_mv[..., 0] = torch.where(better, dx, best_mv[..., 0])
            best_mv[..., 1] = torch.where(better, dy, best_mv[..., 1])
    return best_mv, best
