"""Motion-cost tables (port of encoder/me.py's host helpers)."""

from __future__ import annotations

import numpy as np


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
