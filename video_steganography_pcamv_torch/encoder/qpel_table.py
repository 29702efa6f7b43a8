"""Quarter-pel table geometry (port of encoder/qpel_table.py).

After full-pel ME every sample a later stage wants lies on the qpel
lattice within +-6 qpel of 4*mv_fp, and the interpolation phase of each
lattice offset is static. Offsets are indexed o = (oy+6)*13 + (ox+6).
"""

from __future__ import annotations

import torch

from ..ops.blocks import to_blocks
from ..ops.transform import hadamard4x4

MARGIN = 4


def off_index(oy: int, ox: int) -> int:
    return (oy + 6) * 13 + (ox + 6)


def _phase_slices(oy: int, ox: int):
    """Static plane pair + offsets of qpel offset (ox, oy) from a
    full-pel-anchored window (planes 0=F, 1=H, 2=V, 3=C)."""
    fx, fy = ox & 3, oy & 3
    bx, by = (ox >> 2) + MARGIN, (oy >> 2) + MARGIN
    if fx % 2 == 0 and fy % 2 == 0:
        p = (fx >> 1) + 2 * (fy >> 1)
        return (p, by, bx), (p, by, bx)
    if fx % 2 == 1 and fy % 2 == 0:
        return ((1 + 2 * (fy >> 1), by, bx),
                (0 + 2 * (fy >> 1), by, bx + (1 if fx == 3 else 0)))
    if fx % 2 == 0 and fy % 2 == 1:
        return (((fx >> 1) + 2, by, bx),
                ((fx >> 1), by + (1 if fy == 3 else 0), bx))
    return ((1, by + (1 if fy == 3 else 0), bx),
            (2, by, bx + (1 if fx == 3 else 0)))


def wht16(blocks: torch.Tensor) -> torch.Tensor:
    """Per-4x4 WHT of [..., H, W] blocks in the plane layout."""
    return hadamard4x4(to_blocks(blocks, 4))
