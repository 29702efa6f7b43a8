"""Block-layout helpers (port of the reference's ops/blocks.py).

Every NxN block position becomes one coefficient plane:
``planes[..., r, c, by, bx] == pixel (n*by + r, n*bx + c)``.
"""

from __future__ import annotations

import torch


def to_blocks(x: torch.Tensor, n: int = 4) -> torch.Tensor:
    """[..., H, W] -> [..., n, n, H//n, W//n]."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // n, n, w // n, n)
    return x.movedim((-3, -1), (-4, -3))


def mb_tiles(plane: torch.Tensor, b: int) -> torch.Tensor:
    """[b*mbh, b*mbw] plane -> [mbh*mbw, b, b] MB tiles (raster)."""
    h, w = plane.shape
    return plane.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3) \
        .reshape(-1, b, b)


def from_blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., n, n, BY, BX] -> [..., H, W]."""
    *lead, n, n2, by, bx = x.shape
    assert n == n2
    x = x.movedim((-4, -3), (-3, -1))
    return x.reshape(*lead, by * n, bx * n)
