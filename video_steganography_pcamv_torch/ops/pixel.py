"""SAD / SATD over block tiles (port of ops/pixel.py)."""

from __future__ import annotations

import torch

from .blocks import to_blocks
from .transform import hadamard4x4

_I32 = torch.int32


def sad(a: torch.Tensor, b: torch.Tensor, block: int = 16) -> torch.Tensor:
    """SAD over block x block tiles of the last two axes."""
    d = torch.abs(a.to(_I32) - b.to(_I32))
    return to_blocks(d, block).sum((-4, -3), dtype=_I32)


def satd4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-4x4 SATD: (sum |WHT4(a-b)|) >> 1."""
    d = to_blocks(a.to(_I32) - b.to(_I32), 4)
    return torch.abs(hadamard4x4(d)).sum((-4, -3), dtype=_I32) >> 1


def satd(a: torch.Tensor, b: torch.Tensor, block: int = 16) -> torch.Tensor:
    """SATD summed to block x block tiles."""
    return to_blocks(satd4(a, b), block // 4).sum((-4, -3), dtype=_I32)


def _wht8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sylvester-order 8-point Walsh-Hadamard transform along `dim`
    (natural-order butterflies at strides 1, 2, 4)."""
    x = x.movedim(dim, -1)
    for s in (1, 2, 4):
        v = x.reshape(*x.shape[:-1], 8 // (2 * s), 2, s)
        a, b = v[..., 0, :], v[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(x.shape)
    return x.movedim(-1, dim)


def sa8d_16x16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x264_pixel_sa8d_16x16 of [N, 16, 16] int32 pairs: the sum over
    the four 8x8 sub-blocks of |H8 (a - b) H8^T|, then (sum + 2) >> 2
    (the reference's einsum with its Sylvester `_H8`). Returns [N]."""
    d = (a.to(_I32) - b.to(_I32)).reshape(-1, 2, 8, 2, 8).transpose(2, 3)
    t = _wht8(_wht8(d, -2), -1)
    s = torch.abs(t).sum((1, 2, 3, 4), dtype=_I32)
    return (s + 2) >> 2
