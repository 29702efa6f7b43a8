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
