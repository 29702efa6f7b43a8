"""SAD / SATD over block tiles, PSNR and SSIM (port of ops/pixel.py)."""

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


def psnr_from_ssd(ssd_val: float, n_pixels: int) -> float:
    """Global PSNR from a summed SSD (x264 encoder.c:2590-2610)."""
    import math
    if ssd_val <= 0:
        return 99.99
    mse = ssd_val / n_pixels
    return 10.0 * math.log10(255.0 * 255.0 / mse)


def ssim_wxh(recon: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x264-semantics SSIM summed over 8x8 windows at stride 4 (x264
    pixel.c:435-470 ssim_4x4x2_core/ssim_end1, driven per frame as in
    encoder.c:1069-1080; the caller applies the +2-pixel offset).
    recon/src: equal-shape integer planes. The window sums are int32, the
    formula float32 in the reference's order; returns the float32 sum
    over ((w>>2)-1)*((h>>2)-1) windows as a 0-d tensor on the planes'
    device (normalization is the caller's, encoder.c:2605-2610)."""
    h, w = recon.shape
    bh, bw = h // 4, w // 4
    a = recon[:4 * bh, :4 * bw].to(_I32)
    b = src[:4 * bh, :4 * bw].to(_I32)

    def blksum(x):
        return x.reshape(bh, 4, bw, 4).sum((1, 3), dtype=_I32)
    s1 = blksum(a)
    s2 = blksum(b)
    ss = blksum(a * a) + blksum(b * b)
    s12 = blksum(a * b)

    def win(x):  # 2x2 block window sums -> [bh-1, bw-1]
        return (x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1] + x[1:, 1:]) \
            .to(torch.float32)
    s1w, s2w, ssw, s12w = win(s1), win(s2), win(ss), win(s12)
    c1 = float(int(.01 * .01 * 255 * 255 * 64 + .5))
    c2 = float(int(.03 * .03 * 255 * 255 * 64 * 63 + .5))
    vars_ = ssw * 64 - s1w * s1w - s2w * s2w
    covar = s12w * 64 - s1w * s2w
    ssim = (2 * s1w * s2w + c1) * (2 * covar + c2) \
        / ((s1w * s1w + s2w * s2w + c1) * (vars_ + c2))
    return ssim.sum()
