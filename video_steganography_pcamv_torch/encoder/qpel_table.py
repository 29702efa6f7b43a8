"""Quarter-pel block tables (port of encoder/qpel_table.py).

After full-pel ME every sample a later stage wants lies on the qpel
lattice within +-6 qpel of 4*mv_fp, and the interpolation phase of each
lattice offset is static. Offsets are indexed o = (oy+6)*13 + (ox+6).

The 16x16-only P path fetches one [4, WIN, WIN] window of the four hpel
planes per MB (kernel B7, `gather_windows`), builds every offset's
16x16 block as a static slice-average (`block_table`) and its per-4x4
WHT (`wht_table`), so that SATD against any candidate is a difference of
table rows (`satd_tables`). The tables are int16 (blocks <= 255, WHT
coefficients <= 4080): at 1080p each is [169, 8160, 16, 16], 0.7 GB.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops import mc
from ..ops.blocks import to_blocks
from ..ops.transform import hadamard4x4

# window geometry: origin = full-pel base - MARGIN; offsets in [-6, 6]
# qpel reach full-pel bases [-2, 1] plus the pairing offset (+1) and
# the 16-pel block, so WIN = 24 covers them
MARGIN = 4
WIN = 24

_I32 = torch.int32


def off_index(oy: int, ox: int) -> int:
    return (oy + 6) * 13 + (ox + 6)


def _window_origins(mv_fp, mbh: int, mbw: int):
    n = mbh * mbw
    ar = torch.arange(n, device=mv_fp.device)
    mvf = mv_fp.reshape(n, 2).long()
    ys = torch.div(ar, mbw, rounding_mode="floor") * 16 + mc.PAD - MARGIN \
        + mvf[:, 1]
    xs = (ar % mbw) * 16 + mc.PAD - MARGIN + mvf[:, 0]
    return ys, xs


def gather_windows_plain(planes, mv_fp, mbh: int, mbw: int):
    """Plain version of B7 (the reference's `gather_windows_jnp`):
    planes [4, Hp, Wp] padded (F, H, V, C), mv_fp [mbh, mbw, 2] ->
    [N, 4, WIN, WIN] windows at (mb_base + mv_fp - MARGIN)."""
    ys, xs = _window_origins(mv_fp, mbh, mbw)
    w = torch.arange(WIN, device=planes.device)
    yy = ys[:, None] + w
    xx = xs[:, None] + w
    return planes[:, yy[:, :, None], xx[:, None, :]].permute(1, 0, 2, 3)


def gather_windows(planes, mv_fp, mbh: int, mbw: int):
    """Kernel B7, replacing the TPU kernel `gather_windows`
    (video_steganography_pcamv_tpu/encoder/qpel_table.py:64): a warp an
    MB, aligned 16-byte loads, funnel shifts, coalesced 16-byte stores
    (`csrc/windows.cu`). Bound by device memory.

    planes [4, Hp, Wp] uint8 (PAD-padded hpel planes); mv_fp [mbh, mbw,
    2] int32 full-pel. |mv| <= PAD - MARGIN keeps every window inside the
    planes (the furthest column is W + 43 of W + 2 * PAD); the encoder
    refuses larger search ranges (`check_slice`), and the kernel traps on
    a window outside the planes. Returns [N, 4, WIN, WIN] uint8.
    CPU tensors run `gather_windows_plain`; CUDA tensors launch the
    kernel (counted in `gather_windows.launches`)."""
    if planes.device.type == "cpu":
        return gather_windows_plain(planes, mv_fp, mbh, mbw)
    hp, wp = 16 * mbh + 2 * mc.PAD, 16 * mbw + 2 * mc.PAD
    kernels.check_tensor("gather_windows", "planes", planes, torch.uint8,
                         (4, hp, wp))
    if planes.data_ptr() % 16:
        raise ValueError("gather_windows: planes are not 16-byte aligned")
    kernels.check_tensor("gather_windows", "mv_fp", mv_fp, _I32,
                         (mbh, mbw, 2))
    n = mbh * mbw
    out = torch.empty((n, 4, WIN, WIN), dtype=torch.uint8,
                      device=planes.device)
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_gather_windows",
                       [VP, CI, CI, VP, CI, CI, VP, VP])
    ptr = kernels.ptr
    rc = fn(ptr(planes), hp, wp, ptr(mv_fp), mbh, mbw, ptr(out),
            kernels.stream(planes))
    kernels.check(rc, "pcamv_gather_windows")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


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


def block_table(windows):
    """[N, 4, WIN, WIN] uint8 -> [169, N, 16, 16] int16: every qpel
    offset in [-6, 6]^2 as a static slice-average."""
    w16 = windows.to(torch.int16)
    outs = []
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = _phase_slices(oy, ox)
            a = w16[:, p1, y1:y1 + 16, x1:x1 + 16]
            b = w16[:, p2, y2:y2 + 16, x2:x2 + 16]
            outs.append((a + b + 1) >> 1)
    return torch.stack(outs)


def wht16(blocks: torch.Tensor) -> torch.Tensor:
    """Per-4x4 WHT of [..., H, W] blocks in the plane layout
    [..., 4, 4, H/4, W/4]."""
    return hadamard4x4(to_blocks(blocks, 4))


def wht_table(blocks):
    """wht16 of the [169, N, 16, 16] table as int16 [169, N, 4, 4, 4, 4],
    in chunks of 13 offsets (bounds the int32 intermediates)."""
    return torch.cat([wht16(blocks[k:k + 13].to(_I32)).to(torch.int16)
                      for k in range(0, blocks.shape[0], 13)])


def satd_tables(wa, wb):
    """SATD between WHT tensors [..., 4, 4, 4, 4]: per-4x4 |sum| >> 1,
    summed; int16 inputs accumulate in int32."""
    d = torch.abs(wa.to(_I32) - wb.to(_I32))
    return (d.sum((-4, -3), dtype=_I32) >> 1).sum((-2, -1), dtype=_I32)


def select_rows(table, idx):
    """out[n] = table[idx[n], n] for a [K, N, ...] table."""
    return table[idx.long(), torch.arange(table.shape[1],
                                          device=table.device)]
