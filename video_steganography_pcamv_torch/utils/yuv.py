"""Frames and the synthetic test sequence (the port's copy of the
reference's utils/yuv.py: `Frame` and `synthetic_sequence`; the file
readers and writers are outside the serving slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Frame:
    y: np.ndarray  # [H, W] uint8
    u: np.ndarray  # [H/2, W/2] uint8
    v: np.ndarray  # [H/2, W/2] uint8

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]


def synthetic_sequence(width: int, height: int, n_frames: int,
                       seed: int = 7, motion: float = 2.0) -> list[Frame]:
    """Deterministic moving-texture sequence for tests and benchmarks.

    A textured background pans with subpixel-ish drift plus a few moving
    rectangles; produces a realistic mix of well-predicted and occluded
    macroblocks so ME/pskip/stego paths all get exercised.
    """
    rng = np.random.RandomState(seed)
    big = rng.randint(0, 256, (height * 2, width * 2)).astype(np.float32)
    # low-pass for a natural-ish texture
    k = np.ones(9) / 9.0
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    big = (big - big.min()) / max(1e-6, float(np.ptp(big))) * 220 + 16

    n_rects = 4
    rects = [(rng.randint(0, width), rng.randint(0, height),
              rng.randint(16, 48), rng.randint(16, 48),
              rng.uniform(-3, 3), rng.uniform(-3, 3),
              rng.randint(40, 215)) for _ in range(n_rects)]

    frames = []
    for t in range(n_frames):
        ox = int(round(motion * t)) % width
        oy = int(round(motion * 0.5 * t)) % height
        y = big[oy: oy + height, ox: ox + width].copy()
        for (rx, ry, rw, rh, vx, vy, val) in rects:
            x0 = int(rx + vx * t) % width
            y0 = int(ry + vy * t) % height
            x1 = min(x0 + rw, width)
            y1 = min(y0 + rh, height)
            y[y0:y1, x0:x1] = val
        yp = np.clip(y, 0, 255).astype(np.uint8)
        u = (yp[::2, ::2] // 2 + 64).astype(np.uint8)
        v = (255 - yp[1::2, 1::2] // 2 - 64).astype(np.uint8)
        frames.append(Frame(yp, u, v))
    return frames
