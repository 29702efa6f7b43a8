"""Adaptive quantization (port of ops/aq.py; x264 --aq-mode 1:
x264_adaptive_quant_frame, encoder/ratecontrol.c:231-265).

`aq_offsets` turns each MB's source AC energy, var(16x16 luma) +
var(8x8 u) + var(8x8 v) with var = sqr - (sum^2 >> log2(count)), into a
float32 QP offset `(strength * 1.0397) * (log2(max(energy, 1)) -
14.427)`. It runs on the encoder's device in torch and reproduces the
reference bit for bit:

- The reference asks for int64 sums with JAX's 64-bit mode off, so they
  are int32: a luma MB whose sum exceeds 46340 (a mean above ~181) has
  its `sum * sum` wrap before the arithmetic shift (ROADMAP F6). A flat
  MB of luma 250 then gets +9.953049 at strength 1 where exact
  arithmetic gives -14.999752. The port keeps the wrap.
- Its log2 is XLA's CPU float32 routine (`ln_xla`, `log2_xla`): the
  exponent and mantissa split by bit masks, the sqrt(1/2) fold, the
  polynomial in XLA's order, then 1/ln 2 (torch's own log2 differs from
  it on a third of the integers below 2^25, ROADMAP C8). XLA's IR has
  plain fmul/fadd pairs, but its x86 code fuses most of them into FMAs
  (vfmadd), and so does the final `* 1/ln 2 - 14.427`; the port takes
  each such pair as one exactly rounded `fma32` (float64, corrected on
  the float32 midpoints) and every other step as one float32 torch op.
  Eager ops are never contracted, so the same code serves the card.

`assign_qp_grid` (the +-1 hysteresis in raster order) and
`effective_qp_grid` (the decoder-visible chain: an MB that codes no
mb_qp_delta inherits the previous MB's qp) stay on the host as in the
reference, after one pull of the [mbh, mbw] offsets a frame. An encoder
rebuilds its grids every frame, so a resumed stream
(`state.from_reference`) needs no AQ state. The reference's `Zones`
waits for its own item (ROADMAP A16).
"""

from __future__ import annotations

import numpy as np
import torch

from .transform import CHROMA_QP_TABLE

_F32, _F64 = torch.float32, torch.float64
_I32, _I64 = torch.int32, torch.int64


def _f32(bits: int) -> float:
    """The float32 whose IEEE bits are `bits` (as a Python float)."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# the constants of XLA's inlined float32 log, in the order it uses them
_SQRTH = _f32(0x3F3504F3)          # sqrt(1/2), the fold point
_P = [_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,   # p0 p1 p2
                        0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,   # p3 p4 p5
                        0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]  # p6 p7 p8
_Q1 = _f32(0xB95E8083)             # -2.12194440e-4
_Q2 = 0.693359375
_INV_LN2 = _f32(0x3FB8AA3B)        # 1 / ln 2 in float32
_MIN_NORM = _f32(0x00800000)


def _to_odd(s: torch.Tensor, p: torch.Tensor, cd: torch.Tensor):
    """s = p + cd rounded to float64, moved one float64 step toward the
    exact sum where the sum was inexact (its error, TwoSum)."""
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    away = torch.where(err > 0, torch.inf, -torch.inf).to(_F64)
    return torch.where(err != 0, torch.nextafter(s, away), s)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (a fused multiply-add), on
    any device: the product is exact in float64 and the sum is rounded to
    float64 once; rounding that to float32 is exact rounding, unless it
    lies exactly on a float32 midpoint (double rounding), where it is
    first moved toward the exact sum (`_to_odd`): on the card on every
    lane (no host sync), on the CPU on the few such lanes."""
    p = a.to(_F64) * torch.as_tensor(b, dtype=_F32).to(a.device, _F64)
    cd = torch.as_tensor(c, dtype=_F32).to(a.device, _F64).expand_as(p)
    s = p + cd
    mid = (s.view(_I64) & 0x1FFFFFFF) == 0x10000000
    if s.is_cuda:
        s = torch.where(mid, _to_odd(s, p, cd), s)
    else:
        i = mid.nonzero(as_tuple=True)
        s[i] = _to_odd(s[i], p[i], cd[i])
    return s.to(_F32)


def ln_xla(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive float32 values as XLA's CPU backend
    computes it on an FMA machine: the Cephes float32 polynomial with the
    exponent split by bit masks, its multiply-adds fused as the compiled
    code fuses them (the IR's fmul/fadd pairs become vfmadd)."""
    x = torch.clamp(x.to(_F32), min=_MIN_NORM)
    bits = x.view(_I32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & -2139095041) | 1056964608).view(_F32)   # [0.5, 1)
    small = m < _SQRTH
    e = e - torch.where(small, 1.0, 0.0).to(_F32)
    t = (m - 1.0) + torch.where(small, m, 0.0).to(_F32)
    z = t * t
    z3 = z * t
    y1 = fma32(t, fma32(t, _P[0], _P[1]), _P[2])
    y2 = fma32(t, fma32(t, _P[3], _P[4]), _P[5])
    y3 = fma32(t, fma32(t, _P[6], _P[7]), _P[8])
    y = fma32(z3, fma32(z3, fma32(z3, y1, y2), y3), e * _Q1)
    return fma32(e, _Q2, fma32(z, -0.5, t) + y)


def log2_xla(x: torch.Tensor) -> torch.Tensor:
    """jax.jit(jnp.log2) of positive float32 values on the CPU: the
    natural log of `ln_xla` times 1/ln 2 (a plain multiply there)."""
    return ln_xla(x) * _INV_LN2


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _var_tiles(plane, b: int, shift: int, mbh: int, mbw: int):
    t = plane[:b * mbh, :b * mbw].to(_I64)
    t = t.reshape(mbh, b, mbw, b).permute(0, 2, 1, 3)
    s = t.sum((2, 3))
    sq = t.mul(t).sum((2, 3))
    return sq - (_wrap32(s * s) >> shift)


def aq_offsets(y, u, v, mbh: int, mbw: int, strength) -> torch.Tensor:
    """Per-MB AQ qp offsets [mbh, mbw] float32 from the source planes
    (int32 or uint8, MB-padded) on their device: the reference's
    `aq_offsets` bit for bit, its int32 wrap (F6) and XLA's log2
    included."""
    energy = _wrap32(_var_tiles(y, 16, 8, mbh, mbw)
                     + _var_tiles(u, 8, 6, mbh, mbw)
                     + _var_tiles(v, 8, 6, mbh, mbw))
    energy = torch.clamp(energy, min=1).to(_F32)
    k = torch.tensor(strength, dtype=_F32) * torch.tensor(1.0397,
                                                          dtype=_F32)
    # log2(e) - 14.427 as the compiled reference has it: one fused
    # multiply-add on the natural log
    return k.to(energy.device) * fma32(ln_xla(energy), _INV_LN2, -14.427)


def assign_qp_grid(qp_frame: int, offsets: np.ndarray, qp_min: int = 0,
                   qp_max: int = 51) -> np.ndarray:
    """Per-MB integer QP grid int32 [mbh, mbw]: clip(frame qp + offset +
    0.5) (float32 under numpy 2's rules for a Python int plus
    np.float32), truncated, with the reference's +-1 hysteresis against
    the previous MB in raster order."""
    mbh, mbw = offsets.shape
    out = np.zeros((mbh, mbw), np.int32)
    last = int(np.clip(qp_frame + 0.5, qp_min, qp_max))
    for my in range(mbh):
        for mx in range(mbw):
            q = int(np.clip(qp_frame + offsets[my, mx] + 0.5,
                            qp_min, qp_max))
            if abs(q - last) == 1:
                q = last
            out[my, mx] = q
            last = q
    return out


def effective_qp_grid(qp_grid: np.ndarray, coded: np.ndarray,
                      prev_qp: int) -> np.ndarray:
    """Decoder-visible QP per MB int32 [mbh, mbw]: an MB that codes no
    mb_qp_delta (coded False) keeps the previous MB's qp (spec 7.4.5);
    prev_qp is the slice QP. The deblocker reads this chain."""
    mbh, mbw = qp_grid.shape
    out = np.empty((mbh, mbw), np.int32)
    last = int(prev_qp)
    for my in range(mbh):
        for mx in range(mbw):
            if coded[my, mx]:
                last = int(qp_grid[my, mx])
            out[my, mx] = last
    return out


def chroma_grid(qp_grid: np.ndarray, chroma_qp_offset: int) -> np.ndarray:
    """The chroma QP of every MB of a luma QP grid (int32)."""
    return CHROMA_QP_TABLE[np.clip(qp_grid + chroma_qp_offset, 0, 51)] \
        .astype(np.int32)


def frame_grids(y, u, v, qp: int, p):
    """The (luma, chroma) QP grids int32 [mbh, mbw] of a frame at slice
    QP qp under Params p (one pull of the offsets)."""
    offs = aq_offsets(y, u, v, p.mb_height, p.mb_width, p.aq_strength)
    grid = assign_qp_grid(qp, offs.cpu().numpy(), p.qp_min, p.qp_max)
    return grid, chroma_grid(grid, p.chroma_qp_offset)
