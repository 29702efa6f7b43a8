"""Kernels B8a and B8b: the fused 4x4 residual transform pair of the
inter luma encode.

B8a `dct_quant` replaces the TPU kernel `dct_quant_pallas`
(video_steganography_pcamv_tpu/ops/pallas_kernels.py:175, kernel
`_dct_quant_kernel` :88): residual -> forward 4x4 DCT -> quant, with an
optional zeroed DC (`zero_dc`). B8b `deq_idct` replaces
`deq_idct_pallas` (:204, kernel `_deq_idct_kernel` :123): dequant ->
optional pre-dequantized DC row (`use_dc`) -> inverse 4x4 DCT -> pred
add -> clip to [0, 255]. Both kernels live in `csrc/dct_quant.cu`.

Layout: the reference's `[16, L]`, row i = coefficient position 4*r + c
and lane l = one 4x4 block. On the H100 a thread owns one lane, so the
16 loads and stores of a row are coalesced across a warp; the TPU's
lane padding to 2048 is dropped. Both kernels are bound by their device
memory traffic (B8a reads two int32 rows and writes one per
coefficient, B8b the same plus the optional DC row).

No path launches them: every 4x4 luma encode runs the fused kernel of
`ops/lumap.py`, which also does the decimation between the two. They
stay as standalone check entries, held against their plain versions on
the card, and as the earlier chain that the fused kernel is timed
against.

On a CPU tensor each wrapper runs its plain version, the port's
transform arithmetic (`ops/transform.py`) on the same layout; on a CUDA
tensor it launches its kernel, counted in `<wrapper>.launches`, or
raises.
"""

from __future__ import annotations

import torch

from . import transform as T
from .. import kernels

_I32 = torch.int32


def _planes(x16):
    """[16, L] -> [4(r), 4(c), L, 1], the transform module's layout."""
    return x16.reshape(4, 4, -1, 1)


def dct_quant_plain(cur16, pred16, mf16, bias16, zero_dc: bool = False):
    """sign(c) * ((bias + |c|) * mf >> 16) of the 4x4 DCT of cur - pred,
    per lane. mf16/bias16 [16] int32 in (4r + c) order."""
    coef = T.dct4x4(_planes(cur16 - pred16)).reshape(16, -1)
    mag = (bias16[:, None] + torch.abs(coef)) * mf16[:, None] >> 16
    lev = torch.sign(coef) * mag
    if zero_dc:
        lev[0] = 0
    return lev


def deq_idct_plain(lev16, pred16, dmf16, qbits: int, dc=None,
                   use_dc: bool = False):
    """Dequant (qbits = qp // 6 - 4), DC row replaced by `dc` [1, L]
    when use_dc, inverse DCT, (x + 32) >> 6, pred add, clip."""
    d = lev16 * dmf16[:, None]
    if qbits >= 0:
        d = d << qbits
    else:
        d = (d + (1 << (-qbits - 1))) >> (-qbits)
    if use_dc:
        d = torch.cat([dc.reshape(1, -1).to(d.dtype), d[1:]])
    r = (T.idct4x4(_planes(d)).reshape(16, -1) + 32) >> 6
    return torch.clamp(pred16 + r, 0, 255)


_VP, _CI = kernels.VP, kernels.CI


def _check(fn: str, lanes: int, **tensors) -> None:
    """int32, contiguous, on the card: [16, L] rows, [16] tables, the
    [1, L] dc row."""
    for name, t in tensors.items():
        shape = {"dc": (1, lanes)}.get(name, (16,) if t.dim() == 1
                                       else (16, lanes))
        kernels.check_tensor(fn, name, t, _I32, shape)


def dct_quant(cur16, pred16, mf16, bias16, zero_dc: bool = False):
    """Kernel B8a, replacing `dct_quant_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:175).

    cur16/pred16 [16, L] int32; mf16/bias16 [16] int32 (qp-resolved
    inter quant tables). Returns lev [16, L] int32."""
    if cur16.device.type == "cpu":
        return dct_quant_plain(cur16, pred16, mf16, bias16, zero_dc)
    lanes = cur16.shape[-1]
    _check("dct_quant", lanes, cur16=cur16, pred16=pred16, mf16=mf16,
           bias16=bias16)
    out = torch.empty((16, lanes), dtype=_I32, device=cur16.device)
    fn = kernels.entry("pcamv_dct_quant",
                       [_VP] * 4 + [_CI] * 2 + [_VP] * 2)
    ptr = kernels.ptr
    rc = fn(ptr(cur16), ptr(pred16), ptr(mf16), ptr(bias16), lanes,
            int(zero_dc), ptr(out), kernels.stream(cur16))
    kernels.check(rc, "pcamv_dct_quant")
    dct_quant.launches += 1
    return out


dct_quant.launches = 0


def deq_idct(lev16, pred16, dmf16, qbits: int, dc=None,
             use_dc: bool = False):
    """Kernel B8b, replacing `deq_idct_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:204).

    lev16/pred16 [16, L] int32; dmf16 [16] int32; qbits = qp // 6 - 4;
    dc [1, L] int32 dequantized DC for row 0, read when use_dc. Returns
    recon [16, L] int32 in [0, 255]."""
    if lev16.device.type == "cpu":
        return deq_idct_plain(lev16, pred16, dmf16, qbits, dc, use_dc)
    lanes = lev16.shape[-1]
    _check("deq_idct", lanes, lev16=lev16, pred16=pred16, dmf16=dmf16,
           **({"dc": dc} if use_dc else {}))
    out = torch.empty((16, lanes), dtype=_I32, device=lev16.device)
    fn = kernels.entry("pcamv_deq_idct",
                       [_VP] * 3 + [_CI, _VP] + [_CI] * 2 + [_VP] * 2)
    ptr = kernels.ptr
    rc = fn(ptr(lev16), ptr(pred16), ptr(dmf16), int(qbits),
            ptr(dc) if use_dc else None, int(use_dc), lanes, ptr(out),
            kernels.stream(lev16))
    kernels.check(rc, "pcamv_deq_idct")
    deq_idct.launches += 1
    return out


deq_idct.launches = 0
