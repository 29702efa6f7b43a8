"""The fused inter luma encode of 16x16 MBs: kernel B8 as one launch.

`luma_p_encode` replaces the reference's pair `dct_quant_pallas`
(video_steganography_pcamv_tpu/ops/pallas_kernels.py:175) and
`deq_idct_pallas` (:204) together with the JVT-B118 decimation that
`luma_p_encode_fast` runs between them
(video_steganography_pcamv_tpu/encoder/inter.py:124); it computes what
the reference's `luma_p_encode(cur, pred, qp, decimate=True)` computes
(:225), plus the force-zero of the stego pass 2 and the luma cbp. The
kernel is `csrc/luma_p.cu`: a half-warp per MB, a lane per 4x4 block,
the 8x8 and MB score sums as shuffles and the cbp as a ballot, so that
nothing between the transform and the reconstruction reaches device
memory.

The current MBs are read straight from the luma plane through a raster
MB index: the whole frame (no index, N = the plane's MB count), a
subset (`idx`), or the stego probe's 13 versions of every MB (no index,
N = 13 x the MB count: MB i reads the plane's MB i % count).

Under trellis quantization the levels come from the trellis
(`ops/trellis.py`, run on the DCT of the residual before the call) and
the wrapper takes them as `levels`: the kernel's second entry skips the
transform and the quant and runs the rest as above, the reference's
`luma_p_encode(..., trellis=True)`.

The quant tables are the caller's (`tables`, an `ops.cqm.QuantTables`:
its inter class; None: flat). `qp` is an int, or under adaptive
quantization an int32 [N] tensor of per-MB qps (the reference's
`luma_p_encode(cur, pred, qp[N], ...)`); the kernel then takes each MB's
rows of the tables' [52, 48] slab (`QuantTables.qtab_all`) in the same
single launch (`luma_p_encode.grid_launches` counts those calls). With
`nr_offset` (int32 [4, 4], the encoder's running noise-reduction
offsets) the DCT entry takes its noise-reduction instance, the
reference's `luma_p_encode(..., nr_offset=)`: the per-position sums of |coef| over every block of the
call, before the denoise, come back as a fourth result, and each AC
coefficient is pulled toward zero by its offset before the quant.

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches its kernel, counted in `luma_p_encode.launches` (the levels-in
entry in `luma_p_encode.levels_launches`, the noise-reduction instance
also in `luma_p_encode.nr_launches`), or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import const
from . import transform as T
from .cqm import FLAT
from .. import kernels
from .blocks import mb_tiles, to_blocks

_I32 = torch.int32

# JVT-B118 decimation table (quant.c x264_mb_decimate_score)
DS_TAB = np.array([3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                  np.int32)


def zigzag_gather(levels: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4, BY, BX] -> [N, 16, BY, BX] in zigzag order."""
    zz = const(T.ZIGZAG_4x4, levels.device).long()
    return levels[:, zz[:, 0], zz[:, 1]]


def decimate_score(levels: torch.Tensor) -> torch.Tensor:
    """x264_mb_decimate_score over zigzag levels [N, 16, BY, BX]."""
    a = torch.abs(levels)
    anybig = (a > 1).any(1)
    nz = a > 0
    idx = torch.arange(16, device=levels.device,
                       dtype=_I32)[None, :, None, None]
    marked = torch.where(nz, idx, -1)
    prev = torch.cummax(marked, dim=1).values
    prev_excl = torch.cat([torch.full_like(prev[:, :1], -1),
                           prev[:, :-1]], dim=1)
    run = idx - prev_excl - 1
    tab = const(DS_TAB, levels.device)
    contrib = torch.where(nz, tab[torch.clamp(run, 0, 15).long()], 0)
    return torch.where(anybig, 9, contrib.sum(1, dtype=_I32))


def cbp_luma_of(lev: torch.Tensor) -> torch.Tensor:
    n = lev.shape[0]
    nz_blk = (lev != 0).any(2).any(1)                        # [N,4,4]
    cbp8 = nz_blk.reshape(n, 2, 2, 2, 2).any(4).any(2)       # [N,2,2]
    return (cbp8[:, 0, 0].to(_I32) + 2 * cbp8[:, 0, 1].to(_I32)
            + 4 * cbp8[:, 1, 0].to(_I32) + 8 * cbp8[:, 1, 1].to(_I32))


def _cur_tiles(y, n: int, idx):
    """The N current MBs: the plane's MB idx[i], or MB i % count."""
    tiles = mb_tiles(y, 16)
    if idx is not None:
        return tiles[idx.long()]
    if n == tiles.shape[0]:
        return tiles
    return tiles[torch.arange(n, device=y.device) % tiles.shape[0]]


def denoise(coef, nr_offset):
    """x264_denoise_dct (common/quant.c:180) on [N, 4, 4, BY, BX]
    coefficient planes: (the per-position sums of |coef| [4, 4] int32,
    before the denoise; the planes with every AC coefficient set to
    sign(c) * max(|c| - offset, 0))."""
    absx = torch.abs(coef)
    nr_sum = absx.sum((0, 3, 4), dtype=_I32)
    off = nr_offset.reshape(4, 4).to(_I32).clone()
    off[0, 0] = 0
    newabs = torch.clamp(absx - off[None, :, :, None, None], min=0)
    return nr_sum, torch.sign(coef) * newabs


def luma_p_encode_plain(y, pred, qp, idx=None, fz=None,
                        lev: bool = True, levels=None, tables=None,
                        nr_offset=None):
    """Residual -> 4x4 DCT -> (denoise) -> inter quant (or the given
    `levels`) -> decimation (per 8x8 score >= 4, per MB sum of the kept
    8x8 scores >= 6) -> force-zero -> dequant -> IDCT -> recon, and the
    luma cbp of the kept levels (and the denoise's sums)."""
    n = pred.shape[0]
    nr_sum = None
    if levels is None:
        cur = _cur_tiles(y, n, idx)
        coef = T.dct4x4(to_blocks(cur - pred, 4))
        if nr_offset is not None:
            nr_sum, coef = denoise(coef, nr_offset)
        levels = T.quant4x4(coef, qp, intra=False, tables=tables)
    sc = decimate_score(zigzag_gather(levels))               # [N,4,4]
    sc8 = sc.reshape(n, 2, 2, 2, 2).sum((2, 4), dtype=_I32)
    keep8 = sc8 >= 4
    keep_mb = torch.where(keep8, sc8, 0).sum((1, 2), dtype=_I32) >= 6
    keep = keep8 & keep_mb[:, None, None]
    if fz is not None:
        keep = keep & ~fz.reshape(n, 1, 1).to(torch.bool)
    keep_blk = keep.repeat_interleave(2, 1).repeat_interleave(2, 2)
    levels = levels * keep_blk[:, None, None, :, :]
    rec = T.idct4x4_add(to_blocks(pred, 4),
                        T.dequant4x4(levels, qp, tables=tables))
    rec = rec.permute(0, 3, 1, 4, 2).reshape(n, 16, 16)
    out = (levels if lev else None), rec, cbp_luma_of(levels)
    return out if nr_offset is None else out + (nr_sum,)


# the flat per-qp [16] tables in (4r + c) order: quant mf, inter bias,
# dequant mf (the check entries' constants)
MF16 = [T.QUANT4_MF[q].reshape(16).copy() for q in range(52)]
BIAS16 = [T.QUANT4_BIAS_INTER[q].reshape(16).copy() for q in range(52)]
DMF16 = [T.DEQUANT4_MF[q].reshape(16).copy() for q in range(6)]

_VP, _CI = kernels.VP, kernels.CI


def _check(y, pred, idx, fz, levels=None, nr_offset=None,
           qp_mb=None) -> None:
    """The input contract on every device: an int32 plane of 16x16 MBs,
    int32 [N, 16, 16] predictions, int32 [N] MB numbers inside the
    plane, bool [N] force-zero flags, int32 [N, 4, 4, 4, 4] levels,
    int32 [4, 4] noise-reduction offsets (not with levels), int32 [N]
    per-MB qps in [0, 51] (on the card a value outside traps), all on
    y's device; on the card also contiguous and, for y and pred, 16-byte
    aligned."""
    fn = "luma_p_encode"
    if y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16:
        raise ValueError("%s: y shape %s is not a plane of 16x16 MBs"
                         % (fn, tuple(y.shape)))
    n = pred.shape[0]
    if levels is not None and nr_offset is not None:
        raise ValueError("%s: nr_offset with levels (the trellis path "
                         "denoises before the trellis)" % fn)
    for name, t, dtype, shape in (("y", y, _I32, tuple(y.shape)),
                                  ("pred", pred, _I32, (n, 16, 16)),
                                  ("idx", idx, _I32, (n,)),
                                  ("fz", fz, torch.bool, (n,)),
                                  ("levels", levels, _I32,
                                   (n, 4, 4, 4, 4)),
                                  ("nr_offset", nr_offset, _I32, (4, 4)),
                                  ("qp", qp_mb, _I32, (n,))):
        if t is None:
            continue
        if y.is_cuda:
            kernels.check_tensor(fn, name, t, dtype, shape)
            continue
        if t.device != y.device:
            raise ValueError("%s: %s is on %s, y on %s"
                             % (fn, name, t.device, y.device))
        if t.dtype != dtype:
            raise TypeError("%s: %s dtype %s, expected %s"
                            % (fn, name, t.dtype, dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s: %s shape %s, expected %s"
                             % (fn, name, tuple(t.shape), shape))
    if y.is_cuda:
        for name, t in (("y", y), ("pred", pred)):
            if t.data_ptr() % 16:
                raise ValueError("%s: %s is not 16-byte aligned"
                                 % (fn, name))
    elif idx is not None and n and (
            int(idx.min()) < 0 or int(idx.max()) >= y.numel() // 256):
        # on the card an MB number outside the plane traps the launch
        raise IndexError("%s: idx outside the plane's %d MBs"
                         % (fn, y.numel() // 256))
    if qp_mb is not None and not y.is_cuda and n and (
            int(qp_mb.min()) < 0 or int(qp_mb.max()) > 51):
        raise ValueError("%s: a per-MB qp outside [0, 51]" % fn)


def luma_p_encode(y, pred, qp, idx=None, fz=None, lev: bool = True,
                  levels=None, tables=None, nr_offset=None):
    """Kernel B8 fused, replacing `dct_quant_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:175), the
    decimation of `luma_p_encode_fast` and `deq_idct_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:204).

    y [16 mbh, 16 mbw] int32 luma plane; pred [N, 16, 16] int32; idx
    [N] int32 raster MB numbers of the current MBs, or None for MB
    i % (mbh mbw); fz [N] bool, MBs that keep no residual, or None; lev
    False skips the levels; levels [N, 4(r), 4(c), 4(by), 4(bx)] int32,
    the quantized levels to start from (the trellis's; y and idx are
    then not read), or None; tables the `ops.cqm.QuantTables` whose inter
    class quantizes (None: flat); nr_offset [4, 4] int32 noise-reduction
    offsets, or None; qp an int or an int32 [N] tensor of per-MB qps.
    Returns (lev [N, 4, 4, 4, 4] int32 or None, rec [N,
    16, 16] int32, cbp_luma [N] int32), and with nr_offset also nr_sum
    [4, 4] int32."""
    grid = isinstance(qp, torch.Tensor)
    if not grid and not 0 <= qp <= 51:
        raise ValueError("luma_p_encode: qp %d outside [0, 51]" % qp)
    _check(y, pred, idx, fz, levels, nr_offset, qp if grid else None)
    if not y.is_cuda:
        return luma_p_encode_plain(y, pred, qp, idx, fz, lev, levels,
                                   tables, nr_offset)
    n = pred.shape[0]
    dev = y.device
    rec = torch.empty((n, 16, 16), dtype=_I32, device=dev)
    cbp = torch.empty((n,), dtype=_I32, device=dev)
    out = (torch.empty((n, 4, 4, 4, 4), dtype=_I32, device=dev)
           if lev else None)
    # zeroed on the launch's stream; the kernel adds into it
    nr_sum = (None if nr_offset is None
              else torch.zeros((4, 4), dtype=_I32, device=dev))
    if n == 0:
        return (out, rec, cbp) + (() if nr_sum is None else (nr_sum,))
    ptr = kernels.ptr
    fzp = None if fz is None else ptr(fz)
    outp = None if out is None else ptr(out)
    if grid:
        return _launch_grid(y, pred, qp, idx, fzp, outp, levels,
                            FLAT if tables is None else tables, nr_offset,
                            nr_sum, out, rec, cbp)
    # the inter tables' three [16] rows, each 64 bytes into the last
    base = (FLAT if tables is None else tables).qtab(qp, dev).data_ptr()
    mf, bias, dmf = (ctypes.c_void_p(base + 64 * i) for i in range(3))
    if levels is not None:
        fn = kernels.entry("pcamv_luma_p_recon",
                           [_VP] * 3 + [_CI, _VP, _CI] + [_VP] * 4)
        rc = fn(ptr(pred), ptr(levels), fzp, n, dmf, qp // 6 - 4, outp,
                ptr(rec), ptr(cbp), kernels.stream(y))
        kernels.check(rc, "pcamv_luma_p_recon")
        luma_p_encode.levels_launches += 1
        return out, rec, cbp
    fn = kernels.entry("pcamv_luma_p_encode",
                       [_VP] * 2 + [_CI] * 2 + [_VP] * 2 + [_CI]
                       + [_VP] * 3 + [_CI] + [_VP] * 6)
    rc = fn(ptr(y), ptr(pred), y.shape[1], y.numel() // 256,
            None if idx is None else ptr(idx), fzp, n, mf, bias, dmf,
            qp // 6 - 4, None if nr_sum is None else ptr(nr_offset),
            None if nr_sum is None else ptr(nr_sum), outp, ptr(rec),
            ptr(cbp), kernels.stream(y))
    kernels.check(rc, "pcamv_luma_p_encode")
    luma_p_encode.launches += 1
    if nr_sum is None:
        return out, rec, cbp
    luma_p_encode.nr_launches += 1
    return out, rec, cbp, nr_sum


def _launch_grid(y, pred, qp, idx, fzp, outp, levels, tables, nr_offset,
                 nr_sum, out, rec, cbp):
    """The per-MB qp instance of either entry (qp int32 [N] on the
    card)."""
    ptr = kernels.ptr
    n = pred.shape[0]
    slab = ptr(tables.qtab_all(y.device))
    if levels is not None:
        fn = kernels.entry("pcamv_luma_p_recon_grid",
                           [_VP] * 3 + [_CI] + [_VP] * 6)
        rc = fn(ptr(pred), ptr(levels), fzp, n, ptr(qp), slab, outp,
                ptr(rec), ptr(cbp), kernels.stream(y))
        kernels.check(rc, "pcamv_luma_p_recon_grid")
        luma_p_encode.levels_launches += 1
        luma_p_encode.grid_launches += 1
        return out, rec, cbp
    fn = kernels.entry("pcamv_luma_p_encode_grid",
                       [_VP] * 2 + [_CI] * 2 + [_VP] * 2 + [_CI]
                       + [_VP] * 8)
    rc = fn(ptr(y), ptr(pred), y.shape[1], y.numel() // 256,
            None if idx is None else ptr(idx), fzp, n, ptr(qp), slab,
            None if nr_sum is None else ptr(nr_offset),
            None if nr_sum is None else ptr(nr_sum), outp, ptr(rec),
            ptr(cbp), kernels.stream(y))
    kernels.check(rc, "pcamv_luma_p_encode_grid")
    luma_p_encode.launches += 1
    luma_p_encode.grid_launches += 1
    if nr_sum is None:
        return out, rec, cbp
    luma_p_encode.nr_launches += 1
    return out, rec, cbp, nr_sum


luma_p_encode.launches = 0
luma_p_encode.levels_launches = 0
luma_p_encode.nr_launches = 0
luma_p_encode.grid_launches = 0
