"""Kernels B1 and B6: full-pel motion search.

B1: `fullpel_parts` replaces the TPU kernel `fullpel_parts_pallas`
(video_steganography_pcamv_tpu/ops/pallas_kernels.py:435). On a CUDA
tensor it launches the hand-written kernel `csrc/fullpel.cu`; on a CPU
tensor it runs `fullpel_search_parts`, the plain PyTorch port of the
reference's `encoder/partition.py:fullpel_search_parts`, which is also
the kernel's oracle.

Both take the full-pel MV predictor as an input, so the one kernel
serves the reference's CPU branch (predictor `prev_mv >> 2`) and its
TPU branch (zero predictor). The kernel takes the reference plane as
uint8 and packs the int32 current frame to bytes while loading it; on
the H100 it is bound by SIMD byte-SAD work (~2.3 G absolute differences
a 1080p frame at rng 16, four to an instruction); device-memory traffic
is ~3.4 KB per MB.

Output (both paths): the reference's `st` dict — c16 [mbh,mbw],
mv16 [mbh,mbw,2], c16x8/mv16x8 [mbh,mbw,2(,2)], c8x16/mv8x16,
c8 [mbh,mbw,4], mv8 [mbh,mbw,4,2]; MVs are full-pel (x, y).

B1's sub-unit instance: `fullpel_sub` serves the sub-8x8 analysis'
search, the reference's plain-jnp `fullpel_search_sub`
(video_steganography_pcamv_tpu/encoder/partition.py:896; no TPU kernel
there). Its kernel is a second kernel of `csrc/fullpel.cu` on B1's
method (it shares B1's staging of the MB and the window and its
two-level minimum as device helpers) that keeps the sixteen 4x4 SADs of
every displacement and 41 running minima: B1's 9 units, then per 8x8
block two 8x4, two 4x8 and four 4x4. Its plain version,
`fullpel_search_sub`, is the CPU path and the kernel's oracle.
Output: B1's `st` dict plus c84/mv84 and c48/mv48 [mbh,mbw,4,2(,2)] and
c44/mv44 [mbh,mbw,4,4(,2)] (8x8 block and sub-unit in z-order).

B6: `fullpel_search16` replaces the TPU kernel `fullpel_search_pallas`
(pallas_kernels.py:549), the 16x16-only search of the unpartitioned P
path against a zero predictor. Its kernel is the 16x16 instance of the
same CUDA template (`csrc/fullpel.cu`, one running minimum instead of
nine); its plain version is `encoder/me.py:fullpel_search`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import mc
from .. import kernels
from ..encoder.me import fullpel_search, mv_bits_table
from ..ops.blocks import to_blocks

_I32 = torch.int32
BIG = 1 << 30

# unit order of the kernel's 9 outputs: 16x16; 16x8 T/B; 8x16 L/R;
# 8x8 in z-order
_UNIT_KEYS = (("c16", "mv16", 0, 1), ("c16x8", "mv16x8", 1, 2),
              ("c8x16", "mv8x16", 3, 2), ("c8", "mv8", 5, 4))
# the sub-unit instance's 32 more: per 8x8 block (z-order) 8x4 top/bottom,
# 4x8 left/right, 4x4 in z-order
_SUB_KEYS = (("c84", "mv84", 9, 8), ("c48", "mv48", 17, 8),
             ("c44", "mv44", 25, 16))
SUB_UNITS = 41


def bits_table(rng: int) -> np.ndarray:
    """The reference's se(v) bit-size table for a +-rng scan."""
    return mv_bits_table(4 * (rng + 64))


@functools.lru_cache(maxsize=None)
def max_lam(rng: int) -> int:
    """The largest lam whose costs (a 16x16 SAD of at most 65280 plus
    lam times two table entries) stay below 2^20."""
    return ((1 << 20) - 1 - 256 * 255) // (2 * int(bits_table(rng).max()))


def fullpel_search_parts(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int,
                         mbw: int, lam: int = 1) -> dict:
    """Plain version: a loop over the (2rng+1)^2 displacements in
    dy-outer, dx-inner order with strict-< running minima."""
    dev = cur_y.device
    h, w = 16 * mbh, 16 * mbw
    bits_t = _bits_on(dev, rng)
    off = 4 * (rng + 64)
    nb = bits_t.shape[0]
    pmx = pred_mv_fp[..., 0]
    pmy = pred_mv_fp[..., 1]

    def full(*shape):
        return torch.full((mbh, mbw) + shape, BIG, dtype=_I32, device=dev)

    def zeros(*shape):
        return torch.zeros((mbh, mbw) + shape, dtype=_I32, device=dev)

    st = dict(c16=full(), mv16=zeros(2), c16x8=full(2), mv16x8=zeros(2, 2),
              c8x16=full(2), mv8x16=zeros(2, 2), c8=full(4),
              mv8=zeros(4, 2))

    def upd(ck, mk, cost, mv_i):
        better = cost < st[ck]
        st[ck] = torch.where(better, cost, st[ck])
        st[mk] = torch.where(better[..., None], mv_i, st[mk])

    side = 2 * rng + 1
    grid = np.stack(np.meshgrid(np.arange(-rng, rng + 1),
                                np.arange(-rng, rng + 1),
                                indexing="xy"), -1).reshape(-1, 2)
    mvs = torch.as_tensor(grid, device=dev).to(_I32)   # (dx, dy) rows
    for i in range(side * side):
        dy, dx = i // side - rng, i % side - rng
        win = ref_fp[mc.PAD + dy:mc.PAD + dy + h,
                     mc.PAD + dx:mc.PAD + dx + w]
        sad8 = to_blocks(torch.abs(cur_y - win), 8).sum((-4, -3),
                                                       dtype=_I32)
        q = sad8.reshape(mbh, 2, mbw, 2).permute(0, 2, 1, 3)
        ix = torch.clamp(4 * dx - 4 * pmx + off, 0, nb - 1).long()
        iy = torch.clamp(4 * dy - 4 * pmy + off, 0, nb - 1).long()
        mvc = (bits_t[ix] + bits_t[iy]) * lam
        mv_i = mvs[i]
        upd("c16", "mv16", q.sum((2, 3), dtype=_I32) + mvc, mv_i)
        upd("c16x8", "mv16x8", q.sum(3, dtype=_I32) + mvc[..., None],
            mv_i)
        upd("c8x16", "mv8x16", q.sum(2, dtype=_I32) + mvc[..., None],
            mv_i)
        upd("c8", "mv8", q.reshape(mbh, mbw, 4) + mvc[..., None], mv_i)
    return st


def fullpel_search_sub(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int,
                       mbw: int, lam: int = 1) -> dict:
    """Plain version of the sub-unit instance, the reference's
    `fullpel_search_sub`: per displacement (dy-outer, dx-inner) the
    sixteen 4x4 SADs of every MB, the 41 unit costs against the MB's
    predictor and strict-< running minima."""
    dev = cur_y.device
    h, w = 16 * mbh, 16 * mbw
    bits_t = _bits_on(dev, rng)
    off = 4 * (rng + 64)
    nb = bits_t.shape[0]
    pmx = pred_mv_fp[..., 0]
    pmy = pred_mv_fp[..., 1]
    shapes = dict(c16=(), c16x8=(2,), c8x16=(2,), c8=(4,), c84=(4, 2),
                  c48=(4, 2), c44=(4, 4))
    st = {}
    for ck, sh in shapes.items():
        st[ck] = torch.full((mbh, mbw) + sh, BIG, dtype=_I32, device=dev)
        st["mv" + ck[1:]] = torch.zeros((mbh, mbw) + sh + (2,), dtype=_I32,
                                        device=dev)

    def upd(ck, cost, mv_i):
        mk = "mv" + ck[1:]
        better = cost < st[ck]
        st[ck] = torch.where(better, cost, st[ck])
        st[mk] = torch.where(better[..., None], mv_i, st[mk])

    side = 2 * rng + 1
    grid = np.stack(np.meshgrid(np.arange(-rng, rng + 1),
                                np.arange(-rng, rng + 1),
                                indexing="xy"), -1).reshape(-1, 2)
    mvs = torch.as_tensor(grid, device=dev).to(_I32)   # (dx, dy) rows
    for i in range(side * side):
        dy, dx = i // side - rng, i % side - rng
        win = ref_fp[mc.PAD + dy:mc.PAD + dy + h,
                     mc.PAD + dx:mc.PAD + dx + w]
        sad4 = to_blocks(torch.abs(cur_y - win), 4).sum((-4, -3),
                                                       dtype=_I32)
        # [mbh, mbw, 4 (8x8 z), 4 (4x4 z)]
        q4 = sad4.reshape(mbh, 2, 2, mbw, 2, 2).permute(0, 3, 1, 4, 2, 5) \
            .reshape(mbh, mbw, 4, 4)
        q8 = q4.sum(-1, dtype=_I32)
        ix = torch.clamp(4 * dx - 4 * pmx + off, 0, nb - 1).long()
        iy = torch.clamp(4 * dy - 4 * pmy + off, 0, nb - 1).long()
        mvc = (bits_t[ix] + bits_t[iy]) * lam
        mv_i = mvs[i]
        qz = q8.reshape(mbh, mbw, 2, 2)
        m1 = mvc[..., None, None]
        upd("c16", q8.sum(-1, dtype=_I32) + mvc, mv_i)
        upd("c16x8", qz.sum(3, dtype=_I32) + mvc[..., None], mv_i)
        upd("c8x16", qz.sum(2, dtype=_I32) + mvc[..., None], mv_i)
        upd("c8", q8 + mvc[..., None], mv_i)
        upd("c84", q4[..., [0, 2]] + q4[..., [1, 3]] + m1, mv_i)
        upd("c48", q4[..., [0, 1]] + q4[..., [2, 3]] + m1, mv_i)
        upd("c44", q4 + m1, mv_i)
    return st


def units_to_st(cost9: torch.Tensor, idx9: torch.Tensor, rng: int) -> dict:
    """[mbh,mbw,9] (cost, dy-outer scan index) -> the `st` dict; with
    the sub-unit instance's [mbh,mbw,41] also c84/c48/c44 and their
    MVs."""
    side = 2 * rng + 1
    dy = torch.div(idx9, side, rounding_mode="floor") - rng
    dx = idx9 % side - rng
    mv9 = torch.stack([dx, dy], dim=-1).to(_I32)
    st = {}
    for ck, mk, lo, cnt in _UNIT_KEYS + (_SUB_KEYS if cost9.shape[-1] > 9
                                         else ()):
        if cnt == 1:
            st[ck] = cost9[..., lo]
            st[mk] = mv9[..., lo, :]
        else:
            sh = cost9.shape[:2] + ((4, cnt // 4) if cnt > 4 else (cnt,))
            st[ck] = cost9[..., lo:lo + cnt].reshape(sh)
            st[mk] = mv9[..., lo:lo + cnt, :].reshape(sh + (2,))
    return st


def _check_inputs(fn: str, cur_y, ref_fp, rng: int, mbh: int, mbw: int,
                  lam: int):
    """The kernels' input contract, held on every device: cur_y int32
    (8-bit samples), ref_fp uint8, 0 <= rng <= PAD, and a lam that keeps
    every cost below 2^20 (the kernel's 32-bit (cost, scan index) key);
    on CUDA also the shapes, contiguity and 16-byte aligned data."""
    if cur_y.dtype != _I32 or ref_fp.dtype != torch.uint8:
        raise TypeError("%s: cur_y %s / ref_fp %s, expected int32 / uint8"
                        % (fn, cur_y.dtype, ref_fp.dtype))
    if not 0 <= rng <= mc.PAD:
        raise ValueError("%s: rng %d outside [0, %d]" % (fn, rng, mc.PAD))
    if not 0 <= lam <= max_lam(rng):
        raise ValueError("%s: lam %d outside [0, %d]" % (fn, lam,
                                                         max_lam(rng)))
    if cur_y.device.type == "cpu":
        return
    h, w = 16 * mbh, 16 * mbw
    kernels.check_tensor(fn, "cur_y", cur_y, _I32, (h, w))
    kernels.check_tensor(fn, "ref_fp", ref_fp, torch.uint8,
                         (h + 2 * mc.PAD, w + 2 * mc.PAD))
    for name, t in (("cur_y", cur_y), ("ref_fp", ref_fp)):
        if t.data_ptr() % 16:
            raise ValueError("%s: %s is not 16-byte aligned" % (fn, name))


def fullpel_parts(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int, mbw: int,
                  lam: int = 1) -> dict:
    """Kernel B1, replacing the TPU kernel `fullpel_parts_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:435). On the
    H100 it is bound by SIMD byte-SAD work.

    cur_y [16mbh,16mbw] int32 (8-bit samples); ref_fp the PAD-padded
    full-pel plane, uint8; pred_mv_fp [mbh,mbw,2] int32 full-pel
    predictor; 0 <= rng <= PAD; 0 <= lam <= max_lam(rng). CPU tensors
    run the plain version; CUDA tensors launch the kernel (counted in
    `fullpel_parts.launches`) into outputs allocated here; anything else
    raises."""
    _check_inputs("fullpel_parts", cur_y, ref_fp, rng, mbh, mbw, lam)
    if cur_y.device.type == "cpu":
        return fullpel_search_parts(cur_y, ref_fp, pred_mv_fp, rng, mbh,
                                    mbw, lam)
    w = 16 * mbw
    kernels.check_tensor("fullpel_parts", "pred_mv_fp", pred_mv_fp, _I32,
                         (mbh, mbw, 2))
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_fullpel_parts",
                       [VP, CI, VP, CI, VP, VP] + [CI] * 5 + [VP] * 3)
    bits_t = _bits_on(cur_y.device, rng)
    cost9 = torch.empty((mbh, mbw, 9), dtype=_I32, device=cur_y.device)
    idx9 = torch.empty((mbh, mbw, 9), dtype=_I32, device=cur_y.device)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), w, ptr(ref_fp), w + 2 * mc.PAD, ptr(pred_mv_fp),
            ptr(bits_t), bits_t.shape[0], rng, int(lam), mbh, mbw,
            ptr(cost9), ptr(idx9), kernels.stream(cur_y))
    kernels.check(rc, "pcamv_fullpel_parts")
    fullpel_parts.launches += 1
    return units_to_st(cost9, idx9, rng)


fullpel_parts.launches = 0


def fullpel_sub(cur_y, ref_fp, pred_mv_fp, rng: int, mbh: int, mbw: int,
                lam: int = 1) -> dict:
    """B1's sub-unit instance (csrc/fullpel.cu, `pcamv_fullpel_sub`),
    serving the reference's plain-jnp `fullpel_search_sub`
    (video_steganography_pcamv_tpu/encoder/partition.py:896). The
    contract is `fullpel_parts`'; CPU tensors run `fullpel_search_sub`,
    CUDA tensors launch the kernel (counted in `fullpel_sub.launches`)."""
    _check_inputs("fullpel_sub", cur_y, ref_fp, rng, mbh, mbw, lam)
    if cur_y.device.type == "cpu":
        return fullpel_search_sub(cur_y, ref_fp, pred_mv_fp, rng, mbh,
                                  mbw, lam)
    w = 16 * mbw
    kernels.check_tensor("fullpel_sub", "pred_mv_fp", pred_mv_fp, _I32,
                         (mbh, mbw, 2))
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_fullpel_sub",
                       [VP, CI, VP, CI, VP, VP] + [CI] * 5 + [VP] * 3)
    bits_t = _bits_on(cur_y.device, rng)
    shape = (mbh, mbw, SUB_UNITS)
    cost = torch.empty(shape, dtype=_I32, device=cur_y.device)
    idx = torch.empty(shape, dtype=_I32, device=cur_y.device)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), w, ptr(ref_fp), w + 2 * mc.PAD, ptr(pred_mv_fp),
            ptr(bits_t), bits_t.shape[0], rng, int(lam), mbh, mbw,
            ptr(cost), ptr(idx), kernels.stream(cur_y))
    kernels.check(rc, "pcamv_fullpel_sub")
    fullpel_sub.launches += 1
    return units_to_st(cost, idx, rng)


fullpel_sub.launches = 0


def fullpel_search16(cur_y, ref_fp, rng: int, mbh: int, mbw: int,
                     lam: int = 1):
    """Kernel B6, replacing the TPU kernel `fullpel_search_pallas`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:549): the
    exhaustive +-rng 16x16 SAD search, cost = SAD + lam * (bits(se(4dx))
    + bits(se(4dy))) against a zero predictor, first strict-< minimum in
    dy-outer, dx-inner order. On the H100 it is bound by SIMD byte-SAD
    work, like B1.

    cur_y [16mbh,16mbw] int32 (8-bit samples); ref_fp the PAD-padded
    full-pel plane, uint8; 0 <= rng <= PAD; 0 <= lam <= max_lam(rng).
    Returns (mv [mbh,mbw,2] int32 full-pel (x, y), cost [mbh,mbw]
    int32). CPU tensors run the plain `fullpel_search`; CUDA tensors
    launch the kernel (counted in `fullpel_search16.launches`)."""
    _check_inputs("fullpel_search16", cur_y, ref_fp, rng, mbh, mbw, lam)
    if cur_y.device.type == "cpu":
        zero = torch.zeros((mbh, mbw, 2), dtype=_I32)
        return fullpel_search(cur_y, ref_fp, zero, rng, mbh, mbw, lam)
    w = 16 * mbw
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_fullpel_search16",
                       [VP, CI, VP, CI, VP] + [CI] * 5 + [VP] * 3)
    bits_t = _bits_on(cur_y.device, rng)
    mv = torch.empty((mbh, mbw, 2), dtype=_I32, device=cur_y.device)
    cost = torch.empty((mbh, mbw), dtype=_I32, device=cur_y.device)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), w, ptr(ref_fp), w + 2 * mc.PAD, ptr(bits_t),
            bits_t.shape[0], rng, int(lam), mbh, mbw, ptr(mv), ptr(cost),
            kernels.stream(cur_y))
    kernels.check(rc, "pcamv_fullpel_search16")
    fullpel_search16.launches += 1
    return mv, cost


fullpel_search16.launches = 0

_BITS: dict = {}


def _bits_on(device, rng: int) -> torch.Tensor:
    key = (str(device), rng)
    if key not in _BITS:
        _BITS[key] = torch.as_tensor(bits_table(rng), device=device) \
            .to(_I32).contiguous()
    return _BITS[key]
