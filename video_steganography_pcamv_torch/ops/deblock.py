"""Kernel B5: the in-loop deblocker (spec 8.7).

`deblock_frame` replaces the TPU kernel `deblock_frame_pallas`
(video_steganography_pcamv_tpu/ops/deblock_pallas.py:469): the whole
function, its parameter precompute `edge_params` (:61), pads, wave loop
(`_run`, :449) and uint8 slices. On a CUDA tensor it launches the
hand-written kernel `csrc/deblock.cu` once a frame: one persistent CTA
per MB row computes the edge parameters itself and filters the uint8
planes in place (on a copy of the input planes), rows handing over to
each other through progress counters. On a CPU tensor it runs
`edge_params` and `deblock_frame_plain`, the kernel's oracle.

`edge_params` is the plain-torch port of the reference's per-MB
parameter precompute: boundary strengths, alpha/beta, tc0 and active
masks per MB, edge and 4-line group, in the reference's [n_mb, 128] row
layout:
  0:8 alpha_l [dir*4+e] | 8:16 beta_l | 16:24 active_l | 24:26 strong
  [dir] | 32:64 bs_l [dir*16+e*4+g] | 64:96 tc0_l | 96:100 alpha_c
  [dir*2+ei] | 100:104 beta_c | 104:108 active_c | 108:124 tc0_c
  [dir*8+ei*4+g]   (dir 0 = vertical edges; ei 0/1 = edge 0/2)
The pixel filter then only does normative arithmetic with those scalars.
The kernel computes the same rows (as bytes, in shared memory).

Order: the reference filters MBs in raster order; MB (mx, my) may run
once MB (mx+1, my-1) has, the knight dependency. The plain version
filters the knight waves d = mx + 2*my (the order of the reference's
`deblock_jax.deblock_frame_device`) with `filter_mbs`, which filters any
set of MBs whose tiles are disjoint; the kernel runs the rows
concurrently at half-MB grain: MB (mx, my)'s vertical edges after MB
(mx-1, my), its horizontal edges once row my-1 has finished MB mx and
the vertical edges of MB mx+1. Both give the raster-order result. On
the H100 the kernel is bound by the latency of its step chain, not by
bytes (the 1080p planes are ~3 MB).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from . import const
from .. import kernels
from ..encoder.intra import waves

_I32 = torch.int32
PAD = 4


def _parse_tables():
    """alpha/beta/tc0 tables from the port's copy of the C++ include
    (native/deblock_tables.inc)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "deblock_tables.inc")
    with open(path) as f:
        src = f.read()

    def arr(name):
        i = src.index(name)
        body = src[src.index("{", i):src.index(";", i)]
        return [int(x) for x in re.findall(r"-?\d+", body)]

    return (np.array(arr("ALPHA_TAB"), np.int32),
            np.array(arr("BETA_TAB"), np.int32),
            np.array(arr("TC0_TAB"), np.int32).reshape(76, 4))


ALPHA_TAB, BETA_TAB, TC0_TAB = _parse_tables()
# the kernel's copy: alpha [76] | beta [76] | tc0 [76][4]
_TABS = np.concatenate([ALPHA_TAB, BETA_TAB, TC0_TAB.reshape(-1)])


def _shift_right(x):
    """x[:, c-1] with zero fill at c = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _shift_down(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _qp_grid(q, mbh: int, mbw: int, dev) -> torch.Tensor:
    """A frame qp (int) or a per-MB map as an int32 [mbh, mbw] grid."""
    if isinstance(q, torch.Tensor):
        return q.to(dev, _I32).reshape(mbh, mbw)
    return torch.full((mbh, mbw), q, dtype=_I32, device=dev)


def edge_params(intra, skip, nnz4, mv4, qp, qpc, mbh: int,
                mbw: int, qp_thresh: int = 15, off_a: int = 0,
                off_b: int = 0, ref4=None, trans8=None, mv4_l1=None,
                ref4_l1=None) -> torch.Tensor:
    """Per-MB deblock parameters [mbh*mbw, 128] int32 (layout above).
    ref4 [4mbh, 4mbw] holds the L0 reference index of each 4x4 block
    (None: all 0, one reference); blocks that differ in it get bS 1.
    mv4_l1/ref4_l1 (a decoded B slice; the encoder deblocks no B slice)
    give the L1 motion, compared the same way, list by list (x264's
    frame.c:735-741).
    trans8 [mbh, mbw] marks the MBs coded with the 8x8 transform (None:
    none), whose inner luma edges 1 and 3 are no transform edges and
    stay off (the rule lives in these rows; the filter is unchanged).
    qp/qpc are the frame's, or under adaptive quantization int32 [mbh,
    mbw] maps (the decoder-visible chain): an MB edge averages the two
    MBs' qps, a missing neighbour reading 0, and the inner edges' low-qp
    gate reads the MB's own (the reference's deblock_pallas.py:77-120)."""
    dev = nnz4.device
    ALPHA = const(ALPHA_TAB, dev)
    BETA = const(BETA_TAB, dev)
    TC0 = const(TC0_TAB, dev)
    qp_g = _qp_grid(qp, mbh, mbw, dev)
    qpc_g = _qp_grid(qpc, mbh, mbw, dev)
    intra_g = intra.to(_I32) > 0

    def grid4(x):
        return x.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)

    nnz4 = nnz4.to(_I32)
    mvx4, mvy4 = mv4[..., 0].to(_I32), mv4[..., 1].to(_I32)
    ref4 = torch.zeros_like(nnz4) if ref4 is None else ref4.to(_I32)
    maps = (nnz4, mvx4, mvy4, ref4)
    if mv4_l1 is not None:
        maps += (mv4_l1[..., 0].to(_I32), mv4_l1[..., 1].to(_I32),
                 ref4_l1.to(_I32))
    cur = [grid4(t) for t in maps]
    left = [grid4(_shift_right(t)) for t in maps]
    top = [grid4(_shift_down(t)) for t in maps]

    cur_i = intra_g
    left_i = _shift_right(intra_g)
    top_i = _shift_down(intra_g)
    cur_skip = skip.to(_I32) > 0
    t8 = (torch.zeros_like(intra_g) if trans8 is None
          else trans8.to(_I32) > 0)
    eqp = [(_shift_right(qp_g) + qp_g + 1) >> 1,
           (_shift_down(qp_g) + qp_g + 1) >> 1]
    eqpc = [(_shift_right(qpc_g) + qpc_g + 1) >> 1,
            (_shift_down(qpc_g) + qpc_g + 1) >> 1]
    lowqp = qp_g <= qp_thresh
    mxg = torch.arange(mbw, device=dev)[None, :].expand(mbh, mbw)
    myg = torch.arange(mbh, device=dev)[:, None].expand(mbh, mbw)
    border = [mxg > 0, myg > 0]
    internal_on = ~cur_skip & ~lowqp

    par = torch.zeros((mbh, mbw, 128), dtype=_I32, device=dev)
    for d in range(2):
        for e in range(4):
            # q = the edge's own 4x4 column (d 0) / row (d 1); p = the one
            # before it, in the left / top MB for the MB edge e = 0
            src = (left if d == 0 else top) if e == 0 else cur
            k = 0 if e == 0 else e - 1
            if d == 0:
                q = [t[..., e] for t in cur]
                pp = [t[..., k] for t in src]
                nb_i = left_i
            else:
                q = [t[..., e, :] for t in cur]
                pp = [t[..., k, :] for t in src]
                nb_i = top_i
            bs = torch.where((q[0] > 0) | (pp[0] > 0), 2, 0)
            mvd = torch.zeros_like(bs, dtype=torch.bool)
            for j in range(1, len(maps), 3):   # L0, then L1 if given
                mvd |= (((q[j] - pp[j]).abs() >= 4)
                        | ((q[j + 1] - pp[j + 1]).abs() >= 4)
                        | (q[j + 2] != pp[j + 2]))
            bs = torch.where((bs == 0) & mvd, 1, bs)
            promote = cur_i | nb_i if e == 0 else cur_i
            bs = torch.where(promote[..., None], 3, bs).to(_I32)
            par[..., 32 + d * 16 + e * 4:36 + d * 16 + e * 4] = bs

            eq = eqp[d] if e == 0 else qp_g
            ia = (eq + off_a + 12).long()
            a_e = ALPHA[ia]
            b_e = BETA[(eq + off_b + 12).long()]
            gate = border[d] if e == 0 else internal_on
            act = gate & (a_e > 0) & (b_e > 0)
            par[..., d * 4 + e] = a_e
            par[..., 8 + d * 4 + e] = b_e
            par[..., 16 + d * 4 + e] = (act & ~t8 if e in (1, 3)
                                        else act).to(_I32)
            bsc = torch.clamp(bs, 0, 3).long()
            par[..., 64 + d * 16 + e * 4:68 + d * 16 + e * 4] = \
                TC0[ia[..., None], bsc]
            if e in (0, 2):
                ei = e // 2
                eqc = eqpc[d] if e == 0 else qpc_g
                iac = (eqc + off_a + 12).long()
                actc = gate & (a_e > 0) & (b_e > 0)
                par[..., 96 + d * 2 + ei] = ALPHA[iac]
                par[..., 100 + d * 2 + ei] = BETA[(eqc + off_b + 12).long()]
                par[..., 104 + d * 2 + ei] = actc.to(_I32)
                par[..., 108 + d * 8 + ei * 4:112 + d * 8 + ei * 4] = \
                    TC0[iac[..., None], bsc]
    par[..., 24] = (cur_i | left_i).to(_I32)
    par[..., 25] = (cur_i | top_i).to(_I32)
    return par.reshape(mbh * mbw, 128)


def _luma_lines(s, a, b, tc0, bs, strong, active):
    """One luma edge over [W, L] lines; s = p3..q3. Returns p2..q2."""
    p3, p2, p1, p0, q0, q1, q2, q3 = s
    base = (((p0 - q0).abs() < a) & ((p1 - p0).abs() < b)
            & ((q1 - q0).abs() < b) & active)
    nf = base & (bs > 0) & ~strong
    ap = (p2 - p0).abs() < b
    aq = (q2 - q0).abs() < b
    tc = tc0 + ap.to(_I32) + aq.to(_I32)
    avg = (p0 + q0 + 1) >> 1
    p1n = p1 + torch.maximum(-tc0, torch.minimum(((p2 + avg) >> 1) - p1, tc0))
    q1n = q1 + torch.maximum(-tc0, torch.minimum(((q2 + avg) >> 1) - q1, tc0))
    delta = torch.maximum(-tc, torch.minimum(
        (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc))
    p0_n = torch.clamp(p0 + delta, 0, 255)
    q0_n = torch.clamp(q0 - delta, 0, 255)

    sf = base & strong
    lum = (p0 - q0).abs() < ((a >> 2) + 2)
    sp = lum & ap
    sq = lum & aq
    p0_s3 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    p1_s = (p2 + p1 + p0 + q0 + 2) >> 2
    p2_s = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    p0_w = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s3 = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
    q1_s = (p0 + q0 + q1 + q2 + 2) >> 2
    q2_s = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    q0_w = (2 * q1 + q0 + p1 + 2) >> 2
    w = torch.where
    return (w(sf & sp, p2_s, p2),
            w(sf & sp, p1_s, w(nf & ap, p1n, p1)),
            w(sf, w(sp, p0_s3, p0_w), w(nf, p0_n, p0)),
            w(sf, w(sq, q0_s3, q0_w), w(nf, q0_n, q0)),
            w(sf & sq, q1_s, w(nf & aq, q1n, q1)),
            w(sf & sq, q2_s, q2))


def _chroma_lines(s, a, b, tc0, bs, strong, active):
    p1, p0, q0, q1 = s
    base = (((p0 - q0).abs() < a) & ((p1 - p0).abs() < b)
            & ((q1 - q0).abs() < b) & active)
    nf = base & (bs > 0) & ~strong
    tc = tc0 + 1
    delta = torch.maximum(-tc, torch.minimum(
        (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, tc))
    sf = base & strong
    w = torch.where
    return (w(sf, (2 * p1 + p0 + q1 + 2) >> 2,
              w(nf, torch.clamp(p0 + delta, 0, 255), p0)),
            w(sf, (2 * q1 + q0 + p1 + 2) >> 2,
              w(nf, torch.clamp(q0 - delta, 0, 255), q0)))


def pad_planes(y, u, v):
    """int32 copies of the planes with a PAD-pixel zero border, the
    layout `filter_mbs` works in."""
    return tuple(torch.nn.functional.pad(p.to(_I32), (PAD,) * 4)
                 for p in (y, u, v))


def unpad_planes(planes, shape_y, shape_c):
    """The uint8 frame planes of `pad_planes` output."""
    (H, W), (Hc, Wc) = shape_y, shape_c
    yp, up, vp = planes
    return (yp[PAD:PAD + H, PAD:PAD + W].to(torch.uint8),
            up[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8),
            vp[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8))


def filter_mbs(planes, par, my, mx, mbw: int, dirs=(0, 1)):
    """Filter the MBs (my, mx) [W] long in place in the padded planes,
    each on its 20x20 luma / 12x12 chroma tile with its `edge_params`
    row: the vertical edges (dir 0), then the horizontal ones (dir 1), of
    `dirs`. The tiles must be disjoint and every MB a tile reaches that
    comes earlier in raster order filtered: the knight waves, or one MB
    at a time in any order that keeps the row above min(mx+2, mbw) MBs
    ahead (or, per direction, the CUDA kernel's half-MB rule)."""
    yp, up, vp = planes
    dev = yp.device
    r20 = torch.arange(20, device=dev)
    r12 = torch.arange(12, device=dev)
    rows = (16 * my)[:, None] + r20
    cols = (16 * mx)[:, None] + r20
    crows = (8 * my)[:, None] + r12
    ccols = (8 * mx)[:, None] + r12
    tile = yp[rows[:, :, None], cols[:, None, :]]
    tu = up[crows[:, :, None], ccols[:, None, :]]
    tv = vp[crows[:, :, None], ccols[:, None, :]]
    pr = par[my * mbw + mx]                           # [W,128]

    def sc(i):
        return pr[:, i:i + 1]

    def vec(lo, rep):
        return pr[:, lo:lo + 4].repeat_interleave(rep, 1)

    zero = torch.zeros_like(sc(0), dtype=torch.bool)
    for d in dirs:
        for e in range(4):
            pos = 4 + 4 * e
            strong = (sc(24 + d) > 0) if e == 0 else zero
            args = (sc(d * 4 + e), sc(8 + d * 4 + e),
                    vec(64 + d * 16 + e * 4, 4), vec(32 + d * 16 + e * 4, 4),
                    strong, sc(16 + d * 4 + e) > 0)
            if d == 0:
                s = [tile[:, 4:20, pos + k] for k in range(-4, 4)]
                outs = _luma_lines(s, *args)
                for k, o in enumerate(outs):
                    tile[:, 4:20, pos - 3 + k] = o
            else:
                s = [tile[:, pos + k, 4:20] for k in range(-4, 4)]
                outs = _luma_lines(s, *args)
                for k, o in enumerate(outs):
                    tile[:, pos - 3 + k, 4:20] = o
    for d in dirs:
        for ei, e in enumerate((0, 2)):
            pos = 4 + 2 * e
            strong = (sc(24 + d) > 0) if e == 0 else zero
            args = (sc(96 + d * 2 + ei), sc(100 + d * 2 + ei),
                    vec(108 + d * 8 + ei * 4, 2),
                    vec(32 + d * 16 + e * 4, 2), strong,
                    sc(104 + d * 2 + ei) > 0)
            for t in (tu, tv):
                if d == 0:
                    s = [t[:, 4:12, pos + k] for k in range(-2, 2)]
                    p0o, q0o = _chroma_lines(s, *args)
                    t[:, 4:12, pos - 1] = p0o
                    t[:, 4:12, pos] = q0o
                else:
                    s = [t[:, pos + k, 4:12] for k in range(-2, 2)]
                    p0o, q0o = _chroma_lines(s, *args)
                    t[:, pos - 1, 4:12] = p0o
                    t[:, pos, 4:12] = q0o
    yp[rows[:, :, None], cols[:, None, :]] = tile
    up[crows[:, :, None], ccols[:, None, :]] = tu
    vp[crows[:, :, None], ccols[:, None, :]] = tv


def deblock_frame_plain(y, u, v, par, mbh: int, mbw: int):
    """Plain version: the knight-wavefront tile filter of the reference's
    deblock_jax.deblock_frame_device, fed by `edge_params` rows.
    y/u/v MB-aligned planes (uint8 or int32); returns filtered uint8
    planes."""
    planes = pad_planes(y, u, v)
    for my, mx in waves(mbw, mbh, y.device):
        filter_mbs(planes, par, my, mx, mbw)
    return unpad_planes(planes, y.shape, u.shape)


def _map(name, t, shape):
    """A per-MB / per-4x4 map as the kernel reads it: int32, contiguous."""
    t = t.to(_I32).contiguous()
    kernels.check_tensor("deblock_frame", name, t, _I32, shape)
    return t


def deblock_frame_cuda(y, u, v, intra, skip, nnz4, mv4, qp, qpc,
                       mbh: int, mbw: int, qp_thresh: int = 15,
                       off_a: int = 0, off_b: int = 0, trans8=None,
                       ref4=None):
    """One launch of the CUDA deblocker: edge parameters and filter, on
    uint8 copies of the planes (one device-to-device copy each, inside
    the launch call). qp/qpc ints, or int32 [mbh, mbw] maps (the kernel
    traps on a value outside [0, 51]). Counted in
    `deblock_frame.launches` (with maps also `deblock_frame.map_launches`)."""
    H, W = 16 * mbh, 16 * mbw
    maps_in = isinstance(qp, torch.Tensor)
    if isinstance(qpc, torch.Tensor) != maps_in:
        raise TypeError("deblock_frame: qp and qpc must both be maps or "
                        "both ints")
    qs = (0, 0) if maps_in else (qp, qpc)
    if not (0 <= qs[0] <= 51 and 0 <= qs[1] <= 51 and -12 <= off_a <= 12
            and -12 <= off_b <= 12):
        raise ValueError("deblock_frame: qp %d / qpc %d / offsets %d, %d "
                         "outside the spec tables" % (qs + (off_a, off_b)))
    src = []
    for name, t, shape in (("y", y, (H, W)), ("u", u, (H // 2, W // 2)),
                           ("v", v, (H // 2, W // 2))):
        t = t.to(torch.uint8).contiguous()
        kernels.check_tensor("deblock_frame", name, t, torch.uint8, shape)
        src.append(t)
    maps = [_map("intra", intra, (mbh, mbw)), _map("skip", skip, (mbh, mbw)),
            None if trans8 is None else _map("trans8", trans8, (mbh, mbw)),
            _map("nnz4", nnz4, (4 * mbh, 4 * mbw)),
            _map("mv4", mv4, (4 * mbh, 4 * mbw, 2)),
            None if ref4 is None else _map("ref4", ref4, (4 * mbh, 4 * mbw)),
            _map("qp", qp, (mbh, mbw)) if maps_in else None,
            _map("qpc", qpc, (mbh, mbw)) if maps_in else None]
    dev = y.device
    out = [torch.empty_like(t) for t in src]
    # the row ticket, then the luma and the chroma progress counters
    sync = torch.empty((2 * mbh + 1,), dtype=_I32, device=dev)
    fn = kernels.entry("pcamv_deblock_frame",
                       [kernels.VP] * 15 + [kernels.CI] * 7 + [kernels.VP] * 2)
    ptr = kernels.ptr
    rc = fn(*(ptr(t) for t in src + out),
            *(None if m is None else ptr(m) for m in maps),
            ptr(const(_TABS, dev)), qs[0], qs[1], qp_thresh, off_a, off_b,
            mbh, mbw, ptr(sync), kernels.stream(y))
    kernels.check(rc, "pcamv_deblock_frame")
    deblock_frame.launches += 1
    deblock_frame.map_launches += int(maps_in)
    return tuple(out)


def resident_ctas(mbw: int) -> int:
    """How many CTAs of the CUDA deblocker the current card holds at once
    for a row of mbw MBs (a frame with more MB rows starts some rows only
    after others have finished)."""
    fn = kernels.entry("pcamv_deblock_resident_ctas", [kernels.CI])
    n = fn(mbw)
    if n <= 0:
        raise RuntimeError("pcamv_deblock_resident_ctas failed")
    return n


def deblock_frame(y, u, v, intra, skip, nnz4, mv4, qp, qpc,
                  mbh: int, mbw: int, qp_thresh: int = 15, off_a: int = 0,
                  off_b: int = 0, trans8=None, ref4=None):
    """Kernel B5, replacing the TPU kernel `deblock_frame_pallas`
    (video_steganography_pcamv_tpu/ops/deblock_pallas.py:469). On the
    H100 it is one launch a frame, bound by the latency of its
    mbw + 2(mbh-1) step chain.

    The contract of the reference's deblock_frame_device: planes (uint8
    or int32, MB-aligned) + per-MB intra/skip (and trans8), per-4x4
    nnz/mv (and ref4, the L0 reference index of each 4x4 block on the
    multi-reference path: None is all 0), the frame's qp/qpc or per-MB
    int32 [mbh, mbw] maps (adaptive quantization) -> new uint8 planes
    (the inputs are left as they are). CPU
    tensors run `edge_params` + the plain version; CUDA tensors launch
    the kernel; anything else raises."""
    if y.device.type == "cpu":
        par = edge_params(intra, skip, nnz4, mv4, qp, qpc, mbh, mbw,
                          qp_thresh=qp_thresh, off_a=off_a, off_b=off_b,
                          ref4=ref4, trans8=trans8)
        return deblock_frame_plain(y, u, v, par, mbh, mbw)
    return deblock_frame_cuda(y, u, v, intra, skip, nnz4, mv4, qp, qpc, mbh,
                              mbw, qp_thresh=qp_thresh, off_a=off_a,
                              off_b=off_b, trans8=trans8, ref4=ref4)


deblock_frame.launches = 0
deblock_frame.map_launches = 0
