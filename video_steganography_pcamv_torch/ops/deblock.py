"""Kernel B5: the in-loop deblocker (spec 8.7).

`deblock_frame` replaces the TPU kernel `deblock_frame_pallas`
(video_steganography_pcamv_tpu/ops/deblock_pallas.py:469, run by `_run`
with the body from `_make_kernel`). On a CUDA tensor it launches the
hand-written kernel `csrc/deblock.cu`; on a CPU tensor it runs
`deblock_frame_plain`.

Both share `edge_params`, the plain-torch port of the reference's
per-MB parameter precompute (deblock_pallas.py:61): boundary strengths,
alpha/beta, tc0 and active masks per MB, edge and 4-line group, in the
reference's [n_mb, 128] row layout:
  0:8 alpha_l [dir*4+e] | 8:16 beta_l | 16:24 active_l | 24:26 strong
  [dir] | 32:64 bs_l [dir*16+e*4+g] | 64:96 tc0_l | 96:100 alpha_c
  [dir*2+ei] | 100:104 beta_c | 104:108 active_c | 108:124 tc0_c
  [dir*8+ei*4+g]   (dir 0 = vertical edges; ei 0/1 = edge 0/2)
The pixel filter then only does normative arithmetic with those scalars.

Order: MBs go in knight waves d = mx + 2*my (the order of the
reference's `deblock_jax.deblock_frame_device`): every MB a tile
touches was finished in an earlier wave, and the 20x20 tiles of one
wave are disjoint, so a wave is one parallel step and the result equals
the serial raster order. On the H100 the kernel is bound by launch and
latency (~mbw + 2*mbh waves, each a few dozen MBs), not by bytes (the
1080p planes are ~3 MB).
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


def _shift_right(x):
    """x[:, c-1] with zero fill at c = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _shift_down(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def edge_params(intra, skip, nnz4, mv4, qp: int, qpc: int, mbh: int,
                mbw: int, qp_thresh: int = 15, off_a: int = 0,
                off_b: int = 0, ref4=None, trans8=None) -> torch.Tensor:
    """Per-MB deblock parameters [mbh*mbw, 128] int32 (layout above).
    ref4 [4mbh, 4mbw] holds the L0 reference index of each 4x4 block
    (None: all 0, one reference); blocks that differ in it get bS 1.
    trans8 [mbh, mbw] marks the MBs coded with the 8x8 transform (None:
    none), whose inner luma edges 1 and 3 are no transform edges and
    stay off (the rule lives in these rows; the filter is unchanged)."""
    dev = nnz4.device
    ALPHA = const(ALPHA_TAB, dev)
    BETA = const(BETA_TAB, dev)
    TC0 = const(TC0_TAB, dev)
    qp_g = torch.full((mbh, mbw), qp, dtype=_I32, device=dev)
    qpc_g = torch.full((mbh, mbw), qpc, dtype=_I32, device=dev)
    intra_g = intra.to(_I32) > 0

    def grid4(x):
        return x.reshape(mbh, 4, mbw, 4).permute(0, 2, 1, 3)

    nnz4 = nnz4.to(_I32)
    mvx4, mvy4 = mv4[..., 0].to(_I32), mv4[..., 1].to(_I32)
    ref4 = torch.zeros_like(nnz4) if ref4 is None else ref4.to(_I32)
    maps = (nnz4, mvx4, mvy4, ref4)
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
                qn, qx, qy, qr = (t[..., e] for t in cur)
                pn, px, py, pr = (t[..., k] for t in src)
                nb_i = left_i
            else:
                qn, qx, qy, qr = (t[..., e, :] for t in cur)
                pn, px, py, pr = (t[..., k, :] for t in src)
                nb_i = top_i
            bs = torch.where((qn > 0) | (pn > 0), 2, 0)
            mvd = (((qx - px).abs() >= 4) | ((qy - py).abs() >= 4)
                   | (qr != pr))
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


def deblock_frame_plain(y, u, v, par, mbh: int, mbw: int):
    """Plain version: the knight-wavefront tile filter of the reference's
    deblock_jax.deblock_frame_device, fed by `edge_params` rows.
    y/u/v int32 MB-aligned planes; returns filtered uint8 planes."""
    dev = y.device
    yp = torch.nn.functional.pad(y.to(_I32), (PAD,) * 4)
    up = torch.nn.functional.pad(u.to(_I32), (PAD,) * 4)
    vp = torch.nn.functional.pad(v.to(_I32), (PAD,) * 4)
    r20 = torch.arange(20, device=dev)
    r12 = torch.arange(12, device=dev)
    for my, mx in waves(mbw, mbh, dev):
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
        for d in range(2):
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
        for d in range(2):
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
    H, W = y.shape
    Hc, Wc = u.shape
    return (yp[PAD:PAD + H, PAD:PAD + W].to(torch.uint8),
            up[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8),
            vp[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8))


def deblock_frame_cuda(y, u, v, par, mbh: int, mbw: int):
    """Launch the CUDA deblocker on int32 planes + edge_params rows.
    The outputs are allocated here (zero-bordered int32 copies the
    kernel filters in place); counted in `deblock_frame.launches`."""
    H, W = 16 * mbh, 16 * mbw
    for name, t, shape in (("y", y, (H, W)), ("u", u, (H // 2, W // 2)),
                           ("v", v, (H // 2, W // 2)),
                           ("par", par, (mbh * mbw, 128))):
        kernels.check_tensor("deblock_frame", name, t, _I32, shape)
    yp = torch.nn.functional.pad(y, (PAD,) * 4).contiguous()
    up = torch.nn.functional.pad(u, (PAD,) * 4).contiguous()
    vp = torch.nn.functional.pad(v, (PAD,) * 4).contiguous()
    fn = kernels.entry("pcamv_deblock_frame",
                       [kernels.VP] * 4 + [kernels.CI] * 2 + [kernels.VP])
    rc = fn(kernels.ptr(yp), kernels.ptr(up), kernels.ptr(vp),
            kernels.ptr(par), mbh, mbw, kernels.stream(y))
    kernels.check(rc, "pcamv_deblock_frame")
    deblock_frame.launches += 1
    Hc, Wc = H // 2, W // 2
    return (yp[PAD:PAD + H, PAD:PAD + W].to(torch.uint8),
            up[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8),
            vp[PAD:PAD + Hc, PAD:PAD + Wc].to(torch.uint8))


def deblock_frame(y, u, v, intra, skip, nnz4, mv4, qp: int, qpc: int,
                  mbh: int, mbw: int, qp_thresh: int = 15, off_a: int = 0,
                  off_b: int = 0, trans8=None):
    """Kernel B5, replacing the TPU kernel `deblock_frame_pallas`
    (video_steganography_pcamv_tpu/ops/deblock_pallas.py:469). On the
    H100 it is bound by launch latency (one grid per knight wave).

    The contract of the reference's deblock_frame_device: int32 planes +
    per-MB intra/skip (and trans8), per-4x4 nnz/mv -> uint8 planes. CPU
    tensors run the plain version; CUDA tensors launch the kernel;
    anything else raises."""
    par = edge_params(intra, skip, nnz4, mv4, qp, qpc, mbh, mbw,
                      qp_thresh=qp_thresh, off_a=off_a, off_b=off_b,
                      trans8=trans8)
    if y.device.type == "cpu":
        return deblock_frame_plain(y, u, v, par, mbh, mbw)
    return deblock_frame_cuda(y.to(_I32).contiguous(),
                              u.to(_I32).contiguous(),
                              v.to(_I32).contiguous(), par, mbh, mbw)


deblock_frame.launches = 0
