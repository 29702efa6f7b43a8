"""P-frame partition analysis + fused stego stage 1 (port of the serving
subset of encoder/partition.py).

One exhaustive full-pel scan (kernel B1) gives every partition unit's
best MV; the partition decision is a 4-way argmin with the mb_type
header-bit terms. Per 8x8 block, a 16x16 window of the four hpel planes
around its full-pel MV yields all 169 qpel offsets in [-6, 6]^2 as
static slice-averages, and SATD against any of them uses the
WHT-linearity trick (`ops/probe.py`).

`p_stage1_stego` runs one path on every device: B1 -> partition decision
-> window fetch (kernel B9) -> the analyse tail, kernels B2 -> B3 -> B4
on a CUDA tensor and their plain versions on a CPU one
(`ops.probe.analyse_tail`). The reference's two P-analysis branches
differ, for this slice, only in B1's MV predictor: zero on its
accelerator branch, prev_mv >> 2 on its CPU branch. The reference ties
that choice to its backend (`use_pallas`); the port maps it onto
`tail_kernel` (True: zero), so that either stream is served on either
device. The accelerator branch's bounded one-hot window fetch and MC
(`gather_windows8_mm`, `mv_bound`) are the TPU's gather workaround and
bit-exact to the gather for |mv| <= rng: the port fetches the windows
with B9 and keeps the gather MC.

Block index convention per MB: 8x8 blocks b in {0: TL, 1: TR, 2: BL,
3: BR} (z-order).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import const
from ..ops import mc
from ..ops import probe as PR
from ..ops.fullpel import fullpel_parts
from ..stego.cost import D_MV, D_NB, rca_decide
from . import inter as INTER
from . import qpel_table as QT
from .scan_device import scan_p_device

_I32 = torch.int32

D_16x16, D_16x8, D_8x16, D_8x8 = 0, 1, 2, 3
_HDR_BITS = np.array([1, 3, 3, 9], np.int32)
UNIT_BLOCKS = {
    D_16x16: [(0, 1, 2, 3)],
    D_16x8: [(0, 1), (2, 3)],
    D_8x16: [(0, 2), (1, 3)],
    D_8x8: [(0,), (1,), (2,), (3,)],
}
N_UNITS = np.array([1, 2, 2, 4], np.int32)
BLOCK_UNIT = np.array([[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1],
                       [0, 1, 2, 3]], np.int32)


def decide_partition(st: dict, mbh: int, mbw: int, lam: int = 1):
    """4-way partition decision from the full-pel unit costs plus header
    lambda terms. Returns (part [mbh,mbw] int32, mvfp8 [2mbh,2mbw,2])."""
    hdr = _HDR_BITS
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        st["c8"].sum(-1, dtype=_I32) + lam * int(hdr[3]),
    ])
    part = torch.argmin(tot, dim=0)
    mv_by_part = torch.stack([
        st["mv16"][:, :, None, :].expand(mbh, mbw, 4, 2),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])
    mv8 = torch.gather(mv_by_part, 0,
                       part[None, :, :, None, None].expand(1, mbh, mbw, 4, 2)
                       )[0]
    mvsp = mv8.reshape(mbh, mbw, 2, 2, 2).permute(0, 2, 1, 3, 4) \
        .reshape(2 * mbh, 2 * mbw, 2)
    return part.to(_I32), mvsp


def window8_index(mvfp8, mbh: int, mbw: int):
    """Row and column indices [N8, 16] of every 8x8 block's window."""
    n8 = 4 * mbh * mbw
    dev = mvfp8.device
    ar = torch.arange(n8, device=dev)
    bys = torch.div(ar, 2 * mbw, rounding_mode="floor") * 8
    bxs = (ar % (2 * mbw)) * 8
    mvf = mvfp8.reshape(n8, 2).long()
    w16 = torch.arange(16, device=dev)
    yy = (bys + mc.PAD - QT.MARGIN + mvf[:, 1])[:, None] + w16
    xx = (bxs + mc.PAD - QT.MARGIN + mvf[:, 0])[:, None] + w16
    return yy, xx


def gather_windows8_plain(planes, mvfp8, mbh: int, mbw: int):
    """Plain version of B9 (the reference's `gather_windows8_jnp`): the
    per-8x8-block [N8, 4, 16, 16] window at (block + mv - MARGIN), one
    advanced-index gather."""
    yy, xx = window8_index(mvfp8, mbh, mbw)
    return planes[:, yy[:, :, None], xx[:, None, :]].permute(1, 0, 2, 3) \
        .contiguous()


def gather_windows8(planes, mvfp8, mbh: int, mbw: int):
    """Kernel B9, replacing the TPU kernel `gather_windows8_banked`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:259): every 8x8
    block's 16x16 window of the four hpel planes, a warp a block: aligned
    16-byte loads, funnel shifts, coalesced 16-byte stores
    (`csrc/windows8.cu`). Bound by device memory.

    planes [4, Hp, Wp] uint8 (PAD-padded hpel planes); mvfp8 [2mbh, 2mbw,
    2] int32 full-pel. |mv| <= PAD - MARGIN keeps every window inside the
    planes (the furthest column is W + 47, the last of W + 2 * PAD); the
    encoder refuses larger search ranges (`check_slice`), and the kernel
    traps on a window outside the planes. Returns [N8, 4, 16, 16] uint8.
    CPU tensors run `gather_windows8_plain`; CUDA tensors launch the
    kernel (counted in `gather_windows8.launches`)."""
    if planes.dtype != torch.uint8:
        raise TypeError("gather_windows8: planes %s, expected uint8"
                        % planes.dtype)
    if planes.device.type == "cpu":
        return gather_windows8_plain(planes, mvfp8, mbh, mbw)
    hp, wp = 16 * mbh + 2 * mc.PAD, 16 * mbw + 2 * mc.PAD
    kernels.check_tensor("gather_windows8", "planes", planes, torch.uint8,
                         (4, hp, wp))
    if planes.data_ptr() % 16:
        raise ValueError("gather_windows8: planes are not 16-byte aligned")
    kernels.check_tensor("gather_windows8", "mvfp8", mvfp8, _I32,
                         (2 * mbh, 2 * mbw, 2))
    out = torch.empty((4 * mbh * mbw, 4, 16, 16), dtype=torch.uint8,
                      device=planes.device)
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_gather_windows8",
                       [VP, CI, CI, VP, CI, CI, VP, VP])
    ptr = kernels.ptr
    rc = fn(ptr(planes), hp, wp, ptr(mvfp8), mbh, mbw, ptr(out),
            kernels.stream(planes))
    kernels.check(rc, "pcamv_gather_windows8")
    gather_windows8.launches += 1
    return out


gather_windows8.launches = 0


def probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv, mbh: int,
                  mbw: int):
    """Per-unit RCA selection from the probe maps (analyse.c:2391-2550).
    Returns (rho [mbh,mbw,4] f32, alt [mbh,mbw,4,2], valid)."""
    dev = SK.device
    n = mbh * mbw
    mvz = PR.sp_to_z(mv8, mbh, mbw).reshape(n, 4, 2)
    block_unit = const(BLOCK_UNIT, dev)[part.reshape(n).long()]
    mvpz = mvp_u.reshape(n, 4, 2)
    ncm = cost_mv.shape[0]
    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]
    centers = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                          for c in range(12)]

    keep8 = [sc8[v] >= 4 for v in range(13)]
    keep_mb0 = torch.where(keep8[0], sc8[0], 0).sum(1, dtype=_I32) >= 6
    kept0 = keep8[0] & keep_mb0[:, None]
    P0 = torch.where(kept0[None], SK[0], SP[0])
    ar = torch.arange(n, device=dev)

    out_rho, out_alt, out_valid = [], [], []
    for u in range(4):
        mem = block_unit == u
        valid_u = mem.any(1)
        first = torch.argmax(mem.to(_I32), dim=1)
        mvu = mvz[ar, first]
        mvpu = mvpz[:, u]

        def mvcost(dq):
            ix = torch.abs(mvu[:, 0] + dq[1] - mvpu[:, 0])
            iy = torch.abs(mvu[:, 1] + dq[0] - mvpu[:, 1])
            return (cost_mv[torch.clamp(ix, max=ncm - 1).long()]
                    + cost_mv[torch.clamp(iy, max=ncm - 1).long()])

        def probes_from(per_blk, center):
            sat = (per_blk * mem[None]).sum(2, dtype=_I32)        # [9,n]
            mvc = torch.stack([mvcost((center[0] + d0, center[1] + d1))
                               for d0, d1 in nb_d])
            return (sat + mvc).T

        def per_blk_for(c):
            sc_sel = torch.where(mem, sc8[c + 1], sc8[0])
            k8_sel = torch.where(mem, keep8[c + 1], keep8[0])
            keep_mb = torch.where(k8_sel, sc_sel, 0).sum(1, dtype=_I32) >= 6
            kept = k8_sel & keep_mb[:, None]
            return torch.where(kept[None], SK[c + 1], SP[c + 1])

        nb0 = probes_from(P0, (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = nb0.min(1).values >= orig_cost
        cand_cost, cand_opt = [], []
        for c in range(12):
            nbc = probes_from(per_blk_for(c), centers[c + 1])
            cand_cost.append(nbc[:, 8])
            cand_opt.append(nbc.min(1).values >= nbc[:, 8])
        rho, sel_delta, _flags = rca_decide(
            nb0, orig_cost, orig_opt, torch.stack(cand_cost, 1),
            torch.stack(cand_opt, 1))
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(valid_u)
    rho = torch.stack(out_rho, 1).reshape(mbh, mbw, 4)
    alt = torch.stack(out_alt, 1).reshape(mbh, mbw, 4, 2)
    valid = torch.stack(out_valid, 1).reshape(mbh, mbw, 4)
    return rho, alt, valid


def p_stage1_stego(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp: int,
                   qpc: int, lam: int, cost_mv, rng: int, mbh: int,
                   mbw: int, extra=None, tail_kernel: bool = False,
                   trans8: bool = False, rd: bool = False):
    """Fused P stage 1: analyse -> pass-1 encode -> device scan -> RCA
    stego costs. `tail_kernel` picks B1's MV predictor: zero (True, the
    reference's accelerator branch) or prev_mv >> 2 (False, its CPU
    branch); see the module docstring. `trans8`/`rd` go to the pass-1
    encode, which then returns only its cbp maps (the reference's pass 2
    is a full re-encode under the 8x8 transform). Returns (packed f32,
    res) with the reference's layout
      [part n | mv8 8n | cbp_l n | cbp_c n | skip n | alt 8n | rho 4n
       | extra]."""
    pred = torch.zeros_like(prev_mv) if tail_kernel else prev_mv >> 2
    ref8 = ref_luma.to(torch.uint8)          # B1 reads plane 0, B9 all 4
    st = fullpel_parts(y, ref8[0], pred.contiguous(), rng, mbh, mbw, lam)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam)
    mvfp8 = mvfp8.contiguous()
    windows = gather_windows8(ref8, mvfp8, mbh, mbw)
    mv8, _r_idx8, SK, SP, sc8 = PR.analyse_tail(
        y, windows, part, mvfp8, prev_mv.contiguous(), lam, qp, mbh, mbw)
    res = INTER.encode_p_frame_device8(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw,
        trans8=trans8, rd=rd, cbp_only=trans8)
    cbp_l = res["cbp_luma"].to(_I32)
    cbp_c = res["cbp_chroma"].to(_I32)
    skip, _mvd, mvp_u, _ = scan_p_device(part, mv8, cbp_l, cbp_c, mbh, mbw)
    rho, alt, _valid = probe_combine(SK, SP, sc8, part, mv8, mvp_u, cost_mv,
                                     mbh, mbw)
    f32 = torch.float32
    pieces = [part, mv8, cbp_l, cbp_c, skip, alt, rho]
    if extra is not None:
        pieces.append(extra)
    packed = torch.cat([p.reshape(-1).to(f32) for p in pieces])
    return packed, res
