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


def decide_partition(st: dict, mbh: int, mbw: int, lam: int = 1,
                     allow_parts: bool = True):
    """4-way partition decision from the full-pel unit costs plus header
    lambda terms; `allow_parts` False pins every MB to 16x16. Returns
    (part [mbh,mbw] int32, mvfp8 [2mbh,2mbw,2])."""
    hdr = _HDR_BITS
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        st["c8"].sum(-1, dtype=_I32) + lam * int(hdr[3]),
    ])
    part = torch.argmin(tot, dim=0)
    if not allow_parts:
        part = torch.zeros_like(part)
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


def gather_windows8_plain(planes, mvfp8, mbh: int, mbw: int, ref8=None):
    """Plain version of B9 (the reference's `gather_windows8_jnp`, and
    with `ref8` its `gather_windows8_mref`): the per-8x8-block [N8, 4,
    16, 16] window at (block + mv - MARGIN), one advanced-index gather;
    with `ref8` [2mbh, 2mbw] from entry ref8[b] of the [R, 4, Hp, Wp]
    stack."""
    yy, xx = window8_index(mvfp8, mbh, mbw)
    if ref8 is None:
        return planes[:, yy[:, :, None], xx[:, None, :]] \
            .permute(1, 0, 2, 3).contiguous()
    r = ref8.reshape(-1).long()[:, None, None, None]
    pp = torch.arange(4, device=planes.device)[None, :, None, None]
    return planes[r, pp, yy[:, None, :, None], xx[:, None, None, :]]


def gather_windows8(planes, mvfp8, mbh: int, mbw: int, ref8=None):
    """Kernel B9, replacing the TPU kernel `gather_windows8_banked`
    (video_steganography_pcamv_tpu/ops/pallas_kernels.py:259): every 8x8
    block's 16x16 window of the four hpel planes, a warp a block: aligned
    16-byte loads, funnel shifts, coalesced 16-byte stores
    (`csrc/windows8.cu`). Bound by device memory.

    planes [4, Hp, Wp] uint8 (PAD-padded hpel planes), or with `ref8`
    (the multi-reference analysis) a stack [R, 4, Hp, Wp] of them and
    ref8 [2mbh, 2mbw] int32 the entry each 8x8 block reads; mvfp8 [2mbh,
    2mbw, 2] int32 full-pel. |mv| <= PAD - MARGIN keeps every window
    inside the planes (the furthest column is W + 47, the last of W + 2 *
    PAD); the encoder refuses larger search ranges (`check_slice`), and
    the kernel traps on a window outside the planes or a reference index
    outside [0, R). Returns [N8, 4, 16, 16] uint8. CPU tensors run
    `gather_windows8_plain`; CUDA tensors launch the kernel (counted in
    `gather_windows8.launches`)."""
    if planes.dtype != torch.uint8:
        raise TypeError("gather_windows8: planes %s, expected uint8"
                        % planes.dtype)
    if (planes.dim() == 4) != (ref8 is not None):
        raise ValueError("gather_windows8: a [R, 4, Hp, Wp] stack goes with "
                         "ref8, [4, Hp, Wp] planes without")
    if planes.device.type == "cpu":
        return gather_windows8_plain(planes, mvfp8, mbh, mbw, ref8=ref8)
    hp, wp = 16 * mbh + 2 * mc.PAD, 16 * mbw + 2 * mc.PAD
    nref = 1 if ref8 is None else planes.shape[0]
    kernels.check_tensor("gather_windows8", "planes", planes, torch.uint8,
                         (4, hp, wp) if ref8 is None else (nref, 4, hp, wp))
    if planes.data_ptr() % 16:
        raise ValueError("gather_windows8: planes are not 16-byte aligned")
    kernels.check_tensor("gather_windows8", "mvfp8", mvfp8, _I32,
                         (2 * mbh, 2 * mbw, 2))
    if ref8 is not None:
        kernels.check_tensor("gather_windows8", "ref8", ref8, _I32,
                             (2 * mbh, 2 * mbw))
    out = torch.empty((4 * mbh * mbw, 4, 16, 16), dtype=torch.uint8,
                      device=planes.device)
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_gather_windows8",
                       [VP, CI, CI, VP, VP, CI, CI, CI, VP, VP])
    ptr = kernels.ptr
    rc = fn(ptr(planes), hp, wp, ptr(mvfp8),
            None if ref8 is None else ptr(ref8), nref, mbh, mbw, ptr(out),
            kernels.stream(planes))
    kernels.check(rc, "pcamv_gather_windows8")
    gather_windows8.launches += 1
    return out


gather_windows8.launches = 0


# ---------------------------------------------------------------------------
# Multi-reference P analysis (the reference's partition.py:742-880; x264's
# per-reference search loop, analyse.c:1122-1200, and its mixed-reference
# P_8x8): B1 runs once per DPB entry, and each partition unit keeps the
# (cost, mv, ref) of its cheapest entry with the te(v) ref_idx bits in the
# cost. DPB slots past n_valid (the stack is padded by repeating the newest
# entry) carry a 1 << 28 penalty.
# ---------------------------------------------------------------------------

def te_ref_bits(num_ref: int) -> np.ndarray:
    """Bits of ref_idx te(v) per index (spec 9.1.1): one bit when the
    range is 0..1, else the ue(v) size."""
    if num_ref <= 1:
        return np.zeros(num_ref, np.int32)
    if num_ref == 2:
        return np.ones(2, np.int32)
    return np.array([2 * int(np.floor(np.log2(i + 1))) + 1
                     for i in range(num_ref)], np.int32)


def merge_ref_states(sts, lam: int, ref_bits, n_valid: int) -> dict:
    """Per-unit (cost, mv, ref) over the per-reference B1 states `sts`
    (ascending reference index): a strictly cheaper entry replaces the
    kept one, so ties keep the lower reference. Returns the `st` dict of
    `decide_partition` plus r16, r16x8, r8x16, r8 (int32 indices)."""
    out = {}
    for ck in ("c16", "c16x8", "c8x16", "c8"):
        mk, rk = "mv" + ck[1:], "r" + ck[1:]
        best_c = best_mv = best_r = None
        for r, st in enumerate(sts):
            pen = 0 if r < n_valid else 1 << 28
            c = st[ck] + (lam * int(ref_bits[r]) + pen)
            if best_c is None:
                best_c, best_mv = c, st[mk]
                best_r = torch.zeros_like(c)
            else:
                better = c < best_c
                best_c = torch.where(better, c, best_c)
                best_mv = torch.where(better[..., None], st[mk], best_mv)
                best_r = torch.where(better, r, best_r)
        out[ck], out[mk], out[rk] = best_c, best_mv, best_r.to(_I32)
    return out


def ref8_from_partition(st: dict, part, mbh: int, mbw: int):
    """Each 8x8 block's reference under the chosen partition, [2mbh,
    2mbw] int32 (the reference selection of `decide_partition`'s MVs)."""
    ref_by_part = torch.stack([
        st["r16"][:, :, None].expand(mbh, mbw, 4),
        st["r16x8"][:, :, [0, 0, 1, 1]],
        st["r8x16"][:, :, [0, 1, 0, 1]],
        st["r8"],
    ])
    r8 = torch.gather(ref_by_part, 0,
                      part.long()[None, :, :, None].expand(1, mbh, mbw, 4))[0]
    return r8.reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3) \
        .reshape(2 * mbh, 2 * mbw).contiguous()


def analyse_p_frame_parts_mref(y, refs8, n_valid: int, prev_mv, lam: int,
                               qp: int, rng: int, mbh: int, mbw: int,
                               num_ref: int, allow_parts: bool = True,
                               tail_kernel: bool = False, tables=None):
    """Multi-reference partition analysis, the reference's
    `analyse_p_frame_parts_mref` (partition.py:812) with its analyse tail
    on the windows: B1 on plane 0 of each stacked entry (`refs8` [R, 4,
    Hp, Wp] uint8, newest first; predictor zero with `tail_kernel`, else
    prev_mv >> 2), the merge, `decide_partition`, the per-8x8 reference,
    B9 with it, then B3' -> B4' (`ops.probe.analyse_tail`). The probe
    maps do not depend on the MV predictor, so they are computed here;
    `probe_combine` runs once the host scan has given the predictors.
    B4' quantizes with the inter class of `tables` (None: flat).
    Returns (part, mv8 qpel, ref8 [2mbh, 2mbw] int32, SK, SP, sc8)."""
    pred = (torch.zeros_like(prev_mv) if tail_kernel
            else prev_mv >> 2).contiguous()
    sts = [fullpel_parts(y, refs8[r, 0], pred, rng, mbh, mbw, lam)
           for r in range(num_ref)]
    st = merge_ref_states(sts, lam, te_ref_bits(num_ref), n_valid)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam, allow_parts)
    mvfp8 = mvfp8.contiguous()
    ref8 = ref8_from_partition(st, part, mbh, mbw)
    windows = gather_windows8(refs8, mvfp8, mbh, mbw, ref8=ref8)
    mv8, _r_idx8, SK, SP, sc8 = PR.analyse_tail(
        y, windows, part, mvfp8, prev_mv.contiguous(), lam, qp, mbh, mbw,
        tables=tables)
    return part, mv8, ref8, SK, SP, sc8


def analyse_p_frame_parts(y, ref8, prev_mv, lam: int, qp: int, rng: int,
                          mbh: int, mbw: int, tail_kernel: bool = False,
                          tables=None):
    """One-reference partition analysis, the reference's
    `analyse_p_frame_parts` (partition.py:1364, both `use_pallas`
    branches mapped on `tail_kernel`) with its analyse tail on the
    windows: B1 on plane 0 of `ref8` ([4, Hp, Wp] uint8 hpel planes;
    predictor zero with `tail_kernel`, else prev_mv >> 2), the partition
    decision, B9, then B2 -> B3 -> B4 (`ops.probe.analyse_tail`, B4's
    probe at qp with the inter class of `tables`). Returns (part, mv8
    qpel, SK, SP, sc8); `probe_combine` turns the maps into the RCA costs
    once the MV predictors are known."""
    pred = torch.zeros_like(prev_mv) if tail_kernel else prev_mv >> 2
    st = fullpel_parts(y, ref8[0], pred.contiguous(), rng, mbh, mbw, lam)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam)
    mvfp8 = mvfp8.contiguous()
    windows = gather_windows8(ref8, mvfp8, mbh, mbw)
    mv8, _r_idx8, SK, SP, sc8 = PR.analyse_tail(
        y, windows, part, mvfp8, prev_mv.contiguous(), lam, qp, mbh, mbw,
        tables=tables)
    return part, mv8, SK, SP, sc8


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
                   trans8: bool = False, rd: bool = False,
                   trellis: bool = False, tables=None, nr_offset=None):
    """Fused P stage 1: analyse -> pass-1 encode -> device scan -> RCA
    stego costs. `tail_kernel` picks B1's MV predictor: zero (True, the
    reference's accelerator branch) or prev_mv >> 2 (False, its CPU
    branch); see the module docstring. `trans8`/`rd`/`trellis`/
    `nr_offset` go to the pass-1 encode, which then returns only its cbp
    maps (the reference's pass 2 is a full re-encode under the 8x8
    transform, trellis or noise reduction) and, with `nr_offset`, the
    pass-1 noise-reduction sums as res["nr_sum"]. B4 and both encodes
    quantize with the inter class of `tables` (None: flat); noise
    reduction reaches the encode, never B4's probe.
    Returns (packed f32, res) with the reference's layout
      [part n | mv8 8n | cbp_l n | cbp_c n | skip n | alt 8n | rho 4n
       | extra]."""
    # B1 reads plane 0 of the uint8 hpel planes, B9 all 4
    part, mv8, SK, SP, sc8 = analyse_p_frame_parts(
        y, ref_luma.to(torch.uint8), prev_mv, lam, qp, rng, mbh, mbw,
        tail_kernel=tail_kernel, tables=tables)
    res = INTER.encode_p_frame_device8(
        y, u, v, ref_luma, ref_u, ref_v, mv8, qp, qpc, mbh, mbw,
        trans8=trans8, rd=rd,
        cbp_only=trans8 or trellis or nr_offset is not None,
        trellis=trellis, tables=tables, nr_offset=nr_offset)
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
