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
from ..ops.fullpel import fullpel_parts, fullpel_sub
from ..ops import lumap as LP
from ..ops import transform as T
from ..ops.rdcost import cavlc_block_bits, se_len
from ..stego.cost import D_MV, D_NB, rca_decide
from . import inter as INTER
from . import qpel_table as QT
from .me import mv_bits_table
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


def _tail(y, windows, part, mvfp8, prev_mv, lam: int, qp: int, mbh: int,
          mbw: int, tables, probe: bool):
    """The analyse tail on the windows: B3 -> B4 with `probe`
    (`ops.probe.analyse_tail`: mv8, SK, SP, sc8), else B3 alone with its
    per-MB inter cost (the stego-off analysis: mv8, mb_cost)."""
    if not probe:
        mv8, _r_idx8, mb_cost = PR.subpel(y, windows, part, mvfp8, prev_mv,
                                          lam, mbh, mbw, mb_cost=True)
        return mv8, mb_cost
    mv8, _r_idx8, SK, SP, sc8 = PR.analyse_tail(
        y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw, tables=tables)
    return mv8, SK, SP, sc8


def analyse_p_frame_parts_mref(y, refs8, n_valid: int, prev_mv, lam: int,
                               qp: int, rng: int, mbh: int, mbw: int,
                               num_ref: int, allow_parts: bool = True,
                               tail_kernel: bool = False, tables=None,
                               probe: bool = True):
    """Multi-reference partition analysis, the reference's
    `analyse_p_frame_parts_mref` (partition.py:812) with its analyse tail
    on the windows: B1 on plane 0 of each stacked entry (`refs8` [R, 4,
    Hp, Wp] uint8, newest first; predictor zero with `tail_kernel`, else
    prev_mv >> 2), the merge, `decide_partition`, the per-8x8 reference,
    B9 with it, then B3' -> B4' (`ops.probe.analyse_tail`). The probe
    maps do not depend on the MV predictor, so they are computed here;
    `probe_combine` runs once the host scan has given the predictors.
    B4' quantizes with the inter class of `tables` (None: flat).
    Returns (part, mv8 qpel, ref8 [2mbh, 2mbw] int32, SK, SP, sc8); with
    `probe` False (stego off) no B4 runs, and the tail is (mb_cost,) the
    per-MB inter cost from B3: (part, mv8, ref8, mb_cost)."""
    pred = (torch.zeros_like(prev_mv) if tail_kernel
            else prev_mv >> 2).contiguous()
    sts = [fullpel_parts(y, refs8[r, 0], pred, rng, mbh, mbw, lam)
           for r in range(num_ref)]
    st = merge_ref_states(sts, lam, te_ref_bits(num_ref), n_valid)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam, allow_parts)
    mvfp8 = mvfp8.contiguous()
    ref8 = ref8_from_partition(st, part, mbh, mbw)
    windows = gather_windows8(refs8, mvfp8, mbh, mbw, ref8=ref8)
    mv8, *tail = _tail(y, windows, part, mvfp8, prev_mv.contiguous(), lam,
                       qp, mbh, mbw, tables, probe)
    return (part, mv8, ref8, *tail)


def analyse_p_frame_parts(y, ref8, prev_mv, lam: int, qp: int, rng: int,
                          mbh: int, mbw: int, tail_kernel: bool = False,
                          tables=None, probe: bool = True):
    """One-reference partition analysis, the reference's
    `analyse_p_frame_parts` (partition.py:1364, both `use_pallas`
    branches mapped on `tail_kernel`) with its analyse tail on the
    windows: B1 on plane 0 of `ref8` ([4, Hp, Wp] uint8 hpel planes;
    predictor zero with `tail_kernel`, else prev_mv >> 2), the partition
    decision, B9, then B2 -> B3 -> B4 (`ops.probe.analyse_tail`, B4's
    probe at qp with the inter class of `tables`). Returns (part, mv8
    qpel, SK, SP, sc8); `probe_combine` turns the maps into the RCA costs
    once the MV predictors are known. With `probe` False (stego off) no
    B4 runs: (part, mv8, mb_cost), mb_cost [mbh, mbw] the per-MB inter
    cost from B3, which the intra-in-P compare reads."""
    pred = torch.zeros_like(prev_mv) if tail_kernel else prev_mv >> 2
    st = fullpel_parts(y, ref8[0], pred.contiguous(), rng, mbh, mbw, lam)
    part, mvfp8 = decide_partition(st, mbh, mbw, lam)
    mvfp8 = mvfp8.contiguous()
    windows = gather_windows8(ref8, mvfp8, mbh, mbw)
    mv8, *tail = _tail(y, windows, part, mvfp8, prev_mv.contiguous(), lam,
                       qp, mbh, mbw, tables, probe)
    return (part, mv8, *tail)


def rd_rerank_parts(y, u, v, ref, prev_mv, qp: int, qpc: int, lam: int,
                    rng: int, mbh: int, mbw: int, trellis: bool = False,
                    nr_offset=None, trans8: bool = False,
                    tail_kernel: bool = False, tables=None):
    """The partition-shape RD re-rank of `rd` >= 1 with stego off, the
    reference's `rd_rerank_parts` (partition.py:1616-1724; x264's
    x264_mb_analyse_p_rd, analyse.c:2117): B1 once (its predictor per
    `tail_kernel`, as in `analyse_p_frame_parts`), then for each of the
    four uniform shapes the windows (B9), B3 with its per-MB cost, a full
    encode with the RD 8x8-transform choice (`trellis` the probe trellis:
    the reference's trellis > 1), the device scan for the exact mvds and
    `inter.rd_coded_cost`; a shape whose SATD total is above 5/4 of the
    best is gated out with 1 << 30, and each MB takes the first cheapest
    shape, its units' MVs and its B3 cost. `ref` is the reference dict.
    Returns (part [mbh,mbw] int32, mv8 [2mbh,2mbw,2] qpel, mb_cost
    [mbh,mbw] int32)."""
    dev = y.device
    planes = ref["luma"].to(torch.uint8)
    pred = torch.zeros_like(prev_mv) if tail_kernel else prev_mv >> 2
    st = fullpel_parts(y, planes[0], pred.contiguous(), rng, mbh, mbw, lam)
    hdr = _HDR_BITS
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        st["c8"].sum(-1, dtype=_I32) + lam * int(hdr[3]),
    ])
    # analyse.c:2119 thresh = i_satd * 5/4 (the candidate gate)
    thresh = torch.div(tot.min(0).values * 5, 4, rounding_mode="floor")
    mv_by_part = torch.stack([
        st["mv16"][:, :, None, :].expand(mbh, mbw, 4, 2),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])
    prev = prev_mv.contiguous()
    costs, mv8s, mb_costs = [], [], []
    for s in range(4):
        part_s = torch.full((mbh, mbw), s, dtype=_I32, device=dev)
        mvsp = mv_by_part[s].reshape(mbh, mbw, 2, 2, 2) \
            .permute(0, 2, 1, 3, 4).reshape(2 * mbh, 2 * mbw, 2).contiguous()
        windows = gather_windows8(planes, mvsp, mbh, mbw)
        mv8_s, _r_idx, cost_s = PR.subpel(y, windows, part_s, mvsp, prev,
                                          lam, mbh, mbw, mb_cost=True)
        res = INTER.encode_p_frame_device8(
            y, u, v, ref["luma"], ref["u"], ref["v"], mv8_s, qp, qpc, mbh,
            mbw, trans8=trans8, rd=True, trellis=trellis, tables=tables,
            nr_offset=nr_offset)
        _, mvd_s, _, _ = scan_p_device(part_s, mv8_s,
                                       res["cbp_luma"].to(_I32),
                                       res["cbp_chroma"].to(_I32), mbh, mbw)
        rd = INTER.rd_coded_cost(
            y, u, v, res["luma_lev"], res["chroma_dc"], res["chroma_ac"],
            res["recon_y"], res["recon_u"], res["recon_v"], mvd_s, part_s,
            qp, mbh, mbw)
        costs.append(torch.where(tot[s] <= thresh, rd, 1 << 30))
        mv8s.append(mv8_s)
        mb_costs.append(cost_s)
    part = torch.argmin(torch.stack(costs), dim=0).to(_I32)
    sel8 = part.repeat_interleave(2, 0).repeat_interleave(2, 1).long()
    mv8 = torch.gather(torch.stack(mv8s), 0,
                       sel8[None, :, :, None].expand(1, 2 * mbh, 2 * mbw, 2)
                       )[0]
    mb_cost = torch.gather(torch.stack(mb_costs), 0, part.long()[None])[0]
    return part, mv8.contiguous(), mb_cost


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


# ---------------------------------------------------------------------------
# Sub-8x8 partitions (P_8x8 sub_mb_types 8x4 / 4x8 / 4x4), the reference's
# partition.py:852-1360 (x264's p8x4/p4x8/p4x4 analysis, analyse.c:
# 1569-1693, and the D_L0_8x4/4x8/4x4 stego capture, analyse.c:3518-3689).
# The full-pel search of every unit of every shape is B1's sub-unit
# instance (`ops.fullpel.fullpel_sub`); the sub_mb_type decision is a
# 4-way argmin per 8x8 block with ue() header-bit terms, and the MB
# decision takes the sub-optimized 8x8 cost. The per-4x4 windows, qpel
# tables, subpel refinement and RCA costs are plain torch on every device.
# Slots: a unit's slot is the z index (8x8 block major, 4x4 minor) of its
# first 4x4 block, up to 16 an MB.
# ---------------------------------------------------------------------------

# sub_mb_type header bits: ue(0)=1, ue(1)=3, ue(2)=3, ue(3)=5
_SUB_HDR_BITS = np.array([1, 3, 3, 5], np.int32)
# mb_type header bits with the P_8x8 sub bits counted separately
_HDR_BITS_SUB = np.array([1, 3, 3, 5], np.int32)
# per-4x4-block (z order) slot of MB partitions 0..2
_UNIT_ID_PART = np.array([[0] * 16, [0] * 8 + [8] * 8,
                          [0, 0, 0, 0, 4, 4, 4, 4] * 2], np.int32)
# slot within an 8x8 block per sub_mb_type
_SUB_UNIT_ID = np.array([[0, 0, 0, 0], [0, 0, 2, 2], [0, 1, 0, 1],
                         [0, 1, 2, 3]], np.int32)
_SUBPEL4_OFFSETS = np.array([(oy, ox) for oy in range(-3, 4)
                             for ox in range(-3, 4)], np.int32)
# subpel_sub's MV-bits table, clipped at +-2048
_SUBPEL4_BITS = mv_bits_table(4 * 512)
# z index -> (by, bx) of the 4x4 block inside its MB, and raster -> z
_Z = np.arange(16)
_Z_BY = 2 * (_Z >> 3) + ((_Z >> 1) & 1)
_Z_BX = 2 * ((_Z >> 2) & 1) + (_Z & 1)
_Z_RASTER = 4 * _Z_BY + _Z_BX
_R2Z = np.argsort(_Z_RASTER)


def unit_id_map(part, sub_type):
    """[mbh,mbw] part + [mbh,mbw,4] sub_type -> [mbh,mbw,16] slot of
    every 4x4 block (z order); slot s exists iff unit_id[..., s] == s."""
    dev = part.device
    mbh, mbw = part.shape
    base = const(_UNIT_ID_PART, dev)[torch.clamp(part, 0, 2).long()]
    rel = const(_SUB_UNIT_ID, dev)[sub_type.long()]          # [., ., 4, 4]
    blk = 4 * torch.arange(4, device=dev, dtype=_I32)[:, None]
    sub_ids = (rel + blk).reshape(mbh, mbw, 16)
    return torch.where((part == 3)[..., None], sub_ids, base)


def decide_partition_sub(st: dict, mbh: int, mbw: int, lam: int = 1,
                         allow_parts: bool = True):
    """The per-8x8 sub_mb_type argmin, then the 4-way MB decision on the
    sub-optimized 8x8 cost (first minimum on ties, both levels). Returns
    (part [mbh,mbw], sub_type [mbh,mbw,4] (0 outside P_8x8), mv4fp
    [4mbh,4mbw,2] full-pel)."""
    shdr = _SUB_HDR_BITS
    sub_tot = torch.stack([
        st["c8"] + lam * int(shdr[0]),
        st["c84"].sum(-1, dtype=_I32) + lam * int(shdr[1]),
        st["c48"].sum(-1, dtype=_I32) + lam * int(shdr[2]),
        st["c44"].sum(-1, dtype=_I32) + lam * int(shdr[3])])
    sub_type = torch.argmin(sub_tot, dim=0).to(_I32)
    c8best = sub_tot.min(0).values
    hdr = _HDR_BITS_SUB
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        c8best.sum(-1, dtype=_I32) + lam * int(hdr[3])])
    part = (torch.argmin(tot, dim=0).to(_I32) if allow_parts
            else torch.zeros((mbh, mbw), dtype=_I32, device=tot.device))
    sub_type = torch.where((part == 3)[..., None], sub_type, 0)

    full = (mbh, mbw, 4, 4, 2)
    mv44_by_sub = torch.stack([
        st["mv8"][:, :, :, None, :].expand(full),
        st["mv84"][:, :, :, [0, 0, 1, 1], :],
        st["mv48"][:, :, :, [0, 1, 0, 1], :],
        st["mv44"]])
    mv44_p3 = torch.gather(mv44_by_sub, 0, sub_type.long()[
        None, :, :, :, None, None].expand((1,) + full))[0]
    mv44_by_part = torch.stack([
        st["mv16"][:, :, None, None, :].expand(full),
        st["mv16x8"][:, :, [0, 0, 1, 1], None, :].expand(full),
        st["mv8x16"][:, :, [0, 1, 0, 1], None, :].expand(full),
        mv44_p3])
    mv44 = torch.gather(mv44_by_part, 0, part.long()[
        None, :, :, None, None, None].expand((1,) + full))[0]
    return part, sub_type, _z44_to_sp(mv44, mbh, mbw).contiguous()


def gather_windows4(planes, mv4fp, mbh: int, mbw: int, ref4=None):
    """Every 4x4 block's [4, 12, 12] window of the hpel planes at (block
    + mv - MARGIN), the reference's `gather_windows4_jnp` (planes [4, Hp,
    Wp]) or with `ref4` [4mbh,4mbw] its `gather_windows4_mref` (planes
    the [R, 4, Hp, Wp] stack): one gather, [N4, 4, 12, 12]."""
    n4 = 16 * mbh * mbw
    dev = mv4fp.device
    ar = torch.arange(n4, device=dev)
    bys = torch.div(ar, 4 * mbw, rounding_mode="floor") * 4
    bxs = (ar % (4 * mbw)) * 4
    mvf = mv4fp.reshape(n4, 2).long()
    w12 = torch.arange(4 + 2 * QT.MARGIN, device=dev)
    yy = (bys + mc.PAD - QT.MARGIN + mvf[:, 1])[:, None] + w12
    xx = (bxs + mc.PAD - QT.MARGIN + mvf[:, 0])[:, None] + w12
    if ref4 is None:
        return planes[:, yy[:, :, None], xx[:, None, :]].permute(1, 0, 2, 3)
    r = ref4.reshape(n4).long()[:, None, None, None]
    pp = torch.arange(4, device=dev)[None, :, None, None]
    return planes[r, pp, yy[:, None, :, None], xx[:, None, None, :]]


def block_table4(windows):
    """[N4, 4, 12, 12] uint8 windows -> [169, N4, 4, 4] uint8: every qpel
    offset in [-6, 6]^2 as a static slice-average."""
    w16 = windows.to(torch.int16)
    outs = []
    for oy in range(-6, 7):
        for ox in range(-6, 7):
            (p1, y1, x1), (p2, y2, x2) = QT._phase_slices(oy, ox)
            a = w16[:, p1, y1:y1 + 4, x1:x1 + 4]
            b = w16[:, p2, y2:y2 + 4, x2:x2 + 4]
            outs.append(((a + b + 1) >> 1).to(torch.uint8))
    return torch.stack(outs)


def wht4_flat(blocks):
    """Per-4x4-block WHT, flat: [..., 4, 4] -> [..., 16] int32."""
    return QT.wht16(blocks.to(_I32)).reshape(*blocks.shape[:-2], 16)


def wht4_table(blocks4):
    """wht4_flat of the [169, N4, 4, 4] table as int16 [169, N4, 16], in
    chunks of 13 offsets (bounds the int32 intermediates)."""
    return torch.cat([wht4_flat(blocks4[k:k + 13]).to(torch.int16)
                      for k in range(0, blocks4.shape[0], 13)])


def satd_flat4(wa, wb):
    """SATD between flat 4x4 WHTs [..., 16]."""
    return torch.abs(wa.to(_I32) - wb.to(_I32)).sum(-1, dtype=_I32) >> 1


def blocks4(y, mbh: int, mbw: int):
    """[16mbh, 16mbw] -> [N4, 4, 4] 4x4 blocks in frame raster order."""
    return y.reshape(4 * mbh, 4, 4 * mbw, 4).permute(0, 2, 1, 3) \
        .reshape(16 * mbh * mbw, 4, 4)


def sp4_to_z(a, mbh: int, mbw: int):
    """[4mbh, 4mbw, ...] -> [mbh, mbw, 16, ...] with the block axis in z
    order (8x8 block major, 4x4 minor)."""
    rest = tuple(a.shape[2:])
    k = len(rest)
    return a.reshape(mbh, 2, 2, mbw, 2, 2, *rest).permute(
        0, 3, 1, 4, 2, 5, *range(6, 6 + k)).reshape(mbh, mbw, 16, *rest)


def z_to_sp4(a, mbh: int, mbw: int):
    """[mbh, mbw, 16, ...] -> [4mbh, 4mbw, ...]."""
    rest = tuple(a.shape[3:])
    k = len(rest)
    return a.reshape(mbh, mbw, 2, 2, 2, 2, *rest).permute(
        0, 2, 4, 1, 3, 5, *range(6, 6 + k)).reshape(4 * mbh, 4 * mbw, *rest)


def subpel_sub(cur_y, wht4, part, sub_type, mv4fp, prev_mv, mbh: int,
               mbw: int, lam: int = 1):
    """Quarter-pel refinement of every unit at 4x4 grain from the 4x4
    qpel tables (subpel 2: the 49 offsets of [-3, 3]^2, oy outer): the
    unit's summed SATD + lam * MV bits against its MB's prev_mv (the
    table clipped at +-2048), the first minimum. wht4 [169, N4, 16];
    mv4fp [4mbh,4mbw,2] full-pel. Returns (mv4 qpel [4mbh,4mbw,2], r_idx4
    [N4] int32, mb_cost [mbh,mbw] int32: the sum of each unit's minimum
    cost over the slots that hold a unit, the plain encoder's inter cost
    for the intra compare)."""
    dev = cur_y.device
    n4 = 16 * mbh * mbw
    wcur = wht4_flat(blocks4(cur_y, mbh, mbw))               # [N4, 16]
    mvf = mv4fp.reshape(n4, 2)
    bits_t = const(_SUBPEL4_BITS, dev)
    off = 4 * 512
    pred4 = prev_mv.repeat_interleave(4, 0).repeat_interleave(4, 1) \
        .reshape(n4, 2)
    satds, mvcs = [], []
    for oy, ox in _SUBPEL4_OFFSETS.tolist():
        satds.append(satd_flat4(wcur, wht4[QT.off_index(oy, ox)]))
        ix = torch.clamp(4 * mvf[:, 0] + ox - pred4[:, 0], -off, off) + off
        iy = torch.clamp(4 * mvf[:, 1] + oy - pred4[:, 1], -off, off) + off
        mvcs.append((bits_t[ix.long()] + bits_t[iy.long()]) * lam)
    k = len(satds)
    satz = sp4_to_z(torch.stack(satds, 1).reshape(4 * mbh, 4 * mbw, k),
                    mbh, mbw).movedim(-1, 0)             # [K,mbh,mbw,16]
    mvcz = sp4_to_z(torch.stack(mvcs, 1).reshape(4 * mbh, 4 * mbw, k),
                    mbh, mbw).movedim(-1, 0)
    uid = unit_id_map(part, sub_type)                    # [mbh,mbw,16]
    unit_satd = torch.zeros_like(satz).scatter_add_(
        3, uid.long()[None].expand_as(satz), satz)
    cost = unit_satd + mvcz
    best, sel_slot = cost.min(0)                         # [mbh,mbw,16]
    sel_blk = torch.gather(sel_slot, 2, uid.long())
    offs = const(_SUBPEL4_OFFSETS, dev)[sel_blk]         # [., ., 16, 2]
    mvz = sp4_to_z(mv4fp, mbh, mbw)
    mvq = torch.stack([4 * mvz[..., 0] + offs[..., 1],
                       4 * mvz[..., 1] + offs[..., 0]], dim=-1)
    r_idx = (offs[..., 0] + 6) * 13 + (offs[..., 1] + 6)
    slot = torch.arange(16, device=dev, dtype=uid.dtype)
    mb_cost = torch.where(uid == slot, best, 0).sum(-1, dtype=_I32)
    return (z_to_sp4(mvq, mbh, mbw).to(_I32).contiguous(),
            z_to_sp4(r_idx, mbh, mbw).reshape(n4).to(_I32), mb_cost)


def _sub_tail(y, planes, part, sub_type, mv4fp, prev_mv, mbh: int,
              mbw: int, lam: int, ref4=None):
    """The sub analysis after the decision: the 4x4 windows (with ref4
    [4mbh,4mbw] from the stacked entries), the qpel tables and the subpel
    refinement. Returns (mv4, r_idx4, blocks4, wht4, mb_cost)."""
    tab = block_table4(gather_windows4(planes, mv4fp, mbh, mbw, ref4=ref4))
    wht = wht4_table(tab)
    mv4, r_idx4, mb_cost = subpel_sub(y, wht, part, sub_type, mv4fp,
                                      prev_mv, mbh, mbw, lam)
    return mv4, r_idx4, tab, wht, mb_cost


def analyse_p_frame_sub(y, ref8, prev_mv, rng: int, mbh: int, mbw: int,
                        lam: int, allow_parts: bool = True):
    """The sub-8x8 P analysis at one reference, the reference's
    `analyse_p_frame_sub` (partition.py:1341): B1's sub-unit instance
    against prev_mv >> 2 on both of the reference's branches (it has no
    accelerator form), the two-level decision, the per-4x4 windows and
    qpel tables, the subpel refinement. ref8 [4, Hp, Wp] uint8 hpel
    planes. Returns (part, sub_type, mv4 qpel, r_idx4, blocks4 [169, N4,
    4, 4] uint8, wht4 [169, N4, 16] int16, mb_cost [mbh, mbw])."""
    st = fullpel_sub(y, ref8[0], (prev_mv >> 2).contiguous(), rng, mbh,
                     mbw, lam)
    part, sub_type, mv4fp = decide_partition_sub(st, mbh, mbw, lam,
                                                 allow_parts)
    return (part, sub_type) + _sub_tail(y, ref8, part, sub_type, mv4fp,
                                        prev_mv, mbh, mbw, lam)


def analyse_p_frame_sub_mref(y, refs8, n_valid: int, prev_mv, rng: int,
                             mbh: int, mbw: int, lam: int, num_ref: int,
                             allow_parts: bool = True):
    """The multi-reference sub-8x8 analysis, the reference's
    `analyse_p_frame_sub_mref` (partition.py:1297): B1's sub-unit
    instance once per stacked entry (refs8 [R, 4, Hp, Wp] uint8), the MB
    shapes merged across entries as on the partition path, each 8x8's
    reference its own masked argmin, and the sub splits inside an 8x8
    costed on that reference (with its te(v) bits). Returns (part,
    sub_type, mv4, ref8 [2mbh, 2mbw], r_idx4, blocks4, wht4, mb_cost)."""
    ref_bits = te_ref_bits(num_ref)
    pred = (prev_mv >> 2).contiguous()
    sts = [fullpel_sub(y, refs8[r, 0], pred, rng, mbh, mbw, lam)
           for r in range(num_ref)]
    stm = merge_ref_states(sts, lam, ref_bits, n_valid)
    r8 = stm["r8"]                                       # [mbh,mbw,4] z
    rb = torch.as_tensor(ref_bits).to(y.device)[r8.long()] * lam
    for ck in ("c84", "c48", "c44"):
        mk = "mv" + ck[1:]
        nsub = sts[0][ck].shape[-1]
        sel = r8.long()[None, :, :, :, None].expand(1, mbh, mbw, 4, nsub)
        stm[ck] = torch.gather(torch.stack([st[ck] for st in sts]), 0,
                               sel)[0] + rb[..., None]
        stm[mk] = torch.gather(
            torch.stack([st[mk] for st in sts]), 0,
            sel[..., None].expand(1, mbh, mbw, 4, nsub, 2))[0]
    part, sub_type, mv4fp = decide_partition_sub(stm, mbh, mbw, lam,
                                                 allow_parts)
    ref8 = ref8_from_partition(stm, part, mbh, mbw)
    mv4, r_idx4, tab, wht, mb_cost = _sub_tail(
        y, refs8, part, sub_type, mv4fp, prev_mv, mbh, mbw, lam,
        ref4=ref8.repeat_interleave(2, 0).repeat_interleave(2, 1))
    return part, sub_type, mv4, ref8, r_idx4, tab, wht, mb_cost


def _z44_to_sp(mv44, mbh: int, mbw: int):
    """[mbh,mbw,4 (8x8 z),4 (sub z),2] -> [4mbh,4mbw,2] spatial."""
    return mv44.reshape(mbh, mbw, 2, 2, 2, 2, 2) \
        .permute(0, 2, 4, 1, 3, 5, 6).reshape(4 * mbh, 4 * mbw, 2)


def _bits_per8(luma_lev, chroma_ac, n: int):
    """The residual CAVLC bits at nC 0 of each 8x8 z block [n, 4] int32:
    its four luma 4x4s and its chroma AC 4x4 in each plane (chroma DC is
    left out, as in the reference). luma_lev [mbh,mbw,256] in (by, bx,
    r, c) order, chroma_ac [mbh,mbw,128] in (plane, by, bx, r, c)."""
    dev = luma_lev.device
    zz = const(T.ZIGZAG_4x4, dev).long()
    blk = luma_lev.reshape(n * 16, 4, 4).to(_I32)
    bl = cavlc_block_bits(blk[:, zz[:, 0], zz[:, 1]],
                          torch.zeros(n * 16, dtype=_I32, device=dev)) \
        .reshape(n, 2, 2, 2, 2)                          # [n,by8,y,bx8,x]
    per8 = bl.sum((2, 4), dtype=_I32).reshape(n, 4)
    ca = chroma_ac.reshape(n * 8, 4, 4).to(_I32)
    cb = cavlc_block_bits(ca[:, zz[:, 0], zz[:, 1]][:, 1:],
                          torch.zeros(n * 8, dtype=_I32, device=dev),
                          max_coeff=15).reshape(n, 2, 4)
    return per8 + cb.sum(1, dtype=_I32)


def _ssd_per8(y, u, v, res, mbh: int, mbw: int):
    """The SSD of each 8x8 z block [n, 4] int32: its 8x8 luma and its 4x4
    chroma in each plane (x264_rd_cost_part's measure)."""
    n = mbh * mbw
    tot = 0
    for plane, rec, b in ((y, res["recon_y"], 8), (u, res["recon_u"], 4),
                          (v, res["recon_v"], 4)):
        d = rec.to(_I32) - plane.to(_I32)
        tot = tot + (d * d).reshape(mbh, 2, b, mbw, 2, b) \
            .sum((2, 5), dtype=_I32).permute(0, 2, 1, 3).reshape(n, 4)
    return tot


def _sub_mvd_bits(mv4, mvp, sub_type, n: int, mbh: int, mbw: int):
    """The se(v) bits of every sub unit's mvd against its 8x8's MVP
    [n, 4] (mvp [mbh,mbw,4,2] per 8x8, sub_type [n, 4])."""
    d = sp4_to_z(mv4, mbh, mbw).reshape(n, 4, 4, 2) \
        - mvp.reshape(n, 4, 1, 2)
    slots = torch.arange(4, device=mv4.device, dtype=_I32)
    is_unit = const(_SUB_UNIT_ID, mv4.device)[sub_type.long()] == slots
    return torch.where(is_unit, se_len(d[..., 0]) + se_len(d[..., 1]),
                       0).sum(-1, dtype=_I32)


def rd_rerank_sub(y, u, v, ref, prev_mv, qp: int, qpc: int, lam: int,
                  rng: int, mbh: int, mbw: int, trellis: bool = False,
                  nr_offset=None, tables=None):
    """The sub-8x8 RD re-rank of `rd` >= 1 with stego off at one
    reference, the reference's `rd_rerank_sub` (partition.py:1774-1944;
    x264_mb_analyse_p_rd's P_8x8 branch, analyse.c:2150-2180). B1's
    sub-unit instance once (against prev_mv >> 2), then seven
    uniform-shape frame probes, each the 4x4 windows and qpel tables,
    `subpel_sub`, the fused luma encode (`trellis` the probe trellis: the
    reference's trellis > 1) and the device scan: the three MB shapes
    priced by `inter.rd_coded_cost`, the four sub_mb_types per 8x8 by
    `_bits_per8` + `_ssd_per8` + the mvd bits of each unit against its
    8x8's probe MVP. Candidates above 5/4 of the SATD best are gated out
    with 1 << 30; each 8x8 takes the first cheapest sub type, the
    recomposed mixed P_8x8 frame is encoded and priced exactly, and each
    MB the first cheapest shape. `ref` is the reference dict. Returns
    (part, sub_type, mv4 qpel, r_idx4 [N4], mb_cost [mbh,mbw]): the
    winning shape's subpel cost, on P_8x8 the least uniform sub probe's.
    The reference's final tables (read only by the stego engine) are not
    built."""
    dev = y.device
    n = mbh * mbw
    planes = ref["luma"].to(torch.uint8)
    st = fullpel_sub(y, planes[0], (prev_mv >> 2).contiguous(), rng, mbh,
                     mbw, lam)
    shdr = _SUB_HDR_BITS
    sub_tot = torch.stack([
        st["c8"] + lam * int(shdr[0]),
        st["c84"].sum(-1, dtype=_I32) + lam * int(shdr[1]),
        st["c48"].sum(-1, dtype=_I32) + lam * int(shdr[2]),
        st["c44"].sum(-1, dtype=_I32) + lam * int(shdr[3])])
    sub_min = sub_tot.min(0).values                      # [mbh,mbw,4]
    sub_thresh = torch.div(sub_min * 5, 4, rounding_mode="floor")
    hdr = _HDR_BITS_SUB
    tot = torch.stack([
        st["c16"] + lam * int(hdr[0]),
        st["c16x8"].sum(-1, dtype=_I32) + lam * int(hdr[1]),
        st["c8x16"].sum(-1, dtype=_I32) + lam * int(hdr[2]),
        sub_min.sum(-1, dtype=_I32) + lam * int(hdr[3])])
    mb_thresh = torch.div(tot.min(0).values * 5, 4, rounding_mode="floor")
    b44 = (mbh, mbw, 4, 4, 2)
    cands44 = [
        st["mv16"][:, :, None, None, :].expand(b44),
        st["mv16x8"][:, :, [0, 0, 1, 1], None, :].expand(b44),
        st["mv8x16"][:, :, [0, 1, 0, 1], None, :].expand(b44),
        st["mv8"][:, :, :, None, :].expand(b44),
        st["mv84"][:, :, :, [0, 0, 1, 1], :],
        st["mv48"][:, :, :, [0, 1, 0, 1], :],
        st["mv44"]]
    prev = prev_mv.contiguous()

    def probe(ci):
        """One uniform-shape frame probe: subpel, encode, device scan."""
        part_c = torch.full((mbh, mbw), min(ci, 3), dtype=_I32, device=dev)
        sub_c = torch.full((mbh, mbw, 4), max(ci - 3, 0), dtype=_I32,
                           device=dev)
        mv4fp = _z44_to_sp(cands44[ci], mbh, mbw).contiguous()
        wht = wht4_table(block_table4(gather_windows4(planes, mv4fp, mbh,
                                                      mbw)))
        mv4_c, r_idx4_c, cost_c = subpel_sub(y, wht, part_c, sub_c, mv4fp,
                                             prev, mbh, mbw, lam)
        res = INTER.encode_p_frame_device4(
            y, u, v, ref["luma"], ref["u"], ref["v"], mv4_c, qp, qpc, mbh,
            mbw, trellis=trellis, tables=tables, nr_offset=nr_offset)
        _, mvd_c, mvp_c, _ = scan_p_device(
            part_c, mv4_c[::2, ::2].contiguous(), res["cbp_luma"].to(_I32),
            res["cbp_chroma"].to(_I32), mbh, mbw)
        return mv4_c, r_idx4_c, cost_c, res, mvd_c, mvp_c

    # an int32 sentinel above any MB's SSD + bits cost
    big = 1 << 30
    shape_rd, fields = [], []
    for ci in range(3):
        mv4_c, r_idx4_c, cost_c, res, mvd_c, _ = probe(ci)
        rd = INTER.rd_coded_cost(
            y, u, v, res["luma_lev"], res["chroma_dc"], res["chroma_ac"],
            res["recon_y"], res["recon_u"], res["recon_v"], mvd_c,
            torch.full((mbh, mbw), ci, dtype=_I32, device=dev), qp, mbh,
            mbw)
        shape_rd.append(torch.where(tot[ci] <= mb_thresh, rd, big))
        fields.append((mv4_c, r_idx4_c, cost_c))
    sub_rd = []
    for t in range(4):
        mv4_c, r_idx4_c, cost_c, res, _, mvp_c = probe(3 + t)
        sub_t = torch.full((n, 4), t, dtype=_I32, device=dev)
        bits = (_bits_per8(res["luma_lev"], res["chroma_ac"], n)
                + _sub_mvd_bits(mv4_c, mvp_c, sub_t, n, mbh, mbw)
                + int(_SUB_HDR_BITS[t]))
        prd = INTER.rd_total(_ssd_per8(y, u, v, res, mbh, mbw), bits, qp) \
            .reshape(mbh, mbw, 4)
        sub_rd.append(torch.where(sub_tot[t] <= sub_thresh, prd, big))
        fields.append((mv4_c, r_idx4_c, cost_c))
    sub_type = torch.argmin(torch.stack(sub_rd), dim=0).to(_I32)

    # the mixed-sub_type P_8x8 frame, recomposed and priced exactly
    all44 = torch.stack([sp4_to_z(f[0], mbh, mbw) for f in fields])
    sel16 = sub_type.repeat_interleave(4, -1)            # [mbh,mbw,16]
    mv4_mix = z_to_sp4(torch.gather(
        all44[3:], 0, sel16.long()[None, ..., None].expand(1, mbh, mbw, 16,
                                                           2))[0],
        mbh, mbw).contiguous()
    res_m = INTER.encode_p_frame_device4(
        y, u, v, ref["luma"], ref["u"], ref["v"], mv4_mix, qp, qpc, mbh,
        mbw, trellis=trellis, tables=tables, nr_offset=nr_offset)
    _, _, mvp_m, _ = scan_p_device(
        torch.full((mbh, mbw), 3, dtype=_I32, device=dev),
        mv4_mix[::2, ::2].contiguous(), res_m["cbp_luma"].to(_I32),
        res_m["cbp_chroma"].to(_I32), mbh, mbw)
    subt_f = sub_type.reshape(n, 4)
    bits_m = (_bits_per8(res_m["luma_lev"], res_m["chroma_ac"], n).sum(
        1, dtype=_I32)
        + _sub_mvd_bits(mv4_mix, mvp_m, subt_f, n, mbh, mbw).sum(
            1, dtype=_I32)
        + const(_SUB_HDR_BITS, dev)[subt_f.long()].sum(1, dtype=_I32)
        + int(_HDR_BITS_SUB[3]))
    ssd_m = _ssd_per8(y, u, v, res_m, mbh, mbw).sum(1, dtype=_I32)
    rd_mix = INTER.rd_total(ssd_m, bits_m, qp).reshape(mbh, mbw)
    shape_rd.append(torch.where(tot[3] <= mb_thresh, rd_mix, big))
    part = torch.argmin(torch.stack(shape_rd), dim=0).to(_I32)
    sub_type = torch.where((part == 3)[..., None], sub_type, 0)

    # each 4x4 block takes the winning candidate's MV and offset
    widx = torch.where((part == 3)[..., None], 3 + sub_type.repeat_interleave(
        4, -1), part[..., None].expand(mbh, mbw, 16)).long()
    mv4 = z_to_sp4(torch.gather(all44, 0, widx[None, ..., None].expand(
        1, mbh, mbw, 16, 2))[0], mbh, mbw)
    all_ri = torch.stack([sp4_to_z(f[1].reshape(4 * mbh, 4 * mbw), mbh, mbw)
                          for f in fields])
    r_idx4 = z_to_sp4(torch.gather(all_ri, 0, widx[None])[0], mbh,
                      mbw).reshape(16 * n)
    # the intra compare's inter cost: the winning shape's subpel cost,
    # on P_8x8 the least of the uniform sub probes'
    cost3 = torch.stack([f[2] for f in fields[3:]]).min(0).values
    costs = torch.stack([f[2] for f in fields[:3]] + [cost3])
    mb_cost = torch.gather(costs, 0, part.long()[None])[0]
    return (part, sub_type, mv4.to(_I32).contiguous(), r_idx4.to(_I32),
            mb_cost)


def _mb_pred_z(blkz):
    """[m, 16 (z), 4, 4] blocks -> [m, 16, 16] MB predictions."""
    m = blkz.shape[0]
    return blkz[:, const(_R2Z, blkz.device).long()].reshape(m, 4, 4, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(m, 16, 16).contiguous()


def _wht_blocks_z(rec):
    """[m, 16, 16] MB recon -> [m, 16 (z), 16] flat per-4x4 WHTs."""
    m = rec.shape[0]
    r44 = rec.reshape(m, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(m, 16, 4, 4)
    return wht4_flat(r44[:, const(_Z_RASTER, rec.device).long()])


def stego_costs_sub(cur_y, blocks4, wht4, r_idx4, part, sub_type, mv4,
                    mvp_s, cost_mv, qp: int, mbh: int, mbw: int,
                    tables=None):
    """The RCA cost of every unit slot with the sub-8x8 shapes, the
    reference's `stego_costs_sub` (partition.py:1159; x264's
    x264_ih_get_mv_cost, analyse.c:2391-2550, with the D_L0_8x4/4x8/4x4
    cases): each slot's unit encoded at its chosen offset and at the 12
    D_MV candidates (the rest of its MB at the chosen offsets) and
    probed against its 9 lattice neighbours; rho by `rca_decide` in
    float32. Every one of the 16 slots of every MB is computed, as in the
    reference, whose slots that do not exist are masked later; a slot's
    SATD terms are zero outside its unit, so the candidate encodes run
    only on the MBs where the slot exists: one fused luma-encode launch
    for the MBs' chosen offsets, then one a slot for its 12 candidates
    (the current MBs read from the plane by MB number). part/sub_type are
    host arrays; blocks4/wht4/r_idx4 the analysis tables; mv4
    [4mbh,4mbw,2] and mvp_s [mbh,mbw,16,2] (each slot's predictor) on the
    device; cost_mv the probe MV-cost table; quantized at qp with the
    inter class of `tables`. Returns (rho [mbh,mbw,16] f32, alt
    [mbh,mbw,16,2], valid [mbh,mbw,16])."""
    dev = cur_y.device
    n = mbh * mbw
    ncm = cost_mv.shape[0]
    uid_np = unit_id_map(torch.as_tensor(np.asarray(part, np.int32)),
                         torch.as_tensor(np.asarray(sub_type, np.int32))
                         ).numpy().reshape(n, 16)
    uid = torch.as_tensor(uid_np).to(dev)
    mvz = sp4_to_z(mv4, mbh, mbw).reshape(n, 16, 2)
    mvps = mvp_s.reshape(n, 16, 2)

    def z_rows(t):
        return sp4_to_z(t.reshape(4 * mbh, 4 * mbw, *t.shape[1:]), mbh,
                        mbw).reshape(n, 16, *t.shape[1:])

    sel_whtz = {(dy, dx): z_rows(QT.select_rows(wht4, r_idx4 + 13 * dy + dx))
                for dy in range(-3, 4) for dx in range(-3, 4)}

    def blocks_at(dy, dx):
        return z_rows(QT.select_rows(blocks4, r_idx4 + 13 * dy + dx)) \
            .to(_I32)

    blk0z = blocks_at(0, 0)                              # [n,16,4,4]
    centers = [(int(D_MV[c][1]), int(D_MV[c][0])) for c in range(12)]
    cand_blkz = [blocks_at(*d) for d in centers]
    nb_d = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]
    _, rec0, _ = LP.luma_p_encode(cur_y, _mb_pred_z(blk0z), qp, lev=False,
                                  tables=tables)
    w0 = _wht_blocks_z(rec0)                             # [n,16,16]

    out_rho, out_alt, out_valid = [], [], []
    for s in range(16):
        mvu, mvpu = mvz[:, s], mvps[:, s]

        def mvcost(dq):
            ix = torch.abs(mvu[:, 0] + dq[1] - mvpu[:, 0])
            iy = torch.abs(mvu[:, 1] + dq[0] - mvpu[:, 1])
            return (cost_mv[torch.clamp(ix, max=ncm - 1).long()]
                    + cost_mv[torch.clamp(iy, max=ncm - 1).long()])

        vidx = np.nonzero(uid_np[:, s] == s)[0]
        m = len(vidx)
        vi = torch.as_tensor(vidx).to(dev)
        mem = (uid[vi] == s)                             # [m, 16]
        sel = {d: t[vi] for d, t in sel_whtz.items()}
        wvers = [w0[vi]]
        if m:
            m4 = mem[:, :, None, None]
            preds = torch.cat([_mb_pred_z(torch.where(m4, cand_blkz[c][vi],
                                                      blk0z[vi]))
                               for c in range(12)])
            _, rec, _ = LP.luma_p_encode(
                cur_y, preds, qp, idx=vi.to(_I32).repeat(12), lev=False,
                tables=tables)
            wvers += list(_wht_blocks_z(rec).reshape(12, m, 16, 16))
        else:
            wvers += [w0[vi]] * 12

        def probes(wrec, center):
            outp = []
            for d0, d1 in nb_d:
                d = (center[0] + d0, center[1] + d1)
                sat = (satd_flat4(wrec, sel[d]) * mem).sum(1, dtype=_I32)
                full = torch.zeros(n, dtype=_I32, device=dev)
                full[vi] = sat
                outp.append(full + mvcost(d))
            return torch.stack(outp, dim=1)               # [n, 9]

        nb0 = probes(wvers[0], (0, 0))
        orig_cost = nb0[:, 8]
        orig_opt = nb0.min(1).values >= orig_cost
        cand_cost, cand_opt = [], []
        for c in range(12):
            nbc = probes(wvers[c + 1], centers[c])
            cand_cost.append(nbc[:, 8])
            cand_opt.append(nbc.min(1).values >= nbc[:, 8])
        rho, sel_delta, _flags = rca_decide(
            nb0, orig_cost, orig_opt, torch.stack(cand_cost, 1),
            torch.stack(cand_opt, 1))
        out_rho.append(rho)
        out_alt.append(mvu + sel_delta)
        out_valid.append(uid[:, s] == s)
    return (torch.stack(out_rho, 1).reshape(mbh, mbw, 16),
            torch.stack(out_alt, 1).reshape(mbh, mbw, 16, 2).to(_I32),
            torch.stack(out_valid, 1).reshape(mbh, mbw, 16))
