"""B slices (port of the stego subset of encoder/bslice.py: BASELINE
config 4's B frames and every direct mode, implicit weights and the
reference B of a pyramid).

The analysis runs in two device stages around one host step, as in the
reference:

  stage 1  B1's all-shapes full-pel scan against a zero predictor
           (`fullpel_parts`), once per L0 entry and once on L1; the L0
           entries merged per MB at 16x16 with REF_COST (ties to the
           lower index, padded entries carry a 1 << 28 penalty);
  host     the approximate direct fields from the two 16x16 fields
           (`approx_direct_fields`) and their per-8x8 SATD
           (`bipred_satd8_device`);
  stage 2  the exact full-pel BI SADs, the shape x list-combo decision,
           per list the windows (B9, on L0 with each 8x8's entry) and
           the subpel refine (B3', zero predictor), then the SATD-level
           combo choice (`analyse_b_parts`).

The L0 list is always a stack of entries (one at one reference): the
reference's single-reference B functions compute what its
multi-reference ones compute with one entry (no ref_idx bits, every MB
on entry 0), so one path serves both. The bipred combine takes the
implicit weight of `bipred_weight` (`weightb`; 32, the plain average,
without it): a scalar in the analysis, per L0 entry in the 16x16 BI
cost, per 8x8 in the encode.

Direct MVs come from spatial direct, derived in the host commit on the
committed neighbours, or from a field computed once a frame
(`temporal_direct_fields`, with `dist_scale_factor` per L0 entry and the
colocated picture's references mapped into L0 by POC; `no_direct_fields`
for `direct` 0). `scan_b_parts` is the host raster commit with the
decoder's exact derivation; `encode_b_frame_device` assembles the bipred
prediction and encodes it, its 4x4 luma with the fused luma-encode kernel
(`ops/lumap.luma_p_encode`).

Without partitions (x264's `--partitions none`) a B frame takes the
16x16 analysis instead (`analyse_b_frame`, the reference's
`analyse_b_frame` and `analyse_b_frame_mref`): per list entry B6's
full-pel search against a zero predictor (`fullpel_search16`), B7's
windows (`gather_windows`), the qpel tables and the subpel refine against
a zero predictor; the L0 entries merged per MB at the SATD level with
REF_COST; BI at the two winners. `bipred_satd_device` costs the
approximate direct prediction per MB and `scan_b_frame` is the host
commit of the 16x16 modes.

Every kernel wrapper runs its plain version on a CPU tensor and its
kernel on a CUDA one. Block index convention per MB: 8x8 blocks b in
{0: TL, 1: TR, 2: BL, 3: BR} (z-order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const
from ..ops import mc
from ..ops.blocks import mb_tiles
from ..ops.fullpel import fullpel_parts, fullpel_search16
from ..ops.lumap import luma_p_encode
from ..ops.probe import (_mb_blocks8, block_row8, satd_flat, sp_to_z,
                         subpel, wht8_flat, z_to_sp)
from . import qpel_table as QT
from .analyse2 import subpel_cost_from_table
from .inter import _p_result, chroma_encode, mb_qps, trellis_luma_levels
from .me import mv_bits_table
from .partition import D_16x16, D_16x8, D_8x16, gather_windows8, te_ref_bits
from .qpel_table import gather_windows

_I32 = torch.int32

# ue(k) bit size
_UE_BITS = np.array([2 * ((k + 1).bit_length() - 1) + 1
                     for k in range(64)], np.int32)

# mb_type ue codes of the two-partition shapes, [sel_a, sel_b] with sel in
# {0: L0, 1: L1, 2: BI} (x264 mb_type_b_to_golomb, encoder/cavlc.c:44-49)
B_CODE_16X8 = np.array([[4, 8, 12], [10, 6, 14], [16, 18, 20]], np.int32)
B_CODE_8X16 = np.array([[5, 9, 13], [11, 7, 15], [17, 19, 21]], np.int32)
# sub_mb_type ue codes: sel {0: L0, 1: L1, 2: BI, 3: direct} -> code
_B_SUB_CODE = np.array([1, 2, 3, 0], np.int32)

# ue bit sizes of the 16x16 mb_type codes direct / L0 / L1 / BI (the mvd
# bits are in the MV cost)
_B_HDR_BITS = np.array([1, 3, 3, 5], np.int64)

# the mb_type ue bits of each two-partition combo
_UE_16X8 = _UE_BITS[B_CODE_16X8]
_UE_8X16 = _UE_BITS[B_CODE_8X16]

_MV_BITS = mv_bits_table(4 * 512)
_BOFF = 4 * 512


def _bi_avg(p0, p1, w1=32):
    """Bipred combine (the reference's `_bi_avg`): the implicit weighted
    clip((p0 (64 - w1) + p1 w1 + 32) >> 6) (spec 8.4.2.3.2, log2WD 5);
    w1 an int, or a tensor that broadcasts against p0 (per MB or per 8x8
    block). At w1 = 32 it is the plain average (p0 + p1 + 1) >> 1, which
    the default (no `weightb`) takes directly."""
    if isinstance(w1, int) and w1 == 32:
        return (p0 + p1 + 1) >> 1
    return torch.clamp((p0 * (64 - w1) + p1 * w1 + 32) >> 6, 0, 255)


def bipred_weight(poc_b: int, poc0: int, poc1: int, weightb: bool) -> int:
    """Implicit bipred weight of the L1 prediction (w0 = 64 - w1), the
    reference's `bipred_weight` (x264_macroblock_bipred_init): 32 without
    `weightb`, when td = 0 or outside [-64, 128]; C's division, which
    truncates toward zero, also where td < 0."""
    if not weightb:
        return 32
    td = min(127, max(-128, poc1 - poc0))
    if td == 0:
        return 32
    tb = min(127, max(-128, poc_b - poc0))
    tx = (16384 + (abs(td) >> 1)) // abs(td) * (1 if td > 0 else -1)
    dsf = min(1023, max(-1024, (tb * tx + 32) >> 6)) >> 2
    return dsf if -64 <= dsf <= 128 else 32


def weight_arg(w, dev):
    """A weight table (numpy, any shape) as `_bi_avg`'s argument: the int
    when every entry is the same, else an int32 tensor of it on dev."""
    w = np.asarray(w)
    if (w == w.reshape(-1)[0]).all():
        return int(w.reshape(-1)[0])
    return torch.as_tensor(np.ascontiguousarray(w, np.int32)).to(dev)


def _mvc(mv, lam: int, scale: int = 1):
    """lam * (bits(scale mv_x) + bits(scale mv_y)) against a zero
    predictor, for a [..., 2] int32 tensor."""
    bits = const(_MV_BITS, mv.device)
    ix = torch.clamp(scale * mv[..., 0], -_BOFF, _BOFF) + _BOFF
    iy = torch.clamp(scale * mv[..., 1], -_BOFF, _BOFF) + _BOFF
    return (bits[ix.long()] + bits[iy.long()]) * lam


def _block_origins(mbh: int, mbw: int, dev, step: int):
    n8 = 4 * mbh * mbw
    ar = torch.arange(n8, device=dev, dtype=_I32)
    return (torch.div(ar, 2 * mbw, rounding_mode="floor") * step,
            (ar % (2 * mbw)) * step)


def _gather8_fp(plane, mv8sp, mbh: int, mbw: int, r8=None):
    """Full-pel 8x8 windows at block origin + mv, [N8, 8, 8] (spatial
    order). plane: the PAD-padded full-pel plane [Hp, Wp], or with r8
    [N8] a stack [R, Hp, Wp] and each block's entry."""
    ys, xs = _block_origins(mbh, mbw, plane.device, 8)
    mvf = mv8sp.reshape(-1, 2).long()
    ar8 = torch.arange(8, device=plane.device)
    yy = (ys.long() + mc.PAD + mvf[:, 1])[:, None] + ar8
    xx = (xs.long() + mc.PAD + mvf[:, 0])[:, None] + ar8
    if r8 is None:
        return plane[yy[:, :, None], xx[:, None, :]]
    return plane[r8.long()[:, None, None], yy[:, :, None], xx[:, None, :]]


def _shape_mv_fields(st):
    """Per-shape per-8x8 (z-order) full-pel MV fields [4, mbh, mbw, 4, 2]
    of a B1 state."""
    mbh, mbw = st["c16"].shape
    return torch.stack([
        st["mv16"][:, :, None, :].expand(mbh, mbw, 4, 2),
        st["mv16x8"][:, :, [0, 0, 1, 1], :],
        st["mv8x16"][:, :, [0, 1, 0, 1], :],
        st["mv8"],
    ])


def _unit_reduce(per_block, part_kind: int):
    """[..., 4] per-block -> per-unit sums replicated back to blocks."""
    if part_kind == D_16x16:
        return per_block.sum(-1, keepdim=True, dtype=_I32) \
            .expand(per_block.shape)
    if part_kind == D_16x8:
        return per_block[..., [0, 0, 2, 2]] + per_block[..., [1, 1, 3, 3]]
    if part_kind == D_8x16:
        return per_block[..., [0, 1, 0, 1]] + per_block[..., [2, 3, 2, 3]]
    return per_block


def _take(stacked, idx):
    """stacked [K, mbh, mbw, *rest] at idx [mbh, mbw] -> [mbh, mbw,
    *rest]."""
    rest = stacked.shape[3:]
    i = idx.long().reshape(1, *idx.shape, *([1] * len(rest)))
    return torch.gather(stacked, 0,
                        i.expand(1, *stacked.shape[1:]))[0]


def analyse_b_parts_stage1(y, refs0_fp, n_valid: int, ref1_fp, rng: int,
                           mbh: int, mbw: int, lam: int):
    """Stage 1, the reference's `analyse_b_parts_stage1_mref`
    (bslice.py:539; with one entry its `analyse_b_parts_stage1`, :523):
    B1 per L0 entry (refs0_fp [R, Hp, Wp] uint8 full-pel planes, newest
    first) and on L1 (ref1_fp), the per-MB L0 entry chosen at 16x16 with
    REF_COST lam * te(ref) bits (first minimum: ties keep the lower
    index; entries past n_valid carry a 1 << 28 penalty and still run
    B1), every field of the L0 state taken at that entry, and its ref
    bits added to the L0 unit costs. Returns (st0, st1, ref0 [mbh, mbw]
    int32)."""
    nrefs = refs0_fp.shape[0]
    zero = torch.zeros((mbh, mbw, 2), dtype=_I32, device=y.device)
    bits = te_ref_bits(nrefs)
    sts = [fullpel_parts(y, refs0_fp[r], zero, rng, mbh, mbw, lam)
           for r in range(nrefs)]
    c16 = torch.stack([sts[r]["c16"] + lam * int(bits[r]) if r < n_valid
                       else torch.full_like(sts[r]["c16"], 1 << 28)
                       for r in range(nrefs)])
    ref0 = torch.argmin(c16, dim=0).to(_I32)
    st0 = {k: _take(torch.stack([st[k] for st in sts]), ref0)
           for k in sts[0]}
    rb = (lam * torch.as_tensor(bits, device=y.device)[ref0.long()]) \
        .to(_I32)
    st0["c16"] = st0["c16"] + rb
    for k in ("c16x8", "c8x16", "c8"):
        st0[k] = st0[k] + rb[..., None]
    st1 = fullpel_parts(y, ref1_fp, zero, rng, mbh, mbw, lam)
    return st0, st1, ref0


def _direct_pred8(ref0_luma, ref1_luma, use0, use1, mv0_8, mv1_8, mbh: int,
                  mbw: int, w1=32):
    """The (approximate) direct prediction per 8x8 block [N8, 8, 8]
    (spatial order) at per-8x8 qpel MVs of both lists, BI blocks combined
    at the scalar weight w1."""
    ys8, xs8 = _block_origins(mbh, mbw, use0.device, 8)
    n8 = ys8.shape[0]
    u0 = use0.reshape(n8)[:, None, None].to(torch.bool)
    u1 = use1.reshape(n8)[:, None, None].to(torch.bool)
    p0 = mc.mc_luma(ref0_luma, ys8, xs8, mv0_8.reshape(n8, 2), 8, 8)
    p1 = mc.mc_luma(ref1_luma, ys8, xs8, mv1_8.reshape(n8, 2), 8, 8)
    return torch.where(u0 & u1, _bi_avg(p0, p1, w1), torch.where(u0, p0, p1))


def bipred_satd8_device(y, ref0_luma, ref1_luma, use0, use1, mv0_8, mv1_8,
                        mbh: int, mbw: int, w1: int = 32):
    """Per-8x8 SATD [mbh, mbw, 4] (z-order) of the (approximate) direct
    prediction at per-8x8 qpel MVs, eager torch (the reference's
    bslice.py:771)."""
    p8 = _direct_pred8(ref0_luma, ref1_luma, use0, use1, mv0_8, mv1_8, mbh,
                       mbw, w1)
    satd = satd_flat(wht8_flat(_mb_blocks8(y, mbh, mbw)), wht8_flat(p8))
    return sp_to_z(satd.reshape(2 * mbh, 2 * mbw), mbh, mbw)


def bipred_satd_device(y, ref0_luma, ref1_luma, use0, use1, mv0_8, mv1_8,
                       mbh: int, mbw: int, w1: int = 32):
    """Per-MB SATD [mbh, mbw] of the (approximate) direct prediction
    (the reference's bslice.py:314): the 8x8 predictions assembled into
    16x16 MBs, SATD over the MB's 4x4 blocks."""
    p8 = _direct_pred8(ref0_luma, ref1_luma, use0, use1, mv0_8, mv1_8, mbh,
                       mbw, w1)
    pred = mb_tiles(p8.reshape(2 * mbh, 2 * mbw, 8, 8).permute(0, 2, 1, 3)
                    .reshape(16 * mbh, 16 * mbw), 16)
    return QT.satd_tables(QT.wht16(mb_tiles(y, 16)), QT.wht16(pred)) \
        .reshape(mbh, mbw)


def _search16(y, planes, rng: int, mbh: int, mbw: int, lam: int):
    """One list entry of the 16x16 B analysis: B6 (zero predictor) on the
    full-pel plane, B7's windows on the four hpel planes, the qpel
    tables and the subpel refine against a zero predictor. planes [4,
    Hp, Wp] int32. Returns (mv [mbh,mbw,2] qpel, cost [mbh,mbw], blk
    [N,16,16] int16 the prediction at mv)."""
    p8 = planes.to(torch.uint8)
    mv_fp, _ = fullpel_search16(y, p8[0], rng, mbh, mbw, lam)
    blocks = QT.block_table(gather_windows(p8, mv_fp, mbh, mbw))
    zero = torch.zeros((mbh, mbw, 2), dtype=_I32, device=y.device)
    mv, r_idx, cost = subpel_cost_from_table(
        y, QT.wht_table(blocks), mv_fp, zero, mbh, mbw, lam)
    return mv, cost, QT.select_rows(blocks, r_idx)


def analyse_b_frame(y, refs0_luma, n_valid: int, ref1_luma, rng: int,
                    mbh: int, mbw: int, lam: int, w1=32):
    """The 16x16 B analysis (the reference's `analyse_b_frame_mref`,
    bslice.py:168; with one entry its `analyse_b_frame`, :121): per L0
    entry (refs0_luma [R, 4, Hp, Wp] int32, newest first) and on L1
    (ref1_luma [4, Hp, Wp]) `_search16`; the L0 entry chosen per MB by
    cost + lam * te(ref) bits (first minimum: ties keep the lower index;
    entries past n_valid carry a 1 << 28 penalty and still run); BI at
    the two winners, SATD of the weighted average (w1: an int, or an
    int32 tensor [R] of each L0 entry's implicit weight) plus both MVs'
    bits and the L0 ref bits. Returns (mv0, c0, ref0 [mbh,mbw] int32, mv1,
    c1, cbi)."""
    nrefs = refs0_luma.shape[0]
    n = mbh * mbw
    bits = te_ref_bits(nrefs)
    cs, mvs, blks = [], [], []
    for r in range(nrefs):
        mv, cost, blk = _search16(y, refs0_luma[r], rng, mbh, mbw, lam)
        cs.append(cost + lam * int(bits[r]) if r < n_valid
                  else torch.full_like(cost, 1 << 28))
        mvs.append(mv)
        blks.append(blk)
    c_st = torch.stack(cs)
    ref0 = torch.argmin(c_st, dim=0).to(_I32)
    c0 = c_st.min(0).values
    mv0 = _take(torch.stack(mvs), ref0)
    blk0 = _take(torch.stack(blks).reshape(nrefs, mbh, mbw, 16, 16), ref0)
    mv1, c1, blk1 = _search16(y, ref1_luma, rng, mbh, mbw, lam)
    if not isinstance(w1, int):     # each MB's L0 entry's weight
        w1 = w1[ref0.reshape(n).long()][:, None, None]
    bi = _bi_avg(blk0.reshape(n, 16, 16).to(_I32), blk1.to(_I32), w1)
    satd_bi = QT.satd_tables(QT.wht16(mb_tiles(y, 16)), QT.wht16(bi))
    rb = (lam * torch.as_tensor(bits, device=y.device)[ref0.long()]).to(_I32)
    cbi = satd_bi.reshape(mbh, mbw) + _mvc(mv0, lam) + _mvc(mv1, lam) + rb
    return mv0, c0, ref0, mv1, c1, cbi.to(_I32)


def analyse_b_parts(y, refs0_luma, ref1_luma, st0, st1, c_dir8,
                    ref0_map, mbh: int, mbw: int, lam: int, w1: int = 32):
    """Stage 2 of the B partition analysis, the reference's
    `analyse_b_parts` (bslice.py:580) at subpel 2.

    refs0_luma: the stacked L0 list [R, 4, Hp, Wp] int32 hpel planes,
    ref0_map [mbh, mbw] each MB's entry; ref1_luma [4, Hp, Wp]. st0/st1:
    stage-1 states; c_dir8 [mbh, mbw, 4] the approximate direct SATDs.
    The windows of each list come from B9 (on L0 with each 8x8's entry)
    and the subpel refine is B3' against a zero predictor; every BI
    combine takes the scalar weight w1 (L0[0]'s, as in the reference,
    whatever entry an MB uses). Returns dict
    part [mbh,mbw], sel8 [mbh,mbw,4] (0 L0 / 1 L1 / 2 BI / 3 direct-8x8),
    mv0_8 / mv1_8 [2mbh,2mbw,2] qpel, c_cfg [mbh,mbw]."""
    dev = y.device
    n8 = 4 * mbh * mbw
    cur8 = _mb_blocks8(y, mbh, mbw)
    wcur8 = wht8_flat(cur8)
    zero = torch.zeros((mbh, mbw, 2), dtype=_I32, device=dev)
    r8_map = ref0_map.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .contiguous()
    ue = [int(b) for b in _UE_BITS]

    f0 = _shape_mv_fields(st0)
    f1 = _shape_mv_fields(st1)
    # exact full-pel BI SAD per shape at the shape's unit MVs
    bi_unit = []
    for s in range(4):
        w0 = _gather8_fp(refs0_luma[:, 0], z_to_sp(f0[s], mbh, mbw),
                         mbh, mbw, r8=r8_map.reshape(n8))
        wl1 = _gather8_fp(ref1_luma[0], z_to_sp(f1[s], mbh, mbw), mbh,
                          mbw)
        sad = torch.abs(cur8 - _bi_avg(w0, wl1, w1)).sum((1, 2),
                                                          dtype=_I32)
        sadz = sp_to_z(sad.reshape(2 * mbh, 2 * mbw), mbh, mbw)
        bi_unit.append(_unit_reduce(sadz, s) + _mvc(f0[s], lam, 4)
                       + _mvc(f1[s], lam, 4))

    # full-pel shape + combo decision (SAD level)
    tot16 = torch.stack([st0["c16"] + lam * ue[1], st1["c16"] + lam * ue[2],
                         bi_unit[0][..., 0] + lam * ue[3]]).min(0).values

    def two_part(ca, cb, ue_tab):
        combos = ca[:, None] + cb[None, :] \
            + lam * const(ue_tab, dev)[:, :, None, None]
        combos = combos.reshape(9, mbh, mbw)
        return torch.argmin(combos, 0), combos.min(0).values

    _, tot16x8 = two_part(
        torch.stack([st0["c16x8"][..., 0], st1["c16x8"][..., 0],
                     bi_unit[1][..., 0]]),
        torch.stack([st0["c16x8"][..., 1], st1["c16x8"][..., 1],
                     bi_unit[1][..., 2]]), _UE_16X8)
    _, tot8x16 = two_part(
        torch.stack([st0["c8x16"][..., 0], st1["c8x16"][..., 0],
                     bi_unit[2][..., 0]]),
        torch.stack([st0["c8x16"][..., 1], st1["c8x16"][..., 1],
                     bi_unit[2][..., 1]]), _UE_8X16)
    tot8 = torch.stack([st0["c8"] + lam * ue[1], st1["c8"] + lam * ue[2],
                        bi_unit[3] + lam * ue[3]]).min(0).values \
        .sum(-1, dtype=_I32) + lam * ue[22]
    part = torch.argmin(torch.stack([tot16, tot16x8, tot8x16, tot8]),
                        0).to(_I32)

    # subpel refinement per list at the chosen shape
    outs = []
    for planes, f, ref8 in ((refs0_luma, f0, r8_map),
                            (ref1_luma, f1, None)):
        mvfp8 = z_to_sp(_take(f, part), mbh, mbw).contiguous()
        win = gather_windows8(planes.to(torch.uint8), mvfp8, mbh, mbw,
                              ref8=ref8)
        mv8, r_idx8 = subpel(y, win, part, mvfp8, zero, lam, mbh, mbw)
        roy = torch.div(r_idx8, 13, rounding_mode="floor") - 6
        blk = block_row8(win, roy, r_idx8 % 13 - 6).to(_I32)
        outs.append((mv8, blk))
    (mv8_0, blk0), (mv8_1, blk1) = outs

    def satd_z(blk):
        s = satd_flat(wcur8, wht8_flat(blk))
        return sp_to_z(s.reshape(2 * mbh, 2 * mbw), mbh, mbw)

    s0z, s1z = satd_z(blk0), satd_z(blk1)
    sbz = satd_z(_bi_avg(blk0, blk1, w1))
    mv0z = sp_to_z(mv8_0, mbh, mbw)
    mv1z = sp_to_z(mv8_1, mbh, mbw)

    def take_unit(sz):
        return _take(torch.stack([_unit_reduce(sz, s) for s in range(4)]),
                     part)

    cu0 = take_unit(s0z) + _mvc(mv0z, lam)
    cu1 = take_unit(s1z) + _mvc(mv1z, lam)
    cub = take_unit(sbz) + _mvc(mv0z, lam) + _mvc(mv1z, lam)

    # final combo choice at SATD level
    c16f = torch.stack([cu0[..., 0] + lam * ue[1], cu1[..., 0] + lam * ue[2],
                        cub[..., 0] + lam * ue[3]])
    sel16f = torch.argmin(c16f, 0)
    tot16f = c16f.min(0).values

    def unit_costs(u):
        return torch.stack([cu0[..., u], cu1[..., u], cub[..., u]])

    sel_h, tot_h = two_part(unit_costs(0), unit_costs(2), _UE_16X8)
    sel_v, tot_v = two_part(unit_costs(0), unit_costs(1), _UE_8X16)
    c8f = torch.stack([cu0 + lam * ue[3], cu1 + lam * ue[3],
                       cub + lam * ue[5], c_dir8 + lam * ue[1]])
    sel8x8 = torch.argmin(c8f, 0)
    tot8f = c8f.min(0).values.sum(-1, dtype=_I32) + lam * ue[22]
    c_cfg = _take(torch.stack([tot16f, tot_h, tot_v, tot8f]), part)
    sel8 = _take(torch.stack([
        sel16f[..., None].expand(mbh, mbw, 4),
        torch.stack([sel_h // 3, sel_h // 3, sel_h % 3, sel_h % 3], -1),
        torch.stack([sel_v // 3, sel_v % 3, sel_v // 3, sel_v % 3], -1),
        sel8x8]), part).to(_I32)
    return dict(part=part, sel8=sel8, mv0_8=mv8_0, mv1_8=mv8_1, c_cfg=c_cfg)


# ---------------------------------------------------------------------------
# Host MVP grid, spatial direct derivation and raster commit (spec
# 8.4.1.2.2 / 8.4.1.3; the reference's encoder/scan.py _Grid + unit_mvp)
# ---------------------------------------------------------------------------

class _Grid:
    """4x4-granularity MV field + ref field + decoded mask of one list."""

    def __init__(self, mbh, mbw):
        self.h4, self.w4 = 4 * mbh, 4 * mbw
        self.mv = np.zeros((self.h4, self.w4, 2), np.int32)
        self.ref = np.full((self.h4, self.w4), -1, np.int32)
        self.dec = np.zeros((self.h4, self.w4), bool)

    def nb(self, y4, x4):
        """(mv, ref, available); unavailable = outside or not yet coded."""
        if 0 <= y4 < self.h4 and 0 <= x4 < self.w4 and self.dec[y4, x4]:
            return self.mv[y4, x4], int(self.ref[y4, x4]), True
        return np.zeros(2, np.int32), -1, False

    def commit(self, y4, x4, h4, w4, mv, ref=0):
        self.mv[y4:y4 + h4, x4:x4 + w4] = mv
        self.ref[y4:y4 + h4, x4:x4 + w4] = ref
        self.dec[y4:y4 + h4, x4:x4 + w4] = True


def unit_mvp(g: _Grid, y4, x4, w4, part, unit, ref=0):
    """MVP of one partition unit (spec 8.4.1.3; x264 macroblock.c:28-145)
    with the same-reference rules."""
    mva, ra, av_a = g.nb(y4, x4 - 1)
    mvb, rb, av_b = g.nb(y4 - 1, x4)
    mvc, rc, av_c = g.nb(y4 - 1, x4 + w4)
    if not av_c:
        mvc, rc, av_c = g.nb(y4 - 1, x4 - 1)
    if part == D_16x8:
        if unit == 0 and av_b and rb == ref:
            return mvb.copy()
        if unit == 1 and av_a and ra == ref:
            return mva.copy()
    elif part == D_8x16:
        if unit == 0 and av_a and ra == ref:
            return mva.copy()
        if unit == 1 and av_c and rc == ref:
            return mvc.copy()
    match = [av_a and ra == ref, av_b and rb == ref, av_c and rc == ref]
    if sum(match) == 1:
        return (mva if match[0] else mvb if match[1] else mvc).copy()
    if not av_b and not av_c and av_a:
        return mva.copy()
    return np.median(np.stack([mva, mvb, mvc]), axis=0).astype(np.int32)


# per-8x8 colocated corner 4x4 (direct_8x8_inference_flag == 1)
_COL_CORNERS = [(0, 0), (0, 3), (3, 0), (3, 3)]


def _col_zero(col_mv4, col_ref4, y4, x4, cy, cx) -> bool:
    """colZeroFlag: the colocated block's own reference is 0 and its MV
    within +-1 in both components."""
    colm = col_mv4[y4 + cy, x4 + cx]
    return (int(col_ref4[y4 + cy, x4 + cx]) == 0 and abs(int(colm[0])) <= 1
            and abs(int(colm[1])) <= 1)


def spatial_direct(g0: _Grid, g1: _Grid, col_mv4, col_ref4, my: int,
                   mx: int):
    """Spatial direct MVs of one MB (spec 8.4.1.2.2: refIdxLX =
    MinPositive over the A/B/C neighbours, ref-matched median MVP).
    col_mv4/col_ref4: the L1[0] anchor's motion field. Returns (use0,
    use1, mv0 [4,2], mv1 [4,2] per 8x8 z-order, refIdxL0, refIdxL1) with
    the refs 0 under directZeroPrediction."""
    y4, x4 = 4 * my, 4 * mx
    refs, mvps = [], []
    for g in (g0, g1):
        _, ra, _ = g.nb(y4, x4 - 1)
        _, rb, _ = g.nb(y4 - 1, x4)
        _, rc, av_c = g.nb(y4 - 1, x4 + 4)
        if not av_c:
            _, rc, _ = g.nb(y4 - 1, x4 - 1)
        cand = [r for r in (ra, rb, rc) if r >= 0]
        ref = min(cand) if cand else -1
        refs.append(ref)
        mvps.append(unit_mvp(g, y4, x4, 4, D_16x16, 0, ref=ref)
                    if ref >= 0 else np.zeros(2, np.int32))
    mv0 = np.zeros((4, 2), np.int32)
    mv1 = np.zeros((4, 2), np.int32)
    if refs[0] < 0 and refs[1] < 0:
        return True, True, mv0, mv1, 0, 0
    use0, use1 = refs[0] >= 0, refs[1] >= 0
    for b, (cy, cx) in enumerate(_COL_CORNERS):
        cz = _col_zero(col_mv4, col_ref4, y4, x4, cy, cx)
        for use, ref, mvp, out in ((use0, refs[0], mvps[0], mv0),
                                   (use1, refs[1], mvps[1], mv1)):
            if use:
                out[b] = 0 if (ref == 0 and cz) else mvp
    return use0, use1, mv0, mv1, max(refs[0], 0), max(refs[1], 0)


def approx_direct_fields(mv0, mv1, col_mv4, col_ref4):
    """Approximate direct fields for the device direct cost: every MB
    taken as committed L0 at mv0 / L1 at mv1 (qpel [mbh, mbw, 2] numpy),
    exact only where the neighbours keep those modes; the committed
    direct MVs are re-derived exactly in `scan_b_parts`. Returns (use0,
    use1, mv0_8, mv1_8) per 8x8 [2mbh, 2mbw(, 2)] int32."""
    mbh, mbw = mv0.shape[:2]
    outs = []
    for mv in (mv0, mv1):
        g = _Grid(mbh, mbw)
        g.mv[:] = np.repeat(np.repeat(mv, 4, 0), 4, 1)
        g.ref[:] = 0
        g.dec[:] = True
        dmv8 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
        for my in range(mbh):
            for mx in range(mbw):
                y4, x4 = 4 * my, 4 * mx
                mvp = unit_mvp(g, y4, x4, 4, D_16x16, 0, ref=0)
                for b, (cy, cx) in enumerate(_COL_CORNERS):
                    dmv8[2 * my + (b >> 1), 2 * mx + (b & 1)] = \
                        0 if _col_zero(col_mv4, col_ref4, y4, x4, cy, cx) \
                        else mvp
        outs.append(dmv8)
    ones = np.ones((2 * mbh, 2 * mbw), np.int32)
    return ones, ones.copy(), outs[0], outs[1]


def dist_scale_factor(poc_b: int, poc0: int, poc1: int) -> int:
    """DistScaleFactor of temporal direct (spec 8.4.1.2.3; the reference's
    `dist_scale_factor`): poc0 the L0 entry's POC, poc1 L1[0]'s; 256 at
    td = 0; C's division, which truncates toward zero."""
    td = int(np.clip(poc1 - poc0, -128, 127))
    tb = int(np.clip(poc_b - poc0, -128, 127))
    if td == 0:
        return 256
    tx = (16384 + abs(td) // 2) // abs(td) * (1 if td > 0 else -1)
    return int(np.clip((tb * tx + 32) >> 6, -1024, 1023))


def temporal_direct_fields(col_mv4, col_ref4, dsf, col_map=None):
    """Temporal direct of a whole frame (spec 8.4.1.2.3; the reference's
    `temporal_direct_fields`, x264_mb_predict_mv_direct16x16_temporal).
    Per 8x8 (direct_8x8_inference) the colocated corner 4x4 of L1[0]'s
    field scales: mvL0 = (DSF mvCol + 128) >> 8, mvL1 = mvL0 - mvCol.
    col_ref4 -1 is colocated intra (zeros, ref 0); <= -2 a block with no
    L0 motion (a reference B's L1-only block), which makes the whole MB
    direct-unavailable. dsf: a scalar, or [R] per L0 entry, each block
    scaling by its mapped entry's. col_map [Rcol]: map_col_to_list0 by
    POC, -1 where the colocated reference is not in the active L0 (the MB
    is then direct-unavailable); None keeps the identity. Unlike spatial
    direct nothing depends on the neighbours' commits, so the field is
    computed once a frame, on the host. Returns (avail [mbh,mbw] bool,
    mv0_8 [2mbh,2mbw,2], mv1_8, ref8_0 [2mbh,2mbw])."""
    h4, w4 = col_ref4.shape
    mbh, mbw = h4 // 4, w4 // 4
    iy = np.arange(2 * mbh)
    ix = np.arange(2 * mbw)
    cy = (iy // 2) * 4 + (iy % 2) * 3   # the corner 4x4 of each 8x8
    cx = (ix // 2) * 4 + (ix % 2) * 3
    colm = col_mv4[np.ix_(cy, cx)].astype(np.int64)
    colr = col_ref4[np.ix_(cy, cx)]
    intra = colr == -1
    unused = colr <= -2
    mref = isinstance(dsf, np.ndarray) and dsf.ndim == 1
    if col_map is not None:
        cm = np.asarray(col_map, np.int32)
        mapped = np.where(colr < 0, 0, cm[np.clip(colr, 0, len(cm) - 1)])
        ok8 = intra | (~unused & (mapped >= 0))
        ref8 = np.maximum(mapped, 0).astype(np.int32)
    elif mref:
        ref8 = np.where(colr < 0, 0, colr).astype(np.int32)
        ok8 = intra | ~unused
    else:
        ref8 = np.zeros_like(colr, np.int32)
        ok8 = intra | (colr == 0)
    avail = ok8.reshape(mbh, 2, mbw, 2).all(axis=(1, 3))
    zero = colr < 0    # zeros for every block without L0 motion
    dsf_b = dsf[np.clip(ref8, 0, len(dsf) - 1)][..., None] if mref else dsf
    mv0 = (dsf_b * colm + 128) >> 8     # arithmetic shift, as in C
    mv1 = mv0 - colm
    mv0 = np.where(zero[..., None], 0, mv0).astype(np.int32)
    mv1 = np.where(zero[..., None], 0, mv1).astype(np.int32)
    return avail, mv0, mv1, ref8


def _tdir_mb(tdir, my: int, mx: int):
    """One MB of a precomputed temporal (or disabled) direct field:
    (use0, use1, mv0 [4,2], mv1 [4,2], ref8 [4] per 8x8 z-order)."""
    avail, tmv0, tmv1, tref = tdir
    ok = bool(avail[my, mx])
    sy, sx = slice(2 * my, 2 * my + 2), slice(2 * mx, 2 * mx + 2)
    return (ok, ok, tmv0[sy, sx].reshape(4, 2), tmv1[sy, sx].reshape(4, 2),
            tref[sy, sx].reshape(4))


def no_direct_fields(mbh: int, mbw: int):
    """`direct` 0 (x264 --direct none): every MB direct-unavailable, in
    `temporal_direct_fields`' layout."""
    return (np.zeros((mbh, mbw), bool),
            np.zeros((2 * mbh, 2 * mbw, 2), np.int32),
            np.zeros((2 * mbh, 2 * mbw, 2), np.int32),
            np.zeros((2 * mbh, 2 * mbw), np.int32))


def _direct_mb(g0, g1, col_mv4, col_ref4, tdir, my: int, mx: int):
    """The direct derivation of one MB: spatial from the committed grids
    (tdir None), else the precomputed field. Returns (use0, use1, mv0,
    mv1, ref8 [4] L0 refs, refIdxL1)."""
    if tdir is None:
        du0, du1, dmv0, dmv1, dr0, dr1 = spatial_direct(
            g0, g1, col_mv4, col_ref4, my, mx)
        return du0, du1, dmv0, dmv1, np.full(4, dr0, np.int32), dr1
    return _tdir_mb(tdir, my, mx) + (0,)


def _commit_intra(g0, g1, y4: int, x4: int) -> None:
    """An intra MB in both lists' grids: available, mv 0, ref -1."""
    g0.commit(y4, x4, 4, 4, 0, ref=-1)
    g1.commit(y4, x4, 4, 4, 0, ref=-1)


# unit geometry per B shape: (member blocks, oy4, ox4, h4, w4, mvp kind)
_B_UNIT_GEOM = {
    0: [((0, 1, 2, 3), 0, 0, 4, 4, D_16x16)],
    1: [((0, 1), 0, 0, 2, 4, D_16x8), ((2, 3), 2, 0, 2, 4, D_16x8)],
    2: [((0, 2), 0, 0, 4, 2, D_8x16), ((1, 3), 0, 2, 4, 2, D_8x16)],
    3: [((0,), 0, 0, 2, 2, 3), ((1,), 0, 2, 2, 2, 3),
        ((2,), 2, 0, 2, 2, 3), ((3,), 2, 2, 2, 2, 3)],
}


def scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir, col_mv4, col_ref4,
                 lam: int, ref0=None, tdir=None, intra=None):
    """Host raster commit of the B partition path (the reference's
    bslice.py:975): the exact direct derivation (spatial
    on the committed grids, or tdir, a precomputed temporal or disabled
    field), direct-vs-config decision (direct wins where available at
    c_dir + lam <= c_cfg), per-unit MVP/mvd for both lists in
    all-L0-then-all-L1 order (a later unit's MVP sees this MB's earlier
    units, spec 8.4.1.3).

    part/sel8/c_cfg: `analyse_b_parts` outputs (numpy); mv0z/mv1z
    [mbh,mbw,4,2] z-order qpel; c_dir [mbh,mbw] the 16x16-direct SATD;
    ref0 [mbh,mbw] each MB's L0 entry under multi-reference (None: 0);
    intra [mbh,mbw] bool the MBs the intra compare switched (None: none):
    they carry no motion and are committed as available neighbours with
    mv 0 and ref -1 in both lists (x264's cache, macroblock.c:28-46), as
    the decoder holds them.
    Returns (code [mbh,mbw] mb_type ue, subs [mbh,mbw,4] sub_mb_type ue
    (code 22), use0/use1 [2mbh,2mbw], fmv0/fmv1 [2mbh,2mbw,2], mvd0/mvd1
    [mbh,mbw,4,2] per unit in coding order, ref8_0 [2mbh,2mbw], -1 where
    L0 is unused)."""
    mbh, mbw = part.shape
    g0, g1 = _Grid(mbh, mbw), _Grid(mbh, mbw)
    code = np.zeros((mbh, mbw), np.int32)
    subs = np.zeros((mbh, mbw, 4), np.int32)
    use0 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    use1 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    fmv0 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    fmv1 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    mvd0 = np.zeros((mbh, mbw, 4, 2), np.int32)
    mvd1 = np.zeros((mbh, mbw, 4, 2), np.int32)
    ref8_0 = np.full((2 * mbh, 2 * mbw), -1, np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            y4, x4 = 4 * my, 4 * mx
            if intra is not None and intra[my, mx]:
                _commit_intra(g0, g1, y4, x4)
                continue
            du0, du1, dmv0, dmv1, dr8, _ = _direct_mb(
                g0, g1, col_mv4, col_ref4, tdir, my, mx)
            r0 = int(ref0[my, mx]) if ref0 is not None else 0
            if du0 and c_dir[my, mx] + lam <= c_cfg[my, mx]:
                # B_Direct_16x16 (code 0), committed per 8x8
                for b in range(4):
                    sy, sx = 2 * my + (b >> 1), 2 * mx + (b & 1)
                    use0[sy, sx] = int(du0)
                    use1[sy, sx] = int(du1)
                    fmv0[sy, sx] = dmv0[b]
                    ref8_0[sy, sx] = dr8[b]
                    if du1:
                        fmv1[sy, sx] = dmv1[b]
                    g0.commit(2 * sy, 2 * sx, 2, 2, dmv0[b],
                              ref=int(dr8[b]))
                    g1.commit(2 * sy, 2 * sx, 2, 2, dmv1[b],
                              ref=0 if du1 else -1)
                continue
            p = int(part[my, mx])
            if p == 0:
                code[my, mx] = 1 + int(sel8[my, mx, 0])
            elif p == 1:
                code[my, mx] = B_CODE_16X8[int(sel8[my, mx, 0]),
                                           int(sel8[my, mx, 2])]
            elif p == 2:
                code[my, mx] = B_CODE_8X16[int(sel8[my, mx, 0]),
                                           int(sel8[my, mx, 1])]
            else:
                code[my, mx] = 22
                subs[my, mx] = _B_SUB_CODE[sel8[my, mx]]
            for li, (g, mvz, duse, dmv, usearr, fmvarr, mvdarr) in \
                    enumerate(((g0, mv0z, du0, dmv0, use0, fmv0, mvd0),
                               (g1, mv1z, du1, dmv1, use1, fmv1, mvd1))):
                for u, (blocks, oy, ox, h4, w4, kind) in \
                        enumerate(_B_UNIT_GEOM[p]):
                    s = int(sel8[my, mx, blocks[0]])
                    if s == 3:    # direct 8x8 sub-mode (B_8x8 only)
                        b = blocks[0]
                        sy, sx = 2 * my + (b >> 1), 2 * mx + (b & 1)
                        usearr[sy, sx] = int(duse)
                        rd = int(dr8[b]) if li == 0 else 0
                        if duse:
                            fmvarr[sy, sx] = dmv[b]
                            if li == 0:
                                ref8_0[sy, sx] = rd
                        g.commit(2 * sy, 2 * sx, 2, 2, dmv[b],
                                 ref=rd if duse else -1)
                        continue
                    uses = s == li or s == 2
                    ur = r0 if li == 0 else 0
                    mv = mvz[my, mx, blocks[0]].copy() if uses \
                        else np.zeros(2, np.int32)
                    if uses:
                        mvdarr[my, mx, u] = mv - unit_mvp(
                            g, y4 + oy, x4 + ox, w4, kind, u, ref=ur)
                    for b in blocks:
                        sy, sx = 2 * my + (b >> 1), 2 * mx + (b & 1)
                        usearr[sy, sx] = int(uses)
                        if uses:
                            fmvarr[sy, sx] = mv
                            if li == 0:
                                ref8_0[sy, sx] = ur
                    g.commit(y4 + oy, x4 + ox, h4, w4, mv,
                             ref=ur if uses else -1)
    return code, subs, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0


def scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4, lam: int,
                 ref0=None, tdir=None, intra=None):
    """Host raster commit of the 16x16 B path (the reference's
    bslice.py:1102): per MB the exact direct derivation
    (spatial, or tdir as in `scan_b_parts`), the mode by the first
    minimum of
    c + lam * mb_type bits over direct / L0 / L1 / BI (direct only where
    it has a list), the MVP and mvd of the chosen lists.

    c_dir/c0/c1/cbi [mbh,mbw] costs; mv0/mv1 [mbh,mbw,2] qpel; ref0
    [mbh,mbw] each MB's L0 entry under multi-reference (None: 0); intra
    as in `scan_b_parts`.
    Returns (mode [mbh,mbw] in {0 direct, 1 L0, 2 L1, 3 BI}, use0/use1
    [2mbh,2mbw], fmv0/fmv1 [2mbh,2mbw,2], mvd0/mvd1 [mbh,mbw,2], ref8_0
    [2mbh,2mbw], -1 where L0 is unused)."""
    mbh, mbw = c0.shape
    g0, g1 = _Grid(mbh, mbw), _Grid(mbh, mbw)
    mode = np.zeros((mbh, mbw), np.int32)
    use0 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    use1 = np.zeros((2 * mbh, 2 * mbw), np.int32)
    fmv0 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    fmv1 = np.zeros((2 * mbh, 2 * mbw, 2), np.int32)
    mvd0 = np.zeros((mbh, mbw, 2), np.int32)
    mvd1 = np.zeros((mbh, mbw, 2), np.int32)
    ref8_0 = np.full((2 * mbh, 2 * mbw), -1, np.int32)
    hdr = _B_HDR_BITS
    for my in range(mbh):
        for mx in range(mbw):
            y4, x4 = 4 * my, 4 * mx
            if intra is not None and intra[my, mx]:
                _commit_intra(g0, g1, y4, x4)
                continue
            du0, du1, dmv0, dmv1, dr8, dr1 = _direct_mb(
                g0, g1, col_mv4, col_ref4, tdir, my, mx)
            cands = np.array([
                (int(c_dir[my, mx]) if du0 or du1 else (1 << 60))
                + lam * hdr[0],
                int(c0[my, mx]) + lam * hdr[1],
                int(c1[my, mx]) + lam * hdr[2],
                int(cbi[my, mx]) + lam * hdr[3]], np.int64)
            m = int(np.argmin(cands))
            mode[my, mx] = m
            sy, sx = slice(2 * my, 2 * my + 2), slice(2 * mx, 2 * mx + 2)
            if m == 0:
                use0[sy, sx] = int(du0)
                use1[sy, sx] = int(du1)
                fmv0[sy, sx] = dmv0.reshape(2, 2, 2)
                fmv1[sy, sx] = dmv1.reshape(2, 2, 2)
                if du0:
                    ref8_0[sy, sx] = dr8.reshape(2, 2)
                for b in range(4):
                    by, bx = y4 + 2 * (b >> 1), x4 + 2 * (b & 1)
                    g0.commit(by, bx, 2, 2, dmv0[b],
                              ref=int(dr8[b]) if du0 else -1)
                    g1.commit(by, bx, 2, 2, dmv1[b], ref=dr1 if du1 else -1)
                continue
            r0 = int(ref0[my, mx]) if ref0 is not None else 0
            u0i, u1i = int(m in (1, 3)), int(m in (2, 3))
            if u0i:
                mvd0[my, mx] = mv0[my, mx] - unit_mvp(g0, y4, x4, 4, D_16x16,
                                                      0, ref=r0)
            if u1i:
                mvd1[my, mx] = mv1[my, mx] - unit_mvp(g1, y4, x4, 4, D_16x16,
                                                      0, ref=0)
            use0[sy, sx] = u0i
            use1[sy, sx] = u1i
            if u0i:
                fmv0[sy, sx] = mv0[my, mx]
                ref8_0[sy, sx] = r0
            if u1i:
                fmv1[sy, sx] = mv1[my, mx]
            zero = np.zeros(2, np.int32)
            g0.commit(y4, x4, 4, 4, mv0[my, mx] if u0i else zero,
                      ref=r0 if u0i else -1)
            g1.commit(y4, x4, 4, 4, mv1[my, mx] if u1i else zero,
                      ref=0 if u1i else -1)
    return mode, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0


# ---------------------------------------------------------------------------
# The B encode
# ---------------------------------------------------------------------------

def _assemble_pred_b(refs0, ref1, use0, use1, mv0_8, mv1_8, ref8_0,
                     mbh: int, mbw: int, w1=32):
    """Bipred luma + chroma per 8x8 block (the reference's
    bslice.py:257). refs0: the stacked L0 list, dict 'luma' [R,4,Hp,Wp],
    'u', 'v' [R,Hp,Wp], and ref8_0 [2mbh,2mbw] each 8x8's entry (-1 where
    L0 is unused); ref1: dict 'luma' [4,Hp,Wp], 'u', 'v'; w1 the implicit
    weight, an int or an int32 tensor [2mbh,2mbw] per 8x8 block. Returns
    (pred_y [n,16,16], pred_u [n,8,8], pred_v)."""
    dev = use0.device
    n8 = 4 * mbh * mbw
    u0 = use0.reshape(n8)[:, None, None].to(torch.bool)
    u1 = use1.reshape(n8)[:, None, None].to(torch.bool)
    mv0f, mv1f = mv0_8.reshape(n8, 2), mv1_8.reshape(n8, 2)
    r8 = torch.clamp(ref8_0.reshape(n8), min=0)
    w8 = w1 if isinstance(w1, int) else w1.reshape(n8)[:, None, None]

    def combine(p0, p1, b):
        p = torch.where(u0 & u1, _bi_avg(p0, p1, w8),
                        torch.where(u0, p0, p1))
        return mb_tiles(p.reshape(2 * mbh, 2 * mbw, b, b).permute(0, 2, 1, 3)
                        .reshape(2 * b * mbh, 2 * b * mbw), 2 * b)

    ys8, xs8 = _block_origins(mbh, mbw, dev, 8)
    pred_y = combine(mc.mc_luma_multi(refs0["luma"], r8, ys8, xs8, mv0f, 8, 8),
                     mc.mc_luma(ref1["luma"], ys8, xs8, mv1f, 8, 8), 8)
    ysc, xsc = _block_origins(mbh, mbw, dev, 4)
    preds_c = []
    for pl in ("u", "v"):
        preds_c.append(combine(
            mc.mc_chroma_multi(refs0[pl], r8, ysc, xsc, mv0f, 4, 4),
            mc.mc_chroma(ref1[pl], ysc, xsc, mv1f, 4, 4), 4))
    return pred_y, preds_c[0], preds_c[1]


def encode_b_frame_device(y, u, v, refs0, ref1, use0, use1, mv0_8, mv1_8,
                          ref8_0, qp, qpc, mbh: int,
                          mbw: int, w1=32, trellis: bool = False,
                          tables=None) -> dict:
    """The B encode at per-8x8 (use, mv) fields of both lists, the
    reference's `encode_b_frame_device` (bslice.py:340) with decimation
    on: the bipred prediction at the implicit weight w1
    (`_assemble_pred_b`), the 4x4 luma encode by the fused luma-encode
    kernel (one launch on CUDA, decimation in the kernel; with `trellis`
    from the inter trellis's levels), the chroma encode as on the P path,
    all with the inter class of `tables` (None: flat; never noise
    reduction, as in the reference). qp/qpc are ints, or per-MB [mbh,
    mbw] grids under adaptive quantization (the reference's bslice.py:
    352-355). Returns the P encode's result dict."""
    qp, qpc = mb_qps(qp, qpc, mbh * mbw, y.device)
    pred_y, pred_u, pred_v = _assemble_pred_b(
        refs0, ref1, use0, use1, mv0_8, mv1_8, ref8_0, mbh, mbw, w1)
    pred_y = pred_y.contiguous()
    levels = trellis_luma_levels(y, pred_y, qp, tables) if trellis else None
    lev, rec, cbp_l = luma_p_encode(y, pred_y, qp, levels=levels,
                                    tables=tables)
    fz = torch.zeros(mbh * mbw, dtype=torch.bool, device=y.device)
    chroma = [chroma_encode(mb_tiles(plane, 8), predc, qpc, fz, trellis,
                            tables)
              for plane, predc in ((u, pred_u), (v, pred_v))]
    return _p_result(lev, rec, cbp_l, chroma, mbh, mbw)
