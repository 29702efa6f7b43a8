"""Verification decoder: Annex-B H.264 (baseline subset) -> planes + MB info.

Independent of the encoder internals (shares only the spec constant
tables). Purpose (SURVEY.md §4.3): prove the encoder's reconstruction
matches a conforming decoder bit-exactly, and expose the motion-vector
field for the blind stego extractor (the reference never shipped its
extractor — stc_extract include commented out, analyse.c:43).

The port's copy of the reference's decoder/decoder.py, cut to the paths
that the port's streams take: I/P slices under CAVLC or CABAC
(I16x16/I4x4/I8x8, P partitions incl. sub-8x8, the adaptive 8x8
transform, P_SKIP, sliding-window DPB, L0 reordering) and B slices
under CAVLC or CABAC (B_Skip, B_Direct_16x16 and direct 8x8 subs under
spatial or temporal direct, the 16x16 L0/L1/BI types, the 16x8/8x16
combos, B_8x8 with direct/L0/L1/BI subs, intra MBs, multi-reference L0
lists, the default B list order, implicit weighted bipred, reference B
slices entering the DPB, deblocked B slices with the two-list bS, POC
output order), with the SPS's scaling lists (held per decode in each
slice's `recon.Dequant`); the CABAC parser is `cabac_dec.py`. Picture
scaling matrices, per-plane chroma scaling lists, explicit weighted
bipred (weighted_bipred_idc 1),
the 8x8 transform in B MBs, B sub-8x8
partitions, L1 reordering and more than one L1 reference raise
NotImplementedError. Per-MB QP changes (mb_qp_delta, adaptive
quantization) reach the dequant and the deblocker. The in-loop filter is
the port's `ops.deblock`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.bitstream import BitReader, nal_unescape
from ..encoder import vlc_tables as VT
from ..encoder.bslice import bipred_weight, dist_scale_factor
from ..encoder.vlc_tables import B_CODE_USES, B_SUB_USES
from ..ops import deblock as DB
from . import recon as R

# luma blkIdx -> (by, bx) and chroma blkIdx -> (by, bx) (the reference's
# encoder/cavlc.py LUMA_SCAN / CHROMA_SCAN)
LUMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
             (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]
CHROMA_SCAN = [(0, 0), (0, 1), (1, 0), (1, 1)]

# partition-unit geometry (y4_off, x4_off, w4, h4) per P mb_type 0..3, and
# per sub_mb_type (0=P_L0_8x8, 1=8x4, 2=4x8, 3=4x4) relative to its 8x8
# (the reference's encoder/scan.py UNIT_GEOM / SUB_GEOM)
UNIT_GEOM = {
    0: [(0, 0, 4, 4)],
    1: [(0, 0, 4, 2), (2, 0, 4, 2)],
    2: [(0, 0, 2, 4), (0, 2, 2, 4)],
    3: [(0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2), (2, 2, 2, 2)],
}
SUB_GEOM = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (1, 0, 2, 1)],
    2: [(0, 0, 1, 2), (0, 1, 1, 2)],
    3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
}


def mb_units(part: int, subs=None):
    """Unit geometry of one MB in coding order (the reference's
    encoder/scan.py mb_units)."""
    if part != 3:
        return UNIT_GEOM[part]
    out = []
    for b in range(4):
        boy, box = 2 * (b >> 1), 2 * (b & 1)
        st = 0 if subs is None else int(subs[b])
        for (soy, sox, w4, h4) in SUB_GEOM[st]:
            out.append((boy + soy, box + sox, w4, h4))
    return out


CHROMA_QP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39])]).astype(int)


def _build_decode_map(codes, values):
    m = {}
    for code, val in zip(codes, values):
        if code:
            m[code] = val
    return m

# coeff_token decode maps per table: bitstring -> (total_coeff, t1s)
_CT_MAPS = []
for _tab in range(5):
    codes = list(VT.COEFF_TOKEN[_tab])
    vals = [((i // 4) + 1, i % 4) for i in range(64)]
    codes.append(VT.COEFF0[_tab])
    vals.append((0, 0))
    _CT_MAPS.append(_build_decode_map(codes, vals))

_TZ_MAPS = [_build_decode_map(row, range(16)) for row in VT.TOTAL_ZEROS]
_TZDC_MAPS = [_build_decode_map(row, range(4)) for row in VT.TOTAL_ZEROS_DC]
_RB_MAPS = [_build_decode_map(row, range(15)) for row in VT.RUN_BEFORE]


def _read_vlc(br: BitReader, dmap: dict):
    s = ""
    for _ in range(20):
        s += str(br.read1())
        if s in dmap:
            return dmap[s]
    from ..utils.log import PcamvError
    raise PcamvError(f"VLC decode failure: {s}")


def read_residual(br: BitReader, max_coeff: int, nc: int) -> list[int]:
    """Spec 9.2 residual_block_cavlc. Returns scan-ordered levels."""
    if nc == -1:
        tab = 4
    elif nc < 2:
        tab = 0
    elif nc < 4:
        tab = 1
    elif nc < 8:
        tab = 2
    else:
        tab = 3
    tc, t1s = _read_vlc(br, _CT_MAPS[tab])
    levels = [0] * max_coeff
    if tc == 0:
        return levels

    vals = []
    for _ in range(t1s):
        vals.append(-1 if br.read1() else 1)
    sl = 1 if (tc > 10 and t1s < 3) else 0
    for i in range(tc - t1s):
        prefix = 0
        while br.read1() == 0:
            prefix += 1
            assert prefix < 32
        if sl == 0 and prefix == 14:
            sz = 4
        elif prefix >= 15:
            sz = prefix - 3
        else:
            sz = sl
        code = (min(15, prefix) << sl) + (br.read(sz) if sz else 0)
        if prefix >= 15 and sl == 0:
            code += 15
        if prefix >= 16:
            code += (1 << (prefix - 3)) - 4096
        if i == 0 and t1s < 3:
            code += 2
        val = (code + 2) >> 1 if code % 2 == 0 else -((code + 1) >> 1)
        vals.append(val)
        if sl == 0:
            sl = 1
        if abs(val) > (3 << (sl - 1)) and sl < 6:
            sl += 1

    if tc < max_coeff:
        if max_coeff == 4:
            tz = _read_vlc(br, _TZDC_MAPS[tc - 1])
        else:
            tz = _read_vlc(br, _TZ_MAPS[tc - 1])
    else:
        tz = 0

    # place coefficients: vals[0] is the highest-frequency coefficient
    runs = []
    zeros_left = tz
    for _ in range(tc - 1):
        if zeros_left > 0:
            run = _read_vlc(br, _RB_MAPS[min(zeros_left, 7) - 1])
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    pos = tc - 1 + tz
    for k, v in enumerate(vals):
        levels[pos] = v
        if k < len(runs):
            pos -= 1 + runs[k]
    return levels


# ---------------------------------------------------------------------------


@dataclass
class DecSPS:
    profile: int = 66
    width: int = 0
    height: int = 0
    log2_max_frame_num: int = 4
    num_ref_frames: int = 1
    poc_type: int = 2
    log2_max_poc_lsb: int = 10
    direct_8x8_inference: bool = True
    crop = (0, 0, 0, 0)
    level_idc: int = 0
    sps_id: int = 0
    # VUI (None when absent): dict with sar/fps/etc.
    vui: dict = None
    # seq scaling lists (None = flat): (intra4, inter4, intra8, inter8)
    scaling: tuple = None


@dataclass
class DecPPS:
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    num_ref_idx_l0_active: int = 1
    deblocking_control_present: bool = True
    transform_8x8: bool = False
    cabac: bool = False
    weighted_bipred_idc: int = 0


@dataclass
class MBInfo:
    """Per-MB decode record; MVs feed the blind extractor."""
    mb_type: str = "SKIP"  # "I16x16", "I4x4", "P16x16", "P16x8",
                           # "P8x16", "P8x8", "SKIP"
    mv: tuple = (0, 0)
    qp: int = 0
    unit_mvs: list = None  # partition-unit MVs in coding order


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    slice_type: int = 2
    mbs: list = field(default_factory=list)
    poc: int = 0


def parse_nals(data: bytes):
    """Split Annex-B stream into (nal_type, ref_idc, rbsp) tuples."""
    out = []
    i = 0
    n = len(data)
    starts = []
    while i < n - 3:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i < n - 4 and data[i + 2] == 0 and data[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim preceding zeros of the next start code
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        hdr = data[s]
        out.append((hdr & 0x1F, (hdr >> 5) & 3, nal_unescape(data[s + 1:e])))
    return out


def _parse_scaling_lists(br):
    """seq scaling lists (spec 7.3.2.1.1 scaling_list() + Table 7-2
    fall-back rule A), as the reference reads them. Returns (intra4,
    inter4, intra8, inter8) raster lists. Absent lists 0/3/6/7 fall to
    the spec defaults (= the JVT matrices); lists 1,2 / 4,5 must be
    absent (copies of 0 / 3: per-plane chroma lists are refused)."""
    from ..ops import cqm as Q
    from ..ops.transform import ZIGZAG_4x4
    from ..ops.transform8 import ZIGZAG_8x8

    def one(n, zz, default):
        if not br.read1():       # not present
            return None          # the caller applies the fall-back
        out = np.zeros(n, np.int64)
        last, nxt = 8, 8
        vals = np.zeros(n, np.int64)
        for j in range(n):
            if nxt != 0:
                delta = br.read_se()
                nxt = (last + delta + 256) % 256
                if j == 0 and nxt == 0:
                    return np.asarray(default, np.int64)  # use default
            last = last if nxt == 0 else nxt
            vals[j] = last
        out[zz[:, 0] * (4 if n == 16 else 8) + zz[:, 1]] = vals
        return out

    zz4 = np.asarray(ZIGZAG_4x4).reshape(-1, 2)
    zz8 = np.asarray(ZIGZAG_8x8).reshape(-1, 2)
    i4 = one(16, zz4, Q.JVT4I)
    for _ in range(2):          # lists 1,2 (intra Cb/Cr)
        if one(16, zz4, i4) is not None:
            raise NotImplementedError("per-plane chroma scaling lists")
    p4 = one(16, zz4, Q.JVT4P)
    for _ in range(2):          # lists 4,5 (inter Cb/Cr)
        if one(16, zz4, p4) is not None:
            raise NotImplementedError("per-plane chroma scaling lists")
    i8 = one(64, zz8, Q.JVT8I)
    p8 = one(64, zz8, Q.JVT8P)
    return tuple(np.asarray(d, np.int64) if v is None else v
                 for v, d in ((i4, Q.JVT4I), (p4, Q.JVT4P), (i8, Q.JVT8I),
                              (p8, Q.JVT8P)))


def parse_sps(rbsp: bytes) -> DecSPS:
    br = BitReader(rbsp)
    profile = br.read(8)
    br.read(8)  # constraints
    sps = DecSPS()
    sps.level_idc = br.read(8)
    sps.sps_id = br.read_ue()
    sps.profile = profile
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        # High-profile extension block (spec 7.3.2.1)
        chroma_format = br.read_ue()
        assert chroma_format == 1, "only 4:2:0 supported"
        assert br.read_ue() == 0 and br.read_ue() == 0, "8-bit only"
        br.read1()  # qpprime_y_zero_transform_bypass
        if br.read1():   # seq_scaling_matrix_present
            sps.scaling = _parse_scaling_lists(br)
    sps.log2_max_frame_num = br.read_ue() + 4
    sps.poc_type = br.read_ue()
    assert sps.poc_type in (0, 2), \
        f"unsupported poc_type {sps.poc_type}"
    if sps.poc_type == 0:
        sps.log2_max_poc_lsb = br.read_ue() + 4
    sps.num_ref_frames = br.read_ue()
    br.read1()
    mbw = br.read_ue() + 1
    mbh = br.read_ue() + 1
    frame_mbs_only = br.read1()
    assert frame_mbs_only == 1
    sps.direct_8x8_inference = bool(br.read1())
    crop = br.read1()
    cl = cr = ct = cb = 0
    if crop:
        cl, cr, ct, cb = (br.read_ue(), br.read_ue(),
                          br.read_ue(), br.read_ue())
    if br.read1():  # vui_parameters_present
        sps.vui = _parse_vui(br)
    sps.width = mbw * 16 - 2 * (cl + cr)
    sps.height = mbh * 16 - 2 * (ct + cb)
    sps.crop = (cl, cr, ct, cb)
    return sps


_SAR_TABLE = {1: (1, 1), 2: (12, 11), 3: (10, 11), 4: (16, 11),
              5: (40, 33), 6: (24, 11), 7: (20, 11), 8: (32, 11),
              9: (80, 33), 10: (18, 11), 11: (15, 11), 12: (64, 33),
              13: (160, 99)}


def _parse_vui(br) -> dict:
    """VUI parameters (spec E.1.1) — metadata surfaced for tests."""
    v = {}
    if br.read1():  # aspect_ratio_info
        idc = br.read(8)
        if idc == 255:
            v["sar"] = (br.read(16), br.read(16))
        else:
            v["sar"] = _SAR_TABLE.get(idc, (0, 0))
    if br.read1():  # overscan_info
        v["overscan"] = br.read1()
    if br.read1():  # signal_type
        v["videoformat"] = br.read(3)
        v["fullrange"] = br.read1()
        if br.read1():  # colour_description
            v["colorprim"] = br.read(8)
            v["transfer"] = br.read(8)
            v["colmatrix"] = br.read(8)
    if br.read1():  # chroma_loc_info
        v["chromaloc"] = (br.read_ue(), br.read_ue())
    if br.read1():  # timing_info
        num_units = br.read(32)
        time_scale = br.read(32)
        v["fps"] = (time_scale, 2 * num_units)  # fps = ts / (2*nuit)
        v["fixed_frame_rate"] = br.read1()
    assert br.read1() == 0  # nal_hrd
    assert br.read1() == 0  # vcl_hrd
    br.read1()  # pic_struct
    if br.read1():  # bitstream_restriction
        br.read1()
        br.read_ue()
        br.read_ue()
        v["log2_max_mv_h"] = br.read_ue()
        v["log2_max_mv_v"] = br.read_ue()
        v["num_reorder_frames"] = br.read_ue()
        v["max_dec_frame_buffering"] = br.read_ue()
    return v


def parse_pps(rbsp: bytes) -> DecPPS:
    br = BitReader(rbsp)
    pps = DecPPS()
    br.read_ue()  # pps id
    br.read_ue()  # sps id
    pps.cabac = bool(br.read1())  # entropy_coding_mode
    br.read1()  # pic_order_present
    assert br.read_ue() == 0, "slice groups unsupported"
    pps.num_ref_idx_l0_active = br.read_ue() + 1
    br.read_ue()
    br.read1()
    pps.weighted_bipred_idc = br.read(2)
    pps.pic_init_qp = 26 + br.read_se()
    br.read_se()
    pps.chroma_qp_index_offset = br.read_se()
    pps.deblocking_control_present = bool(br.read1())
    br.read1()
    br.read1()
    if br.more_rbsp_data():
        # FRExt tail (spec 7.3.2.2)
        pps.transform_8x8 = bool(br.read1())
        assert br.read1() == 0, "pic scaling matrices unsupported"
        br.read_se()  # second_chroma_qp_index_offset
    return pps


class SliceDecoder:
    """Decodes one frame (single slice)."""

    def __init__(self, sps: DecSPS, pps: DecPPS, refs=None, refs_l1=None,
                 poc: int = 0, direct_spatial: bool = True):
        self.sps, self.pps = sps, pps
        # the dequant with the stream's scaling lists
        self.Q = R.Dequant(sps.scaling)
        # the slice's L0 list (P: most recent reference first)
        self.refs = refs or []
        self.refs_l1 = refs_l1 or []   # B-slice list 1 (future anchor)
        self.p_l0_active = None  # P-slice num_ref override (7.4.3)
        self.b_l0_active = 1     # B-slice effective L0 size
        self.direct_spatial = direct_spatial
        # per L0 entry: the implicit bipred weight of the L1 prediction
        # (weighted_bipred_idc 2, spec 8.4.2.3.2; x264's
        # bipred_weight[i_ref0][0]) and temporal direct's DistScaleFactor
        # (spec 8.4.1.2.3), from the POC distances of the actual entries
        n0 = max(1, len(self.refs))
        self.bipred_w1_tab = [32] * n0
        self._dsf_tab = [256] * n0
        if self.refs and self.refs_l1:
            poc1 = self.refs_l1[0]["poc"]
            if pps.weighted_bipred_idc == 2:
                self.bipred_w1_tab = [
                    bipred_weight(poc, e["poc"], poc1, True)
                    for e in self.refs]
            if not direct_spatial:
                self._dsf_tab = [dist_scale_factor(poc, e["poc"], poc1)
                                 for e in self.refs]
        self.mbw = (sps.width + 15) // 16
        self.mbh = (sps.height + 15) // 16
        self.y = np.zeros((self.mbh * 16, self.mbw * 16), np.int64)
        self.u = np.zeros((self.mbh * 8, self.mbw * 8), np.int64)
        self.v = np.zeros((self.mbh * 8, self.mbw * 8), np.int64)
        self.nnz_y = np.zeros((4 * self.mbh, 4 * self.mbw), np.int32)
        self.nnz_c = np.zeros((2, 2 * self.mbh, 2 * self.mbw), np.int32)
        # i4x4 mode map for predIntra4x4PredMode (2 = not i4x4-coded)
        self.modes4 = np.full((4 * self.mbh, 4 * self.mbw), 2, np.int32)
        self.mb_intra = np.zeros((self.mbh, self.mbw), bool)
        self.mb_skip = np.zeros((self.mbh, self.mbw), bool)
        self.mb_trans8 = np.zeros((self.mbh, self.mbw), bool)
        # per-8x8 coeff counts of trans8 inter MBs (deblock bS reads the
        # 8x8's count through every covered 4x4 cell, while nnz_y keeps
        # the interleaved sub-block counts for CAVLC nC)
        self.nnz8 = np.zeros((2 * self.mbh, 2 * self.mbw), np.int32)
        # 4x4-granularity MV field (the reference's cache.mv): supports
        # all partition shapes uniformly
        self.mv4 = np.zeros((4 * self.mbh, 4 * self.mbw, 2), np.int32)
        self.ref4 = np.full((4 * self.mbh, 4 * self.mbw), -1, np.int32)
        # list-1 motion fields (B slices only)
        self.mv4_1 = np.zeros((4 * self.mbh, 4 * self.mbw, 2), np.int32)
        self.ref4_1 = np.full((4 * self.mbh, 4 * self.mbw), -1, np.int32)
        self.dec4 = np.zeros((4 * self.mbh, 4 * self.mbw), bool)
        self.decoded = np.zeros((self.mbh, self.mbw), bool)
        self.mbs: list[MBInfo] = []

    def _nc(self, arr, by, bx):
        has_l, has_t = bx > 0, by > 0
        if has_l and has_t:
            return int(arr[by, bx - 1] + arr[by - 1, bx] + 1) >> 1
        if has_l:
            return int(arr[by, bx - 1])
        if has_t:
            return int(arr[by - 1, bx])
        return 0

    def decode_i16x16(self, br: BitReader, mx: int, my: int, mb_type: int,
                      qp: int):
        mode = (mb_type - 1) % 4
        cbp_chroma = ((mb_type - 1) // 4) % 3
        cbp_luma = 15 if (mb_type - 1) >= 12 else 0
        cmode = br.read_ue()
        qp_delta = br.read_se()
        qp = (qp + qp_delta + 52) % 52   # spec 7.4.5 QP chain
        qpc = int(CHROMA_QP[np.clip(qp + self.pps.chroma_qp_index_offset,
                                    0, 51)])

        gx, gy = 16 * mx, 16 * my
        at, al = my > 0, mx > 0
        top = self.y[gy - 1, gx:gx + 16] if at else np.zeros(16, np.int64)
        left = self.y[gy:gy + 16, gx - 1] if al else np.zeros(16, np.int64)
        tl = self.y[gy - 1, gx - 1] if (at and al) else 0
        pred = R.pred_16x16(mode, top, left, tl, at, al)

        # DC block
        nc = self._nc(self.nnz_y, 4 * my, 4 * mx)
        dc_lev = R.dezigzag(read_residual(br, 16, nc))
        dc = R.ihadamard4x4(dc_lev)
        dc = self.Q.dequant_dc_luma(dc, qp)

        blocks = np.zeros((4, 4, 4, 4), np.int64)  # [by,bx,r,c] dequant AC
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            if cbp_luma:
                nc = self._nc(self.nnz_y, 4 * my + by, 4 * mx + bx)
                lv = read_residual(br, 15, nc)
                self.nnz_y[4 * my + by, 4 * mx + bx] = \
                    sum(1 for x in lv if x)
                blocks[by, bx] = self.Q.dequant4x4(R.dezigzag([0] + lv), qp,
                                                   intra=True)
            else:
                self.nnz_y[4 * my + by, 4 * mx + bx] = 0
        blocks[:, :, 0, 0] = dc
        for by in range(4):
            for bx in range(4):
                py, px = gy + 4 * by, gx + 4 * bx
                self.y[py:py + 4, px:px + 4] = R.recon_block4x4(
                    pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                    blocks[by, bx])

        self._decode_chroma(br, mx, my, cmode, cbp_chroma, qpc, intra=True)
        self.mb_intra[my, mx] = True
        # intra neighbours are AVAILABLE with mv 0 /
        # ref -1 for MVP/P_SKIP (x264 cache -1 vs -2
        # outside, macroblock.c:28-46; scan.py twin)
        self.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
        self.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
        return qp

    def decode_i4x4(self, br: BitReader, mx: int, my: int, qp: int):
        """I_NxN (Intra_4x4) macroblock (spec 7.3.5.1 + 8.3.1)."""
        # 16 predicted-mode syntax elements, z-scan order
        modes = np.zeros(16, np.int32)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            gy4, gx4 = 4 * my + by, 4 * mx + bx
            pm = self._pred_i4_mode(gy4, gx4)
            if br.read1():
                modes[blk] = pm
            else:
                rem = br.read(3)
                modes[blk] = rem + (1 if rem >= pm else 0)
            self.modes4[gy4, gx4] = modes[blk]

        cmode = br.read_ue()
        cbp = VT.CBP_INTRA_TO_GOLOMB.index(br.read_ue())
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp = (qp + br.read_se() + 52) % 52
        qpc = int(CHROMA_QP[np.clip(qp + self.pps.chroma_qp_index_offset,
                                    0, 51)])

        # residual parse (16-coeff blocks), then recon in z-order
        blocks = np.zeros((4, 4, 4, 4), np.int64)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            if cbp_luma & (1 << (blk >> 2)):
                nc = self._nc(self.nnz_y, 4 * my + by, 4 * mx + bx)
                lv = read_residual(br, 16, nc)
                self.nnz_y[4 * my + by, 4 * mx + bx] = \
                    sum(1 for x in lv if x)
                blocks[by, bx] = self.Q.dequant4x4(R.dezigzag(lv), qp,
                                                   intra=True)
            else:
                self.nnz_y[4 * my + by, 4 * mx + bx] = 0
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            pred = self._i4_pred_block(mx, my, by, bx, int(modes[blk]))
            py, px = 16 * my + 4 * by, 16 * mx + 4 * bx
            self.y[py:py + 4, px:px + 4] = R.recon_block4x4(
                pred, blocks[by, bx])

        self._decode_chroma(br, mx, my, cmode, cbp_chroma, qpc, intra=True)
        self.mb_intra[my, mx] = True
        # intra neighbours are AVAILABLE with mv 0 /
        # ref -1 for MVP/P_SKIP (x264 cache -1 vs -2
        # outside, macroblock.c:28-46; scan.py twin)
        self.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
        self.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
        return qp

    _Z8 = [(0, 0), (0, 1), (1, 0), (1, 1)]

    def _read_lev8(self, br: BitReader, mx: int, my: int, cbp_luma: int):
        """The 8x8-transform luma residual: per coded 8x8 four
        interleaved 4x4 CAVLC blocks, sub-block j carrying zigzag
        positions 4k + j (spec 7.4.5.3.3). Returns [2, 2, 64] levels in
        zigzag order."""
        lev8 = np.zeros((2, 2, 64), np.int64)
        for b, (by8, bx8) in enumerate(self._Z8):
            for j, (sy, sx) in enumerate(self._Z8):
                yy = 4 * my + 2 * by8 + sy
                xx = 4 * mx + 2 * bx8 + sx
                if cbp_luma & (1 << b):
                    nc = self._nc(self.nnz_y, yy, xx)
                    lv = read_residual(br, 16, nc)
                    self.nnz_y[yy, xx] = sum(1 for x in lv if x)
                    lev8[by8, bx8, j::4] = lv
                else:
                    self.nnz_y[yy, xx] = 0
        return lev8

    def decode_i8x8(self, br: BitReader, mx: int, my: int, qp: int):
        """I_NxN with transform_size_8x8_flag 1 (spec 7.3.5 + 8.3.2)."""
        modes = np.zeros(4, np.int32)
        for b, (by8, bx8) in enumerate(self._Z8):
            gy4, gx4 = 4 * my + 2 * by8, 4 * mx + 2 * bx8
            pm = self._pred_i4_mode(gy4, gx4)
            if br.read1():
                modes[b] = pm
            else:
                rem = br.read(3)
                modes[b] = rem + (1 if rem >= pm else 0)
            # i8x8 modes replicate into the 2x2 ctx cells (x264 cache)
            self.modes4[gy4:gy4 + 2, gx4:gx4 + 2] = modes[b]

        cmode = br.read_ue()
        cbp = VT.CBP_INTRA_TO_GOLOMB.index(br.read_ue())
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp:
            qp = (qp + br.read_se() + 52) % 52
        qpc = int(CHROMA_QP[np.clip(qp + self.pps.chroma_qp_index_offset,
                                    0, 51)])
        lev8 = self._read_lev8(br, mx, my, cbp_luma)
        for b, (by8, bx8) in enumerate(self._Z8):
            deq = self.Q.dequant8x8(R.dezigzag8(lev8[by8, bx8]), qp,
                                    intra=True)
            pred = self._i8_pred_block(mx, my, by8, bx8, int(modes[b]))
            py, px = 16 * my + 8 * by8, 16 * mx + 8 * bx8
            self.y[py:py + 8, px:px + 8] = R.idct8x8_add(pred, deq)

        self._decode_chroma(br, mx, my, cmode, cbp_chroma, qpc, intra=True)
        self.mb_intra[my, mx] = True
        self.mb_trans8[my, mx] = True
        # intra neighbours are AVAILABLE with mv 0 / ref -1 for MVP/P_SKIP
        self.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
        self.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
        return qp

    def _i8_pred_block(self, mx, my, by8, bx8, mode):
        """Borders from reconstructed samples with the spec's top-right
        availability and substitution, then the 8x8 edge filter and the
        prediction."""
        gy8, gx8 = 2 * my + by8, 2 * mx + bx8
        py, px = 8 * gy8, 8 * gx8
        at, al = gy8 > 0, gx8 > 0
        t = np.zeros(16, np.int64)
        lf = np.zeros(8, np.int64)
        lt = 0
        have_lt = at and al
        have_tr = False
        if at:
            t[:8] = self.y[py - 1, px:px + 8]
            if gx8 + 1 < 2 * self.mbw:
                mb2 = ((gy8 - 1) // 2, (gx8 + 1) // 2)
                if mb2 < (my, mx):
                    have_tr = True
                elif mb2 == (my, mx):
                    z = {q: i for i, q in enumerate(self._Z8)}
                    have_tr = (z[((gy8 - 1) % 2, (gx8 + 1) % 2)]
                               < z[(by8, bx8)])
            if have_tr:
                t[8:] = self.y[py - 1, px + 8:px + 16]
            else:
                t[8:] = t[7]
        if al:
            lf[:] = self.y[py:py + 8, px - 1]
        if have_lt:
            lt = int(self.y[py - 1, px - 1])
        edge = R.filter_edge8(lt, t, lf, have_lt, have_tr)
        return R.pred_8x8(mode, edge, at, al)

    def _pred_i4_mode(self, gy4: int, gx4: int) -> int:
        """predIntra4x4PredMode (spec 8.3.1.1): DC if either neighbour
        block is unavailable, else min of the neighbour modes (2 for
        blocks not coded Intra_4x4)."""
        if gx4 == 0 or gy4 == 0:
            return 2
        return int(min(self.modes4[gy4, gx4 - 1], self.modes4[gy4 - 1, gx4]))

    def _i4_pred_block(self, mx, my, by, bx, mode):
        """Assemble borders from reconstructed samples + spec top-right
        availability/substitution, then predict."""
        gy4, gx4 = 4 * my + by, 4 * mx + bx
        py, px = 4 * gy4, 4 * gx4
        at, al = gy4 > 0, gx4 > 0
        t = np.zeros(8, np.int64)
        l = np.zeros(4, np.int64)
        lt = 0
        if at:
            t[:4] = self.y[py - 1, px:px + 4]
            # top-right: available iff that 4x4 block precedes this one
            # in decoding order (spec 6.4.8 + 8.3.1.2 substitution)
            tr_ok = False
            if gx4 + 1 < 4 * self.mbw:
                my2, mx2 = (gy4 - 1) // 4, (gx4 + 1) // 4
                if (my2, mx2) < (my, mx):
                    tr_ok = True
                elif (my2, mx2) == (my, mx):
                    zi = {p: i for i, p in enumerate(LUMA_SCAN)}
                    tr_ok = (zi[(by - 1, bx + 1)] < zi[(by, bx)])
            if tr_ok:
                t[4:] = self.y[py - 1, px + 4:px + 8]
            else:
                t[4:] = t[3]
        if al:
            l[:] = self.y[py:py + 4, px - 1]
        if at and al:
            lt = int(self.y[py - 1, px - 1])
        return R.pred_4x4(mode, t, l, lt, at, al)

    def _decode_chroma(self, br, mx, my, cmode, cbp_chroma, qpc, intra,
                       preds=None):
        gx, gy = 8 * mx, 8 * my
        at, al = my > 0, mx > 0
        # spec residual() order: both chroma DC blocks first, then all ACs
        dcs = []
        for ch in range(2):
            if cbp_chroma:
                lv = read_residual(br, 4, -1)  # raster scan over the 2x2
                dc2 = np.array([[lv[0], lv[1]], [lv[2], lv[3]]], np.int64)
                dc = self.Q.dequant_dc_chroma(R.ihadamard2x2(dc2), qpc,
                                              intra=intra)
            else:
                dc = np.zeros((2, 2), np.int64)
            dcs.append(dc)
        for ch, plane in ((0, self.u), (1, self.v)):
            blocks = np.zeros((2, 2, 4, 4), np.int64)
            if cbp_chroma == 2:
                for blk in range(4):
                    by, bx = CHROMA_SCAN[blk]
                    nc = self._nc(self.nnz_c[ch], 2 * my + by, 2 * mx + bx)
                    lv = read_residual(br, 15, nc)
                    self.nnz_c[ch, 2 * my + by, 2 * mx + bx] = \
                        sum(1 for x in lv if x)
                    blocks[by, bx] = self.Q.dequant4x4(
                        R.dezigzag([0] + lv), qpc, intra=intra)
            else:
                self.nnz_c[ch, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
            blocks[:, :, 0, 0] = dcs[ch]

            if preds is not None:
                pred = preds[ch]
            elif intra:
                top = plane[gy - 1, gx:gx + 8] if at else np.zeros(8, np.int64)
                left = plane[gy:gy + 8, gx - 1] if al else np.zeros(8, np.int64)
                tl = plane[gy - 1, gx - 1] if (at and al) else 0
                pred = R.pred_chroma(cmode, top, left, tl, at, al)
            else:
                pred = self._inter_pred_chroma(ch, mx, my)
            for by in range(2):
                for bx in range(2):
                    py, px = gy + 4 * by, gx + 4 * bx
                    plane[py:py + 4, px:px + 4] = R.recon_block4x4(
                        pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                        blocks[by, bx])

    def _inter_pred_chroma(self, ch, mx, my):
        """Chroma MB prediction from the 4x4-granularity luma MVs: one
        2x2 chroma block per luma 4x4 (spec 8.4.2.2 partition mapping;
        identical to the coarser per-8x8 path when the MV is uniform
        within the 8x8 — bilinear MC is position-independent)."""
        out = np.zeros((8, 8), np.int64)
        mvblk = self.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4]
        rblk = self.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4]

        def plane_of(r):
            d = self.refs[max(0, int(r))]
            return d["u"] if ch == 0 else d["v"]

        # fast path: uniform MV + ref over the MB -> one 8x8 MC
        if (mvblk == mvblk[0, 0]).all() and (rblk == rblk[0, 0]).all():
            mv = mvblk[0, 0]
            return R.np_mc_chroma(plane_of(rblk[0, 0]), 8 * my, 8 * mx,
                                  int(mv[0]), int(mv[1]), bh=8, bw=8)
        for j in range(4):
            for i in range(4):
                mv = mvblk[j, i]
                out[2 * j:2 * j + 2, 2 * i:2 * i + 2] = R.np_mc_chroma(
                    plane_of(rblk[j, i]), 8 * my + 2 * j, 8 * mx + 2 * i,
                    int(mv[0]), int(mv[1]), bh=2, bw=2)
        return out

    # ---- MVP at 4x4 granularity (spec 8.4.1.3 / 8.4.1.1) ----
    def _nb4(self, y4, x4, lst=0):
        if (0 <= y4 < 4 * self.mbh and 0 <= x4 < 4 * self.mbw
                and self.dec4[y4, x4]):
            mv = self.mv4 if lst == 0 else self.mv4_1
            rf = self.ref4 if lst == 0 else self.ref4_1
            return mv[y4, x4], int(rf[y4, x4]), True
        return np.zeros(2, np.int32), -1, False

    def _unit_mvp(self, y4, x4, w4, part, unit, ref=0, lst=0):
        mva, ra, av_a = self._nb4(y4, x4 - 1, lst)
        mvb, rb, av_b = self._nb4(y4 - 1, x4, lst)
        mvc, rc, av_c = self._nb4(y4 - 1, x4 + w4, lst)
        if not av_c:
            mvc, rc, av_c = self._nb4(y4 - 1, x4 - 1, lst)
        if part == 1:      # D_16x8
            if unit == 0 and av_b and rb == ref:
                return mvb.copy()
            if unit == 1 and av_a and ra == ref:
                return mva.copy()
        elif part == 2:    # D_8x16
            if unit == 0 and av_a and ra == ref:
                return mva.copy()
            if unit == 1 and av_c and rc == ref:
                return mvc.copy()
        match = [av_a and ra == ref, av_b and rb == ref,
                 av_c and rc == ref]
        if sum(match) == 1:
            return (mva if match[0] else mvb if match[1]
                    else mvc).copy()
        if not av_b and not av_c and av_a:
            return mva.copy()
        return np.median(np.stack([mva, mvb, mvc]), axis=0).astype(np.int32)

    def _pskip_mv(self, my, mx):
        y4, x4 = 4 * my, 4 * mx
        mva, ra, av_a = self._nb4(y4, x4 - 1)
        mvb, rb, av_b = self._nb4(y4 - 1, x4)
        if not av_a or not av_b:
            return np.zeros(2, np.int32)
        if ((ra == 0 and mva[0] == 0 and mva[1] == 0)
                or (rb == 0 and mvb[0] == 0 and mvb[1] == 0)):
            return np.zeros(2, np.int32)
        return self._unit_mvp(y4, x4, 4, 0, 0, ref=0)

    def _recon_inter_luma(self, mx, my, blocks):
        """blocks: [4,4,4,4] dequantized (by,bx,r,c) incl. DC. Prediction
        at 4x4 granularity from mv4 (uniform-MV 8x8s collapse to one
        8x8 MC — the FIR interpolation is position-independent, so the
        result is identical either way)."""
        gy, gx = 16 * my, 16 * mx
        pred = self._inter_pred_luma16(mx, my)
        for by in range(4):
            for bx in range(4):
                py, px = gy + 4 * by, gx + 4 * bx
                self.y[py:py + 4, px:px + 4] = R.recon_block4x4(
                    pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                    blocks[by, bx])

    def _recon_inter_luma8(self, mx, my, deq8):
        """8x8-transform inter recon: deq8 [2,2,8,8] dequantized."""
        gy, gx = 16 * my, 16 * mx
        pred = self._inter_pred_luma16(mx, my)
        for by8 in range(2):
            for bx8 in range(2):
                py, px = gy + 8 * by8, gx + 8 * bx8
                self.y[py:py + 8, px:px + 8] = R.idct8x8_add(
                    pred[8 * by8:8 * by8 + 8, 8 * bx8:8 * bx8 + 8],
                    deq8[by8, bx8])

    def _inter_pred_luma16(self, mx, my):
        gy, gx = 16 * my, 16 * mx
        pred = np.zeros((16, 16), np.int64)
        mvblk = self.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4]
        rblk = self.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4]
        for b in range(4):
            j2, i2 = (b >> 1) * 2, (b & 1) * 2
            oy, ox = 8 * (b >> 1), 8 * (b & 1)
            sub = mvblk[j2:j2 + 2, i2:i2 + 2]
            rlum = self.refs[max(0, int(rblk[j2, i2]))]["luma"]
            if (sub == sub[0, 0]).all():
                mv = sub[0, 0]
                pred[oy:oy + 8, ox:ox + 8] = R.np_mc_luma(
                    rlum, gy + oy, gx + ox,
                    int(mv[0]), int(mv[1]), bh=8, bw=8)
            else:
                for j in range(2):
                    for i in range(2):
                        mv = sub[j, i]
                        pred[oy + 4 * j:oy + 4 * j + 4,
                             ox + 4 * i:ox + 4 * i + 4] = R.np_mc_luma(
                            rlum, gy + oy + 4 * j,
                            gx + ox + 4 * i,
                            int(mv[0]), int(mv[1]), bh=4, bw=4)
        return pred

    def decode_p_mb(self, br: BitReader, mx: int, my: int, mb_type: int,
                    qp: int):
        """P_L0_16x16 / P_L0_L0_16x8 / P_L0_L0_8x16 / P_8x8 (spec
        7.3.5.2), incl. sub_mb_types P_L0_8x8/8x4/4x8/4x4."""
        ref0_inferred = mb_type == 4      # P_8x8ref0 (Table 7-13)
        if mb_type == 4:
            mb_type = 3
        if mb_type == 3:
            subs = [br.read_ue() for _ in range(4)]
            assert all(0 <= st <= 3 for st in subs), \
                f"unsupported sub_mb_type in {subs}"
            geom = mb_units(3, subs)
            ref_geom = UNIT_GEOM[3]
        else:
            subs = None
            geom = UNIT_GEOM[mb_type]
            ref_geom = geom
        y4, x4 = 4 * my, 4 * mx
        num_ref = (self.p_l0_active if self.p_l0_active is not None
                   else self.pps.num_ref_idx_l0_active)
        if ref0_inferred:
            self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        elif num_ref > 1:
            for (oy, ox, w4, h4) in ref_geom:
                if num_ref == 2:
                    r = 1 - br.read1()        # te(v), range 0..1
                else:
                    r = br.read_ue()
                self.ref4[y4 + oy:y4 + oy + h4,
                          x4 + ox:x4 + ox + w4] = r
        else:
            self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        unit_mvs = []
        for u, (oy, ox, w4, h4) in enumerate(geom):
            mvd = (br.read_se(), br.read_se())
            r = int(self.ref4[y4 + oy, x4 + ox])
            mvp = self._unit_mvp(y4 + oy, x4 + ox, w4, mb_type, u,
                                 ref=r)
            mv = np.array([mvp[0] + mvd[0], mvp[1] + mvd[1]], np.int32)
            self.mv4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = mv
            self.dec4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = True
            unit_mvs.append((int(mv[0]), int(mv[1])))
        cbp_code = br.read_ue()
        cbp = VT.CBP_INTER_TO_GOLOMB.index(cbp_code)
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        # transform_size_8x8_flag between cbp and dqp (spec 7.3.5);
        # absent when a sub-partition is smaller than 8x8
        t8_present = subs is None or all(st == 0 for st in subs)
        trans8 = bool(self.pps.transform_8x8 and cbp_luma and t8_present
                      and br.read1())
        if cbp:
            qp = (qp + br.read_se() + 52) % 52
        qpc = int(CHROMA_QP[np.clip(qp + self.pps.chroma_qp_index_offset,
                                    0, 51)])
        if trans8:
            lev8 = self._read_lev8(br, mx, my, cbp_luma)
            deq8 = np.stack([np.stack([
                self.Q.dequant8x8(R.dezigzag8(lev8[a, b2]), qp, intra=False)
                for b2 in range(2)]) for a in range(2)])
            self._recon_inter_luma8(mx, my, deq8)
            self.mb_trans8[my, mx] = True
            for by8, bx8 in self._Z8:
                self.nnz8[2 * my + by8, 2 * mx + bx8] = int(
                    np.count_nonzero(lev8[by8, bx8]))
        else:
            blocks = np.zeros((4, 4, 4, 4), np.int64)
            for blk in range(16):
                by, bx = LUMA_SCAN[blk]
                if cbp_luma & (1 << (blk >> 2)):
                    nc = self._nc(self.nnz_y, 4 * my + by, 4 * mx + bx)
                    lv = read_residual(br, 16, nc)
                    self.nnz_y[4 * my + by, 4 * mx + bx] = \
                        sum(1 for x in lv if x)
                    blocks[by, bx] = self.Q.dequant4x4(R.dezigzag(lv), qp)
                else:
                    self.nnz_y[4 * my + by, 4 * mx + bx] = 0
            self._recon_inter_luma(mx, my, blocks)
        self._decode_chroma(br, mx, my, 0, cbp_chroma if cbp else 0, qpc,
                            intra=False)
        self.decoded[my, mx] = True
        kind = ("P16x16", "P16x8", "P8x16", "P8x8")[mb_type]
        self.mbs.append(MBInfo(kind, unit_mvs[0], qp, unit_mvs=unit_mvs))
        return qp

    def decode_pskip(self, mx: int, my: int, qp: int):
        mv = self._pskip_mv(my, mx)
        y4, x4 = 4 * my, 4 * mx
        self.mv4[y4:y4 + 4, x4:x4 + 4] = mv
        self.ref4[y4:y4 + 4, x4:x4 + 4] = 0
        self.dec4[y4:y4 + 4, x4:x4 + 4] = True
        self._recon_inter_luma(mx, my, np.zeros((4, 4, 4, 4), np.int64))
        for ch, plane in ((0, self.u), (1, self.v)):
            pred = self._inter_pred_chroma(ch, mx, my)
            gy, gx = 8 * my, 8 * mx
            plane[gy:gy + 8, gx:gx + 8] = pred
        self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.decoded[my, mx] = True
        self.mb_skip[my, mx] = True
        self.mbs.append(MBInfo("SKIP", (int(mv[0]), int(mv[1])), qp,
                               unit_mvs=[(int(mv[0]), int(mv[1]))]))

    # ------------------------------------------------------------------
    # B slices: spatial (spec 8.4.1.2.2) or temporal (8.4.1.2.3) direct
    # with direct_8x8_inference, both lists' motion fields, bipred recon
    # at the implicit weights (twin of the encoder's bslice.scan_b_parts)
    # ------------------------------------------------------------------
    _COL_CORNERS = ((0, 0), (0, 3), (3, 0), (3, 3))

    def _direct(self, my, mx):
        """The direct derivation of the slice's mode: (use0, use1, mv0
        [4,2], mv1 [4,2], refIdxL0 (an int, or [4] per 8x8 under
        temporal direct), refIdxL1)."""
        if self.direct_spatial:
            return self._spatial_direct(my, mx)
        return self._temporal_direct(my, mx)

    def _direct_coded(self, my, mx):
        """`_direct` of an MB the slice codes as B_Skip or B_Direct_16x16
        (or with a direct 8x8 sub): raises ValueError where the derivation
        has no prediction (temporal direct unavailable), which a conformant
        stream never codes."""
        out = self._direct(my, mx)
        if not (out[0] or out[1]):
            raise ValueError("direct MB (%d, %d) where temporal direct is "
                             "unavailable: not a conformant stream"
                             % (mx, my))
        return out

    def _temporal_direct(self, my, mx):
        """Temporal direct (spec 8.4.1.2.3; twin of the encoder's
        bslice.temporal_direct_fields): each 8x8's colocated corner MV,
        from L1[0]'s L0-only field, scaled by its mapped L0 entry's
        DistScaleFactor; refIdxL0 = map_col_to_list0 of the colocated
        reference, by POC within the active L0 (x264's
        macroblock.c:830-841); colocated intra gives zeros and refs 0. A
        colocated reference outside the active L0, or a reference B's
        L1-only block, makes the MB direct-unavailable (macroblock.c:199):
        a conformant stream codes no direct MB there."""
        y4, x4 = 4 * my, 4 * mx
        col = self.refs_l1[0]
        col_mv4 = col.get("mv4_l0", col["mv4"])
        col_ref4 = col.get("ref4_l0", col["ref4"])
        cmap = None
        rp0 = col.get("ref_poc0")
        if rp0:
            n_act = min(self.b_l0_active, len(self.refs))
            pocs = [self.refs[j]["poc"] for j in range(n_act)]
            cmap = [pocs.index(q) if q in pocs else -1 for q in rp0]
        mv0 = np.zeros((4, 2), np.int32)
        mv1 = np.zeros((4, 2), np.int32)
        r8 = np.zeros(4, np.int32)
        for b, (cy, cx) in enumerate(self._COL_CORNERS):
            colr = int(col_ref4[y4 + cy, x4 + cx])
            if colr == -1:
                continue
            if colr <= -2:
                return False, False, mv0 * 0, mv1 * 0, r8 * 0, 0
            if cmap is not None:
                r = cmap[min(colr, len(cmap) - 1)]
                if r < 0:
                    return False, False, mv0 * 0, mv1 * 0, r8 * 0, 0
            else:
                r = min(colr, len(self._dsf_tab) - 1)
            r8[b] = r
            colm = col_mv4[y4 + cy, x4 + cx].astype(np.int64)
            l0 = (self._dsf_tab[r] * colm + 128) >> 8
            mv0[b] = l0
            mv1[b] = l0 - colm
        return True, True, mv0, mv1, r8, 0

    def _spatial_direct(self, my, mx):
        """Spatial direct (use0, use1, mv0 [4,2], mv1 [4,2] per 8x8
        z-order, refIdxL0, refIdxL1); the colocated field is L1[0]'s
        own."""
        y4, x4 = 4 * my, 4 * mx
        col = self.refs_l1[0]
        col_mv4, col_ref4 = col["mv4"], col["ref4"]
        refs, mvps = [], []
        for lst in (0, 1):
            _, ra, _ = self._nb4(y4, x4 - 1, lst)
            _, rb, _ = self._nb4(y4 - 1, x4, lst)
            _, rc, av_c = self._nb4(y4 - 1, x4 + 4, lst)
            if not av_c:
                _, rc, _ = self._nb4(y4 - 1, x4 - 1, lst)
            cand = [r for r in (ra, rb, rc) if r >= 0]
            ref = min(cand) if cand else -1
            refs.append(ref)
            mvps.append(self._unit_mvp(y4, x4, 4, 0, 0, ref=ref, lst=lst)
                        if ref >= 0 else np.zeros(2, np.int32))
        mv0 = np.zeros((4, 2), np.int32)
        mv1 = np.zeros((4, 2), np.int32)
        if refs[0] < 0 and refs[1] < 0:
            return True, True, mv0, mv1, 0, 0
        use0, use1 = refs[0] >= 0, refs[1] >= 0
        for b, (cy, cx) in enumerate(self._COL_CORNERS):
            colr = int(col_ref4[y4 + cy, x4 + cx])
            colm = col_mv4[y4 + cy, x4 + cx]
            col_zero = (colr == 0 and abs(int(colm[0])) <= 1
                        and abs(int(colm[1])) <= 1)
            for use, ref, mvp, out in ((use0, refs[0], mvps[0], mv0),
                                       (use1, refs[1], mvps[1], mv1)):
                if use:
                    out[b] = 0 if (ref == 0 and col_zero) else mvp
        return (use0, use1, mv0, mv1, max(refs[0], 0), max(refs[1], 0))

    def _commit_b(self, my, mx, use0, use1, mv0, mv1, r0=0):
        """Write per-8x8 (mv, ref) of both lists into the neighbour
        fields. mv0/mv1: [4,2] per 8x8 z-order; use0/use1: bool (whole
        MB) or [4]; r0: the MB's L0 ref."""
        y4, x4 = 4 * my, 4 * mx
        u0 = np.broadcast_to(np.asarray(use0), (4,))
        u1 = np.broadcast_to(np.asarray(use1), (4,))
        r0a = np.broadcast_to(np.asarray(r0), (4,))
        for b in range(4):
            by, bx = y4 + 2 * (b >> 1), x4 + 2 * (b & 1)
            self.mv4[by:by + 2, bx:bx + 2] = mv0[b] if u0[b] else 0
            self.ref4[by:by + 2, bx:bx + 2] = int(r0a[b]) if u0[b] else -1
            self.mv4_1[by:by + 2, bx:bx + 2] = mv1[b] if u1[b] else 0
            self.ref4_1[by:by + 2, bx:bx + 2] = 0 if u1[b] else -1
        self.dec4[y4:y4 + 4, x4:x4 + 4] = True

    def _b_preds(self, mx, my, use0, use1, mv0, mv1, r0=0):
        """Bipred luma [16,16] and chroma (2 x [8,8]) predictions of one
        MB at per-8x8 (mv0, mv1) [4,2]; use0/use1/r0 per MB or per 8x8
        ([4]). The bipred combine takes the implicit weight of the L0
        entry a block uses (32 is the plain average)."""
        u0a = np.broadcast_to(np.asarray(use0), (4,))
        u1a = np.broadcast_to(np.asarray(use1), (4,))
        r0a = np.broadcast_to(np.asarray(r0), (4,))

        def pred(b, mc, key, y0, x0, n):
            p0 = p1 = None
            if u0a[b]:
                p0 = mc(self.refs[int(r0a[b])][key], y0, x0,
                        int(mv0[b][0]), int(mv0[b][1]), bh=n, bw=n)
            if u1a[b]:
                p1 = mc(self.refs_l1[0][key], y0, x0, int(mv1[b][0]),
                        int(mv1[b][1]), bh=n, bw=n)
            if u0a[b] and u1a[b]:
                w1 = self.bipred_w1_tab[min(int(r0a[b]),
                                            len(self.bipred_w1_tab) - 1)]
                if w1 == 32:
                    return (p0 + p1 + 1) >> 1
                return np.clip((p0 * (64 - w1) + p1 * w1 + 32) >> 6, 0, 255)
            return p0 if u0a[b] else p1

        py = np.zeros((16, 16), np.int64)
        pc = [np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)]
        for b in range(4):
            oy, ox = (b >> 1), (b & 1)
            py[8 * oy:8 * oy + 8, 8 * ox:8 * ox + 8] = pred(
                b, R.np_mc_luma, "luma", 16 * my + 8 * oy,
                16 * mx + 8 * ox, 8)
            for ch, key in ((0, "u"), (1, "v")):
                pc[ch][4 * oy:4 * oy + 4, 4 * ox:4 * ox + 4] = pred(
                    b, R.np_mc_chroma, key, 8 * my + 4 * oy,
                    8 * mx + 4 * ox, 4)
        return py, pc

    def decode_b_skip(self, mx: int, my: int, qp: int):
        use0, use1, mv0, mv1, r0, _r1 = self._direct_coded(my, mx)
        self._commit_b(my, mx, use0, use1, mv0, mv1, r0=r0)
        py, pc = self._b_preds(mx, my, use0, use1, mv0, mv1, r0=r0)
        self.y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16] = py
        for ch, plane in ((0, self.u), (1, self.v)):
            plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = pc[ch]
        self.nnz_y[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
        self.nnz_c[:, 2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = 0
        self.decoded[my, mx] = True
        self.mb_skip[my, mx] = True
        m0 = (int(mv0[0, 0]), int(mv0[0, 1]))
        self.mbs.append(MBInfo("BSKIP", m0, qp, unit_mvs=[m0]))

    # B partition geometry per shape: (member blocks, oy4, ox4, h4, w4,
    # mvp kind) (spec Table 7-14)
    _B_UNIT_GEOM = {
        1: [((0, 1), 0, 0, 2, 4, 1), ((2, 3), 2, 0, 2, 4, 1)],
        2: [((0, 2), 0, 0, 4, 2, 2), ((1, 3), 0, 2, 4, 2, 2)],
        3: [((0,), 0, 0, 2, 2, 3), ((1,), 0, 2, 2, 2, 3),
            ((2,), 2, 0, 2, 2, 3), ((3,), 2, 2, 2, 2, 3)],
    }

    def _derive_b_parts_mvs(self, mx, my, mb_type, subs, mvds,
                            refs_u=None):
        """MV derivation + neighbour-field commit of a B partition MB
        (twin of the encoder's scan_b_parts walk): spatial direct first
        (before any commit of this MB), then all-L0-then-all-L1 unit
        order; within a list a later unit's MVP sees this MB's earlier
        units (spec 8.4.1.3). mvds: [2][n_units] of (x, y) or None;
        refs_u: per-unit L0 refs. Returns (use0 [4], use1 [4], mv0 [4,2],
        mv1 [4,2] per 8x8 z-order, r8 [4] per-8x8 L0 refs, unit_mvs)."""
        y4, x4 = 4 * my, 4 * mx
        du0, du1, dmv0, dmv1, dr0, _dr1 = self._direct(my, mx)
        dr8 = np.broadcast_to(np.asarray(dr0), (4,))
        r8_out = np.zeros(4, np.int32)
        if mb_type == 22:
            geom = self._B_UNIT_GEOM[3]
            uses = ([B_SUB_USES[int(s)][0] for s in subs],
                    [B_SUB_USES[int(s)][1] for s in subs])
            direct_units = {u for u, s in enumerate(subs) if s == 0}
        else:
            _n, u0t, u1t = B_CODE_USES[mb_type]
            geom = self._B_UNIT_GEOM[1 if mb_type % 2 == 0 else 2]
            uses = (list(u0t), list(u1t))
            direct_units = set()
        use_v = [np.zeros(4, np.int32), np.zeros(4, np.int32)]
        mv_v = [np.zeros((4, 2), np.int32), np.zeros((4, 2), np.int32)]
        unit_mvs = []
        for li in (0, 1):
            duse = (du0, du1)[li]
            dmv = (dmv0, dmv1)[li]
            mvf = self.mv4 if li == 0 else self.mv4_1
            rff = self.ref4 if li == 0 else self.ref4_1
            for u, (blocks, oy, ox, h4, w4, kind) in enumerate(geom):
                ur = 0 if refs_u is None or li == 1 else int(refs_u[u])
                if u in direct_units:
                    if not (du0 or du1):
                        self._direct_coded(my, mx)   # raises
                    ui = int(duse)
                    for b in blocks:
                        use_v[li][b] = ui
                        if ui:
                            mv_v[li][b] = dmv[b]
                            if li == 0:
                                r8_out[b] = int(dr8[b])
                        by, bx = y4 + 2 * (b >> 1), x4 + 2 * (b & 1)
                        mvf[by:by + 2, bx:bx + 2] = dmv[b]
                        rff[by:by + 2, bx:bx + 2] = \
                            (int(dr8[b]) if li == 0 else 0) if ui else -1
                        self.dec4[by:by + 2, bx:bx + 2] = True
                        if li == 0:
                            unit_mvs.append((int(dmv[b][0]),
                                             int(dmv[b][1])))
                    continue
                used = bool(uses[li][u])
                mv = np.zeros(2, np.int32)
                if used:
                    mvp = self._unit_mvp(y4 + oy, x4 + ox, w4, kind, u,
                                         ref=ur, lst=li)
                    d = mvds[li][u]
                    mv = np.array([mvp[0] + d[0], mvp[1] + d[1]], np.int32)
                for b in blocks:
                    use_v[li][b] = 1 if used else 0
                    if used:
                        mv_v[li][b] = mv
                        if li == 0:
                            r8_out[b] = ur
                mvf[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = mv
                rff[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = \
                    ur if used else -1
                self.dec4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = True
                if li == 0:
                    unit_mvs.append((int(mv[0]), int(mv[1])))
        return use_v[0], use_v[1], mv_v[0], mv_v[1], r8_out, unit_mvs

    # ---- CAVLC B macroblocks (the reference's decoder.py:1188-1443) ----
    def b_t8_present(self, mb_type: int, subs) -> bool:
        """Whether a coded B MB with luma residual carries
        transform_size_8x8_flag under the PPS's 8x8 mode (spec 7.3.5):
        not where direct prediction (B_Direct_16x16, a direct sub-MB)
        meets an SPS without direct_8x8_inference_flag. Sub-8x8 B
        partitions, which also drop it, are refused before."""
        direct = mb_type == 0 or (subs is not None and 0 in subs)
        return not direct or self.sps.direct_8x8_inference

    def _read_inter_residual(self, br: BitReader, mx: int, my: int,
                             qp: int, t8_present: bool = True):
        """coded_block_pattern, transform_size_8x8_flag (read where
        `t8_present`), mb_qp_delta and the 4x4 luma levels of an inter
        MB. Returns (qp, cbp_chroma, dequantized blocks [4,4,4,4])."""
        cbp = VT.CBP_INTER_TO_GOLOMB.index(br.read_ue())
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if self.pps.transform_8x8 and cbp_luma and t8_present \
                and br.read1():
            raise NotImplementedError(
                "the 8x8 transform in B MBs (neither encoder codes one)")
        if cbp:
            qp = (qp + br.read_se() + 52) % 52
        blocks = np.zeros((4, 4, 4, 4), np.int64)
        for blk in range(16):
            by, bx = LUMA_SCAN[blk]
            yy, xx = 4 * my + by, 4 * mx + bx
            if cbp_luma & (1 << (blk >> 2)):
                lv = read_residual(br, 16, self._nc(self.nnz_y, yy, xx))
                self.nnz_y[yy, xx] = sum(1 for x in lv if x)
                blocks[by, bx] = self.Q.dequant4x4(R.dezigzag(lv), qp)
            else:
                self.nnz_y[yy, xx] = 0
        return qp, cbp_chroma, blocks

    def _recon_b_cavlc(self, br, mx, my, use0, use1, mv0, mv1, r0, qp,
                       t8_present: bool = True):
        """The bipred prediction of a coded B MB plus its residual (the
        chroma residual read here, after the luma)."""
        qp, cbp_chroma, blocks = self._read_inter_residual(br, mx, my, qp,
                                                           t8_present)
        qpc = int(CHROMA_QP[np.clip(qp + self.pps.chroma_qp_index_offset,
                                    0, 51)])
        py, pc = self._b_preds(mx, my, use0, use1, mv0, mv1, r0=r0)
        gy, gx = 16 * my, 16 * mx
        for by in range(4):
            for bx in range(4):
                self.y[gy + 4 * by:gy + 4 * by + 4,
                       gx + 4 * bx:gx + 4 * bx + 4] = R.recon_block4x4(
                    py[4 * by:4 * by + 4, 4 * bx:4 * bx + 4], blocks[by, bx])
        self._decode_chroma(br, mx, my, 0, cbp_chroma, qpc, intra=False,
                            preds=pc)
        self.decoded[my, mx] = True
        return qp

    def decode_b_mb(self, br: BitReader, mx: int, my: int, mb_type: int,
                    qp: int):
        """B_Direct_16x16 (0) / B_L0_16x16 (1) / B_L1_16x16 (2) /
        B_Bi_16x16 (3): ref_idx_l0 (multi-reference L0 lists), the L0
        mvd, the L1 mvd, the residual."""
        y4, x4 = 4 * my, 4 * mx
        r0 = 0
        if mb_type == 0:
            use0, use1, mv0, mv1, r0, _r1 = self._direct_coded(my, mx)
        else:
            use0, use1 = mb_type in (1, 3), mb_type in (2, 3)
            mv0 = np.zeros((4, 2), np.int32)
            mv1 = np.zeros((4, 2), np.int32)
            if use0 and self.b_l0_active > 1:
                r0 = br.read_te(self.b_l0_active - 1)
            if use0:
                mvd = (br.read_se(), br.read_se())
                mvp = self._unit_mvp(y4, x4, 4, 0, 0, ref=r0, lst=0)
                mv0[:] = (mvp[0] + mvd[0], mvp[1] + mvd[1])
            if use1:
                mvd = (br.read_se(), br.read_se())
                mvp = self._unit_mvp(y4, x4, 4, 0, 0, ref=0, lst=1)
                mv1[:] = (mvp[0] + mvd[0], mvp[1] + mvd[1])
        self._commit_b(my, mx, use0, use1, mv0, mv1, r0=r0)
        qp = self._recon_b_cavlc(br, mx, my, use0, use1, mv0, mv1, r0, qp,
                                 self.b_t8_present(mb_type, None))
        m0 = (int(mv0[0, 0]), int(mv0[0, 1]))
        self.mbs.append(MBInfo(("BDIRECT", "BL0", "BL1", "BBI")[mb_type], m0,
                               qp, unit_mvs=[m0]))
        return qp

    def decode_b_mb_parts(self, br: BitReader, mx: int, my: int,
                          mb_type: int, qp: int):
        """B partition MBs: the two-partition list combos (codes 4-21)
        and B_8x8 (22) with direct/L0/L1/BI sub_mb_types (spec Tables
        7-14/7-18): sub types, the L0 refs (multi-reference), all L0
        mvds, all L1 mvds (x264's cavlc.c:463-560), the residual."""
        if mb_type == 22:
            subs = [br.read_ue() for _ in range(4)]
            if any(s > 3 for s in subs):
                raise NotImplementedError("B sub-8x8 partitions %s" % subs)
            geom = self._B_UNIT_GEOM[3]
            uses = ([B_SUB_USES[s][0] for s in subs],
                    [B_SUB_USES[s][1] for s in subs])
            direct_units = [i for i, s in enumerate(subs) if s == 0]
        else:
            _n, u0t, u1t = B_CODE_USES[mb_type]
            geom = self._B_UNIT_GEOM[1 if mb_type % 2 == 0 else 2]
            uses = (list(u0t), list(u1t))
            direct_units = []
            subs = None
        refs_u = [0] * len(geom)
        if self.b_l0_active > 1:
            for u in range(len(geom)):
                if uses[0][u] and u not in direct_units:
                    refs_u[u] = br.read_te(self.b_l0_active - 1)
        mvds = [[None] * len(geom), [None] * len(geom)]
        for li in (0, 1):
            for u in range(len(geom)):
                if uses[li][u] and u not in direct_units:
                    mvds[li][u] = (br.read_se(), br.read_se())
        use0, use1, mv0, mv1, r8, unit_mvs = self._derive_b_parts_mvs(
            mx, my, mb_type, subs, mvds, refs_u)
        qp = self._recon_b_cavlc(br, mx, my, use0, use1, mv0, mv1, r8, qp,
                                 self.b_t8_present(mb_type, subs))
        kind = "B8x8" if mb_type == 22 else \
            ("B16x8" if mb_type % 2 == 0 else "B8x16")
        m0 = (int(mv0[0, 0]), int(mv0[0, 1]))
        self.mbs.append(MBInfo(kind, m0, qp, unit_mvs=unit_mvs or [m0]))
        return qp

    def decode_b_slice(self, br: BitReader, qp: int):
        """A CAVLC B slice: mb_skip_run of B_Skip MBs, then the coded MB:
        inter (0-22), I_NxN (23) or I_16x16 (24-47)."""
        n_mbs = self.mbh * self.mbw
        addr = 0
        while addr < n_mbs:
            for _ in range(br.read_ue()):
                self.decode_b_skip(addr % self.mbw, addr // self.mbw, qp)
                addr += 1
            if addr >= n_mbs:
                break
            my, mx = addr // self.mbw, addr % self.mbw
            mb_type = br.read_ue()
            if mb_type <= 3:
                qp = self.decode_b_mb(br, mx, my, mb_type, qp)
            elif mb_type <= 22:
                qp = self.decode_b_mb_parts(br, mx, my, mb_type, qp)
            elif mb_type == 23:
                self.mb_intra[my, mx] = True
                if self.pps.transform_8x8 and br.read1():
                    qp = self.decode_i8x8(br, mx, my, qp)
                    kind = "I8x8"
                else:
                    qp = self.decode_i4x4(br, mx, my, qp)
                    kind = "I4x4"
                self.decoded[my, mx] = True
                self.mbs.append(MBInfo(kind, (0, 0), qp))
            elif mb_type <= 47:
                self.mb_intra[my, mx] = True
                qp = self.decode_i16x16(br, mx, my, mb_type - 23, qp)
                self.decoded[my, mx] = True
                self.mbs.append(MBInfo("I16x16", (0, 0), qp))
            else:
                raise AssertionError(f"unsupported B mb_type {mb_type}")
            addr += 1

    def decode_slice(self, br: BitReader, slice_type: int, qp: int):
        if slice_type in (2, 7):
            for my in range(self.mbh):
                for mx in range(self.mbw):
                    mb_type = br.read_ue()
                    assert 0 <= mb_type <= 24, \
                        f"unsupported I mb_type {mb_type}"
                    if mb_type == 0:
                        if self.pps.transform_8x8 and br.read1():
                            qp = self.decode_i8x8(br, mx, my, qp)
                            kind = "I8x8"
                        else:
                            qp = self.decode_i4x4(br, mx, my, qp)
                            kind = "I4x4"
                    else:
                        qp = self.decode_i16x16(br, mx, my, mb_type, qp)
                        kind = "I16x16"
                    self.decoded[my, mx] = True
                    self.mbs.append(MBInfo(kind, (0, 0), qp))
            return
        if slice_type not in (0, 5):
            raise NotImplementedError(f"slice_type {slice_type}")
        n_mbs = self.mbh * self.mbw
        addr = 0
        while addr < n_mbs:
            skip_run = br.read_ue()
            for _ in range(skip_run):
                my, mx = addr // self.mbw, addr % self.mbw
                self.decode_pskip(mx, my, qp)
                addr += 1
            if addr >= n_mbs:
                break
            my, mx = addr // self.mbw, addr % self.mbw
            mb_type = br.read_ue()
            if mb_type <= 4:
                # 4 = P_8x8ref0 (spec Table 7-13, CAVLC only): P_8x8
                # with every ref inferred 0, no ref_idx syntax — the
                # reference always prefers it when all refs are 0
                # (encoder/cavlc.c:428-436)
                qp = self.decode_p_mb(br, mx, my, mb_type, qp)
            elif mb_type == 5:
                self.mb_intra[my, mx] = True
                if self.pps.transform_8x8 and br.read1():
                    qp = self.decode_i8x8(br, mx, my, qp)
                    kind = "I8x8"
                else:
                    qp = self.decode_i4x4(br, mx, my, qp)
                    kind = "I4x4"
                self.decoded[my, mx] = True
                self.mbs.append(MBInfo(kind, (0, 0), qp))
            elif 6 <= mb_type <= 29:
                self.mb_intra[my, mx] = True
                qp = self.decode_i16x16(br, mx, my, mb_type - 5, qp)
                self.decoded[my, mx] = True
                self.mbs.append(MBInfo("I16x16", (0, 0), qp))
            else:
                raise AssertionError(f"unsupported P mb_type {mb_type}")
            addr += 1


def _deblock(dec: SliceDecoder, qp: int, alpha_off: int, beta_off: int,
             cqo: int, is_b: bool = False):
    """The in-loop filter of a decoded slice, with the port's deblocker
    (`ops.deblock`, its plain version on the CPU), at each MB's QP (the
    mb_qp_delta chain, adaptive quantization's per-MB QPs included: an MB
    edge averages the two MBs' QPs). In a B slice the boundary strength
    compares both lists' motion (spec 8.7.2.1, x264's frame.c:735-741),
    where an unused list is ref -1 / mv 0."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32))

    qp_map = np.array([m.qp for m in dec.mbs], np.int32).reshape(dec.mbh,
                                                                 dec.mbw)
    if (qp_map == qp).all():
        qpc = int(CHROMA_QP[np.clip(qp + cqo, 0, 51)])
    else:
        qp, qpc = t(qp_map), t(CHROMA_QP[np.clip(qp_map + cqo, 0, 51)])

    # a trans8 MB's 4x4 cells carry their 8x8 block's coefficient count
    t8r = np.repeat(np.repeat(dec.mb_trans8, 4, 0), 4, 1)
    nz8r = np.repeat(np.repeat(dec.nnz8, 2, 0), 2, 1)
    nnz = np.where(t8r, nz8r, dec.nnz_y)
    par = DB.edge_params(t(dec.mb_intra), t(dec.mb_skip), t(nnz),
                         t(dec.mv4), qp, qpc, dec.mbh, dec.mbw,
                         qp_thresh=15 - min(alpha_off, beta_off)
                         - max(cqo, 0), off_a=alpha_off, off_b=beta_off,
                         ref4=t(dec.ref4 if is_b
                                else np.maximum(dec.ref4, 0)),
                         trans8=t(dec.mb_trans8),
                         mv4_l1=t(dec.mv4_1) if is_b else None,
                         ref4_l1=t(dec.ref4_1) if is_b else None)
    planes = DB.deblock_frame_plain(t(dec.y), t(dec.u), t(dec.v), par,
                                    dec.mbh, dec.mbw)
    return tuple(p.numpy().astype(np.int64) for p in planes)


def decode_annexb(data: bytes) -> list[DecodedFrame]:
    """Decode an Annex-B stream (IDR + P/B chain, sliding-window DPB of
    sps.num_ref_frames references). With poc_type 0 (B streams) the
    frames are returned in display (POC) order within each IDR period;
    the P frames keep their decode order among themselves."""
    sps = pps = None
    frames = []
    dpb = []   # [0] = most recent reference; entries carry poc + motion
    gop = 0
    prev_poc_lsb = prev_poc_msb = 0
    for nal_type, ref_idc, rbsp in parse_nals(data):
        if nal_type == 7:
            sps = parse_sps(rbsp)
        elif nal_type == 8:
            pps = parse_pps(rbsp)
        elif nal_type in (1, 5):
            br = BitReader(rbsp)
            first_mb = br.read_ue()
            assert first_mb == 0, "multi-slice frames unsupported"
            slice_type = br.read_ue()
            br.read_ue()  # pps id
            frame_num = br.read(sps.log2_max_frame_num)
            if nal_type == 5:
                br.read_ue()  # idr_pic_id
            poc = 0
            if sps.poc_type == 0:
                lsb = br.read(sps.log2_max_poc_lsb)
                max_lsb = 1 << sps.log2_max_poc_lsb
                if nal_type == 5:
                    prev_poc_lsb = prev_poc_msb = 0
                    msb = 0
                elif (lsb < prev_poc_lsb
                        and prev_poc_lsb - lsb >= max_lsb // 2):
                    msb = prev_poc_msb + max_lsb
                elif (lsb > prev_poc_lsb
                        and lsb - prev_poc_lsb > max_lsb // 2):
                    msb = prev_poc_msb - max_lsb
                else:
                    msb = prev_poc_msb
                poc = msb + lsb
                if ref_idc != 0:
                    prev_poc_lsb, prev_poc_msb = lsb, msb
            is_b = slice_type in (1, 6)
            direct_spatial = bool(br.read1()) if is_b else True
            reorder_l0 = None
            l0_override = None
            if slice_type in (0, 5) or is_b:
                if br.read1():  # num_ref_idx_override
                    l0_override = br.read_ue() + 1
                    if is_b and br.read_ue() != 0:
                        raise NotImplementedError("more than one L1 ref")
                if br.read1():  # ref_pic_list_reordering_flag_l0
                    # short-term reordering ops (spec 7.3.3.1)
                    reorder_l0 = []
                    while True:
                        idc = br.read_ue()
                        if idc == 3:
                            break
                        assert idc in (0, 1), \
                            "long-term reordering unsupported"
                        reorder_l0.append((idc, br.read_ue()))
                if is_b and br.read1():
                    raise NotImplementedError("L1 reordering")
            if nal_type == 5:
                br.read1()
                br.read1()
            elif ref_idc != 0:
                assert br.read1() == 0  # sliding window
            cabac_model = 0
            if pps.cabac and slice_type not in (2, 7):
                cabac_model = br.read_ue()  # cabac_init_idc
            qp = pps.pic_init_qp + br.read_se()
            disable = 1
            alpha_off = beta_off = 0
            if pps.deblocking_control_present:
                disable = br.read_ue()
                if disable != 1:
                    alpha_off = 2 * br.read_se()
                    beta_off = 2 * br.read_se()
            if nal_type == 5:
                dpb = []   # IDR resets the DPB
                gop += 1
            if is_b:
                if pps.weighted_bipred_idc == 1:
                    raise NotImplementedError("explicit weighted bipred")
                # default B lists (spec 8.2.4.2.3): L0 past references
                # POC-descending, L1 future ones POC-ascending
                l0 = sorted((e for e in dpb if e["poc"] < poc),
                            key=lambda e: -e["poc"])
                l1 = sorted((e for e in dpb if e["poc"] > poc),
                            key=lambda e: e["poc"])
                assert l0 and l1, "B slice needs refs on both sides"
                dec = SliceDecoder(sps, pps, refs=l0, refs_l1=l1, poc=poc,
                                   direct_spatial=direct_spatial)
                # the signalled L0 size governs te(v) parsing (7.4.3)
                dec.b_l0_active = (l0_override if l0_override is not None
                                   else pps.num_ref_idx_l0_active)
                assert dec.b_l0_active <= len(l0), \
                    f"B slice signals {dec.b_l0_active} L0 refs, " \
                    f"DPB has {len(l0)}"
                if pps.cabac:
                    _decode_slice_cabac_b(dec, br, qp, cabac_model)
                else:
                    dec.decode_b_slice(br, qp)
            else:
                dec = _decode_p_or_i(sps, pps, br, dpb, slice_type, qp,
                                     frame_num, reorder_l0, l0_override,
                                     cabac_model)
            if disable != 1:
                dec.y, dec.u, dec.v = _deblock(dec, qp, alpha_off, beta_off,
                                               pps.chroma_qp_index_offset,
                                               is_b)
            _append_frame(frames, dec, sps, slice_type, poc, gop)
            if ref_idc != 0:
                dpb.insert(0, _dpb_entry(dec, pps, nal_type, slice_type,
                                         frame_num, poc, is_b))
                del dpb[max(1, sps.num_ref_frames):]
    if sps is not None and sps.poc_type == 0:
        # display (POC) order within each IDR period
        order = sorted(range(len(frames)),
                       key=lambda i: (frames[i][0], frames[i][1].poc))
        return [frames[i][1] for i in order]
    return [f for _, f in frames]


def _decode_p_or_i(sps, pps, br, dpb, slice_type: int, qp: int,
                   frame_num: int, reorder_l0, l0_override, cabac_model):
    """An I or P slice: the default P list (PicNum descending) with the
    slice's reordering ops applied, then the slice data."""
    l0p = list(dpb)   # default P order: PicNum descending
    if reorder_l0:
        # apply 8.2.4.3.1: move each addressed short-term
        # ref to the next list position
        max_fn = 1 << sps.log2_max_frame_num
        pred = frame_num
        for idx, (idc, arg) in enumerate(reorder_l0):
            if idc == 0:
                pred -= arg + 1
                if pred < 0:
                    pred += max_fn
            else:
                pred += arg + 1
                if pred >= max_fn:
                    pred -= max_fn
            j = next(i for i, e in enumerate(l0p)
                     if e["frame_num"] % max_fn == pred)
            l0p.insert(idx, l0p.pop(j))
    dec = SliceDecoder(sps, pps, refs=l0p)
    dec.p_l0_active = l0_override
    if pps.cabac:
        _decode_slice_cabac(dec, br, slice_type, qp, cabac_model)
    else:
        dec.decode_slice(br, slice_type, qp)
    return dec


def _dpb_entry(dec, pps, nal_type: int, slice_type: int, frame_num: int,
               poc: int, is_b: bool) -> dict:
    """A decoded reference picture as a DPB entry: padded planes, POC,
    frame_num, the colocated fields a later B reads and its own active L0
    POCs (map_col_to_list0, spec 8.4.1.2.3). For a reference B the
    spatial field takes L1's motion where L0 is unused (spec 8.4.1.2.2)
    and temporal reads the L0-only field, as x264's cache does
    (macroblock.c:187): intra stays -1, an L1-only block is -2 (the
    macroblock.c:199 direct-unavailable case)."""
    col_mv, col_ref = dec.mv4, dec.ref4
    col_mv0, col_ref0 = dec.mv4, dec.ref4
    if is_b:
        m0 = dec.ref4 >= 0
        col_mv = np.where(m0[..., None], dec.mv4, dec.mv4_1)
        col_ref = np.where(m0, dec.ref4, dec.ref4_1)
        col_mv0 = np.where(m0[..., None], dec.mv4, 0)
        col_ref0 = np.where(m0, dec.ref4,
                            np.where(dec.ref4_1 >= 0, -2, -1))
        rp0 = [e["poc"] for e in dec.refs[:dec.b_l0_active]]
    elif slice_type in (2, 7) or nal_type == 5:
        rp0 = []
    else:
        n_act = (dec.p_l0_active if dec.p_l0_active is not None
                 else pps.num_ref_idx_l0_active)
        rp0 = [e["poc"] for e in dec.refs[:n_act]]
    return {"luma": R.np_hpel_planes(R.np_pad(dec.y)),
            "u": R.np_pad(dec.u), "v": R.np_pad(dec.v),
            "frame_num": frame_num, "poc": poc,
            "mv4": col_mv.copy(), "ref4": col_ref.copy(),
            "mv4_l0": col_mv0.copy(), "ref4_l0": col_ref0.copy(),
            "ref_poc0": rp0}


def _append_frame(frames, dec, sps, slice_type: int, poc: int, gop: int):
    h, w = sps.height, sps.width
    frames.append((gop, DecodedFrame(
        y=dec.y[:h, :w].astype(np.uint8),
        u=dec.u[:h // 2, :w // 2].astype(np.uint8),
        v=dec.v[:h // 2, :w // 2].astype(np.uint8),
        slice_type=slice_type, mbs=dec.mbs, poc=poc)))


# ---------------------------------------------------------------------------
# CABAC slice decode (spec 7.3.4 ae(v) path; parser in cabac_dec.py)
# ---------------------------------------------------------------------------

def _dez16(levels):
    return R.dezigzag(list(levels))


def _decode_slice_cabac(dec: SliceDecoder, br, slice_type: int, qp: int,
                        model: int = 0):
    from .cabac_dec import CabacSliceParser

    while br.bit_position() % 8:
        assert br.read1() == 1, "cabac_alignment_one_bit must be 1"
    is_i = slice_type in (2, 7)
    ps = CabacSliceParser(br, dec.mbw, dec.mbh, qp, is_i, model,
                          num_ref=(dec.p_l0_active
                                   if dec.p_l0_active is not None
                                   else dec.pps.num_ref_idx_l0_active),
                          trans8_mode=dec.pps.transform_8x8)
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    n = dec.mbh * dec.mbw
    for a in range(n):
        my, mx = a // dec.mbw, a % dec.mbw
        if is_i:
            i4, mode16, cbpl, cbpc = ps.mb_type_i_slice(my, mx)
            if i4:
                if ps.trans8_mode and ps.transform_size_flag(my, mx):
                    _recon_i8_cabac(dec, ps, my, mx, qp, qpc)
                else:
                    _recon_i4_cabac(dec, ps, my, mx, qp, qpc)
            else:
                _recon_i16_cabac(dec, ps, my, mx, mode16, cbpl, cbpc,
                                 qp, qpc)
            dec.decoded[my, mx] = True
        else:
            if ps.skip_flag(my, mx):
                ps.parse_skip_mb(my, mx)
                dec.decode_pskip(mx, my, ps.qp)
            else:
                is_intra, info = ps.mb_type_p()
                if is_intra:
                    i4, mode16, cbpl, cbpc = info
                    dec.mb_intra[my, mx] = True
                    if i4:
                        if ps.trans8_mode \
                                and ps.transform_size_flag(my, mx):
                            _recon_i8_cabac(dec, ps, my, mx, qp, qpc)
                        else:
                            _recon_i4_cabac(dec, ps, my, mx, qp, qpc)
                    else:
                        _recon_i16_cabac(dec, ps, my, mx, mode16, cbpl,
                                         cbpc, qp, qpc)
                    dec.decoded[my, mx] = True
                else:
                    _recon_p_cabac(dec, ps, my, mx, info, qp, qpc)
        eos = ps.end_mb()
        assert eos == (1 if a == n - 1 else 0), f"end_of_slice at MB {a}"
    dec.nnz_y = ps.nnz_y  # deblock consumes the luma nnz map


def _recon_chroma_from(dec, ps, my, mx, cmode, cbp_chroma, cdcs, cacs,
                       qpc, intra, preds=None):
    gx, gy = 8 * mx, 8 * my
    at, al = my > 0, mx > 0
    for ch, plane in ((0, dec.u), (1, dec.v)):
        dc2 = np.array([[cdcs[ch][0], cdcs[ch][1]],
                        [cdcs[ch][2], cdcs[ch][3]]], np.int64)
        dc = (dec.Q.dequant_dc_chroma(R.ihadamard2x2(dc2), qpc,
                                      intra=intra)
              if cbp_chroma else np.zeros((2, 2), np.int64))
        blocks = np.zeros((2, 2, 4, 4), np.int64)
        if cbp_chroma == 2:
            for by in range(2):
                for bx in range(2):
                    blocks[by, bx] = dec.Q.dequant4x4(
                        _dez16(cacs[ch, by, bx]), qpc, intra=intra)
        blocks[:, :, 0, 0] = dc
        if preds is not None:
            pred = preds[ch]
        elif intra:
            top = plane[gy - 1, gx:gx + 8] if at else np.zeros(8, np.int64)
            left = plane[gy:gy + 8, gx - 1] if al else np.zeros(8, np.int64)
            tl = plane[gy - 1, gx - 1] if (at and al) else 0
            pred = R.pred_chroma(cmode, top, left, tl, at, al)
        else:
            pred = dec._inter_pred_chroma(ch, mx, my)
        for by in range(2):
            for bx in range(2):
                py, px = gy + 4 * by, gx + 4 * bx
                plane[py:py + 4, px:px + 4] = R.recon_block4x4(
                    pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                    blocks[by, bx])


def _recon_i16_cabac(dec, ps, my, mx, mode16, cbpl, cbpc, qp, qpc):
    cmode, dc_lv, acs, cdcs, cacs = ps.parse_i16_mb(
        my, mx, mode16, cbpl, cbpc)
    qp = ps.qp
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    gx, gy = 16 * mx, 16 * my
    at, al = my > 0, mx > 0
    top = dec.y[gy - 1, gx:gx + 16] if at else np.zeros(16, np.int64)
    left = dec.y[gy:gy + 16, gx - 1] if al else np.zeros(16, np.int64)
    tl = dec.y[gy - 1, gx - 1] if (at and al) else 0
    pred = R.pred_16x16(mode16, top, left, tl, at, al)
    dc = dec.Q.dequant_dc_luma(R.ihadamard4x4(_dez16(dc_lv)), qp)
    blocks = np.zeros((4, 4, 4, 4), np.int64)
    for by in range(4):
        for bx in range(4):
            if cbpl:
                blocks[by, bx] = dec.Q.dequant4x4(_dez16(acs[by, bx]), qp,
                                                  intra=True)
    blocks[:, :, 0, 0] = dc
    for by in range(4):
        for bx in range(4):
            py, px = gy + 4 * by, gx + 4 * bx
            dec.y[py:py + 4, px:px + 4] = R.recon_block4x4(
                pred[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                blocks[by, bx])
    _recon_chroma_from(dec, ps, my, mx, cmode, cbpc, cdcs, cacs, qpc,
                       True)
    # intra neighbours: AVAILABLE with mv 0 / ref -1 for MVP/P_SKIP
    # (x264 cache -1 vs -2 outside, macroblock.c:28-46)
    dec.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
    dec.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
    dec.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
    dec.mb_intra[my, mx] = True
    dec.mbs.append(MBInfo("I16x16", (0, 0), qp))


def _recon_i4_cabac(dec, ps, my, mx, qp, qpc):
    modes, cmode, cbp_luma, cbp_chroma, blk_lv, cdcs, cacs = \
        ps.parse_i4_mb(my, mx)
    qp = ps.qp
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    blocks = np.zeros((4, 4, 4, 4), np.int64)
    for by in range(4):
        for bx in range(4):
            blocks[by, bx] = dec.Q.dequant4x4(_dez16(blk_lv[by, bx]), qp,
                                              intra=True)
    for blk in range(16):
        by, bx = LUMA_SCAN[blk]
        # keep the CAVLC-path mode map in sync for any later MBs
        dec.modes4[4 * my + by, 4 * mx + bx] = modes[blk]
        pred = dec._i4_pred_block(mx, my, by, bx, int(modes[blk]))
        py, px = 16 * my + 4 * by, 16 * mx + 4 * bx
        dec.y[py:py + 4, px:px + 4] = R.recon_block4x4(
            pred, blocks[by, bx])
    _recon_chroma_from(dec, ps, my, mx, cmode, cbp_chroma, cdcs, cacs,
                       qpc, True)
    # intra neighbours: AVAILABLE with mv 0 / ref -1 for MVP/P_SKIP
    # (x264 cache -1 vs -2 outside, macroblock.c:28-46)
    dec.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
    dec.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
    dec.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
    dec.mb_intra[my, mx] = True
    dec.mbs.append(MBInfo("I4x4", (0, 0), qp))


def _recon_i8_cabac(dec, ps, my, mx, qp, qpc):
    """I_NxN with transform flag 1 under CABAC: cat-5 residual +
    shared 8x8 prediction/recon helpers (twin of decode_i8x8)."""
    modes8, cmode, cbp_luma, cbp_chroma, lev8, cdcs, cacs = \
        ps.parse_i8_mb(my, mx)
    qp = ps.qp
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    for b, (by8, bx8) in enumerate(dec._Z8):
        # keep the CAVLC-path mode map in sync for later i4 MBs
        dec.modes4[4 * my + 2 * by8:4 * my + 2 * by8 + 2,
                   4 * mx + 2 * bx8:4 * mx + 2 * bx8 + 2] = modes8[b]
        deq = dec.Q.dequant8x8(R.dezigzag8(lev8[by8, bx8]), qp, intra=True)
        pred = dec._i8_pred_block(mx, my, by8, bx8, int(modes8[b]))
        py, px = 16 * my + 8 * by8, 16 * mx + 8 * bx8
        dec.y[py:py + 8, px:px + 8] = R.idct8x8_add(pred, deq)
    _recon_chroma_from(dec, ps, my, mx, cmode, cbp_chroma, cdcs, cacs,
                       qpc, True)
    # intra neighbours: AVAILABLE with mv 0 / ref -1 for MVP/P_SKIP
    # (x264 cache -1 vs -2 outside, macroblock.c:28-46)
    dec.dec4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = True
    dec.mv4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = 0
    dec.ref4[4 * my:4 * my + 4, 4 * mx:4 * mx + 4] = -1
    dec.mb_intra[my, mx] = True
    dec.mb_trans8[my, mx] = True
    dec.mbs.append(MBInfo("I8x8", (0, 0), qp))


def _recon_p_cabac(dec, ps, my, mx, part, qp, qpc):
    ((mvds, subs, refs), cbp_luma, cbp_chroma, blk_lv, cdcs, cacs,
     lev8) = ps.parse_p_mb(my, mx, part)
    qp = ps.qp
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    geom = mb_units(part, subs)
    ref_geom = UNIT_GEOM[part]
    y4, x4 = 4 * my, 4 * mx
    for k, (oy, ox, w4, h4) in enumerate(ref_geom):
        dec.ref4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = refs[k]
    unit_mvs = []
    for u, (oy, ox, w4, h4) in enumerate(geom):
        mvp = dec._unit_mvp(y4 + oy, x4 + ox, w4, part, u,
                            ref=int(dec.ref4[y4 + oy, x4 + ox]))
        mv = np.array([mvp[0] + mvds[u][0], mvp[1] + mvds[u][1]],
                      np.int32)
        dec.mv4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = mv
        dec.dec4[y4 + oy:y4 + oy + h4, x4 + ox:x4 + ox + w4] = True
        unit_mvs.append((int(mv[0]), int(mv[1])))
    if lev8 is not None:
        deq8 = np.stack([np.stack([
            dec.Q.dequant8x8(R.dezigzag8(lev8[a, b2]), qp, intra=False)
            for b2 in range(2)]) for a in range(2)])
        dec._recon_inter_luma8(mx, my, deq8)
        dec.mb_trans8[my, mx] = True
        for b, (by8, bx8) in enumerate(dec._Z8):
            dec.nnz8[2 * my + by8, 2 * mx + bx8] = int(
                np.count_nonzero(lev8[by8, bx8]))
    else:
        blocks = np.zeros((4, 4, 4, 4), np.int64)
        for by in range(4):
            for bx in range(4):
                if cbp_luma & (1 << ((by // 2) * 2 + bx // 2)):
                    blocks[by, bx] = dec.Q.dequant4x4(
                        _dez16(blk_lv[by, bx]), qp)
        dec._recon_inter_luma(mx, my, blocks)
    _recon_chroma_from(dec, ps, my, mx, 0, cbp_chroma, cdcs, cacs, qpc,
                       False)
    dec.decoded[my, mx] = True
    kind = ("P16x16", "P16x8", "P8x16", "P8x8")[part]
    dec.mbs.append(MBInfo(kind, unit_mvs[0], qp, unit_mvs=unit_mvs))


def _decode_slice_cabac_b(dec: SliceDecoder, br, qp: int, model: int = 0):
    """CABAC B slice (twin of the encoder's B writer): B_Skip, direct,
    16x16 and partition MBs, and intra MBs (the B prefix, then the I
    slice's intra binarization)."""
    from .cabac_dec import CabacSliceParser

    while br.bit_position() % 8:
        assert br.read1() == 1, "cabac_alignment_one_bit must be 1"
    ps = CabacSliceParser(br, dec.mbw, dec.mbh, qp, False, model,
                          num_ref=dec.b_l0_active, slice_is_b=True,
                          trans8_mode=dec.pps.transform_8x8,
                          b_t8_present=dec.b_t8_present)
    n = dec.mbh * dec.mbw
    for a in range(n):
        my, mx = a // dec.mbw, a % dec.mbw
        if ps.skip_flag(my, mx):
            ps.parse_b_skip_mb(my, mx)
            dec.decode_b_skip(mx, my, ps.qp)
        else:
            btype = ps.mb_type_b(my, mx)
            if btype <= 22:
                _recon_b_cabac(dec, ps, my, mx, btype)
            else:
                i4, mode16, cbpl, cbpc = ps.mb_type_b_intra_suffix()
                dec.mb_intra[my, mx] = True
                qpc = int(CHROMA_QP[np.clip(
                    qp + dec.pps.chroma_qp_index_offset, 0, 51)])
                if not i4:
                    _recon_i16_cabac(dec, ps, my, mx, mode16, cbpl, cbpc, qp,
                                     qpc)
                elif ps.trans8_mode and ps.transform_size_flag(my, mx):
                    _recon_i8_cabac(dec, ps, my, mx, qp, qpc)
                else:
                    _recon_i4_cabac(dec, ps, my, mx, qp, qpc)
                dec.decoded[my, mx] = True
        eos = ps.end_mb()
        assert eos == (1 if a == n - 1 else 0), f"end_of_slice at MB {a}"
    dec.nnz_y = ps.nnz_y


def _recon_b_cabac(dec, ps, my, mx, code):
    """One coded B MB: parse (16x16 codes 0-3 by `parse_b_mb`, partition
    codes 4-22 by `parse_b_mb_parts`), derive and commit its MVs, then
    the bipred recon with its residual."""
    y4, x4 = 4 * my, 4 * mx
    if code <= 3:
        mvd0, mvd1, cbpl, cbpc, blk_lv, cdcs, cacs, r0 = \
            ps.parse_b_mb(my, mx, code)
        if code == 0:
            use0, use1, mv0, mv1, r0, _r1 = dec._direct_coded(my, mx)
        else:
            use0, use1 = code in (1, 3), code in (2, 3)
            mv0 = np.zeros((4, 2), np.int32)
            mv1 = np.zeros((4, 2), np.int32)
            if use0:
                mvp = dec._unit_mvp(y4, x4, 4, 0, 0, ref=r0, lst=0)
                mv0[:] = (mvp[0] + mvd0[0], mvp[1] + mvd0[1])
            if use1:
                mvp = dec._unit_mvp(y4, x4, 4, 0, 0, ref=0, lst=1)
                mv1[:] = (mvp[0] + mvd1[0], mvp[1] + mvd1[1])
        dec._commit_b(my, mx, use0, use1, mv0, mv1, r0=r0)
        kind = ("BDIRECT", "BL0", "BL1", "BBI")[code]
        unit_mvs = None
    else:
        subs, mvds, cbpl, cbpc, blk_lv, cdcs, cacs, refs_u = \
            ps.parse_b_mb_parts(my, mx, code)
        use0, use1, mv0, mv1, r0, unit_mvs = dec._derive_b_parts_mvs(
            mx, my, code, subs, mvds, refs_u)
        kind = "B8x8" if code == 22 else \
            ("B16x8" if code % 2 == 0 else "B8x16")
    qp = ps.qp
    qpc = int(CHROMA_QP[np.clip(qp + dec.pps.chroma_qp_index_offset,
                                0, 51)])
    py, pc = dec._b_preds(mx, my, use0, use1, mv0, mv1, r0=r0)
    gy, gx = 16 * my, 16 * mx
    for by in range(4):
        for bx in range(4):
            dec.y[gy + 4 * by:gy + 4 * by + 4,
                  gx + 4 * bx:gx + 4 * bx + 4] = R.recon_block4x4(
                py[4 * by:4 * by + 4, 4 * bx:4 * bx + 4],
                dec.Q.dequant4x4(_dez16(blk_lv[by, bx]), qp))
    _recon_chroma_from(dec, ps, my, mx, 0, cbpc, cdcs, cacs, qpc, False,
                       preds=pc)
    dec.decoded[my, mx] = True
    m0 = (int(mv0[0, 0]), int(mv0[0, 1]))
    dec.mbs.append(MBInfo(kind, m0, qp, unit_mvs=unit_mvs or [m0]))
