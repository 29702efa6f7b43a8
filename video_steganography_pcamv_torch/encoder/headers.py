"""SPS / PPS / slice-header writers.

Reference: upstream encoder/set.c (x264_sps_init:77, sps_write:215,
pps_init:368, pps_write:429) and the slice-header writer in
encoder/encoder.c (x264_slice_header_init / x264_slice_header_write).
Baseline, Main and High profile as the encoder picks them: CAVLC or
CABAC, the 8x8-transform flag, the seq scaling lists of a custom
quantizer (4x4 and 8x8), frame_mbs_only, poc_type 2 for IPP streams and
0 with B frames, one slice per frame.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.bitstream import BitWriter

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100

SLICE_TYPE_P = 0
SLICE_TYPE_B = 1
SLICE_TYPE_I = 2


# x264_levels[] (upstream encoder/set.c:509-528, x264.h:312-326):
# (level_idc, mbps, frame_size, dpb, bitrate, cpb, mv_range)
LEVELS = (
    (10,   1485,    99,   152064,     64,    175,  64),
    (11,   3000,   396,   345600,    192,    500, 128),
    (12,   6000,   396,   912384,    384,   1000, 128),
    (13,  11880,   396,   912384,    768,   2000, 128),
    (20,  11880,   396,   912384,   2000,   2000, 128),
    (21,  19800,   792,  1824768,   4000,   4000, 256),
    (22,  20250,  1620,  3110400,   4000,   4000, 256),
    (30,  40500,  1620,  3110400,  10000,  10000, 256),
    (31, 108000,  3600,  6912000,  14000,  14000, 512),
    (32, 216000,  5120,  7864320,  20000,  20000, 512),
    (40, 245760,  8192, 12582912,  20000,  25000, 512),
    (41, 245760,  8192, 12582912,  50000,  62500, 512),
    (42, 522240,  8704, 13369344,  50000,  62500, 512),
    (50, 589824, 22080, 42393600, 135000, 135000, 512),
    (51, 983040, 36864, 70778880, 240000, 240000, 512),
)

# aspect_ratio_idc table (spec E-1; set.c:289-295)
_SAR_IDC = {(1, 1): 1, (12, 11): 2, (10, 11): 3, (16, 11): 4,
            (40, 33): 5, (24, 11): 6, (20, 11): 7, (32, 11): 8,
            (80, 33): 9, (18, 11): 10, (15, 11): 11, (64, 33): 12,
            (160, 99): 13}


def pick_level(mb_width: int, mb_height: int, fps_num: int, fps_den: int,
               num_refs: int, mv_range: int) -> int:
    """Smallest level whose frame-size / MB-rate / DPB / MV-range limits
    hold (auto mode of x264's i_level_idc; checks mirror
    x264_validate_levels, upstream encoder/set.c:537)."""
    mbs = mb_width * mb_height
    dpb = mbs * 384 * num_refs
    mbps = mbs * fps_num // max(1, fps_den)
    for lev, l_mbps, l_fs, l_dpb, _br, _cpb, l_mv in LEVELS:
        if (l_fs >= mbs and l_fs * 8 >= mb_width * mb_width
                and l_fs * 8 >= mb_height * mb_height
                and l_dpb >= dpb and l_mbps >= mbps
                and l_mv >= mv_range):
            return lev
    return 51


def validate_levels(level_idc: int, mb_width: int, mb_height: int,
                    fps_num: int, fps_den: int, num_refs: int,
                    mv_range: int, vbv_maxrate: int, vbv_bufsize: int,
                    high_profile: bool) -> list:
    """Level-limit checks (x264_validate_levels, encoder/set.c:537-573).
    Returns a list of warning strings (empty = conformant)."""
    lev = next((l for l in LEVELS if l[0] == level_idc), None)
    if lev is None:
        return [f"unknown level_idc {level_idc}"]
    _, l_mbps, l_fs, l_dpb, l_br, l_cpb, l_mv = lev
    mbs = mb_width * mb_height
    errs = []
    if (l_fs < mbs or l_fs * 8 < mb_width * mb_width
            or l_fs * 8 < mb_height * mb_height):
        errs.append(f"frame MB size ({mb_width}x{mb_height}) > level "
                    f"limit ({l_fs})")
    dpb = mbs * 384 * num_refs
    if dpb > l_dpb:
        errs.append(f"DPB size ({num_refs} frames, {dpb} bytes) > level "
                    f"limit ({l_dpb})")
    cbp_factor = 5 if high_profile else 4
    if vbv_maxrate > l_br * cbp_factor // 4:
        errs.append(f"VBV bitrate ({vbv_maxrate}) > level limit "
                    f"({l_br * cbp_factor // 4})")
    if vbv_bufsize > l_cpb * cbp_factor // 4:
        errs.append(f"VBV buffer ({vbv_bufsize}) > level limit "
                    f"({l_cpb * cbp_factor // 4})")
    if mv_range > l_mv:
        errs.append(f"MV range ({mv_range}) > level limit ({l_mv})")
    if fps_den > 0:
        mbps = mbs * fps_num // fps_den
        if mbps > l_mbps:
            errs.append(f"MB rate ({mbps}) > level limit ({l_mbps})")
    return errs


@dataclass
class VUI:
    """VUI parameters (spec Annex E; fields as x264_sps_init assembles
    them, upstream encoder/set.c:147-211)."""
    sar_width: int = 0
    sar_height: int = 0
    overscan: int = 0        # 0 undef, 1 show, 2 crop
    videoformat: int = 5
    fullrange: bool = False
    colorprim: int = 2
    transfer: int = 2
    colmatrix: int = 2
    chromaloc: int = 0
    fps_num: int = 0         # timing_info (0 = absent)
    fps_den: int = 0
    num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 1
    mv_range: int = 512      # drives log2_max_mv_length

    def write(self, bw: BitWriter) -> None:
        """VUI bitstream (x264_sps_write VUI section, set.c:287-361)."""
        sar = self.sar_width > 0 and self.sar_height > 0
        bw.write1(1 if sar else 0)
        if sar:
            idc = _SAR_IDC.get((self.sar_width, self.sar_height))
            if idc is not None:
                bw.write(8, idc)
            else:
                bw.write(8, 255)  # Extended_SAR
                bw.write(16, self.sar_width)
                bw.write(16, self.sar_height)
        bw.write1(1 if self.overscan else 0)
        if self.overscan:
            bw.write1(1 if self.overscan == 2 else 0)
        color_desc = (self.colorprim != 2 or self.transfer != 2
                      or self.colmatrix != 2)
        signal_type = (self.videoformat != 5 or self.fullrange
                       or color_desc)
        bw.write1(1 if signal_type else 0)
        if signal_type:
            bw.write(3, min(self.videoformat, 5))
            bw.write1(1 if self.fullrange else 0)
            bw.write1(1 if color_desc else 0)
            if color_desc:
                bw.write(8, self.colorprim)
                bw.write(8, self.transfer)
                bw.write(8, self.colmatrix)
        bw.write1(1 if self.chromaloc else 0)
        if self.chromaloc:
            bw.write_ue(self.chromaloc)
            bw.write_ue(self.chromaloc)
        timing = self.fps_num > 0 and self.fps_den > 0
        bw.write1(1 if timing else 0)
        if timing:
            bw.write(32, self.fps_den)       # num_units_in_tick
            bw.write(32, self.fps_num * 2)   # time_scale
            bw.write1(1)                     # fixed_frame_rate
        bw.write1(0)  # nal_hrd_parameters_present
        bw.write1(0)  # vcl_hrd_parameters_present
        bw.write1(0)  # pic_struct_present
        bw.write1(1)  # bitstream_restriction
        bw.write1(1)  # motion_vectors_over_pic_boundaries
        bw.write_ue(0)  # max_bytes_per_pic_denom
        bw.write_ue(0)  # max_bits_per_mb_denom
        log2_mv = max(1, (4 * self.mv_range - 1).bit_length())
        bw.write_ue(log2_mv)  # log2_max_mv_length_horizontal
        bw.write_ue(log2_mv)  # log2_max_mv_length_vertical
        bw.write_ue(self.num_reorder_frames)
        bw.write_ue(self.max_dec_frame_buffering)


def _write_one_scaling_list(bw: BitWriter, vals, zz) -> None:
    """scaling_list() (spec 7.3.2.1.1): delta_scale chain over the
    zigzag order of a raster-order list."""
    last = 8
    for (r, c) in zz:
        cur = int(vals[r][c])
        delta = cur - last
        if delta > 127:
            delta -= 256
        elif delta < -128:
            delta += 256
        bw.write_se(delta)
        last = cur


def _write_scaling_lists(bw: BitWriter, s4i, s4p, s8i, s8p) -> None:
    """8 seq_scaling_list_present flags + explicit lists for 0 (intra
    4x4 Y), 3 (inter 4x4 Y), 6/7 (8x8); 1,2 and 4,5 fall back to the
    previous list (spec Table 7-2 fall-back rule A)."""
    from ..ops.transform import ZIGZAG_4x4
    from ..ops.transform8 import ZIGZAG_8x8
    import numpy as np
    zz4 = [tuple(x) for x in np.asarray(ZIGZAG_4x4).reshape(-1, 2)]
    zz8 = [tuple(x) for x in np.asarray(ZIGZAG_8x8).reshape(-1, 2)]
    flat4 = [[16] * 4] * 4
    flat8 = [[16] * 8] * 8
    for li, vals, zz, flat in ((0, s4i, zz4, flat4),
                               (3, s4p, zz4, flat4)):
        bw.write1(1)
        _write_one_scaling_list(
            bw, flat if vals is None
            else np.asarray(vals).reshape(4, 4), zz)
        bw.write1(0)   # list li+1 falls back to list li
        bw.write1(0)   # list li+2 likewise
    for vals in (s8i, s8p):
        bw.write1(1)
        _write_one_scaling_list(
            bw, flat8 if vals is None
            else np.asarray(vals).reshape(8, 8), zz8)


@dataclass
class SPS:
    width: int
    height: int
    num_ref_frames: int = 1
    log2_max_frame_num: int = 8
    level_idc: int = 30
    sps_id: int = 0
    poc_type: int = 2         # 2 for IPPP (decode==display); 0 with B
    log2_max_poc_lsb: int = 10
    profile: int = PROFILE_BASELINE
    vui: VUI = None
    # seq scaling lists (raster order; None = no seq_scaling_matrix).
    # Written in spec list order 0..7 with lists 1,2 / 4,5 absent
    # (fall-back rule A copies the previous list -> chroma shares luma,
    # matching x264 --cqm jvt / --cqm4 semantics)
    scaling4_intra: object = None
    scaling4_inter: object = None
    scaling8_intra: object = None
    scaling8_inter: object = None

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    def write(self) -> bytes:
        bw = BitWriter()
        bw.write(8, self.profile)
        bw.write1(1 if self.profile == PROFILE_BASELINE else 0)
        bw.write1(1 if self.profile == PROFILE_MAIN else 0)
        bw.write1(0)  # constraint_set2
        bw.write(5, 0)  # constraint_set3 + reserved
        bw.write(8, self.level_idc)
        bw.write_ue(self.sps_id)
        if self.profile >= PROFILE_HIGH:
            # High-profile extension block (spec 7.3.2.1; reference
            # sps_write for FRExt profiles)
            bw.write_ue(1)   # chroma_format_idc 4:2:0
            bw.write_ue(0)   # bit_depth_luma_minus8
            bw.write_ue(0)   # bit_depth_chroma_minus8
            bw.write1(0)     # qpprime_y_zero_transform_bypass
            if self.scaling4_intra is None \
                    and self.scaling4_inter is None \
                    and self.scaling8_intra is None \
                    and self.scaling8_inter is None:
                bw.write1(0)  # seq_scaling_matrix_present
            else:
                bw.write1(1)  # seq_scaling_matrix_present
                _write_scaling_lists(
                    bw, self.scaling4_intra, self.scaling4_inter,
                    self.scaling8_intra, self.scaling8_inter)
        bw.write_ue(self.log2_max_frame_num - 4)
        bw.write_ue(self.poc_type)
        if self.poc_type == 0:
            bw.write_ue(self.log2_max_poc_lsb - 4)
        bw.write_ue(self.num_ref_frames)
        bw.write1(0)  # gaps_in_frame_num_value_allowed
        bw.write_ue(self.mb_width - 1)
        bw.write_ue(self.mb_height - 1)
        bw.write1(1)  # frame_mbs_only
        bw.write1(1)  # direct_8x8_inference
        crop_r = self.mb_width * 16 - self.width
        crop_b = self.mb_height * 16 - self.height
        if crop_r or crop_b:
            bw.write1(1)
            bw.write_ue(0)
            bw.write_ue(crop_r // 2)
            bw.write_ue(0)
            bw.write_ue(crop_b // 2)
        else:
            bw.write1(0)
        if self.vui is not None:
            bw.write1(1)
            self.vui.write(bw)
        else:
            bw.write1(0)  # vui_parameters_present
        bw.rbsp_trailing()
        return bw.get_bytes()


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    pic_init_qp: int = 26
    chroma_qp_index_offset: int = 0
    num_ref_idx_l0_active: int = 1
    cabac: bool = False
    transform_8x8: bool = False
    weighted_bipred_idc: int = 0   # 2 = implicit (x264 set.c:384)

    def write(self) -> bytes:
        bw = BitWriter()
        bw.write_ue(self.pps_id)
        bw.write_ue(self.sps_id)
        bw.write1(1 if self.cabac else 0)  # entropy_coding_mode
        bw.write1(0)  # pic_order_present
        bw.write_ue(0)  # num_slice_groups - 1
        bw.write_ue(self.num_ref_idx_l0_active - 1)
        bw.write_ue(0)  # num_ref_idx_l1_active - 1
        bw.write1(0)  # weighted_pred
        bw.write(2, self.weighted_bipred_idc)
        bw.write_se(self.pic_init_qp - 26)
        bw.write_se(0)  # pic_init_qs
        bw.write_se(self.chroma_qp_index_offset)
        bw.write1(1)  # deblocking_filter_control_present
        bw.write1(0)  # constrained_intra_pred
        bw.write1(0)  # redundant_pic_cnt_present
        if self.transform_8x8:
            # PPS FRExt tail (spec 7.3.2.2 more_rbsp_data section)
            bw.write1(1)     # transform_8x8_mode_flag
            bw.write1(0)     # pic_scaling_matrix_present
            bw.write_se(self.chroma_qp_index_offset)  # 2nd chroma offset
        bw.rbsp_trailing()
        return bw.get_bytes()


def write_slice_header(bw: BitWriter, sps: SPS, pps: PPS, slice_type: int,
                       frame_num: int, qp: int, idr: bool,
                       idr_pic_id: int = 0,
                       disable_deblock: int = 1,
                       poc_lsb: int = 0, is_ref: bool = True,
                       alpha_div2: int = 0, beta_div2: int = 0,
                       direct_spatial: bool = True,
                       reorder_l0=None,
                       b_l0_active: int = 1,
                       p_l0_active: int = None) -> None:
    """Single-slice frame header (reference: encoder/encoder.c slice
    header writer; fields per spec 7.3.3)."""
    bw.write_ue(0)  # first_mb_in_slice
    bw.write_ue(slice_type)
    bw.write_ue(pps.pps_id)
    bw.write(sps.log2_max_frame_num, frame_num % (1 << sps.log2_max_frame_num))
    if idr:
        bw.write_ue(idr_pic_id)
    if sps.poc_type == 0:
        bw.write(sps.log2_max_poc_lsb,
                 poc_lsb % (1 << sps.log2_max_poc_lsb))
    if slice_type == SLICE_TYPE_B:
        bw.write1(1 if direct_spatial else 0)  # direct_spatial_mv_pred
    if slice_type in (SLICE_TYPE_P, SLICE_TYPE_B):
        if (slice_type == SLICE_TYPE_B
                and pps.num_ref_idx_l0_active != b_l0_active):
            # override the PPS default (spec 7.4.3): b_l0_active L0
            # refs (1 = single-ref B under a multi-ref-P PPS; >1 =
            # multi-ref B lists), always one L1 ref
            bw.write1(1)
            bw.write_ue(b_l0_active - 1)  # num_ref_idx_l0_active_minus1
            bw.write_ue(0)   # num_ref_idx_l1_active_minus1
        elif (slice_type == SLICE_TYPE_P and p_l0_active is not None
                and pps.num_ref_idx_l0_active != p_l0_active):
            # P-slice override: encoder_reconfig can shrink the live
            # reference window below the PPS default (encoder.c:840)
            bw.write1(1)
            bw.write_ue(p_l0_active - 1)  # num_ref_idx_l0_active_minus1
        else:
            bw.write1(0)  # num_ref_idx_active_override
        if reorder_l0:
            # ref_pic_list_reordering (spec 7.3.3.1): explicit L0
            # order when the default PicNum-descending list differs
            # from the encoder's references (B-pyramid: the next P
            # wants the previous anchor ahead of the BREF; the
            # reference emits the same ops, encoder/encoder.c:138-150)
            bw.write1(1)
            for idc, arg in reorder_l0:
                bw.write_ue(idc)
                bw.write_ue(arg)   # abs_diff_pic_num_minus1
            bw.write_ue(3)         # end of reordering ops
        else:
            bw.write1(0)  # ref_pic_list_reordering_flag_l0
        if slice_type == SLICE_TYPE_B:
            bw.write1(0)  # ref_pic_list_reordering_flag_l1
    # dec_ref_pic_marking only for reference pictures (nal_ref_idc != 0)
    if idr:
        bw.write1(0)  # no_output_of_prior_pics
        bw.write1(0)  # long_term_reference_flag
    elif is_ref:
        bw.write1(0)  # adaptive_ref_pic_marking_mode (sliding window)
    if pps.cabac and slice_type != SLICE_TYPE_I:
        bw.write_ue(0)  # cabac_init_idc
    bw.write_se(qp - pps.pic_init_qp)
    # deblocking_filter_control_present == 1:
    bw.write_ue(disable_deblock)
    if disable_deblock != 1:
        bw.write_se(alpha_div2)  # slice_alpha_c0_offset_div2
        bw.write_se(beta_div2)   # slice_beta_offset_div2


NAL_SEI = 6
NAL_AUD = 9
SEI_USER_DATA_UNREGISTERED = 5

# primary_pic_type by slice type present in the AU (spec Table 7-5)
_AUD_PIC_TYPE = {SLICE_TYPE_I: 0, SLICE_TYPE_P: 1, SLICE_TYPE_B: 2}


def aud_payload(slice_type: int) -> bytes:
    """Access-unit delimiter RBSP (spec 7.3.2.4; x264 --aud writes one
    per access unit, encoder/encoder.c NAL_AUD emission)."""
    bw = BitWriter()
    bw.write(3, _AUD_PIC_TYPE.get(slice_type, 2))
    bw.rbsp_trailing()
    return bw.get_bytes()

# 16-byte UUID identifying this encoder's SEI (role of the x264 uuid in
# encoder/set.c:475-483)
_SEI_UUID = bytes([0x7c, 0x1d, 0xb2, 0x54, 0x6e, 0x49, 0x41, 0x3a,
                   0x8e, 0x11, 0x5d, 0x2f, 0x0a, 0xc5, 0x64, 0x9b])


def sei_version_payload(opt_string: str) -> bytes:
    """SEI user_data_unregistered RBSP carrying the encoder id +
    options string (x264_sei_version_write, encoder/set.c:475)."""
    body = _SEI_UUID + (
        "video-steganography-pcamv-tpu - H.264/MV-stego encoder"
        " - options: " + opt_string).encode() + b"\x00"
    bw = BitWriter()
    bw.write(8, SEI_USER_DATA_UNREGISTERED)   # payload type
    size = len(body)
    while size >= 255:
        bw.write(8, 255)
        size -= 255
    bw.write(8, size)
    for byte in body:
        bw.write(8, byte)
    bw.rbsp_trailing()
    return bw.get_bytes()
