"""Encoder lifecycle + the fused stego serving loop (port of the IPP
subset of encoder/core.py).

Per P frame: the lowres lookahead costs and the fused stage 1
(`p_stage1_stego`) are enqueued on the device; the previous frame's
entropy (native CAVLC or CABAC) is written on the host meanwhile; then
ONE `.cpu()` pull of the packed stage-1 tensor feeds the slice-type
decision and the host STC; the flip re-encode, the lean level pack and
the in-loop deblock (kernel B5) are enqueued, and the level buffer is
pulled and entropy-coded during the next frame's call (`flush` drains
the last one). Frame 0 and keyint/scenecut frames are IDR frames.

That pipelining needs `pipeline`, the device deblock and metrics off,
as in the reference. Otherwise (the reference's default Params: PSNR
on, `deblock_device=False`) each P frame takes the same fused step
unpipelined: its slice is written in its own call, and the PSNR/SSIM
of the deblocked recon is accumulated on the device (`close()`
reports it). The reference deblocks that branch on the host; the
port's deblocker (B5) is bit-exact to it.

The reference's two P-analysis branches differ, for this slice, in
B1's MV predictor, a choice the reference ties to its backend. The port
maps it onto `Params.tail_kernel` and serves it on every device: True
(the default, bench.py's serving configuration) gives the stream of the
reference's accelerator branch (a zero predictor), False that of its
CPU branch (`prev_mv >> 2`). Both run the analyse-tail kernels B2-B4 on
CUDA. Either way the stream on CUDA equals the stream on the CPU, and
equals the reference `Encoder` on the same branch.

BASELINE config 3 (`transform_8x8`, `rd` 1) takes the same pipelined
path: a High-profile SPS/PPS, Intra_8x8 and the RD choice in the IDR,
the 8x8-transform candidate and its choice in the P encodes, a full
(never incremental) pass 2, the trans8 flags into the deblock and the
8x8 levels through the lean buffer to the writer, as the reference does.

With `partitions=False` (x264's `--partitions none`) every frame takes
the reference's non-fused IPP branch instead, unpipelined: each call
returns its own access unit. A P frame runs the 16x16 analysis
(`analyse2`: kernels B6 and B7, the qpel tables), the pass-1 encode
(the fused luma-encode kernel), the native MVP/P_SKIP scan, the stego
embedding with its batched probe encode and pass-2 re-encode
(`StegoEngine.embed_frame`), the in-loop deblock (kernel B5) and the
native CAVLC or CABAC writer. The reference serves this path only with
its host deblocker (`deblock_device=False`); the port's deblocker is
bit-exact to it.

With `ref_frames` > 1 (x264's `--ref N`, BASELINE config 4's P half)
every P frame takes the reference's multi-reference branch of
`_encode_p_parts`, unpipelined, with or without partitions: B1 once per
entry of the DPB (a sliding window of `ref_frames` deblocked frames,
newest first), the per-unit reference merge, B9 with each 8x8 block's
reference, B3' -> B4', the multi-reference pass-1 encode, the native
MVP/P_SKIP scan with references, the host STC and a full pass-2
re-encode (flips change MVs, never references), B5 with the per-4x4
reference map and the native writer with ref_idx_l0. The slice header
overrides num_ref_idx_l0_active while fewer than `ref_frames` entries
are valid (after an IDR).

With `bframes` > 0 (CAVLC or CABAC, partitions on or off, any
`ref_frames`) frames are buffered in display order and coded in decode
order, as the reference's B pipe does: each GOP's last frame is a P
anchor (the unpipelined P paths above), the frames before it B slices
against the previous anchor (L0; under multi-reference the P list as it
stood before the anchor) and the new one (L1). With `b_pyramid` the
middle B of a GOP of two or more is a reference picture, coded right
after the anchor: the earlier B frames take it as L1[0], the later ones
as L0[0], and the next P slice reorders L0 to lead with the anchor (the
DPB keeps a P list view apart from its store). Direct MVs follow
`direct`: spatial, temporal (scaled from the colocated field, mapped into
L0 by POC), none, or auto (each slice takes the mode whose running score
of would-be-direct MBs leads). `weightb` makes every bipred combine
implicitly weighted by POC distance. Where a GOP ends is the lookahead's
choice: after
`bframes` B frames (`b_adapt` 0), earlier when the newest frame predicts
badly from its predecessor (`b_adapt` 1), or by the B-placement DP over
a window of up to 12 frames (`b_adapt` 2). A B frame runs the two-stage
partition analysis of `bslice.py` (B1 per list and L0 entry, B9, B3'),
or without partitions the 16x16 one (B6, B7, the qpel tables, per list
and L0 entry), the host commit with the exact spatial direct
derivation, the B encode (the fused luma-encode kernel) and the CAVLC or
CABAC B writer (native for 16x16 MBs at one reference, as in the
reference); its slice is not deblocked, and only a pyramid's reference B
enters the DPB.
`flush()` codes the buffered frames as the last GOPs.

Every path quantizes with the encoder's own `ops.cqm.QuantTables`
(`self.qt`, from `cqm`, the custom lists and the deadzones; the SPS
carries any list that is not flat), never with process state. Under
`noise_reduction` every P encode's 4x4 luma is denoised by the running
offsets (`_nr_offset`), which each P frame's pass-1 sums update
(`_nr_update`) before its pass 2, as in the reference; the pass 2 is
then a full re-encode.

Under adaptive quantization (`aq_mode` 1) every frame gets a per-MB qp
grid from its source planes (`ops.aq`: the offsets on the device, the
hysteresis on the host, `self.aq_grids`): the IDR, the P frames' pass 1
and pass 2 and the B encode quantize each MB at its qp, the writers code
the folded mb_qp_delta wherever an MB codes one, and B5 deblocks with the
decoder-visible chain of qps. The analysis, B4's probes and rho stay at
the frame qp. A one-reference P frame then takes the reference's unfused
path (`_encode_p_parts`: the stage-1 analysis, the pass-1 encode, one
pull, the native scan, the embedding with a full pass 2), unpipelined,
and the incremental re-encode is off.

With stego off (`StegoParams.em_rate` 0, the reference's default: the
plain encoder) no P frame takes the fused step: each takes the
reference's unfused `_encode_p_parts` (the port's too), unpipelined, at
one reference or more. The analysis runs B1 -> B9 -> B3 with B3's
per-MB inter cost and no B4 (at `rd` >= 1 without AQ the four-shape RD
re-rank, `partition.rd_rerank_parts`, instead), then the final encode,
the intra compare (`intra.refine_p_intra`: MBs become I16x16 or I4x4
where their intra cost beats the inter one; off under AQ), the native
scan with the intra MBs, at `rd` 2 and one reference the P_SKIP and
qpel RD probes (`_rd_skip_force`, `_rd_qpel_refine`), B5 with the intra
map, and the native writers with the intra MBs in the P slice. The
16x16-only path runs as with stego on, without the embedding. A sub-8x8
P frame (`_encode_p_sub`) takes its own analysis (at `rd` >= 1, one
reference and no AQ the seven-probe RD re-rank `partition.rd_rerank_sub`)
and the same intra compare, scan, B5 and writers. A B frame runs the
stego-on B path, then the intra compare over its recon (an MB that a
later spatial-direct MB reads as a neighbour stays inter), the rescan
around the intra MBs (no re-encode, as in the reference) and the Python
B writers with the intra MBs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..ops import aq as AQ
from ..ops import cqm as CQ
from ..ops import mc
from ..ops import probe as PR
from ..ops.deblock import deblock_frame
from ..ops.pixel import psnr_from_ssd, ssim_wxh
from ..ops.transform import chroma_qp
from ..params import Params, SLICE_I, SLICE_P, SLICE_B, param2string
from ..stego.cost import cost_mv_table
from ..state import load_state
from ..stego.embed import StegoEngine
from ..utils.bitstream import (BitWriter, nal_unit, NAL_SLICE, NAL_SLICE_IDR,
                               NAL_SPS, NAL_PPS, NAL_PRIORITY_HIGHEST,
                               NAL_PRIORITY_HIGH, NAL_PRIORITY_DISPOSABLE)
from ..utils.log import log, LOG_WARNING
from ..utils.yuv import Frame
from . import headers as H
from . import inter as P
from . import me as ME
from . import bslice as BS
from . import qpel_table as QT
from .analyse2 import analyse_p_frame
from .cabac import CabacSliceWriter
from .cavlc import FrameCavlc
from .inter_incr import changed_mbs, pad_subset, reencode_p_incremental
from .intra import encode_i_frame, refine_p_intra
from . import partition as PT
from . import scan as SCAN
from .partition import p_stage1_stego
from .ratecontrol import RateControl
from .slicetype import Lookahead

_LEAN_EXC_CAP = 4096
# luma 256 | chroma dc 8 | chroma ac 128 | cbp 2 [| luma8 256 | trans8 1]
_LEAN_WIDTH = 394
_LEAN_WIDTH8 = 257


def check_slice(p: Params) -> None:
    """Raise NotImplementedError for any option outside the ported
    slice: CQP, CAVLC or CABAC, subpel 2, decimation, incremental
    re-encode (turned off by trellis and noise reduction, as in the
    reference), me_range <= PAD - MARGIN, stego on or off (the plain
    encoder, with every option it serves while embedding: intra MBs in
    P and B frames, the rd 1/2 re-ranks and trellis 2's probe trellis on
    every P path, the sub-8x8 one's RD re-rank at one reference), and
    every combination of: the
    quant options (`cqm` flat or jvt, any custom 4x4/8x8 list,
    `deadzone_inter`/`deadzone_intra` 0-32, `noise_reduction`);
    partitions (the serving path; pipelined or not, PSNR/SSIM on or off,
    either deblocker) or partitions off with the host deblock at one
    reference (the 16x16-only path); `ref_frames` 1-8; `bframes` 0-16
    with `b_adapt` 0, 1 or 2, any `direct` mode (none, spatial, temporal,
    auto), with or without `b_pyramid` and `weightb`; the 8x8 transform,
    `rd` 0-2 and, under CABAC, `trellis` 0-2. While embedding, the
    reference codes `rd` 2 as `rd` 1 and `trellis` 2 as `trellis` 1
    (their other uses are in its stego-off branches), and takes the 8x8
    transform only in the IDR and the one-reference partitioned P
    frames: elsewhere it only signals the PPS flag, and every MB that may
    carry transform_size_8x8_flag carries 0. Noise reduction reaches the
    P frames' 4x4 luma encodes (pass 1 and pass 2), never the IDR, the
    B encode or the stego probes. Adaptive quantization (`aq_mode` 1, any
    `aq_strength` 0-3) reaches every final encode of every frame type: the
    IDR (its quants, trellis and RD lambda2 per MB), the P frames' pass 1
    and pass 2 (one reference then leaves the fused step for the unfused
    path), the B encode, their mb_qp_delta and the deblocker's qp maps;
    never the analysis, B4's probes or rho (all at the frame qp). With
    stego on the reference asserts partitions under AQ, so the 16x16-only
    path refuses it. Sub-8x8 partitions (`p4x4`, with partitions on;
    without, the reference ignores the flag) take the unfused sub path
    on every P frame and anchor, with every option above: at more than
    one reference that path stays 4x4-only (the PPS flag alone), and its
    noise-reduction offsets stay zero (F11). With more than one reference
    it takes the host deblock only: under `deblock_device` the
    reference's deblock there reads no references (ROADMAP F10). With
    stego off the sub-8x8 path re-ranks its shapes by RD at `rd` >= 1
    (one reference, no AQ; `rd` 2 codes as `rd` 1 there, as in the
    reference) and runs the intra compare, and B frames run it too (both
    B paths, every direct mode; off under AQ, as in the reference)."""
    if not p.partitions and p.deblock_device and p.ref_frames == 1:
        raise NotImplementedError(
            "partitions off with deblock_device on: the reference drops "
            "the recon planes (need_recon is False, core.py:3475-3478) and "
            "its host deblock then raises KeyError 'recon_y' (core.py:3480)"
            "; use deblock_device=False")
    bad = []
    for name, ok in (
            ("aq_mode with partitions off (the reference's Params.validate "
             "asserts the partition path while embedding)",
             not (p.aq_mode and not p.partitions)),
            ("rc_mode!=0 (ROADMAP A16)", p.rc_mode == 0),
            ("pipeline_deep (ROADMAP A19)", not p.pipeline_deep),
            ("i4x4 off (ROADMAP A16)", p.i4x4),
            ("subpel!=2 (ROADMAP A16)", p.subpel == 2),
            ("dct_decimate off (ROADMAP A16)", p.dct_decimate),
            ("incremental off (ROADMAP A16)", p.incremental),
            ("zones (ROADMAP A16)", not p.zones),
            ("qpfile (ROADMAP A16)", not p.qpfile),
            ("deblock off (ROADMAP A16)", p.deblock),
            ("me_range>%d (ROADMAP A16: a window of the qpel analysis "
             "would leave the padded planes, where the reference's CPU "
             "branch reads clamped gather indices and its TPU branch "
             "clamped strips)"
             % (mc.PAD - QT.MARGIN), p.me_range <= mc.PAD - QT.MARGIN),
            ("stego em_file (ROADMAP A16)", not p.stego.em_file),
            ("stego alpha_com (ROADMAP A16)", p.stego.alpha_com == 0.0),
            ("p4x4 with ref_frames>1 and deblock_device (ROADMAP F10: the "
             "reference's sub path deblocks without the reference map, so "
             "the decoder's recon drifts from the encoder's; use "
             "deblock_device=False)",
             not (p.p4x4 and p.partitions and p.ref_frames > 1
                  and p.deblock_device))):
        if not ok:
            bad.append(name)
    if bad:
        raise NotImplementedError(
            "outside the ported serving slice: " + ", ".join(bad))


@dataclass
class EncodeStats:
    frames: int = 0
    bits: int = 0
    ssd_y: int = 0          # summed over the frames (Params.psnr)
    ssd_u: int = 0
    ssd_v: int = 0
    ssim_sum: float = 0.0   # window SSIMs summed (Params.ssim)
    i_frames: int = 0
    p_frames: int = 0
    b_frames: int = 0
    mv_covers: int = 0
    message_bits: int = 0
    mv_flips: int = 0
    elapsed: float = 0.0
    i8x8_mbs: int = 0       # Intra_8x8 MBs of the I slices
    trans8_mbs: int = 0     # P MBs coded with the 8x8 transform


def _nnz4(lev, mbh: int, mbw: int):
    """Per-4x4 total_coeff map [4mbh, 4mbw] for the deblocker; lev is
    [mbh, mbw, ...] with 256 levels per MB in (by, bx, r, c) order."""
    l6 = lev.reshape(mbh, mbw, 4, 4, 16)
    return (l6 != 0).sum(4, dtype=torch.int32).permute(0, 2, 1, 3) \
        .reshape(4 * mbh, 4 * mbw)


def _nnz4_t8(lev4, lev8, t8, mbh: int, mbw: int):
    """Per-4x4 total_coeff map for the deblocker under the 8x8
    transform: every 4x4 cell of a t8 MB carries its 8x8 block's count
    (the 8x8's edges read any covered cell; its inner 4x4 edges are off
    by the deblocker's trans8 rule). lev8 [mbh, mbw, ...] with 256
    levels per MB in (by8, bx8, r, c) order."""
    nz8 = (lev8.reshape(mbh, mbw, 2, 2, 64) != 0).sum(4, dtype=torch.int32) \
        .permute(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
    nz8 = nz8.repeat_interleave(2, 0).repeat_interleave(2, 1)
    t8r = t8.to(torch.bool).repeat_interleave(4, 0).repeat_interleave(4, 1)
    return torch.where(t8r, nz8, _nnz4(lev4, mbh, mbw))


def _levels_i16(res: dict, n: int) -> torch.Tensor:
    """The entropy writer's inputs as one [n, _LEAN_WIDTH (+
    _LEAN_WIDTH8 with the 8x8 transform)] int16 tensor."""
    cols = [("luma_lev", 256), ("chroma_dc", 8), ("chroma_ac", 128),
            ("cbp_luma", 1), ("cbp_chroma", 1)]
    if "luma8_lev" in res:
        cols += [("luma8_lev", 256), ("trans8", 1)]
    return torch.cat([res[k].reshape(n, w).to(torch.int16) for k, w in cols],
                     dim=1)


def _pack_frame_lean(res: dict, n: int) -> torch.Tensor:
    """Everything the entropy writer needs in ONE int8 buffer: levels and
    cbp clamped to int8, plus a fixed-capacity exception list (count,
    flat indices, int16 values) of entries with |x| > 127."""
    flat = _levels_i16(res, n).reshape(-1)
    dev = flat.device
    big = flat.abs() > 127
    count = big.sum(dtype=torch.int32).reshape(1)
    pos = torch.cumsum(big.to(torch.int32), 0) - 1
    slot = torch.where(big & (pos < _LEAN_EXC_CAP), pos, _LEAN_EXC_CAP)
    idx = torch.full((_LEAN_EXC_CAP + 1,), -1, dtype=torch.int32, device=dev)
    idx.scatter_(0, slot.long(),
                 torch.arange(flat.shape[0], dtype=torch.int32, device=dev))
    idx = idx[:_LEAN_EXC_CAP]       # slot CAP collected the overflow
    vals = torch.where(idx >= 0, flat[idx.clamp(min=0).long()], 0) \
        .to(torch.int16)
    lo = flat.clamp(-128, 127).to(torch.int8)
    meta = torch.cat([count, idx]).view(torch.int8)
    return torch.cat([lo, meta, vals.view(torch.int8)])


def _unpack_frame_lean(buf: np.ndarray, mbh: int, mbw: int,
                       has8: bool = False):
    """Host half of _pack_frame_lean -> level/cbp dict, or None if the
    exception list overflowed."""
    n = mbh * mbw
    width = _LEAN_WIDTH + (_LEAN_WIDTH8 if has8 else 0)
    flat_len = n * width
    lo = buf[:flat_len].astype(np.int16)
    meta = buf[flat_len:flat_len + 4 * (1 + _LEAN_EXC_CAP)].view(np.int32)
    if int(meta[0]) > _LEAN_EXC_CAP:
        return None
    idx = meta[1:]
    vals = buf[flat_len + 4 * (1 + _LEAN_EXC_CAP):].view(np.int16)
    sel = idx >= 0
    lo[idx[sel]] = vals[sel]
    return _split_levels(lo.reshape(n, width), mbh, mbw)


def _split_levels(packed: np.ndarray, mbh: int, mbw: int) -> dict:
    out = {
        "luma_lev": np.ascontiguousarray(packed[:, :256])
        .reshape(mbh, mbw, 4, 4, 4, 4),
        "chroma_dc": np.ascontiguousarray(packed[:, 256:264])
        .reshape(mbh, mbw, 2, 2, 2),
        "chroma_ac": np.ascontiguousarray(packed[:, 264:392])
        .reshape(mbh, mbw, 2, 2, 2, 4, 4),
        "cbp_luma": packed[:, 392].astype(np.uint8).reshape(mbh, mbw),
        "cbp_chroma": packed[:, 393].astype(np.uint8).reshape(mbh, mbw),
    }
    if packed.shape[1] > _LEAN_WIDTH:
        out["luma8_lev"] = np.ascontiguousarray(packed[:, 394:650]) \
            .reshape(mbh, mbw, 2, 2, 8, 8)
        out["trans8"] = packed[:, 650].astype(bool).reshape(mbh, mbw)
    return out


def _levels_exact(res: dict, mbh: int, mbw: int) -> dict:
    """Exact int16 pull (the lean buffer's overflow fallback)."""
    packed = _levels_i16(res, mbh * mbw).cpu().numpy()
    return _split_levels(packed, mbh, mbw)


# the host arrays of an intra-in-P result the writers read
_INTRA_KEYS = ("mode", "cmode", "cbp_luma", "cbp_chroma", "luma_dc",
               "luma_ac", "chroma_dc", "chroma_ac", "i4_modes")


def _intra_mb(ir: dict, my: int, mx: int, *keys) -> list:
    """One MB's entries of `refine_p_intra`'s host arrays, ints for the
    scalar ones."""
    return [int(ir[k][my, mx]) if ir[k].ndim == 2 else ir[k][my, mx]
            for k in keys]


def _neighbour_deps(mask: np.ndarray) -> np.ndarray:
    """The MBs that an MB of `mask` [mbh, mbw] reads as its neighbour A,
    B, C or D (left, top, top-right, top-left): the MBs an intra MB
    predicts from (the rd 2 probes keep their recon), or those a spatial
    direct MB derives its motion from (they stay inter in a B slice)."""
    dep = np.zeros_like(mask)
    dep[:, :-1] |= mask[:, 1:]
    dep[:-1, :] |= mask[1:, :]
    dep[:-1, 1:] |= mask[1:, :-1]
    dep[:-1, :-1] |= mask[1:, 1:]
    return dep


class Encoder:
    """Construct -> encode_frame per frame -> flush. `device` is where
    every tensor of the encode lives ("cuda[:k]", the default, or
    "cpu"); a CUDA request without CUDA raises."""

    def __init__(self, params: Params, device="cuda"):
        params.validate()
        check_slice(params)
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Encoder(device=%r): CUDA is not available"
                               % str(device))
        if dev.type not in ("cpu", "cuda"):
            raise NotImplementedError("device type %s" % dev.type)
        self.device = dev
        self.p = params
        self.sps = H.SPS(params.width, params.height,
                         num_ref_frames=params.ref_frames,
                         log2_max_frame_num=8)
        self.pps = H.PPS(pic_init_qp=params.qp,
                         chroma_qp_index_offset=params.chroma_qp_offset,
                         num_ref_idx_l0_active=params.ref_frames,
                         cabac=params.cabac,
                         weighted_bipred_idc=2 if params.weightb else 0)
        if params.bframes > 0:
            # B streams: real POCs, main profile, and a DPB that holds
            # both anchors (plus the ref_frames-deep past list under
            # multi-reference: the future anchor takes a slot of its own;
            # a pyramid's reference B one more, set.c:198-201)
            pyr = params.b_pyramid
            self.sps.poc_type = 0
            self.sps.profile = H.PROFILE_MAIN
            self.sps.num_ref_frames = max(4 if pyr else 2, params.ref_frames)
            if params.ref_frames > 1:
                self.sps.num_ref_frames = max(
                    self.sps.num_ref_frames,
                    params.ref_frames + (2 if pyr else 1))
        # the quantizer (x264 --cqm, --deadzone-*): this encoder's own
        # tables, never process state; any list that is not flat goes
        # into the SPS, which then uses High profile (core.py:298-319)
        self.qt = CQ.from_params(params)
        if not self.qt.is_flat:
            (self.sps.scaling4_intra, self.sps.scaling4_inter,
             self.sps.scaling8_intra, self.sps.scaling8_inter) = self.qt.lists
            self.sps.profile = H.PROFILE_HIGH
        if params.transform_8x8:
            self.sps.profile = H.PROFILE_HIGH
            self.pps.transform_8x8 = True
        self.sps.sps_id = params.sps_id
        self.pps.sps_id = params.sps_id
        self.sps.vui = H.VUI(
            sar_width=params.sar_width, sar_height=params.sar_height,
            overscan=params.overscan, videoformat=params.videoformat,
            fullrange=params.fullrange, colorprim=params.colorprim,
            transfer=params.transfer, colmatrix=params.colmatrix,
            chromaloc=params.chromaloc, fps_num=params.fps_num,
            fps_den=params.fps_den,
            num_reorder_frames=(2 if params.b_pyramid else
                                1 if params.bframes else 0),
            max_dec_frame_buffering=self.sps.num_ref_frames,
            mv_range=params.me_range)
        if params.level_idc:
            self.sps.level_idc = params.level_idc
        else:
            self.sps.level_idc = H.pick_level(
                params.mb_width, params.mb_height, params.fps_num,
                params.fps_den, self.sps.num_ref_frames, params.me_range)
        for msg in H.validate_levels(
                self.sps.level_idc, params.mb_width, params.mb_height,
                params.fps_num, params.fps_den, self.sps.num_ref_frames,
                params.me_range, params.vbv_maxrate, params.vbv_bufsize,
                self.sps.profile >= H.PROFILE_HIGH):
            log(LOG_WARNING, msg)
        native.load()
        self._dpb_store = []   # reference dicts, newest first
        self.dpb = []          # the P list view over the store
        self._dpb_disps = []   # display index of each P list entry
        self._ref_meta = None  # staged (disp, frame_num, anchor, L0 disps)
        self.ref = None        # the newest anchor
        self._poc_lsb = 0      # POC LSB of the P slice being coded
        self._pending_p = None
        # buffered display-order frames of the B pipe: (frame, y, u, v,
        # satd, disp, lowres plane)
        self._bbuf = []
        self._disp_idx = 0     # display index of the next input frame
        self._last_idr_disp = 0
        self._col = None       # (mv4, ref4) of the newest anchor
        self._anchor_lr = None  # lowres plane of the newest anchor
        self._anchor_disp = 0  # display index of the newest anchor
        self._last_anchor_fn = 0   # frame_num of the newest anchor
        self._reorder_next_p = False   # the next P slice reorders L0
        self._direct_score = [0, 0]    # `direct` 3: temporal, spatial
        # (final8, ref8) of the last P anchor that records its motion;
        # None after an IDR (the 16x16 P path at one reference records
        # none, as in the reference, so its B frames read an intra field)
        self._anchor_motion = None
        self.frame_num = 0
        self.idr_pic_id = 0
        self.stats = EncodeStats()
        self.prev_mv = None
        self.recon_prev = None  # the last frame's deblocked planes
        # None with stego off: the plain encoder
        self._stego = StegoEngine(params) if params.stego.enabled else None
        self.rc = RateControl(params)
        self.lookahead = Lookahead(params)
        self._cmv_cache = {}
        # noise reduction's running state (x264 nr_residual_sum /
        # nr_count), float64 on the host as in the reference
        self._nr_sum = np.zeros((4, 4), np.float64)
        self._nr_count = 0
        # adaptive quantization: the current frame's (qp, chroma qp)
        # grids int32 [mbh, mbw] on the host, None without AQ; rebuilt
        # every frame, so no state crosses frames
        self.aq_grids = None
        # (part, sub_type) host arrays of the last sub-8x8 P frame
        self.last_sub = None

    # ------------------------------------------------------------------
    # noise reduction (x264_noise_reduction_update, macroblock.c:902-922;
    # the reference's core.py:3540-3562: the offsets are updated once a
    # frame from its pass-1 sums)
    _NR_W2 = np.array([[800, 320, 800, 320], [320, 128, 320, 128],
                       [800, 320, 800, 320], [320, 128, 320, 128]],
                      np.float64)   # FIX8(3.125/1.25/0.5), dct.h:55-64

    def _nr_offset(self):
        """The current offsets, int32 [4, 4] (truncated as the
        reference's astype), or None without noise reduction."""
        if not self.p.noise_reduction:
            return None
        num = (float(self.p.noise_reduction) * self._nr_count
               + self._nr_sum / 2)
        den = self._nr_sum * self._NR_W2 / 256.0 + 1.0
        return (num / den).astype(np.int32)

    def nr_offset(self):
        """`_nr_offset` as a tensor on the encoder's device, or None."""
        off = self._nr_offset()
        return None if off is None else torch.as_tensor(off).to(self.device)

    def _nr_update(self, res: dict) -> None:
        """Add a P frame's pass-1 sums (one pull of 16 ints) and its
        block count; halve both past 2^18 blocks."""
        if "nr_sum" not in res:
            return
        self._nr_sum += res["nr_sum"].cpu().numpy().astype(np.float64)
        self._nr_count += 16 * self.p.mb_height * self.p.mb_width
        if self._nr_count > (1 << 18):
            self._nr_sum /= 2
            self._nr_count >>= 1

    # ------------------------------------------------------------------
    def headers(self) -> bytes:
        """SPS + PPS + SEI Annex-B chunk."""
        out = nal_unit(NAL_SPS, NAL_PRIORITY_HIGHEST, self.sps.write())
        out += nal_unit(NAL_PPS, NAL_PRIORITY_HIGHEST, self.pps.write())
        out += nal_unit(H.NAL_SEI, 0,
                        H.sei_version_payload(param2string(self.p)))
        return out

    def _pad(self, frame: Frame):
        """Edge-replicate planes to MB multiples as int32 device tensors."""
        mbw, mbh = self.p.mb_width, self.p.mb_height
        y = np.asarray(frame.y, np.int32)
        u = np.asarray(frame.u, np.int32)
        v = np.asarray(frame.v, np.int32)
        py, px = mbh * 16 - y.shape[0], mbw * 16 - y.shape[1]
        if py or px:
            y = np.pad(y, ((0, py), (0, px)), mode="edge")
            u = np.pad(u, ((0, py // 2), (0, px // 2)), mode="edge")
            v = np.pad(v, ((0, py // 2), (0, px // 2)), mode="edge")
        return tuple(torch.as_tensor(a).to(self.device) for a in (y, u, v))

    def _aud(self, slice_type: int) -> bytes:
        if not self.p.aud:
            return b""
        return nal_unit(H.NAL_AUD, 0, H.aud_payload(slice_type))

    def encode_frame(self, frame: Frame) -> bytes:
        """Encode one input frame; returns the NALs ready so far (the
        pipelined loop emits frame N's slice during frame N+1's call)."""
        if self.p.bframes > 0:
            return self._encode_frame_bpipe(frame)
        t0 = time.time()
        y, u, v = self._pad(frame)
        if (self._fused_p() and self.ref is not None
                and self.lookahead.prev_lr is not None):
            return self._encode_frame_ipp_fast(frame, y, u, v, t0)
        out_pend = self._drain_pending()
        is_idr, satd = self.lookahead.decide(y)
        if self.ref is None:
            is_idr = True
        if not is_idr and self._fused_p():
            raise NotImplementedError("non-fused partitioned P frame")
        qp = self.rc.start(SLICE_I if is_idr else SLICE_P, satd)
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            out += self._encode_idr(y, u, v, qp)
        else:
            out += nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH,
                            self._encode_p_unfused()(y, u, v, qp))
            self.stats.p_frames += 1
        self._accumulate_psnr(frame, y, u, v)
        self.frame_num += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out_pend + out

    def _encode_idr(self, y, u, v, qp: int) -> bytes:
        self.frame_num = 0
        self._dpb_store, self.dpb, self._dpb_disps = [], [], []
        self._reorder_next_p = False
        out = self.headers()
        nal = self._encode_i(y, u, v, qp)
        self.stats.i_frames += 1
        return out + nal_unit(NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST, nal)

    def _encode_frame_ipp_fast(self, frame, y, u, v, t0) -> bytes:
        p = self.p
        pipelined = (p.pipeline and p.deblock_device
                     and not (p.psnr or p.ssim))
        lr2 = self.lookahead.costs_device(y)
        qp = self.rc.start(SLICE_P, 1)
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        d = self._fused_dispatch(y, u, v, qp, qpc, extra=lr2)
        # the previous frame's entropy runs while the device works
        out_prev = self._drain_pending()
        n = p.mb_height * p.mb_width
        packed = d["packed"].cpu().numpy()        # the one blocking pull
        ci, cp = int(packed[24 * n]), int(packed[24 * n + 1])
        is_idr, satd = self.lookahead.decide_from_costs(ci, cp)
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            qp = self.rc.start(SLICE_I, satd)
            out += self._encode_idr(y, u, v, qp)
        else:
            d["packed"] = packed
            pend = self._fused_complete(d)
            pend.update(frame_num=self.frame_num, poc_lsb=self._poc_lsb)
            if pipelined:
                pend["aud"] = out
                self._pending_p = pend
                self.stats.p_frames += 1
                self.frame_num += 1
                self.stats.frames += 1
                self.stats.elapsed += time.time() - t0
                return out_prev
            # unpipelined: the slice is written in this call
            out += self._p_nal(pend)
            self.stats.p_frames += 1
        self._accumulate_psnr(frame, y, u, v)
        self.frame_num += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out_prev + out

    def flush(self) -> bytes:
        """Drain the deferred entropy of the last P frame (b"" when
        every call returned its own access unit: unpipelined or the
        16x16-only path); with B frames, code the buffered frames as the
        last GOPs (under `b_adapt` 2 the placement DP runs until one GOP
        remains)."""
        out = self._drain_pending()
        while len(self._bbuf) > self.p.bframes + 1:
            out += self._flush_gop_k(self.lookahead.decide_b_placement(
                self._anchor_lr, [b[6] for b in self._bbuf],
                self.p.bframes))
        if self._bbuf:
            out += self._flush_gop()
        return out

    def close(self) -> dict:
        """Final summary (x264_encoder_close, encoder.c:2795-2884), the
        reference's dict, and the rate control's stat flush."""
        self.rc.write_stats()
        st, p = self.stats, self.p
        n = max(1, st.frames)
        npix_y = n * p.width * p.height
        return {
            "frames": st.frames,
            "fps": st.frames / st.elapsed if st.elapsed > 0 else 0.0,
            "kbps": st.bits * p.fps_num / p.fps_den / n / 1000.0,
            "psnr_y": psnr_from_ssd(st.ssd_y, npix_y),
            "psnr_u": psnr_from_ssd(st.ssd_u, npix_y // 4),
            "psnr_v": psnr_from_ssd(st.ssd_v, npix_y // 4),
            "ssim_y": (st.ssim_sum / n
                       / max(1, ((p.width - 6) >> 2)
                             * ((p.height - 6) >> 2))
                       if p.ssim else 0.0),
            "mv_covers": st.mv_covers,
            "message_bits": st.message_bits,
            "mv_flips": st.mv_flips,
        }

    def _accumulate_psnr(self, frame: Frame, y, u, v, recon=None):
        """Add the frame's SSDs (Params.psnr) and SSIM sum (Params.ssim)
        of the deblocked recon (or `recon`, a B frame's planes) against
        the source: int64 sums and the SSIM on the device, one pull of
        the four scalars. y/u/v are the padded source planes on the
        device (their top-left crop is the frame)."""
        p = self.p
        recon = recon or self.recon_prev
        if recon is None or not (p.psnr or p.ssim):
            return
        h, w = frame.y.shape
        ry, ru, rv = recon
        vals = []
        if p.psnr:
            for r, s, hh, ww in ((ry, y, h, w), (ru, u, h // 2, w // 2),
                                 (rv, v, h // 2, w // 2)):
                d = r[:hh, :ww].to(torch.int64) - s[:hh, :ww].to(torch.int64)
                vals.append((d * d).sum().to(torch.float64))
        if p.ssim:
            vals.append(ssim_wxh(ry[2:h, 2:w], y[2:h, 2:w])
                        .to(torch.float64))
        got = torch.stack(vals).cpu().tolist()
        if p.psnr:
            self.stats.ssd_y += int(got[0])
            self.stats.ssd_u += int(got[1])
            self.stats.ssd_v += int(got[2])
        if p.ssim:
            self.stats.ssim_sum += got[-1]

    def _drain_pending(self) -> bytes:
        pd = self._pending_p
        if pd is None:
            return b""
        self._pending_p = None
        t0 = time.time()
        out = pd["aud"] + self._p_nal(pd)
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out

    def _p_nal(self, pd: dict) -> bytes:
        """The slice NAL of a completed fused P frame: its level buffer
        pulled (the lean one, or the exact levels on its overflow) and
        entropy-coded."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        res_np = _unpack_frame_lean(pd["buf"].cpu().numpy(), mbh, mbw,
                                    bool(p.transform_8x8))
        if res_np is None:
            res_np = _levels_exact(pd["res"], mbh, mbw)
        if "trans8" in res_np:
            self.stats.trans8_mbs += int(
                (res_np["trans8"] & (res_np["cbp_luma"] != 0)).sum())
        nal = self._finish_p_slice(res_np, pd["qp"], pd["part"], pd["mvd"],
                                   pd["skip"], pd["frame_num"],
                                   pd["poc_lsb"])
        return nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, nal)

    # ------------------------------------------------------------------
    # The B pipe (x264 frame reordering, encoder.c:2179-2228: display
    # order in, decode order out; each anchor, then its B frames)
    # ------------------------------------------------------------------
    def _encode_frame_bpipe(self, frame: Frame) -> bytes:
        p = self.p
        y, u, v = self._pad(frame)
        is_idr, satd = self.lookahead.decide(y)
        if self.ref is None:
            is_idr = True
        disp = self._disp_idx
        self._disp_idx += 1
        if is_idr:
            # frames before an IDR cannot be B frames against it: they
            # are coded as a chain of P anchors first
            out = self._flush_pending_as_p()
            self._last_idr_disp = disp
            out += self._encode_anchor(frame, y, u, v, True, satd, disp)
            self._anchor_lr = self.lookahead.prev_lr
            return out
        self._bbuf.append((frame, y, u, v, satd, disp,
                           self.lookahead.prev_lr))
        if p.b_adapt == 2:
            # the B-placement DP over the lookahead window (x264's
            # B_ADAPT_TRELLIS; the window of encoder.c:713-726)
            if len(self._bbuf) < max(p.bframes + 1, min(p.rc_lookahead, 12)):
                return b""
            return self._flush_gop_k(self.lookahead.decide_b_placement(
                self._anchor_lr, [b[6] for b in self._bbuf], p.bframes))
        # b_adapt 1 closes the GOP early at a frame that predicts badly
        close = (p.b_adapt == 1 and len(self._bbuf) > 1
                 and self.lookahead.bad_b_candidate)
        if len(self._bbuf) <= p.bframes and not close:
            return b""
        return self._flush_gop()

    def _flush_pending_as_p(self) -> bytes:
        out = b""
        for (f, y, u, v, satd, disp, lr) in self._bbuf:
            out += self._encode_anchor(f, y, u, v, False, satd, disp)
            self._anchor_lr = lr
        self._bbuf = []
        return out

    def _flush_gop(self) -> bytes:
        return self._flush_gop_k(len(self._bbuf) - 1)

    def _flush_gop_k(self, k: int) -> bytes:
        """Code buffered frame k as the P anchor, then frames [0, k) as
        its B frames (decode order); the frames after k stay buffered.
        The B frames' L0 list is the P list as it stood before the anchor
        entered the DPB. Under `b_pyramid` (k >= 2) the middle B is coded
        right after the anchor as a reference picture (x264's
        encoder.c:2207): the earlier B frames take it as L1[0], the later
        ones as L0[0], and the next P slice carries the one L0 reordering
        op that puts the anchor back at the head of its list."""
        items = self._bbuf
        self._bbuf = items[k + 1:]
        f, y, u, v, satd, disp, lr = items[k]
        l0_disp = self._anchor_disp
        # under b_pyramid a GOP too short for a reference B keeps the
        # reference's single-reference B path (core.py:614-616): L0 is
        # the newest anchor alone, whatever ref_frames
        single = self.p.b_pyramid and self.p.ref_frames > 1
        l0_stack = (self._stack_l0(self.dpb[:1], 1) if single
                    else self._stack_l0(self.dpb))
        out = self._encode_anchor(f, y, u, v, False, satd, disp)
        self._anchor_lr = lr
        ref_l1, col = self.ref, self._col
        # the anchor's own L0 display indices (map_col_to_list0 of the B
        # frames whose colocated picture it is)
        anchor_poc0 = self._dpb_store[0]["_ref_poc0"]
        if not (self.p.b_pyramid and k >= 2):
            for (bf, by, bu, bv, bsatd, bdisp, _) in items[:k]:
                out += self._encode_b_frame(
                    bf, by, bu, bv, l0_stack, ref_l1, col, bsatd, bdisp,
                    (2 * bdisp, 2 * l0_disp, 2 * disp), anchor_poc0,
                    l0_map=not single)[0]
            return out
        mid = k // 2
        bf, by, bu, bv, bsatd, mdisp, _ = items[mid]
        stack0 = self._stack_l0(self._b_l0_view(mdisp))
        disps0 = stack0[4]
        nal, (bref_ref, bref_col, bref_col_l0) = self._encode_b_frame(
            bf, by, bu, bv, stack0, ref_l1, col, bsatd, mdisp,
            (2 * mdisp, 2 * l0_disp, 2 * disp), anchor_poc0, is_ref=True)
        out += nal
        # the reference B enters the sliding window: the later B frames
        # lead L0 with it, the next P sees it after the reordering op
        self._ref_meta = (mdisp, self.frame_num - 1, False, disps0)
        self._push_ref(bref_ref)
        stack1 = self._stack_l0(self._b_l0_view(disp))
        for i, (bf, by, bu, bv, bsatd, bdisp, _) in enumerate(items[:k]):
            if i == mid:
                continue
            if bdisp < mdisp:
                # L1[0] is the reference B: temporal direct reads its
                # L0-only field, spatial its L0-else-L1 one
                out += self._encode_b_frame(
                    bf, by, bu, bv, stack0, bref_ref, bref_col, bsatd, bdisp,
                    (2 * bdisp, 2 * l0_disp, 2 * mdisp), disps0,
                    col_t=bref_col_l0)[0]
            else:
                out += self._encode_b_frame(
                    bf, by, bu, bv, stack1, ref_l1, col, bsatd, bdisp,
                    (2 * bdisp, 2 * mdisp, 2 * disp), anchor_poc0)[0]
        self._reorder_next_p = True
        return out

    def _take_reorder_l0(self, frame_num: int):
        """The one-shot L0 reordering op of the P slice coded as
        frame_num (the reference's `_take_reorder_l0`): after a pyramid
        GOP the default PicNum-descending list leads with the reference
        B, and one op puts the previous anchor first (x264's
        encoder.c:138-150 emits the same)."""
        if not self._reorder_next_p:
            return None
        self._reorder_next_p = False
        diff = self._last_anchor_fn - frame_num
        if diff == 0:
            return None
        return [(0 if diff < 0 else 1, abs(diff) - 1)]

    def _encode_anchor(self, frame, y, u, v, is_idr: bool, satd,
                       disp: int) -> bytes:
        """An I or P anchor of the B pipe: the IPP encodes unpipelined
        (the fused step at one reference, `_encode_p_parts` at more),
        then the colocated field the B frames read."""
        t0 = time.time()
        qp = self.rc.start(SLICE_I if is_idr else SLICE_P, satd)
        self._poc_lsb = 2 * (disp - self._last_idr_disp)
        out = self._aud(SLICE_I if is_idr else SLICE_P)
        if is_idr:
            self.lookahead.last_keyframe = disp
            self._ref_meta = (disp, 0, True, [])
            out += self._encode_idr(y, u, v, qp)
        else:
            self._ref_meta = (disp, self.frame_num, True,
                              list(self._dpb_disps))
            if not self._fused_p():
                out += nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH,
                                self._encode_p_unfused()(y, u, v, qp))
            else:
                d = self._fused_dispatch(y, u, v, qp, chroma_qp(
                    qp, self.p.chroma_qp_offset))
                d["packed"] = d["packed"].cpu().numpy()
                pend = self._fused_complete(d)
                pend.update(frame_num=self.frame_num, poc_lsb=self._poc_lsb)
                self._anchor_motion = (pend["final8"], None)
                out += self._p_nal(pend)
            self.stats.p_frames += 1
        self._last_anchor_fn = self.frame_num
        self._anchor_disp = disp
        self._save_col()
        self._accumulate_psnr(frame, y, u, v)
        self.frame_num += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        return out

    def _save_col(self):
        """The anchor's per-4x4 motion field for spatial direct's
        colZeroFlag (the reference's `_save_col`): an I anchor is all
        intra (ref -1); a P anchor carries its true per-8x8 references,
        and ref -1 on its intra MBs (stego off). The reference reads the
        motion of the newest frame that recorded any; its 16x16 P path
        at one reference records none, so after an IDR such anchors give
        the intra field too, though the decoder stores their true field:
        the port keeps that, for the same stream."""
        p = self.p
        h4, w4 = 4 * p.mb_height, 4 * p.mb_width
        if self._anchor_motion is None:
            self._col = (np.zeros((h4, w4, 2), np.int32),
                         np.full((h4, w4), -1, np.int32))
            return
        # (final, ref8[, intra mask]): the mask only with stego off
        final, ref8, *intra = self._anchor_motion
        # a sub-8x8 anchor records its per-4x4 field, the others per 8x8
        mv4 = (final if final.shape[0] == h4
               else np.repeat(np.repeat(final, 2, 0), 2, 1))
        ref4 = (np.zeros((h4, w4), np.int32) if ref8 is None
                else np.repeat(np.repeat(ref8, 2, 0), 2, 1))
        if intra and intra[0] is not None:
            ref4 = np.where(np.repeat(np.repeat(intra[0], 4, 0), 4, 1), -1,
                            ref4)
        self._col = (np.ascontiguousarray(mv4, np.int32),
                     np.ascontiguousarray(ref4, np.int32))

    def _direct_mode(self, disp: int, pocs, ent, l0_disps, col, col_t,
                     col_poc0):
        """The slice's direct mode (the reference's core.py:2893-2948):
        spatial (`direct` 1, or 3 while the auto score favours it), else
        the temporal field (2, 3) or none (0). The temporal field scales
        by each L0 entry's DistScaleFactor (ent: the display index of
        each of the ref_frames L0 slots) and maps the colocated
        picture's references (col_poc0, its L0 display indices) into the
        active L0 by POC; col_t is the colocated reference B's L0-only
        field. Returns (spatial, tdir, tfields): tdir the field the
        commit uses (None: spatial), tfields the temporal one computed
        (None unless `direct` is 2 or 3)."""
        p = self.p
        dmode = p.direct
        spatial = (self._direct_score[1] > self._direct_score[0]
                   if dmode == 3 else dmode == 1)
        tdir = tfields = None
        if dmode in (2, 3):
            dsf = np.array([BS.dist_scale_factor(2 * disp, 2 * d, pocs[2])
                            for d in ent], np.int64)
            act = l0_disps[:max(1, min(len(l0_disps), p.ref_frames))]
            cmap = np.array([act.index(d) if d in act else -1
                             for d in col_poc0] or [-1], np.int32)
            tmv4, tref4 = col_t if col_t is not None else col
            tfields = BS.temporal_direct_fields(tmv4, tref4, dsf,
                                                col_map=cmap)
            if not spatial:
                tdir = tfields
        if dmode == 0:
            tdir = BS.no_direct_fields(p.mb_height, p.mb_width)
        return spatial, tdir, tfields

    def _encode_b_frame(self, frame, y, u, v, l0, ref_l1, col, satd,
                        disp: int, pocs, col_poc0, col_t=None,
                        is_ref: bool = False, l0_map: bool = True):
        """A B frame between two pictures, the reference's
        `_encode_b_frame` (core.py:2853): the direct mode of the slice,
        the B analysis (`_analyse_b_parts`, or `_analyse_b16` without
        partitions), the B encode (the fused luma-encode kernel) at the
        implicit weights, with stego off the intra compare (`_b_intra`,
        off under AQ) and the rescan around its intra MBs, and the CAVLC
        or CABAC B slice. l0: the stacked
        L0 list (luma, u, v, n_valid, the display index of each valid
        entry), entry 0 the nearest past reference; ref_l1 the L1[0]
        picture and col its colocated field; pocs (B, L0[0], L1[0]).
        l0_map False takes the reference's single-reference B path at
        ref_frames > 1 (no L0 map to the writers, as at one reference).
        Returns (bytes, ref): a non-reference B is never deblocked nor
        stored, and ref is None; with is_ref (the middle B of a pyramid
        GOP) it is still coded undeblocked, and ref is (its reference
        planes, its colocated field, its L0-only colocated field)."""
        t0 = time.time()
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        qp = self.rc.start(SLICE_B, satd)
        lam = ME.lambda_tab(qp)
        refs_l, refs_u, refs_v, n_valid, l0_disps = l0
        num_ref = n_valid   # the active L0 count the slice signals
        # each L0 slot's display index (padded slots repeat the last) and
        # implicit weight (x264's bipred_weight[i_ref0][0])
        ent = [l0_disps[min(r, len(l0_disps) - 1)]
               for r in range(refs_l.shape[0])]
        w_tab = np.array([BS.bipred_weight(2 * disp, 2 * d, pocs[2],
                                           p.weightb) for d in ent],
                         np.int32)
        dm = self._direct_mode(disp, pocs, ent, l0_disps, col, col_t,
                               col_poc0)
        analyse = self._analyse_b_parts if p.partitions else self._analyse_b16
        rescan, ref0_16, inter_cost = analyse(y, refs_l, n_valid, ref_l1,
                                              lam, w_tab, col, dm)
        code, subs, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0 = rescan()
        t = self._dev
        qp_enc, qpc_enc = self._aq_frame(y, u, v, qp)
        res = BS.encode_b_frame_device(
            y, u, v, dict(luma=refs_l, u=refs_u, v=refs_v), ref_l1, t(use0),
            t(use1), t(fmv0), t(fmv1), t(ref8_0), qp_enc, qpc_enc, mbh, mbw,
            w1=BS.weight_arg(w_tab[np.maximum(ref8_0, 0)], self.device),
            trellis=bool(p.trellis), tables=self.qt)
        res, kind, ir = self._b_intra(y, u, v, res, code, subs, inter_cost,
                                      dm[1] is None, qp, lam)
        intra = None
        if ir is not None:
            intra = (kind, {k: ir[k].cpu().numpy() for k in _INTRA_KEYS})
            # no re-encode: the rescan only re-derives the mvds and the
            # motion fields around the intra MBs
            code, subs, use0, use1, fmv0, fmv1, mvd0, mvd1, ref8_0 = \
                rescan(kind > 0)
        res_np = _levels_exact(res, mbh, mbw)
        # a B frame's metrics read its own recon (it is never deblocked)
        self._accumulate_psnr(frame, y, u, v, recon=(
            res["recon_y"], res["recon_u"], res["recon_v"]))
        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_B,
                             self.frame_num, qp, idr=False,
                             disable_deblock=1,
                             poc_lsb=2 * (disp - self._last_idr_disp),
                             is_ref=is_ref, direct_spatial=bool(dm[0]),
                             b_l0_active=num_ref)
        # the reference codes no ref_idx_l0 at one reference (its
        # single-reference B path passes no L0 map), and then writes a
        # slice of 16x16 MBs natively
        ref0_w = ref0_16 if p.ref_frames > 1 and l0_map else None
        write = (self._write_b_slice_cabac if p.cabac
                 else self._write_b_slice_cavlc)
        nal = write(bw, res_np, qp, code, subs, mvd0, mvd1, ref0_w, num_ref,
                    self._qp_grid_arg(), intra=intra)
        prio = NAL_PRIORITY_HIGH if is_ref else NAL_PRIORITY_DISPOSABLE
        out = self._aud(SLICE_B) + nal_unit(NAL_SLICE, prio, nal)
        if is_ref:
            self.frame_num += 1   # a reference picture advances frame_num
        self.stats.b_frames += 1
        self.stats.frames += 1
        self.stats.bits += 8 * len(out)
        self.rc.end(8 * len(out))
        self.stats.elapsed += time.time() - t0
        if not is_ref:
            return out, None
        bref = mc.build_ref(res["recon_y"], res["recon_u"], res["recon_v"])
        return out, (bref,) + self._bref_cols(use0, use1, fmv0, fmv1, ref8_0)

    def _b_intra(self, y, u, v, res, code, subs, inter_cost, spatial: bool,
                 qp: int, lam: int):
        """The intra compare of a B frame (`_intra_compare`; the
        reference's core.py:3110-3153, analyse.c:3110+) against each MB's
        inter cost (host [mbh, mbw]). Under spatial direct an MB that a
        later direct MB (code 0, or B_8x8 with a direct sub) reads as its
        neighbour A, B, C or D keeps its inter coding (cost -1):
        switching it would change that MB's derived motion."""
        direct = code == 0
        if subs is not None:
            direct |= (code == 22) & (subs == 0).any(-1)
        dep = _neighbour_deps(direct) if spatial else np.zeros_like(direct)
        cost = np.where(dep, -1, inter_cost).astype(np.int32)
        return self._intra_compare(y, u, v, res, self._dev(cost), qp, lam)

    @staticmethod
    def _bref_cols(use0, use1, fmv0, fmv1, ref8_0):
        """The two colocated fields of a reference B (the reference's
        core.py:3183-3220; the decoder stores the same): spatial direct
        reads L0's motion, else L1's (spec 8.4.1.2.2, refIdxL0Col < 0),
        with the true L0 references; temporal reads the L0-only field
        (x264's fref1 cache, macroblock.c:187), where a block that uses
        L1 only is -2, direct-unavailable (macroblock.c:199). Blocks that
        use neither list, the intra MBs (the rescan leaves them no list),
        are -1."""
        def r4(a):
            return np.repeat(np.repeat(np.asarray(a), 2, 0), 2, 1)

        u0r, u1r = r4(use0).astype(bool), r4(use1).astype(bool)
        f0r, f1r, r0_4 = r4(fmv0), r4(fmv1), r4(ref8_0).astype(np.int32)
        dead = ~(u0r | u1r)
        col_mv = np.where(dead[..., None], 0,
                          np.where(u0r[..., None], f0r, f1r))
        col_ref = np.where(dead, -1, np.where(u0r, r0_4, 0))
        col_mv0 = np.where((dead | ~u0r)[..., None], 0, f0r)
        col_ref0 = np.where(dead, -1, np.where(u0r, r0_4, -2))
        return ((col_mv.astype(np.int32), col_ref.astype(np.int32)),
                (col_mv0.astype(np.int32), col_ref0.astype(np.int32)))

    def _direct_auto_score(self, y, ref0_luma, ref1_luma, spatial: bool,
                           tfields, approx_mvs, col, c_act, c_best,
                           lam: int, w1: int, parts: bool):
        """`direct` 3 (auto): add each mode's would-be-direct count to its
        running score (the reference's core.py:2814; x264's per-MB bskip
        probe under both modes, analyse.c:3185-3199, with its 9/10 decay,
        encoder.c:2569-2580). The active mode's direct cost is c_act; the
        other mode's field costs one more device dispatch and one pull."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        ones = np.ones((mbh, mbw), bool)
        if spatial:
            av8 = np.repeat(np.repeat(tfields[0].astype(np.int32), 2, 0),
                            2, 1)
            au, alt_avail = (av8, av8, tfields[1], tfields[2]), tfields[0]
        else:
            au = BS.approx_direct_fields(approx_mvs[0], approx_mvs[1], *col)
            alt_avail = ones
        fn = BS.bipred_satd8_device if parts else BS.bipred_satd_device
        c_alt = fn(y, ref0_luma, ref1_luma, *(self._dev(a) for a in au),
                   mbh, mbw, w1=w1)
        if parts:
            c_alt = c_alt.sum(-1)
        c_alt = c_alt.cpu().numpy().astype(np.int64)
        act_avail = ones if spatial else tfields[0]
        s_act = int(((c_act + lam <= c_best) & act_avail).sum())
        s_alt = int(((c_alt + lam <= c_best) & alt_avail).sum())
        sc = self._direct_score   # [temporal, spatial]
        if sc[0] + sc[1] > mbh * mbw:
            sc[0] = sc[0] * 9 // 10
            sc[1] = sc[1] * 9 // 10
        sc[int(spatial)] += s_act
        sc[1 - int(spatial)] += s_alt

    def _analyse_b_parts(self, y, refs_l, n_valid: int, ref_l1, lam: int,
                         w_tab, col, dm):
        """The partition path's B analysis (the reference's core.py:
        2974-3038): stage 1 (B1 per L0 entry and on L1), the direct
        SATDs of the slice's direct field (the approximate spatial one,
        or the temporal or disabled one, whose unavailable MBs are priced
        out), stage 2 (B9, B3'), one pull, the direct-auto score, the
        host commit. Every BI combine takes L0[0]'s weight. Returns
        (rescan, the per-MB L0 entry, the per-MB inter cost of the intra
        compare: the lesser of the direct cost + lam and the chosen
        configuration's); rescan(intra=None) gives `scan_b_parts`'s
        fields, the MBs of the mask `intra` committed as intra."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        spatial, tdir, tfields = dm
        col_mv4, col_ref4 = col
        w1 = int(w_tab[0])
        st0, st1, ref0_d = BS.analyse_b_parts_stage1(
            y, refs_l[:, 0].to(torch.uint8), n_valid,
            ref_l1["luma"][0].to(torch.uint8), p.me_range, mbh, mbw, lam)
        mv16 = None
        if tdir is None or p.direct == 3:
            mv16 = 4 * torch.cat([st0["mv16"].reshape(-1),
                                  st1["mv16"].reshape(-1)]
                                 ).cpu().numpy().reshape(2, mbh, mbw, 2)
        if tdir is not None:
            av8 = np.repeat(np.repeat(tdir[0].astype(np.int32), 2, 0), 2, 1)
            au = (av8, av8, tdir[1], tdir[2])
        else:
            au = BS.approx_direct_fields(mv16[0], mv16[1], col_mv4, col_ref4)
        c_dir8 = BS.bipred_satd8_device(
            y, refs_l[0], ref_l1["luma"], *(self._dev(a) for a in au), mbh,
            mbw, w1=w1)
        if tdir is not None:
            # a direct-unavailable MB never wins (16x16 or 8x8 direct)
            c_dir8 = torch.where(self._dev(tdir[0])[:, :, None], c_dir8,
                                 1 << 20)
        stres = BS.analyse_b_parts(y, refs_l, ref_l1["luma"], st0, st1,
                                   c_dir8, ref0_d, mbh, mbw, lam, w1=w1)
        # one pull of everything the host commit reads
        pieces = [stres["part"], stres["sel8"], PR.sp_to_z(
            stres["mv0_8"], mbh, mbw), PR.sp_to_z(stres["mv1_8"], mbh, mbw),
            stres["c_cfg"], c_dir8.sum(-1), ref0_d]
        meta = torch.cat([x.reshape(-1).to(torch.int32) for x in pieces]
                         ).cpu().numpy()
        part = meta[:n].reshape(mbh, mbw)
        sel8 = meta[n:5 * n].reshape(mbh, mbw, 4)
        mv0z = meta[5 * n:13 * n].reshape(mbh, mbw, 4, 2)
        mv1z = meta[13 * n:21 * n].reshape(mbh, mbw, 4, 2)
        c_cfg = meta[21 * n:22 * n].reshape(mbh, mbw)
        c_dir = meta[22 * n:23 * n].reshape(mbh, mbw)
        ref0_16 = meta[23 * n:].reshape(mbh, mbw)
        if p.direct == 3:
            self._direct_auto_score(
                y, refs_l[0], ref_l1["luma"], spatial, tfields, mv16, col,
                c_dir.astype(np.int64), c_cfg.astype(np.int64), lam, w1,
                parts=True)

        def rescan(intra=None):
            return BS.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir,
                                   col_mv4, col_ref4, lam, ref0=ref0_16,
                                   tdir=tdir, intra=intra)
        return (rescan, ref0_16,
                np.minimum(c_dir.astype(np.int64) + lam, c_cfg))

    def _analyse_b16(self, y, refs_l, n_valid: int, ref_l1, lam: int, w_tab,
                     col, dm):
        """The 16x16-only path's B analysis (the reference's core.py:
        3039-3081): B6 -> B7 -> qpel tables -> subpel per list and L0
        entry (`BS.analyse_b_frame`, BI at each L0 entry's weight), one
        pull, the direct SATD per MB of the slice's direct field, one
        pull, the direct-auto score, the host commit (`scan_b_frame`).
        Returns what `_analyse_b_parts` does (the rescan's fields without
        sub_mb_types, mvds per MB; the inter cost the least of the four
        candidates, each with its mb_type bits)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        spatial, tdir, tfields = dm
        col_mv4, col_ref4 = col
        w1 = int(w_tab[0])
        mv0, c0, ref0_d, mv1, c1, cbi = BS.analyse_b_frame(
            y, refs_l, n_valid, ref_l1["luma"], p.me_range, mbh, mbw, lam,
            w1=BS.weight_arg(w_tab, self.device))
        meta = torch.cat([x.reshape(-1).to(torch.int32) for x in (
            mv0, mv1, c0, c1, cbi, ref0_d)]).cpu().numpy()
        mv0_np = meta[:2 * n].reshape(mbh, mbw, 2)
        mv1_np = meta[2 * n:4 * n].reshape(mbh, mbw, 2)
        c0_np, c1_np, cbi_np, ref0_16 = (
            meta[(4 + k) * n:(5 + k) * n].reshape(mbh, mbw)
            for k in range(4))
        if tdir is not None:
            av8 = np.repeat(np.repeat(tdir[0].astype(np.int32), 2, 0), 2, 1)
            au = (av8, av8, tdir[1], tdir[2])
        else:
            au = BS.approx_direct_fields(mv0_np, mv1_np, col_mv4, col_ref4)
        c_dir = BS.bipred_satd_device(
            y, refs_l[0], ref_l1["luma"], *(self._dev(a) for a in au), mbh,
            mbw, w1=w1).cpu().numpy()
        if p.direct == 3:
            hdr = BS._B_HDR_BITS
            best = np.minimum(np.minimum(c0_np + lam * hdr[1],
                                         c1_np + lam * hdr[2]),
                              cbi_np + lam * hdr[3])
            self._direct_auto_score(
                y, refs_l[0], ref_l1["luma"], spatial, tfields,
                (mv0_np, mv1_np), col, c_dir + lam * hdr[0], best, lam, w1,
                parts=False)

        def rescan(intra=None):
            mode, *rest = BS.scan_b_frame(c_dir, c0_np, c1_np, cbi_np, mv0_np,
                                          mv1_np, col_mv4, col_ref4, lam,
                                          ref0=ref0_16, tdir=tdir,
                                          intra=intra)
            return (mode, None, *rest)
        hdr = np.asarray(BS._B_HDR_BITS, np.int64)
        inter_cost = np.stack([c.astype(np.int64) + lam * h for c, h in zip(
            (c_dir, c0_np, c1_np, cbi_np), hdr)]).min(0)
        return rescan, ref0_16, inter_cost

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _b_qp_delta(aqg, last_qp: int, my: int, mx: int):
        """A coded B MB's mb_qp_delta under adaptive quantization (the
        spec 7.4.5 fold against the last coded qp) and the new last qp;
        (0, last_qp) without a grid."""
        if aqg is None:
            return 0, last_qp
        q = int(aqg[my, mx])
        return ((q - last_qp + 26) % 52) - 26, q

    def _write_b_slice_cavlc(self, bw, res, qp: int, code, subs, mvd0,
                             mvd1, ref0, num_ref: int, aqg=None,
                             intra=None) -> bytes:
        """CAVLC B slice data (the reference's `_write_b_slice_cavlc`,
        core.py:3262): `mb_skip_run` over the direct MBs with no
        residual, `FrameCavlc.write_b_mb` for the others; a slice of
        16x16 codes (0-3) without an L0 map takes the native twin
        `native.write_slice_b`, as in the reference (not under the PPS's
        8x8-transform flag, which only the Python writer codes). ref0
        [mbh, mbw] each MB's L0 entry (None: 0), coded as ref_idx_l0 when
        num_ref > 1; aqg the frame's AQ qp grid (mb_qp_delta; the
        reference then writes in Python); intra (intra_kind [mbh, mbw],
        `refine_p_intra`'s host arrays) when the slice holds intra MBs,
        written as I_16x16 or I_NxN with the B slice's mb_type offset and
        mb_qp_delta 0 (the reference then writes in Python too)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        t8 = bool(p.transform_8x8)
        last_qp = qp
        if (ref0 is None and np.all(code <= 3) and not t8 and aqg is None
                and intra is None):
            return self._write_b_native(native.write_slice_b, bw, res,
                                        code, mvd0, mvd1)
        fc = FrameCavlc(mbw, mbh, trans8_mode=t8)
        skip_run = 0
        for my in range(mbh):
            for mx in range(mbw):
                k = 0 if intra is None else int(intra[0][my, mx])
                if k:
                    bw.write_ue(skip_run)
                    skip_run = 0
                    ir = intra[1]
                    if k == 2:
                        fc.write_i4x4_mb(
                            bw, mx, my, ir["i4_modes"][my, mx],
                            *_intra_mb(ir, my, mx, "cmode", "cbp_luma",
                                       "cbp_chroma", "luma_ac", "chroma_dc",
                                       "chroma_ac"))
                    else:
                        fc.write_i16x16_mb(
                            bw, mx, my, *_intra_mb(
                                ir, my, mx, "mode", "cmode", "cbp_luma",
                                "cbp_chroma", "luma_dc", "luma_ac",
                                "chroma_dc", "chroma_ac"))
                    continue
                m = int(code[my, mx])
                cl = int(res["cbp_luma"][my, mx])
                cc = int(res["cbp_chroma"][my, mx])
                if m == 0 and cl == 0 and cc == 0:
                    skip_run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(skip_run)
                skip_run = 0
                dq = 0
                if cl or cc:
                    dq, last_qp = self._b_qp_delta(aqg, last_qp, my, mx)
                fc.write_b_mb(bw, mx, my, m, mvd0[my, mx], mvd1[my, mx], cl,
                              cc, res["luma_lev"][my, mx],
                              res["chroma_dc"][my, mx],
                              res["chroma_ac"][my, mx], qp_delta=dq,
                              subs=None if subs is None else subs[my, mx],
                              ref0=0 if ref0 is None else int(ref0[my, mx]),
                              num_ref=num_ref)
        if skip_run:
            bw.write_ue(skip_run)
        bw.rbsp_trailing()
        return bw.get_bytes()

    def _write_b_native(self, writer, bw, res, code, mvd0, mvd1,
                        **kw) -> bytes:
        """A B slice of 16x16 MBs through a native writer (mvds per MB,
        or per unit with the MB's in slot 0)."""
        mbh, mbw = self.p.mb_height, self.p.mb_width
        n = mbh * mbw
        hdr, nbits = bw.partial_bytes()
        m0 = mvd0 if mvd0.ndim == 3 else mvd0[:, :, 0]
        m1 = mvd1 if mvd1.ndim == 3 else mvd1[:, :, 0]
        return writer(
            hdr, nbits, mbw, mbh, **kw, mode=code.reshape(n),
            mvd0=np.ascontiguousarray(m0).reshape(n, 2),
            mvd1=np.ascontiguousarray(m1).reshape(n, 2),
            cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
            luma_blocks=res["luma_lev"].reshape(n, 16, 16),
            chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
            chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16))

    def _write_b_slice_cabac(self, bw, res, qp: int, code, subs, mvd0,
                             mvd1, ref0, num_ref: int, aqg=None,
                             intra=None) -> bytes:
        """CABAC B slice data (the reference's `_write_b_slice_cabac`,
        core.py:3349): B_Skip where a direct MB has no residual,
        `write_b_mb` for codes 0-3, `write_b_mb_ext` for the partition
        codes; a slice of 16x16 codes without an L0 map takes the native
        twin `native.write_slice_cabac_b`, as in the reference (not
        under the PPS's 8x8-transform flag). ref0 [mbh, mbw] each MB's L0
        entry (None: 0), coded as ref_idx_l0 when num_ref > 1; aqg and
        intra as for the CAVLC writer (`write_i4_mb` / `write_i16_mb` with
        in_b: the B prefix, then the I slice's suffix)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        t8 = bool(p.transform_8x8)
        last_qp = qp
        if (ref0 is None and np.all(code <= 3) and not t8 and aqg is None
                and intra is None):
            return self._write_b_native(native.write_slice_cabac_b, bw, res,
                                        code, mvd0, mvd1, qp=qp)
        per_unit = mvd0.ndim == 4     # the partition path's [mbh,mbw,4,2]
        while not bw.byte_aligned():
            bw.write1(1)
        w = CabacSliceWriter(mbw, mbh, qp, slice_is_i=False,
                             slice_is_b=True, trans8_mode=t8)
        for a in range(n):
            my, mx = a // mbw, a % mbw
            m = int(code[my, mx])
            cl = int(res["cbp_luma"][my, mx])
            cc = int(res["cbp_chroma"][my, mx])
            r0 = 0 if ref0 is None else int(ref0[my, mx])
            lev = (res["luma_lev"][my, mx], res["chroma_dc"][my, mx],
                   res["chroma_ac"][my, mx])
            k = 0 if intra is None else int(intra[0][my, mx])
            if k == 2:
                w.write_i4_mb(my, mx, intra[1]["i4_modes"][my, mx],
                              *_intra_mb(intra[1], my, mx, "cmode",
                                         "cbp_luma", "cbp_chroma", "luma_ac",
                                         "chroma_dc", "chroma_ac"),
                              in_b=True)
            elif k == 1:
                w.write_i16_mb(my, mx, *_intra_mb(
                    intra[1], my, mx, "mode", "cmode", "cbp_luma",
                    "cbp_chroma", "luma_dc", "luma_ac", "chroma_dc",
                    "chroma_ac"), in_b=True)
            if k:
                w.end_mb(a == n - 1)
                continue
            if m == 0 and cl == 0 and cc == 0:
                w.write_b_skip_mb(my, mx)
                w.end_mb(a == n - 1)
                continue
            dq = 0
            if cl or cc:
                dq, last_qp = self._b_qp_delta(aqg, last_qp, my, mx)
            if m <= 3:
                w.write_b_mb(my, mx, m,
                             mvd0[my, mx, 0] if per_unit else mvd0[my, mx],
                             mvd1[my, mx, 0] if per_unit else mvd1[my, mx],
                             cl, cc, *lev, dqp=dq, ref0=r0, num_ref=num_ref)
            else:
                w.write_b_mb_ext(my, mx, m, subs[my, mx], mvd0[my, mx],
                                 mvd1[my, mx], cl, cc, *lev, dqp=dq, ref0=r0,
                                 num_ref=num_ref)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        return bw.get_bytes()

    # ------------------------------------------------------------------
    def _encode_p16(self, y, u, v, qp: int) -> bytes:
        """The unpartitioned P frame (the reference's `_encode_p`
        16x16 branch with `analyse_p`): the 16x16 analysis (B6 -> B7 ->
        qpel tables -> subpel), pass-1 encode, scan, embed (pass 2; none
        with stego off), deblock, entropy."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        dev = self.device
        mv_q, r_idx, blocks, wht = analyse_p_frame(
            y, self.ref["luma"], torch.as_tensor(self.prev_mv).to(dev),
            p.me_range, mbh, mbw, ME.lambda_tab(qp))
        mv_np = mv_q.cpu().numpy()
        res = P.encode_p_frame_device(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"], mv_q,
            qp, qpc, mbh, mbw, trellis=bool(p.trellis), tables=self.qt,
            nr_offset=self.nr_offset())
        self._nr_update(res)
        skip, mvd, mvp = native.host_scan_p(
            mv_np, res["cbp_luma"].cpu().numpy(),
            res["cbp_chroma"].cpu().numpy())
        if self._stego is not None:
            replaced = self._stego.embed_frame(
                self, y, u, v, qp, mv_np, skip, mvp,
                {"blocks": blocks, "wht": wht, "r_idx": r_idx})
            if replaced is not None:
                mv_np, skip, mvd, res = replaced
        mv4 = torch.as_tensor(mv_np).to(dev) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        self._deblock_device(
            res, torch.zeros((mbh, mbw), dtype=torch.int32, device=dev),
            torch.as_tensor(skip.astype(np.int32)).to(dev), mv4, qp,
            _nnz4(res["luma_lev"], mbh, mbw))
        self.prev_mv = np.ascontiguousarray(mv_np, np.int32)
        res_np = _levels_exact(res, mbh, mbw)
        mvd4 = np.zeros((mbh, mbw, 4, 2), np.int32)
        mvd4[:, :, 0] = mvd
        return self._finish_p_slice(res_np, qp, np.zeros((mbh, mbw),
                                                          np.int32),
                                    mvd4, skip, self.frame_num,
                                    self._poc_lsb)

    def _stack_l0(self, entries, R: int = 0):
        """A list of DPB entries as stacked tensors ([R, 4, Hp, Wp] luma,
        [R, Hp, Wp] chroma) padded to R (default ref_frames) entries by
        repeating the first (the merges mask the padding out), the count
        of valid entries and their display indices."""
        R = R or self.p.ref_frames
        es = list(entries) + [entries[0]] * (R - len(entries))
        return (torch.stack([d["luma"] for d in es]),
                torch.stack([d["u"] for d in es]),
                torch.stack([d["v"] for d in es]), len(entries),
                [e["_disp"] for e in entries])

    def _fused_p(self) -> bool:
        """The P frames take the fused step (the reference's condition,
        core.py:794-799, under the Params served): stego on, one
        reference, partitions, no adaptive quantization, no sub-8x8
        partitions."""
        p = self.p
        return (self._stego is not None and p.partitions
                and p.ref_frames == 1 and not p.aq_mode and not p.p4x4)

    def _encode_p_unfused(self):
        """The unpipelined P path of this encoder's Params: the sub-8x8
        one, the partitioned one (`partitions`, or more than one
        reference, where partitions off pins every MB to 16x16) or the
        16x16-only one."""
        if self.p.p4x4 and self.p.partitions:
            return self._encode_p_sub
        if self.p.partitions or self.p.ref_frames > 1:
            return self._encode_p_parts
        return self._encode_p16

    def _encode_p_parts(self, y, u, v, qp: int) -> bytes:
        """A partitioned P frame unfused, the reference's `_encode_p_parts`
        (core.py:1846-1998) at one reference or more (`partitions` False
        pins every MB to 16x16 at more than one), unpipelined. With stego
        on it serves adaptive quantization at one reference and every
        multi-reference P frame; with stego off every such P frame (the
        plain encoder).

        The analysis at the frame qp: B1 (per DPB entry at more than one
        reference, then the merge), the partition decision, B9, then B3 ->
        B4 with stego on (the probe maps) or B3 alone with its per-MB
        inter cost with stego off; at one reference with stego off, `rd`
        >= 1 and no AQ the RD re-rank `partition.rd_rerank_parts`
        instead. Then the AQ grids, the encode at them (the 8x8
        transform, rd, trellis and noise reduction as the Params say),
        with stego off the intra compare (`intra.refine_p_intra`, off
        under AQ), one pull of part/mv8/cbp(/ref8), the native scan (with
        the intra MBs), with stego off at `rd` 2 (one reference, no AQ)
        the P_SKIP and qpel RD probes, with stego on the embedding (rho at
        the frame qp from the probe maps, a full pass-2 re-encode at the
        grids), B5 with the intra map, the reference map and the
        decoder-visible qp maps, and the slice with its intra MBs and
        mb_qp_delta."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        dev = self.device
        lam = ME.lambda_tab(qp)
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        t8 = bool(p.transform_8x8)
        stego = self._stego is not None
        multiref = p.ref_frames > 1
        prev = torch.as_tensor(self.prev_mv).to(dev)
        ref8, refs, num_ref = None, None, 1
        if multiref:
            refs_luma, refs_u, refs_v, num_ref = self._stack_l0(self.dpb)[:4]
            refs = (refs_luma, refs_u, refs_v)
            part, mv8, ref8, *tail = PT.analyse_p_frame_parts_mref(
                y, refs_luma.to(torch.uint8), num_ref, prev, lam, qp,
                p.me_range, mbh, mbw, p.ref_frames,
                allow_parts=bool(p.partitions),
                tail_kernel=bool(p.tail_kernel), tables=self.qt, probe=stego)
        elif not stego and p.rd >= 1 and not p.aq_mode:
            # the probes quantize by the trellis only at trellis 2
            # (analyse.c:248), the final encode at any trellis
            part, mv8, *tail = PT.rd_rerank_parts(
                y, u, v, self.ref, prev, qp, qpc, lam, p.me_range, mbh, mbw,
                trellis=p.trellis > 1, nr_offset=self.nr_offset(),
                trans8=t8, tail_kernel=bool(p.tail_kernel), tables=self.qt)
        else:
            part, mv8, *tail = PT.analyse_p_frame_parts(
                y, self.ref["luma"].to(torch.uint8), prev, lam, qp,
                p.me_range, mbh, mbw, tail_kernel=bool(p.tail_kernel),
                tables=self.qt, probe=stego)
        qp_enc, qpc_enc = self._aq_frame(y, u, v, qp)
        if multiref:
            res = P.encode_p_frame_device8_mref(
                y, u, v, *refs, mv8, ref8, qp_enc, qpc_enc, mbh, mbw,
                trellis=bool(p.trellis), tables=self.qt,
                nr_offset=self.nr_offset())
        else:
            res = P.encode_p_frame_device8(
                y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"], mv8,
                qp_enc, qpc_enc, mbh, mbw, trans8=t8, rd=bool(p.rd),
                trellis=bool(p.trellis), tables=self.qt,
                nr_offset=self.nr_offset())
        self._nr_update(res)
        res, intra_kind, ir = self._intra_compare(y, u, v, res, tail[0], qp,
                                                  lam)
        intra = intra_kind > 0
        metas = [part.reshape(-1), mv8.reshape(-1),
                 res["cbp_luma"].reshape(-1).to(torch.int32),
                 res["cbp_chroma"].reshape(-1).to(torch.int32)]
        if multiref:
            metas.append(ref8.reshape(-1))
        meta = torch.cat(metas).cpu().numpy()
        part_np = meta[:n].reshape(mbh, mbw)
        mv8_np = np.ascontiguousarray(meta[n:9 * n]).reshape(2 * mbh,
                                                             2 * mbw, 2)
        cbp_l = meta[9 * n:10 * n].reshape(mbh, mbw)
        cbp_c = meta[10 * n:11 * n].reshape(mbh, mbw)
        ref8_np = (np.ascontiguousarray(meta[11 * n:]).reshape(2 * mbh,
                                                               2 * mbw)
                   if multiref else None)
        skip, mvd, mvp, final8 = native.scan_p_parts(
            part_np, mv8_np, cbp_l, cbp_c, intra=intra if ir else None,
            ref8=ref8_np)
        skip &= ~intra
        if not stego and p.rd >= 2 and not multiref and not p.aq_mode:
            for probe in (self._rd_skip_force, self._rd_qpel_refine):
                out = probe(y, u, v, qp, qpc, part_np, final8, skip, mvd,
                            res, intra)
                if out is not None:
                    final8, skip, mvd, res = out
        if stego:
            replaced = self._stego.embed_frame_parts(
                self, y, u, v, qp, part_np, mv8_np, skip, mvp, ref8_np,
                (*tail, part, mv8), refs, grids=(qp_enc, qpc_enc))
            if replaced is not None:
                final8, skip, mvd, res = replaced
        res_np = _levels_exact(res, mbh, mbw)
        intra_t, t8_eff, nnz, intra_res = self._p_deblock_maps(res, res_np,
                                                               intra, ir)
        final8_t = self._dev(final8)
        self._deblock_device(
            res, intra_t, self._dev(skip.astype(np.int32)),
            final8_t.repeat_interleave(2, 0).repeat_interleave(2, 1), qp, nnz,
            trans8=t8_eff,
            ref4=(None if ref8 is None else
                  ref8.repeat_interleave(2, 0).repeat_interleave(2, 1)),
            qp_maps=self._qp_maps_p(res_np, skip, qp))
        # an intra MB carries no motion: its predictor slot is zero
        self.prev_mv = np.where(intra[..., None], 0,
                                final8[::2, ::2]).astype(np.int32)
        self._anchor_motion = (final8, ref8_np, intra)
        return self._finish_p_slice(
            res_np, qp, part_np, mvd, skip, self.frame_num, self._poc_lsb,
            ref8=ref8_np, num_ref=num_ref,
            intra=None if intra_res is None else (intra_kind, intra_res))

    def _intra_compare(self, y, u, v, res, inter_cost, qp: int, lam: int):
        """The plain encoder's intra compare over an encoded frame (the
        reference's core.py:1931, :2616, :3120): with stego off and
        `intra_in_p` on (off under AQ, as in the reference)
        `intra.refine_p_intra` against `inter_cost` [mbh, mbw] (device),
        the switched MBs' recon in res. Returns (res, intra_kind [mbh,
        mbw] host int32, refine_p_intra's dict or None when no MB
        switched)."""
        p = self.p
        kind = np.zeros((p.mb_height, p.mb_width), np.int32)
        if self._stego is not None or not p.intra_in_p or p.aq_mode:
            return res, kind, None
        ir = refine_p_intra(y, u, v, res["recon_y"], res["recon_u"],
                            res["recon_v"], inter_cost, qp,
                            chroma_qp(qp, p.chroma_qp_offset), p.mb_width,
                            p.mb_height, lam=lam, trellis=bool(p.trellis),
                            tables=self.qt)
        kind = ir["intra_kind"].cpu().numpy()
        if not kind.any():
            return res, kind, None
        return dict(res, recon_y=ir["recon_y"], recon_u=ir["recon_u"],
                    recon_v=ir["recon_v"]), kind, ir

    def _p_deblock_maps(self, res, res_np, intra, ir):
        """A P frame's per-MB intra map (device int32), effective trans8
        (the decision AND cbp_luma != 0 AND inter; None without the 8x8
        transform) and per-4x4 nnz (an intra MB's from its own levels)
        for B5, counting the trans8 MBs; and the host arrays of the intra
        MBs for the writers (None without). intra is the host mask, ir
        `_intra_compare`'s dict."""
        mbh, mbw = self.p.mb_height, self.p.mb_width
        intra_t = self._dev(intra.astype(np.int32))
        if "trans8" in res:
            t8_eff = res["trans8"] & (res["cbp_luma"] != 0) & (intra_t == 0)
            nnz = _nnz4_t8(res["luma_lev"], res["luma8_lev"], t8_eff, mbh,
                           mbw)
            self.stats.trans8_mbs += int(
                (res_np["trans8"] & (res_np["cbp_luma"] != 0) & ~intra).sum())
        else:
            t8_eff = None
            nnz = _nnz4(res["luma_lev"], mbh, mbw)
        if ir is None:
            return intra_t, t8_eff, nnz, None
        m4 = intra_t.repeat_interleave(4, 0).repeat_interleave(4, 1)
        nnz = torch.where(m4 != 0, _nnz4(ir["luma_ac"], mbh, mbw), nnz)
        return intra_t, t8_eff, nnz, {k: ir[k].cpu().numpy()
                                      for k in _INTRA_KEYS}

    def _encode_final8(self, y, u, v, qp: int, qpc: int, final8, skip):
        """The rd 2 probes' full re-encode at the field final8 with the
        P_SKIPs in `skip` forced (host arrays)."""
        p = self.p
        return P.encode_p_frame_device8(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            self._dev(final8), qp, qpc, p.mb_height, p.mb_width,
            force_zero=self._dev(skip), trans8=bool(p.transform_8x8),
            rd=bool(p.rd), trellis=bool(p.trellis), tables=self.qt,
            nr_offset=self.nr_offset())

    def _graft_intra(self, res2, res, intra):
        """res2 with the recon of the intra MBs (host mask `intra`) taken
        from res: a rd 2 re-encode keeps the committed intra patches (the
        MBs they predict from keep their recon, `_neighbour_deps`)."""
        if not intra.any():
            return res2
        m = self._dev(intra)
        out = dict(res2)
        for k, b in (("recon_y", 16), ("recon_u", 8), ("recon_v", 8)):
            mm = m.repeat_interleave(b, 0).repeat_interleave(b, 1)
            out[k] = torch.where(mm, res[k], res2[k])
        return out

    def _rd_skip_force(self, y, u, v, qp: int, qpc: int, part_np, final8,
                       skip, mvd, res, intra):
        """rd 2's P_SKIP RD probe, the reference's `_rd_skip_force`
        (core.py:2084-2140): each coded inter MB whose P_SKIP cost at the
        committed field's pskip MV (`scan.pskip_field`) is below its coded
        cost (`inter.rd_skip_eval`) is forced to skip, unless an intra MB
        predicts from it; then the forced rescan and a re-encode. Returns
        (final8, skip, mvd, res) or None when nothing flips."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        pskip = SCAN.pskip_field(part_np, final8, skip)
        cost_c, cost_s = P.rd_skip_eval(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"], pskip,
            res["luma_lev"], res["chroma_dc"], res["chroma_ac"],
            res["recon_y"], res["recon_u"], res["recon_v"], mvd, part_np, qp,
            mbh, mbw)
        cs = torch.stack([cost_c, cost_s]).cpu().numpy()
        force = (cs[1] < cs[0]) & ~skip & ~intra & ~_neighbour_deps(intra)
        if not force.any():
            return None
        skip2 = skip | force
        final2, mvd2, _ = SCAN.scan_p_frame_forced(
            part_np, final8, skip2, intra=intra if intra.any() else None)
        res2 = self._encode_final8(y, u, v, qp, qpc, final2, skip2)
        return final2, skip2, mvd2, self._graft_intra(res2, res, intra)

    def _rd_qpel_refine(self, y, u, v, qp: int, qpc: int, part_np, final8,
                        skip, mvd, res, intra):
        """rd 2's qpel RD refine, the reference's `_rd_qpel_refine`
        (core.py:2000-2083): the frame re-encoded at each of the four
        +-1-qpel shifts of the committed field, `inter.rd_coded_cost` of
        each (the mvds shifted alike), and every coded 16x16 inter MB that
        no intra MB predicts from keeps its first cheaper shift; then the
        forced rescan and a re-encode. Returns (final8, skip, mvd, res) or
        None when no MB moves."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width

        def cost(r, mvd_r):
            return P.rd_coded_cost(
                y, u, v, r["luma_lev"], r["chroma_dc"], r["chroma_ac"],
                r["recon_y"], r["recon_u"], r["recon_v"], mvd_r, part_np, qp,
                mbh, mbw)

        elig = (part_np == 0) & ~skip & ~intra & ~_neighbour_deps(intra)
        if not elig.any():
            return None
        shifts = [np.array(d, np.int32)
                  for d in ((1, 0), (-1, 0), (0, 1), (0, -1))]
        costs = [cost(res, mvd)]
        for off in shifts:
            res_d = self._encode_final8(y, u, v, qp, qpc, final8 + off, skip)
            costs.append(cost(res_d, mvd + off))
        costs = torch.stack(costs).cpu().numpy()
        best = costs[0]
        best_off = np.zeros((mbh, mbw, 2), np.int32)
        for off, cost_d in zip(shifts, costs[1:]):
            upd = (cost_d < best) & elig
            best_off = np.where(upd[..., None], off, best_off)
            best = np.where(upd, cost_d, best)
        if not best_off.any():
            return None
        off8 = np.repeat(np.repeat(best_off, 2, 0), 2, 1)
        final2, mvd2, _ = SCAN.scan_p_frame_forced(
            part_np, (final8 + off8).astype(np.int32), skip,
            intra=intra if intra.any() else None)
        res2 = self._encode_final8(y, u, v, qp, qpc, final2, skip)
        return final2, skip, mvd2, self._graft_intra(res2, res, intra)

    def trans8_elig(self, part, sub_type):
        """The MBs that may take the 8x8 transform on the one-reference
        sub-8x8 path (x264_mb_transform_8x8_allowed: every partition at
        least 8x8), a bool device tensor, or None without the transform
        or with no such MB. part/sub_type are host arrays."""
        if not self.p.transform_8x8:
            return None
        elig = (part != 3) | np.all(sub_type == 0, axis=-1)
        return self._dev(elig) if elig.any() else None

    def _encode_p_sub(self, y, u, v, qp: int) -> bytes:
        """A sub-8x8-partitioned P frame, the reference's `_encode_p_sub`
        (core.py:2518-2812): the analysis (B1's sub-unit instance once
        per reference against prev_mv >> 2 on both of the reference's
        branches, the two-level decision, the per-4x4 qpel tables and
        subpel, `partition.analyse_p_frame_sub(_mref)`; with stego off at
        one reference, `rd` >= 1 and no AQ the sub RD re-rank
        `partition.rd_rerank_sub` instead), the AQ grids, the encode
        (`inter.encode_p_frame_sub`, the fused luma kernel; at more than
        one reference `encode_p_frame_device4` on the stacked DPB,
        4x4-only), with stego off the intra compare
        (`intra.refine_p_intra` against the analysis's per-MB cost, off
        under AQ), one pull of part/sub_type/mv4(/ref8) and one of the
        cbps, the sub scan with the intra MBs, with stego on
        `StegoEngine.embed_frame_sub` (its pass 2 a full re-encode), B5
        on the per-4x4 field with the intra map and the reference map
        (`check_slice` refuses the reference's deblock without it, F10)
        and the slice with its sub_mb_types and intra MBs. The reference
        updates no noise-reduction state on this path (F11)."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        dev = self.device
        lam = ME.lambda_tab(qp)
        qpc = chroma_qp(qp, p.chroma_qp_offset)
        stego = self._stego is not None
        prev = torch.as_tensor(self.prev_mv).to(dev)
        refs, ref8, num_ref = None, None, 1
        tables4 = None
        if p.ref_frames > 1:
            refs_luma, refs_u, refs_v, num_ref = self._stack_l0(self.dpb)[:4]
            refs = (refs_luma, refs_u, refs_v)
            part, sub, mv4, ref8, r_idx4, blocks4, wht4, mb_cost = \
                PT.analyse_p_frame_sub_mref(
                    y, refs_luma.to(torch.uint8), num_ref, prev, p.me_range,
                    mbh, mbw, lam, p.ref_frames)
            tables4 = {"blocks": blocks4, "wht": wht4, "r_idx": r_idx4}
        elif not stego and p.rd >= 1 and not p.aq_mode:
            # the probes quantize by the trellis only at trellis 2
            # (analyse.c:248); no rd 2 probes on this path
            part, sub, mv4, _r_idx4, mb_cost = PT.rd_rerank_sub(
                y, u, v, self.ref, prev, qp, qpc, lam, p.me_range, mbh, mbw,
                trellis=p.trellis > 1, nr_offset=self.nr_offset(),
                tables=self.qt)
        else:
            part, sub, mv4, r_idx4, blocks4, wht4, mb_cost = \
                PT.analyse_p_frame_sub(y, self.ref["luma"].to(torch.uint8),
                                       prev, p.me_range, mbh, mbw, lam)
            tables4 = {"blocks": blocks4, "wht": wht4, "r_idx": r_idx4}
        meta = torch.cat([part.reshape(-1), sub.reshape(-1),
                          mv4.reshape(-1)]
                         + ([] if ref8 is None else [ref8.reshape(-1)])
                         ).cpu().numpy()
        part_np = meta[:n].reshape(mbh, mbw)
        sub_np = meta[n:5 * n].reshape(mbh, mbw, 4)
        mv4_np = np.ascontiguousarray(meta[5 * n:37 * n]).reshape(
            4 * mbh, 4 * mbw, 2)
        ref8_np = (None if ref8 is None else np.ascontiguousarray(
            meta[37 * n:]).reshape(2 * mbh, 2 * mbw))
        qp_enc, qpc_enc = self._aq_frame(y, u, v, qp)
        ref4 = (None if ref8 is None else
                ref8.repeat_interleave(2, 0).repeat_interleave(2, 1))
        if refs is not None:
            res = P.encode_p_frame_device4(
                y, u, v, *refs, mv4, qp_enc, qpc_enc, mbh, mbw, ref4=ref4,
                trellis=bool(p.trellis), tables=self.qt,
                nr_offset=self.nr_offset())
        else:
            res = P.encode_p_frame_sub(
                y, u, v, self.ref, mv4, qp_enc, qpc_enc, mbh, mbw,
                elig=self.trans8_elig(part_np, sub_np), rd=bool(p.rd),
                trellis=bool(p.trellis), tables=self.qt,
                nr_offset=self.nr_offset())
        res, intra_kind, ir = self._intra_compare(y, u, v, res, mb_cost, qp,
                                                  lam)
        intra = intra_kind > 0
        cbp = torch.stack([res["cbp_luma"], res["cbp_chroma"]]).cpu().numpy()
        skip, mvd, mvp, final4 = SCAN.scan_p_frame_sub(
            part_np, sub_np, mv4_np, cbp[0], cbp[1],
            intra=intra if ir else None, ref8=ref8_np)
        skip &= ~intra
        if stego:
            replaced = self._stego.embed_frame_sub(
                self, y, u, v, qp, part_np, sub_np, mv4_np, skip, mvp,
                tables4, ref8=ref8_np, refs=refs, grids=(qp_enc, qpc_enc))
            if replaced is not None:
                final4, skip, mvd, res = replaced
        res_np = _levels_exact(res, mbh, mbw)
        intra_t, t8_eff, nnz, intra_res = self._p_deblock_maps(res, res_np,
                                                               intra, ir)
        self._deblock_device(
            res, intra_t, self._dev(skip.astype(np.int32)),
            self._dev(final4), qp, nnz, trans8=t8_eff, ref4=ref4,
            qp_maps=self._qp_maps_p(res_np, skip, qp))
        # an intra MB carries no motion: its predictor slot is zero
        self.prev_mv = np.where(intra[..., None], 0,
                                final4[::4, ::4]).astype(np.int32)
        self._anchor_motion = (np.ascontiguousarray(final4), ref8_np, intra)
        self.last_sub = (part_np, sub_np)
        return self._finish_p_slice(
            res_np, qp, part_np, mvd, skip, self.frame_num, self._poc_lsb,
            ref8=ref8_np, num_ref=num_ref, sub_type=sub_np,
            intra=None if intra_res is None else (intra_kind, intra_res))

    # ------------------------------------------------------------------
    # adaptive quantization (x264_adaptive_quant_frame; the reference's
    # core.py:1143-1175, :1898-1911, :2373-2385, :2878-2890)
    def _aq_frame(self, y, u, v, qp: int):
        """The frame's (qp, chroma qp) for the encodes: under adaptive
        quantization its per-MB grids (`ops.aq.frame_grids`, kept on the
        host as `self.aq_grids` for the writers and the deblocker) as int32
        device tensors; otherwise the frame's ints, and `aq_grids` None."""
        p = self.p
        if not p.aq_mode:
            self.aq_grids = None
            return qp, chroma_qp(qp, p.chroma_qp_offset)
        self.aq_grids = AQ.frame_grids(y, u, v, qp, p)
        return tuple(self._dev(g) for g in self.aq_grids)

    def _qp_maps(self, coded, qp: int):
        """The deblocker's (qp, chroma qp) maps under adaptive
        quantization, or None: the decoder-visible chain of the frame's
        grid over the MBs that code mb_qp_delta (`coded`, host bool
        [mbh, mbw]; the others keep the previous MB's qp)."""
        if self.aq_grids is None:
            return None
        eff = AQ.effective_qp_grid(self.aq_grids[0], coded, qp)
        return (self._dev(eff),
                self._dev(AQ.chroma_grid(eff, self.p.chroma_qp_offset)))

    def _qp_maps_p(self, res_np, skip, qp: int):
        """`_qp_maps` of a P frame: an MB codes mb_qp_delta when it is
        not skipped and has a cbp."""
        if self.aq_grids is None:
            return None
        coded = (((res_np["cbp_luma"] | res_np["cbp_chroma"]) != 0)
                  & ~np.asarray(skip, bool))
        return self._qp_maps(coded, qp)

    def _qp_grid_arg(self):
        """The writers' per-MB qp grid, or None."""
        return None if self.aq_grids is None else self.aq_grids[0]

    def _encode_i(self, y, u, v, qp: int) -> bytes:
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        t8 = bool(p.transform_8x8)
        qp_enc, qpc_enc = self._aq_frame(y, u, v, qp)
        res_dev = encode_i_frame(y, u, v, qp_enc, qpc_enc, mbw, mbh,
                                 lam=ME.lambda_tab(qp), i8x8=t8,
                                 rd=bool(p.rd), trellis=bool(p.trellis),
                                 tables=self.qt)
        dev = self.device
        i32 = torch.int32
        if t8:
            # I_8x8 MBs carry transform_size_8x8_flag = 1 whatever their
            # cbp (spec 7.3.5)
            t8_i = res_dev["mb_i8"]
            nnz = _nnz4_t8(res_dev["luma_ac"], res_dev["luma8_lev"], t8_i,
                           mbh, mbw)
        else:
            t8_i = None
            nnz = _nnz4(res_dev["luma_ac"], mbh, mbw)
        keys = ("mode", "cmode", "cbp_luma", "cbp_chroma", "luma_dc",
                "luma_ac", "chroma_dc", "chroma_ac", "mb_i4", "i4_modes")
        if t8:
            keys += ("mb_i8", "i8_modes", "luma8_lev")
        res = {k: res_dev[k].cpu().numpy() for k in keys}
        qp_maps = None
        if self.aq_grids is not None:
            # I_16x16 always codes mb_qp_delta, I_NxN only with residual
            i16 = ~res["mb_i4"].astype(bool)
            if t8:
                i16 &= ~res["mb_i8"].astype(bool)
            qp_maps = self._qp_maps(
                i16 | ((res["cbp_luma"] | res["cbp_chroma"]) != 0), qp)
        self._deblock_device(
            res_dev, torch.ones((mbh, mbw), dtype=i32, device=dev),
            torch.zeros((mbh, mbw), dtype=i32, device=dev),
            torch.zeros((4 * mbh, 4 * mbw, 2), dtype=i32, device=dev), qp,
            nnz, trans8=t8_i, qp_maps=qp_maps)
        if t8:
            self.stats.i8x8_mbs += int(res["mb_i8"].sum())
        self.prev_mv = np.zeros((mbh, mbw, 2), np.int32)
        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_I,
                             self.frame_num, qp, idr=True,
                             idr_pic_id=self.idr_pic_id,
                             disable_deblock=0,
                             alpha_div2=p.deblock_alpha,
                             beta_div2=p.deblock_beta,
                             poc_lsb=self._poc_lsb)
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self._anchor_motion = None
        hdr, nbits = bw.partial_bytes()
        if p.cabac:
            return native.write_slice_cabac(
                hdr, nbits, H.SLICE_TYPE_I, mbw, mbh, qp,
                mode=res["mode"].reshape(n), cmode=res["cmode"].reshape(n),
                cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
                luma_dc=res["luma_dc"].reshape(n, 16),
                luma_blocks=res["luma_ac"].reshape(n, 16, 16),
                chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
                chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
                mb_i4=res["mb_i4"].reshape(n),
                i4_modes=res["i4_modes"].reshape(n, 16),
                mb_i8=res["mb_i8"].reshape(n) if t8 else None,
                i8_modes=res["i8_modes"].reshape(n, 4) if t8 else None,
                luma8_lev=res["luma8_lev"].reshape(n, 256) if t8 else None,
                trans8_mode=t8, qp_grid=self._qp_grid_arg())
        return native.write_slice(
            hdr, nbits, H.SLICE_TYPE_I, mbw, mbh,
            mode=res["mode"].reshape(n), cmode=res["cmode"].reshape(n),
            cbp_luma=res["cbp_luma"], cbp_chroma=res["cbp_chroma"],
            luma_dc=res["luma_dc"].reshape(n, 16),
            luma_blocks=res["luma_ac"].reshape(n, 16, 16),
            chroma_dc=res["chroma_dc"].reshape(n, 2, 4),
            chroma_ac=res["chroma_ac"].reshape(n, 2, 4, 16),
            mb_i4=res["mb_i4"].reshape(n),
            i4_modes=res["i4_modes"].reshape(n, 16),
            mb_i8=res["mb_i8"].reshape(n) if t8 else None,
            i8_modes=res["i8_modes"].reshape(n, 4) if t8 else None,
            luma8_lev=res["luma8_lev"] if t8 else None, trans8_mode=t8,
            qp_grid=self._qp_grid_arg(), slice_qp=qp)

    def _cost_mv_dev(self, qp: int, lam: int) -> torch.Tensor:
        if qp not in self._cmv_cache:
            self._cmv_cache[qp] = torch.as_tensor(
                cost_mv_table(lam)).to(self.device)
        return self._cmv_cache[qp]

    def _fused_dispatch(self, y, u, v, qp: int, qpc: int, extra=None):
        """Enqueue the fused stage 1; no blocking pull here."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        lam = ME.lambda_tab(qp)
        prev_mv = torch.as_tensor(self.prev_mv).to(self.device)
        packed, res = p_stage1_stego(
            y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
            prev_mv, qp, qpc, lam, self._cost_mv_dev(qp, lam), p.me_range,
            mbh, mbw, extra=extra, tail_kernel=bool(p.tail_kernel),
            trans8=bool(p.transform_8x8), rd=bool(p.rd),
            trellis=bool(p.trellis), tables=self.qt,
            nr_offset=self.nr_offset())
        return dict(packed=packed, res=res, y=y, u=u, v=v, qp=qp, qpc=qpc)

    def _fused_complete(self, d) -> dict:
        """The noise reduction's update from pass 1, host STC + flips,
        then enqueue the re-encode (incremental where few MBs changed,
        always full under the 8x8 transform, trellis or noise reduction,
        as in the reference), the lean level pack and the deblock.
        Returns the pending record the next frame's call drains."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        qp, qpc, y, u, v = d["qp"], d["qpc"], d["y"], d["u"], d["v"]
        packed = d["packed"]
        self._nr_update(d["res"])
        part_np = packed[:n].astype(np.int32).reshape(mbh, mbw)
        mv8_np = packed[n:9 * n].astype(np.int32).reshape(2 * mbh, 2 * mbw, 2)
        skip1 = packed[11 * n:12 * n].astype(bool).reshape(mbh, mbw)
        alt_u = packed[12 * n:20 * n].astype(np.int32).reshape(mbh, mbw, 4, 2)
        rho_u = np.ascontiguousarray(packed[20 * n:24 * n]) \
            .reshape(mbh, mbw, 4).astype(np.float64)

        final8, skip, mvd = self._stego.apply_costs(
            self, part_np, mv8_np, skip1, rho_u, alt_u)
        dev = self.device
        final8_t = torch.as_tensor(np.ascontiguousarray(final8)).to(dev)
        idx, fzs = changed_mbs(mv8_np, final8, skip1, skip, mbh, mbw)
        t8 = bool(p.transform_8x8)
        incr_ok = not (t8 or p.trellis or p.noise_reduction)
        if incr_ok and len(idx) <= n // 4:
            idx_p, fz_p, _cap = pad_subset(idx, fzs, n)
            res2 = reencode_p_incremental(
                d["res"], y, u, v, self.ref["luma"], self.ref["u"],
                self.ref["v"], final8_t, torch.as_tensor(idx_p).to(dev),
                torch.as_tensor(fz_p).to(dev), qp, qpc, mbh, mbw,
                tables=self.qt)
        else:
            res2 = P.encode_p_frame_device8(
                y, u, v, self.ref["luma"], self.ref["u"], self.ref["v"],
                final8_t, qp, qpc, mbh, mbw,
                force_zero=torch.as_tensor(skip).to(dev), trans8=t8,
                rd=bool(p.rd), trellis=bool(p.trellis), tables=self.qt,
                nr_offset=self.nr_offset())
        if t8:
            # the effective flag: the decision AND cbp_luma != 0 (with no
            # luma residual the flag is not sent and reads as 0)
            t8_eff = res2["trans8"] & (res2["cbp_luma"] != 0)
            nnz = _nnz4_t8(res2["luma_lev"], res2["luma8_lev"], t8_eff, mbh,
                           mbw)
        else:
            t8_eff = None
            nnz = _nnz4(res2["luma_lev"], mbh, mbw)
        # the lean level buffer is enqueued before the deblock waves
        buf = _pack_frame_lean(res2, n)
        mv4 = final8_t.repeat_interleave(2, 0).repeat_interleave(2, 1)
        self._deblock_device(
            res2, torch.zeros((mbh, mbw), dtype=torch.int32, device=dev),
            torch.as_tensor(skip.astype(np.int32)).to(dev), mv4, qp, nnz,
            trans8=t8_eff)
        # no intra MBs in stego P frames: the predictor is the final field
        self.prev_mv = np.ascontiguousarray(final8[::2, ::2], np.int32)
        return dict(buf=buf, res=res2, qp=qp, part=part_np, mvd=mvd,
                    skip=skip, final8=final8)

    def _deblock_device(self, res, intra, skip, mv4, qp: int, nnz4,
                        trans8=None, ref4=None, qp_maps=None):
        """In-loop deblock (kernel B5 on CUDA, one launch on uint8 copies
        of the recon planes) into the new reference; trans8 [mbh, mbw]
        marks the MBs coded with the 8x8 transform, ref4 [4mbh, 4mbw]
        holds each 4x4 block's reference index (None: one reference),
        qp_maps the per-MB (qp, chroma qp) maps under adaptive
        quantization (`_qp_maps`; None: the frame's qp)."""
        p = self.p
        off_a, off_b = 2 * p.deblock_alpha, 2 * p.deblock_beta
        qps = qp_maps or (qp, chroma_qp(qp, p.chroma_qp_offset))
        dy, du, dv = deblock_frame(
            res["recon_y"], res["recon_u"], res["recon_v"], intra, skip,
            nnz4, mv4, qps[0], qps[1], p.mb_height, p.mb_width,
            qp_thresh=(15 - min(off_a, off_b) - max(0, p.chroma_qp_offset)),
            off_a=off_a, off_b=off_b, trans8=trans8, ref4=ref4)
        self.recon_prev = (dy, du, dv)
        self._push_ref(mc.build_ref(dy, du, dv))

    def _push_ref(self, refdict: dict):
        """Sliding-window DPB update (newest first; spec 8.2.5.3), at most
        SPS num_ref_frames entries. The entry takes the metadata the
        coding picture staged in `_ref_meta` (display index, frame_num,
        anchor or reference B, its own L0 display indices for
        map_col_to_list0; an IPP stream stages none), then the P list
        view is derived again."""
        e = dict(refdict)
        disp, fn, anchor, ref_poc0 = self._ref_meta or (0, 0, True, [])
        self._ref_meta = None
        e.update(_disp=disp, _fn=fn, _anchor=anchor,
                 _ref_poc0=list(ref_poc0))
        self._dpb_store.insert(0, e)
        del self._dpb_store[self.sps.num_ref_frames:]
        self._refresh_dpb_view()

    def _refresh_dpb_view(self):
        """The P list over the store (the reference's `_refresh_dpb_view`):
        the newest anchor, then the rest PicNum-descending, cut to
        ref_frames; after a pyramid GOP this is the decoder's default list
        after the one reordering op, otherwise decode order."""
        st = self._dpb_store
        if not st:
            self.dpb, self._dpb_disps, self.ref = [], [], None
            return
        head = next((e for e in st if e["_anchor"]), st[0])
        rest = sorted((e for e in st if e is not head),
                      key=lambda e: -e["_fn"])
        self.dpb = ([head] + rest)[:self.p.ref_frames]
        self._dpb_disps = [e["_disp"] for e in self.dpb]
        self.ref = self.dpb[0]

    def _b_l0_view(self, bdisp: int):
        """A B frame's L0 list over the store: the references before it
        in display order, POC-descending (spec 8.2.4.2.3), cut to
        ref_frames."""
        return sorted((e for e in self._dpb_store if e["_disp"] < bdisp),
                      key=lambda e: -e["_disp"])[:self.p.ref_frames]

    @staticmethod
    def _refs4(part_np, ref8):
        """[mbh, mbw, 4] L0 index of each ref slot for the native writers
        (the reference's `_refs4`: slot k is partition k's first 8x8,
        unused slots 0)."""
        mbh, mbw = part_np.shape
        r = np.zeros((mbh, mbw, 4), np.int32)
        r[..., 0] = ref8[::2, ::2]
        r[..., 1] = np.where(part_np == 1, ref8[1::2, ::2], ref8[::2, 1::2])
        r[..., 2] = ref8[1::2, ::2]
        r[..., 3] = ref8[1::2, 1::2]
        return r

    def _finish_p_slice(self, res_np, qp: int, part_np, mvd, skip,
                        frame_num: int, poc_lsb: int, ref8=None,
                        num_ref: int = 1, sub_type=None,
                        intra=None) -> bytes:
        """P slice header + native CAVLC or CABAC entropy of a completed
        frame (the 16x16-only path passes part 0 and mvd in slot 0). On
        the multi-reference path ref8 [2mbh, 2mbw] gives each 8x8 block's
        reference and num_ref the active L0 count (the header overrides
        the PPS's while it is smaller; ref_idx is coded when it is above
        1). On the sub-8x8 path sub_type [mbh,mbw,4] gives each P_8x8
        block's sub_mb_type and mvd [mbh,mbw,16,2] the units' mvds in
        coding order. With stego off, `intra` is (intra_kind [mbh,mbw],
        the host arrays of `intra.refine_p_intra`) when the slice holds
        intra MBs: they take its levels and modes, I_16x16 or I_NxN with the
        P slice's mb_type offset (their mb_qp_delta 0, and under the 8x8
        transform an I_NxN MB's transform_size_8x8_flag 0, as in the
        reference). The native writers serve every slice, under adaptive
        quantization with the frame's grid (`aq_grids`) as mb_qp_delta."""
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        t8 = bool(p.transform_8x8)
        cbp_l, cbp_c = res_np["cbp_luma"], res_np["cbp_chroma"]
        luma = res_np["luma_lev"].reshape(n, 16, 16)
        cdc = res_np["chroma_dc"].reshape(n, 2, 4)
        cac = res_np["chroma_ac"].reshape(n, 2, 4, 16)
        kw = {}
        if intra is not None:
            kind, ir = intra
            m = kind.reshape(n) > 0

            def pick(a, b):
                return np.where(m.reshape((n,) + (1,) * (b.ndim - 1)),
                                a.reshape(b.shape), b)

            cbp_l = pick(ir["cbp_luma"], cbp_l.reshape(n).astype(np.int32))
            cbp_c = pick(ir["cbp_chroma"], cbp_c.reshape(n).astype(np.int32))
            luma = pick(ir["luma_ac"], luma)
            cdc = pick(ir["chroma_dc"], cdc)
            cac = pick(ir["chroma_ac"], cac)
            kw = dict(p_intra=m, mode=ir["mode"].reshape(n),
                      cmode=ir["cmode"].reshape(n),
                      luma_dc=ir["luma_dc"].reshape(n, 16),
                      mb_i4=(kind.reshape(n) == 2).astype(np.uint8),
                      i4_modes=ir["i4_modes"].reshape(n, 16))
        bw = BitWriter()
        H.write_slice_header(bw, self.sps, self.pps, H.SLICE_TYPE_P,
                             frame_num, qp, idr=False, disable_deblock=0,
                             alpha_div2=p.deblock_alpha,
                             beta_div2=p.deblock_beta, poc_lsb=poc_lsb,
                             reorder_l0=self._take_reorder_l0(frame_num),
                             p_l0_active=num_ref)
        hdr, nbits = bw.partial_bytes()
        refs = None if ref8 is None else self._refs4(part_np, ref8)
        mvd4 = mvd.reshape(n, -1, 2)
        sub = None if sub_type is None else sub_type.reshape(n, 4)
        if p.cabac:
            return native.write_slice_cabac(
                hdr, nbits, H.SLICE_TYPE_P, mbw, mbh, qp,
                skip=skip.reshape(n).astype(np.uint8),
                part=part_np.reshape(n), mvd4=mvd4, sub_type=sub,
                cbp_luma=cbp_l, cbp_chroma=cbp_c, luma_blocks=luma,
                chroma_dc=cdc, chroma_ac=cac, refs=refs, num_ref=num_ref,
                luma8_lev=(res_np["luma8_lev"].reshape(n, 256)
                           if "luma8_lev" in res_np else None),
                trans8=(res_np["trans8"].astype(np.int32)
                        if "trans8" in res_np else None),
                trans8_mode=t8, qp_grid=self._qp_grid_arg(), **kw)
        return native.write_slice(
            hdr, nbits, H.SLICE_TYPE_P, mbw, mbh,
            skip=skip.reshape(n).astype(np.uint8),
            part=part_np.reshape(n), mvd4=mvd4, sub_type=sub,
            cbp_luma=cbp_l, cbp_chroma=cbp_c, luma_blocks=luma,
            chroma_dc=cdc, chroma_ac=cac, refs=refs, num_ref=num_ref,
            trans8=res_np["trans8"].reshape(n) if "trans8" in res_np
            else None, luma8_lev=res_np.get("luma8_lev"), trans8_mode=t8,
            qp_grid=self._qp_grid_arg(), slice_qp=qp, **kw)

    def load_state(self, d: dict) -> None:
        """Resume mid-stream from a state dict of numpy arrays (see
        `video_steganography_pcamv_torch.state.from_reference`)."""
        load_state(self, d)
