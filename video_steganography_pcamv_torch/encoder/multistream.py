"""Multi-stream encoders (port of encoder/multistream.py).

`MultiEncoder` encodes S independent streams in lockstep, one frame of
each per step, every stream with its own `Encoder` on its own device
(stream s on devices[s % len(devices)]). The reference vmaps its device
stages over a stacked [S, ...] stream axis to amortize dispatch and
transfer syncs; the port's form of that batching is the order of the
work: all S streams' analysis and pass-1 encodes are enqueued before one
host sync, all S streams' part/mv8/cbp metas come back in one transfer
per device, and all S streams' levels in one transfer per device after
pass 2. Each kernel is launched once per stream (none has a stream axis).
The host work (the native scans, rho's pulls, the STC embedding, the
entropy writers) loops over the streams, as in the reference.

Per P step and stream, as the reference's `encode_step`: the partition
analysis (kernel B1 against a zero predictor with `Params.tail_kernel`,
the reference's accelerator branch, else against prev_mv >> 2, its CPU
branch; B9; B3 and B4), the pass-1 encode (the fused luma-encode
kernel), the native MVP/P_SKIP scan, rho from B4's probe maps and
`probe_combine` (the reference's `stego_costs_parts`), the host STC
(`StegoEngine.apply_costs`), a full pass-2 re-encode (never the
incremental one), the in-loop deblock (kernel B5, bit-exact to the
reference's host deblocker) with the new reference built from it, and
the slice through the encoder's native CAVLC or CABAC writer. With
stego off (the reference's `self._stego is None` branch, multistream.py:
204-207) no B4 runs and B3 gives the per-MB cost instead, the pass-1
encode is the final one, and the slice codes the scan's field, skips and
mvds (the reference's MultiEncoder turns intra in P off).

The reference's `MultiEncoder` reads few Params: its P encodes take no
option but the quant tables (process state there, each encoder's own
`qt` here) and it writes AUD, POC, reference-count and deblock-offset
fields nowhere. `check_multistream` refuses each option it does not
serve. `PipelinedMultiEncoder` drives S independent `Encoder`s round-
robin through their own `encode_frame` (the fused serving path).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..params import Params, SLICE_I, SLICE_P
from ..ops.transform import chroma_qp
from ..utils.bitstream import (nal_unit, NAL_SLICE, NAL_SLICE_IDR,
                               NAL_PRIORITY_HIGHEST, NAL_PRIORITY_HIGH)
from . import inter as P
from . import me as ME
from . import partition as PT
from .core import Encoder, _levels_i16, _nnz4, _split_levels


def check_multistream(p: Params) -> None:
    """Raise NotImplementedError for the options the reference's
    `MultiEncoder` ignores or breaks (ROADMAP F7-F9): its P steps run
    the one-reference partitioned analysis and encodes at the frame qp
    whatever the Params say, and its P slice header carries neither the
    deblock offsets nor a POC LSB nor a reference-count override. Stego
    on or off is served."""
    bad = [name for name, on in (
        ("ref_frames>1 (its P steps search the newest frame only, and "
         "its CAVLC P slices code no ref_idx: ROADMAP F7)",
         p.ref_frames > 1),
        ("bframes (it codes every frame as I or P)", p.bframes > 0),
        ("transform_8x8 (its P slices omit transform_size_8x8_flag: "
         "ROADMAP F8)", p.transform_8x8),
        ("trellis (its P encodes never trellis)", p.trellis),
        ("aq_mode (its P encodes quantize at the frame qp)", p.aq_mode),
        ("noise_reduction (its P encodes never denoise)",
         p.noise_reduction),
        ("deblock_alpha/deblock_beta (its P slice headers omit the "
         "offsets its deblock applies: ROADMAP F9)",
         p.deblock_alpha or p.deblock_beta),
        ("aud (it writes no access-unit delimiter)", p.aud),
        ("partitions off (its P steps always run the partitioned "
         "analysis)", not p.partitions),
        ("p4x4 (its P steps never split an 8x8)", p.p4x4)) if on]
    if bad:
        raise NotImplementedError("MultiEncoder: " + ", ".join(bad))


def _pull(tensors) -> list:
    """Host copies of the flat same-dtype `tensors`, one transfer per
    device."""
    by_dev = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out = [None] * len(tensors)
    for idx in by_dev.values():
        flat = torch.cat([tensors[i] for i in idx]).cpu().numpy()
        at = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[at:at + k]
            at += k
    return out


class MultiEncoder:
    """Encode S independent streams in lockstep (one frame from each per
    step). `devices`: where the streams live, stream s on
    devices[s % len(devices)] (default: "cuda:0" for every stream)."""

    def __init__(self, params: Params, n_streams: int, devices=None):
        check_multistream(params)
        # intra-in-P is not batched in the reference either: it keeps
        # the device stages identical across the stream axis
        params.intra_in_p = False
        devs = [torch.device(d) for d in (devices or ["cuda:0"])]
        self.S = n_streams
        self.devices = [devs[s % len(devs)] for s in range(n_streams)]
        self.encs = [Encoder(params, device=d) for d in self.devices]
        self.p = params
        self._refs = None   # each stream's reference dict, after a step

    def encode_step(self, frames) -> list:
        """frames: one Frame per stream. Returns per-stream chunks."""
        if len(frames) != self.S:
            raise ValueError("encode_step: %d frames for %d streams"
                             % (len(frames), self.S))
        encs = self.encs
        padded = [e._pad(f) for e, f in zip(encs, frames)]
        decisions = []
        for e, (y, _u, _v) in zip(encs, padded):
            is_idr, satd = e.lookahead.decide(y)
            if e.ref is None and self._refs is None:
                is_idr = True
            qp = e.rc.start(SLICE_I if is_idr else SLICE_P, satd)
            decisions.append((is_idr, qp))
        if len({d[0] for d in decisions}) != 1:
            raise RuntimeError("streams out of GOP lockstep")
        if decisions[0][0]:
            outs = []
            for e, (y, u, v), (_, qp) in zip(encs, padded, decisions):
                e.frame_num = 0
                chunk = e.headers() + nal_unit(
                    NAL_SLICE_IDR, NAL_PRIORITY_HIGHEST,
                    e._encode_i(y, u, v, qp))
                self._finish(e, chunk)
                outs.append(chunk)
            self._refs = [e.ref for e in encs]
            return outs
        return self._encode_p_step(padded, [d[1] for d in decisions])

    def _encode_p_step(self, padded, qps) -> list:
        p = self.p
        mbh, mbw = p.mb_height, p.mb_width
        n = mbh * mbw
        encs = self.encs
        # the analysis and pass 1 of every stream, enqueued before any
        # host sync (the reference's `_analyse_encode_s`)
        stego = encs[0]._stego is not None
        stage1, metas, res2 = [], [], []
        for s, e in enumerate(encs):
            y, u, v = padded[s]
            qp = qps[s]
            ref = self._refs[s]
            part, mv8, *tail = PT.analyse_p_frame_parts(
                y, ref["luma"].to(torch.uint8),
                torch.as_tensor(e.prev_mv).to(e.device), ME.lambda_tab(qp),
                qp, p.me_range, mbh, mbw, tail_kernel=bool(p.tail_kernel),
                tables=e.qt, probe=stego)
            # with stego off the pass-1 encode is the final one
            res1 = P.encode_p_frame_device8(
                y, u, v, ref["luma"], ref["u"], ref["v"], mv8, qp,
                chroma_qp(qp, p.chroma_qp_offset), mbh, mbw,
                cbp_only=stego, tables=e.qt)
            stage1.append((part, mv8, *tail))
            if not stego:
                res2.append(res1)
            metas.append(torch.cat([
                part.reshape(-1), mv8.reshape(-1),
                res1["cbp_luma"].reshape(-1).to(torch.int32),
                res1["cbp_chroma"].reshape(-1).to(torch.int32)]))
        metas = _pull(metas)

        # per stream: the native scan (with stego off, all), rho (the
        # reference's
        # `stego_costs_parts` is `probe_maps_xla` + `probe_combine`:
        # B4's maps are the first half here), the STC, then the full
        # pass 2.
        # The reference's batched `_stego_costs_s` is never called, so it
        # has no counterpart.
        hosts = []
        for s, e in enumerate(encs):
            y, u, v = padded[s]
            qp = qps[s]
            meta = metas[s]
            part_np = meta[:n].reshape(mbh, mbw)
            mv8_np = np.ascontiguousarray(meta[n:9 * n]).reshape(
                2 * mbh, 2 * mbw, 2)
            skip1, mvd1, mvp, final1 = native.scan_p_parts(
                part_np, mv8_np, meta[9 * n:10 * n].reshape(mbh, mbw),
                meta[10 * n:].reshape(mbh, mbw))
            if not stego:
                hosts.append((part_np, final1, skip1, mvd1))
                continue
            part, mv8, SK, SP, sc8 = stage1[s]
            rho, alt, _valid = PT.probe_combine(
                SK, SP, sc8, part, mv8, torch.as_tensor(mvp).to(e.device),
                e._cost_mv_dev(qp, ME.lambda_tab(qp)), mbh, mbw)
            rho_alt = torch.cat([rho.reshape(-1),
                                 alt.reshape(-1).to(torch.float32)]) \
                .cpu().numpy()
            final8, skip, mvd = e._stego.apply_costs(
                e, part_np, mv8_np, skip1,
                rho_alt[:4 * n].reshape(mbh, mbw, 4),
                rho_alt[4 * n:].reshape(mbh, mbw, 4, 2).astype(np.int32))
            ref = self._refs[s]
            res2.append(P.encode_p_frame_device8(
                y, u, v, ref["luma"], ref["u"], ref["v"],
                torch.as_tensor(np.ascontiguousarray(final8)).to(e.device),
                qp, chroma_qp(qp, p.chroma_qp_offset), mbh, mbw,
                force_zero=torch.as_tensor(skip).to(e.device), tables=e.qt))
            hosts.append((part_np, final8, skip, mvd))
        levels = _pull([_levels_i16(r, n).reshape(-1) for r in res2])

        outs = []
        for s, e in enumerate(encs):
            qp = qps[s]
            part_np, final8, skip, mvd = hosts[s]
            res = res2[s]
            dev = e.device
            final8_t = torch.as_tensor(np.ascontiguousarray(final8)).to(dev)
            # B5 on the device while the host writes this stream's slice
            e._deblock_device(
                res, torch.zeros((mbh, mbw), dtype=torch.int32, device=dev),
                torch.as_tensor(skip.astype(np.int32)).to(dev),
                final8_t.repeat_interleave(2, 0).repeat_interleave(2, 1), qp,
                _nnz4(res["luma_lev"], mbh, mbw))
            e.prev_mv = np.ascontiguousarray(final8[::2, ::2], np.int32)
            # the reference writes its own P slice header (multistream.py:
            # 223-228) without deblock offsets, POC LSB or a reference
            # count; under the Params served here (`check_multistream`)
            # the encoder's slice writer codes the same bits
            chunk = nal_unit(NAL_SLICE, NAL_PRIORITY_HIGH, e._finish_p_slice(
                _split_levels(levels[s].reshape(n, -1), mbh, mbw), qp,
                part_np, mvd, skip, e.frame_num, e._poc_lsb))
            self._finish(e, chunk)
            outs.append(chunk)
        self._refs = [e.ref for e in encs]
        return outs

    @staticmethod
    def _finish(e, chunk: bytes) -> None:
        e.frame_num += 1
        e.stats.frames += 1
        e.stats.bits += 8 * len(chunk)
        e.rc.end(8 * len(chunk))


class PipelinedMultiEncoder:
    """S independent Encoders driven round-robin through the fused
    serving path: each `encode_frame` enqueues its stream's stage 1 and
    writes its previous frame's slice meanwhile, so the host work of one
    stream overlaps the device work of the next. No GOP lockstep.
    `devices` as for `MultiEncoder`."""

    def __init__(self, params: Params, n_streams: int, devices=None):
        devs = [torch.device(d) for d in (devices or ["cuda:0"])]
        self.S = n_streams
        self.encs = [Encoder(params, device=devs[s % len(devs)])
                     for s in range(n_streams)]

    def encode_step(self, frames) -> list:
        """frames: one Frame per stream. Returns per-stream chunks
        (entropy may lag one frame per stream; `flush` drains)."""
        if len(frames) != self.S:
            raise ValueError("encode_step: %d frames for %d streams"
                             % (len(frames), self.S))
        return [e.encode_frame(f) for e, f in zip(self.encs, frames)]

    def flush(self) -> list:
        return [e.flush() for e in self.encs]
