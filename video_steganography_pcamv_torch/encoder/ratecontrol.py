"""Rate control: CQP / CRF / ABR, VBV, 2-pass stat files, qpfile.

Reference: encoder/ratecontrol.c — x264_ratecontrol_new (:268),
rate_estimate_qscale (ABR/CRF feedback loop), clip_qscale (VBV),
x264_ratecontrol_end (complexity accumulation), init_pass2 (:137,
2-pass allocation), parse_qpfile (x264.c:862-868).

This is pure per-frame scalar host logic (it is host C in the reference
too); the device contribution is the lookahead SATD complexity estimate
(encoder/slicetype.py) standing in for x264_rc_analyse_slice.

The control law is x264's:
  qscale = blurred_complexity^(1-qcomp) / rate_factor
with rate_factor = wanted_bits_window / cplxr_sum for ABR (feedback) or
a constant derived from the target quality for CRF, ABR overflow
compensation against a 2*tolerance*bitrate buffer, per-type qscale
ratios (ip_factor), step clamps, and VBV clamping via per-type
bits-size predictors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# RC modes (reference: X264_RC_* x264.h)
RC_CQP = 0
RC_CRF = 1
RC_ABR = 2

SLICE_I = 0
SLICE_P = 1
SLICE_B = 2


def qp2qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale2qp(q: float) -> float:
    return 12.0 + 6.0 * math.log2(q / 0.85)


def clip3(x, lo, hi):
    return max(lo, min(hi, x))


@dataclass
class _Pred:
    """Linear bits predictor bits ~ coeff*satd/qscale (ratecontrol.c
    predict_size/update_predictor)."""
    coeff: float = 0.25
    count: float = 1.0
    decay: float = 0.5

    def predict(self, q: float, satd: float) -> float:
        return self.coeff * satd / (q * self.count)

    def update(self, q: float, satd: float, bits: float) -> None:
        if satd < 1 or bits < 1:
            return
        self.count *= self.decay
        self.coeff *= self.decay
        self.count += 1.0
        self.coeff += bits * q / satd


class RateControl:
    """Per-frame QP decision. Usage:
    qp = rc.start(slice_type, satd); ...encode...; rc.end(bits)."""

    def __init__(self, params):
        p = params
        self.p = p
        self.mode = p.rc_mode
        self.fps = p.fps_num / p.fps_den
        self.bitrate = p.bitrate * 1000.0  # kbps -> bps
        self.rate_tolerance = p.rate_tolerance
        self.qcomp = p.qcomp
        self.ip_factor = p.ip_ratio
        self.lstep = 2.0 ** (p.qp_step / 6.0)
        self.frame_num = 0
        self.last_satd = 0
        self.qpa = p.qp  # qp of the frame being encoded

        # ABR state (x264_ratecontrol_new :268 init values)
        bpf = self.bitrate / self.fps if self.bitrate > 0 else 1.0
        init_cplx = (0.01 * 700000.0 ** self.qcomp)
        self.cplxr_sum = init_cplx * qp2qscale(p.qp) / bpf if bpf else 1.0
        self.wanted_bits_window = init_cplx
        self.short_term_cplxsum = 0.0
        self.short_term_cplxcount = 0.0
        self.total_bits = 0.0
        self.accum_p_qp = 0.0
        self.accum_p_norm = 0.0
        self.last_qscale_for = {t: qp2qscale(p.qp)
                                for t in (SLICE_I, SLICE_P, SLICE_B)}
        self.last_rceq = 1.0
        self.lmin = qp2qscale(p.qp_min if p.qp_min > 0 else 10)
        self.lmax = qp2qscale(p.qp_max)

        # CRF: constant rate factor from the crf "qp-like" knob
        # (ratecontrol.c: rate_factor_constant =
        #  base_cplx^(1-qcomp) / qp2qscale(crf))
        base_cplx = p.mb_width * p.mb_height * 120.0
        self.rate_factor_constant = (base_cplx ** (1.0 - self.qcomp)
                                     / qp2qscale(p.crf)) if p.crf else 1.0

        # VBV
        self.b_vbv = p.vbv_maxrate > 0 and p.vbv_bufsize > 0
        self.buffer_size = p.vbv_bufsize * 1000.0
        self.buffer_rate = p.vbv_maxrate * 1000.0 / self.fps
        self.buffer_fill = self.buffer_size * p.vbv_init
        self.pred = {t: _Pred() for t in (SLICE_I, SLICE_P, SLICE_B)}

        # 2-pass
        self.stat_frames = []        # pass-1 collection
        self.pass2_qscale = None     # pass-2 per-frame plan
        self.expected_bits = None
        if p.stat_in:
            self._init_pass2(p.stat_in)

        # qpfile (x264.c:862 parse_qpfile): frame -> (type, qp)
        self.qpfile = {}
        if p.qpfile:
            for line in open(p.qpfile):
                parts = line.split()
                if len(parts) >= 3:
                    self.qpfile[int(parts[0])] = (parts[1],
                                                  int(parts[2]))

    # ------------------------------------------------------------------
    def forced(self, frame_idx: int):
        """qpfile override: (type_str, qp) or None."""
        return self.qpfile.get(frame_idx)

    def start(self, slice_type: int, satd: int) -> int:
        """Choose the QP for the incoming frame
        (x264_ratecontrol_start + rate_estimate_qscale)."""
        p = self.p
        self.slice_type = slice_type
        self.last_satd = max(1, satd)
        if self.mode == RC_CQP:
            # per-type constants exactly as the reference derives them
            # (ratecontrol.c:369-373): ip/pb offsets are 6*log2 of the
            # factor, added with +0.5 then TRUNCATED (C double->int),
            # so qp 26 / ipratio 1.4 gives I at 23, B at 28
            if slice_type == SLICE_I:
                q = int(clip3(p.qp - 6.0 * math.log2(abs(p.ip_ratio))
                              + 0.5, 0, 51))
            elif slice_type == SLICE_B:
                q = int(clip3(p.qp + 6.0 * math.log2(abs(p.pb_ratio))
                              + 0.5, 0, 51))
            else:
                q = p.qp
            self.qpa = int(clip3(q, p.qp_min, p.qp_max))
            return self.qpa

        if self.pass2_qscale is not None:
            q = self._pass2_qscale_for(self.frame_num)
            # in-loop overflow compensation against the pass-2 plan
            # (rate_estimate_qscale's 2-pass branch: scale by the
            # deviation from expected bits so far)
            if self._expected_so_far > 0:
                abr_buffer = 2.0 * self.rate_tolerance * self.bitrate
                diff = self.total_bits - self._expected_so_far
                q *= clip3(1.0 + diff / max(abr_buffer, 1.0), 0.5, 2.0)
            self._expected_so_far += self._expected_frame_bits.get(
                self.frame_num, self.bitrate / self.fps)
            q = self._clip_vbv(slice_type, q)
            self.qpa = int(clip3(round(qscale2qp(q)), p.qp_min, p.qp_max))
            self.last_qscale_for[slice_type] = q
            return self.qpa

        if slice_type == SLICE_B:
            # B qscale from the last P qscale * pb_factor
            # (rate_estimate_qscale's B branch, simplified to the
            # non-adaptive neighbour-average form)
            q = self.last_qscale_for[SLICE_P] * abs(self.p.pb_ratio)
            q = self._clip_vbv(slice_type, q)
            self.last_qscale_for[SLICE_B] = q
            self.qpa = int(clip3(round(qscale2qp(q)), p.qp_min,
                                 p.qp_max))
            return self.qpa

        # 1-pass: blurred complexity (rate_estimate_qscale)
        self.short_term_cplxsum *= 0.5
        self.short_term_cplxcount *= 0.5
        self.short_term_cplxsum += self.last_satd
        self.short_term_cplxcount += 1.0
        blurred = self.short_term_cplxsum / self.short_term_cplxcount
        self.last_rceq = blurred ** (1.0 - self.qcomp)

        if self.mode == RC_CRF:
            q = self.last_rceq / self.rate_factor_constant
        else:  # ABR
            rate_factor = (self.wanted_bits_window / self.cplxr_sum
                           if self.cplxr_sum > 0 else 1.0)
            q = self.last_rceq / max(rate_factor, 1e-9)
            wanted_bits = (self.frame_num * self.bitrate / self.fps)
            overflow = 1.0
            if wanted_bits > 0:
                abr_buffer = 2.0 * self.rate_tolerance * self.bitrate \
                    * max(1.0, math.sqrt(self.frame_num / 25.0))
                overflow = clip3(
                    1.0 + (self.total_bits - wanted_bits) / abr_buffer,
                    0.5, 2.0)
                q *= overflow

            if (slice_type == SLICE_I and p.keyint_max > 1
                    and self.accum_p_norm > 0):
                # I-frame qp from the running P average (:rate_estimate)
                q = qp2qscale(self.accum_p_qp / self.accum_p_norm) \
                    / abs(self.ip_factor)
            elif self.frame_num > 0:
                lmin = self.last_qscale_for[SLICE_P] / self.lstep
                lmax = self.last_qscale_for[SLICE_P] * self.lstep
                if overflow > 1.1 and self.frame_num > 3:
                    lmax *= self.lstep
                elif overflow < 0.9:
                    lmin /= self.lstep
                q = clip3(q, lmin, lmax)

        q = self._clip_vbv(slice_type, q)
        q = clip3(q, self.lmin, self.lmax)
        self.last_qscale_for[slice_type] = q
        if self.frame_num == 0:
            self.last_qscale_for[SLICE_I] = q * abs(self.ip_factor)
        self.qpa = int(clip3(round(qscale2qp(q)), p.qp_min, p.qp_max))
        return self.qpa

    def _clip_vbv(self, slice_type: int, q: float) -> float:
        """clip_qscale's VBV branch (underflow guard + per-frame cap)."""
        if not self.b_vbv or self.last_satd <= 0:
            return q
        pred = self.pred[slice_type]
        bits = pred.predict(q, self.last_satd)
        if bits > self.buffer_fill / 2.0:
            qf = clip3(self.buffer_fill / (2.0 * bits), 0.2, 1.0)
            q /= qf
            bits *= qf
        # don't drain more than what's actually in the buffer
        max_bits = max(self.buffer_fill - self.buffer_rate * 0.5, 1.0)
        if bits > max_bits:
            q *= bits / max_bits
        return q

    def end(self, bits: int) -> None:
        """Post-frame state update (x264_ratecontrol_end)."""
        t = self.slice_type
        self.total_bits += bits
        qscale = qp2qscale(self.qpa)
        if self.mode in (RC_ABR, RC_CRF) and self.pass2_qscale is None:
            if t != SLICE_B:
                self.cplxr_sum += bits * qscale / max(self.last_rceq, 1e-9)
            self.wanted_bits_window += self.bitrate / self.fps
            if t != SLICE_B:
                self.accum_p_qp *= 0.95
                self.accum_p_norm *= 0.95
                self.accum_p_norm += 1.0
                self.accum_p_qp += self.qpa + \
                    (6.0 * math.log2(abs(self.ip_factor))
                     if t == SLICE_I else 0.0)
        if self.b_vbv:
            self.pred[t].update(qscale, self.last_satd, bits)
            self.buffer_fill += self.buffer_rate - bits
            self.buffer_fill = clip3(self.buffer_fill, 0.0,
                                     self.buffer_size)
        if self.p.stat_out:
            self.stat_frames.append(
                dict(idx=self.frame_num, type="IPB"[t], qp=self.qpa,
                     satd=self.last_satd, bits=int(bits)))
        self.frame_num += 1

    # ------------------------------------------------------------------
    # 2-pass (init_pass2, ratecontrol.c:137)
    # ------------------------------------------------------------------
    def write_stats(self) -> None:
        """Pass-1 stat file (x264_ratecontrol_summary / rc_end write)."""
        if not self.p.stat_out:
            return
        with open(self.p.stat_out, "w") as f:
            for r in self.stat_frames:
                f.write(f"in:{r['idx']} type:{r['type']} qp:{r['qp']} "
                        f"satd:{r['satd']} bits:{r['bits']}\n")

    def _init_pass2(self, path: str) -> None:
        """Read pass-1 stats and plan per-frame qscales so that
        sum(predicted bits) == target (bisection over the global rate
        factor, the core of init_pass2's scale search)."""
        frames = []
        for line in open(path):
            d = {}
            for tok in line.split():
                k, v = tok.split(":")
                d[k] = v
            frames.append(dict(idx=int(d["in"]), type=d["type"],
                               qp=int(d["qp"]), satd=float(d["satd"]),
                               bits=float(d["bits"])))
        if not frames:
            return
        target = self.bitrate / self.fps * len(frames)
        # complexity per frame: bits * qscale (qp-independent measure)
        for fr in frames:
            fr["cplx"] = fr["bits"] * qp2qscale(fr["qp"])
            fr["rceq"] = max(fr["cplx"], 1.0) ** (1.0 - self.qcomp)
            if fr["type"] == "I":
                fr["rceq"] *= abs(self.ip_factor)

        def total_bits(rate_factor):
            tot = 0.0
            for fr in frames:
                q = clip3(fr["rceq"] / rate_factor, self.lmin, self.lmax)
                tot += fr["cplx"] / q  # predicted bits at q
            return tot

        # larger rate_factor => smaller qscale => more bits, so
        # total_bits is increasing in rate_factor: bisect on it.
        lo, hi = 1e-6, 1e6
        for _ in range(60):
            mid = math.sqrt(lo * hi)
            if total_bits(mid) < target:
                lo = mid
            else:
                hi = mid
        rf = math.sqrt(lo * hi)
        self.pass2_qscale = {
            fr["idx"]: clip3(fr["rceq"] / rf, self.lmin, self.lmax)
            for fr in frames}
        self.expected_bits = total_bits(rf)
        self._expected_frame_bits = {
            fr["idx"]: fr["cplx"] / self.pass2_qscale[fr["idx"]]
            for fr in frames}
        self._expected_so_far = 0.0

    def _pass2_qscale_for(self, idx: int) -> float:
        q = self.pass2_qscale.get(idx)
        if q is None:  # more frames than pass 1 saw: reuse last plan
            q = self.last_qscale_for[self.slice_type]
        return q
