"""Partition-aware host scan: MVP / P_SKIP / mvd at 4x4 granularity
(a copy of the reference's encoder/scan.py, numpy only).

Reference: x264_mb_predict_mv (common/macroblock.c:28-145) and
x264_mb_predict_mv_pskip (:165), generalized from the 16x16-only scan
in encoder/inter.py. The MV field lives on the 4x4 block grid (the
reference's cache.mv), so neighbour lookups (A/B/C with D fallback)
work for any partition shape, including the in-MB sub-block cases of
P_8x8 (a BR sub-block's C is the not-yet-decoded area -> D fallback,
exactly as the cache availability encodes it).

This is cheap serial integer work — host-side by design (the reference
runs it inside the MB loop). The native library's `pcamv_scan_p_parts`
is the C++ twin of `scan_p_frame`; the sub-8x8 scans
(`scan_p_frame_sub`, `scan_p_frame_sub_forced`) run here.
"""

from __future__ import annotations

import numpy as np

from .partition import D_16x16, D_16x8, D_8x16, D_8x8

# unit geometry per partition type: (y4_off, x4_off, w4, h4) per unit
UNIT_GEOM = {
    D_16x16: [(0, 0, 4, 4)],
    D_16x8: [(0, 0, 4, 2), (2, 0, 4, 2)],
    D_8x16: [(0, 0, 2, 4), (0, 2, 2, 4)],
    D_8x8: [(0, 0, 2, 2), (0, 2, 2, 2), (2, 0, 2, 2), (2, 2, 2, 2)],
}

# sub_mb_type (spec 7.4.5.2 P table: 0=P_L0_8x8, 1=8x4, 2=4x8, 3=4x4).
# Geometry relative to the 8x8 block, in 4x4 units: (oy4, ox4, w4, h4),
# coding order (reference mvd order: x264_cabac_mb8x8_mvd writes 4*i+0 /
# 4*i+2 for 8x4 and 4*i+0 / 4*i+1 for 4x8, encoder/cabac.c:470-495).
SUB_GEOM = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (1, 0, 2, 1)],
    2: [(0, 0, 1, 2), (0, 1, 1, 2)],
    3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
}
N_SUB = (1, 2, 2, 4)


def mb_units(part: int, subs=None):
    """Unit geometry of one MB in coding order: list of
    (y4_off, x4_off, w4, h4). subs: [4] sub_mb_types (used iff
    part == D_8x8 and sub splits are in play; None = all P_L0_8x8)."""
    if part != D_8x8:
        return UNIT_GEOM[part]
    out = []
    for b in range(4):
        boy, box = 2 * (b >> 1), 2 * (b & 1)
        st = 0 if subs is None else int(subs[b])
        for (soy, sox, w4, h4) in SUB_GEOM[st]:
            out.append((boy + soy, box + sox, w4, h4))
    return out


class _Grid:
    """4x4-granularity MV field + ref field + decoded mask."""

    def __init__(self, mbh, mbw):
        self.h4, self.w4 = 4 * mbh, 4 * mbw
        self.mv = np.zeros((self.h4, self.w4, 2), np.int32)
        self.ref = np.full((self.h4, self.w4), -1, np.int32)
        self.dec = np.zeros((self.h4, self.w4), bool)

    def nb(self, y4, x4):
        """(mv, ref, available) of block (y4, x4); unavailable = out of
        frame or not yet decoded (x264 cache ref == -2)."""
        if 0 <= y4 < self.h4 and 0 <= x4 < self.w4 and self.dec[y4, x4]:
            return self.mv[y4, x4], int(self.ref[y4, x4]), True
        return np.zeros(2, np.int32), -1, False

    def commit(self, y4, x4, h4, w4, mv, ref=0):
        self.mv[y4:y4 + h4, x4:x4 + w4] = mv
        self.ref[y4:y4 + h4, x4:x4 + w4] = ref
        self.dec[y4:y4 + h4, x4:x4 + w4] = True


def _median3(a, b, c):
    return np.median(np.stack([a, b, c]), axis=0).astype(np.int32)


def unit_mvp(g: _Grid, y4, x4, w4, part, unit, ref=0):
    """MVP for one partition unit (spec 8.4.1.3; macroblock.c:28-145).
    With multiple references the 'same ref' rules are live: the
    directional 16x8/8x16 shortcuts and the exactly-one-match rule
    compare refIdx (x264 keeps refs in the same cache)."""
    mva, ra, av_a = g.nb(y4, x4 - 1)
    mvb, rb, av_b = g.nb(y4 - 1, x4)
    mvc, rc, av_c = g.nb(y4 - 1, x4 + w4)
    if not av_c:
        mvc, rc, av_c = g.nb(y4 - 1, x4 - 1)   # D substitution
    # partition shortcuts (macroblock.c:88-103): require same ref
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
    return _median3(mva, mvb, mvc)


def _pskip_mv(g: _Grid, y4, x4):
    """P_SKIP MV (spec 8.4.1.1; macroblock.c:165): zero when A/B is
    missing or is a zero-MV *ref-0* neighbour, else the ref-0 MVP."""
    mva, ra, av_a = g.nb(y4, x4 - 1)
    mvb, rb, av_b = g.nb(y4 - 1, x4)
    if not av_a or not av_b:
        return np.zeros(2, np.int32)
    if ((ra == 0 and mva[0] == 0 and mva[1] == 0)
            or (rb == 0 and mvb[0] == 0 and mvb[1] == 0)):
        return np.zeros(2, np.int32)
    return unit_mvp(g, y4, x4, 4, D_16x16, 0, ref=0)


def _unit_mv(mv8, my, mx, part, unit):
    """The unit's MV from the per-8x8 field (uniform across members)."""
    g = UNIT_GEOM[part][unit]
    return mv8[2 * my + g[0] // 2, 2 * mx + g[1] // 2].copy()


def scan_p_frame(part: np.ndarray, mv8: np.ndarray,
                 cbp_luma: np.ndarray, cbp_chroma: np.ndarray,
                 intra: np.ndarray | None = None,
                 ref8: np.ndarray | None = None):
    """Raster scan over a partitioned P frame.

    part: [mbh,mbw] in {0..3}; mv8: [2mbh,2mbw,2] qpel (uniform per
    unit); cbp_*: [mbh,mbw]; intra: optional mask — intra MBs carry no
    MVs and are unavailable for prediction (x264 cache ref == -1);
    ref8: optional [2mbh,2mbw] per-8x8 L0 refs (None = all 0).
    Returns (skip [mbh,mbw] bool, mvd [mbh,mbw,4,2], mvp [mbh,mbw,4,2],
    final_mv8 [2mbh,2mbw,2] with pskip MVs substituted)."""
    mbh, mbw = part.shape
    g = _Grid(mbh, mbw)
    skip = np.zeros((mbh, mbw), bool)
    mvd = np.zeros((mbh, mbw, 4, 2), np.int32)
    mvp_out = np.zeros((mbh, mbw, 4, 2), np.int32)
    final = mv8.copy()
    for my in range(mbh):
        for mx in range(mbw):
            if intra is not None and intra[my, mx]:
                # intra neighbours are AVAILABLE with mv 0 / ref -1
                # (x264 cache ref -1 vs -2 for outside,
                # macroblock.c:28-46; spec 8.4.1.3: only truly
                # unavailable neighbours trigger the C->D fallback,
                # the lone-A rule, and the P_SKIP zero-forcing)
                g.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)
                continue
            y4, x4 = 4 * my, 4 * mx
            p = int(part[my, mx])
            if p == D_16x16:
                ps = _pskip_mv(g, y4, x4)
                here = mv8[2 * my, 2 * mx]
                r0 = 0 if ref8 is None else int(ref8[2 * my, 2 * mx])
                if (cbp_luma[my, mx] == 0 and cbp_chroma[my, mx] == 0
                        and r0 == 0
                        and here[0] == ps[0] and here[1] == ps[1]):
                    skip[my, mx] = True
            for u, (oy, ox, w4, h4) in enumerate(UNIT_GEOM[p]):
                r = (0 if ref8 is None
                     else int(ref8[2 * my + oy // 2, 2 * mx + ox // 2]))
                mvp = unit_mvp(g, y4 + oy, x4 + ox, w4, p, u, ref=r)
                mv = _unit_mv(mv8, my, mx, p, u)
                mvd[my, mx, u] = mv - mvp
                mvp_out[my, mx, u] = mvp
                g.commit(y4 + oy, x4 + ox, h4, w4, mv, ref=r)
    return skip, mvd, mvp_out, final


def scan_p_frame_sub(part: np.ndarray, sub_type: np.ndarray,
                     mv4: np.ndarray, cbp_luma: np.ndarray,
                     cbp_chroma: np.ndarray,
                     intra: np.ndarray | None = None,
                     ref8: np.ndarray | None = None):
    """Raster scan over a P frame with sub-8x8 partitions.

    part: [mbh,mbw] in {0..3}; sub_type: [mbh,mbw,4] sub_mb_type per
    8x8 block (z-order, meaningful where part == D_8x8); mv4:
    [4mbh,4mbw,2] qpel MVs at 4x4 granularity (uniform within each
    unit). Returns (skip [mbh,mbw] bool, mvd [mbh,mbw,16,2] coding-
    order unit mvds, mvp [mbh,mbw,16,2], final_mv4). The MVP partition
    shortcuts apply only to 16x8/8x16 MB partitions (macroblock.c:
    88-103); sub-units always take the median path."""
    mbh, mbw = part.shape
    g = _Grid(mbh, mbw)
    skip = np.zeros((mbh, mbw), bool)
    mvd = np.zeros((mbh, mbw, 16, 2), np.int32)
    mvp_out = np.zeros((mbh, mbw, 16, 2), np.int32)
    final = mv4.copy()
    for my in range(mbh):
        for mx in range(mbw):
            if intra is not None and intra[my, mx]:
                g.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)  # see above
                continue
            y4, x4 = 4 * my, 4 * mx
            p = int(part[my, mx])
            if p == D_16x16:
                r0 = (0 if ref8 is None else int(ref8[2 * my, 2 * mx]))
                ps = _pskip_mv(g, y4, x4)
                here = mv4[y4, x4]
                if (cbp_luma[my, mx] == 0 and cbp_chroma[my, mx] == 0
                        and r0 == 0
                        and here[0] == ps[0] and here[1] == ps[1]):
                    skip[my, mx] = True
            for u, (oy, ox, w4, h4) in enumerate(
                    mb_units(p, sub_type[my, mx])):
                r = (0 if ref8 is None
                     else int(ref8[2 * my + oy // 2, 2 * mx + ox // 2]))
                mvp = unit_mvp(g, y4 + oy, x4 + ox, w4, p, u, ref=r)
                mv = mv4[y4 + oy, x4 + ox].copy()
                mvd[my, mx, u] = mv - mvp
                mvp_out[my, mx, u] = mvp
                g.commit(y4 + oy, x4 + ox, h4, w4, mv, ref=r)
    return skip, mvd, mvp_out, final


def scan_p_frame_sub_forced(part: np.ndarray, sub_type: np.ndarray,
                            mv4: np.ndarray, skip: np.ndarray,
                            ref8: np.ndarray | None = None):
    """Stego pass-2 scan at 4x4 granularity (sub-8x8-aware twin of
    scan_p_frame_forced). ref8: optional [2mbh,2mbw] per-8x8 L0 refs
    (multi-ref; flips alternate MVs, never refs — the pass-1 refs are
    re-committed so the ref-matched MVP rules stay live)."""
    mbh, mbw = part.shape
    g = _Grid(mbh, mbw)
    mvd = np.zeros((mbh, mbw, 16, 2), np.int32)
    mvp_out = np.zeros((mbh, mbw, 16, 2), np.int32)
    final = mv4.copy()
    for my in range(mbh):
        for mx in range(mbw):
            y4, x4 = 4 * my, 4 * mx
            p = int(part[my, mx])
            if skip[my, mx]:
                ps = _pskip_mv(g, y4, x4)
                final[y4:y4 + 4, x4:x4 + 4] = ps
                g.commit(y4, x4, 4, 4, ps)
                continue
            for u, (oy, ox, w4, h4) in enumerate(
                    mb_units(p, sub_type[my, mx])):
                r = (0 if ref8 is None
                     else int(ref8[2 * my + oy // 2, 2 * mx + ox // 2]))
                mvp = unit_mvp(g, y4 + oy, x4 + ox, w4, p, u, ref=r)
                mv = final[y4 + oy, x4 + ox].copy()
                mvd[my, mx, u] = mv - mvp
                mvp_out[my, mx, u] = mvp
                g.commit(y4 + oy, x4 + ox, h4, w4, mv, ref=r)
    return final, mvd, mvp_out


def pskip_field(part: np.ndarray, mv8: np.ndarray,
                skip: np.ndarray, ref8: np.ndarray | None = None):
    """Per-MB P_SKIP MV under the committed field: the MV each MB
    would take if forced to skip (an approximation for the RD-skip
    decision — the forced rescan re-derives exactly). mv8 is the FINAL
    field (detected skips already carry their pskip MVs)."""
    mbh, mbw = part.shape
    g = _Grid(mbh, mbw)
    out = np.zeros((mbh, mbw, 2), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            y4, x4 = 4 * my, 4 * mx
            out[my, mx] = _pskip_mv(g, y4, x4)
            if skip[my, mx]:
                g.commit(y4, x4, 4, 4, mv8[2 * my, 2 * mx], ref=0)
                continue
            pt = int(part[my, mx])
            for u, (oy, ox, w4, h4) in enumerate(UNIT_GEOM[pt]):
                r = (0 if ref8 is None
                     else int(ref8[2 * my + oy // 2, 2 * mx + ox // 2]))
                g.commit(y4 + oy, x4 + ox, h4, w4,
                         mv8[2 * my + oy // 2, 2 * mx + ox // 2], ref=r)
    return out


def scan_p_frame_forced(part: np.ndarray, mv8: np.ndarray,
                        skip: np.ndarray,
                        ref8: np.ndarray | None = None,
                        intra: np.ndarray | None = None):
    """Stego pass-2 scan: skip flags FORCED to pass-1 (analyse.c:2658
    forcing); skipped MBs take the pskip MV in the NEW context; coded
    units keep their (possibly flipped) MVs. intra: optional mask —
    intra MBs carry no MVs and stay uncommitted (same neighbour
    convention as scan_p_frame; omitting it desyncs the mvds of MBs
    whose A/B/C neighbours are intra). Returns (final_mv8, mvd,
    mvp)."""
    mbh, mbw = part.shape
    g = _Grid(mbh, mbw)
    mvd = np.zeros((mbh, mbw, 4, 2), np.int32)
    mvp_out = np.zeros((mbh, mbw, 4, 2), np.int32)
    final = mv8.copy()
    for my in range(mbh):
        for mx in range(mbw):
            if intra is not None and intra[my, mx]:
                g.commit(4 * my, 4 * mx, 4, 4, 0, ref=-1)  # see above
                continue
            y4, x4 = 4 * my, 4 * mx
            p = int(part[my, mx])
            if skip[my, mx]:
                ps = _pskip_mv(g, y4, x4)
                final[2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = ps
                g.commit(y4, x4, 4, 4, ps, ref=0)
                continue
            for u, (oy, ox, w4, h4) in enumerate(UNIT_GEOM[p]):
                r = (0 if ref8 is None
                     else int(ref8[2 * my + oy // 2, 2 * mx + ox // 2]))
                mvp = unit_mvp(g, y4 + oy, x4 + ox, w4, p, u, ref=r)
                gy, gx = 2 * my + oy // 2, 2 * mx + ox // 2
                mv = final[gy, gx].copy()
                mvd[my, mx, u] = mv - mvp
                mvp_out[my, mx, u] = mvp
                g.commit(y4 + oy, x4 + ox, h4, w4, mv, ref=r)
    return final, mvd, mvp_out
