"""Blind payload extraction from a coded bitstream.

The reference never shipped its extractor (stc_extract_c.h include is
commented out, upstream encoder/analyse.c:43); this implements
the documented recovery path (SURVEY.md §0): decode the MV field of each
P frame, take LSB(mvx+mvy) per coded MV in coding order, and run the STC
syndrome with the shared key/height/rate.
"""

from __future__ import annotations

import numpy as np

from ..decoder import decode_annexb
from .stc import stc_extract, stc_feasible_k, StcState


def cover_bits_of_frame(frame) -> np.ndarray:
    """LSB(mvx+mvy) of every partition-unit MV of coded (non-skip)
    inter MBs, coding order (reference cover walk,
    encoder/encoder.c:1566-1647: P_L0 16x16/16x8/8x16 + P_8x8)."""
    bits = []
    for m in frame.mbs:
        if m.mb_type in ("P16x16", "P16x8", "P8x16", "P8x8"):
            for mv in (m.unit_mvs or [m.mv]):
                bits.append((mv[0] + mv[1]) & 1)
    return np.array(bits, np.uint8)


def extract_from_stream(data: bytes, em_rate: float, key: int = 0,
                        stc_h: int = 10) -> list[np.ndarray]:
    """Recover per-P-frame messages from an Annex-B stream. Extraction
    is blind and keyless (the parity-check matrix is deterministic:
    toolbox table + the persistent LCG replayed in frame order exactly
    as the embedder consumed it); `key` is kept for API compatibility
    but only guards the message PRNG on the embed side."""
    return extract_from_frames(decode_annexb(data), em_rate, stc_h)


def extract_from_frames(frames, em_rate: float,
                        stc_h: int = 10) -> list[np.ndarray]:
    """`extract_from_stream` on the stream's decoded frames (the
    `decode_annexb` output), for a caller that decodes anyway."""
    out = []
    state = StcState()  # replays the embedder's matrix sequence
    for frame in frames:
        if frame.slice_type not in (0, 5):
            continue   # covers live only in P slices (encoder.c:1276)
        cov = cover_bits_of_frame(frame)
        n_cov = len(cov)
        an = int(em_rate) if em_rate > 1 else int(em_rate * n_cov)
        an = min(an, n_cov)
        # mirror the embedder's deterministic feasibility reduction
        an = stc_feasible_k(n_cov, an, stc_h, state)
        if an <= 0:
            out.append(np.zeros(0, np.uint8))
            continue
        out.append(stc_extract(cov, an, h=stc_h, state=state))
    return out
