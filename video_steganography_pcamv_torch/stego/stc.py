"""Syndrome-Trellis Codes: minimal-cost embedding + syndrome extraction,
bit-parity with the reference embedder.

Reference: upstream embed.h:309-548 (`stc_embed`, the
Filler/Judas/Fridrich STC toolbox embedder). The semantics reproduced
exactly here (verified against an independent C++ twin on random
inputs, tests/test_stc_parity.py):

- Submatrix columns come from the toolbox's hard-coded table for
  heights 7-12 and widths 2-20 (embed.h:11-132 `mats[]`, transcribed as
  data in stc_mats.py), else from the MSVC-rand LCG fallback
  (embed.h:134-139 `myrand`, 214013/2531011 >> 16 & 0x7fff) whose state
  `myholdrand` starts at 1 and PERSISTS across calls — modeled by
  StcState, one per stream (the reference is one process per stream).
- Block widths: invalpha = n/k, shorter = floor, longer = ceil; block j
  takes `longer` iff worm + longer <= (j+1)*invalpha + 0.5
  (embed.h:377-391). Two column sets are generated per call: shorter
  first, then longer (this LCG consumption order matters for parity).
- Forward Viterbi over 2^h f32 prices; the y=1 transition wins ties
  (embed.h:436-467: the path bit is set when the kept price equals the
  flip-arrival price). Message bit j contracts state s -> 2s + m_j
  (embed.h:476-489); the column mask shrinks once per block while
  k - j <= h (embed.h:483-484).
- Backward traceback from state 0 (embed.h:516-538).

The reference never ships an extractor (stc_extract_c.h include is
commented out, analyse.c:43); stc_extract computes the documented
syndrome of the same banded matrix.
"""

from __future__ import annotations

import numpy as np

from .stc_mats import MATS

INF = np.float32(np.inf)


class StcState:
    """The reference's static `myholdrand` (embed.h:134, seeded 1):
    getMatrix's LCG fallback consumes it across calls. One instance per
    stream (encoder and extractor each replay the same sequence)."""

    def __init__(self):
        self.holdrand = 1

    def rand(self) -> int:
        # MSVC CRT rand(): embed.h:136-139
        self.holdrand = (self.holdrand * 214013 + 2531011) & 0xFFFFFFFF
        return (self.holdrand >> 16) & 0x7FFF


def get_matrix(width: int, height: int, state: StcState) -> np.ndarray:
    """Toolbox submatrix columns (embed.h:276-306 getMatrix)."""
    if 2 <= width <= 20 and 7 <= height <= 12:
        return np.array(MATS[height - 7][width - 2], np.uint32)
    if (1 << (height - 2)) < width:
        raise ValueError(
            "Cannot generate matrix for this payload; raise stc_h")
    mask = (1 << (height - 2)) - 1
    bop = (1 << (height - 1)) + 1
    cols: list[int] = []
    while len(cols) < width:
        r = ((state.rand() & mask) << 1) + bop
        if r not in cols:
            cols.append(r)
    return np.array(cols, np.uint32)


def ref_layout(n: int, k: int, h: int, state: StcState):
    """Column sets + per-block widths exactly as the reference builds
    them (embed.h:344-391). Returns (cols_short, cols_long, widths[k],
    use_longer[k]). Raises ValueError when k > n."""
    invalpha = n / k
    if invalpha < 1:
        raise ValueError("message cannot be longer than the cover")
    shorter = int(np.floor(invalpha))
    longer = int(np.ceil(invalpha))
    cols_s = get_matrix(shorter, h, state)   # order matters for the LCG
    # the reference calls getMatrix TWICE even when longer == shorter
    # (embed.h:362-376): on the LCG path the second call consumes the
    # generator and all blocks use the SECOND result (matrices[i] = 1
    # for every i when invalpha is integral)
    cols_l = get_matrix(longer, h, state)
    widths = np.empty(k, np.int32)
    use_longer = np.empty(k, np.uint8)
    worm = 0
    for j in range(k):
        if worm + longer <= (j + 1) * invalpha + 0.5:
            use_longer[j] = 1
            widths[j] = longer
            worm += longer
        else:
            use_longer[j] = 0
            widths[j] = shorter
            worm += shorter
    return cols_s, cols_l, widths, use_longer


def _h_column_ints(n: int, k: int, h: int, state: StcState):
    """Each cover element's parity-check column as a k-bit int:
    element i of block j with (masked) column c contributes bit t of c
    to message bit j + t (the trellis state-bit t carries the parity of
    message bit j + t)."""
    cols_s, cols_l, widths, use_longer = ref_layout(n, k, h, state)
    out = []
    colmask = (1 << h) - 1
    for j in range(k):
        cols = cols_l if use_longer[j] else cols_s
        for t in range(int(widths[j])):
            c = int(cols[t]) & colmask
            out.append(c << j)
        if k - j <= h:
            colmask >>= 1
    return out


def _gf2_rank(col_ints) -> int:
    pivots = {}
    r = 0
    for v in col_ints:
        while v:
            low = v & -v
            p = pivots.get(low)
            if p is None:
                pivots[low] = v
                r += 1
                break
            v ^= p
    return r


def _eff_h(k: int, h: int) -> int:
    """Effective constraint height: min(h, k), floored at 2. For k >= h
    this is h (bit-parity with the reference). For k < h the reference
    is broken (its traceback mask diverges from the forward mask and
    frames fail non-deterministically, embed.h:483 vs :523); reducing
    the height to k makes both masks identical ((2^k-1) >> j at block j)
    and the trellis self-consistent. Deterministic on both sides."""
    return max(2, min(h, k))


def stc_feasible_k(n: int, k: int, h: int, state: StcState) -> int:
    """Largest k' <= k whose parity-check matrix has full rank — i.e.
    every message is embeddable. The reference simply fails the frame
    when the syndrome is out of range (embed.h:495-504 totalprice
    check); a blind extractor cannot observe that, so both sides apply
    this DETERMINISTIC reduction instead (it depends only on
    (n, k, h) and the running LCG word, all of which the extractor
    knows). Probes use clones of `state`; the caller's state advances
    only through the eventual ref_layout of the accepted k'. With the
    self-consistent height _eff_h(k, h), the trellis realizes exactly
    the linear code of the banded matrix, so full rank <=> every
    message embeddable."""
    while k > 0:
        probe = StcState()
        probe.holdrand = state.holdrand
        try:
            r = _gf2_rank(_h_column_ints(n, k, _eff_h(k, h), probe))
        except ValueError:
            # width > 2^(h-2): no matrix exists at this rate (the
            # reference errors out the same way, embed.h:287-290)
            return 0
        if r == k:
            return k
        k = r
    return 0


def stc_embed(cover: np.ndarray, message: np.ndarray, rho: np.ndarray,
              h: int = 10, state: StcState | None = None):
    """Find stego bits y minimizing sum(rho[x != y]) with syndrome(y) ==
    message, reproducing the reference trellis bit-for-bit. Returns
    (stego_bits [n], total_cost)."""
    x = np.asarray(cover, np.uint8)
    m = np.asarray(message, np.uint8)
    costs = np.asarray(rho, np.float32)
    n, k = len(x), len(m)
    if k == 0:
        return x.copy(), 0.0
    if state is None:
        state = StcState()
    h = _eff_h(k, h)
    cols_s, cols_l, widths, use_longer = ref_layout(n, k, h, state)

    n_states = 1 << h
    states = np.arange(n_states)
    price = np.full(n_states, INF, np.float32)
    price[0] = np.float32(0.0)
    # path[i, s]: optimal arrival at state s after element i used y_i=1
    path = np.zeros((n, n_states), bool)

    colmask = n_states - 1
    i = 0
    for j in range(k):
        cols = cols_l if use_longer[j] else cols_s
        for t in range(int(widths[j])):
            col = int(cols[t]) & colmask
            if x[i] == 0:
                c_keep, c_flip = np.float32(0.0), costs[i]
            else:
                c_keep, c_flip = costs[i], np.float32(0.0)
            v_keep = price + c_keep               # y_i = 0, stay
            v_flip = price[states ^ col] + c_flip  # y_i = 1, via column
            # reference tie rule: the flip transition wins equal prices
            # (embed.h:458-467 sets the path bit when min == flip price)
            use1 = v_flip <= v_keep
            price = np.where(use1, v_flip, v_keep)
            path[i] = use1
            i += 1
        # enforce message bit j: new state l <- old state 2l + m_j
        # (embed.h:476-489)
        src = (states << 1) | int(m[j])
        valid = src < n_states
        price = np.where(valid, price[src & (n_states - 1)], INF)
        if k - j <= h:
            colmask >>= 1
    total = float(price[0])
    if not np.isfinite(total):
        raise ValueError("syndrome not in the range of the matrix")

    # backward traceback (embed.h:508-538)
    y = np.zeros(n, np.uint8)
    st = 0
    colmask = 0
    i = n - 1
    for j in range(k - 1, -1, -1):
        cols = cols_l if use_longer[j] else cols_s
        st = (st << 1) | int(m[j])
        if k - j <= h:
            colmask = (colmask << 1) | 1
        for t in range(int(widths[j]) - 1, -1, -1):
            if path[i, st]:
                y[i] = 1
                st ^= int(cols[t]) & colmask
            i -= 1
    assert i == -1 and st == 0, (i, st)
    return y, total


def stc_extract(stego: np.ndarray, k: int, h: int = 10,
                state: StcState | None = None) -> np.ndarray:
    """Recover the k message bits from stego cover bits (blind — the
    banded matrix is deterministic given the running StcState):
    incremental syndrome, LSB after each block."""
    y = np.asarray(stego, np.uint8)
    n = len(y)
    if k == 0:
        return np.zeros(0, np.uint8)
    if state is None:
        state = StcState()
    h = _eff_h(k, h)
    cols_s, cols_l, widths, use_longer = ref_layout(n, k, h, state)
    out = np.zeros(k, np.uint8)
    st = 0
    colmask = (1 << h) - 1
    i = 0
    for j in range(k):
        cols = cols_l if use_longer[j] else cols_s
        for t in range(int(widths[j])):
            if y[i]:
                st ^= int(cols[t]) & colmask
            i += 1
        out[j] = st & 1
        st >>= 1
        if k - j <= h:
            colmask >>= 1
    return out
