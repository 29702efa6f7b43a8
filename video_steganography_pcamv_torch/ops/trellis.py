"""RD-optimal (trellis) quantization, the reference's `ops/trellis.py`.

x264's `quant_trellis_cabac` (encoder/rdo.c:411-648): a Viterbi DP over
the zigzag positions whose 8 nodes are the CABAC abs-level context
states, scoring SSD (transform domain, weighted back to pixel scale)
plus lambda2 times the CABAC cost of the sig/last/abs-level bins.

As in the reference, the DP runs over every block of the call at once:
[M, 8] node tensors, one step per zigzag position in reverse order, and
a traceback over the recorded [n, M, 8] decision tables. It keeps the
reference's decisions to the bit:
 - scores are float32, each product and sum in the reference's order
   (no fused multiply-add: plain tensor ops, never `addcmul`); lambda2
   / 16 is taken once, exactly (a power-of-two scale commutes with the
   rounding of the product);
 - ties go to the first node in the reference's flat (candidate, node)
   order (`torch.min` over a dim returns the first minimum's index), dead
   nodes score `_INF` = 3e38 / 4;
 - the integer quant and unquant products wrap at 32 bits, as the
   reference computes them (its int64 casts are int32 with JAX's x64
   off);
 - contexts start from the slice-initial P/B model-0 states
   (`init_states(qp, False, 0)`) for every slice type, and the quant
   tables are the encoder's (`ops.cqm.QuantTables`: its CQM lists, as
   the reference's `_mf_unq_zig(cqm_version)` reads the active ones).

Plain PyTorch on every device; the DP's tables are module constants
copied to the caller's device once (`ops.const`), the quant tables are
kept on their `QuantTables`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import const
from . import cqm as CQ
from . import transform as T
from . import transform8 as T8

CABAC_SIZE_BITS = 8          # bit costs in 1/256 bit units
LAMBDA_BITS = 4

# ctxBlockCat ids (cat 5 = 8x8 luma)
(CAT_LUMA_DC, CAT_LUMA_AC, CAT_LUMA_4x4, CAT_CHROMA_DC, CAT_CHROMA_AC,
 CAT_LUMA_8x8) = range(6)
_SIG_OFF = [105, 120, 134, 149, 152, 402]
_LAST_OFF = [166, 181, 195, 210, 213, 417]
_ABS_OFF = [227, 237, 247, 257, 266, 426]
_N = {CAT_LUMA_DC: 16, CAT_LUMA_AC: 15, CAT_LUMA_4x4: 16,
      CAT_CHROMA_DC: 4, CAT_CHROMA_AC: 15, CAT_LUMA_8x8: 64}

# abs-level node machine (spec 9.3.3.1.1.9; rdo.c coeff_abs_level_*)
_LEVEL1_CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int64)
_LEVELGT1_CTX = np.array([5, 5, 5, 5, 6, 7, 8, 9], np.int64)
_LEVEL_TRANS = np.array([[1, 2, 3, 3, 4, 5, 6, 7],
                         [4, 4, 4, 4, 5, 6, 7, 7]], np.int64)
# one-hot of each node's level-1 / level-gt1 state slot: [8, 10]
_L1_HOT = np.arange(10)[None, :] == _LEVEL1_CTX[:, None]
_G1_HOT = np.arange(10)[None, :] == _LEVELGT1_CTX[:, None]
_J8 = np.arange(8, dtype=np.int64)

_INF = float(np.float32(3e38) / 4)


# ---------------------------------------------------------------------------
# Host tables (copies of the reference's)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entropy_tables():
    """(ENT [128,2] int32 1/256-bit costs, TRANS [128,2] int32 packed
    next states) over packed state s = 2*pStateIdx + valMPS."""
    from ..encoder.cabac_tables import TRANS_IDX_MPS, TRANS_IDX_LPS
    alpha = (0.01875 / 0.5) ** (1.0 / 63)
    p_lps = 0.5 * alpha ** np.arange(64)
    c_lps = np.round(-np.log2(p_lps) * 256).astype(np.int64)
    c_mps = np.round(-np.log2(1 - p_lps) * 256).astype(np.int64)
    ent = np.zeros((128, 2), np.int32)
    trans = np.zeros((128, 2), np.int32)
    for ps in range(64):
        for mps in range(2):
            s = 2 * ps + mps
            for b in range(2):
                if b == mps:
                    ent[s, b] = c_mps[ps]
                    trans[s, b] = 2 * int(TRANS_IDX_MPS[ps]) + mps
                else:
                    ent[s, b] = c_lps[ps]
                    nm = mps ^ 1 if ps == 0 else mps
                    trans[s, b] = 2 * int(TRANS_IDX_LPS[ps]) + nm
    return ent, trans


@functools.lru_cache(maxsize=None)
def _unary_tables():
    """cabac_size_unary / cabac_transition_unary twins (rdo.c:318-344):
    cost of the gt1 unary suffix for prefix p (bits 2..p as '1', a
    trailing '0' when p<14) plus the bypass sign bit; packed-state in,
    packed-state out. [15, 128] each."""
    ent, trans = _entropy_tables()
    cost = np.zeros((15, 128), np.int32)
    nxt = np.zeros((15, 128), np.int32)
    for prefix in range(15):
        for s0 in range(128):
            s = s0
            bits = 0
            for _ in range(1, prefix):
                bits += ent[s, 1]
                s = trans[s, 1]
            if 0 < prefix < 14:
                bits += ent[s, 0]
                s = trans[s, 0]
            bits += 1 << CABAC_SIZE_BITS   # bypass sign
            cost[prefix, s0] = bits
            nxt[prefix, s0] = s
    return cost, nxt


@functools.lru_cache(maxsize=None)
def _ctx_state_tables():
    """Packed slice-initial CABAC states for every qp (the P/B model-0
    table), indexed by scan POSITION: sig_c/last_c [52, 6, 64] (cats
    0-4: the identity map clipped to the ctx count; cat 5: the 8x8
    significance maps, cabac.c:551-568) and abs [52, 6, 10]."""
    from ..encoder.cabac_tables import init_states
    from ..encoder.cabac import SIG8_CTX, LAST8_CTX
    absl = np.zeros((52, 6, 10), np.int32)
    sig_c = np.zeros((52, 6, 64), np.int32)
    last_c = np.zeros((52, 6, 64), np.int32)
    for qp in range(52):
        st, mps = init_states(qp, False, 0)
        packed = 2 * st + mps
        for cat in range(6):
            n = _N[cat]
            if cat == CAT_LUMA_8x8:
                for i in range(n):
                    m = min(i, 62)
                    sig_c[qp, cat, i] = packed[402 + SIG8_CTX[m]]
                    last_c[qp, cat, i] = packed[417 + LAST8_CTX[m]]
            else:
                nctx = min(n, 15) if cat != CAT_CHROMA_DC else 3
                for i in range(n):
                    m = min(i, nctx - 1)
                    sig_c[qp, cat, i] = packed[_SIG_OFF[cat] + m]
                    last_c[qp, cat, i] = packed[_LAST_OFF[cat] + m]
            absl[qp, cat] = packed[_ABS_OFF[cat]:_ABS_OFF[cat] + 10]
    return sig_c, last_c, absl


@functools.lru_cache(maxsize=None)
def _lambda2_tab():
    """lambda2 per qp [2, 52] float32 (rdo.c:356-384): row 0 inter
    .85^2 * 2^(qp/3 + 10 - LAMBDA_BITS), row 1 intra .65^2 * ..."""
    qp = np.arange(52)
    inter = np.floor(0.85 * 0.85 * 2.0 ** (qp / 3.0 + 10 - LAMBDA_BITS))
    intra = np.floor(0.65 * 0.65 * 2.0 ** (qp / 3.0 + 10 - LAMBDA_BITS))
    return np.stack([inter, intra]).astype(np.float32)


def _mf_unq_zig(tables=None):
    """4x4 quant MF and direct-inverse unquant in zigzag order, [2, 52,
    16] int32 each (list 0 intra, 1 inter), of the given
    `ops.cqm.QuantTables` (None: flat): the quantizer the encode uses,
    kept on that object. unq = round(2^24 / mf), so (lvl * unq + 128)
    >> 8 inverts lvl = coef * mf >> 16 (rdo.c:405-410)."""
    return CQ.FLAT.zig4() if tables is None else tables.zig4()


def _mf_unq_zig8(tables=None):
    """8x8 quant MF + direct-inverse unquant in zigzag8 order, per list:
    [2, 52, 64] int32 each (the rdo.c unquant8_mf semantics with the
    q/6 shift baked in), of the given tables (None: flat)."""
    return CQ.FLAT.zig8() if tables is None else tables.zig8()


@functools.lru_cache(maxsize=None)
def _weight2_zig8():
    """dct8 weight2 (common/dct.h:67-83: FIX8 of the squared inverse
    DCT8 basis norms, 6 classes on a 4x4-periodic grid), zigzag8 order,
    float32 [64]."""
    cls4 = np.array([[0, 3, 4, 3], [3, 1, 5, 1],
                     [4, 5, 2, 5], [3, 1, 5, 1]])
    vals = np.array([1.00000, 0.78487, 2.56132,
                     0.88637, 1.60040, 1.41850], np.float64)
    w = np.floor(vals * 256 + 0.5)[cls4[np.arange(8)[:, None] % 4,
                                        np.arange(8)[None, :] % 4]]
    zz = T8.ZIGZAG_8x8
    return w[zz[:, 0], zz[:, 1]].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weight2_zig():
    """dct4 weight2 (common/dct.h:55-64: FIX8 of 3.125/1.25/0.5 by
    frequency parity), zigzag order, float32 [16]."""
    w = np.zeros((4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            w[i, j] = [3.125, 1.25, 0.5][(i & 1) + (j & 1)] * 256
    zz = T.ZIGZAG_4x4
    return w[zz[:, 0], zz[:, 1]]


@functools.lru_cache(maxsize=None)
def _dp_tables():
    """The DP's lookup tables as int64 arrays (indices into each other):
    ent/trans [256] (packed state * 2 + bin), ucost/utrans [15 * 128]
    (prefix * 128 + packed state), sig/last [52, 6, 64], abs [52, 6, 10];
    lambda2 / 16 [2, 52] float32 (exact: a power-of-two scale)."""
    ent, trans = _entropy_tables()
    ucost, utrans = _unary_tables()
    sig, last, absl = _ctx_state_tables()
    i64 = lambda t: np.ascontiguousarray(t, np.int64).reshape(t.shape)
    return dict(ent=i64(ent).reshape(-1), trans=i64(trans).reshape(-1),
                ucost=i64(ucost).reshape(-1), utrans=i64(utrans).reshape(-1),
                sig=i64(sig), last=i64(last), abs=i64(absl),
                lam16=(_lambda2_tab() / np.float32(16)).astype(np.float32))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value (the reference's
    products wrap at 32 bits)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _ue_big_bits(v: torch.Tensor) -> torch.Tensor:
    """bs_size_ue_big(v) << 8 for v >= 0: (2 * bitlen(v + 1) - 1) << 8.
    The bit length is frexp's exponent, exact in float64 for int32."""
    nb = torch.frexp((v + 1).to(torch.float64))[1].to(torch.int64)
    return (2 * nb - 1) << CABAC_SIZE_BITS


# ---------------------------------------------------------------------------
# The DP
# ---------------------------------------------------------------------------

def trellis_quant(zz: torch.Tensor, qp, cat: int, intra: bool,
                  tables=None) -> torch.Tensor:
    """Trellis-quantize zigzag-ordered coefficient vectors.

    zz: [M, n] int32 transform coefficients in scan order (n = 16 for
    LUMA_DC/LUMA_4x4, 15 for *_AC (scan positions 1..15), 4 for
    CHROMA_DC, 64 for LUMA_8x8). qp: an int, or an [M] tensor of
    per-row qps. tables: the encoder's `ops.cqm.QuantTables` (None:
    flat), whose class's quantizer the DP rates against. Returns [M, n]
    int32 signed levels on zz's device.

    Everything that depends on the position alone (the candidate levels,
    their SSD, the flag and Exp-Golomb bits, the contexts they lead to,
    which rows take part) is computed for all positions before the scan,
    so that a step runs only what depends on the node states."""
    n = _N[cat]
    if zz.dim() != 2 or zz.shape[1] != n:
        raise ValueError("trellis_quant: cat %d takes [M, %d], got %s"
                         % (cat, n, tuple(zz.shape)))
    off = 1 if cat in (CAT_LUMA_AC, CAT_CHROMA_AC) else 0
    dc = cat in (CAT_LUMA_DC, CAT_CHROMA_DC)
    dev = zz.device
    m = zz.shape[0]
    i64, f32 = torch.int64, torch.float32
    if m == 0:
        return torch.zeros((0, n), dtype=torch.int32, device=dev)

    tab = _dp_tables()
    ent, trans = const(tab["ent"], dev), const(tab["trans"], dev)
    ucost, utrans = const(tab["ucost"], dev), const(tab["utrans"], dev)
    if isinstance(qp, torch.Tensor):
        qp_b = qp.to(dev, i64).reshape(-1).expand(m)
    else:
        qp_b = torch.full((m,), int(qp), dtype=i64, device=dev)
    lam16 = const(tab["lam16"], dev)[1 if intra else 0][qp_b]     # [M] f32
    li = 0 if intra else 1
    qt = CQ.FLAT if tables is None else tables
    if cat == CAT_LUMA_8x8:
        mf = qt.dev("zig8mf", dev)[li][qp_b].to(i64)            # [M, 64]
        unq = qt.dev("zig8unq", dev)[li][qp_b].to(i64)
        w = const(_weight2_zig8(), dev)
    else:
        mf = qt.dev("zig4mf", dev)[li][qp_b].to(i64)            # [M, 16]
        unq = qt.dev("zig4unq", dev)[li][qp_b].to(i64)
        if dc:
            mf = (mf[:, :1] >> 1).expand(m, n)
            unq = (unq[:, :1] << 1).expand(m, n)
            w = torch.full((n,), 256.0, dtype=f32, device=dev)
        else:
            mf, unq = mf[:, off:off + n], unq[:, off:off + n]
            w = const(_weight2_zig(), dev)[off:off + n]
    sig_st = const(tab["sig"], dev)[qp_b, cat, :n]    # [M, n] per POS
    last_st = const(tab["last"], dev)[qp_b, cat, :n]
    abs_st0 = const(tab["abs"], dev)[qp_b, cat]       # [M, 10]

    zz = zz.to(torch.int32)
    a = torch.abs(zz)                                  # [M, n] int32
    sgn = torch.sign(zz)
    q = (_wrap32(a.to(i64) * mf + (1 << 15)) >> 16)    # int32 values
    idxs = torch.arange(n, device=dev)
    lastnz = torch.where(q > 0, idxs, -1).amax(1)      # [M]

    # per position, every row: [M, n, ...]
    act = lastnz[:, None] >= idxs                      # the row takes part
    qz = q == 0
    upd = act & ~qz                                    # the q > 0 step
    act_qz = (act & qz)[:, :, None]                    # the q == 0 step
    upd3 = upd[:, :, None]
    cands = torch.stack([q, torch.clamp(q - 1, min=0)], dim=2)  # [M,n,2]
    unq_lvl = (_wrap32(cands * unq[:, :, None] + 128) >> 8).to(f32)
    d = a.to(f32)[:, :, None] - unq_lvl
    ssd = (d * d * w[None, :, None])[..., None]         # [M, n, 2, 1]
    prefix = torch.clamp(cands - 1, max=14)
    gt = (prefix > 0)[..., None]                       # [M, n, 2, 1]
    gt_bin = gt.to(i64)
    pfx128 = 128 * torch.clamp(prefix, 0, 14)[..., None]
    nonzero = (cands > 0)[..., None]                   # [M, n, 2, 1]
    big = torch.where(cands >= 15, _ue_big_bits(cands - 15), 0)
    cost_sig = ent.reshape(128, 2)[sig_st]             # [M, n, 2]
    cost_last = ent.reshape(128, 2)[last_st]
    cost_sig[:, n - 1] = 0                             # the final position
    cost_last[:, n - 1] = 0
    j8 = const(_J8, dev)
    jpos = j8 > 0
    # the q == 0 step: nodes j > 0 pay sig(0)
    zero_inc = torch.where(jpos, (cost_sig[:, :, 0].to(f32)
                                  * lam16[:, None])[..., None], 0.0)
    # a nonzero candidate's flag bits (sig(1) + last(node 0 ? 1 : 0))
    # and its Exp-Golomb suffix; a zero one's sig(0) on nodes j > 0
    j0 = ~jpos
    flag_big = (cost_sig[:, :, 1, None] + torch.where(
        j0, cost_last[:, :, 1, None], cost_last[:, :, 0, None])
    )[:, :, None, :] + big[..., None]                  # [M, n, 2, 8]
    zero_bits = torch.where(j0, 0, cost_sig[:, :, 0, None])[:, :, None, :]
    # the node each (candidate, previous node) leads to, as the [8, 16]
    # match of target node t against flat candidate c * 8 + j
    lvl_trans = const(_LEVEL_TRANS, dev)
    next_ctx = torch.where(nonzero, lvl_trans[(cands > 1).to(i64)], j8)
    leads = next_ctx.reshape(m, n, 1, 16) == j8[:, None]   # [M, n, 8, 16]
    l1c = const(_LEVEL1_CTX, dev)
    g1c = const(_LEVELGT1_CTX, dev)
    l1_hot = const(_L1_HOT, dev)
    g1_hot = const(_G1_HOT, dev)

    scores = torch.full((m, 8), _INF, dtype=f32, device=dev)
    scores[:, 0] = 0.0
    states = abs_st0[:, None, :].expand(m, 8, 10).contiguous()
    e_lev, e_prev = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        l1_state = states[:, j8, l1c][:, None, :]           # [M, 1, 8]
        g1_state = states[:, j8, g1c][:, None, :]
        l1_idx = 2 * l1_state + gt_bin[:, i]                # [M, 2, 8]
        u_idx = pfx128[:, i] + g1_state
        lvl_bits = ent[l1_idx] + torch.where(gt[:, i], ucost[u_idx],
                                             1 << CABAC_SIZE_BITS)
        bits = torch.where(nonzero[:, i], flag_big[:, i] + lvl_bits,
                           zero_bits[:, i])
        cand_scores = scores[:, None, :] + ssd[:, i] \
            + bits.to(f32) * lam16[:, None, None]           # [M, 2, 8]
        upd_l1 = torch.where(nonzero[:, i], trans[l1_idx], l1_state)
        upd_g1 = torch.where(gt[:, i], utrans[u_idx], g1_state)
        cand_states = torch.where(
            l1_hot, upd_l1[..., None],
            torch.where(g1_hot, upd_g1[..., None], states[:, None]))
        masked = torch.where(leads[:, i], cand_scores.reshape(m, 1, 16),
                             _INF)                          # [M, 8, 16]
        new_scores, win = torch.min(masked, dim=2)          # first minimum
        new_states = torch.gather(cand_states.reshape(m, 16, 10), 1,
                                  win[:, :, None].expand(m, 8, 10))
        lev_sel = torch.where(win >= 8, cands[:, i, 1:], cands[:, i, :1])
        prev_sel = win % 8
        scores = torch.where(upd3[:, i], new_scores, torch.where(
            act_qz[:, i], scores + zero_inc[:, i], scores))
        states = torch.where(upd3[:, i, :, None], new_states, states)
        e_lev[i] = torch.where(upd3[:, i], lev_sel, 0)
        e_prev[i] = torch.where(upd3[:, i], prev_sel, j8)

    node = torch.argmin(scores, dim=1)[:, None]                # [M, 1]
    levs = []
    for i in range(n):
        levs.append(torch.gather(e_lev[i], 1, node))
        node = torch.gather(e_prev[i], 1, node)
    return (torch.cat(levs, dim=1) * sgn).to(torch.int32)
