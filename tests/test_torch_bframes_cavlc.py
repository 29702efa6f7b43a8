"""CAVLC B slices and `b_adapt` 1 against the JAX reference on seeded
inputs, with no JAX encode: the Python CAVLC B writer against the
reference's for every mb_type code 0-22 at one reference and at two;
the native CAVLC and CABAC B writers against the Python ones on slices
of 16x16 codes, with mvds per MB and per unit; the adaptive-B flag of
every lookahead decision against the reference's. The end-to-end run at
the reference's default Params with `bframes=2` (CAVLC, b_adapt 1
closing a GOP at a cut) is in `tests/test_torch_encoder.py`, whose
default-Params run has already compiled its P programs."""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder.cavlc import (
    FrameCavlc as JFrameCavlc)
from video_steganography_pcamv_tpu.encoder.slicetype import (
    Lookahead as JLookahead)
from video_steganography_pcamv_tpu.params import Params
from video_steganography_pcamv_tpu.utils.bitstream import (
    BitWriter as JBitWriter)

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.encoder.cavlc import FrameCavlc
from video_steganography_pcamv_torch.encoder.slicetype import Lookahead
from video_steganography_pcamv_torch.utils.bitstream import BitWriter

from test_torch_bframes import H, MBH, MBW, W, t_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEFAULTS_B2 = dict(width=W, height=H, bframes=2)


# ---------------------------------------------------------------------------
# The writers
# ---------------------------------------------------------------------------

def _b_syntax(seed, codes_hi=23):
    """Seeded B slice syntax: codes (every code below codes_hi once,
    then random), B_8x8 subs, per-unit mvds, cbps and levels that agree
    with them, per-MB L0 entries."""
    g = np.random.default_rng(seed)
    code = g.integers(0, codes_hi, (MBH, MBW)).astype(np.int32)
    code.reshape(-1)[:codes_hi] = np.arange(codes_hi)
    subs = g.integers(0, 4, (MBH, MBW, 4)).astype(np.int32)
    mvd0 = g.integers(-40, 41, (MBH, MBW, 4, 2)).astype(np.int32)
    mvd1 = g.integers(-40, 41, (MBH, MBW, 4, 2)).astype(np.int32)
    cbp_l = (g.integers(0, 16, (MBH, MBW))
             * (g.random((MBH, MBW)) < 0.6)).astype(np.int32)
    cbp_c = (g.integers(0, 3, (MBH, MBW))
             * (g.random((MBH, MBW)) < 0.6)).astype(np.int32)
    lev = g.integers(-3, 4, (MBH, MBW, 4, 4, 4, 4)) \
        * (g.random((MBH, MBW, 4, 4, 4, 4)) < 0.2)
    lev[0, 0, 0, 0, 0, 0] = 40          # an escape-coded level
    for b8 in range(4):
        off = ((cbp_l >> b8) & 1) == 0
        lev[:, :, 2 * (b8 >> 1):2 * (b8 >> 1) + 2,
            2 * (b8 & 1):2 * (b8 & 1) + 2][off] = 0
    cdc = g.integers(-2, 3, (MBH, MBW, 2, 2, 2)) * (cbp_c > 0)[
        ..., None, None, None]
    cac = g.integers(-2, 3, (MBH, MBW, 2, 2, 2, 4, 4)) \
        * (g.random((MBH, MBW, 2, 2, 2, 4, 4)) < 0.2) \
        * (cbp_c == 2)[..., None, None, None, None, None]
    cac[..., 0, 0] = 0
    res = dict(luma_lev=lev.astype(np.int32), chroma_dc=cdc.astype(np.int32),
               chroma_ac=cac.astype(np.int32), cbp_luma=cbp_l,
               cbp_chroma=cbp_c)
    ref0 = g.integers(0, 2, (MBH, MBW)).astype(np.int32)
    return code, subs, mvd0, mvd1, res, ref0


@pytest.mark.parametrize("num_ref", [1, 2])
def test_cavlc_b_writer_matches_reference(num_ref):
    """mb_skip_run over the residual-free direct MBs, then
    `FrameCavlc.write_b_mb` for codes 0-22 (te(v) ref_idx_l0 at two
    references, none at one), byte for byte."""
    code, subs, mvd0, mvd1, res, ref0 = _b_syntax(40 + num_ref)
    outs = []
    for fc_cls, bw_cls in ((FrameCavlc, BitWriter),
                           (JFrameCavlc, JBitWriter)):
        bw = bw_cls()
        bw.write(5, 0b10110)
        fc = fc_cls(MBW, MBH)
        run = 0
        for my in range(MBH):
            for mx in range(MBW):
                m, cl, cc = (int(code[my, mx]), int(res["cbp_luma"][my, mx]),
                             int(res["cbp_chroma"][my, mx]))
                if m == 0 and cl == 0 and cc == 0:
                    run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(run)
                run = 0
                fc.write_b_mb(bw, mx, my, m, mvd0[my, mx], mvd1[my, mx], cl,
                              cc, res["luma_lev"][my, mx],
                              res["chroma_dc"][my, mx],
                              res["chroma_ac"][my, mx], qp_delta=0,
                              subs=subs[my, mx], ref0=int(ref0[my, mx]),
                              num_ref=num_ref)
        if run:
            bw.write_ue(run)
        bw.rbsp_trailing()
        outs.append(bw.get_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 100


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
def test_native_b_writers_match_python_writers(cabac):
    """A slice of 16x16 codes without an L0 map takes
    `native.write_slice_b` / `native.write_slice_cabac_b`; the same
    slice through the Python writer (an L0 map of zeros at one
    reference, which codes no ref_idx) gives the same bytes, with mvds
    per MB (the 16x16 path) and per unit (the partition path)."""
    kw = dict(DEFAULTS_B2, cabac=cabac)
    enc = TEncoder(t_params(kw), device="cpu")
    code, _subs, mvd0, mvd1, res, _ref0 = _b_syntax(50 + cabac, codes_hi=4)
    write = enc._write_b_slice_cabac if cabac else enc._write_b_slice_cavlc
    outs = []
    for m0, m1 in ((mvd0[:, :, 0], mvd1[:, :, 0]), (mvd0, mvd1)):
        for ref0 in (None, np.zeros((MBH, MBW), np.int32)):
            bw = BitWriter()
            bw.write(7, 0b1011001)
            outs.append(write(bw, res, 30, code, None, m0, m1, ref0, 1))
    assert len(set(outs)) == 1 and len(outs[0]) > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_bad_b_candidate_matches_reference(seed):
    """The b_adapt 1 flag of every decision, IDRs included: keyint
    expiry every 5 frames, cost pairs around the 0.9 ratio."""
    g = np.random.default_rng(seed)
    kw = dict(width=W, height=H, bframes=2, keyint_max=5, keyint_min=2)
    ports, refs = Lookahead(TP.Params(**kw)), JLookahead(Params(**kw))
    for idx in range(1, 30):
        ci = int(g.integers(1000, 5000))
        cp = int(ci * g.choice([0.5, 0.89, 0.9, 0.91, 1.0]))
        assert ports._decide_host(idx, ci, cp) == refs._decide_host(idx, ci,
                                                                   cp)
        assert ports.bad_b_candidate == refs.bad_b_candidate
