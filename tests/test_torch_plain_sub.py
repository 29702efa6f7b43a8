"""The plain encoder (stego off) on the sub-8x8 path (`p4x4`) of the
port against the JAX `Encoder`, on the CPU.

The clip is the reference's `tests/test_rd_sub.py` `_frames` (96x64: a
patch sliding over a static background, so that 8x8 blocks split into
8x4/4x8/4x4 units) with new smooth content pasted into each P frame, so
that the intra compare switches MBs to I16x16/I4x4; me_range 8, qp 26,
the Params of the reference's test. Streams, byte-equal AU by AU to the
reference, with the port's decoder giving the port encoder's recon on
every frame (B frames included):

- rd 0 under CAVLC; ref_frames 2 under CABAC (the host deblock, which
  reads the references); adaptive quantization (no intra compare, no
  re-rank); p4x4 anchors with B frames, and a resume through
  `state.from_reference` after such an anchor with intra MBs. The RD
  re-rank's streams and module are `tests/test_torch_plain_sub_rd.py`'s,
  which shares these helpers (a file of its own, so that the two run on
  different test workers).

The modules, on the inputs the reference's encoder gave them in those
runs: the sub analysis at one and two references with `subpel_sub`'s
per-MB cost. All equalities are exact (integer codec).
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import partition as TPT
from video_steganography_pcamv_torch.state import from_reference

from test_rd_sub import _frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 96, 64
MBW, MBH = W // 16, H // 16


def sub_frames(n=3):
    """`test_rd_sub._frames(n)` with new smooth content in two corners
    of every P frame (a gradient top right, a ramp bottom left)."""
    out = []
    gy, gx = np.mgrid[0:16, 0:32]
    for i, f in enumerate(_frames(n)):
        y = f.y.copy()
        if i:
            y[0:16, 64:96] = (40 * i + 3 * gx + 5 * gy).astype(np.uint8)
            y[48:64, 0:32] = (200 - 20 * i - 4 * gy).astype(np.uint8)
        out.append(Frame(y, f.u, f.v))
    return out


# case -> (frames, Params beyond width/height/qp 26/me_range 8/p4x4)
CASES = {
    "cavlc": (3, {}),
    "ref2_cabac": (3, dict(ref_frames=2, cabac=True)),
    "aq": (3, dict(aq_mode=1)),
    "bframes": (5, dict(bframes=1, b_adapt=0, scenecut_threshold=0)),
}
# the RD re-rank's cases (tests/test_torch_plain_sub_rd.py)
RD_CASES = {
    "rd1": (3, dict(rd=1)),
    # IDR + 1 P: the reference's trellis programs are the slow part here
    "rd2_trellis2_cabac_8x8": (2, dict(rd=2, trellis=2, cabac=True,
                                       transform_8x8=True)),
}
_ALL = dict(CASES, **RD_CASES)


def _kw(case):
    return dict(dict(width=W, height=H, qp=26, me_range=8, p4x4=True),
                **_ALL[case][1])


# the reference's analysis calls in its encodes: (function, args, kwargs,
# outputs) as numpy, per case
_CALLS = {}
_WANT = {}
_CAPTURED = ("analyse_p_frame_sub", "analyse_p_frame_sub_mref",
             "rd_rerank_sub")


def _np(a):
    return None if a is None else np.array(a)


def _reference(case):
    """The JAX Encoder's AUs of `case`, once a module, with its sub
    analysis calls recorded."""
    if case not in _WANT:
        calls = _CALLS.setdefault(case, [])
        saved = {name: getattr(JPT, name) for name in _CAPTURED}

        def recorder(name):
            fn = saved[name]

            def rec(*a, **kw):
                out = fn(*a, **kw)
                calls.append((name, [_np(x) for x in a],
                              {k: _np(v) for k, v in kw.items()},
                              [_np(x) for x in out]))
                return out
            return rec
        try:
            for name in _CAPTURED:
                setattr(JPT, name, recorder(name))
            enc = JEncoder(Params(**_kw(case)))
            frames = sub_frames(_ALL[case][0])
            _WANT[case] = [enc.encode_frame(f) for f in frames] \
                + [enc.flush()]
        finally:
            for name, fn in saved.items():
                setattr(JPT, name, fn)
    return _WANT[case]


def _port_run(case):
    """The port's AUs of `case` and its recon of each input frame (the
    deblocked anchor, or a B frame's own recon)."""
    p = TP.Params(**_kw(case))
    p.tail_kernel = False
    enc = TEncoder(p, device="cpu")
    frames = sub_frames(_ALL[case][0])
    recon = {}
    real = enc._accumulate_psnr

    def keep(frame, y, u, v, recon_=None):
        r = recon_ or enc.recon_prev
        recon[id(frame)] = tuple(x.cpu().numpy() for x in r)
        return real(frame, y, u, v, recon_)
    enc._accumulate_psnr = lambda frame, y, u, v, recon=None: keep(
        frame, y, u, v, recon)
    aus = [enc.encode_frame(f) for f in frames] + [enc.flush()]
    return enc, aus, [recon[id(f)] for f in frames]


def _check_decoded(bs, recons, n):
    """The port's decoder gives the encoder's recon on every frame, in
    display order."""
    dec = decode_annexb(bs)
    assert len(dec) == n
    for i, (d, r) in enumerate(zip(dec, recons)):
        np.testing.assert_array_equal(d.y, r[0][:H, :W], err_msg=str(i))
        np.testing.assert_array_equal(d.u, r[1][:H // 2, :W // 2])
        np.testing.assert_array_equal(d.v, r[2][:H // 2, :W // 2])
    return dec


def check_stream(case):
    """Every AU byte-equal to the reference's; decoded == recon; intra
    MBs in the P frames (and the B frames) wherever the intra compare
    runs (not under AQ), and P_8x8 MBs with sub_mb_types under 8x8."""
    want = _reference(case)
    enc, aus, recons = _port_run(case)
    assert aus == want
    n = _ALL[case][0]
    dec = _check_decoded(b"".join(aus), recons, n)
    kinds = [{m.mb_type for m in d.mbs} for d in dec]
    intra = [bool(k & {"I16x16", "I4x4"}) for k in kinds[1:]]
    if case == "aq":
        assert not any(intra), kinds
    else:
        assert all(intra), kinds
    if case == "bframes":
        assert any(k.startswith("B") for k in kinds[1]), kinds
    part, sub = enc.last_sub
    assert (sub[part == 3] > 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_sub_stream_byte_equal(case):
    """`check_stream` of each case."""
    check_stream(case)


def test_plain_sub_analysis_matches_reference():
    """`analyse_p_frame_sub` (one reference) and
    `analyse_p_frame_sub_mref` (two) on the inputs of the reference's
    encodes, every output: the decision, mv4, the tables and
    `subpel_sub`'s per-MB cost."""
    seen = set()
    for case in ("cavlc", "ref2_cabac"):
        _reference(case)
        for name, a, kw, want in _CALLS[case]:
            if name == "analyse_p_frame_sub":
                y, ref, prev, rng, mbh, mbw, lam = a[:7]
                got = TPT.analyse_p_frame_sub(
                    torch.as_tensor(y), torch.as_tensor(ref).to(torch.uint8),
                    torch.as_tensor(prev), int(rng), int(mbh), int(mbw),
                    int(lam))
            elif name == "analyse_p_frame_sub_mref":
                y, refs, n_valid, prev, rng, mbh, mbw, lam, _sp, nr = a
                got = TPT.analyse_p_frame_sub_mref(
                    torch.as_tensor(y), torch.as_tensor(refs).to(torch.uint8),
                    int(n_valid), torch.as_tensor(prev), int(rng), int(mbh),
                    int(mbw), int(lam), int(nr))
            else:
                continue
            seen.add(name)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            assert (want[-1] > 0).all()
    assert seen == {"analyse_p_frame_sub", "analyse_p_frame_sub_mref"}


def test_plain_sub_resume_after_an_anchor_with_intra_mbs():
    """A port Encoder resumed from the JAX Encoder's state after the
    first GOP (a p4x4 P anchor with intra MBs, whose colocated field the
    next B frame reads with ref -1 there) writes the remaining AUs
    byte-equal."""
    frames = sub_frames(5)
    jenc = JEncoder(Params(**_kw("bframes")))
    head = [jenc.encode_frame(f) for f in frames[:3]]
    assert head[2]          # the first GOP (P anchor + B) is out
    state = from_reference(jenc)
    assert state["bpipe"]["anchor_motion"][2].any()
    want = [jenc.encode_frame(f) for f in frames[3:]] + [jenc.flush()]
    p = TP.Params(**_kw("bframes"))
    p.tail_kernel = False
    tenc = TEncoder(p, device="cpu")
    tenc.load_state(state)
    got = [tenc.encode_frame(f) for f in frames[3:]] + [tenc.flush()]
    assert got == want
