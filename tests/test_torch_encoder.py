"""The whole ported serving slice (its CPU branch, tail_kernel=False)
vs the JAX reference Encoder on the CPU: byte-equal Annex-B streams,
decoded alike by the port's decoder and the reference's, payload
recovered alike by the port's blind extractor and the reference's. Also
resumes the port mid-stream from a live reference encoder
(`state.from_reference`) with a pipelined frame still pending, and
requires the rest of the stream to be byte-equal; and a cropped 120x72
frame, whose padded edge MBs B1 and B9 search. The port's Encoder is
given the port's own Params built from the same keyword arguments.

The reference's default Params (PSNR on, host deblock: the fused step
unpipelined), with SSIM and with `pipeline=False`, give the same stream
and the same `close()` dict (PSNR exactly, SSIM to rtol 1e-5, its
float32 sum's order) frame by frame, and the same stream as the
pipelined serving Params. CABAC streams are byte-equal too, the port's
decoder reproduces the JAX decoder's frames and MV fields on them, a
low-QP case takes the lean level buffer's exact fallback, and a resumed
unpipelined CABAC encoder ends with the reference's stream and stats."""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import (
    decode_annexb as j_decode)
from video_steganography_pcamv_tpu.decoder import decode_annexb
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import (
    decode_annexb as t_decode)
from video_steganography_pcamv_torch.encoder import core as TCORE
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames, extract_from_stream as t_extract)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 112, 80
EM_RATE, KEY = 64, 99


def _seq(n, seed=1, w=W, h=H):
    rng = np.random.RandomState(seed)
    big = rng.randint(30, 226, ((h + 64) // 4, (w + 64) // 4))
    big = np.repeat(np.repeat(big, 4, 0), 4, 1).astype(np.uint8)
    frames = []
    for i in range(n):
        f = big[16 + i:16 + i + h, 16 + 2 * i:16 + 2 * i + w].copy()
        u = np.full((h // 2, w // 2), 120 + i, np.uint8)
        frames.append(Frame(f, u, u.copy()))
    return frames


def _params(params=Params, stego=StegoParams, **kw):
    """bench.py's serving Params, analyse-tail kernels off."""
    kw = dict(dict(width=W, height=H, qp=26, me_range=16,
                   deblock_device=True, psnr=False), **kw)
    p = params(stego=stego(em_rate=EM_RATE, key=KEY), **kw)
    p.tail_kernel = False
    p.pipeline_deep = False
    return p


def _tparams(**kw):
    return _params(TP.Params, TP.StegoParams, **kw)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


@pytest.fixture(scope="module")
def serving_reference():
    """One JAX run of the serving Params over _seq(6), shared: its
    stream, and its state after frame 3 (a pipelined frame pending)."""
    frames = _seq(6)
    jenc = JEncoder(_params())
    head = b"".join(jenc.encode_frame(f) for f in frames[:3])
    assert jenc._pending_p is not None
    state = from_reference(jenc)
    tail = _run(jenc, frames[3:])
    return dict(frames=frames, head=head, tail=tail, state=state,
                i_frames=jenc.stats.i_frames)


@pytest.mark.parametrize("kw", [
    {}, {"keyint_max": 3},
    {"chroma_qp_offset": -2, "deblock_alpha": 2, "deblock_beta": -1}],
    ids=["ippppp", "keyint3", "deblock_offsets"])
def test_stream_byte_equal_and_payload(kw, request):
    frames = _seq(6)
    if kw:
        jenc = JEncoder(_params(**kw))
        want, want_i = _run(jenc, frames), jenc.stats.i_frames
    else:
        ref = request.getfixturevalue("serving_reference")
        want, want_i = ref["head"] + ref["tail"], ref["i_frames"]
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i_frames == want_i
    assert (tenc.stats.i_frames > 1) == ("keyint_max" in kw)
    dec = t_decode(got)
    assert len(decode_annexb(got)) == len(dec) == len(frames)
    sent = tenc._stego.sent_messages
    for rec in (extract_from_stream(got, em_rate=EM_RATE, key=KEY),
                extract_from_frames(dec, em_rate=EM_RATE)):
        assert len(rec) == len(sent) and sum(len(s) for s in sent) > 0
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def test_cropped_120x72_stream_byte_equal_and_payload():
    """120x72 is not a multiple of 16: the SPS crops a 128x80 coded
    frame, and B1 and B9 search the padded frame's edge MBs."""
    frames = _seq(5, seed=3, w=120, h=72)
    kw = dict(width=120, height=72)
    want = _run(JEncoder(_params(**kw)), frames)
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    dec = t_decode(got)
    assert len(dec) == len(frames)
    assert dec[0].y.shape == (72, 120)
    sent = tenc._stego.sent_messages
    for rec in (extract_from_stream(got, em_rate=EM_RATE, key=KEY),
                extract_from_frames(dec, em_rate=EM_RATE)):
        assert len(rec) == len(sent) and sum(len(s) for s in sent) > 0
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def test_resume_mid_stream_from_reference(serving_reference):
    ref = serving_reference
    tenc = TEncoder(_tparams(), device="cpu")
    tenc.load_state(ref["state"])
    got_tail = _run(tenc, ref["frames"][3:])
    assert got_tail == ref["tail"]
    sent = tenc._stego.sent_messages
    for extract in (extract_from_stream, t_extract):
        rec = extract(ref["head"] + got_tail, em_rate=EM_RATE, key=KEY)
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def _cpu_branch(p):
    """The reference's CPU branch (B1 against prev_mv >> 2), which the
    JAX Encoder takes on a CPU backend."""
    p.tail_kernel = False
    return p


def _run_traced(enc, frames):
    """Encode + flush, with the SSD/SSIM sums after every call."""
    out, trace = [], []
    for f in frames:
        out.append(enc.encode_frame(f))
        st = enc.stats
        trace.append((st.ssd_y, st.ssd_u, st.ssd_v, st.ssim_sum))
    return b"".join(out) + enc.flush(), trace


def check_close(got, want):
    """close() dicts: the same keys, the counts and PSNRs exact, SSIM
    to rtol 1e-5 (a float32 sum in another order); fps is a rate of the
    wall clock."""
    assert got.keys() == want.keys()
    for k in want:
        if k == "ssim_y":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        elif k != "fps":
            assert got[k] == want[k], k


def check_traces(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        np.testing.assert_allclose(g[3], w[3], rtol=1e-5)


def check_decoders_and_payload(bs, n_frames, sent):
    """The port's decoder reproduces the JAX decoder's frames and MV
    fields; the port's extractor recovers the payload."""
    dec, jdec = t_decode(bs), j_decode(bs)
    assert len(dec) == len(jdec) == n_frames
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.mb_type for m in a.mbs] == [m.mb_type for m in b.mbs]
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    rec = extract_from_frames(dec, em_rate=EM_RATE)
    assert len(rec) == len(sent) and sum(len(s) for s in sent) > 0
    for g, s in zip(rec, sent):
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("kw", [
    {}, {"ssim": True}, {"pipeline": False, "deblock_device": True}],
    ids=["defaults", "ssim", "pipeline_off"])
def test_default_params_byte_equal_and_close(kw):
    """Params(width, height, stego=...) at its defaults: PSNR on and the
    host deblock put the fused P step on its unpipelined branch."""
    frames = _seq(4, seed=5)
    jenc = JEncoder(Params(width=W, height=H, **kw,
                           stego=StegoParams(em_rate=EM_RATE, key=KEY)))
    want, want_trace = _run_traced(jenc, frames)
    tenc = TEncoder(_cpu_branch(TP.Params(
        width=W, height=H, **kw,
        stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))), device="cpu")
    got, got_trace = _run_traced(tenc, frames)
    assert got == want
    assert tenc.stats.p_frames == 3
    check_traces(got_trace, want_trace)
    assert got_trace[-1][0] > 0 and (got_trace[-1][3] > 0) == ("ssim" in kw)
    check_close(tenc.close(), jenc.close())
    if not kw:
        # the pipelined serving Params give the same stream
        piped = TEncoder(_cpu_branch(TP.Params(
            width=W, height=H, deblock_device=True, psnr=False,
            stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))), device="cpu")
        assert _run(piped, frames) == got
    check_decoders_and_payload(got, len(frames),
                               tenc._stego.sent_messages)


@pytest.mark.parametrize("low_qp", [False, True], ids=["qp26", "qp2"])
def test_cabac_stream_byte_equal_and_payload(low_qp, monkeypatch):
    """CABAC on the pipelined path. At QP 2 on binary noise each P
    frame has more levels past int8 than the lean buffer's exception
    list holds, so the exact level pull serves the writer."""
    exact = []
    orig = TCORE._levels_exact
    monkeypatch.setattr(TCORE, "_levels_exact",
                        lambda *a: exact.append(1) or orig(*a))
    if low_qp:
        rng = np.random.RandomState(2)
        frames = [Frame(*((rng.randint(0, 2, shape) * 255).astype(np.uint8)
                          for shape in ((H, W), (H // 2, W // 2),
                                        (H // 2, W // 2))))
                  for _ in range(4)]
        kw = dict(cabac=True, qp=2, qp_min=0)
    else:
        frames = _seq(4, seed=5)
        kw = dict(cabac=True)
    want = _run(JEncoder(_params(**kw)), frames)
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert len(exact) == (3 if low_qp else 0)
    check_decoders_and_payload(got, len(frames), tenc._stego.sent_messages)


def test_resume_unpipelined_cabac_from_reference():
    """A CABAC encoder at the default Params (unpipelined, PSNR and
    SSIM on) resumed mid-stream: the same tail and the same close()."""
    frames = _seq(5, seed=6)
    kw = dict(width=W, height=H, cabac=True, ssim=True)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    head = b"".join(jenc.encode_frame(f) for f in frames[:3])
    assert jenc._pending_p is None
    tenc = TEncoder(_cpu_branch(TP.Params(
        **kw, stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))),
        device="cpu")
    tenc.load_state(from_reference(jenc))
    got_tail = _run(tenc, frames[3:])
    assert got_tail == _run(jenc, frames[3:])
    check_close(tenc.close(), jenc.close())
    assert tenc.stats.frames == 5 and tenc.stats.ssd_y > 0
    check_decoders_and_payload(head + got_tail, len(frames),
                               tenc._stego.sent_messages)


def test_trellis_stream_byte_equal_and_payload():
    """Trellis 1 on the pipelined serving path under CABAC: the IDR's
    levels, pass 1 (its cbp maps) and the full pass 2 (the incremental
    re-encode is off under trellis, as in the reference) all trellised;
    the 4x4 luma levels reach the fused kernel's levels-in entry.
    Trellis 2 codes as trellis 1 while embedding."""
    frames = _seq(4, seed=5)
    want = _run(JEncoder(_params(cabac=True, trellis=1)), frames)
    tenc = TEncoder(_tparams(cabac=True, trellis=1), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    check_decoders_and_payload(got, len(frames), tenc._stego.sent_messages)
    # trellis 2: the same slices (only the SEI's option string differs)
    got2 = _run(TEncoder(_tparams(cabac=True, trellis=2), device="cpu"),
                frames)
    assert got2 != want and non_sei_nals(got2) == non_sei_nals(want)
    assert non_sei_nals(_run(TEncoder(_tparams(cabac=True), device="cpu"),
                             frames)) != non_sei_nals(want)


def non_sei_nals(bs: bytes) -> list:
    """The stream's NAL units but the SEI (x264's option string)."""
    return [n for n in bs.split(b"\x00\x00\x01") if n and n[0] & 31 != 6]
