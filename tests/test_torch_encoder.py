"""The whole ported serving slice (its CPU branch, tail_kernel=False)
vs the JAX reference Encoder on the CPU: byte-equal Annex-B streams,
decoded alike by the port's decoder and the reference's, payload
recovered alike by the port's blind extractor and the reference's. Also
resumes the port mid-stream from a live reference encoder
(`state.from_reference`) with a pipelined frame still pending, and
requires the rest of the stream to be byte-equal; and a cropped 120x72
frame, whose padded edge MBs B1 and B9 search. The port's Encoder is
given the port's own Params built from the same keyword arguments."""

import numpy as np
import pytest

from video_steganography_pcamv_tpu.decoder import decode_annexb
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import (
    decode_annexb as t_decode)
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_stream as t_extract)

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
    kw = dict(dict(width=W, height=H), **kw)
    p = params(qp=26, me_range=16, deblock_device=True, psnr=False,
               stego=stego(em_rate=EM_RATE, key=KEY), **kw)
    p.tail_kernel = False
    p.pipeline_deep = False
    return p


def _tparams(**kw):
    return _params(TP.Params, TP.StegoParams, **kw)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


@pytest.mark.parametrize("kw", [
    {}, {"keyint_max": 3},
    {"chroma_qp_offset": -2, "deblock_alpha": 2, "deblock_beta": -1}],
    ids=["ippppp", "keyint3", "deblock_offsets"])
def test_stream_byte_equal_and_payload(kw):
    frames = _seq(6)
    jenc = JEncoder(_params(**kw))
    want = _run(jenc, frames)
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i_frames == jenc.stats.i_frames
    assert (tenc.stats.i_frames > 1) == ("keyint_max" in kw)
    for dec in (decode_annexb(got), t_decode(got)):
        assert len(dec) == len(frames)
    sent = tenc._stego.sent_messages
    for extract in (extract_from_stream, t_extract):
        rec = extract(got, em_rate=EM_RATE, key=KEY)
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
    for extract in (extract_from_stream, t_extract):
        rec = extract(got, em_rate=EM_RATE, key=KEY)
        assert len(rec) == len(sent) and sum(len(s) for s in sent) > 0
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def test_resume_mid_stream_from_reference():
    frames = _seq(6)
    jenc = JEncoder(_params())
    head = b"".join(jenc.encode_frame(f) for f in frames[:3])
    assert jenc._pending_p is not None
    state = from_reference(jenc)
    tenc = TEncoder(_tparams(), device="cpu")
    tenc.load_state(state)
    want_tail = _run(jenc, frames[3:])
    got_tail = _run(tenc, frames[3:])
    assert got_tail == want_tail
    sent = tenc._stego.sent_messages
    for extract in (extract_from_stream, t_extract):
        rec = extract(head + got_tail, em_rate=EM_RATE, key=KEY)
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)
