"""The whole ported serving slice vs the JAX reference Encoder on the CPU:
byte-equal Annex-B streams, decodable, payload recovered by the
reference's blind extractor. Also resumes the port mid-stream from a
live reference encoder (`state.from_reference`) with a pipelined frame
still pending, and requires the rest of the stream to be byte-equal."""

import numpy as np
import pytest

from video_steganography_pcamv_tpu.decoder import decode_annexb
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch.state import from_reference

W, H = 112, 80
EM_RATE, KEY = 64, 99


def _seq(n, seed=1):
    rng = np.random.RandomState(seed)
    big = rng.randint(30, 226, ((H + 64) // 4, (W + 64) // 4))
    big = np.repeat(np.repeat(big, 4, 0), 4, 1).astype(np.uint8)
    frames = []
    for i in range(n):
        f = big[16 + i:16 + i + H, 16 + 2 * i:16 + 2 * i + W].copy()
        u = np.full((H // 2, W // 2), 120 + i, np.uint8)
        frames.append(Frame(f, u, u.copy()))
    return frames


def _params(**kw):
    """bench.py's serving Params, analyse-tail kernels off."""
    p = Params(width=W, height=H, qp=26, me_range=16, deblock_device=True,
               psnr=False, stego=StegoParams(em_rate=EM_RATE, key=KEY),
               **kw)
    p.tail_kernel = False
    p.pipeline_deep = False
    return p


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
    tenc = TEncoder(_params(**kw), device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i_frames == jenc.stats.i_frames
    assert (tenc.stats.i_frames > 1) == ("keyint_max" in kw)
    assert len(decode_annexb(got)) == len(frames)
    sent = tenc._stego.sent_messages
    rec = extract_from_stream(got, em_rate=EM_RATE, key=KEY)
    assert len(rec) == len(sent) and sum(len(s) for s in sent) > 0
    for g, s in zip(rec, sent):
        np.testing.assert_array_equal(g, s)


def test_resume_mid_stream_from_reference():
    frames = _seq(6)
    jenc = JEncoder(_params())
    head = b"".join(jenc.encode_frame(f) for f in frames[:3])
    assert jenc._pending_p is not None
    state = from_reference(jenc)
    tenc = TEncoder(_params(), device="cpu")
    tenc.load_state(state)
    want_tail = _run(jenc, frames[3:])
    got_tail = _run(tenc, frames[3:])
    assert got_tail == want_tail
    rec = extract_from_stream(head + got_tail, em_rate=EM_RATE, key=KEY)
    sent = tenc._stego.sent_messages
    assert len(rec) == len(sent)
    for g, s in zip(rec, sent):
        np.testing.assert_array_equal(g, s)
