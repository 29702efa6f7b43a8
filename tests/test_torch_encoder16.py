"""The port's 16x16-only path (partitions=False, deblock_device=False)
vs the JAX reference Encoder on the CPU, at 112x80, IDR + 4 P frames
with bench.py's other Params: byte-equal access units frame by frame,
decoded by the port's decoder and the reference's, payload recovered by
the port's extractor and the reference's. One JAX encode is shared; it
also snapshots its state after frame 2 (`state.from_reference`), from
which the port resumes and must give the same tail. The reference
itself fails with deblock_device=True on this path, so the port
refuses that combination. Under CABAC, with PSNR and SSIM on, the
stream and the `close()` dict equal the reference's too."""

import numpy as np
import pytest

from video_steganography_pcamv_tpu.decoder import decode_annexb
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import (
    decode_annexb as t_decode)
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_stream as t_extract)
from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence

W, H = 112, 80
EM_RATE, KEY = 64, 99
N_FRAMES, RESUME_AFTER = 5, 3


def _params(params=Params, stego=StegoParams, **kw):
    """bench.py's Params with the 16x16-only P path."""
    base = dict(width=W, height=H, qp=26, me_range=16, deblock_device=False,
                psnr=False, partitions=False,
                stego=stego(em_rate=EM_RATE, key=KEY))
    base.update(kw)
    p = params(**base)
    p.pipeline_deep = False
    return p


def _tparams(**kw):
    return _params(TP.Params, TP.StegoParams, **kw)


@pytest.fixture(scope="module")
def reference():
    frames = synthetic_sequence(W, H, N_FRAMES, seed=7)
    jenc = JEncoder(_params())
    aus, state = [], None
    for i, f in enumerate(frames):
        aus.append(jenc.encode_frame(f))
        if i + 1 == RESUME_AFTER:
            state = from_reference(jenc)
    assert jenc.flush() == b""
    return dict(frames=frames, aus=aus, state=state,
                sent=list(jenc._stego.sent_messages),
                p_frames=jenc.stats.p_frames)


def _check_payload(bs, sent):
    assert sum(len(s) for s in sent) > 0
    for extract in (extract_from_stream, t_extract):
        rec = extract(bs, em_rate=EM_RATE, key=KEY)
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def test_stream_byte_equal_and_payload(reference):
    tenc = TEncoder(_tparams(), device="cpu")
    aus = [tenc.encode_frame(f) for f in reference["frames"]]
    assert tenc.flush() == b""
    for i, (got, want) in enumerate(zip(aus, reference["aus"])):
        assert got == want, "access unit %d differs" % i
    assert tenc.stats.p_frames == reference["p_frames"] == N_FRAMES - 1
    bs = b"".join(aus)
    for dec in (decode_annexb(bs), t_decode(bs)):
        assert len(dec) == N_FRAMES
    sent = tenc._stego.sent_messages
    assert len(sent) == N_FRAMES - 1
    for g, s in zip(sent, reference["sent"]):
        np.testing.assert_array_equal(g, s)
    _check_payload(bs, sent)


def test_resume_mid_stream_from_reference(reference):
    assert reference["state"]["pending"] is None
    tenc = TEncoder(_tparams(), device="cpu")
    tenc.load_state(reference["state"])
    tail = [tenc.encode_frame(f)
            for f in reference["frames"][RESUME_AFTER:]]
    assert tail == reference["aus"][RESUME_AFTER:]
    bs = b"".join(reference["aus"][:RESUME_AFTER] + tail)
    _check_payload(bs, tenc._stego.sent_messages)


def test_refuses_device_deblock_without_partitions():
    with pytest.raises(NotImplementedError, match="recon_y"):
        TEncoder(_tparams(deblock_device=True), device="cpu")
    with pytest.raises(NotImplementedError, match="me_range"):
        TEncoder(_tparams(me_range=24), device="cpu")


def test_cabac_with_metrics_stream_byte_equal_and_close():
    """The 16x16-only path under CABAC (the writer's 16x16 form: part 0,
    the MVD in slot 0) with PSNR and SSIM accumulated every frame:
    byte-equal access units; close() equal, PSNR exactly and SSIM to
    rtol 1e-5 (a float32 sum in another order)."""
    frames = synthetic_sequence(W, H, 4, seed=7)
    kw = dict(cabac=True, psnr=True, ssim=True)
    jenc = JEncoder(_params(**kw))
    want = [jenc.encode_frame(f) for f in frames]
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = [tenc.encode_frame(f) for f in frames]
    assert got == want and tenc.flush() == b""
    jd, td = jenc.close(), tenc.close()
    assert td.keys() == jd.keys()
    for k in jd:
        if k == "ssim_y":
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-5)
            assert td[k] > 0
        elif k != "fps":
            assert td[k] == jd[k], k
    bs = b"".join(got)
    dec, jdec = t_decode(bs), decode_annexb(bs)
    assert len(dec) == len(jdec) == len(frames)
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    _check_payload(bs, tenc._stego.sent_messages)
