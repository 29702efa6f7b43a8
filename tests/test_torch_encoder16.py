"""The port's 16x16-only path (partitions=False, deblock_device=False)
vs the JAX reference Encoder on the CPU, at 112x80, IDR + 4 P frames
with bench.py's other Params: byte-equal access units frame by frame,
decoded by the port's decoder and the reference's, payload recovered by
the port's extractor and the reference's. One JAX encode is shared; it
also snapshots its state after frame 2 (`state.from_reference`), from
which the port resumes and must give the same tail. The reference
itself fails with deblock_device=True on this path, so the port
refuses that combination. Under CABAC, with PSNR and SSIM on, the
stream and the `close()` dict equal the reference's too. With B frames
(CAVLC under b_adapt 2, CABAC under b_adapt 0) the stream is byte-equal,
every B slice through the native writer as in the reference, decoded
alike by both decoders (this file's JAX runs have already compiled the
16x16 path's programs, so these runs cost little here)."""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import decode_annexb
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import extract_from_stream

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import native as T_NATIVE
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import (
    decode_annexb as t_decode)
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_stream as t_extract)
from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence


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


def assert_decoders_agree(bs, n_frames):
    """The port's decoder gives the JAX decoder's planes, slice types and
    MB motion on every frame."""
    dec, jdec = t_decode(bs), decode_annexb(bs)
    assert len(dec) == len(jdec) == n_frames
    for a, b in zip(dec, jdec):
        assert (a.slice_type, a.poc) == (b.slice_type, b.poc)
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.mb_type for m in a.mbs] == [m.mb_type for m in b.mbs]
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    return dec


@pytest.mark.parametrize("cabac,kw", [
    (False, dict(b_adapt=2, rc_lookahead=4)), (True, dict(b_adapt=0))],
    ids=["cavlc_badapt2", "cabac"])
def test_b_frames_byte_equal_and_payload(cabac, kw, monkeypatch):
    """B frames at one reference (B6 and B7 per list, `scan_b_frame`):
    the stream is byte-equal to the JAX Encoder's, every B slice goes
    through the native writer of its entropy coder (`write_slice_b`,
    `write_slice_cabac_b`) as in the reference, both decoders agree on
    every frame and both extractors recover the payload. The reference
    leaves the B frames' colocated field stale on this path (ROADMAP
    F2); the stream keeps it."""
    frames = synthetic_sequence(W, H, 7, seed=7)
    kw = dict(kw, bframes=2, cabac=cabac)
    jenc = JEncoder(_params(**kw))
    want = b"".join(jenc.encode_frame(f) for f in frames) + jenc.flush()
    calls = []
    for name in ("write_slice_b", "write_slice_cabac_b"):
        def wrap(*a, _fn=getattr(T_NATIVE, name), _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(T_NATIVE, name, wrap)
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = b"".join(tenc.encode_frame(f) for f in frames) + tenc.flush()
    assert got == want
    n_b = tenc.stats.b_frames
    assert n_b == jenc.stats.b_frames > 0
    assert calls == ["write_slice_cabac_b" if cabac else "write_slice_b"] * n_b
    dec = assert_decoders_agree(got, len(frames))
    assert {m.mb_type for f in dec if f.slice_type == 1 for m in f.mbs} \
        <= {"BSKIP", "BDIRECT", "BL0", "BL1", "BBI"}
    _check_payload(got, tenc._stego.sent_messages)


def test_pyramid_temporal_direct_under_f2():
    """A pyramid GOP (B B B P, its middle B a reference) under weightb
    and direct auto at one reference, whose first B slice (the reference
    B) takes temporal direct: the stream is byte-equal to the JAX
    Encoder's. ROADMAP F2 reaches it: the encoder reads the IDR's intra
    field as every anchor's colocated field, so the later B frames (L0[0]
    the reference B) code temporal direct MBs that the decoders, which
    hold the anchor's true field (references outside the B's one-entry
    L0), find direct-unavailable: neither decoder decodes the stream."""
    frames = synthetic_sequence(W, H, 7, seed=7)
    kw = dict(bframes=3, b_adapt=0, b_pyramid=True, weightb=True, direct=3,
              cabac=False)
    jenc = JEncoder(_params(**kw))
    want = b"".join(jenc.encode_frame(f) for f in frames) + jenc.flush()
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got = b"".join(tenc.encode_frame(f) for f in frames) + tenc.flush()
    assert got == want
    assert tenc.stats.b_frames == jenc.stats.b_frames == 4
    assert tenc._direct_score == jenc._direct_score
    with pytest.raises(ValueError, match="temporal direct is unavailable"):
        t_decode(got)
    with pytest.raises(TypeError):
        decode_annexb(got)


def test_analyse_b_frame_matches_reference():
    """The 16x16 B analysis at one reference (B6, B7, the qpel tables,
    the subpel refine against a zero predictor per list, BI at the
    winners) on seeded planes against the reference's `analyse_b_frame`,
    at this file's me_range, whose program the B runs above compiled."""
    import jax.numpy as jnp
    from video_steganography_pcamv_tpu.encoder import bslice as JB
    from video_steganography_pcamv_torch.encoder import bslice as TB
    from video_steganography_pcamv_torch.encoder.me import lambda_tab
    from test_torch_bframes import _refs
    (t0, _t1, t2), (j0, _j1, j2), cur = _refs(3, 62)
    lam, rng, mbh, mbw = lambda_tab(28), 16, H // 16, W // 16
    got = TB.analyse_b_frame(torch.as_tensor(cur), t0["luma"][None], 1,
                             t2["luma"], rng, mbh, mbw, lam)
    mv0, c0, mv1, c1, cbi = JB.analyse_b_frame(
        jnp.asarray(cur), j0["luma"], j2["luma"], rng, mbh, mbw, lam, 2,
        False, w1=32)
    want = (mv0, c0, np.zeros((mbh, mbw), np.int32), mv1, c1, cbi)
    for name, a, b in zip(("mv0", "c0", "ref0", "mv1", "c1", "cbi"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_trans8_trellis_byte_equal_to_reference_with_f4_keys(monkeypatch):
    """The 16x16-only path with transform_8x8 and trellis 1 under CABAC
    (x264's --partitions none --8x8dct --trellis 1): the IDR codes
    Intra_8x8 on trellised levels, the P frames (no 8x8 transform on
    this path) trellis pass 1 and pass 2 and carry
    transform_size_8x8_flag 0. The reference raises KeyError on its first
    such P frame (ROADMAP F4: its writers read the `trans8`/`luma8_lev`
    that its 16x16 encode never makes); with those keys added as all-4x4
    the streams are byte-equal. Both decoders give the encoder's recon;
    both extractors recover the payload."""
    import jax.numpy as jnp
    from video_steganography_pcamv_tpu.encoder import inter as J_INTER
    orig = J_INTER.encode_p_frame_device

    def with_keys(*a, **kw):
        res = dict(orig(*a, **kw))
        cbp = res["cbp_luma"]
        res.setdefault("trans8", jnp.zeros(cbp.shape, bool))
        res.setdefault("luma8_lev", jnp.zeros(cbp.shape + (256,), jnp.int16))
        return res
    monkeypatch.setattr(J_INTER, "encode_p_frame_device", with_keys)
    frames = synthetic_sequence(W, H, 4, seed=7)
    kw = dict(cabac=True, transform_8x8=True, trellis=1)
    jenc = JEncoder(_params(**kw))
    want = [jenc.encode_frame(f) for f in frames]
    tenc = TEncoder(_tparams(**kw), device="cpu")
    got, recons = [], []
    for f in frames:
        got.append(tenc.encode_frame(f))
        recons.append([np.asarray(t) for t in tenc.recon_prev])
    assert got == want
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs == 0
    bs = b"".join(got)
    dec, jdec = t_decode(bs), decode_annexb(bs)
    assert len(dec) == len(jdec) == len(frames)
    for a, b, r in zip(dec, jdec, recons):
        for pl, rp, s in zip(("y", "u", "v"), r, (1, 2, 2)):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(getattr(a, pl),
                                          rp[:H // s, :W // s])
    _check_payload(bs, tenc._stego.sent_messages)
