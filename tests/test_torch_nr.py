"""Noise reduction (x264 --nr) in the port vs the JAX reference on the
CPU.

Module: the fused luma encode's plain twin with `nr_offset`
(`luma_p_encode_plain`, and the trellis path's `luma_encode`, which
denoises before the trellis) equals the reference's
`luma_p_encode(..., nr_offset=)`: levels, recon and the per-position
sums of |coef|.

Streams, byte-equal to the JAX `Encoder` (both decoders equal frame by
frame, both extractors recover the payload), with IDR + 4 P so that the
offset each encode reads is the reference's from the third P frame on,
where a wrong order of update and read would show: NR 400 on the
pipelined main path (a full pass 2 under NR), with the encoder's NR
state equal to the reference's after the run and a resume through
`state.from_reference` mid-stream; NR on the 16x16-only path; NR at
ref_frames 2; and the reference's `b+trellis+cabac+nr` (bframes 2,
trellis 1, CABAC, NR), where NR reaches the P anchors only."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import inter as J_INTER
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import cqm as J_CQM
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import core as T_CORE
from video_steganography_pcamv_torch.encoder import inter as T_INTER
from video_steganography_pcamv_torch.ops import lumap as LP
from video_steganography_pcamv_torch.ops.blocks import mb_tiles
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _reference_flat_after():
    """The direct calls into the reference's ops read its process-wide
    CQM: flat here, and flat for the modules after this one."""
    J_CQM.set_cqm()
    yield
    J_CQM.set_cqm()


W, H = 112, 80
EM_RATE, KEY = 64, 99
NR = 400


@pytest.mark.parametrize("trellis", [False, True])
@pytest.mark.parametrize("qp", [20, 30])
def test_luma_encode_nr_matches_reference(trellis, qp):
    rng = np.random.default_rng(qp + trellis)
    mbh, mbw = 2, 3
    n = mbh * mbw
    y = rng.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.int32)
    noise = np.round(rng.laplace(0, 3 + qp / 4, (n, 16, 16))).astype(np.int32)
    cur = mb_tiles(torch.as_tensor(y), 16).numpy()
    pred = np.clip(cur + noise, 0, 255).astype(np.int32)
    off = rng.integers(0, 40, (4, 4)).astype(np.int32)
    off[0, 0] = 99      # the DC is never denoised, whatever its offset
    want_lev, want_rec, want_sum = J_INTER.luma_p_encode(
        jnp.asarray(cur), jnp.asarray(pred), qp, True, trellis,
        jnp.asarray(off))
    yt, pt, ot = (torch.as_tensor(a) for a in (y, pred, off))
    if trellis:
        lev, rec, cbp, nr_sum = T_INTER.luma_encode(yt, pt, qp, trellis=True,
                                                    nr_offset=ot)
    else:
        lev, rec, cbp, nr_sum = LP.luma_p_encode_plain(yt, pt, qp,
                                                       nr_offset=ot)
    np.testing.assert_array_equal(lev.numpy(), np.asarray(want_lev))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want_rec))
    np.testing.assert_array_equal(nr_sum.numpy(), np.asarray(want_sum))
    # the denoise moved some level
    plain = T_INTER.luma_encode(yt, pt, qp, trellis=trellis)[0]
    assert (plain != lev).any()


def _kw(**kw):
    """bench.py's serving Params at 112x80 on the reference's CPU
    branch, with NR."""
    return dict(dict(width=W, height=H, qp=26, me_range=16,
                     deblock_device=True, psnr=False, tail_kernel=False,
                     noise_reduction=NR), **kw)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def _jax(kw):
    jp = Params(**{k: v for k, v in kw.items() if k != "tail_kernel"},
                stego=StegoParams(em_rate=EM_RATE, key=KEY))
    jp.tail_kernel = kw["tail_kernel"]
    jp.pipeline_deep = False
    return JEncoder(jp)


def _port(kw):
    return TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")


def check_decode_and_payload(got, n_frames, sent):
    dec, jdec = decode_annexb(got), j_decode(got)
    assert len(dec) == len(jdec) == n_frames
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(got, em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def _check_nr_state(tenc, jenc):
    np.testing.assert_array_equal(tenc._nr_sum, jenc._nr_sum)
    assert tenc._nr_count == jenc._nr_count > 0
    np.testing.assert_array_equal(tenc._nr_offset(),
                                  np.asarray(jenc._nr_offset()))


@pytest.fixture
def pass2_log(monkeypatch):
    """Which pass-2 re-encode each port P frame took."""
    log = []
    orig = T_CORE.reencode_p_incremental

    def wrap(*a, **kw):
        log.append("incremental")
        return orig(*a, **kw)
    monkeypatch.setattr(T_CORE, "reencode_p_incremental", wrap)
    return log


def test_nr_main_path_and_resume(pass2_log):
    """NR 400 on the pipelined main path: every pass 2 a full
    re-encode, the NR state after the run equal to the reference's, and
    the port resumed after two frames from the live reference (its NR
    sums and count carried) gives the rest of the stream."""
    frames = synthetic_sequence(W, H, 5, seed=7)
    kw = _kw()
    jenc = _jax(kw)
    head = b"".join(jenc.encode_frame(f) for f in frames[:2])
    state = from_reference(jenc)
    assert state["nr_count"] > 0
    want = head + _run(jenc, frames[2:])
    tenc = _port(kw)
    got = _run(tenc, frames)
    assert got == want
    assert not pass2_log
    _check_nr_state(tenc, jenc)
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)
    resumed = _port(kw)
    resumed.load_state(state)
    assert _run(resumed, frames[2:]) == want[len(head):]
    _check_nr_state(resumed, jenc)


@pytest.mark.parametrize("kw", [
    dict(partitions=False, deblock_device=False),
    dict(ref_frames=2),
], ids=["16x16", "ref2"])
def test_nr_other_p_paths(kw):
    frames = synthetic_sequence(W, H, 5, seed=7)
    kw = _kw(**kw)
    jenc = _jax(kw)
    want = _run(jenc, frames)
    tenc = _port(kw)
    got = _run(tenc, frames)
    assert got == want
    _check_nr_state(tenc, jenc)
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)


def test_nr_bframes_trellis_cabac():
    """The reference's b+trellis+cabac+nr (tests/test_feature_matrix.py):
    NR reaches the P anchors' encodes, not the B encode."""
    frames = synthetic_sequence(W, H, 4, seed=9)
    kw = _kw(bframes=2, b_adapt=0, cabac=True, trellis=1)
    jenc = _jax(kw)
    want = _run(jenc, frames)
    tenc = _port(kw)
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.b_frames == 2
    _check_nr_state(tenc, jenc)
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)
