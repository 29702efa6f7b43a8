"""The port's multi-stream encoders (`encoder/multistream.py`,
`parallel/mesh.py`) against the JAX package's, on the CPU.

- `MultiEncoder` at 128x96, S=2, 4 frames, em_rate 12, key 5 (the
  Params of the reference's `test_multistream_stego_payloads`): each
  stream byte-equal to the JAX `MultiEncoder`'s, on its CPU branch
  (`tail_kernel=False`) and on its accelerator branch (through
  `reference_accel`); the reference's extractor recovers every payload.
- `build_multi_encoder` over two CPU devices, byte-equal to the same
  reference run.
- A port `MultiEncoder` resumed after step 2 from the reference's state
  (`state.multi_from_reference`) writes steps 3 and 4 byte-equal.
- `PipelinedMultiEncoder` at 96x64, S=2, T=5, byte-equal to the JAX one.
- CABAC, a chroma qp offset and an IDR step inside the streams, which
  the reference's `MultiEncoder` honours, byte-equal.
- Stego off: the plain `MultiEncoder` byte-equal to the JAX one, and its
  streams equal to the port's single-stream encoders'.
- Every option the reference's `MultiEncoder` ignores or breaks is
  refused, and the reference's faults under three of them (ROADMAP F7,
  F8, F9) are shown on the reference itself; both raise when the
  streams leave GOP lockstep.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder.multistream import (
    MultiEncoder as JMultiEncoder, PipelinedMultiEncoder as JPipelined)
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch import state as TS
from video_steganography_pcamv_torch.encoder.multistream import (
    MultiEncoder, PipelinedMultiEncoder)
from video_steganography_pcamv_torch.parallel import mesh as TMESH

from test_torch_encoder_accel import reference_accel  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H, S, N = 128, 96, 2, 4
EM_RATE, KEY = 12.0, 5


def _kw(**kw):
    return dict(dict(width=W, height=H, qp=27, me_range=8,
                     intra_in_p=False), **kw)


def _jparams(**kw):
    return Params(**_kw(**kw), stego=StegoParams(em_rate=EM_RATE, key=KEY))


def _tparams(tail_kernel=False, **kw):
    p = TP.Params(**_kw(**kw), stego=TP.StegoParams(em_rate=EM_RATE,
                                                    key=KEY))
    p.tail_kernel = tail_kernel
    return p


def _tparams_off():
    """The port's Params with stego off, on the reference's CPU branch."""
    p = TP.Params(**_kw())
    p.tail_kernel = False
    return p


def _seqs(n=N):
    return [synthetic_sequence(W, H, n, seed=20 + s) for s in range(S)]


def _steps(me, seqs, steps, snap_after=None):
    """Per step, the chunk of each stream; with `snap_after` also the
    reference state after that many steps."""
    out, snap = [], None
    for t in steps:
        out.append(me.encode_step([seq[t] for seq in seqs]))
        if snap_after is not None and t + 1 == snap_after:
            snap = TS.multi_from_reference(me)
    return out, snap


def _streams(chunks):
    return [b"".join(c[s] for c in chunks) for s in range(S)]


@pytest.fixture(scope="module")
def reference_run():
    """The JAX MultiEncoder on its CPU branch: the chunks of every step,
    the sent messages and its state after step 2."""
    seqs = _seqs()
    me = JMultiEncoder(_jparams(), S)
    chunks, snap = _steps(me, seqs, range(N), snap_after=2)
    return seqs, chunks, [e._stego.sent_messages for e in me.encs], snap


def _payloads_recovered(streams, sent):
    for bs, msgs in zip(streams, sent):
        got = j_extract(bs, em_rate=EM_RATE, key=KEY)
        assert len(got) == len(msgs) == N - 1
        assert sum(len(m) for m in msgs) > 0
        for g, m in zip(got, msgs):
            np.testing.assert_array_equal(g, m)


def test_multistream_byte_equal_cpu_branch(reference_run):
    seqs, want, sent, _snap = reference_run
    me = MultiEncoder(_tparams(), S, devices=["cpu"])
    got, _ = _steps(me, seqs, range(N))
    assert got == want
    _payloads_recovered(_streams(got), [e._stego.sent_messages
                                        for e in me.encs])
    for e, msgs in zip(me.encs, sent):
        assert all(np.array_equal(a, b)
                   for a, b in zip(e._stego.sent_messages, msgs))
    for bs in _streams(got):
        assert len(j_decode(bs)) == N


def test_multistream_byte_equal_accel_branch(reference_run, reference_accel):
    """The reference's accelerator branch (B1 against a zero predictor)
    against `tail_kernel=True`: byte-equal, and unlike the CPU branch's
    streams."""
    seqs, cpu_branch, _sent, _snap = reference_run
    jme = JMultiEncoder(_jparams(), S)
    want, _ = _steps(jme, seqs, range(N))
    assert reference_accel["fullpel"] >= 1
    me = MultiEncoder(_tparams(tail_kernel=True), S, devices=["cpu"])
    got, _ = _steps(me, seqs, range(N))
    assert got == want
    assert got != cpu_branch
    _payloads_recovered(_streams(got), [e._stego.sent_messages
                                        for e in me.encs])


def test_build_multi_encoder_over_two_devices(reference_run):
    seqs, want, _sent, _snap = reference_run
    devs = TMESH.build_mesh(devices=["cpu", "cpu"])
    me = TMESH.build_multi_encoder(_tparams(), devs)
    assert me.S == 2 and me.devices == devs
    got, _ = _steps(me, seqs, range(N))
    assert got == want


def test_multistream_resumes_from_reference_state(reference_run):
    """The reference's state after step 2 in a fresh port MultiEncoder:
    steps 3 and 4 byte-equal, and the payloads of the whole streams
    recovered."""
    seqs, want, sent, snap = reference_run
    me = MultiEncoder(_tparams(), S, devices=["cpu"])
    TS.load_multi_state(me, snap)
    got, _ = _steps(me, seqs, range(2, N))
    assert got == want[2:]
    _payloads_recovered(_streams(want[:2] + got),
                        [e._stego.sent_messages for e in me.encs])


def test_pipelined_multistream_byte_equal():
    """PipelinedMultiEncoder at the reference test's Params (96x64, S=2,
    T=5, flush): byte-equal per stream, payloads recovered."""
    S2, T, W2, H2 = 2, 5, 96, 64
    kw = dict(width=W2, height=H2, qp=26, me_range=4, keyint_max=30,
              scenecut_threshold=0)
    jp = Params(**kw, stego=StegoParams(em_rate=16.0, key=13))
    tp = TP.Params(**kw, stego=TP.StegoParams(em_rate=16.0, key=13))
    tp.tail_kernel = False
    seqs = [synthetic_sequence(W2, H2, T, seed=60 + s) for s in range(S2)]
    streams = {}
    for name, me in (("jax", JPipelined(jp, S2)),
                     ("port", PipelinedMultiEncoder(tp, S2,
                                                    devices=["cpu"]))):
        out = [b""] * S2
        for t in range(T):
            out = [a + b for a, b in
                   zip(out, me.encode_step([seq[t] for seq in seqs]))]
        streams[name] = [a + b for a, b in zip(out, me.flush())]
        if name == "port":
            for bs, e in zip(streams[name], me.encs):
                got = j_extract(bs, em_rate=16.0, key=13)
                sent = e._stego.sent_messages
                assert len(got) == len(sent) == T - 1
                for g, m in zip(got, sent):
                    np.testing.assert_array_equal(g, m)
    assert streams["port"] == streams["jax"]


def test_multistream_honoured_options_byte_equal():
    """Options the reference's MultiEncoder honours, together: CABAC, a
    chroma qp offset and keyint_max 3 with scene cuts off (an IDR step
    inside the streams): byte-equal on the CPU branch."""
    kw = dict(cabac=True, chroma_qp_offset=-2, keyint_max=3,
              scenecut_threshold=0)
    seqs = _seqs()
    want, _ = _steps(JMultiEncoder(_jparams(**kw), S), seqs, range(N))
    got, _ = _steps(MultiEncoder(_tparams(**kw), S, devices=["cpu"]), seqs,
                    range(N))
    assert got == want
    assert all(c[s].count(b"\0\0\0\1\x67") == 1 for c in (got[0], got[3])
               for s in range(S))


@pytest.mark.parametrize("kw,name", [
    (dict(ref_frames=2), "ref_frames"), (dict(bframes=1), "bframes"),
    (dict(transform_8x8=True), "transform_8x8"),
    (dict(cabac=True, trellis=1), "trellis"), (dict(aq_mode=1), "aq_mode"),
    (dict(noise_reduction=100), "noise_reduction"),
    (dict(deblock_alpha=2), "deblock_alpha"),
    (dict(deblock_beta=-1), "deblock_beta"), (dict(aud=True), "aud"),
    (dict(partitions=False, deblock_device=False), "partitions off")])
def test_multistream_refuses_what_the_reference_does_not_serve(kw, name):
    with pytest.raises(NotImplementedError, match=name):
        MultiEncoder(_tparams(**kw), S, devices=["cpu"])


def test_multistream_stego_off_waits_for_a16b():
    """Stego off no longer waits (A16b's P half): the plain
    MultiEncoder's streams are each the plain single-stream port
    Encoder's (the contract of the reference's
    `test_multistream_matches_single_stream`; the MultiEncoder turns the
    intra compare off, as the reference's does), with no B4 launch."""
    seqs = _seqs(3)
    me = MultiEncoder(TP.Params(**_kw()), S, devices=["cpu"])
    assert all(e._stego is None for e in me.encs)
    multi = _streams(_steps(me, seqs, range(3))[0])
    for s in range(S):
        enc = TEncoder(TP.Params(**_kw()), device="cpu")
        single = b"".join(enc.encode_frame(f) for f in seqs[s])
        assert multi[s] == single, s
        assert len(j_decode(multi[s])) == 3


def test_multistream_stego_off_byte_equal():
    """The plain MultiEncoder (stego off) against the JAX MultiEncoder
    on its CPU branch: each stream byte-equal (the reference's
    `test_multistream_matches_single_stream` holds its streams equal to
    its single-stream Encoder's, `test_multistream_stego_off_waits_for_
    a16b` the port's). Its analysis is the stego-on one's without B4,
    whose accelerator branch `test_multistream_byte_equal_accel_branch`
    holds."""
    seqs = _seqs(3)
    want, _ = _steps(JMultiEncoder(Params(**_kw()), S), seqs, range(3))
    got, _ = _steps(MultiEncoder(_tparams_off(), S, devices=["cpu"]), seqs,
                    range(3))
    assert got == want
    assert all(len(j_decode(bs)) == 3 for bs in _streams(got))


def _reference_streams(n_frames, **kw):
    """The reference MultiEncoder under `kw` over n_frames, with each
    stream's recon after every step."""
    seqs = _seqs(n_frames)
    me = JMultiEncoder(_jparams(**kw), S)
    streams, recons = [b""] * S, [[] for _ in range(S)]
    for t in range(n_frames):
        chunks = me.encode_step([seq[t] for seq in seqs])
        streams = [a + b for a, b in zip(streams, chunks)]
        for s, e in enumerate(me.encs):
            recons[s].append(tuple(np.asarray(x) for x in e.recon_prev))
    return streams, recons


def test_f7_reference_multistream_ref_frames_cavlc_is_undecodable():
    """ROADMAP F7: at ref_frames 2 under CAVLC the reference's P slices
    code no ref_idx where its PPS asks for one: its own decoder fails."""
    streams, _ = _reference_streams(2, ref_frames=2)
    for bs in streams:
        with pytest.raises(Exception):
            j_decode(bs)


def test_f8_reference_multistream_transform_8x8_breaks():
    """ROADMAP F8: with transform_8x8 the reference's P slices omit
    transform_size_8x8_flag under CAVLC (its decoder fails) and its CABAC
    writer reads levels its P encodes never return (KeyError)."""
    streams, _ = _reference_streams(2, transform_8x8=True)
    for bs in streams:
        with pytest.raises(Exception):
            j_decode(bs)
    with pytest.raises(KeyError, match="luma8_lev"):
        _reference_streams(2, transform_8x8=True, cabac=True)


def test_f9_reference_multistream_deblock_offsets_leave_the_recon():
    """ROADMAP F9: the reference deblocks its P frames with the slice
    offsets its P slice headers leave out: the decoded P frames differ
    from its recon (the IDR's header carries them)."""
    streams, recons = _reference_streams(2, deblock_alpha=2,
                                         deblock_beta=-1)
    for bs, rec in zip(streams, recons):
        dec = j_decode(bs)
        diff = [sum(int((np.asarray(getattr(d, pl))[:r.shape[0], :r.shape[1]]
                         != r).sum()) for pl, r in zip("yuv", rr))
                for d, rr in zip(dec, rec)]
        assert diff[0] == 0 and diff[1] > 0


def test_gop_lockstep_is_kept_as_an_error():
    """keyint_min 1 lets a scene cut make one stream's frame an IDR
    alone: the reference asserts and the port raises at the same step."""
    kw = dict(keyint_max=2, keyint_min=1)
    seqs = _seqs()
    raised = {}
    for name, me, exc in (
            ("jax", JMultiEncoder(_jparams(**kw), S), AssertionError),
            ("port", MultiEncoder(_tparams(**kw), S, devices=["cpu"]),
             RuntimeError)):
        for t in range(N):
            try:
                me.encode_step([seq[t] for seq in seqs])
            except exc as ex:
                assert "lockstep" in str(ex)
                raised[name] = t
                break
    assert raised["jax"] == raised["port"]
