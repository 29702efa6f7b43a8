"""Multi-reference P (x264 --ref N, BASELINE config 4's P half) in the
port vs the JAX reference on the CPU, on the reference's CPU branch
(tail_kernel=False).

Modules: `te_ref_bits`, `merge_ref_states` (ties keep the lower
reference, slots past n_valid masked) and the per-8x8 reference under
the chosen partition; B9's plain version with a per-8x8 reference
against `gather_windows8_mref`; `encode_p_frame_device8_mref` with and
without forced skips; B5's plain version with a per-4x4 reference map
whose neighbours differ only in their reference, against the native
deblocker.

End to end, on the reference's flicker content (frame t matches t-2 far
better than t-1, so reference 1 wins): ref_frames 2 under CAVLC and
CABAC, ref_frames 3 with keyint_max 3 (fewer valid entries than
ref_frames after every IDR, so the slice header overrides the active
count), and partitions off with ref_frames 2 (every MB 16x16). Each
stream is byte-equal to the JAX `Encoder`'s and the port's blind
extractor recovers every payload bit; the CAVLC run also resumes the
port mid-stream from the live reference encoder (`state.from_reference`,
the whole DPB) and requires the rest of the stream to be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu import native as j_native
from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import inter as J_INTER
from video_steganography_pcamv_tpu.encoder import partition as J_PT
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import inter as T_INTER
from video_steganography_pcamv_torch.encoder import partition as T_PT
from video_steganography_pcamv_torch.ops import deblock as DB
from video_steganography_pcamv_torch.ops import mc
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


W, H = 112, 80
MBH, MBW = H // 16, W // 16
EM_RATE, KEY = 64, 5


def _flicker_frames(n, seed=3, w=W, h=H):
    """The reference's multi-reference content (tests/test_multiref.py):
    f0 = texture A; odd frames = an unrelated texture B; even frames = A
    shifted a little. Even frames match the frame two back."""
    rng = np.random.RandomState(seed)
    pad = 16
    a = rng.randint(30, 226, (h + 2 * pad, w + 2 * pad)).astype(np.uint8)
    a = ((a.astype(np.int32) + np.roll(a, 1, 0) + np.roll(a, 1, 1)
          + np.roll(np.roll(a, 1, 0), 1, 1)) // 4).astype(np.uint8)
    b = rng.randint(0, 256, (h, w)).astype(np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    frames = []
    for i in range(n):
        if i % 2 == 1:
            yp = b
        else:
            sh = i // 2
            yp = a[pad + sh:pad + sh + h, pad + 2 * sh:pad + 2 * sh + w]
        frames.append(Frame(np.ascontiguousarray(yp), u.copy(), u.copy()))
    return frames


def _kw(**kw):
    """BASELINE config 4's P half at 112x80 (tools/bench_c4.py's Params
    with bframes 0), on the reference's CPU branch."""
    return dict(dict(width=W, height=H, qp=26, me_range=16, ref_frames=2,
                     deblock_device=True, psnr=False, tail_kernel=False),
                **kw)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def _random_state(g, r):
    """A B1 output dict with costs from a small range (many ties)."""
    c = lambda *s: torch.as_tensor(g.integers(100, 112, s).astype(np.int32))
    m = lambda *s: torch.as_tensor(g.integers(-8, 9, s).astype(np.int32))
    return dict(c16=c(MBH, MBW), mv16=m(MBH, MBW, 2),
                c16x8=c(MBH, MBW, 2), mv16x8=m(MBH, MBW, 2, 2),
                c8x16=c(MBH, MBW, 2), mv8x16=m(MBH, MBW, 2, 2),
                c8=c(MBH, MBW, 4), mv8=m(MBH, MBW, 4, 2))


@pytest.mark.parametrize("num_ref,n_valid", [(2, 2), (3, 1), (4, 3)])
def test_merge_and_ref8_match_reference(num_ref, n_valid):
    g = np.random.default_rng(10 * num_ref + n_valid)
    sts = [_random_state(g, r) for r in range(num_ref)]
    lam = 2
    np.testing.assert_array_equal(T_PT.te_ref_bits(num_ref),
                                  J_PT.te_ref_bits(num_ref))
    bits = T_PT.te_ref_bits(num_ref)
    got = T_PT.merge_ref_states(sts, lam, bits, n_valid)
    want = J_PT.merge_ref_states(
        [{k: jnp.asarray(v.numpy()) for k, v in st.items()} for st in sts],
        lam, bits, jnp.asarray(n_valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["r8"].max()) < n_valid
    assert (n_valid == 1) == (int(got["r8"].max()) == 0)
    for allow in (True, False):
        part, mv = T_PT.decide_partition(got, MBH, MBW, lam, allow)
        jpart, jmv = J_PT.decide_partition(want, MBH, MBW, lam, allow)
        np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))
        np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
        np.testing.assert_array_equal(
            T_PT.ref8_from_partition(got, part, MBH, MBW).numpy(),
            np.asarray(J_PT.ref8_from_partition(want, jpart, MBH, MBW)))


def _dpb(n, seed):
    """n stacked random reference entries: luma [n,4,Hp,Wp], u, v."""
    g = np.random.default_rng(seed)
    refs = [mc.build_ref(*(torch.as_tensor(g.integers(0, 256, s)
                                           .astype(np.int32))
                           for s in ((H, W), (H // 2, W // 2),
                                     (H // 2, W // 2))))
            for _ in range(n)]
    return [torch.stack([r[k] for r in refs]) for k in ("luma", "u", "v")]


def test_plain_b9_with_ref8_matches_reference():
    luma, _, _ = _dpb(3, 1)
    planes = luma.to(torch.uint8)
    g = np.random.default_rng(2)
    mvfp = g.integers(-20, 21, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    ref8 = g.integers(0, 3, (2 * MBH, 2 * MBW)).astype(np.int32)
    got = T_PT.gather_windows8(planes, torch.as_tensor(mvfp), MBH, MBW,
                               ref8=torch.as_tensor(ref8))
    want = J_PT.gather_windows8_mref(jnp.asarray(planes.numpy()),
                                     jnp.asarray(mvfp), jnp.asarray(ref8),
                                     MBH, MBW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one reference and no ref8: the single-reference call, unchanged
    ones = torch.ones((2 * MBH, 2 * MBW), dtype=torch.int32)
    np.testing.assert_array_equal(
        T_PT.gather_windows8(planes[1], torch.as_tensor(mvfp), MBH,
                             MBW).numpy(),
        T_PT.gather_windows8(planes, torch.as_tensor(mvfp), MBH, MBW,
                             ref8=ones).numpy())
    with pytest.raises(ValueError):
        T_PT.gather_windows8(planes, torch.as_tensor(mvfp), MBH, MBW)


@pytest.mark.parametrize("force", [False, True])
def test_encode_mref_matches_reference(force):
    luma, u_r, v_r = _dpb(2, 3)
    g = np.random.default_rng(4)
    y = g.integers(0, 256, (H, W)).astype(np.int32)
    u = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    v = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    mv8 = g.integers(-40, 41, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    ref8 = g.integers(0, 2, (2 * MBH, 2 * MBW)).astype(np.int32)
    fz = (g.random((MBH, MBW)) < 0.3) if force else None
    t = torch.as_tensor
    got = T_INTER.encode_p_frame_device8_mref(
        t(y), t(u), t(v), luma, u_r, v_r, t(mv8), t(ref8), 26, 29, MBH, MBW,
        force_zero=None if fz is None else t(fz))
    want = J_INTER.encode_p_frame_device8_mref(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        jnp.asarray(luma.numpy()), jnp.asarray(u_r.numpy()),
        jnp.asarray(v_r.numpy()), jnp.asarray(mv8), jnp.asarray(ref8), 26,
        29, MBH, MBW, force_zero=None if fz is None else jnp.asarray(fz))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if force:
        assert not got["cbp_luma"].numpy()[fz].any()


def test_plain_b5_with_ref4_matches_native():
    """Neighbours that differ only in their reference (no residual, one
    MV field, no intra or skip MB) get bS 1 and are filtered."""
    g = np.random.default_rng(6)
    y = g.integers(90, 140, (H, W)).astype(np.int32)
    u = g.integers(100, 130, (H // 2, W // 2)).astype(np.int32)
    v = g.integers(100, 130, (H // 2, W // 2)).astype(np.int32)
    zero = np.zeros((MBH, MBW), np.int32)
    nnz4 = np.zeros((4 * MBH, 4 * MBW), np.int32)
    mv4 = np.zeros((4 * MBH, 4 * MBW, 2), np.int32)
    ref4 = g.integers(0, 3, (4 * MBH, 4 * MBW)).astype(np.int32)
    t = torch.as_tensor
    got = DB.deblock_frame(t(y), t(u), t(v), t(zero), t(zero), t(nnz4),
                           t(mv4), 26, 26, MBH, MBW, ref4=t(ref4))
    flat = DB.deblock_frame(t(y), t(u), t(v), t(zero), t(zero), t(nnz4),
                            t(mv4), 26, 26, MBH, MBW)
    planes = [np.ascontiguousarray(a, np.uint8) for a in (y, u, v)]
    j_native.deblock_frame(*planes, zero.astype(np.uint8), nnz4, mv4,
                           zero.astype(np.uint8), 26, 26, ref4=ref4)
    for name, w_, g_ in zip("yuv", planes, got):
        np.testing.assert_array_equal(w_, g_.numpy(), err_msg=name)
    assert not torch.equal(got[0], flat[0])


@pytest.fixture
def ref8_log(monkeypatch):
    """Records the per-8x8 reference map of every analysed P frame."""
    log = []
    orig = T_PT.analyse_p_frame_parts_mref

    def wrap(*a, **kw):
        out = orig(*a, **kw)
        log.append(out[2].numpy().copy())
        return out
    monkeypatch.setattr(T_PT, "analyse_p_frame_parts_mref", wrap)
    return log


def _check_payload(stream, enc, n_frames):
    dec = decode_annexb(stream)
    assert len(dec) == n_frames
    rec = extract_from_frames(dec, em_rate=EM_RATE)
    sent = enc._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    assert len(rec) == len(sent)
    for g_, s in zip(rec, sent):
        np.testing.assert_array_equal(g_, s)


@pytest.mark.parametrize("cabac", [False, True])
def test_ref2_stream_byte_equal_payload_and_resume(cabac, ref8_log):
    frames = _flicker_frames(5)
    kw = _kw(cabac=cabac)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    head = b"".join(jenc.encode_frame(f) for f in frames[:3])
    state = from_reference(jenc)
    want = head + _run(jenc, frames[3:])
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert any((r == 1).any() for r in ref8_log)
    _check_payload(got, tenc, len(frames))
    if not cabac:
        resumed = TEncoder(TP.Params(**kw, stego=TP.StegoParams(
            em_rate=EM_RATE, key=KEY)), device="cpu")
        resumed.load_state(state)
        assert len(resumed._dpb_store) == 2
        assert _run(resumed, frames[3:]) == want[len(head):]


@pytest.mark.parametrize("kw,n", [
    (dict(ref_frames=3, keyint_max=3), 5),
    (dict(partitions=False), 4),
], ids=["ref3_keyint3", "partitions_off"])
def test_mref_stream_byte_equal_and_payload(kw, n, ref8_log):
    frames = _flicker_frames(n)
    kw = _kw(**kw)
    want = _run(JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                        key=KEY))), frames)
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert any((r == 1).any() for r in ref8_log)
    _check_payload(got, tenc, n)


def reference_with_trans8_keys(monkeypatch):
    """ROADMAP F4: the reference's P writers read `trans8`/`luma8_lev`
    of every P encode whenever transform_8x8 is on, and its
    multi-reference and 16x16 encodes, which take no 8x8 transform, have
    neither, so it raises KeyError on their first P frame. This patch
    adds the keys those encodes leave out (all MBs 4x4-transformed);
    nothing else changes. The port writes that stream:
    transform_size_8x8_flag 0 in every MB with luma residual."""
    for name in ("encode_p_frame_device8_mref", "encode_p_frame_device"):
        orig = getattr(J_INTER, name)

        def with_keys(*a, _orig=orig, **kw):
            res = dict(_orig(*a, **kw))
            cbp = res["cbp_luma"]
            res.setdefault("trans8", jnp.zeros(cbp.shape, bool))
            res.setdefault("luma8_lev",
                           jnp.zeros(cbp.shape + (256,), jnp.int16))
            return res
        monkeypatch.setattr(J_INTER, name, with_keys)


def run_with_recon(enc, frames):
    """Encode + flush of an encoder that returns each frame's access
    unit in its own call, with the deblocked recon after each frame."""
    out, recons = [], []
    for f in frames:
        out.append(enc.encode_frame(f))
        recons.append(tuple(np.asarray(p.cpu()) for p in enc.recon_prev))
    return b"".join(out) + enc.flush(), recons


def check_decoders_equal_recon(stream, recons):
    """The port's decoder equals the JAX decoder and the encoder's recon
    on every frame."""
    dec, jdec = decode_annexb(stream), j_decode(stream)
    assert len(dec) == len(jdec) == len(recons)
    for a, b, r in zip(dec, jdec, recons):
        h, w = a.y.shape
        for pl, rp, (hh, ww) in zip(("y", "u", "v"), r,
                                    ((h, w), (h // 2, w // 2),
                                     (h // 2, w // 2))):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(getattr(a, pl), rp[:hh, :ww])
    return dec


def test_ref2_trans8_rd_trellis_byte_equal(ref8_log, monkeypatch):
    """ref_frames 2 with transform_8x8, rd 1 and trellis 1 under CABAC
    (x264's --ref 2 --8x8dct --subme 7 --trellis 1): the IDR codes
    Intra_8x8 by the RD choice on trellised levels, the P frames take
    the multi-reference encode (no 8x8 transform, trellis in pass 1 and
    pass 2) and carry transform_size_8x8_flag 0. Byte-equal to the
    reference with F4's keys added; both decoders give the encoder's
    recon; the payload is recovered."""
    reference_with_trans8_keys(monkeypatch)
    frames = _flicker_frames(5)
    kw = _kw(cabac=True, transform_8x8=True, rd=1, trellis=1)
    want = _run(JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                        key=KEY))), frames)
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got, recons = run_with_recon(tenc, frames)
    assert got == want
    assert any((r == 1).any() for r in ref8_log)
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs == 0
    check_decoders_equal_recon(got, recons)
    _check_payload(got, tenc, len(frames))


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
def test_b_frames_partitions_off_byte_equal(cabac, monkeypatch):
    """B frames on the 16x16-only path at two references (the L0 merge of
    `analyse_b_frame` at the SATD level, ref_idx_l0 per MB): the stream is
    byte-equal to the JAX Encoder's, the B slices go through the Python
    writers (the reference's route with an L0 map), both decoders agree
    on every frame and the payload is recovered. This file's JAX runs
    have already compiled the multi-reference 16x16 P programs."""
    from video_steganography_pcamv_tpu.decoder import decode_annexb as jdec
    from video_steganography_pcamv_torch import native as t_native
    from video_steganography_pcamv_torch.encoder.cabac import (
        CabacSliceWriter)
    from video_steganography_pcamv_torch.encoder.cavlc import FrameCavlc
    frames = _flicker_frames(6)
    kw = _kw(partitions=False, bframes=2, b_adapt=0, cabac=cabac)
    want = _run(JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                        key=KEY))), frames)
    calls = {"python": 0, "native": 0}

    def count(key, fn):
        def wrap(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrap
    writer = CabacSliceWriter if cabac else FrameCavlc
    monkeypatch.setattr(writer, "write_b_mb",
                        count("python", writer.write_b_mb))
    for name in ("write_slice_b", "write_slice_cabac_b"):
        monkeypatch.setattr(t_native, name,
                            count("native", getattr(t_native, name)))
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.b_frames == 3
    assert calls["python"] > 0 and calls["native"] == 0
    dec, jd = decode_annexb(got), jdec(got)
    assert [f.slice_type for f in dec] == [f.slice_type for f in jd]
    for a, b in zip(dec, jd):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    _check_payload(got, tenc, len(frames))


@pytest.mark.parametrize("direct", [3, 2], ids=["auto", "temporal"])
def test_b_pyramid_partitions_off(direct, monkeypatch):
    """The 16x16-only path at two references with bframes 3, b_pyramid
    and weightb: a pyramid GOP (B B B P, its middle B a reference, the
    next P's L0 reordering op), then B P, whose B the reference codes on
    one L0 entry. Direct auto (temporal first): byte-equal to the JAX
    Encoder's, both decoders agree, the payload is recovered. Temporal
    direct: ROADMAP F3, the reference's 16x16 commit raises OverflowError
    on the first direct-unavailable MB (a Python int of 1 << 60 added to
    a numpy int32); the port's stream decodes equal in both decoders and
    carries the payload. Either way every decoded frame, the reference B
    among them, equals the encoder's recon (the anchors' deblocked
    planes, the B frames' undeblocked ones)."""
    from video_steganography_pcamv_torch.encoder import bslice as TB
    from video_steganography_pcamv_torch.ops import mc as tmc
    from video_steganography_pcamv_tpu.decoder import decode_annexb as jdec
    frames = _flicker_frames(7)
    kw = _kw(partitions=False, bframes=3, b_adapt=0, b_pyramid=True,
             weightb=True, direct=direct)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    recon, last = {}, {}
    build, enc_b = tmc.build_ref, TB.encode_b_frame_device
    push, bframe = tenc._push_ref, tenc._encode_b_frame

    def build_ref(y, u, v, *a, **k):
        last["ref"] = tuple(t.numpy().copy() for t in (y, u, v))
        return build(y, u, v, *a, **k)

    def push_ref(refdict):
        recon[tenc._ref_meta[0]] = last.pop("ref")
        return push(refdict)

    def encode_b(*a, **k):
        out = enc_b(*a, **k)
        last["b"] = tuple(out[n].numpy().copy()
                          for n in ("recon_y", "recon_u", "recon_v"))
        return out

    def b_frame(*a, **k):
        out = bframe(*a, **k)
        recon[a[8]] = last.pop("b")
        return out
    monkeypatch.setattr(tmc, "build_ref", build_ref)
    monkeypatch.setattr(TB, "encode_b_frame_device", encode_b)
    tenc._push_ref, tenc._encode_b_frame = push_ref, b_frame
    got = _run(tenc, frames)
    if direct == 3:
        assert got == _run(jenc, frames)
        assert tenc._direct_score == jenc._direct_score
    else:
        with pytest.raises(OverflowError):
            _run(jenc, frames)
    assert tenc.stats.b_frames == 4
    dec, jd = decode_annexb(got), jdec(got)
    assert [f.slice_type for f in dec] == [f.slice_type for f in jd]
    assert sorted(recon) == sorted(f.poc // 2 for f in dec)
    for a, b in zip(dec, jd):
        for pl, r, s in zip(("y", "u", "v"), recon[a.poc // 2], (1, 2, 2)):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(
                getattr(a, pl), r[:H // s, :W // s],
                err_msg="display %d plane %s" % (a.poc // 2, pl))
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    _check_payload(got, tenc, len(frames))


@pytest.mark.parametrize("n_valid", [2, 1])
def test_analyse_b_frame_mref_matches_reference(n_valid):
    """The 16x16 B analysis at two references (per entry B6, B7, the
    tables and the subpel refine; the L0 merge at the SATD level with
    te(v) ref bits, an entry past n_valid penalised) on seeded planes
    against the reference's `analyse_b_frame_mref` with the per-entry
    weights its encoder passes (plain 32s without weightb), at this
    file's me_range, whose program the B runs above compiled."""
    from video_steganography_pcamv_tpu.encoder import bslice as JB
    from video_steganography_pcamv_torch.encoder import bslice as TB
    from video_steganography_pcamv_torch.encoder.me import lambda_tab
    from test_torch_bframes import _refs, _stack_j, _stack_t
    (t0, t1, t2), (j0, j1, j2), cur = _refs(3, 62 + n_valid)
    lam, rng = lambda_tab(28), 16
    got = TB.analyse_b_frame(torch.as_tensor(cur),
                             _stack_t([t0, t1])["luma"], n_valid,
                             t2["luma"], rng, MBH, MBW, lam)
    want = JB.analyse_b_frame_mref(
        jnp.asarray(cur), _stack_j([j0, j1])["luma"], jnp.asarray(n_valid),
        j2["luma"], rng, MBH, MBW, lam, 2, False, 2,
        w1=jnp.full((2,), 32, jnp.int32))
    for name, a, b in zip(("mv0", "c0", "ref0", "mv1", "c1", "cbi"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert bool((got[2].numpy() == 1).any()) == (n_valid == 2)
