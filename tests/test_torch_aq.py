"""Adaptive quantization (x264 --aq-mode 1) in the port vs the JAX
reference on the CPU, exact unless a line says otherwise.

Ops, on seeded numpy inputs: `ops.aq.aq_offsets` bit-equal to the
reference's jitted `aq_offsets` on random planes with bright flat MBs,
and on the planes of ROADMAP F6 (the reference's int32 wrap: a flat MB
of luma 250 with chroma 128 gets +9.953049 at strength 1 where exact
arithmetic gives -14.999752); the port's float32 log2 bit-equal to
`jax.jit(jnp.log2)` on every integer 1..2^25 (ROADMAP C8);
`assign_qp_grid` / `effective_qp_grid`; the quant ops at per-MB qps; the
fused luma encode's plain version and the trellis path at a per-MB grid,
with and without noise reduction, against the reference's
`luma_p_encode(cur, pred, qp[N], ...)`; `edge_params` and the plain
deblocker under qp maps against the reference's `edge_params` and
`deblock_frame_device`.

Streams, byte-equal to the JAX `Encoder` (headers included), one JAX run
each (module-scoped), with the port's decoder equal to the JAX decoder
and to the encoder's recon on every frame and both extractors
recovering the payload: bench.py's Params with `aq_mode` 1 at one
reference on the CPU branch (IDR + 4 P; the unfused one-reference P
path), the same at `aq_strength` 0.5 and 2.0, `ref_frames` 2 under
CAVLC, config 3 (transform_8x8, rd 1, CABAC, trellis 1) with cqm jvt,
NR 400 and `aq_strength` 1.5 (last: the reference swaps its
process-wide tables), and the accelerator branch (3 frames, through
tests/test_torch_encoder_accel.py's fixture). B frames under AQ are in
tests/test_torch_bframes.py beside config 4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import inter as J_INTER
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import aq as J_AQ
from video_steganography_pcamv_tpu.ops import cqm as J_CQM
from video_steganography_pcamv_tpu.ops import deblock_jax as DJ
from video_steganography_pcamv_tpu.ops import deblock_pallas as DP
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.ops import transform8 as JT8
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import inter as T_INTER
from video_steganography_pcamv_torch.encoder.core import check_slice
from video_steganography_pcamv_torch.ops import aq as AQ
from video_steganography_pcamv_torch.ops import deblock as DB
from video_steganography_pcamv_torch.ops import lumap as LP
from video_steganography_pcamv_torch.ops import transform as TT
from video_steganography_pcamv_torch.ops import transform8 as TT8
from video_steganography_pcamv_torch.ops.blocks import mb_tiles
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames)

from test_torch_encoder_accel import reference_accel  # noqa: F401


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
    """The config-3 case installs jvt in the reference's process-wide
    tables: flat again for the modules after this one."""
    J_CQM.set_cqm()
    yield
    J_CQM.set_cqm()


W, H = 112, 80
EM_RATE, KEY = 64, 99


def _planes(seed, mbh=5, mbw=7):
    """Random source planes with bright flat MBs (the F6 wrap) and a
    dark one."""
    g = np.random.default_rng(seed)
    y = g.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.int32)
    u = g.integers(0, 256, (8 * mbh, 8 * mbw)).astype(np.int32)
    v = g.integers(0, 256, (8 * mbh, 8 * mbw)).astype(np.int32)
    y[:32, :32], y[32:48, :16], y[48:64, 16:32] = 250, 200, 12
    y[64:, 48:] //= 8
    u[:16, :16] = v[:16, :16] = 128
    return y, u, v


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0, 1.5, 3.0])
def test_aq_offsets_bit_equal_to_reference(strength):
    for seed in (1, 2):
        y, u, v = _planes(seed)
        want = np.asarray(J_AQ.aq_offsets(
            *(jnp.asarray(a) for a in (y, u, v)), 5, 7,
            jnp.float32(strength)))
        got = AQ.aq_offsets(*(torch.as_tensor(a) for a in (y, u, v)), 5, 7,
                            strength).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("luma", [200, 250])
def test_f6_the_references_int32_wrap_is_kept(luma):
    """ROADMAP F6: a flat MB whose luma sum exceeds 46340 wraps in the
    reference's int32 `s * s`, so it gets a coarser qp where exact
    arithmetic gives a finer one; the port's offset is the reference's,
    wrap included."""
    y = np.full((16, 16), luma, np.int32)
    c = np.full((8, 8), 128, np.int32)
    want = np.asarray(J_AQ.aq_offsets(jnp.asarray(y), jnp.asarray(c),
                                      jnp.asarray(c), 1, 1,
                                      jnp.float32(1.0)))
    got = AQ.aq_offsets(torch.as_tensor(y), torch.as_tensor(c),
                        torch.as_tensor(c), 1, 1, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # exact arithmetic: the variance of a flat MB is 0, energy max(0, 1)
    exact = np.float32(1.0397) * (np.log2(np.float32(1.0))
                                  - np.float32(14.427))
    assert abs(float(exact) - (-14.999752)) < 1e-5
    assert float(got[0, 0]) > 0
    if luma == 250:
        assert got[0, 0] == np.float32(9.953049)


def test_log2_is_xlas_on_every_integer_to_2_25():
    """ROADMAP C8: the port's float32 log2 is XLA's CPU routine (its
    polynomial with the compiled code's FMAs), bit for bit, on every
    integer 1..2^25; torch's own log2 is not."""
    log2 = jax.jit(jnp.log2)
    step = 1 << 22
    torch_differs = 0
    for lo in range(1, (1 << 25) + 1, step):
        x = np.arange(lo, lo + step, dtype=np.float32)
        want = np.asarray(log2(x))
        got = AQ.log2_xla(torch.from_numpy(x)).numpy()
        bad = np.nonzero(got.view(np.uint32) != want.view(np.uint32))[0]
        assert bad.size == 0, "log2 differs at %s" % x[bad[:5]]
        if lo == 1:
            torch_differs = int((torch.log2(torch.from_numpy(x)).numpy()
                                 != want).sum())
    assert torch_differs > 0


@pytest.mark.parametrize("qp", [10, 26, 45])
def test_qp_grids_equal_reference(qp):
    g = np.random.default_rng(qp)
    offs = (g.normal(0, 4, (6, 9)) + g.choice([0.0, 0.5, -0.5], (6, 9))) \
        .astype(np.float32)
    offs[0, :3] = [0.49, 0.51, -0.5]
    for lo, hi in ((0, 51), (12, 40)):
        want = J_AQ.assign_qp_grid(qp, offs, lo, hi)
        got = AQ.assign_qp_grid(qp, offs, lo, hi)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        coded = g.random((6, 9)) < 0.6
        np.testing.assert_array_equal(
            AQ.effective_qp_grid(got, coded, qp),
            J_AQ.effective_qp_grid(want, coded, qp))
    np.testing.assert_array_equal(
        AQ.chroma_grid(want, 2),
        JT.CHROMA_QP_TABLE[np.clip(want + 2, 0, 51)].astype(np.int32))


def test_quant_ops_at_per_mb_qps_equal_reference():
    """The 4x4, DC and 8x8 quant and dequant ops at per-MB qps (both
    classes, qbits on both sides of 0), shaped as the reference's
    encoders shape them."""
    g = np.random.default_rng(5)
    n = 12
    qp = g.integers(0, 52, n).astype(np.int32)
    qp[:3] = [0, 23, 51]
    coef = g.integers(-3000, 3001, (n, 4, 4, 4, 4)).astype(np.int32)
    lev = g.integers(-300, 301, (n, 4, 4, 4, 4)).astype(np.int32)
    dc = g.integers(-3000, 3001, (n, 4, 4)).astype(np.int32)
    c8 = g.integers(-3000, 3001, (n, 2, 2, 8, 8)).astype(np.int32)
    l8 = g.integers(-200, 201, (n, 2, 2, 8, 8)).astype(np.int32)
    qt, qj = torch.as_tensor(qp), jnp.asarray(qp)
    qjb = qj[:, None, None]

    def eq(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for intra in (True, False):
        eq(TT.quant4x4(torch.as_tensor(coef), qt, intra),
           JT.quant4x4(jnp.asarray(coef), qjb, intra))
        eq(TT.dequant4x4(torch.as_tensor(lev), qt, intra),
           JT.dequant4x4(jnp.asarray(lev), qjb, intra))
        eq(TT.quant_dc(torch.as_tensor(dc), qt, intra),
           JT.quant_dc(jnp.asarray(dc), qjb, intra))
        eq(TT.dequant_dc_chroma(torch.as_tensor(dc[:, :2, :2]), qt, intra),
           JT.dequant_dc_chroma(jnp.asarray(dc[:, :2, :2]), qjb, intra))
        eq(TT8.quant8x8(torch.as_tensor(c8), qt, intra),
           JT8.quant8x8(jnp.asarray(c8), qj, intra))
        eq(TT8.dequant8x8(torch.as_tensor(l8), qt, intra),
           JT8.dequant8x8(jnp.asarray(l8), qj, intra))
        eq(TT8.quant8x8(torch.as_tensor(c8[:, 0, 0]), qt, intra),
           JT8.quant8x8(jnp.asarray(c8[:, 0, 0]), qj, intra))
    eq(TT.dequant_dc_luma(torch.as_tensor(dc), qt),
       JT.dequant_dc_luma(jnp.asarray(dc), qjb))


@pytest.mark.parametrize("trellis,nr", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_luma_encode_at_a_per_mb_grid_matches_reference(trellis, nr):
    """The fused luma encode's plain version (its three instances: the
    DCT entry, the NR instance, the levels-in entry under trellis) at a
    per-MB qp grid against the reference's luma_p_encode(cur, pred,
    qp[N], ...); the wrapper on CPU tensors is the plain version."""
    g = np.random.default_rng(7 + 2 * trellis + nr)
    mbh, mbw = 2, 3
    n = mbh * mbw
    y = g.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.int32)
    cur = mb_tiles(torch.as_tensor(y), 16).numpy()
    noise = np.round(g.laplace(0, 9, (n, 16, 16))).astype(np.int32)
    pred = np.clip(cur + noise, 0, 255).astype(np.int32)
    qp = g.integers(10, 52, n).astype(np.int32)
    qp[:2] = [10, 51]
    off = g.integers(0, 40, (4, 4)).astype(np.int32) if nr else None
    args = (jnp.asarray(cur), jnp.asarray(pred), jnp.asarray(qp), True,
            trellis) + ((jnp.asarray(off),) if nr else ())
    want = J_INTER.luma_p_encode(*args)
    yt, pt, qt = (torch.as_tensor(a) for a in (y, pred, qp))
    ot = None if off is None else torch.as_tensor(off)
    if trellis:
        got = T_INTER.luma_encode(yt, pt, qt, trellis=True, nr_offset=ot)
    else:
        got = LP.luma_p_encode_plain(yt, pt, qt, nr_offset=ot)
        wrapped = LP.luma_p_encode(yt, pt, qt, nr_offset=ot)
        for a, b in zip(wrapped, got):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if nr:
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[2]))
    # the grid is read per MB: the same MBs at their mean qp differ
    flat = LP.luma_p_encode_plain(yt, pt, int(qp.mean()))[1]
    assert not torch.equal(flat, got[1])


@pytest.mark.parametrize("mbh,mbw,off_a,off_b,t8", [
    (4, 6, 0, 0, False), (3, 7, 4, -2, True)])
def test_deblock_under_qp_maps_matches_reference(mbh, mbw, off_a, off_b, t8):
    """`edge_params` and the plain deblocker with per-MB qp and chroma qp
    maps (the decoder-visible chain, qps 0-51, some MBs at or below
    qp_thresh) against the reference's."""
    g = np.random.default_rng(mbh * 10 + mbw)
    H_, W_ = 16 * mbh, 16 * mbw
    base = g.integers(60, 180, (mbh, mbw))
    y = np.clip(np.repeat(np.repeat(base, 16, 0), 16, 1)
                + g.integers(-24, 25, (H_, W_)), 0, 255)
    u = np.clip(128 + g.integers(-24, 25, (H_ // 2, W_ // 2)), 0, 255)
    v = np.clip(128 + g.integers(-24, 25, (H_ // 2, W_ // 2)), 0, 255)
    intra = (g.random((mbh, mbw)) < 0.15).astype(np.int32)
    skip = ((g.random((mbh, mbw)) < 0.2) & (intra == 0)).astype(np.int32)
    nnz4 = (g.random((4 * mbh, 4 * mbw)) < 0.5).astype(np.int32)
    mv4 = np.repeat(np.repeat(g.integers(-20, 21, (2 * mbh, 2 * mbw, 2)), 2,
                              0), 2, 1).astype(np.int32)
    trans8 = (g.random((mbh, mbw)) < 0.5).astype(np.int32) if t8 else None
    qp = g.integers(0, 52, (mbh, mbw)).astype(np.int32)
    qpc = JT.CHROMA_QP_TABLE[np.clip(qp + 1, 0, 51)].astype(np.int32)
    thresh = 15 - min(off_a, off_b)
    maps = [np.ascontiguousarray(a, np.int32)
            for a in (intra, skip, nnz4, mv4)]
    kw = dict(qp_thresh=thresh, off_a=off_a, off_b=off_b)
    want = DP.edge_params(*(jnp.asarray(a) for a in maps), jnp.asarray(qp),
                          jnp.asarray(qpc), mbh, mbw,
                          trans8=None if trans8 is None
                          else jnp.asarray(trans8), **kw)
    got = DB.edge_params(*(torch.as_tensor(a) for a in maps),
                         torch.as_tensor(qp), torch.as_tensor(qpc), mbh, mbw,
                         trans8=None if trans8 is None
                         else torch.as_tensor(trans8), **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    planes = [np.ascontiguousarray(a, np.int32) for a in (y, u, v)]
    out = DB.deblock_frame(*(torch.as_tensor(a) for a in planes + maps),
                           torch.as_tensor(qp), torch.as_tensor(qpc), mbh,
                           mbw, trans8=None if trans8 is None
                           else torch.as_tensor(trans8), **kw)
    ref = DJ.deblock_frame_device(*(jnp.asarray(a) for a in planes + maps),
                                  jnp.asarray(qp), jnp.asarray(qpc), mbh,
                                  mbw, trans8=None if trans8 is None
                                  else jnp.asarray(trans8), **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_check_slice_admits_aq_and_refuses_the_rest():
    def params(**kw):
        return TP.Params(width=W, height=H, aq_mode=1,
                         stego=TP.StegoParams(em_rate=EM_RATE, key=KEY),
                         **kw)
    for kw in (dict(), dict(aq_strength=0.0), dict(aq_strength=3.0),
               dict(ref_frames=2), dict(bframes=2, cabac=True),
               dict(transform_8x8=True, rd=1, cabac=True, trellis=1)):
        p = params(**kw)
        p.validate()
        check_slice(p)
    p = params(zones="0,9,q=30")
    p.validate()
    with pytest.raises(NotImplementedError, match="zones"):
        check_slice(p)
    # embedding needs the partition path under AQ (the reference's
    # Params.validate asserts it)
    p = params(partitions=False, deblock_device=False)
    with pytest.raises(AssertionError):
        p.validate()
    with pytest.raises(NotImplementedError, match="aq_mode"):
        check_slice(p)


# ---------------------------------------------------------------------------
# streams

def _kw(**kw):
    """bench.py's serving Params at 112x80 with aq_mode 1, on the
    reference's CPU branch."""
    return dict(dict(width=W, height=H, qp=26, me_range=16,
                     deblock_device=True, psnr=False, tail_kernel=False,
                     aq_mode=1), **kw)


def _jax_params(kw):
    jp = Params(**{k: v for k, v in kw.items() if k != "tail_kernel"},
                stego=StegoParams(em_rate=EM_RATE, key=KEY))
    jp.tail_kernel = kw["tail_kernel"]
    jp.pipeline_deep = False
    return jp


def _run_pair(kw, n_frames):
    """One JAX run and one port run on the same frames; the port's
    deblocked recon of every frame kept."""
    frames = synthetic_sequence(W, H, n_frames, seed=7)
    jenc = JEncoder(_jax_params(kw))
    want = jenc.headers() + b"".join(jenc.encode_frame(f) for f in frames) \
        + jenc.flush()
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    recon, grids = [], []
    got = tenc.headers()
    for f in frames:
        got += tenc.encode_frame(f)
        recon.append(tuple(t.numpy() for t in tenc.recon_prev))
        grids.append(tenc.aq_grids[0].copy())
    got += tenc.flush()
    return dict(want=want, got=got, jenc=jenc, tenc=tenc, recon=recon,
                grids=grids, n=n_frames)


def test_accel_branch_stream_byte_equal(reference_accel):
    """The reference's accelerator branch under AQ (its unfused
    `analyse_p_frame_parts` with the Pallas full-pel scan, in interpret
    mode) against the port with `tail_kernel=True`, 3 frames."""
    J_CQM.set_cqm()
    r = _run_pair(_kw(tail_kernel=True), 3)
    assert reference_accel["fullpel"] >= 1
    assert r["got"] == r["want"]
    dec, jdec = decode_annexb(r["got"]), j_decode(r["got"])
    for a, b, rec in zip(dec, jdec, r["recon"]):
        for pl, want, s in zip(("y", "u", "v"), rec, (1, 2, 2)):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(getattr(a, pl),
                                          want[:H // s, :W // s])
    sent = r["tenc"]._stego.sent_messages
    for rec in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(r["got"], em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


_RUNS = {
    "main": (_kw(), 5),
    "strength_0.5": (_kw(aq_strength=0.5), 4),
    "strength_2.0": (_kw(aq_strength=2.0), 4),
    "ref2_cavlc": (_kw(ref_frames=2), 4),
    # last: cqm jvt swaps the reference's tables
    "config3_jvt_nr": (_kw(cabac=True, transform_8x8=True, rd=1, trellis=1,
                           cqm="jvt", noise_reduction=400,
                           aq_strength=1.5), 4),
}


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, case):
    if case not in runs:
        runs[case] = _run_pair(*_RUNS[case])
    return runs[case]


CASES = list(_RUNS)


@pytest.mark.parametrize("case", CASES)
def test_stream_byte_equal_to_reference(case, runs):
    r = _get(runs, case)
    assert r["tenc"].headers() == r["jenc"].headers()
    assert r["got"] == r["want"]
    # AQ reached the stream: every grid spans qps
    assert all(g.min() < g.max() for g in r["grids"])
    assert r["tenc"].stats.p_frames == r["n"] - 1


@pytest.mark.parametrize("case", CASES)
def test_decoders_agree_with_the_recon(case, runs):
    """The port's decoder equals the JAX decoder and the encoder's
    deblocked recon on every frame."""
    r = _get(runs, case)
    dec, jdec = decode_annexb(r["got"]), j_decode(r["got"])
    assert len(dec) == len(jdec) == r["n"]
    for a, b, rec in zip(dec, jdec, r["recon"]):
        for pl, want, s in zip(("y", "u", "v"), rec, (1, 2, 2)):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(getattr(a, pl),
                                          want[:H // s, :W // s])


@pytest.mark.parametrize("case", CASES)
def test_both_extractors_recover_the_payload(case, runs):
    r = _get(runs, case)
    sent = r["tenc"]._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(decode_annexb(r["got"]),
                                    em_rate=EM_RATE),
                j_extract(r["got"], em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)
