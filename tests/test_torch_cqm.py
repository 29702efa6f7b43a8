"""Custom quantization matrices and the deadzones (x264 --cqm jvt,
--cqm4*/--cqm8*, --deadzone-inter/intra) in the port vs the JAX
reference on the CPU.

Tables: the port's `ops.cqm.QuantTables` (4x4 and 8x8, intra and inter,
the trellis's zigzag tables) equal the reference's `_build_tables` /
`build_tables8` / `_mf_unq_zig(version)` for flat, jvt, custom lists and
deadzones 0, 6 and 32. Ops: the 4x4, DC and 8x8 quant/dequant under jvt
equal the reference's at qp 0, 20 and 26 with coefficients up to
+-2^15, where the products wrap and the low-qp dequant rounds.

Streams, byte-equal to the JAX `Encoder` (both decoders equal frame by
frame, both extractors recover the payload): custom 8x8 lists under
`cqm="flat"` with the 8x8 transform (ROADMAP F5: the port used to admit
and drop them); jvt on the pipelined main path with the incremental
re-encode, on both branches (the accelerator one through
tests/test_torch_encoder_accel.py's fixture); jvt on config 3 under
CABAC with trellis 1; jvt with B frames at ref_frames 2; custom 4x4
lists at qp 20 together with the deadzones 6/30. Two port encoders with different
quantizers, interleaved frame by frame in one process, each give the
stream they give alone.

The reference keeps its CQM as process state (every JAX `Encoder`
installs its own and clears the JAX compile caches when it changes), so
the cases are grouped by CQM and the module restores the flat tables
when it ends."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import cqm as J_CQM
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.ops import transform8 as JT8
from video_steganography_pcamv_tpu.ops import trellis as J_TR
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import core as T_CORE
from video_steganography_pcamv_torch.ops import cqm as CQ
from video_steganography_pcamv_torch.ops import transform as TT
from video_steganography_pcamv_torch.ops import transform8 as TT8
from video_steganography_pcamv_torch.ops import trellis as T_TR
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames)

from test_torch_encoder8 import config3_frames
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
    """Leave the reference's process-wide CQM flat for the modules that
    run after this one in the same worker."""
    yield
    J_CQM.set_cqm()


W, H = 112, 80
EM_RATE, KEY = 64, 99
LIST8 = tuple(int(x) for x in np.arange(64) % 40 + 8)
LIST4I = (8, 11, 14, 17, 11, 14, 17, 20, 14, 17, 20, 23, 17, 20, 23, 26)
LIST4P = (20, 18, 16, 14, 18, 16, 14, 12, 16, 14, 12, 10, 14, 12, 10, 9)


def _lists(kw):
    """The reference Encoder's list rules (core.py:298-312)."""
    if kw.get("cqm") == "jvt":
        return [kw.get("cqm4i", J_CQM.JVT4I), kw.get("cqm4p", J_CQM.JVT4P),
                kw.get("cqm8i", J_CQM.JVT8I), kw.get("cqm8p", J_CQM.JVT8P)]
    return [kw.get(k) for k in ("cqm4i", "cqm4p", "cqm8i", "cqm8p")]


QUANT_CASES = {
    "flat": {},
    "jvt": dict(cqm="jvt"),
    "custom": dict(cqm4i=LIST4I, cqm4p=LIST4P, cqm8i=LIST8,
                   cqm8p=LIST8[::-1]),
    "dz0": dict(deadzone_inter=0, deadzone_intra=0),
    "dz6": dict(cqm="jvt", deadzone_inter=6, deadzone_intra=6),
    "dz32": dict(deadzone_inter=32, deadzone_intra=32),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_tables_equal_reference(case):
    kw = QUANT_CASES[case]
    p = TP.Params(width=W, height=H, **kw)
    p.validate()
    qt = CQ.from_params(p)
    i4, p4, i8, p8 = _lists(kw)
    dzi, dzp = 32 - p.deadzone_intra, 32 - p.deadzone_inter
    mf_i, bias_i, _, dmf_i = JT._build_tables(i4, deadzone_intra=dzi)
    mf_p, _, bias_p, dmf_p = JT._build_tables(p4, deadzone_inter=dzp)
    for got, want in ((qt.mf4, [mf_i, mf_p]), (qt.bias4, [bias_i, bias_p]),
                      (qt.dmf4, [dmf_i, dmf_p])):
        np.testing.assert_array_equal(got, np.stack(want))
    for got, want in zip((qt.mf8, qt.bias8, qt.dmf8),
                         JT8.build_tables8(i8, p8, dzi, dzp)):
        np.testing.assert_array_equal(got, want)
    # the trellis rates against the same tables as the reference's
    # _mf_unq_zig(cqm_version) after its set_cqm
    J_CQM.set_cqm(i4, p4, i8, p8, dz_intra=dzi, dz_inter=dzp)
    v = J_CQM.version()
    for got, want in ((T_TR._mf_unq_zig(qt), J_TR._mf_unq_zig(v)),
                      (T_TR._mf_unq_zig8(qt), J_TR._mf_unq_zig8(v))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (qt == CQ.FLAT) == (case == "flat")
    assert qt.is_flat == (case in ("flat", "dz0", "dz32"))


@pytest.mark.parametrize("qp", [0, 20, 26])
def test_ops_under_jvt_equal_reference(qp):
    """The quant and dequant ops with the jvt tables, against the
    reference's with jvt installed: 4x4 and DC (luma, chroma) in both
    classes and 8x8, with coefficients up to +-2^15 (the quant product
    leaves int32 at low qp and wraps) and levels whose dequant rounds
    below qp 24 (qbits < 0)."""
    J_CQM.set_preset("jvt")
    qt = CQ.from_params(TP.Params(width=W, height=H, cqm="jvt"))
    g = np.random.default_rng(qp)
    coef = g.integers(-(1 << 15), 1 << 15, (6, 4, 4, 2, 2)).astype(np.int32)
    coef[0] = g.integers(-300, 301, (4, 4, 2, 2))
    lev = g.integers(-2000, 2001, (6, 4, 4, 2, 2)).astype(np.int32)
    dc = coef[:, 0, 0]
    ct, lt, dct = (torch.as_tensor(a) for a in (coef, lev, dc))

    def eq(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    for intra in (True, False):
        eq(TT.quant4x4(ct, qp, intra, tables=qt),
           JT.quant4x4(jnp.asarray(coef), qp, intra))
        eq(TT.dequant4x4(lt, qp, intra, tables=qt),
           JT.dequant4x4(jnp.asarray(lev), qp, intra))
        eq(TT.quant_dc(dct, qp, intra, tables=qt),
           JT.quant_dc(jnp.asarray(dc), qp, intra))
        eq(TT.dequant_dc_chroma(lt[:, 0, 0], qp, intra, tables=qt),
           JT.dequant_dc_chroma(jnp.asarray(lev[:, 0, 0]), qp, intra))
    eq(TT.dequant_dc_luma(lt[:, 0, 0], qp, tables=qt),
       JT.dequant_dc_luma(jnp.asarray(lev[:, 0, 0]), qp))
    # the wrap is real: some product of this case leaves int32
    if qp == 0:
        mf = np.asarray(JT.QUANT4_MF_I)[qp].astype(np.int64)
        assert ((np.abs(coef).astype(np.int64) * mf[:, :, None, None])
                >= (1 << 31)).any()
    c8 = g.integers(-(1 << 15), 1 << 15, (3, 8, 8)).astype(np.int32)
    l8 = g.integers(-2000, 2001, (3, 8, 8)).astype(np.int32)
    tabs8 = JT8.build_tables8(J_CQM.JVT8I, J_CQM.JVT8P)
    for intra in (True, False):
        eq(TT8.quant8x8(torch.as_tensor(c8), qp, intra, tables=qt),
           JT8.quant8x8(jnp.asarray(c8), qp, intra, tables=tabs8))
        eq(TT8.dequant8x8(torch.as_tensor(l8), qp, intra, tables=qt),
           JT8.dequant8x8(jnp.asarray(l8), qp, intra, tables=tabs8))


def _kw(**kw):
    """bench.py's serving Params at 112x80 on the reference's CPU
    branch."""
    return dict(dict(width=W, height=H, qp=26, me_range=16,
                     deblock_device=True, psnr=False, tail_kernel=False),
                **kw)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def _jax_params(kw, em_rate=EM_RATE):
    jp = Params(**{k: v for k, v in kw.items() if k != "tail_kernel"},
                stego=StegoParams(em_rate=em_rate, key=KEY))
    jp.tail_kernel = kw.get("tail_kernel", True)
    jp.pipeline_deep = False
    return jp


def _port(kw, em_rate=EM_RATE):
    return TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=em_rate,
                                                         key=KEY)),
                    device="cpu")


def check_decode_and_payload(got, n_frames, sent, em_rate=EM_RATE):
    """The port's decoder equals the JAX decoder frame by frame; both
    extractors recover the sent payload."""
    dec, jdec = decode_annexb(got), j_decode(got)
    assert len(dec) == len(jdec) == n_frames
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(dec, em_rate=em_rate),
                j_extract(got, em_rate=em_rate, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)
    return dec


def _byte_equal(kw, frames, em_rate=EM_RATE):
    """The JAX Encoder's stream and headers against the port's."""
    jenc = JEncoder(_jax_params(kw, em_rate))
    want = _run(jenc, frames)
    tenc = _port(kw, em_rate)
    got = _run(tenc, frames)
    assert tenc.headers() == jenc.headers()
    assert got == want
    return tenc, got


def test_f5_custom_8x8_lists_under_flat_cqm():
    """ROADMAP F5: cqm8i/cqm8p with cqm="flat" and the 8x8 transform.
    The lists go into a High-profile SPS and quantize the 8x8 blocks
    (intra and inter), as in the reference; the port used to accept the
    Params and drop the lists."""
    frames = config3_frames(4, W, H)
    kw = _kw(transform_8x8=True, rd=1, cqm8i=LIST8, cqm8p=LIST8[::-1])
    tenc, got = _byte_equal(kw, frames)
    assert tenc.sps.scaling8_intra is not None
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs > 0
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)


@pytest.fixture
def incremental_log(monkeypatch):
    """Counts the port's incremental pass-2 re-encodes."""
    log = []
    orig = T_CORE.reencode_p_incremental

    def wrap(*a, **kw):
        log.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(T_CORE, "reencode_p_incremental", wrap)
    return log


# few payload bits a frame, so that the flips touch few MBs and pass 2
# takes the incremental re-encode
EM_FEW = 8


def test_jvt_main_path_cpu_branch(incremental_log):
    frames = synthetic_sequence(W, H, 4, seed=7)
    tenc, got = _byte_equal(_kw(cqm="jvt"), frames, EM_FEW)
    assert tenc.sps.profile == 100 and tenc.sps.scaling4_intra is not None
    assert incremental_log, "no P frame took the incremental re-encode"
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages,
                             EM_FEW)


def test_jvt_main_path_accel_branch(reference_accel, incremental_log):
    frames = synthetic_sequence(W, H, 4, seed=7)
    tenc, got = _byte_equal(_kw(cqm="jvt", tail_kernel=True), frames,
                            EM_FEW)
    assert reference_accel["fullpel"] >= 1 and reference_accel["tail"] >= 1
    assert incremental_log, "no P frame took the incremental re-encode"
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages,
                             EM_FEW)


def test_jvt_config3_cabac_trellis():
    frames = config3_frames(4, W, H)
    kw = _kw(cqm="jvt", transform_8x8=True, rd=1, cabac=True, trellis=1)
    tenc, got = _byte_equal(kw, frames)
    assert tenc.stats.i8x8_mbs > 0
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)


def test_jvt_bframes_ref2():
    """jvt with B frames (b_adapt 0, CABAC) at ref_frames 2: the anchors
    on the multi-reference path, the B encode with the inter lists."""
    frames = synthetic_sequence(W, H, 4, seed=9)
    kw = _kw(cqm="jvt", bframes=2, b_adapt=0, ref_frames=2, cabac=True)
    tenc, got = _byte_equal(kw, frames)
    assert tenc.stats.b_frames == 2
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)


def test_custom_4x4_lists_at_qp20_and_deadzones():
    """Custom 4x4 lists (intra and inter, so chroma too) at qp 20, where
    the dequant of every class rounds (qbits < 0), with the deadzones
    6/30 (bias numerators 26 inter, 2 intra) in the same stream: one
    CQM switch of the reference for both."""
    frames = synthetic_sequence(W, H, 4, seed=7)
    kw = _kw(qp=20, cqm4i=LIST4I, cqm4p=LIST4P, deadzone_inter=6,
             deadzone_intra=30)
    tenc, got = _byte_equal(kw, frames)
    assert tenc.qt.dz_inter == 26 and tenc.qt.dz_intra == 2
    assert tenc.sps.scaling8_intra is None
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)


def test_two_port_encoders_interleaved():
    """Two encoders with different quantizers in one process, fed frame
    by frame in turn, each give the stream they give alone: no module of
    the port holds the active tables."""
    frames = synthetic_sequence(W, H, 4, seed=7)
    kws = [_kw(cqm="jvt", deadzone_inter=6, deadzone_intra=30),
           _kw(cqm4p=LIST4P, cqm8i=LIST8, transform_8x8=True)]
    alone = [_run(_port(kw), frames) for kw in kws]
    encs = [_port(kw) for kw in kws]
    outs = [[], []]
    for f in frames:
        for e, o in zip(encs, outs):
            o.append(e.encode_frame(f))
    for e, o, want in zip(encs, outs, alone):
        assert b"".join(o) + e.flush() == want
    assert alone[0] != alone[1]
