"""The port's BASELINE config 3 (the 8x8 transform with rd 1, CAVLC, one
reference, no B frames) on the pipelined stego path, against the JAX
`Encoder` on its CPU branch (tail_kernel=False): byte-equal Annex-B
streams over IDR + 4 P frames for (transform_8x8, rd) in {(1, 1),
(1, 0), (0, 1)}, with Intra_8x8 MBs in the IDR and 8x8-transform P MBs
present; the port's decoder reproduces the JAX decoder's frames, and
both extractors recover the payload; the same under CABAC, where the
deblocker's nnz map of an 8x8-transform MB comes from its 8x8 blocks
whatever the entropy mode. The accelerator branch's config-3 case is in
tests/test_torch_encoder_accel.py."""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
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


W, H = 128, 96
EM_RATE, KEY = 64, 99


def config3_frames(n, w=W, h=H, seed=2):
    """Gradient + sine content (favours Intra_8x8 and the 8x8 transform)
    panning 2 pels a frame, with a textured band (favours 4x4)."""
    rng = np.random.RandomState(seed)
    pad = 40
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad]
    base = (40 + 0.8 * xx + 0.5 * yy
            + 14 * np.sin(xx / 9.0) * np.cos(yy / 13.0))
    band = (yy > (h + 2 * pad) // 2) & (yy < (h + 2 * pad) // 2 + 24)
    base = np.where(band, base + rng.randint(-50, 51, base.shape), base)
    out = []
    for i in range(n):
        s = 2 * i
        y = base[pad:pad + h, pad + s:pad + s + w] + rng.randn(h, w) * 2
        gy, gx = np.mgrid[0:h // 2, 0:w // 2]
        u = 100 + (gx + s // 2) // 2
        v = 150 - gy // 2
        out.append(Frame(*(np.ascontiguousarray(np.clip(a, 0, 255),
                                                np.uint8) for a in (y, u, v))))
    return out


def config3_kw(transform_8x8=True, rd=1):
    """bench.py's serving Params with the 8x8 transform and rd."""
    return dict(width=W, height=H, qp=26, me_range=16, deblock_device=True,
                psnr=False, transform_8x8=transform_8x8, rd=rd)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def check_decode_and_payload(got, n_frames, sent):
    """The port's decoder equals the JAX decoder frame by frame; both
    extractors recover the sent payload."""
    dec, jdec = decode_annexb(got), j_decode(got)
    assert len(dec) == len(jdec) == n_frames
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.mb_type for m in a.mbs] == [m.mb_type for m in b.mbs]
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(got, em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)
    return dec


@pytest.mark.parametrize("t8,rd", [(True, 1), (True, 0), (False, 1)],
                         ids=["trans8_rd1", "trans8_rd0", "rd1"])
def test_config3_stream_byte_equal_cpu_branch(t8, rd):
    frames = config3_frames(5)
    jp = Params(**config3_kw(t8, rd),
                stego=StegoParams(em_rate=EM_RATE, key=KEY))
    jp.tail_kernel = False
    jp.pipeline_deep = False
    want = _run(JEncoder(jp), frames)
    tp = TP.Params(**config3_kw(t8, rd),
                   stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    tp.tail_kernel = False
    tenc = TEncoder(tp, device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i_frames == 1 and tenc.stats.p_frames == 4
    dec = check_decode_and_payload(got, len(frames),
                                   tenc._stego.sent_messages)
    kinds = {m.mb_type for m in dec[0].mbs}
    if t8:
        assert tenc.stats.i8x8_mbs > 0 and "I8x8" in kinds
        assert tenc.stats.trans8_mbs > 0
    else:
        assert tenc.stats.i8x8_mbs == tenc.stats.trans8_mbs == 0


def test_config3_cabac_stream_byte_equal_cpu_branch():
    """Config 3 under CABAC (the cat-5 8x8 residuals, the transform
    flag's contexts), trans8 + rd 1 as in the first case above."""
    frames = config3_frames(5)
    jp = Params(**config3_kw(), cabac=True,
                stego=StegoParams(em_rate=EM_RATE, key=KEY))
    jp.tail_kernel = False
    want = _run(JEncoder(jp), frames)
    tp = TP.Params(**config3_kw(), cabac=True,
                   stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    tp.tail_kernel = False
    tenc = TEncoder(tp, device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs > 0
    dec = check_decode_and_payload(got, len(frames),
                                   tenc._stego.sent_messages)
    assert "I8x8" in {m.mb_type for m in dec[0].mbs}


def _cpu_branch_pair(rd=1, **kw):
    """The JAX and the port's Params of config 3 (rd as given) + kw on
    the CPU branch."""
    jp = Params(**config3_kw(rd=rd), **kw,
                stego=StegoParams(em_rate=EM_RATE, key=KEY))
    tp = TP.Params(**config3_kw(rd=rd), **kw,
                   stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    jp.tail_kernel = tp.tail_kernel = False
    return jp, tp


def test_config3_trellis_stream_byte_equal_cpu_branch():
    """Config 3 under CABAC with trellis 1 (x264's --8x8dct --subme 7
    --trellis 1): the IDR's i16/i4/i8 levels, the P encodes' 4x4 levels
    (through the fused kernel's levels-in entry), the 8x8 candidate's
    cat-5 levels before the RD choice, and the chroma levels, in pass 1
    and the full pass 2. Trellis 2 codes as trellis 1 while embedding
    (its other uses are in the reference's stego-off branches)."""
    frames = config3_frames(5)
    jp, tp = _cpu_branch_pair(cabac=True, trellis=1)
    want = _run(JEncoder(jp), frames)
    tenc = TEncoder(tp, device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs > 0
    check_decode_and_payload(got, len(frames), tenc._stego.sent_messages)
    tp2 = _cpu_branch_pair(cabac=True, trellis=2)[1]
    assert tp2.trellis == 2
    got2 = _run(TEncoder(tp2, device="cpu"), frames)
    assert got2 != want and non_sei_nals(got2) == non_sei_nals(want)
    # the trellis changed the slices
    _, tp0 = _cpu_branch_pair(cabac=True)
    assert non_sei_nals(_run(TEncoder(tp0, device="cpu"), frames)) \
        != non_sei_nals(want)


def test_rd2_codes_as_rd1_while_embedding():
    """rd 2's uses in the reference (the partition re-rank, the skip
    force, the qpel refine) are all in its stego-off branches, so with
    stego on its stream is rd 1's; the port's rd 2 stream is that
    stream too."""
    frames = config3_frames(4)
    streams = [_run(JEncoder(_cpu_branch_pair(rd=rd)[0]), frames)
               for rd in (1, 2)]
    # the same slices: only the SEI's option string differs
    assert streams[0] != streams[1]
    assert non_sei_nals(streams[0]) == non_sei_nals(streams[1])
    tenc = TEncoder(_cpu_branch_pair(rd=2)[1], device="cpu")
    assert _run(tenc, frames) == streams[1]
    assert tenc.stats.trans8_mbs > 0


def non_sei_nals(bs: bytes) -> list:
    """The stream's NAL units but the SEI (x264's option string)."""
    return [n for n in bs.split(b"\x00\x00\x01") if n and n[0] & 31 != 6]
