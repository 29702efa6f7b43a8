"""The port's own copies of the reference's jax-free modules: its
decoder against the reference decoder (slice types, MB types, unit MVs
and recon planes) on x264's streams (CAVLC I/P, deblocking off, three
references, and the CABAC B streams of `--bframes 2` and of `--b-pyramid
--weightb`, whose B slices are deblocked and implicitly weighted) and on
a port-encoded stream, its blind extractor against the reference's, and
its Params against the reference's Params."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu import params as JP
from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)

from video_steganography_pcamv_torch import Encoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.stego.extract import extract_from_stream
from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFSTREAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "refstreams")
EM_RATE, KEY = 64, 99


@pytest.fixture(scope="module")
def port_stream():
    """A port-encoded 112x80 stream (the accelerator branch, the
    default), six frames, with its sent payload."""
    p = TP.Params(width=112, height=80, qp=26, me_range=16,
                  deblock_device=True, psnr=False,
                  stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    enc = Encoder(p, device="cpu")
    frames = synthetic_sequence(112, 80, 6, seed=3)
    bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    return bs, enc._stego.sent_messages


def _stream(name, port_stream):
    if name == "port_112x80":
        return port_stream[0]
    with open(os.path.join(REFSTREAMS, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["cavlc_q26.264", "deblock_off.264",
                                  "mref3.264", "bframes2.264",
                                  "bpyramid.264", "port_112x80"])
def test_decoder_matches_reference(name, port_stream):
    data = _stream(name, port_stream)
    got, want = decode_annexb(data), j_decode(data)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.slice_type == w.slice_type
        assert [m.mb_type for m in g.mbs] == [m.mb_type for m in w.mbs]
        assert [m.unit_mvs for m in g.mbs] == [m.unit_mvs for m in w.mbs]
        for plane in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane), err_msg=plane)


def test_extractor_matches_reference(port_stream):
    bs, sent = port_stream
    got = extract_from_stream(bs, em_rate=EM_RATE, key=KEY)
    want = j_extract(bs, em_rate=EM_RATE, key=KEY)
    assert len(got) == len(want) == len(sent)
    assert sum(len(s) for s in sent) > 0
    for g, w, s in zip(got, want, sent):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("cls", ["Params", "StegoParams"])
def test_params_fields_and_defaults_equal(cls):
    t, j = getattr(TP, cls)(), getattr(JP, cls)()
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    assert tf == jf
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.tail_kernel if cls == "Params" else True
