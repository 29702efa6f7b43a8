"""The plain encoder (stego off) with intra MBs in B slices on the port
against the JAX `Encoder`, on the CPU.

The clips are the reference's `tests/test_intra_in_b.py`
`_novel_b_frames` (96x64: noise anchors around a smooth B frame the
anchors cannot predict, half of it the anchors' noise in the mixed
variant, so that one slice holds intra, inter and direct MBs), and a
five-frame variant for a pyramid; qp 28, me_range 4, bframes 1,
b_adapt 0, the Params of the reference's test. Streams, byte-equal AU
by AU to the reference, the port's decoder giving the port encoder's
recon on every frame, B frames included, and every B slice holding
intra MBs:

- the partition path under CAVLC (spatial direct) and under CABAC with
  temporal direct and the PPS's 8x8-transform flag; the 16x16 path
  under CAVLC and CABAC; a pyramid (bframes 3, its middle B a reference
  picture whose colocated fields carry the intra MBs as ref -1) at
  ref_frames 2.

The modules: `scan_b_parts` / `scan_b_frame` with `intra=` against the
reference's on random fields (spatial, temporal and no direct), and the
dependant rule of the port's intra compare (`Encoder._b_intra`: under
spatial direct an MB that a later direct MB reads as a neighbour stays
inter; under temporal direct nothing depends on the neighbours). All
equalities are exact (integer codec).
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder import bslice as JB
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import bslice as TB
from video_steganography_pcamv_torch.encoder.me import lambda_tab

from test_intra_in_b import _novel_b_frames


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 96, 64
MBW, MBH = W // 16, H // 16


def pyramid_frames():
    """Noise anchors around three smooth B frames, each its own
    gradient."""
    f0, _b, f2 = _novel_b_frames(seed=4)
    out = [f0]
    for k in range(3):
        g = (np.arange(H)[:, None] * (2 + k)
             + np.arange(W)[None, :] * (3 - k)).astype(np.uint8)
        out.append(Frame(g, f0.u.copy(), f0.v.copy()))
    return out + [Frame(255 - f2.y, f2.u.copy(), f2.v.copy())]


# case -> (clip, Params beyond the reference test's)
CASES = {
    "parts_cavlc": (lambda: _novel_b_frames(seed=2, mixed=True), {}),
    "parts_cabac_temporal_8x8": (
        lambda: _novel_b_frames(seed=2, mixed=True),
        dict(cabac=True, direct=2, transform_8x8=True)),
    "b16_cavlc": (lambda: _novel_b_frames(seed=1), dict(partitions=False)),
    "b16_cabac": (lambda: _novel_b_frames(seed=1),
                  dict(partitions=False, cabac=True)),
    "pyramid_ref2": (pyramid_frames, dict(bframes=3, b_pyramid=True,
                                          ref_frames=2)),
}


def _kw(case):
    return dict(dict(width=W, height=H, qp=28, me_range=4, bframes=1,
                     b_adapt=0, scenecut_threshold=0), **CASES[case][1])


_WANT = {}


def _reference(case):
    """The JAX Encoder's AUs of `case`, once a module."""
    if case not in _WANT:
        enc = JEncoder(Params(**_kw(case)))
        _WANT[case] = [enc.encode_frame(f) for f in CASES[case][0]()] \
            + [enc.flush()]
    return _WANT[case]


def _port_run(case):
    """The port's AUs of `case`, its recon of each input frame and the
    intra kind map of each B frame's compare."""
    p = TP.Params(**_kw(case))
    p.tail_kernel = False
    enc = TEncoder(p, device="cpu")
    frames = CASES[case][0]()
    recon, kinds = {}, []
    real, real_intra = enc._accumulate_psnr, enc._b_intra

    def keep(frame, y, u, v, recon_=None):
        r = recon_ or enc.recon_prev
        recon[id(frame)] = tuple(x.cpu().numpy() for x in r)
        return real(frame, y, u, v, recon_)

    def b_intra(*a, **kw):
        out = real_intra(*a, **kw)
        kinds.append(None if out[2] is None else out[1])
        return out
    enc._accumulate_psnr = lambda frame, y, u, v, recon=None: keep(
        frame, y, u, v, recon)
    enc._b_intra = b_intra
    aus = [enc.encode_frame(f) for f in frames] + [enc.flush()]
    return enc, aus, [recon[id(f)] for f in frames], kinds


@pytest.mark.parametrize("case", list(CASES))
def test_plain_b_stream_byte_equal(case):
    """Every AU byte-equal to the reference's; decoded == the encoder's
    recon on every frame; every B frame's compare switched MBs to intra,
    and the decoder reads them as I16x16/I4x4 MBs of a B slice."""
    want = _reference(case)
    _enc, aus, recons, kinds = _port_run(case)
    assert aus == want
    dec = decode_annexb(b"".join(aus))
    assert len(dec) == len(recons)
    for i, (d, r) in enumerate(zip(dec, recons)):
        np.testing.assert_array_equal(d.y, r[0][:H, :W], err_msg=str(i))
        np.testing.assert_array_equal(d.u, r[1][:H // 2, :W // 2])
        np.testing.assert_array_equal(d.v, r[2][:H // 2, :W // 2])
    n_b = len(recons) - 2
    assert len(kinds) == n_b and all(k is not None for k in kinds)
    for d in dec[1:-1]:
        types = {m.mb_type for m in d.mbs}
        assert types & {"I16x16", "I4x4"}, types
        if "mixed" in case or case.startswith("parts"):
            assert any(t.startswith("B") for t in types), types


def _col_field(g):
    m8 = g.integers(-9, 10, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    r8 = g.choice([-1, 0, 0, 0], (2 * MBH, 2 * MBW)).astype(np.int32)
    return (np.repeat(np.repeat(m8, 2, 0), 2, 1),
            np.repeat(np.repeat(r8, 2, 0), 2, 1))


@pytest.mark.parametrize("direct", ["spatial", "temporal", "none"])
def test_scan_b_with_intra_matches_reference(direct):
    """`scan_b_parts` and `scan_b_frame` with a random intra mask (intra
    MBs committed as available neighbours with ref -1 in both lists)
    against the reference's, at one and two L0 entries."""
    g = np.random.default_rng({"spatial": 60, "temporal": 61,
                               "none": 62}[direct])
    part = g.integers(0, 4, (MBH, MBW)).astype(np.int32)
    sel8 = g.integers(0, 4, (MBH, MBW, 4)).astype(np.int32)
    sel8[part != 3] = np.minimum(sel8[part != 3], 2)
    sel8[part == 0] = sel8[part == 0][:, :1]
    sel8[part == 1] = sel8[part == 1][:, [0, 0, 2, 2]]
    sel8[part == 2] = sel8[part == 2][:, [0, 1, 0, 1]]
    mv0z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    mv1z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    c_cfg = g.integers(100, 200, (MBH, MBW)).astype(np.int32)
    c_dir = g.integers(60, 220, (MBH, MBW)).astype(np.int32)
    c = [g.integers(60, 220, (MBH, MBW)).astype(np.int32) for _ in range(3)]
    mv0 = g.integers(-20, 21, (MBH, MBW, 2)).astype(np.int32)
    mv1 = g.integers(-20, 21, (MBH, MBW, 2)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g)
    intra = g.random((MBH, MBW)) < 0.3
    tdir = {"spatial": None, "none": TB.no_direct_fields(MBH, MBW),
            "temporal": JB.temporal_direct_fields(col_mv4, col_ref4, 180)
            }[direct]
    for ref0 in (None, g.integers(0, 2, (MBH, MBW)).astype(np.int32)):
        for mask in (None, intra):
            got = TB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir,
                                  col_mv4, col_ref4, 4, ref0=ref0, tdir=tdir,
                                  intra=mask)
            want = JB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir,
                                   col_mv4, col_ref4, 4, intra=mask,
                                   tdir=tdir, ref0=ref0)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            if direct == "none":
                # the reference's 16x16 commit raises OverflowError at a
                # direct-unavailable MB (ROADMAP F3)
                continue
            got = TB.scan_b_frame(c_dir, *c, mv0, mv1, col_mv4, col_ref4, 4,
                                  ref0=ref0, tdir=tdir, intra=mask)
            want = JB.scan_b_frame(c_dir, *c, mv0, mv1, col_mv4, col_ref4, 4,
                                   intra=mask, tdir=tdir, ref0=ref0)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        # intra MBs use no list and carry no mvd
        i8 = np.repeat(np.repeat(intra, 2, 0), 2, 1)
        n = len(got)
        assert not got[n - 7][i8].any() and not got[n - 6][i8].any()
        assert not got[n - 3][intra].any() and not got[n - 2][intra].any()


@pytest.mark.parametrize("spatial", [True, False])
def test_b_intra_keeps_the_direct_dependants_inter(spatial):
    """With every MB's inter cost above any intra cost, the compare
    switches every MB but, under spatial direct, the left, top,
    top-right and top-left neighbours of a direct MB (code 0, or B_8x8
    with a direct sub)."""
    p = TP.Params(**_kw("parts_cavlc"))
    enc = TEncoder(p, device="cpu")
    f = _novel_b_frames(seed=1)[1]
    y, u, v = enc._pad(f)
    res = {"recon_y": y.to(torch.uint8), "recon_u": u.to(torch.uint8),
           "recon_v": v.to(torch.uint8)}
    code = np.full((MBH, MBW), 1, np.int32)
    subs = np.zeros((MBH, MBW, 4), np.int32)
    code[2, 2] = 0
    code[1, 4] = 22
    subs[1, 4] = [1, 0, 2, 3]
    code[3, 0] = 22
    subs[3, 0] = [1, 2, 3, 1]            # B_8x8 without a direct sub
    _res, kind, _ir = enc._b_intra(y, u, v, res, code, subs,
                                   np.full((MBH, MBW), 1 << 30, np.int64),
                                   spatial, 28, int(lambda_tab(28)))
    kept = {(2, 1), (1, 2), (1, 3), (1, 1), (0, 4), (0, 5), (0, 3)}
    for my in range(MBH):
        for mx in range(MBW):
            assert (kind[my, mx] == 0) == (spatial and (my, mx) in kept), \
                (my, mx, kind)
