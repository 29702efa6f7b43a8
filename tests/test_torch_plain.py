"""The plain encoder (stego off, `StegoParams.em_rate` 0) on the port
against the JAX `Encoder`, on the CPU.

Streams at 128x96, me_range 8 (the Params of the reference's
`tests/test_intra_in_p.py`), on the reference's CPU branch
(`tail_kernel` False) and, where B1's predictor differs (the
one-reference analysis, the RD re-rank, the multi-reference analysis),
on its accelerator branch too (True, reached through
`reference_accel`):

- an occlusion-reveal clip (new content in each P frame, so the intra
  compare switches MBs to I16x16/I4x4): CAVLC and CABAC at rd 0, rd 1
  with the 8x8 transform (the four-shape RD re-rank with the 8x8
  candidate), ref_frames 2 under CAVLC and CABAC, adaptive quantization
  (which turns the intra compare and the re-rank off), the 16x16-only
  path, B frames with intra_in_p off, and a resume through
  `state.from_reference`;
- the chroma-heavy moving clip of the reference's
  `tests/test_rdcost.py::test_rd2_qpel_refine` (with a reveal in frame
  2): rd 2 (the P_SKIP and qpel RD probes, which both move MBs here)
  under CAVLC, and with trellis 2 (the probe trellis) under CABAC over
  IDR + 1 P.

Every stream is byte-equal AU by AU; the port's decoder gives the
encoder's recon frame by frame (the JAX decoder's frames on the B
stream). The modules: B3's per-MB inter cost (`ops.probe.subpel_parts`
with `mb_cost`) against the reference's `subpel_parts`,
`intra.refine_p_intra`, `inter.rd_coded_cost` / `rd_skip_eval` and
`partition.rd_rerank_parts` (both branches) against the reference's, on
every output. `check_slice` serves stego off with sub-8x8 partitions
and with B frames and the intra compare (tests/test_torch_plain_sub_b.py
holds those streams), and refuses by name what it refuses with stego on.
All equalities are exact (integer codec).
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import inter as JP
from video_steganography_pcamv_tpu.encoder import intra as JI
from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.encoder.me import lambda_tab
from video_steganography_pcamv_tpu.params import Params
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import core as TC
from video_steganography_pcamv_torch.encoder import inter as TI
from video_steganography_pcamv_torch.encoder import intra as TINTRA
from video_steganography_pcamv_torch.encoder import partition as TPT
from video_steganography_pcamv_torch.encoder import scan as TSCAN
from video_steganography_pcamv_torch.ops import probe as PR
from video_steganography_pcamv_torch.state import from_reference

from test_torch_encoder_accel import reference_accel  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 128, 96
MBW, MBH = W // 16, H // 16


def _reveal_frames():
    """Global motion with occlusion reveals: frame 1 is
    `tests/test_intra_in_p.py`'s `_frames(3)` reveal, frame 2 reveals
    new content elsewhere."""
    rng = np.random.RandomState(3)
    base = np.repeat(np.repeat(
        rng.randint(40, 216, (H // 4 + 16, W // 4 + 16)), 4, 0), 4, 1) \
        .astype(np.uint8)
    u = np.full((H // 2, W // 2), 128, np.uint8)
    out = []
    for i, (dy, dx, y0, x0) in enumerate(((0, 0, 0, 0), (2, 3, 24, 32),
                                          (4, 5, 8, 64))):
        f = base[dy:H + dy, dx:W + dx].copy()
        if i:
            new = np.repeat(np.repeat(rng.randint(0, 256, (12, 16)), 4, 0),
                            4, 1).astype(np.uint8)
            f[y0:y0 + 48, x0:x0 + 64] = new[:48, :64]
        out.append(Frame(f, u.copy(), u.copy()))
    return out


def _qpel_frames(n=3):
    """`tests/test_rdcost.py::test_rd2_qpel_refine`'s clip (its luma
    gradient, strong moving chroma and noise), with a reveal in frame
    2, over `n` frames."""
    rng = np.random.RandomState(5)
    pad = 32
    gy, gx = np.mgrid[0:H + 2 * pad, 0:W + 2 * pad]
    luma_big = (120 + 8 * np.sin(gx / 7.0) + 8 * np.cos(gy / 9.0)) \
        .astype(np.uint8)
    cg_y, cg_x = np.mgrid[0:(H + 2 * pad) // 2, 0:(W + 2 * pad) // 2]
    chroma_big = (128 + 60 * np.sign(np.sin(cg_x / 2.5)
                                     * np.sin(cg_y / 3.0))) \
        .clip(0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        y = luma_big[pad + i:pad + i + H, pad + 2 * i:pad + 2 * i + W].copy()
        y = np.clip(y.astype(np.int32)
                    + (rng.randn(H, W) * 2).astype(np.int32),
                    0, 255).astype(np.uint8)
        if i == 2:
            y[40:80, 16:64] = rng.randint(0, 256, (40, 48))
        cu = chroma_big[(pad + i) // 2:(pad + i) // 2 + H // 2,
                        (pad + 2 * i) // 2:(pad + 2 * i) // 2 + W // 2].copy()
        frames.append(Frame(y, cu, 255 - cu))
    return frames


_CLIPS = {"reveal": _reveal_frames, "qpel": _qpel_frames,
          # IDR + 1 P: the port's eager trellis is the slow part there
          "qpel2": lambda: _qpel_frames(2)}

# case -> (clip, Params beyond width/height/qp 26/me_range 8)
CASES = {
    "cavlc": ("reveal", {}),
    "cabac": ("reveal", dict(cabac=True)),
    "trans8_rd1": ("reveal", dict(transform_8x8=True, rd=1)),
    "rd2": ("qpel", dict(qp=30, rd=2)),
    "rd2_trellis2_cabac": ("qpel2", dict(qp=30, rd=2, cabac=True,
                                         trellis=2)),
    "ref2_cavlc": ("reveal", dict(ref_frames=2)),
    "ref2_cabac": ("reveal", dict(ref_frames=2, cabac=True)),
    "aq": ("reveal", dict(aq_mode=1)),
    "p16": ("reveal", dict(partitions=False)),
    "bframes": ("reveal", dict(bframes=2, intra_in_p=False)),
}
# the cases whose P frames run the intra compare
_INTRA = {"cavlc", "cabac", "trans8_rd1", "rd2", "rd2_trellis2_cabac",
          "ref2_cavlc", "ref2_cabac"}
# the accelerator branch differs from the CPU branch in B1's predictor
# alone (ROADMAP C1), on three paths: the one-reference analysis, the RD
# re-rank and the multi-reference analysis; these cases hold one each
_ACCEL = ("cavlc", "rd2", "ref2_cavlc")


def _kw(case):
    return dict(dict(width=W, height=H, qp=26, me_range=8), **CASES[case][1])


def _tparams(case, tail_kernel):
    p = TP.Params(**_kw(case))
    p.tail_kernel = tail_kernel
    return p


def _aus(enc, frames):
    """Per call, the encoder's output; then flush()'s."""
    return [enc.encode_frame(f) for f in frames] + [enc.flush()]


_WANT = {}


def _reference(case, branch):
    """The JAX Encoder's AUs of `case` on `branch` ("cpu" or "accel", the
    caller patching the latter in), computed once a module."""
    key = (case, branch)
    if key not in _WANT:
        _WANT[key] = _aus(JEncoder(Params(**_kw(case))),
                          _CLIPS[CASES[case][0]]())
    return _WANT[key]


def _port_run(case, tail_kernel):
    """The port's AUs of `case`, the recon after each call, and the rd 2
    probes' counts of frames they changed."""
    enc = TEncoder(_tparams(case, tail_kernel), device="cpu")
    moved = {"skip": 0, "qpel": 0}
    for name, attr in (("skip", "_rd_skip_force"),
                       ("qpel", "_rd_qpel_refine")):
        fn = getattr(enc, attr)

        def counted(*a, fn=fn, name=name):
            out = fn(*a)
            moved[name] += out is not None
            return out
        setattr(enc, attr, counted)
    frames = _CLIPS[CASES[case][0]]()
    aus, recons = [], []
    for f in frames:
        aus.append(enc.encode_frame(f))
        recons.append(tuple(x.cpu().numpy() for x in enc.recon_prev))
    aus.append(enc.flush())
    return enc, aus, recons, moved


def _check_stream(case, aus, want, recons, moved):
    assert aus == want
    bs = b"".join(aus)
    dec = decode_annexb(bs)
    n = len(_CLIPS[CASES[case][0]]())
    assert len(dec) == n
    if CASES[case][1].get("bframes"):
        for a, b in zip(dec, j_decode(bs)):
            for pl in ("y", "u", "v"):
                np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert any(m.mb_type.startswith("B") for d in dec for m in d.mbs)
    else:
        for i, (d, r) in enumerate(zip(dec, recons)):
            np.testing.assert_array_equal(d.y, r[0][:H, :W], err_msg=str(i))
            np.testing.assert_array_equal(d.u, r[1][:H // 2, :W // 2])
            np.testing.assert_array_equal(d.v, r[2][:H // 2, :W // 2])
    kinds = [{m.mb_type for m in d.mbs} for d in dec[1:]]
    if case in _INTRA:
        assert any(k & {"I16x16", "I4x4"} for k in kinds), kinds
    else:
        assert not any(k & {"I16x16", "I4x4", "I8x8"} for k in kinds), kinds
    if CASES[case][1].get("rd") == 2:
        assert moved["skip"] > 0 and moved["qpel"] > 0, moved


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stream_byte_equal_cpu_branch(case):
    """The reference's CPU branch (B1 against prev_mv >> 2) against
    `tail_kernel=False`."""
    want = _reference(case, "cpu")
    _enc, aus, recons, moved = _port_run(case, False)
    _check_stream(case, aus, want, recons, moved)


@pytest.mark.parametrize("case", _ACCEL)
def test_plain_stream_byte_equal_accel_branch(case, reference_accel):
    """The reference's accelerator branch (B1 against a zero predictor,
    through the patched Pallas entry: once a P frame, once per reference
    at ref_frames 2, and once in the RD re-rank) against
    `tail_kernel=True`, on each path B1's predictor reaches."""
    # (the patched entry is traced once a module and static
    # configuration, so its count shows only the first trace)
    want = _reference(case, "accel")
    _enc, aus, recons, moved = _port_run(case, True)
    _check_stream(case, aus, want, recons, moved)


def test_plain_16x16_path_is_one_stream_on_both_branches():
    """The 16x16-only path searches against a zero predictor on both of
    the reference's branches, so both `tail_kernel` settings give its
    one stream."""
    want = _reference("p16", "cpu")
    _enc, aus, recons, moved = _port_run("p16", True)
    _check_stream("p16", aus, want, recons, moved)


def test_plain_resume_from_reference_state():
    """A port Encoder resumed from the JAX Encoder's state after frame 2
    (intra MBs in frame 1, the prev_mv predictor zero there) writes the
    remaining AUs byte-equal."""
    frames = _reveal_frames()
    jenc = JEncoder(Params(**_kw("cavlc")))
    for f in frames[:2]:
        jenc.encode_frame(f)
    state = from_reference(jenc)
    want = [jenc.encode_frame(f) for f in frames[2:]]
    tenc = TEncoder(_tparams("cavlc", False), device="cpu")
    tenc.load_state(state)
    assert tenc._stego is None
    assert [tenc.encode_frame(f) for f in frames[2:]] == want


def _analysis_inputs(seed=11):
    """A reveal P frame against its deblocked reference: (y, u, v int32
    source planes, the reference dict, prev_mv)."""
    frames = _reveal_frames()
    enc = TEncoder(_tparams("cavlc", False), device="cpu")
    enc.encode_frame(frames[0])
    y, u, v = enc._pad(frames[1])
    prev = torch.as_tensor(
        np.random.RandomState(seed).randint(-24, 25, (MBH, MBW, 2)),
        dtype=torch.int32)
    return y, u, v, enc.ref, prev


def _j(t):
    import jax.numpy as jnp
    return jnp.asarray(t.cpu().numpy())


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("part_kind", ["decided", "mixed"])
def test_b3_mb_cost_matches_reference_subpel_parts(part_kind):
    """B3's per-MB inter cost (the plain twin of `csrc/analyse_tail.cu`'s
    mb_cost output) against the reference's `subpel_parts`, with the
    partition decision's shapes and with every shape in every row."""
    y, _u, _v, ref, prev = _analysis_inputs()
    qp = 26
    lam = int(lambda_tab(qp))
    planes = ref["luma"].to(torch.uint8)
    st = TPT.fullpel_parts(y, planes[0], prev >> 2, 8, MBH, MBW, lam)
    part, mvfp8 = TPT.decide_partition(st, MBH, MBW, lam)
    if part_kind == "mixed":
        part = (torch.arange(MBH * MBW, dtype=torch.int32) % 4) \
            .reshape(MBH, MBW)
    windows = TPT.gather_windows8(planes, mvfp8.contiguous(), MBH, MBW)
    mv8, r_idx8, cost = PR.subpel(y, windows, part, mvfp8, prev, lam, MBH,
                                  MBW, mb_cost=True)
    jwin = JPT.gather_windows8_jnp(_j(ref["luma"]).astype(np.uint8),
                                   _j(mvfp8), MBH, MBW)
    wht8 = JPT.wht8_flat(JPT.block_table8(jwin))
    jmv8, jr, jcost = JPT.subpel_parts(_j(y), wht8.astype(np.int16),
                                       _j(part), _j(mvfp8), _j(prev), MBH,
                                       MBW, lam, 2)
    _eq(mv8, jmv8, "mv8")
    _eq(r_idx8, jr, "r_idx8")
    _eq(cost, jcost, "mb_cost")
    # the stego path's outputs do not move
    mv8b, r_idx8b = PR.subpel(y, windows, part, mvfp8, prev, lam, MBH, MBW)
    _eq(mv8b, mv8)
    _eq(r_idx8b, r_idx8)


def test_analysis_without_b4_matches_reference():
    """The stego-off analysis (`analyse_p_frame_parts(probe=False)`, B1 ->
    decision -> B9 -> B3) against the reference's `analyse_p_frame_parts`
    on its CPU branch: part, mv8 and mb_cost; no B4 output."""
    y, _u, _v, ref, prev = _analysis_inputs()
    lam = int(lambda_tab(26))
    out = TPT.analyse_p_frame_parts(y, ref["luma"].to(torch.uint8), prev,
                                    lam, 26, 8, MBH, MBW, probe=False)
    assert len(out) == 3
    jpart, jmv8, _r, _b, _w, jcost = JPT.analyse_p_frame_parts(
        _j(y), _j(ref["luma"]), _j(prev), 8, MBH, MBW, lam, 2)
    for a, b, what in zip(out, (jpart, jmv8, jcost),
                          ("part", "mv8", "mb_cost")):
        _eq(a, b, what)


def test_refine_p_intra_matches_reference():
    """`intra.refine_p_intra` over an encoded reveal P frame against the
    reference's, on every output."""
    y, u, v, ref, prev = _analysis_inputs()
    qp, qpc = 26, 26
    lam = int(lambda_tab(qp))
    part, mv8, mb_cost = TPT.analyse_p_frame_parts(
        y, ref["luma"].to(torch.uint8), prev, lam, qp, 8, MBH, MBW,
        probe=False)
    res = TI.encode_p_frame_device8(y, u, v, ref["luma"], ref["u"],
                                    ref["v"], mv8, qp, qpc, MBH, MBW)
    got = TINTRA.refine_p_intra(y, u, v, res["recon_y"], res["recon_u"],
                                res["recon_v"], mb_cost, qp, qpc, MBW, MBH,
                                lam=lam)
    want = JI.refine_p_intra(_j(y), _j(u), _j(v), _j(res["recon_y"]),
                             _j(res["recon_u"]), _j(res["recon_v"]),
                             _j(mb_cost), qp, qpc, MBW, MBH, lam=lam)
    assert set(got) == set(want)
    assert (got["intra_kind"] > 0).any()
    for k in want:
        _eq(got[k], want[k], k)


def test_rd_costs_match_reference():
    """`inter.rd_coded_cost` and `rd_skip_eval` against the reference's
    (their int32 arithmetic), on a mixed-partition encode with random
    mvds and pskip MVs; at qp 51 the lambda2 products wrap."""
    y, u, v, ref, prev = _analysis_inputs()
    rng = np.random.RandomState(4)
    part = torch.as_tensor(rng.randint(0, 4, (MBH, MBW)), dtype=torch.int32)
    mv8 = torch.as_tensor(rng.randint(-30, 31, (2 * MBH, 2 * MBW, 2)),
                          dtype=torch.int32)
    mvd = rng.randint(-300, 301, (MBH, MBW, 4, 2)).astype(np.int32)
    pskip = rng.randint(-30, 31, (MBH, MBW, 2)).astype(np.int32)
    for qp in (26, 51):
        res = TI.encode_p_frame_device8(y, u, v, ref["luma"], ref["u"],
                                        ref["v"], mv8, qp, qp, MBH, MBW)
        args = [res[k] for k in ("luma_lev", "chroma_dc", "chroma_ac",
                                 "recon_y", "recon_u", "recon_v")]
        jargs = [_j(a) for a in args]
        got = TI.rd_coded_cost(y, u, v, *args, mvd, part.numpy(), qp, MBH,
                               MBW)
        want = JP.rd_coded_cost(_j(y), _j(u), _j(v), *jargs, mvd,
                                part.numpy(), qp, MBH, MBW)
        _eq(got, want, "rd_coded_cost qp %d" % qp)
        gc, gs = TI.rd_skip_eval(y, u, v, ref["luma"], ref["u"], ref["v"],
                                 pskip, *args, mvd, part.numpy(), qp, MBH,
                                 MBW)
        wc, ws = JP.rd_skip_eval(_j(y), _j(u), _j(v), _j(ref["luma"]),
                                 _j(ref["u"]), _j(ref["v"]), pskip, *jargs,
                                 mvd, part.numpy(), qp, MBH, MBW)
        _eq(gc, wc, "cost_coded qp %d" % qp)
        _eq(gs, ws, "cost_skip qp %d" % qp)


@pytest.mark.parametrize("branch", ["cpu", "accel"])
def test_rd_rerank_parts_matches_reference(branch, request):
    """`partition.rd_rerank_parts` against the reference's: part, mv8
    and mb_cost, on both branches (B1 against prev_mv >> 2 with the 8x8
    transform, or a zero predictor through the patched Pallas entry; the
    probe trellis is held by the rd2_trellis2_cabac streams)."""
    if branch == "accel":
        request.getfixturevalue("reference_accel")
    y, u, v, ref, prev = _analysis_inputs()
    qp, qpc = 26, 26
    lam = int(lambda_tab(qp))
    got = TPT.rd_rerank_parts(y, u, v, ref, prev, qp, qpc, lam, 8, MBH, MBW,
                              trans8=branch == "cpu",
                              tail_kernel=branch == "accel")
    jref = {k: _j(ref[k]) for k in ("luma", "u", "v")}
    jpart, jmv8, _r, _b, _w, jcost = JPT.rd_rerank_parts(
        _j(y), _j(u), _j(v), jref["luma"], jref["u"], jref["v"], _j(prev),
        qp, qpc, 8, MBH, MBW, lam, 2, decimate=True, trellis=False,
        nr_offset=None, trans8=branch == "cpu", use_pallas=branch == "accel")
    assert len(set(got[0].flatten().tolist())) > 1
    for a, b, what in zip(got, (jpart, jmv8, jcost),
                          ("part", "mv8", "mb_cost")):
        _eq(a, b, what)


def test_pskip_field_and_forced_scan_with_intra_are_the_references():
    """The rd 2 probes' host scans (`scan.pskip_field`,
    `scan_p_frame_forced` with intra MBs) are the reference's copies."""
    from video_steganography_pcamv_tpu.encoder import scan as JSCAN
    rng = np.random.RandomState(9)
    part = rng.randint(0, 4, (MBH, MBW)).astype(np.int32)
    mv8 = rng.randint(-20, 21, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    skip = rng.rand(MBH, MBW) < 0.3
    intra = (rng.rand(MBH, MBW) < 0.2) & ~skip
    _eq(TSCAN.pskip_field(part, mv8, skip), JSCAN.pskip_field(part, mv8,
                                                               skip))
    for a, b in zip(TSCAN.scan_p_frame_forced(part, mv8, skip, intra=intra),
                    JSCAN.scan_p_frame_forced(part, mv8, skip,
                                              intra=intra)):
        _eq(a, b)


@pytest.mark.parametrize("kw,name", [
    (dict(p4x4=True, crf=23.0), "rc_mode!=0"),
    (dict(bframes=2, zones="0,5,q=30"), "zones"),
    (dict(bframes=2, cabac=True, ref_frames=2, p4x4=True,
          deblock_device=True), "ROADMAP F10"),
])
def test_check_slice_refuses_what_the_plain_encoder_waits_for(kw, name):
    """Stego off is served with every option stego on is; what stays
    refused with it is what stays refused with stego on (rate control,
    zones, F10)."""
    p = TP.Params(**dict(_kw("cavlc"), **kw))
    p.validate()
    with pytest.raises(NotImplementedError, match=name):
        TC.check_slice(p)


@pytest.mark.parametrize("kw", [
    dict(), dict(bframes=2, intra_in_p=False), dict(bframes=2, aq_mode=1),
    dict(p4x4=True, partitions=False), dict(ref_frames=3, rd=2, cabac=True,
                                            trellis=2),
    dict(p4x4=True, rd=2, trellis=2, cabac=True, transform_8x8=True),
    dict(bframes=2), dict(bframes=2, cabac=True, ref_frames=2)])
def test_check_slice_serves_the_plain_encoder(kw):
    """B frames with the intra compare on or off (by intra_in_p, or by
    AQ, as in the reference), sub-8x8 partitions (with the RD re-rank and
    the intra compare), and p4x4 where the reference ignores it."""
    p = TP.Params(**dict(_kw("cavlc"), **kw))
    p.validate()
    TC.check_slice(p)
