"""B slices (BASELINE config 4 whole: bframes 2, b_adapt 0, ref_frames 2,
CABAC, spatial direct, and the other B options: b_pyramid, weightb, the
direct modes) in the port vs the JAX reference on the CPU, on the
reference's CPU branch (tail_kernel=False).

End to end, one JAX run each (module-scoped): config 4 at 112x80
(me_range 8, stego em_rate 16 key 5), IDR + 7 frames + flush, so the
run ends in a short GOP; ref_frames 1 with bframes 1, PSNR and SSIM on;
config 4 with CAVLC and b_adapt 2 over a 5-frame window (rc_lookahead
5, longer than bframes + 1), IDR + 9 frames + flush, so flush() runs the
B-placement DP more than once; the reference's default Params with
`bframes=2` (x264's `--bframes 2`: CAVLC, b_adapt 1, partitions, PSNR,
the host deblock; me_range 8 like the other runs, whose compiled
programs these share) on a clip with a noise frame at display index 4,
where b_adapt 1 closes the second GOP after one B frame; config 4 with
bframes 3, b_pyramid, weightb and direct auto (two pyramid GOPs, the
reference B of each and the next P's L0 reordering op); temporal direct
with weightb at one reference under CAVLC and b_adapt 1; and direct 0.
Each port stream is byte-equal to the JAX `Encoder`'s (the same frames
placed as B); both extractors recover `sent_messages`; the port's decoder
(CABAC and CAVLC B slices) gives the JAX decoder's planes and MB motion
on every frame, B frames included; the close() dicts agree. The same JAX
runs give `state.from_reference` snapshots at a GOP boundary and inside
a GOP (under b_adapt 2: right after a GOP, frames still buffered; under
the pyramid with the reordering op pending), from which the port resumes
byte-equal to the reference's continuation (ROADMAP F1). Adaptive
quantization (aq_mode 1) on config 4 and on the pyramid with temporal
direct under CAVLC: per-MB qps in every encode and mb_qp_delta in the
Python B writers; a snapshot inside a GOP resumes with no AQ state (the
grids are rebuilt every frame).

Modules, on the same seeded numpy inputs: `spatial_direct` and
`scan_b_parts` (one and two references, colocated intra / ref 0 / ref 1
blocks; on temporal and disabled direct fields), `approx_direct_fields`,
`bipred_weight`, `dist_scale_factor`, `temporal_direct_fields`, the
direct-auto score with its decay, the B analysis of one frame (stage 1
with the L0 merge, the direct SATDs, stage 2, unweighted and weighted),
the CABAC B writer on seeded B syntax, `encode_b_frame_device`'s levels
and recon at one reference and at two (there also at per-8x8 weights);
and `check_slice`: the B options of the slice accepted, every other one
refused with its ROADMAP id."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import bslice as JB
from video_steganography_pcamv_tpu.encoder import scan as JSCAN
from video_steganography_pcamv_tpu.encoder.cabac import (
    CabacSliceWriter as JWriter)
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.bitstream import (
    BitWriter as JBitWriter)
from video_steganography_pcamv_tpu.utils.yuv import Frame, synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb as t_decode
from video_steganography_pcamv_torch.encoder import bslice as TB
from video_steganography_pcamv_torch.encoder.cabac import (
    CabacSliceWriter as TWriter)
from video_steganography_pcamv_torch.encoder.core import check_slice
from video_steganography_pcamv_torch.encoder.me import lambda_tab
from video_steganography_pcamv_torch.ops import mc as TMC
from video_steganography_pcamv_torch.state import from_reference
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames)
from video_steganography_pcamv_torch.utils.bitstream import BitWriter


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
EM_RATE, KEY = 16, 5
RNG = 8


def _kw(**kw):
    """tools/bench_c4.py's Params at 112x80, me_range 8."""
    return dict(dict(width=W, height=H, qp=26, me_range=RNG, cabac=True,
                     bframes=2, b_adapt=0, ref_frames=2,
                     deblock_device=True, psnr=False), **kw)


def t_params(kw, tail_kernel=False):
    return TP.Params(**kw, tail_kernel=tail_kernel,
                     stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))


def encode_both(frames, kw):
    """The JAX Encoder and the port's (its CPU branch, tail_kernel
    False) on `frames` at Params `kw` with stego em_rate 16 key 5; the
    JAX run also keeps a `from_reference` snapshot after every frame and
    the bytes each call returned."""
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    chunks, snaps = [], []
    for f in frames:
        chunks.append(jenc.encode_frame(f))
        snaps.append(from_reference(jenc))
    chunks.append(jenc.flush())
    tenc = TEncoder(t_params(kw), device="cpu")
    # every frame's recon as the encoder meters it: an anchor's
    # deblocked planes, a B frame's own undeblocked ones
    recon, meter = {}, tenc._accumulate_psnr

    def keep_recon(frame, y, u, v, recon_planes=None):
        disp = next(i for i, f in enumerate(frames) if f is frame)
        recon[disp] = tuple(np.asarray(t.cpu()) for t in
                            (recon_planes or tenc.recon_prev))
        return meter(frame, y, u, v, recon_planes)
    tenc._accumulate_psnr = lambda frame, y, u, v, recon=None: keep_recon(
        frame, y, u, v, recon)
    got = b"".join(tenc.encode_frame(f) for f in frames) + tenc.flush()
    return dict(want=b"".join(chunks), got=got, jenc=jenc, tenc=tenc,
                n=len(frames), kw=kw, frames=frames, chunks=chunks,
                snaps=snaps, recon=recon)


def _encode_both(n_frames, **kw):
    return encode_both(synthetic_sequence(W, H, n_frames, seed=9), _kw(**kw))


def resume_matches_reference(run, k: int) -> int:
    """The port resumed from the reference's snapshot after frame k
    gives the reference's continuation byte for byte; returns how many
    frames the snapshot held buffered."""
    snap = run["snaps"][k]
    tenc = TEncoder(t_params(run["kw"]), device="cpu")
    tenc.load_state(snap)
    got = b"".join(tenc.encode_frame(f) for f in run["frames"][k + 1:]) \
        + tenc.flush()
    assert got == b"".join(run["chunks"][k + 1:])
    return len(snap["bpipe"]["bbuf"])


def stream_matches_reference(run):
    assert run["got"] == run["want"]
    st = run["tenc"].stats
    assert st.b_frames == run["jenc"].stats.b_frames > 0
    assert st.p_frames == run["jenc"].stats.p_frames
    assert st.frames == run["n"]


def port_decode(run):
    """The port's decode of the port's stream, once a run."""
    if "decoded" not in run:
        run["decoded"] = t_decode(run["got"])
    return run["decoded"]


def decoders_agree(run):
    """The port's decoder gives the JAX decoder's planes, slice types,
    POCs and MB motion on every frame; returns the decoded frames."""
    dec, jdec = port_decode(run), j_decode(run["got"])
    assert len(dec) == len(jdec) == run["n"]
    # display order; POCs count from each IDR
    idr = [i for i, f in enumerate(dec) if f.slice_type == 2]
    assert [f.poc for f in dec] == [
        2 * (i - max(k for k in idr if k <= i)) for i in range(run["n"])]
    for a, b in zip(dec, jdec):
        assert (a.slice_type, a.poc) == (b.slice_type, b.poc)
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.mb_type for m in a.mbs] == [m.mb_type for m in b.mbs]
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    return dec


def extractors_recover(run):
    """Both blind extractors recover the port's `sent_messages`."""
    sent = run["tenc"]._stego.sent_messages
    assert len(sent) == run["tenc"].stats.p_frames
    assert sum(len(s) for s in sent) > 0
    for rec in (j_extract(run["got"], em_rate=EM_RATE, key=KEY),
                extract_from_frames(port_decode(run), em_rate=EM_RATE)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


@pytest.fixture(scope="module")
def config4():
    return _encode_both(8)


@pytest.fixture(scope="module")
def ref1_b1():
    """bframes 1 at one reference, with PSNR and SSIM on (a B frame's
    metrics read its own recon: it never enters the DPB)."""
    return _encode_both(6, ref_frames=1, bframes=1, psnr=True, ssim=True)


@pytest.fixture(scope="module")
def badapt2():
    return _encode_both(10, cabac=False, b_adapt=2, rc_lookahead=5)


@pytest.fixture(scope="module")
def pyramid():
    """Config 4 with bframes 3, b_pyramid, weightb and direct auto: GOPs
    of B B B P and B B P, each with its middle B a reference picture
    (the next P reorders L0), twice, then B P, too short for one (the
    reference codes its B on one L0 entry, whatever ref_frames); implicit
    weights on every BI combine, the first slices temporal (the auto
    score starts at [0, 0])."""
    return _encode_both(11, bframes=3, b_pyramid=True, weightb=True,
                        direct=3)


@pytest.fixture(scope="module")
def temporal_cavlc():
    """Temporal direct with weightb at one reference, CAVLC, b_adapt 1."""
    return _encode_both(8, ref_frames=1, cabac=False, b_adapt=1, direct=2,
                        weightb=True)


@pytest.fixture(scope="module")
def direct_none():
    """direct 0 (x264 --direct none) at one reference: no direct MB, no
    B_Skip."""
    return _encode_both(7, ref_frames=1, direct=0)


@pytest.fixture(scope="module")
def defaults_b2():
    frames = synthetic_sequence(W, H, 8, seed=9)
    noise = np.random.default_rng(3).integers(0, 256, (H, W)).astype(
        np.uint8)
    frames[4] = Frame(noise, frames[4].u, frames[4].v)
    return encode_both(frames, dict(width=W, height=H, bframes=2,
                                    me_range=RNG))


@pytest.fixture(scope="module")
def bmref_trellis():
    """The reference's own cross-feature case `bmref+weightb+trellis`
    (tests/test_feature_matrix.py), without its NR: ref_frames 3,
    bframes 2, b_adapt 0, weightb, trellis 1, CABAC, keyint_max 6 (an
    IDR inside the B pipe). Every final encode is trellised: the IDRs,
    the multi-reference anchors' pass 1 and pass 2, the B encodes."""
    return _encode_both(9, ref_frames=3, weightb=True, trellis=1,
                        keyint_max=6)


@pytest.fixture(scope="module")
def trans8_rd():
    """bframes 2 with transform_8x8 and rd 1 at one reference (x264's
    --bframes 2 --8x8dct --subme 7), CABAC: the IDR codes Intra_8x8, the
    P anchors (the unpipelined fused step) take the 8x8 candidate by its
    RD choice, every B MB with luma residual carries
    transform_size_8x8_flag 0."""
    return _encode_both(7, ref_frames=1, transform_8x8=True, rd=1)


@pytest.fixture(scope="module")
def trans8_rd_cavlc():
    """The same under CAVLC (the Python B writer: the native one does
    not code the flag)."""
    return _encode_both(7, ref_frames=1, transform_8x8=True, rd=1,
                        cabac=False)


@pytest.fixture(scope="module")
def aq_config4():
    """Config 4 with adaptive quantization (aq_mode 1): per-MB qps in
    the IDR, the multi-reference anchors and the B encodes, mb_qp_delta
    in the CABAC B writer (Python, as the reference's under AQ)."""
    return _encode_both(8, aq_mode=1)


@pytest.fixture(scope="module")
def aq_pyramid_temporal():
    """The pyramid with temporal direct under CAVLC with adaptive
    quantization: the reference B's per-MB qps and the Python CAVLC B
    writer's mb_qp_delta."""
    return _encode_both(8, aq_mode=1, bframes=3, b_pyramid=True, direct=2,
                        cabac=False)


CASES = ["config4", "ref1_b1", "badapt2", "defaults_b2", "pyramid",
         "temporal_cavlc", "direct_none", "bmref_trellis", "trans8_rd",
         "trans8_rd_cavlc", "aq_config4", "aq_pyramid_temporal"]


@pytest.mark.parametrize("case", CASES)
def test_stream_byte_equal(case, request):
    stream_matches_reference(request.getfixturevalue(case))


@pytest.mark.parametrize("case", CASES)
def test_decoders_agree_on_every_frame(case, request):
    types = [f.slice_type
             for f in decoders_agree(request.getfixturevalue(case))]
    assert types[0] == 2 and 1 in types and 0 in types


@pytest.mark.parametrize("case", CASES)
def test_both_extractors_recover_the_payload(case, request):
    extractors_recover(request.getfixturevalue(case))


@pytest.mark.parametrize("case", CASES)
def test_decoded_frames_equal_the_encoders_recon(case, request):
    """The port's decode of every frame, B frames and reference Bs
    included, equals the recon the port's encoder metered for it."""
    run = request.getfixturevalue(case)
    dec = port_decode(run)     # in display order
    assert sorted(run["recon"]) == list(range(len(dec)))
    for d, f in enumerate(dec):
        for pl, r, s in zip(("y", "u", "v"), run["recon"][d], (1, 2, 2)):
            np.testing.assert_array_equal(
                getattr(f, pl), r[:H // s, :W // s],
                err_msg="display %d plane %s" % (d, pl))


@pytest.mark.parametrize("case", ["trans8_rd", "trans8_rd_cavlc"])
def test_trans8_b_streams_code_8x8_in_the_anchors(case, request):
    """Under the PPS's 8x8 flag the IDR codes Intra_8x8 and the P anchors
    8x8-transform MBs; the B slices code B MBs with luma residual (each
    with its transform_size_8x8_flag 0)."""
    run = request.getfixturevalue(case)
    st = run["tenc"].stats
    assert st.i8x8_mbs > 0 and st.trans8_mbs > 0
    kinds = {m.mb_type for f in port_decode(run) if f.slice_type == 1
             for m in f.mbs}
    assert kinds - {"BSKIP", "BDIRECT"}


@pytest.mark.parametrize("case,k,buffered", [
    ("config4", 6, 0), ("config4", 5, 2), ("ref1_b1", 4, 0),
    ("ref1_b1", 3, 1), ("badapt2", 7, 2), ("badapt2", 8, 3),
    ("pyramid", 2, 2), ("pyramid", 4, 0), ("pyramid", 5, 1),
    ("aq_config4", 5, 2)],
    ids=["ref2_gop_boundary", "ref2_mid_gop", "ref1_gop_boundary",
         "ref1_mid_gop", "badapt2_after_a_gop", "badapt2_mid_gop",
         "pyramid_mid_gop", "pyramid_reorder_pending",
         "pyramid_mid_gop_reorder_pending", "aq_mid_gop"])
def test_resume_from_reference_snapshot(case, k, buffered, request):
    """F1: a snapshot of the reference's B pipe at a GOP boundary and
    inside a GOP (frames buffered, waiting for their anchor) resumes into
    the reference's continuation: b_adapt 0 at ref_frames 2 and 1, and
    b_adapt 2 with its window, whose frames stay buffered across a
    GOP's end; under the pyramid inside the first GOP, and after it
    while the next P slice's L0 reordering op is still pending (the DPB
    then holds the reference B)."""
    run = request.getfixturevalue(case)
    assert resume_matches_reference(run, k) == buffered
    if case == "pyramid":
        bp = run["snaps"][k]["bpipe"]
        assert bp["reorder_next_p"] == (k >= 4)
        assert [e["_anchor"] for e in run["snaps"][k]["dpb"]] == \
            ([False, True, True] if k >= 4 else [True])


def test_pyramid_structure_weights_and_direct_modes(pyramid):
    """Decode order I P4 B2 B1 B3 P8 B6 B5 B7 P10 B9 with the middle B of
    each pyramid GOP a reference (nal_ref_idc > 0), a frame_num step after
    it, the P after each pyramid GOP carrying one L0 reordering op, the
    last B on one L0 entry, weighted bipred in the PPS, and slices under
    both direct modes (auto)."""
    from video_steganography_pcamv_torch.decoder.decoder import parse_nals
    from video_steganography_pcamv_torch.utils.bitstream import BitReader
    sps = pyramid["tenc"].sps
    info = []
    for nal_type, ref_idc, rbsp in parse_nals(pyramid["got"]):
        if nal_type not in (1, 5):
            continue
        br = BitReader(rbsp)
        br.read_ue()
        st = br.read_ue()
        br.read_ue()
        fn = br.read(sps.log2_max_frame_num)
        if nal_type == 5:
            br.read_ue()
        poc = br.read(sps.log2_max_poc_lsb)
        ds = br.read1() if st == 1 else None
        l0 = 2   # the PPS's num_ref_idx_l0_active
        if st in (0, 1) and br.read1():
            l0 = br.read_ue() + 1
            if st == 1:
                br.read_ue()
        reorder = bool(br.read1()) if st in (0, 1) else None
        info.append((st, poc // 2, ref_idc > 0, fn, ds, reorder, l0))
    assert [(t, d, r) for t, d, r, *_ in info] == [
        (2, 0, True), (0, 4, True), (1, 2, True), (1, 1, False),
        (1, 3, False), (0, 8, True), (1, 6, True), (1, 5, False),
        (1, 7, False), (0, 10, True), (1, 9, False)]
    assert [i[3] for i in info] == [0, 1, 2, 3, 3, 3, 4, 5, 5, 5, 6]
    assert [i[5] for i in info if i[0] == 0] == [False, True, True]
    assert [i[6] for i in info if i[0] == 1] == [1, 1, 2, 2, 2, 2, 1]
    assert {i[4] for i in info if i[0] == 1} == {0, 1}
    assert pyramid["tenc"].pps.weighted_bipred_idc == 2
    assert pyramid["tenc"].sps.num_ref_frames == 4
    assert pyramid["tenc"]._direct_score == pyramid["jenc"]._direct_score


def test_badapt2_window_outgrows_a_gop_and_flush_runs_the_dp(badapt2):
    """The buffer holds more than bframes + 1 frames, also when flush()
    starts; the DP places single B frames on the pan."""
    held = [len(s["bpipe"]["bbuf"]) for s in badapt2["snaps"]]
    assert max(held) == held[-1] == 4
    types = [f.slice_type for f in port_decode(badapt2)]
    assert types == [2, 1, 0, 1, 1, 0, 1, 0, 1, 0]


def test_default_params_b_adapt1_closes_the_gop_at_the_cut(defaults_b2):
    """Display order I B B P | B P | B P: at b_adapt 0 the second GOP
    would hold two B frames. CAVLC B slices throughout; close() equal."""
    tenc = defaults_b2["tenc"]
    assert (tenc.p.cabac, tenc.p.b_adapt, tenc.p.psnr) == (False, 1, True)
    assert [f.slice_type for f in port_decode(defaults_b2)] == \
        [2, 1, 1, 0, 1, 0, 1, 0]
    got, want = tenc.close(), defaults_b2["jenc"].close()
    assert got.keys() == want.keys() and 20 < got["psnr_y"] < 99
    for k in want:
        if k != "fps":
            assert got[k] == want[k], k


def test_close_with_b_frames_matches_reference(ref1_b1):
    """close(): counts, bits and PSNR exact, SSIM to rtol 1e-5 (a float
    sum in another order); fps is a rate of the wall clock."""
    got, want = ref1_b1["tenc"].close(), ref1_b1["jenc"].close()
    assert got.keys() == want.keys()
    assert 20 < got["psnr_y"] < 99 and 0 < got["ssim_y"] <= 1
    for k in want:
        if k == "ssim_y":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        elif k != "fps":
            assert got[k] == want[k], k


def test_config4_b_frames_cover_the_b_syntax(config4):
    """The config-4 stream's B slices hold skips, direct, 16x16 and
    partition MBs."""
    kinds = {m.mb_type for f in port_decode(config4)
             if f.slice_type == 1 for m in f.mbs}
    assert {"BSKIP", "BDIRECT", "BL0", "BL1", "B16x8", "B8x16",
            "B8x8"} <= kinds


# ---------------------------------------------------------------------------
# Host direct derivation and commit
# ---------------------------------------------------------------------------

def _col_field(g, num_ref):
    """A colocated anchor field: per-8x8 refs in {-1 (intra), 0..}, MVs
    in +-2 qpel (so colZeroFlag varies)."""
    r8 = g.integers(-1, num_ref, (2 * MBH, 2 * MBW)).astype(np.int32)
    m8 = g.integers(-2, 3, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    return (np.repeat(np.repeat(m8, 2, 0), 2, 1),
            np.repeat(np.repeat(r8, 2, 0), 2, 1))


@pytest.mark.parametrize("num_ref", [1, 2])
def test_scan_b_parts_matches_reference(num_ref):
    g = np.random.default_rng(20 + num_ref)
    part = g.integers(0, 4, (MBH, MBW)).astype(np.int32)
    sel8 = g.integers(0, 3, (MBH, MBW, 4)).astype(np.int32)
    sel8[part == 3] = g.integers(0, 4, (int((part == 3).sum()), 4))
    sel8[part == 0] = sel8[part == 0][:, :1]
    sel8[part == 1] = sel8[part == 1][:, [0, 0, 2, 2]]
    sel8[part == 2] = sel8[part == 2][:, [0, 1, 0, 1]]
    mv0z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    mv1z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    c_cfg = g.integers(100, 200, (MBH, MBW)).astype(np.int32)
    c_dir = g.integers(60, 220, (MBH, MBW)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g, num_ref)
    ref0 = (g.integers(0, num_ref, (MBH, MBW)).astype(np.int32)
            if num_ref > 1 else None)
    lam = 4
    got = TB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir, col_mv4,
                          col_ref4, lam, ref0=ref0)
    want = JB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir, col_mv4,
                           col_ref4, lam, ref0=ref0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    code = got[0]
    assert (code == 0).any() and (code > 3).any() and (code == 22).any()
    assert (got[1][code == 22] == 0).any()   # a direct 8x8 sub


def test_spatial_direct_matches_reference():
    """Every MB of a random half-coded grid pair: neighbours with refs
    -1 / 0 / 1 and unavailable ones."""
    g = np.random.default_rng(7)
    grids = []
    for cls in (TB._Grid, JSCAN._Grid):
        gg = np.random.default_rng(8)
        pair = (cls(MBH, MBW), cls(MBH, MBW))
        for gr in pair:
            gr.mv[:] = gg.integers(-20, 21, gr.mv.shape)
            gr.ref[:] = gg.integers(-1, 2, gr.ref.shape)
            gr.dec[:] = gg.random(gr.dec.shape) < 0.7
        grids.append(pair)
    col_mv4, col_ref4 = _col_field(g, 2)
    for my in range(MBH):
        for mx in range(MBW):
            a = TB.spatial_direct(*grids[0], col_mv4, col_ref4, my, mx)
            b = JB.spatial_direct(*grids[1], col_mv4, col_ref4, my, mx,
                                  with_refs=True)
            assert a[0] == b[0] and a[1] == b[1] and a[4:] == b[4:]
            np.testing.assert_array_equal(a[2], b[2])
            np.testing.assert_array_equal(a[3], b[3])


def test_approx_direct_fields_match_reference():
    g = np.random.default_rng(11)
    mv0 = g.integers(-40, 41, (MBH, MBW, 2)).astype(np.int32)
    mv1 = g.integers(-40, 41, (MBH, MBW, 2)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g, 2)
    for a, b in zip(TB.approx_direct_fields(mv0, mv1, col_mv4, col_ref4),
                    JB.approx_direct_fields(mv0, mv1, col_mv4, col_ref4)):
        np.testing.assert_array_equal(a, b)


_POCS = [-300, -200, -130, -64, -20, -7, -2, 0, 1, 2, 3, 5, 8, 20, 64, 127,
         128, 130, 200, 300]


def test_bipred_weight_matches_reference():
    """Every (poc_b, poc0, poc1) of a grid that reaches the td and tb
    clamps, td = 0, td < 0 and weights outside [-64, 128] (which fall
    back to 32), with and without weightb."""
    got, seen = [], set()
    for b in _POCS:
        for p0 in _POCS:
            for p1 in _POCS:
                for wb in (True, False):
                    w = TB.bipred_weight(b, p0, p1, wb)
                    assert w == JB.bipred_weight(b, p0, p1, wb), (b, p0, p1)
                    got.append(w)
                    if wb and p1 == p0:
                        seen.add("td0")
                    if wb and p1 < p0 and w != 32:
                        seen.add("td<0")
    assert seen == {"td0", "td<0"}
    assert min(got) == -64 and max(got) == 128 and len(set(got)) > 50


def test_dist_scale_factor_matches_reference():
    got = [TB.dist_scale_factor(b, p0, p1) for b in _POCS for p0 in _POCS
           for p1 in _POCS]
    want = [JB.dist_scale_factor(b, p0, p1) for b in _POCS for p0 in _POCS
            for p1 in _POCS]
    assert got == want
    assert min(got) == -1024 and max(got) == 1023 and 256 in got


@pytest.mark.parametrize("mode", ["col_map", "mref", "single"])
def test_temporal_direct_fields_match_reference(mode):
    """Colocated intra (-1), L1-only (-2) and references 0-2; dsf a
    scalar or per L0 entry; map_col_to_list0 with -1 entries."""
    g = np.random.default_rng({"col_map": 40, "mref": 41, "single": 42}[mode])
    r8 = g.choice([-2, -1, 0, 0, 1, 2], (2 * MBH, 2 * MBW)).astype(np.int32)
    m8 = g.integers(-40, 41, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    col_mv4 = np.repeat(np.repeat(m8, 2, 0), 2, 1)
    col_ref4 = np.repeat(np.repeat(r8, 2, 0), 2, 1)
    dsf = (np.array([128, -200, 700], np.int64) if mode != "single"
           else 300)
    cmap = np.array([1, -1, 0], np.int32) if mode == "col_map" else None
    got = TB.temporal_direct_fields(col_mv4, col_ref4, dsf, col_map=cmap)
    want = JB.temporal_direct_fields(col_mv4, col_ref4, dsf, col_map=cmap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].any() and not got[0].all()


@pytest.mark.parametrize("num_ref", [1, 2])
def test_scan_b_parts_temporal_matches_reference(num_ref):
    """The partition commit on a temporal field (per-8x8 L0 refs, MBs
    direct-unavailable) and on direct 0's field."""
    g = np.random.default_rng(50 + num_ref)
    part = g.integers(0, 4, (MBH, MBW)).astype(np.int32)
    sel8 = g.integers(0, 3, (MBH, MBW, 4)).astype(np.int32)
    sel8[part == 3] = g.integers(0, 4, (int((part == 3).sum()), 4))
    sel8[part == 0] = sel8[part == 0][:, :1]
    sel8[part == 1] = sel8[part == 1][:, [0, 0, 2, 2]]
    sel8[part == 2] = sel8[part == 2][:, [0, 1, 0, 1]]
    mv0z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    mv1z = g.integers(-12, 13, (MBH, MBW, 4, 2)).astype(np.int32)
    c_cfg = g.integers(100, 200, (MBH, MBW)).astype(np.int32)
    c_dir = g.integers(60, 220, (MBH, MBW)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g, num_ref)
    col_ref4[:4, :8] = -2
    ref0 = (g.integers(0, num_ref, (MBH, MBW)).astype(np.int32)
            if num_ref > 1 else None)
    dsf = np.array([200, 90][:num_ref], np.int64)
    tdir = JB.temporal_direct_fields(col_mv4, col_ref4, dsf,
                                     col_map=np.arange(num_ref))
    for field in (tdir, TB.no_direct_fields(MBH, MBW)):
        got = TB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir, col_mv4,
                              col_ref4, 4, ref0=ref0, tdir=field)
        want = JB.scan_b_parts(part, sel8, mv0z, mv1z, c_cfg, c_dir,
                               col_mv4, col_ref4, 4, ref0=ref0, tdir=field)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert not tdir[0].all() and tdir[0].any()


def test_direct_auto_score_and_decay_match_reference():
    """`direct` 3's score against the reference's `_direct_auto_score`
    over rounds that alternate the active mode and the partition and
    16x16 forms, past the 9/10 decay."""
    (t0, _t1, t2), (j0, _j1, j2), cur = _refs(3, 14)
    tenc = TEncoder(t_params(_kw(direct=3)), device="cpu")
    jenc = JEncoder(Params(**_kw(direct=3),
                           stego=StegoParams(em_rate=EM_RATE, key=KEY)))
    g = np.random.default_rng(15)
    col = _col_field(g, 1)
    tf = JB.temporal_direct_fields(*col, np.array([150, 150], np.int64),
                                   col_map=np.array([0], np.int32))
    mvs = tuple(g.integers(-30, 31, (MBH, MBW, 2)).astype(np.int32)
                for _ in range(2))
    decayed = False
    for rnd in range(8):
        spatial, parts = rnd % 3 == 1, rnd % 2 == 0
        c_act = g.integers(0, 400, (MBH, MBW)).astype(np.int64)
        c_best = g.integers(0, 1200, (MBH, MBW)).astype(np.int64)
        before = sum(tenc._direct_score)
        tenc._direct_auto_score(torch.as_tensor(cur), t0["luma"], t2["luma"],
                                spatial, tf, mvs, col, c_act, c_best, 6, 40,
                                parts)
        jenc._direct_auto_score(jnp.asarray(cur), j0, j2, spatial, tf, mvs,
                                *col, c_act, c_best, 6, 40, parts)
        assert tenc._direct_score == jenc._direct_score
        decayed |= before > MBH * MBW
    assert decayed


# ---------------------------------------------------------------------------
# The B analysis of one frame and the B encode
# ---------------------------------------------------------------------------

def _refs(n, seed):
    """n reference entries built from a smooth random texture, each
    shifted a little, as port dicts and JAX dicts."""
    g = np.random.default_rng(seed)
    big = g.integers(30, 226, (H // 4 + 8, W // 4 + 8))
    big = np.repeat(np.repeat(big, 4, 0), 4, 1)
    out_t, out_j = [], []
    for k in range(n):
        y = big[3 * k:3 * k + H, 2 * k:2 * k + W].astype(np.int32)
        u = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
        v = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
        out_t.append(TMC.build_ref(*(torch.as_tensor(a) for a in (y, u, v))))
        out_j.append(JMC.build_ref(*(jnp.asarray(a) for a in (y, u, v))))
    cur = big[5:5 + H, 4:4 + W].astype(np.int32)
    return out_t, out_j, cur


def _stack_t(es):
    return {k: torch.stack([e[k] for e in es]) for k in ("luma", "u", "v")}


def _stack_j(es):
    return {k: jnp.stack([e[k] for e in es]) for k in ("luma", "u", "v")}


def test_b_analysis_matches_reference_two_refs(config4):
    """Stage 1 with the L0 merge (entry 1 past n_valid in one run),
    the approximate direct SATDs and stage 2, port vs JAX, at the
    config-4 shapes; the BI combines unweighted, then at an implicit
    weight."""
    (t0, t1, t2), (j0, j1, j2), cur = _refs(3, 5)
    y = torch.as_tensor(cur)
    yj = jnp.asarray(cur)
    lam = lambda_tab(28)
    rs_t, rs_j = _stack_t([t0, t1]), _stack_j([j0, j1])
    g = np.random.default_rng(3)
    col_mv4, col_ref4 = _col_field(g, 2)
    for n_valid, w1 in ((2, 32), (1, 44)):
        st0, st1, ref0 = TB.analyse_b_parts_stage1(
            y, rs_t["luma"][:, 0].to(torch.uint8), n_valid,
            t2["luma"][0].to(torch.uint8), RNG, MBH, MBW, lam)
        jst0, jst1, jref0 = JB.analyse_b_parts_stage1_mref(
            yj, rs_j["luma"], jnp.asarray(n_valid), j2["luma"], RNG, MBH,
            MBW, lam, 2)
        np.testing.assert_array_equal(ref0.numpy(), np.asarray(jref0))
        for k in jst0:
            np.testing.assert_array_equal(st0[k].numpy(),
                                          np.asarray(jst0[k]), err_msg=k)
            np.testing.assert_array_equal(st1[k].numpy(),
                                          np.asarray(jst1[k]), err_msg=k)
        assert (n_valid == 1) == (int(ref0.max()) == 0)
        au = JB.approx_direct_fields(4 * np.asarray(jst0["mv16"]),
                                     4 * np.asarray(jst1["mv16"]),
                                     col_mv4, col_ref4)
        c_dir8 = TB.bipred_satd8_device(
            y, rs_t["luma"][0], t2["luma"], *(torch.as_tensor(a) for a in au),
            MBH, MBW, w1=w1)
        jc_dir8 = JB.bipred_satd8_device(
            yj, j0["luma"], j2["luma"], *(jnp.asarray(a) for a in au),
            MBH, MBW, w1=w1)
        np.testing.assert_array_equal(c_dir8.numpy(), np.asarray(jc_dir8))
        got = TB.analyse_b_parts(y, rs_t["luma"], t2["luma"], st0, st1,
                                 c_dir8, ref0, MBH, MBW, lam, w1=w1)
        want = JB.analyse_b_parts(yj, rs_j["luma"], j2["luma"], jst0, jst1,
                                  jc_dir8, MBH, MBW, lam, 2, w1=w1,
                                  ref0_map=jnp.asarray(ref0.numpy()))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("num_ref,weighted", [(1, False), (2, False),
                                              (2, True)],
                         ids=["1", "2", "2_weighted"])
def test_encode_b_frame_device_matches_reference(num_ref, weighted):
    """The port's one path (a stack of one L0 entry at one reference)
    against the reference's single-reference encode and its
    multi-reference one, there also at per-8x8 implicit weights (each
    block its L0 entry's)."""
    (t0, t1, t2), (j0, j1, j2), cur = _refs(3, 9 + num_ref)
    g = np.random.default_rng(num_ref)
    y = cur
    u = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    v = g.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    use0 = g.integers(0, 2, (2 * MBH, 2 * MBW)).astype(np.int32)
    use1 = np.where(use0 == 0, 1,
                    g.integers(0, 2, use0.shape)).astype(np.int32)
    fmv0 = g.integers(-30, 31, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    fmv1 = g.integers(-30, 31, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    ref8 = np.where(use0 == 1, g.integers(0, num_ref, use0.shape),
                    -1).astype(np.int32)
    qp, qpc = 28, 28
    t = torch.as_tensor
    w8 = np.array([40, -10], np.int32)[np.maximum(ref8, 0)] if weighted \
        else None
    got = TB.encode_b_frame_device(
        t(y), t(u), t(v), _stack_t([t0, t1][:num_ref]), t2, t(use0),
        t(use1), t(fmv0), t(fmv1), t(ref8), qp, qpc, MBH, MBW,
        w1=32 if w8 is None else TB.weight_arg(w8, "cpu"))
    if num_ref == 1:
        want = JB.encode_b_frame_device(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), j0["luma"],
            j0["u"], j0["v"], j2["luma"], j2["u"], j2["v"],
            jnp.asarray(use0), jnp.asarray(use1), jnp.asarray(fmv0),
            jnp.asarray(fmv1), qp, qpc, MBH, MBW, decimate=True,
            trellis=False, w1=32)
    else:
        rs_j = _stack_j([j0, j1])
        want = JB.encode_b_frame_device(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), rs_j["luma"],
            rs_j["u"], rs_j["v"], j2["luma"], j2["u"], j2["v"],
            jnp.asarray(use0), jnp.asarray(use1), jnp.asarray(fmv0),
            jnp.asarray(fmv1), qp, qpc, MBH, MBW, decimate=True,
            trellis=False, w1=32 if w8 is None else jnp.asarray(w8),
            ref8_0=jnp.asarray(ref8))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["cbp_luma"].max()) > 0


# ---------------------------------------------------------------------------
# The CABAC B writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_ref", [1, 2])
def test_cabac_b_writer_matches_reference(num_ref):
    """Seeded B syntax: every mb_type code 0-22, B_8x8 subs, mvds, cbps,
    levels and (num_ref 2) per-MB L0 references."""
    g = np.random.default_rng(30 + num_ref)
    n = MBH * MBW
    code = g.integers(0, 23, (MBH, MBW)).astype(np.int32)
    code.reshape(-1)[:23] = np.arange(23)
    subs = g.integers(0, 4, (MBH, MBW, 4)).astype(np.int32)
    mvd0 = g.integers(-40, 41, (MBH, MBW, 4, 2)).astype(np.int32)
    mvd1 = g.integers(-40, 41, (MBH, MBW, 4, 2)).astype(np.int32)
    cbp_l = g.integers(0, 16, (MBH, MBW)) * (g.random((MBH, MBW)) < 0.6)
    cbp_c = g.integers(0, 3, (MBH, MBW)) * (g.random((MBH, MBW)) < 0.6)
    lev = g.integers(-3, 4, (MBH, MBW, 4, 4, 4, 4)) \
        * (g.random((MBH, MBW, 4, 4, 4, 4)) < 0.2)
    for my in range(MBH):
        for mx in range(MBW):
            for b8 in range(4):
                if not cbp_l[my, mx] & (1 << b8):
                    lev[my, mx, 2 * (b8 >> 1):2 * (b8 >> 1) + 2,
                        2 * (b8 & 1):2 * (b8 & 1) + 2] = 0
    cdc = g.integers(-2, 3, (MBH, MBW, 2, 2, 2)) * (cbp_c > 0)[
        ..., None, None, None]
    cac = g.integers(-2, 3, (MBH, MBW, 2, 2, 2, 4, 4)) \
        * (g.random((MBH, MBW, 2, 2, 2, 4, 4)) < 0.2) \
        * (cbp_c == 2)[..., None, None, None, None, None]
    cac[..., 0, 0] = 0
    ref0 = g.integers(0, num_ref, (MBH, MBW)).astype(np.int32)
    outs = []
    for writer, bwc in ((TWriter, BitWriter), (JWriter, JBitWriter)):
        bw = bwc()
        bw.write(5, 0b10110)
        while not bw.byte_aligned():
            bw.write1(1)
        w = writer(MBW, MBH, 28, slice_is_i=False, slice_is_b=True)
        for a in range(n):
            my, mx = a // MBW, a % MBW
            m, cl, cc = int(code[my, mx]), int(cbp_l[my, mx]), \
                int(cbp_c[my, mx])
            args = (cl, cc, lev[my, mx], cdc[my, mx], cac[my, mx])
            kw = dict(ref0=int(ref0[my, mx]), num_ref=num_ref)
            if m == 0 and cl == 0 and cc == 0:
                w.write_b_skip_mb(my, mx)
            elif m <= 3:
                w.write_b_mb(my, mx, m, mvd0[my, mx, 0], mvd1[my, mx, 0],
                             *args, **kw)
            else:
                w.write_b_mb_ext(my, mx, m, subs[my, mx], mvd0[my, mx],
                                 mvd1[my, mx], *args, **kw)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        outs.append(bw.get_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 100


# ---------------------------------------------------------------------------
# The slice's bounds
# ---------------------------------------------------------------------------

def test_check_slice_accepts_config4():
    for refs in (1, 2, 8):
        p = TP.Params(**_kw(width=1920, height=1088, me_range=16,
                            ref_frames=refs),
                      stego=TP.StegoParams(em_rate=64, key=5))
        p.validate()
        check_slice(p)


@pytest.mark.parametrize("kw", [
    dict(partitions=False), dict(cabac=False), dict(b_adapt=1),
    dict(b_adapt=2)], ids=["partitions_off", "cavlc", "b_adapt1",
                           "b_adapt2"])
@pytest.mark.parametrize("refs", [1, 2])
def test_check_slice_accepts_b_options_of_the_slice(kw, refs):
    """Partitions off, CAVLC and b_adapt 1 and 2 with B frames (ROADMAP
    A14a-c), at one reference and at two."""
    p = t_params(_kw(**kw, ref_frames=refs, deblock_device=False))
    p.validate()
    check_slice(p)


@pytest.mark.parametrize("b_adapt", [0, 1, 2])
@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
@pytest.mark.parametrize("partitions", [True, False],
                         ids=["partitions", "16x16"])
def test_check_slice_accepts_pyramid_weightb_and_every_direct_mode(
        partitions, cabac, b_adapt):
    """b_pyramid, weightb and direct none / spatial / temporal / auto
    (ROADMAP A14d-f) on both B paths, at ref_frames 1, 2 and 8."""
    for refs in (1, 2, 8):
        for direct in range(4):
            p = t_params(_kw(partitions=partitions, cabac=cabac,
                             b_adapt=b_adapt, ref_frames=refs, bframes=3,
                             b_pyramid=True, weightb=True, direct=direct,
                             deblock_device=False))
            p.validate()
            assert p.b_pyramid
            check_slice(p)


@pytest.mark.parametrize("kw", [
    dict(cqm="jvt"), dict(noise_reduction=100), dict(deadzone_inter=20)],
    ids=["cqm", "nr", "deadzones"])
def test_check_slice_accepts_the_quant_options_with_b_frames(kw):
    """cqm, noise_reduction and the deadzones (refused before they were
    served) with B frames, beside a pyramid, weightb, temporal direct,
    the 8x8 transform, rd 2 and trellis."""
    kw = dict(kw, b_pyramid=True, bframes=3, weightb=True, direct=2,
              transform_8x8=True, rd=2, trellis=1)
    p = TP.Params(**_kw(**kw), stego=TP.StegoParams(em_rate=EM_RATE,
                                                    key=KEY))
    p.validate()
    assert p.bframes == 3
    check_slice(p)


@pytest.mark.parametrize("partitions", [True, False],
                         ids=["partitions", "16x16"])
@pytest.mark.parametrize("refs", [1, 2, 8])
def test_check_slice_accepts_trans8_rd_and_trellis_with_b_frames(
        refs, partitions):
    """The 8x8 transform, rd 1 and 2 and trellis 1 and 2 (ROADMAP A15
    but cqm) with B frames, CAVLC (trellis off: it needs CABAC) and
    CABAC, on both B paths."""
    for cabac in (False, True):
        for rd, trellis in ((1, 1), (2, 2)):
            p = t_params(_kw(partitions=partitions, cabac=cabac,
                             ref_frames=refs, transform_8x8=True, rd=rd,
                             trellis=trellis, deblock_device=False))
            p.validate()
            assert p.trellis == (trellis if cabac else 0)
            check_slice(p)


@pytest.mark.parametrize("kw,name", [
    # sub-8x8 partitions are served with B frames, but not at more than
    # one reference under the device deblock (ROADMAP F10)
    (dict(p4x4=True), "ROADMAP F10"),
    # adaptive quantization is served with B frames: zones, its A16
    # neighbour, stays refused beside it
    (dict(aq_mode=1, zones="0,9,q=30"), "zones (ROADMAP A16)"),
    # stego off is served with B frames and the intra compare: zones
    # stay refused beside it
    (dict(stego_off=True, zones="0,9,q=30"), "zones (ROADMAP A16)"),
], ids=["p4x4", "aq", "stego_off"])
def test_check_slice_refuses_b_options_outside_the_slice(kw, name):
    """The A16 options stay refused with B frames, also beside a
    pyramid, weightb, temporal direct, the 8x8 transform, rd 2 and
    trellis."""
    kw = dict(kw, b_pyramid=True, bframes=3, weightb=True, direct=2,
              transform_8x8=True, rd=2, trellis=1)
    stego = (TP.StegoParams() if kw.pop("stego_off", False)
             else TP.StegoParams(em_rate=EM_RATE, key=KEY))
    p = TP.Params(**_kw(**kw), stego=stego)
    p.validate()
    assert p.bframes == 3
    with pytest.raises(NotImplementedError, match=re.escape(name)):
        check_slice(p)
