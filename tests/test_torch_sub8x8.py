"""Sub-8x8 partitions (`p4x4`) in the port vs the JAX reference on the
CPU, exact.

Modules, on frames whose 4x4 blocks move individually (made with numpy
from a seed, as tests/test_sub8x8.py makes them) at 96x64 and me_range
4: B1's sub-unit instance's plain version against the reference's
`fullpel_search_sub` (and the kernel's output layout through
`units_to_st`), `decide_partition_sub`, the whole one- and
two-reference sub analysis (windows, qpel tables, `subpel_sub`), both
sub scans, `stego_costs_sub`'s rho bit for bit, the sub encodes (with
trellis and noise reduction, and on the stacked DPB), and the native
CAVLC and CABAC writers' sub_mb_type forms against the reference's
Python writers (with the 8x8 transform and mb_qp_delta, where the
noSubMbPartSizeLessThan8x8Flag rule applies).

Streams, byte-equal to the JAX `Encoder` (headers included), one JAX run
each (module-scoped), the port's decoder equal to the encoder's recon on
every frame and both extractors recovering the payload: CAVLC at one
reference, CABAC with trellis 1, ref_frames 2 (the host deblock, which
reads the references), transform_8x8 with aq_mode 1 under CAVLC (the
reference's Python-writer route) and bframes 2 with sub anchors. Also:
`check_slice` admits p4x4 and `check_multistream` refuses it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import cabac as J_CABAC
from video_steganography_pcamv_tpu.encoder import cavlc as J_CAVLC
from video_steganography_pcamv_tpu.encoder import inter as J_INTER
from video_steganography_pcamv_tpu.encoder import partition as J_PT
from video_steganography_pcamv_tpu.encoder import scan as J_SCAN
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import mc as J_MC
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.cost import (
    cost_mv_table as j_cost_mv_table)
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.bitstream import (
    BitWriter as JBitWriter)
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import native
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import inter as T_INTER
from video_steganography_pcamv_torch.encoder import partition as T_PT
from video_steganography_pcamv_torch.encoder import scan as T_SCAN
from video_steganography_pcamv_torch.encoder.core import check_slice
from video_steganography_pcamv_torch.encoder.multistream import (
    check_multistream)
from video_steganography_pcamv_torch.ops import fullpel as FP
from video_steganography_pcamv_torch.ops import mc as T_MC
from video_steganography_pcamv_torch.stego.cost import cost_mv_table
from video_steganography_pcamv_torch.stego.embed import (
    slot_unit_mvs, unit_start_mask)
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


W, H = 96, 64
MBH, MBW = H // 16, W // 16
RNG = 4
EM_RATE, KEY = 24, 77
MOVES = [(0, 1), (1, -1), (-1, 0), (2, 1), (0, -2), (-1, 2)]


def _texture(seed):
    rs = np.random.RandomState(seed)
    pad = 16
    big = rs.randint(30, 226, (H + 2 * pad, W + 2 * pad)).astype(np.int32)
    # smoothed, so that the subpel interpolation means something
    return (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
            + np.roll(np.roll(big, 1, 0), 1, 1)) // 4


def _moved(big, k):
    """Frame k of the texture: every 4x4 block displaced on its own, by
    a move that cycles with the block and the frame; in the right third
    the move is the MB's (whole partitions win there)."""
    pad = 16
    y = np.zeros((H, W), np.uint8)
    for j in range(H // 4):
        for i in range(W // 4):
            b = ((j // 4) * W + i // 4 if i >= W // 6 else j * (W // 4) + i)
            dy, dx = MOVES[(b + k) % len(MOVES)]
            y[4 * j:4 * j + 4, 4 * i:4 * i + 4] = \
                big[pad + 4 * j + dy:pad + 4 * j + dy + 4,
                    pad + 4 * i + dx:pad + 4 * i + dx + 4]
    return y


def _sequence(n, seed, flicker=False):
    """n frames of 4x4-moving content (the odd ones 10 brighter with
    `flicker`, so that older references win some blocks)."""
    big = _texture(seed)
    rs = np.random.RandomState(seed + 1)
    frames = []
    for k in range(n):
        y = _moved(big, k).astype(np.int32)
        if flicker and k % 2:
            y = np.clip(y + 10, 0, 255)
        u = rs.randint(100, 156, (H // 2, W // 2)).astype(np.uint8)
        v = rs.randint(100, 156, (H // 2, W // 2)).astype(np.uint8)
        frames.append(Frame(y.astype(np.uint8), u, v))
    return frames


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

LAM = 4


@pytest.fixture(scope="module")
def pair():
    """A reference frame (as both packages build it) and a current one,
    a random qpel MV predictor, the same inputs as numpy / JAX / torch."""
    big = _texture(3)
    ref = _moved(big, 0)
    cur = _moved(big, 1).astype(np.int32)
    uv = np.full((H // 2, W // 2), 128, np.int32)
    rs = np.random.RandomState(5)
    prev = rs.randint(-9, 10, (MBH, MBW, 2)).astype(np.int32)
    jref = J_MC.build_ref(jnp.asarray(ref), jnp.asarray(uv), jnp.asarray(uv))
    tref = T_MC.build_ref(*(torch.as_tensor(a.astype(np.int32))
                            for a in (ref, uv, uv)))
    return dict(cur=cur, prev=prev, jref=jref, tref=tref,
                tcur=torch.as_tensor(cur), tprev=torch.as_tensor(prev))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.fixture(scope="module")
def j_search(pair):
    """The reference's per-4x4 full-pel search on the pair."""
    st = J_PT.fullpel_search_sub(
        jnp.asarray(pair["cur"]), pair["jref"]["luma"][0],
        jnp.asarray(pair["prev"] >> 2), RNG, MBH, MBW, LAM)
    return {k: np.asarray(v) for k, v in st.items()}


def test_fullpel_search_sub_equals_reference(pair, j_search):
    got = FP.fullpel_sub(pair["tcur"], pair["tref"]["luma"][0].to(
        torch.uint8), pair["tprev"] >> 2, RNG, MBH, MBW, LAM)
    assert sorted(got) == sorted(j_search)
    for k, want in j_search.items():
        _eq(got[k], want, k)


def test_sub_kernel_output_layout(pair):
    """The kernel's [n, 41] (cost, dy-outer scan index) pairs, built here
    from the plain search in the kernel's unit order, give back the plain
    `st` through `units_to_st` (rng 3, so that the scan indices differ
    from the 4x4 layout of the search)."""
    rng = 3
    st = FP.fullpel_search_sub(pair["tcur"], pair["tref"]["luma"][0].to(
        torch.uint8), pair["tprev"] >> 2, rng, MBH, MBW, LAM)
    side = 2 * rng + 1
    order = [("c16", 1), ("c16x8", 2), ("c8x16", 2), ("c8", 4), ("c84", 8),
             ("c48", 8), ("c44", 16)]
    cost = torch.cat([st[k].reshape(MBH, MBW, c) for k, c in order], -1)
    mv = torch.cat([st["mv" + k[1:]].reshape(MBH, MBW, c, 2)
                    for k, c in order], 2)
    idx = (mv[..., 1] + rng) * side + mv[..., 0] + rng
    assert cost.shape[-1] == FP.SUB_UNITS
    back = FP.units_to_st(cost, idx, rng)
    assert sorted(back) == sorted(st)
    for k in st:
        assert torch.equal(back[k], st[k]), k


def test_decide_partition_sub_equals_reference(j_search):
    for allow in (True, False):
        want = J_PT.decide_partition_sub(
            {k: jnp.asarray(v) for k, v in j_search.items()}, MBH, MBW, LAM,
            allow)
        got = T_PT.decide_partition_sub(
            {k: torch.as_tensor(v) for k, v in j_search.items()}, MBH, MBW,
            LAM, allow)
        for g, w, name in zip(got, want, ("part", "sub_type", "mv4fp")):
            _eq(g, w, name)
    assert (np.asarray(want[0]) == 0).all()


@pytest.fixture(scope="module")
def j_analysis(pair):
    """The reference's one-reference sub analysis (its encoder's call)."""
    out = J_PT.analyse_p_frame_sub(
        jnp.asarray(pair["cur"]), pair["jref"]["luma"],
        jnp.asarray(pair["prev"]), RNG, MBH, MBW, LAM, 2)
    return [np.asarray(a) for a in out]


def test_analyse_p_frame_sub_equals_reference(pair, j_analysis):
    """The decision, the per-4x4 windows and qpel tables, subpel_sub."""
    got = T_PT.analyse_p_frame_sub(
        pair["tcur"], pair["tref"]["luma"].to(torch.uint8), pair["tprev"],
        RNG, MBH, MBW, LAM)
    part, sub, mv4, r_idx4, blocks4, wht4, _mb_cost = j_analysis
    assert (part == 3).any() and (sub > 0).any()
    for g, w, name in zip(got, (part, sub, mv4, r_idx4, blocks4, wht4),
                          ("part", "sub_type", "mv4", "r_idx4", "blocks4",
                           "wht4")):
        _eq(g, w, name)


def test_analyse_p_frame_sub_mref_equals_reference(pair):
    """Two stacked references (the second the reference frame 10
    brighter) with one valid and with both valid."""
    jl = pair["jref"]["luma"]
    jrefs = jnp.stack([jl, jnp.clip(jl + 10, 0, 255)])
    trefs = torch.as_tensor(np.asarray(jrefs)).to(torch.uint8)
    for n_valid in (1, 2):
        want = J_PT.analyse_p_frame_sub_mref(
            jnp.asarray(pair["cur"]), jrefs, jnp.asarray(n_valid),
            jnp.asarray(pair["prev"]), RNG, MBH, MBW, LAM, 2, 2)
        got = T_PT.analyse_p_frame_sub_mref(
            pair["tcur"], trefs, n_valid, pair["tprev"], RNG, MBH, MBW,
            LAM, 2)
        for g, w, name in zip(got, want[:7], ("part", "sub_type", "mv4",
                                              "ref8", "r_idx4", "blocks4",
                                              "wht4")):
            _eq(g, w, "%s n_valid %d" % (name, n_valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_sub_scans_equal_reference(seed):
    """scan_p_frame_sub (with and without references) and the forced
    rescan on a random sub-partitioned field."""
    rs = np.random.RandomState(seed)
    mbh, mbw = 4, 5
    part = rs.randint(0, 4, (mbh, mbw)).astype(np.int32)
    sub = np.where((part == 3)[..., None],
                   rs.randint(0, 4, (mbh, mbw, 4)), 0).astype(np.int32)
    mv4 = rs.randint(-12, 13, (4 * mbh, 4 * mbw, 2)).astype(np.int32)
    cbl = rs.randint(0, 16, (mbh, mbw)) * (rs.rand(mbh, mbw) < 0.5)
    cbc = rs.randint(0, 3, (mbh, mbw)) * (rs.rand(mbh, mbw) < 0.5)
    ref8 = rs.randint(0, 2, (2 * mbh, 2 * mbw)).astype(np.int32)
    for r8 in (None, ref8):
        want = J_SCAN.scan_p_frame_sub(part, sub, mv4, cbl, cbc, ref8=r8)
        got = T_SCAN.scan_p_frame_sub(part, sub, mv4, cbl, cbc, ref8=r8)
        for g, w in zip(got, want):
            _eq(g, w)
        skip = want[0]
        for g, w in zip(T_SCAN.scan_p_frame_sub_forced(part, sub, mv4, skip,
                                                       ref8=r8),
                        J_SCAN.scan_p_frame_sub_forced(part, sub, mv4, skip,
                                                       ref8=r8)):
            _eq(g, w)


def test_stego_costs_sub_rho_bit_equal(pair, j_analysis):
    """rho (bit for bit), the alternative MVs and the slot mask of every
    slot of every MB, at the encoder's arguments."""
    part, sub, mv4, r_idx4, blocks4, wht4, _c = j_analysis
    qp = 26
    lam = 4
    cbl = np.zeros((MBH, MBW), np.int32)
    _skip, _mvd, mvp16, _f = J_SCAN.scan_p_frame_sub(part, sub, mv4, cbl,
                                                     cbl)
    U = unit_start_mask(part, sub)
    rank = np.cumsum(U, axis=-1) - U
    mvp_s = np.where(U[..., None], np.take_along_axis(
        mvp16, np.minimum(rank, 15)[..., None].repeat(2, -1), axis=2),
        0).astype(np.int32)
    want = J_PT.stego_costs_sub(
        jnp.asarray(pair["cur"]), jnp.asarray(blocks4), jnp.asarray(wht4),
        jnp.asarray(r_idx4), jnp.asarray(part), jnp.asarray(sub),
        jnp.asarray(mv4), jnp.asarray(mvp_s),
        jnp.asarray(j_cost_mv_table(lam)), qp, MBH, MBW, decimate=True)
    got = T_PT.stego_costs_sub(
        pair["tcur"], torch.as_tensor(blocks4), torch.as_tensor(wht4),
        torch.as_tensor(r_idx4), part, sub, torch.as_tensor(mv4),
        torch.as_tensor(mvp_s), torch.as_tensor(cost_mv_table(lam)), qp,
        MBH, MBW)
    rho_w = np.asarray(want[0])
    assert rho_w.dtype == np.float32
    _eq(got[0].numpy().view(np.uint32), rho_w.view(np.uint32), "rho")
    _eq(got[1], want[1], "alt")
    _eq(got[2], want[2], "valid")
    # the slot mask is the unit-start mask, and slot 0 carries the
    # MB's first unit MV
    _eq(got[2], U)
    _eq(slot_unit_mvs(mv4, MBH, MBW)[:, :, 0], mv4[::4, ::4])


@pytest.mark.parametrize("trellis,nr", [(False, False), (True, True)])
def test_encode_p_frame_device4_equals_reference(pair, j_analysis, trellis,
                                                 nr):
    """The sub encode (force-zero on a few MBs) at one reference and on
    a stack of two with a per-4x4 reference map."""
    _p, _s, mv4, *_ = j_analysis
    rs = np.random.RandomState(2)
    fz = rs.rand(MBH, MBW) < 0.2
    uv = (np.arange(H * W // 4).reshape(H // 2, W // 2) % 97 + 80) \
        .astype(np.int32)
    nr_off = (rs.randint(0, 40, (4, 4)).astype(np.int32) if nr else None)
    qp, qpc = 24, 26
    want = J_INTER.encode_p_frame_device4(
        jnp.asarray(pair["cur"]), jnp.asarray(uv), jnp.asarray(uv),
        pair["jref"]["luma"], pair["jref"]["u"], pair["jref"]["v"],
        jnp.asarray(mv4), qp, qpc, MBH, MBW, force_zero=jnp.asarray(fz),
        trellis=trellis,
        nr_offset=None if nr_off is None else jnp.asarray(nr_off))
    t = torch.as_tensor
    got = T_INTER.encode_p_frame_device4(
        pair["tcur"], t(uv), t(uv), pair["tref"]["luma"], pair["tref"]["u"],
        pair["tref"]["v"], t(mv4), qp, qpc, MBH, MBW, force_zero=t(fz),
        trellis=trellis, nr_offset=None if nr_off is None else t(nr_off))
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k], k)
    ref4 = np.repeat(np.repeat(rs.randint(0, 2, (2 * MBH, 2 * MBW)), 2, 0),
                     2, 1).astype(np.int32)
    stack = {k: jnp.stack([pair["jref"][k], pair["jref"][k] // 2])
             for k in ("luma", "u", "v")}
    want = J_INTER.encode_p_frame_device4_mref(
        jnp.asarray(pair["cur"]), jnp.asarray(uv), jnp.asarray(uv),
        stack["luma"], stack["u"], stack["v"], jnp.asarray(mv4),
        jnp.asarray(ref4), qp, qpc, MBH, MBW, trellis=trellis)
    got = T_INTER.encode_p_frame_device4(
        pair["tcur"], t(uv), t(uv), *(t(np.asarray(stack[k]))
                                      for k in ("luma", "u", "v")),
        t(mv4), qp, qpc, MBH, MBW, ref4=t(ref4), trellis=trellis)
    for k in want:
        _eq(got[k], want[k], "mref " + k)


def _writer_inputs(seed, mbh=3, mbw=4):
    """A random sub-partitioned P slice's syntax: skips, parts, sub
    types (some MBs all P_L0_8x8), unit mvds in coding order, cbps,
    levels, 8x8-transform flags and levels, a qp grid."""
    rs = np.random.RandomState(seed)
    n = mbh * mbw
    part = rs.randint(0, 4, (mbh, mbw)).astype(np.int32)
    sub = np.where((part == 3)[..., None] & (rs.rand(mbh, mbw, 1) < 0.7),
                   rs.randint(0, 4, (mbh, mbw, 4)), 0).astype(np.int32)
    skip = (rs.rand(mbh, mbw) < 0.15) & (part == 0)
    mvd = rs.randint(-9, 10, (mbh, mbw, 16, 2)).astype(np.int32)
    cbl = rs.randint(0, 16, (mbh, mbw)).astype(np.int32)
    cbc = rs.randint(0, 3, (mbh, mbw)).astype(np.int32)
    lev = (rs.randint(-3, 4, (mbh, mbw, 256))
           * (rs.rand(mbh, mbw, 256) < 0.15)).astype(np.int16)
    lev8 = (rs.randint(-3, 4, (mbh, mbw, 256))
            * (rs.rand(mbh, mbw, 256) < 0.15)).astype(np.int16)
    cdc = (rs.randint(-2, 3, (mbh, mbw, 8))
           * (cbc > 0)[..., None]).astype(np.int16)
    cac = (rs.randint(-2, 3, (mbh, mbw, 128)) * (rs.rand(mbh, mbw, 128) < 0.1)
           * (cbc == 2)[..., None]).astype(np.int16)
    t8 = rs.rand(mbh, mbw) < 0.5
    t8 &= (part != 3) | np.all(sub == 0, axis=-1)
    # a coded 8x8 block keeps a level, an uncoded one none
    for my in range(mbh):
        for mx in range(mbw):
            for b in range(4):
                on = (cbl[my, mx] >> b) & 1
                blk4 = lev[my, mx].reshape(4, 4, 16)
                for (by, bx) in ((2 * (b >> 1) + i, 2 * (b & 1) + j)
                                 for i in (0, 1) for j in (0, 1)):
                    if not on:
                        blk4[by, bx] = 0
                blk8 = lev8[my, mx].reshape(2, 2, 64)[b >> 1, b & 1]
                if not on:
                    blk8[:] = 0
                elif not blk8.any():
                    blk8[0] = 1
    qp_grid = rs.randint(20, 33, (mbh, mbw)).astype(np.int32)
    return dict(n=n, mbh=mbh, mbw=mbw, part=part, sub=sub, skip=skip,
                mvd=mvd, cbl=cbl, cbc=cbc, lev=lev, lev8=lev8, cdc=cdc,
                cac=cac, t8=t8, qp_grid=qp_grid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_cavlc_sub_writer_equals_reference(seed):
    """The native CAVLC writer's sub_mb_type form against the reference's
    Python writer, plain and with the 8x8 transform and mb_qp_delta (its
    `_encode_p_sub` route under AQ or the 8x8 transform)."""
    d = _writer_inputs(seed)
    mbh, mbw, n, qp = d["mbh"], d["mbw"], d["n"], 26
    for t8_mode, aq in ((False, False), (True, True)):
        bw = JBitWriter()
        bw.write_ue(7)
        fc = J_CAVLC.FrameCavlc(mbw, mbh, trans8_mode=t8_mode)
        run, last = 0, qp
        for my in range(mbh):
            for mx in range(mbw):
                if d["skip"][my, mx]:
                    run += 1
                    fc.set_mb_nnz_zero(mx, my)
                    continue
                bw.write_ue(run)
                run = 0
                dq = 0
                if aq and (d["cbl"][my, mx] or d["cbc"][my, mx]):
                    g = int(d["qp_grid"][my, mx])
                    dq = ((g - last + 26) % 52) - 26
                    last = g
                pt = int(d["part"][my, mx])
                fc.write_p_mb(
                    bw, mx, my, pt, d["mvd"][my, mx], int(d["cbl"][my, mx]),
                    int(d["cbc"][my, mx]),
                    d["lev"][my, mx].reshape(4, 4, 4, 4),
                    d["cdc"][my, mx].reshape(2, 2, 2),
                    d["cac"][my, mx].reshape(2, 2, 2, 4, 4), qp_delta=dq,
                    sub_types=d["sub"][my, mx] if pt == 3 else None,
                    trans8=bool(t8_mode and d["t8"][my, mx]),
                    luma8_lev=(d["lev8"][my, mx].reshape(2, 2, 8, 8)
                               if t8_mode else None))
        if run:
            bw.write_ue(run)
        bw.rbsp_trailing()
        want = bw.get_bytes()
        hb = JBitWriter()
        hb.write_ue(7)
        hdr, nbits = hb.partial_bytes()
        got = native.write_slice(
            hdr, nbits, 0, mbw, mbh, skip=d["skip"].reshape(n),
            part=d["part"].reshape(n), mvd4=d["mvd"].reshape(n, 16, 2),
            sub_type=d["sub"].reshape(n, 4), cbp_luma=d["cbl"],
            cbp_chroma=d["cbc"], luma_blocks=d["lev"].reshape(n, 16, 16),
            chroma_dc=d["cdc"].reshape(n, 2, 4),
            chroma_ac=d["cac"].reshape(n, 2, 4, 16),
            trans8=d["t8"].reshape(n) if t8_mode else None,
            luma8_lev=d["lev8"] if t8_mode else None, trans8_mode=t8_mode,
            qp_grid=d["qp_grid"] if aq else None, slice_qp=qp)
        assert got == want, (seed, t8_mode, aq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_cabac_sub_writer_equals_reference(seed):
    """The native CABAC writer's sub_mb_type form against the reference's
    Python CabacSliceWriter, plain and with the 8x8 transform and
    mb_qp_delta."""
    d = _writer_inputs(seed)
    mbh, mbw, n, qp = d["mbh"], d["mbw"], d["n"], 26
    for t8_mode, aq in ((False, False), (True, True)):
        bw = JBitWriter()
        bw.write_ue(7)
        hdr, nbits = bw.partial_bytes()
        while not bw.byte_aligned():
            bw.write1(1)
        w = J_CABAC.CabacSliceWriter(mbw, mbh, qp, slice_is_i=False,
                                     trans8_mode=t8_mode)
        last = qp
        for a in range(n):
            my, mx = divmod(a, mbw)
            if d["skip"][my, mx]:
                w.write_skip_mb(my, mx)
            else:
                dq = 0
                if aq and (d["cbl"][my, mx] or d["cbc"][my, mx]):
                    g = int(d["qp_grid"][my, mx])
                    dq = ((g - last + 26) % 52) - 26
                    last = g
                pt = int(d["part"][my, mx])
                w.write_p_mb(
                    my, mx, pt, d["mvd"][my, mx], int(d["cbl"][my, mx]),
                    int(d["cbc"][my, mx]),
                    d["lev"][my, mx].reshape(4, 4, 4, 4),
                    d["cdc"][my, mx].reshape(2, 2, 2),
                    d["cac"][my, mx].reshape(2, 2, 2, 4, 4),
                    sub_types=d["sub"][my, mx] if pt == 3 else None,
                    trans8=bool(t8_mode and d["t8"][my, mx]),
                    luma8_lev=(d["lev8"][my, mx].reshape(2, 2, 8, 8)
                               if t8_mode else None), dqp=dq)
            w.end_mb(a == n - 1)
        w.end_slice(bw)
        want = bw.get_bytes()
        got = native.write_slice_cabac(
            hdr, nbits, 0, mbw, mbh, qp, skip=d["skip"].reshape(n),
            part=d["part"].reshape(n), mvd4=d["mvd"].reshape(n, 16, 2),
            sub_type=d["sub"].reshape(n, 4), cbp_luma=d["cbl"],
            cbp_chroma=d["cbc"], luma_blocks=d["lev"].reshape(n, 16, 16),
            chroma_dc=d["cdc"].reshape(n, 2, 4),
            chroma_ac=d["cac"].reshape(n, 2, 4, 16),
            trans8=d["t8"].astype(np.int32) if t8_mode else None,
            luma8_lev=d["lev8"].reshape(n, 256) if t8_mode else None,
            trans8_mode=t8_mode, qp_grid=d["qp_grid"] if aq else None)
        assert got == want, (seed, t8_mode, aq)


# --------------------------------------------------------------------------
# streams
# --------------------------------------------------------------------------

def _kw(**kw):
    return dict(dict(width=W, height=H, qp=26, me_range=RNG, p4x4=True),
                **kw)


_RUNS = {
    "cavlc": (_kw(), 4, False),
    "cabac_trellis": (_kw(cabac=True, trellis=1), 4, False),
    "ref2": (_kw(ref_frames=2), 5, True),
    "trans8_aq_cavlc": (_kw(transform_8x8=True, aq_mode=1), 4, False),
    "bframes2": (_kw(bframes=2, b_adapt=0), 5, False),
}


def _run_pair(kw, n_frames, flicker):
    """One JAX run and one port run on the same frames; the recon the
    port's encoder metered for every frame (by display index)."""
    frames = _sequence(n_frames, seed=11, flicker=flicker)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    want = jenc.headers() + b"".join(jenc.encode_frame(f) for f in frames) \
        + jenc.flush()
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    recon, meter, subs = {}, tenc._accumulate_psnr, []

    def keep_recon(frame, y, u, v, recon_planes=None):
        disp = next(i for i, f in enumerate(frames) if f is frame)
        recon[disp] = tuple(np.asarray(t.cpu()) for t in
                            (recon_planes or tenc.recon_prev))
        if tenc.last_sub is not None:
            subs.append(tenc.last_sub)
        return meter(frame, y, u, v, recon_planes)
    tenc._accumulate_psnr = lambda frame, y, u, v, recon=None: keep_recon(
        frame, y, u, v, recon)
    got = tenc.headers() + b"".join(tenc.encode_frame(f) for f in frames) \
        + tenc.flush()
    return dict(want=want, got=got, tenc=tenc, recon=recon, n=n_frames,
                subs=subs)


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, case):
    if case not in runs:
        runs[case] = _run_pair(*_RUNS[case])
    return runs[case]


@pytest.mark.parametrize("case", list(_RUNS))
def test_stream_byte_equal_to_reference(case, runs):
    r = _get(runs, case)
    assert r["got"] == r["want"]
    # sub-8x8 splits, and MBs whose partitions are all 8x8 or larger
    # (under the 8x8 transform these take the 8x8-capable encode)
    assert any((s[0] == 3).any() and (s[1] > 0).any() for s in r["subs"])
    assert any((s[0] != 3).any() for s in r["subs"])


@pytest.mark.parametrize("case", list(_RUNS))
def test_decoded_frames_equal_the_recon(case, runs):
    r = _get(runs, case)
    dec = decode_annexb(r["got"])
    assert len(dec) == r["n"] == len(r["recon"])
    jdec = j_decode(r["got"])
    for i, (a, b) in enumerate(zip(dec, jdec)):
        for pl, want, s in zip(("y", "u", "v"), r["recon"][i], (1, 2, 2)):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
            np.testing.assert_array_equal(
                getattr(a, pl), want[:H // s, :W // s],
                err_msg="%s frame %d %s" % (case, i, pl))


@pytest.mark.parametrize("case", list(_RUNS))
def test_both_extractors_recover_the_payload(case, runs):
    r = _get(runs, case)
    sent = r["tenc"]._stego.sent_messages
    assert r["tenc"].stats.mv_flips > 0
    dec = decode_annexb(r["got"])
    for got in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(r["got"], em_rate=EM_RATE, key=KEY)):
        assert len(got) == len(sent)
        for g, s in zip(got, sent):
            np.testing.assert_array_equal(g, s)


def test_check_slice_admits_p4x4_and_multistream_refuses_it():
    for kw in (_kw(), _kw(cabac=True, trellis=1, ref_frames=3),
               _kw(transform_8x8=True, rd=1, aq_mode=1, noise_reduction=200,
                   cqm="jvt"), _kw(bframes=3, b_pyramid=True, direct=3),
               _kw(partitions=False, deblock_device=False)):
        p = TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
        p.validate()
        check_slice(p)
    p = TP.Params(**_kw(), stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    with pytest.raises(NotImplementedError, match="p4x4"):
        check_multistream(p)


@pytest.mark.parametrize("kw", [
    dict(ref_frames=2), dict(ref_frames=8, cabac=True, trellis=1),
    dict(ref_frames=2, bframes=2, b_adapt=0)], ids=["ref2", "ref8", "b"])
def test_check_slice_refuses_p4x4_multiref_device_deblock(kw):
    """At more than one reference the reference's sub path deblocks on
    the device without the reference map (ROADMAP F10): refused by name,
    and served with the host deblock."""
    p = TP.Params(**_kw(deblock_device=True, **kw),
                  stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    p.validate()
    with pytest.raises(NotImplementedError, match="ROADMAP F10"):
        check_slice(p)
    p.deblock_device = False
    check_slice(p)
    p.deblock_device, p.ref_frames = True, 1
    check_slice(p)
