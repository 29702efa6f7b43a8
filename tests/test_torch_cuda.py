"""Card-only checks of the port (marked `cuda`; skipped without a GPU).

This file imports no jax, so on a GPU machine without jax it runs on
its own:  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
- kernels B1 and B6 vs their plain versions on an odd MB grid
  (textured and flat content, random predictors for B1) at rng 7, 16
  and 20, and at the largest lam their 32-bit keys admit;
- kernel B5 (the whole deblock_frame call, uint8 in and out) vs
  edge_params + its plain version at qp 26 and 40;
- kernels B3 and B4 (the windows in, B2's rows built inside) vs their
  plain versions, and B2's standalone entry vs the plain tables, at
  112x80 and on a band of 1080p MB rows (decimate on and off for B4);
  the fused analyse tail (B3 -> B4 in one launch) vs subpel_parts +
  probe_maps_plain at 112x80 and on 1080p MB rows, with a zero
  predictor, decimate off and jvt with deadzone 16; B4's check entry on
  rows on the +-3 box's corners and edges; B3's mb_cost instance with
  both predictors; the launches a P frame on a stego path (the fused
  tail alone) and on a stego-off path (B3 alone);
- a small encode on cuda is byte-equal to the same encode on the cpu,
  for both tail_kernel settings;
- kernels B6, B7, B8a and B8b vs their plain versions (B8 at qp 20, 26
  and 38, zero_dc and use_dc on and off);
- the fused luma encode (csrc/luma_p.cu) vs its plain version on an odd
  MB count at qp 0-51, on flat content, with force-zero, with an MB
  subset and the 13 x n probe form, with the levels omitted, and an MB
  number outside the plane failing the launch;
- the 112x80 16x16-only encode (partitions=False) on cuda is
  byte-equal to the same encode on the cpu;
- kernel B9 vs its plain version on real MVs and on +-20 corner MVs
  (7x5 and 8x5 MB grids), and a window outside the planes failing the
  launch; B10 vs its plain version at rng 7, 8, 16 and 20; B5 with the
  trans8 rule and slice offsets;
- a 120x72 (cropped) encode on cuda is byte-equal to the cpu encode;
- the 128x96 config-3 encode (transform_8x8, rd 1) on cuda is byte-equal
  to the same encode on the cpu;
- at 112x80, cuda == cpu streams under CABAC on the main path (both
  tail_kernel settings), on config 3 and on the 16x16-only path, and at
  the reference's default Params (PSNR and SSIM on, the host deblock's
  twin on the card, unpipelined), whose close() dicts agree too (PSNR
  exactly, SSIM to rtol 1e-5: the float32 sums' order differs);
- kernel B7 (a warp an MB) vs its plain version on odd MB grids, the
  120x72 padded grid and +-20 corner MVs, and a window outside the
  planes failing the launch;
- B9 with a per-8x8 reference on a stack of 2 and 3 references vs its
  plain version, and a reference index outside the stack failing the
  launch; B5 with a per-4x4 reference map whose neighbours differ only
  in their reference vs edge_params + its plain version;
- at 112x80, cuda == cpu multi-reference streams: ref_frames 2 under
  CAVLC and CABAC, ref_frames 3 with keyint_max 3 on the CPU branch,
  and partitions off with the host deblock's twin;
- at 112x80, cuda == cpu B streams (BASELINE config 4: bframes 2,
  ref_frames 2, CABAC; and bframes 1 at one reference), with every
  kernel call of the B frames held array-equal to its plain version on
  the same inputs: B1 against a zero predictor, B9 on the L0 stack with
  the per-MB L0 map and on L1, B3' on the B windows and the fused luma
  encode on the bipred predictions; the per-B-frame launch counts; and
  pyramid streams (b_pyramid, weightb) under every direct mode, the
  reference B's kernel calls included;
- the fused luma encode's levels-in entry vs its plain version on the
  trellis's levels at qp 0-51; `trellis_quant` on the card equal to the
  CPU for every cat; at 112x80, cuda == cpu streams with trellis, the
  8x8 transform and rd 2 on the multi-reference, 16x16 and main paths,
  and on B streams (a pyramid with weightb and trellis, the 8x8
  transform with rd under CABAC and CAVLC), the B frames' kernel calls
  held against their plain versions;
- the fused luma encode's noise-reduction instance vs its plain version
  under the jvt tables at qp 0-51 (sums included), both instances on
  residuals whose quant products wrap, B4 under jvt, and cuda == cpu
  streams with cqm jvt, the deadzones, custom 8x8 lists and noise
  reduction on the main, 16x16 and B paths;
- adaptive quantization: the fused luma encode's per-MB qp instances
  (the DCT entry, the NR instance and the levels-in entry) under random
  grids of qps 10-51 vs their plain versions, B5 under random qp maps
  vs edge_params + its plain version, and cuda == cpu streams with
  aq_mode 1 at one reference (CAVLC) and on config 4 (bframes 2,
  ref_frames 2, CABAC);
- the multi-stream layer: MultiEncoder's two streams at 128x96 on cuda
  equal to the cpu streams on both tail_kernel settings, with the
  kernels' launches per P step; the tiled step over 4 tiles on cuda:0
  equal to the untiled step there;
- sub-8x8 partitions: B1's sub-unit instance (`pcamv_fullpel_sub`) vs
  its plain version on an odd MB grid at rng 4, 16 and 20 (random
  predictors, predictors at the window's corners, flat content, the
  largest lam), and cuda == cpu streams with p4x4 at 96x64 on 4x4-moving
  content (CAVLC; CABAC with trellis; ref_frames 2; ref_frames 3 with CABAC,
  both on the host deblock (ROADMAP F10); transform_8x8 with
  aq_mode 1; bframes 2), with the sub instance, the fused luma encode and
  B5 launched on the path;
- the plain encoder (stego off): B3's mb_cost output vs its plain twin
  at 1080p shapes (random and zero predictors), with the stego
  instance's outputs unmoved; B5 on a plain P frame with intra MBs in
  patches vs edge_params + its plain version; and cuda == cpu streams
  at 112x80 on a clip with occlusion reveals (CAVLC, CABAC, rd 2,
  ref_frames 2), with B3's mb_cost instance launched and B4 never;
- the plain encoder's sub-8x8 path and intra MBs in B slices: B5 on a
  plain sub P frame (per-4x4 motion, intra patches) vs edge_params +
  its plain version; cuda == cpu streams with p4x4 at 96x64 (rd 1
  under CAVLC; rd 2 with trellis 2, CABAC and transform_8x8) and with
  bframes 2 under CABAC at 112x80, B4 never launched.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_torch import Encoder
from video_steganography_pcamv_torch.encoder import inter as INTER
from video_steganography_pcamv_torch.encoder import partition as PT
from video_steganography_pcamv_torch.encoder import qpel_table as QT
from video_steganography_pcamv_torch.encoder import slicetype as ST
from video_steganography_pcamv_torch.encoder.me import fullpel_search
from video_steganography_pcamv_torch.ops import deblock as DB
from video_steganography_pcamv_torch.ops import fullpel as FP
from video_steganography_pcamv_torch.ops import lumap as LP
from video_steganography_pcamv_torch.ops import mc as TMC
from video_steganography_pcamv_torch.ops import probe as PR
from video_steganography_pcamv_torch.ops import tq4 as TQ
from video_steganography_pcamv_torch.ops.transform import chroma_qp
from video_steganography_pcamv_torch.params import Params, StegoParams
from video_steganography_pcamv_torch.utils.yuv import (Frame,
                                                       synthetic_sequence)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _search_inputs(dev, mbh, mbw, flat, seed):
    """(cur int32, the padded uint8 reference plane) on a textured or a
    flat frame pair (flat: every displacement ties)."""
    r = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    ref = r.randint(0, 256, (h, w)).astype(np.int32)
    cur = np.roll(ref, (2, -3), (0, 1))
    if flat:
        ref[:] = 100
        cur[:] = 101
    return (torch.as_tensor(cur, device=dev),
            TMC.pad_plane(torch.as_tensor(ref, device=dev)).to(torch.uint8))


@pytest.mark.parametrize("rng", [7, 16, 20])
@pytest.mark.parametrize("flat", [False, True])
def test_b1_kernel_matches_plain(dev, flat, rng):
    """B1 on an odd 5x7 MB grid, random predictors (past the window's
    edge too), at search ranges that are and are not multiples of 4."""
    mbh, mbw, lam = 5, 7, 4
    cur, ref = _search_inputs(dev, mbh, mbw, flat, rng)
    pred = torch.as_tensor(np.random.RandomState(rng).randint(
        -rng - 4, rng + 5, (mbh, mbw, 2)).astype(np.int32), device=dev)
    got = FP.fullpel_parts(cur, ref, pred, rng, mbh, mbw, lam)
    want = FP.fullpel_search_parts(cur, ref, pred, rng, mbh, mbw, lam)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rng", [7, 20])
def test_b1_b6_kernels_match_plain_at_the_largest_lam(dev, rng):
    """Costs next to 2^20, the limit of the kernel's 32-bit key."""
    mbh, mbw = 5, 7
    lam = FP.max_lam(rng)
    cur, ref = _search_inputs(dev, mbh, mbw, False, rng + 2)
    pred = torch.as_tensor(np.random.RandomState(rng).randint(
        -rng, rng + 1, (mbh, mbw, 2)).astype(np.int32), device=dev)
    got = FP.fullpel_parts(cur, ref, pred, rng, mbh, mbw, lam)
    want = FP.fullpel_search_parts(cur, ref, pred, rng, mbh, mbw, lam)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    zero = torch.zeros_like(pred)
    got = FP.fullpel_search16(cur, ref, rng, mbh, mbw, lam)
    want = fullpel_search(cur, ref, zero, rng, mbh, mbw, lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("rng", [7, 16, 20])
@pytest.mark.parametrize("flat", [False, True])
def test_b6_kernel_matches_plain_odd_grid(dev, flat, rng):
    mbh, mbw, lam = 5, 7, 4
    cur, ref = _search_inputs(dev, mbh, mbw, flat, rng + 1)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    got = FP.fullpel_search16(cur, ref, rng, mbh, mbw, lam)
    want = fullpel_search(cur, ref, zero, rng, mbh, mbw, lam)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("qp", [26, 40])
def test_b5_kernel_matches_plain(dev, qp):
    mbh, mbw = 5, 9
    g = np.random.default_rng(qp)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(128 + g.integers(-24, 25, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = (g.random((mbh, mbw)) < 0.15)
    skip = (g.random((mbh, mbw)) < 0.2) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.5
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2))
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4]]
    y8 = [p.to(torch.uint8) for p in t[:3]]
    kept = [p.clone() for p in y8]
    got = DB.deblock_frame(*y8, *t[3:], qp, chroma_qp(qp), mbh, mbw)
    par = DB.edge_params(*t[3:], qp, chroma_qp(qp), mbh, mbw)
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert a.dtype == torch.uint8 and torch.equal(a, b)
    # the inputs are left as they were
    for a, b in zip(y8, kept):
        assert torch.equal(a, b)


def _tail_inputs(dev, w, h, seed):
    """A frame pair through B1 (zero predictor), the partition decision
    and the window gather, as the accelerator branch runs them."""
    mbh, mbw = h // 16, w // 16
    fr = synthetic_sequence(w, h, 2, seed=seed)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = TMC.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                        device=dev), c, c)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    ref8 = ref["luma"].to(torch.uint8)
    st = FP.fullpel_parts(cur, ref8[0], zero, 16, mbh, mbw, 4)
    part, mvfp8 = PT.decide_partition(st, mbh, mbw, 4)
    mvfp8 = mvfp8.contiguous()
    windows = PT.gather_windows8(ref8, mvfp8, mbh, mbw)
    prev_mv = torch.as_tensor(np.random.RandomState(seed).randint(
        -40, 41, (mbh, mbw, 2)).astype(np.int32), device=dev)
    return cur, windows, part, mvfp8, prev_mv, mbh, mbw


@pytest.mark.parametrize("w,h,qp", [(112, 80, 26), (112, 80, 40),
                                    (1920, 64, 26)],
                         ids=["112x80-q26", "112x80-q40", "1080p-band"])
def test_b2_b3_b4_kernels_match_plain(dev, w, h, qp):
    cur, windows, part, mvfp8, prev_mv, mbh, mbw = _tail_inputs(
        dev, w, h, qp)
    lam = 4
    blocks8, wht8 = PR.qpel_tables(windows)
    want_b = PR.block_table8(windows)
    assert torch.equal(blocks8, want_b)
    assert torch.equal(wht8, PR.wht8_table(want_b))
    mv8, r_idx8 = PR.subpel(cur, windows, part, mvfp8, prev_mv, lam, mbh,
                            mbw)
    want_mv8, want_r = PR.subpel_parts(cur, windows, part, mvfp8, prev_mv,
                                       mbh, mbw, lam)
    assert torch.equal(mv8, want_mv8) and torch.equal(r_idx8, want_r)
    for decimate in (True, False):
        got = PR.probe_maps(cur, windows, r_idx8, qp, mbh, mbw, decimate)
        want = PR.probe_maps_plain(cur, windows, r_idx8, qp, mbh, mbw,
                                   decimate)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    torch.cuda.synchronize()


@pytest.mark.parametrize("w,h,case", [
    (112, 80, "random"), (112, 80, "zero"), (112, 80, "decimate-off"),
    (112, 80, "jvt-dz16"), (1920, 64, "random"), (1920, 64, "jvt-dz16")])
def test_fused_tail_matches_plain(dev, w, h, case):
    """The analyse tail in one launch vs subpel_parts + probe_maps_plain:
    a random or zero predictor, decimate off, jvt with deadzone 16."""
    qp = 26
    cur, windows, part, mvfp8, prev_mv, mbh, mbw = _tail_inputs(
        dev, w, h, qp)
    if case == "zero":
        prev_mv = torch.zeros_like(prev_mv)
    decimate = case != "decimate-off"
    tables = _jvt_tables() if case == "jvt-dz16" else None
    n0 = PR.analyse_tail.launches
    got = PR.analyse_tail(cur, windows, part, mvfp8, prev_mv, 4, qp, mbh,
                          mbw, decimate, tables)
    assert PR.analyse_tail.launches == n0 + 1
    want = PR.subpel_parts(cur, windows, part, mvfp8, prev_mv, mbh, mbw, 4)
    want += PR.probe_maps_plain(cur, windows, want[1], qp, mbh, mbw,
                                decimate, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("decimate", [True, False])
def test_b4_check_entry_on_the_box_edges(dev, decimate):
    """B4's check entry on rows on every corner and edge of the +-3 box
    (the lattice then reaches the [-6, 6]^2 table's rim)."""
    cur, windows, _part, _mv, _pred, mbh, mbw = _tail_inputs(dev, 112, 80,
                                                             26)
    edge = [(oy + 6) * 13 + ox + 6 for oy in range(-3, 4)
            for ox in range(-3, 4) if max(abs(oy), abs(ox)) == 3]
    rows = torch.as_tensor(np.array(edge * 6, np.int32)[:4 * mbh * mbw],
                           device=dev)
    got = PR.probe_maps(cur, windows, rows, 26, mbh, mbw, decimate,
                        _jvt_tables())
    want = PR.probe_maps_plain(cur, windows, rows, 26, mbh, mbw, decimate,
                               _jvt_tables())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pred", ["random", "zero"])
def test_b3_mb_cost_matches_plain(dev, pred):
    cur, windows, part, mvfp8, prev_mv, mbh, mbw = _tail_inputs(
        dev, 1920, 64, 26)
    if pred == "zero":
        prev_mv = torch.zeros_like(prev_mv)
    got = PR.subpel(cur, windows, part, mvfp8, prev_mv, 4, mbh, mbw,
                    mb_cost=True)
    want = PR.subpel_parts(cur, windows, part, mvfp8, prev_mv, mbh, mbw, 4,
                           mb_cost=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("em_rate", [12, 0], ids=["stego", "stego-off"])
def test_tail_launches_a_p_frame(dev, em_rate):
    """A P frame on the main path launches the fused tail once (B3 alone
    and B4's check entry never); with stego off, B3 alone once with its
    mb_cost output and the fused tail never."""
    frames = synthetic_sequence(112, 80, 3, seed=3)
    enc = Encoder(Params(width=112, height=80, qp=26, me_range=16,
                         scenecut_threshold=0,
                         stego=StegoParams(em_rate=em_rate, key=5)),
                  device=dev)
    fns = (PR.analyse_tail, PR.subpel, PR.probe_maps)
    n0 = [f.launches for f in fns]
    c0 = PR.subpel.cost_launches
    for f in frames:
        enc.encode_frame(f)
    enc.flush()
    n = [f.launches - a for f, a in zip(fns, n0)]
    n_p = enc.stats.p_frames
    assert n_p == 2
    if em_rate:
        assert n == [n_p, 0, 0]
    else:
        assert n == [0, n_p, 0] and PR.subpel.cost_launches - c0 == n_p


@pytest.mark.parametrize("tail_kernel", [True, False])
def test_cuda_stream_equals_cpu_stream(dev, tail_kernel):
    W, H = 64, 48
    r = np.random.RandomState(4)
    big = np.repeat(np.repeat(r.randint(30, 226, (30, 40)), 4, 0), 4, 1)
    frames = [Frame(big[i:i + H, 2 * i:2 * i + W].astype(np.uint8),
                    np.full((H // 2, W // 2), 120, np.uint8),
                    np.full((H // 2, W // 2), 130, np.uint8))
              for i in range(4)]

    def run(device):
        p = Params(width=W, height=H, qp=26, me_range=16,
                   deblock_device=True, psnr=False,
                   stego=StegoParams(em_rate=16, key=5))
        p.tail_kernel = tail_kernel
        enc = Encoder(p, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")


@pytest.mark.parametrize("flat", [False, True])
def test_b6_b7_kernels_match_plain(dev, flat):
    mbh, mbw, rng, lam = 5, 7, 16, 4
    fr = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=9)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = TMC.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                        device=dev), c, c)
    if flat:
        cur[:] = 101
        ref["luma"][:] = 100
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    planes = ref["luma"].to(torch.uint8)
    mv, cost = FP.fullpel_search16(cur, planes[0], rng, mbh, mbw, lam)
    want_mv, want_cost = fullpel_search(cur, planes[0], zero, rng, mbh,
                                        mbw, lam)
    assert torch.equal(mv, want_mv) and torch.equal(cost, want_cost)
    edge = torch.as_tensor(np.random.RandomState(1).choice(
        [-rng, rng], (mbh, mbw, 2)).astype(np.int32), device=dev)
    for mv_fp in (mv, edge):
        got = QT.gather_windows(planes, mv_fp, mbh, mbw)
        assert torch.equal(got, QT.gather_windows_plain(planes, mv_fp, mbh,
                                                        mbw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("qp", [20, 26, 38])
def test_b8_kernels_match_plain(dev, qp):
    g = np.random.default_rng(qp)
    L = 13 * 35 * 16
    cur = g.integers(0, 256, (16, L))
    pred = np.clip(cur + g.integers(-40, 41, (16, L)), 0, 255)
    dc = g.integers(-3000, 3000, (1, L))
    cur, pred, dc = (torch.as_tensor(a.astype(np.int32), device=dev)
                     for a in (cur, pred, dc))
    mf, bias, dmf = (torch.as_tensor(t, device=dev) for t in (
        LP.MF16[qp], LP.BIAS16[qp], LP.DMF16[qp % 6]))
    for zero_dc in (False, True):
        lev = TQ.dct_quant(cur, pred, mf, bias, zero_dc)
        assert torch.equal(lev, TQ.dct_quant_plain(cur, pred, mf, bias,
                                                   zero_dc))
    lev = lev * INTER._decimate_keep16(lev, L // 16)
    for use_dc in (False, True):
        rec = TQ.deq_idct(lev, pred, dmf, qp // 6 - 4, dc, use_dc)
        assert torch.equal(rec, TQ.deq_idct_plain(lev, pred, dmf,
                                                  qp // 6 - 4, dc, use_dc))
    torch.cuda.synchronize()


def _luma_p_inputs(dev, mbh, mbw, seed, flat=False):
    """(y plane, pred [n, 16, 16]) on the card: a third of the MBs with a
    sparse residual, a third small noise, a third large noise; flat: a
    constant plane and prediction one level apart."""
    g = np.random.default_rng(seed)
    y = g.integers(0, 256, (16 * mbh, 16 * mbw))
    cur = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(-1, 16,
                                                                    16)
    noise = g.integers(-3, 4, cur.shape)
    sparse = np.where(g.random(cur.shape) < 0.03,
                      g.integers(-25, 26, cur.shape), 0)
    pred = cur + sparse
    pred[1::3] = cur[1::3] + noise[1::3]
    pred[2::3] = cur[2::3] + 8 * noise[2::3]
    if flat:
        y[:] = 101
        pred[:] = 100
    return (torch.as_tensor(y.astype(np.int32), device=dev),
            torch.as_tensor(np.clip(pred, 0, 255).astype(np.int32),
                            device=dev))


def _luma_p_equal(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.parametrize("flat", [False, True])
def test_luma_p_kernel_matches_plain(dev, flat):
    """The fused kernel on 35 MBs (an odd count: the last warp's idle
    half repeats an MB) at every qp, with and without force-zero."""
    y, pred = _luma_p_inputs(dev, 5, 7, 3, flat)
    fz = torch.as_tensor(np.random.default_rng(4).random(35) < 0.3,
                         device=dev)
    for qp in range(52):
        for f in (None, fz):
            got = LP.luma_p_encode(y, pred, qp, fz=f)
            _luma_p_equal(got, LP.luma_p_encode_plain(y, pred, qp, fz=f))
    torch.cuda.synchronize()


@pytest.mark.parametrize("qp", [20, 26])
def test_luma_p_kernel_index_forms(dev, qp):
    """An MB subset (odd length, repeats) with force-zero, and the probe's
    13 x n batch with the levels omitted."""
    y, pred = _luma_p_inputs(dev, 5, 7, qp)
    g = np.random.default_rng(qp)
    idx = torch.as_tensor(g.integers(0, 35, 23).astype(np.int32),
                          device=dev)
    fz = torch.as_tensor(g.random(23) < 0.3, device=dev)
    p_sub = pred[g.integers(0, 35, 23)]
    _luma_p_equal(LP.luma_p_encode(y, p_sub, qp, idx=idx, fz=fz),
                  LP.luma_p_encode_plain(y, p_sub, qp, idx=idx, fz=fz))
    p13 = torch.clamp(pred.repeat(13, 1, 1) + torch.as_tensor(
        g.integers(-6, 7, (13 * 35, 16, 16)).astype(np.int32), device=dev),
        0, 255)
    got = LP.luma_p_encode(y, p13, qp, lev=False)
    assert got[0] is None
    _luma_p_equal(got, LP.luma_p_encode_plain(y, p13, qp, lev=False))
    torch.cuda.synchronize()


_LUMA_P_OUTSIDE = r"""
import torch
from video_steganography_pcamv_torch.ops import lumap as LP
y = torch.full((80, 112), 7, dtype=torch.int32, device="cuda")
pred = torch.zeros((3, 16, 16), dtype=torch.int32, device="cuda")
idx = torch.tensor([0, 35, 1], dtype=torch.int32, device="cuda")
out = LP.luma_p_encode(y, pred, 26, idx=idx)
torch.cuda.synchronize()
print("RETURNED", int(out[1].sum()))
"""


def test_luma_p_mb_outside_the_plane_fails_the_launch(dev):
    """An MB number outside the plane traps the launch: the call fails
    and does not go on with the plain version (in a subprocess, since
    the trap ends the CUDA context)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _LUMA_P_OUTSIDE], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "RETURNED" not in r.stdout, r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


def test_cuda_stream_equals_cpu_stream_16x16(dev):
    frames = synthetic_sequence(112, 80, 4, seed=7)

    def run(device):
        p = Params(width=112, height=80, qp=26, me_range=16,
                   deblock_device=False, partitions=False, psnr=False,
                   stego=StegoParams(em_rate=16, key=5))
        enc = Encoder(p, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")


@pytest.mark.parametrize("w,h", [(112, 80), (128, 80)],
                         ids=["112x80", "120x72-padded"])
@pytest.mark.parametrize("corner", [False, True])
def test_b9_kernel_matches_plain(dev, corner, w, h):
    """B9 on odd MB grids (7x5; 8x5, a 120x72 frame padded to 128x80),
    on real MVs and at the +-20 corner MVs."""
    cur, _w, _p, mvfp8, _pm, mbh, mbw = _tail_inputs(dev, w, h, 3)
    fr = synthetic_sequence(w, h, 1, seed=5)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    planes = TMC.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                           device=dev), c, c)["luma"] \
        .to(torch.uint8)
    if corner:
        mv = np.random.RandomState(2).randint(-20, 21, (2 * mbh, 2 * mbw, 2))
        # outward at each corner: the furthest windows the encoder admits
        for by, bx, v in ((0, 0, (-20, -20)), (0, -1, (20, -20)),
                          (-1, 0, (-20, 20)), (-1, -1, (20, 20))):
            mv[by, bx] = v
        mvfp8 = torch.as_tensor(mv.astype(np.int32), device=dev)
    got = PT.gather_windows8(planes, mvfp8, mbh, mbw)
    assert torch.equal(got, PT.gather_windows8_plain(planes, mvfp8, mbh,
                                                     mbw))
    torch.cuda.synchronize()


@pytest.mark.parametrize("rng", [7, 8, 16, 20])
def test_b10_kernel_matches_plain(dev, rng):
    fr = synthetic_sequence(224, 144, 2, seed=4)     # lowres 112x72
    cur, ref = (ST.lowres(torch.as_tensor(f.y.astype(np.int32), device=dev))
                for f in fr[::-1])
    bh, bw = cur.shape[0] // 8, cur.shape[1] // 8    # tiles 5x7
    assert torch.equal(ST.lowres_costs_kernel(cur, ref, bh, bw, rng),
                       ST.lowres_costs_kernel_plain(cur, ref, bh, bw, rng))


_OUTSIDE = r"""
import torch
from video_steganography_pcamv_torch.encoder import partition as PT
mbh, mbw = 5, 7
planes = torch.full((4, 16 * mbh + 48, 16 * mbw + 48), 7, dtype=torch.uint8,
                    device="cuda")
mv = torch.zeros((2 * mbh, 2 * mbw, 2), dtype=torch.int32, device="cuda")
mv[0, 0] = torch.tensor([-21, 0])       # one column left of the planes
out = PT.gather_windows8(planes, mv, mbh, mbw)
torch.cuda.synchronize()
print("RETURNED", int((out == 0).sum()))
"""


def test_b9_window_outside_the_planes_fails_the_launch(dev):
    """A window outside the planes traps the launch instead of returning
    zeros or neighbouring bytes (in a subprocess, since the trap ends
    the CUDA context)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _OUTSIDE], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "RETURNED" not in r.stdout, r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


def test_b5_kernel_matches_plain_trans8(dev):
    mbh, mbw, qp = 5, 9, 30
    g = np.random.default_rng(8)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(128 + g.integers(-24, 25, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    maps = [g.random((mbh, mbw)) < 0.15, g.random((mbh, mbw)) < 0.2,
            g.random((4 * mbh, 4 * mbw)) < 0.5,
            g.integers(-20, 21, (4 * mbh, 4 * mbw, 2))]
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + maps]
    t8 = torch.as_tensor((g.random((mbh, mbw)) < 0.5).astype(np.int32),
                         device=dev)
    kw = dict(qp_thresh=19, off_a=2, off_b=-4, trans8=t8)
    got = DB.deblock_frame(*t[:3], *t[3:], qp, chroma_qp(qp), mbh, mbw,
                           **kw)
    par = DB.edge_params(*t[3:], qp, chroma_qp(qp), mbh, mbw, **kw)
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_stream_equals_cpu_stream_cropped_120x72(dev):
    """A frame size that is not a multiple of 16 (SPS cropping): B1 and
    B9 run on the padded frame's edge MBs."""
    frames = synthetic_sequence(120, 72, 5, seed=7)

    def run(device):
        p = Params(width=120, height=72, qp=26, me_range=16,
                   deblock_device=True, psnr=False,
                   stego=StegoParams(em_rate=16, key=5))
        enc = Encoder(p, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")


def test_cuda_stream_equals_cpu_stream_config3(dev):
    frames = synthetic_sequence(128, 96, 5, seed=7)

    def run(device):
        p = Params(width=128, height=96, qp=26, me_range=16,
                   deblock_device=True, psnr=False, transform_8x8=True, rd=1,
                   stego=StegoParams(em_rate=16, key=5))
        enc = Encoder(p, device=device)
        bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        assert enc.stats.i8x8_mbs > 0 and enc.stats.trans8_mbs > 0
        return bs

    assert run(dev) == run("cpu")


@pytest.mark.parametrize("kw", [
    dict(cabac=True, deblock_device=True, psnr=False),
    dict(cabac=True, deblock_device=True, psnr=False, tail_kernel=False),
    dict(cabac=True, deblock_device=True, psnr=False, transform_8x8=True,
         rd=1),
    dict(cabac=True, partitions=False, psnr=False),
    dict(ssim=True)],
    ids=["cabac", "cabac_cpu_branch", "cabac_config3", "cabac_16x16",
         "defaults_ssim"])
def test_cuda_stream_equals_cpu_stream_cabac_and_defaults(dev, kw):
    frames = synthetic_sequence(112, 80, 4, seed=7)

    def run(device):
        p = Params(width=112, height=80,
                   stego=StegoParams(em_rate=16, key=5), **kw)
        enc = Encoder(p, device=device)
        bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        return bs, enc.close()

    (bs_g, d_g), (bs_c, d_c) = run(dev), run("cpu")
    assert bs_g == bs_c
    assert d_g.keys() == d_c.keys()
    for k in d_c:
        if k == "ssim_y":
            np.testing.assert_allclose(d_g[k], d_c[k], rtol=1e-5)
        elif k != "fps":
            assert d_g[k] == d_c[k], k


def _corner(mv, ext):
    """Outward +-ext MVs at the four corner blocks of an [h, w, 2] field:
    the furthest windows the encoder admits."""
    for by, bx, v in ((0, 0, (-ext, -ext)), (0, -1, (ext, -ext)),
                      (-1, 0, (-ext, ext)), (-1, -1, (ext, ext))):
        mv[by, bx] = v
    return mv


@pytest.mark.parametrize("mbh,mbw", [(5, 7), (5, 8), (3, 1)],
                         ids=["7x5", "120x72-padded", "1x3"])
def test_b7_kernel_matches_plain(dev, mbh, mbw):
    """B7 on odd MB counts (the last CTA's idle warps), the 8x5 grid of a
    120x72 frame, random MVs over every 16-byte phase and the +-20
    corner MVs."""
    g = np.random.RandomState(mbh * mbw)
    planes = torch.as_tensor(g.randint(0, 256, (4, 16 * mbh + 48,
                                                16 * mbw + 48))
                             .astype(np.uint8), device=dev)
    for mv in (g.randint(-20, 21, (mbh, mbw, 2)),
               _corner(g.randint(-20, 21, (mbh, mbw, 2)), 20)):
        mvt = torch.as_tensor(mv.astype(np.int32), device=dev)
        got = QT.gather_windows(planes, mvt, mbh, mbw)
        assert torch.equal(got, QT.gather_windows_plain(planes, mvt, mbh,
                                                        mbw))
    torch.cuda.synchronize()


def _trap_subprocess(code):
    """Run `code` in a subprocess (a trap ends the CUDA context): it must
    fail with a CUDA error and not print RETURNED."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "RETURNED" not in r.stdout, r.stdout
    assert "CUDA" in r.stderr or "cuda" in r.stderr, r.stderr[-2000:]


_B7_OUTSIDE = r"""
import torch
from video_steganography_pcamv_torch.encoder import qpel_table as QT
mbh, mbw = 5, 7
planes = torch.full((4, 16 * mbh + 48, 16 * mbw + 48), 7, dtype=torch.uint8,
                    device="cuda")
mv = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device="cuda")
mv[0, 0] = torch.tensor([-21, 0])       # one column left of the planes
out = QT.gather_windows(planes, mv, mbh, mbw)
torch.cuda.synchronize()
print("RETURNED", int((out == 0).sum()))
"""


def test_b7_window_outside_the_planes_fails_the_launch(dev):
    _trap_subprocess(_B7_OUTSIDE)


@pytest.mark.parametrize("nref", [2, 3])
def test_b9_kernel_with_ref8_matches_plain(dev, nref):
    """B9 on a stack of references, each 8x8 block reading its own entry
    (the multi-reference analysis), at real-sized random and +-20 corner
    MVs on the 8x5 grid."""
    mbh, mbw = 5, 8
    g = np.random.RandomState(nref)
    planes = torch.as_tensor(g.randint(0, 256, (nref, 4, 16 * mbh + 48,
                                                16 * mbw + 48))
                             .astype(np.uint8), device=dev)
    ref8 = torch.as_tensor(g.randint(0, nref, (2 * mbh, 2 * mbw))
                           .astype(np.int32), device=dev)
    for mv in (g.randint(-20, 21, (2 * mbh, 2 * mbw, 2)),
               _corner(g.randint(-20, 21, (2 * mbh, 2 * mbw, 2)), 20)):
        mvt = torch.as_tensor(mv.astype(np.int32), device=dev)
        got = PT.gather_windows8(planes, mvt, mbh, mbw, ref8=ref8)
        assert torch.equal(got, PT.gather_windows8_plain(planes, mvt, mbh,
                                                         mbw, ref8=ref8))
    torch.cuda.synchronize()


_B9_BAD_REF = r"""
import torch
from video_steganography_pcamv_torch.encoder import partition as PT
mbh, mbw = 5, 7
planes = torch.full((2, 4, 16 * mbh + 48, 16 * mbw + 48), 7,
                    dtype=torch.uint8, device="cuda")
mv = torch.zeros((2 * mbh, 2 * mbw, 2), dtype=torch.int32, device="cuda")
ref8 = torch.zeros((2 * mbh, 2 * mbw), dtype=torch.int32, device="cuda")
ref8[1, 2] = 2                          # one past the stack
out = PT.gather_windows8(planes, mv, mbh, mbw, ref8=ref8)
torch.cuda.synchronize()
print("RETURNED", int((out == 0).sum()))
"""


def test_b9_reference_outside_the_stack_fails_the_launch(dev):
    _trap_subprocess(_B9_BAD_REF)


def test_b5_kernel_with_ref4_matches_plain(dev):
    """B5 with the per-4x4 reference map: inter neighbours that differ
    only in their reference get bS 1 (no residual, one MV field), next
    to the usual random maps."""
    mbh, mbw = 5, 9
    g = np.random.default_rng(11)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(128 + g.integers(-24, 25, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = g.random((mbh, mbw)) < 0.1
    skip = (g.random((mbh, mbw)) < 0.2) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.3
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2))
    nnz4[:, :2 * mbw] = False              # left half: one MV field,
    mv4[:, :2 * mbw] = 3                   # no residual
    ref4 = g.integers(0, 3, (4 * mbh, 4 * mbw))
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4, ref4]]
    y8 = [p.to(torch.uint8) for p in t[:3]]
    got = DB.deblock_frame(*y8, *t[3:7], 26, chroma_qp(26), mbh, mbw,
                           ref4=t[7])
    par = DB.edge_params(*t[3:7], 26, chroma_qp(26), mbh, mbw, ref4=t[7])
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert a.dtype == torch.uint8 and torch.equal(a, b)
    flat = DB.deblock_frame(*y8, *t[3:7], 26, chroma_qp(26), mbh, mbw)
    assert not torch.equal(flat[0], got[0])


@pytest.mark.parametrize("kw", [
    dict(ref_frames=2), dict(ref_frames=2, cabac=True),
    dict(ref_frames=3, keyint_max=3, tail_kernel=False),
    dict(ref_frames=2, partitions=False, deblock_device=False)],
    ids=["ref2", "ref2_cabac", "ref3_keyint3_cpu_branch",
         "ref2_partitions_off"])
def test_cuda_stream_equals_cpu_stream_multiref(dev, kw):
    frames = synthetic_sequence(112, 80, 5, seed=7)

    def run(device):
        base = dict(width=112, height=80, qp=26, me_range=16,
                    deblock_device=True, psnr=False)
        base.update(kw)
        enc = Encoder(Params(stego=StegoParams(em_rate=64, key=5), **base),
                      device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b)


def _check_b_kernels(monkeypatch, names):
    """Each kernel wrapper a B frame calls (bslice's names) runs on the
    card and again on CPU copies of its inputs, which takes its plain
    version: the outputs must be equal. Returns the card calls counted
    by name."""
    from video_steganography_pcamv_torch.encoder import bslice as BS
    calls = {}
    for name in names:
        fn = getattr(BS, name)

        def check(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            if a[0].is_cuda:
                assert _same(out, _fn(*_cpu(a), **_cpu(k))), _name
                calls[_name] = calls.get(_name, 0) + 1
            return out
        monkeypatch.setattr(BS, name, check)
    return calls


def _b_streams(dev, kw, n_frames=6):
    """The 112x80 stream on the card and on the CPU, and the card's B
    frame count."""
    frames = synthetic_sequence(112, 80, n_frames, seed=7)

    def run(device):
        base = dict(width=112, height=80, qp=26, me_range=16, cabac=True,
                    b_adapt=0, psnr=False, deblock_device=True)
        base.update(kw)
        enc = Encoder(Params(stego=StegoParams(em_rate=64, key=5), **base),
                      device=device)
        bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        return bs, enc.stats.b_frames

    (got, n_b), (want, _) = run(dev), run("cpu")
    assert got == want and n_b > 0
    return n_b


@pytest.mark.parametrize("kw", [
    dict(bframes=2, ref_frames=2), dict(bframes=1, ref_frames=1)],
    ids=["config4", "bframes1_ref1"])
def test_cuda_stream_equals_cpu_stream_bframes(dev, kw, monkeypatch):
    """Every kernel call of the B frames equals its plain version; then
    cuda == cpu streams."""
    calls = _check_b_kernels(monkeypatch, ("fullpel_parts", "gather_windows8",
                                           "subpel", "luma_p_encode"))
    n_b = _b_streams(dev, kw)
    r = kw["ref_frames"]
    assert calls == {"fullpel_parts": (r + 1) * n_b,
                     "gather_windows8": 2 * n_b, "subpel": 2 * n_b,
                     "luma_p_encode": n_b}


@pytest.mark.parametrize("kw", [
    dict(bframes=2, cabac=False), dict(bframes=2, cabac=False, ref_frames=2),
    dict(bframes=2, cabac=False, b_adapt=2, rc_lookahead=5),
    dict(bframes=2, cabac=False, partitions=False, deblock_device=False,
         b_adapt=2, rc_lookahead=4),
    dict(bframes=2, partitions=False, deblock_device=False, ref_frames=2)],
    ids=["cavlc_ref1", "cavlc_ref2", "cavlc_badapt2", "b16_cavlc_badapt2",
         "b16_cabac_ref2"])
def test_cuda_stream_equals_cpu_stream_b_options(dev, kw, monkeypatch):
    """CAVLC B slices, b_adapt 2 and the 16x16 path's B frames: every
    kernel call of the B frames (B1, B9, B3' and the luma encode with
    partitions; B6, B7 and the luma encode without, per list and L0
    entry) equals its plain version; then cuda == cpu streams."""
    r = kw.get("ref_frames", 1)
    if kw.get("partitions", True):
        want = dict(fullpel_parts=r + 1, gather_windows8=2, subpel=2,
                    luma_p_encode=1)
    else:
        want = dict(fullpel_search16=r + 1, gather_windows=r + 1,
                    luma_p_encode=1)
    calls = _check_b_kernels(monkeypatch, want)
    n_b = _b_streams(dev, kw, n_frames=7)
    assert calls == {k: n * n_b for k, n in want.items()}


@pytest.mark.parametrize("kw", [
    dict(cabac=True, ref_frames=2, direct=3),
    dict(cabac=False, b_adapt=1, direct=2),
    dict(cabac=True, direct=0),
    dict(partitions=False, deblock_device=False, ref_frames=2, direct=2)],
    ids=["config4_auto", "cavlc_temporal", "direct_none",
         "b16_ref2_temporal"])
def test_cuda_stream_equals_cpu_stream_pyramid(dev, kw, monkeypatch):
    """b_pyramid (bframes 3: one pyramid GOP, its middle B a reference)
    with weightb under every direct mode: every kernel call of the B
    frames, the reference B's included, equals its plain version; then
    cuda == cpu streams."""
    kw = dict(kw, bframes=3, b_pyramid=True, weightb=True)
    r = kw.get("ref_frames", 1)
    if kw.get("partitions", True):
        want = dict(fullpel_parts=r + 1, gather_windows8=2, subpel=2,
                    luma_p_encode=1)
    else:
        want = dict(fullpel_search16=r + 1, gather_windows=r + 1,
                    luma_p_encode=1)
    calls = _check_b_kernels(monkeypatch, want)
    n_b = _b_streams(dev, kw, n_frames=6)
    assert calls == {k: n * n_b for k, n in want.items()}


@pytest.mark.parametrize("qp", [0, 20, 26, 40, 51])
def test_luma_p_levels_entry_matches_plain(dev, qp):
    """The fused luma encode's levels-in entry (the trellis path's) on
    35 MBs, fed the inter trellis's levels (plain torch, on the card),
    with and without force-zero, levels kept and omitted."""
    y, pred = _luma_p_inputs(dev, 5, 7, 3)
    levels = INTER.trellis_luma_levels(y, pred, qp)
    fz = torch.as_tensor(np.random.default_rng(4).random(35) < 0.3,
                         device=dev)
    n0 = LP.luma_p_encode.levels_launches
    for f in (None, fz):
        for lev in (True, False):
            got = LP.luma_p_encode(y, pred, qp, fz=f, lev=lev, levels=levels)
            _luma_p_equal(got, LP.luma_p_encode_plain(
                y, pred, qp, fz=f, lev=lev, levels=levels))
    torch.cuda.synchronize()
    assert LP.luma_p_encode.levels_launches == n0 + 4


def test_trellis_on_the_card_matches_the_cpu(dev):
    """`trellis_quant` (plain torch) on the card gives the CPU's levels:
    the float32 scores decide alike, every cat, intra and inter."""
    from video_steganography_pcamv_torch.ops import trellis as TR
    g = np.random.default_rng(11)
    for cat, n in TR._N.items():
        zz = np.round(g.laplace(0, 40, (300, n))).astype(np.int32)
        qp = g.integers(0, 52, 300).astype(np.int32)
        for intra in (False, True):
            want = TR.trellis_quant(torch.as_tensor(zz), torch.as_tensor(qp),
                                    cat, intra)
            got = TR.trellis_quant(torch.as_tensor(zz, device=dev),
                                   torch.as_tensor(qp, device=dev), cat,
                                   intra)
            assert torch.equal(got.cpu(), want), (cat, intra)


@pytest.mark.parametrize("kw", [
    dict(cabac=True, ref_frames=2, transform_8x8=True, rd=1, trellis=1),
    dict(cabac=True, partitions=False, deblock_device=False,
         transform_8x8=True, trellis=1),
    dict(cabac=True, trellis=1), dict(rd=2)],
    ids=["ref2_trans8_rd_trellis", "p16_trans8_trellis", "trellis", "rd2"])
def test_cuda_stream_equals_cpu_stream_trellis(dev, kw):
    """Trellis, the 8x8 transform and rd 2 on the P paths at 112x80:
    cuda == cpu streams."""
    frames = synthetic_sequence(112, 80, 4, seed=7)

    def run(device):
        base = dict(width=112, height=80, qp=26, me_range=16,
                    deblock_device=True, psnr=False)
        base.update(kw)
        enc = Encoder(Params(stego=StegoParams(em_rate=16, key=5), **base),
                      device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")


@pytest.mark.parametrize("kw", [
    dict(bframes=3, b_pyramid=True, weightb=True, ref_frames=2, trellis=1),
    dict(bframes=2, transform_8x8=True, rd=1),
    dict(bframes=2, transform_8x8=True, rd=1, cabac=False)],
    ids=["pyramid_weightb_trellis", "trans8_rd", "trans8_rd_cavlc"])
def test_cuda_stream_equals_cpu_stream_b_trellis_trans8(dev, kw,
                                                        monkeypatch):
    """B frames with trellis (the B encode's luma through the levels-in
    entry) and with the 8x8 transform and rd: every kernel call of the B
    frames equals its plain version; then cuda == cpu streams."""
    r = kw.get("ref_frames", 1)
    want = dict(fullpel_parts=r + 1, gather_windows8=2, subpel=2,
                luma_p_encode=1)
    calls = _check_b_kernels(monkeypatch, want)
    n_b = _b_streams(dev, kw, n_frames=6)
    assert calls == {k: n * n_b for k, n in want.items()}


def _jvt_tables():
    from video_steganography_pcamv_torch.ops import cqm as CQ
    return CQ.QuantTables(CQ.JVT4I, CQ.JVT4P, CQ.JVT8I, CQ.JVT8P,
                          dz_intra=24, dz_inter=16)


@pytest.mark.parametrize("qp", [0, 20, 26, 40, 51])
def test_luma_p_nr_instance_matches_plain(dev, qp):
    """The fused luma encode's noise-reduction instance on 35 MBs (an
    odd count: the idle half-warp adds nothing to the sums) under the
    jvt tables, with and without force-zero, levels kept and omitted:
    levels, recon, cbp and the per-position sums equal the plain
    version's."""
    y, pred = _luma_p_inputs(dev, 5, 7, 3)
    qt = _jvt_tables()
    off = torch.as_tensor(np.random.default_rng(qp).integers(
        0, 30, (4, 4)).astype(np.int32), device=dev)
    fz = torch.as_tensor(np.random.default_rng(4).random(35) < 0.3,
                         device=dev)
    n0 = LP.luma_p_encode.nr_launches
    for f in (None, fz):
        for lev in (True, False):
            got = LP.luma_p_encode(y, pred, qp, fz=f, lev=lev, tables=qt,
                                   nr_offset=off)
            _luma_p_equal(got, LP.luma_p_encode_plain(
                y, pred, qp, fz=f, lev=lev, tables=qt, nr_offset=off))
    torch.cuda.synchronize()
    assert LP.luma_p_encode.nr_launches == n0 + 4


def test_quant_products_wrap_as_the_plain_versions(dev):
    """Residuals up to +-40000 at qp 0 under jvt: the quant product
    leaves int32 and wraps alike in the fused luma encode (both
    instances) and its plain version."""
    g = np.random.default_rng(13)
    y = torch.as_tensor(g.integers(-20000, 20001, (80, 112))
                        .astype(np.int32), device=dev)
    pred = torch.as_tensor(g.integers(-20000, 20001, (35, 16, 16))
                           .astype(np.int32), device=dev)
    qt = _jvt_tables()
    for kw in ({}, {"nr_offset": torch.full((4, 4), 7, dtype=torch.int32,
                                            device=dev)}):
        _luma_p_equal(LP.luma_p_encode(y, pred, 0, tables=qt, **kw),
                      LP.luma_p_encode_plain(y, pred, 0, tables=qt, **kw))


@pytest.mark.parametrize("qp", [0, 20, 26])
def test_b4_kernel_under_jvt_matches_plain(dev, qp):
    """B4 with the jvt inter list and deadzone 16 vs its plain version
    on the 112x80 inputs of the B2-B4 test."""
    from video_steganography_pcamv_torch.encoder import me as ME
    w, h = 112, 80
    mbh, mbw = h // 16, w // 16
    fr = synthetic_sequence(w, h, 2, seed=3)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = TMC.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                        device=dev), c, c)
    lam = ME.lambda_tab(qp)
    planes = ref["luma"].to(torch.uint8)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    st = FP.fullpel_parts(cur, planes[0], zero, 16, mbh, mbw, lam)
    part, mvfp8 = PT.decide_partition(st, mbh, mbw, lam)
    windows = PT.gather_windows8(planes, mvfp8.contiguous(), mbh, mbw)
    _mv8, r_idx8 = PR.subpel(cur, windows, part, mvfp8.contiguous(), zero,
                             lam, mbh, mbw)
    qt = _jvt_tables()
    got = PR.probe_maps(cur, windows, r_idx8, qp, mbh, mbw, True, qt)
    want = PR.probe_maps_plain(cur, windows, r_idx8, qp, mbh, mbw, True, qt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", [
    dict(cqm="jvt"), dict(cqm="jvt", noise_reduction=400,
                          deadzone_inter=16, deadzone_intra=8),
    dict(cqm8i=tuple(range(8, 72)), transform_8x8=True, rd=1),
    dict(noise_reduction=400, partitions=False, deblock_device=False),
    dict(noise_reduction=400, bframes=2, cabac=True, trellis=1)],
    ids=["jvt", "jvt_nr_deadzones", "cqm8i_trans8", "nr_16x16",
         "nr_b_trellis_cabac"])
def test_cuda_stream_equals_cpu_stream_quant_options(dev, kw):
    """The quantizer's options (cqm, deadzones, noise reduction) at
    112x80: cuda == cpu streams, the NR state too."""
    frames = synthetic_sequence(112, 80, 5, seed=7)

    def run(device):
        base = dict(width=112, height=80, qp=26, me_range=16,
                    deblock_device=True, psnr=False)
        base.update(kw)
        enc = Encoder(Params(stego=StegoParams(em_rate=16, key=5), **base),
                      device=device)
        bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        return bs, enc._nr_sum.copy(), enc._nr_count

    got, want = run(dev), run("cpu")
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]


@pytest.mark.parametrize("seed", [0, 1])
def test_luma_p_per_mb_qp_instances_match_plain(dev, seed):
    """The fused luma encode at a per-MB qp grid (10-51) on 35 MBs (an
    odd count) under the jvt tables: the DCT entry with and without
    force-zero and the levels, its NR instance (sums included) and the
    levels-in entry on the trellis's levels at the same grid."""
    y, pred = _luma_p_inputs(dev, 5, 7, 3 + seed)
    g = np.random.default_rng(seed)
    grid = torch.as_tensor(g.integers(10, 52, 35).astype(np.int32),
                           device=dev)
    qt = _jvt_tables()
    fz = torch.as_tensor(g.random(35) < 0.3, device=dev)
    off = torch.as_tensor(g.integers(0, 30, (4, 4)).astype(np.int32),
                          device=dev)
    levels = INTER.trellis_luma_levels(y, pred, grid, qt)
    n0 = LP.luma_p_encode.grid_launches
    calls = 0
    for f in (None, fz):
        for kw in ({}, {"lev": False}, {"nr_offset": off},
                   {"levels": levels}):
            got = LP.luma_p_encode(y, pred, grid, fz=f, tables=qt, **kw)
            _luma_p_equal(got, LP.luma_p_encode_plain(y, pred, grid, fz=f,
                                                      tables=qt, **kw))
            calls += 1
    torch.cuda.synchronize()
    assert LP.luma_p_encode.grid_launches == n0 + calls


def test_b5_kernel_under_qp_maps_matches_plain(dev):
    """B5 with per-MB qp and chroma qp maps (qps 0-51: some MBs at or
    below qp_thresh), trans8 and slice offsets, vs edge_params + its
    plain version."""
    mbh, mbw = 5, 9
    g = np.random.default_rng(17)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(128 + g.integers(-24, 25, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = (g.random((mbh, mbw)) < 0.15)
    skip = (g.random((mbh, mbw)) < 0.2) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.5
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2))
    q = g.integers(0, 52, (mbh, mbw))
    qc = np.array([chroma_qp(int(x), 2) for x in q.reshape(-1)]).reshape(
        mbh, mbw)
    t8 = g.random((mbh, mbw)) < 0.5
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4, q, qc, t8]]
    kw = dict(qp_thresh=13, off_a=4, off_b=-2, trans8=t[9])
    got = DB.deblock_frame(*(p.to(torch.uint8) for p in t[:3]), *t[3:7],
                           t[7], t[8], mbh, mbw, **kw)
    par = DB.edge_params(*t[3:7], t[7], t[8], mbh, mbw, **kw)
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(aq_mode=1),
    dict(aq_mode=1, cabac=True, bframes=2, b_adapt=0, ref_frames=2)],
    ids=["one_ref_cavlc", "config4"])
def test_cuda_stream_equals_cpu_stream_aq(dev, kw):
    """Adaptive quantization at 112x80: cuda == cpu streams (the per-MB
    qp instances of the luma kernel and B5 with qp maps on the card)."""
    frames = synthetic_sequence(112, 80, 5, seed=7)

    def run(device):
        base = dict(width=112, height=80, qp=26, me_range=16,
                    deblock_device=True, psnr=False)
        base.update(kw)
        enc = Encoder(Params(stego=StegoParams(em_rate=16, key=5), **base),
                      device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    n0, m0 = LP.luma_p_encode.grid_launches, DB.deblock_frame.map_launches
    got = run(dev)
    assert LP.luma_p_encode.grid_launches > n0
    assert DB.deblock_frame.map_launches > m0
    assert got == run("cpu")


@pytest.mark.parametrize("tail_kernel", [True, False])
def test_multistream_cuda_equals_cpu(dev, tail_kernel):
    """MultiEncoder at 128x96, two streams, IDR + 3 P steps: the streams
    on cuda:0 equal the streams on the cpu, and each P step launched B1,
    B9, the fused tail (B3 -> B4) and B5 once and the fused luma encode
    twice a stream."""
    from video_steganography_pcamv_torch.encoder.multistream import (
        MultiEncoder)
    seqs = [synthetic_sequence(128, 96, 4, seed=20 + s) for s in range(2)]

    def run(device):
        p = Params(width=128, height=96, qp=27, me_range=8,
                   stego=StegoParams(em_rate=12, key=5))
        p.tail_kernel = tail_kernel
        me = MultiEncoder(p, 2, devices=[device])
        return [me.encode_step([sq[t] for sq in seqs]) for t in range(4)]

    fns = (FP.fullpel_parts, PT.gather_windows8, PR.analyse_tail, PR.subpel,
           PR.probe_maps, DB.deblock_frame, LP.luma_p_encode)
    n0 = [f.launches for f in fns]
    got = run(dev)
    n = [f.launches - a for f, a in zip(fns, n0)]
    # 3 P steps x 2 streams; B5 also deblocks the 2 IDRs
    assert n == [6, 6, 6, 0, 0, 8, 12]
    assert got == run("cpu")


def test_tiled_step_on_the_card_equals_untiled(dev):
    """The tiled step over 4 tiles on cuda:0 equals the untiled
    p_frame_step_parts on cuda:0 key by key (zero predictor), and 6
    packed halos moved."""
    from video_steganography_pcamv_torch.models import pipeline as TPL
    from video_steganography_pcamv_torch.parallel import tile as TTL
    f0, f1 = synthetic_sequence(96, 192, 2, seed=3)
    planes = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
              for a in (f1.y, f1.u, f1.v, f0.y, f0.u, f0.v)]
    prev = torch.zeros((12, 6, 2), dtype=torch.int32, device=dev)
    kw = dict(qp=28, qpc=28, mbh=12, mbw=6, rng=8, lam=4)
    TTL.halo_log.clear()
    got = TTL.p_frame_step_tiled([dev] * 4, *planes, prev, **kw)
    assert len(TTL.halo_log) == 6
    ref = TMC.build_ref(*planes[3:])
    want = TPL.p_frame_step_parts(*planes[:3], ref["luma"], ref["u"],
                                  ref["v"], prev, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rng", [4, 16, 20])
@pytest.mark.parametrize("case", ["random", "corner", "flat", "max_lam"])
def test_fullpel_sub_kernel_matches_plain(dev, case, rng):
    """B1's sub-unit instance on an odd 5x7 MB grid: random predictors,
    predictors at the corners of the window (every unit's MV cost
    extreme), flat content (every displacement ties) and the largest lam
    its 32-bit keys admit."""
    mbh, mbw = 5, 7
    cur, ref = _search_inputs(dev, mbh, mbw, case == "flat", rng + 3)
    rs = np.random.RandomState(rng)
    if case == "corner":
        pr = rs.choice([-rng, rng], (mbh, mbw, 2))
    else:
        pr = rs.randint(-rng - 4, rng + 5, (mbh, mbw, 2))
    pred = torch.as_tensor(pr.astype(np.int32), device=dev)
    lam = FP.max_lam(rng) if case == "max_lam" else 4
    n0 = FP.fullpel_sub.launches
    got = FP.fullpel_sub(cur, ref, pred, rng, mbh, mbw, lam)
    assert FP.fullpel_sub.launches == n0 + 1
    want = FP.fullpel_search_sub(cur, ref, pred, rng, mbh, mbw, lam)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _sub_frames(n, seed):
    """96x64 frames whose 4x4 blocks move on their own (sub splits win;
    in the right third whole MBs move), the odd ones 10 brighter."""
    W, H = 96, 64
    r = np.random.RandomState(seed)
    big = r.randint(30, 226, (H + 32, W + 32)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    moves = [(0, 1), (1, -1), (-1, 0), (2, 1), (0, -2), (-1, 2)]
    frames = []
    for k in range(n):
        y = np.zeros((H, W), np.int32)
        for j in range(H // 4):
            for i in range(W // 4):
                b = ((j // 4) * W + i // 4 if i >= W // 6
                     else j * (W // 4) + i)
                dy, dx = moves[(b + k) % 6]
                y[4 * j:4 * j + 4, 4 * i:4 * i + 4] = \
                    big[16 + 4 * j + dy:20 + 4 * j + dy,
                        16 + 4 * i + dx:20 + 4 * i + dx]
        y = np.clip(y + 10 * (k % 2), 0, 255).astype(np.uint8)
        frames.append(Frame(y, r.randint(100, 156, (H // 2, W // 2))
                            .astype(np.uint8),
                            r.randint(100, 156, (H // 2, W // 2))
                            .astype(np.uint8)))
    return frames


@pytest.mark.parametrize("kw", [
    dict(), dict(cabac=True, trellis=1), dict(ref_frames=2),
    dict(ref_frames=3, cabac=True),
    dict(transform_8x8=True, aq_mode=1), dict(bframes=2, b_adapt=0)],
    ids=["cavlc", "cabac_trellis", "ref2", "ref3_cabac",
         "trans8_aq", "bframes2"])
def test_cuda_stream_equals_cpu_stream_p4x4(dev, kw):
    """Sub-8x8 partitions at 96x64, me_range 4: cuda == cpu streams, with
    the sub instance, the fused luma encode and B5 on the card."""
    frames = _sub_frames(5, 11)

    def run(device):
        enc = Encoder(Params(width=96, height=64, qp=26, me_range=4,
                             p4x4=True, stego=StegoParams(em_rate=24, key=77),
                             **kw), device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    n0, l0, d0 = (FP.fullpel_sub.launches, LP.luma_p_encode.launches,
                  DB.deblock_frame.launches)
    got = run(dev)
    assert FP.fullpel_sub.launches > n0
    assert LP.luma_p_encode.launches > l0
    assert DB.deblock_frame.launches > d0
    assert got == run("cpu")


@pytest.mark.parametrize("zero_pred", [False, True], ids=["random", "zero"])
def test_b3_mb_cost_output_matches_plain_1080p(dev, zero_pred):
    """B3's per-MB inter cost (the stego-off analysis) at 1080p shapes:
    equal to its plain twin, and the mv8/r_idx8 of the instance without
    it unmoved."""
    cur, windows, part, mvfp8, prev_mv, mbh, mbw = _tail_inputs(
        dev, 1920, 1088, 26)
    if zero_pred:
        prev_mv = torch.zeros_like(prev_mv)
    got = PR.subpel(cur, windows, part, mvfp8, prev_mv, 4, mbh, mbw,
                    mb_cost=True)
    want = PR.subpel_parts(cur, windows, part, mvfp8, prev_mv, mbh, mbw, 4,
                           mb_cost=True)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    plain = PR.subpel(cur, windows, part, mvfp8, prev_mv, 4, mbh, mbw)
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


def test_b5_on_a_plain_p_frame_with_intra_mbs_matches_plain(dev):
    """B5 on a P frame of the plain encoder: intra MBs in patches, the
    inter MBs with trans8 and skips, vs edge_params + its plain
    version."""
    mbh, mbw, qp = 9, 11, 28
    g = np.random.default_rng(5)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(np.repeat(np.repeat(g.integers(60, 190, (s[0] // 8,
                                                               s[1] // 8)),
                                          8, 0), 8, 1)
                      + g.integers(-20, 21, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = np.zeros((mbh, mbw), bool)
    intra[2:6, 3:8] = True
    intra[7:, :2] = True
    skip = (g.random((mbh, mbw)) < 0.25) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.5
    mv4 = np.repeat(np.repeat(g.integers(-20, 21, (2 * mbh, 2 * mbw, 2)), 2,
                              0), 2, 1)
    t8 = (g.random((mbh, mbw)) < 0.5) & ~intra
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4, t8]]
    y8 = [p.to(torch.uint8) for p in t[:3]]
    got = DB.deblock_frame(*y8, *t[3:7], qp, chroma_qp(qp), mbh, mbw,
                           trans8=t[7])
    par = DB.edge_params(*t[3:7], qp, chroma_qp(qp), mbh, mbw, trans8=t[7])
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _b4_launches():
    """B4's launches: the fused tail's and its check entry's."""
    return PR.analyse_tail.launches + PR.probe_maps.launches


def _reveal_frames(n, W=112, H=80, seed=3):
    """Global motion with a new-content patch in every P frame."""
    r = np.random.RandomState(seed)
    big = np.repeat(np.repeat(r.randint(40, 216, (H // 4 + 8, W // 4 + 8)),
                              4, 0), 4, 1).astype(np.uint8)
    out = []
    for i in range(n):
        y = big[i:H + i, 2 * i:W + 2 * i].copy()
        if i:
            y0, x0 = r.randint(0, H - 32), r.randint(0, W - 48)
            y[y0:y0 + 32, x0:x0 + 48] = np.repeat(np.repeat(
                r.randint(0, 256, (8, 12)), 4, 0), 4, 1)
        c = np.full((H // 2, W // 2), 128, np.uint8)
        out.append(Frame(y, c, c.copy()))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(cabac=True), dict(rd=2), dict(ref_frames=2)],
    ids=["cavlc", "cabac", "rd2", "ref2"])
def test_cuda_stream_equals_cpu_stream_plain(dev, kw):
    """The plain encoder (stego off) at 112x80 on reveal content: cuda
    == cpu streams, with B3's mb_cost instance launched and B4 (the fused
    tail, the check entry) never."""
    frames = _reveal_frames(4)

    def run(device):
        enc = Encoder(Params(width=112, height=80, qp=26, me_range=16,
                             deblock_device=True, psnr=False, **kw),
                      device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    c0, b4 = PR.subpel.cost_launches, _b4_launches()
    got = run(dev)
    assert PR.subpel.cost_launches > c0
    assert _b4_launches() == b4
    assert got == run("cpu")


def test_b5_on_a_plain_sub_p_frame_with_intra_mbs_matches_plain(dev):
    """B5 on a sub-8x8 P frame of the plain encoder: per-4x4 MVs that
    move inside the 8x8 blocks of half the MBs, intra MBs in patches,
    trans8 on the inter MBs without a split, vs edge_params + its plain
    version."""
    mbh, mbw, qp = 9, 11, 28
    g = np.random.default_rng(6)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(np.repeat(np.repeat(g.integers(60, 190, (s[0] // 8,
                                                               s[1] // 8)),
                                          8, 0), 8, 1)
                      + g.integers(-20, 21, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = np.zeros((mbh, mbw), bool)
    intra[1:4, 2:6] = True
    intra[6:, 7:] = True
    skip = (g.random((mbh, mbw)) < 0.2) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.5
    split = g.random((mbh, mbw)) < 0.5
    mv4 = np.repeat(np.repeat(g.integers(-20, 21, (2 * mbh, 2 * mbw, 2)), 2,
                              0), 2, 1)
    mv4 = mv4 + np.where(np.repeat(np.repeat(split, 4, 0), 4, 1)[..., None],
                         g.integers(-5, 6, mv4.shape), 0)
    t8 = (g.random((mbh, mbw)) < 0.5) & ~intra & ~split
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4, t8]]
    y8 = [p.to(torch.uint8) for p in t[:3]]
    got = DB.deblock_frame(*y8, *t[3:7], qp, chroma_qp(qp), mbh, mbw,
                           trans8=t[7])
    par = DB.edge_params(*t[3:7], qp, chroma_qp(qp), mbh, mbw, trans8=t[7])
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _plain_sub_frames(n):
    """`_sub_frames` with new smooth content in two corners of every P
    frame, so that the plain encoder's intra compare has work."""
    out = []
    gy, gx = np.mgrid[0:16, 0:32]
    for i, f in enumerate(_sub_frames(n, 11)):
        y = f.y.copy()
        if i:
            y[0:16, 64:96] = (40 * i + 3 * gx + 5 * gy).astype(np.uint8)
            y[48:64, 0:32] = (200 - 20 * i - 4 * gy).astype(np.uint8)
        out.append(Frame(y, f.u, f.v))
    return out


@pytest.mark.parametrize("kw", [
    dict(rd=1), dict(rd=2, trellis=2, cabac=True, transform_8x8=True)],
    ids=["rd1_cavlc", "rd2_trellis2_cabac"])
def test_cuda_stream_equals_cpu_stream_plain_sub(dev, kw):
    """The plain encoder's sub-8x8 path (stego off, the RD re-rank and
    the intra compare) at 96x64: cuda == cpu streams, with the sub
    instance, the fused luma encode and B5 on the card and B4 never."""
    frames = _plain_sub_frames(3)

    def run(device):
        enc = Encoder(Params(width=96, height=64, qp=26, me_range=8,
                             p4x4=True, deblock_device=True, psnr=False,
                             **kw), device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    def luma():
        # under trellis the luma encodes take the levels-in entry
        return LP.luma_p_encode.launches + LP.luma_p_encode.levels_launches

    n0, l0, d0, b4 = (FP.fullpel_sub.launches, luma(),
                      DB.deblock_frame.launches, _b4_launches())
    got = run(dev)
    assert FP.fullpel_sub.launches > n0
    assert luma() >= l0 + 2 * 9
    assert DB.deblock_frame.launches > d0
    assert _b4_launches() == b4
    assert got == run("cpu")


def test_cuda_stream_equals_cpu_stream_intra_in_b(dev):
    """Intra MBs in B slices (stego off, the partition path, CABAC) at
    112x80 on reveal content: cuda == cpu streams, B4 never launched."""
    frames = _reveal_frames(5)

    def run(device):
        enc = Encoder(Params(width=112, height=80, qp=26, me_range=16,
                             deblock_device=True, psnr=False, bframes=2,
                             b_adapt=0, cabac=True), device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    b4 = _b4_launches()
    got = run(dev)
    assert _b4_launches() == b4
    assert got == run("cpu")
