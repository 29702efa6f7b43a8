"""The port's 16x16-only P analysis and encode vs the JAX reference on
the CPU, every comparison exact:

- B6's plain version (`encoder/me.py:fullpel_search`, zero predictor,
  and the `ops.fullpel.fullpel_search16` wrapper) against
  `fullpel_search_pallas` in interpret mode and the JAX
  `fullpel_search`, textured and flat (tied) content;
- B7's plain version against the reference's `gather_windows` in
  interpret mode at the extreme MVs;
- B8a/B8b plain versions against `dct_quant_pallas` /
  `deq_idct_pallas` in interpret mode, zero_dc / use_dc on and off, at
  qp 20, 26 and 38;
- `luma_p_encode_fast` against the JAX `luma_p_encode`, decimation on
  and off;
- `analyse_p_frame`, `subpel_from_table` and `stego_costs_from_table`
  against the JAX analyse2 on a real 112x80 frame pair (rho bit-equal
  in float32);
- `encode_p_frame_device` against the JAX one, with and without
  force_zero.
Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import analyse2 as JA2
from video_steganography_pcamv_tpu.encoder import inter as JINTER
from video_steganography_pcamv_tpu.encoder import qpel_table as JQT
from video_steganography_pcamv_tpu.encoder.me import (
    fullpel_search as j_fullpel_search)
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.ops.pallas_kernels import (
    deq_idct_pallas, dct_quant_pallas, fullpel_search_pallas)
from video_steganography_pcamv_tpu.stego.cost import cost_mv_table

from video_steganography_pcamv_torch.encoder import analyse2 as TA2
from video_steganography_pcamv_torch.encoder import inter as TINTER
from video_steganography_pcamv_torch.encoder import qpel_table as TQT
from video_steganography_pcamv_torch.encoder.me import (
    fullpel_search as t_fullpel_search, lambda_tab)
from video_steganography_pcamv_torch.ops import fullpel as TFP
from video_steganography_pcamv_torch.ops import tq4 as TQ
from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mbh,mbw,rng,flat", [
    (3, 8, 4, False), (5, 7, 16, False), (3, 4, 6, True)],
    ids=["3x8_rng4", "5x7_rng16", "flat_ties"])
def test_b6_plain_matches_pallas_and_jax(mbh, mbw, rng, flat):
    r = np.random.RandomState(5)
    h, w = 16 * mbh, 16 * mbw
    ref = r.randint(0, 256, (h, w)).astype(np.int32)
    cur = np.clip(np.roll(ref, (2, -3), (0, 1))
                  + r.randint(-2, 3, (h, w)), 0, 255).astype(np.int32)
    if flat:
        ref[:] = 90
        cur[:] = 91
    lam = 4
    ref_p = JMC.pad_plane(jnp.asarray(ref))
    mv_p, cost_p = fullpel_search_pallas(jnp.asarray(cur), ref_p, rng, mbh,
                                         mbw, lam, interpret=True)
    zero = np.zeros((mbh, mbw, 2), np.int32)
    mv_j, cost_j = j_fullpel_search(jnp.asarray(cur), ref_p,
                                    jnp.asarray(zero), rng, mbh, mbw, lam)
    mv_t, cost_t = t_fullpel_search(_t(cur), _t(ref_p), _t(zero), rng, mbh,
                                    mbw, lam)
    mv_w, cost_w = TFP.fullpel_search16(_t(cur), _t(ref_p).to(torch.uint8),
                                        rng, mbh, mbw, lam)
    for mv, cost in ((mv_j, cost_j), (mv_t, cost_t), (mv_w, cost_w)):
        _eq(mv, mv_p)
        _eq(cost, cost_p)
    if flat:      # every displacement ties: the first in scan order wins
        _eq(mv_t, np.full((mbh, mbw, 2), 0))


def test_b7_plain_matches_pallas_at_extreme_mvs():
    mbh, mbw, rng = 5, 7, 16
    r = np.random.RandomState(3)
    hp, wp = 16 * mbh + 2 * JMC.PAD, 16 * mbw + 2 * JMC.PAD
    planes = r.randint(0, 256, (4, hp, wp)).astype(np.uint8)
    mv = r.choice([-rng, rng], (mbh, mbw, 2)).astype(np.int32)
    mv[0, 0] = (-rng, -rng)
    mv[-1, -1] = (rng, rng)
    want = JQT.gather_windows(jnp.asarray(planes), jnp.asarray(mv), mbh, mbw,
                              interpret=True)
    got = TQT.gather_windows(_t(planes), _t(mv), mbh, mbw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (35, 4, 24, 24)
    _eq(got, want)
    _eq(TQT.gather_windows_plain(_t(planes), _t(mv), mbh, mbw), want)


@pytest.mark.parametrize("qp", [20, 26, 38])
def test_b8_plain_matches_pallas(qp):
    r = np.random.RandomState(qp)
    L = 40 * 16
    cur = r.randint(0, 256, (16, L)).astype(np.int32)
    pred = np.clip(cur + r.randint(-40, 41, (16, L)), 0, 255) \
        .astype(np.int32)
    mf = JT.QUANT4_MF[qp].reshape(16).astype(np.int32)
    bias = JT.QUANT4_BIAS_INTER[qp].reshape(16).astype(np.int32)
    dmf = JT.DEQUANT4_MF[qp % 6].reshape(16).astype(np.int32)
    dc = r.randint(-2000, 2000, (1, L)).astype(np.int32)
    for zero_dc in (False, True):
        want = dct_quant_pallas(jnp.asarray(cur), jnp.asarray(pred),
                                jnp.asarray(mf), jnp.asarray(bias),
                                zero_dc=zero_dc, interpret=True)
        lev = TQ.dct_quant(_t(cur), _t(pred), _t(mf), _t(bias), zero_dc)
        _eq(lev, want)
        _eq(TQ.dct_quant_plain(_t(cur), _t(pred), _t(mf), _t(bias),
                               zero_dc), want)
    assert int((lev != 0).sum()) > L // 4
    for use_dc in (False, True):
        want = deq_idct_pallas(jnp.asarray(lev.numpy()), jnp.asarray(pred),
                               jnp.asarray(dmf), qp // 6 - 4,
                               jnp.asarray(dc) if use_dc else None,
                               use_dc=use_dc, interpret=True)
        _eq(TQ.deq_idct(lev, _t(pred), _t(dmf), qp // 6 - 4, _t(dc),
                        use_dc), want)


@pytest.mark.parametrize("decimate", [True, False])
def test_luma_p_encode_fast_matches_jax(decimate):
    r = np.random.RandomState(7)
    n = 40
    cur = r.randint(0, 256, (n, 16, 16)).astype(np.int32)
    pred = np.clip(cur + r.randint(-12, 13, (n, 16, 16)), 0, 255) \
        .astype(np.int32)
    pred[::3] = np.clip(cur[::3] + r.randint(-2, 3, (14, 16, 16)), 0, 255)
    for qp in (20, 26, 38):
        lev_j, rec_j = JINTER.luma_p_encode(jnp.asarray(cur),
                                            jnp.asarray(pred), qp, decimate)
        lev_t, rec_t = TINTER.luma_p_encode_fast(_t(cur), _t(pred), qp,
                                                 decimate)
        _eq(lev_t, lev_j)
        _eq(rec_t, rec_j)


@pytest.fixture(scope="module")
def pair():
    """A real 112x80 frame pair, the reference planes built by the JAX
    build_ref, and the JAX analysis of the second frame."""
    mbh, mbw, rng, qp = 5, 7, 16, 26
    fr = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=3)
    y = fr[1].y.astype(np.int32)
    ref = JMC.build_ref(jnp.asarray(fr[0].y.astype(np.int32)),
                        jnp.asarray(fr[0].u.astype(np.int32)),
                        jnp.asarray(fr[0].v.astype(np.int32)))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    prev_mv = np.random.RandomState(4).randint(
        -20, 21, (mbh, mbw, 2)).astype(np.int32)
    lam = lambda_tab(qp)
    jout = JA2.analyse_p_frame(jnp.asarray(y), jnp.asarray(ref["luma"]),
                               jnp.asarray(prev_mv), rng, mbh, mbw, lam, 2,
                               False)
    return dict(mbh=mbh, mbw=mbw, rng=rng, qp=qp, lam=lam, y=y, ref=ref,
                u=fr[1].u.astype(np.int32), v=fr[1].v.astype(np.int32),
                prev_mv=prev_mv, jout=[np.asarray(a) for a in jout])


def test_analyse_p_frame_matches_jax(pair):
    p = pair
    tout = TA2.analyse_p_frame(_t(p["y"]), _t(p["ref"]["luma"]),
                               _t(p["prev_mv"]), p["rng"], p["mbh"],
                               p["mbw"], p["lam"])
    for got, want in zip(tout, p["jout"]):
        _eq(got, want)
    # subpel alone, at full-pel MVs other than B6's
    mv_fp = np.random.RandomState(6).randint(
        -12, 13, (p["mbh"], p["mbw"], 2)).astype(np.int32)
    got = TA2.subpel_from_table(_t(p["y"]), tout[3], _t(mv_fp),
                                _t(p["prev_mv"]), p["mbh"], p["mbw"],
                                p["lam"])
    want = JA2.subpel_from_table(
        jnp.asarray(p["y"]), jnp.asarray(p["jout"][3]), jnp.asarray(mv_fp),
        jnp.asarray(p["prev_mv"]), p["mbh"], p["mbw"], p["lam"], 2)
    for g, w in zip(got, want):
        _eq(g, w)


def test_stego_costs_from_table_matches_jax(pair):
    p = pair
    mbh, mbw, qp = p["mbh"], p["mbw"], p["qp"]
    mv, r_idx, blocks, wht = p["jout"]
    mvp = np.clip(mv + np.random.RandomState(8).randint(
        -6, 7, mv.shape), -400, 400).astype(np.int32)
    cmv = cost_mv_table(p["lam"])
    rho_j, alt_j, fl_j = JA2.stego_costs_from_table(
        jnp.asarray(p["y"]), jnp.asarray(blocks), jnp.asarray(wht),
        jnp.asarray(r_idx), jnp.asarray(mv), jnp.asarray(mvp),
        jnp.asarray(cmv), qp, mbh, mbw, decimate=True)
    rho_t, alt_t, fl_t = TA2.stego_costs_from_table(
        _t(p["y"]), _t(blocks).to(torch.int16), _t(wht).to(torch.int16),
        _t(r_idx), _t(mv), _t(mvp), _t(cmv), qp, mbh, mbw)
    assert rho_t.dtype == torch.float32
    _eq(rho_t.numpy().view(np.int32), np.asarray(rho_j).view(np.int32))
    _eq(alt_t, alt_j)
    _eq(fl_t, fl_j)
    assert np.asarray(fl_j)[..., 0].any() and not np.asarray(
        fl_j)[..., 0].all()


@pytest.mark.parametrize("force", [False, True], ids=["free", "force_zero"])
def test_encode_p_frame_device_matches_jax(pair, force):
    p = pair
    mbh, mbw, qp = p["mbh"], p["mbw"], p["qp"]
    qpc = int(JT.chroma_qp(qp))
    mv = p["jout"][0]
    fz = np.random.RandomState(2).rand(mbh, mbw) < 0.4 if force else None
    want = JINTER.encode_p_frame_device(
        jnp.asarray(p["y"]), jnp.asarray(p["u"]), jnp.asarray(p["v"]),
        *(jnp.asarray(p["ref"][k]) for k in ("luma", "u", "v")),
        jnp.asarray(mv), qp, qpc, mbh, mbw, decimate=True,
        force_zero=None if fz is None else jnp.asarray(fz))
    got = TINTER.encode_p_frame_device(
        _t(p["y"]), _t(p["u"]), _t(p["v"]),
        *(_t(p["ref"][k]) for k in ("luma", "u", "v")), _t(mv), qp, qpc,
        mbh, mbw, force_zero=None if fz is None else _t(fz))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        _eq(got[k], want[k])
