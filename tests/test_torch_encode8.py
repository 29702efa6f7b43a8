"""The port's High-profile encodes against the JAX package, every output
array exact: the partitioned P encode `encode_p_frame_device8` with the
8x8 transform (trans8) by the sa8d rule and by RD cost (rd), with and
without forced-zero MBs, and the I-frame encode `encode_i_frame` with
Intra_8x8 (i8x8), by SATD and by RD cost."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder import inter as JINTER
from video_steganography_pcamv_tpu.encoder import intra as JI
from video_steganography_pcamv_tpu.encoder.me import lambda_tab
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.ops.transform import chroma_qp

from video_steganography_pcamv_torch.encoder import inter as TINTER
from video_steganography_pcamv_torch.encoder import intra as TI
from video_steganography_pcamv_torch.ops import mc as TMC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW = 5, 7


def _smooth(seed, mbh, mbw, shift=0):
    """Gradient + sine luma (favours the 8x8 transform and Intra_8x8)
    with a few textured MBs, and chroma ramps."""
    r = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    yy, xx = np.mgrid[0:h, 0:w]
    xx = xx + shift
    y = (40 + 0.8 * xx + 0.5 * yy
         + 14 * np.sin(xx / 9.0) * np.cos(yy / 13.0) + r.randn(h, w) * 2)
    tex = np.repeat(np.repeat(r.rand(mbh, mbw) < 0.25, 16, 0), 16, 1)
    y = np.where(tex, y + r.randint(-40, 41, (h, w)), y)
    gy, gx = np.mgrid[0:h // 2, 0:w // 2]
    u = 100 + gx // 2 + r.randint(-2, 3, gx.shape)
    v = 150 - gy // 2 + r.randint(-2, 3, gy.shape)
    return [np.ascontiguousarray(np.clip(a, 0, 255), np.int32)
            for a in (y, u, v)]


def _cmp(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(want[k]),
                                      got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("rd", [False, True])
@pytest.mark.parametrize("qp", [22, 30])
def test_encode_p_frame_device8_trans8(qp, rd):
    cur = _smooth(1, MBH, MBW, shift=3)
    ref = _smooth(1, MBH, MBW)
    g = np.random.RandomState(qp + rd)
    mv8 = g.randint(-20, 21, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    mv8[: MBH] = np.array([12, 0], np.int32)      # the true pan: 3 pels
    fz = g.rand(MBH, MBW) < 0.2
    qpc = chroma_qp(qp)
    jref = JMC.build_ref(*(jnp.asarray(a) for a in ref))
    tref = TMC.build_ref(*(torch.as_tensor(a) for a in ref))
    for force in (None, fz):
        want = JINTER.encode_p_frame_device8(
            *(jnp.asarray(a) for a in cur), jref["luma"], jref["u"],
            jref["v"], jnp.asarray(mv8), qp, qpc, MBH, MBW,
            force_zero=None if force is None else jnp.asarray(force),
            trans8=True, rd=rd)
        got = TINTER.encode_p_frame_device8(
            *(torch.as_tensor(a) for a in cur), tref["luma"], tref["u"],
            tref["v"], torch.as_tensor(mv8), qp, qpc, MBH, MBW,
            force_zero=None if force is None else torch.as_tensor(force),
            trans8=True, rd=rd)
        assert set(got) == set(want)
        _cmp(got, want, got.keys())
        t8 = got["trans8"].numpy()
        assert t8.any() and not t8.all()
        only = TINTER.encode_p_frame_device8(
            *(torch.as_tensor(a) for a in cur), tref["luma"], tref["u"],
            tref["v"], torch.as_tensor(mv8), qp, qpc, MBH, MBW,
            force_zero=None if force is None else torch.as_tensor(force),
            trans8=True, rd=rd, cbp_only=True)
        _cmp(only, want, ("cbp_luma", "cbp_chroma"))


@pytest.mark.parametrize("rd", [False, True])
@pytest.mark.parametrize("qp", [26, 36])
def test_encode_i_frame_i8x8(qp, rd):
    mbh, mbw = MBH, MBW
    y, u, v = _smooth(qp, mbh, mbw)
    qpc = chroma_qp(qp)
    lam = lambda_tab(qp)
    want = JI.encode_i_frame(*(jnp.asarray(a) for a in (y, u, v)), qp, qpc,
                             mbw, mbh, lam=lam, i4x4=True, i8x8=True, rd=rd)
    got = TI.encode_i_frame(*(torch.as_tensor(a) for a in (y, u, v)), qp,
                            qpc, mbw, mbh, lam=lam, i8x8=True, rd=rd)
    assert set(got) == set(want)
    _cmp(got, want, got.keys())
    assert bool(got["mb_i8"].any())


def test_encode_i_frame_rd_without_i8x8():
    y, u, v = _smooth(4, MBH, MBW)
    qp = 26
    want = JI.encode_i_frame(*(jnp.asarray(a) for a in (y, u, v)), qp,
                             chroma_qp(qp), MBW, MBH, lam=lambda_tab(qp),
                             i4x4=True, rd=True)
    got = TI.encode_i_frame(*(torch.as_tensor(a) for a in (y, u, v)), qp,
                            chroma_qp(qp), MBW, MBH, lam=lambda_tab(qp),
                            rd=True)
    _cmp(got, want, got.keys())
