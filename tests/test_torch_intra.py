"""I-frame encode (knight wavefront, i16x16 + i4x4 + chroma) vs the JAX
reference `encode_i_frame`, every output array exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import intra as JI
from video_steganography_pcamv_tpu.encoder.me import lambda_tab
from video_steganography_pcamv_tpu.ops.transform import chroma_qp

from video_steganography_pcamv_torch.encoder import intra as TI


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(seed, mbh, mbw):
    r = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    big = r.randint(30, 226, (h // 4 + 2, w // 4 + 2))
    y = np.repeat(np.repeat(big, 4, 0), 4, 1)[2:2 + h, 1:1 + w]
    y = np.clip(y + r.randint(-6, 7, (h, w)), 0, 255)
    # flat MBs (i16x16 wins) beside textured ones (i4x4 wins)
    flat = np.repeat(np.repeat(r.rand(mbh, mbw) < 0.4, 16, 0), 16, 1)
    y = np.where(flat, 90 + np.mgrid[0:h, 0:w][1] // 8, y)
    gy, gx = np.mgrid[0:h // 2, 0:w // 2]
    u = np.clip(100 + gx + r.randint(-3, 4, gx.shape), 0, 255)
    v = np.clip(150 - gy + r.randint(-3, 4, gy.shape), 0, 255)
    return [np.ascontiguousarray(a, np.int32) for a in (y, u, v)]


@pytest.mark.parametrize("qp,mbh,mbw", [(26, 5, 7), (40, 3, 6), (18, 4, 3)])
def test_encode_i_frame_matches_reference(qp, mbh, mbw):
    y, u, v = _planes(qp, mbh, mbw)
    qpc = chroma_qp(qp)
    lam = lambda_tab(qp)
    want = JI.encode_i_frame(*(jnp.asarray(a) for a in (y, u, v)), qp, qpc,
                             mbw, mbh, lam=lam, i4x4=True)
    got = TI.encode_i_frame(*(torch.as_tensor(a) for a in (y, u, v)), qp,
                            qpc, mbw, mbh, lam=lam)
    for k, t in got.items():
        np.testing.assert_array_equal(np.asarray(want[k]), t.numpy(),
                                      err_msg=k)
    assert bool(got["mb_i4"].any()) and not bool(got["mb_i4"].all())


def test_wave_tables_match():
    for mbw, mbh in ((7, 5), (120, 68)):
        for a, b in zip(JI.wave_tables(mbw, mbh), TI.wave_tables(mbw, mbh)):
            np.testing.assert_array_equal(a, b)
