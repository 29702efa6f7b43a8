"""The port's High-profile 8x8 ops against the JAX package on the same
inputs, all exact: the 8x8 transform family (`ops/transform8`) at qp 20,
26 and 38, `sa8d_16x16`, the CAVLC bit counter `cavlc_block_bits` with
`ue_len`, and the Intra_8x8 edge filter and predictions
(`ops/predict8`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.ops import pixel as JPX
from video_steganography_pcamv_tpu.ops import predict8 as JP8
from video_steganography_pcamv_tpu.ops import rdcost as JRD
from video_steganography_pcamv_tpu.ops import transform8 as JT8

from video_steganography_pcamv_torch.ops import pixel as TPX
from video_steganography_pcamv_torch.ops import predict8 as TP8
from video_steganography_pcamv_torch.ops import rdcost as TRD
from video_steganography_pcamv_torch.ops import transform8 as TT8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tables_match():
    # the reference's tables are int64 in numpy and int32 on its device
    for a, b in ((TT8.QUANT8_MF, JT8.QUANT8_MF),
                 (TT8.QUANT8_BIAS, JT8.QUANT8_BIAS),
                 (TT8.DEQUANT8_MF, JT8.DEQUANT8_MF),
                 (TT8.ZIGZAG_8x8, JT8.ZIGZAG_8x8),
                 (TT8.DECIMATE_TABLE8, JT8.DECIMATE_TABLE8),
                 (TP8.I8_TABLES, JP8._I8_TABLES)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qp", [20, 26, 38])
@pytest.mark.parametrize("intra", [False, True])
def test_transform8_chain(qp, intra):
    g = np.random.default_rng(qp + 100 * intra)
    res = g.integers(-255, 256, (6, 2, 2, 8, 8)).astype(np.int32)
    res[0] = g.integers(-6, 7, (2, 2, 8, 8))        # small: sparse levels
    pred = g.integers(0, 256, res.shape).astype(np.int32)
    coef_j = JT8.dct8x8(jnp.asarray(res))
    coef_t = TT8.dct8x8(_t(res))
    _eq(coef_t, coef_j)
    lev_j = JT8.quant8x8(coef_j, qp, intra)
    lev_t = TT8.quant8x8(coef_t, qp, intra)
    _eq(lev_t, lev_j)
    assert (np.asarray(lev_j) == 0).any() and (np.asarray(lev_j) != 0).any()
    _eq(TT8.decimate_score64(lev_t), JT8.decimate_score64(lev_j))
    deq_j = JT8.dequant8x8(lev_j, qp, intra=intra)
    deq_t = TT8.dequant8x8(lev_t, qp, intra=intra)
    _eq(deq_t, deq_j)
    _eq(TT8.idct8x8_add(_t(pred), deq_t),
        JT8.idct8x8_add(jnp.asarray(pred), deq_j))


def test_decimate_score64_runs():
    g = np.random.default_rng(3)
    lev = np.zeros((64, 8, 8), np.int32)
    for k in range(64):
        pos = g.choice(64, size=g.integers(0, 6), replace=False)
        lev[k].reshape(64)[pos] = g.choice([-1, 1, 2], size=len(pos),
                                           p=[0.45, 0.45, 0.1])
    _eq(TT8.decimate_score64(_t(lev)), JT8.decimate_score64(jnp.asarray(lev)))


def test_sa8d_16x16():
    g = np.random.default_rng(5)
    a = g.integers(0, 256, (20, 16, 16)).astype(np.int32)
    b = g.integers(0, 256, (20, 16, 16)).astype(np.int32)
    b[:5] = a[:5] + g.integers(-3, 4, (5, 16, 16))
    _eq(TPX.sa8d_16x16(_t(a), _t(b)),
        JPX.sa8d_16x16(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("max_coeff", [16, 15, 4])
def test_cavlc_block_bits(max_coeff):
    g = np.random.default_rng(max_coeff)
    n = 600
    lev = np.zeros((n, max_coeff), np.int32)
    for k in range(n):
        cnt = g.integers(0, max_coeff + 1)
        pos = g.choice(max_coeff, size=cnt, replace=False)
        mag = np.where(g.random(cnt) < 0.6, 1, g.integers(1, 40, cnt))
        if k % 50 == 0:
            mag = g.integers(100, 3000, cnt)          # long level codes
        lev[k, pos] = mag * g.choice([-1, 1], cnt)
    if max_coeff == 4:
        nc = np.full(n, -1, np.int32)
    else:
        nc = g.integers(0, 17, n).astype(np.int32)
    want = JRD.cavlc_block_bits(jnp.asarray(lev), jnp.asarray(nc),
                                max_coeff=max_coeff)
    _eq(TRD.cavlc_block_bits(_t(lev), _t(nc), max_coeff=max_coeff), want)


def test_ue_se_len():
    v = np.concatenate([np.arange(0, 300), [1023, 1024, 65535, 65536,
                                            (1 << 22) + 5]]).astype(np.int32)
    _eq(TRD.ue_len(_t(v)), JRD.ue_len(jnp.asarray(v)))
    s = np.arange(-200, 201).astype(np.int32)
    _eq(TRD.se_len(_t(s)), JRD.se_len(jnp.asarray(s)))


def test_predict8_filter_and_modes():
    g = np.random.default_rng(9)
    n = 64
    lt = g.integers(0, 256, n).astype(np.int32)
    top = g.integers(0, 256, (n, 16)).astype(np.int32)
    left = g.integers(0, 256, (n, 8)).astype(np.int32)
    have_lt = g.random(n) < 0.5
    have_tr = g.random(n) < 0.5
    at = g.random(n) < 0.7
    al = g.random(n) < 0.7
    e_j = JP8.filter_edges(jnp.asarray(lt), jnp.asarray(top),
                           jnp.asarray(left), jnp.asarray(have_lt),
                           jnp.asarray(have_tr))
    e_t = TP8.filter_edges(_t(lt), _t(top), _t(left), _t(have_lt),
                           _t(have_tr))
    _eq(e_t, e_j)
    _eq(TP8.predict_i8x8_all(e_t, _t(at), _t(al)),
        JP8.predict_i8x8_all(e_j, jnp.asarray(at), jnp.asarray(al)))
