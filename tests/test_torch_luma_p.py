"""The fused inter luma encode `ops/lumap.luma_p_encode` (kernel B8 in
one launch) against the JAX `luma_p_encode(..., decimate=True)` on the
CPU, every output exact:

- random MBs at qp 0, 12, 20, 26, 40 and 51 (both dequant branches);
- sparse residuals that land an 8x8 decimate score at exactly 3 and 4
  and an MB sum of kept 8x8 scores at exactly 5 and 6;
- an all-zero residual, and a random force-zero mask against the
  reference's `lev * ~fz` / `where(fz, pred, rec)`;
- the index forms: an MB subset, and 13 x n MBs reading MB i % n;
- the wrapper's input contract, which holds on the CPU too.
Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder import inter as JINTER
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.ops.blocks import to_blocks

from video_steganography_pcamv_torch.ops import lumap as LP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW = 6, 8                     # 48 MBs


def _tiles(y):
    h, w = y.shape
    return y.reshape(h // 16, 16, w // 16, 16).transpose(0, 2, 1, 3) \
        .reshape(-1, 16, 16)


def _sparse_pred(r, cur, p_blk=0.12, lo=6, hi=25):
    """pred = cur minus a few +-lo..hi deltas in a share p_blk of the
    4x4 blocks: small decimate scores, some kept and some dropped."""
    d = np.zeros(cur.shape, np.int32)
    mask = r.rand(cur.shape[0], 4, 4) < p_blk
    for i, by, bx in zip(*np.nonzero(mask)):
        k = r.randint(1, 4)
        ys, xs = r.randint(0, 4, k), r.randint(0, 4, k)
        d[i, 4 * by + ys, 4 * bx + xs] += r.choice([-1, 1], k) \
            * r.randint(lo, hi, k)
    return np.clip(cur - d, 0, 255).astype(np.int32)


def _frame(seed):
    """A 96x128 plane and predictions for its 48 MBs: a third sparse
    residuals, a third small noise, a third large noise."""
    r = np.random.RandomState(seed)
    y = r.randint(0, 256, (16 * MBH, 16 * MBW)).astype(np.int32)
    cur = _tiles(y)
    pred = _sparse_pred(r, cur)
    noise = r.randint(-3, 4, cur.shape)
    pred[1::3] = np.clip(cur[1::3] + noise[1::3], 0, 255)
    pred[2::3] = np.clip(cur[2::3] + 8 * noise[2::3], 0, 255)
    return y, pred


def _jax(cur, pred, qp, fz=None):
    """The reference's encode, its force-zero and cbp as numpy."""
    lev, rec = JINTER.luma_p_encode(jnp.asarray(cur), jnp.asarray(pred), qp,
                                    decimate=True)
    lev, rec = np.asarray(lev), np.asarray(rec)
    if fz is not None:
        lev = lev * ~fz[:, None, None, None, None]
        rec = np.where(fz[:, None, None], pred, rec)
    nz8 = (lev != 0).any((1, 2)).reshape(-1, 2, 2, 2, 2).any((2, 4))
    cbp = (nz8[:, 0, 0] + 2 * nz8[:, 0, 1] + 4 * nz8[:, 1, 0]
           + 8 * nz8[:, 1, 1]).astype(np.int32)
    return lev, rec, cbp


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("qp", [0, 12, 20, 26, 40, 51])
def test_plain_matches_jax(qp):
    y, pred = _frame(qp + 1)
    want = _jax(_tiles(y), pred, qp)
    got = LP.luma_p_encode_plain(_t(y), _t(pred), qp)
    _eq(got, want)
    if 12 <= qp <= 26:                # not all kept, not all dropped
        assert 0 < (want[2] != 0).sum() < len(pred)


def test_decimation_thresholds():
    """Seed 3's sparse residuals put an 8x8 score at exactly 3 (dropped)
    and 4 (kept) and an MB sum at exactly 5 (dropped) and 6 (kept); the
    scores are the reference's."""
    r = np.random.RandomState(3)
    cur = r.randint(40, 216, (48, 16, 16)).astype(np.int32)
    pred = _sparse_pred(r, cur)
    qp = 26
    lev0 = JT.quant4x4(JT.dct4x4(to_blocks(jnp.asarray(cur - pred), 4)), qp,
                       intra=False)
    sc = np.asarray(JINTER.decimate_score(JINTER._zigzag_gather(lev0)))
    sc8 = sc.reshape(-1, 2, 2, 2, 2).sum((2, 4))
    tot = np.where(sc8 >= 4, sc8, 0).sum((1, 2))
    for v in (3, 4):
        assert (sc8 == v).any(), v
    for v in (5, 6):
        assert (tot == v).any(), v
    y = np.ascontiguousarray(
        cur.reshape(MBH, MBW, 16, 16).transpose(0, 2, 1, 3)
        .reshape(16 * MBH, 16 * MBW))
    want = _jax(cur, pred, qp)
    _eq(LP.luma_p_encode_plain(_t(y), _t(pred), qp), want)
    # an MB with one 8x8 at 5 and the rest below 4 keeps no level
    assert not want[0][tot == 5].any()
    assert want[0][tot == 6].any()


@pytest.mark.parametrize("qp", [20, 26])
def test_zero_residual_and_force_zero(qp):
    y, pred = _frame(9)
    cur = _tiles(y)
    lev, rec, cbp = LP.luma_p_encode_plain(_t(y), _t(cur), qp)
    assert not lev.any() and not cbp.any()
    _eq((lev, rec, cbp), _jax(cur, cur, qp))
    fz = np.random.RandomState(qp).rand(len(pred)) < 0.4
    want = _jax(cur, pred, qp, fz)
    assert want[2][~fz].any()
    _eq(LP.luma_p_encode(_t(y), _t(pred), qp, fz=_t(fz)), want)


def test_index_forms():
    """An MB subset (in any order, repeats allowed) and the probe's
    13 x n batch, against the reference on the gathered / tiled MBs."""
    y, pred = _frame(5)
    cur = _tiles(y)
    n, qp = len(cur), 26
    r = np.random.RandomState(6)
    idx = r.randint(0, n, 17).astype(np.int32)
    idx[:2] = (n - 1, 0)
    p_sub = pred[r.randint(0, n, 17)]
    fz = r.rand(17) < 0.3
    _eq(LP.luma_p_encode(_t(y), _t(p_sub), qp, idx=_t(idx), fz=_t(fz)),
        _jax(cur[idx], p_sub, qp, fz))
    p13 = np.clip(np.concatenate([pred] * 13)
                  + r.randint(-6, 7, (13 * n, 16, 16)), 0, 255) \
        .astype(np.int32)
    lev, rec, cbp = LP.luma_p_encode(_t(y), _t(p13), qp, lev=False)
    assert lev is None
    _eq((rec, cbp), _jax(np.concatenate([cur] * 13), p13, qp)[1:])


def test_wrapper_contract_on_cpu():
    y, pred = _frame(2)
    y, pred = _t(y), _t(pred)
    n = pred.shape[0]
    for qp in (-1, 52):
        with pytest.raises(ValueError, match="qp"):
            LP.luma_p_encode(y, pred, qp)
    with pytest.raises(ValueError, match="plane"):
        LP.luma_p_encode(y[:40], pred, 26)
    with pytest.raises(TypeError, match="y dtype"):
        LP.luma_p_encode(y.to(torch.uint8), pred, 26)
    with pytest.raises(TypeError, match="pred dtype"):
        LP.luma_p_encode(y, pred.to(torch.int16), 26)
    with pytest.raises(ValueError, match="pred shape"):
        LP.luma_p_encode(y, pred[:, :8], 26)
    with pytest.raises(TypeError, match="idx dtype"):
        LP.luma_p_encode(y, pred, 26, idx=torch.arange(n))
    with pytest.raises(ValueError, match="idx shape"):
        LP.luma_p_encode(y, pred, 26,
                         idx=torch.arange(n - 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="fz dtype"):
        LP.luma_p_encode(y, pred, 26, fz=torch.zeros(n, dtype=torch.int32))
    for bad in (-1, n):
        idx = torch.zeros(n, dtype=torch.int32)
        idx[3] = bad
        with pytest.raises(IndexError, match="idx"):
            LP.luma_p_encode(y, pred, 26, idx=idx)
