"""Trellis quantization in the port (`ops/trellis.py`) vs the JAX
reference's `ops/trellis.py` on the CPU, and the fused luma encode's
levels-in entry vs the reference's `luma_p_encode(..., trellis=True)`.

The DP decides in float32, so one rounding apart flips a level: the
levels must be equal, for every ctxBlockCat, intra and inter, at qp 0,
12, 26, 40 and 51, through a per-row qp tensor and through an int qp.
Coefficients are Laplacian around the quantizer's step (made with numpy
from a seed), a fraction of rows scaled up to reach the unary and
Exp-Golomb level bins (>= 15) and every row cut to a random last
position. The reference computes its quant products in int32 (its int64
casts are int32 with JAX's x64 off): a case of huge coefficients holds
the port to that wrap-around."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import inter as J_INTER
from video_steganography_pcamv_tpu.ops import trellis as JT

from video_steganography_pcamv_torch.encoder import inter as T_INTER
from video_steganography_pcamv_torch.ops import lumap as LP
from video_steganography_pcamv_torch.ops import trellis as TT
from video_steganography_pcamv_torch.ops.blocks import mb_tiles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QPS = (0, 12, 26, 40, 51)
ROWS = 48       # rows per qp


def _coefs(cat: int, seed: int):
    """[5 * ROWS, n] int32 coefficients, rows grouped by qp, and the
    per-row qp."""
    n = TT._N[cat]
    rng = np.random.default_rng(seed)
    mf = TT._mf_unq_zig8()[0][1] if cat == TT.CAT_LUMA_8x8 \
        else TT._mf_unq_zig()[0][1]
    out = []
    for qp in QPS:
        step = (1 << 16) / float(mf[qp][0])
        if cat in (TT.CAT_LUMA_DC, TT.CAT_CHROMA_DC):
            step *= 2
        last = rng.integers(1, n + 1, (ROWS, 1))
        c = rng.laplace(0, 1.5 * step, (ROWS, n)) * (np.arange(n) < last)
        c[:ROWS // 8] *= 12
        out.append(np.round(c).astype(np.int32))
    return np.concatenate(out), np.repeat(np.array(QPS, np.int32), ROWS)


@pytest.mark.parametrize("intra", [False, True], ids=["inter", "intra"])
@pytest.mark.parametrize("cat", range(6), ids=[
    "luma_dc", "luma_ac", "luma_4x4", "chroma_dc", "chroma_ac", "luma_8x8"])
def test_trellis_quant_matches_reference(cat, intra):
    zz, qps = _coefs(cat, 10 * cat + intra)
    want = np.asarray(JT.trellis_quant(jnp.asarray(zz), jnp.asarray(qps),
                                       cat, intra))
    got = TT.trellis_quant(torch.as_tensor(zz), torch.as_tensor(qps), cat,
                           intra)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cases reach nonzero levels and the unary / Exp-Golomb bins
    assert (want != 0).any() and (np.abs(want) >= 15).any()
    for qp in QPS:
        sel = qps == qp
        got_q = TT.trellis_quant(torch.as_tensor(zz[sel]), qp, cat, intra)
        np.testing.assert_array_equal(got_q.numpy(), want[sel])


@pytest.mark.parametrize("cat", [TT.CAT_LUMA_4x4, TT.CAT_LUMA_8x8],
                         ids=["luma_4x4", "luma_8x8"])
def test_trellis_quant_wraps_at_32_bits_like_reference(cat):
    """|coef| up to 2^21: coef * mf passes 2^31 at low qp, and the
    reference's int32 product wraps (it would not in int64)."""
    n = TT._N[cat]
    rng = np.random.default_rng(7)
    zz = rng.integers(-(1 << 21), 1 << 21, (64, n)).astype(np.int32)
    qps = np.repeat(np.array([0, 6, 12, 30], np.int32), 16)
    want = np.asarray(JT.trellis_quant(jnp.asarray(zz), jnp.asarray(qps),
                                       cat, False))
    got = TT.trellis_quant(torch.as_tensor(zz), torch.as_tensor(qps), cat,
                           False)
    np.testing.assert_array_equal(got.numpy(), want)
    mf = np.asarray(TT._mf_unq_zig8()[0][1] if n == 64
                    else TT._mf_unq_zig()[0][1])[qps][:, :n]
    assert (np.abs(zz).astype(np.int64) * mf >= (1 << 31)).any()


@pytest.mark.parametrize("qp", [12, 26, 40])
def test_luma_encode_from_trellis_levels_matches_reference(qp):
    """The 4x4 P luma encode under trellis: the port's trellis levels
    through `luma_p_encode_plain(levels=)` (the levels-in kernel's twin,
    the same wrapper on the CPU) against the reference's
    `luma_p_encode(cur, pred, qp, decimate=True, trellis=True)`."""
    rng = np.random.default_rng(qp)
    mbh, mbw = 3, 4
    n = mbh * mbw
    y = rng.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.int32)
    qstep = 0.625 * 2 ** (qp / 6)
    noise = np.round(rng.laplace(0, 2 + 0.6 * qstep, (n, 16, 16))) \
        .astype(np.int32)
    cur = mb_tiles(torch.as_tensor(y), 16).numpy()
    pred = np.clip(cur + noise, 0, 255).astype(np.int32)
    want_lev, want_rec = J_INTER.luma_p_encode(
        jnp.asarray(cur), jnp.asarray(pred), qp, True, True)
    yt, pt = torch.as_tensor(y), torch.as_tensor(pred)
    lev, rec, cbp = T_INTER.luma_encode(yt, pt, qp, trellis=True)
    np.testing.assert_array_equal(lev.numpy(), np.asarray(want_lev))
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want_rec))
    np.testing.assert_array_equal(cbp.numpy(), LP.cbp_luma_of(lev).numpy())
    # the trellis moved some level away from the deadzone quant's
    plain, _, _ = LP.luma_p_encode_plain(yt, pt, qp)
    assert (plain != lev).any()
    # force-zero through the levels-in entry
    fz = torch.as_tensor(np.arange(n) % 3 == 0)
    lev_fz, rec_fz, cbp_fz = LP.luma_p_encode(yt, pt, qp, fz=fz,
                                              levels=lev.contiguous())
    assert not lev_fz[fz].any() and not cbp_fz[fz].any()
    np.testing.assert_array_equal(rec_fz[fz].numpy(), pred[fz.numpy()])
    np.testing.assert_array_equal(lev_fz[~fz].numpy(), lev[~fz].numpy())
