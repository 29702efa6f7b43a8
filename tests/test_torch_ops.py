"""Port primitives vs the JAX reference on the same seeded inputs, exact:
transforms and quantisation, MC (including the wrapped hpel border),
SAD/SATD, intra predictors and the lowres lookahead costs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.ops import pixel as JPX
from video_steganography_pcamv_tpu.ops import predict as JPR
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.encoder import slicetype as JST

from video_steganography_pcamv_torch.ops import mc as TMC
from video_steganography_pcamv_torch.ops import pixel as TPX
from video_steganography_pcamv_torch.ops import predict as TPR
from video_steganography_pcamv_torch.ops import transform as TT
from video_steganography_pcamv_torch.encoder import slicetype as TST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


def both(x):
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("qp", [0, 12, 26, 40, 51])
def test_transform_quant_roundtrip(qp):
    rng = np.random.RandomState(qp)
    res = rng.randint(-255, 256, (3, 4, 4, 5, 6)).astype(np.int32)
    j, t = both(res)
    jc, tc = JT.dct4x4(j), TT.dct4x4(t)
    eq(jc, tc)
    for intra in (True, False):
        jl = JT.quant4x4(jc, qp, intra=intra)
        tl = TT.quant4x4(tc, qp, intra=intra)
        eq(jl, tl)
        eq(JT.dequant4x4(jl, qp), TT.dequant4x4(tl, qp))
        eq(JT.quant_dc(jc[:, 0, 0], qp, intra), TT.quant_dc(tc[:, 0, 0], qp,
                                                             intra))
    eq(JT.idct4x4_add(j, jc), TT.idct4x4_add(t, tc))
    eq(JT.hadamard4x4(j, final_shift=True), TT.hadamard4x4(t, True))
    eq(JT.dequant_dc_luma(j[:, 0, 0], qp), TT.dequant_dc_luma(t[:, 0, 0], qp))
    dc = res[:, :2, :2]
    jd, td = both(dc)
    eq(JT.hadamard2x2(jd), TT.hadamard2x2(td))
    eq(JT.dequant_dc_chroma(jd[:, 0, 0], qp),
       TT.dequant_dc_chroma(td[:, 0, 0], qp))
    assert TT.chroma_qp(qp, -2) == JT.chroma_qp(qp, -2)
    np.testing.assert_array_equal(TT.QUANT4_MF, JT.QUANT4_MF)
    np.testing.assert_array_equal(TT.QUANT4_BIAS_INTER, JT.QUANT4_BIAS_INTER)
    np.testing.assert_array_equal(TT.DEQUANT4_MF, JT.DEQUANT4_MF)


def test_hpel_planes_wrap_and_build_ref():
    rng = np.random.RandomState(1)
    y = rng.randint(0, 256, (32, 48)).astype(np.int32)
    u = rng.randint(0, 256, (16, 24)).astype(np.int32)
    (jy, ty), (ju, tu) = both(y), both(u)
    eq(JMC.pad_plane(jy), TMC.pad_plane(ty))
    # the border wraps around (jnp.roll), so the last columns of H/V/C
    # mix in the opposite edge — compare whole planes, wrap included
    for a, b in zip(JMC.hpel_planes(JMC.pad_plane(jy)),
                    TMC.hpel_planes(TMC.pad_plane(ty))):
        eq(a, b)
    jr, tr = JMC.build_ref(jy, ju, ju), TMC.build_ref(ty, tu, tu)
    for k in ("luma", "u", "v"):
        eq(jr[k], tr[k])


@pytest.mark.parametrize("bh", [16, 8])
def test_mc_luma_chroma_gather(bh):
    rng = np.random.RandomState(bh)
    y = rng.randint(0, 256, (48, 64)).astype(np.int32)
    jr = JMC.build_ref(jnp.asarray(y), jnp.asarray(y[::2, ::2]),
                       jnp.asarray(y[1::2, ::2]))
    tr = TMC.build_ref(torch.as_tensor(y), torch.as_tensor(y[::2, ::2]),
                       torch.as_tensor(y[1::2, ::2]))
    n = 40
    ys = (rng.randint(0, 48 // bh, n) * bh).astype(np.int32)
    xs = (rng.randint(0, 64 // bh, n) * bh).astype(np.int32)
    mv = rng.randint(-60, 61, (n, 2)).astype(np.int32)
    (jys, tys), (jxs, txs), (jmv, tmv) = both(ys), both(xs), both(mv)
    eq(JMC.mc_luma(jr["luma"], jys, jxs, jmv, bh, bh),
       TMC.mc_luma(tr["luma"], tys, txs, tmv, bh, bh))
    eq(JMC.mc_chroma(jr["u"], jys // 2, jxs // 2, jmv, bh // 2, bh // 2),
       TMC.mc_chroma(tr["u"], tys // 2, txs // 2, tmv, bh // 2, bh // 2))


def test_sad_satd():
    rng = np.random.RandomState(7)
    a = rng.randint(0, 256, (2, 32, 48)).astype(np.int32)
    b = rng.randint(0, 256, (2, 32, 48)).astype(np.int32)
    (ja, ta), (jb, tb) = both(a), both(b)
    for blk in (4, 8, 16):
        eq(JPX.sad(ja, jb, blk), TPX.sad(ta, tb, blk))
    eq(JPX.satd4(ja, jb), TPX.satd4(ta, tb))
    eq(JPX.satd(ja, jb, 16), TPX.satd(ta, tb, 16))


def test_intra_predictors():
    rng = np.random.RandomState(3)
    n = 30
    top = rng.randint(0, 256, (n, 16)).astype(np.int32)
    left = rng.randint(0, 256, (n, 16)).astype(np.int32)
    tl = rng.randint(0, 256, n).astype(np.int32)
    at = rng.rand(n) < 0.7
    al = rng.rand(n) < 0.7
    J = [jnp.asarray(x) for x in (top, left, tl, at, al)]
    T = [torch.as_tensor(x) for x in (top, left, tl, at, al)]
    eq(JPR.predict_i16x16_all(*J), TPR.predict_i16x16_all(*T))
    Jc = [J[0][:, :8], J[1][:, :8]] + J[2:]
    Tc = [T[0][:, :8], T[1][:, :8]] + T[2:]
    eq(JPR.predict_chroma_all(*Jc), TPR.predict_chroma_all(*Tc))
    J4 = [J[0][:, :8], J[1][:, :4]] + J[2:]
    T4 = [T[0][:, :8], T[1][:, :4]] + T[2:]
    eq(JPR.predict_i4x4_all(*J4), TPR.predict_i4x4_all(*T4))


@pytest.mark.parametrize("rng_", [0, 3])
def test_lowres_costs(rng_):
    r = np.random.RandomState(rng_)
    bh, bw = 3, 4
    cur = r.randint(0, 256, (16 * bh, 16 * bw)).astype(np.int32)
    prev = np.roll(cur, (2, -3), (0, 1))
    (jc, tc), (jp, tp) = both(cur), both(prev)
    jl, tl = JST.lowres(jc), TST.lowres(tc)
    eq(jl, tl)
    eq(JST.lowres_costs(jl, JST.lowres(jp), bh, bw, rng=rng_),
       TST.lowres_costs(tl, TST.lowres(tp), bh, bw, rng=rng_))
