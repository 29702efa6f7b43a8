"""The port's analyse tail (ops/probe.py) vs the JAX reference's TPU
kernels run in interpret mode: the plain B2 tables against
`qpel_tables_pallas`, the plain `analyse_tail` (B2 -> B3 -> B4) against
`analyse_tail_pallas` (at 112x80, the size whose interpret-mode
compile tests/test_torch_encoder_accel.py's `tail_interpret` shares
across the modules of a process), and `probe_combine` on the port's
maps against the reference's `stego_costs_parts`. Every comparison is
exact. The constant tables of the tail's CUDA kernel
(csrc/tail_tables.inc) are held against their sources: the reference's
D_MV, D_NB and zigzag, the pairs they imply, and its 4x4 WHT and core
DCT as 16x16 matrices."""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import me as JME
from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.ops import transform as JT
from video_steganography_pcamv_tpu.stego.cost import D_MV, D_NB
from video_steganography_pcamv_tpu.ops.probe_pallas import (
    qpel_tables_pallas)
from video_steganography_pcamv_tpu.stego.cost import cost_mv_table

from video_steganography_pcamv_torch.encoder import partition as TPT
from video_steganography_pcamv_torch.ops import probe as TPR
from video_steganography_pcamv_torch.ops import transform as TT

from test_torch_encoder_accel import tail_interpret


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


def _sp_to_z_rows(a, mbh, mbw):
    """[N8 spatial, ...] -> [N8 z-order, ...] (the TPU kernels' lanes)."""
    rest = a.shape[1:]
    return a.reshape(mbh, 2, mbw, 2, *rest) \
        .transpose(0, 2, 1, 3, *range(4, 4 + len(rest))) \
        .reshape(4 * mbh * mbw, *rest)


def _z_to_sp_rows(a, mbh, mbw):
    rest = a.shape[1:]
    return a.reshape(mbh, mbw, 2, 2, *rest) \
        .transpose(0, 2, 1, 3, *range(4, 4 + len(rest))) \
        .reshape(4 * mbh * mbw, *rest)


def _setup(seed, mbh, mbw, flat=False):
    """Inputs as tests/test_probe_pallas.py builds them; `flat` makes
    both frames one grey level and the predictor sit 5 qpel left of and
    above block 0's full-pel MV, so every SATD is 0 and the subpel
    costs tie between neighbouring offsets."""
    rng = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    prev = rng.randint(0, 256, (h, w)).astype(np.int32)
    cur = np.clip(prev + rng.randint(-20, 21, (h, w)), 0, 255) \
        .astype(np.int32)
    if flat:
        prev[:] = 128
        cur[:] = 128
    u = rng.randint(0, 256, (h // 2, w // 2)).astype(np.int32)
    ref = JMC.build_ref(jnp.asarray(prev), jnp.asarray(u), jnp.asarray(u))
    part = rng.randint(0, 4, (mbh, mbw)).astype(np.int32)
    mvfp8 = rng.randint(-16, 17, (2 * mbh, 2 * mbw, 2)).astype(np.int32)
    # members of a partition unit share their MV
    mvz = np.array(JPT._sp_to_z(jnp.asarray(mvfp8), mbh, mbw))
    for pt, units in JPT.UNIT_BLOCKS.items():
        sel = part == pt
        for blocks in units:
            for b in blocks[1:]:
                mvz[sel, b] = mvz[sel, blocks[0]]
    mvfp8 = np.asarray(JPT._z_to_sp(jnp.asarray(mvz), mbh, mbw))
    if flat:
        prev_mv = (4 * mvz[:, :, 0] - 5).astype(np.int32)
    else:
        prev_mv = rng.randint(-32, 33, (mbh, mbw, 2)).astype(np.int32)
    planes = ref["luma"].astype(jnp.uint8)
    windows = JPT.gather_windows8_jnp(planes, jnp.asarray(mvfp8), mbh, mbw)
    return cur, windows, part, mvfp8, prev_mv


@pytest.mark.parametrize("seed,qp,decimate,flat", [
    (0, 26, True, False), (1, 26, True, False), (0, 38, True, False),
    (1, 38, True, False), (2, 26, False, False), (3, 26, True, True)],
    ids=["s0-q26", "s1-q26", "s0-q38", "s1-q38", "nodecimate", "flat"])
def test_analyse_tail_plain_matches_pallas(seed, qp, decimate, flat):
    mbh, mbw = 5, 7
    cur, windows, part, mvfp8, prev_mv = _setup(seed, mbh, mbw, flat)
    lam = JME.lambda_tab(qp)
    # `decimate` is static in the reference, so each setting is a trace
    # of its own; with it off, the reference's probe kernel writes the
    # same SK, SP = SK and sc8 = 0 (probe_pallas.py:470-476), so the
    # decimate-off result is held against the decimate-on trace
    want = tail_interpret(
        jnp.asarray(cur), windows, jnp.asarray(part), jnp.asarray(mvfp8),
        jnp.asarray(prev_mv), lam, qp, mbh, mbw, decimate=True)
    if not decimate:
        mv8, r_idx8, SK, _SP, sc8 = want
        want = (mv8, r_idx8, SK, SK, jnp.zeros_like(sc8))
    got = TPR.analyse_tail(_t(cur), _t(windows), _t(part), _t(mvfp8),
                           _t(prev_mv), lam, qp, mbh, mbw,
                           decimate=decimate)
    for name, g, w in zip(("mv8", "r_idx8", "SK", "SP", "sc8"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if flat:
        # every SATD is 0; where the predictor sits (-5, -5) qpel from
        # 4 * mv, offsets -3 and -2 tie in each component and the first
        # (-3, -3), table index 42, must win
        pred8 = np.repeat(np.repeat(prev_mv, 2, 0), 2, 1)
        tied = ((pred8 - 4 * mvfp8) == -5).all(-1).reshape(-1)
        assert tied.sum() >= 8
        assert (got[1].numpy()[tied] == 42).all()


def test_probe_combine_matches_stego_costs_parts():
    mbh, mbw, qp = 2, 3, 26
    cur, windows, part, mvfp8, prev_mv = _setup(3, mbh, mbw)
    lam = JME.lambda_tab(qp)
    cur_j = jnp.asarray(cur)
    blocks8 = JPT.block_table8(windows)
    wht8 = JPT.wht8_flat(blocks8).astype(jnp.int16)
    mv8, ridx, _ = JPT.subpel_parts(
        cur_j, wht8, jnp.asarray(part), jnp.asarray(mvfp8),
        jnp.asarray(prev_mv), mbh, mbw, lam, 2)
    mvp_u = np.random.RandomState(9).randint(
        -64, 65, (mbh, mbw, 4, 2)).astype(np.int32)
    cmv = cost_mv_table(lam)
    want = JPT.stego_costs_parts(
        cur_j, blocks8, wht8, ridx, jnp.asarray(part), mv8,
        jnp.asarray(mvp_u), jnp.asarray(cmv), qp, mbh, mbw, True)

    mv8_t, _r, SK, SP, sc8 = TPR.analyse_tail(
        _t(cur), _t(windows), _t(part), _t(mvfp8), _t(prev_mv), lam, qp,
        mbh, mbw)
    np.testing.assert_array_equal(mv8_t.numpy(), np.asarray(mv8))
    got = TPT.probe_combine(SK, SP, sc8, _t(part), mv8_t, _t(mvp_u),
                            _t(cmv), mbh, mbw)
    for name, g, w in zip(("rho", "alt", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_qpel_tables_plain_matches_pallas():
    mbh, mbw = 5, 7
    n8 = 4 * mbh * mbw
    windows = np.random.RandomState(5).randint(
        0, 256, (n8, 4, 16, 16)).astype(np.uint8)
    pad = (-n8) % 128
    w1024 = _sp_to_z_rows(windows.reshape(n8, 1024), mbh, mbw).T
    w1024 = np.pad(w1024.astype(np.int16), ((0, 0), (0, pad)))
    blk_p, wht_p = qpel_tables_pallas(jnp.asarray(w1024), interpret=True)

    def to_sp(tab):
        t = np.asarray(tab).reshape(169, 64, n8 + pad)[:, :, :n8]
        return np.stack([_z_to_sp_rows(t[o].T, mbh, mbw)
                         for o in range(169)])            # [169, N8, 64]

    blocks8, wht8 = TPR.qpel_tables(_t(windows))
    assert blocks8.dtype == torch.uint8 and wht8.dtype == torch.int16
    np.testing.assert_array_equal(
        blocks8.numpy().reshape(169, n8, 64).astype(np.int16),
        to_sp(blk_p))
    np.testing.assert_array_equal(wht8.numpy(), to_sp(wht_p))


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_INC = os.path.join(_ROOT, "video_steganography_pcamv_torch", "csrc",
                    "tail_tables.inc")


def _inc_tables():
    """name -> flat int array of every table in csrc/tail_tables.inc."""
    with open(_INC) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r"(k\w+)((?:\[\d+\])+) = \{([^}]*)\};", src):
        shape = [int(d) for d in re.findall(r"\d+", m.group(2))]
        out[m.group(1)] = np.array(
            [int(x) for x in m.group(3).split(",")]).reshape(shape)
    return out


def _slot(dy, dx):
    return (dy + 3) * 7 + dx + 3


def _kron_of(fn):
    """[j = 4*vr + vc, i = 4*r + c] of a transform on axes (-4, -3)."""
    eye = np.eye(16, dtype=np.int32).reshape(16, 4, 4, 1, 1)
    return np.asarray(fn(jnp.asarray(eye))).reshape(16, 16).T


_CENTRES = [(0, 0)] + [(int(dy), int(dx)) for dx, dy in D_MV]
_NBS = [(int(dy), int(dx)) for dx, dy in D_NB]


def _want_sp_pairs():
    """Every unordered lattice slot pair {c_v, c_v + nb_k}, nb_k !=
    (0, 0)."""
    return {tuple(sorted((_slot(cy, cx), _slot(cy + ny, cx + nx))))
            for cy, cx in _CENTRES for ny, nx in _NBS if (ny, nx) != (0, 0)}


def _check_sp(t):
    pairs = [tuple(p) for p in t["kSpPair"]]
    want = _want_sp_pairs()
    assert len(pairs) == len(set(pairs)) == len(want) == 84
    assert set(pairs) == want
    for v, (cy, cx) in enumerate(_CENTRES):
        for k, (ny, nx) in enumerate(_NBS):
            i = t["kSpIndex"][9 * v + k]
            if (ny, nx) == (0, 0):
                assert i == -1
            else:
                assert sorted(pairs[i]) == sorted(
                    (_slot(cy, cx), _slot(cy + ny, cx + nx)))


def _check_slot_version(t):
    want = np.full(49, -1)
    for v, (cy, cx) in enumerate(_CENTRES):
        want[_slot(cy, cx)] = v
    np.testing.assert_array_equal(t["kSlotVersion"], want)


def _check_sk_slot(t):
    np.testing.assert_array_equal(
        t["kSkSlot"], [_slot(cy + ny, cx + nx) for cy, cx in _CENTRES
                       for ny, nx in _NBS])


def _check_zigzag(t):
    zz = [4 * int(r) + int(c) for r, c in JT.ZIGZAG_4x4]
    np.testing.assert_array_equal(t["kZigzagRank"],
                                  [zz.index(j) for j in range(16)])


def _check_dct(t):
    np.testing.assert_array_equal(t["kDctKron"], _kron_of(JT.dct4x4))
    assert set(np.unique(np.abs(t["kDctKron"]))) == {1, 2, 4}


def _check_generated(_t):
    """The file is what its generator writes from the port's sources."""
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    try:
        import gen_tail_tables
    finally:
        sys.path.pop(0)
    with open(_INC) as f:
        assert f.read() == gen_tail_tables.source()


_TABLE_CHECKS = {
    "centres": lambda t: np.testing.assert_array_equal(t["kCenter"],
                                                       _CENTRES),
    "nb": lambda t: np.testing.assert_array_equal(t["kNb"], _NBS),
    "slot_version": _check_slot_version,
    "zigzag_rank": _check_zigzag,
    "sp_pairs": _check_sp,
    "sk_slots": _check_sk_slot,
    "wht_kron": lambda t: np.testing.assert_array_equal(
        t["kWhtKron"], _kron_of(JT.hadamard4x4)),
    "dct_kron": _check_dct,
    "generated": _check_generated,
}


@pytest.mark.parametrize("table", list(_TABLE_CHECKS))
def test_tail_kernel_tables_match_their_sources(table):
    """Each table of csrc/tail_tables.inc against its source: the probe
    versions' centres and D_NB (the reference's D_MV, D_NB), the
    slot -> version map, the zigzag rank, the 84 SP pairs and the
    (v, k) -> pair index, the SK slots, the kron WHT and DCT (the
    reference's `hadamard4x4` / `dct4x4` on the unit blocks), and the
    file against its generator."""
    _TABLE_CHECKS[table](_inc_tables())


@pytest.mark.parametrize("which", ["wht", "dct"])
def test_tail_kron_matrices_transform_random_blocks(which):
    """The kernel's matrices on random uint8 4x4s (a row a block,
    coefficient order 4*vr + vc) give the port's butterflies' results,
    and a pair [x | y] against [M; -M] gives M (x - y), the folded SATD
    difference and residual."""
    t = _inc_tables()
    m = t["kWhtKron" if which == "wht" else "kDctKron"].astype(np.int64)
    fn = TT.hadamard4x4 if which == "wht" else TT.dct4x4
    g = np.random.RandomState(7)
    x = g.randint(0, 256, (500, 4, 4))
    y = g.randint(0, 256, (500, 4, 4))
    planes = torch.as_tensor(x.transpose(1, 2, 0)[:, :, :, None]
                             .astype(np.int32))
    want = fn(planes).numpy()[:, :, :, 0].transpose(2, 0, 1).reshape(500, 16)
    np.testing.assert_array_equal(x.reshape(500, 16) @ m.T, want)
    ab = np.concatenate([x.reshape(500, 16), y.reshape(500, 16)], 1)
    np.testing.assert_array_equal(ab @ np.concatenate([m.T, -m.T]),
                                  (x - y).reshape(500, 16) @ m.T)
