"""The port's flagship steps (`models/pipeline.py`) and its tiled step
(`parallel/tile.py`) against the JAX package's, on the CPU.

At 128x96 the same inputs go through the JAX `multi_stream_step` over two
streams (for both steps, whose per-stream results are the steps') and
the port's `p_frame_step`, `p_frame_step_parts` and `multi_stream_step`:
`with_stego` on and off, `cost_mv` given and built by the step, and on
both branches (`use_pallas`: the reference's accelerator branch of the
partitioned step runs its Pallas kernel B1 in interpret mode as a host
callback, the `reference_accel` fixture of
tests/test_torch_encoder_accel.py). Integer outputs array-equal,
`stego_rho` bit-equal. The default `cost_mv` table is held bit-equal to
XLA's on every lam of `lambda_tab(0..51)`.

The tiled step over 4 CPU tiles at mbh=12, mbw=6 (the reference's
tests/test_tile_mesh.py shape) equals the JAX tiled step and the port's
untiled step key by key, and its halo log shows 2 * (4 - 1) packed
transfers of PAD luma and PAD chroma rows. Each JAX program is compiled
once a module: the JAX results are module-scoped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from video_steganography_pcamv_tpu.encoder import me as JME
from video_steganography_pcamv_tpu.models import pipeline as JPL
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.parallel import tile as JTL
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch.models import pipeline as TPL
from video_steganography_pcamv_torch.ops import mc as TMC
from video_steganography_pcamv_torch.parallel import mesh as TMESH
from video_steganography_pcamv_torch.parallel import tile as TTL

from test_torch_encoder_accel import reference_accel  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW, RNG, QP, QPC = 6, 8, 8, 26, 26
LAM = int(JME.lambda_tab(QP))


def _frames(mbh, mbw, seed):
    """(y, u, v, ry, ru, rv) int32: frame 1 and frame 0's planes."""
    f0, f1 = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=seed)
    return tuple(np.asarray(a, np.int32)
                 for a in (f1.y, f1.u, f1.v, f0.y, f0.u, f0.v))


def _inputs(s=0):
    """Stream s's planes, padded references and a random predictor."""
    y, u, v, ry, ru, rv = _frames(MBH, MBW, 3 + s)
    ref = JMC.build_ref(jnp.asarray(ry), jnp.asarray(ru), jnp.asarray(rv))
    rs = np.random.RandomState(11 + s)
    prev = rs.randint(-12, 13, (MBH, MBW, 2)).astype(np.int32)
    return (y, u, v, np.asarray(ref["luma"]), np.asarray(ref["u"]),
            np.asarray(ref["v"]), prev)


def _kw(**kw):
    return dict(dict(qp=QP, qpc=QPC, mbh=MBH, mbw=MBW, rng=RNG, lam=LAM),
                **kw)


def _port(fn, args, **kw):
    out = fn(*(torch.as_tensor(a) for a in args), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax(fn, args, **kw):
    return {k: np.asarray(v) for k, v in
            fn(*(jnp.asarray(a) for a in args), **kw).items()}


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.kind == "f":
            # rho bit for bit (ROADMAP C2)
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k].view(np.int32),
                                          want[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# the CPU branch's JAX runs, once a module: `multi_stream_step` over two
# streams for each step (whose per-stream results are the steps')
_STEPS = ("p_frame_step", "p_frame_step_parts")


@pytest.fixture(scope="module")
def jax_cpu_branch():
    streams = [_inputs(s) for s in range(2)]
    stacked = [np.stack(a) for a in zip(*streams)]
    kw = _kw()
    out = {}
    for step in _STEPS:
        multi = jax.jit(lambda *a, parts=step.endswith("parts"):
                        JPL.multi_stream_step(*a, parts=parts, **kw))(
            *(jnp.asarray(a) for a in stacked))
        out[step] = {k: np.asarray(v) for k, v in multi.items()}
    return streams, stacked, out


@pytest.mark.parametrize("with_stego,cost_mv", [(True, None),
                                                (True, "given"),
                                                (False, None)])
@pytest.mark.parametrize("step", _STEPS)
def test_step_matches_reference_cpu_branch(jax_cpu_branch, step,
                                           with_stego, cost_mv):
    """Stream 0 through each step, against the reference's run with its
    default cost_mv: the port's given the default table as an argument
    (bit-equal to XLA's, `test_default_cost_mv_is_xlas_on_every_lam`) or
    building it itself. With stego off the reference's step only leaves
    out its stego keys, so the port's is held against the reference's
    with stego on, those keys left out."""
    streams, _stacked, want = jax_cpu_branch
    kw = _kw(with_stego=with_stego)
    if cost_mv:
        kw["cost_mv"] = TPL.default_cost_mv(LAM, "cpu")
    ref = {k: v[0] for k, v in want[step].items()}
    if not with_stego:
        ref = {k: v for k, v in ref.items() if not k.startswith("stego_")}
    got = _port(getattr(TPL, step), streams[0], **kw)
    _equal(got, ref)
    if with_stego:
        assert np.abs(got["stego_rho"]).sum() > 0


@pytest.mark.parametrize("step", _STEPS)
def test_multi_stream_step_matches_reference(jax_cpu_branch, step):
    """Two streams over a leading axis: the JAX vmapped step against the
    port's per-stream calls."""
    _streams, stacked, want = jax_cpu_branch
    got = TPL.multi_stream_step(*(torch.as_tensor(a) for a in stacked),
                                parts=step.endswith("parts"), **_kw())
    _equal({k: v.numpy() for k, v in got.items()}, want[step])


def test_step_matches_reference_accel_branch(jax_cpu_branch,
                                            reference_accel):
    """use_pallas=True. The partitioned step: the reference's kernel B1
    (zero predictor) in interpret mode; its outputs then differ from the
    CPU branch's (B1's predictor). The 16x16 step searches against zero
    on both branches (the reference's B6 or its plain search, equal by
    its own tests/test_analyse2.py), so the port's accelerator branch is
    held against the reference's CPU-branch run."""
    streams, _stacked, want = jax_cpu_branch
    args = streams[0]
    ref = _jax(JPL.p_frame_step_parts, args, **_kw(use_pallas=True))
    assert reference_accel["fullpel"] >= 1
    got = _port(TPL.p_frame_step_parts, args, **_kw(use_pallas=True))
    _equal(got, ref)
    other = _port(TPL.p_frame_step_parts, args, **_kw(use_pallas=False))
    assert not all(np.array_equal(other[k], got[k]) for k in got)
    got16 = _port(TPL.p_frame_step, args, **_kw(use_pallas=True))
    _equal(got16, {k: v[0] for k, v in want["p_frame_step"].items()})


def test_default_cost_mv_is_xlas_on_every_lam():
    """The steps' default table, bit-equal to the reference's expression
    under XLA on the CPU, lam traced as in the steps."""
    @jax.jit
    def ref_table(lam):
        d = jnp.arange(0, 4 * 512 + 1)
        base = (2.0 * jnp.log2(d.astype(jnp.float32) + 1.0)
                + 0.718 + (d != 0))
        return (lam * base + 0.5).astype(jnp.int32)

    lams = sorted({int(JME.lambda_tab(q)) for q in range(52)})
    assert len(lams) > 20
    for lam in lams:
        np.testing.assert_array_equal(
            TPL.default_cost_mv(lam, "cpu").numpy(),
            np.asarray(ref_table(jnp.int32(lam))), err_msg="lam %d" % lam)


def test_step_refuses_what_it_cannot_run():
    args = [torch.as_tensor(a) for a in _inputs()]
    for kw in (dict(subpel=1), dict(decimate=False)):
        with pytest.raises(NotImplementedError):
            TPL.p_frame_step_parts(*args, **_kw(**kw))


# ---------------------------------------------------------------------------
# the tiled step: 4 tiles at the reference's test shape
# ---------------------------------------------------------------------------

TMBH, TMBW, N_TILES = 12, 6, 4


@pytest.fixture(scope="module")
def tiled_case():
    y, u, v, ry, ru, rv = _frames(TMBH, TMBW, 3)
    prev = np.zeros((TMBH, TMBW, 2), np.int32)
    kw = dict(qp=28, qpc=28, mbh=TMBH, mbw=TMBW, rng=8, lam=4)
    mesh = Mesh(np.array(jax.devices()[:N_TILES]), ("tile",))
    tiled = {k: np.asarray(a) for k, a in JTL.p_frame_step_tiled(
        mesh, y, u, v, ry, ru, rv, prev, **kw).items()}
    return (y, u, v, ry, ru, rv, prev), kw, tiled


def test_tiled_step_matches_reference(tiled_case):
    """The port's tiled step over 4 CPU tiles equals the JAX tiled step
    and the port's untiled step key by key (the reference's
    tests/test_tile_mesh.py holds its tiled step equal to its untiled
    one on these inputs, and the untiled steps are held equal above);
    the halo log holds exactly the 2 * (n - 1) packed transfers, each of
    PAD luma and PAD chroma rows, between neighbours."""
    args, kw, tiled = tiled_case
    TTL.halo_log.clear()
    got = TTL.p_frame_step_tiled(["cpu"] * N_TILES, *args, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert len(TTL.halo_log) == 2 * (N_TILES - 1)
    _equal(got, tiled)
    ref = TMC.build_ref(*(torch.as_tensor(a) for a in args[3:6]))
    untiled = TPL.p_frame_step_parts(
        *(torch.as_tensor(a) for a in args[:3]), ref["luma"], ref["u"],
        ref["v"], torch.as_tensor(args[6]), **kw)
    _equal(got, {k: v.numpy() for k, v in untiled.items()})
    assert sorted(TTL.halo_log) == sorted(
        [(i, i + 1, TMC.PAD, TMC.PAD) for i in range(N_TILES - 1)]
        + [(i + 1, i, TMC.PAD, TMC.PAD) for i in range(N_TILES - 1)])


@pytest.mark.parametrize("rng", [4, 8, 16])
def test_pred_clamp_matches_reference(rng):
    assert TTL.pred_clamp_fp(rng) == JTL.pred_clamp_fp(rng)


def test_tiled_step_clamps_the_vertical_predictor(tiled_case):
    """A predictor beyond the clamp is clipped in each tile: the tiled
    step equals the untiled port step fed the clipped predictor."""
    args, kw = tiled_case[:2]
    rs = np.random.RandomState(5)
    prev = rs.randint(-80, 81, (TMBH, TMBW, 2)).astype(np.int32)
    got = TTL.p_frame_step_tiled(["cpu"] * N_TILES, *args[:6], prev, **kw)
    cq = 4 * TTL.pred_clamp_fp(kw["rng"])
    clipped = prev.copy()
    clipped[..., 1] = np.clip(clipped[..., 1], -cq, cq)
    assert (clipped != prev).any()
    ref = TMC.build_ref(*(torch.as_tensor(a) for a in args[3:6]))
    want = TPL.p_frame_step_parts(
        *(torch.as_tensor(a) for a in args[:3]), ref["luma"], ref["u"],
        ref["v"], torch.as_tensor(clipped), **kw)
    # rows next to a tile edge read the neighbour's halo, the same rows
    for k in ("mv8", "part", "cbp_luma", "luma_lev", "recon_y"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def test_tiled_step_refuses_bad_splits(tiled_case):
    args, kw = tiled_case[:2]
    with pytest.raises(ValueError):
        TTL.p_frame_step_tiled(["cpu"] * 5, *args, **kw)
    with pytest.raises(ValueError):
        TTL.p_frame_step_tiled(["cpu"] * 6, *args, **kw)


def test_encode_streams_sharded_sums_over_devices():
    """Two streams over two CPU devices: the per-stream outputs equal
    `multi_stream_step`'s, and the global MV magnitude is the sum over
    both streams."""
    streams = [_inputs(s) for s in range(2)]
    stacked = [np.stack(a) for a in zip(*streams)]
    kw = _kw()
    out = TMESH.encode_streams_sharded(TMESH.build_mesh(devices=["cpu"] * 2),
                                       *stacked, parts=True, **kw)
    want = TPL.multi_stream_step(*(torch.as_tensor(a) for a in stacked),
                                 parts=True, **kw)
    for k in want:
        np.testing.assert_array_equal(out[k].numpy(), want[k].numpy())
    assert int(out["global_mv_mag"]) == int(want["mv8"].abs().sum())
    with pytest.raises(ValueError):
        TMESH.encode_streams_sharded(["cpu"] * 3, *stacked, **kw)
