"""The fused P stage 1 and the pass-2 pieces vs the JAX reference on a
real mid-stream state carried over by `state.from_reference`: the packed
stage-1 array (rho compared bit for bit), the pass-1 `res`, the
incremental re-encode of a flipped subset and the lean level pack.

Both branches of stage 1 are covered: the reference's CPU branch
(`tail_kernel=False`, its own `p_stage1_stego`) and its accelerator
branch (`tail_kernel=True`), whose reference is composed here from
partition.py's TPU branch with B1's Pallas kernel in interpret mode and
the analyse tail's XLA twin (the chain the reference's
tests/test_probe_pallas.py holds its tail kernels against)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import core as JCORE
from video_steganography_pcamv_tpu.encoder import inter_incr as JINC
from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.encoder import inter as JINTER
from video_steganography_pcamv_tpu.encoder import slicetype as JST
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.encoder.me import lambda_tab
from video_steganography_pcamv_tpu.encoder.scan_device import _scan_p_device
from video_steganography_pcamv_tpu.ops.transform import chroma_qp
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.cost import cost_mv_table
from video_steganography_pcamv_tpu.utils.yuv import Frame, synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch.encoder import core as TCORE
from video_steganography_pcamv_torch.encoder import inter_incr as TINC
from video_steganography_pcamv_torch.encoder import partition as TPT
from video_steganography_pcamv_torch.encoder import slicetype as TST
from video_steganography_pcamv_torch.params import Params as TParams
from video_steganography_pcamv_torch.params import StegoParams as TStegoParams
from video_steganography_pcamv_torch.state import from_reference

from test_torch_encoder_accel import fullpel_interpret, tail_xla


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 112, 80
MBH, MBW = 5, 7
RES_KEYS = ("luma_lev", "cbp_luma", "cbp_chroma", "chroma_dc", "chroma_ac",
            "recon_y", "recon_u", "recon_v")


def _seq(n, seed=1):
    rng = np.random.RandomState(seed)
    big = rng.randint(30, 226, ((H + 64) // 4, (W + 64) // 4))
    big = np.repeat(np.repeat(big, 4, 0), 4, 1).astype(np.uint8)
    frames = []
    for i in range(n):
        f = big[16 + i:16 + i + H, 16 + 2 * i:16 + 2 * i + W].copy()
        u = np.full((H // 2, W // 2), 120 + i, np.uint8)
        frames.append(Frame(f, u, u.copy()))
    return frames


def _params(params=Params, stego=StegoParams, tail_kernel=False,
            size=(W, H)):
    p = params(width=size[0], height=size[1], qp=26, me_range=16,
               deblock_device=True, psnr=False,
               stego=stego(em_rate=64, key=99))
    p.tail_kernel = tail_kernel
    return p


def _tparams(tail_kernel=False, size=(W, H)):
    """The same encode described by the port's own Params."""
    return _params(TParams, TStegoParams, tail_kernel, size)


@pytest.fixture(scope="module")
def stage1():
    """Both stage-1 results on frame 3, after three reference frames."""
    frames = _seq(4)
    jenc = JEncoder(_params())
    for f in frames[:3]:
        jenc.encode_frame(f)
    tenc = TEncoder(_tparams(), device="cpu")
    tenc.load_state(from_reference(jenc))
    qp = 26
    qpc, lam = chroma_qp(qp), lambda_tab(qp)
    y, u, v = jenc._pad(frames[3])
    lr_j = JST.lowres_costs(JST.lowres(y), jenc.lookahead.prev_lr, MBH, MBW,
                            rng=8)
    packed_j, res_j, *_ = JPT.p_stage1_stego(
        y, u, v, jenc.ref["luma"], jenc.ref["u"], jenc.ref["v"],
        jnp.asarray(jenc.prev_mv), qp, qpc, lam,
        jnp.asarray(cost_mv_table(lam)), 16, MBH, MBW, 2, False, True,
        False, nr_offset=None, extra=lr_j, full_pass1=True,
        tail_kernel=False)
    yt, ut, vt = tenc._pad(frames[3])
    lr_t = TST.lowres_costs(TST.lowres(yt), tenc.lookahead.prev_lr, MBH,
                            MBW, rng=8)
    packed_t, res_t = TPT.p_stage1_stego(
        yt, ut, vt, tenc.ref["luma"], tenc.ref["u"], tenc.ref["v"],
        torch.as_tensor(tenc.prev_mv), qp, qpc, lam,
        torch.as_tensor(cost_mv_table(lam)), 16, MBH, MBW, extra=lr_t)
    return dict(jenc=jenc, tenc=tenc, yuv_j=(y, u, v), yuv_t=(yt, ut, vt),
                packed_j=np.asarray(packed_j), packed_t=packed_t.numpy(),
                res_j=res_j, res_t=res_t, qp=qp, qpc=qpc)


def test_packed_stage1_equal(stage1):
    pj, pt = stage1["packed_j"], stage1["packed_t"]
    assert pj.dtype == pt.dtype == np.float32 and pj.shape == pt.shape
    n = MBH * MBW
    assert pj.shape == (24 * n + 2,)
    np.testing.assert_array_equal(pj.view(np.int32), pt.view(np.int32))
    assert (pj[20 * n:24 * n] >= 1).all()          # rho is a cost


def test_pass1_res_equal(stage1):
    for k in RES_KEYS:
        np.testing.assert_array_equal(np.asarray(stage1["res_j"][k]),
                                      stage1["res_t"][k].numpy(), err_msg=k)


def test_incremental_reencode_equal(stage1):
    n = MBH * MBW
    pj = stage1["packed_j"]
    mv8 = pj[n:9 * n].astype(np.int32).reshape(2 * MBH, 2 * MBW, 2)
    skip1 = pj[11 * n:12 * n].astype(bool).reshape(MBH, MBW)
    final8 = mv8.copy()
    r = np.random.RandomState(0)
    for _ in range(4):
        gy, gx = r.randint(0, 2 * MBH), r.randint(0, 2 * MBW)
        final8[gy, gx] += (1, 0)
    skip = skip1.copy()
    skip[0, 0] = not skip[0, 0]
    idx, fz = JINC.changed_mbs(mv8, final8, skip1, skip, MBH, MBW)
    assert 0 < len(idx) <= n // 4
    idx_p, fz_p, cap = JINC.pad_subset(idx, fz, n)
    tidx, tfz, tcap = TINC.pad_subset(idx, fz, n)
    assert cap == tcap and (idx_p == tidx).all()
    jenc, tenc = stage1["jenc"], stage1["tenc"]
    y, u, v = stage1["yuv_j"]
    want = JINC.reencode_p_incremental(
        stage1["res_j"], y, u, v, jenc.ref["luma"], jenc.ref["u"],
        jenc.ref["v"], jnp.asarray(final8), jnp.asarray(idx_p),
        jnp.asarray(fz_p), stage1["qp"], stage1["qpc"], MBH, MBW, cap)
    yt, ut, vt = stage1["yuv_t"]
    got = TINC.reencode_p_incremental(
        stage1["res_t"], yt, ut, vt, tenc.ref["luma"], tenc.ref["u"],
        tenc.ref["v"], torch.as_tensor(final8), torch.as_tensor(tidx),
        torch.as_tensor(tfz), stage1["qp"], stage1["qpc"], MBH, MBW)
    for k in RES_KEYS:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)


def test_lean_pack_equal(stage1):
    n = MBH * MBW
    res_j = dict(stage1["res_j"])
    res_t = dict(stage1["res_t"])
    # push some levels past int8 so the exception list is exercised
    big = np.zeros((MBH, MBW, 256), np.int16)
    big[1, 2, 5], big[3, 4, 0], big[0, 6, 255] = 300, -200, 128
    res_j["luma_lev"] = res_j["luma_lev"] + jnp.asarray(big)
    res_t["luma_lev"] = res_t["luma_lev"] + torch.as_tensor(big)
    lev_in = {k: res_j[k] for k in ("luma_lev", "chroma_dc", "chroma_ac",
                                    "cbp_luma", "cbp_chroma")}
    want = np.asarray(JCORE._pack_frame_lean(lev_in, n, False))
    got = TCORE._pack_frame_lean(res_t, n).numpy()
    np.testing.assert_array_equal(want, got)
    dj = JCORE._unpack_frame_lean(want, MBH, MBW, False)
    dt = TCORE._unpack_frame_lean(got, MBH, MBW)
    for k, a in dj.items():
        np.testing.assert_array_equal(a, dt[k], err_msg=k)


# ---------------------------------------------------------------------------
# The accelerator branch (tail_kernel=True), at the same 112x80 size, so
# that its reference encoder reuses the compiled programs of the one above
# ---------------------------------------------------------------------------

def _accel_reference(y, u, v, ref, prev_mv, qp, qpc, lam, cost_mv, extra):
    """The reference's TPU branch of p_stage1_stego
    (encoder/partition.py:1448-1504), composed with B1's Pallas kernel
    in interpret mode and the analyse tail's XLA twin (each compiled
    once a shape in this process: tests/test_torch_encoder_accel.py's
    `compiled` and `tail_xla`); the pass-1 encode
    keeps its levels (cbp_only=False) as the serving path's full_pass1
    does."""
    rng = 16
    st = fullpel_interpret(y, ref["luma"][0], rng, MBH, MBW, lam)
    part, mvfp8 = JPT.decide_partition.__wrapped__(st, MBH, MBW, lam)
    windows = JPT.gather_windows8_mm(ref["luma"].astype(jnp.uint8), mvfp8,
                                     MBH, MBW, rng).astype(jnp.uint8)
    mv8, _r, SK, SP, sc8 = tail_xla(
        y, windows, part, mvfp8, prev_mv, lam, qp, MBH, MBW, decimate=True)
    res = JINTER.encode_p_frame_device8.__wrapped__(
        y, u, v, ref["luma"], ref["u"], ref["v"], mv8, qp, qpc, MBH, MBW,
        True, None, False, None, cbp_only=False, mv_bound=rng + 2)
    cbp_l = res["cbp_luma"].astype(jnp.int32)
    cbp_c = res["cbp_chroma"].astype(jnp.int32)
    skip, _mvd, mvp_u, _ = _scan_p_device(part, mv8, cbp_l, cbp_c, MBH, MBW)
    rho, alt, _valid = JPT.probe_combine(SK, SP, sc8, part, mv8, mvp_u,
                                         cost_mv, MBH, MBW, True)
    packed = jnp.concatenate([a.reshape(-1).astype(jnp.float32) for a in (
        part, mv8, cbp_l, cbp_c, skip, alt, rho, extra)])
    return np.asarray(packed), res


@pytest.fixture(scope="module")
def stage1_accel():
    """Both packed arrays and pass-1 results of the accelerator branch on
    frames 3 and 4 of a synthetic sequence, each from the reference
    encoder's state after the frames before it."""
    frames = synthetic_sequence(W, H, 5, seed=7)
    jenc = JEncoder(_params(size=(W, H)))
    for f in frames[:3]:
        jenc.encode_frame(f)
    out = []
    qp = 26
    qpc, lam = chroma_qp(qp), lambda_tab(qp)
    cmv = cost_mv_table(lam)
    for f in frames[3:]:
        tenc = TEncoder(_tparams(True, size=(W, H)), device="cpu")
        tenc.load_state(from_reference(jenc))
        y, u, v = jenc._pad(f)
        lr_j = JST.lowres_costs(JST.lowres(y), jenc.lookahead.prev_lr, MBH,
                                MBW, rng=8)
        packed_j, res_j = _accel_reference(
            y, u, v, jenc.ref, jnp.asarray(jenc.prev_mv), qp, qpc, lam,
            jnp.asarray(cmv), lr_j)
        yt, ut, vt = tenc._pad(f)
        lr_t = TST.lowres_costs(TST.lowres(yt), tenc.lookahead.prev_lr, MBH,
                                MBW, rng=8)
        packed_t, res_t = TPT.p_stage1_stego(
            yt, ut, vt, tenc.ref["luma"], tenc.ref["u"], tenc.ref["v"],
            torch.as_tensor(tenc.prev_mv), qp, qpc, lam,
            torch.as_tensor(cmv), 16, MBH, MBW, extra=lr_t,
            tail_kernel=True)
        out.append((packed_j, packed_t.numpy(), res_j, res_t))
        jenc.encode_frame(f)
    return out


@pytest.mark.parametrize("frame", [0, 1], ids=["p3", "p4"])
def test_accel_packed_stage1_equal(stage1_accel, frame):
    pj, pt, _, _ = stage1_accel[frame]
    n = MBH * MBW
    assert pj.shape == pt.shape == (24 * n + 2,)
    np.testing.assert_array_equal(pj.view(np.int32), pt.view(np.int32))


@pytest.mark.parametrize("frame", [0, 1], ids=["p3", "p4"])
def test_accel_pass1_res_equal(stage1_accel, frame):
    _, _, res_j, res_t = stage1_accel[frame]
    for k in RES_KEYS:
        np.testing.assert_array_equal(np.asarray(res_j[k]), res_t[k].numpy(),
                                      err_msg=k)
