"""Kernel B5's plain version and its parameter precompute vs the
reference, exact: `edge_params` against deblock_pallas.edge_params; the
plain deblocker against deblock_jax.deblock_frame_device, against the
Pallas kernel body (`_run` in interpret mode) and against the native C++
filter. The CUDA kernel is held against the plain version in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu import native
from video_steganography_pcamv_tpu.ops import deblock_jax as DJ
from video_steganography_pcamv_tpu.ops import deblock_pallas as DP
from video_steganography_pcamv_tpu.ops.transform import chroma_qp

from video_steganography_pcamv_torch.ops import deblock as DB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed, mbh, mbw):
    """Low-amplitude structure so nearly every edge filter fires, plus
    fuzzed intra/skip/nnz/mv maps (all edge types and bS values)."""
    g = np.random.default_rng(seed)
    H, W = 16 * mbh, 16 * mbw
    base = g.integers(60, 180, (mbh, mbw))
    y = np.clip(np.repeat(np.repeat(base, 16, 0), 16, 1)
                + g.integers(-24, 25, (H, W)), 0, 255)
    u = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    v = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    intra = (g.random((mbh, mbw)) < 0.15).astype(np.int32)
    skip = ((g.random((mbh, mbw)) < 0.2) & (intra == 0)).astype(np.int32)
    nnz4 = (g.random((4 * mbh, 4 * mbw)) < 0.5).astype(np.int32) \
        * g.integers(1, 4, (4 * mbh, 4 * mbw)).astype(np.int32)
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2)).astype(np.int32)
    mv4 = np.repeat(np.repeat(mv4[::2, ::2], 2, 0), 2, 1)
    return [np.ascontiguousarray(a, np.int32)
            for a in (y, u, v, intra, skip, nnz4, mv4)]


CASES = [(26, 4, 6, 0, 0), (40, 3, 7, 0, 0), (14, 3, 5, 0, 0),
         (32, 4, 5, 4, -2)]


@pytest.mark.parametrize("qp,mbh,mbw,off_a,off_b", CASES)
def test_edge_params_match_reference(qp, mbh, mbw, off_a, off_b):
    f = _frame(qp, mbh, mbw)
    qpc = chroma_qp(qp)
    want = DP.edge_params(*(jnp.asarray(a) for a in f[3:]), qp, qpc, mbh,
                          mbw, qp_thresh=15 - min(off_a, off_b),
                          off_a=off_a, off_b=off_b)
    got = DB.edge_params(*(torch.as_tensor(a) for a in f[3:]), qp, qpc,
                         mbh, mbw, qp_thresh=15 - min(off_a, off_b),
                         off_a=off_a, off_b=off_b)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("qp,mbh,mbw,off_a,off_b", CASES)
def test_plain_b5_matches_wavefront_and_native(qp, mbh, mbw, off_a, off_b):
    f = _frame(qp + 1, mbh, mbw)
    qpc = chroma_qp(qp)
    thresh = 15 - min(off_a, off_b)
    got = DB.deblock_frame(*(torch.as_tensor(a) for a in f), qp, qpc, mbh,
                           mbw, qp_thresh=thresh, off_a=off_a, off_b=off_b)
    want = DJ.deblock_frame_device(*(jnp.asarray(a) for a in f), qp, qpc,
                                   mbh, mbw, qp_thresh=thresh, off_a=off_a,
                                   off_b=off_b)
    planes = [np.ascontiguousarray(a, np.uint8) for a in f[:3]]
    native.deblock_frame(*planes, f[3].astype(np.uint8), f[5], f[6],
                         f[4].astype(np.uint8), qp, qpc,
                         alpha_off=off_a, beta_off=off_b)
    for name, t, j, nat in zip("yuv", got, want, planes):
        assert t.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                      err_msg="vs jax, plane " + name)
        np.testing.assert_array_equal(nat, t.numpy(),
                                      err_msg="vs native, plane " + name)


def test_plain_b5_matches_pallas_interpret():
    qp, mbh, mbw = 30, 3, 4
    f = _frame(5, mbh, mbw)
    qpc = chroma_qp(qp)
    par_j = DP.edge_params(*(jnp.asarray(a) for a in f[3:]), qp, qpc,
                           mbh, mbw)
    n_mb = mbh * mbw
    par_j = jnp.pad(par_j, ((0, -n_mb % 16), (0, 0)))
    H, W, Hc, Wc = 16 * mbh, 16 * mbw, 8 * mbh, 8 * mbw
    pad = DP.PAD
    Hp, Wp = H + 32, max(-(-(W + pad) // 128) * 128,
                         (16 * (mbw - 1)) // 128 * 128 + 256)
    Hpc, Wpc = Hc + 16, max(-(-(Wc + pad) // 128) * 128,
                            (8 * (mbw - 1)) // 128 * 128 + 256)

    def place(a, h, w):
        out = np.zeros((h, w), np.int32)
        out[pad:pad + a.shape[0], pad:pad + a.shape[1]] = a
        return jnp.asarray(out)

    yo, uo, vo = DP._run(place(f[0], Hp, Wp), place(f[1], Hpc, Wpc),
                         place(f[2], Hpc, Wpc), par_j, mbh, mbw,
                         interpret=True)
    want = [np.asarray(yo)[pad:pad + H, pad:pad + W],
            np.asarray(uo)[pad:pad + Hc, pad:pad + Wc],
            np.asarray(vo)[pad:pad + Hc, pad:pad + Wc]]
    par_t = DB.edge_params(*(torch.as_tensor(a) for a in f[3:]), qp, qpc,
                           mbh, mbw)
    got = DB.deblock_frame_plain(*(torch.as_tensor(a) for a in f[:3]),
                                 par_t, mbh, mbw)
    for name, w_, g_ in zip("yuv", want, got):
        np.testing.assert_array_equal(w_, g_.numpy(), err_msg=name)


@pytest.mark.parametrize("qp,mbh,mbw,off_a,off_b", CASES[:2])
def test_edge_params_with_ref4_match_reference(qp, mbh, mbw, off_a, off_b):
    """Per-4x4 reference indices (the decoder's multi-reference P
    streams): blocks that differ in ref4 get bS 1, as in the reference's
    edge_params and its native deblocker."""
    f = _frame(qp + 2, mbh, mbw)
    f[6][:] = 0             # one motion field: bS 1 comes from ref4 alone
    qpc = chroma_qp(qp)
    ref4 = np.random.default_rng(qp).integers(0, 3, (mbh, mbw, 2, 2))
    ref4 = np.ascontiguousarray(np.repeat(np.repeat(
        ref4.transpose(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw), 2, 0), 2, 1),
        np.int32)
    thresh = 15 - min(off_a, off_b)
    want = DP.edge_params(*(jnp.asarray(a) for a in f[3:]), qp, qpc, mbh,
                          mbw, ref4=jnp.asarray(ref4), qp_thresh=thresh,
                          off_a=off_a, off_b=off_b)
    par = DB.edge_params(*(torch.as_tensor(a) for a in f[3:]), qp, qpc,
                         mbh, mbw, qp_thresh=thresh, off_a=off_a,
                         off_b=off_b, ref4=torch.as_tensor(ref4))
    np.testing.assert_array_equal(np.asarray(want), par.numpy())
    got = DB.deblock_frame_plain(*(torch.as_tensor(a) for a in f[:3]), par,
                                 mbh, mbw)
    planes = [np.ascontiguousarray(a, np.uint8) for a in f[:3]]
    native.deblock_frame(*planes, f[3].astype(np.uint8), f[5], f[6],
                         f[4].astype(np.uint8), qp, qpc, ref4=ref4,
                         alpha_off=off_a, beta_off=off_b)
    for name, t, nat in zip("yuv", got, planes):
        np.testing.assert_array_equal(nat, t.numpy(), err_msg=name)
