"""B9 and B10 on the CPU, exact against the JAX package.

B9 (`partition.gather_windows8`): its plain version, the CPU path,
equals the reference's `gather_windows8_jnp` and its Pallas kernel
`gather_windows8_banked` in interpret mode, at the extreme MVs the
encoder admits (+-rng at the four frame corners, rng 16 and 20).

B10 (`slicetype.lowres_costs_kernel`): its plain wrapper equals the
reference's `lowres_costs_pallas` with B1 (`fullpel_parts_pallas`) in
interpret mode, on a lowres plane whose size is not a multiple of 16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.encoder import slicetype as JST
from video_steganography_pcamv_tpu.ops import pallas_kernels

from video_steganography_pcamv_torch.encoder import partition as TPT
from video_steganography_pcamv_torch.encoder import slicetype as TST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW = 3, 4


def _corner_mvs(rng: int, sx: int, sy: int, seed: int):
    g = np.random.RandomState(seed)
    mv = g.randint(-rng, rng + 1, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    for by, bx in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        mv[by, bx] = (sx * rng, sy * rng)
    return mv


@pytest.mark.parametrize("rng", [16, 20])
def test_b9_plain_equals_reference_at_corner_mvs(rng):
    g = np.random.RandomState(rng)
    planes = g.randint(0, 256, (4, 16 * MBH + 48, 16 * MBW + 48)) \
        .astype(np.uint8)
    tplanes = torch.as_tensor(planes)
    for k, (sx, sy) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
        mv = _corner_mvs(rng, sx, sy, 10 * rng + k)
        got = TPT.gather_windows8(tplanes, torch.as_tensor(mv), MBH, MBW)
        plain = TPT.gather_windows8_plain(tplanes, torch.as_tensor(mv), MBH,
                                          MBW)
        assert got.dtype == torch.uint8 and got.shape == (4 * MBH * MBW, 4,
                                                         16, 16)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        want = JPT.gather_windows8_jnp(jnp.asarray(planes), jnp.asarray(mv),
                                       MBH, MBW)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        banked = pallas_kernels.gather_windows8_banked(
            jnp.asarray(planes), jnp.asarray(mv), MBH, MBW, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(banked))
    # the kernel's input contract, held on the CPU path too
    with pytest.raises(TypeError, match="uint8"):
        TPT.gather_windows8(tplanes.to(torch.int32), torch.as_tensor(mv),
                            MBH, MBW)


def test_b10_plain_equals_reference(monkeypatch):
    calls = {"n": 0}
    orig = pallas_kernels.fullpel_parts_pallas

    class _Fullpel:
        @staticmethod
        def __wrapped__(*args, **kw):
            calls["n"] += 1
            return orig.__wrapped__(*args, interpret=True, **kw)

    monkeypatch.setattr(pallas_kernels, "fullpel_parts_pallas", _Fullpel())
    bh, bw, rng = 5, 7, 8                      # 40x56: padded to 48x64
    g = np.random.RandomState(3)
    ref = g.randint(20, 236, (8 * bh, 8 * bw)).astype(np.int32)
    cur = np.roll(ref, (2, -3), (0, 1)) + g.randint(-4, 5, ref.shape)
    cur[:8, :8] = 128                           # an intra-cheaper block
    want = jax.jit(JST.lowres_costs_pallas.__wrapped__,
                   static_argnums=(2, 3, 4))(jnp.asarray(cur),
                                             jnp.asarray(ref), bh, bw, rng)
    assert calls["n"] == 1
    tc, tr = torch.as_tensor(cur), torch.as_tensor(ref)
    plain = TST.lowres_costs_kernel_plain(tc, tr, bh, bw, rng)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TST.lowres_costs_kernel(tc, tr, bh, bw, rng).numpy(), plain.numpy())
    # B10's MV cost differs from the lookahead's own `lowres_costs`
    assert int(plain[0]) == int(TST.lowres_costs(tc, tr, bh, bw, rng)[0])


def _pan_frames(n, w=64, h=48):
    """A smooth texture on a horizontal ramp panning 22 pels a frame:
    at me_range 24 the top-edge blocks pick vertical MVs of -24."""
    from video_steganography_pcamv_torch.utils.yuv import Frame
    g = np.random.RandomState(0)
    big = g.randint(20, 236, (h + 200, w + 200)).astype(np.int32)
    for _ in range(2):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(np.roll(big, 1, 0), 1, 1)) // 4
    xx = np.mgrid[0:h + 200, 0:w + 200][1]
    big = np.clip(xx * 2 % 256 + big // 8, 0, 255).astype(np.uint8)
    u = np.full((h // 2, w // 2), 128, np.uint8)
    return [Frame(np.ascontiguousarray(big[60:60 + h,
                                           100 + 22 * i:100 + 22 * i + w]),
                  u, u.copy()) for i in range(n)]


def test_me_range_past_pad_margin_is_refused(monkeypatch):
    """At me_range 24 (B1 admits up to PAD 24) an edge block's window
    leaves the padded planes: the plain gather reads wrapped or missing
    rows, B9 traps, and the reference's two branches read differently
    clamped samples. Shown with the refusal lifted; then the Encoder
    refuses me_range > PAD - MARGIN = 20 on every path."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import core as TCORE
    from video_steganography_pcamv_torch.params import Params, StegoParams

    def params(partitions=True, **kw):
        p = Params(width=64, height=48, qp=26, deblock_device=partitions,
                   partitions=partitions, psnr=False,
                   stego=StegoParams(em_rate=16, key=3), **kw)
        p.tail_kernel = False
        return p

    outside = []
    orig = TPT.gather_windows8

    def spy(planes, mvfp8, mbh, mbw):
        yy, xx = TPT.window8_index(mvfp8, mbh, mbw)
        hp, wp = planes.shape[1:]
        outside.append(bool((yy.min() < 0) | (yy.max() >= hp)
                            | (xx.min() < 0) | (xx.max() >= wp)))
        return orig(planes, mvfp8, mbh, mbw)

    with monkeypatch.context() as m:
        m.setattr(TPT, "gather_windows8", spy)
        m.setattr(TCORE, "check_slice", lambda p: None)
        enc = Encoder(params(me_range=24), device="cpu")
        for f in _pan_frames(5):
            enc.encode_frame(f)
    assert len(outside) == 4 and any(outside)

    for partitions in (True, False):
        with pytest.raises(NotImplementedError, match="me_range>20"):
            Encoder(params(partitions, me_range=24), device="cpu")
        Encoder(params(partitions, me_range=20), device="cpu")
