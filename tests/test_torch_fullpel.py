"""Kernel B1's plain version vs the JAX reference, exact.

- against `partition.fullpel_search_parts` with random predictors, on
  textured content and on flat content where many displacements tie
  (the first minimum in dy-outer, dx-inner order must win);
- against the Pallas kernel `fullpel_parts_pallas` in interpret mode
  with a zero predictor;
- the wrappers' input contract (int32 current frame, uint8 reference
  plane, rng <= PAD, costs below 2^20), which the CPU path holds as the
  kernels do.
The CUDA kernel is held against the plain version in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.ops import mc as JMC
from video_steganography_pcamv_tpu.ops.pallas_kernels import (
    fullpel_parts_pallas)

from video_steganography_pcamv_torch.ops import fullpel as FP
from video_steganography_pcamv_torch.ops import mc as TMC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = ("c16", "mv16", "c16x8", "mv16x8", "c8x16", "mv8x16", "c8", "mv8")


def _content(kind, seed, mbh, mbw):
    r = np.random.RandomState(seed)
    h, w = 16 * mbh, 16 * mbw
    if kind == "flat":
        ref = np.full((h, w), 100, np.int32)
        ref[r.randint(0, h, 6), r.randint(0, w, 6)] = 140
        cur = np.full((h, w), 101, np.int32)
    else:
        ref = r.randint(0, 256, (h, w)).astype(np.int32)
        cur = np.roll(np.roll(ref, 2, 0), -3, 1)
        cur = np.clip(cur + r.randint(-3, 4, cur.shape), 0, 255) \
            .astype(np.int32)
    return cur, ref


def _assert_st(jst, tst):
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(jst[k]),
                                      tst[k].cpu().numpy(), err_msg=k)


@pytest.mark.parametrize("kind,rng,lam", [("texture", 4, 4),
                                          ("flat", 4, 1),
                                          ("flat", 6, 0),
                                          ("texture", 8, 9)])
def test_plain_b1_matches_reference(kind, rng, lam):
    mbh, mbw = 3, 4
    cur, ref = _content(kind, rng + lam, mbh, mbw)
    pred = np.random.RandomState(rng).randint(
        -2 * rng, 2 * rng + 1, (mbh, mbw, 2)).astype(np.int32)
    jst = JPT.fullpel_search_parts(jnp.asarray(cur),
                                   JMC.pad_plane(jnp.asarray(ref)),
                                   jnp.asarray(pred), rng, mbh, mbw, lam)
    tst = FP.fullpel_parts(torch.as_tensor(cur),
                           TMC.pad_plane(torch.as_tensor(ref))
                           .to(torch.uint8),
                           torch.as_tensor(pred), rng, mbh, mbw, lam)
    _assert_st(jst, tst)


def test_plain_b1_matches_pallas_zero_predictor():
    mbh, mbw, rng, lam = 2, 3, 4, 4
    cur, ref = _content("texture", 5, mbh, mbw)
    jst = fullpel_parts_pallas(jnp.asarray(cur),
                               JMC.pad_plane(jnp.asarray(ref)), rng, mbh,
                               mbw, lam, interpret=True)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32)
    tst = FP.fullpel_search_parts(torch.as_tensor(cur),
                                  TMC.pad_plane(torch.as_tensor(ref)),
                                  zero, rng, mbh, mbw, lam)
    _assert_st(jst, tst)


def test_units_to_st_scan_order():
    rng = 3
    side = 2 * rng + 1
    idx = torch.arange(9, dtype=torch.int32).reshape(1, 1, 9) * 5
    cost = torch.arange(9, dtype=torch.int32).reshape(1, 1, 9)
    st = FP.units_to_st(cost, idx, rng)
    i = 5 * 5
    assert st["mv8"][0, 0, 0].tolist() == [i % side - rng, i // side - rng]
    assert st["c16"].item() == 0 and st["c8"][0, 0].tolist() == [5, 6, 7, 8]


def test_wrappers_hold_the_kernel_input_contract_on_cpu():
    mbh, mbw, rng = 2, 3, 4
    cur, ref = _content("texture", 1, mbh, mbw)
    tcur = torch.as_tensor(cur)
    ref32 = TMC.pad_plane(torch.as_tensor(ref))
    ref8 = ref32.to(torch.uint8)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32)
    _assert_st(FP.fullpel_search_parts(tcur, ref32, zero, rng, mbh, mbw, 4),
               FP.fullpel_parts(tcur, ref8, zero, rng, mbh, mbw, 4))
    for fn, args in ((FP.fullpel_parts, (zero,)), (FP.fullpel_search16, ())):
        with pytest.raises(TypeError, match="uint8"):
            fn(tcur, ref32, *args, rng, mbh, mbw, 4)
        with pytest.raises(TypeError, match="int32"):
            fn(tcur.to(torch.uint8), ref8, *args, rng, mbh, mbw, 4)
        with pytest.raises(ValueError, match="rng 25"):
            fn(tcur, ref8, *args, 25, mbh, mbw, 4)
        # the kernel's 32-bit (cost, scan index) key: costs below 2^20
        fn(tcur, ref8, *args, rng, mbh, mbw, FP.max_lam(rng))
        with pytest.raises(ValueError, match="lam"):
            fn(tcur, ref8, *args, rng, mbh, mbw, FP.max_lam(rng) + 1)
    assert 65280 + 2 * FP.max_lam(rng) * int(FP.bits_table(rng).max()) \
        < 1 << 20 <= 65280 + 2 * (FP.max_lam(rng) + 1) * int(
            FP.bits_table(rng).max())
