"""`b_adapt` 2's pieces against the JAX reference on seeded inputs:
`slicetype_path` (the B-placement DP) on random cost tables with ties,
`lowres_costs_window` on random lowres planes and
`Lookahead.decide_b_placement` over the same window. The end-to-end run
with b_adapt 2 (CAVLC, two references, a window longer than bframes + 1,
the flush's DP and the resume) is in `tests/test_torch_bframes.py`,
where it shares config 4's compiled JAX programs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import slicetype as JST
from video_steganography_pcamv_tpu.params import Params

from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.encoder import slicetype as TST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,n,bframes", [
    (0, 5, 2), (1, 12, 3), (2, 8, 1), (3, 12, 16)])
def test_slicetype_path_matches_reference(seed, n, bframes):
    """Integer-valued costs from a small range, so equal path sums (the
    ties of the strict <) are common."""
    g = np.random.default_rng(seed)
    for _ in range(20):
        costs = {}
        for j in range(n):
            for a in range(max(-1, j - 1 - bframes), j):
                costs[("P", j, a, -2)] = float(g.integers(1, 6))
                for i in range(a + 1, j):
                    costs[("B", i, a, j)] = float(g.integers(0, 4))
        assert TST.slicetype_path(costs, n, bframes) == \
            JST.slicetype_path(costs, n, bframes)


def _lowres_planes(seed, n, bh=3, bw=4):
    """Smooth random lowres planes, each the previous one shifted, with
    noise: the window search finds real minima."""
    g = np.random.default_rng(seed)
    big = np.repeat(np.repeat(g.integers(20, 236, (8 * bh // 2 + 8,
                                                   8 * bw // 2 + 8)), 2, 0),
                    2, 1)
    return [(big[k:k + 8 * bh, 2 * k:2 * k + 8 * bw]
             + g.integers(-6, 7, (8 * bh, 8 * bw))).clip(0, 255)
            .astype(np.int32) for k in range(n)]


def test_lowres_costs_window_matches_reference():
    planes = _lowres_planes(5, 5)
    triples = [(1, 0, 0, 0), (2, 0, 3, 1), (4, 1, 1, 0), (3, 2, 4, 1),
               (0, 4, 2, 1), (2, 2, 2, 0)]
    arr = np.array(triples, np.int32)
    want = JST.lowres_costs_window(
        jnp.stack([jnp.asarray(p) for p in planes]), *(jnp.asarray(arr[:, c])
                                                      for c in range(4)),
        3, 4, 4, len(triples))
    got = TST.lowres_costs_window(
        torch.stack([torch.as_tensor(p) for p in planes]), triples, 3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bframes", [1, 2])
def test_decide_b_placement_matches_reference(bframes):
    kw = dict(width=32, height=48, bframes=bframes, b_adapt=2,
              lookahead_me_range=4)
    planes = _lowres_planes(6 + bframes, 6, bh=3, bw=2)
    got = TST.Lookahead(TP.Params(**kw)).decide_b_placement(
        torch.as_tensor(planes[0]), [torch.as_tensor(p) for p in planes[1:]],
        bframes)
    want = JST.Lookahead(Params(**kw)).decide_b_placement(
        jnp.asarray(planes[0]), [jnp.asarray(p) for p in planes[1:]],
        bframes)
    assert got == want
