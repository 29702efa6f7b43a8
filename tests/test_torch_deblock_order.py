"""The order rule of the CUDA deblocker, held on its plain helper.

The knight rule: MB (mx, my) may run once row my-1 has finished
min(mx+2, mbw) MBs. Here `ops.deblock.filter_mbs` is driven one MB at a
time in random orders that keep that rule, and must give the knight-wave
result of `deblock_frame_plain` bit for bit. A lag of 1 (row my-1 only
min(mx+1, mbw) MBs ahead) lets MB (mx, my) run before MB (mx+1, my-1),
whose left edge writes the rows above it, and must change the frame on
some seed.

The CUDA kernel (csrc/deblock.cu) applies the rule at half-MB grain:
MB (mx, my)'s vertical edges right after MB (mx-1, my), its horizontal
edges once row my-1 has finished MB mx and the vertical edges of MB
mx+1. Driven by direction, that order must give the same frame, and
must not without the wait on MB (mx+1, my-1)'s vertical edges.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_torch.ops import deblock as DB
from video_steganography_pcamv_torch.ops.transform import chroma_qp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW = 6, 8
SEEDS = [0, 1, 2]


def _frame(seed):
    """MB-level steps plus noise in all three planes, fuzzed
    intra/skip/nnz/mv/trans8 maps, a qp in [24, 40], and the frame's
    edge_params rows."""
    g = np.random.default_rng(seed)
    H, W = 16 * MBH, 16 * MBW

    def plane(h, w, step):
        base = g.integers(60, 180, (h // step, w // step))
        return torch.as_tensor(np.clip(
            np.repeat(np.repeat(base, step, 0), step, 1)
            + g.integers(-12, 13, (h, w)), 0, 255).astype(np.uint8))

    planes = (plane(H, W, 16), plane(H // 2, W // 2, 8),
              plane(H // 2, W // 2, 8))
    intra = g.random((MBH, MBW)) < 0.2
    maps = [torch.as_tensor(a.astype(np.int32)) for a in (
        intra, (g.random((MBH, MBW)) < 0.2) & ~intra,
        g.random((4 * MBH, 4 * MBW)) < 0.5,
        g.integers(-12, 13, (4 * MBH, 4 * MBW, 2)))]
    t8 = torch.as_tensor((g.random((MBH, MBW)) < 0.5).astype(np.int32))
    qp = int(g.integers(24, 41))
    par = DB.edge_params(*maps, qp, chroma_qp(qp), MBH, MBW, trans8=t8)
    return planes, par


def _schedule(rng, lag: int, highest_first: bool):
    """(my, mx) one MB at a time: each row left to right, row my's next
    MB mx once row my-1 has finished min(mx + lag, MBW) MBs; among the
    rows that may go, a random one or the lowest in the frame."""
    done = [0] * MBH
    order = []
    while len(order) < MBH * MBW:
        ready = [my for my in range(MBH) if done[my] < MBW and (
            my == 0 or done[my - 1] >= min(done[my] + lag, MBW))]
        my = ready[-1] if highest_first else int(rng.choice(ready))
        order.append((my, done[my]))
        done[my] += 1
    return order


def _run(planes, par, order):
    padded = DB.pad_planes(*planes)
    for my, mx in order:
        DB.filter_mbs(padded, par, torch.tensor([my]), torch.tensor([mx]),
                      MBW)
    return DB.unpad_planes(padded, planes[0].shape, planes[1].shape)


@pytest.mark.parametrize("seed", SEEDS)
def test_any_knight_order_equals_the_waves(seed):
    planes, par = _frame(seed)
    want = DB.deblock_frame_plain(*planes, par, MBH, MBW)
    assert any(not torch.equal(a, b) for a, b in zip(want, planes))
    rng = np.random.default_rng(seed)
    for highest_first in (False, True):
        got = _run(planes, par, _schedule(rng, 2, highest_first))
        for name, a, b in zip("yuv", got, want):
            assert torch.equal(a, b), (name, highest_first)


def test_a_lag_of_one_breaks_the_order():
    differs = []
    for seed in SEEDS:
        planes, par = _frame(seed)
        want = DB.deblock_frame_plain(*planes, par, MBH, MBW)
        got = _run(planes, par, _schedule(None, 1, True))
        differs.append(any(not torch.equal(a, b) for a, b in zip(got, want)))
    assert any(differs), differs


def _half_schedule(rng, wait_left_edge: bool, highest_first: bool):
    """(my, mx, dir) steps in the kernel's order: per row V(0) H(0) V(1)
    H(1) ...; H(mx, my) once row my-1 has done H up to mx and (with
    `wait_left_edge`) V of mx+1."""
    vdone, hdone = [0] * MBH, [0] * MBH
    order = []

    def h_ready(my):
        mx = hdone[my]
        if my == 0:
            return True
        if hdone[my - 1] < mx + 1:
            return False
        return not wait_left_edge or vdone[my - 1] >= min(mx + 2, MBW)

    while len(order) < 2 * MBH * MBW:
        ready = []
        for my in range(MBH):
            if vdone[my] == hdone[my] < MBW:
                ready.append((my, 0))
            elif hdone[my] < vdone[my] and h_ready(my):
                ready.append((my, 1))
        my, d = ready[-1] if highest_first else \
            ready[int(rng.integers(len(ready)))]
        done = vdone if d == 0 else hdone
        order.append((my, done[my], d))
        done[my] += 1
    return order


def _run_half(planes, par, order):
    padded = DB.pad_planes(*planes)
    for my, mx, d in order:
        DB.filter_mbs(padded, par, torch.tensor([my]), torch.tensor([mx]),
                      MBW, dirs=(d,))
    return DB.unpad_planes(padded, planes[0].shape, planes[1].shape)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_kernels_half_mb_order_equals_the_waves(seed):
    planes, par = _frame(seed)
    want = DB.deblock_frame_plain(*planes, par, MBH, MBW)
    rng = np.random.default_rng(100 + seed)
    for highest_first in (False, True):
        got = _run_half(planes, par, _half_schedule(rng, True,
                                                    highest_first))
        for name, a, b in zip("yuv", got, want):
            assert torch.equal(a, b), (name, highest_first)


def test_skipping_the_left_edge_above_breaks_the_order():
    differs = []
    for seed in SEEDS:
        planes, par = _frame(seed)
        want = DB.deblock_frame_plain(*planes, par, MBH, MBW)
        got = _run_half(planes, par, _half_schedule(None, False, True))
        differs.append(any(not torch.equal(a, b) for a, b in zip(got, want)))
    assert any(differs), differs
