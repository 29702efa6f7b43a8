"""The 16x16-only path's B-frame host and device helpers
(`partitions=False`, x264's `--partitions none`) against the JAX
reference on seeded inputs: `bipred_satd_device`, and `scan_b_frame` at
one reference and at two, on spatial and on temporal direct. The
end-to-end runs and the 16x16 B analysis (`analyse_b_frame` against the
reference's `analyse_b_frame` and `analyse_b_frame_mref`) are where
their JAX programs are already compiled: one reference in
`tests/test_torch_encoder16.py` (CAVLC and CABAC, the native B writers),
two in `tests/test_torch_multiref.py` (the Python writers with
ref_idx_l0, the L0 merge with an entry past n_valid)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.encoder import bslice as JB

from video_steganography_pcamv_torch.encoder import bslice as TB

from test_torch_bframes import MBH, MBW, _col_field, _refs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_bipred_satd_device_matches_reference():
    (t0, _t1, t2), (j0, _j1, j2), cur = _refs(3, 70)
    g = np.random.default_rng(71)
    au = JB.approx_direct_fields(
        g.integers(-30, 31, (MBH, MBW, 2)).astype(np.int32),
        g.integers(-30, 31, (MBH, MBW, 2)).astype(np.int32),
        *_col_field(g, 1))
    got = TB.bipred_satd_device(torch.as_tensor(cur), t0["luma"],
                                t2["luma"], *(torch.as_tensor(a) for a in au),
                                MBH, MBW)
    want = JB.bipred_satd_device(jnp.asarray(cur), j0["luma"], j2["luma"],
                                 *(jnp.asarray(a) for a in au), MBH, MBW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_ref", [1, 2])
def test_scan_b_frame_matches_reference(num_ref):
    g = np.random.default_rng(80 + num_ref)
    c0, c1, cbi, c_dir = (g.integers(100, 200, (MBH, MBW)).astype(np.int32)
                          for _ in range(4))
    mv0 = g.integers(-12, 13, (MBH, MBW, 2)).astype(np.int32)
    mv1 = g.integers(-12, 13, (MBH, MBW, 2)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g, num_ref)
    ref0 = (g.integers(0, num_ref, (MBH, MBW)).astype(np.int32)
            if num_ref > 1 else None)
    got = TB.scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4, 4,
                          ref0=ref0)
    want = JB.scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4,
                           4, ref0=ref0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert set(np.unique(got[0])) == {0, 1, 2, 3}


@pytest.mark.parametrize("num_ref", [1, 2])
def test_scan_b_frame_temporal_matches_reference(num_ref):
    """The 16x16 commit on a temporal direct field (per-8x8 L0 refs from
    the colocated ones, each block its entry's DistScaleFactor) where
    every MB is direct-available; where one is not, the reference raises
    (ROADMAP F3, tests/test_torch_encoder16.py)."""
    g = np.random.default_rng(90 + num_ref)
    c0, c1, cbi, c_dir = (g.integers(100, 200, (MBH, MBW)).astype(np.int32)
                          for _ in range(4))
    mv0 = g.integers(-12, 13, (MBH, MBW, 2)).astype(np.int32)
    mv1 = g.integers(-12, 13, (MBH, MBW, 2)).astype(np.int32)
    col_mv4, col_ref4 = _col_field(g, num_ref)
    ref0 = (g.integers(0, num_ref, (MBH, MBW)).astype(np.int32)
            if num_ref > 1 else None)
    tdir = TB.temporal_direct_fields(
        col_mv4, col_ref4, np.array([180, 70][:num_ref], np.int64),
        col_map=np.arange(num_ref))
    assert tdir[0].all()
    got = TB.scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4, 4,
                          ref0=ref0, tdir=tdir)
    want = JB.scan_b_frame(c_dir, c0, c1, cbi, mv0, mv1, col_mv4, col_ref4,
                           4, ref0=ref0, tdir=tdir)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == 0).any()
