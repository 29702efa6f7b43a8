"""The analyse tail's rows built from the windows (B2 fused into B3/B4),
held bit for bit against B2's tables.

- `block_row8` with one offset per 8x8 (the gather the kernels' row
  builder mirrors) against the rows of `block_table8` / `wht8_table`;
- the plain `subpel` and `probe_maps`, which build only the rows they
  read through `window_rows`, against the same chain fed from the full
  tables (`window_rows` replaced by a table lookup), for two seeds and
  decimate on and off.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_torch.ops import probe as PR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MBH, MBW = 2, 3
N8 = 4 * MBH * MBW


def _windows(g):
    return torch.as_tensor(g.integers(0, 256, (N8, 4, 16, 16))
                           .astype(np.uint8))


def _index(oy, ox):
    return (oy + 6) * 13 + (ox + 6)


def table_rows(windows):
    """`window_rows` over the full B2 tables: every row is a lookup."""
    blocks8 = PR.block_table8(windows)
    wht8 = PR.wht8_table(blocks8)
    ar = torch.arange(windows.shape[0])

    def pick(table, oy, ox):
        i = _index(oy, ox)
        return table[i] if isinstance(i, int) else table[i.long(), ar]
    return (lambda oy, ox: pick(blocks8, oy, ox),
            lambda oy, ox: pick(wht8, oy, ox).to(torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_row_builder_matches_the_tables(seed):
    g = np.random.default_rng(seed)
    windows = _windows(g)
    blocks8 = PR.block_table8(windows)
    wht8 = PR.wht8_table(blocks8)
    ar = torch.arange(N8)
    for _ in range(4):
        oy = torch.as_tensor(g.integers(-6, 7, N8))
        ox = torch.as_tensor(g.integers(-6, 7, N8))
        i = _index(oy, ox)
        row = PR.block_row8(windows, oy, ox)
        assert row.dtype == torch.uint8
        assert torch.equal(row, blocks8[i, ar])
        assert torch.equal(PR.wht8_flat(row), wht8[i, ar].to(torch.int32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("decimate", [True, False])
def test_windows_tail_equals_table_tail(seed, decimate, monkeypatch):
    g = np.random.default_rng(10 + seed)
    windows = _windows(g)
    cur = torch.as_tensor(g.integers(0, 256, (16 * MBH, 16 * MBW))
                          .astype(np.int32))
    part = torch.as_tensor(g.integers(0, 4, (MBH, MBW)).astype(np.int32))
    mvfp8 = torch.as_tensor(g.integers(-16, 17, (2 * MBH, 2 * MBW, 2))
                            .astype(np.int32))
    prev_mv = torch.as_tensor(g.integers(-40, 41, (MBH, MBW, 2))
                              .astype(np.int32))
    args = (cur, windows, part, mvfp8, prev_mv, 4, 26, MBH, MBW)
    got = PR.analyse_tail(*args, decimate=decimate)
    monkeypatch.setattr(PR, "window_rows", table_rows)
    want = PR.analyse_tail(*args, decimate=decimate)
    for name, a, b in zip(("mv8", "r_idx8", "SK", "SP", "sc8"), got, want):
        assert a.dtype == torch.int32, name
        assert torch.equal(a, b), name
