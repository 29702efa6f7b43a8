"""Card-only checks of the port (marked `cuda`; skipped without a GPU).

This file imports no jax, so on a GPU machine without jax it runs on
its own:  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
- kernel B1 vs its plain version (textured and flat content, random
  predictor);
- kernel B5 vs its plain version at qp 26 and 40;
- a small encode on cuda is byte-equal to the same encode on the cpu.
"""

import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.utils.yuv import Frame

from video_steganography_pcamv_torch import Encoder
from video_steganography_pcamv_torch.ops import deblock as DB
from video_steganography_pcamv_torch.ops import fullpel as FP
from video_steganography_pcamv_torch.ops import mc as TMC
from video_steganography_pcamv_torch.ops.transform import chroma_qp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("flat", [False, True])
def test_b1_kernel_matches_plain(dev, flat):
    mbh, mbw, rng, lam = 4, 6, 16, 4
    r = np.random.RandomState(2)
    h, w = 16 * mbh, 16 * mbw
    ref = r.randint(0, 256, (h, w)).astype(np.int32)
    cur = np.roll(ref, (2, -3), (0, 1))
    if flat:
        ref[:] = 100
        cur[:] = 101
    pred = r.randint(-9, 10, (mbh, mbw, 2)).astype(np.int32)
    args = [torch.as_tensor(cur, device=dev),
            TMC.pad_plane(torch.as_tensor(ref, device=dev)),
            torch.as_tensor(pred, device=dev)]
    got = FP.fullpel_parts(*args, rng, mbh, mbw, lam)
    want = FP.fullpel_search_parts(*args, rng, mbh, mbw, lam)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("qp", [26, 40])
def test_b5_kernel_matches_plain(dev, qp):
    mbh, mbw = 5, 9
    g = np.random.default_rng(qp)
    H, W = 16 * mbh, 16 * mbw
    planes = [np.clip(128 + g.integers(-24, 25, s), 0, 255)
              for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    intra = (g.random((mbh, mbw)) < 0.15)
    skip = (g.random((mbh, mbw)) < 0.2) & ~intra
    nnz4 = g.random((4 * mbh, 4 * mbw)) < 0.5
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2))
    t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
         for a in planes + [intra, skip, nnz4, mv4]]
    par = DB.edge_params(*t[3:], qp, chroma_qp(qp), mbh, mbw)
    got = DB.deblock_frame_cuda(*t[:3], par, mbh, mbw)
    want = DB.deblock_frame_plain(*t[:3], par, mbh, mbw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cuda_stream_equals_cpu_stream(dev):
    W, H = 64, 48
    r = np.random.RandomState(4)
    big = np.repeat(np.repeat(r.randint(30, 226, (30, 40)), 4, 0), 4, 1)
    frames = [Frame(big[i:i + H, 2 * i:2 * i + W].astype(np.uint8),
                    np.full((H // 2, W // 2), 120, np.uint8),
                    np.full((H // 2, W // 2), 130, np.uint8))
              for i in range(4)]

    def run(device):
        p = Params(width=W, height=H, qp=26, me_range=16,
                   deblock_device=True, psnr=False,
                   stego=StegoParams(em_rate=16, key=5))
        enc = Encoder(p, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()

    assert run(dev) == run("cpu")
