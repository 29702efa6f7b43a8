"""Time the pieces of the PyTorch port's in-loop deblock stage at 1080p
on the card.

    python3 tools/torch_deblock_split.py [--root CHECKOUT]

Imports the port (`video_steganography_pcamv_torch`) from CHECKOUT
(default: this checkout) and builds one 1080p frame: uint8 recon planes
with MB-level steps and noise, fuzzed intra/skip/nnz/mv maps at qp 26.
Each piece is timed with CUDA events around it alone, median of 20
calls, on fresh inputs each call.

- A deblocker that takes int32 planes and precomputed `edge_params`
  rows (`deblock_frame_cuda(y, u, v, par, mbh, mbw)`, one launch per
  knight wave): the int32 casts of the recon planes that the encoder
  did before the call, `edge_params`, the zero-border pads, the kernel's
  wave launches and the uint8 slices, then the whole stage.
- The one-launch deblocker (`deblock_frame` on uint8 planes, edge
  parameters in the kernel): `edge_params` alone, for scale, and the
  whole call.
"""

import argparse
import inspect
import os
import sys

import numpy as np
import torch

MBH, MBW = 68, 120


def timed(fn, prepare=lambda: None, reps: int = 20) -> float:
    """Median ms of fn(prepare()) over reps, CUDA events around fn."""
    fn(prepare())
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        arg = prepare()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def frame(dev):
    g = np.random.default_rng(26)
    H, W = 16 * MBH, 16 * MBW
    base = g.integers(60, 180, (MBH, MBW))
    y = np.clip(np.repeat(np.repeat(base, 16, 0), 16, 1)
                + g.integers(-24, 25, (H, W)), 0, 255)
    u = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    v = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    intra = (g.random((MBH, MBW)) < 0.15).astype(np.int32)
    skip = ((g.random((MBH, MBW)) < 0.2) & (intra == 0)).astype(np.int32)
    nnz4 = (g.random((4 * MBH, 4 * MBW)) < 0.5).astype(np.int32)
    mv4 = g.integers(-20, 21, (4 * MBH, 4 * MBW, 2)).astype(np.int32)
    planes = [torch.as_tensor(a.astype(np.uint8), device=dev)
              for a in (y, u, v)]
    maps = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (intra, skip, nnz4, mv4)]
    return planes, maps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.ops import deblock as DB
    dev = torch.device("cuda", 0)
    kernels.load()
    planes, maps = frame(dev)
    qp, qpc = 26, 26
    pad = torch.nn.functional.pad
    ms = {}
    ms["edge_params"] = timed(lambda _: DB.edge_params(*maps, qp, qpc, MBH,
                                                       MBW))
    old_api = len(inspect.signature(DB.deblock_frame_cuda).parameters) == 6
    if old_api:
        P = DB.PAD
        par = DB.edge_params(*maps, qp, qpc, MBH, MBW)
        i32 = [p.to(torch.int32) for p in planes]
        ms["int32 casts"] = timed(lambda _: [p.to(torch.int32)
                                             for p in planes])
        ms["pads"] = timed(lambda _: [pad(p, (P,) * 4).contiguous()
                                      for p in i32])
        fn = kernels.entry("pcamv_deblock_frame",
                           [kernels.VP] * 4 + [kernels.CI] * 2
                           + [kernels.VP])

        def kernel(padded):
            kernels.check(fn(*(kernels.ptr(t) for t in padded),
                             kernels.ptr(par), MBH, MBW,
                             kernels.stream(par)), "pcamv_deblock_frame")
        ms["kernel (wave launches)"] = timed(
            kernel, lambda: [pad(p, (P,) * 4).contiguous() for p in i32])
        H, W = 16 * MBH, 16 * MBW
        padded = [pad(p, (P,) * 4).contiguous() for p in i32]
        ms["uint8 slices"] = timed(lambda _: (
            padded[0][P:P + H, P:P + W].to(torch.uint8),
            padded[1][P:P + H // 2, P:P + W // 2].to(torch.uint8),
            padded[2][P:P + H // 2, P:P + W // 2].to(torch.uint8)))
        ms["whole stage"] = timed(lambda _: DB.deblock_frame(
            *[p.to(torch.int32) for p in planes], *maps, qp, qpc, MBH, MBW))
    else:
        ms["whole call"] = timed(lambda _: DB.deblock_frame(
            *planes, *maps, qp, qpc, MBH, MBW))
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print("deblock stage pieces at 1080p, ms (median of 20), %s  [%s]"
          % ("wave-per-launch deblocker" if old_api
             else "one-launch deblocker", card))
    for k, v in ms.items():
        print("  %-24s %.4f" % (k, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
