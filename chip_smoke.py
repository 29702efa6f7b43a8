"""On-card smoke test of the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card name + power limit, kernel build (nvcc, sm_90a) and its time;
  2. kernel B1 (full-pel partition search) against its plain version at
     1080p shapes, random and zero predictor: array-equal, both timed;
  3. kernel B5 (deblock) against its plain version at 1080p with fuzzed
     intra/skip/nnz/mv maps at qp 26 and 40: array-equal, both timed;
  4. 112x80 six-frame encode on cuda and on cpu: byte-equal streams that
     the reference decoder decodes and the reference extractor reads;
  5. the serving main path at 1920x1088 (bench.py's Params), ten frames
     plus flush: payload recovered, both kernels launched, fps printed.
The line before the last holds the per-kernel JSON record; the last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MBH, MBW = 68, 120          # 1920x1088


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over reps, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs(a: dict, b: dict) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max()) for k in a)


def phase_b1(dev):
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    rs = np.random.RandomState(11)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    ref = mc.pad_plane(torch.as_tensor(fr[0].y.astype(np.int32), device=dev))
    rng, lam = 16, 4
    worst = 0
    preds = {"random": rs.randint(-12, 13, (MBH, MBW, 2)),
             "zero": np.zeros((MBH, MBW, 2))}
    for name, pr in preds.items():
        pred = torch.as_tensor(pr.astype(np.int32), device=dev)
        got = FP.fullpel_parts(cur, ref, pred, rng, MBH, MBW, lam)
        want = FP.fullpel_search_parts(cur, ref, pred, rng, MBH, MBW, lam)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if err != 0 or any(not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("B1 kernel != plain (%s predictor), max "
                                 "abs err %d" % (name, err))
        worst = max(worst, err)
        log("B1 %s predictor: kernel == plain at %dx%d MBs, rng %d"
            % (name, MBH, MBW, rng))
    ms = cuda_ms(lambda: FP.fullpel_parts(cur, ref, pred, rng, MBH, MBW,
                                          lam), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: FP.fullpel_search_parts(
        cur, ref, pred, rng, MBH, MBW, lam), reps=3)
    log("B1 time: kernel %.3f ms, plain %.3f ms (median, 1080p)"
        % (ms, plain_ms))
    return {"name": "fullpel_parts", "route": "cuda",
            "source": "video_steganography_pcamv_torch/csrc/fullpel.cu",
            "replaces": "video_steganography_pcamv_tpu/ops/"
                        "pallas_kernels.py:435",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_b5(dev):
    from video_steganography_pcamv_torch.ops import deblock as DB
    H, W = 16 * MBH, 16 * MBW
    worst = 0
    ms = plain_ms = None
    for qp in (26, 40):
        g = np.random.default_rng(qp)
        base = g.integers(60, 180, (MBH, MBW))
        y = np.clip(np.repeat(np.repeat(base, 16, 0), 16, 1)
                    + g.integers(-24, 25, (H, W)), 0, 255)
        u = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
        v = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
        intra = (g.random((MBH, MBW)) < 0.15).astype(np.int32)
        skip = ((g.random((MBH, MBW)) < 0.2) & (intra == 0)).astype(np.int32)
        nnz4 = (g.random((4 * MBH, 4 * MBW)) < 0.5).astype(np.int32)
        mv4 = g.integers(-20, 21, (4 * MBH, 4 * MBW, 2)).astype(np.int32)
        mv4 = np.repeat(np.repeat(mv4[::2, ::2], 2, 0), 2, 1)
        t = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
             for a in (y, u, v, intra, skip, nnz4, mv4)]
        qpc = min(qp, 39)
        par = DB.edge_params(t[3], t[4], t[5], t[6], qp, qpc, MBH, MBW)
        got = DB.deblock_frame_cuda(t[0], t[1], t[2], par, MBH, MBW)
        want = DB.deblock_frame_plain(t[0], t[1], t[2], par, MBH, MBW)
        torch.cuda.synchronize()
        for a, b, name in zip(got, want, "yuv"):
            err = int((a.long() - b.long()).abs().max())
            worst = max(worst, err)
            if not torch.equal(a, b):
                raise AssertionError("B5 kernel != plain, plane %s qp %d, "
                                     "max abs err %d" % (name, qp, err))
        log("B5 qp %d: kernel == plain at %dx%d MBs" % (qp, MBH, MBW))
        ms = cuda_ms(lambda: DB.deblock_frame_cuda(t[0], t[1], t[2], par,
                                                   MBH, MBW), 20, 3)
        plain_ms = cuda_ms(lambda: DB.deblock_frame_plain(
            t[0], t[1], t[2], par, MBH, MBW), 3)
        log("B5 qp %d time: kernel %.3f ms, plain %.3f ms (median, 1080p)"
            % (qp, ms, plain_ms))
    return {"name": "deblock_frame", "route": "cuda",
            "source": "video_steganography_pcamv_torch/csrc/deblock.cu",
            "replaces": "video_steganography_pcamv_tpu/ops/"
                        "deblock_pallas.py:469",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _params(w, h, me_range):
    from video_steganography_pcamv_tpu.params import Params, StegoParams
    p = Params(width=w, height=h, qp=26, me_range=me_range,
               deblock_device=True, psnr=False,
               stego=StegoParams(em_rate=64, key=99))
    p.tail_kernel = False
    p.pipeline_deep = False
    return p


def _encode(p, frames, device):
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(p, device=device)
    bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    return enc, bs


def _check_payload(bs, enc, n_frames):
    from video_steganography_pcamv_tpu.decoder import decode_annexb
    from video_steganography_pcamv_tpu.stego.extract import (
        extract_from_stream)
    dec = decode_annexb(bs)
    if len(dec) != n_frames:
        raise AssertionError("decoded %d frames of %d" % (len(dec), n_frames))
    got = extract_from_stream(bs, em_rate=64, key=99)
    sent = enc._stego.sent_messages
    if len(got) != len(sent) or not all(
            np.array_equal(a, b) for a, b in zip(got, sent)):
        raise AssertionError("extracted payload != sent payload")
    return sum(len(s) for s in sent)


def phase_small(dev):
    from video_steganography_pcamv_tpu.utils.yuv import Frame
    W, H = 112, 80
    rng = np.random.RandomState(1)
    big = rng.randint(30, 226, ((H + 64) // 4, (W + 64) // 4))
    big = np.repeat(np.repeat(big, 4, 0), 4, 1).astype(np.uint8)
    frames = []
    for i in range(6):
        f = big[16 + i:16 + i + H, 16 + 2 * i:16 + 2 * i + W].copy()
        c = np.full((H // 2, W // 2), 120 + i, np.uint8)
        frames.append(Frame(f, c, c.copy()))
    enc_g, bs_g = _encode(_params(W, H, 16), frames, dev)
    _enc_c, bs_c = _encode(_params(W, H, 16), frames, "cpu")
    if bs_g != bs_c:
        raise AssertionError("112x80 stream: cuda (%d B) != cpu (%d B)"
                             % (len(bs_g), len(bs_c)))
    bits = _check_payload(bs_g, enc_g, len(frames))
    log("112x80 x6: cuda stream == cpu stream (%d bytes), %d payload bits "
        "recovered" % (len(bs_g), bits))


def phase_main(dev, card):
    from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
    from video_steganography_pcamv_torch.ops.deblock import deblock_frame
    from video_steganography_pcamv_torch.ops.fullpel import fullpel_parts
    frames = synthetic_sequence(1920, 1088, 10, seed=7)
    p = _params(1920, 1088, 16)
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(p, device=dev)
    fullpel_parts.launches = 0
    deblock_frame.launches = 0
    t0 = time.time()
    bs = enc.encode_frame(frames[0])
    torch.cuda.synchronize()
    t1 = time.time()
    for f in frames[1:]:
        bs += enc.encode_frame(f)
    bs += enc.flush()
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {"fullpel_parts": fullpel_parts.launches,
                "deblock_frame": deblock_frame.launches}
    n_p = enc.stats.p_frames
    if launches["fullpel_parts"] < n_p or n_p < 1:
        raise AssertionError("B1 launched %d times for %d P frames"
                             % (launches["fullpel_parts"], n_p))
    if launches["deblock_frame"] < len(frames):
        raise AssertionError("B5 launched %d times for %d frames"
                             % (launches["deblock_frame"], len(frames)))
    bits = _check_payload(bs, enc, len(frames))
    fps_p = (len(frames) - 1) / (t2 - t1)
    log("1080p main path: %d frames (%d I, %d P), %d bytes, %d payload "
        "bits recovered; IDR %.3f s; P frames %.4f fps incl. flush; "
        "all %.4f fps  [%s]" % (len(frames), enc.stats.i_frames, n_p,
                                len(bs), bits, t1 - t0, fps_p,
                                len(frames) / (t2 - t0), card))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from video_steganography_pcamv_torch import kernels
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log("python %s, torch %s, cuda %s" % (sys.version.split()[0],
                                          torch.__version__,
                                          torch.version.cuda))
    t0 = time.time()
    kernels.load()
    log("kernels built/loaded in %.1f s (nvcc %.1f s) -> %s"
        % (time.time() - t0, kernels.build_seconds or 0.0,
           os.path.relpath(kernels.lib_path())))
    recs = [phase_b1(dev), phase_b5(dev)]
    phase_small(dev)
    launches = phase_main(dev, card)
    for r in recs:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
