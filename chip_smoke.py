"""On-card smoke test of the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card name + power limit; the nvcc kernel build (one nvcc per CUDA
     source, all started together) and the g++ build of the port's
     native library, in parallel, with their times;
  2. kernel B1 (full-pel partition search) against its plain version at
     1080p shapes, random and zero predictor: array-equal, both timed;
  3. kernel B5 (deblock) against its plain version at 1080p with fuzzed
     intra/skip/nnz/mv maps at qp 26 and 40: array-equal, both timed;
  4. kernels B2 (qpel tables), B3 (subpel) and B4 (probe maps) against
     their plain versions at 1080p shapes on a real frame pair run
     through the accelerator branch's B1 + partition decision:
     array-equal, timed, beside their bounds;
  5. 112x80 six-frame encode on cuda and on cpu for both tail_kernel
     settings: byte-equal streams that the port's decoder decodes and
     the port's extractor reads;
  6. the main path at 1920x1088, bench.py's Params (tail_kernel=True, the
     reference's accelerator branch), ten frames plus flush: payload
     recovered, all five kernels launched, fps printed;
  7. the tail_kernel=False path (B1 against the predictor prev_mv >> 2)
     at 1920x1088, IDR + 3 P frames plus flush: payload recovered, all
     five kernels launched;
  8. per-stage times of a 1080p P frame on the tail_kernel=True path.
The line before the last two holds the per-kernel JSON record, then the
card line; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MBH, MBW = 68, 120          # 1920x1088
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 rate


def log(msg):
    print(msg, flush=True)


def card_query(fields: str) -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=" + fields,
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """Peak 32-bit integer rate: 132 SMs x 64 INT32 lanes x the SM clock
    (the maximum that nvidia-smi reports)."""
    mhz = float(card_query("clocks.max.sm").split()[0])
    return 132 * 64 * mhz * 1e6


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    integer operations over the int32 rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def max_abs(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def record(name, source, replaces, err, ms, plain_ms, bnd):
    return {"name": name, "route": "cuda",
            "source": "video_steganography_pcamv_torch/csrc/" + source,
            "replaces": "video_steganography_pcamv_tpu/" + replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def phase_build():
    from video_steganography_pcamv_torch import kernels, native
    t0 = time.time()
    errs = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # re-raised below
            errs.append(e)

    th = threading.Thread(target=run, args=(native.build,))
    th.start()
    run(kernels.load)
    th.join()
    if errs:
        raise errs[0]
    native.load()
    log("kernels built/loaded in %.1f s (nvcc %.1f s) -> %s; native g++ "
        "%.1f s" % (time.time() - t0, kernels.build_seconds or 0.0,
                    os.path.relpath(kernels.lib_path()),
                    native.build_seconds or 0.0))


def phase_b1(dev, int_rate):
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
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
        err = max_abs([got[k] for k in want], want.values())
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
    # bytes: cur, the padded reference, the predictor read once; 9
    # (cost, index) pairs written per MB. ops: per MB and displacement,
    # 256 abs-differences of 3 int ops (sub, abs, add)
    n = MBH * MBW
    nbytes = (cur.numel() + ref.numel() + 2 * n + 18 * n) * 4
    ops = n * (2 * rng + 1) ** 2 * 256 * 3
    bnd = bound(nbytes, ops, int_rate)
    log("B1 time: kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s) "
        "(median, 1080p)" % (ms, plain_ms, *bnd))
    return record("fullpel_parts", "fullpel.cu",
                  "ops/pallas_kernels.py:435", worst, ms, plain_ms, bnd)


def phase_b5(dev, int_rate):
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
        err = max_abs(got, want)
        worst = max(worst, err)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("B5 kernel != plain at qp %d, max abs err "
                                 "%d" % (qp, err))
        log("B5 qp %d: kernel == plain at %dx%d MBs" % (qp, MBH, MBW))
        ms = cuda_ms(lambda: DB.deblock_frame_cuda(t[0], t[1], t[2], par,
                                                   MBH, MBW), 20, 3)
        plain_ms = cuda_ms(lambda: DB.deblock_frame_plain(
            t[0], t[1], t[2], par, MBH, MBW), 3)
        log("B5 qp %d time: kernel %.3f ms, plain %.3f ms (median, 1080p)"
            % (qp, ms, plain_ms))
    # bytes: the three int32 planes read and written, the [n, 128] int32
    # parameter rows read. ops: per MB 8 luma edges x 16 lines and 2 x 4
    # chroma edges x 8 lines, ~30 int ops a filtered line
    n = MBH * MBW
    nbytes = 2 * 4 * (H * W + 2 * (H // 2) * (W // 2)) + n * 128 * 4
    ops = n * (8 * 16 + 2 * 4 * 8) * 30
    bnd = bound(nbytes, ops, int_rate)
    log("B5 bound %.4f ms (%s)" % bnd)
    return record("deblock_frame", "deblock.cu",
                  "ops/deblock_pallas.py:469", worst, ms, plain_ms, bnd)


def _tail_inputs(dev):
    """A real 1080p frame pair through the accelerator branch's head:
    B1 with a zero predictor, the partition decision, the windows."""
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder.me import lambda_tab
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    qp = 26
    lam = lambda_tab(qp)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                       device=dev), c, c)
    zero = torch.zeros((MBH, MBW, 2), dtype=torch.int32, device=dev)
    st = FP.fullpel_parts(cur, ref["luma"][0], zero, 16, MBH, MBW, lam)
    part, mvfp8 = PT.decide_partition(st, MBH, MBW, lam)
    windows = PT.gather_windows8(ref["luma"].to(torch.uint8), mvfp8, MBH,
                                 MBW).contiguous()
    prev_mv = torch.as_tensor(np.random.RandomState(4).randint(
        -40, 41, (MBH, MBW, 2)).astype(np.int32), device=dev)
    return cur, windows, part, mvfp8.contiguous(), prev_mv, lam, qp


def phase_tail(dev, int_rate):
    from video_steganography_pcamv_torch.ops import probe as PR
    cur, windows, part, mvfp8, prev_mv, lam, qp = _tail_inputs(dev)
    n = MBH * MBW
    n8 = 4 * n
    recs = []

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("%s kernel != plain, max abs err %d"
                                 % (name, err))
        log("%s: kernel == plain at %dx%d MBs (N8 %d)" % (name, MBH, MBW,
                                                         n8))
        return err

    # B2: reads the windows, writes both tables; per 8x8 and offset, 64
    # averages (3 ops) and four 4x4 WHTs (64 ops each)
    blocks8, wht8 = PR.qpel_tables(windows)
    want = PR.block_table8(windows)
    err = check("B2 qpel_tables", (blocks8, wht8),
                (want, PR.wht8_table(want)))
    del want
    ms = cuda_ms(lambda: PR.qpel_tables(windows), 20, 3)
    plain_ms = cuda_ms(lambda: PR.wht8_table(PR.block_table8(windows)), 3)
    bnd = bound(n8 * (1024 + 169 * 64 * 3), n8 * 169 * (64 * 3 + 4 * 64),
                int_rate)
    recs.append(record("qpel_tables", "qpel_tables.cu",
                       "ops/probe_pallas.py:221", err, ms, plain_ms, bnd))

    # B3: reads cur (int32), 49 WHT rows per 8x8, part/mv/pred; writes
    # mv8 and r_idx8; per 8x8 and offset ~3 ops a coefficient
    got = PR.subpel(cur, wht8, part, mvfp8, prev_mv, lam, MBH, MBW)
    want = PR.subpel_parts(cur, wht8, part, mvfp8, prev_mv, MBH, MBW, lam)
    err = check("B3 subpel", got, want)
    r_idx8 = got[1]
    ms = cuda_ms(lambda: PR.subpel(cur, wht8, part, mvfp8, prev_mv, lam,
                                   MBH, MBW), 20, 3)
    plain_ms = cuda_ms(lambda: PR.subpel_parts(cur, wht8, part, mvfp8,
                                               prev_mv, MBH, MBW, lam), 3)
    bnd = bound(n8 * (64 * 4 + 49 * 128 + 8 + 12) + n * 12,
                n8 * 49 * 64 * 3, int_rate)
    recs.append(record("subpel", "subpel.cu", "ops/probe_pallas.py:301",
                       err, ms, plain_ms, bnd))

    # B4: the probe lattice's distinct rows per 8x8 (13 pred rows, the
    # WHT rows centre+neighbour reaches), cur and r_idx read; SK, SP, sc8
    # written. ops per (8x8, version, 4x4): residual+DCT 80, quant 80,
    # decimate 80, dequant+IDCT 144, recon 64, the recon's WHT 64, 9
    # SATDs of 48 for SK. The pred's WHT is the table row at the
    # version's centre, so it costs no op; an SP entry is the SATD of two
    # table rows, and each unordered pair of distinct rows is counted
    # once (48 ops a 4x4)
    for decimate in (True, False):
        got = PR.probe_maps(cur, blocks8, wht8, r_idx8, qp, MBH, MBW,
                            decimate)
        want = PR.probe_maps_plain(cur, blocks8, wht8, r_idx8, qp, MBH, MBW,
                                   decimate)
        err = check("B4 probe_maps (decimate %s)" % decimate, got, want)
    ms = cuda_ms(lambda: PR.probe_maps(cur, blocks8, wht8, r_idx8, qp, MBH,
                                       MBW), 20, 3)
    plain_ms = cuda_ms(lambda: PR.probe_maps_plain(
        cur, blocks8, wht8, r_idx8, qp, MBH, MBW), 3)
    rows = {(cy + ny, cx + nx) for cy, cx in PR._CENTERS for ny, nx in PR._NB}
    nbytes = n8 * (len(rows) * 128 + 13 * 64 + 64 * 4 + 4
                   + (2 * 117 + 13) * 4)
    sp_pairs = {frozenset((c, (c[0] + ny, c[1] + nx))) for c in PR._CENTERS
                for ny, nx in PR._NB if (ny, nx) != (0, 0)}
    ops = n8 * 4 * (13 * (80 + 80 + 80 + 144 + 64 + 64 + 9 * 48)
                    + len(sp_pairs) * 48)
    bnd = bound(nbytes, ops, int_rate)
    recs.append(record("probe_maps", "probe_maps.cu",
                       "ops/probe_pallas.py:481", err, ms, plain_ms, bnd))
    for r in recs:
        log("%s time: kernel %.3f ms, plain %.3f ms, bound %.4f ms (%s) "
            "(median, 1080p)" % (r["name"], r["ms"], r["plain_ms"],
                                 r["bound_ms"], r["bound_by"]))
    return recs


def _params(w, h, tail_kernel, me_range=16):
    from video_steganography_pcamv_torch.params import Params, StegoParams
    p = Params(width=w, height=h, qp=26, me_range=me_range,
               deblock_device=True, psnr=False,
               stego=StegoParams(em_rate=64, key=99))
    p.tail_kernel = tail_kernel
    p.pipeline_deep = False
    return p


def _encode(p, frames, device):
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(p, device=device)
    bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    return enc, bs


def _check_payload(bs, enc, n_frames):
    from video_steganography_pcamv_torch.decoder import decode_annexb
    from video_steganography_pcamv_torch.stego.extract import (
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
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(112, 80, 6, seed=7)
    streams = {}
    for tail_kernel in (True, False):
        p = _params(112, 80, tail_kernel)
        enc_g, bs_g = _encode(p, frames, dev)
        _enc_c, bs_c = _encode(_params(112, 80, tail_kernel), frames, "cpu")
        if bs_g != bs_c:
            raise AssertionError("112x80 stream, tail_kernel=%s: cuda (%d B)"
                                 " != cpu (%d B)" % (tail_kernel, len(bs_g),
                                                     len(bs_c)))
        bits = _check_payload(bs_g, enc_g, len(frames))
        streams[tail_kernel] = bs_g
        log("112x80 x6, tail_kernel=%s: cuda stream == cpu stream (%d "
            "bytes), %d payload bits recovered" % (tail_kernel, len(bs_g),
                                                   bits))
    log("112x80: the two branches' streams %s"
        % ("differ" if streams[True] != streams[False] else "are equal"))


def _counters():
    from video_steganography_pcamv_torch.ops.deblock import deblock_frame
    from video_steganography_pcamv_torch.ops.fullpel import fullpel_parts
    from video_steganography_pcamv_torch.ops import probe as PR
    return {"fullpel_parts": fullpel_parts, "qpel_tables": PR.qpel_tables,
            "subpel": PR.subpel, "probe_maps": PR.probe_maps,
            "deblock_frame": deblock_frame}


def phase_main(dev, card, tail_kernel: bool, n_frames: int):
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(1920, 1088, n_frames, seed=7)
    enc = Encoder(_params(1920, 1088, tail_kernel), device=dev)
    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.time()
    bs = enc.encode_frame(frames[0])
    torch.cuda.synchronize()
    t1 = time.time()
    for f in frames[1:]:
        bs += enc.encode_frame(f)
    bs += enc.flush()
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {k: fn.launches for k, fn in fns.items()}
    n_p = enc.stats.p_frames
    if n_p < 1:
        raise AssertionError("no P frame in the main path")
    want = {"fullpel_parts": n_p, "qpel_tables": n_p, "subpel": n_p,
            "probe_maps": n_p, "deblock_frame": len(frames)}
    for k, lo in want.items():
        if launches[k] < lo:
            raise AssertionError("%s launched %d times, want >= %d"
                                 % (k, launches[k], lo))
    bits = _check_payload(bs, enc, len(frames))
    fps_p = (len(frames) - 1) / (t2 - t1)
    log("1080p tail_kernel=%s: %d frames (%d I, %d P), %d bytes, %d "
        "payload bits recovered; IDR %.3f s; P frames %.4f fps incl. "
        "flush; all %.4f fps; launches %s  [%s]"
        % (tail_kernel, len(frames), enc.stats.i_frames, n_p, len(bs), bits,
           t1 - t0, fps_p, len(frames) / (t2 - t0), json.dumps(launches),
           card))
    return launches


def phase_stages(dev, card, n_frames: int = 7):
    """Per-stage device time of a 1080p P frame on the tail_kernel=True
    path: every stage is wrapped with a device sync on each side (the
    syncs remove the pipelining, so the stages sum to more than a P
    frame of phase 6). Averages over the P frames after the first."""
    from video_steganography_pcamv_torch import Encoder, native
    from video_steganography_pcamv_torch.encoder import core as CORE
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    from video_steganography_pcamv_torch.ops import probe as PR
    from video_steganography_pcamv_torch.stego import embed as EMB
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    targets = [(ST.Lookahead, "costs_device"), (PT, "fullpel_parts"),
               (PT, "decide_partition"), (PT, "gather_windows8"),
               (PR, "qpel_tables"), (PR, "subpel"), (PR, "probe_maps"),
               (INTER, "encode_p_frame_device8"), (PT, "scan_p_device"),
               (PT, "probe_combine"), (EMB.StegoEngine, "apply_costs"),
               (CORE, "reencode_p_incremental"), (CORE, "deblock_frame"),
               (native, "write_slice")]
    totals = {name: 0.0 for _, name in targets}
    state = {"on": False}

    def timed(name, fn):
        def wrap(*a, **kw):
            if not state["on"]:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        # a kernel wrapper counts its launches on the name it is called
        # by, which is now this one
        wrap.launches = 0
        return wrap

    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    frames = synthetic_sequence(1920, 1088, n_frames, seed=7)
    try:
        for obj, name, fn in saved:
            setattr(obj, name, timed(name, fn))
        enc = Encoder(_params(1920, 1088, True), device=dev)
        enc.encode_frame(frames[0])
        enc.encode_frame(frames[1])
        torch.cuda.synchronize()
        state["on"] = True
        t0 = time.perf_counter()
        for f in frames[2:]:
            enc.encode_frame(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        enc.flush()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    n = len(frames) - 2
    log("1080p tail_kernel=True stage times, ms per P frame over %d P "
        "frames, a device sync around each stage  [%s]" % (n, card))
    for name, s in sorted(totals.items(), key=lambda kv: -kv[1]):
        log("  %-24s %9.3f" % (name, 1e3 * s / n))
    log("  %-24s %9.3f" % ("(rest of the frame)",
                           1e3 * (wall - sum(totals.values())) / n))
    log("  %-24s %9.3f" % ("(frame, with the syncs)", 1e3 * wall / n))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.time()
    dev = torch.device("cuda", 0)
    card = card_query("name,power.limit")
    log(card)
    log("python %s, torch %s, cuda %s" % (sys.version.split()[0],
                                          torch.__version__,
                                          torch.version.cuda))
    phase_build()
    int_rate = int32_ops_per_s()
    log("int32 peak %.3e ops/s (132 SMs x 64 lanes x max SM clock)"
        % int_rate)
    recs = [phase_b1(dev, int_rate), phase_b5(dev, int_rate)]
    recs += phase_tail(dev, int_rate)
    phase_small(dev)
    launches = phase_main(dev, card, tail_kernel=True, n_frames=10)
    phase_main(dev, card, tail_kernel=False, n_frames=4)
    phase_stages(dev, card)
    for r in recs:
        r["launches"] = launches[r["name"]]
    log("total %.1f s" % (time.time() - t_start))
    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
