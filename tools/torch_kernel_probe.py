"""Probe the card for the PyTorch port's full-pel search (B1/B6/B10),
window fetches (B9 per 8x8, B7 per MB) and 4x4 luma encode (B8).

    python3 tools/torch_kernel_probe.py [SECTION ...]

SECTION is any of sass, tma, b9, b7, search, luma (default: all).

On a machine with one NVIDIA H100 and nvcc, from the repository root:
1. the SASS opcode counts and registers of `csrc/fullpel.cu`,
   `csrc/windows8.cu`, `csrc/luma_p.cu` and `csrc/dct_quant.cu` (nvcc
   -cubin, cuobjdump -sass);
2. whether a tensor-map TMA load runs: a 16 x 16 x 4 uint8 box through
   libcu++'s `cp_async_bulk_tensor_3d_global_to_shared` (map as a
   `__grid_constant__` parameter), through inline PTX (map in global
   memory), and, for comparison, a 1D `cp.async.bulk` copy; each in its
   own process, since a fault ends the CUDA context;
3. B9's kernel at 1080p on the main path's MVs against a variant that
   reads each window row as five aligned 4-byte words
   (`tools/torch_kernel_probe.cu`), both array-equal to the plain
   gather, both called through their C entry points into preallocated
   outputs and timed in turns as 50 back-to-back launches between CUDA
   events (median of 5, three rounds), so that the wrapper's host time
   does not count; then B9 on a stack of two references with a random
   per-8x8 reference index (the multi-reference P analysis);
4. B7 (`csrc/windows.cu`, a warp an MB) at 1080p on the 16x16 path's
   full-pel MVs against its earlier design (a block of 192 threads an
   MB, one byte a thread, kept in `tools/torch_kernel_probe.cu`), both
   array-equal to the plain gather, timed the same way;
5. the same device-only time of B1, B6 and B10's B1 launch at 1080p;
6. the same device-only time of the fused luma encode
   (`csrc/luma_p.cu`) and of B8a and B8b (`csrc/dct_quant.cu`) at
   1080p, on the whole frame at qp 26 and 20 and on the stego probe's
   13-version batch.
The probe library is built into build/torch_probe/ (git-ignored).
"""

import collections
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "torch_probe")
LIB = os.path.join(OUT, "probe.so")
VP, CI = ctypes.c_void_p, ctypes.c_int


def sass_counts(nvcc, flags, name):
    """Registers and opcode counts of csrc/NAME.cu, one line a kernel."""
    cubin = os.path.join(OUT, name + ".cubin")
    r = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
                        cubin, os.path.join(ROOT, "video_steganography_"
                                            "pcamv_torch", "csrc",
                                            name + ".cu")],
                       capture_output=True, text=True, check=True)
    print(name, [ln.split(":", 1)[1].strip() for ln in
                 r.stderr.splitlines() if "Used" in ln])
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    for f in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", f))
        print("  %s: %d instructions; %s" % (
            f.split("\n", 1)[0].strip(), sum(ops.values()),
            dict(ops.most_common(12))))


def copy_case(mode: int) -> None:
    """One probe_copy mode on a small random [4, 128, 160] plane set."""
    lib = ctypes.CDLL(LIB)
    lib.probe_copy.restype = CI
    lib.probe_copy.argtypes = [CI, VP, CI, CI, VP, CI, VP, VP]
    g = np.random.RandomState(0)
    hp, wp, n = 128, 160, 64
    planes = torch.as_tensor(g.randint(0, 256, (4, hp, wp)).astype(np.uint8),
                             device="cuda")
    xy = np.stack([g.randint(0, wp - 16, n), g.randint(0, hp - 16, n)], 1)
    xyt = torch.as_tensor(xy.astype(np.int32), device="cuda")
    out = torch.zeros((n, 4, 16, 16), dtype=torch.uint8, device="cuda")
    map_dev = torch.zeros(128, dtype=torch.uint8, device="cuda")
    rc = lib.probe_copy(mode, planes.data_ptr(), hp, wp, xyt.data_ptr(), n,
                        out.data_ptr(), map_dev.data_ptr())
    torch.cuda.synchronize()
    if mode == 2:
        want = torch.stack([planes[0, y:y + 16, (x & ~15):(x & ~15) + 16]
                            for x, y in xy])
        ok = torch.equal(out[:, 0], want)
    else:
        want = torch.stack([planes[:, y:y + 16, x:x + 16] for x, y in xy])
        ok = torch.equal(out, want)
    print("rc %d, copy equal %s" % (rc, ok))


def launch_ms(fn, launches=50, reps=5):
    """Median over reps of the CUDA-event time of `launches` back-to-back
    calls, per call: the device time when a call enqueues faster than
    the kernel runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def b9_variants() -> None:
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    from video_steganography_pcamv_torch import kernels
    mbh, mbw = 68, 120
    dev = torch.device("cuda", 0)
    fr = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=3)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    planes = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                          device=dev), c, c)["luma"] \
        .to(torch.uint8)
    zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
    st = FP.fullpel_parts(cur, planes[0], zero, 16, mbh, mbw, 4)
    mv = PT.decide_partition(st, mbh, mbw, 4)[1].contiguous()
    want = PT.gather_windows8_plain(planes, mv, mbh, mbw)
    lib = ctypes.CDLL(LIB)
    hp, wp = planes.shape[1:]
    args = [VP, CI, CI, VP, CI, CI, VP, VP]
    lib.probe_windows8_words.restype = CI
    lib.probe_windows8_words.argtypes = args
    b9 = kernels.entry("pcamv_gather_windows8",
                       [VP, CI, CI, VP, VP, CI, CI, CI, VP, VP])
    ptr = kernels.ptr
    refs = torch.stack([planes, torch.roll(planes, 1, dims=2)]).contiguous()
    ref8 = torch.as_tensor(np.random.RandomState(2).randint(
        0, 2, (2 * mbh, 2 * mbw)).astype(np.int32), device=dev)
    runs = {}
    for label, p, r8, fn in (
            ("two aligned 16-byte chunks a row (csrc/windows8.cu)", planes,
             None, lambda p, r8, o: b9(ptr(p), hp, wp, ptr(mv),
                                       ptr(r8) if r8 is not None else None,
                                       1 if r8 is None else 2, mbh, mbw,
                                       ptr(o), kernels.stream(p))),
            ("five aligned 4-byte words a row", planes, None,
             lambda p, r8, o: lib.probe_windows8_words(
                 ptr(p), hp, wp, ptr(mv), mbh, mbw, ptr(o),
                 kernels.stream(p))),
            ("csrc/windows8.cu on 2 references, random ref8", refs, ref8,
             lambda p, r8, o: b9(ptr(p), hp, wp, ptr(mv), ptr(r8), 2, mbh,
                                 mbw, ptr(o), kernels.stream(p)))):
        out = torch.empty_like(want)
        ref_want = (want if r8 is None else
                    PT.gather_windows8_plain(p, mv, mbh, mbw, ref8=r8))

        def run(fn=fn, p=p, r8=r8, out=out):
            kernels.check(fn(p, r8, out), "B9 variant")
        run()
        torch.cuda.synchronize()
        print("B9 %s == plain: %s" % (label, torch.equal(out, ref_want)))
        runs[label] = run
    for _ in range(3):
        print("B9 1080p, ms a launch (50 back-to-back launches, median of "
              "5): " + "; ".join("%s %.4f" % (k, launch_ms(f))
                                 for k, f in runs.items()))


def b7_variants() -> None:
    """B7 at 1080p on the 16x16 path's MVs (B6 against a zero predictor,
    rng 16): the redesign against the earlier kernel, both through their
    C entry points into preallocated outputs."""
    from video_steganography_pcamv_torch.encoder import qpel_table as QT
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    from video_steganography_pcamv_torch import kernels
    mbh, mbw = 68, 120
    dev = torch.device("cuda", 0)
    fr = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=3)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    planes = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                          device=dev), c, c)["luma"] \
        .to(torch.uint8)
    mv = FP.fullpel_search16(cur, planes[0], 16, mbh, mbw, 4)[0] \
        .contiguous()
    # (the plain gather returns a permuted view: compare into contiguous
    # outputs, the kernels' layout)
    want = QT.gather_windows_plain(planes, mv, mbh, mbw).contiguous()
    lib = ctypes.CDLL(LIB)
    hp, wp = planes.shape[1:]
    args = [VP, CI, CI, VP, CI, CI, VP, VP]
    runs = {}
    for label, fn in (
            ("a warp an MB, 16-byte chunks (csrc/windows.cu)",
             kernels.entry("pcamv_gather_windows", args)),
            ("a block an MB, a byte a thread (before the redesign)",
             lib.probe_windows_bytes)):
        fn.restype, fn.argtypes = CI, args
        out = torch.empty_like(want)

        def run(fn=fn, out=out):
            kernels.check(fn(planes.data_ptr(), hp, wp, mv.data_ptr(), mbh,
                             mbw, out.data_ptr(), kernels.stream(planes)),
                          "B7 variant")
        run()
        torch.cuda.synchronize()
        print("B7 %s == plain: %s" % (label, torch.equal(out, want)))
        runs[label] = run
    for _ in range(3):
        print("B7 1080p, ms a launch (50 back-to-back launches, median of "
              "5): " + "; ".join("%s %.4f" % (k, launch_ms(f))
                                 for k, f in runs.items()))


def search_device_ms() -> None:
    """B1 (rng 16, zero predictor), B6 (rng 16) and B10's B1 launch (the
    960x544 lowres planes as 34x60 tiles, rng 8) at 1080p, called
    through their C entry points into preallocated outputs."""
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    dev = torch.device("cuda", 0)
    fr = synthetic_sequence(1920, 1088, 2, seed=3)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    prev = torch.as_tensor(fr[0].y.astype(np.int32), device=dev)
    lr_cur = ST.lowres(cur).contiguous()
    cases = [("B1 1080p rng 16", cur, mc.pad_plane(prev.to(torch.uint8)),
              16, 68, 120, 4),
             ("B10's B1 launch, 960x544 rng 8", lr_cur,
              mc.pad_plane(ST.lowres(prev).to(torch.uint8)), 8, 34, 60, 1)]
    ptr = kernels.ptr
    parts = kernels.entry("pcamv_fullpel_parts", [VP, CI, VP, CI, VP, VP]
                          + [CI] * 5 + [VP] * 3)
    s16 = kernels.entry("pcamv_fullpel_search16", [VP, CI, VP, CI, VP]
                        + [CI] * 5 + [VP] * 3)
    for name, c, r, rng, mbh, mbw, lam in cases:
        bits = FP._bits_on(dev, rng)
        zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=dev)
        a = torch.empty((mbh, mbw, 9), dtype=torch.int32, device=dev)
        b = torch.empty_like(a)
        w = 16 * mbw

        def run():
            kernels.check(parts(ptr(c), w, ptr(r), w + 48, ptr(zero),
                                ptr(bits), bits.shape[0], rng, lam, mbh, mbw,
                                ptr(a), ptr(b), kernels.stream(c)), name)
        print("%s: %.4f ms a launch" % (name, launch_ms(run)))
        if rng == 16:
            mv = torch.empty((mbh, mbw, 2), dtype=torch.int32, device=dev)
            cost = torch.empty((mbh, mbw), dtype=torch.int32, device=dev)

            def run16():
                kernels.check(s16(ptr(c), w, ptr(r), w + 48, ptr(bits),
                                  bits.shape[0], rng, lam, mbh, mbw, ptr(mv),
                                  ptr(cost), kernels.stream(c)), "B6")
            print("B6 1080p rng 16: %.4f ms a launch" % launch_ms(run16))


def luma_device_ms() -> None:
    """The fused luma encode and B8a/B8b at 1080p (8160 MBs), called
    through their C entry points into preallocated outputs: predictions
    at random per-8x8 qpel MVs, and the 13-version batch as the 16x16
    path's probe gives it (13 predictions per MB, the levels
    omitted)."""
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.ops import const
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    mbh, mbw = 68, 120
    dev = torch.device("cuda", 0)
    fr = synthetic_sequence(16 * mbw, 16 * mbh, 2, seed=3)
    y = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                       device=dev), c, c)
    g = np.random.RandomState(5)
    mv8 = torch.as_tensor(g.randint(-40, 41, (2 * mbh, 2 * mbw, 2))
                          .astype(np.int32), device=dev)
    pred = INTER.assemble_pred_luma(ref["luma"], mv8, mbh, mbw)
    p13 = torch.clamp(pred.repeat(13, 1, 1) + torch.as_tensor(
        g.randint(-4, 5, (13 * mbh * mbw, 16, 16)).astype(np.int32),
        device=dev), 0, 255)
    ptr = kernels.ptr
    fused = kernels.entry("pcamv_luma_p_encode",
                          [VP] * 2 + [CI] * 2 + [VP] * 2 + [CI] + [VP] * 3
                          + [CI] + [VP] * 6)
    dq = kernels.entry("pcamv_dct_quant", [VP] * 4 + [CI] * 2 + [VP] * 2)
    di = kernels.entry("pcamv_deq_idct", [VP] * 3 + [CI, VP] + [CI] * 2
                       + [VP] * 2)
    cur_tiles = INTER.mb_tiles(y, 16)
    for label, p, qp, with_lev in (("frame qp 26", pred, 26, True),
                                   ("frame qp 20", pred, 20, True),
                                   ("13-version batch qp 26", p13, 26,
                                    False)):
        n = p.shape[0]
        lev = torch.empty((n, 4, 4, 4, 4), dtype=torch.int32, device=dev)
        rec = torch.empty((n, 16, 16), dtype=torch.int32, device=dev)
        cbp = torch.empty((n,), dtype=torch.int32, device=dev)
        mf, bias, dmf = (const(t, dev) for t in (
            LP.MF16[qp], LP.BIAS16[qp], LP.DMF16[qp % 6]))

        def run(p=p, qp=qp, with_lev=with_lev, lev=lev, rec=rec, cbp=cbp,
                n=n, mf=mf, bias=bias, dmf=dmf):
            kernels.check(fused(ptr(y), ptr(p), 16 * mbw, mbh * mbw, None,
                                None, n, ptr(mf), ptr(bias), ptr(dmf),
                                qp // 6 - 4, None, None,
                                ptr(lev) if with_lev else None,
                                ptr(rec), ptr(cbp), kernels.stream(y)),
                          "fused luma encode")
        run()
        want = LP.luma_p_encode_plain(y, p, qp, lev=with_lev)
        same = torch.equal(rec, want[1]) and torch.equal(cbp, want[2]) and (
            not with_lev or torch.equal(lev, want[0]))
        cur = cur_tiles.repeat(n // cur_tiles.shape[0], 1, 1)
        cur16, pred16 = INTER._mb_to_coef16(cur), INTER._mb_to_coef16(p)
        L = cur16.shape[1]
        lev16 = torch.empty((16, L), dtype=torch.int32, device=dev)
        rec16 = torch.empty_like(lev16)

        def run_a(cur16=cur16, pred16=pred16, mf=mf, bias=bias, L=L,
                  lev16=lev16):
            kernels.check(dq(ptr(cur16), ptr(pred16), ptr(mf), ptr(bias), L,
                             0, ptr(lev16), kernels.stream(y)), "B8a")

        def run_b(pred16=pred16, dmf=dmf, qp=qp, L=L, lev16=lev16,
                  rec16=rec16):
            kernels.check(di(ptr(lev16), ptr(pred16), ptr(dmf), qp // 6 - 4,
                             None, 0, L, ptr(rec16), kernels.stream(y)),
                          "B8b")
        run_a()
        for _ in range(3):
            print("B8 %s (%d MBs), ms a launch (50 back-to-back launches, "
                  "median of 5): fused %.4f (== plain: %s); B8a %.4f; B8b "
                  "%.4f" % (label, n, launch_ms(run), same, launch_ms(run_a),
                            launch_ms(run_b)))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--copy":
        copy_case(int(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from video_steganography_pcamv_torch import kernels
    sections = sys.argv[1:] or ["sass", "tma", "b9", "b7", "search", "luma"]
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                        "driver_version", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    print(r.stdout.strip(), "| torch", torch.__version__, "cuda",
          torch.version.cuda)
    os.makedirs(OUT, exist_ok=True)
    nvcc = kernels._nvcc()
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", LIB,
                    os.path.join(ROOT, "tools", "torch_kernel_probe.cu")],
                   check=True)
    for name in ("fullpel", "windows8", "windows", "luma_p",
                 "dct_quant") if "sass" in sections else ():
        sass_counts(nvcc, kernels.NVCC_FLAGS, name)
    for mode, what in ((0, "TMA tensor load, libcu++, map as parameter"),
                       (1, "TMA tensor load, PTX, map in global memory"),
                       (2, "1D cp.async.bulk copy")
                       ) if "tma" in sections else ():
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--copy", str(mode)], capture_output=True,
                           text=True, timeout=300)
        err = [ln for ln in r.stderr.splitlines() if "rror" in ln]
        print("%s: exit %d; %s %s" % (what, r.returncode, r.stdout.strip(),
                                      err[-1:] if err else ""))
    for name, fn in (("b9", b9_variants), ("b7", b7_variants),
                     ("search", search_device_ms), ("luma", luma_device_ms)):
        if name in sections:
            fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
