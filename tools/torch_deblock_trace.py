"""Where the time of the PyTorch port's one-launch deblocker goes, MB by
MB, on the card.

    python3 tools/torch_deblock_trace.py

Makes a copy of `csrc/deblock.cu` in which lane 0 of each filter warp
(luma, chroma) stamps `%globaltimer` at six points of every MB of its
row, builds it with nvcc into `build/deblock_trace/`, runs it on the
1080p frame of `tools/torch_deblock_split.py` (qp 26) and prints, per
warp, the mean and median of each piece of an MB, the per-MB time of
row 0 (which waits on nothing) and of row 30, and when each row ends.
The copy is held against `edge_params` + `deblock_frame_plain`. The
stamps cost a few stores an MB, so the traced kernel runs slightly
slower than the real one. globaltimer ticks in steps of about 0.26 us
on the H100.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from torch_deblock_split import MBH, MBW, frame, timed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = ["ready wait", "vertical edges + left store", "publish",
          "top rows: wait + load", "prefetch + horizontal + store"]

# (anchor in deblock.cu, text put before it)
STAMPS = [
    ("    // a wait that outlasts kSpinLimit sleeps (seconds) is a fault: "
     "trap\n    for (int n = 0; reinterpret_cast<volatile int*>(ready)",
     "    long long* tr_ = trace + (((size_t)warp * f.mbh + my) * mbw + mx)"
     " * 6;\n    if (lane == 0) tr_[0] = gtime();\n"),
    ("    const int need = min(mx + 1, mbw);",
     "    if (lane == 0) tr_[1] = gtime();\n"),
    ("    if (mx > 0) publish(mx);\n",
     "    if (lane == 0) tr_[2] = gtime();\n"),
    ("\n    // the top rows\n", "    if (lane == 0) tr_[3] = gtime();\n"),
    ("    if (my > 0 && ltop) {\n      int t[16];\n      unpack_bytes(t, "
     "top.x);", "    if (lane == 0) tr_[4] = gtime();\n"),
    ("  }\n  publish(mbw);\n}", "    if (lane == 0) tr_[5] = gtime();\n"),
]


def traced_source() -> str:
    with open(os.path.join(ROOT, "video_steganography_pcamv_torch", "csrc",
                           "deblock.cu")) as f:
        src = f.read()
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError("deblock.cu changed: anchor not found once: "
                               + anchor.strip()[:60])
        src = src.replace(anchor, text + anchor)
    edits = [
        ("const int* __restrict__ tabs, int* __restrict__ sync) {",
         "const int* __restrict__ tabs, int* __restrict__ sync,\n"
         "                    long long* trace) {"),
        ("__device__ __forceinline__ int ld_acquire",
         "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n\n__device__ __forceinline__ int ld_acquire"),
        ("      static_cast<int*>(sync));",
         "      static_cast<int*>(sync), static_cast<long long*>(trace));"),
        ("int mbh, int mbw,\n    void* sync, void* stream) {",
         "int mbh, int mbw,\n    void* sync, void* stream, void* trace) {"),
    ]
    for a, b in edits:
        if src.count(a) != 1:
            raise RuntimeError("deblock.cu changed: " + a[:60])
        src = src.replace(a, b)
    return src


def build() -> ctypes.CDLL:
    sys.path.insert(0, ROOT)
    from video_steganography_pcamv_torch import kernels
    out = os.path.join(ROOT, "build", "deblock_trace")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "deblock_trace.cu")
    with open(cu, "w") as f:
        f.write(traced_source())
    so = os.path.join(out, "deblock_trace.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
           kernels.SRC_DIR, "-o", so, cu]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + r.stderr)
    lib = ctypes.CDLL(so)
    fn = lib.pcamv_deblock_frame
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p] * 3
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    fn = build()
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.ops import deblock as DB
    dev = torch.device("cuda", 0)
    planes, maps = frame(dev)
    out = [torch.empty_like(p) for p in planes]
    sync = torch.empty(2 * MBH + 1, dtype=torch.int32, device=dev)
    trace = torch.zeros(2 * MBH * MBW * 6, dtype=torch.int64, device=dev)
    tabs = torch.as_tensor(DB._TABS, device=dev)
    P = kernels.ptr

    def run(_=None):
        kernels.check(fn(*(P(t) for t in planes + out), P(maps[0]),
                         P(maps[1]), None, P(maps[2]), P(maps[3]), None,
                         None, None, P(tabs),
                         26, 26, 15, 0, 0, MBH, MBW, P(sync),
                         kernels.stream(sync), P(trace)),
                      "traced pcamv_deblock_frame")
    ms = timed(run)
    run()
    torch.cuda.synchronize()
    par = DB.edge_params(*maps, 26, 26, MBH, MBW)
    want = DB.deblock_frame_plain(*planes, par, MBH, MBW)
    if not all(torch.equal(a, b) for a, b in zip(out, want)):
        raise AssertionError("traced kernel != plain")
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print("traced deblock at 1080p: %.4f ms a call (median of 20), == plain"
          "  [%s]" % (ms, card))
    t = trace.cpu().numpy().reshape(2, MBH, MBW, 6).astype(np.float64)
    t = (t - t[:, :, :, 0].min()) / 1000.0                  # us
    for w, name in enumerate(("luma", "chroma")):
        tw = t[w]
        d = np.diff(tw, axis=2)
        print("== %s warp: last row ends at %.2f us" % (name, tw[-1, -1, 5]))
        for k, piece in enumerate(PIECES):
            print("  %-30s mean %.3f us, median %.3f us"
                  % (piece, d[:, :, k].mean(), np.median(d[:, :, k])))
        print("  row 0 per MB us (MBs 1-11):",
              np.round(tw[0, 1:12, 5] - tw[0, 1:12, 0], 2).tolist())
        print("  row 30 per MB us (MBs 1-11):",
              np.round(tw[30, 1:12, 5] - tw[30, 1:12, 0], 2).tolist())
        print("  row end us, rows 0-9:",
              np.round(tw[:10, -1, 5], 2).tolist())
        print("  row 30 starts its MB 1 at %.2f us (%.2f us a row)"
              % (tw[30, 1, 0], tw[30, 1, 0] / 30))
    return 0


if __name__ == "__main__":
    sys.exit(main())
