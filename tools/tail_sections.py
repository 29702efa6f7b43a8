"""Where the fused analyse tail's time goes, section by section, on the
H100.

    python3 tools/tail_sections.py

Builds copies of csrc/analyse_tail.cu, each cut after one section (a
`return;` inserted before the anchor line that begins the next one: 0
staging, 1 B3's tiles, 2 its minimum, 3 the lattice, 4 the DCT tiles
with their chain and the SP tiles, 5 the SK tiles; none: the whole
kernel; and the whole kernel at 4 blocks an SM instead of 5), each into
a library of its own (one nvcc each, all started together; the tool
raises if an anchor is not found exactly once), and times each build's
`pcamv_analyse_tail` alone on chip_smoke's 1080p tail inputs (CUDA
events around 20 back-to-back launches, the median of 7). Prints the
cumulative ms after each section and each section's share. The early
ends' outputs are not meaningful; only their times are.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from video_steganography_pcamv_torch import kernels  # noqa: E402
from video_steganography_pcamv_torch.ops import probe as PR  # noqa: E402

STOPS = [0, 1, 2, 3, 4, 5, None, "min4"]
# the first line of the section after each cut
ANCHORS = {
    0: "  const uint32_t cur0 = sm.cur[bl][sl][tq]",
    1: "    // the partition-coupled costs",
    2: "    if (mb_cost != nullptr && t == 0)",
    3: "    // a warp takes the next tile",
    4: "    // the SK tiles (v, k)",
    5: "    // the maps, a 16-byte row",
}
MIN_BLOCKS = "static constexpr int kMinBlocks = kProbe ? 5 : 8;"
NAMES = ["staging", "B3 tiles", "B3 minimum", "lattice",
         "DCT + chain, SP tiles", "SK tiles", "maps out"]


def _variant(text: str, k) -> str:
    """The source of build k: cut after section k, at 4 blocks an SM
    ("min4"), or as it is (None)."""
    if k is None:
        return text
    anchor, new = ((MIN_BLOCKS, MIN_BLOCKS.replace("? 5", "? 4"))
                   if k == "min4" else (ANCHORS[k], "return;\n" + ANCHORS[k]))
    if text.count(anchor) != 1:
        raise RuntimeError("tail_sections: anchor %r found %d times in "
                           "analyse_tail.cu" % (anchor, text.count(anchor)))
    return text.replace(anchor, new)


def build_all(out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(kernels.SRC_DIR, "analyse_tail.cu")) as f:
        text = f.read()
    procs = {}
    for k in STOPS:
        src = os.path.join(out_dir, "tail_stop_%s.cu" % k)
        with open(src, "w") as f:
            f.write(_variant(text, k))
        lib = os.path.join(out_dir, "tail_stop_%s.so" % k)
        procs[k] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.SRC_DIR,
             "-shared", "-o", lib, src], stderr=subprocess.PIPE, text=True))
    libs = {}
    for k, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(err)
        libs[k] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_sections: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = C.card_query("name,power.limit")
    libs = build_all(os.path.join(ROOT, "build", "tail_sections"))
    cur, windows, part, mvfp8, prev_mv, lam, qp = C._tail_inputs(dev)
    n = C.MBH * C.MBW
    mv8, r8, sk, sp, sc8 = PR._tail_out(n, dev, True)
    qtab = PR.quant_params(qp, None, dev)
    p = kernels.ptr
    args = [p(cur), p(windows), p(part), p(mvfp8), p(prev_mv), int(lam),
            p(qtab), qp // 6 - 4, 1, C.MBH, C.MBW, p(mv8), p(r8), p(sk),
            p(sp), p(sc8), kernels.stream(cur)]
    VP, CI = kernels.VP, kernels.CI
    ms = {}
    for k in STOPS:
        fn = ctypes.CDLL(libs[k]).pcamv_analyse_tail
        fn.restype = ctypes.c_int
        fn.argtypes = [VP] * 5 + [CI, VP] + [CI] * 4 + [VP] * 6

        def run(fn=fn):
            for _ in range(20):
                kernels.check(fn(*args), "pcamv_analyse_tail")
        ms[k] = C.cuda_ms(run, 7, 2) / 20
    print("fused analyse tail at 1080p by section, ms alone (cumulative; "
          "the section's own)  [%s]" % card)
    prev = 0.0
    for k, name in zip(STOPS, NAMES):
        print("  %-24s %.4f  %.4f" % (name, ms[k], ms[k] - prev))
        prev = ms[k]
    print("whole kernel at __launch_bounds__(256, 4) (64 registers): %.4f "
          "ms" % ms["min4"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
