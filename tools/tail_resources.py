"""Registers, spills and shared memory of the analyse-tail kernels, and
their tensor-core instructions, as nvcc compiles them for sm_90a.

    python3 tools/tail_resources.py [CSRC_DIR ...]

For each CUDA source of the tail in each csrc directory (default: this
checkout's; give a parent checkout's too to compare), runs `nvcc -c
-Xptxas -v` with the port's flags (kernels.NVCC_FLAGS) and prints, per
kernel, ptxas's registers, spill stores/loads and static shared memory,
then the kernel's SASS instruction count and its IMMA (integer tensor
core) instructions from `cuobjdump -sass`. Needs the CUDA toolkit.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from video_steganography_pcamv_torch import kernels  # noqa: E402

# this tree's tail and B2's entry, then B3's and B4's sources before the
# fused tail replaced them (found only in an older checkout given as an
# argument, to compare against)
TAIL_SOURCES = ("analyse_tail.cu", "qpel_tables.cu", "subpel.cu",
                "probe_maps.cu")


def resources(src: str, tmp: str) -> list:
    """[(kernel, registers, spill stores, spill loads, smem bytes, SASS
    instructions, IMMA instructions)] of the kernels in `src`."""
    nvcc = kernels._nvcc()
    obj = os.path.join(tmp, os.path.basename(src) + ".o")
    r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                        "-o", obj, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr)
    rows, name = {}, None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows.setdefault(name, {}).update(spill_st=int(m.group(1)),
                                             spill_ld=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.setdefault(name, {}).update(
                regs=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    for part in sass.split("Function : ")[1:]:
        fn = part.split()[0]
        body = part.splitlines()
        n = sum(1 for ln in body if re.search(r"/\*[0-9a-f]{4,}\*/", ln))
        imma = sum(1 for ln in body if " IMMA" in ln)
        if fn in rows:
            rows[fn].update(sass=n, imma=imma)
    return [(fn, d.get("regs"), d.get("spill_st"), d.get("spill_ld"),
             d.get("smem"), d.get("sass"), d.get("imma"))
            for fn, d in sorted(rows.items())]


def main(argv) -> int:
    dirs = argv or [kernels.SRC_DIR]
    with tempfile.TemporaryDirectory() as tmp:
        for d in dirs:
            for name in TAIL_SOURCES:
                src = os.path.join(d, name)
                if not os.path.exists(src):
                    continue
                print("== %s" % os.path.relpath(src, ROOT))
                for row in resources(src, tmp):
                    print("  %s: %s registers, spills %s B stored / %s B "
                          "loaded, %s B static smem, %s SASS instructions, "
                          "%s IMMA" % row)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
