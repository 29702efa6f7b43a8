"""Write the constant tables of the analyse-tail kernel.

    python3 tools/gen_tail_tables.py

writes video_steganography_pcamv_torch/csrc/tail_tables.inc, which
csrc/analyse_tail.cu includes, from the port's Python sources: the probe
versions' centres and the D_NB neighbours (`ops.probe._CENTERS`, `_NB`,
from `stego.cost`), the zigzag scan (`ops.transform.ZIGZAG_4x4`), the SP
pairs they imply, and the 2-D 4x4 Walsh-Hadamard and forward core DCT as
16x16 matrices (the plain `hadamard4x4` and `dct4x4` applied to the unit
blocks; coefficient j = 4*vr + vc, pixel i = 4*r + c).
tests/test_torch_probe.py holds the file against these sources.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from video_steganography_pcamv_torch.ops import probe as PR  # noqa: E402
from video_steganography_pcamv_torch.ops import transform as T  # noqa: E402

OUT = os.path.join(ROOT, "video_steganography_pcamv_torch", "csrc",
                   "tail_tables.inc")
BOX = 7


def slot(dy: int, dx: int) -> int:
    """The lattice slot of delta (dy, dx) in the [-3, 3]^2 box."""
    return (dy + 3) * BOX + (dx + 3)


def kron(fn) -> torch.Tensor:
    """[16 (j = 4*vr + vc), 16 (i = 4*r + c)] int32: `fn` (a transform
    over axes (-4, -3) of [..., 4, 4, BY, BX]) on each unit 4x4."""
    eye = torch.eye(16, dtype=torch.int32).reshape(16, 4, 4, 1, 1)
    return fn(eye).reshape(16, 16).T.contiguous()


def tables() -> dict:
    """name -> (C type, flat int list, shape) of every table."""
    centres = PR._CENTERS
    nb = PR._NB
    slot_version = [-1] * (BOX * BOX)
    for v, (cy, cx) in enumerate(centres):
        slot_version[slot(cy, cx)] = v
    pairs = sorted({tuple(sorted((slot(cy, cx), slot(cy + ny, cx + nx))))
                    for cy, cx in centres for ny, nx in nb
                    if (ny, nx) != (0, 0)})
    sp_index = []
    for cy, cx in centres:
        for ny, nx in nb:
            if (ny, nx) == (0, 0):
                sp_index.append(-1)
            else:
                sp_index.append(pairs.index(tuple(sorted(
                    (slot(cy, cx), slot(cy + ny, cx + nx))))))
    sk_slot = [slot(cy + ny, cx + nx) for cy, cx in centres
               for ny, nx in nb]
    zz = [int(4 * r + c) for r, c in T.ZIGZAG_4x4]
    rank = [zz.index(j) for j in range(16)]
    flat = lambda rows: [int(x) for row in rows for x in row]  # noqa: E731
    return {
        "kCenter": ("int", flat(centres), (len(centres), 2)),
        "kNb": ("int", flat(nb), (len(nb), 2)),
        "kSlotVersion": ("int", slot_version, (BOX * BOX,)),
        "kZigzagRank": ("int", rank, (16,)),
        "kSpPair": ("int", flat(pairs), (len(pairs), 2)),
        "kSpIndex": ("int", sp_index, (len(centres) * len(nb),)),
        "kSkSlot": ("int", sk_slot, (len(centres) * len(nb),)),
        "kWhtKron": ("int8_t", kron(T.hadamard4x4).reshape(-1).tolist(),
                     (16, 16)),
        "kDctKron": ("int8_t", kron(T.dct4x4).reshape(-1).tolist(),
                     (16, 16)),
    }


_NOTES = {
    "kCenter": "(dy, dx) of the 13 probe versions: (0, 0), then "
               "stego.cost.D_MV",
    "kNb": "(dy, dx) of stego.cost.D_NB",
    "kSlotVersion": "the version centred on lattice slot (dy+3)*7 + "
                    "(dx+3), or -1",
    "kZigzagRank": "the zigzag scan position of coefficient 4*vr + vc",
    "kSpPair": "the distinct unordered lattice slot pairs {c_v, c_v + "
               "nb_k}, nb_k != (0, 0)",
    "kSpIndex": "(v*9 + k) -> its kSpPair row, -1 for nb_k = (0, 0)",
    "kSkSlot": "(v*9 + k) -> the lattice slot of c_v + nb_k",
    "kWhtKron": "the 2-D 4x4 WHT: [j = 4*vr + vc][i = 4*r + c]",
    "kDctKron": "the 2-D forward 4x4 core DCT: [j = 4*vr + vc][i = 4*r + "
                "c]",
}


def source() -> str:
    lines = ["// GENERATED by tools/gen_tail_tables.py from the port's "
             "Python sources;",
             "// tests/test_torch_probe.py checks it. Do not edit.", ""]
    for name, (ctype, vals, shape) in tables().items():
        dims = "".join("[%d]" % d for d in shape)
        space = "__device__ __align__(16) const" if ctype == "int8_t" \
            else "__constant__"
        lines.append("// " + _NOTES[name])
        lines.append("%s %s %s%s = {%s};" % (space, ctype, name, dims,
                                             ", ".join(map(str, vals))))
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    with open(OUT, "w") as f:
        f.write(source())
    print(OUT)
