"""Custom quantization matrices and deadzones (port of ops/cqm.py, x264
--cqm / --cqm4* / --cqm8* / --deadzone-*: common/set.c x264_cqm_init and
the set.h preset tables).

The reference keeps the active CQM as process state: it swaps the module
tables of its transform ops and retraces. The port keeps no such state.
A `QuantTables` is built once per `Encoder` from its Params and passed
to every op and kernel wrapper that quantizes; `FLAT` (the flat lists
and x264's default deadzones) is the default wherever a caller passes
none. So two encoders with different quantizers run side by side in one
process.

A `QuantTables` is immutable. It holds the four raster lists, the
deadzone numerators, the 4x4 and 8x8 quant/dequant tables per class
(index 0 intra, 1 inter, as the reference's 8x8 tables), the trellis's
zigzag tables derived from them, and, made on first use and kept on the
object, the device copies the kernels read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import transform as T
from . import transform8 as T8

# JVT sample matrices (x264 common/set.h x264_cqm_jvt*; the spec's
# Default_4x4/8x8 lists), raster order
JVT4I = np.array([
    6, 13, 20, 28,
    13, 20, 28, 32,
    20, 28, 32, 37,
    28, 32, 37, 42], np.int64)
JVT4P = np.array([
    10, 14, 20, 24,
    14, 20, 24, 27,
    20, 24, 27, 30,
    24, 27, 30, 34], np.int64)
JVT8I = np.array([
    6, 10, 13, 16, 18, 23, 25, 27,
    10, 11, 16, 18, 23, 25, 27, 29,
    13, 16, 18, 23, 25, 27, 29, 31,
    16, 18, 23, 25, 27, 31, 33, 36,
    18, 23, 25, 27, 31, 33, 36, 38,
    23, 25, 27, 31, 33, 36, 38, 40,
    25, 27, 31, 33, 36, 38, 40, 42,
    27, 29, 31, 36, 38, 40, 42, 42], np.int64)
JVT8P = np.array([
    9, 13, 15, 17, 19, 21, 22, 24,
    13, 13, 17, 19, 21, 22, 24, 25,
    15, 17, 19, 21, 22, 24, 25, 27,
    17, 19, 21, 22, 24, 25, 27, 28,
    19, 21, 22, 24, 25, 27, 28, 30,
    21, 22, 24, 25, 27, 28, 30, 32,
    22, 24, 25, 27, 28, 30, 32, 33,
    24, 25, 27, 28, 30, 32, 33, 35], np.int64)


def _norm(v, n: int):
    """A raster list as int64 [n], or None when absent or flat (16)."""
    if v is None:
        return None
    a = np.asarray(v, np.int64).reshape(-1)
    if a.size != n or not ((a > 0) & (a <= 255)).all():
        raise ValueError("scaling list must be %d values in 1..255" % n)
    if (a == 16).all():
        return None
    a.flags.writeable = False
    return a


def _frozen(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.flags.writeable = False
    return a


def _mf_unq(mf: np.ndarray):
    """(mf, unq) int32 with unq = round(2^24 / mf), so that (lvl * unq +
    128) >> 8 inverts lvl = coef * mf >> 16 (rdo.c:405-410)."""
    mf = mf.astype(np.int64)
    unq = np.round((1 << 24) / np.maximum(mf, 1)).astype(np.int64)
    return _frozen(mf.astype(np.int32)), _frozen(unq.astype(np.int32))


class QuantTables:
    """The quantizer of one encoder: lists (intra4, inter4, intra8,
    inter8), raster, None = flat; dz_intra / dz_inter the deadzone bias
    numerators (x264 set.c:76, 32 - deadzone; defaults 21 / 11).

    mf4, bias4 [2, 52, 4, 4] and dmf4 [2, 6, 4, 4] int32; mf8, bias8
    [2, 52, 8, 8] and dmf8 [2, 6, 8, 8] int32; class 0 intra, 1 inter."""

    def __init__(self, intra4=None, inter4=None, intra8=None, inter8=None,
                 dz_intra: int = 21, dz_inter: int = 11):
        self.lists = (_norm(intra4, 16), _norm(inter4, 16),
                      _norm(intra8, 64), _norm(inter8, 64))
        self.dz_intra, self.dz_inter = int(dz_intra), int(dz_inter)
        i4, p4, i8, p8 = self.lists
        mf_i, bias_i, _, dmf_i = T._build_tables(i4, deadzone_intra=dz_intra)
        mf_p, _, bias_p, dmf_p = T._build_tables(p4, deadzone_inter=dz_inter)
        self.mf4 = _frozen(np.stack([mf_i, mf_p]))
        self.bias4 = _frozen(np.stack([bias_i, bias_p]))
        self.dmf4 = _frozen(np.stack([dmf_i, dmf_p]))
        mf8, bias8, dmf8 = T8.build_tables8(i8, p8, dz_intra, dz_inter)
        self.mf8, self.bias8, self.dmf8 = (_frozen(mf8), _frozen(bias8),
                                           _frozen(dmf8))
        self._memo = {}

    @property
    def key(self) -> tuple:
        return (tuple(None if a is None else a.tobytes()
                      for a in self.lists), self.dz_intra, self.dz_inter)

    def __eq__(self, other) -> bool:
        return isinstance(other, QuantTables) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        names = ("i4", "p4", "i8", "p8")
        lists = [n for n, a in zip(names, self.lists) if a is not None]
        return "QuantTables(lists=%s, dz=%d/%d)" % (
            ",".join(lists) or "flat", self.dz_intra, self.dz_inter)

    @property
    def is_flat(self) -> bool:
        """No list differs from flat (the SPS then carries none)."""
        return all(a is None for a in self.lists)

    def zig4(self):
        """The trellis's 4x4 tables in zigzag order: (mf, unq) [2, 52,
        16] int32 (the reference's `_mf_unq_zig`)."""
        if "zig4" not in self._memo:
            zz = T.ZIGZAG_4x4
            self._memo["zig4"] = _mf_unq(self.mf4[:, :, zz[:, 0], zz[:, 1]])
        return self._memo["zig4"]

    def zig8(self):
        """The trellis's 8x8 tables in zigzag8 order: (mf, unq) [2, 52,
        64] int32 (the reference's `_mf_unq_zig8`)."""
        if "zig8" not in self._memo:
            zz = T8.ZIGZAG_8x8
            self._memo["zig8"] = _mf_unq(self.mf8[:, :, zz[:, 0], zz[:, 1]])
        return self._memo["zig8"]

    def dev(self, name: str, device) -> torch.Tensor:
        """This object's table `name` (an attribute, or "zig4mf",
        "zig4unq", "zig8mf", "zig8unq") as a tensor on `device`, made
        once per device."""
        k = (name, device)
        t = self._memo.get(k)
        if t is None:
            if name.startswith("zig"):
                arr = (self.zig4() if name[3] == "4" else self.zig8())[
                    0 if name.endswith("mf") else 1]
            else:
                arr = getattr(self, name)
            t = self._memo[k] = torch.as_tensor(np.array(arr),
                                                device=torch.device(device))
        return t

    def qtab(self, qp: int, device) -> torch.Tensor:
        """The inter tables at qp as one int32 [48] tensor on `device`:
        mf [16] | bias [16] | dequant mf [16], each in (4r + c) order,
        the constants of the fused luma kernel and of B4."""
        k = ("qtab", qp, device)
        t = self._memo.get(k)
        if t is None:
            arr = np.concatenate([self.mf4[1, qp].reshape(16),
                                  self.bias4[1, qp].reshape(16),
                                  self.dmf4[1, qp % 6].reshape(16)])
            t = self._memo[k] = torch.as_tensor(arr.astype(np.int32),
                                                device=torch.device(device))
        return t

    def qtab_all(self, device) -> torch.Tensor:
        """`qtab` of every qp as one int32 [52, 48] slab on `device` (the
        fused luma kernel's tables under a per-MB qp grid)."""
        k = ("qtab_all", device)
        t = self._memo.get(k)
        if t is None:
            t = self._memo[k] = torch.stack(
                [self.qtab(q, device) for q in range(52)]).contiguous()
        return t


FLAT = QuantTables()


def from_params(p) -> QuantTables:
    """The reference Encoder's lists and deadzones (core.py:298-312):
    `jvt` fills every list the user left unset with the JVT matrix;
    the bias numerators are 32 - deadzone."""
    if p.cqm == "jvt":
        lists = [p.cqm4i if p.cqm4i is not None else JVT4I,
                 p.cqm4p if p.cqm4p is not None else JVT4P,
                 p.cqm8i if p.cqm8i is not None else JVT8I,
                 p.cqm8p if p.cqm8p is not None else JVT8P]
    elif p.cqm == "flat":
        lists = [p.cqm4i, p.cqm4p, p.cqm8i, p.cqm8p]
    else:
        raise ValueError("unknown cqm preset %r" % p.cqm)
    qt = QuantTables(*lists, dz_intra=32 - p.deadzone_intra,
                     dz_inter=32 - p.deadzone_inter)
    return FLAT if qt == FLAT else qt
