"""ctypes loader for the port's native host back-end.

`pcamv_native.cpp` (the CAVLC I/P slice writer and the 16x16 B one, the
partition MVP / P_SKIP scans with references and the 16x16 ones, the STC
embedder) and `cabac.cpp` (the CABAC I/P slice writer and the 16x16 B
one) are the port's copies of the reference package's C++ sources. It
is compiled with g++ at first use into `build/torch_native/` at the
repository root (git-ignored); the library name carries a hash of the
sources and flags, so an edit rebuilds it. A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "torch_native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_SOURCES = ("pcamv_native.cpp", "cabac.cpp")

_lib = None
build_seconds = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in [os.path.join(_DIR, s) for s in _SOURCES] + sorted(
            glob.glob(os.path.join(_DIR, "*.inc"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, "pcamv_native_%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the library if the one for these sources is missing;
    returns its path."""
    global build_seconds
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the port's native library needs g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    t0 = time.time()
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           *[os.path.join(_DIR, s) for s in _SOURCES]]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("g++ failed (%d):\n%s\n%s"
                           % (r.returncode, " ".join(cmd), r.stderr))
    os.replace(tmp, out)
    build_seconds = time.time() - t0
    return out


def load() -> ctypes.CDLL:
    """The native library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    vp = ctypes.c_void_p
    ci = ctypes.c_int

    lib.pcamv_write_slice.restype = ctypes.c_long
    lib.pcamv_write_slice.argtypes = [
        u8p, ctypes.c_long, u8p, ci, ci, ci, ci,
        vp, vp, vp, i32p, i32p, vp, i32p, i32p, i32p, vp, vp, vp, vp,
        vp, ci, vp, ci, vp, vp, vp, vp, ci, vp, ci, vp]
    lib.pcamv_write_slice_cabac.restype = ctypes.c_long
    lib.pcamv_write_slice_cabac.argtypes = [
        u8p, ctypes.c_long, u8p, ci, ci, ci, ci, ci, ci,
        vp, vp, vp, vp, vp, i32p, i32p, vp, i32p, i32p, i32p,
        vp, vp, vp, ci, vp, ci, vp, vp, vp, vp, ci, vp, vp]
    lib.pcamv_write_slice_b.restype = ctypes.c_long
    lib.pcamv_write_slice_b.argtypes = [
        u8p, ctypes.c_long, u8p, ci, ci, ci] + [i32p] * 8
    lib.pcamv_write_slice_cabac_b.restype = ctypes.c_long
    lib.pcamv_write_slice_cabac_b.argtypes = [
        u8p, ctypes.c_long, u8p, ci, ci, ci, ci, ci] + [i32p] * 8
    lib.pcamv_scan_p_parts.restype = None
    lib.pcamv_scan_p_parts.argtypes = [
        i32p, i32p, i32p, i32p, ci, ci, vp, u8p, i32p, i32p, i32p, vp]
    lib.pcamv_scan_p_parts_forced.restype = None
    lib.pcamv_scan_p_parts_forced.argtypes = [
        i32p, i32p, u8p, ci, ci, i32p, i32p, i32p, vp]
    lib.pcamv_host_scan_p.restype = None
    lib.pcamv_host_scan_p.argtypes = [i32p, i32p, i32p, ci, ci, u8p, i32p,
                                      i32p]
    lib.pcamv_host_scan_p_forced.restype = None
    lib.pcamv_host_scan_p_forced.argtypes = [i32p, u8p, ci, ci, i32p, i32p]
    lib.pcamv_stc_embed.restype = ctypes.c_int
    lib.pcamv_stc_embed.argtypes = [
        u8p, ctypes.c_long, u8p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ci, ctypes.POINTER(ctypes.c_uint32),
        u8p, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _as_i32(x):
    return np.ascontiguousarray(x, np.int32)


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _as_u8(a, n: int):
    """A per-MB flag array as a contiguous uint8 [n] array, or None."""
    return None if a is None else np.ascontiguousarray(a, np.uint8).reshape(n)


def _grid(qp_grid, n: int):
    """A per-MB qp grid as a contiguous int32 [n] array, or None."""
    return None if qp_grid is None else _as_i32(qp_grid).reshape(n)


def write_slice(header_bytes: bytes, header_nbits: int, slice_type: int,
                mbw: int, mbh: int, *, skip=None, mode=None, cmode=None,
                cbp_luma, cbp_chroma, luma_dc=None, luma_blocks, chroma_dc,
                chroma_ac, mb_i4=None, i4_modes=None, part=None,
                mvd4=None, refs=None, num_ref: int = 1, sub_type=None,
                mb_i8=None,
                i8_modes=None, luma8_lev=None, trans8=None,
                trans8_mode: bool = False, qp_grid=None,
                slice_qp: int = 0, p_intra=None) -> bytes:
    """Native whole-slice CAVLC entropy coding (I slices, and P slices
    with partitions and one or more references). Shapes: luma_blocks
    [N,16,16], luma_dc [N,16], chroma_dc [N,2,4], chroma_ac [N,2,4,16],
    mb_i4 [N] u8, i4_modes [N,16], part [N], mvd4 [N,4,2], refs [N,4]
    the L0 index of each ref slot (coded when num_ref > 1; None: all 0,
    as `_refs4` in the encoder lays them out); sub_type [N,4] each P_8x8
    block's sub_mb_type, mvd4 then [N,16,2] the units in coding order
    (an MB with a sub-partition under 8x8 codes no
    transform_size_8x8_flag). High-profile 8x8
    transform (`trans8_mode`, the PPS flag): mb_i8 [N] u8, i8_modes
    [N,4], luma8_lev [N,2,2,8,8] raster (zigzag-scanned here), trans8
    [N] u8. Adaptive quantization: qp_grid [N] each MB's qp, written as
    the folded mb_qp_delta against the last coded qp (from slice_qp, the
    header's) wherever an MB codes one (None: every delta 0). Intra MBs
    in a P slice (stego off): p_intra [N] u8 marks them, and they take
    mode, cmode, luma_dc, mb_i4 and i4_modes and the residual arrays at
    their index, as an I slice's MBs do."""
    lib = load()
    n = mbw * mbh
    hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
    skip_a = (np.ascontiguousarray(skip, np.uint8)
              if skip is not None else None)
    mode_a = _as_i32(mode) if mode is not None else None
    cmode_a = _as_i32(cmode) if cmode is not None else None
    dc_a = _as_i32(luma_dc) if luma_dc is not None else None
    i4_a = (np.ascontiguousarray(mb_i4, np.uint8)
            if mb_i4 is not None else None)
    i4m_a = (_as_i32(i4_modes).reshape(n * 16)
             if i4_modes is not None else None)
    part_a = _as_i32(part).reshape(n) if part is not None else None
    stride = 16 if sub_type is not None else 4
    mvd4_a = (_as_i32(mvd4).reshape(n * 2 * stride)
              if mvd4 is not None else None)
    sub_a = _as_i32(sub_type).reshape(n * 4) if sub_type is not None \
        else None
    refs_a = _as_i32(refs).reshape(n * 4) if refs is not None else None
    i8_a = (np.ascontiguousarray(mb_i8, np.uint8).reshape(n)
            if mb_i8 is not None else None)
    i8m_a = _as_i32(i8_modes).reshape(n * 4) if i8_modes is not None \
        else None
    l8_a = None
    if luma8_lev is not None:
        from ..ops.transform8 import ZIGZAG_8x8_FLAT
        l8_a = np.ascontiguousarray(_as_i32(luma8_lev).reshape(n, 4, 64)
                                    [:, :, ZIGZAG_8x8_FLAT].reshape(n * 256))
    t8_a = (np.ascontiguousarray(trans8, np.uint8).reshape(n)
            if trans8 is not None else None)
    grid_a = _grid(qp_grid, n)
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        r = lib.pcamv_write_slice(
            out, cap, hdr, header_nbits, slice_type, mbw, mbh,
            _ptr(skip_a), _ptr(mode_a), _ptr(cmode_a),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            _ptr(dc_a), _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128),
            _ptr(i4_a), _ptr(i4m_a), _ptr(part_a), _ptr(mvd4_a),
            _ptr(refs_a), num_ref, _ptr(sub_a), stride, _ptr(i8_a),
            _ptr(i8m_a), _ptr(l8_a), _ptr(t8_a), 1 if trans8_mode else 0,
            _ptr(grid_a), slice_qp, _ptr(_as_u8(p_intra, n)))
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native slice writer overflow")


def write_slice_cabac(header_bytes: bytes, header_nbits: int,
                      slice_type: int, mbw: int, mbh: int, qp: int, *,
                      model: int = 0, skip=None, part=None, mvd4=None,
                      mode=None, cmode=None, cbp_luma, cbp_chroma,
                      luma_dc=None, luma_blocks, chroma_dc, chroma_ac,
                      mb_i4=None, i4_modes=None, refs=None,
                      num_ref: int = 1, sub_type=None, mb_i8=None,
                      i8_modes=None, luma8_lev=None, trans8=None,
                      trans8_mode: bool = False, qp_grid=None,
                      p_intra=None) -> bytes:
    """Native whole-slice CABAC entropy coding of an I or P slice (twin
    of encoder/cabac.py's CabacSliceWriter, bit-identical). Shapes as
    in `write_slice`, except: luma8_lev [N, 256] raster (the writer
    scans it), refs [N, 4] per-ref-slot L0 refs (coded when num_ref >
    1), sub_type [N, 4] with mvd4 then [N, 16, 2] per sub-unit; qp_grid
    [N] as in `write_slice` (the chain starts at qp), its mb_qp_delta
    contexts following the previous MB's delta; p_intra as in
    `write_slice`."""
    lib = load()
    n = mbw * mbh
    hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
    skip_a = (np.ascontiguousarray(skip, np.uint8)
              if skip is not None else None)
    part_a = _as_i32(part).reshape(n) if part is not None else None
    stride = 16 if sub_type is not None else 4
    mvd4_a = (_as_i32(mvd4).reshape(n * 2 * stride)
              if mvd4 is not None else None)
    sub_a = _as_i32(sub_type).reshape(n * 4) if sub_type is not None \
        else None
    mode_a = _as_i32(mode).reshape(n) if mode is not None else None
    cmode_a = _as_i32(cmode).reshape(n) if cmode is not None else None
    dc_a = _as_i32(luma_dc).reshape(n * 16) if luma_dc is not None \
        else None
    i4_a = (np.ascontiguousarray(mb_i4, np.uint8)
            if mb_i4 is not None else None)
    i4m_a = (_as_i32(i4_modes).reshape(n * 16)
             if i4_modes is not None else None)
    refs_a = _as_i32(refs).reshape(n * 4) if refs is not None else None
    i8_a = (np.ascontiguousarray(mb_i8, np.uint8)
            if mb_i8 is not None else None)
    i8m_a = _as_i32(i8_modes).reshape(n * 4) if i8_modes is not None \
        else None
    l8_a = _as_i32(luma8_lev).reshape(n * 256) if luma8_lev is not None \
        else None
    t8_a = _as_i32(trans8).reshape(n) if trans8 is not None else None
    grid_a = _grid(qp_grid, n)
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        r = lib.pcamv_write_slice_cabac(
            out, cap, hdr, header_nbits, slice_type, mbw, mbh, qp, model,
            _ptr(skip_a), _ptr(part_a), _ptr(mvd4_a), _ptr(mode_a),
            _ptr(cmode_a), _as_i32(cbp_luma).reshape(n),
            _as_i32(cbp_chroma).reshape(n), _ptr(dc_a),
            _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128),
            _ptr(i4_a), _ptr(i4m_a), _ptr(refs_a), num_ref,
            _ptr(sub_a), stride, _ptr(i8_a), _ptr(i8m_a), _ptr(l8_a),
            _ptr(t8_a), 1 if trans8_mode else 0, _ptr(grid_a),
            _ptr(_as_u8(p_intra, n)))
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native cabac writer overflow")


def _write_b(entry: str, args, mode, mvd0, mvd1, cbp_luma, cbp_chroma,
             luma_blocks, chroma_dc, chroma_ac, n: int) -> bytes:
    cap = 1 << 22
    while True:
        out = np.zeros(cap, np.uint8)
        r = getattr(load(), entry)(
            out, cap, *args, _as_i32(mode).reshape(n),
            _as_i32(mvd0).reshape(n * 2), _as_i32(mvd1).reshape(n * 2),
            _as_i32(cbp_luma).reshape(n), _as_i32(cbp_chroma).reshape(n),
            _as_i32(luma_blocks).reshape(n * 256),
            _as_i32(chroma_dc).reshape(n * 8),
            _as_i32(chroma_ac).reshape(n * 128))
        if r >= 0:
            return bytes(out[:r])
        cap *= 4
        if cap > (1 << 28):
            raise RuntimeError("native %s overflow" % entry)


def write_slice_b(header_bytes: bytes, header_nbits: int, mbw: int,
                  mbh: int, *, mode, mvd0, mvd1, cbp_luma, cbp_chroma,
                  luma_blocks, chroma_dc, chroma_ac) -> bytes:
    """Native CAVLC B slice of 16x16 MBs at one reference (twin of the
    encoder's `_write_b_slice_cavlc` with `encoder/cavlc.py`): mode [N]
    codes 0-3 (0 with no residual is a B_Skip in mb_skip_run), mvd0/mvd1
    [N, 2]; the residual shapes as in `write_slice`."""
    hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
    return _write_b("pcamv_write_slice_b", (hdr, header_nbits, mbw, mbh),
                    mode, mvd0, mvd1, cbp_luma, cbp_chroma, luma_blocks,
                    chroma_dc, chroma_ac, mbw * mbh)


def write_slice_cabac_b(header_bytes: bytes, header_nbits: int, mbw: int,
                        mbh: int, qp: int, *, model: int = 0, mode, mvd0,
                        mvd1, cbp_luma, cbp_chroma, luma_blocks, chroma_dc,
                        chroma_ac) -> bytes:
    """Native CABAC B slice of 16x16 MBs at one reference (twin of the
    encoder's `_write_b_slice_cabac` with `encoder/cabac.py`); arguments
    as in `write_slice_b`."""
    hdr = np.frombuffer(header_bytes + b"\0" * 8, np.uint8).copy()
    return _write_b("pcamv_write_slice_cabac_b",
                    (hdr, header_nbits, mbw, mbh, qp, model), mode, mvd0,
                    mvd1, cbp_luma, cbp_chroma, luma_blocks, chroma_dc,
                    chroma_ac, mbw * mbh)


def scan_p_parts(part, mv8, cbp_luma, cbp_chroma, intra=None, ref8=None):
    """Pass-1 MVP / P_SKIP scan of a partitioned P frame (twin of the
    reference's scan.py scan_p_frame), with the same-reference MVP rules
    when ref8 [2mbh, 2mbw] is given (None: every block on reference 0);
    intra [mbh, mbw] MBs, if any, carry no MV. Returns (skip [mbh,mbw]
    bool, mvd [mbh,mbw,4,2], mvp [mbh,mbw,4,2], final8 [2mbh,2mbw,2])."""
    lib = load()
    mbh, mbw = part.shape
    skip = np.zeros(mbh * mbw, np.uint8)
    mvd = np.zeros(mbh * mbw * 8, np.int32)
    mvp = np.zeros(mbh * mbw * 8, np.int32)
    final8 = np.zeros(2 * mbh * 2 * mbw * 2, np.int32)
    intra_a = (None if intra is None
               else np.ascontiguousarray(intra, np.uint8).reshape(-1))
    ref8_a = None if ref8 is None else _as_i32(ref8).reshape(-1)
    lib.pcamv_scan_p_parts(
        _as_i32(part).reshape(-1), _as_i32(mv8).reshape(-1),
        _as_i32(cbp_luma).reshape(-1), _as_i32(cbp_chroma).reshape(-1),
        mbw, mbh, _ptr(intra_a), skip, mvd, mvp, final8, _ptr(ref8_a))
    return (skip.reshape(mbh, mbw).astype(bool),
            mvd.reshape(mbh, mbw, 4, 2), mvp.reshape(mbh, mbw, 4, 2),
            final8.reshape(2 * mbh, 2 * mbw, 2))


def scan_p_parts_forced(part, mv8, skip, ref8=None):
    """Forced partition scan (twin of the reference's scan.py
    scan_p_frame_forced), with references as in `scan_p_parts`. Returns
    (final8, mvd, mvp)."""
    lib = load()
    mbh, mbw = part.shape
    final8 = np.zeros(2 * mbh * 2 * mbw * 2, np.int32)
    mvd = np.zeros(mbh * mbw * 8, np.int32)
    mvp = np.zeros(mbh * mbw * 8, np.int32)
    ref8_a = None if ref8 is None else _as_i32(ref8).reshape(-1)
    lib.pcamv_scan_p_parts_forced(
        _as_i32(part).reshape(-1), _as_i32(mv8).reshape(-1),
        np.ascontiguousarray(skip, np.uint8).reshape(-1), mbw, mbh,
        final8, mvd, mvp, _ptr(ref8_a))
    return (final8.reshape(2 * mbh, 2 * mbw, 2),
            mvd.reshape(mbh, mbw, 4, 2), mvp.reshape(mbh, mbw, 4, 2))


def host_scan_p(mv, cbp_luma, cbp_chroma):
    """Pass-1 scan of a 16x16-only P frame (twin of the reference's
    encoder/inter.py host_scan_p): skip flags, mvd and the median MVP
    from the chosen qpel MVs [mbh, mbw, 2]. Returns (skip [mbh,mbw]
    bool, mvd [mbh,mbw,2], mvp [mbh,mbw,2])."""
    lib = load()
    mbh, mbw = cbp_luma.shape
    skip = np.zeros(mbh * mbw, np.uint8)
    mvd = np.zeros(mbh * mbw * 2, np.int32)
    mvp = np.zeros(mbh * mbw * 2, np.int32)
    lib.pcamv_host_scan_p(_as_i32(mv).reshape(-1),
                          _as_i32(cbp_luma).reshape(-1),
                          _as_i32(cbp_chroma).reshape(-1), mbw, mbh, skip,
                          mvd, mvp)
    return (skip.reshape(mbh, mbw).astype(bool), mvd.reshape(mbh, mbw, 2),
            mvp.reshape(mbh, mbw, 2))


def host_scan_p_forced(mv, skip):
    """Pass-2 scan of a 16x16-only P frame with the skip flags forced
    (twin of the reference's host_scan_p_forced): skipped MBs take the
    P_SKIP vector of the new MV context. Returns (final_mv [mbh,mbw,2],
    mvd [mbh,mbw,2])."""
    lib = load()
    mbh, mbw = skip.shape
    final = np.zeros(mbh * mbw * 2, np.int32)
    mvd = np.zeros(mbh * mbw * 2, np.int32)
    lib.pcamv_host_scan_p_forced(
        _as_i32(mv).reshape(-1), np.ascontiguousarray(skip, np.uint8)
        .reshape(-1), mbw, mbh, final, mvd)
    return final.reshape(mbh, mbw, 2), mvd.reshape(mbh, mbw, 2)


def stc_embed(cover, message, rho, h=10, state=None):
    """Reference-parity STC (embed.h:309-548). `state` is a
    stego.stc.StcState whose persistent LCG word is advanced in place
    (the reference's static myholdrand, embed.h:134)."""
    from ..stego.stc import StcState
    lib = load()
    if state is None:
        state = StcState()
    cover = np.ascontiguousarray(cover, np.uint8)
    message = np.ascontiguousarray(message, np.uint8)
    rho32 = np.ascontiguousarray(rho, np.float32)
    stego = np.zeros(len(cover), np.uint8)
    cost = ctypes.c_double(0.0)
    hold = ctypes.c_uint32(state.holdrand & 0xFFFFFFFF)
    r = lib.pcamv_stc_embed(
        cover, len(cover), message, len(message),
        rho32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h,
        ctypes.byref(hold), stego, ctypes.byref(cost))
    state.holdrand = int(hold.value)
    if r != 0:
        raise ValueError(f"stc_embed native error {r}")
    return stego, float(cost.value)
