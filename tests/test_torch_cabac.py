"""The port's CABAC modules against the JAX package's, with no encoder in
the loop: the native `write_slice_cabac` against the port's and the JAX
package's `CabacSliceWriter` on the same seeded syntax (I slices with
I_16x16/I_NxN, with and without the 8x8 transform; P slices with skips,
every partition, large MVDs and levels, with and without the 8x8
transform; the 16x16-only form), byte-equal; the port's CABAC I/P
decoder against the JAX decoder on x264's own CABAC streams (frames, MB
types and unit MVs equal); `ssim_wxh` and `psnr_from_ssd` against the
JAX functions."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder.cabac import (
    CabacSliceWriter as JWriter)
from video_steganography_pcamv_tpu.ops import pixel as JPX
from video_steganography_pcamv_tpu.utils.bitstream import (
    BitWriter as JBitWriter)

from video_steganography_pcamv_torch import native
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder.cabac import (
    CabacSliceWriter as TWriter)
from video_steganography_pcamv_torch.ops import pixel as TPX
from video_steganography_pcamv_torch.utils.bitstream import (
    BitWriter as TBitWriter)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFSTREAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "refstreams")
MBH, MBW = 3, 5
SLICE_I, SLICE_P = 2, 0


def _levels(rng, shape, p_nz=0.15):
    """Sparse levels, mostly small, some past CABAC's unary prefix
    (|level| > 15) and a few large (|level| > 127)."""
    mag = rng.geometric(0.45, shape)
    big = rng.rand(*shape) < 0.03
    mag = np.where(big, rng.randint(16, 400, shape), mag)
    sign = np.where(rng.rand(*shape) < 0.5, -1, 1)
    return np.where(rng.rand(*shape) < p_nz, sign * mag, 0).astype(np.int32)


def _syntax(seed, slice_type, trans8, p16=False):
    """One slice's syntax for MBH x MBW MBs, consistent the way an
    encoder's is: cbp bits match the levels, an uncoded block holds no
    levels, an 8x8-transform block is coded iff it has a level."""
    rng = np.random.RandomState(seed)
    n = MBH * MBW
    s = {"luma_lev": _levels(rng, (n, 4, 4, 4, 4)),
         "chroma_dc": _levels(rng, (n, 2, 2, 2), 0.4),
         "chroma_ac": _levels(rng, (n, 2, 2, 2, 4, 4))}
    s["chroma_ac"][..., 0, 0] = 0
    l8 = _levels(rng, (n, 2, 2, 8, 8), 0.08)
    # 8x8 blocks, in (by8, bx8) order, of the 4x4 levels
    blk8 = s["luma_lev"].reshape(n, 2, 2, 2, 2, 16).transpose(
        0, 1, 3, 2, 4, 5).reshape(n, 4, 64)
    if slice_type == SLICE_I:
        s["mb_i4"] = (rng.rand(n) < 0.5).astype(np.uint8)
        s["mb_i8"] = ((rng.rand(n) < 0.5) & (s["mb_i4"] == 0) & trans8) \
            .astype(np.uint8)
        s["mode"] = rng.randint(0, 4, n).astype(np.int32)
        s["i4_modes"] = rng.randint(0, 9, (n, 16)).astype(np.int32)
        s["i8_modes"] = rng.randint(0, 9, (n, 4)).astype(np.int32)
        s["luma_dc"] = _levels(rng, (n, 4, 4), 0.5)
        i16 = (s["mb_i4"] == 0) & (s["mb_i8"] == 0)
        s["luma_lev"][..., 0, 0] = np.where(i16[:, None, None], 0,
                                            s["luma_lev"][..., 0, 0])
        has_ac = (s["luma_lev"].reshape(n, 256) != 0).any(1)
        cbp4 = ((blk8 != 0).any(2) * (1 << np.arange(4))).sum(1)
        cbp8 = ((l8.reshape(n, 4, 64) != 0).any(2)
                * (1 << np.arange(4))).sum(1)
        s["cbp_luma"] = np.where(s["mb_i8"] == 1, cbp8,
                                 np.where(i16, 15 * has_ac, cbp4))
        s["cmode"] = rng.randint(0, 4, n).astype(np.int32)
    else:
        s["skip"] = (rng.rand(n) < 0.3).astype(np.uint8)
        s["part"] = (np.zeros(n, np.int32) if p16
                     else rng.randint(0, 4, n).astype(np.int32))
        mvd = rng.randint(-12, 13, (n, 4, 2))
        mvd = np.where(rng.rand(n, 4, 2) < 0.1,
                       rng.randint(-300, 301, (n, 4, 2)), mvd)
        nu = np.array([1, 2, 2, 4])[s["part"]]
        mvd[np.arange(4)[None, :] >= nu[:, None]] = 0
        s["mvd4"] = mvd.astype(np.int32)
        s["trans8"] = ((rng.rand(n) < 0.5) & trans8).astype(np.int32)
        cbp4 = ((blk8 != 0).any(2) * (1 << np.arange(4))).sum(1)
        # a coded 8x8 block keeps its 4x4s only where they have levels
        drop = rng.rand(n, 4) < 0.3
        cbp4 &= ~(drop * (1 << np.arange(4))).sum(1)
        cbp8 = ((l8.reshape(n, 4, 64) != 0).any(2)
                * (1 << np.arange(4))).sum(1)
        s["cbp_luma"] = np.where(s["trans8"] == 1, cbp8, cbp4)
        for b in range(4):
            off = ((s["cbp_luma"] >> b) & 1) == 0
            by8, bx8 = b >> 1, b & 1
            blk = s["luma_lev"][:, 2 * by8:2 * by8 + 2,
                                2 * bx8:2 * bx8 + 2]
            blk[off | (s["trans8"] == 1)] = 0
            l8[:, by8, bx8][off | (s["trans8"] == 0)] = 0
    has_cac = (s["chroma_ac"].reshape(n, -1) != 0).any(1)
    has_cdc = (s["chroma_dc"].reshape(n, -1) != 0).any(1)
    s["cbp_chroma"] = np.where(has_cac, 2, np.where(has_cdc, 1, 0))
    s["chroma_ac"][s["cbp_chroma"] < 2] = 0
    s["luma8_lev"] = l8
    s["cbp_luma"] = s["cbp_luma"].astype(np.int32)
    s["cbp_chroma"] = s["cbp_chroma"].astype(np.int32)
    return s


def _header(bw_cls):
    bw = bw_cls()
    for b in (1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1):
        bw.write1(b)
    return bw


def _write_native(s, slice_type, trans8, qp):
    n = MBH * MBW
    hdr, nbits = _header(TBitWriter).partial_bytes()
    kw = dict(cbp_luma=s["cbp_luma"], cbp_chroma=s["cbp_chroma"],
              luma_blocks=s["luma_lev"].reshape(n, 16, 16),
              chroma_dc=s["chroma_dc"].reshape(n, 2, 4),
              chroma_ac=s["chroma_ac"].reshape(n, 2, 4, 16),
              luma8_lev=s["luma8_lev"].reshape(n, 256) if trans8 else None,
              trans8_mode=trans8)
    if slice_type == SLICE_I:
        kw.update(mode=s["mode"], cmode=s["cmode"],
                  luma_dc=s["luma_dc"].reshape(n, 16), mb_i4=s["mb_i4"],
                  i4_modes=s["i4_modes"],
                  mb_i8=s["mb_i8"] if trans8 else None,
                  i8_modes=s["i8_modes"] if trans8 else None)
    else:
        kw.update(skip=s["skip"], part=s["part"], mvd4=s["mvd4"],
                  trans8=s["trans8"] if trans8 else None)
    return native.write_slice_cabac(hdr, nbits, slice_type, MBW, MBH, qp,
                                    **kw)


def _write_python(writer_cls, bw_cls, s, slice_type, trans8, qp):
    """The reference's Python CABAC slice loop (its writers' oracle,
    encoder/core.py `_write_i_slice_cabac` / `_write_p_slice_cabac`)."""
    bw = _header(bw_cls)
    while not bw.byte_aligned():
        bw.write1(1)
    is_i = slice_type == SLICE_I
    w = writer_cls(MBW, MBH, qp, slice_is_i=is_i, trans8_mode=trans8)
    n = MBH * MBW
    for a in range(n):
        my, mx = a // MBW, a % MBW
        cbpl, cbpc = int(s["cbp_luma"][a]), int(s["cbp_chroma"][a])
        cdc = s["chroma_dc"][a]
        cac = s["chroma_ac"][a]
        if is_i and trans8 and s["mb_i8"][a]:
            w.write_i8_mb(my, mx, s["i8_modes"][a], int(s["cmode"][a]),
                          cbpl, cbpc, s["luma8_lev"][a], cdc, cac)
        elif is_i and s["mb_i4"][a]:
            w.write_i4_mb(my, mx, s["i4_modes"][a], int(s["cmode"][a]),
                          cbpl, cbpc, s["luma_lev"][a], cdc, cac)
        elif is_i:
            w.write_i16_mb(my, mx, int(s["mode"][a]), int(s["cmode"][a]),
                           cbpl != 0, cbpc, s["luma_dc"][a],
                           s["luma_lev"][a], cdc, cac)
        elif s["skip"][a]:
            w.write_skip_mb(my, mx)
        else:
            w.write_p_mb(my, mx, int(s["part"][a]), s["mvd4"][a], cbpl,
                         cbpc, s["luma_lev"][a], cdc, cac,
                         trans8=bool(trans8 and s["trans8"][a]),
                         luma8_lev=s["luma8_lev"][a] if trans8 else None)
        w.end_mb(a == n - 1)
    w.end_slice(bw)
    return bw.get_bytes()


@pytest.mark.parametrize("slice_type,trans8,p16,qp,seed", [
    (SLICE_I, False, False, 26, 1), (SLICE_I, True, False, 30, 2),
    (SLICE_P, False, False, 26, 3), (SLICE_P, True, False, 20, 4),
    (SLICE_P, False, True, 38, 5)],
    ids=["i", "i_trans8", "p", "p_trans8", "p16x16"])
def test_native_writer_matches_python_writers(slice_type, trans8, p16, qp,
                                              seed):
    s = _syntax(seed, slice_type, trans8, p16)
    got = _write_native(s, slice_type, trans8, qp)
    port_py = _write_python(TWriter, TBitWriter, s, slice_type, trans8, qp)
    jax_py = _write_python(JWriter, JBitWriter, s, slice_type, trans8, qp)
    assert got == port_py == jax_py
    assert len(got) > 100


@pytest.mark.parametrize("name", ["cabac_q26.264", "cabac_q40.264",
                                  "dct8_q26.264", "dct8_trellis.264",
                                  "subme7.264"])
def test_cabac_decoder_matches_reference(name):
    """x264's CABAC I/P streams (96x64, 8 frames; the 8x8 transform,
    trellis, sub-8x8 partitions)."""
    with open(os.path.join(REFSTREAMS, name), "rb") as f:
        data = f.read()
    got, want = decode_annexb(data), j_decode(data)
    assert len(got) == len(want) == 8
    assert {g.slice_type % 5 for g in got} == {0, 2}
    for g, w in zip(got, want):
        assert g.slice_type == w.slice_type
        assert [m.mb_type for m in g.mbs] == [m.mb_type for m in w.mbs]
        assert [m.unit_mvs for m in g.mbs] == [m.unit_mvs for m in w.mbs]
        for plane in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(g, plane),
                                          getattr(w, plane))


@pytest.mark.parametrize("h,w,seed", [(78, 110, 0), (70, 118, 1),
                                      (64, 64, 2)])
def test_ssim_wxh_matches_reference(h, w, seed):
    """The window sums are integers and the formula float32 in the
    reference's order; only the final sum's order differs, so the sum
    is held to rtol 1e-5 (x264's SSIM is a float32 sum too)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, 256, (h, w))
    rec = np.clip(src + rng.randint(-12, 13, (h, w)), 0, 255)
    rec[: h // 3] = src[: h // 3]        # some windows at SSIM 1
    want = float(JPX.ssim_wxh(jnp.asarray(rec, jnp.int32),
                              jnp.asarray(src, jnp.int32)))
    got = TPX.ssim_wxh(torch.as_tensor(rec.astype(np.uint8)),
                       torch.as_tensor(src.astype(np.int32)))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_psnr_from_ssd_matches_reference():
    for ssd, npix in ((0, 100), (1, 8960), (123456789, 2088960),
                      (136 * 1920 * 1088, 1920 * 1088)):
        assert TPX.psnr_from_ssd(ssd, npix) == JPX.psnr_from_ssd(ssd, npix)
