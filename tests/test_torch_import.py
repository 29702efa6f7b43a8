"""The port imports neither jax nor the JAX package, reads no file of
the JAX package, and its Encoder refuses what it cannot run.

The import check runs in a subprocess whose meta-path finder refuses
every `jax` and `video_steganography_pcamv_tpu` import and whose `open`
refuses every path inside the JAX package; it imports every module of
the port package and runs a tiny encode, decode and extraction, under
CAVLC, under CABAC at the reference's default Params, with two
reference frames, and with B frames (BASELINE config 4), then an IDR and
a P step of a two-stream `MultiEncoder` and a tiled P step over two CPU
tiles (`parallel.tile`). A source scan
refuses any import of the JAX package in the port or in chip_smoke.py."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from video_steganography_pcamv_torch.params import Params, StegoParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "video_steganography_pcamv_tpu"

_BLOCKED_IMPORT = textwrap.dedent("""
    import builtins, importlib, io, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "video_steganography_pcamv_tpu")

    class _Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    _open = builtins.open

    def _guarded_open(file, *a, **kw):
        if "video_steganography_pcamv_tpu" in str(file):
            raise PermissionError("blocked read: %s" % file)
        return _open(file, *a, **kw)

    sys.meta_path.insert(0, _Blocker())
    builtins.open = io.open = _guarded_open
    import numpy as np
    import torch
    # one intra-op thread, as the port's test modules run torch beside
    # the other test workers
    torch.set_num_threads(1)
    import video_steganography_pcamv_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)

    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.decoder import decode_annexb
    from video_steganography_pcamv_torch.params import Params, StegoParams
    from video_steganography_pcamv_torch.stego.extract import (
        extract_from_stream)
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(32, 32, 3, seed=1)
    for p in (Params(width=32, height=32, qp=26, me_range=16,
                     deblock_device=True, psnr=False,
                     stego=StegoParams(em_rate=4, key=3)),
              Params(width=32, height=32, cabac=True, ssim=True,
                     stego=StegoParams(em_rate=4, key=3)),
              Params(width=32, height=32, qp=26, me_range=16, ref_frames=2,
                     stego=StegoParams(em_rate=4, key=3)),
              Params(width=32, height=32, qp=26, me_range=8, cabac=True,
                     bframes=2, b_adapt=0, ref_frames=2, psnr=False,
                     transform_8x8=True, rd=1, trellis=1,
                     stego=StegoParams(em_rate=4, key=3))):
        enc = Encoder(p, device="cpu")
        bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        assert len(decode_annexb(bs)) == 3
        got = extract_from_stream(bs, em_rate=4, key=3)
        sent = enc._stego.sent_messages
        assert len(got) == len(sent) and all(
            np.array_equal(a, b) for a, b in zip(got, sent))
        if p.ssim:
            closed = enc.close()
    assert closed["psnr_y"] < 99 and closed["ssim_y"] > 0

    # the multi-stream and tile layers: an IDR and a P step of two
    # streams, and a tiled P step over two CPU tiles
    from video_steganography_pcamv_torch.encoder.multistream import (
        MultiEncoder)
    from video_steganography_pcamv_torch.parallel import tile
    me = MultiEncoder(Params(width=32, height=32, qp=26, me_range=8,
                             stego=StegoParams(em_rate=4, key=3)), 2,
                      devices=["cpu"])
    seqs = [synthetic_sequence(32, 32, 2, seed=s) for s in (1, 2)]
    steps = [me.encode_step([sq[t] for sq in seqs]) for t in range(2)]
    for s in range(2):
        bs = steps[0][s] + steps[1][s]
        assert len(decode_annexb(bs)) == 2
        got = extract_from_stream(bs, em_rate=4, key=3)
        sent = me.encs[s]._stego.sent_messages
        assert len(got) == len(sent) == 1
        assert np.array_equal(got[0], sent[0])
    f0, f1 = synthetic_sequence(32, 96, 2, seed=4)
    out = tile.p_frame_step_tiled(
        ["cpu", "cpu"], f1.y, f1.u, f1.v, f0.y, f0.u, f0.v,
        np.zeros((6, 2, 2), np.int32), qp=26, qpc=26, mbh=6, mbw=2)
    assert len(tile.halo_log) == 2 and out["mv8"].shape == (12, 4, 2)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print(len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 30


def _imported_modules(path):
    """Every module name an import statement of `path` names (relative
    imports resolved by their level only)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            out.append(node.args[0].value)
    return out


def test_source_scan_no_jax_package_import():
    files = sorted(glob.glob(os.path.join(
        ROOT, "video_steganography_pcamv_torch", "**", "*.py"),
        recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) >= 30
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in (JAX_PKG, "jax", "jaxlib")]
    assert not bad, bad


def test_every_cuda_source_is_built_and_names_its_tpu_kernel():
    """Each csrc/*.cu file is in the kernel build, exports a C entry
    point and names the TPU kernel it replaces."""
    from video_steganography_pcamv_torch import kernels
    srcs = sorted(glob.glob(os.path.join(
        ROOT, "video_steganography_pcamv_torch", "csrc", "*.cu")))
    assert len(srcs) >= 8
    assert kernels.sources() == srcs
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert 'extern "C" int pcamv_' in text, path
        assert "video_steganography_pcamv_tpu/" in text, path
        assert "_pallas" in text or "_kernel" in text, path


def test_kernel_wrappers_name_their_tpu_kernel():
    """Every wrapper of a TPU kernel names it, file and line, and counts
    its launches; B10 rides on B1's kernel and names the reference's
    wrapper of B1."""
    from video_steganography_pcamv_torch.encoder import partition, slicetype
    from video_steganography_pcamv_torch.encoder import qpel_table
    from video_steganography_pcamv_torch.ops import deblock, fullpel, probe
    from video_steganography_pcamv_torch.ops import lumap, tq4
    wrappers = {
        fullpel.fullpel_parts: "ops/pallas_kernels.py:435",
        fullpel.fullpel_search16: "ops/pallas_kernels.py:549",
        probe.qpel_tables: "ops/probe_pallas.py:221",
        probe.subpel: "ops/probe_pallas.py:301",
        probe.probe_maps: "ops/probe_pallas.py:481",
        deblock.deblock_frame: "ops/deblock_pallas.py:469",
        qpel_table.gather_windows: "encoder/qpel_table.py:64",
        tq4.dct_quant: "ops/pallas_kernels.py:175",
        tq4.deq_idct: "ops/pallas_kernels.py:204",
        partition.gather_windows8: "ops/pallas_kernels.py:259",
        lumap.luma_p_encode: "ops/pallas_kernels.py:175",
    }
    for fn, where in wrappers.items():
        doc = " ".join(fn.__doc__.split())
        assert "video_steganography_pcamv_tpu/" + where in doc, fn.__name__
        assert fn.launches >= 0
    doc = " ".join(lumap.luma_p_encode.__doc__.split())
    assert "video_steganography_pcamv_tpu/ops/pallas_kernels.py:204" in doc
    doc = " ".join(slicetype.lowres_costs_kernel.__doc__.split())
    assert "video_steganography_pcamv_tpu/encoder/slicetype.py:41" in doc


def _slice_params(**kw):
    base = dict(width=112, height=80, qp=26, me_range=16,
                deblock_device=True, psnr=False,
                stego=StegoParams(em_rate=64, key=99))
    base.update(kw)
    return Params(**base)


def test_encoder_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from video_steganography_pcamv_torch import Encoder
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(_slice_params(), device="cuda")


def test_encoder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from video_steganography_pcamv_torch import Encoder
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(_slice_params())


# adaptive quantization is served (the "aq_mode" rows check that zones,
# its A16 neighbour, stays refused beside it); so are sub-8x8 partitions,
# but not with more than one reference under the device deblock (the
# "p4x4" rows: ROADMAP F10)
_REFUSED = [
    pytest.param(dict(p4x4=True, ref_frames=2), id="p4x4"),
    pytest.param(dict(ref_frames=8, p4x4=True, cabac=True, bframes=2,
                      b_adapt=0), id="ref_frames,p4x4"),
    dict(ref_frames=2, aq_mode=1, zones="0,5,q=30"),
    dict(me_range=24),
    dict(aq_mode=1, zones="0,5,q=30"),
    dict(crf=23.0), dict(pipeline_deep=True),
    dict(zones="0,5,q=30"),
    # stego off is served with every option stego on is (sub-8x8
    # partitions and intra MBs in B slices too): rate control (A16c) and
    # zones stay refused beside it
    pytest.param(dict(stego=StegoParams(em_rate=0), p4x4=True, crf=23.0),
                 id="stego"),
    pytest.param(dict(stego=StegoParams(em_rate=0), bframes=2,
                      zones="0,5,q=30"), id="stego,bframes"),
    dict(stego=StegoParams(em_rate=64, key=99, alpha_com=0.5)),
    dict(subpel=1), dict(dct_decimate=False),
    dict(incremental=False), dict(partitions=False, deblock_device=True),
]


@pytest.mark.parametrize("kw", _REFUSED, ids=lambda kw: ",".join(
    k for k in kw if k != "zones" or "aq_mode" not in kw))
def test_encoder_rejects_options_outside_the_slice(kw):
    from video_steganography_pcamv_torch import Encoder
    with pytest.raises(NotImplementedError):
        Encoder(_slice_params(**kw), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(cabac=True), dict(psnr=True), dict(ssim=True),
    dict(deblock_device=False), dict(pipeline=False),
    dict(cabac=True, transform_8x8=True, rd=1),
    dict(cabac=True, partitions=False, deblock_device=False),
    dict(ref_frames=2), dict(cabac=True, ref_frames=2),
    dict(ref_frames=8, partitions=False), dict(bframes=2),
    dict(cabac=True, bframes=2),
    dict(bframes=2, partitions=False, deblock_device=False),
    dict(bframes=2, b_pyramid=True), dict(cabac=True, bframes=2, direct=2),
    dict(bframes=2, transform_8x8=True),
    dict(ref_frames=2, transform_8x8=True), dict(ref_frames=2, rd=1),
    dict(rd=2), dict(transform_8x8=True, partitions=False,
                     deblock_device=False),
    dict(cabac=True, bframes=2, rd=1), dict(cabac=True, trellis=1),
    dict(cabac=True, trellis=2, ref_frames=3, bframes=2, weightb=True),
    dict(aq_mode=1), dict(aq_mode=1, ref_frames=2),
    dict(stego=StegoParams(em_rate=0)),
    dict(stego=StegoParams(em_rate=0), cabac=True, ref_frames=2, rd=2,
         trellis=2, bframes=2, intra_in_p=False),
    dict(stego=StegoParams(em_rate=0), p4x4=True, rd=1),
    dict(stego=StegoParams(em_rate=0), bframes=2, b_pyramid=True),
    dict(aq_mode=1, cabac=True, bframes=2, transform_8x8=True, trellis=1),
], ids=lambda kw: ",".join(kw))
def test_encoder_accepts_the_reference_defaults_and_cabac(kw):
    """Options the port serves since it took the reference's default
    Params (PSNR on, host deblock, unpipelined) and CABAC, multiple
    reference frames (with or without partitions, either deblocker),
    B frames at the reference's default b_adapt 1 (CAVLC or CABAC, with
    or without partitions, a pyramid, temporal direct), and the 8x8
    transform, rd 1-2 and trellis 1-2 with each of those; adaptive
    quantization on the partition paths."""
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(_slice_params(**kw), device="cpu")
    assert enc.p.cabac == kw.get("cabac", False)


@pytest.mark.parametrize("kw", [
    dict(bframes=2, cqm="jvt"),
    dict(ref_frames=2, noise_reduction=100),
    dict(deadzone_inter=20), dict(cqm="jvt", partitions=False,
                                  deblock_device=False),
    dict(noise_reduction=100),
    dict(cabac=True, bframes=2, trellis=1, deadzone_intra=10),
    dict(cqm8i=tuple(range(8, 72)), cqm4p=tuple(range(8, 24))),
], ids=lambda kw: ",".join(kw))
def test_encoder_accepts_the_quant_options(kw):
    """The quantizer's options (refused before they were served: cqm,
    the deadzones, noise_reduction) on the main path, the 16x16 path,
    multiple references and B frames: the encoder builds its own
    tables, and the SPS carries any list that is not flat."""
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(_slice_params(**kw), device="cpu")
    assert enc.qt.is_flat == (not any(k.startswith("cqm") for k in kw))
    sps = enc.sps
    assert all(x is None for x in (sps.scaling4_intra, sps.scaling4_inter,
                                   sps.scaling8_intra, sps.scaling8_inter)
               ) == enc.qt.is_flat
    assert enc.qt.dz_inter == 32 - enc.p.deadzone_inter


def test_encoder_accepts_params_at_their_defaults():
    from video_steganography_pcamv_torch import Encoder
    p = Params(width=112, height=80, stego=StegoParams(em_rate=64, key=99))
    assert p.psnr and not p.deblock_device and p.pipeline
    Encoder(p, device="cpu")
