"""The port imports no jax, and its Encoder refuses what it cannot run.

The import check runs in a subprocess whose meta-path finder refuses
every `jax` import, then imports every module of the port package."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from video_steganography_pcamv_tpu.params import Params, StegoParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoJax())
    import video_steganography_pcamv_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print(len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip().splitlines()[-1]) >= 20


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


@pytest.mark.parametrize("kw", [
    dict(cabac=True), dict(bframes=2), dict(ref_frames=2), dict(p4x4=True),
    dict(transform_8x8=True), dict(rd=1), dict(aq_mode=1),
    dict(noise_reduction=100), dict(crf=23.0), dict(pipeline_deep=True),
    dict(psnr=True), dict(ssim=True), dict(zones="0,5,q=30"),
    dict(stego=StegoParams(em_rate=0)),
    dict(stego=StegoParams(em_rate=64, key=99, alpha_com=0.5)),
    dict(deblock_device=False), dict(subpel=1), dict(dct_decimate=False),
    dict(incremental=False),
], ids=lambda kw: ",".join(kw))
def test_encoder_rejects_options_outside_the_slice(kw):
    from video_steganography_pcamv_torch import Encoder
    with pytest.raises(NotImplementedError):
        Encoder(_slice_params(**kw), device="cpu")
