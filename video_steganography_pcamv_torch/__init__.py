"""PyTorch + CUDA port of the H.264 MV-steganography encoder.

The JAX package `video_steganography_pcamv_tpu` is the reference: every
function here is held array-equal (or byte-equal) to its counterpart
there. This package imports `torch` and never `jax`; the reference's
jax-free modules (params, native, utils, headers, ratecontrol, stc,
extract, decoder) are imported rather than copied.

Layout mirrors the reference: `ops/` (tensor primitives and the two
hand-written Hopper kernels), `encoder/`, `stego/`, plus `csrc/` (CUDA
sources) and `kernels/` (nvcc build + ctypes loader).
"""

from .encoder.core import Encoder  # noqa: F401
