"""PyTorch + CUDA port of the H.264 MV-steganography encoder.

The JAX package `video_steganography_pcamv_tpu` is the reference: every
function here is held array-equal (or byte-equal) to its counterpart
there. This package imports `torch` and never `jax`, and nothing of the
reference package: it keeps its own copies of the jax-free modules it
needs (params, utils, encoder/headers, ratecontrol, vlc_tables, stego/
stc, stc_mats, extract, the CAVLC I/P decoder and the native C++ host
back-end).

Layout mirrors the reference: `ops/` (tensor primitives and the wrappers
of the hand-written Hopper kernels), `encoder/`, `stego/`, `decoder/`,
`utils/`, plus `csrc/` (CUDA sources), `kernels/` (nvcc build + ctypes
loader) and `native/` (C++ host back-end, g++ build + ctypes loader).
"""

from .encoder.core import Encoder  # noqa: F401
