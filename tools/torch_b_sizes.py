"""Bytes per access unit of BASELINE config 4 (tools/bench_c4.py's Params:
bframes 2, b_adapt 0, ref_frames 2, CABAC, stego em_rate 64 key 5) in
the JAX reference and in the PyTorch port, both on the CPU, on the same
clip (synthetic_sequence seed 9, IDR + 6 frames + flush).

    python3 tools/torch_b_sizes.py [WIDTH HEIGHT]   (default 640 368)

Prints, per access unit in decode order, (type, display index, bytes)
for the reference's CPU branch, and whether the port's stream on its
CPU branch (tail_kernel=False) is byte-equal to it. Minutes at the
default size, most of it the reference's compiles; keep it far below
1080p on a CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence
from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP


def main(width=640, height=368, n_frames=7):
    kw = dict(width=width, height=height, qp=26, me_range=16, cabac=True,
              bframes=2, b_adapt=0, ref_frames=2, deblock_device=True,
              psnr=False)
    frames = synthetic_sequence(width, height, n_frames, seed=9)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=64, key=5)))
    aus = [au for f in frames for au in jenc.encode_frame_aus(f)]
    aus += jenc.flush_aus()
    want = b"".join(chunk for _disp, chunk, _kind in aus)
    tenc = TEncoder(TP.Params(**kw, tail_kernel=False,
                              stego=TP.StegoParams(em_rate=64, key=5)),
                    device="cpu")
    got = b"".join(tenc.encode_frame(f) for f in frames) + tenc.flush()
    print("%dx%d config 4, reference AUs (type, display index, bytes): %s"
          % (width, height, [(k, d, len(c)) for d, c, k in aus]))
    print("port stream byte-equal to the reference's: %s (%d bytes)"
          % (got == want, len(got)))
    return 0 if got == want else 1


if __name__ == "__main__":
    sys.exit(main(*[int(x) for x in sys.argv[1:]]))
