"""Streams over devices (port of parallel/mesh.py).

The reference builds a JAX `Mesh`: one process driving many devices,
the stream axis sharded over them. The port's counterpart is one process
holding a list of `torch.device`s and moving tensors with explicit
`.to()` copies. (`torch.distributed` would need one process per GPU, and
NCCL puts no two ranks on one GPU; a device list runs as several entries
of `cuda:0` on a one-card machine and as CPU devices in the tests.)
Streams need no communication: each device runs its own streams' steps,
and `encode_streams_sharded`'s one cross-device value, the global MV
magnitude the reference psums, is the sum of the per-device partial
sums, taken on the first device.
"""

from __future__ import annotations

import torch

from ..encoder.multistream import MultiEncoder
from ..models import pipeline


def build_mesh(n: int = None, devices=None) -> list:
    """The first n devices (all by default) of `devices`, or of the CUDA
    devices when none is given, as `torch.device`s."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_mesh: CUDA is not available; pass "
                               "devices")
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    return devs[:n or len(devs)]


def build_multi_encoder(params, devices) -> MultiEncoder:
    """A MultiEncoder with one stream per device."""
    return MultiEncoder(params, len(devices), devices=devices)


def encode_streams_sharded(devices, ys, us, vs, ref_lumas, ref_us, ref_vs,
                           prev_mvs, **kw) -> dict:
    """`pipeline.multi_stream_step` over S streams, the leading stream
    axis split into len(devices) equal blocks, block d on devices[d] (the
    reference's NamedSharding(mesh, P("dp"))). Inputs are [S, ...] arrays
    or tensors. Returns every output stacked over the S streams on the
    first device, plus "global_mv_mag": the sum of |mv8| (or |mv|) over
    every stream, int32."""
    S, nd = len(ys), len(devices)
    if S % nd:
        raise ValueError("%d streams do not split over %d devices"
                         % (S, nd))
    per = S // nd
    outs = []
    for d, dev in enumerate(devices):
        sl = slice(d * per, (d + 1) * per)
        args = [torch.as_tensor(a[sl]).to(dev)
                for a in (ys, us, vs, ref_lumas, ref_us, ref_vs, prev_mvs)]
        outs.append(pipeline.multi_stream_step(*args, **kw))
    first = devices[0]
    out = {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}
    key = "mv8" if "mv8" in outs[0] else "mv"
    out["global_mv_mag"] = sum(
        o[key].abs().sum(dtype=torch.int32).to(first) for o in outs)
    return out
