"""One frame's MB rows over devices (port of parallel/tile.py).

Each tile encodes its band of MB rows against the previous frame's
reconstruction, holding only its own band plus a PAD-row halo from each
neighbouring tile; the vertical MV predictor is clamped so that every
reference access stays inside the halo (x264's frame-parallel mv-range
clamp, doc/threads.txt, set here by the halo height). Per frame the
halos are the only reference data that moves: across each of the n - 1
tile boundaries one packed (Y | U | V) buffer goes each way, to the
neighbour's device. Frame edges replicate rows (x264_frame_expand_border);
interior tile edges read the neighbour's real rows, so the tiled step
equals the untiled one wherever the predictor respects the clamp.

The reference runs the tiles as a `shard_map` over a JAX mesh with two
`ppermute`s, and audits the compiled HLO for collectives. The port runs
them over an explicit device list (see `parallel.mesh`) and records
every halo transfer in `halo_log` instead: (source tile, destination
tile, luma rows, chroma rows of each plane). The step's outputs are
assembled on the first tile's device.
"""

from __future__ import annotations

import torch

from ..models import pipeline
from ..ops import mc

# every halo transfer since the last reset: (src, dst, y rows, c rows)
halo_log: list = []


def pred_clamp_fp(rng: int) -> int:
    """Max |vertical full-pel predictor| that keeps every window fetch
    inside a PAD-row halo: the full-pel scan reaches pred + rng, the
    qpel window adds its 4-px margin, and the hpel build leaves the outer
    3 halo rows invalid."""
    return max(0, mc.PAD - rng - 7)


def _halo_exchange(planes, h_y: int, h_c: int, devices):
    """planes: per tile (y [Hl, W], u [Hl/2, W/2], v) int32 rows on the
    tile's device. Returns per tile ((top_y, bot_y), (top_u, bot_u),
    (top_v, bot_v)): the neighbours' edge rows, one packed buffer each
    way across each boundary, or replicated edge rows at the frame's
    top and bottom."""
    n = len(planes)

    def pack(y, u, v):
        return torch.cat([y.reshape(-1), u.reshape(-1), v.reshape(-1)])

    def unpack(buf, w: int, wc: int):
        ny, nc = h_y * w, h_c * wc
        return (buf[:ny].reshape(h_y, w), buf[ny:ny + nc].reshape(h_c, wc),
                buf[ny + nc:].reshape(h_c, wc))

    def send(buf, src: int, dst: int):
        halo_log.append((src, dst, h_y, h_c))
        return buf.to(devices[dst])

    # my bottom rows travel down and arrive as the receiver's top halo;
    # my top rows travel up and arrive as the receiver's bottom halo
    tops = [None] + [send(pack(y[-h_y:], u[-h_c:], v[-h_c:]), i, i + 1)
                     for i, (y, u, v) in enumerate(planes[:-1])]
    bots = [send(pack(y[:h_y], u[:h_c], v[:h_c]), i, i - 1)
            for i, (y, u, v) in enumerate(planes) if i > 0] + [None]
    out = []
    for i, (y, u, v) in enumerate(planes):
        w, wc = y.shape[1], u.shape[1]
        top = (unpack(tops[i], w, wc) if tops[i] is not None else
               tuple(p[:1].expand(h, -1) for p, h in
                     ((y, h_y), (u, h_c), (v, h_c))))
        bot = (unpack(bots[i], w, wc) if bots[i] is not None else
               tuple(p[-1:].expand(h, -1) for p, h in
                     ((y, h_y), (u, h_c), (v, h_c))))
        out.append(tuple(zip(top, bot)))
    return out


def _pad_cols(p: torch.Tensor) -> torch.Tensor:
    """Edge-replicate PAD columns each side."""
    return torch.cat([p[:, :1].expand(-1, mc.PAD), p,
                      p[:, -1:].expand(-1, mc.PAD)], dim=1)


def _local_ref(y_l, u_l, v_l, halos) -> dict:
    """The tile's padded reference (full-pel + hpel planes + chroma),
    shaped as `mc.build_ref`'s for a frame of the tile's height: its
    vertical pad rows are the halo's."""
    (ty, by), (tu, bu), (tv, bv) = halos
    fp = _pad_cols(torch.cat([ty, y_l, by]))
    h, v, c = mc.hpel_planes(fp)
    return {"luma": torch.stack([fp, h, v, c]),
            "u": _pad_cols(torch.cat([tu, u_l, bu])),
            "v": _pad_cols(torch.cat([tv, v_l, bv]))}


def p_frame_step_tiled(devices, y, u, v, ry, ru, rv, prev_mv, qp: int,
                       qpc: int, mbh: int, mbw: int, rng: int = 8,
                       lam: int = 4, subpel: int = 2, decimate: bool = True,
                       with_stego: bool = True) -> dict:
    """`pipeline.p_frame_step_parts` with the MB rows of one frame split
    over len(devices) tiles, tile i on devices[i] (a device may repeat).
    y/u/v: the current planes ([16mbh, 16mbw] luma); ry/ru/rv: the
    previous frame's reconstruction, unpadded; prev_mv [mbh, mbw, 2]
    qpel. Arrays or tensors. Returns the untiled step's dict, each output
    assembled on the first device."""
    n = len(devices)
    if mbh % n:
        raise ValueError("MB rows must split evenly over tiles")
    mbh_l = mbh // n
    # the halo rows come from the adjacent tile only: each tile must be
    # at least one halo tall (chroma binds: 8 rows an MB row)
    if 8 * mbh_l < mc.PAD:
        raise ValueError("tile too short: need >= %d MB rows per tile"
                         % -(-mc.PAD // 8))
    clamp_q = 4 * pred_clamp_fp(rng)

    def rows(a, i: int, per: int):
        return torch.as_tensor(a)[i * per:(i + 1) * per].to(
            devices[i], torch.int32)

    refs = [(rows(ry, i, 16 * mbh_l), rows(ru, i, 8 * mbh_l),
             rows(rv, i, 8 * mbh_l)) for i in range(n)]
    halos = _halo_exchange(refs, mc.PAD, mc.PAD, devices)
    outs = []
    for i in range(n):
        ref = _local_ref(*refs[i], halos[i])
        pmv = rows(prev_mv, i, mbh_l).clone()
        # the vertical predictor clamp keeps every fetch inside the halo
        pmv[..., 1] = pmv[..., 1].clamp(-clamp_q, clamp_q)
        outs.append(pipeline.p_frame_step_parts(
            rows(y, i, 16 * mbh_l), rows(u, i, 8 * mbh_l),
            rows(v, i, 8 * mbh_l), ref["luma"], ref["u"], ref["v"], pmv,
            qp, qpc, mbh_l, mbw, rng, lam, subpel=subpel,
            decimate=decimate, with_stego=with_stego))
    first = devices[0]
    return {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}
