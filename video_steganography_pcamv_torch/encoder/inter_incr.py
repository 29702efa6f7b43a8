"""Incremental pass-2 re-encode of the MBs the stego flips touched
(port of encoder/inter_incr.py).

An MB is re-encoded iff one of its 8x8 MVs changed or its skip flag
flipped; every other MB keeps its pass-1 levels and recon. The
reference pads the MB subset to a power-of-two capacity with the
out-of-range index n and lets JAX's scatter drop those rows; a torch
index of n would raise, so the padding is sliced away before the
scatter (the re-encode of a padding row never reaches the output in
either implementation).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lumap as LP
from ..ops import mc
from .inter import chroma_encode, cbp_chroma_of, pack_chroma, mb_tiles


def reencode_p_incremental(res: dict, y, u, v, ref_luma, ref_u, ref_v,
                           mv8, idx, fz, qp: int, qpc: int, mbh: int,
                           mbw: int, tables=None) -> dict:
    """Re-encode the MB subset `idx` with the final MV field and write it
    into a copy of the pass-1 dict, with the inter class of `tables`
    (None: flat). idx/fz may carry `pad_subset`'s padding (index n);
    those rows are dropped here. Never under noise reduction: the
    reference re-encodes every MB there."""
    n = mbh * mbw
    keep = idx < n
    idx32 = idx[keep].to(torch.int32)
    idx = idx32.long()
    fz = fz[keep].to(torch.bool)
    cap = idx.shape[0]
    out = dict(res)
    if cap == 0:
        return out
    dev = y.device
    my = torch.div(idx, mbw, rounding_mode="floor")
    mx = idx % mbw
    dy = torch.tensor([0, 0, 1, 1], device=dev)
    dx = torch.tensor([0, 1, 0, 1], device=dev)
    ys8 = (16 * my[:, None] + 8 * dy[None, :]).reshape(-1)
    xs8 = (16 * mx[:, None] + 8 * dx[None, :]).reshape(-1)
    uy = (2 * my[:, None] + dy[None, :]).reshape(-1)
    ux = (2 * mx[:, None] + dx[None, :]).reshape(-1)
    mvu = mv8[uy, ux]
    p8 = mc.mc_luma(ref_luma, ys8, xs8, mvu, 8, 8)
    pred = p8.reshape(cap, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(cap, 16, 16)
    lev, rec, cbp_luma = LP.luma_p_encode(y, pred, qp, idx=idx32, fz=fz,
                                          tables=tables)

    ysc = (8 * my[:, None] + 4 * dy[None, :]).reshape(-1)
    xsc = (8 * mx[:, None] + 4 * dx[None, :]).reshape(-1)
    chroma = []
    for plane, refp in ((u, ref_u), (v, ref_v)):
        pc4 = mc.mc_chroma(refp, ysc, xsc, mvu, 4, 4)
        predc = pc4.reshape(cap, 2, 2, 4, 4).permute(0, 1, 3, 2, 4) \
            .reshape(cap, 8, 8)
        chroma.append(chroma_encode(mb_tiles(plane, 8)[idx], predc, qpc,
                                    fz, tables=tables))
    cbp_chroma = cbp_chroma_of(chroma)
    cdc, cac = pack_chroma(chroma, cap)

    def put(key, flat_shape, val):
        t = res[key].reshape(flat_shape).clone()
        t[idx] = val.to(t.dtype)
        return t.reshape(res[key].shape)

    out["luma_lev"] = put("luma_lev", (n, 256),
                          lev.movedim((1, 2), (3, 4)).reshape(cap, 256))
    out["cbp_luma"] = put("cbp_luma", (n,), cbp_luma)
    out["cbp_chroma"] = put("cbp_chroma", (n,), cbp_chroma)
    out["chroma_dc"] = put("chroma_dc", (n, 8), cdc)
    out["chroma_ac"] = put("chroma_ac", (n, 128), cac)
    ry = mb_tiles(res["recon_y"], 16).clone()
    ry[idx] = rec.to(ry.dtype)
    out["recon_y"] = ry.reshape(mbh, mbw, 16, 16).permute(0, 2, 1, 3) \
        .reshape(16 * mbh, 16 * mbw)
    for key, (_, _, rc) in zip(("recon_u", "recon_v"), chroma):
        rp = mb_tiles(res[key], 8).clone()
        rp[idx] = rc.to(rp.dtype)
        out[key] = rp.reshape(mbh, mbw, 8, 8).permute(0, 2, 1, 3) \
            .reshape(8 * mbh, 8 * mbw)
    return out


def changed_mbs(mv8_pass1, final8, skip_pass1, skip_final, mbh, mbw):
    """Host changed-MB set: any 8x8 MV differs or the skip flag flipped.
    Returns (flat indices int32 [k], force_zero bool [k])."""
    ch8 = (mv8_pass1 != final8).any(-1)
    chmb = ch8.reshape(mbh, 2, mbw, 2).any(axis=(1, 3))
    chmb |= skip_pass1 != skip_final
    idx = np.flatnonzero(chmb).astype(np.int32)
    return idx, skip_final.reshape(-1)[idx].astype(bool)


def pad_subset(idx, fz, n: int):
    """Pad (idx, fz) to the next power-of-two capacity (min 32) with the
    out-of-range index n, as the reference does (its scatter drops those
    rows; `reencode_p_incremental` drops them before the scatter).
    Returns (idx_padded, fz_padded, cap)."""
    cap = 32
    while cap < len(idx):
        cap *= 2
    idx_p = np.full(cap, n, np.int32)
    idx_p[:len(idx)] = idx
    fz_p = np.zeros(cap, bool)
    fz_p[:len(fz)] = fz
    return idx_p, fz_p, cap
