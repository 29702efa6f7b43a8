"""Motion compensation, gather form (port of ops/mc.py).

Only the gather semantics are ported; the reference's one-hot `*_mm`
selects work around a TPU gather unit and compute the same values.
All filters are the normative spec 8.4.2.2 integer math.
"""

from __future__ import annotations

import torch

PAD = 24  # full-pel border of every reference plane

_I32 = torch.int32


def pad_plane(p: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """Edge-replicate pad (works for integer dtypes)."""
    h, w = p.shape
    rows = torch.arange(-pad, h + pad, device=p.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=p.device).clamp(0, w - 1)
    return p[rows][:, cols]


def _filt6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def hpel_planes(full_padded: torch.Tensor):
    """H (x+1/2), V (y+1/2), C (centre) planes of a padded full-pel
    plane. The shifts wrap around like the reference's `jnp.roll`."""
    p = full_padded.to(_I32)

    def sx(img, k):
        return torch.roll(img, -k, dims=1)

    def sy(img, k):
        return torch.roll(img, -k, dims=0)

    th = _filt6(sx(p, -2), sx(p, -1), p, sx(p, 1), sx(p, 2), sx(p, 3))
    h = torch.clamp((th + 16) >> 5, 0, 255)
    tv = _filt6(sy(p, -2), sy(p, -1), p, sy(p, 1), sy(p, 2), sy(p, 3))
    v = torch.clamp((tv + 16) >> 5, 0, 255)
    tc = _filt6(sy(th, -2), sy(th, -1), th, sy(th, 1), sy(th, 2), sy(th, 3))
    c = torch.clamp((tc + 512) >> 10, 0, 255)
    return h, v, c


def gather_blocks(plane, y0, x0, bh: int, bw: int) -> torch.Tensor:
    """[N, bh, bw] blocks at per-item top-left (y0, x0)."""
    ar_h = torch.arange(bh, device=plane.device)
    ar_w = torch.arange(bw, device=plane.device)
    ys = y0.long()[:, None] + ar_h[None, :]
    xs = x0.long()[:, None] + ar_w[None, :]
    return plane[ys[:, :, None], xs[:, None, :]]


def qpel_phase_tables(mvx, mvy):
    """(plane1, dy1, dx1, plane2, dy2, dx2) of each qpel phase; planes
    0=F, 1=H, 2=V, 3=C (spec 8.4.2.2.1)."""
    fx, fy = mvx & 3, mvy & 3
    ox, oy = fx & 1, fy & 1
    even_idx = (fx >> 1) + 2 * (fy >> 1)
    both = (ox & oy) == 1
    p1 = torch.where(both, 1, torch.where(
        ox == 1, 1 + 2 * (fy >> 1),
        torch.where(oy == 1, (fx >> 1) + 2, even_idx)))
    p2 = torch.where(both, 2, torch.where(
        ox == 1, 2 * (fy >> 1),
        torch.where(oy == 1, fx >> 1, even_idx)))
    d1y = torch.where(both & (fy == 3), 1, 0)
    d1x = torch.zeros_like(fx)
    d2y = torch.where((ox == 1) | both, 0, torch.where(fy == 3, 1, 0))
    d2x = torch.where(((ox == 1) & (fx == 3)) | (both & (fx == 3)), 1, 0)
    return p1, d1y, d1x, p2, d2y, d2x


def mc_luma(planes, mb_y0, mb_x0, mv, bh: int = 16, bw: int = 16):
    """Quarter-pel luma MC of [N] blocks. planes: [4, Hp, Wp] (F,H,V,C)
    PAD-padded; mv: [N, 2] (x, y) qpel. Returns [N, bh, bw] int32."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 2)
    iy = mb_y0 + PAD + (mvy >> 2)
    p1, d1y, d1x, p2, d2y, d2x = qpel_phase_tables(mvx, mvy)
    ar_h = torch.arange(bh, device=planes.device)
    ar_w = torch.arange(bw, device=planes.device)
    ys1 = (iy + d1y).long()[:, None] + ar_h
    xs1 = (ix + d1x).long()[:, None] + ar_w
    ys2 = (iy + d2y).long()[:, None] + ar_h
    xs2 = (ix + d2x).long()[:, None] + ar_w
    s1 = planes[p1.long()[:, None, None], ys1[:, :, None], xs1[:, None, :]]
    s2 = planes[p2.long()[:, None, None], ys2[:, :, None], xs2[:, None, :]]
    return (s1 + s2 + 1) >> 1


def mc_chroma(plane_padded, mb_y0, mb_x0, mv, bh: int = 8, bw: int = 8):
    """1/8-pel bilinear chroma MC; mv is the luma qpel vector."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 3)
    iy = mb_y0 + PAD + (mvy >> 3)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    a = gather_blocks(plane_padded, iy, ix, bh, bw)
    b = gather_blocks(plane_padded, iy, ix + 1, bh, bw)
    c = gather_blocks(plane_padded, iy + 1, ix, bh, bw)
    d = gather_blocks(plane_padded, iy + 1, ix + 1, bh, bw)
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def mc_luma_multi(planes_r, ref_idx, mb_y0, mb_x0, mv, bh: int = 16,
                  bw: int = 16):
    """Multi-reference quarter-pel luma MC: planes_r [R, 4, Hp, Wp] the
    stacked DPB, ref_idx [N] each block's L0 index; otherwise `mc_luma`."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 2)
    iy = mb_y0 + PAD + (mvy >> 2)
    p1, d1y, d1x, p2, d2y, d2x = qpel_phase_tables(mvx, mvy)
    ar_h = torch.arange(bh, device=planes_r.device)
    ar_w = torch.arange(bw, device=planes_r.device)
    ys1 = (iy + d1y).long()[:, None] + ar_h
    xs1 = (ix + d1x).long()[:, None] + ar_w
    ys2 = (iy + d2y).long()[:, None] + ar_h
    xs2 = (ix + d2x).long()[:, None] + ar_w
    r = ref_idx.long()[:, None, None]
    s1 = planes_r[r, p1.long()[:, None, None], ys1[:, :, None],
                  xs1[:, None, :]]
    s2 = planes_r[r, p2.long()[:, None, None], ys2[:, :, None],
                  xs2[:, None, :]]
    return (s1 + s2 + 1) >> 1


def mc_chroma_multi(plane_r, ref_idx, mb_y0, mb_x0, mv, bh: int = 8,
                    bw: int = 8):
    """Multi-reference chroma MC: plane_r [R, Hp, Wp], ref_idx [N];
    otherwise `mc_chroma`."""
    mvx, mvy = mv[:, 0], mv[:, 1]
    ix = mb_x0 + PAD + (mvx >> 3)
    iy = mb_y0 + PAD + (mvy >> 3)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    r = ref_idx.long()[:, None, None]
    ar_h = torch.arange(bh, device=plane_r.device)
    ar_w = torch.arange(bw, device=plane_r.device)

    def gat(y0, x0):
        ys = y0.long()[:, None] + ar_h
        xs = x0.long()[:, None] + ar_w
        return plane_r[r, ys[:, :, None], xs[:, None, :]]

    a = gat(iy, ix)
    b = gat(iy, ix + 1)
    c = gat(iy + 1, ix)
    d = gat(iy + 1, ix + 1)
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def build_ref(recon_y, recon_u, recon_v) -> dict:
    """Reference planes of a reconstructed frame: padded luma + hpel
    pyramid stacked [4, Hp, Wp], padded chroma (all int32)."""
    fp = pad_plane(recon_y.to(_I32))
    h, v, c = hpel_planes(fp)
    return {
        "luma": torch.stack([fp, h, v, c]),
        "u": pad_plane(recon_u.to(_I32)),
        "v": pad_plane(recon_v.to(_I32)),
    }
