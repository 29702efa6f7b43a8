"""Kernels B2-B4: the analyse tail (qpel rows, subpel refine, RCA probe
SATD maps).

`analyse_tail` is the counterpart of the TPU orchestrator
`analyse_tail_pallas` (video_steganography_pcamv_tpu/ops/probe_pallas.py
:574), which runs three TPU kernels:

  B2 `qpel_tables_pallas` (probe_pallas.py:221): the 169 qpel rows of
     every 8x8 and their WHTs, written to two tables;
  B3 `subpel_pallas` (probe_pallas.py:301);
  B4 `probe_maps_pallas` (probe_pallas.py:481).

On the H100 one hand-written kernel template serves B3 and B4
(`csrc/analyse_tail.cu`), with B2 fused in: it builds the rows it
reads from the per-8x8 windows (B9's output) in shared memory, so the
tables (1.06 GB a 1080p frame) are never written, and runs the 4x4
transforms on the int8 tensor cores. `analyse_tail` launches B3 -> B4
as one kernel (every stego P path); `subpel` launches B3 alone (stego
off, B frames); `probe_maps` is B4's check entry on given rows, on no
path. `qpel_tables` keeps B2 as a standalone entry over the row code
of `csrc/qpel_rows.cuh` (`csrc/qpel_tables.cu`), on no path: it holds
that code against `block_table8` / `wht8_table` on its own.

On a CPU tensor each wrapper runs its plain PyTorch version (the port's
twins of the reference's XLA chain: `subpel_parts`, `probe_maps_plain`,
which take the windows as the kernels do and build only the rows they
read, through `window_rows`; `block_table8` + `wht8_table` for B2); on a
CUDA tensor it launches its kernel, counted in `<wrapper>.launches`, or
raises. The TPU's z-order block lanes and 128-lane padding are layout
for its vector unit and are dropped: every tensor here keeps the 8x8
blocks in spatial order; a WHT row is in `wht8_flat` order (sub-block
s = 2*(y>=4) + (x>=4), then 4*vr + vc), the tables are `blocks8 [169,
N8, 8, 8]` uint8 and `wht8 [169, N8, 64]` int16. The kernels read cur
as 8-bit samples (the luma planes every caller passes).

Block index convention per MB: 8x8 blocks b in {0: TL, 1: TR, 2: BL,
3: BR} (z-order).
"""

from __future__ import annotations

import numpy as np
import torch

from . import const
from . import lumap as LP
from . import transform as T
from .cqm import FLAT
from .blocks import from_blocks, to_blocks
from .. import kernels
from ..encoder import inter as INTER
from ..encoder import qpel_table as QT
from ..encoder.me import mv_bits_table
from ..stego.cost import D_MV, D_NB

_I32 = torch.int32

# subpel=2: the qpel offset box around each full-pel MV, oy outer
_SUBPEL_OFFSETS = [(oy, ox) for oy in range(-3, 4) for ox in range(-3, 4)]
_SUBPEL_BITS = mv_bits_table(4 * 512)
# probe versions: the centre, then the 12 D_MV deltas, as (dy, dx)
_CENTERS = [(0, 0)] + [(int(D_MV[c][1]), int(D_MV[c][0]))
                       for c in range(12)]
# the 9 lattice neighbours of a version, as (dy, dx)
_NB = [(int(D_NB[k][1]), int(D_NB[k][0])) for k in range(9)]


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------

def _phase_index(oy, ox):
    """qpel_table._phase_slices for [N8] offset tensors: the flat window
    index [N8, 2] (plane*256 + row*16 + col) of each averaged slice's
    origin."""
    fx, fy = ox & 3, oy & 3
    bx, by = (ox >> 2) + QT.MARGIN, (oy >> 2) + QT.MARGIN
    one_x, one_y = (fx == 3).to(ox.dtype), (fy == 3).to(oy.dtype)
    ex, ey = fx % 2 == 0, fy % 2 == 0
    w = torch.where
    p1 = w(ex & ey, (fx >> 1) + 2 * (fy >> 1),
           w(ey, 1 + 2 * (fy >> 1), w(ex, (fx >> 1) + 2, 1)))
    p2 = w(ex & ey, p1, w(ey, 2 * (fy >> 1), w(ex, fx >> 1, 2)))
    y1 = w(~ex & ~ey, by + one_y, by)
    x1 = bx
    y2 = w(ex & ~ey, by + one_y, by)
    x2 = w(~ex, bx + one_x, bx)
    return torch.stack([p1 * 256 + y1 * 16 + x1, p2 * 256 + y2 * 16 + x2],
                       dim=1)


_RC8 = (torch.arange(8)[:, None] * 16 + torch.arange(8)).reshape(64)


def block_row8(windows, oy, ox):
    """The [N8, 8, 8] uint8 qpel row of offset (oy, ox) from the
    [N8, 4, 16, 16] windows: the (a + b + 1) >> 1 average of two phase
    plane slices. Int offsets are static slices; [N8] int tensors give
    every 8x8 its own offset (a gather)."""
    w16 = windows.to(torch.int16)
    if isinstance(oy, int):
        (p1, y1, x1), (p2, y2, x2) = QT._phase_slices(oy, ox)
        a = w16[:, p1, y1:y1 + 8, x1:x1 + 8]
        b = w16[:, p2, y2:y2 + 8, x2:x2 + 8]
    else:
        n8 = windows.shape[0]
        org = _phase_index(oy.long(), ox.long())            # [N8, 2]
        idx = org[:, :, None] + _RC8.to(windows.device)     # [N8, 2, 64]
        flat = w16.reshape(n8, 1024)
        a = torch.gather(flat, 1, idx[:, 0]).reshape(n8, 8, 8)
        b = torch.gather(flat, 1, idx[:, 1]).reshape(n8, 8, 8)
    return ((a + b + 1) >> 1).to(torch.uint8)


def block_table8(windows):
    """[N8, 4, 16, 16] uint8 -> [169, N8, 8, 8] uint8: every qpel offset
    in [-6, 6]^2 (B2's first table)."""
    return torch.stack([block_row8(windows, oy, ox)
                        for oy in range(-6, 7) for ox in range(-6, 7)])


def wht8_flat(blocks):
    """Per-8x8 WHT, [..., 8, 8] -> [..., 64] ordered (sub-block by, bx,
    then r, c)."""
    w = QT.wht16(blocks.to(_I32))                     # [..., 4,4,2,2]
    w = w.movedim((-4, -3), (-2, -1))                 # [..., 2,2,4,4]
    return w.reshape(*w.shape[:-4], 64)


def wht8_table(blocks8):
    """wht8_flat of the [169, N8, 8, 8] table as int16, in chunks of 13
    offsets (bounds the int32 intermediates)."""
    return torch.cat([wht8_flat(blocks8[k:k + 13]).to(torch.int16)
                      for k in range(0, blocks8.shape[0], 13)])


def window_rows(windows):
    """The plain tail's row source over the windows: (pred, wht) with
    pred(oy, ox) the [N8, 8, 8] uint8 qpel row of offset (oy, ox) and
    wht(oy, ox) its [N8, 64] int32 WHT row; offsets as `block_row8`
    takes them. Only the rows a caller asks for are built."""
    return (lambda oy, ox: block_row8(windows, oy, ox),
            lambda oy, ox: wht8_flat(block_row8(windows, oy, ox)))


def satd_flat(wa, wb):
    """SATD between flat WHT tensors [..., 64]."""
    d = torch.abs(wa.to(_I32) - wb.to(_I32))
    per_sub = d.reshape(*d.shape[:-1], 4, 16).sum(-1, dtype=_I32) >> 1
    return per_sub.sum(-1, dtype=_I32)


def _mb_blocks8(y, mbh: int, mbw: int):
    return y.reshape(2 * mbh, 8, 2 * mbw, 8).permute(0, 2, 1, 3) \
        .reshape(4 * mbh * mbw, 8, 8)


def sp_to_z(a, mbh: int, mbw: int):
    """[2mbh, 2mbw, *rest] spatial 8x8-block grid -> [mbh, mbw, 4, *rest]
    with the z-order block axis."""
    rest = a.shape[2:]
    r = len(rest)
    return a.reshape(mbh, 2, mbw, 2, *rest) \
        .permute(0, 2, 1, 3, *range(4, 4 + r)).reshape(mbh, mbw, 4, *rest)


def z_to_sp(a, mbh: int, mbw: int):
    """[mbh, mbw, 4, *rest] -> [2mbh, 2mbw, *rest]."""
    rest = a.shape[3:]
    r = len(rest)
    return a.reshape(mbh, mbw, 2, 2, *rest) \
        .permute(0, 2, 1, 3, *range(4, 4 + r)) \
        .reshape(2 * mbh, 2 * mbw, *rest)


# per partition (16x16, 16x8, 8x16, 8x8): the z-order 8x8 blocks that
# are the first of their unit
_FIRST = np.array([[1, 0, 0, 0], [1, 0, 1, 0], [1, 1, 0, 0], [1, 1, 1, 1]],
                  np.int32)


def subpel_parts(cur_y, windows, part, mvfp8, prev_mv, mbh: int,
                 mbw: int, lam: int = 1, mb_cost: bool = False):
    """Subpel refinement (subpel=2) per partition unit from the 49 WHT
    rows of the [-3, 3]^2 box, built from the windows. Returns (mv8
    [2mbh,2mbw,2] qpel, r_idx8 [N8] chosen table index) and, with
    `mb_cost`, each MB's inter cost [mbh,mbw] int32: every unit's
    minimum cost counted once, at its first 8x8 (the reference's
    partition.py:354-362)."""
    dev = cur_y.device
    n8 = 4 * mbh * mbw
    wcur = wht8_flat(_mb_blocks8(cur_y, mbh, mbw))
    mvf = mvfp8.reshape(n8, 2)
    bits_t = const(_SUBPEL_BITS, dev)
    off = 4 * 512
    pred8 = prev_mv.repeat_interleave(2, 0).repeat_interleave(2, 1) \
        .reshape(n8, 2)
    _pred, wht = window_rows(windows)
    offsets = _SUBPEL_OFFSETS
    satds, mvcs = [], []
    for oy, ox in offsets:
        satds.append(satd_flat(wcur, wht(oy, ox)))
        qx = 4 * mvf[:, 0] + ox
        qy = 4 * mvf[:, 1] + oy
        ix = torch.clamp(qx - pred8[:, 0], -off, off) + off
        iy = torch.clamp(qy - pred8[:, 1], -off, off) + off
        mvcs.append((bits_t[ix.long()] + bits_t[iy.long()]) * lam)
    K = len(offsets)

    def k_to_z(s):
        return s.reshape(K, mbh, 2, mbw, 2).permute(0, 1, 3, 2, 4) \
            .reshape(K, mbh, mbw, 4)

    satz = k_to_z(torch.stack(satds))
    mvcz = k_to_z(torch.stack(mvcs))
    sums = torch.stack([
        satz.sum(-1, keepdim=True, dtype=_I32).expand_as(satz),
        satz[..., [0, 0, 2, 2]] + satz[..., [1, 1, 3, 3]],
        satz[..., [0, 1, 0, 1]] + satz[..., [2, 3, 2, 3]],
        satz,
    ])                                          # [4, K, mbh, mbw, 4]
    idx = part.long()[None, None, :, :, None].expand(1, K, mbh, mbw, 4)
    cost = torch.gather(sums, 0, idx)[0] + mvcz
    sel = torch.argmin(cost, dim=0)
    offs = torch.as_tensor(np.array(offsets, np.int32), device=dev)
    oy_sel = offs[sel, 0]
    ox_sel = offs[sel, 1]
    mvz = sp_to_z(mvfp8, mbh, mbw)
    mvq = torch.stack([4 * mvz[..., 0] + ox_sel,
                       4 * mvz[..., 1] + oy_sel], dim=-1)
    r_idx = (oy_sel + 6) * 13 + (ox_sel + 6)
    mv8 = z_to_sp(mvq, mbh, mbw)
    r_idx8 = z_to_sp(r_idx[..., None], mbh, mbw)[..., 0].reshape(n8)
    if not mb_cost:
        return mv8.to(_I32), r_idx8.to(_I32)
    first = const(_FIRST, dev)[part.long()]
    cost_mb = (cost.min(dim=0).values * first).sum(-1, dtype=_I32)
    return mv8.to(_I32), r_idx8.to(_I32), cost_mb


# the distinct lattice deltas (cy + ny, cx + nx) around the chosen row:
# the [-3, 3]^2 box but its four corners
_LATTICE = sorted({(cy + ny, cx + nx) for cy, cx in _CENTERS
                   for ny, nx in _NB})


def probe_maps_plain(cur_y, windows, r_idx8, qp: int, mbh: int, mbw: int,
                     decimate: bool = True, tables=None):
    """Per-version probe SATD maps and decimate scores (the heavy half
    of the RCA probe stage), from the 13 pred rows and 45 WHT rows
    around each 8x8's chosen row r_idx8, built from the windows,
    quantized with the inter class of `tables` (None: flat). Returns (SK
    [13,9,n,4], SP [13,9,n,4], sc8 [13,n,4]); with decimate off, SP = SK
    and sc8 = 0."""
    n = mbh * mbw
    roy = torch.div(r_idx8, 13, rounding_mode="floor") - 6
    rox = r_idx8 % 13 - 6
    if not bool(((roy.abs() <= 3) & (rox.abs() <= 3)).all()):
        raise ValueError("probe_maps: r_idx8 outside the subpel box, the "
                         "probe lattice would leave the [-6, 6]^2 table")
    cur = INTER.mb_tiles(cur_y, 16)
    pred_row, wht_row = window_rows(windows)

    sel_whtz = {}
    for dy, dx in _LATTICE:
        w = wht_row(roy + dy, rox + dx)                        # [N8,64]
        sel_whtz[(dy, dx)] = sp_to_z(
            w.reshape(2 * mbh, 2 * mbw, 64), mbh, mbw).reshape(n, 4, 64)

    curz = cur.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n * 4, 8, 8)
    SK, SP, sc8 = [], [], []
    for cen in _CENTERS:
        b8 = pred_row(roy + cen[0], rox + cen[1]).to(_I32)
        pv = sp_to_z(b8.reshape(2 * mbh, 2 * mbw, 8, 8), mbh, mbw) \
            .reshape(n * 4, 8, 8)
        lev = T.quant4x4(T.dct4x4(to_blocks(curz - pv, 4)), qp, intra=False,
                         tables=tables)
        rec = T.idct4x4_add(to_blocks(pv, 4),
                            T.dequant4x4(lev, qp, tables=tables))
        wk = wht8_flat(from_blocks(rec)).reshape(n, 4, 64)
        sels = torch.stack([sel_whtz[(cen[0] + d0, cen[1] + d1)]
                            for d0, d1 in _NB])               # [9,n,4,64]
        SK.append(satd_flat(wk[None], sels))
        if decimate:
            wp = wht8_flat(pv).reshape(n, 4, 64)
            sc = LP.decimate_score(LP.zigzag_gather(lev))
            sc8.append(sc.sum((1, 2), dtype=_I32).reshape(n, 4))
            SP.append(satd_flat(wp[None], sels))
    SK = torch.stack(SK)
    if not decimate:
        return SK, SK.clone(), torch.zeros((13, n, 4), dtype=_I32,
                                           device=SK.device)
    return SK, torch.stack(SP), torch.stack(sc8)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_VP, _CI = kernels.VP, kernels.CI


def _check_windows(fn: str, windows, n8: int) -> None:
    kernels.check_tensor(fn, "windows", windows, torch.uint8,
                         (n8, 4, 16, 16))
    if windows.data_ptr() % 16:
        raise ValueError("%s: windows is not 16-byte aligned" % fn)


def qpel_tables(windows):
    """Kernel B2's standalone entry, replacing `qpel_tables_pallas`
    (video_steganography_pcamv_tpu/ops/probe_pallas.py:221). On the
    serving path B2 is fused into `analyse_tail` and `subpel`, and this
    entry is not launched; it checks the shared row and tensor-core WHT
    code (`csrc/qpel_rows.cuh`) on its own. On the H100 it is bound by
    its table writes (169 * 64 * 3 B per 8x8).

    windows [N8, 4, 16, 16] uint8 (the four hpel phase planes around each
    8x8 block's full-pel MV) -> (blocks8 [169, N8, 8, 8] uint8, wht8
    [169, N8, 64] int16)."""
    if windows.device.type == "cpu":
        blocks8 = block_table8(windows)
        return blocks8, wht8_table(blocks8)
    n8 = windows.shape[0]
    _check_windows("qpel_tables", windows, n8)
    if n8 % 4:
        raise ValueError("qpel_tables: N8 %d is not a multiple of 4" % n8)
    dev = windows.device
    blocks8 = torch.empty((169, n8, 8, 8), dtype=torch.uint8, device=dev)
    wht8 = torch.empty((169, n8, 64), dtype=torch.int16, device=dev)
    fn = kernels.entry("pcamv_qpel_tables", [_VP, _CI, _VP, _VP, _VP])
    ptr = kernels.ptr
    rc = fn(ptr(windows), n8, ptr(blocks8), ptr(wht8), kernels.stream(windows))
    kernels.check(rc, "pcamv_qpel_tables")
    qpel_tables.launches += 1
    return blocks8, wht8


qpel_tables.launches = 0


# B3's first minimum is the least key cost << 6 | offset in 32 bits: a
# unit's SATD is below 2^20 and its MV bits at most 50, so lam below
# 2^20 keeps every cost below 2^26
_LAM_LIMIT = 1 << 20


def _check_tail_inputs(fn, cur_y, windows, part, mvfp8, prev_mv, lam, mbh,
                       mbw):
    n8 = 4 * mbh * mbw
    chk = kernels.check_tensor
    chk(fn, "cur_y", cur_y, _I32, (16 * mbh, 16 * mbw))
    _check_windows(fn, windows, n8)
    chk(fn, "part", part, _I32, (mbh, mbw))
    chk(fn, "mvfp8", mvfp8, _I32, (2 * mbh, 2 * mbw, 2))
    chk(fn, "prev_mv", prev_mv, _I32, (mbh, mbw, 2))
    if not 0 <= lam < _LAM_LIMIT:
        raise ValueError("%s: lam %d outside [0, 2^20)" % (fn, lam))


def subpel(cur_y, windows, part, mvfp8, prev_mv, lam: int, mbh: int,
           mbw: int, mb_cost: bool = False):
    """Kernel B3 alone, replacing `subpel_pallas`
    (video_steganography_pcamv_tpu/ops/probe_pallas.py:301), with the 49
    rows it reads of `qpel_tables_pallas` (probe_pallas.py:221) built
    from the windows: the subpel=2 refine over the 49-offset box, SATD
    summed over each partition unit plus lam * bits(mv - qpel
    predictor), first minimum in (oy, ox) order. The stego paths run it
    inside `analyse_tail`; this entry serves stego off and the B frames.
    On the H100 it is bound by building the rows and the SATDs' integer
    work (the WHTs run on the int8 tensor cores).

    cur_y [16mbh,16mbw] int32, windows [N8,4,16,16] uint8, part
    [mbh,mbw] int32, mvfp8 [2mbh,2mbw,2] int32 full-pel, prev_mv
    [mbh,mbw,2] int32 qpel predictor -> (mv8 [2mbh,2mbw,2] int32 qpel,
    r_idx8 [N8] int32 in spatial order) and, with `mb_cost` (the stego-off
    analysis), each MB's inter cost [mbh,mbw] int32 (`subpel_parts`),
    written by the threads that hold the units' minima (counted in
    `subpel.cost_launches` too)."""
    if cur_y.device.type == "cpu":
        return subpel_parts(cur_y, windows, part, mvfp8, prev_mv, mbh, mbw,
                            lam, mb_cost)
    _check_tail_inputs("subpel", cur_y, windows, part, mvfp8, prev_mv, lam,
                       mbh, mbw)
    dev = cur_y.device
    mv8 = torch.empty((2 * mbh, 2 * mbw, 2), dtype=_I32, device=dev)
    r_idx8 = torch.empty((4 * mbh * mbw,), dtype=_I32, device=dev)
    cost = (torch.empty((mbh, mbw), dtype=_I32, device=dev) if mb_cost
            else None)
    fn = kernels.entry("pcamv_subpel", [_VP] * 5 + [_CI] * 3 + [_VP] * 4)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), ptr(windows), ptr(part), ptr(mvfp8), ptr(prev_mv),
            int(lam), mbh, mbw, ptr(mv8), ptr(r_idx8),
            None if cost is None else ptr(cost), kernels.stream(cur_y))
    kernels.check(rc, "pcamv_subpel")
    subpel.launches += 1
    if cost is None:
        return mv8, r_idx8
    subpel.cost_launches += 1
    return mv8, r_idx8, cost


subpel.launches = 0
subpel.cost_launches = 0


def quant_params(qp: int, tables=None, device="cpu") -> torch.Tensor:
    """The inter quant tables of `tables` (None: flat) at qp in (vr, vh)
    order: mf [16] | bias [16] | dequant mf [16], int32 on `device`
    (B4's per-qp constants, the reference's QUANT4_MF_P,
    QUANT4_BIAS_INTER and DEQUANT4_MF_P, probe_pallas.py:493-497)."""
    return (FLAT if tables is None else tables).qtab(qp, device)


def _tail_out(n: int, dev, search: bool):
    """The tail's outputs carved from one allocation: (mv8 [2mbh*2mbw
    flat, 2], r_idx8 [4n]) when `search`, then SK, SP [13, 9, n, 4] and
    sc8 [13, n, 4] int32."""
    sizes = ([8 * n, 4 * n] if search else []) + [468 * n, 468 * n, 52 * n]
    out = list(torch.empty(sum(sizes), dtype=_I32, device=dev)
               .split(sizes))
    maps = [out[-3].view(13, 9, n, 4), out[-2].view(13, 9, n, 4),
            out[-1].view(13, n, 4)]
    return out[:-3] + maps


def probe_maps(cur_y, windows, r_idx8, qp: int, mbh: int, mbw: int,
               decimate: bool = True, tables=None):
    """Kernel B4's check entry, replacing `probe_maps_pallas`
    (video_steganography_pcamv_tpu/ops/probe_pallas.py:481), with the
    rows it reads of `qpel_tables_pallas` (probe_pallas.py:221) built
    from the windows: per 8x8 block and per probe version (the centre,
    then the 12 D_MV deltas), DCT -> quant -> decimate score -> dequant
    -> IDCT -> recon, and the SATD of the recon and of the pred against
    the 9 D_NB lattice rows. Every path runs B4 inside `analyse_tail`;
    this entry, B4 on rows the caller gives, is on no path (it holds
    B4 against its twin on chosen rows). On the H100 it is bound by its
    integer work (the transforms run on the int8 tensor cores).

    cur_y [16mbh,16mbw] int32, windows [N8,4,16,16] uint8, r_idx8 [N8]
    int32 (chosen rows, in the +-3 box); tables the encoder's
    `ops.cqm.QuantTables` (its inter class and deadzone; None: flat) ->
    (SK [13,9,n,4], SP [13,9,n,4], sc8 [13,n,4]) int32; with decimate
    off, SP = SK and sc8 = 0."""
    if cur_y.device.type == "cpu":
        return probe_maps_plain(cur_y, windows, r_idx8, qp, mbh, mbw,
                                decimate, tables)
    n = mbh * mbw
    chk = kernels.check_tensor
    chk("probe_maps", "cur_y", cur_y, _I32, (16 * mbh, 16 * mbw))
    _check_windows("probe_maps", windows, 4 * n)
    chk("probe_maps", "r_idx8", r_idx8, _I32, (4 * n,))
    if not 0 <= qp <= 51:
        raise ValueError("probe_maps: qp %d outside [0, 51]" % qp)
    dev = cur_y.device
    qtab = quant_params(qp, tables, dev)
    SK, SP, sc8 = _tail_out(n, dev, False)
    fn = kernels.entry("pcamv_probe_maps", [_VP] * 4 + [_CI] * 4 + [_VP] * 4)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), ptr(windows), ptr(r_idx8), ptr(qtab), qp // 6 - 4,
            int(decimate), mbh, mbw, ptr(SK), ptr(SP), ptr(sc8),
            kernels.stream(cur_y))
    kernels.check(rc, "pcamv_probe_maps")
    probe_maps.launches += 1
    return SK, SP, sc8


probe_maps.launches = 0


def analyse_tail(cur_y, windows, part, mvfp8, prev_mv, lam: int, qp: int,
                 mbh: int, mbw: int, decimate: bool = True, tables=None):
    """B3 -> B4 on the windows (B2 fused into both), the contract of
    `analyse_tail_pallas`
    (video_steganography_pcamv_tpu/ops/probe_pallas.py:574), which
    replaces its kernels `subpel_pallas` (:301) and `probe_maps_pallas`
    (:481): on the H100 one launch of `csrc/analyse_tail.cu` (each MB's
    windows staged once, B3's chosen rows kept in shared memory for B4),
    counted in `analyse_tail.launches`; on the CPU `subpel_parts` then
    `probe_maps_plain`.

    cur_y [16mbh,16mbw] int32; windows [N8,4,16,16] uint8 (spatial
    order, `gather_windows8` layout); part [mbh,mbw]; mvfp8 [2mbh,2mbw,2]
    full-pel; prev_mv [mbh,mbw,2] qpel predictor; tables B4's quant
    tables (None: flat). Returns (mv8 [2mbh,2mbw,2] qpel, r_idx8 [N8]
    spatial, SK [13,9,n,4], SP, sc8 [13,n,4])."""
    if cur_y.device.type == "cpu":
        mv8, r_idx8 = subpel_parts(cur_y, windows, part, mvfp8, prev_mv,
                                   mbh, mbw, lam)
        return (mv8, r_idx8) + probe_maps_plain(
            cur_y, windows, r_idx8, qp, mbh, mbw, decimate, tables)
    _check_tail_inputs("analyse_tail", cur_y, windows, part, mvfp8, prev_mv,
                       lam, mbh, mbw)
    if not 0 <= qp <= 51:
        raise ValueError("analyse_tail: qp %d outside [0, 51]" % qp)
    n = mbh * mbw
    dev = cur_y.device
    qtab = quant_params(qp, tables, dev)
    mv8, r_idx8, SK, SP, sc8 = _tail_out(n, dev, True)
    mv8 = mv8.view(2 * mbh, 2 * mbw, 2)
    fn = kernels.entry("pcamv_analyse_tail",
                       [_VP] * 5 + [_CI, _VP] + [_CI] * 4 + [_VP] * 6)
    ptr = kernels.ptr
    rc = fn(ptr(cur_y), ptr(windows), ptr(part), ptr(mvfp8), ptr(prev_mv),
            int(lam), ptr(qtab), qp // 6 - 4, int(decimate), mbh, mbw,
            ptr(mv8), ptr(r_idx8), ptr(SK), ptr(SP), ptr(sc8),
            kernels.stream(cur_y))
    kernels.check(rc, "pcamv_analyse_tail")
    analyse_tail.launches += 1
    return mv8, r_idx8, SK, SP, sc8


analyse_tail.launches = 0
