"""Lookahead slice-type decision (port of encoder/slicetype.py:
`lowres`, `lowres_costs`, `Lookahead.decide`, `costs_device`,
`decide_from_costs`, the adaptive-B signal `bad_b_candidate` of
`b_adapt` 1, and `b_adapt` 2's placement: `lowres_costs_window`,
`slicetype_path`, `Lookahead.decide_b_placement`), and B10,
`lowres_costs_kernel`.

The lookahead runs the plain `lowres_costs` on every device: B10's MV
cost differs from it (the se(v) bits of B1 against a 4(|dx| + |dy|)
penalty), so a lookahead on B10 would decide other frame types than the
reference does, and the stream would stop matching. B10 is ported for
the kernel table and serves no path."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mc
from ..ops.blocks import to_blocks
from ..ops.fullpel import fullpel_parts, fullpel_search_parts

_I32 = torch.int32


def lowres(y: torch.Tensor) -> torch.Tensor:
    """Half-res 2x2 average, rounding up."""
    h, w = y.shape
    t = y.reshape(h // 2, 2, w // 2, 2)
    return (t[:, 0, :, 0] + t[:, 0, :, 1] + t[:, 1, :, 0]
            + t[:, 1, :, 1] + 2) >> 2


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    h, w = x.shape
    rows = torch.arange(-r, h + r, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=x.device).clamp(0, w - 1)
    return x[rows][:, cols]


def lowres_costs(cur_lr, ref_lr, bh: int, bw: int, rng: int = 8):
    """(cost_i, cost_p) of a lowres frame: per-8x8 exhaustive inter SAD
    against the previous lowres frame vs a DC intra SAD. Returns an
    int32 [2] tensor."""
    h, w = 8 * bh, 8 * bw
    ref_pad = _edge_pad(ref_lr, rng)
    best = torch.full((bh, bw), 1 << 30, dtype=_I32, device=cur_lr.device)
    side = 2 * rng + 1
    for i in range(side * side):
        dy = i // side - rng
        dx = i % side - rng
        win = ref_pad[rng + dy:rng + dy + h, rng + dx:rng + dx + w]
        sad = to_blocks(torch.abs(cur_lr - win), 8).sum((-4, -3),
                                                       dtype=_I32)
        best = torch.minimum(best, sad + 4 * (abs(dy) + abs(dx)))
    intra = _dc_intra(cur_lr)
    cost_p = torch.minimum(best, intra).sum(dtype=_I32)
    cost_i = intra.sum(dtype=_I32)
    return torch.stack([cost_i, cost_p])


def lowres_costs_window(stack, triples, bh: int, bw: int, rng: int):
    """Lowres frame-cost estimates of (cur, fwd, bwd, has_b) triples over
    a lookahead window, the reference's `lowres_costs_window`
    (slicetype.py:106): per 8x8 block the minimum of the DC intra SAD,
    the best +-rng forward SAD and, where has_b, the best backward SAD
    and the best SAD against the average of the co-located forward and
    backward windows (each SAD plus 4(|dy| + |dx|)), summed over the
    frame. All triples run in one batch, step by step over the window
    offsets: each step holds one [T, H, W] window per list, never one
    plane per step.

    stack [L, 8bh, 8bw] int32 lowres planes; triples a list of (cur,
    fwd, bwd, has_b) stack indices (bwd ignored without has_b). Returns
    an int64 [T] tensor. The reference sums the block minimums in int32
    (JAX without x64); the totals stay below 2^31 at 1080p, so the int64
    sums are the same numbers."""
    dev = stack.device
    h, w = 8 * bh, 8 * bw
    tri = torch.as_tensor(np.asarray(triples, np.int64).reshape(-1, 4),
                          device=dev)
    pad = torch.stack([_edge_pad(s, rng) for s in stack])
    cur = stack[tri[:, 0]]
    reff = pad[tri[:, 1]]
    isb = torch.nonzero(tri[:, 3]).reshape(-1)
    curb, refb = cur[isb], pad[tri[isb, 2]]
    reffb = reff[isb]
    t, nb = tri.shape[0], isb.shape[0]

    def block_sad(a, b):
        return torch.abs(a - b).reshape(-1, bh, 8, bw, 8).sum(
            (2, 4), dtype=_I32)

    bf = torch.full((t, bh, bw), 1 << 30, dtype=_I32, device=dev)
    bb = torch.full((nb, bh, bw), 1 << 30, dtype=_I32, device=dev)
    bavg = torch.full((nb, bh, bw), 1 << 30, dtype=_I32, device=dev)
    side = 2 * rng + 1
    for i in range(side * side):
        dy, dx = i // side - rng, i % side - rng
        pen = 4 * (abs(dy) + abs(dx))
        ys, xs = rng + dy, rng + dx
        bf = torch.minimum(bf, block_sad(cur, reff[:, ys:ys + h, xs:xs + w])
                           + pen)
        if nb:
            wf = reffb[:, ys:ys + h, xs:xs + w]
            wb = refb[:, ys:ys + h, xs:xs + w]
            bb = torch.minimum(bb, block_sad(curb, wb) + pen)
            bavg = torch.minimum(bavg, block_sad(curb, (wf + wb + 1) >> 1)
                                 + pen)
    blocks = cur.reshape(t, bh, 8, bw, 8)
    dc = torch.div(blocks.sum((2, 4), keepdim=True, dtype=_I32), 64,
                   rounding_mode="floor")
    intra = torch.abs(blocks - dc).sum((2, 4), dtype=_I32)
    best = torch.minimum(intra, bf)
    if nb:
        best[isb] = torch.minimum(best[isb], torch.minimum(bb, bavg))
    return best.sum((1, 2), dtype=torch.int64)


def slicetype_path(costs, n: int, bframes: int):
    """The B-placement DP over the window, the reference's
    `slicetype_path` (slicetype.py:160, x264's B_ADAPT_TRELLIS
    semantics): anchor positions minimising the summed float cost
    estimates, a strict < keeping the first minimum. costs: dict[(kind,
    i, a, b)] -> cost, kind in ('P', 'B'), window positions with the
    previous anchor at -1; every path ends with an anchor at the last
    frame. Returns the first anchor position k (buf[:k] become B
    frames)."""
    inf = float("inf")
    dp = [inf] * n
    first = [0] * n
    for j in range(n):
        for a in range(max(-1, j - 1 - bframes), j):
            seg = costs[("P", j, a, -2)]
            for i in range(a + 1, j):
                seg += costs[("B", i, a, j)]
            prev = 0.0 if a == -1 else dp[a]
            if prev + seg < dp[j]:
                dp[j] = prev + seg
                first[j] = j if a == -1 else first[a]
    return first[n - 1]


def _dc_intra(cur_lr):
    """Per-8x8 DC-prediction SAD [bh, bw] int32."""
    blocks = to_blocks(cur_lr, 8)
    dc = torch.div(blocks.sum((-4, -3), keepdim=True, dtype=_I32), 64,
                   rounding_mode="floor")
    return torch.abs(blocks - dc).sum((-4, -3), dtype=_I32)


def _lowres_costs_b1(search, cur_lr, ref_lr, bh: int, bw: int, rng: int):
    h, w = 8 * bh, 8 * bw
    ph, pw = (-h) % 16, (-w) % 16
    rows = torch.arange(h + ph, device=cur_lr.device).clamp(max=h - 1)
    cols = torch.arange(w + pw, device=cur_lr.device).clamp(max=w - 1)
    cur_p = cur_lr.to(_I32)[rows][:, cols].contiguous()
    ref_p = mc.pad_plane(ref_lr.to(torch.uint8)[rows][:, cols]) \
        .contiguous()
    mh, mw = (h + ph) // 16, (w + pw) // 16
    zero = torch.zeros((mh, mw, 2), dtype=_I32, device=cur_lr.device)
    c8 = search(cur_p, ref_p, zero, rng, mh, mw, 1)["c8"]
    inter = c8.reshape(mh, mw, 2, 2).permute(0, 2, 1, 3) \
        .reshape(2 * mh, 2 * mw)[:bh, :bw]
    intra = _dc_intra(cur_lr)
    return torch.stack([intra.sum(dtype=_I32),
                        torch.minimum(inter, intra).sum(dtype=_I32)])


def lowres_costs_kernel_plain(cur_lr, ref_lr, bh: int, bw: int,
                              rng: int = 8):
    """Plain version of B10: the same wrapper over B1's plain version
    `fullpel_search_parts`."""
    return _lowres_costs_b1(fullpel_search_parts, cur_lr, ref_lr, bh, bw,
                            rng)


def lowres_costs_kernel(cur_lr, ref_lr, bh: int, bw: int, rng: int = 8):
    """B10, replacing the reference's `lowres_costs_pallas`
    (video_steganography_pcamv_tpu/encoder/slicetype.py:41), a wrapper
    over the TPU kernel B1: the lowres plane, edge-padded to 16-multiples,
    tiled as 16x16 "MBs" so that B1's c8 output (zero predictor, lam 1)
    is every 8x8 block's inter SAD argmin; DC intra as in `lowres_costs`.
    Returns int32 [2] (cost_i, cost_p). On a CUDA tensor B1's kernel
    runs (counted in `lowres_costs_kernel.launches` and in
    `fullpel_parts.launches`), on a CPU one its plain version."""
    out = _lowres_costs_b1(fullpel_parts, cur_lr, ref_lr, bh, bw, rng)
    if cur_lr.is_cuda:
        lowres_costs_kernel.launches += 1
    return out


lowres_costs_kernel.launches = 0


class Lookahead:
    """IDR-vs-P decision: keyint expiry or scenecut (slicetype.c:437);
    the adaptive-B signal and the b_adapt 2 placement."""

    def __init__(self, params):
        self.p = params
        self.prev_lr = None
        self.last_keyframe = -(10 ** 9)
        self.frame_idx = -1
        self._pending_lr = None
        # b_adapt 1: the newest decided frame predicts poorly from its
        # predecessor (the B pipe closes the GOP with it as the anchor)
        self.bad_b_candidate = False

    def costs_device(self, y: torch.Tensor) -> torch.Tensor:
        """Enqueue the lowres costs without a host pull; pair with
        decide_from_costs once the values are on the host."""
        p = self.p
        cur_lr = lowres(y)
        out = lowres_costs(cur_lr, self.prev_lr, p.mb_height, p.mb_width,
                           rng=p.lookahead_me_range)
        self._pending_lr = cur_lr
        return out

    def decide_from_costs(self, ci: int, cp: int):
        self.frame_idx += 1
        self.prev_lr = self._pending_lr
        return self._decide_host(self.frame_idx, ci, cp)

    def decide(self, y: torch.Tensor):
        """(is_idr, complexity) for the incoming padded luma plane."""
        p = self.p
        self.frame_idx += 1
        idx = self.frame_idx
        bh, bw = p.mb_height, p.mb_width
        cur_lr = lowres(y)
        if self.prev_lr is None:
            self.prev_lr = cur_lr
            self.last_keyframe = idx
            both = lowres_costs(cur_lr, cur_lr, bh, bw, rng=0).cpu()
            return True, int(both[0])
        both = lowres_costs(cur_lr, self.prev_lr, bh, bw,
                            rng=p.lookahead_me_range).cpu()
        ci, cp = int(both[0]), int(both[1])
        self.prev_lr = cur_lr
        return self._decide_host(idx, ci, cp)

    def decide_b_placement(self, anchor_lr, buf_lrs, bframes: int) -> int:
        """b_adapt 2 over the lookahead window: the cost estimates of
        every (p0, b, p1) triple the DP can touch in one batched device
        call and one pull, then `slicetype_path`. anchor_lr: the previous
        anchor's lowres plane; buf_lrs: those of the buffered
        display-order frames. Returns the window position of the next
        anchor (the frames before it become B frames)."""
        p = self.p
        n = len(buf_lrs)
        if n == 1:
            return 0
        triples, keys = [], []
        for j in range(n):
            for a in range(max(-1, j - 1 - bframes), j):
                triples.append((j + 1, a + 1, a + 1, 0))
                keys.append(("P", j, a, -2))
                for i in range(a + 1, j):
                    triples.append((i + 1, a + 1, j + 1, 1))
                    keys.append(("B", i, a, j))
        vals = lowres_costs_window(
            torch.stack([anchor_lr] + list(buf_lrs)), triples, p.mb_height,
            p.mb_width, p.lookahead_me_range).cpu().tolist()
        return slicetype_path({k: float(v) for k, v in zip(keys, vals)}, n,
                              bframes)

    def _decide_host(self, idx: int, ci: int, cp: int):
        p = self.p
        since_key = idx - self.last_keyframe
        is_idr = since_key >= p.keyint_max
        if (not is_idr and p.scenecut_threshold > 0
                and since_key >= p.keyint_min):
            thresh = p.scenecut_threshold / 100.0
            bias = min(thresh * 4,
                       thresh + thresh * (since_key / p.keyint_max))
            if cp >= (1.0 - bias) * ci:
                is_idr = True
        self.bad_b_candidate = cp * 10 > ci * 9
        if is_idr:
            self.last_keyframe = idx
            return True, ci
        return False, cp
