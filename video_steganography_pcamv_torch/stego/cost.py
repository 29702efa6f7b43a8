"""RCA cost assignment helpers (port of stego/cost.py: `cost_mv_table`
and `rca_decide`; candidate tables from analyse.c:2561-2565)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import const

D_MV = np.array([(0, -1), (1, 0), (0, 1), (-1, 0),
                 (-2, 1), (-1, 2), (1, 2), (2, 1),
                 (2, -1), (1, -2), (-1, -2), (-2, -1)], np.int32)
D_NB = np.array([(0, -1), (1, 0), (0, 1), (-1, 0),
                 (-1, -1), (-1, 1), (1, -1), (1, 1), (0, 0)], np.int32)

_BIG = 1 << 29


def cost_mv_table(lam: int, max_abs: int = 512) -> np.ndarray:
    """lambda * (log2(|d|+1)*2 + 0.718 + (|d|!=0)) + .5, by qpel |d|."""
    d = np.arange(0, 4 * max_abs + 1)
    return (lam * (np.log2(d + 1) * 2 + 0.718 + (d != 0)) + 0.5) \
        .astype(np.int32)


def rca_decide(nb0, orig_cost, orig_opt, cand_cost, cand_opt):
    """Class-preserving candidate choice with the first-4 early exit,
    error-position fallback and the beta1 = 1.4 / beta2 = 4 penalties
    (analyse.c:2412-2549). Returns (rho f32 [n], sel_delta [n,2],
    flags [n,3]).

    The penalties multiply in float32 and truncate, one torch op each,
    so no fused multiply-add can change a bit on any device."""
    dev = nb0.device
    valid = cand_opt == orig_opt[:, None]
    masked = torch.where(valid, cand_cost, _BIG)
    any4 = valid[:, :4].any(1)
    late = torch.arange(12, device=dev)[None, :] >= 4
    masked = torch.where(any4[:, None] & late, _BIG, masked)
    best_idx = torch.argmin(masked, dim=1)
    best_cost = masked.gather(1, best_idx[:, None])[:, 0]
    found = best_cost < _BIG

    fb_idx = torch.argmin(nb0[:, :4], dim=1)
    fb_cost = nb0.gather(1, fb_idx[:, None])[:, 0]

    sel_delta = torch.where(found[:, None], const(D_MV, dev)[best_idx],
                            const(D_NB, dev)[fb_idx])
    sel_cost = torch.where(found, best_cost, fb_cost)
    b_2_neighbor = found & (best_idx >= 4)
    b_error = ~found

    f32 = torch.float32
    cost_opt = torch.clamp(sel_cost - orig_cost, min=1).to(torch.int32)
    beta1 = torch.tensor(1.4, dtype=f32, device=dev)
    beta2 = torch.tensor(4.0, dtype=f32, device=dev)
    scaled1 = torch.mul(beta1, cost_opt.to(f32)).to(torch.int32)
    cost_opt = torch.where(b_2_neighbor, scaled1, cost_opt)
    scaled2 = torch.mul(beta2, cost_opt.to(f32)).to(torch.int32)
    cost_opt = torch.where(b_error, scaled2, cost_opt)
    flags = torch.stack([orig_opt, b_2_neighbor, b_error], 1)
    return cost_opt.to(f32), sel_delta, flags
