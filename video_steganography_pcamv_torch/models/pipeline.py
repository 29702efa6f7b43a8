"""The flagship P-frame steps (port of models/pipeline.py): one P frame's
device stages, analysis -> encode -> stego costs, as one call.

`p_frame_step` is the 16x16 step: the full-pel search (kernel B6) against
a zero predictor, the per-MB window fetch (kernel B7, the reference's
`gather_windows_jnp` gather), the qpel block tables, the subpel argmin,
the P encode (the fused luma-encode kernel) and, `with_stego`, the RCA
costs from the same tables (the fused luma encode once more, on the 13
probe versions). `p_frame_step_parts` is the partitioned step: kernel
B1, the partition decision, B9, B3 -> B4 (`partition.
analyse_p_frame_parts`), the partitioned encode and, `with_stego`,
`probe_combine` against zero unit predictors. `multi_stream_step` calls
either per stream over a leading stream axis.

`use_pallas` is the reference's branch argument (ROADMAP C1). The port
runs its kernels on both branches; the argument picks only B1's MV
predictor in the partitioned step: zero (True, the reference's
accelerator branch) or prev_mv >> 2 (False, its CPU branch). The 16x16
step searches against zero on both.

Every tensor stays on the device of `y`; lam and qp are ints.
"""

from __future__ import annotations

import torch

from ..encoder import inter as INTER
from ..encoder import partition as PT
from ..encoder.analyse2 import analyse_p_frame, stego_costs_from_table
from ..ops.aq import fma32, ln_xla, _INV_LN2

_N_COST = 4 * 512 + 1


def default_cost_mv(lam: int, device) -> torch.Tensor:
    """The steps' MV-cost table when the caller passes none: the
    reference's `(lam * (2 * log2(d + 1) + 0.718 + (d != 0)) + 0.5)
    .astype(int32)` over d in 0..2048, bit for bit as XLA computes it
    in float32 on the CPU (ROADMAP C8): `2 * log2(x)` folded into
    `ln(x) * (2 / ln 2)`, that product and `+ 0.718` one FMA, and `lam *
    base + 0.5` one FMA, except that the last element (2049 = 8 * 256 +
    1: the scalar remainder of XLA's vector loop) adds 0.718 to the
    rounded product. int32 [2049] on `device`."""
    d = torch.arange(_N_COST, dtype=torch.float32, device=device)
    ln = ln_xla(d + 1.0)
    base = fma32(ln, 2.0 * _INV_LN2, 0.718)
    base[-1] = (ln[-1] * _INV_LN2) * 2.0 + 0.718
    base = base + (d != 0).to(torch.float32)
    lam_t = torch.full_like(base, float(lam))
    return fma32(lam_t, base, 0.5).to(torch.int32)


def _check_step(subpel: int, decimate: bool) -> None:
    if subpel != 2:
        raise NotImplementedError("subpel %d (ROADMAP A16d)" % subpel)
    if not decimate:
        raise NotImplementedError("decimate off (ROADMAP A16d)")


def p_frame_step(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp: int,
                 qpc: int, mbh: int, mbw: int, rng: int, lam: int,
                 subpel: int = 2, decimate: bool = True,
                 with_stego: bool = True, use_pallas: bool = False,
                 cost_mv=None) -> dict:
    """One 16x16 P frame, all device stages (the reference's
    `p_frame_step`). y/u/v int32 planes, ref_* `mc.build_ref` planes,
    prev_mv [mbh,mbw,2] qpel (the subpel and probe MV predictor).
    Returns the encode's dict plus "mv" [mbh,mbw,2] and, `with_stego`,
    "stego_rho" [mbh,mbw] float32 and "stego_alt_mv" [mbh,mbw,2]."""
    _check_step(subpel, decimate)
    mv_q, r_idx, blocks, wht = analyse_p_frame(y, ref_luma, prev_mv, rng,
                                               mbh, mbw, lam)
    out = INTER.encode_p_frame_device(y, u, v, ref_luma, ref_u, ref_v,
                                      mv_q, qp, qpc, mbh, mbw)
    out["mv"] = mv_q
    if with_stego:
        if cost_mv is None:
            cost_mv = default_cost_mv(lam, y.device)
        rho, alt, _flags = stego_costs_from_table(
            y, blocks, wht, r_idx, mv_q, prev_mv, cost_mv, qp, mbh, mbw)
        out["stego_rho"] = rho
        out["stego_alt_mv"] = alt
    return out


def p_frame_step_parts(y, u, v, ref_luma, ref_u, ref_v, prev_mv, qp: int,
                       qpc: int, mbh: int, mbw: int, rng: int, lam: int,
                       subpel: int = 2, decimate: bool = True,
                       with_stego: bool = True, use_pallas: bool = False,
                       cost_mv=None) -> dict:
    """The partitioned step (the reference's `p_frame_step_parts`): the
    analysis (B1 against zero with `use_pallas`, else prev_mv >> 2), the
    partitioned encode and, `with_stego`, the RCA costs with zero unit
    predictors. Returns the encode's dict plus "part" [mbh,mbw], "mv8"
    [2mbh,2mbw,2] and, `with_stego`, "stego_rho" [mbh,mbw,4] float32,
    "stego_alt_mv" [mbh,mbw,4,2] and "stego_valid" [mbh,mbw,4] bool."""
    _check_step(subpel, decimate)
    part, mv8, SK, SP, sc8 = PT.analyse_p_frame_parts(
        y, ref_luma.to(torch.uint8), prev_mv, lam, qp, rng, mbh, mbw,
        tail_kernel=bool(use_pallas))
    out = INTER.encode_p_frame_device8(y, u, v, ref_luma, ref_u, ref_v, mv8,
                                       qp, qpc, mbh, mbw)
    out["part"] = part
    out["mv8"] = mv8
    if with_stego:
        if cost_mv is None:
            cost_mv = default_cost_mv(lam, y.device)
        mvp_u = torch.zeros((mbh, mbw, 4, 2), dtype=torch.int32,
                            device=y.device)
        rho, alt, valid = PT.probe_combine(SK, SP, sc8, part, mv8, mvp_u,
                                           cost_mv, mbh, mbw)
        out["stego_rho"] = rho
        out["stego_alt_mv"] = alt
        out["stego_valid"] = valid
    return out


def multi_stream_step(ys, us, vs, ref_lumas, ref_us, ref_vs, prev_mvs,
                      parts: bool = False, **kw) -> dict:
    """`p_frame_step` (or with `parts` `p_frame_step_parts`) per stream
    over a leading stream axis [S, ...]; every output stacked on it."""
    step = p_frame_step_parts if parts else p_frame_step
    outs = [step(*a, **kw) for a in zip(ys, us, vs, ref_lumas, ref_us,
                                         ref_vs, prev_mvs)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
