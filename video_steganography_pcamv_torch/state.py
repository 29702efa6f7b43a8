"""Carry a live reference encoder's state over to the port.

`from_reference(jax_encoder)` snapshots everything the serving path
reads between frames as numpy arrays and plain Python values: the
reference planes, the temporal MV predictor, the lookahead's previous
lowres plane and keyframe counters, the rate-control state, the stego
message PRNG and STC matrix LCG (and the messages sent so far; none
with stego off),
frame_num, the POC LSB, the IDR picture id, the encode stats (frame and
bit counts, the PSNR/SSIM sums `close()` reports, the stego counters),
the pending pipelined frame if there is one, and the B pipe: the
buffered display-order frames (source planes, padded planes, lookahead
SATD, display index, lowres plane), the display counters, the newest
anchor's lowres plane, display index, frame_num and colocated motion
field, the motion the next anchor's field would fall back to (with its
intra MBs, which a stego-off P frame may hold), the
lookahead's adaptive-B flag, the pending L0 reordering op of the P slice
after a pyramid GOP and the `direct` auto score, and the noise
reduction's running sums and block count (a resumed `--nr` stream
diverges without them; the quant lists come from Params, as in the
reference, where each Encoder installs its own). Each DPB entry keeps its
display index, frame_num, kind (anchor or reference B) and its own L0
display indices, from which the P list view is derived again.
Adaptive quantization needs no field: the reference rebuilds its
`_aq_grids` from each frame's source planes, and so does the port
(`Encoder.aq_grids`). `load_state(port_encoder, state)` installs it, so the port can resume
mid-stream, at a GOP boundary or inside a GOP. `multi_from_reference` /
`load_multi_state` do the same for a `MultiEncoder` between steps: each
stream's state and the stacked references. This module imports no
jax: it only reads attributes and converts arrays with `numpy.asarray`.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .utils.yuv import Frame

_REF_KEYS = ("luma", "u", "v")
_RES_KEYS = ("luma_lev", "chroma_dc", "chroma_ac", "cbp_luma",
             "cbp_chroma", "luma8_lev", "trans8")
_PEND_KEYS = ("qp", "part", "mvd", "skip", "final8", "frame_num",
              "poc_lsb", "aud")
_META_KEYS = ("_disp", "_fn", "_anchor", "_ref_poc0")


def from_reference(enc) -> dict:
    """Snapshot of a reference `Encoder` on the IPP serving slice."""
    la = enc.lookahead
    pend = None
    if enc._pending_p is not None:
        pd = enc._pending_p
        pend = {"buf": np.asarray(pd["buf"]),
                "res": {k: np.asarray(pd["res"][k]) for k in _RES_KEYS
                        if k in pd["res"]},
                **{k: copy.deepcopy(pd[k]) for k in _PEND_KEYS}}
    st = enc._stego

    def arr(a):
        return None if a is None else np.asarray(a)

    info = getattr(enc, "last_frame_info", None) or {}
    # a sub-8x8 anchor's per-4x4 field, the others' per-8x8 one
    motion = (None if info.get("mv8") is None else (
        np.asarray(info["mv4"] if info.get("mv4") is not None
                   else info["mv8"]), arr(info.get("ref8")),
        np.asarray(info["kind"]) >= 2))
    bpipe = {
        "bbuf": [{"frame": tuple(np.asarray(x) for x in (f.y, f.u, f.v)),
                  "planes": tuple(np.asarray(x) for x in (y, u, v)),
                  "satd": int(satd), "disp": int(disp), "lr": arr(lr)}
                 for (f, y, u, v, satd, disp, lr) in enc._bbuf],
        "disp_idx": enc._disp_idx,
        "last_idr_disp": enc._last_idr_disp,
        "col": (None if enc._col is None
                else tuple(np.asarray(x) for x in enc._col)),
        "anchor_lr": arr(enc._anchor_lr),
        "anchor_motion": motion,
        "bad_b_candidate": bool(la.bad_b_candidate),
        "anchor_disp": int(enc._anchor_disp),
        "last_anchor_fn": int(enc._last_anchor_fn),
        "reorder_next_p": bool(enc._reorder_next_p),
        "direct_score": [int(x) for x in enc._direct_score],
    }
    return {
        "dpb": [{**{k: np.asarray(e[k]) for k in _REF_KEYS},
                 **{k: copy.deepcopy(e[k]) for k in _META_KEYS}}
                for e in enc._dpb_store],
        "prev_mv": None if enc.prev_mv is None else np.asarray(enc.prev_mv),
        "lookahead": {
            "prev_lr": None if la.prev_lr is None else np.asarray(la.prev_lr),
            "last_keyframe": la.last_keyframe,
            "frame_idx": la.frame_idx},
        "rc": copy.deepcopy(enc.rc.__dict__),
        "stego_rng": None if st is None else st._rng.get_state(),
        "stc_holdrand": None if st is None else st._stc_state.holdrand,
        "sent_messages": ([] if st is None
                          else [np.asarray(m) for m in st.sent_messages]),
        "frame_num": enc.frame_num,
        "poc_lsb": enc._poc_lsb,
        "idr_pic_id": enc.idr_pic_id,
        "stats": dataclasses.asdict(enc.stats),
        "pending": pend,
        "bpipe": bpipe,
        "nr_sum": np.array(enc._nr_sum, np.float64),
        "nr_count": int(enc._nr_count),
    }


def load_state(enc, d: dict) -> None:
    """Install a `from_reference` snapshot into a port `Encoder`."""
    dev = enc.device

    def t(a):
        return torch.as_tensor(np.array(a)).to(dev)

    enc._dpb_store = [{**{k: t(e[k]).to(torch.int32) for k in _REF_KEYS},
                       **{k: copy.deepcopy(e[k]) for k in _META_KEYS}}
                      for e in d["dpb"]]
    enc._refresh_dpb_view()
    enc.prev_mv = (None if d["prev_mv"] is None
                   else np.array(d["prev_mv"], np.int32))
    la = d["lookahead"]
    enc.lookahead.prev_lr = (None if la["prev_lr"] is None
                             else t(la["prev_lr"]).to(torch.int32))
    enc.lookahead.last_keyframe = la["last_keyframe"]
    enc.lookahead.frame_idx = la["frame_idx"]
    enc.rc.__dict__.update(copy.deepcopy(d["rc"]))
    if (enc._stego is None) != (d["stego_rng"] is None):
        raise ValueError("load_state: stego on in one encoder, off in the "
                         "other")
    if enc._stego is not None:
        enc._stego._rng.set_state(d["stego_rng"])
        enc._stego._stc_state.holdrand = d["stc_holdrand"]
        enc._stego.sent_messages = [np.array(m) for m in d["sent_messages"]]
    enc.frame_num = d["frame_num"]
    enc._poc_lsb = d["poc_lsb"]
    enc.idr_pic_id = d["idr_pic_id"]
    enc._nr_sum = np.array(d["nr_sum"], np.float64)
    enc._nr_count = int(d["nr_count"])
    for f in dataclasses.fields(enc.stats):
        if f.name in d["stats"]:
            setattr(enc.stats, f.name, d["stats"][f.name])
    _load_bpipe(enc, d["bpipe"], t)
    enc._pending_p = None
    if d["pending"] is not None:
        pd = {k: copy.deepcopy(d["pending"][k]) for k in _PEND_KEYS}
        pd["buf"] = t(d["pending"]["buf"])
        pd["res"] = {k: t(v) for k, v in d["pending"]["res"].items()}
        enc._pending_p = pd


def _load_bpipe(enc, b: dict, t) -> None:
    def t_or_none(a):
        return None if a is None else t(a).to(torch.int32)

    enc._bbuf = [(Frame(*(np.array(x) for x in e["frame"])),
                  *(t(x).to(torch.int32) for x in e["planes"]), e["satd"],
                  e["disp"], t_or_none(e["lr"])) for e in b["bbuf"]]
    enc._disp_idx = b["disp_idx"]
    enc._last_idr_disp = b["last_idr_disp"]
    enc._col = (None if b["col"] is None
                else tuple(np.array(x, np.int32) for x in b["col"]))
    enc._anchor_lr = t_or_none(b["anchor_lr"])
    m = b["anchor_motion"]
    enc._anchor_motion = (None if m is None else (
        np.array(m[0], np.int32), None if m[1] is None
        else np.array(m[1], np.int32), np.array(m[2], bool)))
    enc.lookahead.bad_b_candidate = b["bad_b_candidate"]
    enc._anchor_disp = b["anchor_disp"]
    enc._last_anchor_fn = b["last_anchor_fn"]
    enc._reorder_next_p = b["reorder_next_p"]
    enc._direct_score = list(b["direct_score"])


def multi_from_reference(me) -> dict:
    """Snapshot of a reference `MultiEncoder` between steps: each
    stream's `from_reference` and the stacked references [S, ...] (None
    before the first step)."""
    refs = None if me._refs is None else {
        k: np.asarray(me._refs[k]) for k in _REF_KEYS}
    return {"streams": [from_reference(e) for e in me.encs], "refs": refs}


def load_multi_state(me, d: dict) -> None:
    """Install a `multi_from_reference` snapshot into a port
    `MultiEncoder`: each stream's state, then each stream's reference
    rebuilt from its slice of the stacked ones."""
    if len(d["streams"]) != me.S:
        raise ValueError("a snapshot of %d streams for %d"
                         % (len(d["streams"]), me.S))
    for e, st in zip(me.encs, d["streams"]):
        load_state(e, st)
    me._refs = None if d["refs"] is None else [
        {k: torch.as_tensor(np.array(d["refs"][k][s])).to(e.device,
                                                           torch.int32)
         for k in _REF_KEYS} for s, e in enumerate(me.encs)]
