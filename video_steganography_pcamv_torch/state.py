"""Carry a live reference encoder's state over to the port.

`from_reference(jax_encoder)` snapshots everything the serving path
reads between frames as numpy arrays and plain Python values: the
reference planes, the temporal MV predictor, the lookahead's previous
lowres plane and keyframe counters, the rate-control state, the stego
message PRNG and STC matrix LCG (and the messages sent so far),
frame_num, the POC LSB, the IDR picture id, the encode stats (frame and
bit counts, the PSNR/SSIM sums `close()` reports, the stego counters),
and the pending pipelined frame if there is one. `load_state(port_encoder, state)` installs it,
so the port can resume mid-stream at a real P frame. This module imports no jax: it
only reads attributes and converts arrays with `numpy.asarray`.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

_REF_KEYS = ("luma", "u", "v")
_RES_KEYS = ("luma_lev", "chroma_dc", "chroma_ac", "cbp_luma",
             "cbp_chroma", "luma8_lev", "trans8")
_PEND_KEYS = ("qp", "part", "mvd", "skip", "final8", "frame_num",
              "poc_lsb", "aud")


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
    return {
        "dpb": [{k: np.asarray(e[k]) for k in _REF_KEYS}
                for e in enc._dpb_store],
        "prev_mv": None if enc.prev_mv is None else np.asarray(enc.prev_mv),
        "lookahead": {
            "prev_lr": None if la.prev_lr is None else np.asarray(la.prev_lr),
            "last_keyframe": la.last_keyframe,
            "frame_idx": la.frame_idx},
        "rc": copy.deepcopy(enc.rc.__dict__),
        "stego_rng": st._rng.get_state(),
        "stc_holdrand": st._stc_state.holdrand,
        "sent_messages": [np.asarray(m) for m in st.sent_messages],
        "frame_num": enc.frame_num,
        "poc_lsb": enc._poc_lsb,
        "idr_pic_id": enc.idr_pic_id,
        "stats": dataclasses.asdict(enc.stats),
        "pending": pend,
    }


def load_state(enc, d: dict) -> None:
    """Install a `from_reference` snapshot into a port `Encoder`."""
    dev = enc.device

    def t(a):
        return torch.as_tensor(np.array(a)).to(dev)

    enc._dpb_store = [{k: t(e[k]).to(torch.int32) for k in _REF_KEYS}
                      for e in d["dpb"]]
    enc.ref = enc._dpb_store[0] if enc._dpb_store else None
    enc.prev_mv = (None if d["prev_mv"] is None
                   else np.array(d["prev_mv"], np.int32))
    la = d["lookahead"]
    enc.lookahead.prev_lr = (None if la["prev_lr"] is None
                             else t(la["prev_lr"]).to(torch.int32))
    enc.lookahead.last_keyframe = la["last_keyframe"]
    enc.lookahead.frame_idx = la["frame_idx"]
    enc.rc.__dict__.update(copy.deepcopy(d["rc"]))
    enc._stego._rng.set_state(d["stego_rng"])
    enc._stego._stc_state.holdrand = d["stc_holdrand"]
    enc._stego.sent_messages = [np.array(m) for m in d["sent_messages"]]
    enc.frame_num = d["frame_num"]
    enc._poc_lsb = d["poc_lsb"]
    enc.idr_pic_id = d["idr_pic_id"]
    for f in dataclasses.fields(enc.stats):
        if f.name in d["stats"]:
            setattr(enc.stats, f.name, d["stats"][f.name])
    enc._pending_p = None
    if d["pending"] is not None:
        pd = {k: copy.deepcopy(d["pending"][k]) for k in _PEND_KEYS}
        pd["buf"] = t(d["pending"]["buf"])
        pd["res"] = {k: t(v) for k, v in d["pending"]["res"].items()}
        enc._pending_p = pd
