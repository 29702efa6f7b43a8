"""The port's accelerator branch (tail_kernel=True, bench.py's default)
end to end vs the JAX `Encoder` on its own accelerator branch.

The reference takes that branch only on a TPU. A fixture puts it there
on the CPU without changing the JAX package, through `monkeypatch`
alone: `jax.default_backend` answers "tpu"; the full-pel kernel B1 runs
its Pallas kernel in interpret mode and the analyse tail runs the XLA
chain that the reference's own tests/test_probe_pallas.py holds its
Pallas kernels against (block_table8 + wht8_flat + subpel_parts +
probe_maps_xla: the interpret-mode tail costs ~50 s to trace and lower
in every test process; tests/test_torch_probe.py holds the port's tail
against it in interpret mode), each as a host callback of the encoder's
programs, so that each is compiled once a shape rather than inside
every program that calls it; the deblocker runs
`deblock_jax.deblock_frame_device`, the bit-exact twin the reference's
CPU branch already uses.

The same branch also serves CABAC (with and without trellis) and the
reference's default Params (PSNR on, host deblock: the fused P step
unpipelined, `close()` equal),
and BASELINE config 4's P half (ref_frames 2, CABAC: the multi-reference
branch, B1 once per reference against a zero predictor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_steganography_pcamv_tpu.decoder import decode_annexb as j_decode
from video_steganography_pcamv_tpu.encoder import partition as JPT
from video_steganography_pcamv_tpu.encoder.core import Encoder as JEncoder
from video_steganography_pcamv_tpu.ops import cqm
from video_steganography_pcamv_tpu.ops import deblock_jax
from video_steganography_pcamv_tpu.ops import deblock_pallas
from video_steganography_pcamv_tpu.ops import pallas_kernels
from video_steganography_pcamv_tpu.ops import probe_pallas
from video_steganography_pcamv_tpu.params import Params, StegoParams
from video_steganography_pcamv_tpu.stego.extract import (
    extract_from_stream as j_extract)
from video_steganography_pcamv_tpu.utils.yuv import synthetic_sequence

from video_steganography_pcamv_torch import Encoder as TEncoder
from video_steganography_pcamv_torch import params as TP
from video_steganography_pcamv_torch.decoder import decode_annexb
from video_steganography_pcamv_torch.encoder import partition as T_PT
from video_steganography_pcamv_torch.stego.extract import (
    extract_from_frames)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread here: beside the other test workers, its
    intra-op pool costs far more than it saves at these frame sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 112, 80
EM_RATE, KEY = 64, 99


def _bench_kw():
    """bench.py's Params (tail_kernel left at its default, True)."""
    return dict(width=W, height=H, qp=26, me_range=16, deblock_device=True,
                psnr=False)


def _run(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def _on_host(fn, out, *arrays):
    """fn(*arrays) as a host callback with the result structure `out`:
    inside a traced encoder program an interpret-mode kernel then runs as
    its own jitted programs, traced, lowered and compiled once a shape and
    kept in the JAX caches (memory and disk), instead of again inside
    every program that calls it (the analyse tail's interpret-mode body
    takes ~40 s to lower and ~45 s to compile). The kernel, its arguments
    and its integer results are the same. Under `vmap` (the reference's
    MultiEncoder) the callback runs once per stream."""
    def host(*a):
        # scalars back to Python numbers, as the direct callers pass them
        # (the same programs then serve both)
        a = [x.item() if np.ndim(x) == 0 else x for x in a]
        return jax.tree.map(np.asarray, fn(*a))
    return jax.pure_callback(host, out, *arrays, vmap_method="sequential")


def _i32(*shape):
    return jax.ShapeDtypeStruct(shape, np.int32)


# the reference's interpret-mode kernels, taken before any test patches
# them
_FULLPEL = pallas_kernels.fullpel_parts_pallas
_TAIL = probe_pallas.analyse_tail_pallas
_COMPILED = {}


def _sig(a):
    return type(a) if isinstance(a, (bool, int, float)) else (
        tuple(np.shape(a)), str(a.dtype))


def _cqm_key():
    """The reference's process-wide quant tables (a trace bakes them in:
    `ops/cqm.set_cqm` clears the caches when they change)."""
    return tuple((k, v if v is None or isinstance(v, int) else
                  np.asarray(v).tobytes())
                 for k, v in sorted(cqm._active.items()))


def compiled(fn, args, **static):
    """fn(*args, **static) through an executable lowered and compiled once
    per (fn, static values, argument shapes and dtypes, the reference's
    quant tables) in this process. The conftest's `jax.clear_caches()`
    after each module drops the jit caches but not these executables, so
    the test modules of one process that run an interpret-mode kernel at
    one shape and one set of tables share one trace, lowering and compile
    of it (the analyse tail's take ~90 s). The kernels are integer, so
    the results are the eager call's."""
    key = (fn, tuple(sorted(static.items())), tuple(_sig(a) for a in args),
           _cqm_key())
    exe = _COMPILED.get(key)
    if exe is None:
        exe = _COMPILED[key] = jax.jit(
            fn, static_argnames=tuple(static)).lower(*args, **static).compile()
    return exe(*args)


def _fullpel_interpret(y, ref, lam, rng, mbh, mbw):
    return _FULLPEL(y, ref, rng, mbh, mbw, lam, interpret=True)


def _tail_interpret(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw,
                    **kw):
    return _TAIL(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw,
                 interpret=True, **kw)


def _tail_xla(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw,
              decimate=True):
    """The XLA chain tests/test_probe_pallas.py::
    test_analyse_tail_matches_xla holds `analyse_tail_pallas` against."""
    blocks8 = JPT.block_table8(windows)
    wht8 = JPT.wht8_flat(blocks8).astype(jnp.int16)
    mv8, r_idx8, _ = JPT.subpel_parts(y, wht8, part, mvfp8, prev_mv, mbh,
                                      mbw, lam, 2)
    return (mv8, r_idx8) + tuple(JPT.probe_maps_xla(
        y, blocks8, wht8, r_idx8, qp, mbh, mbw, decimate))


def tail_xla(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw, **kw):
    """The reference's analyse tail as its XLA twin, compiled once a
    shape (and quant-table set) in this process (`compiled`)."""
    return compiled(_tail_xla, (y, windows, part, mvfp8, prev_mv, lam, qp),
                    mbh=mbh, mbw=mbw, **kw)


def fullpel_interpret(y, ref, rng, mbh, mbw, lam=1):
    """The reference's B1 (`fullpel_parts_pallas`) in interpret mode,
    compiled once a shape in this process (`compiled`)."""
    return compiled(_fullpel_interpret, (y, ref, lam), rng=rng, mbh=mbh,
                    mbw=mbw)


def tail_interpret(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw,
                   **kw):
    """The reference's analyse tail (`analyse_tail_pallas`) in interpret
    mode, compiled once a shape in this process (`compiled`)."""
    return compiled(_tail_interpret, (y, windows, part, mvfp8, prev_mv, lam,
                                      qp), mbh=mbh, mbw=mbw, **kw)


@pytest.fixture
def reference_accel(monkeypatch):
    """Puts the JAX Encoder on its accelerator branch; counts the calls
    of the patched kernel entries (B1 in interpret mode, the analyse tail
    as its XLA twin, each traced as a host callback: `_on_host`)."""
    calls = {"fullpel": 0, "tail": 0}

    def fullpel(y, ref, rng, mbh, mbw, lam=1):
        # fullpel_search_parts' st dict (the kernel's docstring)
        out = {"c16": _i32(mbh, mbw), "mv16": _i32(mbh, mbw, 2),
               "c16x8": _i32(mbh, mbw, 2), "mv16x8": _i32(mbh, mbw, 2, 2),
               "c8x16": _i32(mbh, mbw, 2), "mv8x16": _i32(mbh, mbw, 2, 2),
               "c8": _i32(mbh, mbw, 4), "mv8": _i32(mbh, mbw, 4, 2)}
        return _on_host(lambda yy, rr, ll: fullpel_interpret(
            yy, rr, rng, mbh, mbw, ll), out, y, ref, lam)

    class _Fullpel:
        @staticmethod
        def __wrapped__(*args, **kw):
            calls["fullpel"] += 1
            return fullpel(*args, **kw)

        # the stego-off RD re-rank calls the jitted entry itself
        # (partition.py:1628)
        def __call__(self, *args, **kw):
            return self.__wrapped__(*args, **kw)

    def tail(y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw, **kw):
        calls["tail"] += 1
        n = mbh * mbw
        out = (_i32(2 * mbh, 2 * mbw, 2), _i32(4 * n), _i32(13, 9, n, 4),
               _i32(13, 9, n, 4), _i32(13, n, 4))
        return _on_host(lambda *a: tail_xla(*a, mbh, mbw, **kw),
                        out, y, windows, part, mvfp8, prev_mv, lam, qp)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(pallas_kernels, "fullpel_parts_pallas", _Fullpel())
    monkeypatch.setattr(probe_pallas, "analyse_tail_pallas", tail)
    monkeypatch.setattr(deblock_pallas, "deblock_frame_pallas",
                        deblock_jax.deblock_frame_device)
    return calls


def test_accel_stream_byte_equal_to_reference(reference_accel):
    frames = synthetic_sequence(W, H, 6, seed=7)
    jp = Params(**_bench_kw(), stego=StegoParams(em_rate=EM_RATE, key=KEY))
    assert jp.tail_kernel
    want = _run(JEncoder(jp), frames)
    # the patched entries were traced: the reference took its branch
    assert reference_accel["fullpel"] >= 1 and reference_accel["tail"] >= 1

    tp = TP.Params(**_bench_kw(),
                   stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    assert tp.tail_kernel
    tenc = TEncoder(tp, device="cpu")
    got = _run(tenc, frames)
    assert got == want

    tp_cpu = TP.Params(**_bench_kw(),
                       stego=TP.StegoParams(em_rate=EM_RATE, key=KEY))
    tp_cpu.tail_kernel = False
    assert _run(TEncoder(tp_cpu, device="cpu"), frames) != got

    dec = decode_annexb(got)
    assert len(dec) == len(frames) == len(j_decode(got))
    sent = tenc._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(got, em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


def test_accel_config3_stream_byte_equal_to_reference(reference_accel):
    """BASELINE config 3 (transform_8x8 + rd 1) on the accelerator
    branch: byte-equal over IDR + 4 P frames with Intra_8x8 and
    8x8-transform P MBs; the port's decoder equals the JAX decoder and
    both extractors recover the payload."""
    frames = synthetic_sequence(W, H, 5, seed=7)
    kw = dict(_bench_kw(), transform_8x8=True, rd=1)
    want = _run(JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                        key=KEY))), frames)
    assert reference_accel["fullpel"] >= 1 and reference_accel["tail"] >= 1
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.p_frames == 4
    assert tenc.stats.i8x8_mbs > 0 and tenc.stats.trans8_mbs > 0
    dec, jdec = decode_annexb(got), j_decode(got)
    assert len(dec) == len(jdec) == len(frames)
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
    assert "I8x8" in {m.mb_type for m in dec[0].mbs}
    sent = tenc._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    for rec in (extract_from_frames(dec, em_rate=EM_RATE),
                j_extract(got, em_rate=EM_RATE, key=KEY)):
        assert len(rec) == len(sent)
        for g, s in zip(rec, sent):
            np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("kw", [
    dict(_bench_kw(), cabac=True), dict(width=W, height=H),
    dict(_bench_kw(), cabac=True, trellis=1)],
    ids=["cabac", "defaults", "cabac_trellis"])
def test_accel_cabac_and_defaults_byte_equal_to_reference(reference_accel,
                                                          kw):
    """CABAC on the pipelined main path, also with trellis 1;
    Params(width, height, stego) at its defaults: byte-equal streams,
    equal close() dicts (PSNR exactly, SSIM to rtol 1e-5), the same
    frames and MV fields from both decoders, the payload recovered."""
    frames = synthetic_sequence(W, H, 4, seed=7)
    jenc = JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                   key=KEY)))
    want = _run(jenc, frames)
    # (the patched entries are traced once per process and static
    # configuration; this stream equals the port's tail_kernel=True one,
    # which differs from its CPU branch's, see the first test)
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert tenc.stats.p_frames == 3
    jd, td = jenc.close(), tenc.close()
    assert td.keys() == jd.keys()
    for k in jd:
        if k == "ssim_y":
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-5)
        elif k != "fps":
            assert td[k] == jd[k], k
    assert (td["psnr_y"] < 99) == kw.get("psnr", True)
    dec, jdec = decode_annexb(got), j_decode(got)
    assert len(dec) == len(jdec) == len(frames)
    for a, b in zip(dec, jdec):
        for pl in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(a, pl), getattr(b, pl))
        assert [m.unit_mvs for m in a.mbs] == [m.unit_mvs for m in b.mbs]
    sent = tenc._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    rec = extract_from_frames(dec, em_rate=EM_RATE)
    assert len(rec) == len(sent)
    for g, s in zip(rec, sent):
        np.testing.assert_array_equal(g, s)


def test_accel_multiref_cabac_byte_equal_to_reference(reference_accel,
                                                      monkeypatch):
    """BASELINE config 4's P half (tools/bench_c4.py's Params with
    bframes 0: ref_frames 2, CABAC) on the accelerator branch: the
    reference runs B1 through the patched Pallas entry once per DPB
    entry; the streams are byte-equal, the port chooses reference 1
    somewhere and the payload is recovered."""
    ref8s = []
    orig = T_PT.analyse_p_frame_parts_mref

    def analyse(*a, **k):
        out = orig(*a, **k)
        ref8s.append(out[2].numpy().copy())
        return out
    monkeypatch.setattr(T_PT, "analyse_p_frame_parts_mref", analyse)
    frames = synthetic_sequence(W, H, 4, seed=7)
    kw = dict(_bench_kw(), ref_frames=2, cabac=True)
    want = _run(JEncoder(Params(**kw, stego=StegoParams(em_rate=EM_RATE,
                                                        key=KEY))), frames)
    assert reference_accel["fullpel"] >= 2
    tenc = TEncoder(TP.Params(**kw, stego=TP.StegoParams(em_rate=EM_RATE,
                                                         key=KEY)),
                    device="cpu")
    got = _run(tenc, frames)
    assert got == want
    assert len(ref8s) == 3 and any((r == 1).any() for r in ref8s)
    dec = decode_annexb(got)
    assert len(dec) == len(frames)
    sent = tenc._stego.sent_messages
    assert sum(len(s) for s in sent) > 0
    rec = extract_from_frames(dec, em_rate=EM_RATE)
    assert len(rec) == len(sent)
    for g, s in zip(rec, sent):
        np.testing.assert_array_equal(g, s)
