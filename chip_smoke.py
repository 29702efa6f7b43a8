"""On-card smoke test of the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. card name + power limit; the nvcc kernel build (one nvcc per CUDA
     source, all started together) and the g++ build of the port's
     native library, in parallel, with their times;
  2. kernel B1 (full-pel partition search) against its plain version at
     1080p shapes, rng 16 with random and zero predictors, rng 7 and 20
     with random ones: array-equal, both timed at rng 16;
  3. kernel B5 (the whole deblock_frame call: edge parameters and
     filter, uint8 in and out, one launch) against edge_params + its
     plain version at 1080p with fuzzed intra/skip/nnz/mv maps at qp 26
     and 40, with fuzzed trans8, with slice offsets, at a qp at or below
     qp_thresh, and on a frame with more MB rows than the card holds
     CTAs at once: array-equal, timed, beside its byte/op bound and a
     latency bound (the knight chain's steps x a cross-SM handoff that
     a ping-pong kernel measures);
  4. the analyse tail (csrc/analyse_tail.cu: B3 -> B4 in one launch),
     B3 alone (subpel) with and without its mb_cost output, B4's check
     entry (probe maps) on chosen rows and on rows on every corner and
     edge of the +-3 box, all of which take the windows and build B2's
     qpel rows themselves, and B2's standalone entry (qpel tables),
     against their plain versions at 1080p shapes on a real frame pair
     run through the accelerator branch's B1 + partition decision, with
     random and zero predictors, decimate off, and jvt with the inter
     deadzone 16: array-equal, timed through the wrapper and alone,
     beside their bounds (bytes, the int8 tensor cores' rate for the
     transforms, the int32 rate for the rest) and the ALU-only bound;
  5. 112x80 six-frame encode on cuda and on cpu for both tail_kernel
     settings: byte-equal streams that the port's decoder decodes and
     the port's extractor reads;
  6. the main path at 1920x1088, bench.py's Params (tail_kernel=True, the
     reference's accelerator branch), five frames plus flush: payload
     recovered, B1, B9 and the fused tail (B3 -> B4) launched once per
     P frame, B3 alone and B4's check entry never, B5 once per frame,
     the fused luma encode once or twice per P frame (pass 1, and pass
     2 unless no MB changed), B2's entry and B8a/B8b never, fps
     printed;
  7. the tail_kernel=False path (B1 against the predictor prev_mv >> 2)
     at 1920x1088, IDR + 2 P frames plus flush: payload recovered, the
     same launch counts;
  8. per-stage times of a 1080p P frame on the tail_kernel=True path,
     the pass-1 encode and a full pass 2 in rows of their own;
  9. kernels B6 (16x16 full-pel search, rng 7, 20 and 16), B7 (MB
     window fetch), the fused luma encode (csrc/luma_p.cu: DCT+quant,
     decimation, dequant+IDCT+recon, cbp) and B8a/B8b (4x4 DCT+quant,
     dequant+IDCT, standalone check entries) against their plain
     versions at 1080p shapes on a real frame pair, the luma encodes at
     qp 26 and 20 and on the 13-version probe batch (the fused one also
     with force-zero and on an MB subset, and timed beside the earlier
     B8a -> decimation -> B8b chain on the same inputs), and the fused
     luma encode's levels-in entry (the trellis path's) on the trellis's
     levels of the same inputs at qp 26 and 20, also with force-zero:
     array-equal, timed, beside their bounds (the levels-in entry also
     beside the trellis that makes its levels);
 10. the 16x16-only path (partitions=False, deblock_device=False) at
     112x80, six frames on cuda and on cpu: byte-equal streams that the
     port's decoder decodes and the port's extractor reads;
 11. the 16x16-only path at 1920x1088, IDR + 2 P frames: payload
     recovered by the extractor, B6, B7 and B5 launched, the fused luma
     encode three times per P frame (pass 1, the 13-version probe, pass
     2), B8a/B8b never, fps printed;
 12. (only with --stages16) per-stage times of a 1080p P frame on the
     16x16-only path;
 13. kernel B9 (per-8x8 window fetch) against its plain version at 1080p
     on the main path's real MVs and on synthetic +-16 and +-20 MVs at
     the frame corners, and B10 (lowres frame costs on B1's kernel)
     against its plain version at the 960x544 lowres shape, rng 7, 20
     and 8 (timed): array-equal, timed, beside their bounds;
 14. BASELINE config 3 (transform_8x8 + rd 1, bench.py's other Params)
     at 128x96, six frames on cuda and on cpu: byte-equal streams with
     Intra_8x8 and 8x8-transform P MBs, decoded and read by the port's
     decoder and extractor;
 15. config 3 at 1280x720 (45x80 MBs), IDR + 4 P frames plus flush:
     payload recovered, B1, B9 and the fused tail every P frame, B5
     every frame, the fused luma encode once or twice per P frame, B2's
     entry and B8a/B8b never, I8x8 and trans8 MB counts, fps printed;
 16. (only with --stages8) per-stage times of a 720p config-3 P frame,
     the pass-1 encode in a row of its own;
 17. at 112x80, six frames on cuda and on cpu: CABAC on the main path,
     on config 3 and on the 16x16-only path, and the reference's
     default Params (PSNR and SSIM on, deblock_device=False: the fused
     P step unpipelined): byte-equal streams and equal close() dicts
     (PSNR exactly, SSIM to rtol 1e-5), payload recovered;
 18. the main path at 1920x1088 at the default Params plus SSIM, IDR + 3
     P: the stream is the first four frames of phase 6's, the payload
     phase 6's; PSNR/SSIM and fps printed, the same launch counts;
 19. the main path at 1920x1088 under CABAC, IDR + 2 P: payload
     recovered by the port's CABAC decoder and extractor (the decode
     timed), the same launch counts, the host CABAC write per P slice
     beside CAVLC's on the same syntax, fps printed;
 20. BASELINE config 4's P half (tools/bench_c4.py's Params with bframes
     0: ref_frames 2, CABAC) at 1920x1088, IDR + 2 P: payload recovered
     by the port's CABAC decoder and extractor, B1 launched twice per P
     frame (once per reference), B9 and the fused tail once, the luma
     encode twice (pass 1 and the full pass 2), B5 once per frame; P
     fps, bytes, IDR seconds and the share of 8x8 blocks on reference 1
     printed;
 21. (only with --stages4) per-stage times of a 1080p config-4 P-half P
     frame, pass 1 and pass 2 in rows of their own;
 22. BASELINE config 4 whole (tools/bench_c4.py's Params and clip:
     bframes 2, b_adapt 0, ref_frames 2, CABAC, spatial direct) at
     1920x1088, IDR + 6 frames + flush, two GOPs of P B B: every kernel
     call of the B frames (B1 against a zero predictor, B9 on the
     L0 stack with each 8x8's reference and on L1, B3' on the B
     windows, the fused luma encode on the bipred prediction) array-
     equal to its plain version on the card; each B frame launches B1
     ref_frames + 1 times, B9 twice, B3' twice, the fused luma encode
     once and no other kernel (B5 none: B slices are not deblocked);
     the payload recovered through the port's CABAC decoder, whose B
     frames equal the encoder's recon; P and B fps, the IDR's seconds
     and bytes per frame with its slice type printed;
 23. (only with --stagesB) per-stage times of phase 22's B frames
     (IDR + 6 frames + flush) and of phase 26's;
 24. the reference's default Params with bframes 2 (CAVLC, b_adapt 1,
     partitions, one reference, the host deblock's twin B5, PSNR on,
     me_range 16) at 1920x1088 on phase 22's clip, IDR + 6 frames +
     flush, stego em_rate 64 key 5: every kernel call of the B frames
     (B1 twice, B9 twice, B3' twice, the fused luma encode once)
     array-equal to its plain version on the card, no other kernel
     launched by a B frame; the payload recovered through the port's
     CAVLC B decoder, whose B frames equal the encoder's recon; launches
     per B frame, P and B fps, bytes by slice type, and the CAVLC B write
     per B frame beside phase 22's CABAC one printed;
 25. the 16x16-only path with B frames (partitions=False,
     deblock_device=False, bframes 2, b_adapt 2, rc_lookahead 4, CAVLC,
     one reference; the B slices through the native write_slice_b) on
     the same clip: every B6 and B7 call of the B frames (twice a B
     frame) and the fused luma encode array-equal to its plain version,
     no other kernel launched by a B frame, the payload recovered; the
     frames the placement DP coded as B printed, and the pixels where
     the decoded B frames differ from the encoder's recon (the
     reference's stale colocated field on this path, ROADMAP F2);
 26. config 4 with bframes 3, b_pyramid, weightb and direct auto
     (tools/bench_c4.py's Params and clip otherwise: CABAC, ref_frames
     2, b_adapt 0) at 1920x1088, IDR + 5 frames + flush, decode order I
     P4 Bref2 B1 B3 P5 (the middle B a reference picture, P5 with the
     L0 reordering op): every kernel call of the B frames, the reference
     B's included, array-equal to its plain version, each B frame
     launching B1 three times, B9 and B3' twice, the fused luma encode
     once and no other kernel; the payload recovered through the port's
     CABAC decoder, whose frames, the reference B among them, equal the
     encoder's recon; the reference B frames, the direct mode per B
     slice and the ms of the direct-auto score's extra dispatch
     printed;
 27. the same pyramid at temporal direct without weightb under CAVLC
     (direct 2, bframes 3, ref_frames 2) at 1920x1088, IDR + 4 frames +
     flush, decode order I P4 Bref2 B1 B3: every B slice temporal, so
     that B1 (L1[0] the reference B) reads the reference B's L0-only
     colocated field and B3 takes two valid unweighted L0 entries; the
     same kernel, launch, recon and payload checks as phase 26;
 29. tools/bench_c4.py's Params and clip at ref_frames 1 with
     transform_8x8, rd 1 and trellis 1 (x264's --8x8dct --subme 7
     --trellis 1 --bframes 2) at 1920x1088, IDR + 6 frames + flush, I P
     B B P B B: every kernel call of the B frames and every call of the
     fused luma encode in the P anchors (its levels-in entry, fed by the
     trellis) array-equal to its plain version; exact launches per frame
     type (each P anchor B1, B9, the fused tail, B5 once and the
     levels-in entry twice, each B frame B1 twice, B9 and B3' twice and
     the levels-in entry once); the decoded frames, anchors included, equal the
     encoder's recon and the payload is recovered (in a worker); P and B
     fps, the IDR's seconds, bytes by slice type, the I8x8 and trans8 MB
     counts (each must be above 0) and the trellis's ms per frame
     printed;
 30. the quantizer's options on the main path: bench.py's Params
     (pipelined, tail_kernel=True, CAVLC) with cqm jvt, deadzone_inter
     16, deadzone_intra 8 and noise_reduction 400 at 1920x1088, IDR + 3
     P on phase 6's clip: the SPS carries the jvt lists (High profile);
     every call of the fused luma encode (pass 1 and the full pass 2,
     both its noise-reduction instance) equal to its plain version on
     the CPU, sums included, reading the offsets of a host model of the
     reference's NR arithmetic; every fused tail call equal to its
     plain versions on the card; the encoder's NR state equal to the
     model's after each P frame; exact launches; the decoded frames
     equal the encoder's recon and the payload is recovered (in a
     worker); P fps, the IDR's seconds and bytes per frame beside phase
     6's printed.
 31. the main path's Params with aq_mode 1 at 1920x1088, IDR + 3 P (the
     unfused one-reference path): exact launches, the per-MB qp grids,
     decoded == recon and the payload (in a worker);
 32. BASELINE config 5: 8 concurrent 1920x1088 streams through
     MultiEncoder (tools/bench_streams.py's Params, tail_kernel=True,
     seeds 40 + s), IDR + 2 P steps: exact launches of each P step (B1,
     B9, the fused tail and B5 once a stream, the fused luma encode twice a
     stream), every stream's payload recovered and streams 0 and 7
     decoded == recon (in the workers); the IDR step's seconds and the
     aggregate and per-stream P fps printed;
 33. PipelinedMultiEncoder, 2 streams at 1920x1088, IDR + 3 P: payloads
     recovered (in the workers), the aggregate P fps beside phase 6's;
 34. models/pipeline.py and parallel/tile.py at 1920x1088: p_frame_step
     and p_frame_step_parts with their exact launches, and the tiled
     step over 4 tiles on cuda:0 equal to the untiled step, with 6 halo
     transfers of mc.PAD rows;
 35. the multi-stream and tile layers at 128x96 (the tiled step at
     96x192), cuda == cpu: MultiEncoder on both tail_kernel settings and
     PipelinedMultiEncoder (streams), p_frame_step, p_frame_step_parts
     and the tiled step on [cuda:0] * 4 (outputs);
 36. sub-8x8 partitions at full width: bench.py's Params with p4x4 at
     1920x1088 on bench.py's clip with a 256x256 patch in its middle
     whose 4x4 blocks move on their own (made with numpy from a seed),
     IDR + 3 P (the unfused sub path; the third P frame with a device
     sync around each stage, its stage times printed): exact
     launches per P frame (B1's sub-unit instance once, the fused luma
     encode for pass 1, the chosen offsets' probe, one probe batch per
     slot that holds a unit and pass 2, B5 once a frame, no other
     kernel), B5 on the second P frame's per-4x4 field array-equal to
     its plain twin (in a worker), the share of P_8x8 MBs, the
     sub_mb_type histogram and the internal 4x4 edges whose MVs differ,
     decoded == recon and the payload (in a worker); P fps and the IDR's
     seconds printed;
 37. sub-8x8 partitions at 128x96 on the same kind of clip, cuda == cpu
     (the cpu halves in the workers): CABAC with trellis 1, ref_frames 2
     (on the host deblock: the device deblock at more than one reference
     is refused there, ROADMAP F10), and transform_8x8 with aq_mode 1;
 38. the plain encoder (stego off) at full width: bench.py's Params with
     em_rate 0 (CAVLC, intra_in_p on) at 1920x1088 on bench.py's clip
     with an occlusion reveal in every P frame (`reveal_clip`), IDR + 2
     P at rd 0, then IDR + 1 P at rd 2: exact launches per P frame (rd
     0: B1, B9, B3's mb_cost instance (B3 alone), the fused luma
     encode and B5 once, the fused tail never; rd 2: B1 once, B9 and B3
     four times, the luma encode 5-11 times, B5 once, the fused tail
     never), intra MBs in every P frame,
     `refine_p_intra`'s CUDA-event ms and its share of the frame, P fps,
     decoded == recon and the same intra MBs in the decoder (in a
     worker);
 39. the plain encoder at 112x80 on the reveal clip, IDR + 2 frames,
     cuda == cpu (the cpu
     halves in the workers) for each served option set: CAVLC (both
     tail_kernel settings), CABAC, rd 1, rd 2 with trellis 2, CABAC and
     transform_8x8, ref_frames 2, aq_mode 1, the 16x16-only path,
     bframes 2 with intra_in_p off, and a 2-stream MultiEncoder at
     128x96;
 40. the plain encoder's sub-8x8 path at full width: bench.py's Params
     with p4x4, em_rate 0 and rd 1 (CAVLC, the intra compare on) at
     1920x1088 on `plain_sub_clip` (phase 36's moving 4x4 blocks with
     `reveal_clip`'s new content), IDR + 2 P: exact launches per P frame
     (B1's sub-unit instance once, the fused luma encode 9 times: the
     RD re-rank's seven probes and recomposed frame, then the final
     encode; B5 once; B3, B4 and B9 never), intra MBs, the P_8x8 share
     and the sub_mb_type histogram, `rd_rerank_sub`'s and
     `refine_p_intra`'s CUDA-event ms, P fps, decoded == recon with the
     same intra MBs (in a worker);
 41. intra MBs in B slices at full width: bench.py's Params with em_rate
     0, bframes 2 and b_adapt 0 (CAVLC, partitions) on `reveal_clip`, I
     B B P: per B frame exact launches (B1, B9 and B3 twice, the luma
     encode once, B4 and B5 never), the intra MBs, the direct MBs and the
     MBs the dependant rule kept inter, `_b_intra`'s CUDA-event ms and B
     fps; decoded == recon on every frame (in a worker);
 42. stego off at 112x80 over 5 frames, cuda == cpu (the cpu halves in
     the workers): p4x4 at rd 0, rd 1, rd 2 with trellis 2, CABAC and
     transform_8x8, ref_frames 2 on the host deblock and aq_mode 1; intra
     in B on the partition path under CAVLC and CABAC, the 16x16 path,
     temporal direct, b_pyramid, ref_frames 2, transform_8x8 and p4x4
     anchors; intra MBs decoded wherever the intra compare runs.
Phase 2 also holds B1's sub-unit instance (`pcamv_fullpel_sub`, the
sub-8x8 analysis' search) against its plain version at 1080p shapes, rng
16 with random and zero predictors, rng 20 and 7 with random ones,
timed at rng 16.
Phase 4's B3 mb_cost instance is the plain encoder's per-MB inter
cost; B4's check entry is also timed under the jvt inter list and
deadzone 16, beside the flat tables; phase 9 the fused luma encode's
noise-reduction instance (qp 26 and 20, with force-zero, timed beside
the plain DCT entry through the wrapper and alone) and a wrap case (qp
0 under jvt, residuals up to +-40000: the quant product leaves int32),
and phase 17
cqm jvt with the incremental re-encode, cqm jvt with transform_8x8, rd
1, trellis 1 and CABAC, noise_reduction at ref_frames 2, and
noise_reduction with B frames and the deadzones 16/8.
Phase 3 also holds B5 on a plain P frame whose intra MBs lie in three
patches (trans8 on the inter MBs), on a plain sub-8x8 P frame (per-4x4
motion, intra patches, trans8 on the inter MBs without a split), with a
fuzzed per-4x4 reference map
(ref4), and
on per-4x4 motion fields that move inside 8x8 blocks (the sub-8x8
path's), once with trans8 on the MBs without a sub split and once with
a per-8x8 reference map, phase
13 B9 on a stack of two references with a per-8x8 reference (ref8), and
phase 17 the multi-reference streams at 112x80 (ref_frames 2 under
CAVLC and CABAC, 3 with keyint_max 3 on the CPU branch, partitions
off) and the B streams (config 4, bframes 1 at one reference, CAVLC B
at one reference (the default Params with bframes 2, b_adapt 1) and at
two, b_adapt 2, the 16x16 path's B frames under CABAC at one reference,
the native writer, and two, the Python one; b_pyramid with weightb and
direct auto at two references, temporal direct with weightb under
CAVLC, direct none, and the 16x16 path's pyramid with temporal direct
at two references), and trellis: ref_frames 2 with transform_8x8, rd 1
and trellis 1, b_pyramid with weightb and trellis, the 16x16 path with
transform_8x8 and trellis, the main path with trellis 1 and with rd
2).
Phases 9 and 13 run right after phase 4, so that a new kernel that fails
stops the run early. Phases 29, 32 and 17 (the trellis IDR's minutes
of host-bound eager work, eight 1080p IDRs in a row, and 17's 24 small
cases) and 41 then run in a second process of this script on the same
card (`--side`, its own two workers), beside the rest, and "29, 32, 17
and 41" near the end joins it and logs its lines; 35, 33 and 34 run
right after 6 (so that their decode checks start early), then 18, 19,
20, 22, 24 and 25, and 26, 27, 30, 31, 36-40 and 42 after 25.
The decode checks of the full-width phases (6, 7, 11, 15, 19, 20, 22,
24-27, 30, 31, 33, 36, 38, 40: the port's CPU decoder, seconds a 1080p
frame, and its extractor) run in four spawned worker processes while
the later phases use the card; phase 28 waits for them, prints each
one's result and fails if any failed. The same workers run the cpu
halves of phases 5, 14, 35, 37, 39 and 42 (submitted early) while the
main process runs their cuda halves, the payload checks of these phases
and of phase 10, phase 3's plain twins of its 1080p cases but the first
and phase 36's plain B5 twin. The second process's two workers do the same for phases
29, 32, 17 and 41.
Each phase logs its wall time. The line before the last two holds the
per-kernel JSON record, then the card line; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab PARENT_ROOT

instead compares two checkouts on one card: kernels B1, B9 and B10
(phases 2 and 13), each checkout's 1080p luma encode (the main path's
and the 16x16 path's probe batch), the main path's 1080p encode (phase
6 without the payload check) and its stage times (phase 8), run in a
fresh process from PARENT_ROOT, this checkout, this checkout and
PARENT_ROOT again, each with that checkout's chip_smoke.py and
package.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

MBH, MBW = 68, 120          # 1920x1088
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 rate


def log(msg):
    print(msg, flush=True)


def card_query(fields: str) -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=" + fields,
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def int32_ops_per_s() -> float:
    """Peak 32-bit integer rate: 132 SMs x 64 INT32 lanes x the SM clock
    (the maximum that nvidia-smi reports)."""
    mhz = float(card_query("clocks.max.sm").split()[0])
    return 132 * 64 * mhz * 1e6


def bound(nbytes: float, ops: float, ops_rate: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    integer operations over the int32 rate."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over reps, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def record(name, source, replaces, err, ms, plain_ms, bnd, library_ms=None):
    return {"name": name, "route": "cuda",
            "source": "video_steganography_pcamv_torch/csrc/" + source,
            "replaces": "video_steganography_pcamv_tpu/" + replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}


def phase_build():
    from video_steganography_pcamv_torch import kernels, native
    t0 = time.time()
    errs = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # re-raised below
            errs.append(e)

    th = threading.Thread(target=run, args=(native.build,))
    th.start()
    run(kernels.load)
    th.join()
    if errs:
        raise errs[0]
    native.load()
    log("kernels built/loaded in %.1f s (nvcc %.1f s) -> %s; native g++ "
        "%.1f s" % (time.time() - t0, kernels.build_seconds or 0.0,
                    os.path.relpath(kernels.lib_path()),
                    native.build_seconds or 0.0))


# 4-way SIMD instructions per four absolute differences, summed, in the
# full-pel search's hot loop, as its SASS shows them (csrc/fullpel.cu's
# header): one VABSDIFF4 with accumulate
SAD_OPS_PER_4 = 1


def search_ops(n: int, rng: int) -> int:
    """The least work of an exhaustive +-rng search of n 16x16 blocks:
    256 absolute differences per block and displacement, taken and
    summed four at a time."""
    return n * (2 * rng + 1) ** 2 * 64 * SAD_OPS_PER_4


def phase_b1(dev, int_rate):
    """B1 at 1080p shapes: rng 16 (the main path's) with random and zero
    predictors, rng 7 and 20 (not multiples of 4; 20 is the largest the
    encoder admits) with random predictors; timed at rng 16, zero
    predictor (the main path's accelerator branch)."""
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    rs = np.random.RandomState(11)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    ref = mc.pad_plane(torch.as_tensor(fr[0].y.astype(np.uint8),
                                       device=dev))
    lam = 4
    worst = 0
    cases = [("random", 16, rs.randint(-12, 13, (MBH, MBW, 2))),
             ("random", 7, rs.randint(-12, 13, (MBH, MBW, 2))),
             ("random", 20, rs.randint(-24, 25, (MBH, MBW, 2))),
             ("zero", 16, np.zeros((MBH, MBW, 2)))]
    for name, rng, pr in cases:
        pred = torch.as_tensor(pr.astype(np.int32), device=dev)
        got = FP.fullpel_parts(cur, ref, pred, rng, MBH, MBW, lam)
        want = FP.fullpel_search_parts(cur, ref, pred, rng, MBH, MBW, lam)
        torch.cuda.synchronize()
        err = max_abs([got[k] for k in want], want.values())
        if err != 0 or any(not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("B1 kernel != plain (%s predictor, rng %d),"
                                 " max abs err %d" % (name, rng, err))
        worst = max(worst, err)
        log("B1 %s predictor: kernel == plain at %dx%d MBs, rng %d"
            % (name, MBH, MBW, rng))
    rng = 16
    ms = cuda_ms(lambda: FP.fullpel_parts(cur, ref, pred, rng, MBH, MBW,
                                          lam), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: FP.fullpel_search_parts(
        cur, ref, pred, rng, MBH, MBW, lam), reps=3)
    # bytes: cur (int32) and the padded uint8 reference plane read once,
    # the predictor read; 9 (cost, index) pairs written per MB. ops:
    # search_ops
    n = MBH * MBW
    nbytes = cur.numel() * 4 + ref.numel() + (2 * n + 18 * n) * 4
    bnd = bound(nbytes, search_ops(n, rng), int_rate)
    log("B1 time: kernel %.4f ms, plain %.3f ms, bound %.4f ms (%s) "
        "(median, 1080p, rng 16)" % (ms, plain_ms, *bnd))
    return record("fullpel_parts", "fullpel.cu",
                  "ops/pallas_kernels.py:435", worst, ms, plain_ms, bnd)


# per MB and displacement beyond the SAD work: each of the 41 units'
# cost, formed from the sixteen 4x4 sums and the MV cost, and its
# running minimum
SUB_UNIT_OPS = 41 * 2


def phase_b1_sub(dev, int_rate):
    """B1's sub-unit instance at 1080p shapes against its plain version:
    rng 16 with random and zero predictors, rng 20 and 7 with random
    ones; timed at rng 16 (the sub path's predictor is prev_mv >> 2, so
    a random one)."""
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    y0, y1 = sub_motion_clip(16 * MBW, 16 * MBH, 2, seed=3)
    cur = torch.as_tensor(y1.y.astype(np.int32), device=dev)
    ref = mc.pad_plane(torch.as_tensor(y0.y, device=dev))
    rs = np.random.RandomState(12)
    lam = 4
    cases = [("random", 16, rs.randint(-12, 13, (MBH, MBW, 2))),
             ("zero", 16, np.zeros((MBH, MBW, 2))),
             ("random", 20, rs.randint(-24, 25, (MBH, MBW, 2))),
             ("random", 7, rs.randint(-12, 13, (MBH, MBW, 2)))]
    for name, rng, pr in cases:
        pred = torch.as_tensor(pr.astype(np.int32), device=dev)
        got = FP.fullpel_sub(cur, ref, pred, rng, MBH, MBW, lam)
        want = FP.fullpel_search_sub(cur, ref, pred, rng, MBH, MBW, lam)
        torch.cuda.synchronize()
        if sorted(got) != sorted(want) or any(
                not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("B1 sub-unit instance != plain (%s "
                                 "predictor, rng %d), max abs err %d"
                                 % (name, rng, max_abs(
                                     [got[k] for k in want], want.values())))
        log("B1 sub-unit instance, %s predictor: kernel == plain at %dx%d "
            "MBs, rng %d (41 units)" % (name, MBH, MBW, rng))
    pred = torch.as_tensor(cases[0][2].astype(np.int32), device=dev)
    rng = 16
    ms = cuda_ms(lambda: FP.fullpel_sub(cur, ref, pred, rng, MBH, MBW, lam),
                 reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: FP.fullpel_search_sub(
        cur, ref, pred, rng, MBH, MBW, lam), reps=3)
    b1_ms = cuda_ms(lambda: FP.fullpel_parts(cur, ref, pred, rng, MBH, MBW,
                                             lam), reps=20, warmup=3)
    # bytes: cur (int32) and the padded uint8 plane read once, the
    # predictor read, 41 (cost, index) pairs written per MB. ops: the SAD
    # work of search_ops plus SUB_UNIT_OPS per MB and displacement
    n = MBH * MBW
    nbytes = cur.numel() * 4 + ref.numel() + (2 * n + 82 * n) * 4
    ops = search_ops(n, rng) + n * (2 * rng + 1) ** 2 * SUB_UNIT_OPS
    bnd = bound(nbytes, ops, int_rate)
    log("B1 sub-unit instance time: kernel %.4f ms, plain %.3f ms, bound "
        "%.4f ms (%s); B1 (9 units) on the same inputs %.4f ms (median, "
        "1080p, rng 16)" % (ms, plain_ms, *bnd, b1_ms))
    rec = record("fullpel_sub", "fullpel.cu", "encoder/partition.py:896",
                 0, ms, plain_ms, bnd)
    rec["b1_same_inputs_ms"] = b1_ms
    return rec


def sub_motion_clip(w, h, n, seed):
    """n frames whose 4x4 blocks move on their own (the moves cycle with
    the block and the frame, the odd frames 10 brighter), over a smoothed
    random texture with chroma noise: sub-8x8 splits win there; in the
    right third each MB moves as a whole."""
    from video_steganography_pcamv_torch.utils.yuv import Frame
    rs = np.random.RandomState(seed)
    big = rs.randint(30, 226, (h + 32, w + 32)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    moves = np.array([(0, 1), (1, -1), (-1, 0), (2, 1), (0, -2), (-1, 2)])
    jj, ii = np.meshgrid(np.arange(h // 4), np.arange(w // 4),
                         indexing="ij")
    r4 = np.arange(4)
    frames = []
    for k in range(n):
        blk = np.where(ii >= w // 6, (jj // 4) * w + ii // 4,
                       jj * (w // 4) + ii)
        mv = moves[(blk + k) % len(moves)]
        ys = (16 + 4 * jj + mv[..., 0])[:, :, None, None] + r4[:, None]
        xs = (16 + 4 * ii + mv[..., 1])[:, :, None, None] + r4[None, :]
        y = big[ys, xs].transpose(0, 2, 1, 3).reshape(h, w)
        y = np.clip(y + 10 * (k % 2), 0, 255).astype(np.uint8)
        frames.append(Frame(y, rs.randint(100, 156, (h // 2, w // 2))
                            .astype(np.uint8),
                            rs.randint(100, 156, (h // 2, w // 2))
                            .astype(np.uint8)))
    return frames


def sub_patch_clip(w, h, n, seed, size=256):
    """bench.py's clip (synthetic_sequence, seed 7) with a size x size
    luma patch of `sub_motion_clip` in its middle (MB-aligned): sub-8x8
    splits win there, while the frame's cover stays within what the STC
    embeds 64 bits into (at most 2^(h-2) = 256 cover MVs a payload bit;
    a frame split everywhere has ~15 a MB, and its frames then carry no
    message, as in the reference)."""
    from video_steganography_pcamv_torch.utils.yuv import (Frame,
                                                           synthetic_sequence)
    y0, x0 = (h // 2 - size // 2) // 16 * 16, (w // 2 - size // 2) // 16 * 16
    out = []
    for f, p in zip(synthetic_sequence(w, h, n, seed=7),
                    sub_motion_clip(size, size, n, seed)):
        y = f.y.copy()
        y[y0:y0 + size, x0:x0 + size] = p.y
        out.append(Frame(y, f.u, f.v))
    return out


def _deblock_case(dev, g, mbh, mbw, trans8: bool, ref4: bool = False,
                  sub: bool = False, patches: bool = False):
    """Planes with MB-level steps and noise, fuzzed intra/skip/nnz/mv
    maps (mv constant over 8x8 blocks) and, optionally, trans8 and a
    per-8x8 reference map ref4 (then a quarter of the 8x8 blocks keep
    one MV and no residual, so that their edges differ only in the
    reference). `sub`: half of the MBs are split below 8x8, their MVs
    move per 4x4 by -5..5 quarter pels around their 8x8's (so that the
    MV steps of edges inside an 8x8 straddle the bS threshold of 4),
    and trans8 falls only on the MBs without a split. `patches`: a P
    frame of the plain encoder, its intra MBs in three rectangles of
    new content (the rest inter, a fifth skipped), trans8 only on inter
    MBs."""
    H, W = 16 * mbh, 16 * mbw
    base = g.integers(60, 180, (mbh, mbw))
    y = np.clip(np.repeat(np.repeat(base, 16, 0), 16, 1)
                + g.integers(-24, 25, (H, W)), 0, 255)
    u = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    v = np.clip(128 + g.integers(-24, 25, (H // 2, W // 2)), 0, 255)
    intra = (g.random((mbh, mbw)) < 0.15).astype(np.int32)
    if patches:
        intra[:] = 0
        for _ in range(3):
            y0, x0 = g.integers(0, mbh - 12), g.integers(0, mbw - 20)
            intra[y0:y0 + 12, x0:x0 + 20] = 1
    skip = ((g.random((mbh, mbw)) < 0.2) & (intra == 0)).astype(np.int32)
    nnz4 = (g.random((4 * mbh, 4 * mbw)) < 0.5).astype(np.int32)
    mv4 = g.integers(-20, 21, (4 * mbh, 4 * mbw, 2)).astype(np.int32)
    mv4 = np.repeat(np.repeat(mv4[::2, ::2], 2, 0), 2, 1)
    t8 = (g.random((mbh, mbw)) < 0.5).astype(np.int32) if trans8 else None
    r4 = None
    if ref4:
        r8 = g.integers(0, 2, (2 * mbh, 2 * mbw))
        r4 = np.repeat(np.repeat(r8, 2, 0), 2, 1).astype(np.int32)
        calm = np.repeat(np.repeat(g.random((2 * mbh, 2 * mbw)) < 0.25, 2,
                                   0), 2, 1)
        nnz4[calm] = 0
        mv4[calm] = 5
    if sub:
        split = g.random((mbh, mbw)) < 0.5
        split4 = np.repeat(np.repeat(split, 4, 0), 4, 1)
        mv4 = (mv4 + np.where(split4[..., None],
                              g.integers(-5, 6, mv4.shape), 0)) \
            .astype(np.int32)
        if t8 is not None:
            t8[split] = 0
    if patches and t8 is not None:
        t8[intra == 1] = 0
    planes = [torch.as_tensor(a.astype(np.uint8), device=dev)
              for a in (y, u, v)]
    maps = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (intra, skip, nnz4, mv4)]
    return planes, maps, (None if t8 is None
                          else torch.as_tensor(t8, device=dev)), (
        None if r4 is None else torch.as_tensor(r4, device=dev))


def handoff_ms(dev, rounds: int = 20000) -> float:
    """One cross-SM handoff of the deblocker's progress counters (fence +
    release store, acquire spin), from a two-CTA ping-pong on two SMs."""
    from video_steganography_pcamv_torch import kernels
    flag = torch.zeros((1,), dtype=torch.int32, device=dev)
    fn = kernels.entry("pcamv_handoff_pingpong",
                       [kernels.VP, kernels.CI, kernels.VP])

    def run():
        kernels.check(fn(kernels.ptr(flag), rounds, kernels.stream(flag)),
                      "pcamv_handoff_pingpong")
    ms = cuda_ms(run, 3, warmup=1)
    if int(flag.item()) != 2 * rounds:
        raise AssertionError("ping-pong ended at %d, want %d"
                             % (int(flag.item()), 2 * rounds))
    return ms / (2 * rounds)


def phase_b5(dev, int_rate):
    """B5, the whole deblock_frame call (edge parameters + filter, uint8
    in and out) in one launch, against edge_params + the plain wave
    filter: qp 26 and 40, fuzzed trans8, slice offsets, a qp at or
    below qp_thresh (internal edges off) and a frame with more MB rows
    than the card holds CTAs at once; and with a fuzzed per-4x4
    reference map (the multi-reference path), timed too."""
    from video_steganography_pcamv_torch.ops import deblock as DB
    from video_steganography_pcamv_torch.ops.transform import chroma_qp
    # name, MB rows and columns, qp, off_a, off_b, trans8 (, ref4, sub)
    cases = [("qp 26", MBH, MBW, 26, 0, 0, False),
             ("qp 40", MBH, MBW, 40, 0, 0, False),
             ("qp 30, trans8 fuzzed", MBH, MBW, 30, 0, 0, True),
             ("qp 33, off_a +6, off_b -4, trans8", MBH, MBW, 33, 6, -4,
              True),
             ("qp 14 <= qp_thresh 15", MBH, MBW, 14, 0, 0, False),
             ("qp 26, ref4 fuzzed", MBH, MBW, 26, 0, 0, False, True),
             ("qp 26, per-4x4 mv, trans8 on the MBs without a split", MBH,
              MBW, 26, 0, 0, True, False, True),
             ("qp 30, per-4x4 mv, ref4 fuzzed", MBH, MBW, 30, 0, 0, False,
              True, True),
             ("qp 26, a plain P frame with intra MBs in patches, trans8 on "
              "the inter MBs", MBH, MBW, 26, 0, 0, True, False, False,
              True),
             ("qp 28, a plain sub-8x8 P frame: per-4x4 mv, intra MBs in "
              "patches, trans8 on the inter MBs without a split", MBH, MBW,
              28, 0, 0, True, False, True, True)]
    wide = 1024
    resident = DB.resident_ctas(wide)
    cases.append(("%d MB rows > %d resident CTAs (%dx%d)"
                  % (resident + 32, resident, 16 * wide,
                     16 * (resident + 32)), resident + 32, wide, 28, 0, 0,
                  True))
    errs = [0]     # the largest error of every case, here and deferred
    ms = plain_ms = ref4_ms = None
    for i, (name, mbh, mbw, qp, off_a, off_b, t8, *extra) in enumerate(
            cases):
        g = np.random.default_rng(100 + i)
        planes, maps, trans8, ref4 = _deblock_case(dev, g, mbh, mbw, t8,
                                                   *extra)
        qpc = chroma_qp(qp)
        kw = dict(qp_thresh=15 - min(off_a, off_b), off_a=off_a,
                  off_b=off_b, trans8=trans8, ref4=ref4)
        got = DB.deblock_frame(*planes, *maps, qp, qpc, mbh, mbw, **kw)

        def plain():
            par = DB.edge_params(*maps, qp, qpc, mbh, mbw, **kw)
            return DB.deblock_frame_plain(*planes, par, mbh, mbw)

        def check(want, name=name, got=got, planes=planes, mbh=mbh, mbw=mbw):
            got = [a.cpu() for a in got]
            want = [torch.as_tensor(a).cpu() for a in want]
            err = max_abs(got, want)
            errs[0] = max(errs[0], err)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("B5 kernel != plain (%s), max abs err "
                                     "%d" % (name, err))
            changed = sum(int((a != b.cpu()).sum())
                          for a, b in zip(got, planes))
            log("B5 %s: kernel == plain at %dx%d MBs (%d samples filtered)"
                % (name, mbh, mbw, changed))
        if 0 < i < len(cases) - 1:
            # the plain twin of a 1080p case on the cpu of a worker
            # process meanwhile; phase 28 compares
            cpu = [t if t is None else t.cpu() for t in
                   (*planes, *maps, trans8, ref4)]
            _DEFERRED.append((_submit(_b5_plain_job, cpu, qp, qpc, mbh, mbw,
                                      {k: v for k, v in kw.items()
                                       if k not in ("trans8", "ref4")}),
                              check))
        elif i > 0:
            check(plain())
        else:
            # the plain wave loop takes seconds a call: one timed call,
            # whose output is the twin
            want = []
            plain_ms = cuda_ms(lambda: want.append(plain()), 1, warmup=0)
            check(want[0])
            ms = cuda_ms(lambda: DB.deblock_frame(
                *planes, *maps, qp, qpc, mbh, mbw, **kw), 20, 3)
            log("B5 qp 26 time, the whole call (edge parameters + filter, "
                "uint8 in and out, one launch): kernel %.4f ms, plain "
                "%.3f ms (median, 1080p)" % (ms, plain_ms))
        if ref4 is not None:
            if ref4_ms is None:
                ref4_ms = cuda_ms(lambda: DB.deblock_frame(
                    *planes, *maps, qp, qpc, mbh, mbw, **kw), 20, 3)
            flat = DB.deblock_frame(*planes, *maps, qp, qpc, mbh, mbw,
                                    **dict(kw, ref4=None))
            moved = int((flat[0] != got[0]).sum())
            if moved == 0:
                raise AssertionError("B5 with ref4: no sample depends on "
                                     "the reference map")
            log("B5 with ref4 (%s) time: kernel %.4f ms (median, 1080p, "
                "the first such case); %d luma samples differ from the same "
                "call without ref4" % (name, ref4_ms, moved))
    # bytes: the three uint8 planes read and written once; the per-MB
    # intra/skip/trans8 and the per-4x4 nnz and mv maps (int32) and the
    # 456-entry table read once. ops: the edge parameters, ~40 int ops
    # for each of 32 lanes per MB, and the filter, 8 luma edges x 16
    # lines and 2 x 4 chroma edges x 8 lines, ~30 int ops a line
    n = MBH * MBW
    pix = 256 * n * 3 // 2
    nbytes = 2 * pix + n * 4 * 3 + 16 * n * 4 * 3 + 456 * 4
    ops = n * (32 * 40 + (8 * 16 + 2 * 4 * 8) * 30)
    bnd = bound(nbytes, ops, int_rate)
    maps_t = _b5_qp_maps(dev, int_rate, nbytes, ops)
    # the cases whose twins run in the workers are held in phase 28; a
    # mismatch there fails the run before the record is printed
    worst = max(errs[0], maps_t["err"])
    # latency: the reference's knight-wave chain, mbw + 2(mbh-1) MB steps
    # (254 at 1080p), each priced at one cross-SM handoff of a progress
    # counter. The kernel's half-MB order has mbh-1 handoffs on its
    # chain, the rest are MB filter passes on one warp.
    steps = MBW + 2 * (MBH - 1)
    hop = handoff_ms(dev)
    log("B5 bound %.4f ms (%s); latency bound %d steps x %.5f ms handoff "
        "= %.4f ms" % (*bnd, steps, hop, steps * hop))
    rec = record("deblock_frame", "deblock.cu", "ops/deblock_pallas.py:469",
                 worst, ms, plain_ms, bnd)
    rec.update(latency_bound_ms=steps * hop, handoff_ms=hop,
               latency_steps=steps, ref4_ms=ref4_ms,
               qp_maps_ms=maps_t["ms"], qp_maps_alone_ms=maps_t["alone_ms"],
               qp_maps_plain_ms=maps_t["plain_ms"],
               qp_maps_bound_ms=maps_t["bound"][0],
               scalar_alone_ms=maps_t["scalar_alone_ms"])
    return rec


def _b5_plain_job(t, qp, qpc, mbh, mbw, kw):
    """B5's plain version (edge_params + the wave filter) on the cpu, in
    a worker: t = the three uint8 planes, intra, skip, nnz4, mv4, trans8
    and ref4 (None or tensors)."""
    from video_steganography_pcamv_torch.ops import deblock as DB
    par = DB.edge_params(*t[3:7], qp, qpc, mbh, mbw, trans8=t[7], ref4=t[8],
                         **kw)
    return [a.numpy() for a in DB.deblock_frame_plain(*t[:3], par, mbh, mbw)]


def _deblock_entry_ms(planes, maps, qp, qpc, mbh, mbw, trans8=None,
                      launches=20, reps=5) -> float:
    """Device ms a call of B5's C entry alone (the three plane copies,
    the counters' reset and the launch), outputs and arguments made
    once, without the wrapper's checks: CUDA events around `launches`
    back-to-back calls, the median of `reps`; qp/qpc ints or int32 maps."""
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.ops import deblock as DB
    dev = planes[0].device
    out = [torch.empty_like(t) for t in planes]
    sync = torch.empty((2 * mbh + 1,), dtype=torch.int32, device=dev)
    tabs = torch.as_tensor(DB._TABS, device=dev)
    use_maps = isinstance(qp, torch.Tensor)
    ptr = kernels.ptr
    fn = kernels.entry("pcamv_deblock_frame",
                       [kernels.VP] * 15 + [kernels.CI] * 7 + [kernels.VP] * 2)
    args = (*(ptr(t) for t in list(planes) + out), ptr(maps[0]),
            ptr(maps[1]), None if trans8 is None else ptr(trans8),
            ptr(maps[2]), ptr(maps[3]), None,
            ptr(qp) if use_maps else None, ptr(qpc) if use_maps else None,
            ptr(tabs), 0 if use_maps else qp, 0 if use_maps else qpc, 15, 0,
            0, mbh, mbw, ptr(sync), kernels.stream(sync))

    def run():
        kernels.check(fn(*args), "pcamv_deblock_frame")
    run()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def _b5_qp_maps(dev, int_rate, nbytes, ops):
    """B5 under per-MB qp maps (adaptive quantization's decoder-visible
    chain) at 1080p: random luma qps 10-51 and their chroma qps, trans8
    fuzzed, against edge_params + the plain filter; the samples that
    differ from the same call at the constant qp 26; timed through the
    wrapper and the C entry alone beside the scalar call's entry, with
    the bound of the scalar call plus the two int32 maps."""
    from video_steganography_pcamv_torch.ops import deblock as DB
    from video_steganography_pcamv_torch.ops.transform import (
        CHROMA_QP_TABLE)
    g = np.random.default_rng(131)
    planes, maps, trans8, _ = _deblock_case(dev, g, MBH, MBW, True)
    q = g.integers(10, 52, (MBH, MBW)).astype(np.int32)
    qmap = torch.as_tensor(q, device=dev)
    cmap = torch.as_tensor(CHROMA_QP_TABLE[q].astype(np.int32), device=dev)
    kw = dict(qp_thresh=15, trans8=trans8)
    n_maps = DB.deblock_frame.map_launches
    got = DB.deblock_frame(*planes, *maps, qmap, cmap, MBH, MBW, **kw)
    if DB.deblock_frame.map_launches != n_maps + 1:
        raise AssertionError("B5 with qp maps: map_launches not counted")

    def plain():
        par = DB.edge_params(*maps, qmap, cmap, MBH, MBW, **kw)
        return DB.deblock_frame_plain(*planes, par, MBH, MBW)
    want = plain()
    torch.cuda.synchronize()
    err = max_abs(got, want)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("B5 kernel != plain under qp maps, max abs "
                             "err %d" % err)
    flat = DB.deblock_frame(*planes, *maps, 26, 26, MBH, MBW, **kw)
    moved = sum(int((a != b).sum()) for a, b in zip(got, flat))
    if moved == 0:
        raise AssertionError("B5 with qp maps: no sample depends on them")
    out = {"err": err}
    out["ms"] = cuda_ms(lambda: DB.deblock_frame(*planes, *maps, qmap, cmap,
                                                 MBH, MBW, **kw), 20, 3)
    out["plain_ms"] = cuda_ms(plain, 1, warmup=0)
    out["alone_ms"] = _deblock_entry_ms(planes, maps, qmap, cmap, MBH, MBW,
                                        trans8)
    out["scalar_alone_ms"] = _deblock_entry_ms(planes, maps, 26, 26, MBH,
                                               MBW, trans8)
    out["bound"] = bound(nbytes + 2 * 4 * MBH * MBW, ops, int_rate)
    log("B5 qp maps (luma qp 10-51, trans8 fuzzed): kernel == plain at "
        "%dx%d MBs, %d samples differ from the qp-26 call; through the "
        "wrapper %.4f ms, C entry alone %.4f ms (the scalar call's entry "
        "%.4f ms), plain %.3f ms, bound %.4f ms (%s) (median, 1080p)"
        % (MBH, MBW, moved, out["ms"], out["alone_ms"],
           out["scalar_alone_ms"], out["plain_ms"], *out["bound"]))
    return out


def _tail_inputs(dev):
    """A real 1080p frame pair through the accelerator branch's head:
    B1 with a zero predictor, the partition decision, the windows."""
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder.me import lambda_tab
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    qp = 26
    lam = lambda_tab(qp)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32),
                                       device=dev), c, c)
    zero = torch.zeros((MBH, MBW, 2), dtype=torch.int32, device=dev)
    ref8 = ref["luma"].to(torch.uint8)
    st = FP.fullpel_parts(cur, ref8[0], zero, 16, MBH, MBW, lam)
    part, mvfp8 = PT.decide_partition(st, MBH, MBW, lam)
    mvfp8 = mvfp8.contiguous()
    windows = PT.gather_windows8(ref8, mvfp8, MBH, MBW)
    prev_mv = torch.as_tensor(np.random.RandomState(4).randint(
        -40, 41, (MBH, MBW, 2)).astype(np.int32), device=dev)
    return cur, windows, part, mvfp8, prev_mv, lam, qp


def _alone_ms(name, argtypes, args, launches: int = 20,
              reps: int = 5) -> float:
    """Device ms a launch of a C entry alone: `launches` back-to-back
    launches between two CUDA events, the median of `reps`."""
    from video_steganography_pcamv_torch import kernels
    fn = kernels.entry(name, argtypes)

    def run():
        for _ in range(launches):
            kernels.check(fn(*args), name)
    return cuda_ms(run, reps) / launches


# H100 SXM dense int8 tensor-core rate (NVIDIA's data sheet)
TENSOR_INT8_OPS_PER_S = 1.979e15
# The analyse tail's work, counted from what it computes: a transform of
# a difference x - y (each SATD; the probe's residual cur - pred) one
# product [x | y] x [M; -M], 2 x 256 multiply-adds of 2 ops each, so the
# subtraction is tensor work; a qpel row's 16 averages of 3 ops; a SATD's
# 16 x (abs, add) on the ALU; a probe item's quant 80, decimate 80,
# dequant + IDCT 144, recon 64.
_MAP, _ROW, _SATD, _CHAIN = 2 * 2 * 256, 16 * 3, 16 * 2, 80 + 80 + 144 + 64
# and as the ALU-only bound counts it (the butterfly kernels): a row built
# and transformed with butterflies (16 x 3 + 8 x 8), the probe chain with
# the recon's WHT and 9 SATDs of 48 a version (B4), a SATD 64 x 3 an 8x8
_BUILD_OLD = 16 * 3 + 8 * 8


def tail_bounds(n8: int, n: int, int_rate: float, search: bool,
                probe: bool, mb_cost: bool = False):
    """(bound, ALU-only bound) of B3 (`search`), B4 (`probe`) or the
    fused tail (both) on n8 8x8 blocks: each (ms, by). The bound is the
    largest of the bytes over the HBM rate (the windows read once), the
    transforms' operations over the int8 tensor-core rate and the other
    integer operations over the int32 rate; the ALU-only bound counts
    every operation at the int32 rate, as before the transforms moved to
    the tensor cores."""
    nbytes = n8 * (1024 + 64 * 4)
    tensor = alu = old = 0
    if search:
        nbytes += n8 * (8 + 12) + n * (12 + 4 * mb_cost)
        tensor += n8 * 49 * 4 * _MAP
        alu += n8 * 49 * 4 * (_ROW + _SATD) + n * 8 * mb_cost
        old += n8 * 49 * (4 * _BUILD_OLD + 64 * 3) + n * 8 * mb_cost
    if probe:
        from video_steganography_pcamv_torch.ops import probe as PR
        nbytes += n8 * (2 * 117 + 13) * 4 + n8 * 4 * (not search)
        sp_pairs = {frozenset(((cy, cx), (cy + ny, cx + nx)))
                    for cy, cx in PR._CENTERS for ny, nx in PR._NB
                    if (ny, nx) != (0, 0)}
        # the 13 residual DCTs, the 84 SP and 117 SK SATDs of each 4x4
        tensor += n8 * 4 * (13 + len(sp_pairs) + 13 * 9) * _MAP
        alu += n8 * (45 * 4 * _ROW + 13 * 4 * _CHAIN
                     + (13 * 9 * 4 + len(sp_pairs) * 4) * _SATD)
        old += n8 * 4 * (45 * _BUILD_OLD
                         + 13 * (80 + 80 + 80 + 144 + 64 + 64 + 9 * 48)
                         + len(sp_pairs) * 48)
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "tensor": tensor / TENSOR_INT8_OPS_PER_S * 1e3,
         "alu": alu / int_rate * 1e3}
    by = max(t, key=t.get)
    return ((t[by], "bytes" if by == "bytes" else "operations"),
            bound(nbytes, old, int_rate), t)


def _box_edge_rows(n8: int, seed: int = 11):
    """r_idx8 [N8] with every 8x8 on the edge of the +-3 box, each of its
    24 cells (the four corners among them) drawn at random."""
    edge = [(oy + 6) * 13 + ox + 6 for oy in range(-3, 4)
            for ox in range(-3, 4) if max(abs(oy), abs(ox)) == 3]
    g = np.random.RandomState(seed)
    return torch.as_tensor(np.array(edge, np.int32)[g.randint(0, 24, n8)])


def phase_tail(dev, int_rate):
    from video_steganography_pcamv_torch import kernels
    from video_steganography_pcamv_torch.ops import cqm as CQ
    from video_steganography_pcamv_torch.ops import probe as PR
    cur, windows, part, mvfp8, prev_mv, lam, qp = _tail_inputs(dev)
    n = MBH * MBW
    n8 = 4 * n
    recs = []
    VP, CI, p = kernels.VP, kernels.CI, kernels.ptr
    zero = torch.zeros_like(prev_mv)
    jvt = CQ.QuantTables(CQ.JVT4I, CQ.JVT4P, CQ.JVT8I, CQ.JVT8P,
                         dz_intra=24, dz_inter=16)

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs(got, want)
        if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("%s kernel != plain, max abs err %d"
                                 % (name, err))
        log("%s: kernel == plain at %dx%d MBs (N8 %d)" % (name, MBH, MBW,
                                                         n8))
        return err

    def report(rec, bnds, alone, extra=""):
        """Log a tail kernel's times beside its bounds and keep its
        record (bound_ms / bound_by: the recounted bound)."""
        bnd, old, parts = bnds
        rec.update(bound_ms=bnd[0], bound_by=bnd[1], alone_ms=alone,
                   bound_alu_only_ms=old[0], bound_parts_ms=parts)
        log("%s: %.4f ms through the wrapper, %.4f ms alone, plain %.3f "
            "ms; bound %.4f ms (%s: bytes %.4f, int8 tensor %.4f, int32 "
            "%.4f), ALU-only bound %.4f ms%s (median, 1080p)"
            % (rec["name"], rec["ms"], alone, rec["plain_ms"], bnd[0],
               bnd[1], parts["bytes"], parts["tensor"], parts["alu"],
               old[0], extra))
        recs.append(rec)

    # B2's standalone entry (on no path: the tail builds its rows
    # itself): reads the windows, writes both tables; per 8x8 and offset,
    # 64 averages (3 ops) on the ALU (the four 4x4 WHTs on the tensor
    # cores, ~0.006 ms a 1080p frame at the int8 rate)
    blocks8, wht8 = PR.qpel_tables(windows)
    want = PR.block_table8(windows)
    err = check("B2 qpel_tables (standalone entry)", (blocks8, wht8),
                (want, PR.wht8_table(want)))
    del want, blocks8, wht8
    ms = cuda_ms(lambda: PR.qpel_tables(windows), 20, 3)
    plain_ms = cuda_ms(lambda: PR.wht8_table(PR.block_table8(windows)), 3)
    bnd = bound(n8 * (1024 + 169 * 64 * 3), n8 * 169 * 64 * 3, int_rate)
    recs.append(record("qpel_tables", "qpel_tables.cu",
                       "ops/probe_pallas.py:221", err, ms, plain_ms, bnd))
    torch.cuda.empty_cache()

    # B3 alone (stego off, B frames), without and with its mb_cost
    # output, for a random and a zero predictor
    mv8 = torch.empty((2 * MBH, 2 * MBW, 2), dtype=torch.int32, device=dev)
    r8 = torch.empty((n8,), dtype=torch.int32, device=dev)
    cost = torch.empty((MBH, MBW), dtype=torch.int32, device=dev)
    errs = {False: [], True: []}
    for pred, pname in ((prev_mv, "random"), (zero, "zero")):
        for mb_cost in (False, True):
            got = PR.subpel(cur, windows, part, mvfp8, pred, lam, MBH, MBW,
                            mb_cost=mb_cost)
            want = PR.subpel_parts(cur, windows, part, mvfp8, pred, MBH,
                                   MBW, lam, mb_cost=mb_cost)
            errs[mb_cost].append(check(
                "B3 subpel%s (%s predictor)"
                % (" with mb_cost" if mb_cost else "", pname), got, want))
    sub_args = [p(cur), p(windows), p(part), p(mvfp8), p(prev_mv), int(lam),
                MBH, MBW, p(mv8), p(r8)]
    sub_types = [VP] * 5 + [CI] * 3 + [VP] * 4
    for mb_cost, name in ((False, "subpel"), (True, "subpel_mb_cost")):
        ms = cuda_ms(lambda: PR.subpel(cur, windows, part, mvfp8, prev_mv,
                                       lam, MBH, MBW, mb_cost=mb_cost), 20, 3)
        plain_ms = cuda_ms(lambda: PR.subpel_parts(
            cur, windows, part, mvfp8, prev_mv, MBH, MBW, lam,
            mb_cost=mb_cost), 3)
        alone = _alone_ms("pcamv_subpel", sub_types, sub_args + [
            p(cost) if mb_cost else None, kernels.stream(cur)])
        report(record(name, "analyse_tail.cu", "ops/probe_pallas.py:301",
                      max(errs[mb_cost]), ms, plain_ms, (None, None)),
               tail_bounds(n8, n, int_rate, True, False, mb_cost), alone)

    # the fused tail (B3 -> B4, every stego P path) against subpel_parts
    # + probe_maps_plain: flat tables with a random and a zero predictor,
    # decimate off, jvt with the inter deadzone 16
    errs = []
    for pred, decimate, tables, what in (
            (prev_mv, True, None, "random predictor"),
            (zero, True, None, "zero predictor"),
            (prev_mv, False, None, "decimate off"),
            (prev_mv, True, jvt, "jvt, deadzone 16")):
        got = PR.analyse_tail(cur, windows, part, mvfp8, pred, lam, qp, MBH,
                              MBW, decimate, tables)
        want = PR.subpel_parts(cur, windows, part, mvfp8, pred, MBH, MBW,
                               lam)
        want += PR.probe_maps_plain(cur, windows, want[1], qp, MBH, MBW,
                                    decimate, tables)
        errs.append(check("fused analyse tail (%s)" % what, got, want))
    r_idx8 = got[1]
    ms = cuda_ms(lambda: PR.analyse_tail(cur, windows, part, mvfp8, prev_mv,
                                         lam, qp, MBH, MBW), 20, 3)

    def plain_tail():
        mv, r = PR.subpel_parts(cur, windows, part, mvfp8, prev_mv, MBH, MBW,
                                lam)
        return PR.probe_maps_plain(cur, windows, r, qp, MBH, MBW)
    plain_ms = cuda_ms(plain_tail, 3)
    qtab = PR.quant_params(qp, None, dev)
    sk, sp, sc8 = PR._tail_out(n, dev, False)
    alone = _alone_ms(
        "pcamv_analyse_tail", [VP] * 5 + [CI, VP] + [CI] * 4 + [VP] * 6,
        [p(cur), p(windows), p(part), p(mvfp8), p(prev_mv), int(lam),
         p(qtab), qp // 6 - 4, 1, MBH, MBW, p(mv8), p(r8), p(sk), p(sp),
         p(sc8), kernels.stream(cur)])
    report(record("analyse_tail", "analyse_tail.cu",
                  "ops/probe_pallas.py:574", max(errs), ms, plain_ms,
                  (None, None)),
           tail_bounds(n8, n, int_rate, True, True), alone)

    # B4's check entry (on no path) on chosen rows and on rows on every
    # corner and edge of the +-3 box, decimate on and off, flat and jvt
    edge = _box_edge_rows(n8).to(dev)
    errs = []
    for rows, rname in ((r_idx8, "chosen rows"), (edge, "box-edge rows")):
        for decimate, tables, what in ((True, None, "flat"),
                                       (False, None, "decimate off"),
                                       (True, jvt, "jvt, deadzone 16")):
            got = PR.probe_maps(cur, windows, rows, qp, MBH, MBW, decimate,
                                tables)
            want = PR.probe_maps_plain(cur, windows, rows, qp, MBH, MBW,
                                       decimate, tables)
            errs.append(check("B4 check entry (%s, %s)" % (rname, what),
                              got, want))
    ms = cuda_ms(lambda: PR.probe_maps(cur, windows, r_idx8, qp, MBH, MBW),
                 20, 3)
    ms_j = cuda_ms(lambda: PR.probe_maps(cur, windows, r_idx8, qp, MBH, MBW,
                                         True, jvt), 20, 3)
    plain_ms = cuda_ms(lambda: PR.probe_maps_plain(
        cur, windows, r_idx8, qp, MBH, MBW), 3)
    alone = _alone_ms(
        "pcamv_probe_maps", [VP] * 4 + [CI] * 4 + [VP] * 4,
        [p(cur), p(windows), p(r_idx8), p(qtab), qp // 6 - 4, 1, MBH, MBW,
         p(sk), p(sp), p(sc8), kernels.stream(cur)])
    report(record("probe_maps", "analyse_tail.cu", "ops/probe_pallas.py:481",
                  max(errs), ms, plain_ms, (None, None)),
           tail_bounds(n8, n, int_rate, False, True), alone,
           "; under jvt + deadzone 16 %.4f ms through the wrapper" % ms_j)
    for r in recs:
        log("%s time: kernel %.4f ms, plain %.3f ms, bound %.4f ms (%s) "
            "(median, 1080p)" % (r["name"], r["ms"], r["plain_ms"],
                                 r["bound_ms"], r["bound_by"]))
    return recs


def _touched_bytes(planes, yy, xx) -> int:
    """Distinct plane bytes that windows at rows yy [N, k] and columns
    xx [N, k] of the [4, Hp, Wp] planes read (overlaps counted once)."""
    touched = torch.zeros(planes.shape[1:], dtype=torch.bool,
                          device=planes.device)
    touched[yy[:, :, None], xx[:, None, :]] = True
    return 4 * int(touched.sum())


def phase_b9b10(dev, int_rate):
    """B9 on the main path's real MVs (B1 with a zero predictor and the
    partition decision on a 1080p frame pair) and on +-16 and +-20
    corner MVs; B10 on the lowres planes of the same pair."""
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    from video_steganography_pcamv_torch.encoder.me import lambda_tab
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    lam = lambda_tab(26)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    prev = torch.as_tensor(fr[0].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = mc.build_ref(prev, c, c)
    zero = torch.zeros((MBH, MBW, 2), dtype=torch.int32, device=dev)
    planes = ref["luma"].to(torch.uint8)
    st = FP.fullpel_parts(cur, planes[0], zero, 16, MBH, MBW, lam)
    real = PT.decide_partition(st, MBH, MBW, lam)[1].contiguous()
    n8 = 4 * MBH * MBW
    recs = []

    # B9. bytes: the plane samples the run's windows touch, each read
    # once, the [N8, 4, 16, 16] windows written, the MVs read; no
    # arithmetic. library: the one advanced-index gather
    cases = [("main-path MVs", real)]
    g = np.random.RandomState(12)
    for r in (16, 20):
        for sx, sy in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            mv = g.randint(-r, r + 1, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
            for by, bx in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
                mv[by, bx] = (r * sx, r * sy)
            cases.append(("corner MVs %+d, %+d" % (r * sx, r * sy),
                          torch.as_tensor(mv, device=dev)))
    err = 0
    for name, mv in cases:
        got = PT.gather_windows8(planes, mv, MBH, MBW)
        err = max(err, _check_equal(
            "B9 gather_windows8 (%s)" % name, (got,),
            (PT.gather_windows8_plain(planes, mv, MBH, MBW),)))
        log("B9 %s: kernel == plain at %dx%d MBs (N8 %d)"
            % (name, MBH, MBW, n8))
    ms = cuda_ms(lambda: PT.gather_windows8(planes, real, MBH, MBW), 20, 3)
    plain_ms = cuda_ms(lambda: PT.gather_windows8_plain(planes, real, MBH,
                                                        MBW), 5)
    yy, xx = PT.window8_index(real, MBH, MBW)
    yi, xi = yy[:, :, None], xx[:, None, :]
    lib_ms = cuda_ms(lambda: planes[:, yi, xi], 20, 3)
    read = _touched_bytes(planes, yy, xx)
    log("B9 reads %d distinct plane bytes (%d window bytes written)"
        % (read, n8 * 4 * 256))
    recs.append(record("gather_windows8", "windows8.cu",
                       "ops/pallas_kernels.py:259", err, ms, plain_ms,
                       bound(read + n8 * 4 * 256 + n8 * 8, 0, int_rate),
                       lib_ms))

    # B9 with ref8 (the multi-reference analysis): a stack of the two
    # entries, the per-8x8 reference and full-pel MVs of the merge of B1
    # on each (ref_frames 2, both valid), and +-20 corner MVs with a
    # random ref8
    from video_steganography_pcamv_torch.ops import mc as MC
    older = torch.as_tensor(synthetic_sequence(16 * MBW, 16 * MBH, 1,
                                               seed=11)[0].y
                            .astype(np.int32), device=dev)
    stack = torch.stack([planes, MC.build_ref(older, c, c)["luma"]
                         .to(torch.uint8)]).contiguous()
    sts = [FP.fullpel_parts(cur, stack[r, 0], zero, 16, MBH, MBW, lam)
           for r in range(2)]
    mst = PT.merge_ref_states(sts, lam, PT.te_ref_bits(2), 2)
    part2, mv2 = PT.decide_partition(mst, MBH, MBW, lam)
    mv2 = mv2.contiguous()
    ref8 = PT.ref8_from_partition(mst, part2, MBH, MBW)
    mvc = g.randint(-20, 21, (2 * MBH, 2 * MBW, 2)).astype(np.int32)
    for by, bx, v in ((0, 0, (-20, -20)), (0, -1, (20, -20)),
                      (-1, 0, (-20, 20)), (-1, -1, (20, 20))):
        mvc[by, bx] = v
    rand8 = torch.as_tensor(g.randint(0, 2, (2 * MBH, 2 * MBW))
                            .astype(np.int32), device=dev)
    err8 = 0
    for name, mv, r8 in (("merged MVs and ref8", mv2, ref8),
                         ("+-20 corner MVs, random ref8",
                          torch.as_tensor(mvc, device=dev), rand8)):
        got = PT.gather_windows8(stack, mv, MBH, MBW, ref8=r8)
        err8 = max(err8, _check_equal(
            "B9 gather_windows8 with ref8 (%s)" % name, (got,),
            (PT.gather_windows8_plain(stack, mv, MBH, MBW, ref8=r8),)))
        log("B9 with ref8, %s: kernel == plain at %dx%d MBs (%.1f%% of "
            "the blocks on reference 1)" % (name, MBH, MBW,
                                            100.0 * float(r8.float().mean())))
    ms8 = cuda_ms(lambda: PT.gather_windows8(stack, mv2, MBH, MBW,
                                             ref8=ref8), 20, 3)
    plain8 = cuda_ms(lambda: PT.gather_windows8_plain(stack, mv2, MBH, MBW,
                                                      ref8=ref8), 5)
    log("B9 with ref8 time: kernel %.4f ms, plain %.3f ms (median, 1080p, "
        "2 references)" % (ms8, plain8))
    recs[-1].update(max_abs_err=max(err, err8), ref8_ms=ms8,
                    ref8_plain_ms=plain8)

    # B10 at the lowres shape (960x544: 68x120 8x8 blocks, 34x60 B1
    # tiles), rng 8 (the lookahead's), also 7 and 20. bytes: the lowres
    # cur (int32) and the padded lowres ref (uint8) read once, B1's 9
    # (cost, index) pairs a tile and the two costs written; ops: B1's
    # search_ops a tile, and ~4 ops a sample for the intra pass
    lr_cur, lr_ref = ST.lowres(cur), ST.lowres(prev)
    err = 0
    for rng in (7, 20, 8):
        got = ST.lowres_costs_kernel(lr_cur, lr_ref, MBH, MBW, rng)
        err = max(err, _check_equal(
            "B10 lowres_costs_kernel rng %d" % rng, (got,),
            (ST.lowres_costs_kernel_plain(lr_cur, lr_ref, MBH, MBW,
                                          rng),)))
        log("B10: kernel == plain at %dx%d lowres, rng %d: (cost_i, "
            "cost_p) = %s" % (lr_cur.shape[1], lr_cur.shape[0], rng,
                              got.tolist()))
    ms = cuda_ms(lambda: ST.lowres_costs_kernel(lr_cur, lr_ref, MBH, MBW,
                                                rng), 20, 3)
    plain_ms = cuda_ms(lambda: ST.lowres_costs_kernel_plain(
        lr_cur, lr_ref, MBH, MBW, rng), 3)
    # B10's B1 wrapper call alone (960x544 is 34x60 whole tiles: no edge
    # pad); like every time here, CUDA events around one call, so a slow
    # host's enqueue time shows in it
    th, tw = lr_cur.shape[0] // 16, lr_cur.shape[1] // 16
    lr_pad = mc.pad_plane(lr_ref.to(torch.uint8))
    tz = torch.zeros((th, tw, 2), dtype=torch.int32, device=dev)
    log("B10's B1 call alone: %.4f ms (median, %dx%d tiles, rng %d)"
        % (cuda_ms(lambda: FP.fullpel_parts(lr_cur, lr_pad, tz, rng, th, tw,
                                            1), 20, 3), th, tw, rng))
    nt = th * tw
    nbytes = (lr_cur.numel() * 4 + (lr_cur.shape[0] + 2 * mc.PAD)
              * (lr_cur.shape[1] + 2 * mc.PAD) + (nt * 18 + 2) * 4)
    ops = search_ops(nt, rng) + lr_cur.numel() * 4
    recs.append(record("lowres_costs_kernel", "fullpel.cu",
                       "encoder/slicetype.py:41", err, ms, plain_ms,
                       bound(nbytes, ops, int_rate)))
    for r in recs:
        log("%s time: kernel %.4f ms, plain %.3f ms, library %s, bound "
            "%.4f ms (%s) (median, 1080p)"
            % (r["name"], r["ms"], r["plain_ms"],
               "n/a" if r["library_ms"] is None else "%.4f ms"
               % r["library_ms"], r["bound_ms"], r["bound_by"]))
    return recs


def _check_equal(name, got, want):
    torch.cuda.synchronize()
    err = max_abs(got, want)
    if err != 0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("%s kernel != plain, max abs err %d"
                             % (name, err))
    return err


def phase_b678(dev, int_rate):
    """B6, B7, the fused luma encode and B8a/B8b at 1080p on a real frame
    pair, fed as the 16x16-only path feeds them."""
    from video_steganography_pcamv_torch.encoder import analyse2 as A2
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.encoder import qpel_table as QT
    from video_steganography_pcamv_torch.encoder.me import (fullpel_search,
                                                            lambda_tab)
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import mc
    from video_steganography_pcamv_torch.ops import tq4 as TQ
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    fr = synthetic_sequence(16 * MBW, 16 * MBH, 2, seed=3)
    n = MBH * MBW
    rng, qp = 16, 26
    lam = lambda_tab(qp)
    cur = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
    c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
    ref = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32), device=dev),
                       c, c)
    planes = ref["luma"].to(torch.uint8)
    ref_fp = planes[0]
    recs = []

    # B6 at rng 7, 20 and 16 (the path's, timed). bytes: cur (int32) and
    # the padded uint8 reference read once, (mv, cost) written; ops:
    # search_ops, as B1
    zero = torch.zeros((MBH, MBW, 2), dtype=torch.int32, device=dev)
    err = 0
    for r in (7, 20, rng):
        got = FP.fullpel_search16(cur, ref_fp, r, MBH, MBW, lam)
        want = fullpel_search(cur, ref_fp, zero, r, MBH, MBW, lam)
        err = max(err, _check_equal("B6 fullpel_search16 rng %d" % r, got,
                                    want))
        log("B6: kernel == plain at %dx%d MBs, rng %d" % (MBH, MBW, r))
    mv_fp = got[0]
    ms = cuda_ms(lambda: FP.fullpel_search16(cur, ref_fp, rng, MBH, MBW,
                                             lam), 20, 3)
    plain_ms = cuda_ms(lambda: fullpel_search(cur, ref_fp, zero, rng, MBH,
                                              MBW, lam), 3)
    bnd = bound(cur.numel() * 4 + ref_fp.numel() + 3 * n * 4,
                search_ops(n, rng), int_rate)
    recs.append(record("fullpel_search16", "fullpel.cu",
                       "ops/pallas_kernels.py:549", err, ms, plain_ms, bnd))

    # B7. bytes: the plane samples that this run's windows touch, each
    # read once (neighbouring windows overlap), the 4 x 24 x 24 window
    # written per MB, the MV field read; no arithmetic. library: the one
    # advanced-index gather
    got = QT.gather_windows(planes, mv_fp, MBH, MBW)
    err = _check_equal("B7 gather_windows", (got,),
                       (QT.gather_windows_plain(planes, mv_fp, MBH, MBW),))
    ms = cuda_ms(lambda: QT.gather_windows(planes, mv_fp, MBH, MBW), 20, 3)
    plain_ms = cuda_ms(lambda: QT.gather_windows_plain(planes, mv_fp, MBH,
                                                       MBW), 5)
    ys, xs = QT._window_origins(mv_fp, MBH, MBW)
    w = torch.arange(QT.WIN, device=dev)
    yy = (ys[:, None] + w)[:, :, None]
    xx = (xs[:, None] + w)[:, None, :]
    lib_ms = cuda_ms(lambda: planes[:, yy, xx], 20, 3)
    touched = torch.zeros(planes.shape[1:], dtype=torch.bool, device=dev)
    touched[yy, xx] = True
    read = 4 * int(touched.sum())
    log("B7 reads %d distinct plane bytes (%d window bytes)"
        % (read, n * 4 * QT.WIN * QT.WIN))
    bnd = bound(read + n * 4 * QT.WIN * QT.WIN + n * 8, 0, int_rate)
    recs.append(record("gather_windows", "windows.cu",
                       "encoder/qpel_table.py:64", err, ms, plain_ms, bnd,
                       lib_ms))

    # the luma encodes on the pass-1 inputs (the MBs at their subpel
    # MVs) at qp 26 and 20 (the qb < 0 dequant branch), and on the
    # probe's 13-version batch
    mv_q, r_idx, blocks, wht = A2.analyse_p_frame(
        cur, ref["luma"], zero, rng, MBH, MBW, lam)
    ar = torch.arange(n, device=dev, dtype=torch.int32)
    pred = mc.mc_luma(ref["luma"], torch.div(ar, MBW, rounding_mode="floor")
                      * 16, (ar % MBW) * 16, mv_q.reshape(n, 2))
    blk = torch.cat([QT.select_rows(blocks, r_idx + A2._didx(*cc))
                     for cc in A2._CENTERS]).to(torch.int32)
    recs.append(phase_luma_p(dev, int_rate, cur, pred, blk))
    recs.append(phase_luma_levels(dev, int_rate, cur, pred))
    recs.append(phase_luma_nr(dev, int_rate, cur, pred))
    recs.append(phase_luma_aq(dev, int_rate, cur, pred))

    # B8a/B8b, standalone check entries, on the same inputs with
    # zero_dc / use_dc
    cur16 = INTER._mb_to_coef16(INTER.mb_tiles(cur, 16))
    pred16 = INTER._mb_to_coef16(pred)
    cur16_13 = cur16.repeat(1, len(A2._CENTERS))
    pred16_13 = INTER._mb_to_coef16(blk)
    g = np.random.default_rng(5)
    err_a = err_b = 0
    times = {}
    for tag, c16, p16, q in (("pass", cur16, pred16, 26),
                             ("pass", cur16, pred16, 20),
                             ("probe13", cur16_13, pred16_13, 26)):
        L = c16.shape[1]
        mf = torch.as_tensor(LP.MF16[q], device=dev)
        bias = torch.as_tensor(LP.BIAS16[q], device=dev)
        dmf = torch.as_tensor(LP.DMF16[q % 6], device=dev)
        dc = torch.as_tensor(g.integers(-3000, 3000, (1, L)).astype(np.int32),
                             device=dev)
        for zdc in (False, True):
            lev = TQ.dct_quant(c16, p16, mf, bias, zdc)
            err_a = max(err_a, _check_equal(
                "B8a dct_quant %s qp %d zero_dc %s" % (tag, q, zdc), (lev,),
                (TQ.dct_quant_plain(c16, p16, mf, bias, zdc),)))
        lev = lev * INTER._decimate_keep16(lev, L // 16)
        for udc in (False, True):
            rec = TQ.deq_idct(lev, p16, dmf, q // 6 - 4, dc, udc)
            err_b = max(err_b, _check_equal(
                "B8b deq_idct %s qp %d use_dc %s" % (tag, q, udc), (rec,),
                (TQ.deq_idct_plain(lev, p16, dmf, q // 6 - 4, dc, udc),)))
        key = (tag, q)
        times[key] = (
            cuda_ms(lambda: TQ.dct_quant(c16, p16, mf, bias), 20, 3),
            cuda_ms(lambda: TQ.dct_quant_plain(c16, p16, mf, bias), 5),
            cuda_ms(lambda: TQ.deq_idct(lev, p16, dmf, q // 6 - 4), 20, 3),
            cuda_ms(lambda: TQ.deq_idct_plain(lev, p16, dmf, q // 6 - 4), 5),
            L)
        log("B8 %s qp %d (L %d): kernel == plain; B8a %.4f ms (plain %.3f),"
            " B8b %.4f ms (plain %.3f) (median)" % (tag, q, L, *times[key][:4]))
    # bytes per lane: 16 int32 read from each of two rows and 16 written;
    # ops per lane: B8a 16 subs + 2 x 4 x 8 butterfly ops + 16 x 5 quant
    # ops; B8b 16 x 2 dequant ops + 2 x 4 x 10 butterfly ops + 16 x 4
    # recon ops
    L = cur16.shape[1]
    ta = times[("pass", 26)]
    recs.append(record("dct_quant", "dct_quant.cu",
                       "ops/pallas_kernels.py:175", err_a, ta[0], ta[1],
                       bound(L * 16 * 4 * 3 + 2 * 64, L * (16 + 64 + 80),
                             int_rate)))
    recs.append(record("deq_idct", "dct_quant.cu",
                       "ops/pallas_kernels.py:204", err_b, ta[2], ta[3],
                       bound(L * 16 * 4 * 3 + 64, L * (32 + 80 + 64),
                             int_rate)))
    for r in recs:
        log("%s time: kernel %.4f ms, plain %.3f ms, library %s, bound "
            "%.4f ms (%s) (median, 1080p)"
            % (r["name"], r["ms"], r["plain_ms"],
               "n/a" if r["library_ms"] is None else "%.4f ms"
               % r["library_ms"], r["bound_ms"], r["bound_by"]))
    L13 = cur16_13.shape[1]
    tb = times[("probe13", 26)]
    log("B8 probe13 batch bounds: B8a %.4f ms, B8b %.4f ms (%s); times "
        "B8a %.4f ms, B8b %.4f ms"
        % (bound(L13 * 16 * 4 * 3, L13 * 160, int_rate)[0],
           bound(L13 * 16 * 4 * 3, L13 * 176, int_rate)[0],
           bound(L13 * 16 * 4 * 3, L13 * 160, int_rate)[1], tb[0], tb[2]))
    return recs


# integer operations of the fused luma encode per 4x4 block: 16
# residual subtractions, 2 x 4 x 8 forward butterfly ops, 16 x 5 quant
# ops, 16 x 4 decimate-score ops, 16 x 2 dequant ops, 2 x 4 x 10 inverse
# butterfly ops and 16 x 4 recon ops
LUMA_P_OPS_PER_BLOCK = 16 + 64 + 80 + 64 + 32 + 80 + 64


def phase_luma_p(dev, int_rate, cur, pred, blk):
    """The fused luma encode against its plain version at 1080p: the
    pass-1 inputs at qp 26 and 20, with a force-zero mask, on an MB
    subset, and on the 13-version batch `blk` without the levels; each
    timed beside the earlier chain (B8a -> decimation -> B8b in the
    [16, L] layout, `INTER.luma_p_encode_fast`) on the same inputs, the
    probe's with its `repeat` of the current MBs."""
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.ops import lumap as LP
    n = pred.shape[0]
    g = np.random.default_rng(9)
    fz = torch.as_tensor(g.random(n) < 0.3, device=dev)
    idx = torch.as_tensor(np.sort(g.choice(n, n // 8, replace=False))
                          .astype(np.int32), device=dev)
    p_sub = pred[idx.long()].contiguous()
    tiles = INTER.mb_tiles(cur, 16)
    cases = [("pass qp 26", pred, 26, {}), ("pass qp 20", pred, 20, {}),
             ("pass qp 26 force-zero", pred, 26, {"fz": fz}),
             ("subset qp 26", p_sub, 26, {"idx": idx}),
             ("probe13 qp 26", blk, 26, {"lev": False})]
    err = 0
    times = {}
    for tag, p, q, kw in cases:
        got = LP.luma_p_encode(cur, p, q, **kw)
        want = LP.luma_p_encode_plain(cur, p, q, **kw)
        if kw.get("lev", True) != (got[0] is not None):
            raise AssertionError("luma_p_encode %s: levels %s"
                                 % (tag, "missing" if got[0] is None
                                    else "not omitted"))
        err = max(err, _check_equal("luma_p_encode " + tag,
                                    [t for t in got if t is not None],
                                    [t for t in want if t is not None]))
        if tag.startswith("pass") and "fz" not in kw:
            fast = INTER.luma_p_encode_fast(tiles, p, q)
            _check_equal("luma_p_encode %s vs the B8a/B8b chain" % tag,
                         got[:2], fast)
        if tag in ("pass qp 26", "pass qp 20", "probe13 qp 26"):
            rep = p.shape[0] // n

            def chain(p=p, q=q, rep=rep):
                return INTER.luma_p_encode_fast(
                    tiles if rep == 1 else tiles.repeat(rep, 1, 1), p, q)
            times[tag] = (
                cuda_ms(lambda p=p, q=q, kw=kw: LP.luma_p_encode(cur, p, q,
                                                                 **kw), 20, 3),
                cuda_ms(lambda p=p, q=q, kw=kw: LP.luma_p_encode_plain(
                    cur, p, q, **kw), 5),
                cuda_ms(chain, 20, 3))
        log("luma_p_encode %s (%d MBs): kernel == plain" % (tag, p.shape[0]))

    def bnd(n_out, with_lev):
        # cur (the plane's MBs, each read once) and pred read, rec and
        # cbp (and the levels) written; the [16] tables
        nbytes = (n * 1024 + n_out * (1024 + 1024 + 4)
                  + (n_out * 1024 if with_lev else 0) + 3 * 64)
        return bound(nbytes, n_out * 16 * LUMA_P_OPS_PER_BLOCK, int_rate)
    for tag in times:
        nb = bnd(blk.shape[0], False) if tag.startswith("probe") \
            else bnd(n, True)
        log("luma_p_encode %s: fused %.4f ms, plain %.3f ms, earlier "
            "B8a/decimation/B8b chain %.4f ms, bound %.4f ms (%s) (median)"
            % (tag, *times[tag], *nb))
    t = times["pass qp 26"]
    return record("luma_p_encode", "luma_p.cu", "ops/pallas_kernels.py:175",
                  err, t[0], t[1], bnd(n, True))


# integer operations of the levels-in entry per 4x4 block: the fused
# encode's without the residual, the forward transform and the quant
LUMA_LEVELS_OPS_PER_BLOCK = 64 + 32 + 80 + 64


def phase_luma_levels(dev, int_rate, cur, pred):
    """The fused luma encode's levels-in entry (the trellis path's)
    against its plain version at 1080p: the trellis's levels of the
    pass-1 inputs at qp 26 and 20 (`inter.trellis_luma_levels`, plain
    torch on the card), also with a force-zero mask; timed beside the
    plain version and beside the trellis that makes its levels."""
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.ops import lumap as LP
    n = pred.shape[0]
    fz = torch.as_tensor(np.random.default_rng(9).random(n) < 0.3,
                         device=dev)
    err, times = 0, {}
    for q in (26, 20):
        levels = INTER.trellis_luma_levels(cur, pred, q)
        for tag, kw in (("qp %d" % q, {}), ("qp %d force-zero" % q,
                                            {"fz": fz})):
            got = LP.luma_p_encode(cur, pred, q, levels=levels, **kw)
            want = LP.luma_p_encode_plain(cur, pred, q, levels=levels, **kw)
            err = max(err, _check_equal("luma_p_encode levels-in " + tag,
                                        got, want))
            log("luma_p_encode levels-in %s (%d MBs): kernel == plain"
                % (tag, n))
        times[q] = (
            cuda_ms(lambda: LP.luma_p_encode(cur, pred, q, levels=levels),
                    20, 3),
            cuda_ms(lambda: LP.luma_p_encode_plain(cur, pred, q,
                                                   levels=levels), 5),
            cuda_ms(lambda: INTER.trellis_luma_levels(cur, pred, q), 3))
    # pred and the levels read, the levels, rec and cbp written, the
    # dequant table
    bnd = bound(n * (1024 + 1024 + 1024 + 1024 + 4) + 64,
                n * 16 * LUMA_LEVELS_OPS_PER_BLOCK, int_rate)
    for q, t in times.items():
        log("luma_p_encode levels-in qp %d: kernel %.4f ms, plain %.3f ms, "
            "the trellis of its levels (4x4 luma, %d blocks) %.2f ms, bound "
            "%.4f ms (%s) (median)" % (q, t[0], t[1], 16 * n, t[2], *bnd))
    t = times[26]
    return record("luma_p_encode_levels", "luma_p.cu",
                  "ops/pallas_kernels.py:204", err, t[0], t[1], bnd)


# the reference's default Params where bench.py's Params differ from
# them, plus SSIM: PSNR/SSIM on and the host deblock put the fused P step
# on its unpipelined branch
DEFAULTS = dict(deblock_device=False, psnr=True, ssim=True)


def _params(w, h, tail_kernel, me_range=16, partitions=True,
            config3=False, em_rate=64, **kw):
    """bench.py's Params (`em_rate` payload bits a frame); `config3` adds
    BASELINE config 3's transform_8x8 and rd 1; `kw` overrides the rest
    (cabac, DEFAULTS)."""
    from video_steganography_pcamv_torch.params import Params, StegoParams
    base = dict(width=w, height=h, qp=26, me_range=me_range,
                deblock_device=partitions, psnr=False, partitions=partitions,
                transform_8x8=config3, rd=int(config3),
                stego=StegoParams(em_rate=em_rate, key=99))
    base.update(kw)
    p = Params(**base)
    p.tail_kernel = tail_kernel
    p.pipeline_deep = False
    return p


def _encode(p, frames, device):
    from video_steganography_pcamv_torch import Encoder
    enc = Encoder(p, device=device)
    bs = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    return enc, bs


def _decode_job(bs, n_frames, sent, recon=None, em_rate=64):
    """The port's decoder reconstructs every frame (a CPU deblock,
    seconds a frame at 1080p) and the port's blind extractor recovers
    the payload `sent` from the decoded frames. With `recon` (display
    index -> the encoder's planes of a frame: each B frame's, and the
    anchors' where given) each of those decoded frames is held against
    them. Returns (payload bits, decode + extraction s, the differing
    pixels of each frame in `recon` and the MB types of each B frame, by
    display index)."""
    from video_steganography_pcamv_torch.decoder import decode_annexb
    from video_steganography_pcamv_torch.stego.extract import (
        extract_from_frames)
    t0 = time.time()
    dec = decode_annexb(bs)
    if len(dec) != n_frames:
        raise AssertionError("decoded %d frames of %d" % (len(dec), n_frames))
    kinds, differ = {}, {}
    # display index: POC / 2, or the decode order where every POC is 0
    # (an IPP stream's poc_type 2)
    disp = [fr.poc // 2 for fr in dec]
    if len(set(disp)) < len(disp):
        disp = list(range(len(dec)))
    for d, fr in zip(disp, dec):
        if recon is None or d not in recon:
            continue
        if fr.slice_type == 1:
            kinds[d] = dict(collections.Counter(m.mb_type for m in fr.mbs))
        differ[d] = sum(int((getattr(fr, pl) != r[:fr.y.shape[0] // s,
                                                  :fr.y.shape[1] // s]).sum())
                        for pl, r, s in zip("yuv", recon[d], (1, 2, 2)))
    got = extract_from_frames(dec, em_rate=em_rate)
    if len(got) != len(sent) or not all(
            np.array_equal(a, b) for a, b in zip(got, sent)):
        raise AssertionError("extracted payload != sent payload")
    return sum(len(s) for s in sent), time.time() - t0, differ, kinds


# the reference's NR offsets arithmetic (core.py:3540-3562), for the
# host-side model of phases 9 and 30
NR_W2 = np.array([[800, 320, 800, 320], [320, 128, 320, 128],
                  [800, 320, 800, 320], [320, 128, 320, 128]], np.float64)


def nr_offset_of(strength: int, nr_sum, nr_count: int) -> np.ndarray:
    num = float(strength) * nr_count + nr_sum / 2
    return (num / (nr_sum * NR_W2 / 256.0 + 1.0)).astype(np.int32)


def _luma_entry_ms(cur, pred, q, qt, nr_off=None, launches=50,
                   reps=5) -> float:
    """Device ms a launch of the fused luma encode's C entry alone,
    outputs preallocated, without the wrapper's checks and allocations:
    CUDA events around `launches` back-to-back launches, the median of
    `reps` (as tools/torch_kernel_probe.py times a launch); with nr_off
    its noise-reduction instance (the sums left to accumulate); with q
    an int32 [N] tensor its per-MB qp entry."""
    from video_steganography_pcamv_torch import kernels
    n = pred.shape[0]
    dev = cur.device
    lev = torch.empty((n, 4, 4, 4, 4), dtype=torch.int32, device=dev)
    rec = torch.empty((n, 16, 16), dtype=torch.int32, device=dev)
    cbp = torch.empty((n,), dtype=torch.int32, device=dev)
    nr_sum = torch.zeros(16, dtype=torch.int32, device=dev)
    qtab = None if isinstance(q, torch.Tensor) else qt.qtab(q, dev)
    ptr = kernels.ptr
    VP, CI = kernels.VP, kernels.CI
    fn = kernels.entry("pcamv_luma_p_encode", [VP] * 2 + [CI] * 2
                       + [VP] * 2 + [CI] + [VP] * 3 + [CI] + [VP] * 6)
    off = None if nr_off is None else nr_off.contiguous()
    # the arguments made once, so that the loop below issues launches
    # as fast as the host can
    tail = (None if off is None else ptr(off),
            None if off is None else ptr(nr_sum), ptr(lev), ptr(rec),
            ptr(cbp), kernels.stream(cur))
    if isinstance(q, torch.Tensor):
        name = "pcamv_luma_p_encode_grid"
        fn = kernels.entry(name, [VP] * 2 + [CI] * 2 + [VP] * 2 + [CI]
                           + [VP] * 8)
        args = (ptr(cur), ptr(pred), cur.shape[1], cur.numel() // 256,
                None, None, n, ptr(q), ptr(qt.qtab_all(dev))) + tail
    else:
        name = "pcamv_luma_p_encode"
        args = (ptr(cur), ptr(pred), cur.shape[1], cur.numel() // 256,
                None, None, n, ptr(qtab[:16]), ptr(qtab[16:32]),
                ptr(qtab[32:]), q // 6 - 4) + tail

    def run():
        kernels.check(fn(*args), name)
    run()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def phase_luma_nr(dev, int_rate, cur, pred):
    """The fused luma encode's noise-reduction instance (the reference's
    luma_p_encode(..., nr_offset=)) against its plain version at 1080p on
    the pass-1 inputs under jvt with phase 30's deadzones, at qp 26 and
    20 with offsets from the reference's arithmetic (after one frame of
    sums), also with force-zero; then a wrap case: qp 0 under jvt on
    int32 planes whose residuals reach +-40000 (the quant product leaves
    int32), both instances on 64 MBs. Timed beside the plain DCT entry
    (the instance without NR) on the same inputs, through the wrapper
    and the C entry alone."""
    from video_steganography_pcamv_torch.ops import cqm as CQ
    from video_steganography_pcamv_torch.ops import lumap as LP
    n = pred.shape[0]
    qt = CQ.QuantTables(CQ.JVT4I, CQ.JVT4P, CQ.JVT8I, CQ.JVT8P,
                        dz_intra=24, dz_inter=16)
    fz = torch.as_tensor(np.random.default_rng(9).random(n) < 0.3,
                         device=dev)
    err, times = 0, {}
    for q in (26, 20):
        # the offsets after one frame's sums, as the encoder derives them
        s1 = LP.luma_p_encode_plain(cur, pred, q, tables=qt,
                                    nr_offset=torch.zeros(
                                        (4, 4), dtype=torch.int32,
                                        device=dev))[3]
        off = torch.as_tensor(nr_offset_of(400, s1.cpu().numpy().astype(
            np.float64), 16 * n), device=dev)
        for tag, kw in (("qp %d" % q, {}), ("qp %d force-zero" % q,
                                            {"fz": fz})):
            got = LP.luma_p_encode(cur, pred, q, tables=qt, nr_offset=off,
                                   **kw)
            want = LP.luma_p_encode_plain(cur, pred, q, tables=qt,
                                          nr_offset=off, **kw)
            err = max(err, _check_equal("luma_p_encode NR " + tag, got,
                                        want))
            log("luma_p_encode NR instance %s (%d MBs, offsets %s): kernel "
                "== plain, sums included" % (tag, n,
                                             off.reshape(-1).tolist()))
        times[q] = (
            cuda_ms(lambda: LP.luma_p_encode(cur, pred, q, tables=qt,
                                             nr_offset=off), 20, 3),
            cuda_ms(lambda: LP.luma_p_encode_plain(cur, pred, q, tables=qt,
                                                   nr_offset=off), 5),
            cuda_ms(lambda: LP.luma_p_encode(cur, pred, q, tables=qt), 20, 3),
            _luma_entry_ms(cur, pred, q, qt, off),
            _luma_entry_ms(cur, pred, q, qt))
    # the wrap case
    g = np.random.default_rng(13)
    big = torch.as_tensor(g.integers(-20000, 20001, cur.shape)
                          .astype(np.int32), device=dev)
    idx = torch.arange(64, dtype=torch.int32, device=dev)
    pbig = torch.as_tensor(g.integers(-20000, 20001, (64, 16, 16))
                           .astype(np.int32), device=dev)
    zero_off = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    for kw in ({}, {"nr_offset": zero_off + 7}):
        got = LP.luma_p_encode(big, pbig, 0, idx=idx, tables=qt, **kw)
        want = LP.luma_p_encode_plain(big, pbig, 0, idx=idx, tables=qt, **kw)
        err = max(err, _check_equal("luma_p_encode wrap case %s" % kw,
                                    got, want))
    coef_max = int(LP.luma_p_encode_plain(big, pbig, 0, idx=idx, tables=qt,
                                          nr_offset=zero_off)[3].max())
    log("luma_p_encode wrap case (qp 0, jvt, residuals to +-40000, 64 MBs):"
        " kernel == plain for both instances (sum of |coef| at a position "
        "up to %d; mf up to %d)" % (coef_max, int(qt.mf4[1, 0].max())))
    # bytes as the plain DCT entry's plus the offsets read and the sums
    # written (once a CTA: 16 atomics of 4 B), ops plus the |coef|, the
    # 5 reduction rounds and the denoise (3 ops) per coefficient
    n_cta = -(-n // 16)
    bnd = bound(n * 1024 + n * (1024 + 1024 + 4) + n * 1024 + 3 * 64 + 64
                + n_cta * 64,
                n * 16 * (LUMA_P_OPS_PER_BLOCK + 16 * (1 + 3) + 15 + 1),
                int_rate)
    for q, t in times.items():
        log("luma_p_encode NR instance qp %d: kernel %.4f ms (the plain DCT "
            "entry %.4f ms), alone %.4f ms (plain DCT entry alone %.4f ms), "
            "plain %.3f ms, bound %.4f ms (%s) (median, 1080p)"
            % (q, t[0], t[2], t[3], t[4], t[1], *bnd))
    t = times[26]
    return record("luma_p_encode_nr", "luma_p.cu",
                  "ops/pallas_kernels.py:175", err, t[0], t[1], bnd)


def phase_luma_aq(dev, int_rate, cur, pred):
    """The fused luma encode's per-MB qp instances (adaptive
    quantization, the reference's luma_p_encode(cur, pred, qp[N], ...))
    at 1080p on the pass-1 inputs under jvt with phase 30's deadzones and
    a random grid of qps 10-51: the DCT entry (also with force-zero), its
    noise-reduction instance and the levels-in entry on the trellis's
    levels at the same grid (also with force-zero), each against its
    plain version; a grid of 26 everywhere gives the scalar qp-26 call.
    The grid DCT entry is timed beside the scalar one through the wrapper
    and as the C entry alone."""
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.ops import cqm as CQ
    from video_steganography_pcamv_torch.ops import lumap as LP
    n = pred.shape[0]
    qt = CQ.QuantTables(CQ.JVT4I, CQ.JVT4P, CQ.JVT8I, CQ.JVT8P,
                        dz_intra=24, dz_inter=16)
    g = np.random.default_rng(31)
    grid = torch.as_tensor(g.integers(10, 52, n).astype(np.int32),
                           device=dev)
    fz = torch.as_tensor(g.random(n) < 0.3, device=dev)
    off = torch.as_tensor(g.integers(0, 40, (4, 4)).astype(np.int32),
                          device=dev)
    levels = INTER.trellis_luma_levels(cur, pred, grid, qt)
    cases = (("DCT entry", {}), ("DCT entry force-zero", {"fz": fz}),
             ("NR instance", {"nr_offset": off}),
             ("levels-in entry", {"levels": levels}),
             ("levels-in entry force-zero", {"levels": levels, "fz": fz}))
    err = 0
    n0 = LP.luma_p_encode.grid_launches
    for tag, kw in cases:
        got = LP.luma_p_encode(cur, pred, grid, tables=qt, **kw)
        want = LP.luma_p_encode_plain(cur, pred, grid, tables=qt, **kw)
        err = max(err, _check_equal("luma_p_encode per-MB qp " + tag, got,
                                    want))
        log("luma_p_encode per-MB qp %s (%d MBs, qp 10-51, jvt): kernel == "
            "plain" % (tag, n))
    if LP.luma_p_encode.grid_launches != n0 + len(cases):
        raise AssertionError("luma_p_encode per-MB qp: grid_launches not "
                             "counted")
    flat = torch.full((n,), 26, dtype=torch.int32, device=dev)
    _check_equal("luma_p_encode grid of 26 vs qp 26",
                 LP.luma_p_encode(cur, pred, flat, tables=qt),
                 LP.luma_p_encode(cur, pred, 26, tables=qt))
    t = (cuda_ms(lambda: LP.luma_p_encode(cur, pred, grid, tables=qt), 20,
                 3),
         cuda_ms(lambda: LP.luma_p_encode_plain(cur, pred, grid, tables=qt),
                 5),
         cuda_ms(lambda: LP.luma_p_encode(cur, pred, 26, tables=qt), 20, 3),
         _luma_entry_ms(cur, pred, grid, qt),
         _luma_entry_ms(cur, pred, 26, qt))
    # the DCT entry's bytes plus the grid read (4 B an MB) and the 52 x 48
    # slab (read once); ops plus the MB's table offset and shift
    bnd = bound(n * 1024 + n * (1024 + 1024 + 4) + n * 1024 + n * 4
                + 52 * 48 * 4, n * (16 * LUMA_P_OPS_PER_BLOCK + 4), int_rate)
    log("luma_p_encode per-MB qp DCT entry: kernel %.4f ms (the scalar qp-26"
        " call %.4f ms), alone %.4f ms (scalar alone %.4f ms), plain %.3f "
        "ms, bound %.4f ms (%s) (median, 1080p)"
        % (t[0], t[2], t[3], t[4], t[1], *bnd))
    rec = record("luma_p_encode_aq", "luma_p.cu", "ops/pallas_kernels.py:175",
                 err, t[0], t[1], bnd)
    rec.update(alone_ms=t[3], scalar_ms=t[2], scalar_alone_ms=t[4])
    return rec


# the 1080p decode checks run in worker processes while the next phases
# use the card; `_join_checks` collects them before the result is printed
_POOL, _DEFERRED = None, []
# worker processes of the pool (phase 29's own process runs with one)
POOL_WORKERS = 4


def _worker_init():
    torch.set_num_threads(2)


def _submit(fn, *args):
    """Run fn(*args) in a worker process (spawned: the parent has a CUDA
    context); returns its future."""
    global _POOL
    if _POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL = ProcessPoolExecutor(
            POOL_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
    return _POOL.submit(fn, *args)


def _defer(report, bs, n_frames, sent, recon=None, em_rate=64):
    """Submit `_decode_job` to a worker process and keep `report`, which
    `_join_checks` calls here with its result, in the order submitted."""
    _DEFERRED.append((_submit(_decode_job, bs, n_frames, list(sent), recon,
                              em_rate), report))


def _defer_payload(label, bs, enc, n_frames):
    """The payload check of a small stream (`_decode_job`) in a worker;
    phase 28 logs its bits."""
    _defer(lambda r: log("%s: %d payload bits recovered (in a worker)"
                         % (label, r[0])),
           bs, n_frames, enc._stego.sent_messages,
           em_rate=enc.p.stego.em_rate)


def _cpu_encode_job(w, h, n_frames, tail_kernel, kw):
    """The CPU half of a cuda == cpu check, in a worker: the stream, the
    close() dict and the (I8x8, trans8) MB counts of `_params(w, h,
    tail_kernel, **kw)` over synthetic_sequence(w, h, n_frames, seed=7)
    on the cpu."""
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    enc, bs = _encode(_params(w, h, tail_kernel, **kw),
                      synthetic_sequence(w, h, n_frames, seed=7), "cpu")
    return bs, enc.close(), (enc.stats.i8x8_mbs, enc.stats.trans8_mbs)


def _join_checks():
    """Wait for every deferred decode check and report it; the first
    that failed raises. The worker processes are stopped either way."""
    try:
        while _DEFERRED:
            fut, report = _DEFERRED.pop(0)
            report(fut.result())
    finally:
        _stop_pool()


def _stop_pool():
    """Drop the checks not yet started and stop the worker processes."""
    global _POOL
    _DEFERRED.clear()
    if _POOL is not None:
        _POOL.shutdown(wait=True, cancel_futures=True)
        _POOL = None


def phase_small(dev):
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(112, 80, 6, seed=7)
    streams = {}
    # the cpu halves and the payload checks run in the worker processes
    jobs = {tk: _submit(_cpu_encode_job, 112, 80, len(frames), tk, {})
            for tk in (True, False)}
    for tail_kernel in (True, False):
        enc_g, bs_g = _encode(_params(112, 80, tail_kernel), frames, dev)
        bs_c = jobs[tail_kernel].result()[0]
        if bs_g != bs_c:
            raise AssertionError("112x80 stream, tail_kernel=%s: cuda (%d B)"
                                 " != cpu (%d B)" % (tail_kernel, len(bs_g),
                                                     len(bs_c)))
        label = "112x80 x6, tail_kernel=%s" % tail_kernel
        _defer_payload(label, bs_g, enc_g, len(frames))
        streams[tail_kernel] = bs_g
        log("%s: cuda stream == cpu stream (%d bytes)" % (label, len(bs_g)))
    log("112x80: the two branches' streams %s"
        % ("differ" if streams[True] != streams[False] else "are equal"))


def phase_small16(dev):
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(112, 80, 6, seed=7)
    enc_g, bs_g = _encode(_params(112, 80, True, partitions=False), frames,
                          dev)
    # here, not in a worker: late in the run they hold the decode checks
    _enc_c, bs_c = _encode(_params(112, 80, True, partitions=False), frames,
                           "cpu")
    if bs_g != bs_c:
        raise AssertionError("112x80 16x16-only stream: cuda (%d B) != cpu "
                             "(%d B)" % (len(bs_g), len(bs_c)))
    _defer_payload("112x80 x6, partitions=False", bs_g, enc_g, len(frames))
    log("112x80 x6, partitions=False: cuda stream == cpu stream (%d bytes)"
        % len(bs_g))


def phase_small8(dev):
    """Config 3 at 128x96: the cuda stream equals the cpu stream."""
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(128, 96, 6, seed=7)
    job = _submit(_cpu_encode_job, 128, 96, len(frames), True,
                  dict(config3=True))
    enc_g, bs_g = _encode(_params(128, 96, True, config3=True), frames, dev)
    bs_c, _d, counts_c = job.result()
    if bs_g != bs_c:
        raise AssertionError("128x96 config-3 stream: cuda (%d B) != cpu "
                             "(%d B)" % (len(bs_g), len(bs_c)))
    counts = (enc_g.stats.i8x8_mbs, enc_g.stats.trans8_mbs)
    if min(counts) < 1 or counts != counts_c:
        raise AssertionError("128x96 config 3: I8x8 / trans8 MBs %s on "
                             "cuda, %s on cpu" % (counts, counts_c))
    _defer_payload("128x96 x6, config 3", bs_g, enc_g, len(frames))
    log("128x96 x6, config 3 (transform_8x8, rd 1): cuda stream == cpu "
        "stream (%d bytes), %d I8x8 MBs, %d trans8 P MBs"
        % (len(bs_g), counts[0], counts[1]))


def _close_equal(what, got, want):
    """close() dicts of the same encode on two devices: the same keys,
    PSNR and the counts exactly, SSIM to rtol 1e-5 (a float32 sum whose
    order differs); fps is a rate of the wall clock."""
    if got.keys() != want.keys():
        raise AssertionError("%s: close() keys differ" % what)
    for k in want:
        if k == "fps":
            continue
        ok = (abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) if k == "ssim_y"
              else got[k] == want[k])
        if not ok:
            raise AssertionError("%s: close()[%r] %r on cuda, %r on cpu"
                                 % (what, k, got[k], want[k]))


def phase_small_cabac(dev):
    """CABAC on the main path, on config 3 and on the 16x16-only path,
    the reference's default Params (PSNR, SSIM, the host deblock's twin,
    unpipelined), the multi-reference paths and the B streams (config 4
    and bframes 1) at 112x80: cuda == cpu streams and close() dicts, the
    payload recovered by the port's decoder and extractor."""
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    frames = synthetic_sequence(112, 80, 6, seed=7)
    cases = (("cabac main path", True, dict(cabac=True)),
             ("cabac config 3", True, dict(cabac=True, config3=True)),
             ("cabac 16x16 path", True, dict(cabac=True, partitions=False)),
             ("default Params", True, DEFAULTS),
             ("ref_frames 2", True, dict(ref_frames=2)),
             ("ref_frames 2 cabac", True, dict(ref_frames=2, cabac=True)),
             ("ref_frames 3 keyint_max 3, tail_kernel=False", False,
              dict(ref_frames=3, keyint_max=3)),
             ("ref_frames 2 partitions off", True,
              dict(ref_frames=2, partitions=False)),
             ("config 4 (bframes 2, ref_frames 2, cabac)", True,
              dict(cabac=True, bframes=2, b_adapt=0, ref_frames=2)),
             ("bframes 1, ref_frames 1, cabac", True,
              dict(cabac=True, bframes=1, b_adapt=0)),
             ("CAVLC B, ref_frames 2", True,
              dict(bframes=2, b_adapt=0, ref_frames=2)),
             ("b_adapt 1 (default Params, bframes 2)", True,
              dict(DEFAULTS, bframes=2, b_adapt=1)),
             ("b_adapt 2, rc_lookahead 5", True,
              dict(bframes=2, b_adapt=2, rc_lookahead=5)),
             ("16x16 B, cabac, ref_frames 1", True,
              dict(cabac=True, partitions=False, bframes=2, b_adapt=0)),
             ("16x16 B, cabac, ref_frames 2", True,
              dict(cabac=True, partitions=False, bframes=2, b_adapt=0,
                   ref_frames=2)),
             ("b_pyramid, weightb, direct auto (bframes 3, ref_frames 2, "
              "cabac)", True,
              dict(cabac=True, bframes=3, b_adapt=0, ref_frames=2,
                   b_pyramid=True, weightb=True, direct=3)),
             ("temporal direct, weightb, CAVLC, b_adapt 1", True,
              dict(bframes=2, b_adapt=1, direct=2, weightb=True)),
             ("direct none, cabac", True,
              dict(cabac=True, bframes=2, b_adapt=0, direct=0)),
             ("16x16 B, b_pyramid, temporal direct, ref_frames 2", True,
              dict(partitions=False, bframes=3, b_adapt=0, b_pyramid=True,
                   direct=2, ref_frames=2)),
             ("ref_frames 2, transform_8x8, rd 1, trellis 1, cabac", True,
              dict(cabac=True, ref_frames=2, transform_8x8=True, rd=1,
                   trellis=1)),
             ("b_pyramid, weightb, trellis 1 (bframes 3, ref_frames 2, "
              "cabac)", True,
              dict(cabac=True, bframes=3, b_adapt=0, ref_frames=2,
                   b_pyramid=True, weightb=True, trellis=1)),
             ("16x16 path, transform_8x8, trellis 1, cabac", True,
              dict(cabac=True, partitions=False, transform_8x8=True,
                   trellis=1)),
             ("main path, trellis 1, cabac", True,
              dict(cabac=True, trellis=1)),
             ("main path, rd 2", True, dict(rd=2)),
             # the quantizer's options (cqm, deadzones, nr); 8 payload bits
             # a frame touch few MBs, so pass 2 is incremental
             ("main path, cqm jvt, incremental", True,
              dict(cqm="jvt", em_rate=8)),
             ("cqm jvt, transform_8x8, rd 1, trellis 1, cabac", True,
              dict(cqm="jvt", cabac=True, transform_8x8=True, rd=1,
                   trellis=1)),
             ("nr 400, ref_frames 2", True,
              dict(noise_reduction=400, ref_frames=2)),
             ("nr 400, bframes 2, deadzones 16/8", True,
              dict(noise_reduction=400, bframes=2, b_adapt=0,
                   deadzone_inter=16, deadzone_intra=8)),
             # adaptive quantization: the unfused one-reference P path,
             # per-MB qps in the luma kernel and B5, the writers' deltas
             ("aq_mode 1, one reference, CAVLC", True, dict(aq_mode=1)),
             ("aq_mode 1, config 4 (bframes 2, ref_frames 2, cabac)", True,
              dict(aq_mode=1, cabac=True, bframes=2, b_adapt=0,
                   ref_frames=2)))
    from video_steganography_pcamv_torch.encoder import core as CORE
    incr = CORE.reencode_p_incremental
    # the cpu encodes run in the worker processes meanwhile
    cpu_jobs = [_submit(_cpu_encode_job, 112, 80, len(frames), tk, kw)
                for _what, tk, kw in cases]
    for (what, tk, kw), job in zip(cases, cpu_jobs):
        n_incr = [0]

        def counted(*a, _n=n_incr, **k):
            _n[0] += 1
            return incr(*a, **k)
        CORE.reencode_p_incremental = counted
        try:
            enc_g, bs_g = _encode(_params(112, 80, tk, **kw), frames, dev)
        finally:
            CORE.reencode_p_incremental = incr
        if "incremental" in what and n_incr[0] == 0:
            raise AssertionError("112x80 %s: no incremental re-encode" % what)
        bs_c, d_c, _counts = job.result()
        if bs_g != bs_c:
            raise AssertionError("112x80 %s: cuda (%d B) != cpu (%d B)"
                                 % (what, len(bs_g), len(bs_c)))
        d_g = enc_g.close()
        _close_equal("112x80 " + what, d_g, d_c)
        _defer_payload("112x80 x6, " + what, bs_g, enc_g, len(frames))
        log("112x80 x6, %s: cuda stream == cpu stream (%d bytes), close() "
            "equal (PSNR-Y %.4f, SSIM-Y %.6f / %.6f)"
            % (what, len(bs_g), d_g["psnr_y"], d_g["ssim_y"], d_c["ssim_y"]))


def phase_defaults(dev, card, bs6, enc6):
    """The 1080p main path at the reference's default Params plus SSIM,
    IDR + 3 P: the unpipelined branch, the deblock on B5 (bit-exact to
    the reference's host deblock), PSNR/SSIM on the card. Pipelining
    only reorders work, so the stream must be the first four frames of
    phase 6's stream, with the same payload."""
    launches, bs, enc = phase_main(dev, card, True, 4,
                                   label="1080p default Params",
                                   payload=False, **DEFAULTS)
    if not (bs6.startswith(bs)
            and bs6[len(bs):len(bs) + 4] == b"\0\0\0\1"):
        raise AssertionError("1080p default Params: %d bytes, not the first "
                             "four frames of phase 6's stream" % len(bs))
    sent, sent6 = enc._stego.sent_messages, enc6._stego.sent_messages
    if len(sent) != 3 or not all(np.array_equal(a, b)
                                 for a, b in zip(sent, sent6)):
        raise AssertionError("1080p default Params: payload != phase 6's")
    d = enc.close()
    if not (20 < d["psnr_y"] < 99 and 0 < d["ssim_y"] <= 1):
        raise AssertionError("1080p default Params: close() %s" % d)
    log("1080p default Params (psnr, ssim, deblock_device=False): %d bytes "
        "== phase 6's first 4 frames; PSNR Y/U/V %.4f / %.4f / %.4f, "
        "SSIM-Y %.6f; close() fps %.4f  [%s]"
        % (len(bs), d["psnr_y"], d["psnr_u"], d["psnr_v"], d["ssim_y"],
           d["fps"], card))
    return launches


def _frame_bytes(bs: bytes) -> list:
    """Bytes per frame of an Annex-B stream of one slice a frame: every
    NAL (4-byte start code included) counts to the next slice NAL."""
    sizes, cur = [], 0
    for nal in bs.split(b"\0\0\0\1")[1:]:
        cur += 4 + len(nal)
        if nal[0] & 0x1F in (1, 5):
            sizes.append(cur)
            cur = 0
    return sizes


def phase_cabac(dev, card, bs6):
    """The 1080p main path under CABAC, IDR + 2 P: the payload recovered
    by the port's CABAC decoder and extractor (timed); its bytes per
    frame beside phase 6's CAVLC stream on the same frames; the host
    CABAC write of each slice, and after the run CAVLC's write of the
    same P slices' syntax (5 reps each, median)."""
    from video_steganography_pcamv_torch import native
    calls, orig = [], native.write_slice_cabac

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        calls.append((time.perf_counter() - t0, a, kw))
        return out
    native.write_slice_cabac = timed
    try:
        launches, bs, _enc = phase_main(dev, card, True, 3,
                                        label="1080p CABAC main path",
                                        cabac=True)
    finally:
        native.write_slice_cabac = orig
    cab = _frame_bytes(bs)
    cav = _frame_bytes(bs6)[:len(cab)]
    log("1080p bytes per frame, CABAC %s against CAVLC (phase 6) %s: "
        "%+.2f%% in all, %+.2f%% over the P frames"
        % (cab, cav, 100.0 * (sum(cab) / sum(cav) - 1),
           100.0 * (sum(cab[1:]) / sum(cav[1:]) - 1)))

    def median_ms(fn, *a, **kw):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(*a, **kw)
            t.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(t))
    rows = []
    for t_run, a, kw in calls:
        if a[2] != 0:
            continue      # the I slice
        cavlc_kw = {k: v for k, v in kw.items() if k not in ("luma8_lev",
                                                             "trans8")}
        rows.append("%.3f in the run, %.3f median; CAVLC %.3f"
                    % (1e3 * t_run, median_ms(orig, *a, **kw),
                       median_ms(native.write_slice, *a[:5], **cavlc_kw)))
    log("1080p CABAC host write per P slice (write_slice_cabac ms; CAVLC "
        "write_slice on the same syntax): %s; I slice %.1f ms  [%s]"
        % ("; ".join(rows), 1e3 * calls[0][0], card))
    return launches


def phase_config4p(dev, card):
    """BASELINE config 4's P half at 1080p (tools/bench_c4.py's Params
    with bframes 0: ref_frames 2, CABAC, me_range 16, key 5), IDR + 2 P:
    the payload through the port's CABAC decoder, the exact launch
    counts, and the share of 8x8 blocks the analysis put on reference
    1 (read after the run), which must not be 0 on the P frame whose
    list holds two valid references."""
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.params import StegoParams
    orig, ref8s = PT.analyse_p_frame_parts_mref, []

    def analyse(*a, **kw):
        out = orig(*a, **kw)
        ref8s.append(out[2])
        return out
    PT.analyse_p_frame_parts_mref = analyse
    try:
        launches, bs, enc = phase_main(
            dev, card, True, 3, label="1080p config 4 P half (ref_frames 2,"
            " CABAC)", cabac=True, ref_frames=2,
            stego=StegoParams(em_rate=64, key=5))
    finally:
        PT.analyse_p_frame_parts_mref = orig
    share = [float((r == 1).float().mean()) for r in ref8s]
    log("1080p config 4 P half: %d bytes per frame %s; 8x8 blocks on "
        "reference 1 per P frame %s  [%s]"
        % (len(bs), _frame_bytes(bs), ["%.4f" % x for x in share], card))
    if len(share) != 2 or share[1] <= 0:
        raise AssertionError("1080p config 4 P half: no 8x8 block on "
                             "reference 1 in the second P frame: %s" % share)
    return launches


def _b_kernel_twins():
    """The plain twin of every kernel wrapper a B frame calls, by its name
    in `encoder/bslice.py`, called as the wrapper is."""
    from video_steganography_pcamv_torch.encoder import me as ME
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import qpel_table as QT
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import probe as PR

    def search16(y, ref, rng, mbh, mbw, lam=1):
        zero = torch.zeros((mbh, mbw, 2), dtype=torch.int32, device=y.device)
        return ME.fullpel_search(y, ref, zero, rng, mbh, mbw, lam)
    return {
        "fullpel_parts": FP.fullpel_search_parts,
        "gather_windows8": PT.gather_windows8_plain,
        "subpel": lambda y, w, part, mv, pred, lam, mbh, mbw:
            PR.subpel_parts(y, w, part, mv, pred, mbh, mbw, lam),
        "luma_p_encode": LP.luma_p_encode_plain,
        "fullpel_search16": search16,
        "gather_windows": QT.gather_windows_plain,
    }


def _equal_outputs(got, want) -> bool:
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) for k in want)
    if isinstance(got, (tuple, list)):
        return all(_equal_outputs(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


def phase_config4(dev, card, n_frames: int = 7):
    """BASELINE config 4 whole at 1080p: tools/bench_c4.py's Params
    (bframes 2, b_adapt 0, ref_frames 2, CABAC, me_range 16, stego
    em_rate 64 key 5) and clip (synthetic_sequence seed 9), IDR + 6
    frames + flush, two GOPs of P B B (`phase_bpath`). Returns the
    launches and the CABAC B write's ms per B frame."""
    from video_steganography_pcamv_torch.params import StegoParams
    p = _params(1920, 1088, True, cabac=True, bframes=2, b_adapt=0,
                ref_frames=2, stego=StegoParams(em_rate=64, key=5))
    return phase_bpath(dev, card, "1080p config 4 (bframes 2, ref_frames 2, "
                       "CABAC)", p, n_frames, want_pb=(2, 4))


def phase_defaults_b(dev, card, cabac_write_ms, n_frames: int = 7):
    """The reference's default Params with bframes 2 at 1080p (CAVLC,
    b_adapt 1, partitions, one reference, PSNR on, the host deblock's
    twin B5, me_range 16) on phase 22's clip and stego (`phase_bpath`),
    the CAVLC B write per B frame beside phase 22's CABAC one."""
    from video_steganography_pcamv_torch.params import Params, StegoParams
    p = Params(width=1920, height=1088, bframes=2,
               stego=StegoParams(em_rate=64, key=5))
    _launches, write_ms = phase_bpath(
        dev, card, "1080p default Params, bframes 2 (CAVLC, b_adapt 1)", p,
        n_frames)
    log("1080p B write ms per B frame: CAVLC (phase 24) %s, median %.3f; "
        "CABAC (phase 22) %s, median %.3f  [%s]"
        % (["%.3f" % x for x in write_ms], float(np.median(write_ms)),
           ["%.3f" % x for x in cabac_write_ms],
           float(np.median(cabac_write_ms)), card))


# phase 26's B options over config 4's Params (tools/bench_c4.py's
# bframes 2 raised to 3, so that a GOP holds a reference B)
PYRAMID = dict(bframes=3, b_pyramid=True, weightb=True, direct=3)


def phase_pyramid(dev, card, n_frames: int = 6):
    """Phase 26: tools/bench_c4.py's Params (CABAC, ref_frames 2,
    partitions, me_range 16, stego em_rate 64 key 5) and clip with
    bframes 3, b_pyramid, weightb and direct auto at b_adapt 0, IDR + 5
    + flush: decode order I P4 Bref2 B1 B3 P5 (`phase_bpath`). The
    reference B is coded as a reference picture, the outer B frames
    take it as L1[0] and as L0[0], P5 carries the L0 reordering op;
    temporal direct on the first slices (the auto score starts at [0,
    0]), implicit weights on every BI combine."""
    from video_steganography_pcamv_torch.params import StegoParams
    p = _params(1920, 1088, True, cabac=True, b_adapt=0, ref_frames=2,
                stego=StegoParams(em_rate=64, key=5), **PYRAMID)
    phase_bpath(dev, card, "1080p b_pyramid, weightb, direct auto "
                "(bframes 3, ref_frames 2, CABAC)", p, n_frames,
                want_pb=(2, 3), want_brefs=[2])


def phase_pyramid_temporal(dev, card, n_frames: int = 5):
    """Phase 27: phase 26's pyramid at temporal direct without weightb,
    under CAVLC (direct 2, bframes 3, ref_frames 2, b_adapt 0), IDR + 4
    + flush: decode order I P4 Bref2 B1 B3 (`phase_bpath`). Every B slice
    is temporal: B1 (L1[0] the reference B) reads the reference B's
    L0-only colocated field, -2 on its L1-only blocks, through
    map_col_to_list0; B3 (L0[0] the reference B) takes two valid
    unweighted L0 entries."""
    from video_steganography_pcamv_torch.params import StegoParams
    p = _params(1920, 1088, True, cabac=False, b_adapt=0, ref_frames=2,
                stego=StegoParams(em_rate=64, key=5), bframes=3,
                b_pyramid=True, direct=2)
    phase_bpath(dev, card, "1080p b_pyramid, temporal direct (bframes 3, "
                "ref_frames 2, CAVLC)", p, n_frames, want_pb=(1, 3),
                want_brefs=[2], want_direct=["temporal"] * 3)


def phase_trellis(dev, card, n_frames: int = 7):
    """Phase 29: tools/bench_c4.py's clip (seed 9) and Params (CABAC,
    bframes 2, b_adapt 0, me_range 16, the device deblock, stego em_rate
    64 key 5) at ref_frames 1 with transform_8x8, rd 1 and trellis 1
    (x264's --8x8dct --subme 7 --trellis 1 --bframes 2), IDR + 6 + flush:
    I P B B P B B (`phase_bpath` with its anchor checks). The P anchors
    take the fused step unpipelined: the 8x8 candidate with its cat-5
    trellis and the RD choice, the 4x4 luma through the levels-in entry
    of the fused luma kernel in pass 1 and the full pass 2; the IDR
    trellises every candidate before its RD choice; the B frames'
    luma encode is the levels-in entry too. Returns the launches."""
    from video_steganography_pcamv_torch.params import StegoParams
    p = _params(1920, 1088, True, cabac=True, bframes=2, b_adapt=0,
                ref_frames=1, transform_8x8=True, rd=1, trellis=1,
                stego=StegoParams(em_rate=64, key=5))
    return phase_bpath(dev, card, "1080p transform_8x8, rd 1, trellis 1 "
                       "(bframes 2, ref_frames 1, CABAC)", p, n_frames,
                       want_pb=(2, 4), anchors=True)[0]


def phase_quant(dev, card, bs6, n_frames: int = 4, w: int = 1920,
                h: int = 1088):
    """Phase 30: the quantizer's options on the main path at 1080p:
    bench.py's Params (pipelined, tail_kernel=True, CAVLC) with cqm jvt,
    deadzone_inter 16, deadzone_intra 8 and noise_reduction 400, IDR + 3
    P on phase 6's clip. The SPS carries the jvt lists (High profile);
    every call of the fused luma encode (pass 1 and the full pass 2, both
    the noise-reduction instance) equals its plain version on the CPU,
    its sums included, and reads the offsets of a host model of the
    reference's NR arithmetic fed by those CPU sums; every B4 call equals
    its plain version on the card; after each P frame the encoder's NR
    state equals the model's; exact launches per P frame (B1, B9, B3, B4
    once, the luma encode's NR instance twice, B5 once a frame); the
    decoded frames equal the encoder's recon and the payload is recovered
    (in a worker). P fps (the checks excluded), the IDR's seconds and
    the bytes per frame beside phase 6's are printed. Returns the
    launches."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.decoder.decoder import (parse_nals,
                                                                 parse_sps)
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import probe as PR
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    label = "%dx%d cqm jvt, deadzones 16/8, nr 400" % (w, h)
    nr = 400
    p = _params(w, h, True, cqm="jvt", deadzone_inter=16,
                deadzone_intra=8, noise_reduction=nr)
    frames = synthetic_sequence(w, h, n_frames, seed=7)
    enc = Encoder(p, device=dev)
    qt = enc.qt
    sps = next(parse_sps(r) for t, _, r in parse_nals(enc.headers())
               if t == 7)
    if sps.profile != 100 or sps.scaling is None or not all(
            np.array_equal(a, b) for a, b in zip(sps.scaling, qt.lists)):
        raise AssertionError("%s: the SPS does not carry the jvt lists"
                             % label)
    n = p.mb_height * p.mb_width
    model = {"sum": np.zeros((4, 4), np.float64), "count": 0}
    st = {"check_s": 0.0, "luma": 0, "probe": 0}
    orig_lp, orig_tail = LP.luma_p_encode, PR.analyse_tail

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def luma(*a, **kw):
        out = orig_lp(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = kw.get("nr_offset")
        want_off = nr_offset_of(nr, model["sum"], model["count"])
        if off is None or not np.array_equal(off.cpu().numpy(), want_off):
            raise AssertionError("%s: luma call %d read offsets %s, the "
                                 "model's are %s" % (label, st["luma"],
                                                     off, want_off))
        want = LP.luma_p_encode_plain(*map(cpu, a),
                                      **{k: cpu(v) for k, v in kw.items()})
        if not _equal_outputs([cpu(t) for t in out if t is not None],
                              [t for t in want if t is not None]):
            raise AssertionError("%s: luma call %d kernel != plain (cpu)"
                                 % (label, st["luma"]))
        if st["luma"] % 2 == 0:   # pass 1 (then pass 2): the NR update
            model["sum"] += want[3].numpy().astype(np.float64)
            model["count"] += 16 * n
            if model["count"] > (1 << 18):
                model["sum"] /= 2
                model["count"] >>= 1
        st["luma"] += 1
        st["check_s"] += time.perf_counter() - t0
        return out

    def tail(cur_y, windows, part, mvfp8, prev_mv, lam, qp, mbh, mbw,
             decimate=True, tables=None):
        out = orig_tail(cur_y, windows, part, mvfp8, prev_mv, lam, qp, mbh,
                        mbw, decimate, tables)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = PR.subpel_parts(cur_y, windows, part, mvfp8, prev_mv, mbh,
                               mbw, lam)
        want += PR.probe_maps_plain(cur_y, windows, want[1], qp, mbh, mbw,
                                    decimate, tables)
        if tables is not qt or not _equal_outputs(out, want):
            raise AssertionError("%s: analyse tail call %d kernel != plain"
                                 % (label, st["probe"]))
        torch.cuda.synchronize()
        st["probe"] += 1
        st["check_s"] += time.perf_counter() - t0
        return out

    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    recon, per_frame = {}, []
    # the P encodes reach the luma kernel through `inter.LP`, stage 1 the
    # analyse tail (B3 -> B4) through `partition.PR`; the kernel wrappers
    # keep their own names (they count on them)
    import types
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.encoder import partition as PT
    INTER.LP = types.SimpleNamespace(**dict(vars(LP), luma_p_encode=luma))
    PT.PR = types.SimpleNamespace(**dict(vars(PR), analyse_tail=tail))
    try:
        bs = b""
        for i, f in enumerate(frames):
            st["check_s"] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs += enc.encode_frame(f)
            if i == len(frames) - 1:
                bs += enc.flush()
            torch.cuda.synchronize()
            per_frame.append(time.perf_counter() - t0 - st["check_s"])
            recon[i] = tuple(t.cpu().numpy() for t in enc.recon_prev)
            if i and not (np.array_equal(enc._nr_sum, model["sum"])
                          and enc._nr_count == model["count"]):
                raise AssertionError(
                    "%s: NR state after frame %d: %s / %d, the cpu "
                    "model's %s / %d" % (label, i, enc._nr_sum.tolist(),
                                         enc._nr_count,
                                         model["sum"].tolist(),
                                         model["count"]))
    finally:
        INTER.LP, PT.PR = LP, PR
    launches = {k: fn.launches for k, fn in fns.items()}
    n_p = enc.stats.p_frames
    want = {k: 0 for k in fns}
    want.update(fullpel_parts=n_p, gather_windows8=n_p, analyse_tail=n_p,
                luma_p_encode=2 * n_p,
                luma_p_encode_nr=2 * n_p, deblock_frame=len(frames))
    if n_p != len(frames) - 1 or launches != want:
        raise AssertionError("%s: %d P frames, launches %s, want %s"
                             % (label, n_p, launches, want))
    if st["luma"] != 2 * n_p or st["probe"] != n_p:
        raise AssertionError("%s: checked %d luma and %d tail calls"
                             % (label, st["luma"], st["probe"]))

    def report(r):
        bits, secs, differ, _kinds = r
        if any(differ.values()):
            raise AssertionError("%s: decoded frames differ from the recon:"
                                 " %s" % (label, differ))
        log("%s: %d payload bits recovered, every decoded frame == the "
            "encoder's recon (decode + extraction %.1f s, in a worker)"
            % (label, bits, secs))
    _defer(report, bs, len(frames), enc._stego.sent_messages, recon)
    sizes, sizes6 = _frame_bytes(bs), _frame_bytes(bs6)[:len(frames)]
    log("%s: SPS profile %d with the jvt lists; every luma call (%d, the "
        "NR instance) == its plain version on the cpu, sums and offsets "
        "included, every B4 call (%d) == plain; NR state == the model "
        "after each P frame (sums %s, count %d, offsets %s); launches %s; "
        "IDR %.3f s; P frames %.4f fps (checks excluded); bytes %s, phase "
        "6's %s  [%s]"
        % (label, sps.profile, st["luma"], st["probe"],
           model["sum"].reshape(-1).tolist(), model["count"],
           enc._nr_offset().reshape(-1).tolist(), json.dumps(launches),
           per_frame[0], n_p / sum(per_frame[1:]), sizes, sizes6, card))
    return launches


def phase_aq(dev, card, bs6, n_frames: int = 4, w: int = 1920,
             h: int = 1088):
    """Phase 31: adaptive quantization at 1080p: bench.py's Params
    (tail_kernel=True, CAVLC, one reference) with aq_mode 1, IDR + 3 P on
    phase 6's clip. AQ leaves the fused step: every P frame takes the
    unfused one-reference path. Exact launches per P frame (B1, B9, B3,
    B4 once; the luma encode twice, pass 1 and the full pass 2, both the
    per-MB qp instance; B5 once a frame, with qp maps); every grid lies
    in [qp_min, qp_max] and varies; the decoded frames equal the
    encoder's recon and the payload is recovered (in a worker). Prints
    the P fps (the checks excluded: there are none in the loop), the
    IDR's seconds, the bytes per frame beside phase 6's and the qp
    histogram of each frame's grid. Returns the launches."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.ops.deblock import deblock_frame
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    label = "%dx%d aq_mode 1" % (w, h)
    p = _params(w, h, True, aq_mode=1)
    frames = synthetic_sequence(w, h, n_frames, seed=7)
    enc = Encoder(p, device=dev)
    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    maps0 = deblock_frame.map_launches
    recon, per_frame, hists = {}, [], []
    bs = b""
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bs += enc.encode_frame(f)
        if i == len(frames) - 1:
            bs += enc.flush()
        torch.cuda.synchronize()
        per_frame.append(time.perf_counter() - t0)
        recon[i] = tuple(t.cpu().numpy() for t in enc.recon_prev)
        grid = enc.aq_grids[0]
        if grid.min() < p.qp_min or grid.max() > p.qp_max or \
                grid.min() == grid.max():
            raise AssertionError("%s: frame %d grid spans qp %d-%d"
                                 % (label, i, grid.min(), grid.max()))
        hists.append({int(q): int(c) for q, c in
                      zip(*np.unique(grid, return_counts=True))})
    launches = {k: fn.launches for k, fn in fns.items()}
    n_p = enc.stats.p_frames
    n_emb = sum(len(m) > 0 for m in enc._stego.sent_messages)
    want = {k: 0 for k in fns}
    want.update(fullpel_parts=n_p, gather_windows8=n_p, analyse_tail=n_p,
                luma_p_encode=n_p + n_emb,
                luma_p_encode_aq=n_p + n_emb, deblock_frame=len(frames))
    if (n_p != len(frames) - 1 or n_emb != n_p or launches != want
            or deblock_frame.map_launches - maps0 != len(frames)):
        raise AssertionError("%s: %d P frames (%d embedding), launches %s, "
                             "want %s; B5 with qp maps %d"
                             % (label, n_p, n_emb, launches, want,
                                deblock_frame.map_launches - maps0))

    def report(r):
        bits, secs, differ, _kinds = r
        if any(differ.values()):
            raise AssertionError("%s: decoded frames differ from the recon:"
                                 " %s" % (label, differ))
        log("%s: %d payload bits recovered, every decoded frame == the "
            "encoder's recon (decode + extraction %.1f s, in a worker)"
            % (label, bits, secs))
    _defer(report, bs, len(frames), enc._stego.sent_messages, recon)
    log("%s: launches %s (per P frame: B1, B9, B3, B4 1, the luma encode 2 "
        "at per-MB qps, B5 1 with qp maps); IDR %.3f s; P frames %.4f fps; "
        "bytes %s, phase 6's %s; qp histogram per frame %s  [%s]"
        % (label, json.dumps(launches), per_frame[0],
           n_p / sum(per_frame[1:]), _frame_bytes(bs),
           _frame_bytes(bs6)[:len(frames)], json.dumps(hists), card))
    return launches


def _unit_slots(part, sub):
    """The slots (of 16) that hold a unit in some MB of a sub-8x8 frame:
    the probe batches `stego_costs_sub` launches."""
    from video_steganography_pcamv_torch.encoder import partition as PT
    uid = PT.unit_id_map(torch.as_tensor(part), torch.as_tensor(sub)) \
        .numpy().reshape(-1, 16)
    return int(sum((uid[:, s] == s).any() for s in range(16)))


def _sub_stage_targets():
    """(object, attribute) of every stage of a sub-8x8 P frame."""
    from video_steganography_pcamv_torch import native
    from video_steganography_pcamv_torch.encoder import core as CORE
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import scan as SCAN
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    return [(ST.Lookahead, "decide"), (PT, "fullpel_sub"),
            (PT, "decide_partition_sub"), (PT, "gather_windows4"),
            (PT, "block_table4"), (PT, "wht4_table"), (PT, "subpel_sub"),
            (INTER, "encode_p_frame_device4"), (SCAN, "scan_p_frame_sub"),
            (PT, "stego_costs_sub"), (native, "stc_embed"),
            (SCAN, "scan_p_frame_sub_forced"), (CORE, "deblock_frame"),
            (native, "write_slice")]


def phase_sub(dev, card, n_frames: int = 4, w: int = 1920, h: int = 1088):
    """Phase 36: sub-8x8 partitions at full width (bench.py's Params with
    p4x4) on `sub_patch_clip`, IDR + 3 P: the first two P frames timed
    whole (P fps), the third with a device sync around each stage of
    `_sub_stage_targets`. Exact launches per P frame; B5's call of the
    last P frame held against its plain twin in a worker; decoded ==
    recon and the payload in a worker. Returns the launches."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import core
    label = "%dx%d p4x4" % (w, h)
    p = _params(w, h, True, p4x4=True)
    frames = sub_patch_clip(w, h, n_frames, seed=21)
    enc = Encoder(p, device=dev)
    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    # every patched attribute is restored from its value before any patch
    saved = [(obj, name, getattr(obj, name))
             for obj, name in _sub_stage_targets()]
    calls = []
    real = core.deblock_frame

    def keep(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    stages, state = {}, {"on": False}
    recon, per_frame, per_p, subs = {}, [], [], []
    bs = b""
    try:
        for obj, name, fn in saved:
            inner = keep if (obj, name) == (core, "deblock_frame") else fn
            setattr(obj, name, _stage_wrapper(name, inner, stages, state))
        for i, f in enumerate(frames):
            state["on"] = i == len(frames) - 1
            before = {k: fn.launches for k, fn in fns.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs += enc.encode_frame(f)
            torch.cuda.synchronize()
            per_frame.append(time.perf_counter() - t0)
            recon[i] = tuple(t.cpu().numpy() for t in enc.recon_prev)
            if i:
                per_p.append({k: fn.launches - before[k]
                              for k, fn in fns.items()})
                subs.append(enc.last_sub)
        state["on"] = False
        bs += enc.flush()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    n_p = enc.stats.p_frames
    emb = [len(m) > 0 for m in enc._stego.sent_messages]
    for i, (got, (part, sub)) in enumerate(zip(per_p, subs)):
        want = {k: 0 for k in fns}
        # pass 1, then on a frame that embeds the chosen offsets' probe,
        # a probe batch per slot that holds a unit, and pass 2
        want.update(fullpel_sub=1, deblock_frame=1, luma_p_encode=1 + (
            2 + _unit_slots(part, sub) if emb[i] else 0))
        if got != want:
            raise AssertionError("%s: P frame %d launches %s, want %s"
                                 % (label, i + 1, got, want))
    if n_p != n_frames - 1 or not all(emb):
        raise AssertionError("%s: %d P frames, embedding %s"
                             % (label, n_p, emb))
    part, sub = subs[-1]
    p8 = part == 3
    hist = np.bincount(sub[p8].reshape(-1), minlength=4)
    # B5 of the last P frame: its per-4x4 field moves inside 8x8 blocks
    a, kw = calls[-1]
    mv4 = a[6].cpu().numpy().astype(np.int64)
    # edges between 4x4 columns (rows) 0|1 and 2|3 of an MB: inside 8x8s
    inner = (np.abs(np.diff(mv4, axis=1))[:, 0::2].max(-1) >= 4).sum() \
        + (np.abs(np.diff(mv4, axis=0))[0::2].max(-1) >= 4).sum()
    if inner == 0 or hist[1:].sum() == 0:
        raise AssertionError("%s: no sub-8x8 split (%s) or no internal "
                             "4x4 edge with a MV step (%d)"
                             % (label, hist, inner))
    got = [t.cpu() for t in real(*a, **kw)]
    cpu = [t if not isinstance(t, torch.Tensor) else t.cpu() for t in a]
    qps = cpu[7:9]
    t8 = kw.get("trans8")
    r4 = kw.get("ref4")

    def check_b5(want):
        want = [torch.as_tensor(x) for x in want]
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError("%s: B5 kernel != plain on the sub field, "
                                 "max abs err %d" % (label, max_abs(got,
                                                                    want)))
        log("%s: B5 kernel == plain on the last P frame's per-4x4 field "
            "(%d internal 4x4 edges with a MV step of a pel or more; in a "
            "worker)" % (label, inner))
    _DEFERRED.append((_submit(
        _b5_plain_job, cpu[:7] + [None if t8 is None else t8.cpu(),
                                  None if r4 is None else r4.cpu()],
        qps[0], qps[1], cpu[9], cpu[10],
        {k: v for k, v in kw.items() if k not in ("trans8", "ref4")}),
        check_b5))

    def report(r):
        bits, secs, differ, _kinds = r
        if any(differ.values()):
            raise AssertionError("%s: decoded frames differ from the recon:"
                                 " %s" % (label, differ))
        log("%s: %d payload bits recovered, every decoded frame == the "
            "encoder's recon (decode + extraction %.1f s, in a worker)"
            % (label, bits, secs))
    _defer(report, bs, len(frames), enc._stego.sent_messages, recon)
    log("%s: launches per P frame %s (B1's sub-unit instance 1, the luma "
        "encode 2 + one probe batch per slot holding a unit + 1, B5 1); "
        "IDR %.3f s; P frames %.4f fps (%s s); bytes %s; cover MVs %d, "
        "payload bits %d; P_8x8 MBs %.1f%% of the last P frame, "
        "sub_mb_type histogram (8x8, 8x4, 4x8, 4x4) %s  [%s]"
        % (label, json.dumps([{k: v for k, v in d.items() if v}
                              for d in per_p]),
           per_frame[0], 2 / sum(per_frame[1:3]),
           ", ".join("%.3f" % t for t in per_frame[1:3]), _frame_bytes(bs),
           enc.stats.mv_covers, enc.stats.message_bits, 100.0 * p8.mean(),
           hist.tolist(), card))
    log("%s stage times of the last P frame, ms, a device sync around "
        "each stage (the frame %.3f s with the syncs): %s  [%s]"
        % (label, per_frame[-1], json.dumps({k: round(1e3 * v, 3) for k, v in
                                             sorted(stages.items(),
                                                    key=lambda kv: -kv[1])}),
           card))
    return {k: sum(d[k] for d in per_p) for k in fns}


_SUB_SMALL = {"cabac_trellis": dict(cabac=True, trellis=1),
              "ref2": dict(ref_frames=2, deblock_device=False),
              "trans8_aq": dict(transform_8x8=True, aq_mode=1)}


def _sub_params(w, h, kw):
    return _params(w, h, True, me_range=4, p4x4=True, em_rate=24, **kw)


def _cpu_sub_job(w, h, n_frames, kw):
    """The cpu half of a phase-37 case, in a worker."""
    return _encode(_sub_params(w, h, kw),
                   sub_motion_clip(w, h, n_frames, seed=31), "cpu")[1]


SUB_SMALL_SHAPE = (128, 96, 5)


def submit_small_sub():
    """The cpu halves of phase 37, submitted to the workers early in the
    run (beside the other small phases'), so that phase 37 does not wait
    behind the full-width phases' decode checks."""
    return {k: _submit(_cpu_sub_job, *SUB_SMALL_SHAPE, kw)
            for k, kw in _SUB_SMALL.items()}


def phase_small_sub(dev, jobs):
    """Phase 37: sub-8x8 partitions at 128x96 on `sub_motion_clip`, cuda ==
    cpu (`jobs`: the cpu halves from `submit_small_sub`)."""
    w, h, n_frames = SUB_SMALL_SHAPE
    frames = sub_motion_clip(w, h, n_frames, seed=31)
    for k, kw in _SUB_SMALL.items():
        enc_g, bs_g = _encode(_sub_params(w, h, kw), frames, dev)
        bs_c = jobs[k].result()
        if bs_g != bs_c:
            raise AssertionError("%dx%d p4x4 %s: cuda (%d B) != cpu (%d B)"
                                 % (w, h, k, len(bs_g), len(bs_c)))
        part, sub = enc_g.last_sub
        log("%dx%d x%d p4x4 %s: cuda stream == cpu stream (%d bytes; the "
            "last P frame %d P_8x8 MBs, %d sub-8x8 blocks)"
            % (w, h, n_frames, k, len(bs_g), int((part == 3).sum()),
               int((sub > 0).sum())))


def reveal_clip(w, h, n, seed=7):
    """bench.py's clip (`synthetic_sequence(w, h, n, seed)`) with an
    occlusion reveal in every P frame, as `tests/test_intra_in_p.py`'s:
    a (h/4 x w/4) patch of new content, 4x4-pixel cells of uniform
    random luma (numpy, from `seed`), at a place that moves each frame,
    so that the plain encoder's intra compare switches MBs to intra."""
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    return _paste_reveals(synthetic_sequence(w, h, n, seed=seed), w, h,
                          np.random.default_rng(seed))


def _plain_decode_job(bs, n_frames, recon):
    """A plain stream (stego off) in a worker: the port's decoder
    reconstructs every frame; each is held against the encoder's planes
    `recon` (decode order). Returns (decode s, the differing pixels and
    the intra MBs (I16x16 + I4x4) of each frame)."""
    from video_steganography_pcamv_torch.decoder import decode_annexb
    t0 = time.time()
    dec = decode_annexb(bs)
    if len(dec) != n_frames:
        raise AssertionError("decoded %d frames of %d" % (len(dec), n_frames))
    differ = [sum(int((getattr(fr, pl) != r[:fr.y.shape[0] // s,
                                            :fr.y.shape[1] // s]).sum())
                  for pl, r, s in zip("yuv", recon[i], (1, 2, 2)))
              for i, fr in enumerate(dec)]
    intra = [sum(m.mb_type in ("I16x16", "I4x4") for m in fr.mbs)
             for fr in dec]
    return time.time() - t0, differ, intra


def _plain_run(dev, card, label, p, frames):
    """One plain (stego-off) encode of `frames` at full width, each frame
    synced and timed: per P frame its seconds, launches, intra MBs and
    `refine_p_intra`'s CUDA-event ms; decoded == recon in a worker.
    Returns (launches per P frame, the IDR's s, P seconds, refine ms)."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import core as TC
    enc = Encoder(p, device=dev)
    fns = _counters()
    refine, seen = TC.refine_p_intra, []

    def timed_refine(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = refine(*a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        kind = out["intra_kind"]
        seen.append((ev[0].elapsed_time(ev[1]), int((kind == 1).sum()),
                     int((kind == 2).sum())))
        return out
    TC.refine_p_intra = timed_refine
    per, secs, recon, bs = [], [], [], b""
    try:
        for f in frames:
            for fn in fns.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs += enc.encode_frame(f)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            per.append({k: fn.launches for k, fn in fns.items()})
            recon.append(tuple(t.cpu().numpy() for t in enc.recon_prev))
    finally:
        TC.refine_p_intra = refine
    if enc._stego is not None or enc.stats.p_frames != len(frames) - 1:
        raise AssertionError("%s: not a plain IPP run" % label)
    if len(seen) != len(frames) - 1 or not all(i16 + i4 for _ms, i16, i4
                                                in seen):
        raise AssertionError("%s: refine_p_intra calls %s: every P frame "
                             "should switch MBs to intra" % (label, seen))

    def report(r):
        secs_d, differ, intra = r
        if any(differ):
            raise AssertionError("%s: decoded frames differ from the recon:"
                                 " %s" % (label, differ))
        if intra[1:] != [i16 + i4 for _ms, i16, i4 in seen]:
            raise AssertionError("%s: decoded intra MBs %s, encoded %s"
                                 % (label, intra[1:], seen))
        log("%s: every decoded frame == the encoder's recon, intra MBs a P "
            "frame %s (decode %.1f s, in a worker)" % (label, intra[1:],
                                                       secs_d))
    _DEFERRED.append((_submit(_plain_decode_job, bs, len(frames), recon),
                      report))
    for i, (t, l, (ms, i16, i4)) in enumerate(zip(secs[1:], per[1:], seen)):
        log("%s: P frame %d %.3f s (%.4f fps), %d I16x16 + %d I4x4 MBs, "
            "refine_p_intra %.1f ms (%.1f%% of the frame); launches %s  [%s]"
            % (label, i + 1, t, 1 / t, i16, i4, ms, ms / 10 / t,
               json.dumps({k: v for k, v in l.items() if v}), card))
    log("%s: IDR %.3f s; P frames %.4f fps; bytes %s"
        % (label, secs[0], (len(frames) - 1) / sum(secs[1:]),
           _frame_bytes(bs)))
    return per[1:], secs[0], secs[1:], [x[0] for x in seen]


def phase_plain(dev, card, w: int = 1920, h: int = 1088):
    """Phase 38: the plain encoder at full width: bench.py's Params with
    stego off (em_rate 0), CAVLC, intra_in_p on, on `reveal_clip`: rd 0
    over IDR + 2 P, then rd 2 over IDR + 1 P. Exact launches a P frame:
    at rd 0 B1, B9, B3 (its mb_cost instance), the fused luma encode and
    B5 once, B4 never; at rd 2 B1 once (the RD re-rank), B9 and B3 four
    times (one a shape), B5 once, B4 never, the luma encode once a shape,
    once for the final encode and once a re-encode of the rd 2 probes.
    Every P frame holds intra MBs; decoded == recon (in a worker).
    Returns the rd 0 run's launches summed over its P frames."""
    frames = reveal_clip(w, h, 3)
    label = "%dx%d plain (stego off), rd 0" % (w, h)
    per, _idr, _secs, _ms = _plain_run(dev, card, label,
                                       _params(w, h, True, em_rate=0), frames)
    one = {"fullpel_parts": 1, "gather_windows8": 1, "subpel": 1,
           "subpel_mb_cost": 1, "luma_p_encode": 1, "deblock_frame": 1}
    for i, l in enumerate(per):
        if l != dict({k: 0 for k in l}, **one):
            raise AssertionError("%s: P frame %d launches %s, want %s"
                                 % (label, i + 1, l, one))
    label2 = "%dx%d plain (stego off), rd 2" % (w, h)
    per2, _idr, _secs, _ms = _plain_run(
        dev, card, label2, _params(w, h, True, em_rate=0, rd=2), frames[:2])
    l2 = per2[0]
    lo = dict({k: 0 for k in l2}, fullpel_parts=1, gather_windows8=4,
              subpel=4, subpel_mb_cost=4, luma_p_encode=l2["luma_p_encode"],
              deblock_frame=1)
    if l2 != lo or not 5 <= l2["luma_p_encode"] <= 11:
        raise AssertionError("%s: launches %s, want %s with the luma encode "
                             "5-11 times" % (label2, l2, lo))
    return {k: sum(l[k] for l in per) for k in per[0]}


# phase 39's option sets: the plain encoder at 112x80 (128x96 for the
# MultiEncoder's streams), each on cuda and on cpu
PLAIN_SMALL = {
    "CAVLC": {}, "CAVLC, tail_kernel=False": dict(tail_kernel=False),
    "CABAC": dict(cabac=True), "rd 1": dict(rd=1),
    "rd 2, trellis 2, CABAC, transform_8x8": dict(rd=2, trellis=2,
                                                 cabac=True,
                                                 transform_8x8=True),
    "ref_frames 2": dict(ref_frames=2), "aq_mode 1": dict(aq_mode=1),
    "16x16 path": dict(partitions=False, deblock_device=False),
    "bframes 2, intra_in_p off": dict(bframes=2, intra_in_p=False)}
PLAIN_SMALL_SHAPE = (112, 80, 3)


def _plain_small_job(name, dev):
    """A phase-39 run on `dev` ("cpu" in a worker): the stream, or for
    "MultiEncoder" the two streams, and the recon of the last frame."""
    if name == "MultiEncoder":
        from video_steganography_pcamv_torch.encoder import multistream as MS
        seqs = [reveal_clip(128, 96, 3, seed=20 + s) for s in range(2)]
        me = MS.MultiEncoder(_params(128, 96, True, me_range=8, em_rate=0),
                             2, devices=[dev])
        return _multi_run(me, seqs, 3)[0]
    w, h, n = PLAIN_SMALL_SHAPE
    kw = dict(PLAIN_SMALL[name])
    tk = kw.pop("tail_kernel", True)
    enc, bs = _encode(_params(w, h, tk, em_rate=0, **kw),
                      reveal_clip(w, h, n, seed=11), dev)
    return bs


def submit_plain_small():
    """The cpu halves of phase 39, submitted to the workers early."""
    return {k: _submit(_plain_small_job, k, "cpu")
            for k in list(PLAIN_SMALL) + ["MultiEncoder"]}


def phase_plain_small(dev, jobs):
    """Phase 39: the plain encoder (stego off) at 112x80 on `reveal_clip`
    for each served option set, and a 2-stream MultiEncoder at 128x96:
    cuda == cpu (`jobs`: the cpu halves from `submit_plain_small`)."""
    for k in list(PLAIN_SMALL) + ["MultiEncoder"]:
        got = _plain_small_job(k, dev)
        want = jobs[k].result()
        if got != want:
            raise AssertionError("plain %s: cuda stream != cpu stream" % k)
        log("plain %s: cuda stream == cpu stream (%s bytes)"
            % (k, [len(b) for b in got] if isinstance(got, list)
               else len(got)))


def _paste_reveals(frames, w, h, g):
    """`reveal_clip`'s occlusion reveal in every frame but the first: a
    (h/4 x w/4) patch of 4x4-pixel cells of uniform random luma (from
    the numpy generator `g`) at a place that moves each frame."""
    ph, pw = (h // 4) & ~15, (w // 4) & ~15
    for f in frames[1:]:
        y0 = int(g.integers(0, (h - ph) // 16 + 1)) * 16
        x0 = int(g.integers(0, (w - pw) // 16 + 1)) * 16
        f.y[y0:y0 + ph, x0:x0 + pw] = np.repeat(np.repeat(
            g.integers(0, 256, (ph // 4, pw // 4)), 4, 0), 4, 1)
    return frames


def plain_sub_clip(w, h, n, seed=21):
    """Phase 36's `sub_motion_clip` (4x4 blocks that move on their own)
    with `reveal_clip`'s patch of new content in every P frame: both the
    sub-8x8 splits and the plain encoder's intra compare have work."""
    return _paste_reveals(sub_motion_clip(w, h, n, seed), w, h,
                          np.random.default_rng(seed))


def _timed_calls(patches, timed):
    """Wrap each (module, attribute) of `patches` so that every call is
    timed with CUDA events (a sync after it) into timed[attribute] as
    (ms, output); returns the originals to restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name in patches]
    for obj, name, real in saved:
        def run(*a, real=real, name=name, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(*a, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            timed.setdefault(name, []).append((ev[0].elapsed_time(ev[1]),
                                               out))
            return out
        setattr(obj, name, run)
    return saved


def _restore(saved):
    for obj, name, real in saved:
        setattr(obj, name, real)


def phase_plain_sub(dev, card, w: int = 1920, h: int = 1088):
    """Phase 40: the plain encoder's sub-8x8 path at full width: bench.py's
    Params with p4x4, em_rate 0 and rd 1 (CAVLC, the intra compare on) on
    `plain_sub_clip`, IDR + 2 P. Per P frame: its seconds (P fps), the
    intra MBs, the P_8x8 share and the sub_mb_type histogram, the
    launches (exactly: B1's sub-unit instance once, the fused luma encode
    9 times: the seven probes of `rd_rerank_sub`, the recomposed P_8x8
    frame and the final encode; B5 once; B3, B4 and B9 never) and the
    CUDA-event ms of `partition.rd_rerank_sub` and `intra.refine_p_intra`;
    decoded == recon, with the same intra MBs, in a worker."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import core as TC
    from video_steganography_pcamv_torch.encoder import partition as PT
    label = "%dx%d plain p4x4, rd 1" % (w, h)
    frames = plain_sub_clip(w, h, 3)
    enc = Encoder(_params(w, h, True, em_rate=0, p4x4=True, rd=1),
                  device=dev)
    fns = _counters()
    timed = {}
    saved = _timed_calls([(PT, "rd_rerank_sub"), (TC, "refine_p_intra")],
                         timed)
    per, secs, recon, subs, bs = [], [], [], [], b""
    try:
        for f in frames:
            for fn in fns.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs += enc.encode_frame(f)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            per.append({k: fn.launches for k, fn in fns.items()})
            recon.append(tuple(t.cpu().numpy() for t in enc.recon_prev))
            subs.append(enc.last_sub)
    finally:
        _restore(saved)
    rr, ri = timed.get("rd_rerank_sub", []), timed.get("refine_p_intra", [])
    if len(rr) != 2 or len(ri) != 2:
        raise AssertionError("%s: rd_rerank_sub %d, refine_p_intra %d calls,"
                             " want 2 each" % (label, len(rr), len(ri)))
    want = dict({k: 0 for k in per[1]}, fullpel_sub=1, luma_p_encode=9,
                deblock_frame=1)
    intra = []
    for i, (l, (part, sub), (ms_r, _), (ms_i, ir)) in enumerate(
            zip(per[1:], subs[1:], rr, ri)):
        if l != want:
            raise AssertionError("%s: P frame %d launches %s, want %s"
                                 % (label, i + 1, l, want))
        kind = ir["intra_kind"].cpu().numpy()
        intra.append(int((kind > 0).sum()))
        if not intra[-1] or not (sub[part == 3] > 0).any():
            raise AssertionError("%s: P frame %d: %d intra MBs, sub types "
                                 "%s" % (label, i + 1, intra[-1],
                                         np.unique(sub[part == 3])))
        t = secs[i + 1]
        log("%s: P frame %d %.3f s (%.4f fps), %d I16x16 + %d I4x4 MBs, "
            "P_8x8 %.1f%% of the MBs, sub_mb_type histogram (8x8, 8x4, "
            "4x8, 4x4) %s; rd_rerank_sub %.1f ms, refine_p_intra %.1f ms "
            "(%.1f%% of the frame); launches %s  [%s]"
            % (label, i + 1, t, 1 / t, int((kind == 1).sum()),
               int((kind == 2).sum()), 100.0 * (part == 3).mean(),
               np.bincount(sub[part == 3].ravel(), minlength=4).tolist(),
               ms_r, ms_i, ms_i / 10 / t,
               json.dumps({k: v for k, v in l.items() if v}), card))
    log("%s: IDR %.3f s; P frames %.4f fps; bytes %s"
        % (label, secs[0], 2 / sum(secs[1:]), _frame_bytes(bs)))

    def report(r):
        secs_d, differ, dec_intra = r
        if any(differ) or dec_intra[1:] != intra:
            raise AssertionError("%s: decoded frames differ from the recon "
                                 "%s, decoded intra MBs %s, encoded %s"
                                 % (label, differ, dec_intra[1:], intra))
        log("%s: every decoded frame == the encoder's recon, intra MBs a P "
            "frame %s (decode %.1f s, in a worker)" % (label, intra, secs_d))
    _DEFERRED.append((_submit(_plain_decode_job, bs, len(frames), recon),
                      report))


def phase_plain_b(dev, card, w: int = 1920, h: int = 1088):
    """Phase 41: intra MBs in B slices at full width: bench.py's Params
    with em_rate 0, bframes 2, b_adapt 0, partitions and CAVLC on
    `reveal_clip` (its patch is new in every frame, so the B frames hold
    content neither anchor has), frames I B B P. Per B frame: its
    seconds (B fps), the intra MBs, the MBs that the dependant rule kept
    inter (under spatial direct, the neighbours A-D of a direct MB), the
    launches (B1 twice: L0 and L1, B9 and B3 twice, the fused luma encode
    once, B4 and B5 never) and the CUDA-event ms of `Encoder._b_intra`
    (`refine_p_intra` and the dependant mask); decoded == recon for
    every frame, B frames included, in a worker."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import core as TC
    label = "%dx%d plain B frames" % (w, h)
    frames = reveal_clip(w, h, 4, seed=13)
    enc = Encoder(_params(w, h, True, em_rate=0, bframes=2, b_adapt=0),
                  device=dev)
    fns = _counters()
    recon, rows, bs = {}, [], b""
    real_psnr, real_b, real_intra = (enc._accumulate_psnr,
                                     enc._encode_b_frame, enc._b_intra)

    def keep(frame, y, u, v, recon_=None):
        r = recon_ or enc.recon_prev
        recon[id(frame)] = tuple(t.cpu().numpy() for t in r)
        return real_psnr(frame, y, u, v, recon_)

    def b_intra(y, u, v, res, code, subs, inter_cost, spatial, qp, lam):
        direct = code == 0
        if subs is not None:
            direct |= (code == 22) & (subs == 0).any(-1)
        dep = TC._neighbour_deps(direct) if spatial else direct & False
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_intra(y, u, v, res, code, subs, inter_cost, spatial, qp,
                         lam)
        ev[1].record()
        torch.cuda.synchronize()
        kind = out[1]
        rows[-1].update(intra_ms=ev[0].elapsed_time(ev[1]),
                        i16=int((kind == 1).sum()), i4=int((kind == 2).sum()),
                        kept=int(dep.sum()), direct=int(direct.sum()))
        return out

    def encode_b(*a, **kw):
        for fn in fns.values():
            fn.launches = 0
        rows.append({})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_b(*a, **kw)
        torch.cuda.synchronize()
        rows[-1].update(s=time.perf_counter() - t0,
                        launches={k: fn.launches for k, fn in fns.items()})
        return out
    enc._accumulate_psnr = lambda frame, y, u, v, recon=None: keep(
        frame, y, u, v, recon)
    enc._encode_b_frame, enc._b_intra = encode_b, b_intra
    t0 = time.perf_counter()
    for f in frames:
        bs += enc.encode_frame(f)
    bs += enc.flush()
    wall = time.perf_counter() - t0
    if enc.stats.b_frames != 2 or len(rows) != 2:
        raise AssertionError("%s: %d B frames" % (label, enc.stats.b_frames))
    want = dict({k: 0 for k in fns}, fullpel_parts=2, gather_windows8=2,
                subpel=2, luma_p_encode=1)
    for i, r in enumerate(rows):
        if r["launches"] != want or not r["i16"] + r["i4"]:
            raise AssertionError("%s: B frame %d launches %s (want %s), "
                                 "%d intra MBs" % (label, i, r["launches"],
                                                   want, r["i16"] + r["i4"]))
        log("%s: B frame %d %.3f s (%.4f fps), %d I16x16 + %d I4x4 MBs, %d "
            "direct MBs, %d MBs kept inter as their dependants; _b_intra "
            "%.1f ms (%.1f%% of the frame); launches %s  [%s]"
            % (label, i + 1, r["s"], 1 / r["s"], r["i16"], r["i4"],
               r["direct"], r["kept"], r["intra_ms"],
               r["intra_ms"] / 10 / r["s"],
               json.dumps({k: v for k, v in r["launches"].items() if v}),
               card))
    log("%s: 4 frames %.3f s; B frames %.4f fps; bytes %s"
        % (label, wall, 2 / sum(r["s"] for r in rows), _frame_bytes(bs)))
    want_intra = [rows[0]["i16"] + rows[0]["i4"],
                  rows[1]["i16"] + rows[1]["i4"]]

    def report(r):
        secs_d, differ, dec_intra = r
        if any(differ) or dec_intra[1:3] != want_intra:
            raise AssertionError("%s: decoded frames differ from the recon "
                                 "%s; decoded intra MBs %s, the B frames' "
                                 "%s" % (label, differ, dec_intra,
                                         want_intra))
        log("%s: every decoded frame (B frames included) == the encoder's "
            "recon, intra MBs a frame in display order %s (decode %.1f s, "
            "in a worker)" % (label, dec_intra, secs_d))
    _DEFERRED.append((_submit(_plain_decode_job, bs, len(frames),
                              [recon[id(f)] for f in frames]), report))


# phase 42's option sets: stego off with p4x4 and with intra MBs in B
# slices at 112x80, each on cuda and on cpu
PLAIN_SB_SMALL = {
    "p4x4, rd 0, CAVLC": dict(p4x4=True),
    "p4x4, rd 1": dict(p4x4=True, rd=1),
    "p4x4, rd 2, trellis 2, CABAC, transform_8x8": dict(
        p4x4=True, rd=2, trellis=2, cabac=True, transform_8x8=True),
    "p4x4, ref_frames 2, host deblock": dict(p4x4=True, ref_frames=2,
                                             deblock_device=False),
    "p4x4, aq_mode 1": dict(p4x4=True, aq_mode=1),
    "B, partitions, CAVLC": dict(bframes=2, b_adapt=0),
    "B, partitions, CABAC": dict(bframes=2, b_adapt=0, cabac=True),
    "B, 16x16 path": dict(bframes=2, b_adapt=0, partitions=False,
                          deblock_device=False),
    "B, temporal direct": dict(bframes=2, b_adapt=0, direct=2),
    "B, b_pyramid": dict(bframes=3, b_adapt=0, b_pyramid=True),
    "B, ref_frames 2": dict(bframes=2, b_adapt=0, ref_frames=2),
    "B, transform_8x8": dict(bframes=2, b_adapt=0, transform_8x8=True),
    "B, p4x4 anchors": dict(bframes=2, b_adapt=0, p4x4=True)}
PLAIN_SB_SHAPE = (112, 80, 5)


def _plain_sb_job(name, dev):
    """A phase-42 run on `dev` ("cpu" in a worker): the stream and the
    intra MBs its decoder reads in each frame."""
    from video_steganography_pcamv_torch.decoder import decode_annexb
    w, h, n = PLAIN_SB_SHAPE
    kw = PLAIN_SB_SMALL[name]
    frames = (plain_sub_clip(w, h, n, seed=23) if kw.get("p4x4")
              else reveal_clip(w, h, n, seed=17))
    _enc, bs = _encode(_params(w, h, True, em_rate=0, **kw), frames, dev)
    if dev != "cpu":
        return bs, None
    return bs, [sum(m.mb_type in ("I16x16", "I4x4") for m in fr.mbs)
                for fr in decode_annexb(bs)]


def submit_plain_sb_small():
    """The cpu halves of phase 42, submitted to the workers early."""
    return {k: _submit(_plain_sb_job, k, "cpu") for k in PLAIN_SB_SMALL}


def phase_plain_sb_small(dev, jobs):
    """Phase 42: stego off with sub-8x8 partitions (rd 0 CAVLC, rd 1, rd 2
    with trellis 2, CABAC and transform_8x8, ref_frames 2 on the host
    deblock, aq_mode 1) on `plain_sub_clip` and with intra MBs in B
    slices (the partition path under CAVLC and CABAC, the 16x16 path,
    temporal direct, b_pyramid, ref_frames 2, transform_8x8, p4x4
    anchors) on `reveal_clip`, at 112x80 over 5 frames: cuda == cpu
    (`jobs`: the cpu halves from `submit_plain_sb_small`), and intra MBs
    in the decoded frames wherever the intra compare runs (not under
    AQ)."""
    for k in PLAIN_SB_SMALL:
        got, _ = _plain_sb_job(k, dev)
        want, intra = jobs[k].result()
        if got != want:
            raise AssertionError("plain %s: cuda stream != cpu stream" % k)
        if ("aq_mode" in PLAIN_SB_SMALL[k]) == any(intra[1:]):
            raise AssertionError("plain %s: intra MBs a frame %s" % (k, intra))
        log("plain %s: cuda stream == cpu stream (%d bytes; intra MBs a "
            "frame in display order %s)" % (k, len(got), intra))


# tools/bench_streams.py's Params (BASELINE config 5's serving setup)
STREAMS_KW = dict(qp=26, me_range=16, keyint_max=250, scenecut_threshold=0,
                  psnr=False, deblock_device=True)


def _streams_params(w, h, tail_kernel=True):
    from video_steganography_pcamv_torch.params import Params, StegoParams
    p = Params(width=w, height=h, stego=StegoParams(em_rate=64, key=3),
               **STREAMS_KW)
    p.tail_kernel = tail_kernel
    return p


def _multi_run(me, seqs, n_steps):
    """Drive a multi-stream encoder `n_steps` steps (plus `flush` where
    it has one); returns (the streams, each step's synced seconds)."""
    streams, secs = [b""] * me.S, []
    # a worker process runs the cpu half and never touches the card
    on_card = me.encs[0].device.type == "cuda"
    for t in range(n_steps):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = me.encode_step([sq[t] for sq in seqs])
        if t == n_steps - 1 and hasattr(me, "flush"):
            chunks = [a + b for a, b in zip(chunks, me.flush())]
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        streams = [a + b for a, b in zip(streams, chunks)]
    return streams, secs


def _pipeline_inputs(w, h, dev, seed=7):
    """A frame pair as the steps take it: the current planes, the
    previous frame's planes as the reference's recon, `mc.build_ref`."""
    from video_steganography_pcamv_torch.ops import mc as TMC
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    f0, f1 = synthetic_sequence(w, h, 2, seed=seed)
    planes = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
              for a in (f1.y, f1.u, f1.v, f0.y, f0.u, f0.v)]
    ref = TMC.build_ref(*planes[3:])
    return planes, ref


def _outputs_equal(label, got, want):
    if sorted(got) != sorted(want):
        raise AssertionError("%s: keys %s != %s" % (label, sorted(got),
                                                    sorted(want)))
    for k in want:
        a, b = got[k].cpu(), want[k].cpu()
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("%s: %s differs" % (label, k))


def _small_multi_job(cls_name, tail_kernel, dev, keep=False):
    """Phase 35's run of the multi-stream encoder `cls_name` (two 128x96
    streams, IDR + 3 P, seeds 20 + s) on `dev`: its streams (and with
    `keep` the encoder)."""
    from video_steganography_pcamv_torch.encoder import multistream as MS
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    seqs = [synthetic_sequence(128, 96, 4, seed=20 + s) for s in range(2)]
    me = getattr(MS, cls_name)(_streams_params(128, 96, tail_kernel), 2,
                               devices=[dev])
    streams, _ = _multi_run(me, seqs, 4)
    return (streams, me) if keep else streams


def phase_small_multi(dev):
    """Phase 35: the multi-stream and tile layers at 128x96 (the tiled
    step at 96x192, 12 MB rows), cuda == cpu: MultiEncoder's two streams
    on both tail_kernel settings and PipelinedMultiEncoder's, byte-equal
    and read by the port's decoder and extractor; p_frame_step and
    p_frame_step_parts (with stego) and the tiled step on [cuda:0] * 4
    tiles, equal outputs."""
    from video_steganography_pcamv_torch.models import pipeline as TPL
    from video_steganography_pcamv_torch.parallel import tile as TTL
    runs = [(cls, tail_kernel) for cls, tks in (
        ("MultiEncoder", (True, False)), ("PipelinedMultiEncoder", (True,)))
        for tail_kernel in tks]
    # the cpu runs in the worker processes meanwhile
    cpu_jobs = [_submit(_small_multi_job, cls, tk, "cpu")
                for cls, tk in runs]
    for (name, tail_kernel), job in zip(runs, cpu_jobs):
        got, me = _small_multi_job(name, tail_kernel, dev, keep=True)
        want = job.result()
        if got != want:
            raise AssertionError("128x96 %s, tail_kernel=%s: cuda streams "
                                 "!= cpu streams" % (name, tail_kernel))
        label = "128x96 %s x2, tail_kernel=%s" % (name, tail_kernel)
        for s, (bs, e) in enumerate(zip(got, me.encs)):
            _defer_payload("%s stream %d" % (label, s), bs, e, 4)
        log("%s: cuda streams == cpu streams (%s bytes)"
            % (label, [len(b) for b in got]))
    for step in ("p_frame_step", "p_frame_step_parts"):
        res = []
        for d in (dev, torch.device("cpu")):
            planes, ref = _pipeline_inputs(128, 96, d)
            prev = torch.zeros((6, 8, 2), dtype=torch.int32, device=d)
            res.append(getattr(TPL, step)(
                *planes[:3], ref["luma"], ref["u"], ref["v"], prev, qp=26,
                qpc=26, mbh=6, mbw=8, rng=16, lam=4))
        _outputs_equal("128x96 " + step, *res)
    res = []
    for devs in ([dev] * 4, [torch.device("cpu")] * 4):
        planes, _ref = _pipeline_inputs(96, 192, devs[0], seed=3)
        TTL.halo_log.clear()
        res.append(TTL.p_frame_step_tiled(
            devs, *planes, torch.zeros((12, 6, 2), dtype=torch.int32),
            qp=28, qpc=28, mbh=12, mbw=6, rng=8, lam=4))
        if len(TTL.halo_log) != 6:
            raise AssertionError("96x192 tiled step: %d halo transfers"
                                 % len(TTL.halo_log))
    _outputs_equal("96x192 tiled step", *res)
    log("128x96 p_frame_step, p_frame_step_parts and the 96x192 tiled step "
        "over 4 tiles (6 halo transfers): cuda outputs == cpu outputs")


def phase_config5(dev, card, n_streams: int = 8, n_steps: int = 3):
    """Phase 32: BASELINE config 5, `n_streams` concurrent 1920x1088
    streams through MultiEncoder (tools/bench_streams.py's Params,
    tail_kernel=True, synthetic_sequence seeds 40 + s), IDR + 2 P steps.
    Exact launches of each P step: B1, B9, B3, B4 and B5 once a stream,
    the fused luma encode twice a stream (pass 1 and the full pass 2),
    no other kernel; every stream's payload recovered by the port's
    extractor and, for streams 0 and the last, every decoded frame equal
    to the encoder's recon (in the workers). Prints the IDR step's
    seconds and the aggregate and per-stream P fps."""
    from video_steganography_pcamv_torch.encoder.multistream import (
        MultiEncoder)
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    S = n_streams
    label = "config 5 (%d x 1920x1088, MultiEncoder)" % S
    seqs = [synthetic_sequence(1920, 1088, n_steps, seed=40 + s)
            for s in range(S)]
    me = MultiEncoder(_streams_params(1920, 1088), S, devices=[dev])
    fns = _counters()
    per_step, secs = [], []
    streams = [b""] * S
    recons = {0: {}, S - 1: {}}
    for t in range(n_steps):
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks = me.encode_step([sq[t] for sq in seqs])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append({k: fn.launches for k, fn in fns.items()})
        streams = [a + b for a, b in zip(streams, chunks)]
        for s, rec in recons.items():
            rec[t] = tuple(x.cpu().numpy() for x in me.encs[s].recon_prev)
    want_p = {k: 0 for k in fns}
    want_p.update(fullpel_parts=S, gather_windows8=S, analyse_tail=S,
                  deblock_frame=S, luma_p_encode=2 * S)
    for t, got in enumerate(per_step[1:], 1):
        if got != want_p:
            raise AssertionError("%s: P step %d launches %s, want %s"
                                 % (label, t, got, want_p))
    if per_step[0]["deblock_frame"] != S:
        raise AssertionError("%s: the IDR step deblocked %d frames"
                             % (label, per_step[0]["deblock_frame"]))
    for s, (bs, e) in enumerate(zip(streams, me.encs)):
        rec = recons.get(s)

        def report(r, s=s, rec=rec):
            bits, secs_, differ, _kinds = r
            if rec is not None and any(differ.values()):
                raise AssertionError("%s stream %d: decoded frames differ "
                                     "from the recon: %s" % (label, s,
                                                             differ))
            log("%s stream %d: %d payload bits recovered%s (decode + "
                "extraction %.1f s, in a worker)"
                % (label, s, bits, ", every decoded frame == the encoder's "
                   "recon" if rec is not None else "", secs_))
        _defer(report, bs, n_steps, e._stego.sent_messages, rec)
    n_p = n_steps - 1
    fps = S * n_p / sum(secs[1:])
    log("%s: IDR step %.3f s (%.3f s a stream); P steps %s s; aggregate P "
        "%.4f fps, per stream %.4f fps; bytes per stream %s; launches per "
        "P step %s  [%s]"
        % (label, secs[0], secs[0] / S, ["%.4f" % x for x in secs[1:]], fps,
           fps / S, [len(b) for b in streams], json.dumps(per_step[-1]),
           card))
    return fps


def phase_pipelined_multi(dev, card, n_frames: int = 4):
    """Phase 33: PipelinedMultiEncoder, 2 streams at 1920x1088, IDR + 3 P
    (tools/bench_streams.py's Params and seeds): every payload recovered
    (in the workers); the aggregate P fps beside phase 6's single-stream
    P fps of this run."""
    from video_steganography_pcamv_torch.encoder.multistream import (
        PipelinedMultiEncoder)
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    S = 2
    label = "PipelinedMultiEncoder (%d x 1920x1088)" % S
    seqs = [synthetic_sequence(1920, 1088, n_frames, seed=40 + s)
            for s in range(S)]
    me = PipelinedMultiEncoder(_streams_params(1920, 1088), S, devices=[dev])
    streams, secs = _multi_run(me, seqs, n_frames)
    for s, (bs, e) in enumerate(zip(streams, me.encs)):
        _defer(lambda r, s=s: log("%s stream %d: %d payload bits recovered "
                                  "(decode + extraction %.1f s, in a "
                                  "worker)" % (label, s, r[0], r[1])),
               bs, n_frames, e._stego.sent_messages)
    fps = S * (n_frames - 1) / sum(secs[1:])
    log("%s: IDR step %.3f s; aggregate P %.4f fps incl. flush (per stream "
        "%.4f); phase 6's single-stream P %.4f fps  [%s]"
        % (label, secs[0], fps, fps / S, P_FPS.get("6", float("nan")),
           card))
    return fps


def phase_pipeline_tile(dev, card):
    """Phase 34: models/pipeline.py and parallel/tile.py at 1920x1088 on
    a real frame pair: p_frame_step (B6 and B7 once, the fused luma encode
    twice: the encode and the stego costs' 13-version probe batch) and
    p_frame_step_parts (B1, B9, B3, B4 and the luma encode once), each
    timed; the tiled step over 4 tiles on cuda:0 (17 MB rows a tile)
    equal key by key to the untiled p_frame_step_parts on the same
    inputs with the zero predictor, its halo log 2 * 3 packed transfers
    of mc.PAD luma and mc.PAD chroma rows, and B1 launched once a tile."""
    from video_steganography_pcamv_torch.models import pipeline as TPL
    from video_steganography_pcamv_torch.ops import mc as TMC
    from video_steganography_pcamv_torch.parallel import tile as TTL
    planes, ref = _pipeline_inputs(1920, 1088, dev)
    prev = torch.zeros((MBH, MBW, 2), dtype=torch.int32, device=dev)
    kw = dict(qp=26, qpc=26, mbh=MBH, mbw=MBW, rng=16, lam=4)
    fns = _counters()
    want = {"p_frame_step": dict(fullpel_search16=1, gather_windows=1,
                                 luma_p_encode=2),
            "p_frame_step_parts": dict(fullpel_parts=1, gather_windows8=1,
                                       analyse_tail=1, luma_p_encode=1)}
    outs, ms = {}, {}
    for step, w in want.items():
        fn = getattr(TPL, step)
        for c in fns.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[step] = fn(*planes[:3], ref["luma"], ref["u"], ref["v"], prev,
                        **kw)
        torch.cuda.synchronize()
        ms[step] = 1e3 * (time.perf_counter() - t0)
        got = {k: c.launches for k, c in fns.items() if c.launches}
        if got != w:
            raise AssertionError("1080p %s: launches %s, want %s"
                                 % (step, got, w))
    for c in fns.values():
        c.launches = 0
    TTL.halo_log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled = TTL.p_frame_step_tiled([dev] * 4, *planes, prev, **kw)
    torch.cuda.synchronize()
    ms["tiled x4"] = 1e3 * (time.perf_counter() - t0)
    _outputs_equal("1080p tiled step", tiled, outs["p_frame_step_parts"])
    want_log = sorted([(i, i + 1, TMC.PAD, TMC.PAD) for i in range(3)]
                      + [(i + 1, i, TMC.PAD, TMC.PAD) for i in range(3)])
    if sorted(TTL.halo_log) != want_log or fns["fullpel_parts"].launches != 4:
        raise AssertionError("1080p tiled step: halo log %s, B1 launched %d"
                             % (TTL.halo_log, fns["fullpel_parts"].launches))
    log("1080p p_frame_step, p_frame_step_parts, tiled step over 4 tiles "
        "on cuda:0 (== untiled, %d halo transfers of %d luma + %d chroma "
        "rows): ms %s (one synced call each, first call)  [%s]"
        % (len(TTL.halo_log), TMC.PAD, TMC.PAD,
           json.dumps({k: round(v, 3) for k, v in ms.items()}), card))


def phase_b16(dev, card, n_frames: int = 7):
    """The 16x16-only path with B frames at 1080p (partitions=False,
    deblock_device=False, bframes 2, b_adapt 2, rc_lookahead 4, CAVLC,
    one reference) on phase 22's clip and stego (`phase_bpath`): B6 and
    B7 per list on every B frame, the B slices through the native
    write_slice_b."""
    from video_steganography_pcamv_torch.params import StegoParams
    p = _params(1920, 1088, True, partitions=False, bframes=2, b_adapt=2,
                rc_lookahead=4, stego=StegoParams(em_rate=64, key=5))
    phase_bpath(dev, card, "1080p 16x16 path, bframes 2, b_adapt 2", p,
                n_frames, recon_equal=False)


def phase_bpath(dev, card, label, p, n_frames, want_pb=None,
                recon_equal=True, want_brefs=None, want_direct=None,
                anchors=False):
    """One B-frame configuration at 1080p on bench_c4's clip
    (synthetic_sequence seed 9), IDR + n_frames - 1 + flush. Every
    kernel call of the B frames is held against its plain version on the
    card (array-equal); each B frame launches, per list and L0 entry, B1
    on the partition path (then B9 and B3' once per list) or B6 and B7
    on the 16x16 path, the fused luma encode once and no other kernel;
    the payload is recovered through the port's decoder, whose B frames
    equal the encoder's recon (`recon_equal`; else the differing pixels
    are counted and printed), in a worker process (`_defer`). want_pb: the (P, B) frame counts, and
    want_brefs the display indices of the reference B frames and
    want_direct the direct mode of each B slice in decode order, checked
    when given. P and B fps (the B frames' kernel checks excluded), the
    IDR's seconds, bytes per frame with its slice type, the launches per
    B frame, each B frame's MB types and the B writer's ms per B frame
    are printed. With `anchors` (one reference, partitions, trellis or
    the 8x8 transform) the anchors are held too: every call of the fused
    luma encode in a P anchor against its plain version, each P anchor's
    launches (B1, B9, B3, B4 once, the luma encode twice: pass 1 and the
    full pass 2, B5 once), their decoded frames against the encoder's
    recon; the trellis's ms per frame (CUDA events around each
    `trellis_quant` call, no sync) and the launches per frame type are
    printed, and under the 8x8 transform the run must code I8x8 and
    trans8 MBs. Returns the launches and the writer's ms per B frame."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import bslice as BS
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    refs = p.ref_frames
    frames = synthetic_sequence(1920, 1088, n_frames, seed=9)
    enc = Encoder(p, device=dev)
    fns = _counters()
    rows, per_b, recon, write_ms = [], [], {}, []
    state = {"check": False, "checked": {}, "check_s": 0.0}
    twins = _b_kernel_twins()
    saved = {name: getattr(BS, name) for name in twins}
    # the fused luma encode's entry on this path: levels in under trellis
    lp = "luma_p_encode_levels" if p.trellis else "luma_p_encode"
    state.update(anchor=False, frame=None, checked_anchor={})
    per_a, tr_events = [], []

    def checked(name, fn):
        def wrap(*a, **kw):
            out = fn(*a, **kw)
            if state["check"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = twins[name](*a, **kw)
                if not _equal_outputs(out, want):
                    raise AssertionError("%s: B frame %d: %s kernel != plain"
                                         % (label, len(per_b), name))
                torch.cuda.synchronize()
                state["check_s"] += time.perf_counter() - t0
                state["checked"][name] = state["checked"].get(name, 0) + 1
            return out
        return wrap

    enc_b = BS.encode_b_frame_device

    def encode_b(*a, **kw):
        out = enc_b(*a, **kw)
        recon["last"] = tuple(out[k].cpu().numpy()
                              for k in ("recon_y", "recon_u", "recon_v"))
        return out

    anchor, bframe = enc._encode_anchor, enc._encode_b_frame

    def timed_anchor(f, y, u, v, is_idr, satd, disp):
        before = {k: fn.launches for k, fn in fns.items()}
        state["frame"] = ("I" if is_idr else "P", disp)
        state["anchor"], state["check_s"] = anchors, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = anchor(f, y, u, v, is_idr, satd, disp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - state["check_s"]
        state["anchor"] = False
        per_a.append((state["frame"][0], {k: fn.launches - before[k]
                                          for k, fn in fns.items()}))
        rows.append(("I" if is_idr else "P", disp, len(out), dt))
        if anchors:
            recon[disp] = tuple(t.cpu().numpy() for t in enc.recon_prev)
        return out

    def anchor_luma(*a, **kw):
        out = LP.luma_p_encode(*a, **kw)
        if state["anchor"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = LP.luma_p_encode_plain(*a, **kw)
            if not _equal_outputs([t for t in out if t is not None],
                                  [t for t in want if t is not None]):
                raise AssertionError("%s: anchor %s: luma_p_encode kernel "
                                     "!= plain" % (label, state["frame"]))
            torch.cuda.synchronize()
            state["check_s"] += time.perf_counter() - t0
            key = lp if kw.get("levels") is not None else "luma_p_encode"
            ca = state["checked_anchor"]
            ca[key] = ca.get(key, 0) + 1
        return out

    def timed_trellis(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = trellis_quant(*a, **kw)
        e1.record()
        tr_events.append((state["frame"], e0, e1))
        return out

    def timed_b(f, y, u, v, l0, ref_l1, col, satd, disp, *a, **kw):
        before = {k: fn.launches for k, fn in fns.items()}
        state["frame"] = ("B", disp)
        state["check"], state["check_s"] = True, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bframe(f, y, u, v, l0, ref_l1, col, satd, disp, *a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 - state["check_s"]
        state["check"] = False
        per_b.append({k: fn.launches - before[k] for k, fn in fns.items()})
        nal, ref = out   # ref: a reference B's planes and fields, or None
        if ref is not None:
            brefs.append(disp)
        rows.append(("B", disp, len(nal), dt))
        recon[disp] = recon.pop("last")
        return out

    def direct_mode(*a, **kw):
        out = dmode(*a, **kw)
        direct.append("spatial" if out[0] else
                      "none" if p.direct == 0 else "temporal")
        return out

    def auto_score(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = auto(*a, **kw)
        torch.cuda.synchronize()
        auto_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def timed_writer(fn):
        def wrap(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            write_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return wrap

    direct, auto_ms, brefs = [], [], []
    dmode, auto = enc._direct_mode, enc._direct_auto_score
    enc._direct_mode, enc._direct_auto_score = direct_mode, auto_score
    enc._encode_anchor, enc._encode_b_frame = timed_anchor, timed_b
    for name in ("_write_b_slice_cavlc", "_write_b_slice_cabac"):
        setattr(enc, name, timed_writer(getattr(enc, name)))
    BS.encode_b_frame_device = encode_b
    for name, fn in saved.items():
        setattr(BS, name, checked(name, fn))
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import trellis as TR
    lp_mod, trellis_quant = INTER.LP, TR.trellis_quant
    if anchors:
        # the P encodes reach the luma kernel through `inter.LP`; the
        # kernel wrapper keeps its own name (it counts on it)
        import types
        INTER.LP = types.SimpleNamespace(**dict(vars(LP),
                                                luma_p_encode=anchor_luma))
        TR.trellis_quant = timed_trellis
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.time()
        bs = b""
        for f in frames:
            bs += enc.encode_frame(f)
        bs += enc.flush()
        torch.cuda.synchronize()
        t_all = time.time() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
    finally:
        BS.encode_b_frame_device = enc_b
        for name, fn in saved.items():
            setattr(BS, name, fn)
        INTER.LP, TR.trellis_quant = lp_mod, trellis_quant
    n_b, n_p = enc.stats.b_frames, enc.stats.p_frames
    if n_b < 1 or n_p < 1 or (want_pb and (n_p, n_b) != want_pb):
        raise AssertionError("%s: %d P, %d B frames, want %s"
                             % (label, n_p, n_b, want_pb or ">= 1 each"))
    if want_brefs is not None and brefs != want_brefs:
        raise AssertionError("%s: reference B frames %s, want %s"
                             % (label, brefs, want_brefs))
    if want_direct is not None and direct != want_direct:
        raise AssertionError("%s: direct modes %s, want %s"
                             % (label, direct, want_direct))
    if p.partitions:
        want_b = {"fullpel_parts": refs + 1, "gather_windows8": 2,
                  "subpel": 2, lp: 1}
        whole = ("fullpel_parts", "gather_windows8", "subpel",
                 "analyse_tail", lp, "deblock_frame")
    else:
        want_b = {"fullpel_search16": refs + 1, "gather_windows": refs + 1,
                  lp: 1}
        whole = ("fullpel_search16", "gather_windows", lp, "deblock_frame")
    want_checked = {("luma_p_encode" if k == lp else k): n * n_b
                    for k, n in want_b.items()}
    if state["checked"] != want_checked:
        raise AssertionError("%s: B frame kernel calls checked: %s"
                             % (label, state["checked"]))
    want_all = {k: 0 for k in fns}
    want_all.update(want_b)
    for i, got in enumerate(per_b):
        if got != want_all:
            raise AssertionError("%s: B frame %d launches %s, want %s"
                                 % (label, i, got, want_all))
    for k in whole:
        if launches[k] < 1:
            raise AssertionError("%s: %s never launched" % (label, k))
    if len(write_ms) != n_b:
        raise AssertionError("%s: %d B writes for %d B frames"
                             % (label, len(write_ms), n_b))
    if anchors:
        _check_anchors(label, p, fns, lp, per_a, state["checked_anchor"],
                       n_p, enc)
    def report(res):
        bits, t_dec, differ, kinds = res
        if sorted(differ) != sorted(recon):
            raise AssertionError("%s: decoded frames %s, coded %s"
                                 % (label, sorted(differ), sorted(recon)))
        if recon_equal and any(differ.values()):
            raise AssertionError("%s: decoded frames != encoder recon, "
                                 "pixels %s" % (label, differ))
        log("%s: %d payload bits recovered (decode + extraction %.1f s, in "
            "a worker); decoded %s vs the encoder's recon: pixels "
            "differing per display index %s; MB types per B frame (display "
            "index): %s" % (label, bits, t_dec,
                            "frames" if anchors else "B frames",
                            json.dumps(differ), json.dumps(kinds)))
    _defer(report, bs, n_frames, enc._stego.sent_messages, recon)
    sec = {t: [r[3] for r in rows if r[0] == t] for t in "IPB"}
    log("%s: %d frames (%d I, %d P, %d B), %d bytes, decoded in a worker; "
        "IDR %.3f s; P frames %.4f fps, B frames %.4f fps (each call "
        "synced); all %.4f fps incl. flush  [%s]"
        % (label, len(frames), enc.stats.i_frames, n_p, n_b, len(bs),
           sec["I"][0], len(sec["P"]) / sum(sec["P"]),
           len(sec["B"]) / sum(sec["B"]), len(frames) / t_all, card))
    by_type = {t: [r[2] for r in rows if r[0] == t] for t in "IPB"}
    log("%s: bytes per frame, decode order (type, display index, bytes): "
        "%s; by slice type %s; B bytes / P bytes %.4f; frames coded as B "
        "(display index) %s"
        % (label, [(t, d, b) for t, d, b, _ in rows],
           json.dumps({t: sum(v) for t, v in by_type.items()}),
           np.mean(by_type["B"]) / np.mean(by_type["P"]),
           sorted(r[1] for r in rows if r[0] == "B")))
    log("%s: launches per B frame (each B frame alike): %s; whole run: %s; "
        "B frame seconds %s; P frame seconds %s; B write ms %s"
        % (label, json.dumps({k: v for k, v in per_b[0].items() if v}),
           json.dumps(launches), ["%.3f" % x for x in sec["B"]],
           ["%.3f" % x for x in sec["P"]], ["%.3f" % x for x in write_ms]))
    if anchors:
        torch.cuda.synchronize()
        tr_ms = collections.defaultdict(float)
        for fk, e0, e1 in tr_events:
            tr_ms[fk] += e0.elapsed_time(e1)
        by = {t: [tr_ms[k] for k in sorted(tr_ms, key=lambda k: k[1])
                  if k[0] == t] for t in "IPB"}
        log("%s: trellis ms per frame (CUDA events around each "
            "trellis_quant call, %d calls), I %s, P %s (median %.2f), B %s "
            "(median %.2f)  [%s]"
            % (label, len(tr_events), ["%.2f" % x for x in by["I"]],
               ["%.2f" % x for x in by["P"]], float(np.median(by["P"])),
               ["%.2f" % x for x in by["B"]], float(np.median(by["B"])),
               card))
        log("%s: launches per frame type: I %s, P %s, B %s; I8x8 MBs %d, "
            "trans8 P MBs %d"
            % (label, json.dumps({k: v for k, v in per_a[0][1].items()
                                  if v}),
               json.dumps({k: v for k, v in per_a[1][1].items() if v}),
               json.dumps({k: v for k, v in per_b[0].items() if v}),
               enc.stats.i8x8_mbs, enc.stats.trans8_mbs))
    if brefs or p.direct != 1:
        log("%s: reference B frames (display index) %s; direct mode per B "
            "slice, decode order %s; the direct-auto score's extra dispatch "
            "ms per B frame %s; final score (temporal, spatial) %s"
            % (label, brefs, direct, ["%.3f" % x for x in auto_ms],
               enc._direct_score))
    return launches, write_ms


class _InstanceLaunches:
    """One of a wrapper's other counters as a counter like the wrappers:
    the fused luma encode's `levels_launches` (the levels-in entry, under
    trellis), `nr_launches` (the noise-reduction instance, each launch
    also one of `luma_p_encode.launches`) or `grid_launches` (the per-MB
    qp instances of either entry, adaptive quantization), or B3's
    `subpel.cost_launches` (its mb_cost instance, stego off; each launch
    also one of `subpel.launches`)."""

    def __init__(self, attr: str, owner: str = "luma"):
        self.attr = attr
        self.owner = owner

    def _fn(self):
        from video_steganography_pcamv_torch.ops import lumap as LP
        from video_steganography_pcamv_torch.ops import probe as PR
        return LP.luma_p_encode if self.owner == "luma" else PR.subpel

    @property
    def launches(self):
        return getattr(self._fn(), self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self._fn(), self.attr, n)


def _check_anchors(label, p, fns, lp, per_a, checked, n_p, enc):
    """`phase_bpath`'s anchor checks (one reference, partitions, trellis
    or the 8x8 transform: pass 2 is always a full re-encode): the IDR
    launches B5 alone, each P anchor B1, B9, B3, B4 and B5 once and the
    fused luma encode twice, every luma call of the P anchors was held
    against its plain version, and under the 8x8 transform I8x8 and
    trans8 MBs were coded."""
    if not (p.ref_frames == 1 and p.partitions
            and (p.trellis or p.transform_8x8)):
        raise ValueError("%s: the anchor checks need one reference, "
                         "partitions and trellis or transform_8x8" % label)
    want = {"I": {k: 0 for k in fns}, "P": {k: 0 for k in fns}}
    want["I"]["deblock_frame"] = 1
    want["P"].update({"fullpel_parts": 1, "gather_windows8": 1,
                      "analyse_tail": 1, lp: 2,
                      "deblock_frame": 1})
    for i, (t, got) in enumerate(per_a):
        if got != want[t]:
            raise AssertionError("%s: anchor %d (%s) launches %s, want %s"
                                 % (label, i, t, got, want[t]))
    if checked != {lp: 2 * n_p}:
        raise AssertionError("%s: anchor luma calls checked %s, want %s"
                             % (label, checked, {lp: 2 * n_p}))
    if p.transform_8x8 and min(enc.stats.i8x8_mbs,
                               enc.stats.trans8_mbs) < 1:
        raise AssertionError("%s: %d I8x8 MBs, %d trans8 P MBs"
                             % (label, enc.stats.i8x8_mbs,
                                enc.stats.trans8_mbs))


def _counters():
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    from video_steganography_pcamv_torch.encoder import qpel_table as QT
    from video_steganography_pcamv_torch.ops.deblock import deblock_frame
    from video_steganography_pcamv_torch.ops import fullpel as FP
    from video_steganography_pcamv_torch.ops import lumap as LP
    from video_steganography_pcamv_torch.ops import probe as PR
    from video_steganography_pcamv_torch.ops import tq4 as TQ
    return {"fullpel_parts": FP.fullpel_parts, "fullpel_sub": FP.fullpel_sub,
            "qpel_tables": PR.qpel_tables,
            "subpel": PR.subpel, "probe_maps": PR.probe_maps,
            "analyse_tail": PR.analyse_tail,
            "deblock_frame": deblock_frame,
            "fullpel_search16": FP.fullpel_search16,
            "gather_windows": QT.gather_windows,
            "dct_quant": TQ.dct_quant, "deq_idct": TQ.deq_idct,
            "luma_p_encode": LP.luma_p_encode,
            "luma_p_encode_levels": _InstanceLaunches("levels_launches"),
            "luma_p_encode_nr": _InstanceLaunches("nr_launches"),
            "luma_p_encode_aq": _InstanceLaunches("grid_launches"),
            "subpel_mb_cost": _InstanceLaunches("cost_launches", "subpel"),
            "gather_windows8": PT.gather_windows8,
            "lowres_costs_kernel": ST.lowres_costs_kernel}


# P fps of phase_main's runs by phase, for the later phases to print
P_FPS = {}


def phase_main(dev, card, tail_kernel: bool, n_frames: int,
               partitions: bool = True, config3: bool = False,
               label: str = None, payload: bool = True, phase_id=None,
               **kw):
    """One path end to end at full width: 1920x1088, or 1280x720 for
    config 3; `kw` overrides bench.py's Params (cabac, DEFAULTS).
    Returns the launch counts, the stream and the encoder. The payload
    check runs in a worker process (`_defer`); without `payload` the
    stream is not decoded (the caller checks it)."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    w, h = (1280, 720) if config3 else (1920, 1088)
    frames = synthetic_sequence(w, h, n_frames, seed=7)
    enc = Encoder(_params(w, h, tail_kernel, partitions=partitions,
                          config3=config3, **kw), device=dev)
    fns = _counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.time()
    bs = enc.encode_frame(frames[0])
    torch.cuda.synchronize()
    t1 = time.time()
    for f in frames[1:]:
        bs += enc.encode_frame(f)
    bs += enc.flush()
    torch.cuda.synchronize()
    t2 = time.time()
    launches = {k: fn.launches for k, fn in fns.items()}
    n_p = enc.stats.p_frames
    if n_p < 1:
        raise AssertionError("no P frame in the main path")
    # B2 is fused into B3 and B4, B8a/B8b into the fused luma encode:
    # their standalone entries never run
    exact = {"qpel_tables": 0, "dct_quant": 0, "deq_idct": 0,
             "deblock_frame": len(frames)}
    if partitions:
        # the fused luma encode: pass 1, and pass 2 unless no MB changed
        want = {"fullpel_parts": n_p, "gather_windows8": n_p,
                "analyse_tail": n_p, "luma_p_encode": n_p}
        most = {"luma_p_encode": 2 * n_p}
        # B3 -> B4 in one launch: B3 alone and B4's check entry never
        exact.update(analyse_tail=n_p, subpel=0, probe_maps=0)
    else:
        # per P frame: pass 1, the batched 13-version probe and pass 2
        want = {"fullpel_search16": n_p, "gather_windows": n_p}
        most = {}
        exact["luma_p_encode"] = 3 * n_p
    for k, lo in want.items():
        if launches[k] < lo:
            raise AssertionError("%s launched %d times, want >= %d"
                                 % (k, launches[k], lo))
    for k, hi in most.items():
        if launches[k] > hi:
            raise AssertionError("%s launched %d times, want <= %d"
                                 % (k, launches[k], hi))
    if kw.get("ref_frames", 1) > 1:
        # the multi-reference path: B1 once per reference, pass 1 and,
        # on every frame that embeds, the full pass 2
        n_emb = sum(len(m) > 0 for m in enc._stego.sent_messages)
        exact.update(fullpel_parts=kw["ref_frames"] * n_p,
                     gather_windows8=n_p, luma_p_encode=n_p + n_emb)
    for k, n in exact.items():
        if launches[k] != n:
            raise AssertionError("%s launched %d times, want %d"
                                 % (k, launches[k], n))
    if config3 and min(enc.stats.i8x8_mbs, enc.stats.trans8_mbs) < 1:
        raise AssertionError("config 3: %d I8x8 MBs, %d trans8 P MBs"
                             % (enc.stats.i8x8_mbs, enc.stats.trans8_mbs))
    fps_p = (len(frames) - 1) / (t2 - t1)
    P_FPS[phase_id] = fps_p
    label = label or ("720p config 3 (transform_8x8, rd 1)" if config3
                      else "1080p tail_kernel=%s" % tail_kernel
                      if partitions else "1080p partitions=False")
    if payload:
        _defer(lambda r: log("%s: %d payload bits recovered (decode + "
                             "extraction %.1f s, in a worker)"
                             % (label, r[0], r[1])),
               bs, len(frames), enc._stego.sent_messages)
    log("%s: %d frames (%d I, %d P), %d bytes, %s; IDR %.3f s; P frames "
        "%.4f fps incl. flush; all %.4f fps; launches %s  [%s]"
        % (label, len(frames), enc.stats.i_frames, n_p, len(bs),
           "decoded in a worker" if payload else "not decoded here",
           t1 - t0, fps_p, len(frames) / (t2 - t0), json.dumps(launches),
           card))
    if config3:
        log("720p config 3: %d I8x8 MBs in the IDR, %d trans8 P MBs; "
            "launches per P frame: %s; B5 per frame %.2f"
            % (enc.stats.i8x8_mbs, enc.stats.trans8_mbs, json.dumps(
                {k: launches[k] / n_p for k in want}),
               launches["deblock_frame"] / len(frames)))
    return launches, bs, enc


# the P encodes that serve both passes: pass 1 passes no force_zero,
# pass 2 always does, so each pass gets a stage row of its own
_BY_PASS = ("encode_p_frame_device8", "encode_p_frame_device",
            "encode_p_frame_device8_mref", "encode_p_frame_device4")


def _stage_wrapper(name, fn, frame, state):
    """fn timed while state["on"]: a device sync on each side, the
    seconds added to frame[name] (the encodes of `_BY_PASS` by pass)."""
    def wrap(*a, **kw):
        if not state["on"]:
            return fn(*a, **kw)
        key = name
        if name in _BY_PASS:
            key += " pass %d" % (1 if kw.get("force_zero") is None else 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        frame[key] = frame.get(key, 0.0) + time.perf_counter() - t0
        return out
    # a kernel wrapper counts its launches on the name it is called by,
    # which is now this one
    wrap.launches = 0
    return wrap


def _stage_targets(partitions: bool, mref: bool = False):
    """(object, attribute) of every stage that phase_stages times, for
    the partitioned path, the multi-reference path or the 16x16-only
    path."""
    from video_steganography_pcamv_torch import native
    from video_steganography_pcamv_torch.encoder import analyse2 as A2
    from video_steganography_pcamv_torch.encoder import core as CORE
    from video_steganography_pcamv_torch.encoder import inter as INTER
    from video_steganography_pcamv_torch.encoder import partition as PT
    from video_steganography_pcamv_torch.encoder import qpel_table as QT
    from video_steganography_pcamv_torch.encoder import slicetype as ST
    from video_steganography_pcamv_torch.ops import probe as PR
    from video_steganography_pcamv_torch.stego import embed as EMB
    if mref:
        return [(ST.Lookahead, "decide"), (CORE.Encoder, "_stack_l0"),
                (PT, "fullpel_parts"), (PT, "merge_ref_states"),
                (PT, "decide_partition"), (PT, "gather_windows8"),
                (PR, "analyse_tail"), (INTER, "encode_p_frame_device8_mref"),
                (native, "scan_p_parts"), (PT, "probe_combine"),
                (EMB.StegoEngine, "apply_costs"), (CORE, "deblock_frame"),
                (native, "write_slice_cabac")]
    if partitions:
        return [(ST.Lookahead, "costs_device"), (PT, "fullpel_parts"),
                (PT, "decide_partition"), (PT, "gather_windows8"),
                (PR, "analyse_tail"), (INTER, "encode_p_frame_device8"),
                (PT, "scan_p_device"),
                (PT, "probe_combine"), (EMB.StegoEngine, "apply_costs"),
                (CORE, "reencode_p_incremental"), (CORE, "deblock_frame"),
                (native, "write_slice")]
    return [(ST.Lookahead, "decide"), (A2, "fullpel_search16"),
            (QT, "gather_windows"), (QT, "block_table"), (QT, "wht_table"),
            (A2, "subpel_from_table"), (INTER, "encode_p_frame_device"),
            (native, "host_scan_p"), (A2, "stego_costs_from_table"),
            (native, "stc_embed"), (native, "host_scan_p_forced"),
            (CORE, "deblock_frame"), (native, "write_slice")]


def phase_stages(dev, card, n_frames: int = 7, partitions: bool = True,
                 config3: bool = False, config4p: bool = False):
    """Per-stage device time of a 1080p P frame on the tail_kernel=True
    path (or the 16x16-only path, or a 720p P frame of config 3, or a
    1080p P frame of config 4's P half, phase 20's Params): every
    stage is wrapped with a device sync on each side (the syncs remove
    the pipelining, so the stages sum to more than a P frame of phase
    6). The median and the mean over the P frames after the first, per
    frame (a stage that did not run in a frame counts 0 there)."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    from video_steganography_pcamv_torch.params import StegoParams
    targets = _stage_targets(partitions, mref=config4p)
    kw = (dict(cabac=True, ref_frames=2, stego=StegoParams(em_rate=64,
                                                           key=5))
          if config4p else {})
    frame = {}
    state = {"on": False}

    def timed(name, fn):
        return _stage_wrapper(name, fn, frame, state)

    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    w, h = (1280, 720) if config3 else (1920, 1088)
    frames = synthetic_sequence(w, h, n_frames, seed=7)
    per_frame, walls = [], []
    try:
        for obj, name, fn in saved:
            setattr(obj, name, timed(name, fn))
        enc = Encoder(_params(w, h, True, partitions=partitions,
                              config3=config3, **kw), device=dev)
        enc.encode_frame(frames[0])
        enc.encode_frame(frames[1])
        torch.cuda.synchronize()
        state["on"] = True
        for f in frames[2:]:
            frame.clear()
            t0 = time.perf_counter()
            enc.encode_frame(f)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_frame.append(dict(frame))
        enc.flush()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    n = len(per_frame)
    rows = {k: [1e3 * d.get(k, 0.0) for d in per_frame]
            for k in sorted({k for d in per_frame for k in d})}
    rows["(rest of the frame)"] = [1e3 * (wl - sum(d.values()))
                                   for wl, d in zip(walls, per_frame)]
    rows["(frame, with the syncs)"] = [1e3 * wl for wl in walls]
    log("%s stage times, ms per P frame over %d P frames (median, mean), "
        "a device sync around each stage  [%s]"
        % ("720p config 3" if config3 else "1080p config 4 P half"
           if config4p else "1080p tail_kernel=True" if partitions
           else "1080p partitions=False", n, card))
    for name, v in sorted(rows.items(), key=lambda kv: (
            kv[0].startswith("("), -float(np.mean(kv[1])))):
        log("  %-30s %9.3f %9.3f" % (name, float(np.median(v)),
                                      float(np.mean(v))))


def phase_stages_b(dev, card, n_frames: int = 7, pyramid: bool = False):
    """Per-stage times of phase 22's B frames (config 4 whole at 1080p,
    IDR + 6 + flush: four B frames), or with `pyramid` of phase 26's
    (IDR + 5 + flush: three B frames, the reference B first): every
    stage is wrapped with a device sync on each side; the kernel
    wrappers (B1, B9, B3', the luma encode) are timed inside the stages
    that call them, so their rows are not added into the rest. Median
    and mean over the B frames."""
    from video_steganography_pcamv_torch import Encoder
    from video_steganography_pcamv_torch.encoder import bslice as BS
    from video_steganography_pcamv_torch.encoder import core as CORE
    from video_steganography_pcamv_torch.params import StegoParams
    from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
    outer = [(BS, "analyse_b_parts_stage1"), (BS, "approx_direct_fields"),
             (BS, "bipred_satd8_device"), (BS, "analyse_b_parts"),
             (BS, "scan_b_parts"), (BS, "encode_b_frame_device"),
             (CORE, "_levels_exact"), (CORE.Encoder, "_write_b_slice_cabac"),
             (BS, "temporal_direct_fields"),
             (CORE.Encoder, "_direct_auto_score")]
    inner = [(BS, "fullpel_parts"), (BS, "gather_windows8"), (BS, "subpel"),
             (BS, "luma_p_encode")]
    frame, state = {}, {"on": False, "in_stage": False}
    top = {name for _obj, name in outer}

    def timed(name, fn):
        def wrap(*a, **kw):
            # a stage called inside another (the direct-auto score's
            # dispatch) counts in the outer one
            if not state["on"] or (name in top and state["in_stage"]):
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["in_stage"] |= name in top
            try:
                out = fn(*a, **kw)
            finally:
                state["in_stage"] &= name not in top
            torch.cuda.synchronize()
            frame[name] = frame.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrap

    saved = [(obj, name, getattr(obj, name)) for obj, name in outer + inner]
    kw = PYRAMID if pyramid else dict(bframes=2)
    enc = Encoder(_params(1920, 1088, True, cabac=True, b_adapt=0,
                          ref_frames=2, stego=StegoParams(em_rate=64, key=5),
                          **kw), device=dev)
    bframe, per_b, walls = enc._encode_b_frame, [], []

    def timed_b(*a, **k):
        frame.clear()
        state["on"] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bframe(*a, **k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        state["on"] = False
        per_b.append(dict(frame))
        return out

    enc._encode_b_frame = timed_b
    try:
        for obj, name, fn in saved:
            setattr(obj, name, timed(name, fn))
        for f in synthetic_sequence(1920, 1088, n_frames, seed=9):
            enc.encode_frame(f)
        enc.flush()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    rows = {k: [1e3 * d.get(k, 0.0) for d in per_b]
            for k in sorted({k for d in per_b for k in d})}
    rows["(rest of the B frame)"] = [
        1e3 * (wl - sum(v for k, v in d.items() if k in top))
        for wl, d in zip(walls, per_b)]
    rows["(B frame, with the syncs)"] = [1e3 * wl for wl in walls]
    log("1080p %s B-frame stage times, ms per B frame over %d B frames "
        "(median, mean), a device sync around each stage; rows marked * "
        "run inside another stage  [%s]"
        % ("phase 26 (b_pyramid, weightb, direct auto)" if pyramid
           else "config 4", len(per_b), card))
    for name, v in sorted(rows.items(), key=lambda kv: (
            kv[0].startswith("("), -float(np.mean(kv[1])))):
        mark = "*" if name not in top and not name.startswith("(") else " "
        log("  %-30s%s %9.3f %9.3f" % (name, mark, float(np.median(v)),
                                        float(np.mean(v))))


# run from a checkout's root by `--ab`: the medians of kernels B1 and B9
# at 1080p, of the analyse tail (`ops.probe.analyse_tail`: one launch
# where the checkout fuses it, else B3 then B4) and of B3 with its
# mb_cost output on phase 4's inputs, of the checkout's luma encode at
# 1080p (the main path's
# pass-1 encode on predictions at random per-8x8 MVs, and the 16x16
# path's 13-version probe batch: the fused kernel where the checkout has
# it, else the eager luma_p_encode + cbp_luma_of and the B8a ->
# decimation -> B8b chain with its repeat of the current MBs), the main
# path's 1080p encode and its stage times, with that checkout's
# chip_smoke.py and package (the names used here exist in every
# checkout since B9's phase)
_AB_CHILD = r"""
import time
import numpy as np
import torch
import chip_smoke as C
from video_steganography_pcamv_torch import Encoder
from video_steganography_pcamv_torch.encoder import inter as INTER
from video_steganography_pcamv_torch.ops import mc
from video_steganography_pcamv_torch.utils.yuv import synthetic_sequence
dev = torch.device("cuda", 0)
card = C.card_query("name,power.limit")
C.phase_build()
rate = C.int32_ops_per_s()
recs = [C.phase_b1(dev, rate)] + C.phase_b9b10(dev, rate)
C.log("kernel medians: " + ", ".join("%s %.4f ms" % (r["name"], r["ms"])
                                     for r in recs) + "  [%s]" % card)
fr = synthetic_sequence(1920, 1088, 2, seed=3)
y = torch.as_tensor(fr[1].y.astype(np.int32), device=dev)
c = torch.as_tensor(fr[0].u.astype(np.int32), device=dev)
ref = mc.build_ref(torch.as_tensor(fr[0].y.astype(np.int32), device=dev),
                   c, c)
g = np.random.RandomState(5)
mv8 = torch.as_tensor(g.randint(-40, 41, (136, 240, 2)).astype(np.int32),
                      device=dev)
pred = INTER.assemble_pred_luma(ref["luma"], mv8, 68, 120)
p13 = torch.clamp(pred.repeat(13, 1, 1) + torch.as_tensor(
    g.randint(-4, 5, (13 * 8160, 16, 16)).astype(np.int32), device=dev),
    0, 255)
tiles = INTER.mb_tiles(y, 16)
try:
    from video_steganography_pcamv_torch.ops import lumap as LP
    cases = (("fused luma_p_encode", lambda: LP.luma_p_encode(y, pred, 26)),
             ("fused luma_p_encode, probe batch",
              lambda: LP.luma_p_encode(y, p13, 26, lev=False)))
except ImportError:
    cases = (("eager luma_p_encode + cbp_luma_of", lambda: INTER.cbp_luma_of(
                 INTER.luma_p_encode(tiles, pred, 26)[0])),
             ("B8a/decimation/B8b chain, probe batch",
              lambda: INTER.luma_p_encode_fast(tiles.repeat(13, 1, 1), p13,
                                               26)))
C.log("luma encode medians at 1080p: " + ", ".join(
    "%s %.4f ms" % (k, C.cuda_ms(f, 20, 3)) for k, f in cases)
    + "  [%s]" % card)
from video_steganography_pcamv_torch.ops import probe as PR
cur, win, part, mvf, pmv, lam, qp = C._tail_inputs(dev)
r8 = PR.subpel(cur, win, part, mvf, pmv, lam, 68, 120)[1]
C.log("analyse tail medians at 1080p: analyse_tail %.4f ms, subpel with "
      "mb_cost %.4f ms, probe_maps %.4f ms  [%s]" % (
          C.cuda_ms(lambda: PR.analyse_tail(cur, win, part, mvf, pmv, lam,
                                            qp, 68, 120), 50, 3),
          C.cuda_ms(lambda: PR.subpel(cur, win, part, mvf, pmv, lam, 68, 120,
                                      mb_cost=True), 50, 3),
          C.cuda_ms(lambda: PR.probe_maps(cur, win, r8, qp, 68, 120), 50, 3),
          card))
frames = synthetic_sequence(1920, 1088, 10, seed=7)
enc = Encoder(C._params(1920, 1088, True), device=dev)
t0 = time.time()
bs = enc.encode_frame(frames[0])
torch.cuda.synchronize()
t1 = time.time()
for f in frames[1:]:
    bs += enc.encode_frame(f)
bs += enc.flush()
torch.cuda.synchronize()
t2 = time.time()
C.log("1080p tail_kernel=True: %d bytes; IDR %.3f s; P frames %.4f fps "
      "incl. flush  [%s]" % (len(bs), t1 - t0, 9 / (t2 - t1), card))
C.phase_stages(dev, card)
"""


class SideProcess:
    """Phases in a second process of this script on the same card
    (`--side OUT`), started early so that it runs while the main
    process works through the other phases: its output lines are kept by
    a reader thread and logged when `join` collects it, with its result
    (a JSON file) and its own wall time. `stop` ends it if the run fails
    first."""

    def __init__(self, flag: str):
        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(here, "build"), exist_ok=True)
        self.out = os.path.join(here, "build", "chip_smoke%s.json" % flag[1:])
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def join(self) -> dict:
        rc = self.proc.wait()
        self.reader.join()
        for line in self.lines:
            log("  | " + line)
        log("(its process: %.1f s from its start, rc %d)"
            % (time.time() - self.t0, rc))
        try:
            if rc != 0:
                raise AssertionError("the second process failed (rc %d)" % rc)
            with open(self.out) as f:
                return json.load(f)
        finally:
            os.remove(self.out)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def side_child(out: str) -> int:
    """`--side OUT`: phases 29, 32, 17 and 41 in a second process (their
    cpu halves and decode checks in two workers of its own), phase 29's
    launches written to OUT."""
    global POOL_WORKERS
    POOL_WORKERS = 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    card = card_query("name,power.limit")
    t0 = time.time()
    launches = phase_trellis(dev, card)
    log("[phase 29 (second process): %.1f s]" % (time.time() - t0))
    t1 = time.time()
    phase_config5(dev, card)
    log("[phase 32 (second process): %.1f s]" % (time.time() - t1))
    t1 = time.time()
    phase_small_cabac(dev)
    log("[phase 17 (second process): %.1f s]" % (time.time() - t1))
    t1 = time.time()
    phase_plain_b(dev, card)
    log("[phase 41 (second process): %.1f s]" % (time.time() - t1))
    t1 = time.time()
    _join_checks()
    log("[its decode checks: %.1f s]" % (time.time() - t1))
    with open(out, "w") as f:
        json.dump({"launches": launches}, f)
    return 0


def ab(parent_root: str) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    parent_root = os.path.abspath(parent_root)
    for label, root in (("parent", parent_root), ("change", here),
                        ("change", here), ("parent", parent_root)):
        log("== %s: %s" % (label, os.path.relpath(root, here)))
        t0 = time.time()
        subprocess.run([sys.executable, "-c", _AB_CHILD], cwd=root,
                       check=True)
        log("== %s: %.1f s" % (label, time.time() - t0))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages16", action="store_true",
                    help="also time the stages of the 16x16-only path")
    ap.add_argument("--stages8", action="store_true",
                    help="also time the stages of config 3 at 720p")
    ap.add_argument("--stagesB", action="store_true",
                    help="also time the stages of config 4's and phase "
                    "26's B frames at 1080p")
    ap.add_argument("--stages4", action="store_true",
                    help="also time the stages of config 4's P half at "
                    "1080p")
    ap.add_argument("--ab", metavar="PARENT_ROOT",
                    help="compare the main path with another checkout")
    ap.add_argument("--side", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if args.ab:
        return ab(args.ab)
    if args.side:
        return side_child(args.side)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.time()
    dev = torch.device("cuda", 0)
    card = card_query("name,power.limit")
    log(card)
    log("python %s, torch %s, cuda %s" % (sys.version.split()[0],
                                          torch.__version__,
                                          torch.version.cuda))

    def phase(name, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        log("[phase %s: %.1f s]" % (name, time.time() - t0))
        return out

    phase("1 build", phase_build)
    int_rate = int32_ops_per_s()
    log("int32 peak %.3e ops/s (132 SMs x 64 lanes x max SM clock)"
        % int_rate)
    recs = [phase("2 B1", phase_b1, dev, int_rate),
            phase("2 B1 sub-unit instance", phase_b1_sub, dev, int_rate),
            phase("3 B5", phase_b5, dev, int_rate)]
    recs += phase("4 B2-B4", phase_tail, dev, int_rate)
    recs9 = phase("13 B9-B10", phase_b9b10, dev, int_rate)
    recs16 = phase("9 B6-B8", phase_b678, dev, int_rate)
    # phases 29 (a trellis IDR: minutes of host-bound eager work), 32
    # (eight 1080p IDRs in a row) and 17 (24 small cuda == cpu cases) run
    # in a second process on the card beside the phases below, once the
    # kernels' timings are taken
    global _SIDE
    _SIDE = SideProcess("--side")
    phase("5 112x80", phase_small, dev)
    phase("14 128x96 config 3", phase_small8, dev)
    sub_jobs = submit_small_sub()
    plain_jobs = submit_plain_small()
    plain_sb_jobs = submit_plain_sb_small()
    launches, bs6, enc6 = phase("6 main path", phase_main, dev, card,
                                tail_kernel=True, n_frames=5, phase_id="6")
    phase("35 128x96 multi-stream and tile layers", phase_small_multi, dev)
    phase("33 2 x 1080p PipelinedMultiEncoder", phase_pipelined_multi, dev,
          card)
    phase("34 1080p pipeline and tile steps", phase_pipeline_tile, dev,
          card)
    phase("18 1080p default Params", phase_defaults, dev, card, bs6, enc6)
    phase("19 1080p CABAC", phase_cabac, dev, card, bs6)
    phase("20 1080p config 4 P half", phase_config4p, dev, card)
    _l22, cabac_write_ms = phase("22 1080p config 4", phase_config4, dev,
                                 card)
    phase("24 1080p default Params, bframes 2", phase_defaults_b, dev, card,
          cabac_write_ms)
    phase("25 1080p 16x16 path with B frames", phase_b16, dev, card)
    phase("26 1080p b_pyramid, weightb, direct auto", phase_pyramid, dev,
          card)
    phase("27 1080p b_pyramid, temporal direct", phase_pyramid_temporal,
          dev, card)
    launches30 = phase("30 1080p cqm jvt, deadzones, nr", phase_quant, dev,
                       card, bs6)
    launches31 = phase("31 1080p aq_mode 1", phase_aq, dev, card, bs6)
    launches36 = phase("36 1080p p4x4", phase_sub, dev, card)
    phase("37 128x96 p4x4", phase_small_sub, dev, sub_jobs)
    launches38 = phase("38 1080p plain encoder", phase_plain, dev, card)
    phase("39 112x80 plain encoder", phase_plain_small, dev, plain_jobs)
    phase("40 1080p plain p4x4, rd 1", phase_plain_sub, dev, card)
    phase("42 112x80 plain p4x4 and intra in B", phase_plain_sb_small, dev,
          plain_sb_jobs)
    if args.stagesB:
        phase("23 config-4 B-frame stages", phase_stages_b, dev, card)
        phase("23 phase-26 B-frame stages", phase_stages_b, dev, card,
              n_frames=6, pyramid=True)
    if args.stages4:
        phase("21 config-4 P half stages", phase_stages, dev, card,
              n_frames=6, config4p=True)
    phase("7 tail_kernel=False", phase_main, dev, card, tail_kernel=False,
          n_frames=3)
    phase("8 stages", phase_stages, dev, card)
    phase("10 112x80 16x16", phase_small16, dev)
    launches16, _, _ = phase("11 16x16 path", phase_main, dev, card,
                             tail_kernel=True, n_frames=3, partitions=False)
    if args.stages16:
        phase("12 16x16 stages", phase_stages, dev, card, n_frames=6,
              partitions=False)
    launches8, _, _ = phase("15 720p config 3", phase_main, dev, card,
                            tail_kernel=True, n_frames=5, config3=True)
    if args.stages8:
        phase("16 config-3 stages", phase_stages, dev, card, n_frames=6,
              config3=True)
    launches29 = phase("29, 32, 17 and 41 (the second process, joined)",
                       _SIDE.join)["launches"]
    if launches8["gather_windows8"] < 1:
        raise AssertionError("config 3 did not launch B9")
    for r in recs + recs9:
        # the sub-unit instance runs on phase 36's path only, B3's mb_cost
        # instance on phase 38's (stego off)
        r["launches"] = (launches[r["name"]] or launches36[r["name"]]
                         or launches38[r["name"]])
    for r in recs16:
        # the main path's count where the kernel runs there (the fused
        # luma encode), else the 16x16 path's (B6, B7), phase 29's for the
        # luma encode's levels-in entry (the trellis path), phase 30's
        # for its noise-reduction instance and phase 31's for its per-MB
        # qp instance (adaptive quantization)
        r["launches"] = (launches[r["name"]] or launches16[r["name"]]
                         or launches29[r["name"]] or launches30[r["name"]]
                         or launches31[r["name"]])
    recs += recs16 + recs9
    phase("28 the decode checks in the workers", _join_checks)
    log("total %.1f s" % (time.time() - t_start))
    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


_SIDE = None

if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if _SIDE is not None:
            _SIDE.stop()
        _stop_pool()
    sys.exit(rc)
