#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (webp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the host entropy library (g++) and the kernels (`webp_tpu_torch/csrc`,
nvcc, one process per source), then drives the ported paths at 768x512
through their public entry points, each with the launch counts set to 0
just before it and read just after:

Decode.  Writes four distinct seeded VP8 keyframes (`tests/random_vp8.py`:
I4 and I16 macroblocks, segments, |level| > 127 escapes, several token
partitions; two with the normal loop filter, two with the simple one) and
decodes a batch of 8 of each kind (`dispatch_decode_batch`, out="rgb" and
out="yuv").  The output must be bit-exact with the port's plain torch
decode of the same payloads on the CPU (which the tests hold to the JAX
package and its scalar decoder), the RGB also with the host's C++
YUV->RGB conversion of the YUV output.  Each batch takes one launch of
K1 residual, of K2 + K3 fused (recon_filter) and, for RGB, of K4 yuv2rgb;
K2 recon and K3 loopfilter alone, none.  K1, K2, K3 (both kinds), the
fused kernel (both kinds; also against the main path's planes) and K4 are
each held bit-exact to their plain twins on the same card inputs.  The
three row-CTA kernels are timed beside the one-block-per-image K2 / K3
they replaced, per wavefront step, and beside the chain floor: T MB
hand-overs between rows, timed on chains of CTAs.

Encode, twice: method 3 with segments off, then the flagship, method 4
(trellis) with segments on.  Two distinct seeded synthetic frames
(`tests/synthetic_rgb.py`, asserted to give I4 and I16 MBs; for the
flagship also segmentation with the update map and at least two segment
ids on each) tiled to a batch of 8 go through `encode_frames_lossy_batch`
at Q75, 8 partitions, two-pass and one-pass.  The payloads must be
byte-equal to the port's plain encode of the distinct frames on the CPU
(which the tests hold byte-equal to the JAX package; two worker processes
make it while the card works).  K8 analysis (the flagship's segment
alphas), K5 enc (pass 2 with per-image tables; for the flagship with
trellis and segment ids, and pass 1 too, the kernel's other instance, with
the default tables and segment ids), K6 token_stats (with the skip flags
given, and derived in the kernel as pass 1 runs it; also against the host
C++ token statistics) and K7
enc_tables are each held bit-exact to their plain twins on the main
path's card inputs; the payloads decode through K1-K4 bit-exact with the
plain CPU decode.  In both phases the device-token flow
(`device_tokens=True`: K13 codes the coefficient partitions from pass 2's
levels on the card, K14 the MB headers) gives the same payloads as the
host finisher.  The host finisher's flows pack pass 2's arrays into the
encode wire (the fused K18 prepack + K19 pack_levels launch, then K20
wire: one uint8 row per image; K18 and K19 alone, none) and unpack it on
the host; in both phases K18, K19 (at caps 256 and 100), the fused kernel
and K20 are held bit-exact to their plain twins on the card's pass-2
arrays and on seeded arrays that set each of the wire's flags
(`tests/wire_inputs.py`; `fetch_packed` must return those arrays exactly
through each branch), and the wire path is timed beside the dense fetch
of the same arrays.  In both
phases K13 coeff_tokens (three producer warps and a coder warp a lane) and
K14 mb_headers (a CTA an image counts, scans and writes the header ops,
then one warp codes them) are held bit-exact to their plain twins on the
card's own pass-2 arrays, the segment map written in the flagship and not
in the m3 phase.  In the flagship phase K15 bool_lanes is too, on
adversarial carry streams and on streams steered to carry through 0xFF
runs and past a continued lane's first byte (`tests/token_inputs.py`),
and the host C++ coders (`vp8_token_encode`, `vp8_mbheader_encode`) are
timed on the same arrays as the yardstick; K13 is timed at batch 8 and
batch 1 beside its chain floor (the longest lane's ops times one coder
step, timed on a one-warp chain of ops in shared memory,
`webp_coder_chain`), with the CTAs the card keeps resident, and K14 the
same way (its floor: the image with the most header ops times the step);
both phases time the end to end with and without device tokens in
alternating runs.

Lossless (VP8L) decode.  Two distinct seeded synthetic frames with seeded
alpha (`tests/synthetic_rgb.py`, `tests/random_vp8l.py`) are written by
the jax-free stream writer `tests/random_vp8l.py` as two transform
signatures: [subtract-green, predictor (size_bits 2), colour transform
(size_bits 3)], and a 12-colour quantisation as [palette, predictor on the
packed width].  A batch of 8 of each, and a mixed batch of both, go
through `decode_lossless_batch_device`: every output must equal its source
and the host C++ full decode (`vp8l_decode`).  K9 subtract_green, K10
color_transform, K11 color_indexing and K12 predictor are each held
bit-exact to their plain twins on the phase's own card inputs, the
inverse transforms stepped in stream order reversed; K11 also on an
unpacked 200-colour index image, beside one PyTorch indexing call.  K12,
the row-band kernel, is timed on the photo and on the packed palette
image at batch 8 and batch 1, beside its chain floor: the image's pixel
steps times one step (a one-band chain at two widths) plus a row
hand-over between each two of its CTAs.

Container: the decoder API, after the lossless phase.  Seeded 768x512
WebP files from the jax-free writer `tests/random_webp.py`: two VP8X
stills (a VP8 keyframe with an ALPH chunk, VP8L-compressed through a
palette with the gradient filter in one and raw with the horizontal filter
in the other, and ICCP, EXIF and XMP), a VP8L still with alpha, and a
six-frame animation (a full-canvas VP8 frame; a smaller one at an even
offset, blended; an ALPH + VP8 frame that disposes; VP8L frames with
alpha that blend and that do not; a full-canvas ALPH + VP8 frame that does
not blend; a background colour set through `set_background_color`).
`decode_rgba` decodes the stills and `WebPDecoder.read_frame` the
animation on the card, each file with the counts set to 0 just before it:
K1, recon_filter and K4 once a VP8 payload, K9-K12 once per transform of
each VP8L stream and compressed ALPH.  The outputs must be bit-exact with
the same API on the CPU (the plain twins), the stills' RGB with
`decode_vp8_batch_device` on the card, the VP8L still and the alpha planes
with their sources, the metadata chunks with the writer's, and each canvas
with the sources composed on the host.  Timed, host clock beside CUDA
events: a VP8X still's stages (parse, entropy + upload, K1 +
recon_filter + K4, fetch, alpha), each still's `read_image`, each frame of
the animation, and the gradient and horizontal alpha defilters.

Encoder API, after the encode phases.  Seeded synthetic frames
(`tests/synthetic_rgb.py`, alpha planes from `tests/random_webp.py`)
through `Encoder`, `encode_lossless_rgba` and `AnimationEncoder` on the
card, each file with the counts set to 0 just before it: the default
`Encoder.new_rgb(...).encode()` of the encode phases' first frame at
768x512 (Q75, method 4, segments on at 1,536 MBs, one partition) and its
RGBA with ALPH, each one launch of K8,
K6, K7, the fused K18 + K19 and K20 and two of K5; at 256x256 an RGBA
with ALPH, an L8, a PHOTO preset (sharp YUV) with ICCP / EXIF / XMP, an
alpha_quality 50 and a target_size file, three-frame lossy and lossless
animations; a lossless 768x512 RGBA still (host code only).  The 768x512
VP8 chunks must be byte-equal to the plain CPU encode of that frame at one
partition (the flagship encode phase's worker codes it), the other files
to the same API calls on the CPU (a fourth worker process makes them from
the start); every file decodes through `WebPDecoder` on the card with the
lossless pixels, the ALPH planes and the near-lossless alpha exact, and
the lossy files' PSNR against their sources printed.  Timed, host clock
beside CUDA events, median of 3 after a warm-up: the 768x512 stills'
`encode()` stage by stage (colour conversion, then the encode phases'
stages at a batch of one: upload, segment, pass 1, stats d2h +
probabilities, tables, pass 2, wire, d2h, finish; then ALPH or VP8L, mux)
and whole.

Scale-out, last.  The decode batches of both filter kinds go through
`parallel.decode_wavefront_banded` at 2, 4 and 8 bands an image (K16
recon_banded and K17 filter_banded, one cluster of that many CTAs per
image, a band's rows run as row pipelines of one warp): planes byte-equal
to the fused K2 + K3's of the same run; K16 and K17 held bit-exact to
their twins (bands held apart, halo rows handed over each step) at 4
bands, and timed at 1, 2, 4 and 8 bands beside K2 and K3, per step and
beside their chain floor (T hand-overs between row pipelines, timed on
rings of warps in a CTA and of CTAs in a cluster), with the CTA's shape
and the card's largest number of resident clusters; at 1 band (more rows
than pipelines) byte-equal to the fused K2 + K3 too.  Then a one-rank NCCL process
group (`torch.distributed`, tcp on localhost) carries the four
data-parallel factories of `webp_tpu_torch.parallel`, each byte-equal to
the unsharded path of this run: the decode's RGB, the one-pass analysis,
the flagship's int8 prepack (K18 alone, whose launches there are its
count) and the payloads finished from it, and the token lanes gathered
over the group (the all_gather timed); then the group is destroyed.

Prints the card's name and power limit, per-kernel timings (CUDA events
over each call, the wrapper's host work included; kernel beside plain twin
and the kernel's bound; for K1, K4, K6-K8, K18-K22 and the fused K18 +
K19 also the profiler's
device time of the call's kernels; K9 also beside one in-place add over a
strided view, the one PyTorch call that computes it), the encodes' per-stage
host-clock split (both flows) and d2h bytes (the wire rows beside the
dense arrays), the images by wire branch, the lossless decode's ms/img beside the host C++
decode's, the decoder API's ms per still and per frame, the encoder API's ms per
stage, one JSON line of kernel records and, last,
{"ok": true, "device": {...}}.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails.  Imports neither jax nor the JAX package; needs no network.
"""

from __future__ import annotations

import json
import multiprocessing
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT = 768, 512
BATCH = 8
SEEDS = {False: (101, 202), True: (303, 404)}  # simple filter -> distinct frames
ESCAPES = 32  # |level| > 127 per frame

QUALITY, PARTITIONS = 75, 8
ENC_SEEDS = (11, 12)
# The encode phases: (method, segments).  The flagship is bench.py's encode.
ENCODES = ((3, False), (4, True))

LOSSLESS_SEEDS = (21, 22)
LOSSLESS_COLOURS = 12  # the palette signature: two indices to a byte
K12_STEP_WIDTHS = (2048, 8192)  # widths of the one-band chains that time a K12 pixel step

# The card's peaks for the kernels' bounds (NVIDIA H100 SXM): HBM bytes/s
# (data sheet), and INT32 operations/s outside the tensor cores, which is
# where all the kernels' work runs: 64 INT32 lanes per SM x 132 SMs x the
# 1.98 GHz boost clock (the data sheet's 67 TFLOP/s float32 is 128 FP32
# lanes per SM counting an FMA as two).
PEAK_BYTES = 3.35e12
PEAK_INT_OPS = 64 * 132 * 1.98e9

DECODE_KERNELS = [
    # name, source, replaced TPU kernel (file:line)
    ("residual", "webp_tpu_torch/csrc/residual.cu", "webp_tpu/decode/device.py:509"),
    ("recon", "webp_tpu_torch/csrc/wavefront_rows.cu", "webp_tpu/ops/wavefront2.py:152"),
    ("loopfilter", "webp_tpu_torch/csrc/wavefront_rows.cu", "webp_tpu/ops/loopfilter2.py:192"),
    ("recon_filter", "webp_tpu_torch/csrc/wavefront_rows.cu", "webp_tpu/ops/wavefront2.py:274"),
    ("yuv2rgb", "webp_tpu_torch/csrc/yuv2rgb.cu", "webp_tpu/ops/jax_ops.py:189"),
]
# The one-block-per-image K2 / K3 that the row-CTA kernels replaced (commit
# c28384d, this script at batch 8 x 768x512 on an H100 80GB HBM3 at 700 W):
# ms a batch, and decode_core's ms an image.
ONE_BLOCK_MS = {"recon": 1.3841, "loopfilter": 1.6936, "decode_core": 0.3983}
HANDOFF_CHAINS = (1024, 4096)  # CTAs of the two hand-over chains
# The row-CTA kernel's instances: name -> (recon, filter).
ROW_KERNELS = {"recon": (True, False), "loopfilter": (False, True), "recon_filter": (True, True)}
ENCODE_KERNELS = [
    ("analysis", "webp_tpu_torch/csrc/analysis.cu", "webp_tpu/ops/analysis2.py:128"),
    ("enc", "webp_tpu_torch/csrc/enc.cu",
     "webp_tpu/ops/encode_wavefront2.py:803 + webp_tpu/ops/trellis2.py:110,325"),
    ("token_stats", "webp_tpu_torch/csrc/token_stats.cu", "webp_tpu/ops/token_stats.py:183"),
    ("enc_tables", "webp_tpu_torch/csrc/enc_tables.cu",
     "webp_tpu/ops/encode_wavefront2.py:1405"),
]
TOKEN_KERNELS = [
    ("coeff_tokens", "webp_tpu_torch/csrc/tokens.cu",
     "webp_tpu/ops/token_ops.py:228 (+ :80, :169) + webp_tpu/ops/boolenc2.py:89"),
    ("mb_headers", "webp_tpu_torch/csrc/tokens.cu",
     "webp_tpu/ops/token_ops.py:424 (+ :340) + webp_tpu/ops/boolenc2.py:89"),
    ("bool_lanes", "webp_tpu_torch/csrc/tokens.cu", "webp_tpu/ops/boolenc2.py:89"),
]
WIRE_KERNELS = [
    ("prepack", "webp_tpu_torch/csrc/wire.cu",
     "webp_tpu/ops/encode_wavefront2.py:1028 (jitted :1076, :1087)"),
    ("pack_levels", "webp_tpu_torch/csrc/wire.cu",
     "webp_tpu/ops/encode_wavefront2.py:1113 + webp_tpu/ops/sparse.py:73"),
    ("prepack_pack", "webp_tpu_torch/csrc/wire.cu",
     "webp_tpu/ops/encode_wavefront2.py:1028 + :1113 (one program in :1286)"),
    ("wire", "webp_tpu_torch/csrc/wire.cu",
     "webp_tpu/ops/encode_wavefront2.py:1200 (+ :1178, :1149)"),
]
# The flagship kernels no PR redesigned before K8 and K6, and those two:
# name -> the __global__ functions one call launches, whose device time
# the profiler reads beside the call's time by CUDA events (which holds the
# wrapper's host work).
FLAGSHIP_DEVICE = {"residual": ["residual_kernel"], "yuv2rgb": ["yuv2rgb_kernel"],
                   "analysis": ["analysis_kernel"], "token_stats": ["token_stats_kernel"],
                   "enc_tables": ["enc_tables_kernel"]}
WIRE_SEED = 31  # the overflow case's arrays (tests/wire_inputs.py)
STEERED_SEED = 20  # tests/token_inputs.py steered_lanes: 6 streams that carry
CHAIN_SEED, CHAIN_PASSES = 7, (4, 16)  # the coder-step chain: seeded ops, passes over the ring
PARALLEL_KERNELS = [
    ("recon_banded", "webp_tpu_torch/csrc/banded.cu",
     "webp_tpu/parallel/pipeline.py:60 (+ :37 _band_shifts)"),
    ("filter_banded", "webp_tpu_torch/csrc/banded.cu",
     "webp_tpu/parallel/pipeline.py:60 (+ :37 _band_shifts)"),
]
N_BANDS = (2, 4, 8)  # CTAs per image of the banded decode; 4 is the kernels line's
BAND_RING, BAND_ROUNDS = 8, (250, 2000)  # the banded hand-over rings: members, rounds
FLAT_KERNELS = [
    ("pack_flat", "webp_tpu_torch/csrc/sparse.cu", "webp_tpu/ops/sparse.py:42"),
    ("expand_flat", "webp_tpu_torch/csrc/sparse.cu", "webp_tpu/ops/sparse.py:110"),
]
FLAT_NAMES = [k for k, _, _ in FLAT_KERNELS]
FLAT_SEED = 41  # tests/sparse_inputs.py's arrays
# K5 where its row CTAs outnumber the card's resident ones (images of
# 32 x 128, 8 MB rows), at mbw = 1 and at mbh = 1, pass 1 (n_try 3) and
# pass 2 (n_try 4, trellis); and the pass 2 of methods 5-6 (n_try 10,
# trellis) on 3 x 3 MBs: (w, h, images or None, n_try of each leg).  The
# twin's time goes with the wavefront's steps, w / 16 + 2 (h / 16 - 1).
K5_PROBES = ((32, 128, None, (3, 4)), (16, 160, 3, (3, 4)), (160, 16, 3, (3, 4)),
             (48, 48, 3, (10,)))
LOSSLESS_KERNELS = [
    ("subtract_green", "webp_tpu_torch/csrc/vp8l.cu", "webp_tpu/ops/vp8l_device.py:45"),
    ("color_transform", "webp_tpu_torch/csrc/vp8l.cu", "webp_tpu/ops/vp8l_device.py:51"),
    ("color_indexing", "webp_tpu_torch/csrc/vp8l.cu", "webp_tpu/ops/vp8l_device.py:74"),
    ("predictor", "webp_tpu_torch/csrc/vp8l.cu", "webp_tpu/ops/vp8l_device.py:159"),
]


# The container phase: seeds of its two VP8X stills, its VP8L still and its
# animation (tests/random_webp.py), the background colour the animation is
# given through set_background_color, and the kernels its files launch.
CONTAINER_SEEDS = (51, 52, 53, 54)
CONTAINER_BACKGROUND = (40, 80, 120, 160)
CONTAINER_KERNELS = ("residual", "recon_filter", "yuv2rgb", "subtract_green", "color_transform",
                     "color_indexing", "predictor")

# The encoder-API phase: seeds of its 768x512 frame and of its small
# images and animation frames (tests/synthetic_rgb.py, tests/random_webp.py
# alpha), the small files' side (256 MBs: segments on), the target_size it
# asks of one of them, its metadata chunks, and the kernels one lossy
# encode() launches from 256 MBs (K8, K5 twice, K6, K7, the fused K18 +
# K19, K20).
API_SEEDS = (61, 62, 63, 64)
API_SMALL = 256
API_TARGET = 3500
API_META = (b"ICC profile of the smoke", b"Exif\x00\x00MM\x00*", b"<x:xmpmeta/>")
API_KERNELS = {"analysis": 1, "enc": 2, "token_stats": 1, "enc_tables": 1, "prepack_pack": 1,
               "wire": 1}


def _import_paths() -> None:
    for p in (str(ROOT), str(ROOT / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def make_payloads(width: int, height: int, simple: bool):
    """Distinct seeded random keyframes and their (I4, I16) MB counts."""
    _import_paths()
    from random_vp8 import random_keyframe

    out = []
    for seed in SEEDS[simple]:
        payload, content = random_keyframe(width, height, seed, simple=simple, escapes=ESCAPES)
        n_i4 = int((content["luma_mode"] == 4).sum())
        out.append((payload, n_i4, content["luma_mode"].size - n_i4))
    return out


def cpu_reference(payloads):
    """(RGB [n, h, w, 3], packed YUV [n, ...]) numpy of the port's plain torch
    decode on the CPU."""
    _import_paths()
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb

    batch = tdev.parse_levels_batch(payloads)
    mbw, mbh, _, width, height = tdev.geometry(batch["headers"])
    yuv = tdev.decode_core(tdev.to_device_batch(batch, "cpu"), "yuv")
    rgb = fancy_yuv420_to_rgb(*tdev.split_planes(yuv, mbw, mbh), width, height)
    return rgb.numpy(), yuv.numpy()


def time_ms(fn, reps: int, setup=None):
    """Median device time of fn() over `reps` runs after a warm-up, in ms
    (CUDA events); setup() runs before each run, outside the timed span."""
    import torch

    times = []
    for rep in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:  # the first run warms up
            times.append(start.elapsed_time(stop))
    return statistics.median(times)


def timed(fn):
    """(fn(), its device time in ms by CUDA events): one run, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def device_ms(fn, reps: int, names, tries: int = 3) -> dict:
    """Mean device time per call of fn(), in ms, of the kernels whose names
    contain each of `names` ("" for every device op), from a torch.profiler
    trace of `reps` calls after a warm-up; a trace that holds no device
    time for one of them is taken again, up to `tries` traces; None where
    none held it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = dict.fromkeys(names, 0.0)
        for event in prof.key_averages():
            for n in names:
                if n in event.key:
                    total[n] += event.self_device_time_total  # us
        if all(total.values()):
            break
    return {n: t / reps / 1000 if t else None for n, t in total.items()}


def device_times(label: str, dev, calls: dict) -> dict:
    """name -> {kernel: device ms or None} for each name -> (fn, kernel
    names) of `calls`, by device_ms; {} for each where the profiler fails
    (a measurement aid, not a check) or the device is not a card."""
    import torch

    if torch.device(dev).type != "cuda":
        return {k: {} for k in calls}
    try:
        return {k: device_ms(fn, 20, names) for k, (fn, names) in calls.items()}
    except Exception as e:
        print(f"[{label}] torch.profiler gave no device times: {e!r}", flush=True)
        return {k: {} for k in calls}


def device_total(times: dict):
    """The summed device time of one call's kernels; None unless each was measured."""
    vals = list(times.values())
    return None if not vals or None in vals else sum(vals)


def device_text(times: dict) -> str:
    return ", ".join(f"{n or 'all ops'} " + ("not measured" if t is None else f"{t:.4f} ms")
                     for n, t in times.items()) or "not measured"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved: int, ops: float) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) at the HBM rate, or the operations at
    the INT32 rate, whichever is longer."""
    by_bytes, by_ops = nbytes_moved / PEAK_BYTES * 1e3, ops / PEAK_INT_OPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations"}


# Integer operations the kernels do, counted from their loops (per 4x4
# block: a forward or inverse transform ~96, a quantization ~48, a rate
# ~64, prediction + residual + reconstruction + SSE ~96, the weighted
# Hadamard distortion of source and reconstruction ~128).
OPS_BLOCK_RD = 96 + 48 + 64 + 96 + 96 + 128  # transform, quantize, rate, inverse, distortion
OPS_TRELLIS_NODE = 40                          # one (position, level) node of the DP


def enc_ops(n_mb: int, n_i4: int, n_try: int, trellis: bool) -> float:
    """K5's operations over n_mb MBs of which n_i4 chose I4."""
    i16 = 4 * 16 * OPS_BLOCK_RD + 4 * (2 * 96 + 48 + 64)   # 4 modes x 16 blocks, Y2
    i4 = 16 * (10 * 48 + n_try * OPS_BLOCK_RD) if n_try else 0  # 10 predictions, n_try tried
    uv = 4 * 8 * OPS_BLOCK_RD
    ops = n_mb * (i16 + i4 + uv)
    if trellis:  # I16: 16 blocks x 3 entry contexts; I4: 16 subblocks again
        ops += (n_mb - n_i4) * 16 * 3 * 32 * OPS_TRELLIS_NODE
        ops += n_i4 * 16 * (32 * OPS_TRELLIS_NODE + OPS_BLOCK_RD)
    return ops


# Integer operations of one coder step (`csrc/boolenc.cuh` put: the split,
# the update, the closed-form renormalisation by a count of leading zeros,
# and a byte store every 8 bits or so),
# and of generating one op in K13 and K14 (the class or symbol, the table
# lookups of its node and probability); K13 also scans each MB's 400 levels
# once and its blocks' neighbours for the contexts.
OPS_CODER_STEP = 16
OPS_OP_GEN = 8
OPS_CTX_BLOCK = 16 + 2 * 16


# Integer operations a slot of the wire kernels (`csrc/wire.cu`): K18's
# gather, clip, compare, rank and store; K19's compare, rank and store (the
# fused kernel does both); K20's nibble pack and med-list rank per packed
# value, and its image-list scan per escape slot.
OPS_PREPACK_SLOT = 8
OPS_PACK_SLOT = 6
OPS_WIRE_VALUE = 6
OPS_LIST_SLOT = 12


def handoff_ms(dev) -> float:
    """One hand-over between row CTAs, in ms: chains of CTAs (HANDOFF_CHAINS)
    in which each waits for the one before with the row kernels' poll
    (ld.acquire.gpu) and then publishes as they do (fence + st.release.gpu);
    the longer chain's time less the shorter's over the CTAs between them,
    so that the launch cancels."""
    import torch

    from webp_tpu_torch import _build

    lib = _build.load()
    times = []
    for n in HANDOFF_CHAINS:
        flags = torch.zeros(n + 1, dtype=torch.int32, device=dev)

        def run():
            rc = lib.webp_handoff_chain(n, flags.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"webp_handoff_chain launch failed: CUDA error {rc}")

        times.append(time_ms(run, 20, flags.zero_))
        if int(flags[:n].sum()) != n:
            raise AssertionError(f"the hand-over chain of {n} CTAs did not finish")
    (n0, n1), (t0, t1) = HANDOFF_CHAINS, times
    return (t1 - t0) / (n1 - n0)


def ptxas_report() -> list:
    """The row-CTA kernel's three instances', K5's (both instances), K6's,
    K7's, K8's, K11's (four instances), K12's, K13-K15's, K18's, K19's, the
    fused K18 + K19's, K20's and K22's registers, shared memory and spills,
    from the build's ptxas report."""
    from webp_tpu_torch import _build

    names = {"rows_kernelILb1ELb0E": "recon", "rows_kernelILb0ELb1E": "loopfilter",
             "rows_kernelILb1ELb1E": "recon_filter",
             "enc_kernelILb0E": "enc<no trellis>", "enc_kernelILb1E": "enc<trellis>",
             "analysis_kernel": "analysis", "token_stats_kernel": "token_stats",
             "coeff_tokens_kernel": "coeff_tokens",
             "mb_headers_kernel": "mb_headers", "bool_lanes_kernel": "bool_lanes",
             "coder_chain_kernel": "coder_chain",
             "predictor_rows_kernel": "predictor", "prepack_pack_kernel": "prepack_pack",
             "prepack_kernel": "prepack", "pack_levels_kernel": "pack_levels",
             "wire_kernel": "wire", "enc_tables_kernel": "enc_tables",
             "color_indexing_kernelILi0E": "color_indexing<unpacked>",
             "color_indexing_kernel_2": "color_indexing<2 a byte>",
             "color_indexing_kernelILi2E": "color_indexing<4 a byte>",
             "color_indexing_kernelILi3E": "color_indexing<8 a byte>",
             "pack_flat_kernel": "pack_flat", "expand_flat_kernel": "expand_flat"}
    if not _build.PTXAS_REPORT.exists():  # a library built before the report was kept
        return []
    out, name = [], None
    for line in _build.PTXAS_REPORT.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in names.items() if k in line), None)
        elif name and ("spill" in line or "registers" in line or "smem" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def off_path(counts, keep: dict) -> None:
    """Adds K21's and K22's launches in one main-path run (`counts`, read
    just after it) to keep["flat_launches"], the kernels line's count for
    them: no path calls them."""
    total = keep.setdefault("flat_launches", dict.fromkeys(FLAT_NAMES, 0))
    for k in total:
        total[k] += counts[k]


def phase(name: str, fn, *args):
    """fn(*args), with its wall time printed: the run must end well inside
    its time limit, and the plain twins' host time sets most of it."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{name}] phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def decode_phase(dev, card: str, keep: dict) -> dict:
    """The decode path, counted, checked and timed; name -> kernel record.
    Leaves its batches (filter kind -> payloads) in keep["decode"]."""
    import torch

    from webp_tpu_torch import _build
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.ops import residual
    from webp_tpu_torch.ops.loopfilter import loop_filter_, loop_filter_plain_
    from webp_tpu_torch.ops.recon_filter import recon_filter_, recon_filter_plain_, resident_rows
    from webp_tpu_torch.ops.wavefront import recon_, recon_plain_
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb, fancy_yuv420_to_rgb_plain

    # 1. Inputs: two distinct frames per filter kind, tiled into batches of
    #    8, and the plain CPU decode of the distinct frames.
    t0 = time.perf_counter()
    batches, refs = {}, {}
    for simple in (False, True):
        made = make_payloads(WIDTH, HEIGHT, simple)
        for payload, i4, i16 in made:
            if i4 == 0 or i16 == 0:
                raise AssertionError(f"expected I4 and I16 MBs, got {i4} / {i16}")
            print(f"payload ({'simple' if simple else 'normal'} filter): {len(payload)} bytes, "
                  f"{i4} I4 MBs, {i16} I16 MBs", flush=True)
        distinct = [m[0] for m in made]
        batches[simple] = [distinct[i % len(distinct)] for i in range(BATCH)]
        refs[simple] = cpu_reference(distinct)
    print(f"write + plain CPU decode: {time.perf_counter() - t0:.1f} s", flush=True)
    keep["decode"] = batches
    host = tdev.parse_levels_batch(batches[False])
    nmb = (WIDTH + 15) // 16 * ((HEIGHT + 15) // 16)
    n_esc = int((host["esc_pos"] < nmb * 400).sum(1).min())
    if host["bitmap"] is None or n_esc == 0:
        raise AssertionError(f"main path must take the sparse form with escapes ({n_esc})")

    # 2. The main path, counted: both filter kinds, both outputs.
    _build.reset_launches()
    outs = {(simple, out): tdev.dispatch_decode_batch(batches[simple], out=out, device=dev)
            for simple in (False, True) for out in ("rgb", "yuv")}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    off_path(launches, keep)
    # One fused recon + filter launch a batch; K2 and K3 alone are off the path.
    expect = {"residual": len(outs), "recon_filter": len(outs), "recon": 0, "loopfilter": 0,
              "yuv2rgb": len(outs) // 2}
    counts = {k: launches[k] for k in expect}
    if counts != expect:
        raise AssertionError(f"main path launched {counts}, expected {expect}")
    mbw, mbh = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
    for (simple, out), got in outs.items():
        if got.device.type != "cuda":
            raise AssertionError(f"{out} output on {got.device}")
        want = refs[simple][0 if out == "rgb" else 1]
        got_h = got.cpu().numpy()
        if got_h.shape != (BATCH, *want.shape[1:]):
            raise AssertionError(f"{out} shape {got_h.shape}")
        for i in range(BATCH):
            if not (got_h[i] == want[i % len(want)]).all():
                raise AssertionError(f"image {i} ({out}, simple={simple}) differs from the "
                                     "plain CPU decode")
        if out == "yuv":
            host_rgb = tdev.yuv_packed_to_rgb(got_h, mbw, mbh, WIDTH, HEIGHT)
            if not (host_rgb == outs[(simple, "rgb")].cpu().numpy()).all():
                raise AssertionError("K4 RGB differs from the host C++ conversion")
    print(f"main path: bit-exact vs the plain CPU decode on 2 x {BATCH} images "
          f"(normal and simple filter, rgb and yuv); launches {launches}", flush=True)

    # 3. Each kernel against its plain twin, on the main path's inputs.
    d = tdev.to_device_batch(host, dev)
    _, _, simple, width, height = tdev.geometry(host["headers"])
    f = tdev.field_views(d["u8buf"], nmb)
    mb = (f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"])
    k1_args = [d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")] + list(mb)
    res, do_sub = residual.residuals_sparse(*k1_args)
    res_p, do_sub_p = residual.residuals_sparse_plain(*k1_args)
    i16buf = torch.from_numpy(host["i16buf"]).to(dev)
    dense = residual.residuals_dense(i16buf, *mb)
    err = {"residual": max(max_abs_err(res, res_p), max_abs_err(do_sub, do_sub_p),
                           max_abs_err(dense[0], res_p), max_abs_err(dense[1], do_sub_p))}

    def planes():
        packed = torch.zeros((BATCH, nmb * 384), dtype=torch.uint8, device=dev)
        return tdev.split_planes(packed, mbw, mbh)

    recon_args = (res, f["luma_mode"], f["bpred"], f["chroma_mode"])
    rec, rec_p = planes(), planes()
    target, target_p = planes(), planes()
    recon_(*rec, *recon_args)
    recon_plain_(*rec_p, *recon_args)
    err["recon"] = max(max_abs_err(a, b) for a, b in zip(rec, rec_p))

    lf_args = (f["level"], f["interior"], f["hev"], do_sub)
    err["loopfilter"] = err["recon_filter"] = 0
    filtered = None
    main_planes = tdev.split_planes(outs[(simple, "yuv")], mbw, mbh)
    for kind in (simple, not simple):
        got = [p.clone() for p in rec_p]
        want = [p.clone() for p in rec_p]
        loop_filter_(*got, *lf_args, kind)
        loop_filter_plain_(*want, *lf_args, kind)  # the fused kernel's twin: K2's, then K3's
        err["loopfilter"] = max(err["loopfilter"], *(max_abs_err(a, b) for a, b in zip(got, want)))
        fused = planes()
        recon_filter_(*fused, *recon_args, *lf_args, kind)
        err["recon_filter"] = max(err["recon_filter"],
                                  *(max_abs_err(a, b) for a, b in zip(fused, want)))
        if kind == simple:
            filtered = got
            err["recon_filter"] = max(err["recon_filter"],
                                      *(max_abs_err(a, b) for a, b in zip(fused, main_planes)))
    out = fancy_yuv420_to_rgb(*filtered, width, height)
    out_p = fancy_yuv420_to_rgb_plain(*filtered, width, height)
    err["yuv2rgb"] = max(max_abs_err(out, out_p), max_abs_err(out, outs[(False, "rgb")]))
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"kernels differ from their plain twins: {bad}")
    print(f"kernels vs plain twins (bit-exact, tolerance 0): {err}", flush=True)

    # 4. Timings, kernel beside plain twin, at the main path's shapes.  The
    #    filter works in place, so each run starts from fresh unfiltered planes.
    work = [p.clone() for p in rec]

    def fresh():
        for w, r in zip(work, rec):
            w.copy_(r)

    ms = {
        "residual": time_ms(lambda: residual.residuals_sparse(*k1_args), 50),
        "recon": time_ms(lambda: recon_(*target, *recon_args), 20),
        "loopfilter": time_ms(lambda: loop_filter_(*work, *lf_args, simple), 20, fresh),
        "recon_filter": time_ms(lambda: recon_filter_(*target, *recon_args, *lf_args, simple), 20),
        "yuv2rgb": time_ms(lambda: fancy_yuv420_to_rgb(*filtered, width, height), 50),
    }
    plain_ms = {
        "residual": time_ms(lambda: residual.residuals_sparse_plain(*k1_args), 5),
        "recon": time_ms(lambda: recon_plain_(*target_p, *recon_args), 1),
        "loopfilter": time_ms(lambda: loop_filter_plain_(*work, *lf_args, simple), 1, fresh),
        "yuv2rgb": time_ms(lambda: fancy_yuv420_to_rgb_plain(*filtered, width, height), 5),
    }
    # The fused kernel's twin is K2's then K3's, both warmed up just above.
    plain_ms["recon_filter"] = timed(lambda: recon_filter_plain_(
        *target_p, *recon_args, *lf_args, simple))[1]
    dense_ms = time_ms(lambda: residual.residuals_dense(i16buf, *mb), 50)
    dev_ms = device_times("decode", dev, {
        "residual": (lambda: residual.residuals_sparse(*k1_args), FLAGSHIP_DEVICE["residual"]),
        "residual_dense": (lambda: residual.residuals_dense(i16buf, *mb),
                           FLAGSHIP_DEVICE["residual"]),
        "yuv2rgb": (lambda: fancy_yuv420_to_rgb(*filtered, width, height),
                    FLAGSHIP_DEVICE["yuv2rgb"])})
    for name, _, _ in DECODE_KERNELS:
        device = f", device time {device_text(dev_ms[name])}" if name in dev_ms else ""
        print(f"{name}: {ms[name]:.4f} ms kernel (the call){device}, {plain_ms[name]:.4f} ms "
              f"plain (batch {BATCH} at {WIDTH}x{HEIGHT}; {card})", flush=True)
    dense_bound = bound(nbytes(i16buf, *mb, res, do_sub), BATCH * nmb * 25 * (16 + 96))
    print(f"residual from dense int16 levels (the overflow route): {dense_ms:.4f} ms kernel (the "
          f"call), device time {device_text(dev_ms['residual_dense'])}, bound "
          f"{dense_bound['bound_ms']:.4f} ms by {dense_bound['bound_by']} (batch {BATCH} at "
          f"{WIDTH}x{HEIGHT}; {card})", flush=True)
    # K3's branches depend on the pixels: its time on planes it has already
    # filtered, beside the time on the main path's planes above.
    refilter_ms = time_ms(lambda: loop_filter_(*work, *lf_args, simple), 20)
    print(f"loopfilter on already-filtered planes: {refilter_ms:.4f} ms kernel ({card})",
          flush=True)

    def plain_core():
        r, ds = residual.residuals_sparse_plain(*k1_args)
        p = planes()
        recon_filter_plain_(*p, r, f["luma_mode"], f["bpred"], f["chroma_mode"], f["level"],
                            f["interior"], f["hev"], ds, simple)
        return fancy_yuv420_to_rgb_plain(*p, width, height)

    core_ms = time_ms(lambda: tdev.decode_core(d, "rgb"), 20)
    core_plain_ms = time_ms(plain_core, 1)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        tdev.dispatch_decode_batch(batches[False], out="rgb", device=dev)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1000 / reps
    print(f"decode_core (device, uploaded batch): {core_ms / BATCH:.4f} ms/img kernels "
          f"(one-block K2 + K3: {ONE_BLOCK_MS['decode_core']:.4f}), "
          f"{core_plain_ms / BATCH:.4f} ms/img plain twins ({card})", flush=True)
    print(f"dispatch_decode_batch (host parse + upload + kernels, host clock): "
          f"{e2e_ms / BATCH:.4f} ms/img ({card})", flush=True)

    # Bounds: the bytes of each kernel's inputs and outputs, and its
    # operations (K1: dequant + inverse transform per block; K2: prediction,
    # add and clip per pixel; K3: ~20 per pixel over its edge filters; K4:
    # upsampling and conversion per output pixel).  No single PyTorch call
    # computes any of them.  The row kernels also have a floor of T MB
    # hand-overs between rows, each timed on a chain of CTAs that wait and
    # publish as the kernels do.
    pixels = BATCH * nmb * 384
    bounds = {
        "residual": bound(nbytes(*k1_args, res, do_sub), BATCH * nmb * 25 * (16 + 96)),
        "recon": bound(nbytes(*recon_args, *rec), pixels * 8),
        "loopfilter": bound(2 * nbytes(*rec) + nbytes(*lf_args), pixels * 20),
        "recon_filter": bound(nbytes(*recon_args, *lf_args, *rec), pixels * 28),
        "yuv2rgb": bound(nbytes(*filtered, out), BATCH * width * height * 25),
    }
    steps = mbw + 2 * (mbh - 1)
    hand_ms = keep["handoff_ms"] = handoff_ms(dev)
    resident = ({k: resident_rows(dev, *v) for k, v in ROW_KERNELS.items()}
                if torch.device(dev).type == "cuda" else "n/a")
    print(f"row hand-over (ld.acquire poll -> st.release, chains of {HANDOFF_CHAINS} CTAs): "
          f"{hand_ms * 1e3:.3f} us; chain floor T x hand-over = {steps} x that = "
          f"{steps * hand_ms:.4f} ms ({card})", flush=True)
    for name in ROW_KERNELS:
        before = f", one-block kernel {ONE_BLOCK_MS[name]:.4f} ms" if name in ONE_BLOCK_MS else ""
        print(f"{name}: {ms[name]:.4f} ms{before}; {ms[name] / steps * 1e3:.2f} us a wavefront "
              f"step (T = {steps}); bound {bounds[name]['bound_ms']:.4f} ms "
              f"({bounds[name]['bound_by']}), chain floor {steps * hand_ms:.4f} ms; "
              f"resident row CTAs {resident if isinstance(resident, str) else resident[name]} "
              f"for {BATCH * mbh} ({card})", flush=True)
    return {name: {"launches": launches[name], "max_abs_err": err[name], "ms": ms[name],
                   **({"device_ms": device_total(dev_ms[name])} if name in dev_ms else {}),
                   "plain_ms": plain_ms[name], **bounds[name], "library_ms": None}
            for name, _, _ in DECODE_KERNELS}


def encode_inputs(width: int, height: int):
    """The distinct seeded synthetic frames, and the batch of BATCH they tile."""
    _import_paths()
    from synthetic_rgb import synthetic_frame

    distinct = [synthetic_frame(width, height, s) for s in ENC_SEEDS]
    return distinct, [distinct[i % len(distinct)] for i in range(BATCH)]


def plain_analysis(distinct, method: int, segments: bool):
    """The port's plain analysis of the distinct frames on the CPU, for both
    flows: two_pass -> (per-image arrays, probabilities, segmentations)."""
    _import_paths()
    from webp_tpu_torch.encode import device as edev

    planes = edev.rgb_to_planes(distinct)
    return {two_pass: edev.analyze_frames_lossy_batch(planes, QUALITY, method, two_pass, segments,
                                                      device="cpu")
            for two_pass in (True, False)}


def encode_reference(distinct, method: int, segments: bool, analysis=None):
    """The port's plain encode of the distinct frames on the CPU (from
    `analysis`, `plain_analysis`'s, when given), for both flows: two_pass ->
    (per-image arrays, payloads, segmentations)."""
    _import_paths()
    from webp_tpu_torch.encode import device as edev

    height, width = distinct[0].shape[:2]
    analysis = analysis or plain_analysis(distinct, method, segments)
    return {two_pass: (arrays, edev.finish_frames_lossy_batch(
                arrays, probs, QUALITY, width, height, PARTITIONS, segs), segs)
            for two_pass, (arrays, probs, segs) in analysis.items()}


def reference_worker() -> None:
    """Initialises a worker process of the plain CPU encodes."""
    import torch

    _import_paths()
    torch.set_num_threads(2)


def reference_job(method: int, segments: bool):
    """(encode_reference of the full-size frames, their two-pass payloads at
    one partition as the encoder API codes a lossy still, its seconds), in
    a worker."""
    from webp_tpu_torch.encode import device as edev

    t0 = time.perf_counter()
    distinct = encode_inputs(WIDTH, HEIGHT)[0]
    analysis = plain_analysis(distinct, method, segments)
    ref = encode_reference(distinct, method, segments, analysis)
    arrays, probs, segs = analysis[True]
    one_partition = edev.finish_frames_lossy_batch(arrays, probs, QUALITY, WIDTH, HEIGHT, 1, segs)
    return ref, one_partition, time.perf_counter() - t0


def mode_counts(arrays):
    """(I4 MBs, I16 MBs, distinct chroma modes) over per-image arrays."""
    import numpy as np

    lm = np.concatenate([a["luma_mode"] for a in arrays])
    cm = np.concatenate([a["chroma_mode"] for a in arrays])
    return int((lm == 4).sum()), int((lm != 4).sum()), len(set(cm.tolist()))


def check_reference(ref, segments: bool) -> str:
    """Asserts that the reference encode covers the path: I4 and I16 MBs, 3+
    chroma modes, and with segments on, segmentation with the update map and
    2+ segment ids on every frame.  Returns a summary."""
    n_i4, n_i16, n_chroma = mode_counts(ref[True][0])
    if n_i4 == 0 or n_i16 == 0 or n_chroma < 3:
        raise AssertionError(f"expected I4 and I16 MBs and 3+ chroma modes, got {n_i4} / "
                             f"{n_i16} / {n_chroma}")
    summary = f"{n_i4} I4 and {n_i16} I16 MBs, {n_chroma} chroma modes"
    if segments:
        for two_pass, (_, _, segs) in ref.items():
            for s in segs:
                used = len(set(s.segment_map.tolist()))
                if not (s.enabled and s.update_map and used >= 2):
                    raise AssertionError(f"two_pass={two_pass}: segmentation {s.enabled}, update "
                                         f"map {s.update_map}, {used} segment ids")
        segs = ref[True][2]
        summary += (f"; segment ids used {[len(set(s.segment_map.tolist())) for s in segs]}, "
                    f"quant deltas {[[x.quantizer_level for x in s.segments] for s in segs]}")
    return summary


def stage_timer(ms: dict):
    """stage(name, fn) -> fn(), with ms[name] = (host-clock ms, CUDA-event
    ms) of that run, ended by a synchronise."""
    def stage(name, fn):
        out, host, event = both_clocks(fn)
        ms[name] = (host, event)
        return out
    return stage


def lossy_stages(planes, width: int, height: int, dev, quality: int, method: int,
                 segments: bool, partitions: int, stage, device_tokens: bool = False):
    """The two-pass encode of host planes (Y, U, V) [B, ...] as
    `encode_frames_lossy_batch` runs it, each stage through `stage`:
    (payloads, the bytes that came back from the device after pass 2: the
    host finisher's wire rows and the dense int8 rows of sp_over images, or
    the device tokens')."""
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops import wire
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch

    n_try = edev.n_try_for(method)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    y, u, v = stage("upload", lambda: edev.upload(planes, dev))

    def segment():
        segs = edev.segment(y, u, v, quality) if segments else None
        return segs, edev.params_for(segs, quality, dev)

    def pass1():
        default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
        return edev.encode_analysis_stats_batch(y, u, v, P, default, min(n_try, 3), sid)

    segs, (P, sid) = stage("segment", segment)
    totals, ones = stage("pass1", pass1)
    probs = stage("stats_d2h_probs",
                  lambda: edev.adapt_probs(totals.cpu().numpy(), ones.cpu().numpy()))
    tables = stage("tables", lambda: edev.tables_for(probs, dev))
    arrays = stage("pass2", lambda: encode_analysis_batch(y, u, v, P, tables, n_try,
                                                          method >= 4, sid))
    if device_tokens:
        skipped, lanes = stage("encode_tokens", lambda: edev.encode_tokens(
            arrays, probs, mbw, mbh, partitions))
        tokens = stage("fetch_tokens", lambda: edev.fetch_tokens(arrays, skipped, lanes, sid))
        coders = stage("header_coders", lambda: edev.header_coders(tokens, probs, quality, segs))
        headers = stage("mb_headers", lambda: edev.code_mb_headers(tokens, coders, mbw, mbh,
                                                                    segs))
        payloads = stage("assemble", lambda: edev.assemble(tokens, coders, headers, width,
                                                           height))
        return payloads, tokens.meta.nbytes + sum(a.nbytes for a in (*tokens.parts, *headers))

    def pack():
        pre = wire.prepack_pack(arrays)
        return pre[0], wire.wire(*pre[5:], *pre[1:5])

    lv8, rows = stage("wire", pack)
    host = stage("d2h", lambda: edev.fetch_packed(lv8, rows, arrays))
    payloads = stage("finish", lambda: edev.finish_frames_lossy_batch(
        host, probs, quality, width, height, partitions, segs))
    flags = rows[:, :2].cpu().numpy()
    return payloads, nbytes(rows) + (nbytes(*arrays.values()) if flags[:, 1].any()
                                     else int(flags[:, 0].sum()) * nbytes(lv8[0]))


def encode_stages(rgbs, dev, method: int, segments: bool, device_tokens: bool = False,
                  reps: int = 3):
    """Host-clock ms per stage of the two-pass encode (`lossy_stages` after
    the colour conversion), the median of `reps` runs after a warm-up; also
    the bytes that came back from the device after pass 2, and the
    payloads."""
    from webp_tpu_torch.encode import device as edev

    height, width = rgbs[0].shape[:2]
    runs = []
    for _ in range(reps + 1):
        runs.append({})
        stage = stage_timer(runs[-1])
        planes = stage("rgb_to_yuv", lambda: edev.rgb_to_planes(rgbs))
        payloads, d2h = lossy_stages(planes, width, height, dev, QUALITY, method, segments,
                                     PARTITIONS, stage, device_tokens)
    ms = {n: statistics.median(r[n][0] for r in runs[1:]) for n in runs[0]}
    return ms, d2h, payloads


def encode_phase(dev, card: str, method: int, segments: bool, pending, keep: dict) -> dict:
    """One encode path, counted, checked and timed; name -> kernel record.
    `pending` is the worker's `reference_job(method, segments)`.  The
    flagship leaves its planes, parameters, pass-2 arrays, probabilities,
    two-pass payloads and the plain one-partition payloads in
    keep["flagship"]."""
    import numpy as np
    import torch

    from webp_tpu_torch import _build, encode_frames_lossy_batch
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.encode import vp8 as tvp8
    from webp_tpu_torch.encode.contexts import compute_contexts
    from webp_tpu_torch.io import native
    from webp_tpu_torch.ops.analysis import analyze_alphas_batch, analyze_alphas_batch_plain
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.enc_tables import enc_tables, enc_tables_plain
    from webp_tpu_torch.ops.encode_wavefront import (encode_analysis_batch,
                                                     encode_analysis_batch_plain)
    from webp_tpu_torch.ops.token_stats import token_stats, token_stats_levels, token_stats_plain

    mbw, mbh = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
    nmb = mbw * mbh
    name = f"Q{QUALITY} m{method}, segments {'on' if segments else 'off'}, {PARTITIONS} partitions"
    n_try, trellis = edev.n_try_for(method), method >= 4
    kernels = [k for k, _, _ in ENCODE_KERNELS + WIRE_KERNELS if segments or k != "analysis"]
    wire_on = {"prepack": 0, "pack_levels": 0, "prepack_pack": 1, "wire": 1}
    flat_off = dict.fromkeys(FLAT_NAMES, 0)
    flagship = (method, segments) == ENCODES[-1]

    # 1. Inputs: two distinct frames tiled into a batch of 8, and the plain
    #    CPU encode of the distinct frames (from the worker).
    distinct, rgbs = encode_inputs(WIDTH, HEIGHT)
    t0 = time.perf_counter()
    ref, one_partition, ref_s = pending.get()
    summary = check_reference(ref, segments)
    print(f"[{name}] plain CPU encode (both flows, worker process): {ref_s:.1f} s, waited "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{summary}; payloads {[len(p) for p in ref[True][1]]} bytes (two-pass), "
          f"{[len(p) for p in ref[False][1]]} bytes (one-pass)", flush=True)

    # 2. The main path, counted: two-pass, then one-pass.
    launches = {k: 0 for k in kernels}
    payloads = {}
    edev.WIRE_BRANCHES.update(dict.fromkeys(edev.WIRE_BRANCHES, 0))
    for two_pass, expect in ((True, {"enc": 2, "token_stats": 1, "enc_tables": 1, **wire_on,
                                     **flat_off}),
                             (False, {"enc": 1, "token_stats": 0, "enc_tables": 0, **wire_on,
                                      **flat_off})):
        if segments:
            expect["analysis"] = 1
        _build.reset_launches()
        got = encode_frames_lossy_batch(rgbs, QUALITY, method, two_pass, segments,
                                        num_partitions=PARTITIONS, device=dev)
        torch.cuda.synchronize()
        counts = {k: _build.LAUNCHES[k] for k in [*kernels, *FLAT_NAMES]}
        if counts != expect:
            raise AssertionError(f"two_pass={two_pass} launched {counts}, expected {expect}")
        off_path(counts, keep)
        for k in kernels:
            launches[k] += counts[k]
        for i, p in enumerate(got):
            if p != ref[two_pass][1][i % len(distinct)]:
                raise AssertionError(f"image {i} (two_pass={two_pass}) differs from the plain "
                                     "CPU encode")
        payloads[two_pass] = got
    print(f"[{name}] main path: byte-equal to the plain CPU encode on 2 x {BATCH} images "
          f"(two-pass and one-pass); launches {launches}; images by wire branch "
          f"{edev.WIRE_BRANCHES}", flush=True)

    # The device-token flow, counted: the same payloads as the host finisher.
    expect = {"enc": 2, "token_stats": 1, "enc_tables": 1, "coeff_tokens": 1, "mb_headers": 1,
              "bool_lanes": 0, **dict.fromkeys(wire_on, 0), **flat_off,
              **({"analysis": 1} if segments else {})}
    _build.reset_launches()
    got = encode_frames_lossy_batch(rgbs, QUALITY, method, True, segments,
                                    num_partitions=PARTITIONS, device=dev, device_tokens=True)
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] for k in expect}
    if counts != expect:
        raise AssertionError(f"device_tokens launched {counts}, expected {expect}")
    off_path(counts, keep)
    if got != payloads[True]:
        raise AssertionError("the device-token payloads differ from the host finisher's")
    for k in kernels:
        launches[k] += counts[k]
    token_launches = {k: counts[k] for k, _, _ in TOKEN_KERNELS}
    print(f"[{name}] device-token path: byte-equal to the host finisher's payloads on {BATCH} "
          f"images; launches {counts}", flush=True)

    # 3. Each kernel against its plain twin, on the main path's card inputs
    #    (the twins' single runs timed by CUDA events).
    y, u, v = edev.upload(edev.rgb_to_planes(rgbs), dev)
    err, plain_ms = {}, {}
    segs = None
    if segments:
        alphas = analyze_alphas_batch(y, u, v)
        alphas_p, plain_ms["analysis"] = timed(lambda: analyze_alphas_batch_plain(y, u, v))
        err["analysis"] = max(max_abs_err(a, b) for a, b in zip(alphas, alphas_p))
        segs = edev.segment(y, u, v, QUALITY)
    P, sid = edev.params_for(segs, QUALITY, dev)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    p1_args = (y, u, v, P, default, min(n_try, 3), False, sid)
    pass1 = encode_analysis_batch(*p1_args)
    err["enc"], p1_plain_ms = 0, None
    if trellis:  # else pass 2's twin below runs the same kernel instance
        pass1_p, p1_plain_ms = timed(lambda: encode_analysis_batch_plain(*p1_args))
        err["enc"] = max(max_abs_err(pass1[k], pass1_p[k]) for k in pass1)
    stat_args = (pass1["luma_mode"], pass1["y2_levels"], pass1["y_levels"], pass1["uv_levels"],
                 edev.skip_flags(pass1), mbw, mbh)
    # K6 by both routes: the skip flags given, and derived in the kernel (pass 1's).
    lv_args = (*stat_args[:4], mbw, mbh)
    stats = token_stats(*stat_args)
    stats_p, plain_ms["token_stats"] = timed(lambda: token_stats_plain(*stat_args))
    err["token_stats"] = max(max_abs_err(a, b) for a, b in
                             zip((*stats, *token_stats_levels(*lv_args)), (*stats_p, *stats_p)))
    for i, a in enumerate(edev.fetch(pass1)):  # the host C++ statistics of the token stream
        ctx = compute_contexts(a["luma_mode"], a["y2_levels"], a["y_levels"], a["uv_levels"],
                               mbw, mbh)
        levels, meta = tvp8.token_stream(a, ctx, tvp8.skip_flags(a), mbw)
        for got, host in zip(stats, native.vp8_token_stats(levels, meta)):
            err["token_stats"] = max(err["token_stats"],
                                     max_abs_err(got[i], torch.from_numpy(host).to(dev)))
    probs = torch.from_numpy(edev.adapt_probs(stats[0].cpu().numpy(),
                                              stats[1].cpu().numpy())).to(dev)
    tables = enc_tables(probs)
    tables_p, plain_ms["enc_tables"] = timed(lambda: enc_tables_plain(probs))
    err["enc_tables"] = max(max_abs_err(getattr(tables, f), getattr(tables_p, f))
                            for f in EncTables.FIELDS)
    p2_args = (y, u, v, P, tables, n_try, trellis, sid)
    pass2 = encode_analysis_batch(*p2_args)
    pass2_p, plain_ms["enc"] = timed(lambda: encode_analysis_batch_plain(*p2_args))
    err["enc"] = max(err["enc"], max(max_abs_err(pass2[k], pass2_p[k]) for k in pass2))
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"kernels differ from their plain twins: {bad}")
    pass1_checked = (f"pass 1 at n_try {min(n_try, 3)} with the default tables, "
                     if trellis else "")
    print(f"[{name}] kernels vs plain twins (bit-exact, tolerance 0; K5 {pass1_checked}pass 2 "
          f"at n_try {n_try} with per-image tables{', trellis' if trellis else ''}"
          f"{', segment ids' if segments else ''}; K6 also vs the host C++ statistics): {err}",
          flush=True)

    # 4. Round trip: the card's payloads through the decode kernels.
    decoded = tdev.dispatch_decode_batch(payloads[True], out="rgb", device=dev).cpu().numpy()
    want_rgb, _ = cpu_reference(ref[True][1])
    psnr = []
    for i in range(BATCH):
        if not (decoded[i] == want_rgb[i % len(distinct)]).all():
            raise AssertionError(f"image {i}: the card's decode of the card's payload differs "
                                 "from the plain CPU decode")
    for img, src in zip(decoded, distinct):
        mse = np.mean((img.astype(np.float64) - src) ** 2)
        psnr.append(10 * np.log10(255 ** 2 / mse))
    print(f"[{name}] round trip: the card's payloads decode through K1-K4 bit-exact with the "
          f"plain CPU decode; PSNR vs source {[round(float(x), 4) for x in psnr]} dB", flush=True)

    # 5. Timings at the main path's shapes, kernel beside plain twin and bound.
    ms = {
        "enc": time_ms(lambda: encode_analysis_batch(*p2_args), 10),
        "token_stats": time_ms(lambda: token_stats_levels(*lv_args), 20),
        "enc_tables": time_ms(lambda: enc_tables(probs), 20),
    }
    p1_ms = time_ms(lambda: encode_analysis_batch(*p1_args), 10)
    planes_in = (y, u, v)
    n_i4_1 = int((pass1["luma_mode"] == 4).sum())
    n_i4_2 = int((pass2["luma_mode"] == 4).sum())
    bounds = {
        "enc": bound(nbytes(*planes_in, tables.cls_cost, tables.eob_cost, tables.init_cost,
                            *pass2.values()),
                     enc_ops(BATCH * nmb, n_i4_2, n_try, trellis)),
        "token_stats": bound(nbytes(*stat_args[:5], *stats), BATCH * nmb * 25 * 16 * 12),
        "enc_tables": bound(nbytes(probs, *(getattr(tables, f) for f in EncTables.FIELDS)),
                            BATCH * 4 * 16 * 3 * (68 + 11 + 2) * 33),
    }
    p1_bound = bound(nbytes(*planes_in) + nbytes(*pass1.values()),
                     enc_ops(BATCH * nmb, n_i4_1, min(n_try, 3), False))
    dev_calls = {"token_stats": (lambda: token_stats_levels(*lv_args),
                                 FLAGSHIP_DEVICE["token_stats"]),
                 "enc_tables": (lambda: enc_tables(probs), FLAGSHIP_DEVICE["enc_tables"])}
    if segments:
        ms["analysis"] = time_ms(lambda: analyze_alphas_batch(y, u, v), 20)
        bounds["analysis"] = bound(nbytes(*planes_in, *alphas), BATCH * nmb * 48 * 160)
        dev_calls["analysis"] = (lambda: analyze_alphas_batch(y, u, v),
                                 FLAGSHIP_DEVICE["analysis"])
    dev_ms = device_times(name, dev, dev_calls)
    shape = f"batch {BATCH} at {WIDTH}x{HEIGHT}; {card}"
    p1_plain = "not run" if p1_plain_ms is None else f"{p1_plain_ms:.4f} ms"
    print(f"[{name}] enc pass 1 (default tables, n_try {min(n_try, 3)}): {p1_ms:.4f} ms kernel, "
          f"{p1_plain} plain, bound {p1_bound['bound_ms']:.4f} ms by "
          f"{p1_bound['bound_by']} ({shape})", flush=True)
    for k in (k for k in kernels if k not in wire_on):  # wire_phase prints K18-K20
        what = (f" pass 2 (per-image tables, n_try {n_try}{', trellis' if trellis else ''})"
                if k == "enc" else "")
        device = (f" (the call), device time {device_text(dev_ms[k])} (profiler)"
                  if k in dev_ms else "")
        print(f"[{name}] {k}{what}: {ms[k]:.4f} ms kernel{device}, {plain_ms[k]:.4f} ms plain, "
              f"bound {bounds[k]['bound_ms']:.4f} ms by {bounds[k]['bound_by']} ({shape})",
              flush=True)
    stage_ms, nb, staged = encode_stages(rgbs, dev, method, segments)
    tok_stage_ms, tok_nb, tok_staged = encode_stages(rgbs, dev, method, segments, True)
    if staged != payloads[True] or tok_staged != payloads[True]:
        raise AssertionError("the staged encode differs from the main path")
    # End to end in alternating runs of the two flows (the host clock swings).
    e2e = {False: [], True: []}
    for tokens in (False, True, True, False, False, True):
        t0 = time.perf_counter()
        encode_frames_lossy_batch(rgbs, QUALITY, method, True, segments,
                                  num_partitions=PARTITIONS, device=dev, device_tokens=tokens)
        torch.cuda.synchronize()
        e2e[tokens].append((time.perf_counter() - t0) * 1000 / BATCH)
    for flow, st in (("host finish", stage_ms), ("device tokens", tok_stage_ms)):
        split = ", ".join(f"{k} {x / BATCH:.4f}" for k, x in st.items())
        print(f"[{name}] encode_frames_lossy_batch stages, {flow} (host clock, ms/img): {split} "
              f"({card})", flush=True)
    copy_ms = time_ms(lambda: [a.cpu() for a in pass2.values()], 10)
    print(f"[{name}] pass-2 d2h: host finisher {nb // BATCH} bytes/img (the wire rows, "
          f"{stage_ms['d2h'] / BATCH:.4f} ms/img with the copy of sp_over images' dense rows); "
          f"the dense arrays {nbytes(*pass2.values()) // BATCH} bytes/img, their copy alone "
          f"{copy_ms / BATCH:.4f} ms/img (CUDA events); device tokens: {tok_nb // BATCH} bytes/img "
          f"(modes, skip flags, lanes, partition and header bytes) ({card})", flush=True)
    print(f"[{name}] encode_frames_lossy_batch (two-pass, host clock, alternating runs): host "
          f"finish {statistics.median(e2e[False]):.4f} ms/img "
          f"{[round(x, 4) for x in e2e[False]]}, device tokens "
          f"{statistics.median(e2e[True]):.4f} ms/img {[round(x, 4) for x in e2e[True]]} "
          f"({card})", flush=True)
    # No single PyTorch call computes any of these functions.
    wire_records = wire_phase(dev, card, name, pass2)
    records = {k: {"launches": launches[k], "max_abs_err": err[k], "ms": ms[k],
                   **({"device_ms": device_total(dev_ms[k])} if k in dev_ms else {}),
                   "plain_ms": plain_ms[k], **bounds[k], "library_ms": None}
               for k in kernels if k not in wire_records}
    records.update({k: {"launches": launches[k], **r} for k, r in wire_records.items()})
    if flagship:
        keep["flagship"] = dict(planes=(y, u, v), P=P, sid=sid, segs=segs, pass2=pass2,
                                one_partition=one_partition,
                                probs=probs.cpu().numpy(), payloads=payloads[True], n_try=n_try)
        tok = token_phase(dev, card, name, pass2, probs, sid, segs, mbw, mbh)
        for k, r in tok.items():
            records[k] = {"launches": token_launches[k], **r}
    else:  # K13 and K14 on this phase's arrays; the payloads above checked K15
        records.update({k: {"launches": n, "max_abs_err": 0} for k, n in token_launches.items()})
        err, plain, (_, lanes) = coeff_tokens_vs_twin(pass2, probs, mbw, mbh)
        err_h, plain_h, (_, params, *_) = mb_headers_vs_twin(pass2, probs.cpu().numpy(), sid,
                                                             segs, lanes, mbw, mbh)
        if err != 0 or err_h != 0:
            raise AssertionError(f"coeff_tokens / mb_headers differ from their plain twins by "
                                 f"{err} / {err_h}")
        records["coeff_tokens"]["max_abs_err"] = err
        records["mb_headers"]["max_abs_err"] = err_h
        print(f"[{name}] coeff_tokens and mb_headers vs plain twins on this phase's pass-2 arrays "
              f"(bit-exact, tolerance 0; segment map written in {int(params[:, 0].sum())} of "
              f"{BATCH} images): {err}, {err_h}; "
              f"plain {plain:.4f} / {plain_h:.4f} ms", flush=True)
    return records


def wire_phase(dev, card: str, name: str, pass2) -> dict:
    """K18, K19 (at caps 256 and 100), the fused K18 + K19 and K20 against
    their plain twins on the card's pass-2 arrays, timed beside their
    bounds; the wire path (the fused kernel and K20, the rows' d2h and the
    host unpack in a pool) beside the dense fetch of the same arrays, in
    alternating runs; and the overflow case: seeded arrays
    (`tests/wire_inputs.py`) that set every flag, every kernel's outputs
    equal to the twins', and `fetch_packed` returning the arrays exactly
    through each branch.  name -> kernel record without launches."""
    import torch

    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops import wire
    from webp_tpu_torch.ops.sparse import pack_levels_mb, pack_levels_mb_plain
    from wire_inputs import wire_arrays

    B, nmb = pass2["luma_mode"].shape
    cap, cap_small = wire.CAP_MB, 100

    def kernels(arrays):  # each kernel's outputs, in WIRE_KERNELS' order
        pre = wire.prepack(arrays)
        packed = pack_levels_mb(pre[0], cap)
        return (pre, (*packed, *pack_levels_mb(pre[0], cap_small)), wire.prepack_pack(arrays),
                (wire.wire(*packed, *pre[1:]),))

    def twins(arrays):
        pre = wire.prepack_plain(arrays)
        packed = pack_levels_mb_plain(pre[0], cap)
        return (pre, (*packed, *pack_levels_mb_plain(pre[0], cap_small)), (*pre, *packed),
                (wire.wire_plain(*packed, *pre[1:]),))

    def errors(got, want):
        return {k: max(max_abs_err(a, b) for a, b in zip(g, w))
                for (k, _, _), g, w in zip(WIRE_KERNELS, got, want)}

    # 1. The kernels on pass 2's arrays; each twin timed alone on the
    #    kernels' own inputs.
    pre, packed, fused, (rows,) = kernels(pass2)
    packed = packed[:3]
    err = errors((pre, packed, fused, (rows,)), twins(pass2))
    plain_ms = {}
    _, plain_ms["prepack"] = timed(lambda: wire.prepack_plain(pass2))
    _, plain_ms["pack_levels"] = timed(lambda: pack_levels_mb_plain(pre[0], cap))
    _, plain_ms["prepack_pack"] = timed(lambda: wire.prepack_pack_plain(pass2))
    _, plain_ms["wire"] = timed(lambda: wire.wire_plain(*packed, *pre[1:]))

    # 2. The overflow case, at the same shapes.
    arrays_h, _, flags = wire_arrays(B, nmb, WIRE_SEED)
    over = {k: torch.from_numpy(a).to(dev) for k, a in arrays_h.items()}
    o_pre, o_packed, o_fused, (o_rows,) = kernels(over)
    for k, e in errors((o_pre, o_packed, o_fused, (o_rows,)), twins(over)).items():
        err[k] = max(err[k], e)
    if not (o_rows[:, :2].cpu().numpy() == flags).all():
        raise AssertionError(f"overflow case: flags {o_rows[:, :2].tolist()}, expected "
                             f"{flags.tolist()}")
    want = edev.fetch(over)
    keep = [i for i in range(B) if not flags[i, 1]]
    sub = {k: t[keep] for k, t in over.items()}
    before = dict(edev.WIRE_BRANCHES)
    for got, idx in ((edev.fetch_packed(o_pre[0], o_rows, over), range(B)),
                     (edev.fetch_packed(o_pre[0][keep], o_rows[keep], sub), keep)):
        for g, i in zip(got, idx):
            if any(not (g[k] == want[i][k]).all() for k in want[i]):
                raise AssertionError(f"overflow case: fetch_packed's image {i} differs")
    taken = {k: edev.WIRE_BRANCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"wire kernels differ from their plain twins: {bad}")
    print(f"[{name}] wire kernels vs plain twins (bit-exact, tolerance 0; K19 at caps {cap} and "
          f"{cap_small}; on the card's pass-2 arrays and on the overflow case, flags "
          f"{flags.tolist()} as expected; fetch_packed exact, images by branch {taken}): {err}",
          flush=True)

    # 3. Timings beside the bounds (bytes in and out; operations a slot):
    #    each call by CUDA events (the wrapper's host work included, as for
    #    every kernel here), and the kernels' own device time by the profiler.
    calls = {"prepack": (lambda: wire.prepack(pass2), ["prepack_kernel"]),
             "pack_levels": (lambda: pack_levels_mb(pre[0], cap), ["pack_levels_kernel"]),
             "prepack_pack": (lambda: wire.prepack_pack(pass2), ["prepack_pack_kernel"]),
             "wire": (lambda: wire.wire(*packed, *pre[1:]), ["wire_kernel"])}
    ms = {k: time_ms(fn, 20) for k, (fn, _) in calls.items()}
    dev_ms = device_times(name, dev, calls)
    n_mb = B * nmb
    bounds = {
        "prepack": bound(nbytes(*pass2.values(), *pre), n_mb * wire.SLOTS * OPS_PREPACK_SLOT),
        "pack_levels": bound(nbytes(pre[0], *packed), n_mb * wire.SLOTS * OPS_PACK_SLOT),
        "prepack_pack": bound(nbytes(*pass2.values(), *fused),
                              n_mb * wire.SLOTS * (OPS_PREPACK_SLOT + OPS_PACK_SLOT)),
        "wire": bound(nbytes(*packed, *pre[1:], rows),
                      n_mb * (cap * OPS_WIRE_VALUE + wire.N_ESC * OPS_LIST_SLOT)),
    }
    shape = f"batch {B} at {WIDTH}x{HEIGHT}; {card}"
    for k, _, _ in WIRE_KERNELS:
        print(f"[{name}] {k}: {ms[k]:.4f} ms kernel (the call), device time "
              f"{device_text(dev_ms[k])} "
              f"(profiler), {plain_ms[k]:.4f} ms plain, bound {bounds[k]['bound_ms']:.4f} ms by "
              f"{bounds[k]['bound_by']} ({shape})", flush=True)

    # 4. After pass 2, host clock, alternating: the wire path against the
    #    dense fetch of the same arrays.
    def wire_path():
        p = wire.prepack_pack(pass2)
        edev._pool_map(dict, edev.fetch_packed(p[0], wire.wire(*p[5:], *p[1:5]), pass2))

    rows_h = rows.cpu().numpy()
    sparse = [i for i in range(B) if not rows_h[i, :2].any()]
    t0 = time.perf_counter()
    for i in sparse:
        wire.unpack_wire(rows_h[i], nmb)
    unpack = (f"{(time.perf_counter() - t0) * 1000 / len(sparse):.4f} ms/img" if sparse
              else "not measured")
    runs = {"wire": [], "dense": []}
    for kind in ("dense", "wire", "wire", "dense", "dense", "wire"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wire_path() if kind == "wire" else edev.fetch(pass2)
        runs[kind].append((time.perf_counter() - t0) * 1000 / B)
    print(f"[{name}] after pass 2 (host clock, alternating runs, ms/img): wire path (fused "
          f"K18 + K19, K20, d2h of {rows.shape[1]} B/img, host unpack in a pool) "
          f"{statistics.median(runs['wire']):.4f} {[round(x, 4) for x in runs['wire']]}; dense "
          f"fetch ({nbytes(*pass2.values()) // B} B/img, int32 host arrays) "
          f"{statistics.median(runs['dense']):.4f} {[round(x, 4) for x in runs['dense']]}; the "
          f"host unpack alone, one thread, {unpack} ({card})", flush=True)
    return {k: {"max_abs_err": err[k], "ms": ms[k], "device_ms": device_total(dev_ms[k]),
                "plain_ms": plain_ms[k], **bounds[k], "library_ms": None}
            for k, _, _ in WIRE_KERNELS}


def token_phase(dev, card: str, name: str, pass2, probs, sid, segs, mbw: int, mbh: int) -> dict:
    """K13, K14 and K15 against their plain twins on the card (K13 and K14
    on the flagship's pass-2 arrays, K15 on adversarial carry streams),
    timed beside their bounds and the host C++ coders on the same arrays;
    name -> kernel record without launches."""
    import numpy as np
    import torch

    from token_inputs import CARRY_PATTERNS, steered_lanes
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.encode import vp8 as tvp8
    from webp_tpu_torch.encode.contexts import compute_contexts
    from webp_tpu_torch.io import native
    from webp_tpu_torch.ops import boolenc2, token_ops

    nmb = mbw * mbh
    err, plain_ms, ms, bounds, ops = {}, {}, {}, {}, {}
    # K13 on pass 2's levels and the images' adapted probabilities.
    err["coeff_tokens"], plain_ms["coeff_tokens"], (tok_in, lanes) = coeff_tokens_vs_twin(
        pass2, probs, mbw, mbh)
    width = lanes.data.shape[-1]
    k13_ms = {}
    for n in (BATCH, 1):
        k13_in = [a[:n] for a in tok_in]
        k13_ms[n] = time_ms(lambda: token_ops._coeff_tokens_kernel(*k13_in, mbw, mbh, PARTITIONS,
                                                                   width), 10)
    ms["coeff_tokens"] = k13_ms[BATCH]
    ops["coeff_tokens"] = lanes.n_ops
    bounds["coeff_tokens"] = bound(
        nbytes(*tok_in, lanes.fields()) + int(lanes.n_bytes.sum()),
        int(lanes.n_ops.sum()) * (OPS_CODER_STEP + OPS_OP_GEN) + BATCH * nmb * 25 * OPS_CTX_BLOCK)

    # K14, continuing the frame headers the host writes for these images.
    probs_h = probs.cpu().numpy()
    err["mb_headers"], plain_ms["mb_headers"], (hdr_in, params, heads, tokens, coders) = \
        mb_headers_vs_twin(pass2, probs_h, sid, segs, lanes, mbw, mbh)
    hwidth = heads.data.shape[-1]
    k14_ms = {n: time_ms(lambda n=n: token_ops._mb_headers_kernel(
        *(a[:n] for a in hdr_in), params[:n], mbw, mbh, hwidth), 10) for n in (BATCH, 1)}
    ms["mb_headers"] = k14_ms[BATCH]
    ops["mb_headers"] = heads.n_ops
    bounds["mb_headers"] = bound(nbytes(*hdr_in, params, heads.fields()) + int(heads.n_bytes.sum()),
                                 int(heads.n_ops.sum()) * (OPS_CODER_STEP + OPS_OP_GEN))

    # K15 alone on the carry patterns, from a fresh coder.
    steps, n_lanes = max(len(b) for b, _ in CARRY_PATTERNS), len(CARRY_PATTERNS)
    streams = np.zeros((3, steps, n_lanes), np.uint8)
    for lane, (b, p) in enumerate(CARRY_PATTERNS):
        streams[0, :len(b), lane], streams[1, :len(b), lane], streams[2, :len(b), lane] = b, p, 1
    bits, bprobs, valid = torch.from_numpy(streams).to(dev)
    cap = 4096
    k15 = boolenc2.bool_encode_lanes(bits, bprobs, valid, cap)
    k15_p, plain_ms["bool_lanes"] = timed(
        lambda: boolenc2.bool_encode_lanes_plain(bits, bprobs, valid, cap))
    err["bool_lanes"] = max(max_abs_err(a, b) for a, b in zip(k15, k15_p))
    ms["bool_lanes"] = time_ms(
        lambda: boolenc2._bool_lanes_kernel(bits, bprobs, valid, cap, boolenc2.INIT_STATE), 10)
    ops["bool_lanes"] = k15.n_ops
    bounds["bool_lanes"] = bound(3 * steps * n_lanes + nbytes(k15.fields())
                                 + int(k15.n_bytes.sum()), int(k15.n_ops.sum()) * OPS_CODER_STEP)
    # K15 on streams that carry, fresh and continued (a carry into `lead`).
    steered = {}
    for continued in (False, True):
        *streams_s, state = steered_lanes(6, STEERED_SEED, continued)
        dev_s = [torch.from_numpy(a).to(dev) for a in streams_s]
        got = boolenc2.bool_encode_lanes(*dev_s, cap, state)
        want = boolenc2.bool_encode_lanes_plain(*(torch.from_numpy(a) for a in streams_s), cap,
                                                [torch.tensor(x) for x in state])
        err["bool_lanes"] = max(err["bool_lanes"],
                                max(max_abs_err(a.cpu(), b) for a, b in zip(got, want)))
        steered[continued] = int(got.lead.sum())
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"token kernels differ from their plain twins: {bad}")
    print(f"[{name}] token kernels vs plain twins (bit-exact, tolerance 0; K13 and K14 on the "
          f"card's pass-2 arrays, K15 on {n_lanes} carry streams and on 6 steered streams, fresh "
          f"and continued, whose carries reach lead {steered[False]} / {steered[True]} times): "
          f"{err}", flush=True)
    step_ns = coder_step_ns(dev)
    k13_floor(card, name, k13_ms, lanes, step_ns)
    k14_floor(card, name, k14_ms, heads, step_ns)
    k15_floor(card, name, ms["bool_lanes"], k15, step_ns)

    # The yardstick: the host C++ coders on the same arrays, one thread.
    host = edev.fetch(pass2)
    streams_h = []
    for a in host:
        ctx = compute_contexts(a["luma_mode"], a["y2_levels"], a["y_levels"], a["uv_levels"],
                               mbw, mbh)
        streams_h.append(tvp8.token_stream(a, ctx, tvp8.skip_flags(a), mbw))
    t0 = time.perf_counter()
    for i, (levels, meta) in enumerate(streams_h):
        for p in range(PARTITIONS):
            sel = (meta[:, 3] % PARTITIONS) == p
            native.vp8_token_encode(levels[sel], meta[sel], probs_h[i])
    host_tok_ms = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    for i, a in enumerate(host):  # segs: the flagship's segmentations
        native.vp8_mbheader_encode(coders[i][0], a["luma_mode"], a["bpred"], a["chroma_mode"],
                                   tokens.meta[i, :, 18], mbw, coders[i][1],
                                   segs[i].segment_map, segs[i].enabled and segs[i].update_map,
                                   segs[i].tree_probs)
    host_hdr_ms = (time.perf_counter() - t0) * 1000

    shape = f"batch {BATCH} at {WIDTH}x{HEIGHT}, {PARTITIONS} partitions; {card}"
    for k, _, _ in TOKEN_KERNELS:
        n = ops[k]
        print(f"[{name}] {k}: {ms[k]:.4f} ms kernel, {plain_ms[k]:.4f} ms plain, bound "
              f"{bounds[k]['bound_ms']:.4f} ms by {bounds[k]['bound_by']}; {n.numel()} lanes, "
              f"longest lane {int(n.max())} ops (one dependent chain), "
              f"{int(n.sum())} ops in all ({shape})", flush=True)
    print(f"[{name}] host C++ on the same arrays (one thread, the batch): vp8_token_encode "
          f"{host_tok_ms:.4f} ms ({PARTITIONS} partitions x {BATCH} images), "
          f"vp8_mbheader_encode {host_hdr_ms:.4f} ms ({card})", flush=True)
    return {k: {"max_abs_err": err[k], "ms": ms[k], "plain_ms": plain_ms[k], **bounds[k],
                "library_ms": None} for k, _, _ in TOKEN_KERNELS}


def coeff_tokens_vs_twin(pass2, probs, mbw: int, mbh: int):
    """K13 through its wrapper on pass 2's card arrays against the plain
    twin on the same inputs: (max_abs_err over every Lanes field, the
    twin's ms, (K13's inputs, K13's lanes))."""
    from webp_tpu_torch.ops import token_ops

    tok_in = (pass2["luma_mode"], pass2["y2_levels"], pass2["y_levels"], pass2["uv_levels"],
              probs.reshape(BATCH, -1))
    lanes = token_ops.encode_coeff_partitions(*tok_in, mbw, mbh, PARTITIONS)
    width = lanes.data.shape[-1]
    lanes_p, plain = timed(
        lambda: token_ops.encode_coeff_partitions_plain(*tok_in, mbw, mbh, PARTITIONS, width))
    return max(max_abs_err(a, b) for a, b in zip(lanes, lanes_p)), plain, (tok_in, lanes)


def mb_headers_vs_twin(pass2, probs_h, sid, segs, lanes, mbw: int, mbh: int):
    """K14 through its wrapper on pass 2's card arrays, continuing the frame
    headers the host writes for these images (`lanes`: K13's, for the skip
    probabilities), against the plain twin on the same inputs: (max_abs_err
    over every Lanes field, the twin's ms, (K14's mode inputs, parameters,
    lanes, the fetched tokens, the header coders))."""
    import torch

    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops import token_ops

    skipped = edev.skip_flags(pass2)
    tokens = edev.fetch_tokens(pass2, skipped, lanes, sid)
    coders = edev.header_coders(tokens, probs_h, QUALITY, segs)
    params = edev.mb_header_params(tokens, coders, segs)
    hdr_in = (pass2["luma_mode"], pass2["bpred"], pass2["chroma_mode"],
              torch.zeros_like(pass2["luma_mode"]) if sid is None else sid, skipped)
    heads = token_ops.encode_mb_headers(*hdr_in, params, mbw, mbh)
    heads_p, plain = timed(lambda: token_ops.encode_mb_headers_plain(
        *hdr_in, params, mbw, mbh, heads.data.shape[-1]))
    err = max(max_abs_err(a, b) for a, b in zip(heads, heads_p))
    return err, plain, (hdr_in, params, heads, tokens, coders)


def coder_step_ns(dev) -> float:
    """One step of the coder of K13-K15, in ns: one warp codes CHAIN_PASSES
    passes over K13's ring of seeded ops in shared memory
    (`webp_coder_chain`); the longer chain's time less the shorter's over the
    ops between them, so that the launch cancels."""
    import numpy as np
    import torch

    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import boolenc2

    lib = _build.load()
    ring = lib.webp_coeff_tokens_ring()
    rng = np.random.RandomState(CHAIN_SEED)
    ops = torch.from_numpy((rng.randint(1, 256, ring) | rng.randint(0, 2, ring) << 8)
                           .astype(np.int16)).to(dev)
    cap = CHAIN_PASSES[-1] * ring  # ample: a byte takes several ops
    data = torch.zeros(cap, dtype=torch.uint8, device=dev)
    carries = torch.empty(boolenc2.carry_words(cap), dtype=torch.int32, device=dev)
    info = torch.empty(6, dtype=torch.int64, device=dev)
    times = []
    for passes in CHAIN_PASSES:
        def run():
            rc = lib.webp_coder_chain(ops.data_ptr(), passes, cap, data.data_ptr(),
                                      carries.data_ptr(), info.data_ptr(),
                                      torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"webp_coder_chain launch failed: CUDA error {rc}")

        times.append(time_ms(run, 10))
        if int(info[5]) != passes * ring:
            raise AssertionError(f"the coder chain coded {int(info[5])} ops, not {passes * ring}")
    (p0, p1), (t0, t1) = CHAIN_PASSES, times
    return (t1 - t0) / ((p1 - p0) * ring) * 1e6


def k13_floor(card: str, name: str, k13_ms: dict, lanes, step_ns: float) -> None:
    """K13 at batch 8 and 1 beside its chain floor: the longest lane's ops
    times one coder step (`coder_step_ns`); ns an op of the longest lane,
    and the CTAs the card keeps resident."""
    from webp_tpu_torch import _build

    longest = int(lanes.n_ops.max())
    longest_b1 = int(lanes.n_ops[0].max())
    resident = _build.load().webp_coeff_tokens_resident()
    print(f"[{name}] coeff_tokens: batch {BATCH} {k13_ms[BATCH]:.4f} ms ({lanes.n_ops.numel()} "
          f"CTAs), batch 1 {k13_ms[1]:.4f} ms ({PARTITIONS} CTAs); coder step {step_ns:.3f} ns "
          f"(one warp, ops in shared memory); chain floor {longest * step_ns / 1e6:.4f} ms = "
          f"{longest} ops x the step (batch 1: {longest_b1 * step_ns / 1e6:.4f} ms); "
          f"{k13_ms[BATCH] * 1e6 / longest:.1f} ns an op of the longest lane at batch {BATCH}, "
          f"{k13_ms[1] * 1e6 / longest_b1:.1f} at batch 1; resident CTAs {resident} ({card})",
          flush=True)


def k14_floor(card: str, name: str, k14_ms: dict, heads, step_ns: float) -> None:
    """K14 at batch 8 and 1 beside its chain floor: the image with the most
    header ops times one coder step (its count and write phases come before
    the chain); ns an op of that image."""
    longest, longest_b1 = int(heads.n_ops.max()), int(heads.n_ops[0])
    print(f"[{name}] mb_headers: batch {BATCH} {k14_ms[BATCH]:.4f} ms ({BATCH} CTAs), batch 1 "
          f"{k14_ms[1]:.4f} ms; chain floor {longest * step_ns / 1e6:.4f} ms = {longest} ops x "
          f"the step {step_ns:.3f} ns (batch 1: {longest_b1 * step_ns / 1e6:.4f} ms); "
          f"{k14_ms[BATCH] * 1e6 / longest:.1f} ns an op of the longest lane at batch {BATCH}, "
          f"{k14_ms[1] * 1e6 / longest_b1:.1f} at batch 1 ({card})", flush=True)


def k15_floor(card: str, name: str, k15_ms: float, k15, step_ns: float) -> None:
    """K15 on the carry streams beside its chain floor: the longest
    stream's ops times one coder step."""
    longest = int(k15.n_ops.max())
    print(f"[{name}] bool_lanes: {k15_ms:.4f} ms ({k15.n_ops.numel()} lanes); chain floor "
          f"{longest * step_ns / 1e6:.5f} ms = {longest} ops x the step {step_ns:.3f} ns; "
          f"{k15_ms * 1e6 / longest:.1f} ns an op of the longest stream ({card})", flush=True)


# Integer operations a slot of K21 / K22 (`csrc/sparse.cu`): the load and
# compare or bit test, the byte's shift and or, its share of the popcount
# and the block scan, the rank and the store.
OPS_FLAT_SLOT = 6


def flat_sparse_phase(dev, card: str, keep: dict) -> dict:
    """K21 pack_flat and K22 expand_flat (no path calls them) against their
    twins at batch 8 x 768x512 (N = 614,400 slots an image, cap =
    cap_for(1536)): on the flagship's pass-2 levels (K18's lv8, flattened)
    and on `tests/sparse_inputs.py`'s arrays (densities 0 to 1, exactly at
    the cap, over it, +-127 and -128), the expansion over all bits and over
    the first N - 5; the round trip returns each image within its cap.
    Timed on the flagship's levels beside the twins, one PyTorch call per
    image (pack: masked_select and the pad; expand: masked_scatter_ with
    the bool mask made before) and the bound.  Its launches are those of
    every main-path run before it (keep["flat_launches"]).  name -> kernel
    record."""
    import torch

    from sparse_inputs import flat_cases
    from webp_tpu_torch.ops import sparse, wire

    nmb = ((WIDTH + 15) // 16) * ((HEIGHT + 15) // 16)
    N, cap = nmb * wire.SLOTS, sparse.cap_for(nmb)
    lv8 = wire.prepack(keep["flagship"]["pass2"])[0].reshape(BATCH, N).contiguous()
    inputs = {"flagship lv8": lv8}
    for k, (a, c) in flat_cases(BATCH, nmb, FLAT_SEED).items():
        assert c == cap
        inputs[k] = torch.from_numpy(a).to(dev)
    err = {"pack_flat": 0, "expand_flat": 0}
    over = {}
    for k, flat in inputs.items():
        got = sparse.pack_levels(flat, cap)
        want = sparse.pack_levels_plain(flat, cap)
        err["pack_flat"] = max([err["pack_flat"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        for n in (N, N - 5):
            err["expand_flat"] = max(err["expand_flat"], max_abs_err(
                sparse.expand_levels(got[0], got[1], n), sparse.expand_levels_plain(*want[:2], n)))
        within = ~got[2]
        if not torch.equal(sparse.expand_levels(got[0], got[1], N)[within], flat[within]):
            raise AssertionError(f"{k}: the round trip does not return the input within the cap")
        over[k] = int(got[2].sum())
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"flat sparse kernels differ from their plain twins: {bad}")
    if over["at_cap"] or over["over_cap"] != BATCH or over["density_1"] != BATCH:
        raise AssertionError(f"overflow flags {over}")
    print(f"[flat sparse] K21 / K22 vs plain twins (bit-exact, tolerance 0; batch {BATCH}, N "
          f"{N}, cap {cap}; {len(inputs)} inputs, the expansion also at n = N - 5; round trip "
          f"exact within the cap; images over the cap {over}): {err}", flush=True)

    # Timings on the flagship's levels (within the cap).
    bitmap, vals, flags = sparse.pack_levels(lv8, cap)
    if flags.any():
        raise AssertionError("the flagship's levels overflow the flat cap")
    mask = lv8 != 0
    count = mask.sum(1).tolist()

    def pack_library():
        out = torch.zeros((BATCH, cap), dtype=torch.int8, device=dev)
        for b in range(BATCH):
            nz = torch.masked_select(lv8[b], mask[b])
            out[b, : nz.numel()] = nz[:cap]
        return out

    def expand_library():
        out = torch.zeros((BATCH, N), dtype=torch.int8, device=dev)
        for b in range(BATCH):
            out[b].masked_scatter_(mask[b], vals[b, : count[b]])
        return out

    if not torch.equal(pack_library(), vals) or not torch.equal(expand_library(), lv8):
        raise AssertionError("the library calls disagree with K21 / K22")
    calls = {"pack_flat": (lambda: sparse.pack_levels(lv8, cap), ["pack_flat_kernel"]),
             "expand_flat": (lambda: sparse.expand_levels(bitmap, vals, N),
                             ["expand_flat_kernel"])}
    ms = {k: time_ms(fn, 20) for k, (fn, _) in calls.items()}
    library_ms = {"pack_flat": time_ms(pack_library, 20), "expand_flat": time_ms(expand_library, 20)}
    plain_ms = {}
    _, plain_ms["pack_flat"] = timed(lambda: sparse.pack_levels_plain(lv8, cap))
    _, plain_ms["expand_flat"] = timed(lambda: sparse.expand_levels_plain(bitmap, vals, N))
    dev_ms = device_times("flat sparse", dev, calls)
    # The pack reads the levels and writes the bitmap, the capped values and
    # the flags; the expansion reads the bitmap and each image's `count`
    # values and writes the levels.
    moved = {"pack_flat": nbytes(lv8, bitmap, vals, flags),
             "expand_flat": nbytes(lv8, bitmap) + sum(count) * vals.element_size()}
    bounds = {k: bound(moved[k], BATCH * N * OPS_FLAT_SLOT) for k in calls}
    shape = f"batch {BATCH} at {WIDTH}x{HEIGHT}, N {N}, cap {cap}; {card}"
    for k in calls:
        print(f"[flat sparse] {k}: {ms[k]:.4f} ms kernel (the call), device time "
              f"{device_text(dev_ms[k])} "
              f"(profiler), {plain_ms[k]:.4f} ms plain, {library_ms[k]:.4f} ms library (one "
              f"call per image), bound {bounds[k]['bound_ms']:.4f} ms by {bounds[k]['bound_by']} "
              f"({shape})", flush=True)
    return {k: {"launches": keep["flat_launches"][k], "max_abs_err": err[k], "ms": ms[k],
                "device_ms": device_total(dev_ms[k]), "plain_ms": plain_ms[k], **bounds[k],
                "library_ms": library_ms[k]} for k in calls}


def k5_probe_phase(dev, card: str) -> int:
    """K5 against its twin on the card, pass 1 (n_try 3, default tables),
    pass 2 (n_try 4, trellis, per-image random tables) and the pass 2 of
    methods 5-6 (n_try 10, trellis, per-image random tables), with segment ids,
    at K5_PROBES: the first has more row CTAs than the card keeps resident
    (the occupancy API's count).  Returns the largest error (0)."""
    import numpy as np
    import torch

    from synthetic_rgb import synthetic_frame
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
    from webp_tpu_torch.ops import encode_wavefront as ew
    from webp_tpu_torch.ops.enc_params import EncParams, EncTables

    resident = max(ew.resident_rows(t, dev) for t in (False, True))
    worst, seen = 0, []
    for w, h, images, legs in K5_PROBES:
        mbh = h // 16
        B = images or resident // mbh + 2
        nmb = (w // 16) * mbh
        y, u, v = edev.upload(edev.rgb_to_planes([synthetic_frame(w, h, 60 + i)
                                                   for i in range(B)]), dev)
        rng = np.random.RandomState(w + h)
        lists = [[SegmentParams(quality_to_quant_index(q + 5 * (i % 3))) for q in (30, 50, 70, 85)]
                 for i in range(B)]
        P = EncParams.from_segments(lists, dev)
        sid = torch.from_numpy(rng.randint(0, 4, (B, nmb)).astype(np.uint8)).to(dev)
        probs = rng.randint(1, 256, (B, 4, 8, 3, 11)).astype(np.uint8)
        for n_try in legs:
            trellis = n_try > 3
            tbl = EncTables.from_probs(probs if trellis else T.COEFF_PROBS_DEFAULT, dev)
            args = (y, u, v, P, tbl, n_try, trellis, sid)
            got = ew.encode_analysis_batch(*args)
            want = ew.encode_analysis_batch_plain(*args)
            worst = max([worst] + [max_abs_err(got[k], want[k]) for k in want])
            n_i4 = int((want["luma_mode"] == 4).sum())
            if not 0 < n_i4 < B * nmb:
                raise AssertionError(f"probe {w}x{h} n_try {n_try}: {n_i4} I4 MBs of {B * nmb}")
        seen.append(f"{B} x {w}x{h} ({B * mbh} row CTAs; n_try {legs})")
    torch.cuda.synchronize()
    if worst:
        raise AssertionError(f"K5 differs from its twin on the probes: max_abs_err {worst}")
    print(f"[k5 probe] K5 vs its twin on the card (bit-exact, tolerance 0; pass 1 at n_try 3, "
          f"pass 2 with the trellis at n_try 4 and 10, segment ids): {', '.join(seen)}; the card "
          f"keeps {resident} row CTAs resident ({card})", flush=True)
    return worst


def lossless_inputs(width: int, height: int):
    """(the two distinct source images, their VP8L streams): a photo as
    [subtract-green, predictor 2, colour 3], a 12-colour image as [palette,
    predictor 2 on the packed width]."""
    _import_paths()
    from random_vp8l import (PALETTE, SUBTRACT_GREEN, color, predictor, quantize, vp8l_stream,
                             with_alpha)
    from synthetic_rgb import synthetic_frame

    photo, flat = (with_alpha(synthetic_frame(width, height, s), s) for s in LOSSLESS_SEEDS)
    indexed = quantize(flat, LOSSLESS_COLOURS, LOSSLESS_SEEDS[1])
    streams = [vp8l_stream(photo, 1, (SUBTRACT_GREEN, predictor(2), color(3))),
               vp8l_stream(indexed, 2, (PALETTE, predictor(2)))]
    return [photo, indexed], streams


# Integer operations of K12 per pixel and mode (4 channels' unpacking,
# arithmetic and packing), plus the 7 of the wrapping add, counted from
# `csrc/vp8l.cu`; modes 14 and 15 predict zero.
OPS_PRED = (0, 0, 0, 0, 0, 28, 20, 20, 20, 20, 32, 32, 28, 48, 0, 0)


def predictor_ops(modes, size_bits: int, width: int, height: int) -> int:
    """K12's operations on this run's modes: each pixel's mode is its block's."""
    import numpy as np

    m = modes.cpu().numpy().astype(np.int64)
    per_block = np.asarray(OPS_PRED)[np.minimum(m, 15)] + 7
    pixels_y = np.bincount(np.arange(height) >> size_bits, minlength=m.shape[1])
    pixels_x = np.bincount(np.arange(width) >> size_bits, minlength=m.shape[2])
    return int((per_block * pixels_y[None, :, None] * pixels_x[None, None, :]).sum())


def pixel_step_us(dev) -> float:
    """One pixel step of K12, in us: one 32-row band (one warp, one CTA) of
    seeded residuals and modes 0-13 at the two widths K12_STEP_WIDTHS; the
    longer band's time less the shorter's over the steps between them, so
    that the launch cancels."""
    import numpy as np
    import torch

    from webp_tpu_torch.ops import vp8l_device as K

    rng = np.random.RandomState(LOSSLESS_SEEDS[0])
    times = []
    for w in K12_STEP_WIDTHS:
        src = torch.from_numpy(rng.randint(0, 256, (1, K.BAND, w, 4)).astype(np.uint8)).to(dev)
        modes = torch.from_numpy(rng.randint(0, 14, (1, K.BAND // 4, w // 4)).astype(np.uint8))
        modes = modes.to(dev)
        work = src.clone()
        times.append(time_ms(lambda: K.inverse_predictor_(work, modes, 2), 20,
                             lambda: work.copy_(src)))
    (w0, w1), (t0, t1) = K12_STEP_WIDTHS, times
    return (t1 - t0) / (w1 - w0) * 1e3


def k12_phase(dev, card: str, steps: dict, hand_ms: float) -> None:
    """K12 on the photo and the packed palette image at batch 8 and batch 1,
    beside its chain floor: (w + 2(h - 1)) pixel steps (`pixel_step_us`)
    plus a row hand-over (`handoff_ms`) between each two of an image's
    CTAs; and the CTAs the card keeps resident."""
    from webp_tpu_torch.ops import vp8l_device as K

    step_us = pixel_step_us(dev)
    resident = K.resident_ctas(dev)
    print(f"[lossless] predictor pixel step (one 32-row band at widths {K12_STEP_WIDTHS}): "
          f"{step_us:.4f} us; resident CTAs {resident} ({card})", flush=True)
    for name in ("photo", "palette"):
        _, inp, (modes, size_bits), _ = steps[(name, "predictor")]
        h, w = inp.shape[1:3]
        ctas = K.predictor_bands(h)
        floor = (w + 2 * (h - 1)) * step_us / 1e3 + (ctas - 1) * hand_ms
        times = {}
        for n in (BATCH, 1):
            src, m = inp[:n].contiguous(), modes[:n].contiguous()
            work = src.clone()
            times[n] = time_ms(lambda: K.inverse_predictor_(work, m, size_bits), 20,
                               lambda: work.copy_(src))
        print(f"[lossless] predictor ({name}, {w}x{h}): batch {BATCH} {times[BATCH]:.4f} ms "
              f"({BATCH * ctas} CTAs), batch 1 {times[1]:.4f} ms ({ctas} CTAs); chain floor "
              f"{floor:.4f} ms = {w + 2 * (h - 1)} steps x {step_us:.4f} us + {ctas - 1} "
              f"hand-overs x {hand_ms * 1e3:.3f} us ({card})", flush=True)


def lossless_phase(dev, card: str, keep: dict) -> dict:
    """The lossless decode path, counted, checked and timed; name -> kernel
    record."""
    import numpy as np
    import torch

    from webp_tpu_torch import _build, decode_lossless_batch_device
    from webp_tpu_torch.decode import vp8l_device as ldev
    from webp_tpu_torch.io import native
    from webp_tpu_torch.ops import vp8l_device as K

    # 1. Inputs: the two signatures, tiled, and mixed; the host C++ decode.
    t0 = time.perf_counter()
    sources, streams = lossless_inputs(WIDTH, HEIGHT)
    for src, stream in zip(sources, streams):
        if not (native.vp8l_decode(stream, WIDTH, HEIGHT) == src).all():
            raise AssertionError("the host C++ decode differs from the source")
    n_colours = len(np.unique(sources[1].reshape(-1, 4), axis=0))
    print(f"[lossless] streams {[len(s) for s in streams]} bytes (photo, {n_colours}-colour "
          f"palette); write + host C++ check {time.perf_counter() - t0:.1f} s", flush=True)
    batches = {"photo": [streams[0]] * BATCH, "palette": [streams[1]] * BATCH,
               "mixed": [streams[i % 2] for i in range(BATCH)]}
    want = {"photo": [sources[0]] * BATCH, "palette": [sources[1]] * BATCH,
            "mixed": [sources[i % 2] for i in range(BATCH)]}

    # 2. The main path, counted: both signatures and the mixed batch.
    expect = {"photo": {"subtract_green": 1, "color_transform": 1, "color_indexing": 0,
                        "predictor": 1},
              "palette": {"subtract_green": 0, "color_transform": 0, "color_indexing": 1,
                          "predictor": 1},
              "mixed": {"subtract_green": 1, "color_transform": 1, "color_indexing": 1,
                        "predictor": 2}}
    launches = {k: 0 for k, _, _ in LOSSLESS_KERNELS}
    for name, batch in batches.items():
        _build.reset_launches()
        got = decode_lossless_batch_device(batch, WIDTH, HEIGHT, device_out=True, device=dev)
        torch.cuda.synchronize()
        counts = {k: _build.LAUNCHES[k] for k in launches}
        if counts != expect[name]:
            raise AssertionError(f"{name} batch launched {counts}, expected {expect[name]}")
        off_path(_build.LAUNCHES, keep)
        for k, n in counts.items():
            launches[k] += n
        if name != "mixed" and got.device.type != torch.device(dev).type:
            raise AssertionError(f"{name}: device_out gave a tensor on {got.device}")
        got = got.cpu().numpy() if name != "mixed" else got
        for i in range(BATCH):
            if not (got[i] == want[name][i]).all():
                raise AssertionError(f"{name} image {i} differs from its source")
    print(f"[lossless] main path: 3 x {BATCH} images equal to their sources and the host C++ "
          f"decode (photo, palette, mixed); launches {launches}", flush=True)

    # 3. Each kernel against its twin on the phase's card inputs: the
    #    transforms inverted one by one, the kernel's output feeding the next.
    ops = {0: ("predictor", K.inverse_predictor_, K.inverse_predictor_plain_),
           1: ("color_transform", K.color_transform_, K.color_transform_plain_),
           2: ("subtract_green", K.subtract_green_, K.subtract_green_plain_),
           3: ("color_indexing", K.color_indexing, K.color_indexing_plain)}
    err = {k: 0 for k in launches}
    steps = {}
    for name in ("photo", "palette"):
        results = ldev.entropy_batch(batches[name], WIDTH, HEIGHT)
        sig = ldev.signature(results[0][1], results[0][0].shape[1])
        idxs = list(range(BATCH))
        params = [None if p is None else torch.from_numpy(p).to(dev)
                  for p in ldev.stack_params(results, idxs, sig, HEIGHT)]
        px = torch.from_numpy(np.stack([r[0] for r in results])).to(dev)
        for (ttype, size_bits, table_size), param in zip(reversed(sig[:-1]), reversed(params)):
            kname, kernel, plain = ops[ttype]
            extra = {0: (param, size_bits), 1: (param, size_bits), 2: (),
                     3: (param, table_size, WIDTH)}[ttype]
            out = kernel(px.clone(), *extra)
            out_p, t_plain = timed(lambda: plain(px.clone(), *extra))
            err[kname] = max(err[kname], max_abs_err(out, out_p))
            steps[(name, kname)] = (kernel, px, extra, t_plain)
            px = out
        if max_abs_err(px, torch.from_numpy(np.stack(want[name])).to(dev)):
            raise AssertionError(f"{name}: the stepped kernels' output differs from the source")

    # K11 unpacked (> 16 entries), where one PyTorch call computes it too.
    rng = np.random.RandomState(LOSSLESS_SEEDS[0])
    table_u = np.zeros((BATCH, 256, 4), np.uint8)
    table_u[:, :200] = rng.randint(0, 256, (BATCH, 200, 4))
    px_u = np.zeros((BATCH, HEIGHT, WIDTH, 4), np.uint8)
    px_u[..., 1] = rng.randint(0, 200, (BATCH, HEIGHT, WIDTH))
    px_u, table_u = torch.from_numpy(px_u).to(dev), torch.from_numpy(table_u).to(dev)
    idx_u = px_u[..., 1].long()
    b_idx = torch.arange(BATCH, device=dev)[:, None, None]
    out_u = K.color_indexing(px_u, table_u, 200, WIDTH)
    err_u = max(max_abs_err(out_u, K.color_indexing_plain(px_u, table_u, 200, WIDTH)),
                max_abs_err(out_u, table_u[b_idx, idx_u]))
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad or err_u:
        raise AssertionError(f"kernels differ from their plain twins: {bad}, unpacked K11 {err_u}")
    print(f"[lossless] kernels vs plain twins (bit-exact, tolerance 0; K11 also unpacked, and "
          f"vs one indexing call): {err}", flush=True)

    # 4. Timings at the main path's shapes: K9, K10, K12 on the photo (K12
    #    also on the packed palette image), K11 on the palette; kernel
    #    beside its twin (one timed run) and its bound.  The in-place
    #    kernels start each run from a fresh copy of their input.
    records = {}
    for (name, kname), (kernel, inp, extra, t_plain) in steps.items():
        work = inp.clone()
        if kname == "color_indexing":
            t = time_ms(lambda: kernel(inp, *extra), 20)
        else:
            t = time_ms(lambda: kernel(work, *extra), 20, lambda: work.copy_(inp))
        npx = inp.shape[0] * inp.shape[1] * inp.shape[2]
        if kname == "subtract_green":
            b = bound(2 * nbytes(inp), npx * 8)
        elif kname == "color_transform":
            b = bound(2 * nbytes(inp) + nbytes(extra[0]), npx * 25)
        elif kname == "color_indexing":
            b = bound(nbytes(inp, extra[0]) + BATCH * HEIGHT * WIDTH * 4,
                      BATCH * HEIGHT * WIDTH * 8)
        else:
            b = bound(2 * nbytes(inp) + nbytes(extra[0]),
                      predictor_ops(extra[0], extra[1], inp.shape[2], inp.shape[1]))
        print(f"[lossless] {kname} ({name}, {tuple(inp.shape)}): {t:.4f} ms kernel, "
              f"{t_plain:.4f} ms plain, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({card})", flush=True)
        if kname not in records:  # the photo's predictor, the full width
            records[kname] = {"ms": t, "plain_ms": t_plain, **b, "library_ms": None}
    # K9 as one PyTorch call: green added into red and blue through a
    # strided view, in place (uint8 wraps as the kernel does).
    _, sg_in, _, _ = steps[("photo", "subtract_green")]
    sg_work = sg_in.clone()
    sg_work[..., 0:3:2].add_(sg_work[..., 1:2])
    if max_abs_err(sg_work, K.subtract_green_(sg_in.clone())):
        raise AssertionError("the add_ over px[..., 0:3:2] differs from K9")
    sg_lib = time_ms(lambda: sg_work[..., 0:3:2].add_(sg_work[..., 1:2]), 20,
                     lambda: sg_work.copy_(sg_in))
    records["subtract_green"]["library_ms"] = sg_lib
    # Each call's device time (every device op of the call; both run in place).
    sg_dev = device_times("lossless", dev, {
        "kernel": (lambda: K.subtract_green_(sg_work), [""]),
        "library": (lambda: sg_work[..., 0:3:2].add_(sg_work[..., 1:2]), [""])})
    records["subtract_green"]["device_ms"] = device_total(sg_dev["kernel"])
    print(f"[lossless] subtract_green as one call, px[..., 0:3:2].add_(px[..., 1:2]) "
          f"({tuple(sg_in.shape)}): {sg_lib:.4f} ms, device time "
          f"{device_text(sg_dev['library'])}; the kernel's call "
          f"{records['subtract_green']['ms']:.4f} ms, device time "
          f"{device_text(sg_dev['kernel'])} ({card})", flush=True)
    k12_phase(dev, card, steps, keep["handoff_ms"])
    u_ms = time_ms(lambda: K.color_indexing(px_u, table_u, 200, WIDTH), 20)
    u_plain = time_ms(lambda: K.color_indexing_plain(px_u, table_u, 200, WIDTH), 5)
    u_lib = time_ms(lambda: table_u[b_idx, idx_u], 20)
    u_bound = bound(nbytes(px_u, table_u) + BATCH * HEIGHT * WIDTH * 4, BATCH * HEIGHT * WIDTH * 8)
    # K10's and K11's device times (the profiler): K10 on the photo in place,
    # K11 on the packed palette image and unpacked.
    _, ct_in, ct_extra, _ = steps[("photo", "color_transform")]
    _, ci_in, ci_extra, _ = steps[("palette", "color_indexing")]
    ct_work = ct_in.clone()
    pw_dev = device_times("lossless", dev, {
        "color_transform": (lambda: K.color_transform_(ct_work, *ct_extra), ["color_transform"]),
        "color_indexing": (lambda: K.color_indexing(ci_in, *ci_extra), ["color_indexing"]),
        "unpacked": (lambda: K.color_indexing(px_u, table_u, 200, WIDTH), ["color_indexing"])})
    for k in ("color_transform", "color_indexing"):
        records[k]["device_ms"] = device_total(pw_dev[k])
    records["color_indexing"]["unpacked_device_ms"] = device_total(pw_dev["unpacked"])
    print(f"[lossless] device time (profiler): color_transform (photo) "
          f"{device_text(pw_dev['color_transform'])}; color_indexing packed "
          f"({LOSSLESS_COLOURS} colours, {tuple(ci_in.shape)}) "
          f"{device_text(pw_dev['color_indexing'])}, unpacked (200) "
          f"{device_text(pw_dev['unpacked'])} ({card})", flush=True)
    print(f"[lossless] color_indexing unpacked (200 entries, {tuple(px_u.shape)}): {u_ms:.4f} ms "
          f"kernel, {u_plain:.4f} ms plain, {u_lib:.4f} ms table[b, idx] (int64 indices made "
          f"before), bound {u_bound['bound_ms']:.4f} ms by {u_bound['bound_by']} ({card})",
          flush=True)

    # 5. End to end (host clock): entropy on the host's threads, upload,
    #    kernels, fetch; beside the host C++ full decode, one image at a time.
    reps = 3
    for name in ("photo", "palette"):
        decode_lossless_batch_device(batches[name], WIDTH, HEIGHT, device=dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            decode_lossless_batch_device(batches[name], WIDTH, HEIGHT, device=dev)
        e2e = (time.perf_counter() - t0) * 1000 / (reps * BATCH)
        t0 = time.perf_counter()
        for _ in range(reps):
            ldev.entropy_batch(batches[name], WIDTH, HEIGHT)
        entropy = (time.perf_counter() - t0) * 1000 / (reps * BATCH)
        t0 = time.perf_counter()
        for s in batches[name]:
            native.vp8l_decode(s, WIDTH, HEIGHT)
        host = (time.perf_counter() - t0) * 1000 / BATCH
        print(f"[lossless] {name}: decode_lossless_batch_device {e2e:.4f} ms/img (host clock; "
              f"its threaded entropy pass alone {entropy:.4f}); host C++ vp8l_decode "
              f"{host:.4f} ms/img, one thread ({card})", flush=True)
    # One PyTorch call computes K9 (above) and K11 only unpacked (above);
    # none computes K10 or K12 (a wavefront recurrence).
    return {k: {"launches": launches[k], "max_abs_err": err[k], **records[k]}
            for k, _, _ in LOSSLESS_KERNELS}


def both_clocks(fn):
    """(fn(), host-clock ms, CUDA-event ms): one run, ended by a synchronise."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000, start.elapsed_time(stop)


def median_clocks(fn, reps: int):
    """Medians of both clocks over `reps` runs of fn() after a warm-up."""
    runs = [both_clocks(fn)[1:] for _ in range(reps + 1)][1:]
    return statistics.median(r[0] for r in runs), statistics.median(r[1] for r in runs)


def container_inputs(width: int, height: int):
    """The container phase's files: two VP8X stills (ALPH VP8L-compressed
    through a palette with the gradient filter, and raw with the horizontal
    one; ICCP, EXIF, XMP), a VP8L still with alpha and an animation
    (`tests/random_webp.py`); name -> (file, its VP8 payloads, its VP8L
    streams as (stream, width, height, implicit))."""
    _import_paths()
    import random_webp as rw
    from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor, vp8l_stream

    s = CONTAINER_SEEDS
    stills = {"vp8x_gradient_vp8l": rw.demo_still(width, height, s[0], 3, True, (PALETTE,)),
              "vp8x_horizontal_raw": rw.demo_still(width, height, s[1], 1, False)}
    rgba = rw.rgba_frame(width, height, s[2])
    stream = vp8l_stream(rgba, s[2], (SUBTRACT_GREEN, predictor(2), color(3)))
    anim, frames = rw.demo_animation(width, height, s[3])
    files = {name: (st.data, [st.vp8], [(st.alph[1:], width, height, True)] if st.alph[0] & 1
                    else []) for name, st in stills.items()}
    files["vp8l_alpha"] = (rw.still_vp8l(stream), [], [(stream, width, height, False)])
    files["animation"] = (anim, [f.vp8 for f in frames if f.vp8 is not None],
                          [(f.alph[1:], f.width, f.height, True) for f in frames
                           if f.alph is not None and f.alph[0] & 1]
                          + [(f.vp8l, f.width, f.height, False) for f in frames
                             if f.vp8l is not None])
    return stills, rgba, frames, files


def container_decode(name: str, data: bytes, device, upsampling: str = "bilinear"):
    """The decoder API on one of the container phase's files: a still's
    RGBA by decode_rgba (by read_image for upsampling="simple"), or the
    animation's (canvas, duration) of every read_frame, its background
    colour set."""
    import webp_tpu_torch as api

    if name == "animation":
        d = api.WebPDecoder(data, upsampling=upsampling, device=device)
        d.set_background_color(CONTAINER_BACKGROUND)
        return [d.read_frame() for _ in range(d.num_frames)]
    if upsampling == "simple":
        return api.WebPDecoder(data, upsampling=upsampling, device=device).read_image()
    return api.decode_rgba(data, device=device)[0]


def container_reference():
    """(container_decode of every file on the CPU, and of the VP8X stills
    with upsampling="simple"; its seconds), in a worker: the plain twins run
    a wavefront step at a time, seconds a full-size frame."""
    t0 = time.perf_counter()
    stills, _, _, files = container_inputs(WIDTH, HEIGHT)
    out = {name: container_decode(name, data, "cpu") for name, (data, _, _) in files.items()}
    out["simple"] = {name: container_decode(name, st.data, "cpu", "simple")
                     for name, st in stills.items()}
    return out, time.perf_counter() - t0


def container_phase(dev, card: str, keep: dict) -> dict:
    """The decoder API on WebP files, counted, checked and timed; name ->
    its launches in the phase's main-path run (K1, recon_filter, K4, K9-K12)."""
    import numpy as np
    import torch

    import webp_tpu_torch as api
    from webp_tpu_torch import _build
    from webp_tpu_torch.container import chunks as ck
    from webp_tpu_torch.container.composite import composite_frame
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.decode.alpha import decode_alpha_plane, defilter_alpha
    from webp_tpu_torch.io import native
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb

    # 1. Inputs at WIDTH x HEIGHT, and the launches each file's decode must take.
    t0 = time.perf_counter()
    stills, vp8l_src, frames, files = container_inputs(WIDTH, HEIGHT)
    kinds = {0: "predictor", 1: "color_transform", 2: "subtract_green", 3: "color_indexing"}
    expect = {}
    for name, (data, vp8s, streams) in files.items():
        e = dict.fromkeys(CONTAINER_KERNELS, 0)
        for k in ("residual", "recon_filter", "yuv2rgb"):
            e[k] = len(vp8s)
        for stream, w, h, implicit in streams:
            for t, *_ in native.vp8l_decode_entropy(stream, w, h, implicit)[1]:
                e[kinds[t]] += 1
        expect[name] = e
    print(f"[container] files {({n: len(f[0]) for n, f in files.items()})} bytes; "
          f"{len(frames)} animation frames; write {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. The main path, counted file by file: decode_rgba for the stills,
    #    WebPDecoder.read_frame over the animation with a background colour.
    launches = dict.fromkeys(CONTAINER_KERNELS, 0)
    got = {}
    for name, (data, _, _) in files.items():
        _build.reset_launches()
        got[name] = container_decode(name, data, dev)
        torch.cuda.synchronize()
        counts = {k: _build.LAUNCHES[k] for k in CONTAINER_KERNELS}
        off_path(_build.LAUNCHES, keep)
        if counts != expect[name]:
            raise AssertionError(f"{name} launched {counts}, expected {expect[name]}")
        print(f"[container] {name}: launches {counts}", flush=True)
        for k, n in counts.items():
            launches[k] += n
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the decoder API's path never launched: {launches}")
    simple = {name: container_decode(name, st.data, dev, "simple") for name, st in stills.items()}

    # 3. Checks, tolerance 0: the same API on the CPU (the plain twins, from
    #    the worker); the VP8 payloads through decode_vp8_batch_device on the
    #    card; the VP8L and alpha sources; the metadata chunks; the
    #    animation's canvases composed from those.
    t0 = time.perf_counter()
    ref, ref_s = keep["container_reference"].get()
    waited = time.perf_counter() - t0
    for name in files:
        if name == "animation":
            same = len(got[name]) == len(ref[name]) and all(
                g_ms == w_ms and np.array_equal(g, w)
                for (g, g_ms), (w, w_ms) in zip(got[name], ref[name]))
        else:
            same = np.array_equal(got[name], ref[name])
        if not same:
            raise AssertionError(f"{name}: the card's API output differs from the CPU's")
    for name, st in stills.items():
        if not np.array_equal(simple[name], ref["simple"][name]):
            raise AssertionError(f"{name}: simple upsampling differs from the CPU's")
        rgb = tdev.decode_vp8_batch_device([st.vp8], device=dev)[0]
        if not (np.array_equal(got[name][..., :3], rgb)
                and np.array_equal(got[name][..., 3], st.alpha)):
            raise AssertionError(f"{name}: pixels differ from the VP8 decode or the alpha source")
        dec = api.WebPDecoder(st.data, device=dev)
        if (dec.icc_profile(), dec.exif_metadata(), dec.xmp_metadata()) != (
                st.iccp, st.exif, st.xmp):
            raise AssertionError(f"{name}: metadata chunks differ from the writer's")
    if not np.array_equal(got["vp8l_alpha"], vp8l_src):
        raise AssertionError("vp8l_alpha differs from its source")
    canvas = np.empty((HEIGHT, WIDTH, 4), np.uint8)
    canvas[:] = CONTAINER_BACKGROUND
    prev, clear = (0, 0, 0, 0), True
    for i, (f, (g, g_ms)) in enumerate(zip(frames, got["animation"])):
        if f.rgba is not None:
            px = f.rgba
        else:
            px = tdev.decode_vp8_batch_device([f.vp8], device=dev)[0]
            if f.alpha is not None:
                px = np.dstack([px, f.alpha])
        composite_frame(canvas, CONTAINER_BACKGROUND if clear else None, px, f.x, f.y,
                        px.shape[2] == 4, f.blend, *prev)
        prev, clear = (f.x, f.y, f.width, f.height), f.dispose
        if g_ms != f.duration or not np.array_equal(g, canvas):
            raise AssertionError(f"animation frame {i} differs from its sources composed")
    print(f"[container] bit-exact (tolerance 0) vs the same API with device='cpu' (worker "
          f"process: {ref_s:.1f} s, waited {waited:.1f} s), decode_vp8_batch_device, the "
          f"VP8L and alpha sources, the metadata chunks, {len(frames)} canvases composed from "
          f"the sources; checks {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. Times, host clock beside CUDA events: a VP8X still's stages as
    #    read_image runs them, each still and each frame whole, the filters.
    reps = 3
    for name, st in stills.items():
        d = api.WebPDecoder(st.data, device=dev)
        parse = median_clocks(lambda: api.WebPDecoder(st.data, device=dev), reps)
        entropy = median_clocks(
            lambda: tdev.to_device_batch(tdev.parse_levels_batch([st.vp8]), dev), reps)
        db = tdev.to_device_batch(tdev.parse_levels_batch([st.vp8]), dev)

        def kernels():
            packed = tdev.decode_core(db, "yuv")
            y, u, v = tdev.split_planes(packed, (WIDTH + 15) // 16, (HEIGHT + 15) // 16)
            return (y, u, v), fancy_yuv420_to_rgb(y, u, v, WIDTH, HEIGHT)

        decode = median_clocks(kernels, reps)
        planes, rgb = kernels()
        fetch = median_clocks(lambda: ([p[0].cpu() for p in planes], rgb[0].cpu()), reps)
        alph = d._chunk_bytes(ck.ALPH)
        alpha = median_clocks(lambda: decode_alpha_plane(alph, WIDTH, HEIGHT, dev), reps)
        whole = median_clocks(d.read_image, reps)
        print(f"[container] {name} ms per still, host clock / CUDA events: parse "
              f"{parse[0]:.4f} / {parse[1]:.4f}, entropy + upload {entropy[0]:.4f} / "
              f"{entropy[1]:.4f}, device decode (K1, recon_filter, K4) {decode[0]:.4f} / "
              f"{decode[1]:.4f}, fetch {fetch[0]:.4f} / {fetch[1]:.4f}, alpha "
              f"{alpha[0]:.4f} / {alpha[1]:.4f}; read_image {whole[0]:.4f} / {whole[1]:.4f} "
              f"({card})", flush=True)
    d = api.WebPDecoder(files["vp8l_alpha"][0], device=dev)
    parse = median_clocks(lambda: api.WebPDecoder(files["vp8l_alpha"][0], device=dev), reps)
    whole = median_clocks(d.read_image, reps)
    print(f"[container] vp8l_alpha ms per still, host clock / CUDA events: parse "
          f"{parse[0]:.4f} / {parse[1]:.4f}; read_image (entropy, K9, K10, K12, fetch) "
          f"{whole[0]:.4f} / {whole[1]:.4f} ({card})", flush=True)
    d = api.WebPDecoder(files["animation"][0], device=dev)
    d.set_background_color(CONTAINER_BACKGROUND)
    per_frame = []
    for rep in range(2):
        d.reset_animation()
        runs = [both_clocks(d.read_frame)[1:] for _ in range(d.num_frames)]
        per_frame.append(runs)
    runs = per_frame[-1]
    print(f"[container] animation ms per frame, host clock / CUDA events (second pass): "
          + ", ".join(f"{i}: {h:.4f} / {e:.4f}" for i, (h, e) in enumerate(runs))
          + f"; mean {statistics.mean(r[0] for r in runs):.4f} / "
          f"{statistics.mean(r[1] for r in runs):.4f} ({card})", flush=True)
    from random_webp import filter_alpha

    plane = stills["vp8x_gradient_vp8l"].alpha
    for filtering, label in ((3, "gradient"), (1, "horizontal")):
        filtered = filter_alpha(plane, filtering)
        t0 = time.perf_counter()
        out = defilter_alpha(filtered.copy(), filtering)
        ms = (time.perf_counter() - t0) * 1000
        if not np.array_equal(out, plane):
            raise AssertionError(f"the {label} defilter does not invert the writer's filter")
        print(f"[container] {label} defilter at {WIDTH}x{HEIGHT}: {ms:.4f} ms, host, one "
              f"thread ({card})", flush=True)
    return launches


def api_inputs():
    """The encoder-API phase's images: the encode phases' first 768x512 RGB
    frame and its RGBA with a seeded alpha plane; the small RGB, RGBA and
    gray images; three RGBA animation frames (the first opaque, the second
    the first with a box of the third)."""
    _import_paths()
    import numpy as np
    import random_webp as rw
    from synthetic_rgb import synthetic_frame

    s, n = API_SEEDS, API_SMALL
    rgb = encode_inputs(WIDTH, HEIGHT)[0][0]
    small = synthetic_frame(n, n, s[1])
    frames = [np.dstack([synthetic_frame(n, n, s[3] + i), rw.alpha_plane(n, n, s[3] + i)])
              for i in range(3)]
    frames[0][..., 3] = 255
    frames[1] = frames[0].copy()
    frames[1][n // 6: n // 2, n // 3: n - 7] = frames[2][n // 6: n // 2, n // 3: n - 7]
    return {"rgb": rgb, "rgba": np.dstack([rgb, rw.alpha_plane(WIDTH, HEIGHT, s[0])]),
            "small_rgb": small, "small_rgba": np.dstack([small, rw.alpha_plane(n, n, s[1])]),
            "small_gray": np.ascontiguousarray(synthetic_frame(n, n, s[2])[..., 1]),
            "frames": frames}


def api_files(images, device, counts=None, keep=None) -> dict:
    """The encoder API's files on `device`, those the CPU run checks: name
    -> bytes.  With `counts`, each file's launches into counts[name], the
    counts set to 0 just before it and read just after."""
    import torch

    import webp_tpu_torch as api
    from webp_tpu_torch import _build

    icc, exif, xmp = API_META

    def alpha_quality_50():
        enc = api.Encoder.new_rgba(images["small_rgba"], device=device).with_method(0)
        enc.config.alpha_quality = 50
        return enc.encode()

    def animation(lossless):
        enc = api.AnimationEncoder(API_SMALL, API_SMALL, lossless=lossless, method=2,
                                   device=device)
        for i, frame in enumerate(images["frames"]):
            enc.add_frame(frame, 100 + i)
        return enc.finish()

    makers = {
        "rgba_alph": lambda: api.Encoder.new_rgba(images["small_rgba"], device=device).encode(),
        "l8": lambda: api.Encoder.new_l8(images["small_gray"], device=device).with_method(2)
        .encode(),
        "photo_meta": lambda: api.Encoder.new_rgb(images["small_rgb"], device=device)
        .with_preset(api.Preset.PHOTO).with_icc_profile(icc).with_exif_metadata(exif)
        .with_xmp_metadata(xmp).encode(),
        "alpha_quality_50": alpha_quality_50,
        "target_size": lambda: api.Encoder.new_rgb(images["small_rgb"], device=device)
        .with_method(0).with_target_size(API_TARGET).encode(),
        "anim_lossy": lambda: animation(False),
        "anim_lossless": lambda: animation(True),
        "lossless_768": lambda: api.encode_lossless_rgba(images["rgba"], device=device),
    }
    out = {}
    for name, make in makers.items():
        if counts is None:
            out[name] = make()
            continue
        _build.reset_launches()
        out[name] = make()
        torch.cuda.synchronize()
        counts[name] = {k: _build.LAUNCHES[k] for k in API_KERNELS}
        off_path(_build.LAUNCHES, keep)
    return out


def api_reference():
    """(api_files on the CPU, its seconds), in a worker: the plain twins take
    ~30 s a 256x256 lossy file at method 4."""
    t0 = time.perf_counter()
    return api_files(api_inputs(), "cpu"), time.perf_counter() - t0


def riff_chunks(data: bytes) -> dict:
    """fourcc -> payload of a file's top-level chunks."""
    out, off = {}, 12
    while off + 8 <= len(data):
        size = int.from_bytes(data[off + 4: off + 8], "little")
        out[data[off: off + 4]] = data[off + 8: off + 8 + size]
        off += 8 + size + (size & 1)
    return out


def api_stages(enc, dev):
    """One `Encoder.encode()` of a still, stage by stage as it runs them
    (the lossy route's through `lossy_stages` at a batch of one), each
    ended by a synchronise: (file, {stage: (host ms, CUDA-event ms)})."""
    import numpy as np

    from webp_tpu_torch.container import chunks as ck
    from webp_tpu_torch.encode import api as eapi

    ms = {}
    stage = stage_timer(ms)
    if enc.config.lossless:
        body = eapi._chunk(ck.VP8L, stage("vp8l", enc.lossless_payload))
        return stage("mux", lambda: enc.mux(body, enc.has_alpha, False)), ms
    height, width = enc.image.shape[:2]
    planes = stage("colour", lambda: tuple(np.ascontiguousarray(p)[None]
                                           for p in enc.yuv_planes()))
    (vp8,), _ = lossy_stages(planes, width, height, dev, int(enc.config.quality),
                             min(enc.config.method, 6), True, 1, stage)
    body = eapi._chunk(ck.VP8, vp8)
    if enc.has_alpha:
        plane = np.ascontiguousarray(enc.image[:, :, -1])
        body = eapi._chunk(ck.ALPH, stage("alph", lambda: eapi.alpha_payload(
            plane, enc.config.alpha_quality))) + body
    return stage("mux", lambda: enc.mux(body, enc.has_alpha, enc.has_alpha)), ms


def api_phase(dev, card: str, keep: dict) -> dict:
    """The encoder API, counted, checked and timed; name -> its launches in
    the phase's main-path runs (K8, K5, K6, K7, the fused K18 + K19, K20)."""
    import numpy as np
    import torch

    import webp_tpu_torch as api
    from webp_tpu_torch import _build, metrics
    from webp_tpu_torch.encode.vp8l import near_lossless_preprocess

    # 1. The main path, counted file by file: the default lossy encode() of
    #    the 768x512 RGB frame (Q75 m4, segments on at 1,536 MBs, one
    #    partition) and of its RGBA (+ ALPH), then the files the CPU run
    #    checks (256x256 stills and animations, a lossless 768x512 still).
    t0 = time.perf_counter()
    images = api_inputs()
    counts, files = {}, {}
    for name, make in (("rgb_768", api.Encoder.new_rgb), ("rgba_768", api.Encoder.new_rgba)):
        _build.reset_launches()
        files[name] = make(images[name[:-4]], device=dev).encode()
        torch.cuda.synchronize()
        counts[name] = {k: _build.LAUNCHES[k] for k in API_KERNELS}
        off_path(_build.LAUNCHES, keep)
    files.update(api_files(images, dev, counts, keep))
    lossy_calls = {"anim_lossy": 3, "anim_lossless": 0, "lossless_768": 0}
    launches = dict.fromkeys(API_KERNELS, 0)
    for name, c in counts.items():
        calls = c["wire"]
        ok = calls >= 7 if name == "target_size" else calls == lossy_calls.get(name, 1)
        if not ok or any(c[k] != n * calls for k, n in API_KERNELS.items()):
            raise AssertionError(f"{name} launched {c}: not {lossy_calls.get(name, 1)} lossy "
                                 f"encodes of {API_KERNELS} each")
        for k in launches:
            launches[k] += c[k]
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the encoder API's path never launched: {launches}")
    print(f"[api] files {({n: len(d) for n, d in files.items()})} bytes; launches "
          f"{ {n: c['wire'] for n, c in counts.items()} } lossy encodes, in all {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 2. Checks, tolerance 0: the RGB and RGBA stills' VP8 chunk against the
    #    plain CPU encode of the same frame at one partition (the flagship
    #    encode phase's worker: Q75 m4, segments on); the other files
    #    against the same calls on the CPU (this phase's worker).
    t0 = time.perf_counter()
    want = keep["flagship"]["one_partition"][0]
    for name in ("rgb_768", "rgba_768"):
        if riff_chunks(files[name]).get(b"VP8 ") != want:
            raise AssertionError(f"{name}: the VP8 chunk differs from the plain CPU encode")
    ref, ref_s = keep["api_reference"].get()
    waited = time.perf_counter() - t0
    for name, data in ref.items():
        if files[name] != data:
            raise AssertionError(f"{name}: the card's file differs from the CPU's")
    if len(files["target_size"]) > API_TARGET:
        raise AssertionError(f"target_size: {len(files['target_size'])} > {API_TARGET} bytes")
    meta = api.WebPDecoder(files["photo_meta"], device=dev)
    if (meta.icc_profile(), meta.exif_metadata(), meta.xmp_metadata()) != API_META:
        raise AssertionError("photo_meta: the metadata chunks differ from the encoder's")

    # 3. Every file decoded on the card: lossless pixels and alpha planes
    #    exact, the lossy RGB's PSNR against its source.
    def decode(data):
        d = api.WebPDecoder(data, device=dev)
        return [d.read_frame()[0] for _ in range(d.num_frames)] if d.is_animated() \
            else d.read_image()

    def exact(name, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: decoded pixels or alpha differ from the source")

    alpha_50 = near_lossless_preprocess(np.repeat(images["small_rgba"][..., 3:], 4, 2), 50)
    sources = {"rgb_768": images["rgb"], "rgba_768": images["rgba"],
               "rgba_alph": images["small_rgba"], "photo_meta": images["small_rgb"],
               "alpha_quality_50": np.dstack([images["small_rgb"], alpha_50[..., 0]]),
               "target_size": images["small_rgb"],
               "l8": np.repeat(images["small_gray"][..., None], 3, 2)}
    psnr = {}
    for name, src in sources.items():
        got = decode(files[name])
        if src.shape[2] == 4:
            exact(name, got[..., 3], src[..., 3])
        psnr[name] = round(float(metrics.psnr(got[..., :3], src[..., :3])), 4)
    for i, (got, src) in enumerate(zip(decode(files["anim_lossy"]), images["frames"])):
        exact(f"anim_lossy frame {i}", got[..., 3], src[..., 3])
        psnr[f"anim_lossy {i}"] = round(float(metrics.psnr(got[..., :3], src[..., :3])), 4)
    for i, (got, src) in enumerate(zip(decode(files["anim_lossless"]), images["frames"])):
        exact(f"anim_lossless frame {i}", got, src)
    exact("lossless_768", decode(files["lossless_768"]), images["rgba"])
    print(f"[api] byte-equal (tolerance 0): the 768x512 RGB and RGBA files' VP8 chunk with "
          f"the plain CPU encode at one partition, {len(ref)} files with the same calls on the "
          f"CPU (worker process: {ref_s:.1f} s, waited {waited:.1f} s); decoded on the card: "
          f"lossless pixels, ALPH and the near-lossless alpha exact, PSNR (dB) against the "
          f"sources {psnr}; checks {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. Times of the 768x512 stills, host clock / CUDA events, medians of 3
    #    runs after a warm-up: encode() stage by stage, and whole.
    reps = 3
    for name, enc in (("rgb_768", api.Encoder.new_rgb(images["rgb"], device=dev)),
                      ("rgba_768", api.Encoder.new_rgba(images["rgba"], device=dev)),
                      ("lossless_768", api.Encoder.new_rgba(images["rgba"], device=dev)
                       .with_lossless())):
        runs = []
        for _ in range(reps + 1):
            data, ms = api_stages(enc, dev)
            if data != files[name]:
                raise AssertionError(f"{name}: the staged encode differs from encode()")
            runs.append(ms)
        split = ", ".join(f"{k} {statistics.median(r[k][0] for r in runs[1:]):.4f} / "
                          f"{statistics.median(r[k][1] for r in runs[1:]):.4f}" for k in runs[0])
        whole = median_clocks(enc.encode, reps)
        print(f"[api] {name} encode() ms, host clock / CUDA events: {split}; encode() "
              f"{whole[0]:.4f} / {whole[1]:.4f} ({card})", flush=True)
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def band_handoff_ms(dev) -> tuple:
    """(inside a band, across bands): one hand-over between the banded
    kernels' row pipelines, in ms.  Rings of BAND_RING members, each waiting
    on its predecessor's counter with the kernels' poll and publishing its
    own as they do (`csrc/banded.cu` BandLink): the warps of one CTA,
    counters in its shared memory, acquire and release at CTA scope; or the
    one-warp CTAs of a cluster, each polling its neighbour's counter through
    distributed shared memory, at cluster scope.  The longer run's time less
    the shorter's over the hand-overs between them, so that the launch
    cancels."""
    import torch

    from webp_tpu_torch import _build

    lib = _build.load()
    out = []
    for ctas, warps in ((1, BAND_RING), (BAND_RING, 1)):
        times = []
        for rounds in BAND_ROUNDS:
            def run():
                rc = lib.webp_band_handoff_chain(ctas, warps, rounds,
                                                 torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"webp_band_handoff_chain launch failed: CUDA error {rc}")

            times.append(time_ms(run, 10))
        (r0, r1), (t0, t1) = BAND_ROUNDS, times
        out.append((t1 - t0) / ((r1 - r0) * BAND_RING))
    return tuple(out)


def band_floor_ms(steps: int, n_band: int, inside_ms: float, across_ms: float) -> float:
    """The banded kernels' chain floor: each of the T steps waits on one
    hand-over from the row above, n_band - 1 of them across bands."""
    return (steps - (n_band - 1)) * inside_ms + (n_band - 1) * across_ms


def parallel_phase(dev, card: str, keep: dict) -> dict:
    """The scale-out path, counted, checked and timed; name -> kernel record.

    Banded decode: the decode phase's batches (both filter kinds) through
    `parallel.decode_wavefront_banded` at every n_band of N_BANDS, byte-equal
    to the fused K2 + K3's planes of the same run; K16 and K17 against their twins at
    n_band 4, and timed at n_band 1, 2, 4 and 8 beside K2 and K3, per step and
    beside their chain floor (`band_floor_ms`, from the two hand-overs that
    `band_handoff_ms` times); n_band 1, whose CTA has more rows than row
    pipelines, byte-equal to the fused K2 + K3 too.  Then the four data-parallel
    factories on a process group of one rank (NCCL on a card, gloo on the
    CPU), each byte-equal to the unsharded path of this run: the decode's
    RGB; the one-pass analysis; the flagship's int8 prepack (K18) and the
    payloads finished from it; the gathered token lanes, whose all_gather
    is timed."""
    import torch
    import torch.distributed as dist

    from webp_tpu_torch import _build, parallel
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops import banded, wire
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.encode_wavefront import OUT_FIELDS, encode_analysis_batch
    from webp_tpu_torch.ops.loopfilter import loop_filter_
    from webp_tpu_torch.ops.wavefront import recon_

    mbw, mbh = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
    nmb = mbw * mbh

    # 1. Inputs and the unsharded path of this run: the decode batches'
    #    K1 outputs, K2 + K3 planes and RGB; the flagship's one-pass
    #    analysis and device-token lanes.
    flag = keep["flagship"]
    y, u, v = flag["planes"]
    P, sid, segs, pass2, probs = (flag[k] for k in ("P", "sid", "segs", "pass2", "probs"))
    n_try1 = min(flag["n_try"], 3)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    decode_in, want_planes, want_rgb = {}, {}, {}
    for simple in (False, True):
        d = tdev.to_device_batch(tdev.parse_levels_batch(keep["decode"][simple]), dev)
        decode_in[simple] = d, tdev.wavefront_inputs(d)
        want_planes[simple] = [p.clone() for p in
                               tdev.split_planes(tdev.decode_core(d, "yuv"), mbw, mbh)]
        want_rgb[simple] = tdev.decode_core(d, "rgb")
    want_analysis = encode_analysis_batch(y, u, v, P, default, n_try1, True)
    want_prepack = wire.prepack(pass2)
    skipped, want_lanes = edev.encode_tokens(pass2, probs, mbw, mbh, PARTITIONS)
    want_tokens = edev.fetch_tokens(pass2, skipped, want_lanes, sid)

    def same(got, want, what):
        if max_abs_err(got, want):
            raise AssertionError(f"{what} differs from the unsharded path")

    # 2. The main path, counted: the banded decode at every n_band, then the
    #    factories on a one-rank process group.
    _build.reset_launches()
    for n_band in N_BANDS:
        for simple in (False, True):
            got = parallel.decode_wavefront_banded(
                *decode_in[simple][1], parallel.make_mesh(n_band=n_band, device=dev), mbw, mbh,
                simple)
            for g, w, plane in zip(got, want_planes[simple], "yuv"):
                same(g, w, f"banded {plane} plane (n_band {n_band}, simple={simple})")
    backend = parallel.mesh.BACKENDS[torch.device(dev).type]
    kwargs = {"device_id": torch.device(dev)} if backend == "nccl" else {}
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                            rank=0, **kwargs)
    try:
        init_s = time.perf_counter() - t0
        mesh = parallel.make_mesh(device=dev)
        if mesh.group is None or (mesh.n_data, mesh.rank) != (1, 0):
            raise AssertionError(f"expected a one-rank {backend} mesh, got {mesh}")
        for simple in (False, True):
            step = parallel.make_decode_batch_sharded(mesh, mbw, mbh, simple, WIDTH, HEIGHT)
            same(step(decode_in[simple][0]), want_rgb[simple], f"sharded decode (simple={simple})")
        step = parallel.make_encode_analysis_sharded(mesh, mbw, mbh, n_try1, True)
        got = step(y, u, v, P, default)
        for k in OUT_FIELDS:
            same(got[k], want_analysis[k], f"sharded analysis {k}")
        stats_step, prepack_step = parallel.make_encode_twopass_sharded(mesh, mbw, mbh, n_try1,
                                                                        flag["n_try"], True)
        totals, ones = stats_step(y, u, v, P, default, sid)
        probs2 = edev.adapt_probs(totals.cpu().numpy(), ones.cpu().numpy())
        pre = prepack_step(y, u, v, P, edev.tables_for(probs2, dev), sid)
        for got, want, k in zip(pre, want_prepack, ("lv8", "meta8", "esc_pos", "esc_val",
                                                      "overflow")):
            same(got, want, f"sharded prepack {k}")
        rows = [t.cpu().numpy() for t in pre[:4]]
        arrays = [wire.unpack_analysis(*(a[i] for a in rows)) for i in range(BATCH)]
        payloads = edev.finish_frames_lossy_batch(arrays, probs2, QUALITY, WIDTH, HEIGHT,
                                                  PARTITIONS, segs)
        if payloads != flag["payloads"]:
            raise AssertionError("the sharded two-pass payloads differ from the unsharded ones")
        step = parallel.make_encode_tokens_sharded(mesh, mbw, mbh, PARTITIONS)
        lanes = step(*(pass2[k] for k in ("luma_mode", "y2_levels", "y_levels", "uv_levels")),
                     torch.from_numpy(probs2).to(dev))
        for a, b, name in zip(lanes, want_lanes, lanes._fields):
            same(a, b, f"gathered lanes' {name}")
        host = want_tokens.parts
        for name in ("lead", "n_bytes", "bottom", "bit_num"):
            if not (getattr(lanes, name).cpu().numpy() == getattr(host, name)).all():
                raise AssertionError(f"gathered lanes' {name} differ from fetch_tokens'")
        if not (lanes.data.cpu().numpy() == host.data).all():
            raise AssertionError("gathered lanes' bytes differ from fetch_tokens'")
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        off_path(launches, keep)
        keep["parallel_launches"] = launches
        fields = lanes.fields()
        gather_ms = time_ms(lambda: (parallel.pipeline.all_gather(mesh, fields),
                                     parallel.pipeline.all_gather(mesh, lanes.data)), 20)
        gather_bytes = nbytes(fields, lanes.data)
    finally:
        dist.destroy_process_group()
    needed = [k for k, _, _ in PARALLEL_KERNELS] + [
        "residual", "recon_filter", "yuv2rgb", "enc", "token_stats", "enc_tables",
        "prepack", "coeff_tokens"]
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"the scale-out path launched no {missing} kernel: {launches}")
    print(f"[parallel] main path: banded decode byte-equal to the fused K2 + K3 at n_band "
          f"{N_BANDS} "
          f"(2 x {BATCH} images, both filter kinds); on a one-rank {backend} group (init "
          f"{init_s:.1f} s) the sharded decode, one-pass analysis, two-pass prepack and "
          f"payloads, and gathered token lanes equal the unsharded path; launches "
          f"{ {k: launches[k] for k in needed} }", flush=True)
    print(f"[parallel] token lanes all_gather (fields + bytes, {gather_bytes} B, world size 1): "
          f"{gather_ms:.4f} ms ({card})", flush=True)

    # 3. K16 and K17 against their twins at n_band 4 (the normal filter's
    #    batch, and K17 on the simple one's reconstruction too).
    res, lm, bp, cm, level, interior, hev, do_sub = decode_in[False][1]
    recon_args, lf_args = (res, lm, bp, cm), (level, interior, hev, do_sub)

    def planes():
        return tdev.split_planes(torch.zeros((BATCH, nmb * 384), dtype=torch.uint8, device=dev),
                                 mbw, mbh)

    rec, rec_p = planes(), planes()
    banded.recon_banded_(*rec, *recon_args, 4)
    _, recon_plain_ms = timed(lambda: banded.recon_banded_plain_(*rec_p, *recon_args, 4))
    err = {"recon_banded": max(max_abs_err(a, b) for a, b in zip(rec, rec_p))}
    got, want = [p.clone() for p in rec], [p.clone() for p in rec]
    banded.filter_banded_(*got, *lf_args, False, 4)
    _, filter_plain_ms = timed(lambda: banded.filter_banded_plain_(*want, *lf_args, False, 4))
    err["filter_banded"] = max(max_abs_err(a, b) for a, b in zip(got, want))
    s_args = decode_in[True][1]
    s_rec = planes()
    recon_(*s_rec, *s_args[:4])
    got, want = [p.clone() for p in s_rec], [p.clone() for p in s_rec]
    banded.filter_banded_(*got, *s_args[4:], True, 4)
    banded.filter_banded_plain_(*want, *s_args[4:], True, 4)
    err["filter_banded"] = max(err["filter_banded"], *(max_abs_err(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    if any(err.values()):
        raise AssertionError(f"K16 / K17 differ from their plain twins: {err}")
    print(f"[parallel] K16 / K17 vs plain twins at n_band 4 (bit-exact, tolerance 0; batch "
          f"{BATCH}, K17 also on the simple filter): {err}", flush=True)

    # 4. Timings per n_band beside K2 and K3, on the normal filter's batch;
    #    the filter starts each run from fresh unfiltered planes.  Then
    #    n_band 1 (one CTA an image, more rows than pipelines) byte-equal to
    #    the fused K2 + K3 on both batches.
    target = planes()
    work = [p.clone() for p in rec]

    def fresh():
        for w, r in zip(work, rec):
            w.copy_(r)

    steps = mbw + 2 * (mbh - 1)
    inside_ms, across_ms = band_handoff_ms(dev) if torch.device(dev).type == "cuda" else (0, 0)
    print(f"[parallel] banded hand-over (rings of {BAND_RING}, ld.acquire poll -> __syncwarp, "
          f"st.release): inside a band (shared memory, CTA scope) {inside_ms * 1e3:.4f} us, "
          f"across bands (distributed shared memory, cluster scope) {across_ms * 1e3:.4f} us "
          f"({card})", flush=True)
    k2_ms = time_ms(lambda: recon_(*target, *recon_args), 20)
    k3_ms = time_ms(lambda: loop_filter_(*work, *lf_args, False), 20, fresh)
    ms = {}
    for n_band in (1, *N_BANDS):
        ms[("recon_banded", n_band)] = time_ms(
            lambda: banded.recon_banded_(*target, *recon_args, n_band), 20)
        ms[("filter_banded", n_band)] = time_ms(
            lambda: banded.filter_banded_(*work, *lf_args, False, n_band), 20, fresh)
        shape = banded.max_active_clusters(n_band, mbh) if torch.device(dev).type == "cuda" \
            else "n/a"
        floor = band_floor_ms(steps, n_band, inside_ms, across_ms)
        k16, k17 = ms[("recon_banded", n_band)], ms[("filter_banded", n_band)]
        print(f"[parallel] n_band {n_band} ({mbh // n_band} MB rows a band; {shape}): K16 "
              f"recon_banded {k16:.4f} ms ({k16 / steps * 1e3:.2f} us a step), K17 "
              f"filter_banded {k17:.4f} ms ({k17 / steps * 1e3:.2f} us a step), chain floor "
              f"{floor:.4f} ms (T = {steps}); K2 recon {k2_ms:.4f} ms ({k2_ms / steps * 1e3:.2f} "
              f"us a step), K3 loopfilter {k3_ms:.4f} ms ({k3_ms / steps * 1e3:.2f} us) (same "
              f"run; batch {BATCH} at {WIDTH}x{HEIGHT}; {card})", flush=True)
    for simple in (False, True):
        got = parallel.decode_wavefront_banded(
            *decode_in[simple][1], parallel.make_mesh(n_band=1, device=dev), mbw, mbh, simple)
        for g, w, plane in zip(got, want_planes[simple], "yuv"):
            same(g, w, f"banded {plane} plane (n_band 1, simple={simple})")
    print("[parallel] n_band 1 byte-equal to the fused K2 + K3 (both filter kinds)", flush=True)

    # Bounds: K2's and K3's, the same work.  No PyTorch call computes either.
    pixels = BATCH * nmb * 384
    bounds = {"recon_banded": bound(nbytes(*recon_args, *rec), pixels * 8),
              "filter_banded": bound(2 * nbytes(*rec) + nbytes(*lf_args), pixels * 20)}
    plain_ms = {"recon_banded": recon_plain_ms, "filter_banded": filter_plain_ms}
    return {k: {"launches": launches[k], "max_abs_err": err[k], "ms": ms[(k, 4)],
                "plain_ms": plain_ms[k], **bounds[k], "library_ms": None}
            for k, _, _ in PARALLEL_KERNELS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_paths()
    from webp_tpu_torch import _build
    from webp_tpu_torch.io import native

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    keep = {}

    # The encode phases' plain CPU encodes take minutes of host time: worker
    # processes make them while the card builds, decodes and encodes; the
    # pool's exit stops the workers.
    # The container phase's plain CPU decodes run in a third worker, the
    # encoder-API phase's CPU encodes in a fourth.
    with multiprocessing.get_context("spawn").Pool(len(ENCODES) + 2, reference_worker) as pool:
        refs = {job: pool.apply_async(reference_job, job) for job in ENCODES}
        keep["container_reference"] = pool.apply_async(container_reference)
        keep["api_reference"] = pool.apply_async(api_reference)

        # Build the host library and the kernels from the checkout.
        t0 = time.perf_counter()
        native.load()
        _build.load()
        print(f"build + load: {time.perf_counter() - t0:.1f} s", flush=True)
        for line in ptxas_report():
            print(f"ptxas {line}", flush=True)

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
        print(f"card: {card}", flush=True)

        records = phase("decode", decode_phase, dev, card, keep)
        records.update(phase("lossless", lossless_phase, dev, card, keep))
        for k, n in phase("container", container_phase, dev, card, keep).items():
            records[k]["launches"] += n
        for job in ENCODES:
            # A kernel on both encode paths: launches and errors over both,
            # the times of the flagship's (the last) path.
            for k, r in phase(f"encode m{job[0]}", encode_phase, dev, card, *job, refs[job],
                              keep).items():
                if k in records:
                    r["launches"] += records[k]["launches"]
                    r["max_abs_err"] = max(r["max_abs_err"], records[k]["max_abs_err"])
                records[k] = r
        for k, n in phase("encoder api", api_phase, dev, card, keep).items():
            records[k]["launches"] += n
    records["enc"]["max_abs_err"] = max(records["enc"]["max_abs_err"],
                                        phase("k5 probe", k5_probe_phase, dev, card))
    records.update(phase("parallel", parallel_phase, dev, card, keep))
    # K18 alone runs on the scale-out path (the twopass factory), not on the
    # encodes' (the fused launch): its count is that path's.
    records["prepack"]["launches"] += keep["parallel_launches"]["prepack"]
    # After every main path: it reports their counts.
    records.update(phase("flat sparse", flat_sparse_phase, dev, card, keep))

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu"))
    if leaked:
        raise AssertionError(f"the smoke run imported {leaked}")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces, **records[name]}
        for name, source, replaces in (DECODE_KERNELS + ENCODE_KERNELS + TOKEN_KERNELS
                                       + LOSSLESS_KERNELS + PARALLEL_KERNELS + WIRE_KERNELS
                                       + FLAT_KERNELS)
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
