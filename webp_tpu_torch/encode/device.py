"""Batched lossy VP8 encode on a torch device (methods 0-6, segments on or off).

The port of `webp_tpu/encode/vp8.py`'s batch API: `analyze_frames_lossy_batch`
(:1448) as `dispatch_frames_lossy_batch` and its blocking form,
`dispatch_seg_results` (:1379), `compute_seg_results` (:1428),
`setup_segments` (:1079), `probe_stage_times` (:1608), `encode_frame_lossy`
(:1215), the `XFER` counters (:1233), `encode_frames_lossy_batch` (:1682),
`finish_frames_lossy_batch` (:1702) and `encode_frames_lossy_batch_mixed`
(:1755), with `encode_wavefront2.encode_analysis_stats_batch` (:1471).
The stages, each a function here so that they can be timed apart:

1. `rgb_to_planes`: RGB -> padded YUV420 on the host (C++).
2. `upload`: the planes to the device.
3. `segment`: with segments on and at least 256 MBs, K8's per-MB alphas,
   then k-means, segment quantizers and loop-filter levels per image on
   the host (`encode/analysis.py`); `params_for` packs the four segments'
   parameters per image and the MB segment ids for K5.
4. Pass 1, `encode_analysis_stats_batch`: K5 with the default tables,
   n_try = min(n_try, 3) and no trellis, then K6 on the device-resident
   levels; only the (total, ones) token counts come back.
5. `adapt_probs`: the adapted probabilities per image, on the host.
6. `tables_for`: K7, per-image rate tables from those probabilities.
7. Pass 2: K5 with the per-image tables, the method's n_try and, for
   methods 4-6, the trellis.
8. `wire`: K18 prepack and K19 pack_levels in one launch (`prepack_pack`),
   then K20 wire, pack pass 2's arrays into one uint8 row per image
   (`ops/wire.py`; 402,434 B at 768x512, against 818 B/MB dense).
9. `d2h` (`fetch_packed`): the rows to the host, in one copy; the dense
   int8 level rows of images whose values did not fit the row (sp_over)
   in a second.  When an escape list overflowed, the dense arrays
   (`fetch`) instead: they are still on the device.
10. `finish`: per image in a thread pool, the unpack of its row (C++) and
   then skip flags, contexts, token and MB-header coding and the frame
   header (with the segment header and map) (`encode/vp8.py`).  The
   unpack runs lazily, in the worker that finishes the image, as the JAX
   package's `_LazyUnpack` (`webp_tpu/encode/vp8.py:1240`, `_fetch_packed`
   :1269).

With device_tokens (two-pass only; the JAX package's
`encode_analysis_batch_v2_pertbl_tokens`, `_fetch_tokens` and its
finisher's device branches, `webp_tpu/encode/vp8.py:1301-1376`, :814-849,
:1702-1750), pass 2's levels never leave the card:

8. `encode_tokens`: the skip flags on the device, the adapted
   probabilities up, and K13 codes every image's coefficient partitions.
9. `fetch_tokens`: per-MB modes and skip flags (19 B/MB), K13's lane
   fields and the partitions' bytes to the host, in one copy.
10. `header_coders`: per image, the frame header on the host, up to the
    MB headers.
11. `code_mb_headers`: K14 continues every image's header coder with its
    MB headers, read on the card (modes, skip flags, segment ids).
12. `assemble`: per image, the lanes' carries and flushes, and the frame.

With two_pass=False, one K5 pass runs on the default tables at
n_try = min(n_try, 3), with the trellis from method 4, then stages 8-10,
and the finisher adapts the header's probabilities from the final levels
itself.

Pipelining.  `dispatch_frames_lossy_batch` runs stages 2-4 and returns
`fetch(chain=None, early_chain=None)`, which runs the rest up to the
host finish; `dispatch_seg_results` splits stage 3 the same way.  The
dispatch halves never wait for the device: uploads are staged in pinned
memory (`_build.upload`), downloads go to pinned memory behind an event
(`_build.download`), and the token coders' byte counts are read after
`chain`.  So one lane thread can keep the card fed, as `bench.py:196-250`
does: batch i+1's K8 goes in `early_chain`, ahead of batch i's pass 2,
and its pass 1 in `chain`, right after batch i's pass 2 is queued, while
another thread finishes batch i-1 on the host.  Each pipeline's launches
run on one CUDA stream: the stream current when it was dispatched, which
`fetch` makes current again around its own launches and the hooks.

Tracing (`spans.py`, off unless a caller starts it): `enc.colour`
(`rgb_to_planes`), `enc.seg_dispatch` (the upload, K8 and the alphas'
copy), `enc.alphas_wait` and `enc.kmeans` (the segments' finish),
`enc.dispatch` (the upload and pass 1); in the two-pass fetch
`enc.stats_wait`, `enc.probs`, `enc.tables` (K7) and `enc.pass2`, then
with device tokens `enc.k13_launch`, `enc.k13_wait` (count `relaunches`),
`enc.token_fetch`, `enc.header_coders` and `enc.k14`, else
`enc.wire_fetch`; the finishers `enc.assemble` and `enc.finish`.  Every
host pool task is a `<stage>.task` span.  The bytes each fetch brings
down are counted in `XFER`, not on its span.

Every entry point takes an explicit `device`: on "cpu" the kernels' plain
twins run, on "cuda" the kernels (or the call raises).
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, spans
from ..common import vp8_tables as T
from ..io import native
from ..ops.analysis import analyze_alphas_batch
from ..ops.enc_params import EncParams, EncTables
from ..ops.enc_tables import enc_tables
from ..ops.encode_wavefront import OUT_FIELDS, encode_analysis_batch
from ..ops import token_ops
from ..ops.boolenc2 import Lanes
from ..ops.token_stats import token_stats_levels
from ..ops import wire as wire_ops
from ..ops.wire import encode_analysis_batch_packed, unpack_dense_wire, unpack_wire
from . import vp8
from .analysis import MIN_MBS, Segmentation, segments_off, setup_segments_from_alphas
from .boolenc import assemble_lane
from .costs import ProbaStats
from .quant import SegmentParams, quality_to_quant_index

DEVICE_TOKEN_PARTS = 8  # the JAX package's partitions of the device-token flow

# Host <-> device bytes of the batched encode since the caller last reset
# them, as `webp_tpu/encode/vp8.py:1233` XFER counts them: "up" the planes
# that `dispatch_frames_lossy_batch` uploads (:1483); "down" what comes
# back after pass 2: the wire rows and the dense int8 rows of sp_over
# images (or the dense arrays after an escape overflow), or in the
# device-token flow the modes, skip flags, lane fields and partition bytes
# and K14's header lanes (:1286, :1344).  Not counted, as in the JAX
# package: the parameters, probabilities, tables and segment ids (up), the
# pass-1 statistics and K8's alphas (down), and the planes that
# `dispatch_seg_results` uploads for K8.
XFER = {"up": 0, "down": 0}


def n_try_for(method: int) -> int:
    """B modes tried per subblock: 0 for methods 0-1 (I16 only), 3 for 2-3,
    4 for method 4 and all 10 from method 5."""
    if method < 0:
        raise ValueError(f"method must be >= 0, got {method}")
    return 0 if method <= 1 else 3 if method <= 3 else 4 if method == 4 else 10


def _pool_map(fn, items):
    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, min(len(items), os.cpu_count() or 1))) as pool:
        return list(pool.map(spans.task(fn), items))


def rgb_to_planes(rgbs):
    """Same-geometry RGB frames -> padded (Y, U, V) uint8 batches on the host."""
    with spans.span("enc.colour"):
        planes = _pool_map(native.rgb_to_yuv420, rgbs)
        return tuple(np.stack([p[i] for p in planes]) for i in range(3))


def upload(planes, device):
    """Host planes (Y, U, V) on `device`; to a card without blocking the host
    (`_build.upload`)."""
    return tuple(_build.upload(p, device) for p in planes)


def skip_flags(arrays):
    """[B, nmb] bool: the MB carries no nonzero level (device arrays)."""
    return token_ops.skip_flags(arrays["y2_levels"], arrays["y_levels"], arrays["uv_levels"])


def dispatch_segment(y, u, v, quality: int):
    """K8 on device planes and a copy of its alphas to the host that does not
    block; returns finish() -> per-image `Segmentation`s (k-means in a host
    thread pool, after waiting for the copy), or None below 256 MBs, where
    segments stay off and nothing is launched."""
    B, H, W = y.shape
    if (H // 16) * (W // 16) < MIN_MBS:
        return lambda: None
    alpha, uv_alpha = analyze_alphas_batch(y, u, v)
    wait = _build.download(torch.cat([alpha, uv_alpha[:, None]], dim=1))
    qi = quality_to_quant_index(quality)

    def finish():
        with spans.span("enc.alphas_wait"):
            joint = wait()
        with spans.span("enc.kmeans"):
            return _pool_map(
                lambda i: setup_segments_from_alphas(joint[i, :-1], int(joint[i, -1]), qi),
                range(B))

    return finish


def segment(y, u, v, quality: int):
    """Per-image `Segmentation`s of device planes from K8's alphas (frames of
    at least 256 MBs), or None below that: segments stay off."""
    return dispatch_segment(y, u, v, quality)()


def dispatch_seg_results(planes, quality: int, device="cuda"):
    """Segmentation of host planes (Y, U, V) [B, ...], split so that a
    pipeline can queue K8 early and collect it later: uploads the planes,
    launches K8 and starts the copy of its alphas, waiting for nothing;
    returns finish() -> per-image `Segmentation`s, or None below 256 MBs
    (segments off; then nothing is uploaded).  The port of
    `webp_tpu/encode/vp8.py:1379`; a K8 failure raises (no host
    fallback)."""
    B, H, W = planes[0].shape
    if (H // 16) * (W // 16) < MIN_MBS:
        return lambda: None
    with spans.span("enc.seg_dispatch"):
        return dispatch_segment(*upload(planes, torch.device(device)), quality)


def compute_seg_results(planes, quality: int, device="cuda"):
    """`dispatch_seg_results(...)()`: per-image `Segmentation`s of host
    planes, or None below 256 MBs (`webp_tpu/encode/vp8.py:1428`).  With
    device="cpu" K8's plain twin computes the alphas, the counterpart of
    the JAX package's host analysis (`device=False`)."""
    return dispatch_seg_results(planes, quality, device)()


def setup_segments(y, u, v, base_qi: int, device="cuda") -> Segmentation:
    """One image's segmentation from its planes y [mbh*16, mbw*16], u, v
    [mbh*8, mbw*8] uint8 (host) at the frame's quant index `base_qi`: K8's
    alphas then k-means from 256 MBs, else segments off (`segments_off`
    with the frame's parameters).  The port of `webp_tpu/encode/vp8.py:1079`
    on the batch's route."""
    nmb = (y.shape[0] // 16) * (y.shape[1] // 16)
    if nmb < MIN_MBS:
        return segments_off(nmb, SegmentParams(base_qi))
    alpha, uv_alpha = analyze_alphas_batch(*upload((y[None], u[None], v[None]),
                                                   torch.device(device)))
    return setup_segments_from_alphas(alpha[0].cpu().numpy(), int(uv_alpha[0]), base_qi)


def params_for(segs, quality: int, device):
    """(EncParams, MB segment ids [B, nmb] uint8 or None) for K5: the
    images' four segments, or the frame's one parameter set."""
    if segs is None:
        return EncParams.from_segment(SegmentParams(quality_to_quant_index(quality)), device), None
    sid = np.stack([s.segment_map for s in segs]).astype(np.uint8)
    return (EncParams.from_segments([s.segments for s in segs], device),
            _build.upload(sid, device))


def encode_analysis_stats_batch(y, u, v, P: EncParams, tbl: EncTables, n_try: int, sid=None):
    """Pass 1: K5 (no trellis) then K6 on one stream; (totals, ones) [B, 4,
    8, 3, 11] int32 on the device.  The levels stay on the device; K6
    derives the skip flags from them."""
    out = encode_analysis_batch(y, u, v, P, tbl, n_try, False, sid)
    mbw, mbh = y.shape[2] // 16, y.shape[1] // 16
    return token_stats_levels(out["luma_mode"], out["y2_levels"], out["y_levels"],
                              out["uv_levels"], mbw, mbh)


def adapt_probs(totals: np.ndarray, ones: np.ndarray) -> np.ndarray:
    """Per-image adapted token probabilities [B, 4, 8, 3, 11] uint8."""
    with spans.span("enc.probs"):
        return np.stack(_pool_map(
            lambda i: ProbaStats(totals[i], ones[i]).updated_probs(T.COEFF_PROBS_DEFAULT),
            range(len(totals))))


def tables_for(probs: np.ndarray, device) -> EncTables:
    """K7's tables of host probabilities [B, 4, 8, 3, 11] (uploaded without
    blocking the host)."""
    with spans.span("enc.tables"):
        return enc_tables(_build.upload(np.ascontiguousarray(probs, np.uint8), device))


def fetch(arrays):
    """The dense per-MB arrays to the host: per image, a dict of int32 arrays."""
    host = {k: arrays[k].cpu().numpy() for k in OUT_FIELDS}
    XFER["down"] += sum(a.nbytes for a in host.values())
    return [{k: host[k][i].astype(np.int32) for k in OUT_FIELDS}
            for i in range(host["luma_mode"].shape[0])]


# Images by the branch `fetch_packed` took for them since the last reset:
# the sparse row, the dense int8 row (sp_over), the dense arrays (an
# escape list overflowed).
WIRE_BRANCHES = {"sparse": 0, "dense_row": 0, "dense_arrays": 0}


class LazyUnpack(Mapping):
    """One image's arrays dict, unpacked at first access (in the finisher's
    pool worker)."""

    def __init__(self, unpack):
        self._unpack = unpack
        self._d = None
        self._lock = threading.Lock()

    def _arrays(self) -> dict:
        with self._lock:
            if self._d is None:
                self._d, self._unpack = self._unpack(), None
            return self._d

    def __getitem__(self, k):
        return self._arrays()[k]

    def __iter__(self):
        return iter(self._arrays())

    def __len__(self):
        return len(self._arrays())

    def __reduce__(self):  # pickles as the unpacked dict (the lock cannot be pickled)
        return dict, (self._arrays(),)


def fetch_packed(lv8, wire, arrays):
    """Per image, its arrays dict from the wire (`encode_analysis_batch_packed`'s
    outputs): one copy of the rows [B, wire_bytes] to the host, and of the
    lv8 rows of the sp_over images; the dense `fetch(arrays)` when any
    image's escapes overflowed (byte 1).  Each image unpacks at first
    access (`LazyUnpack`)."""
    with spans.span("enc.wire_fetch"):
        rows = wire.cpu().numpy()
        XFER["down"] += rows.nbytes
        if rows[:, 1].any():
            WIRE_BRANCHES["dense_arrays"] += len(rows)
            return fetch(arrays)
        nmb = lv8.shape[1]
        dense_idx = np.flatnonzero(rows[:, 0])
        dense = {}
        if len(dense_idx):
            host = lv8[torch.from_numpy(dense_idx).to(lv8.device)].cpu().numpy()
            XFER["down"] += host.nbytes
            dense = dict(zip(dense_idx.tolist(), host))
    WIRE_BRANCHES["dense_row"] += len(dense)
    WIRE_BRANCHES["sparse"] += len(rows) - len(dense)

    def one(i):
        if i in dense:
            return unpack_dense_wire(dense[i], rows[i], nmb)
        return unpack_wire(rows[i], nmb)

    return [LazyUnpack(functools.partial(one, i)) for i in range(len(rows))]


def _fetch_rows(*tensors):
    """Device tensors [B, ...] to host numpy arrays of the same shapes and
    types, in one copy (a row per image)."""
    B = tensors[0].shape[0]
    rows = [t.contiguous().reshape(B, t[0].numel()).view(torch.uint8) for t in tensors]
    host = torch.cat(rows, dim=1).cpu().numpy()
    out, at = [], 0
    for t, r in zip(tensors, rows):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(host[:, at:at + r.shape[1]].copy().view(dtype).reshape(t.shape))
        at += r.shape[1]
    return out


class DeviceTokens(NamedTuple):
    """Pass 2's result in the device-token flow.  On the host: `meta` [B,
    nmb, 19] uint8 (16 B modes, luma mode, chroma mode, skip flag per MB)
    and the coded coefficient partitions `parts` (`Lanes` [B, P] of numpy
    arrays).  On the device, what K14 reads: `modes` (luma_mode, bpred,
    chroma_mode, skipped) and the MB segment ids `sid` (None: segments
    off).  `coders` and `headers`, once `with_headers` has run: the
    images' `header_coders` and K14's lanes."""
    meta: np.ndarray
    parts: Lanes
    modes: dict
    sid: object
    coders: list = None
    headers: Lanes = None


def encode_tokens(out, probs: np.ndarray, mbw: int, mbh: int, num_partitions: int):
    """The skip flags [B, nmb] of pass 2's device arrays `out`, and K13's
    coefficient partitions under the images' adapted probabilities `probs`
    [B, 4, 8, 3, 11], as launched (`token_ops.PendingLanes`; nothing here
    waits for the device)."""
    dev = out["luma_mode"].device
    with spans.span("enc.k13_launch"):
        skipped = skip_flags(out)
        pf = _build.upload(np.ascontiguousarray(probs, np.uint8).reshape(len(probs), -1), dev)
        lanes = token_ops.launch_coeff_partitions(out["luma_mode"], out["y2_levels"],
                                                  out["y_levels"], out["uv_levels"], pf, mbw,
                                                  mbh, num_partitions)
    return skipped, lanes


def coeff_lanes(pending: token_ops.PendingLanes) -> Lanes:
    """K13's lanes once its byte counts are read (waiting for the stream),
    after its relaunch if a lane went over (counted on the span)."""
    with spans.span("enc.k13_wait") as s:
        lanes = pending.result()
        s.count(relaunches=lanes.data.shape[-1] > pending.capacity)
    return lanes


def fetch_tokens(out, skipped, lanes: Lanes, sid) -> DeviceTokens:
    """The modes, skip flags and K13's partitions to the host in one copy;
    the MB-header inputs stay on the device."""
    with spans.span("enc.token_fetch"):
        meta = torch.cat([out["bpred"], out["luma_mode"][..., None],
                          out["chroma_mode"][..., None], skipped[..., None].to(torch.uint8)],
                         dim=-1)
        meta, fields, data = _fetch_rows(meta, lanes.fields(), lanes.data)
    XFER["down"] += meta.nbytes + fields.nbytes + data.nbytes
    modes = {k: out[k] for k in ("luma_mode", "bpred", "chroma_mode")}
    return DeviceTokens(meta, Lanes.from_fields(fields, data), {**modes, "skipped": skipped}, sid)


def header_coders(tokens: DeviceTokens, probs, quality: int, segs=None) -> list:
    """Per image, (the frame header's coder up to the MB headers, its skip
    probability from the fetched skip flags), in a host thread pool."""
    nparts = tokens.parts.lead.shape[1]

    def one(i):
        skip_prob = vp8.skip_probability(tokens.meta[i, :, 18])
        return vp8.header_coder(probs[i], quality, nparts, None if segs is None else segs[i],
                                skip_prob), skip_prob

    with spans.span("enc.header_coders"):
        return _pool_map(one, range(len(tokens.meta)))


def code_mb_headers(tokens: DeviceTokens, coders, mbw: int, mbh: int, segs=None) -> Lanes:
    """K14: every image's MB headers, continuing its header coder; the lanes
    ([B], numpy) on the host."""
    m = tokens.modes
    with spans.span("enc.k14"):
        lanes = token_ops.encode_mb_headers(m["luma_mode"], m["bpred"], m["chroma_mode"],
                                            tokens.sid, m["skipped"],
                                            mb_header_params(tokens, coders, segs), mbw, mbh)
        fields, data = _fetch_rows(lanes.fields(), lanes.data)
    XFER["down"] += fields.nbytes + data.nbytes
    return Lanes.from_fields(fields, data)


def with_headers(tokens: DeviceTokens, probs, quality: int, mbw: int, mbh: int,
                 segs=None) -> DeviceTokens:
    """`tokens` with its images' header coders and K14's header lanes."""
    coders = header_coders(tokens, probs, quality, segs)
    return tokens._replace(coders=coders,
                           headers=code_mb_headers(tokens, coders, mbw, mbh, segs))


def mb_header_params(tokens: DeviceTokens, coders, segs=None):
    """K14's per-image parameters [B, 8] on the device: whether the frame
    writes the segment map, its tree probabilities, the skip probability
    and the frame-header coder's state."""
    B = len(coders)
    return token_ops.header_params(
        [False] * B if segs is None else [s.enabled and s.update_map for s in segs],
        [[255] * 3] * B if segs is None else [s.tree_probs for s in segs],
        [sp for _, sp in coders],
        [[getattr(enc, k) for enc, _ in coders] for k in ("bottom", "range", "bit_num")],
        tokens.modes["luma_mode"].device)


def assemble(tokens: DeviceTokens, coders, headers: Lanes, width: int, height: int) -> list:
    """Per image, the payload: the header lane's carries into the frame
    header, the lanes' flushes, and the frame (host thread pool)."""
    parts = tokens.parts

    def lane(f, *i, prefix=b""):
        return assemble_lane(f.lead[i], f.data[i], f.n_bytes[i], f.bottom[i], f.bit_num[i], prefix)

    def one(i):
        header = lane(headers, i, prefix=bytes(coders[i][0].out))
        return vp8.payload(header, [lane(parts, i, p) for p in range(parts.lead.shape[1])],
                           width, height)

    with spans.span("enc.assemble"):
        return _pool_map(one, range(len(coders)))


def finish_frames_tokens(tokens: DeviceTokens, probs, quality: int, width: int, height: int,
                         segs=None) -> list:
    """Stage 12: the payloads of the device-token flow from `tokens` as
    `fetch` returns them, its header coders and K14's lanes included, so
    that every launch of a batch comes from its fetch.  The arguments are
    `finish_frames_lossy_batch`'s; `probs`, `quality` and `segs` went into
    the headers already."""
    if tokens.headers is None:
        raise ValueError("the device tokens have no header lanes: take them from fetch")
    return assemble(tokens, tokens.coders, tokens.headers, width, height)


def dispatch_frames_lossy_batch(planes, quality: int, method: int, two_pass: bool = True,
                                segments: bool = False, *, device="cuda",
                                device_tokens: bool = False,
                                num_partitions: int = DEVICE_TOKEN_PARTS, seg_results=None):
    """Stages 2-4 on host planes (Y, U, V) [B, ...], waiting for nothing:
    the upload, segments (K8, unless `seg_results` gives them), the
    parameters and pass 1 (K5 + K6, and a copy of its statistics to the
    host that does not block), or with two_pass=False the one K5 pass and
    the wire.  The port of `webp_tpu/encode/vp8.py:1448`.

    Returns fetch(chain=None, early_chain=None) -> what
    `analyze_frames_lossy_batch` returns.  The two-pass fetch waits for
    the statistics, calls `early_chain()`, adapts the probabilities,
    launches K7 and pass 2 with the wire (or, with device_tokens, pass 2
    and K13), calls `chain()`, and only then fetches: the wire rows, or
    the device tokens, whose fetch also runs the frame headers and K14
    (stage 11) so that every launch of a batch comes from its fetch.  The
    one-pass fetch calls `early_chain()` and `chain()`, then fetches.  The
    hooks are the pipeline's (`bench.py:196-250`): `early_chain` for the
    next batch's `dispatch_seg_results`, `chain` for its dispatch.

    Both halves launch on the CUDA stream that is current on the calling
    thread when this is called; `fetch` makes it current again around its
    launches and the hooks, so call both halves of a pipeline from one
    thread (the launch order is then fixed).  The fetch after `chain`
    waits for that stream, the chained launches included.  With segments
    and `seg_results` None, this waits for K8's alphas, as the blocking
    `segment` does; `seg_results` from `dispatch_seg_results` keeps it
    free of waits."""
    if device_tokens and not two_pass:
        raise ValueError("device_tokens needs the two-pass flow")
    if device_tokens:
        vp8.check_partitions(num_partitions)
    n_try = n_try_for(method)
    trellis = method >= 4
    dev = torch.device(device)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    with spans.span("enc.dispatch"):
        y, u, v = upload(planes, dev)
        XFER["up"] += sum(int(p.nbytes) for p in planes)
        segs = None
        if segments:
            segs = seg_results if seg_results is not None else segment(y, u, v, quality)
        P, sid = params_for(segs, quality, dev)
        default = EncTables.default(dev)
        if two_pass:
            stats = _build.download(torch.stack(encode_analysis_stats_batch(
                y, u, v, P, default, min(n_try, 3), sid)))
        else:
            packed = encode_analysis_batch_packed(y, u, v, P, default, min(n_try, 3), trellis,
                                                  sid)
    if not two_pass:

        def fetch1(chain=None, early_chain=None):
            with torch.cuda.stream(stream):
                if early_chain is not None:
                    early_chain()
                if chain is not None:
                    chain()
                return fetch_packed(*packed), None, segs

        return fetch1

    def fetch(chain=None, early_chain=None):
        with torch.cuda.stream(stream):
            with spans.span("enc.stats_wait"):
                totals, ones = stats()
            if early_chain is not None:
                early_chain()
            probs = adapt_probs(totals, ones)
            tables = tables_for(probs, dev)
            if not device_tokens:
                with spans.span("enc.pass2"):
                    packed = encode_analysis_batch_packed(y, u, v, P, tables, n_try, trellis,
                                                          sid)
                if chain is not None:
                    chain()
                return fetch_packed(*packed), probs, segs
            with spans.span("enc.pass2"):
                out = encode_analysis_batch(y, u, v, P, tables, n_try, trellis, sid)
            mbw, mbh = y.shape[2] // 16, y.shape[1] // 16
            skipped, lanes = encode_tokens(out, probs, mbw, mbh, num_partitions)
            if chain is not None:
                chain()
            tokens = fetch_tokens(out, skipped, coeff_lanes(lanes), sid)
            return with_headers(tokens, probs, quality, mbw, mbh, segs), probs, segs

    return fetch


def analyze_frames_lossy_batch(planes, quality: int, method: int, two_pass: bool = True,
                               segments: bool = False, device="cuda", device_tokens: bool = False,
                               num_partitions: int = DEVICE_TOKEN_PARTS):
    """Stages 2-9 on host planes (Y, U, V) [B, ...]: (per-image arrays, each
    unpacked at first access, per-image adapted probabilities or None,
    per-image segmentations or None).  With device_tokens (two-pass only),
    stages 2-11 with `num_partitions` coefficient partitions coded on the
    device: (`DeviceTokens` with its header lanes, probabilities,
    segmentations).  `dispatch_frames_lossy_batch(...)()`."""
    return dispatch_frames_lossy_batch(planes, quality, method, two_pass, segments,
                                       device=device, device_tokens=device_tokens,
                                       num_partitions=num_partitions)()


def probe_stage_times(planes, quality: int, method: int, segments: bool = True,
                      seg_results=None, reps: int = 3, device="cuda") -> dict:
    """Per-stage times of the two-pass encode of host planes (Y, U, V), in
    seconds per batch, each the best of `reps` runs after one more: "p1_s"
    pass 1 (K5 + K6), "p2_s" pass 2 (K5 with the per-image tables), "pack_s"
    the wire (the fused K18 + K19, then K20), the launches the pipeline
    makes, on the current stream.  On a card CUDA events time them; on the
    CPU (plain twins) the host clock.  The port of
    `webp_tpu/encode/vp8.py:1608`, whose p2_s holds the prepack (K18):
    JAX's `_prepack_batch_pertbl` is K5 + K18, and its pack_s K19 alone."""
    n_try = n_try_for(method)
    dev = torch.device(device)
    y, u, v = upload(planes, dev)
    segs = None
    if segments:
        segs = seg_results if seg_results is not None else segment(y, u, v, quality)
    P, sid = params_for(segs, quality, dev)

    def best_of(fn):
        out = fn()
        times = []
        for _ in range(reps):
            if dev.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1000)
            else:
                t0 = time.perf_counter()
                out = fn()
                times.append(time.perf_counter() - t0)
        return min(times), out

    t_p1, (totals, ones) = best_of(lambda: encode_analysis_stats_batch(
        y, u, v, P, EncTables.default(dev), min(n_try, 3), sid))
    tables = tables_for(adapt_probs(totals.cpu().numpy(), ones.cpu().numpy()), dev)
    t_p2, arrays = best_of(lambda: encode_analysis_batch(y, u, v, P, tables, n_try, method >= 4,
                                                         sid))

    def pack():
        pre = wire_ops.prepack_pack(arrays)
        return wire_ops.wire(*pre[5:], *pre[1:5])

    t_pack, _ = best_of(pack)
    return {"p1_s": t_p1, "p2_s": t_p2, "pack_s": t_pack}


def finish_frames_lossy_batch(arrays_list, probs, quality: int, width: int, height: int,
                              num_partitions: int = 1, segs=None) -> list:
    """Stage 10: per-image VP8 payloads, in a host thread pool (an image's
    arrays are unpacked in its worker)."""
    with spans.span("enc.finish"):
        return _pool_map(
            lambda i: vp8.finish_frame(arrays_list[i], None if probs is None else probs[i],
                                       quality, width, height, num_partitions,
                                       None if segs is None else segs[i]),
            range(len(arrays_list)))


def encode_frames_lossy_batch(rgbs, quality: int = 75, method: int = 4, two_pass: bool = True,
                              segments: bool = False, *, device_tokens: bool = False,
                              num_partitions: int = None, device="cuda") -> list:
    """Encode same-geometry RGB frames [h, w, 3|4] uint8 to VP8 payloads.
    With device_tokens (two-pass only) the card codes the coefficient
    partitions and the MB headers; the payloads are the same.  The
    parameters after `segments` are keyword-only; `num_partitions` None
    codes DEVICE_TOKEN_PARTS partitions with device tokens and 1 without,
    as the JAX package does."""
    n_try_for(method)
    if num_partitions is None:
        num_partitions = DEVICE_TOKEN_PARTS if device_tokens else 1
    vp8.check_partitions(num_partitions)
    h, w = rgbs[0].shape[:2]
    if any(r.shape[:2] != (h, w) for r in rgbs):
        raise ValueError("frames of one batch must share their geometry")
    arrays, probs, segs = analyze_frames_lossy_batch(rgb_to_planes(rgbs), quality, method,
                                                     two_pass, segments, device=device,
                                                     device_tokens=device_tokens,
                                                     num_partitions=num_partitions)
    if device_tokens:
        return finish_frames_tokens(arrays, probs, quality, w, h, segs)
    return finish_frames_lossy_batch(arrays, probs, quality, w, h, num_partitions, segs)


def encode_frame_lossy(rgb: np.ndarray, quality: int = 75, method: int = 4,
                       device="cuda") -> bytes:
    """One RGB frame [h, w, 3|4] uint8 -> its VP8 payload, with the JAX
    package's `Vp8Encoder` defaults (`webp_tpu/encode/vp8.py:1215`):
    two-pass, one partition, segments from 256 MBs; batch 1 of
    `encode_frames_lossy_batch`."""
    return encode_frames_lossy_batch([rgb], quality, method, True, True, num_partitions=1,
                                     device=device)[0]


def encode_frames_lossy_batch_mixed(rgbs, quality: int = 75, method: int = 4,
                                    two_pass: bool = True, segments: bool = False, *,
                                    device_tokens: bool = False, num_partitions: int = None,
                                    device="cuda") -> list:
    """Frames of mixed geometries: one batch per (h, w), results in input
    order; the parameters as `encode_frames_lossy_batch`'s."""
    groups = {}
    for i, im in enumerate(rgbs):
        groups.setdefault(im.shape[:2], []).append(i)
    out = [None] * len(rgbs)
    for idxs in groups.values():
        res = encode_frames_lossy_batch([rgbs[i] for i in idxs], quality, method, two_pass,
                                        segments, device_tokens=device_tokens,
                                        num_partitions=num_partitions, device=device)
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out
