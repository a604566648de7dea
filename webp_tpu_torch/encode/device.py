"""Batched lossy VP8 encode on a torch device (methods 0-6, segments on or off).

The port of `webp_tpu/encode/vp8.py` `analyze_frames_lossy_batch` (:1448),
`dispatch_seg_results` (:1379), `encode_frames_lossy_batch` (:1682),
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
8. `fetch`: the dense per-MB arrays to the host, in one copy.
9. `finish`: skip flags, contexts, token and MB-header coding and the
   frame header (with the segment header and map) per image in a thread
   pool (`encode/vp8.py`).

With two_pass=False, one K5 pass runs on the default tables at
n_try = min(n_try, 3), with the trellis from method 4, and the finisher
adapts the header's probabilities from the final levels itself.  Every
entry point takes an explicit `device`: on "cpu" the kernels' plain twins
run, on "cuda" the kernels (or the call raises).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..common import vp8_tables as T
from ..io import native
from ..ops.analysis import analyze_alphas_batch
from ..ops.enc_params import EncParams, EncTables
from ..ops.enc_tables import enc_tables
from ..ops.encode_wavefront import OUT_FIELDS, encode_analysis_batch
from ..ops.token_stats import token_stats
from . import vp8
from .analysis import MIN_MBS, setup_segments_from_alphas
from .costs import ProbaStats
from .quant import SegmentParams, quality_to_quant_index


def n_try_for(method: int) -> int:
    """B modes tried per subblock: 0 for methods 0-1 (I16 only), 3 for 2-3,
    4 for method 4 and all 10 from method 5."""
    if method < 0:
        raise ValueError(f"method must be >= 0, got {method}")
    return 0 if method <= 1 else 3 if method <= 3 else 4 if method == 4 else 10


def _pool_map(fn, items):
    items = list(items)
    with ThreadPoolExecutor(max_workers=max(1, min(len(items), os.cpu_count() or 1))) as pool:
        return list(pool.map(fn, items))


def rgb_to_planes(rgbs):
    """Same-geometry RGB frames -> padded (Y, U, V) uint8 batches on the host."""
    planes = _pool_map(native.rgb_to_yuv420, rgbs)
    return tuple(np.stack([p[i] for p in planes]) for i in range(3))


def upload(planes, device):
    return tuple(torch.from_numpy(p).to(device) for p in planes)


def skip_flags(arrays):
    """[B, nmb] bool: the MB carries no nonzero level (device arrays)."""
    return ((arrays["y_levels"] == 0).all(-1).all(-1) & (arrays["uv_levels"] == 0).all(-1).all(-1)
            & (arrays["y2_levels"] == 0).all(-1))


def segment(y, u, v, quality: int):
    """Per-image `Segmentation`s of device planes from K8's alphas (frames of
    at least 256 MBs), or None below that: segments stay off."""
    B, H, W = y.shape
    if (H // 16) * (W // 16) < MIN_MBS:
        return None
    alpha, uv_alpha = (a.cpu().numpy() for a in analyze_alphas_batch(y, u, v))
    qi = quality_to_quant_index(quality)
    return _pool_map(lambda i: setup_segments_from_alphas(alpha[i], int(uv_alpha[i]), qi),
                     range(B))


def params_for(segs, quality: int, device):
    """(EncParams, MB segment ids [B, nmb] uint8 or None) for K5: the
    images' four segments, or the frame's one parameter set."""
    if segs is None:
        return EncParams.from_segment(SegmentParams(quality_to_quant_index(quality)), device), None
    sid = np.stack([s.segment_map for s in segs]).astype(np.uint8)
    return (EncParams.from_segments([s.segments for s in segs], device),
            torch.from_numpy(sid).to(device))


def encode_analysis_stats_batch(y, u, v, P: EncParams, tbl: EncTables, n_try: int, sid=None):
    """Pass 1: K5 (no trellis) then K6 on one stream; (totals, ones) [B, 4,
    8, 3, 11] int32 on the device.  The levels stay on the device."""
    out = encode_analysis_batch(y, u, v, P, tbl, n_try, False, sid)
    mbw, mbh = y.shape[2] // 16, y.shape[1] // 16
    return token_stats(out["luma_mode"], out["y2_levels"], out["y_levels"], out["uv_levels"],
                       skip_flags(out), mbw, mbh)


def adapt_probs(totals: np.ndarray, ones: np.ndarray) -> np.ndarray:
    """Per-image adapted token probabilities [B, 4, 8, 3, 11] uint8."""
    return np.stack(_pool_map(
        lambda i: ProbaStats(totals[i], ones[i]).updated_probs(T.COEFF_PROBS_DEFAULT),
        range(len(totals))))


def tables_for(probs: np.ndarray, device) -> EncTables:
    return enc_tables(torch.from_numpy(np.ascontiguousarray(probs, np.uint8)).to(device))


def fetch(arrays):
    """The dense per-MB arrays to the host: per image, a dict of int32 arrays."""
    host = {k: arrays[k].cpu().numpy() for k in OUT_FIELDS}
    return [{k: host[k][i].astype(np.int32) for k in OUT_FIELDS}
            for i in range(host["luma_mode"].shape[0])]


def analyze_frames_lossy_batch(planes, quality: int, method: int, two_pass: bool = True,
                               segments: bool = False, device="cuda"):
    """Stages 2-8 on host planes (Y, U, V) [B, ...]: (per-image arrays,
    per-image adapted probabilities or None, per-image segmentations or
    None)."""
    n_try = n_try_for(method)
    trellis = method >= 4
    dev = torch.device(device)
    y, u, v = upload(planes, dev)
    segs = segment(y, u, v, quality) if segments else None
    P, sid = params_for(segs, quality, dev)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    if not two_pass:
        out = encode_analysis_batch(y, u, v, P, default, min(n_try, 3), trellis, sid)
        return fetch(out), None, segs
    totals, ones = encode_analysis_stats_batch(y, u, v, P, default, min(n_try, 3), sid)
    probs = adapt_probs(totals.cpu().numpy(), ones.cpu().numpy())
    out = encode_analysis_batch(y, u, v, P, tables_for(probs, dev), n_try, trellis, sid)
    return fetch(out), probs, segs


def finish_frames_lossy_batch(arrays_list, probs, quality: int, width: int, height: int,
                              num_partitions: int = 1, segs=None) -> list:
    """Stage 9: per-image VP8 payloads, in a host thread pool."""
    return _pool_map(
        lambda i: vp8.finish_frame(arrays_list[i], None if probs is None else probs[i],
                                   quality, width, height, num_partitions,
                                   None if segs is None else segs[i]),
        range(len(arrays_list)))


def encode_frames_lossy_batch(rgbs, quality: int = 75, method: int = 4, two_pass: bool = True,
                              segments: bool = False, num_partitions: int = 1,
                              device="cuda") -> list:
    """Encode same-geometry RGB frames [h, w, 3|4] uint8 to VP8 payloads."""
    n_try_for(method)
    if num_partitions not in vp8.PARTITIONS:
        raise ValueError(f"num_partitions must be one of {vp8.PARTITIONS}, got {num_partitions}")
    h, w = rgbs[0].shape[:2]
    if any(r.shape[:2] != (h, w) for r in rgbs):
        raise ValueError("frames of one batch must share their geometry")
    arrays, probs, segs = analyze_frames_lossy_batch(rgb_to_planes(rgbs), quality, method,
                                                     two_pass, segments, device)
    return finish_frames_lossy_batch(arrays, probs, quality, w, h, num_partitions, segs)


def encode_frames_lossy_batch_mixed(rgbs, quality: int = 75, method: int = 4,
                                    two_pass: bool = True, segments: bool = False,
                                    num_partitions: int = 1, device="cuda") -> list:
    """Frames of mixed geometries: one batch per (h, w), results in input order."""
    groups = {}
    for i, im in enumerate(rgbs):
        groups.setdefault(im.shape[:2], []).append(i)
    out = [None] * len(rgbs)
    for idxs in groups.values():
        res = encode_frames_lossy_batch([rgbs[i] for i in idxs], quality, method, two_pass,
                                        segments, num_partitions, device)
        for j, i in enumerate(idxs):
            out[i] = res[j]
    return out
