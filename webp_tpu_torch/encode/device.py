"""Batched lossy VP8 encode on a torch device (methods 0-3, segments off).

The port of `webp_tpu/encode/vp8.py` `analyze_frames_lossy_batch` (:1448,
its segments-off branches), `encode_frames_lossy_batch` (:1682),
`finish_frames_lossy_batch` (:1702) and `encode_frames_lossy_batch_mixed`
(:1755), with `encode_wavefront2.encode_analysis_stats_batch` (:1471).
The stages, each a function here so that they can be timed apart:

1. `rgb_to_planes`: RGB -> padded YUV420 on the host (C++).
2. `upload`: the planes to the device.
3. Pass 1, `encode_analysis_stats_batch`: K5 with the default tables and
   n_try = min(n_try, 3), then K6 on the device-resident levels; only the
   (total, ones) token counts come back.
4. `adapt_probs`: the adapted probabilities per image, on the host.
5. `tables_for`: K7, per-image rate tables from those probabilities.
6. Pass 2, `analyze`: K5 with the per-image tables and the method's n_try.
7. `fetch`: the dense per-MB arrays to the host, in one copy.
8. `finish`: skip flags, contexts, token and MB-header coding and the
   frame header per image in a thread pool (`encode/vp8.py`).

With two_pass=False, pass 2 runs on the default tables and the finisher
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
from ..ops.enc_params import EncParams, EncTables
from ..ops.enc_tables import enc_tables
from ..ops.encode_wavefront import OUT_FIELDS, encode_analysis_batch
from ..ops.token_stats import token_stats
from . import vp8
from .costs import ProbaStats
from .quant import SegmentParams, quality_to_quant_index


def n_try_for(method: int) -> int:
    """B modes tried per subblock: 0 for methods 0-1 (I16 only), 3 for 2-3."""
    if method >= 4:
        raise NotImplementedError(
            f"method {method} needs the trellis kernels (webp_tpu/ops/trellis2.py "
            "trellis_par, trellis_spec3), not ported yet")
    if method < 0:
        raise ValueError(f"method must be >= 0, got {method}")
    return 0 if method <= 1 else 3


def _check_segments(segments: bool) -> None:
    if segments:
        raise NotImplementedError(
            "segments=True needs the segment analysis kernel (webp_tpu/ops/analysis2.py "
            "analyze_alphas_batch), not ported yet")


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


def encode_analysis_stats_batch(y, u, v, P: EncParams, tbl: EncTables, n_try: int):
    """Pass 1: K5 then K6 on one stream; (totals, ones) [B, 4, 8, 3, 11] int32
    on the device.  The levels stay on the device."""
    out = encode_analysis_batch(y, u, v, P, tbl, n_try)
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
    """Stages 2-7 on host planes (Y, U, V) [B, ...]: (per-image arrays,
    per-image adapted probabilities or None)."""
    _check_segments(segments)
    n_try = n_try_for(method)
    dev = torch.device(device)
    y, u, v = upload(planes, dev)
    P = EncParams.from_segment(SegmentParams(quality_to_quant_index(quality)), dev)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    if not two_pass:
        return fetch(encode_analysis_batch(y, u, v, P, default, min(n_try, 3))), None
    totals, ones = encode_analysis_stats_batch(y, u, v, P, default, min(n_try, 3))
    probs = adapt_probs(totals.cpu().numpy(), ones.cpu().numpy())
    return fetch(encode_analysis_batch(y, u, v, P, tables_for(probs, dev), n_try)), probs


def finish_frames_lossy_batch(arrays_list, probs, quality: int, width: int, height: int,
                              num_partitions: int = 1) -> list:
    """Stage 8: per-image VP8 payloads, in a host thread pool."""
    return _pool_map(
        lambda i: vp8.finish_frame(arrays_list[i], None if probs is None else probs[i],
                                   quality, width, height, num_partitions),
        range(len(arrays_list)))


def encode_frames_lossy_batch(rgbs, quality: int = 75, method: int = 4, two_pass: bool = True,
                              segments: bool = False, num_partitions: int = 1,
                              device="cuda") -> list:
    """Encode same-geometry RGB frames [h, w, 3|4] uint8 to VP8 payloads."""
    _check_segments(segments)
    n_try_for(method)
    if num_partitions not in vp8.PARTITIONS:
        raise ValueError(f"num_partitions must be one of {vp8.PARTITIONS}, got {num_partitions}")
    h, w = rgbs[0].shape[:2]
    if any(r.shape[:2] != (h, w) for r in rgbs):
        raise ValueError("frames of one batch must share their geometry")
    arrays, probs = analyze_frames_lossy_batch(rgb_to_planes(rgbs), quality, method, two_pass,
                                               segments, device)
    return finish_frames_lossy_batch(arrays, probs, quality, w, h, num_partitions)


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
