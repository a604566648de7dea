"""The reference two-pass lossy encode of same-geometry RGB frames."""

from __future__ import annotations

import numpy as np
import torch

from .common import vp8_tables as T
from .encode.analysis import MIN_MBS, setup_segments_from_alphas
from .encode.costs import ProbaStats
from .encode.quant import SegmentParams, quality_to_quant_index
from .encode.vp8 import finish_frame
from .encode.yuv import rgb_to_yuv420
from .ops.analysis import analyze_alphas_batch_plain
from .ops.enc_params import EncParams, EncTables
from .ops.enc_tables import enc_tables_plain
from .ops.encode_wavefront import OUT_FIELDS, encode_analysis_batch_plain
from .ops.token_stats import skip_flags, token_stats_plain


def n_try_for(method: int) -> int:
    """B modes tried per subblock: 0 for methods 0-1, 3 for 2-3, 4 for
    method 4 and all 10 from method 5."""
    return 0 if method <= 1 else 3 if method <= 3 else 4 if method == 4 else 10


def segmentations(y, u, v, quality: int):
    """Per-image k-means segmentations from the plain K8 alphas, or None
    below 256 MBs (segments stay off)."""
    B, H, W = y.shape
    if (H // 16) * (W // 16) < MIN_MBS:
        return None
    alpha, uv_alpha = analyze_alphas_batch_plain(y, u, v)
    joint = torch.cat([alpha, uv_alpha[:, None]], dim=1).cpu().numpy()
    qi = quality_to_quant_index(quality)
    return [setup_segments_from_alphas(joint[i, :-1], int(joint[i, -1]), qi) for i in range(B)]


def encode_frames(rgbs, quality: int, method: int, segments: bool, num_partitions: int) -> list:
    """VP8 payloads of RGB frames [h, w, 3] uint8 of one geometry, two-pass,
    with the trellis from method 4."""
    h, w = rgbs[0].shape[:2]
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    planes = [rgb_to_yuv420(r) for r in rgbs]
    y, u, v = (torch.from_numpy(np.stack([p[i] for p in planes])) for i in range(3))
    segs = segmentations(y, u, v, quality) if segments else None
    if segs is None:
        P = EncParams.from_segment(SegmentParams(quality_to_quant_index(quality)), "cpu")
        sid = None
    else:
        P = EncParams.from_segments([s.segments for s in segs], "cpu")
        sid = torch.from_numpy(np.stack([s.segment_map for s in segs]).astype(np.uint8))
    n_try = n_try_for(method)
    out = encode_analysis_batch_plain(y, u, v, P, EncTables.default("cpu"), min(n_try, 3), False,
                                      sid)
    totals, ones = token_stats_plain(out["luma_mode"], out["y2_levels"], out["y_levels"],
                                     out["uv_levels"],
                                     skip_flags(out["y2_levels"], out["y_levels"],
                                                out["uv_levels"]), mbw, mbh)
    totals, ones = totals.numpy(), ones.numpy()
    probs = np.stack([ProbaStats(totals[i], ones[i]).updated_probs(T.COEFF_PROBS_DEFAULT)
                      for i in range(len(rgbs))])
    tables = enc_tables_plain(torch.from_numpy(np.ascontiguousarray(probs, np.uint8)))
    out = encode_analysis_batch_plain(y, u, v, P, tables, n_try, method >= 4, sid)
    host = {k: out[k].numpy() for k in OUT_FIELDS}
    return [finish_frame({k: host[k][i].astype(np.int32) for k in OUT_FIELDS}, probs[i], quality,
                         w, h, num_partitions, None if segs is None else segs[i])
            for i in range(len(rgbs))]
