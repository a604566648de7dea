"""Frozen copy of the plain code of `webp_tpu_torch/encode/quant.py`, the
benchmark's reference; it imports nothing of the port.

Quantization parameters of the lossy encode (host): the quality curve,
biased quantization matrices (with the y1 trellis sharpening), per-segment
RD and trellis lambdas and the loop-filter level.  The same arithmetic as
`webp_tpu/encode/quant.py`.
"""

from __future__ import annotations

import numpy as np

from ..common import vp8_tables as T
from . import tables as ET

QFIX = 17
FSTRENGTH_CUTOFF = 2
# Global chroma-DC quant boost: U/V DC runs two index steps finer than luma
# (a header-level uvdc_delta; libwebp derives -2 from its default sns=50).
DQ_UV_DC = -2


def quality_to_quant_index(quality: int) -> int:
    c = quality / 100.0
    linear_c = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
    comp = linear_c ** (1.0 / 3.0) if linear_c > 0 else 0.0
    q = round(127.0 * (1.0 - comp))
    return min(max(int(q), 0), 127)


def _bias(b: int) -> int:
    return ((b << QFIX) + 128) >> 8


def compute_filter_level(quant_index: int, sharpness: int = 0, strength: int = 60,
                         beta: int = 0) -> int:
    """Loop-filter strength from the quantizer (libwebp VP8SetupFilterStrength)."""
    level0 = 5 * strength
    qstep = int(ET.VP8_AC_TABLE[quant_index]) >> 2
    base = int(ET.LEVELS_FROM_DELTA[min(sharpness, 7), min(qstep, 63)])
    f = (base * level0) // (256 + beta)
    if f < FSTRENGTH_CUTOFF:
        return 0
    return min(f, 63)


class Matrix:
    """Biased quantization matrix for one plane type ('y1' | 'y2' | 'uv'):
    step q, reciprocal iq and rounding bias, DC first then the 15 AC."""

    BIASES = {"y1": (96, 110), "y2": (96, 108), "uv": (110, 115)}

    def __init__(self, q_dc: int, q_ac: int, kind: str):
        dc_b, ac_b = self.BIASES[kind]
        q = np.full(16, q_ac, np.int64)
        q[0] = q_dc
        bias = np.full(16, _bias(ac_b), np.int64)
        bias[0] = _bias(dc_b)
        self.q = q
        self.iq = (1 << QFIX) // q
        self.bias = bias
        # Per-frequency boost of the coefficients the trellis quantizes (y1 only).
        self.sharpen = (ET.VP8_FREQ_SHARPENING.astype(np.int64) * q >> 11 if kind == "y1"
                        else np.zeros(16, np.int64))


class SegmentParams:
    """Quantizers, matrices and RD lambdas for one segment.  `quantizer_level`
    is the segment's delta to the frame's quant index and `lf_level` its
    loop-filter strength (set by `analysis.setup_segments_from_alphas`),
    both written to the segment header."""

    def __init__(self, quant_index: int, quantizer_delta: int = 0, uv_ac_delta: int = 0,
                 uv_dc_delta: int = DQ_UV_DC):
        qi = min(max(quant_index + quantizer_delta, 0), 127)
        self.quant_index = qi
        self.quantizer_level = quantizer_delta
        self.uv_ac_delta = uv_ac_delta
        self.uv_dc_delta = uv_dc_delta
        self.lf_level = None
        ydc = int(T.DC_QUANT[qi])
        yac = int(T.AC_QUANT[qi])
        y2dc = int(T.DC_QUANT[qi]) * 2
        y2ac = max(int(T.AC_QUANT[qi]) * 155 // 100, 8)
        uvdc_i = min(max(qi + uv_dc_delta, 0), 127)
        uvac_i = min(max(qi + uv_ac_delta, 0), 127)
        # Clamped to 132 to stay consistent with decoder dequantization.
        uvdc = min(int(T.DC_QUANT[uvdc_i]), 132)
        uvac = int(T.AC_QUANT[uvac_i])

        self.y1 = Matrix(ydc, yac, "y1")
        self.y2 = Matrix(y2dc, y2ac, "y2")
        self.uv = Matrix(uvdc, uvac, "uv")

        q_i4 = (ydc + 15 * yac + 8) >> 4
        q_i16 = (y2dc + 15 * y2ac + 8) >> 4
        q_uv = (uvdc + 15 * uvac + 8) >> 4
        self.lambda_trellis_i4 = max((7 * q_i4 * q_i4) >> 3, 1)
        self.lambda_trellis_i16 = max((q_i16 * q_i16) >> 2, 1)
        self.lambda_trellis_uv = max((q_uv * q_uv) << 1, 1)
        self.lambda_i4 = max((3 * q_i4 * q_i4) >> 7, 1)
        self.lambda_i16 = max(3 * q_i16 * q_i16, 1)
        self.lambda_uv = max((3 * q_uv * q_uv) >> 6, 1)
        self.lambda_mode = max((q_i4 * q_i4) >> 7, 1)
        self.tlambda = (50 * q_i4) >> 5  # sns_strength=50
