"""The reference decode of a VP8 keyframe to RGB, and its MB modes."""

from __future__ import annotations

import numpy as np

from .decode.vp8 import Vp8Decoder


def decode_rgb(payload: bytes, upsampling: str = "bilinear") -> np.ndarray:
    """[height, width, 3] uint8 RGB of a VP8 keyframe payload; "bilinear" is
    libwebp's fancy upsampling, "simple" repeats each chroma sample."""
    return Vp8Decoder(bytes(payload)).decode().to_rgb(upsampling)


def mb_modes(payload: bytes) -> np.ndarray:
    """Per MB the luma mode (0-3 whole-block, 4 B-predicted) of a keyframe,
    from its header and entropy pass."""
    d = Vp8Decoder(bytes(payload))
    d.parse()
    return np.asarray(d.luma_mode)
