"""ALPH chunk decoding: a raw or VP8L-compressed alpha plane, then the
inverse of its prediction filter (a copy of the JAX package's
`webp_tpu/decode/alpha.py`, routed to the port's lossless decode).

A compressed plane is the green channel of a headerless VP8L stream, which
`decode_lossless_batch_device` decodes on `device` (the entropy pass on the
host, its inverse transforms as kernels K9-K12).  The filters are host
numpy: horizontal and vertical as prefix sums along each axis, gradient as
a loop over the pixels (a 2D recurrence).
"""

from __future__ import annotations

import numpy as np

from ..errors import BitstreamError
from .vp8l_device import decode_lossless_batch_device


def decode_alpha_plane(chunk: bytes, width: int, height: int, device="cuda") -> np.ndarray:
    """Decode an ALPH chunk payload to an [h, w] uint8 alpha plane.  A
    compressed stream the C++ entropy pass rejects raises
    `io.native.StreamError`."""
    if len(chunk) == 0:
        raise BitstreamError("empty ALPH chunk")
    info = chunk[0]
    preprocessing = (info >> 4) & 0b11
    filtering = (info >> 2) & 0b11
    compression = info & 0b11
    if preprocessing > 1:
        raise BitstreamError("invalid alpha preprocessing")
    if compression > 1:
        raise BitstreamError("invalid alpha compression")

    payload = chunk[1:]
    if compression == 1:
        rgba = decode_lossless_batch_device([payload], width, height, implicit_dims=True,
                                            device=device)[0]
        plane = np.ascontiguousarray(rgba[:, :, 1])  # alpha rides the green channel
    else:
        required = width * height
        if len(payload) < required:
            raise BitstreamError("raw alpha plane too small")
        plane = np.frombuffer(payload, np.uint8, required).reshape(height, width).copy()

    return defilter_alpha(plane, filtering)


def defilter_alpha(plane: np.ndarray, filtering: int) -> np.ndarray:
    """Undo the alpha prediction filter in place; returns the plane."""
    h, w = plane.shape
    if filtering == 0:
        return plane
    if filtering == 1:  # horizontal: predictor is the left neighbor
        # First column predicts from the pixel above (row 0 col 0 predicts 0).
        col0 = np.cumsum(plane[:, 0].astype(np.uint32)).astype(np.uint8)
        plane[:, 0] = col0
        plane[:, :] = np.cumsum(plane.astype(np.uint32), axis=1).astype(np.uint8)
        return plane
    if filtering == 2:  # vertical: predictor is the top neighbor
        row0 = np.cumsum(plane[0].astype(np.uint32)).astype(np.uint8)
        plane[0] = row0
        plane[:, :] = np.cumsum(plane.astype(np.uint32), axis=0).astype(np.uint8)
        return plane
    if filtering == 3:  # gradient: clamp(left + top - topleft)
        prev = np.zeros(w, dtype=np.int32)
        for y in range(h):
            row = plane[y].astype(np.int32)
            if y == 0:
                # Row 0: pixel 0 predicts 0, the rest predict from the left.
                acc = np.cumsum(row) & 0xFF
                plane[0] = acc.astype(np.uint8)
                prev = plane[0].astype(np.int32)
                continue
            out = np.empty(w, dtype=np.int32)
            left = (row[0] + prev[0]) & 0xFF  # col 0 predicts from above
            out[0] = left
            for x in range(1, w):
                pred = left + prev[x] - prev[x - 1]
                pred = 0 if pred < 0 else (255 if pred > 255 else pred)
                left = (row[x] + pred) & 0xFF
                out[x] = left
            plane[y] = out.astype(np.uint8)
            prev = out
        return plane
    raise BitstreamError("invalid alpha filtering mode")
