"""Batched VP8L (lossless) decode on a torch device.

The host runs the serial entropy pass of each stream (the C++ Huffman
decoder of `native/vp8l.cpp`, bound in `io/native.py`) on a thread pool:
it yields the entropy-coded image and the stream's transforms, not yet
inverted.  Images that share a transform signature go to the device as one
batch, which applies the inverse transforms in reverse stream order with
kernels K9 subtract-green, K10 colour transform, K11 colour indexing and
K12 inverse predictor (`ops/vp8l_device.py`).  Bit-exact with the JAX
package's `webp_tpu/decode/vp8l_device.py`, whose host half is rebuilt
here; nothing here imports that package.

On a CPU device the kernels' plain torch twins run; on a CUDA device the
kernels run, or the call raises.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..io import native
from ..ops.vp8l_device import (color_indexing, color_transform_, inverse_predictor_,
                               subsample, subtract_green_)

PREDICTOR, COLOR, SUBTRACT_GREEN, COLOR_INDEXING = 0, 1, 2, 3  # transform types


def entropy_batch(datas, width: int, height: int, implicit_dims: bool = False):
    """The C++ entropy pass of every stream, threaded: a list of
    `native.vp8l_decode_entropy` results in input order."""
    if not datas:
        raise ValueError("no payloads")
    with ThreadPoolExecutor(max_workers=max(1, min(len(datas), os.cpu_count() or 1))) as pool:
        return list(pool.map(
            lambda d: native.vp8l_decode_entropy(d, width, height, implicit_dims), datas))


def signature(transforms, tw: int) -> tuple:
    """What a batch must share: each transform's (type, size_bits,
    table_size) in stream order, and the entropy-coded width."""
    return tuple((t, sb, ts) for t, sb, ts, _ in transforms) + (tw,)


def stack_params(results, idxs, sig, height: int):
    """Per transform of `sig`, its parameters stacked over the images
    `idxs`: predictor modes [n, bh, bw] (the predictor image's green),
    colour transform images [n, bh, bw, 4], palettes [n, 256, 4]
    zero-padded; None for subtract-green."""
    params = []
    for k, (ttype, size_bits, _) in enumerate(sig[:-1]):
        data = [results[i][1][k][3] for i in idxs]
        if ttype == PREDICTOR:
            params.append(np.stack([d.reshape(subsample(height, size_bits), -1, 4)[..., 1]
                                    for d in data]))
        elif ttype == COLOR:
            params.append(np.stack([d.reshape(subsample(height, size_bits), -1, 4)
                                    for d in data]))
        elif ttype == SUBTRACT_GREEN:
            params.append(None)
        else:
            table = np.zeros((len(idxs), 256, 4), np.uint8)
            for j, d in enumerate(data):
                table[j, : len(d) // 4] = d.reshape(-1, 4)
            params.append(table)
    return params


def apply_transforms(px: torch.Tensor, params, sig, width: int) -> torch.Tensor:
    """The inverse transforms of `sig`, in reverse stream order, on
    px [B, h, tw, 4] (consumed) -> RGBA [B, h, width, 4]."""
    for (ttype, size_bits, table_size), param in zip(reversed(sig[:-1]), reversed(params)):
        if ttype == PREDICTOR:
            inverse_predictor_(px, param, size_bits)
        elif ttype == COLOR:
            color_transform_(px, param, size_bits)
        elif ttype == SUBTRACT_GREEN:
            subtract_green_(px)
        else:
            px = color_indexing(px, param, table_size, width)
    if px.shape[2] != width:
        raise ValueError(f"transforms leave width {px.shape[2]}, not {width}")
    return px


def decode_lossless_batch_device(datas, width: int, height: int, implicit_dims: bool = False,
                                 device_out: bool = False, device="cuda"):
    """Decode same-geometry VP8L payloads -> RGBA [B, height, width, 4]
    uint8: numpy, or with device_out the tensor on `device` when the batch
    has one transform signature.

    `implicit_dims`: the payloads have no header (ALPH payloads).  Raises
    `io.native.StreamError` (a ValueError), with the C++ error code, on a
    stream the entropy pass rejects.
    """
    results = entropy_batch(datas, width, height, implicit_dims)
    groups = {}
    for i, (buf, transforms) in enumerate(results):
        groups.setdefault(signature(transforms, buf.shape[1]), []).append(i)

    pieces = []
    for sig, idxs in groups.items():
        px = torch.from_numpy(np.stack([results[i][0] for i in idxs])).to(device)
        params = [None if p is None else torch.from_numpy(p).to(device)
                  for p in stack_params(results, idxs, sig, height)]
        pieces.append((idxs, apply_transforms(px, params, sig, width)))

    if device_out and len(pieces) == 1:
        return pieces[0][1]
    out = np.empty((len(datas), height, width, 4), np.uint8)
    for idxs, rgba in pieces:
        out[idxs] = rgba.cpu().numpy()
    return out
