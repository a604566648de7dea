"""Seeded WebP files, written without an encoder.

A few functions that wrap payloads in the RIFF container (the WebP
container specification): `chunk` and `riff`, the VP8X header (`vp8x`),
ALPH payloads (`alph`: the forward filter of each of the four modes, raw
or as a headerless VP8L stream, the preprocessing bit), ANIM and ANMF
(`anim`, `anmf`: frame offsets, durations, the blend and dispose bits),
and whole files (`still_vp8`, `still_vp8l`, `extended`, `animation`).
The pixel payloads come from the jax-free writers `random_vp8.py`
(`random_keyframe`) and `random_vp8l.py` (`vp8l_stream`).

`alpha_plane`, `demo_animation` and `demo_still` build the seeded
scenes that the decoder API's tests and `chip_smoke.py` decode: a VP8X
still with ALPH and ICCP / EXIF / XMP, and an animation whose frames cover
a full-canvas VP8 frame, a smaller one at an offset, ALPH + VP8 that
disposes, VP8L with alpha blended, and frames that do not blend.

The module imports neither jax nor the JAX package, so `chip_smoke.py` can
use it where only PyTorch is installed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from random_vp8 import random_keyframe
from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor, vp8l_stream, with_alpha

# VP8X flag bits.
ICC, ALPHA, EXIF, XMP, ANIMATION = 0x20, 0x10, 0x08, 0x04, 0x02
FILTERS = (0, 1, 2, 3)  # none, horizontal, vertical, gradient


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: fourcc, u32le size, payload, a pad byte if odd."""
    assert len(fourcc) == 4
    return fourcc + len(payload).to_bytes(4, "little") + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def vp8x(width: int, height: int, flags: int) -> bytes:
    """The VP8X chunk of a width x height canvas."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def filter_alpha(plane: np.ndarray, filtering: int) -> np.ndarray:
    """The forward ALPH filter: each pixel minus its prediction from the
    unfiltered neighbours, mod 256.  Pixel (0, 0) predicts 0; row 0 predicts
    from the left, column 0 from above; elsewhere horizontal takes the left,
    vertical the top and gradient clip(left + top - top-left, 0, 255)."""
    a = plane.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if filtering == 0:
        pred[:] = 0
    elif filtering == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif filtering == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph(plane: np.ndarray, filtering: int, compressed: bool, seed: int = 0,
         preprocessing: int = 0, transforms=()) -> bytes:
    """The ALPH payload of an alpha plane [h, w] uint8: the info byte, then
    the filtered plane raw, or as a headerless VP8L stream through
    `transforms` whose green carries it."""
    filtered = filter_alpha(plane, filtering)
    info = bytes([(preprocessing << 4) | (filtering << 2) | int(compressed)])
    if not compressed:
        return info + filtered.tobytes()
    rgba = np.zeros((*plane.shape, 4), np.uint8)
    rgba[..., 1] = filtered
    rgba[..., 3] = 255
    return info + vp8l_stream(rgba, seed, transforms, implicit=True)


def anim(background=(0, 0, 0, 0), loop_count: int = 0) -> bytes:
    return chunk(b"ANIM", bytes(background) + loop_count.to_bytes(2, "little"))


def anmf(x: int, y: int, width: int, height: int, duration: int, body: bytes,
         blend: bool = True, dispose: bool = False) -> bytes:
    """An ANMF chunk: an even offset (x, y), the frame's size, its duration
    in ms and its sub-chunks `body` (ALPH + VP8, VP8 or VP8L)."""
    assert x % 2 == 0 and y % 2 == 0
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, width - 1, height - 1,
                                                      duration))
    return chunk(b"ANMF", head + bytes([(0 if blend else 2) | int(dispose)]) + body)


def still_vp8(payload: bytes) -> bytes:
    return riff(chunk(b"VP8 ", payload))


def still_vp8l(stream: bytes) -> bytes:
    return riff(chunk(b"VP8L", stream))


def extended(width: int, height: int, image: bytes, alpha: bytes = None, iccp: bytes = None,
             exif: bytes = None, xmp: bytes = None, lossless: bool = False) -> bytes:
    """A VP8X still: the VP8 payload `image` with the ALPH payload `alpha`
    (or the VP8L stream `image` with `lossless`), and metadata chunks."""
    flags = ((ICC if iccp is not None else 0) | (ALPHA if alpha is not None or lossless else 0)
             | (EXIF if exif is not None else 0) | (XMP if xmp is not None else 0))
    parts = [vp8x(width, height, flags)]
    if iccp is not None:
        parts.append(chunk(b"ICCP", iccp))
    if alpha is not None:
        parts.append(chunk(b"ALPH", alpha))
    parts.append(chunk(b"VP8L" if lossless else b"VP8 ", image))
    for fourcc, data in ((b"EXIF", exif), (b"XMP ", xmp)):
        if data is not None:
            parts.append(chunk(fourcc, data))
    return riff(*parts)


def animation(width: int, height: int, frames, background=(0, 0, 0, 0), loop_count: int = 0,
              alpha: bool = True, iccp: bytes = None, exif: bytes = None,
              xmp: bytes = None) -> bytes:
    """An animated VP8X file of ANMF chunks `frames` on a width x height
    canvas."""
    flags = (ANIMATION | (ALPHA if alpha else 0) | (ICC if iccp is not None else 0)
             | (EXIF if exif is not None else 0) | (XMP if xmp is not None else 0))
    parts = [vp8x(width, height, flags)]
    if iccp is not None:
        parts.append(chunk(b"ICCP", iccp))
    parts.append(anim(background, loop_count))
    parts += list(frames)
    for fourcc, data in ((b"EXIF", exif), (b"XMP ", xmp)):
        if data is not None:
            parts.append(chunk(fourcc, data))
    return riff(*parts)


def alpha_plane(width: int, height: int, seed: int) -> np.ndarray:
    """A seeded alpha plane [h, w] uint8: a ramp, rectangles of other
    values and a little noise, so that every filter has work."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:height, 0:width]
    plane = (gx * rng.randint(1, 5) + gy * rng.randint(1, 5) + rng.randint(0, 256)) % 256
    for _ in range(3):
        y0, x0 = rng.randint(0, height), rng.randint(0, width)
        plane[y0: y0 + rng.randint(1, height // 2 + 2),
              x0: x0 + rng.randint(1, width // 2 + 2)] = rng.randint(0, 256)
    plane = plane + rng.randint(0, 3, plane.shape)
    return (plane % 256).astype(np.uint8)


def metadata(seed: int):
    """Seeded ICCP, EXIF and XMP payloads (odd sizes among them)."""
    rng = np.random.RandomState(seed)
    return tuple(rng.bytes(int(n)) for n in rng.randint(1, 200, 3))


def rgba_frame(width: int, height: int, seed: int) -> np.ndarray:
    """A seeded RGBA image: blocks of colour, alpha from `with_alpha`."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, ((height + 7) // 8, (width + 7) // 8, 3)).astype(np.uint8)
    rgb = np.kron(rgb, np.ones((8, 8, 1), np.uint8))[:height, :width]
    return with_alpha(rgb, seed)


@dataclasses.dataclass
class Still:
    """A VP8X still and its sources: the VP8 payload, the alpha plane and
    its ALPH payload."""

    data: bytes
    vp8: bytes
    alpha: np.ndarray
    alph: bytes
    iccp: bytes
    exif: bytes
    xmp: bytes


def demo_still(width: int, height: int, seed: int, filtering: int, compressed: bool,
               transforms=(PALETTE,)) -> Still:
    """A VP8X still: a seeded VP8 keyframe, its ALPH (the given filter,
    compressed through `transforms` or raw) and ICCP, EXIF and XMP."""
    vp8, _ = random_keyframe(width, height, seed)
    plane = alpha_plane(width, height, seed)
    iccp, exif, xmp = metadata(seed)
    payload = alph(plane, filtering, compressed, seed, 0, transforms)
    data = extended(width, height, vp8, payload, iccp, exif, xmp)
    return Still(data, vp8, plane, payload, iccp, exif, xmp)


@dataclasses.dataclass
class AnimFrame:
    """One ANMF frame's placement and sources: a VP8 payload (with an
    alpha plane when it has ALPH) or an RGBA image (VP8L)."""

    x: int
    y: int
    width: int
    height: int
    duration: int
    blend: bool
    dispose: bool
    vp8: bytes = None
    alpha: np.ndarray = None
    rgba: np.ndarray = None
    alph: bytes = None  # the ALPH payload of `alpha`
    vp8l: bytes = None  # the VP8L stream of `rgba`


def demo_animation(width: int, height: int, seed: int, alpha_filter: int = 3,
                   alpha_compressed: bool = True):
    """(file, frames) of a seeded animation on a width x height canvas
    (both at least 4): a full-canvas VP8 frame; a smaller VP8 frame at an
    even offset, blended; an ALPH + VP8 frame that disposes; a VP8L frame
    with alpha, blended; a VP8L frame that does not blend; a full-canvas
    ALPH + VP8 frame that does not blend.  Loop count 3, a background hint,
    durations 20-120 ms."""
    rng = np.random.RandomState(seed)
    hw, hh = max(width // 2, 1), max(height // 2, 1)
    ox, oy = (width // 4) & ~1, (height // 4) & ~1
    frames = []

    def vp8_frame(x, y, w, h, blend, dispose, with_alpha_plane):
        payload, _ = random_keyframe(w, h, int(rng.randint(1 << 30)))
        plane = alpha_plane(w, h, int(rng.randint(1 << 30))) if with_alpha_plane else None
        frames.append(AnimFrame(x, y, w, h, int(rng.randint(20, 121)), blend, dispose,
                                vp8=payload, alpha=plane))

    def vp8l_frame(x, y, w, h, blend, dispose):
        frames.append(AnimFrame(x, y, w, h, int(rng.randint(20, 121)), blend, dispose,
                                rgba=rgba_frame(w, h, int(rng.randint(1 << 30)))))

    vp8_frame(0, 0, width, height, True, False, False)
    vp8_frame(ox, oy, hw, hh, True, False, False)
    vp8_frame(width - hw - (width - hw) % 2, 0, hw, hh, True, True, True)
    vp8l_frame(0, oy, hw, height - oy, True, False)
    vp8l_frame(ox, 0, width - ox, hh, False, False)
    vp8_frame(0, 0, width, height, False, False, True)

    chunks = []
    for i, f in enumerate(frames):
        if f.rgba is not None:
            transforms = ((SUBTRACT_GREEN, predictor(2), color(3)), (PALETTE,))[i % 2]
            if transforms == (PALETTE,) and len(np.unique(f.rgba.reshape(-1, 4), axis=0)) > 256:
                transforms = (predictor(3),)
            f.vp8l = vp8l_stream(f.rgba, i, transforms)
            body = chunk(b"VP8L", f.vp8l)
        elif f.alpha is not None:
            f.alph = alph(f.alpha, alpha_filter, alpha_compressed, i, transforms=(predictor(2),))
            body = chunk(b"ALPH", f.alph) + chunk(b"VP8 ", f.vp8)
        else:
            body = chunk(b"VP8 ", f.vp8)
        chunks.append(anmf(f.x, f.y, f.width, f.height, f.duration, body, f.blend, f.dispose))
    iccp, exif, xmp = metadata(seed)
    data = animation(width, height, chunks, tuple(rng.randint(0, 256, 4)), 3, True, iccp,
                     exif, xmp)
    return data, frames
