"""Public encoder API and RIFF container muxing.

The port of `webp_tpu/encode/api.py`: `Preset`, `EncoderParams`,
`EncoderConfig`, `Encoder` with its chained setters, the writer-style
`WebPEncoder`, `encode_rgb`, `encode_rgba`, `encode_lossless_rgba` and the
animation muxer `AnimationEncoder`, with the VP8X, ALPH, ICCP, EXIF and
XMP chunks.

Lossy images go to `device` through the batched encode of
`encode/device.py` at a batch of one: two passes, one partition, the
trellis from method 4 and segments from 256 MBs, which is what the JAX
package's host `Vp8Encoder(quality, method)` computes, byte for byte (K8
from 256 MBs, K5 for pass 1, K6, K7, K5 for pass 2, the fused K18 + K19
and K20, then the host finish).  The colour conversion stays on the host
(C++ `rgb_to_yuv420`, or the numpy sharp-YUV and gray conversions of
`ops/yuv.py`).  Lossless images, ALPH and near-lossless run the host VP8L
encoder (`encode/vp8l.py`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..container import chunks as ck
from ..errors import EncodingError, InvalidDimensions
from ..io import native
from ..ops import yuv as yuvops
from . import device as edev
from .vp8l import encode_alpha_lossless, encode_lossless, near_lossless_preprocess


class Preset:
    """Content presets: photographic presets turn on sharp-YUV chroma,
    synthetic-content presets route to lossless."""

    DEFAULT = "default"
    PICTURE = "picture"
    PHOTO = "photo"
    DRAWING = "drawing"
    ICON = "icon"
    TEXT = "text"


@dataclasses.dataclass
class EncoderParams:
    """Fine-tuning knobs."""

    use_predictor_transform: bool = True


@dataclasses.dataclass
class EncoderConfig:
    """Reusable encoder configuration."""

    quality: float = 75.0
    alpha_quality: float = 100.0
    method: int = 4
    lossless: bool = False
    exact: bool = False
    preset: str = Preset.DEFAULT
    near_lossless: int = 100  # pre-quantization level (encode/vp8l.py)
    target_size: int = 0      # full-output rate control (Encoder.encode)
    sharp_yuv: bool = False   # least-squares chroma refinement (ops/yuv.py)
    params: EncoderParams = dataclasses.field(default_factory=EncoderParams)

    @classmethod
    def new_lossy(cls, quality: float = 75.0) -> "EncoderConfig":
        return cls(quality=quality, lossless=False)

    @classmethod
    def new_lossless(cls) -> "EncoderConfig":
        return cls(quality=100.0, lossless=True)


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    out = fourcc + len(payload).to_bytes(4, "little") + payload
    if len(payload) & 1:
        out += b"\x00"
    return out


def _riff(chunks: bytes) -> bytes:
    return ck.RIFF + (4 + len(chunks)).to_bytes(4, "little") + ck.WEBP + chunks


def _vp8x(width: int, height: int, *, alpha=False, icc=False, exif=False, xmp=False,
          anim=False) -> bytes:
    flags = ((0x20 if icc else 0) | (0x10 if alpha else 0) | (0x08 if exif else 0)
             | (0x04 if xmp else 0) | (0x02 if anim else 0))
    payload = bytes([flags, 0, 0, 0])
    payload += (width - 1).to_bytes(3, "little")
    payload += (height - 1).to_bytes(3, "little")
    return _chunk(ck.VP8X, payload)


def encode_vp8(planes, width: int, height: int, quality, method: int, device) -> bytes:
    """One VP8 payload of host planes (Y, U, V), MB-padded, on `device`: the
    batched two-pass encode at a batch of one, one partition, segments
    from 256 MBs."""
    batch = tuple(np.ascontiguousarray(p)[None] for p in planes)
    arrays, probs, segs = edev.analyze_frames_lossy_batch(
        batch, int(quality), min(method, 6), two_pass=True, segments=True, device=device)
    return edev.finish_frames_lossy_batch(arrays, probs, int(quality), width, height,
                                          num_partitions=1, segs=segs)[0]


def alpha_payload(alpha_plane: np.ndarray, alpha_quality) -> bytes:
    """The ALPH payload of an alpha plane [h, w] uint8: VP8L-compressed,
    after near-lossless pre-quantization when alpha_quality < 100."""
    if alpha_quality < 100:
        rgba_a = np.repeat(alpha_plane[:, :, None], 4, axis=2)
        alpha_plane = np.ascontiguousarray(
            near_lossless_preprocess(rgba_a, int(alpha_quality))[:, :, 0])
    return encode_alpha_lossless(alpha_plane)


class Encoder:
    """Encoder over an in-memory image, configured by chained setters.

    Accepts RGB8 / RGBA8 / L8 / LA8 numpy arrays ([h, w, c] or [h, w]).
    Lossy images are encoded on `device` ("cuda" by default; "cpu" runs the
    kernels' plain twins).
    """

    def __init__(self, image: np.ndarray, color_type: Optional[str] = None, *, device="cuda"):
        image = np.asarray(image)
        if image.ndim == 2:
            image = image[:, :, None]
        channels = image.shape[2]
        inferred = {1: "L8", 2: "LA8", 3: "RGB8", 4: "RGBA8"}.get(channels)
        if inferred is None:
            raise EncodingError(f"unsupported channel count {channels}")
        self.color_type = color_type or inferred
        self.image = image
        self.device = torch.device(device)
        self.config = EncoderConfig()
        self.icc_profile: Optional[bytes] = None
        self.exif_metadata: Optional[bytes] = None
        self.xmp_metadata: Optional[bytes] = None

    # -- constructors --------------------------------------------------------

    @classmethod
    def new_rgb(cls, image, *, device="cuda"):
        return cls(image, "RGB8", device=device)

    @classmethod
    def new_rgba(cls, image, *, device="cuda"):
        return cls(image, "RGBA8", device=device)

    @classmethod
    def new_l8(cls, image, *, device="cuda"):
        return cls(image, "L8", device=device)

    @classmethod
    def new_la8(cls, image, *, device="cuda"):
        return cls(image, "LA8", device=device)

    # -- setters -------------------------------------------------------------

    def with_quality(self, q: float):
        self.config.quality = q
        return self

    def with_method(self, m: int):
        self.config.method = m
        return self

    def with_lossless(self, lossless: bool = True):
        self.config.lossless = lossless
        return self

    def with_preset(self, preset: str):
        self.config.preset = preset
        if preset in (Preset.PHOTO, Preset.PICTURE):
            self.config.sharp_yuv = True
        elif preset in (Preset.ICON, Preset.TEXT):
            # Hard-edged synthetic content: lossless (the palette and LZ77
            # paths compress it far better than blocky lossy).
            self.config.lossless = True
        return self

    def with_sharp_yuv(self, sharp: bool = True):
        self.config.sharp_yuv = sharp
        return self

    def with_near_lossless(self, quality: int):
        self.config.near_lossless = int(quality)
        return self

    def with_target_size(self, size: int):
        self.config.target_size = int(size)
        return self

    def with_config(self, config: EncoderConfig):
        self.config = config
        return self

    def with_icc_profile(self, data: bytes):
        self.icc_profile = bytes(data)
        return self

    def with_exif_metadata(self, data: bytes):
        self.exif_metadata = bytes(data)
        return self

    def with_xmp_metadata(self, data: bytes):
        self.xmp_metadata = bytes(data)
        return self

    # -- encode --------------------------------------------------------------

    def _to_rgba(self) -> np.ndarray:
        img = self.image
        h, w = img.shape[:2]
        rgba = np.empty((h, w, 4), np.uint8)
        if self.color_type == "L8":
            rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = img[:, :, 0]
            rgba[:, :, 3] = 255
        elif self.color_type == "LA8":
            rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = img[:, :, 0]
            rgba[:, :, 3] = img[:, :, 1]
        elif self.color_type == "RGB8":
            rgba[:, :, :3] = img
            rgba[:, :, 3] = 255
        else:
            rgba[:, :] = img
        return rgba

    @property
    def has_alpha(self) -> bool:
        return self.color_type in ("RGBA8", "LA8")

    def yuv_planes(self):
        """The lossy route's host colour conversion: MB-padded (Y, U, V)."""
        if self.color_type in ("L8", "LA8"):
            return yuvops.gray_to_yuv420(self.image[:, :, 0])
        if self.config.sharp_yuv:
            return yuvops.rgb_to_yuv420_sharp(self.image)
        return native.rgb_to_yuv420(self.image)

    def lossless_payload(self) -> bytes:
        """The VP8L payload of the image (near-lossless first when set)."""
        rgba = self._to_rgba()
        if self.config.near_lossless < 100:
            rgba = near_lossless_preprocess(rgba, self.config.near_lossless)
        return encode_lossless(rgba, use_predictor=self.config.params.use_predictor_transform,
                               alpha_used=self.has_alpha)

    def mux(self, body: bytes, alpha: bool, extended: bool) -> bytes:
        """The RIFF file of the image chunks `body` (ALPH + VP8, or VP8L),
        in a VP8X container with the metadata chunks when `extended`."""
        h, w = self.image.shape[:2]
        chunks = b""
        if extended:
            chunks += _vp8x(w, h, alpha=alpha, icc=self.icc_profile is not None,
                            exif=self.exif_metadata is not None,
                            xmp=self.xmp_metadata is not None)
            if self.icc_profile is not None:
                chunks += _chunk(ck.ICCP, self.icc_profile)
        chunks += body
        if extended:
            if self.exif_metadata is not None:
                chunks += _chunk(ck.EXIF, self.exif_metadata)
            if self.xmp_metadata is not None:
                chunks += _chunk(ck.XMP, self.xmp_metadata)
        return _riff(chunks)

    def _bisect_quality(self) -> bytes:
        """Rate control on the full container output: 7 halvings of the
        quality range for the largest file that fits target_size."""
        target = self.config.target_size
        saved_q = self.config.quality
        self.config.target_size = 0
        try:
            lo, hi, best = 0.0, 100.0, None
            for _ in range(7):
                self.config.quality = (lo + hi) / 2
                cand = self.encode()
                if len(cand) <= target:
                    best, lo = cand, self.config.quality
                else:
                    hi = self.config.quality
            if best is None:
                self.config.quality = 0.0
                best = self.encode()
            return best
        finally:
            self.config.target_size = target
            self.config.quality = saved_q

    def encode(self) -> bytes:
        h, w = self.image.shape[:2]
        if not (0 < w <= 16383 and 0 < h <= 16383):
            raise InvalidDimensions(f"{w}x{h}")
        if self.config.target_size > 0 and not self.config.lossless:
            return self._bisect_quality()
        has_meta = any(x is not None
                       for x in (self.icc_profile, self.exif_metadata, self.xmp_metadata))
        if self.config.lossless:
            body = _chunk(ck.VP8L, self.lossless_payload())
            return self.mux(body, self.has_alpha, has_meta)
        body = _chunk(ck.VP8, encode_vp8(self.yuv_planes(), w, h, self.config.quality,
                                         self.config.method, self.device))
        if self.has_alpha:
            alpha_plane = np.ascontiguousarray(self.image[:, :, -1])
            body = _chunk(ck.ALPH, alpha_payload(alpha_plane, self.config.alpha_quality)) + body
        return self.mux(body, self.has_alpha, has_meta or self.has_alpha)


class WebPEncoder:
    """Writer-style API: a configuration reused over images."""

    def __init__(self, *, device="cuda"):
        self.device = torch.device(device)
        self.config = EncoderConfig()
        self.icc_profile = None
        self.exif_metadata = None
        self.xmp_metadata = None

    def set_params(self, params: EncoderParams):
        self.config.params = params

    def set_quality(self, q: float):
        self.config.quality = q

    def set_lossless(self, lossless: bool):
        self.config.lossless = lossless

    def encode(self, data: np.ndarray, color_type: Optional[str] = None) -> bytes:
        enc = Encoder(data, color_type, device=self.device)
        enc.config = self.config
        enc.icc_profile = self.icc_profile
        enc.exif_metadata = self.exif_metadata
        enc.xmp_metadata = self.xmp_metadata
        return enc.encode()


def encode_rgb(image, quality: float = 75.0, *, device="cuda") -> bytes:
    return Encoder.new_rgb(image, device=device).with_quality(quality).encode()


def encode_rgba(image, quality: float = 75.0, *, device="cuda") -> bytes:
    return Encoder.new_rgba(image, device=device).with_quality(quality).encode()


def encode_lossless_rgba(image, *, device="cuda") -> bytes:
    return Encoder.new_rgba(image, device=device).with_lossless().encode()


class AnimationEncoder:
    """Animated WebP muxer: VP8X(anim) + ANIM + per-frame ANMF chunks.

    Frames are lossless (VP8L) by default, cropped to the box that changed
    against the running canvas (even offsets), or lossy (VP8 on `device`,
    one frame at a time) at `quality` over the full canvas, with ALPH where
    the alpha is not all 255.
    """

    def __init__(self, width: int, height: int, *, loop_count: int = 0,
                 background=(255, 255, 255, 255), lossless: bool = True,
                 quality: float = 75.0, method: int = 4, device="cuda"):
        if not (0 < width <= 16384 and 0 < height <= 16384):
            raise InvalidDimensions(f"{width}x{height}")
        self.width = width
        self.height = height
        self.loop_count = loop_count
        self.background = tuple(int(c) for c in background)
        self.lossless = lossless
        self.quality = quality
        self.method = method
        self.device = torch.device(device)
        self._frames = []  # ANMF chunk bytes
        self._canvas = None

    def add_frame(self, rgba: np.ndarray, duration_ms: int):
        """Append a full-canvas RGBA frame shown for duration_ms."""
        rgba = np.asarray(rgba)
        if rgba.shape[:2] != (self.height, self.width) or rgba.shape[2] != 4:
            raise EncodingError("frame must be full-canvas RGBA")
        x = y = 0
        fw, fh = self.width, self.height
        patch = rgba
        if self.lossless and self._canvas is not None:
            diff = (rgba != self._canvas).any(-1)
            ys, xs = np.nonzero(diff)
            if len(ys) == 0:
                # identical frame: 2x2 no-op patch (even offsets required)
                ys = xs = np.zeros(1, np.int64)
            # even offsets (ANMF stores x/2, y/2)
            y = int(ys.min()) & ~1
            x = int(xs.min()) & ~1
            fh = int(ys.max()) + 1 - y
            fw = int(xs.max()) + 1 - x
            patch = np.ascontiguousarray(rgba[y: y + fh, x: x + fw])

        if self.lossless:
            sub = _chunk(ck.VP8L, encode_lossless(patch, alpha_used=True))
        else:
            planes = native.rgb_to_yuv420(patch[:, :, :3])
            sub = _chunk(ck.VP8, encode_vp8(planes, fw, fh, self.quality, self.method,
                                            self.device))
            if (patch[:, :, 3] != 255).any():
                sub = _chunk(ck.ALPH,
                             encode_alpha_lossless(np.ascontiguousarray(patch[:, :, 3]))) + sub

        head = (x // 2).to_bytes(3, "little")
        head += (y // 2).to_bytes(3, "little")
        head += (fw - 1).to_bytes(3, "little")
        head += (fh - 1).to_bytes(3, "little")
        head += int(duration_ms).to_bytes(3, "little")
        head += bytes([0b10])  # no alpha-blend (overwrite rect), no dispose
        self._frames.append(_chunk(ck.ANMF, head + sub))

        if self._canvas is None:
            self._canvas = np.zeros((self.height, self.width, 4), np.uint8)
            self._canvas[:, :] = np.array(self.background, np.uint8)
        self._canvas[y: y + fh, x: x + fw] = patch
        return self

    def finish(self) -> bytes:
        if not self._frames:
            raise EncodingError("animation needs at least one frame")
        anim = bytes(self.background) + int(self.loop_count).to_bytes(2, "little")
        chunks = _vp8x(self.width, self.height, alpha=True, anim=True)
        chunks += _chunk(ck.ANIM, anim)
        chunks += b"".join(self._frames)
        return _riff(chunks)
