"""WebP container demuxer: parses the RIFF structure, builds a chunk index,
exposes the image's metadata and drives per-frame decoding.

A copy of the JAX package's `webp_tpu/container/demux.py` (VP8 and VP8L
stills; the VP8X extended format with ALPH, ICCP, EXIF and XMP; animation
with the ANIM / ANMF state machine and frame compositing), its pixel paths
routed to the port's decoders on the decoder's `device`:

- VP8 (a still, an ANMF frame, and the VP8 under an ALPH):
  `decode_vp8_frame_device` (the host entropy pass, then K1 residuals, the
  fused K2 + K3 `recon_filter` and, for upsampling="bilinear", K4);
- VP8L (a still, an ANMF frame) and VP8L-compressed ALPH:
  `decode_lossless_batch_device` (the host entropy pass, then K9-K12 as the
  stream's transforms ask).

The container parse, the alpha filters and the compositing run on the
host; the canvas is host numpy, as the API returns numpy.  A stream that
the C++ entropy passes reject raises `BitstreamError`, its return code in
the message and the `io.native.StreamError` as its cause.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..decode.alpha import decode_alpha_plane
from ..decode.device import decode_vp8_frame_device
from ..decode.vp8l_device import decode_lossless_batch_device
from ..errors import (
    BitstreamError,
    ChunkHeaderInvalid,
    DecodingError,
    ImageTooLarge,
    InconsistentImageSizes,
    InvalidSignature,
    UnexpectedEof,
    UnsupportedFeature,
)
from ..io import native
from ..io.cursor import Cursor
from . import chunks as ck
from .composite import composite_frame

# `LoopCount`: 0 means forever, otherwise the number of loops.
LOOP_FOREVER = 0

_MAX_DIM = 0x3FFF  # 14-bit dimension cap shared by VP8 and VP8L headers
UPSAMPLINGS = ("bilinear", "simple")


@contextlib.contextmanager
def _stream_errors():
    """The C++ entropy passes' rejections as `BitstreamError`."""
    try:
        yield
    except native.StreamError as e:
        raise BitstreamError(str(e)) from e


@dataclasses.dataclass
class ExtendedInfo:
    """Parsed VP8X header."""

    icc_profile: bool = False
    alpha: bool = False
    exif_metadata: bool = False
    xmp_metadata: bool = False
    animation: bool = False
    canvas_width: int = 0
    canvas_height: int = 0
    background_color_hint: tuple = (0, 0, 0, 0)
    background_color: Optional[tuple] = None


@dataclasses.dataclass
class AnimationState:
    """Mutable cursor over ANMF frames."""

    next_frame: int = 0
    next_frame_start: int = 0
    dispose_next_frame: bool = True
    prev_w: int = 0
    prev_h: int = 0
    prev_x: int = 0
    prev_y: int = 0
    canvas: Optional[np.ndarray] = None  # [h, w, 4] uint8


def _read_extended_header(cur: Cursor) -> ExtendedInfo:
    flags = cur.read_u8()
    cur.skip(3)  # reserved
    canvas_w = cur.read_u24_le() + 1
    canvas_h = cur.read_u24_le() + 1
    if canvas_w * canvas_h > 0xFFFFFFFF:
        raise ImageTooLarge("canvas area exceeds u32")
    return ExtendedInfo(
        icc_profile=bool(flags & 0x20),
        alpha=bool(flags & 0x10),
        exif_metadata=bool(flags & 0x08),
        xmp_metadata=bool(flags & 0x04),
        animation=bool(flags & 0x02),
        canvas_width=canvas_w,
        canvas_height=canvas_h,
    )


class WebPDecoder:
    """Top-level WebP decoder over an in-memory buffer: construct, query
    metadata, then `read_image()` / `read_frame()`.

    `upsampling`: "bilinear" (fancy, K4 on the device) or "simple" (on the
    host).  `device`: where the pixel decodes run; "cuda" launches the
    kernels, "cpu" runs their plain torch twins.  Construction and the
    metadata calls touch no device.
    """

    def __init__(self, data, *, upsampling: str = "bilinear", device="cuda"):
        if upsampling not in UPSAMPLINGS:
            raise ValueError(f"upsampling must be one of {UPSAMPLINGS}, not {upsampling!r}")
        self.data = bytes(data)
        self.width = 0
        self.height = 0
        self.num_frames = 0
        self.loop_count = 1
        self.loop_duration = 0
        self.is_lossy = False
        self.has_alpha = False
        self.kind = "lossy"  # "lossy" | "lossless" | "extended"
        self.extended: Optional[ExtendedInfo] = None
        self.chunks: dict[bytes, tuple[int, int]] = {}  # fourcc -> (start, end)
        self.animation = AnimationState()
        self.memory_limit = None
        self.upsampling = upsampling
        self.device = torch.device(device)
        self._parse()

    # -- container parse ---------------------------------------------------

    def _parse(self) -> None:
        cur = Cursor(self.data)
        fourcc, riff_size, _ = ck.read_chunk_header(cur)
        if fourcc != ck.RIFF:
            raise InvalidSignature("not a RIFF file")
        if cur.read_fourcc() != ck.WEBP:
            raise InvalidSignature("RIFF is not WEBP")

        fourcc, size, rounded = ck.read_chunk_header(cur)
        start = cur.pos

        if fourcc == ck.VP8:
            self._parse_vp8_still(cur, start, size)
        elif fourcc == ck.VP8L:
            self._parse_vp8l_still(cur, start, size)
        elif fourcc == ck.VP8X:
            self._parse_extended(cur, start, size, rounded, riff_size)
        else:
            raise ChunkHeaderInvalid(f"unexpected first chunk {fourcc!r}")

    def _parse_vp8_still(self, cur: Cursor, start: int, size: int) -> None:
        tag = cur.read_u24_le()
        if tag & 1 != 0:
            raise UnsupportedFeature("non-keyframe VP8 frame")
        if bytes(cur.read_bytes(3)) != b"\x9d\x01\x2a":
            raise InvalidSignature("bad VP8 start code")
        self.width = cur.read_u16_le() & _MAX_DIM
        self.height = cur.read_u16_le() & _MAX_DIM
        if self.width == 0 or self.height == 0:
            raise InconsistentImageSizes("zero dimension")
        self.chunks[ck.VP8] = (start, start + size)
        self.kind = "lossy"
        self.is_lossy = True

    def _parse_vp8l_still(self, cur: Cursor, start: int, size: int) -> None:
        if cur.read_u8() != 0x2F:
            raise InvalidSignature("bad VP8L signature")
        header = cur.read_u32_le()
        if header >> 29 != 0:
            raise InvalidSignature("bad VP8L version")
        self.width = (1 + header) & _MAX_DIM
        self.height = (1 + (header >> 14)) & _MAX_DIM
        self.has_alpha = bool((header >> 28) & 1)
        self.chunks[ck.VP8L] = (start, start + size)
        self.kind = "lossless"

    def _parse_extended(self, cur: Cursor, start: int, size: int, rounded: int, riff_size: int) -> None:
        info = _read_extended_header(cur)
        self.width = info.canvas_width
        self.height = info.canvas_height

        # Scan all top-level chunks after VP8X, indexing the first occurrence
        # of each known fourcc and counting ANMF frames.
        position = start + rounded
        max_position = position + max(riff_size - 12, 0)
        cur.seek(min(position, len(self.data)))
        while position < max_position:
            try:
                fourcc, csize, crounded = ck.read_chunk_header(cur)
            except UnexpectedEof:
                break
            rng = (position + 8, position + 8 + csize)
            position += 8 + crounded
            if ck.is_known(fourcc):
                self.chunks.setdefault(fourcc, rng)
            if fourcc == ck.ANMF:
                self.num_frames += 1
                if csize < 24:
                    raise ChunkHeaderInvalid("ANMF too small")
                cur.skip(12)
                duration = cur.read_u32_le() & 0xFFFFFF
                self.loop_duration += duration
                if not self.is_lossy:
                    # Sniff first subchunk for lossy-ness; VP8 or ALPH imply lossy.
                    sub, _, _ = ck.read_chunk_header(cur)
                    if sub in (ck.VP8, ck.ALPH):
                        self.is_lossy = True
                    self._seek_rel(cur, crounded - 24)
                else:
                    self._seek_rel(cur, crounded - 16)
                continue
            try:
                self._seek_rel(cur, crounded)
            except UnexpectedEof:
                break
        if ck.VP8 in self.chunks:
            self.is_lossy = True

        # Flag/chunk consistency; missing ICCP is tolerated (common in the wild).
        if (
            (info.animation and (ck.ANIM not in self.chunks or ck.ANMF not in self.chunks))
            or (info.exif_metadata and ck.EXIF not in self.chunks)
            or (info.xmp_metadata and ck.XMP not in self.chunks)
            or (not info.animation and (ck.VP8 in self.chunks) == (ck.VP8L in self.chunks))
        ):
            raise ChunkHeaderInvalid("VP8X flags inconsistent with present chunks")

        if info.animation:
            anim = self._chunk_bytes(ck.ANIM)
            if anim is None or len(anim) < 6:
                raise ChunkHeaderInvalid("missing/short ANIM chunk")
            c = Cursor(anim)
            info.background_color_hint = tuple(bytes(c.read_bytes(4)))
            self.loop_count = c.read_u16_le()  # 0 == forever
            self.animation.next_frame_start = self.chunks[ck.ANMF][0] - 8

        # Register the first animation frame's subchunks so still-image getters
        # work on animations too.
        if ck.ANMF in self.chunks:
            rng = self.chunks[ck.ANMF]
            position = rng[0] + 16
            cur.seek(position)
            for _ in range(2):
                try:
                    sub, ssize, srounded = ck.read_chunk_header(cur)
                except UnexpectedEof:
                    break
                self.chunks.setdefault(sub, (position + 8, position + 8 + ssize))
                position += 8 + srounded
                if position + 8 > rng[1]:
                    break
                cur.seek(position)

        self.has_alpha = info.alpha
        self.kind = "extended"
        self.extended = info

    def _seek_rel(self, cur: Cursor, delta: int) -> None:
        cur.seek(cur.pos + delta)

    # -- metadata surface --------------------------------------------------

    def dimensions(self) -> tuple[int, int]:
        return (self.width, self.height)

    def is_animated(self) -> bool:
        return self.extended is not None and self.extended.animation

    def set_memory_limit(self, limit: int) -> None:
        self.memory_limit = limit

    def set_background_color(self, rgba: tuple) -> None:
        if self.extended is None:
            raise DecodingError("background color only applies to extended webp")
        self.extended.background_color = tuple(rgba)

    def background_color_hint(self):
        return None if self.extended is None else self.extended.background_color_hint

    def _chunk_bytes(self, fourcc: bytes) -> Optional[bytes]:
        rng = self.chunks.get(fourcc)
        if rng is None:
            return None
        if self.memory_limit is not None and rng[1] - rng[0] > self.memory_limit:
            raise ImageTooLarge("chunk exceeds memory limit")
        if rng[1] > len(self.data):
            raise UnexpectedEof("chunk extends past end of file")
        return self.data[rng[0] : rng[1]]

    def icc_profile(self) -> Optional[bytes]:
        return self._chunk_bytes(ck.ICCP)

    def exif_metadata(self) -> Optional[bytes]:
        return self._chunk_bytes(ck.EXIF)

    def xmp_metadata(self) -> Optional[bytes]:
        return self._chunk_bytes(ck.XMP)

    def output_buffer_size(self) -> int:
        bpp = 4 if self.has_alpha else 3
        return self.width * self.height * bpp

    # -- pixel decode ------------------------------------------------------

    def _vp8_rgb(self, payload: bytes, width: int, height: int, what: str) -> np.ndarray:
        """RGB [height, width, 3] of a VP8 payload whose frame header must
        give width x height (InconsistentImageSizes otherwise, before any
        decode)."""
        with _stream_errors():
            if native.parse_dims(payload) != (width, height):
                raise InconsistentImageSizes(what)
            return decode_vp8_frame_device(payload, self.device, self.upsampling)[1]

    def _with_alpha(self, rgb: np.ndarray, alph: bytes) -> np.ndarray:
        """RGBA of an RGB frame and its ALPH chunk's payload."""
        height, width = rgb.shape[:2]
        rgba = np.empty((height, width, 4), np.uint8)
        rgba[:, :, :3] = rgb
        with _stream_errors():
            rgba[:, :, 3] = decode_alpha_plane(alph, width, height, self.device)
        return rgba

    def _vp8l_rgba(self, payload: bytes, width: int, height: int) -> np.ndarray:
        with _stream_errors():
            return decode_lossless_batch_device([payload], width, height, device=self.device)[0]

    def read_image(self) -> np.ndarray:
        """Decode the (first) image to [h, w, 3|4] uint8."""
        if self.is_animated():
            saved = self.animation
            self.animation = AnimationState(
                next_frame_start=self.chunks[ck.ANMF][0] - 8
            )
            try:
                img, _ = self.read_frame()
            finally:
                self.animation = saved
            return img
        if ck.VP8L in self.chunks:
            rgba = self._vp8l_rgba(self._chunk_bytes(ck.VP8L), self.width, self.height)
            return rgba if self.has_alpha else np.ascontiguousarray(rgba[:, :, :3])
        if ck.VP8 not in self.chunks:
            raise ChunkHeaderInvalid("no VP8 chunk")
        rgb = self._vp8_rgb(self._chunk_bytes(ck.VP8), self.width, self.height,
                            "VP8 frame size != container size")
        if self.has_alpha:
            alph = self._chunk_bytes(ck.ALPH)
            if alph is None:
                raise ChunkHeaderInvalid("alpha flagged but no ALPH chunk")
            return self._with_alpha(rgb, alph)
        return rgb

    def read_frame(self) -> tuple[np.ndarray, int]:
        """Decode the next animation frame; returns (pixels, duration_ms)."""
        if not self.is_animated():
            raise DecodingError("not an animation")
        if self.animation.next_frame == self.num_frames:
            raise DecodingError("no more frames")
        info = self.extended
        cur = Cursor(self.data, self.animation.next_frame_start)
        fourcc, anmf_size, _ = ck.read_chunk_header(cur)
        if fourcc != ck.ANMF or anmf_size < 32:
            raise ChunkHeaderInvalid("bad ANMF chunk header")

        frame_x = cur.read_u24_le() * 2
        frame_y = cur.read_u24_le() * 2
        frame_w = cur.read_u24_le() + 1
        frame_h = cur.read_u24_le() + 1
        if frame_w > 16384 or frame_h > 16384:
            raise ImageTooLarge("animation frame too large")
        if frame_x + frame_w > self.width or frame_y + frame_h > self.height:
            raise DecodingError("frame outside canvas")
        duration = cur.read_u24_le()
        frame_info = cur.read_u8()
        use_alpha_blending = (frame_info & 0b10) == 0
        dispose = (frame_info & 0b01) != 0

        clear_color = info.background_color if self.animation.dispose_next_frame else None

        fourcc, csize, crounded = ck.read_chunk_header(cur)
        if crounded + 24 > anmf_size:
            raise ChunkHeaderInvalid("frame subchunk larger than ANMF")

        if fourcc == ck.VP8:
            frame_px = self._vp8_rgb(bytes(cur.read_bytes(csize)), frame_w, frame_h,
                                     "frame size mismatch")
            frame_has_alpha = False
        elif fourcc == ck.VP8L:
            frame_px = self._vp8l_rgba(bytes(cur.read_bytes(csize)), frame_w, frame_h)
            frame_has_alpha = True
        elif fourcc == ck.ALPH:
            if crounded + 32 > anmf_size:
                raise ChunkHeaderInvalid("ALPH subchunk larger than ANMF")
            alpha_slice = bytes(cur.read_bytes(csize))
            if crounded > csize:
                cur.skip(crounded - csize)
            next_fourcc, next_size, _ = ck.read_chunk_header(cur)
            if csize + next_size + 32 > anmf_size:
                raise ChunkHeaderInvalid("VP8 subchunk larger than ANMF")
            rgb = self._vp8_rgb(bytes(cur.read_bytes(next_size)), frame_w, frame_h,
                                "ANMF frame size != VP8 size")
            frame_px = self._with_alpha(rgb, alpha_slice)
            frame_has_alpha = True
        else:
            raise ChunkHeaderInvalid(f"unexpected frame subchunk {fourcc!r}")

        st = self.animation
        if st.canvas is None:
            st.canvas = np.zeros((self.height, self.width, 4), np.uint8)
            if info.background_color is not None:
                st.canvas[:, :] = np.array(info.background_color, np.uint8)

        composite_frame(
            st.canvas,
            clear_color,
            frame_px,
            frame_x,
            frame_y,
            frame_has_alpha,
            use_alpha_blending,
            st.prev_x,
            st.prev_y,
            st.prev_w,
            st.prev_h,
        )

        st.prev_w, st.prev_h = frame_w, frame_h
        st.prev_x, st.prev_y = frame_x, frame_y
        st.dispose_next_frame = dispose
        st.next_frame_start += anmf_size + 8
        st.next_frame += 1

        if self.has_alpha:
            return st.canvas.copy(), duration
        return np.ascontiguousarray(st.canvas[:, :, :3]), duration

    def reset_animation(self) -> None:
        if not self.is_animated():
            raise DecodingError("not an animation")
        self.animation.next_frame = 0
        self.animation.next_frame_start = self.chunks[ck.ANMF][0] - 8
        self.animation.dispose_next_frame = True


@dataclasses.dataclass
class ImageInfo:
    """Cheap metadata probe: the container parse alone, no pixel decode."""

    width: int
    height: int
    has_alpha: bool
    is_lossy: bool
    is_animated: bool
    num_frames: int

    @classmethod
    def from_webp(cls, data) -> "ImageInfo":
        d = WebPDecoder(data)
        return cls(
            width=d.width,
            height=d.height,
            has_alpha=d.has_alpha,
            is_lossy=d.is_lossy,
            is_animated=d.is_animated(),
            num_frames=d.num_frames,
        )
