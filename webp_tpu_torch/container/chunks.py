"""RIFF chunk vocabulary and header reading for the WebP container (a copy
of the JAX package's `webp_tpu/container/chunks.py`).  RIFF chunks are
fourcc + u32le payload size; odd payloads are padded by one byte."""

from __future__ import annotations

from ..io.cursor import Cursor

# Known fourccs
RIFF = b"RIFF"
WEBP = b"WEBP"
VP8 = b"VP8 "
VP8L = b"VP8L"
VP8X = b"VP8X"
ANIM = b"ANIM"
ANMF = b"ANMF"
ALPH = b"ALPH"
ICCP = b"ICCP"
EXIF = b"EXIF"
XMP = b"XMP "

KNOWN_CHUNKS = {RIFF, WEBP, VP8, VP8L, VP8X, ANIM, ANMF, ALPH, ICCP, EXIF, XMP}


def is_known(fourcc: bytes) -> bool:
    return fourcc in KNOWN_CHUNKS


def read_chunk_header(cur: Cursor) -> tuple[bytes, int, int]:
    """Read (fourcc, size, size_rounded_to_even) from the cursor."""
    fourcc = cur.read_fourcc()
    size = cur.read_u32_le()
    return fourcc, size, size + (size & 1)

