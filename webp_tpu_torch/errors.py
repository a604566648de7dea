"""Error types of the port's decoder API.

The same class tree as the JAX package's `webp_tpu/errors.py`, kept as a
copy so that the port imports nothing of that package: `WebPError`, its
`DecodingError` with seven subclasses, and `EncodingError` with
`InvalidDimensions`.
"""

from __future__ import annotations


class WebPError(Exception):
    """Base class for all codec errors."""


class DecodingError(WebPError):
    """Raised when a WebP bitstream cannot be decoded."""


class InvalidSignature(DecodingError):
    """RIFF/WEBP/VP8/VP8L signature mismatch."""


class ChunkHeaderInvalid(DecodingError):
    """A RIFF chunk header is malformed or unknown where a known one is required."""


class UnexpectedEof(DecodingError):
    """Input ended before a complete chunk / bitstream element."""


class InconsistentImageSizes(DecodingError):
    """Canvas / frame dimension mismatch in the extended format."""


class ImageTooLarge(DecodingError):
    """Image exceeds the configured memory limit."""


class UnsupportedFeature(DecodingError):
    """Bitstream uses a feature the decoder does not support (e.g. non-keyframe)."""


class BitstreamError(DecodingError):
    """Generic corrupt-bitstream condition inside a codec core."""


class EncodingError(WebPError):
    """Raised when an image cannot be encoded."""


class InvalidDimensions(EncodingError):
    """Zero or too-large image dimensions (WebP caps at 16383 per side)."""
