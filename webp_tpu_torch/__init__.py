"""webp_tpu_torch: the WebP decoder and encoder API, the batched lossy VP8
decode and encode and the batched lossless VP8L decode of `webp_tpu`,
ported to PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The decoder API (`container/`, `decode/alpha.py`) is the JAX package's:
`WebPDecoder` and `ImageInfo` over WebP files (VP8 and VP8L stills, VP8X
with ALPH, ICCP, EXIF and XMP, ANIM / ANMF animation with compositing),
`decode_rgb[a][_into]` and the error classes of `errors.py`.  Its pixel
decodes run on the device: VP8 through `decode_vp8_frame_device` (K1, the
fused K2 + K3, K4), VP8L and compressed alpha through
`decode_lossless_batch_device` (K9-K12); the container, the alpha filters
and the canvas stay on the host.

The encoder API (`encode/api.py`) is the JAX package's too: `Encoder`,
`EncoderConfig`, `EncoderParams`, `Preset`, `WebPEncoder`,
`AnimationEncoder`, `encode_rgb[a]` and `encode_lossless_rgba`, with
VP8X, ALPH, ICCP, EXIF, XMP and ANIM / ANMF muxing.  A lossy image is
encoded on the device at a batch of one through the batched two-pass
encode (K8 from 256 MBs, K5, K6, K7, K5 with the trellis from method 4,
the fused K18 + K19, K20), its colour conversion and frame finish on the
host; lossless images, ALPH and near-lossless run the host VP8L encoder
(`encode/vp8l.py`, numpy and the C++ of `native/vp8l.cpp`), as in the JAX
package.  `metrics` holds the host quality metrics (PSNR, SSIM, MS-SSIM,
DSSIM, an SSIMULACRA2-class score).

The host side is the repo's C++ entropy coders (`native/vp8_entropy.cpp`
and `native/vp8l.cpp`, built with g++ and bound in `io/native.py`), the VP8 spec and encoder
tables (`common/vp8_tables.py`, `encode/tables.py`) and the encode's
frame writer (`encode/vp8.py`); with `device_tokens=True` the encode's
coefficient partitions and MB headers are coded on the card instead
(`ops/token_ops.py`).  The package imports neither jax nor the JAX
package `webp_tpu`.  Every entry point takes a `device`, "cuda" by
default: "cuda" runs the kernels of `csrc/` (built with nvcc at first
use), "cpu" runs their plain torch twins; nothing falls back from one to
the other.  Scale-out (`parallel/`): `make_mesh` maps
the JAX mesh's `data` axis onto the ranks of a `torch.distributed` group
and its `band` axis onto the CTAs of a thread-block cluster, with the
banded decode and the data-parallel factories of `webp_tpu.parallel`.
"""

import numpy as np

from . import metrics
from .container.demux import LOOP_FOREVER, ImageInfo, WebPDecoder
from .decode.device import (
    decode_core,
    decode_vp8_batch_device,
    decode_vp8_batch_device_mixed,
    decode_vp8_frame_device,
    dispatch_decode_batch,
    parse_levels_batch,
    to_device_batch,
    wavefront_inputs,
    yuv_packed_to_rgb,
)
from .decode.vp8l_device import decode_lossless_batch_device
from .encode.api import (
    AnimationEncoder,
    Encoder,
    EncoderConfig,
    EncoderParams,
    Preset,
    WebPEncoder,
    encode_lossless_rgba,
    encode_rgb,
    encode_rgba,
)
from .encode.device import encode_frames_lossy_batch, encode_frames_lossy_batch_mixed
from .errors import (
    BitstreamError,
    ChunkHeaderInvalid,
    DecodingError,
    EncodingError,
    ImageTooLarge,
    InconsistentImageSizes,
    InvalidDimensions,
    InvalidSignature,
    UnexpectedEof,
    UnsupportedFeature,
    WebPError,
)
from .parallel import (
    Mesh,
    decode_wavefront_banded,
    make_decode_batch_sharded,
    make_encode_analysis_sharded,
    make_encode_tokens_sharded,
    make_encode_twopass_sharded,
    make_mesh,
)


def decode_rgba(data, device="cuda"):
    """Decode WebP bytes to ([h, w, 4] uint8, width, height)."""
    d = WebPDecoder(data, device=device)
    img = d.read_image()
    if img.shape[2] == 3:
        out = np.empty((*img.shape[:2], 4), img.dtype)
        out[:, :, :3] = img
        out[:, :, 3] = 255
        img = out
    return img, d.width, d.height


def decode_rgb(data, device="cuda"):
    """Decode WebP bytes to ([h, w, 3] uint8, width, height)."""
    d = WebPDecoder(data, device=device)
    img = d.read_image()
    if img.shape[2] == 4:
        img = np.ascontiguousarray(img[:, :, :3])
    return img, d.width, d.height


def decode_rgba_into(data, out, device="cuda"):
    """Decode into a caller-provided [h, w, 4] uint8 buffer."""
    img, _, _ = decode_rgba(data, device)
    if out.shape != img.shape:
        raise DecodingError(f"output buffer shape {out.shape} != {img.shape}")
    out[...] = img
    return out


def decode_rgb_into(data, out, device="cuda"):
    """Decode into a caller-provided [h, w, 3] uint8 buffer."""
    img, _, _ = decode_rgb(data, device)
    if out.shape != img.shape:
        raise DecodingError(f"output buffer shape {out.shape} != {img.shape}")
    out[...] = img
    return out


__all__ = [
    "AnimationEncoder",
    "BitstreamError",
    "ChunkHeaderInvalid",
    "DecodingError",
    "EncodingError",
    "Encoder",
    "EncoderConfig",
    "EncoderParams",
    "ImageInfo",
    "ImageTooLarge",
    "InconsistentImageSizes",
    "InvalidDimensions",
    "InvalidSignature",
    "LOOP_FOREVER",
    "Mesh",
    "Preset",
    "UnexpectedEof",
    "UnsupportedFeature",
    "WebPDecoder",
    "WebPEncoder",
    "WebPError",
    "decode_core",
    "decode_lossless_batch_device",
    "decode_rgb",
    "decode_rgb_into",
    "decode_rgba",
    "decode_rgba_into",
    "decode_vp8_batch_device",
    "decode_vp8_batch_device_mixed",
    "decode_vp8_frame_device",
    "decode_wavefront_banded",
    "dispatch_decode_batch",
    "encode_frames_lossy_batch",
    "encode_frames_lossy_batch_mixed",
    "encode_lossless_rgba",
    "encode_rgb",
    "encode_rgba",
    "make_decode_batch_sharded",
    "make_encode_analysis_sharded",
    "make_encode_tokens_sharded",
    "make_encode_twopass_sharded",
    "make_mesh",
    "metrics",
    "parse_levels_batch",
    "to_device_batch",
    "wavefront_inputs",
    "yuv_packed_to_rgb",
]
