"""webp_tpu_torch: the batched lossy VP8 decode and encode and the batched
lossless VP8L decode of `webp_tpu`, ported to PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

The host side is the repo's C++ entropy coders (`native/vp8_entropy.cpp`
and `native/vp8l.cpp`, built with g++ and bound in `io/native.py`), the VP8 spec and encoder
tables (`common/vp8_tables.py`, `encode/tables.py`) and the encode's
frame writer (`encode/vp8.py`); with `device_tokens=True` the encode's
coefficient partitions and MB headers are coded on the card instead
(`ops/token_ops.py`).  The package imports neither jax nor the JAX
package `webp_tpu`.  Every entry point takes an explicit `device`:
"cuda" runs the kernels of `csrc/` (built with nvcc at first use), "cpu"
runs their plain torch twins.
"""

from .decode.device import (
    decode_core,
    decode_vp8_batch_device,
    decode_vp8_batch_device_mixed,
    decode_vp8_frame_device,
    dispatch_decode_batch,
    parse_levels_batch,
    to_device_batch,
    yuv_packed_to_rgb,
)
from .decode.vp8l_device import decode_lossless_batch_device
from .encode.device import encode_frames_lossy_batch, encode_frames_lossy_batch_mixed

__all__ = [
    "decode_core",
    "decode_lossless_batch_device",
    "decode_vp8_batch_device",
    "decode_vp8_batch_device_mixed",
    "decode_vp8_frame_device",
    "dispatch_decode_batch",
    "encode_frames_lossy_batch",
    "encode_frames_lossy_batch_mixed",
    "parse_levels_batch",
    "to_device_batch",
    "yuv_packed_to_rgb",
]
