"""webp_tpu_torch: the batched lossy VP8 decode of `webp_tpu`, ported to
PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The host side is the repo's C++ entropy pass (`native/vp8_entropy.cpp`,
built with g++ and bound in `io/native.py`) and the VP8 spec tables
(`common/vp8_tables.py`).  The package imports neither jax nor the JAX
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

__all__ = [
    "decode_core",
    "decode_vp8_batch_device",
    "decode_vp8_batch_device_mixed",
    "decode_vp8_frame_device",
    "dispatch_decode_batch",
    "parse_levels_batch",
    "to_device_batch",
    "yuv_packed_to_rgb",
]
