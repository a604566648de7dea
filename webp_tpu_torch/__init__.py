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
runs their plain torch twins.  Scale-out (`parallel/`): `make_mesh` maps
the JAX mesh's `data` axis onto the ranks of a `torch.distributed` group
and its `band` axis onto the CTAs of a thread-block cluster, with the
banded decode and the data-parallel factories of `webp_tpu.parallel`.
"""

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
from .encode.device import encode_frames_lossy_batch, encode_frames_lossy_batch_mixed
from .parallel import (
    Mesh,
    decode_wavefront_banded,
    make_decode_batch_sharded,
    make_encode_analysis_sharded,
    make_encode_tokens_sharded,
    make_encode_twopass_sharded,
    make_mesh,
)

__all__ = [
    "Mesh",
    "decode_core",
    "decode_lossless_batch_device",
    "decode_vp8_batch_device",
    "decode_vp8_batch_device_mixed",
    "decode_vp8_frame_device",
    "decode_wavefront_banded",
    "dispatch_decode_batch",
    "encode_frames_lossy_batch",
    "encode_frames_lossy_batch_mixed",
    "make_decode_batch_sharded",
    "make_encode_analysis_sharded",
    "make_encode_tokens_sharded",
    "make_encode_twopass_sharded",
    "make_mesh",
    "parse_levels_batch",
    "to_device_batch",
    "wavefront_inputs",
    "yuv_packed_to_rgb",
]
