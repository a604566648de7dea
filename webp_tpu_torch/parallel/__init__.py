"""Scale-out of the codec: the `data` axis over the ranks of a
`torch.distributed` group, the `band` axis over the CTAs of a thread-block
cluster (`mesh.py`), and the sharded pipelines (`pipeline.py`)."""

from .mesh import Mesh, make_mesh
from .pipeline import (
    decode_wavefront_banded,
    make_decode_batch_sharded,
    make_encode_analysis_sharded,
    make_encode_tokens_sharded,
    make_encode_twopass_sharded,
)

__all__ = [
    "Mesh",
    "decode_wavefront_banded",
    "make_decode_batch_sharded",
    "make_encode_analysis_sharded",
    "make_encode_tokens_sharded",
    "make_encode_twopass_sharded",
    "make_mesh",
]
