"""Work for the harness's worker processes (spawned, CPU only): the decode
cell's keyframes, and the reference's encodes, decodes and mode reads.

Each function imports what it needs when it runs, so that a worker that
only writes keyframes never imports torch; none touches the card.
"""

from __future__ import annotations


def keyframe(args) -> bytes:
    """A seeded random VP8 keyframe: (width, height, seed, simple,
    log2_parts, run_p)."""
    from .random_vp8 import random_keyframe

    width, height, seed, simple, log2_parts, run_p = args
    return random_keyframe(width, height, seed, simple, log2_parts, run_p=run_p)[0]


def reference_encode(args) -> list:
    """The reference's payloads of frames: (frames, quality, method,
    segments, partitions), on one thread of the worker."""
    import torch

    from vp8ref.encoder import encode_frames

    frames, quality, method, segments, partitions = args
    torch.set_num_threads(1)
    return encode_frames(frames, quality, method, segments, partitions)


def reference_decode(args):
    """(RGB, MB luma modes) of a payload by the reference decoder:
    (payload, upsampling)."""
    from vp8ref.decode.vp8 import Vp8Decoder

    payload, upsampling = args
    d = Vp8Decoder(bytes(payload))
    frame = d.decode()
    return frame.to_rgb(upsampling), d.luma_mode.copy()
