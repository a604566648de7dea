"""Seeded test inputs of the port's tests: mixed frames, their VP8 payloads
from the JAX package's host encoder, and its scalar decoder as the oracle.

A mixed frame's left half is textured (a repeating gradient plus +-40
noise constant on 4x4 blocks), which the encoder codes with B-predicted (I4) MBs; its
right half is flat 8x8 colour blocks, coded as I16 MBs.  Nothing here needs
a corpus.  The scalar decoder and the encoder import no jax, so the card
tests (`test_torch_cuda.py`) use this module where only PyTorch is
installed.
"""

from __future__ import annotations

import numpy as np

from webp_tpu.decode.vp8 import Vp8Decoder
from webp_tpu.encode.vp8 import Vp8Encoder
from webp_tpu_torch.decode.device import narrow_levels


def mixed_frame(width: int, height: int, seed: int) -> np.ndarray:
    """[height, width, 3] uint8 RGB, half textured, half flat."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:height, 0:width]
    base = ((gx * 3 + gy * 2) % 160)[..., None] + rng.randint(20, 60, size=3)
    cells4 = rng.randint(-40, 41, size=((height + 3) // 4, (width + 3) // 4, 3))
    noise = np.kron(cells4, np.ones((4, 4, 1), np.int64))[:height, :width]
    cells8 = rng.randint(0, 256, size=((height + 7) // 8, (width + 7) // 8, 3))
    flat = np.kron(cells8, np.ones((8, 8, 1), np.int64))[:height, :width]
    img = base + noise
    split = max(16, (width // 2) // 16 * 16)
    img[:, split:] = flat[:, split:]
    return np.clip(img, 0, 255).astype(np.uint8)


def encode_frame(rgb: np.ndarray, quality: int = 75, method: int = 2) -> bytes:
    """VP8 payload of `rgb` from the host (python backend) encoder."""
    return Vp8Encoder(quality, method).encode(rgb)


def mixed_payloads(width: int, height: int, seeds, quality: int = 75, method: int = 2):
    return [encode_frame(mixed_frame(width, height, s), quality, method) for s in seeds]


def scalar_decode(payload: bytes):
    """(RGB [h, w, 3], packed planes [yh*yw + 2*ch*cw]) of a payload from the
    scalar `Vp8Decoder`, the oracle the batched decode is held to."""
    frame = Vp8Decoder(bytes(payload)).decode()
    packed = np.concatenate([frame.ybuf.ravel(), frame.ubuf.ravel(), frame.vbuf.ravel()])
    return frame.to_rgb(), packed


def luma_mode_counts(payload: bytes):
    """(I4 MBs, I16 MBs) of a payload, from the scalar parser."""
    d = Vp8Decoder(bytes(payload))
    d.parse(allow_native=True)
    n_i4 = int((d.luma_mode == 4).sum())
    return n_i4, int(d.luma_mode.size) - n_i4


def force_escapes(batch, seed: int = 5, count: int = 6):
    """A copy of a `parse_levels_batch` result whose levels carry
    |level| > 127 at `count` seeded slots per image, re-narrowed into the
    sparse form (an escape list ending in unused-slot sentinels)."""
    b = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
    nmb = b["u8buf"].shape[1] // 24
    rng = np.random.RandomState(seed)
    for i in range(b["u8buf"].shape[0]):
        levels = b["i16buf"][i, : nmb * 400]
        pos = rng.choice(nmb * 400, size=count, replace=False)
        levels[pos] = rng.choice([-2047, -300, -128, 128, 255, 2047], size=count)
        b["bitmap"][i], b["vals"][i], b["esc_pos"][i], b["esc_val"][i] = narrow_levels(levels, nmb)
    return b
