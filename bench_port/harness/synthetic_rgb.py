"""Seeded synthetic RGB frames: a frozen copy of `tests/synthetic_rgb.py`,
with the per-pixel noise's amplitude a parameter (3 there).

A frame is a grid of 64x64 tiles, each of one kind drawn from the seed:
flat colour, colour bands along x (which the encoder predicts vertically),
bands along y (horizontally), a linear ramp (TrueMotion), texture (stripes
plus 4x4-block noise) and sharp-edged rectangles; a faint global gradient
and per-pixel noise ride over the tiles that are not flat.  At 768x512 this
yields both B-predicted (I4) and whole-block (I16) luma MBs and at least
three of the four chroma modes, the mix the encode must cover; the noise
sets how many bits a frame codes to.  Numpy only: no jax, no torch.
"""

from __future__ import annotations

import numpy as np

TILE = 64
KINDS = ("flat", "bands_x", "bands_y", "ramp", "texture", "edges")


def _tile(kind: str, rng, n: int) -> np.ndarray:
    """[n, n, 3] float tile of one kind."""
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float64)
    c0 = rng.randint(30, 226, size=3).astype(np.float64)
    if kind == "flat":
        return np.broadcast_to(c0, (n, n, 3)).copy()
    if kind == "bands_x":
        steps = rng.randint(20, 60, size=3) * np.sign(rng.randn(3))
        return c0 + np.floor(gx / 8)[..., None] * steps / 4
    if kind == "bands_y":
        steps = rng.randint(20, 60, size=3) * np.sign(rng.randn(3))
        return c0 + np.floor(gy / 8)[..., None] * steps / 4
    if kind == "ramp":
        d = rng.uniform(-1.5, 1.5, size=(2, 3))
        return c0 + gx[..., None] * d[0] + gy[..., None] * d[1]
    if kind == "texture":
        period = rng.randint(3, 9)
        stripes = 40 * np.sin(2 * np.pi * (gx + 0.5 * gy) / period)
        cells = rng.randint(-35, 36, size=(n // 4, n // 4, 3))
        return c0 + stripes[..., None] + np.kron(cells, np.ones((4, 4, 1)))
    img = np.broadcast_to(c0, (n, n, 3)).copy()  # edges
    for _ in range(rng.randint(2, 6)):
        y0, x0 = rng.randint(0, n - 4, size=2)
        h, w = rng.randint(4, n, size=2)
        img[y0:y0 + h, x0:x0 + w] = rng.randint(0, 256, size=3)
    return img


def synthetic_frame(width: int, height: int, seed: int, noise: int = 3) -> np.ndarray:
    """[height, width, 3] uint8 RGB frame of seeded tiles, with per-pixel
    noise in [-noise, noise] over the tiles that are not flat."""
    rng = np.random.RandomState(seed)
    ty, tx = -(-height // TILE), -(-width // TILE)
    img = np.zeros((ty * TILE, tx * TILE, 3))
    kinds = []
    for r in range(ty):
        for c in range(tx):
            kind = KINDS[rng.randint(len(KINDS))]
            kinds.append(kind)
            img[r * TILE:(r + 1) * TILE, c * TILE:(c + 1) * TILE] = _tile(kind, rng, TILE)
    gy, gx = np.mgrid[0:ty * TILE, 0:tx * TILE]
    glob = (gx * rng.uniform(-0.05, 0.05) + gy * rng.uniform(-0.05, 0.05))[..., None]
    grain = rng.randint(-noise, noise + 1, size=img.shape)
    flat = np.kron(np.array(kinds).reshape(ty, tx) == "flat", np.ones((TILE, TILE), bool))
    img = np.where(flat[..., None], img, img + glob + grain)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)[:height, :width]
