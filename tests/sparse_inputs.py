"""Seeded int8 level arrays for the image-flat sparse format, jax-free
(`tests/test_torch_sparse.py`, `tests/test_torch_cuda.py`, `chip_smoke.py`).

`flat_cases(B, nmb, seed)` returns named [B, nmb * 400] int8 arrays with
the cap each is packed under (`cap_for(nmb)`, 128 slots an MB):

- `density_0`, `density_0.05`, `density_0.23`, `density_0.31`: a share of
  the slots nonzero, values from a Laplace law clipped to +-127 (as
  `tests/test_sparse.py` draws them);
- `density_1`: every slot nonzero, far over the cap;
- `at_cap`: exactly `cap` nonzeros an image (no overflow);
- `over_cap`: `cap + 1` nonzeros in image 0, `cap + 37` in the others;
- `extremes`: +-127 and -128 at 20% density.
"""

from __future__ import annotations

import numpy as np

DENSITIES = (0.0, 0.05, 0.23, 0.31)
EXTREMES = np.array([127, -127, -128], np.int8)


def cap_for(nmb: int) -> int:
    return nmb * 128


def levels_like(rng, n: int, density: float) -> np.ndarray:
    """[n] int8: a `density` share of the slots drawn from Laplace(0, 9)
    clipped to +-127 (a draw may round to 0)."""
    flat = np.zeros(n, np.int8)
    nz = rng.rand(n) < density
    flat[nz] = np.clip(rng.laplace(0, 9, nz.sum()), -127, 127).astype(np.int8)
    return flat


def with_count(rng, n: int, count: int) -> np.ndarray:
    """[n] int8 with exactly `count` nonzeros at seeded slots."""
    flat = np.zeros(n, np.int8)
    slots = rng.choice(n, count, replace=False)
    v = rng.randint(1, 128, count) * rng.choice([-1, 1], count)
    flat[slots] = v.astype(np.int8)
    return flat


def flat_cases(B: int, nmb: int, seed: int) -> dict:
    """name -> (int8 [B, nmb * 400], cap)."""
    rng = np.random.RandomState(seed)
    n, cap = nmb * 400, cap_for(nmb)
    cases = {}
    for d in DENSITIES:
        cases[f"density_{d:g}"] = np.stack([levels_like(rng, n, d) for _ in range(B)])
    cases["density_1"] = np.stack(
        [(rng.randint(1, 128, n) * rng.choice([-1, 1], n)).astype(np.int8) for _ in range(B)])
    cases["at_cap"] = np.stack([with_count(rng, n, cap) for _ in range(B)])
    cases["over_cap"] = np.stack([with_count(rng, n, cap + (1 if b == 0 else 37)) for b in range(B)])
    ext = np.zeros((B, n), np.int8)
    hit = rng.rand(B, n) < 0.2
    ext[hit] = rng.choice(EXTREMES, int(hit.sum()))
    cases["extremes"] = ext
    return {k: (v, cap) for k, v in cases.items()}
