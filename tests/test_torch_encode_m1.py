"""The encode slice at methods 0 and 1 (I16 only: n_try 0) on the CPU:
`webp_tpu_torch.encode_frames_lossy_batch` against the JAX package's
`analyze_frames_lossy_batch` + `finish_frames_lossy_batch`, two-pass on
and off, 1 and 8 coefficient partitions, on seeded synthetic 72x40 frames.
Kept apart from `test_torch_encode.py` (method 3) so that the JAX
package's compiles of the two methods run on different test workers.
Tolerance: byte-equal payloads.
"""

import pytest

import webp_tpu_torch
from synthetic_rgb import synthetic_frame
from test_torch_encode import QUALITY, jax_encode, jax_fetched, rgbs  # noqa: F401 (fixtures)


@pytest.mark.parametrize("nparts", [1, 8])
@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_encode_matches_jax_method1(rgbs, jax_fetched, two_pass, nparts):
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 1, two_pass,
                                                   num_partitions=nparts, device="cpu")
    assert got == jax_encode(jax_fetched, 1, two_pass, nparts)


def test_method0_decides_as_method1(rgbs, jax_fetched):
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 0, device="cpu")
    assert got == jax_encode(jax_fetched, 1, True, 1)


def test_lower_quality_gives_smaller_payloads():
    rgbs = [synthetic_frame(40, 24, s) for s in (8, 9)]
    lo = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 20, 1, device="cpu")
    hi = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 95, 1, device="cpu")
    assert all(len(a) < len(b) for a, b in zip(lo, hi))
