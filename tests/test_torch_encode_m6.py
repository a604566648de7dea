"""The encode at methods 5 and 6 (trellis, all ten B modes tried) and at
method 4 with segments requested below 256 MBs (so off), on the CPU:
`webp_tpu_torch.encode_frames_lossy_batch` against the JAX package's
`analyze_frames_lossy_batch` + `finish_frames_lossy_batch` on seeded
synthetic 72x40 frames (partial MBs), two-pass, 1 and 8 coefficient
partitions.  Kept apart from the other encode files so that the JAX
package's compiles of its two variants run on their own test worker.
Tolerance: byte-equal payloads.
"""

import pytest

from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops import yuv as jyuv

import webp_tpu_torch
from synthetic_rgb import synthetic_frame

W, H = 72, 40
QUALITY = 75


@pytest.fixture(scope="module")
def rgbs():
    return [synthetic_frame(W, H, s) for s in (1, 2)]


@pytest.fixture(scope="module")
def jax_fetched(rgbs):
    """(method, segments) -> (planes, fetched) of the JAX package's two-pass
    analysis; methods 5 and 6 share one (n_try 10)."""
    cache = {}

    def get(method, segments):
        key = (min(method, 5), segments)
        if key not in cache:
            planes = [jyuv.rgb_to_yuv420(r) for r in rgbs]
            cache[key] = planes, jvp8.analyze_frames_lossy_batch(
                planes, QUALITY, method, (W + 15) // 16, (H + 15) // 16, True, segments)()
        return cache[key]

    return get


@pytest.mark.parametrize("method,nparts", [(5, 1), (6, 8)])
def test_encode_matches_jax_methods_5_6(rgbs, jax_fetched, method, nparts):
    planes, fetched = jax_fetched(method, False)
    want = jvp8.finish_frames_lossy_batch(planes, fetched, QUALITY, method, W, H, False, nparts)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, method, True, False,
                                                   num_partitions=nparts, device="cpu")
    assert got == want


@pytest.mark.parametrize("nparts", [1, 8])
def test_segments_below_256_mbs_stay_off(rgbs, jax_fetched, nparts):
    planes, fetched = jax_fetched(4, True)
    assert fetched[3] is None  # the JAX package leaves segmentation off too
    want = jvp8.finish_frames_lossy_batch(planes, fetched, QUALITY, 4, W, H, True, nparts)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 4, True, True,
                                                   num_partitions=nparts, device="cpu")
    assert got == want
