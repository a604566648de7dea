"""The flagship encode on the CPU: Q75 method 4 (trellis) with segments on,
`webp_tpu_torch.encode_frames_lossy_batch` against the JAX package's
`analyze_frames_lossy_batch` + `finish_frames_lossy_batch`, two-pass and
one-pass, 1 and 8 coefficient partitions, on seeded synthetic 256x256
frames (256 MBs: the least that turns segmentation on); also with the
coefficient partitions and MB headers coded by the device token coder
(`device_tokens=True`, 8 partitions) against the JAX package's host
writer at 8 partitions.  Kept apart from
the other encode files so that the JAX package's compiles of its two
variants run on their own test worker.  Tolerance: byte-equal payloads.
"""

import pytest

from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops import yuv as jyuv

import webp_tpu_torch
from synthetic_rgb import synthetic_frame

W = H = 256
QUALITY, METHOD = 75, 4


@pytest.fixture(scope="module")
def rgbs():
    return [synthetic_frame(W, H, s) for s in (1, 2)]


@pytest.fixture(scope="module")
def jax_fetched(rgbs):
    """two_pass -> (planes, fetched) of the JAX package's analysis."""
    cache = {}

    def get(two_pass):
        if two_pass not in cache:
            planes = [jyuv.rgb_to_yuv420(r) for r in rgbs]
            cache[two_pass] = planes, jvp8.analyze_frames_lossy_batch(
                planes, QUALITY, METHOD, W // 16, H // 16, two_pass, True)()
        return cache[two_pass]

    return get


@pytest.mark.parametrize("nparts", [1, 8])
@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_encode_matches_jax_method4_segments(rgbs, jax_fetched, two_pass, nparts):
    planes, fetched = jax_fetched(two_pass)
    for enabled, update_map, seg_map, _, _ in fetched[3]:  # the path is covered
        assert enabled and update_map and len(set(seg_map.tolist())) >= 2
    want = jvp8.finish_frames_lossy_batch(planes, fetched, QUALITY, METHOD, W, H, True, nparts)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, METHOD, two_pass, True,
                                                   num_partitions=nparts, device="cpu")
    assert got == want


def test_device_tokens_match_jax_method4_segments(rgbs, jax_fetched):
    planes, fetched = jax_fetched(True)
    want = jvp8.finish_frames_lossy_batch(planes, fetched, QUALITY, METHOD, W, H, True, 8)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, METHOD, True, True,
                                                   num_partitions=8, device_tokens=True,
                                                   device="cpu")
    assert got == want
