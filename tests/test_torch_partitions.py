"""The encode entry points' partition count and parameters: with
`device_tokens=True` and no `num_partitions`, `encode_frames_lossy_batch`
codes 8 coefficient partitions, as the JAX package's device-token flow
always does, and is called as the JAX package's own test calls it
(`encode_frames_lossy_batch(imgs, 75, 4, device_tokens=True)`); without
device tokens the default stays 1; the parameters after `segments` are
keyword-only, so a sixth positional argument raises instead of changing
the output.  The payloads are held byte-equal to the port's explicit
8-partition call, which `test_torch_encode.py` and
`test_torch_encode_m4.py` hold to the JAX package; the partition count is
read back by the JAX package's scalar `Vp8Decoder`.
"""

import pytest

import webp_tpu_torch
from webp_tpu.decode.vp8 import Vp8Decoder

from synthetic_rgb import synthetic_frame


def _partitions(payload: bytes) -> int:
    dec = Vp8Decoder(bytes(payload))
    dec.parse(allow_native=False)  # the Python parser records the partitions
    return dec.num_partitions


@pytest.fixture(scope="module")
def imgs():
    return [synthetic_frame(64, 48, s) for s in (5, 6)]


def test_device_tokens_code_eight_partitions_by_default(imgs):
    got = webp_tpu_torch.encode_frames_lossy_batch(imgs, 75, 4, device_tokens=True, device="cpu")
    want = webp_tpu_torch.encode_frames_lossy_batch(imgs, 75, 4, device_tokens=True,
                                                    num_partitions=8, device="cpu")
    assert got == want
    assert [_partitions(p) for p in got] == [8, 8]
    mixed = webp_tpu_torch.encode_frames_lossy_batch_mixed(imgs[:1], 75, 0, device_tokens=True,
                                                           device="cpu")
    assert _partitions(mixed[0]) == 8


def test_host_finisher_codes_one_partition_by_default(imgs):
    got = webp_tpu_torch.encode_frames_lossy_batch(imgs[:1], 75, 2, device="cpu")
    assert _partitions(got[0]) == 1


@pytest.mark.parametrize("entry", ["encode_frames_lossy_batch", "encode_frames_lossy_batch_mixed"])
def test_parameters_after_segments_are_keyword_only(imgs, entry):
    with pytest.raises(TypeError):
        getattr(webp_tpu_torch, entry)(imgs, 75, 4, True, False, True, device="cpu")
    with pytest.raises(ValueError):
        getattr(webp_tpu_torch, entry)(imgs, 75, 4, device_tokens=True, num_partitions=3,
                                       device="cpu")
