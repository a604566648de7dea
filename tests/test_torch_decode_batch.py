"""One batch, one frame: the port's batched lossy decode refuses a batch
whose images differ in width, height or loop filter type (the frame
header's filter type, coded in the first partition), and its mixed entry
point decodes each (width, height, filter type) group on its own.

Inputs are `tests/random_vp8.py` keyframes: 64x48 with the normal filter
(seed 1), 64x48 with the simple filter (seed 2) and a 60x44 frame (seed
3), whose MB grid is the 64x48 frame's.  The oracle is the scalar
`Vp8Decoder` per image (the JAX package's batch decode takes the filter
type and the frame size from image 0).  Tolerance: bit-exact.
"""

import numpy as np
import pytest
import torch

from webp_tpu_torch import parallel
from webp_tpu_torch.decode import device as tdev

from random_vp8 import random_keyframe
from torch_fixtures import scalar_decode


@pytest.fixture(scope="module")
def frames():
    return {
        "normal": random_keyframe(64, 48, seed=1)[0],
        "simple": random_keyframe(64, 48, seed=2, simple=True)[0],
        "small": random_keyframe(60, 44, seed=3)[0],
    }


MIXES = [("normal", "simple"), ("simple", "normal"), ("normal", "small"), ("small", "normal")]


def test_inputs_differ_where_meant(frames):
    h = {k: tdev.parse_levels_batch([p])["headers"][0] for k, p in frames.items()}
    assert (h["normal"][4], h["simple"][4], h["small"][4]) == (0, 1, 0)
    assert tuple(h["small"][:4]) == (60, 44, 4, 3) and tuple(h["normal"][:4]) == (64, 48, 4, 3)


@pytest.mark.parametrize("mix", MIXES, ids="+".join)
def test_mixed_batch_is_refused(frames, mix):
    with pytest.raises(ValueError, match="mix"):
        tdev.parse_levels_batch([frames[k] for k in mix])
    with pytest.raises(ValueError, match="mix"):
        tdev.decode_vp8_batch_device([frames[k] for k in mix], device="cpu")


@pytest.mark.parametrize("mix", MIXES + [("normal", "simple", "small", "simple", "normal")],
                         ids="+".join)
def test_mixed_entry_point_matches_scalar(frames, mix):
    ps = [frames[k] for k in mix]
    got = tdev.decode_vp8_batch_device_mixed(ps, device="cpu")
    for g, p in zip(got, ps):
        want = scalar_decode(p)[0]
        assert g.shape == want.shape
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("mix", MIXES[:2], ids="+".join)
def test_sharded_step_refuses_mixed_filter_kinds(frames, mix):
    """A batch put together by hand from two one-image parses: the step's
    geometry check sees image 1's filter type, not only image 0's."""
    parts = [tdev.parse_levels_batch([frames[k]]) for k in mix]
    batch = {k: None if v is None else np.concatenate([p[k] for p in parts])
             for k, v in parts[0].items()}
    dev_batch = tdev.to_device_batch(batch, "cpu")
    mesh = parallel.Mesh(None, 1, 1, 0, torch.device("cpu"))
    first = tdev.parse_levels_batch([frames[mix[0]]])
    step = parallel.make_decode_batch_sharded(mesh, *tdev.geometry(first["headers"]))
    with pytest.raises(ValueError, match="mix"):
        step(dev_batch)
    # Each image alone passes the same step when it is image 0's frame.
    np.testing.assert_array_equal(step(tdev.to_device_batch(first, "cpu"))[0].numpy(),
                                  scalar_decode(frames[mix[0]])[0])
