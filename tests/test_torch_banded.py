"""The band-split wavefront on the CPU: `webp_tpu_torch.parallel.
decode_wavefront_banded` (the plain twins of kernels K16 and K17, bands held
as tensors of their own with the halo rows handed over by `band_shift`)
against the JAX package's `decode_wavefront_banded` on the conftest's
virtual CPU mesh and against its scalar `Vp8Decoder`, at n_band 2 and 4, on
seeded random keyframes (`random_vp8.py`) of 96x64 with the normal loop
filter and 64x128 with the simple one; against the port's unbanded twins of
K2 and K3 at n_band 1, 2 and 4; and the checks of the band count and of
the one-process mesh.  Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.decode.vp8 import Vp8Decoder
from webp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from webp_tpu.parallel.pipeline import decode_wavefront_banded as jax_decode_wavefront_banded
from webp_tpu_torch import parallel
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.ops import banded
from webp_tpu_torch.ops.loopfilter import loop_filter_plain_
from webp_tpu_torch.ops.wavefront import recon_plain_

from random_vp8 import random_keyframe

# name -> (width, height, simple filter, seed)
FRAMES = {"96x64_normal": (96, 64, False, 31), "64x128_simple": (64, 128, True, 32)}


@pytest.fixture(scope="module")
def frames():
    """name -> (payload, geometry, the port's per-MB inputs on the CPU)."""
    cache = {}

    def get(name):
        if name not in cache:
            width, height, simple, seed = FRAMES[name]
            payload, content = random_keyframe(width, height, seed, simple=simple)
            batch = tdev.parse_levels_batch([payload])
            geo = tdev.geometry(batch["headers"])
            args = tdev.wavefront_inputs(tdev.to_device_batch(batch, "cpu"))
            lm, level = content["luma_mode"], args[4]
            assert geo[2] == simple and (lm == 4).any() and (lm != 4).any()
            assert int(level.max()) > 0  # the filter acts
            cache[name] = payload, geo, args
        return cache[name]

    return get


def _planes(geo):
    mbw, mbh = geo[:2]
    return tdev.split_planes(torch.zeros((1, mbw * mbh * 384), dtype=torch.uint8), mbw, mbh)


@pytest.mark.parametrize("n_band", [2, 4])
@pytest.mark.parametrize("name", list(FRAMES))
def test_banded_matches_jax_and_scalar(frames, name, n_band):
    payload, (mbw, mbh, simple, _, _), args = frames(name)
    got = parallel.decode_wavefront_banded(*args, parallel.make_mesh(n_band=n_band, device="cpu"),
                                           mbw, mbh, simple)
    want = jax_decode_wavefront_banded(*(jnp.asarray(a.numpy()) for a in args),
                                       jax_make_mesh(n_data=1, n_band=n_band), mbw, mbh, simple)
    ref = Vp8Decoder(bytes(payload)).decode()
    for g, w, r in zip(got, want, (ref.ybuf, ref.ubuf, ref.vbuf)):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w)[0])
        np.testing.assert_array_equal(g[0].numpy(), r)


@pytest.mark.parametrize("n_band", [1, 2, 4])
@pytest.mark.parametrize("name", list(FRAMES))
def test_banded_twins_match_unbanded_twins(frames, name, n_band):
    """K16's twin equals K2's after the reconstruction, K17's K3's after
    the filter."""
    _, geo, (res, lm, bp, cm, level, interior, hev, do_sub) = frames(name)
    simple = geo[2]
    got, want = _planes(geo), _planes(geo)
    banded.recon_banded_(*got, res, lm, bp, cm, n_band)
    recon_plain_(*want, res, lm, bp, cm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    banded.filter_banded_(*got, level, interior, hev, do_sub, simple, n_band)
    loop_filter_plain_(*want, level, interior, hev, do_sub, simple)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_band_counts_that_do_not_fit_raise(frames):
    _, (mbw, mbh, simple, _, _), args = frames("96x64_normal")
    assert mbh == 4
    with pytest.raises(ValueError, match="does not divide"):
        parallel.decode_wavefront_banded(*args, parallel.make_mesh(n_band=3, device="cpu"),
                                         mbw, mbh, simple)
    with pytest.raises(ValueError, match="does not divide"):
        banded.recon_banded_(*_planes((mbw, mbh)), *args[:4], 8)
    for n_band in (0, 9, 16, 2.0):
        with pytest.raises(ValueError, match="n_band"):
            parallel.make_mesh(n_band=n_band, device="cpu")


def test_band_shift_hands_rows_to_neighbours():
    rows = [torch.full((2, 5), k + 1) for k in range(3)]
    down = banded.band_shift(rows, "down")
    up = banded.band_shift(rows, "up")
    assert [int(r[0, 0]) for r in down] == [0, 1, 2]
    assert [int(r[0, 0]) for r in up] == [2, 3, 0]
    with pytest.raises(ValueError):
        banded.band_shift(rows, "left")


def test_one_process_mesh():
    mesh = parallel.make_mesh(n_band=4, device="cpu")
    assert mesh == parallel.Mesh(None, 1, 4, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="n_data"):
        parallel.make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        parallel.make_mesh(group=object(), device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        parallel.make_mesh(device="meta")
