"""K12's schedule on the CPU: `inverse_predictor_rows_plain_` walks the
row-band kernel's order (CTAs by ticket, a band's lanes step by step, the
hand-overs through the shared and global edge rows every 8 steps)
and must equal the plain wavefront twin `inverse_predictor_plain_` and the
JAX package's `inverse_predictor_batch` for every seeded order.  A lag one
sub-chunk short of the kernel's rule must break it.

Inputs are seeded residuals and modes (numpy RandomState), modes 0-15
(14 and 15 add zero).  Geometries: 1x1, 1x7, 7x1, widths that are not a
multiple of 4, heights that are not a multiple of the 32-row band, band
boundaries inside a CTA and across CTAs.  Tolerance: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import vp8l_device as jops
from webp_tpu_torch import _build
from webp_tpu_torch.ops import vp8l_device as K

# (size_bits, h, w, batch, warps, resident): warps < K.WARPS puts CTA
# boundaries inside small images; resident 1 runs one CTA at a time.
CASES = {
    "1x1": (2, 1, 1, 2, K.WARPS, None),
    "1x7": (2, 1, 7, 2, K.WARPS, None),
    "7x1": (3, 7, 1, 2, K.WARPS, None),
    "45x29_in_cta": (2, 45, 29, 2, K.WARPS, None),
    "150x13_across_ctas": (9, 150, 13, 1, K.WARPS, None),
    "70x41_one_band_ctas": (3, 70, 41, 1, 1, 1),
}


def _inputs(size_bits, h, w, batch, seed):
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 256, (batch, h, w, 4)).astype(np.uint8)
    modes = rng.randint(0, 16, (batch, K.subsample(h, size_bits), K.subsample(w, size_bits)))
    return px, modes.astype(np.uint8)


@pytest.mark.parametrize("name", list(CASES))
def test_row_schedule_matches_plain_and_jax(name):
    size_bits, h, w, batch, warps, resident = CASES[name]
    px, modes = _inputs(size_bits, h, w, batch, seed=len(name))
    want = K.inverse_predictor_plain_(torch.from_numpy(px.copy()), torch.from_numpy(modes),
                                      size_bits)
    jax_out = jops.inverse_predictor_batch(jnp.asarray(px), jnp.asarray(modes), size_bits)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jax_out))
    for seed in range(2):
        got = K.inverse_predictor_rows_plain_(torch.from_numpy(px.copy()),
                                              torch.from_numpy(modes), size_bits, seed=seed,
                                              warps=warps, resident=resident)
        assert torch.equal(got, want), seed


def test_inputs_cover_every_mode_and_boundary():
    """The cases hold all 16 modes, and band and CTA boundaries."""
    seen = set()
    for name, (size_bits, h, w, batch, warps, _) in CASES.items():
        seen |= set(np.unique(_inputs(size_bits, h, w, batch, seed=len(name))[1]).tolist())
    assert seen == set(range(16))
    assert CASES["45x29_in_cta"][1] > K.BAND and K.predictor_bands(45) == 1
    assert K.predictor_bands(150) == 2 and K.predictor_bands(70, warps=1) == 3


def test_row_schedule_needs_the_lag():
    """With a lag of LAG - 1 sub-chunks a band reads columns of the row above
    that the band above has not yet published: the shared ring still holds
    its zeros there.  Shows that the schedule test can fail."""
    size_bits, h, w = 2, 100, 37
    px, modes = _inputs(size_bits, h, w, 2, seed=9)
    want = K.inverse_predictor_plain_(torch.from_numpy(px.copy()), torch.from_numpy(modes),
                                      size_bits)
    differs = []
    for seed in range(3):
        got = K.inverse_predictor_rows_plain_(torch.from_numpy(px.copy()),
                                              torch.from_numpy(modes), size_bits, seed=seed,
                                              lag=K.LAG - 1, warps=2)
        differs.append(not torch.equal(got, want))
    assert any(differs)


def test_wrapper_on_cpu_runs_the_twin_and_launches_nothing():
    px, modes = _inputs(2, 40, 9, 1, seed=3)
    before = dict(_build.LAUNCHES)
    got = K.inverse_predictor_(torch.from_numpy(px.copy()), torch.from_numpy(modes), 2)
    assert _build.LAUNCHES == before
    want = K.inverse_predictor_plain_(torch.from_numpy(px.copy()), torch.from_numpy(modes), 2)
    assert torch.equal(got, want)
