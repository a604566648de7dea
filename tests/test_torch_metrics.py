"""The quality metrics on the host, against the JAX package.

`webp_tpu_torch/metrics.py` (PSNR, SSIM, MS-SSIM, DSSIM, the
SSIMULACRA2-class score with uniform and with given weights) against
`webp_tpu/metrics.py` on seeded image pairs: noise added to
`synthetic_rgb.py` frames and to random pixels, at sizes that are not
powers of two, and identical pairs.  Tolerance: 1e-12 relative.  An image
under 8 px on its shorter side has no SSIMULACRA2 scale and raises
`ValueError` in the port (the JAX package scores it 100.0).
"""

import numpy as np
import pytest

from webp_tpu import metrics as jm
from webp_tpu_torch import metrics as tm

from synthetic_rgb import synthetic_frame

SIZES = [(37, 53), (64, 64), (131, 200), (11, 90)]


def _pair(h, w, seed, noise=9):
    rng = np.random.RandomState(seed)
    a = synthetic_frame(w, h, seed) if seed % 2 else rng.randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    b = np.clip(a.astype(np.int64) + rng.randint(-noise, noise + 1, a.shape), 0, 255)
    return a, b.astype(np.uint8)


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0), (got, want)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("h,w", SIZES)
def test_metrics_match_jax(h, w, seed):
    a, b = _pair(h, w, seed)
    _close(tm.psnr(a, b), jm.psnr(a, b))
    _close(tm.ms_ssim(a, b), jm.ms_ssim(a, b))
    _close(tm.ssimulacra2(a, b), jm.ssimulacra2(a, b))
    if min(h, w) >= 11:
        _close(tm.ssim(a[..., 1], b[..., 1]), jm.ssim(a[..., 1], b[..., 1]))
        _close(tm.dssim(a, b), jm.dssim(a, b))
        _close(tm.dssim(a[..., 0], b[..., 0]), jm.dssim(a[..., 0], b[..., 0]))


@pytest.mark.parametrize("h,w", [(48, 40), (9, 300)])
def test_ssimulacra2_weights_match_jax(h, w):
    a, b = _pair(h, w, 3, noise=30)
    weights = np.linspace(0.5, 2.0, 108)
    _close(tm.ssimulacra2(a, b, weights), jm.ssimulacra2(a, b, weights))
    _close(tm.ssimulacra2(a, b, list(weights)), jm.ssimulacra2(a, b, weights))
    with pytest.raises(ValueError):
        tm.ssimulacra2(a, b, weights[:107])


def test_identical_pairs():
    a, _ = _pair(40, 56, 5)
    assert tm.psnr(a, a) == jm.psnr(a, a) == 99.0
    _close(tm.ssimulacra2(a, a), 100.0)
    _close(tm.ms_ssim(a, a), jm.ms_ssim(a, a))
    assert tm.dssim(a, a) == jm.dssim(a, a)


@pytest.mark.filterwarnings("ignore:Mean of empty slice", "ignore:invalid value encountered")
@pytest.mark.parametrize("h,w", [(10, 10), (8, 8), (8, 40)])
def test_small_images_match_jax(h, w):
    """Under 11 px MS-SSIM falls back to single-scale SSIM, whose 11-tap
    window leaves nothing (NaN) or less than nothing (ValueError), in both;
    SSIMULACRA2 scores from 8 px."""
    a, b = _pair(h, w, 7)
    _close(tm.ssimulacra2(a, b), jm.ssimulacra2(a, b))
    _close(tm.psnr(a, b), jm.psnr(a, b))
    try:
        want = jm.ms_ssim(a, b)
    except ValueError:
        with pytest.raises(ValueError):
            tm.ms_ssim(a, b)
    else:
        assert np.isnan(want) and np.isnan(tm.ms_ssim(a, b))


@pytest.mark.parametrize("h,w", [(7, 64), (64, 7), (1, 1), (5, 5)])
def test_ssimulacra2_refuses_images_under_8px(h, w):
    a, b = _pair(h, w, 9)
    assert jm.ssimulacra2(a, b) == 100.0  # the JAX package's fault
    with pytest.raises(ValueError):
        tm.ssimulacra2(a, b)
