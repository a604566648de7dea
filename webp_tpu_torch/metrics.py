"""Quality metrics on the host: PSNR, SSIM, MS-SSIM, DSSIM and an
SSIMULACRA2-class score.

The port of `webp_tpu/metrics.py`, numpy float64 in the same order, so
the scores agree with the JAX package's to rounding.  DSSIM is the
Gaussian-windowed SSIM turned into a dissimilarity (1/ssim - 1), per RGB
channel and averaged.  MS-SSIM is Wang/Simoncelli/Bovik 2003 with the
published scale weights.  `ssimulacra2` follows the SSIMULACRA 2.1
pipeline (sRGB -> linear -> XYB, 6 dyadic scales, SSIM and the two
asymmetric error maps, 1- and 4-norms: 108 features) with uniform weights
unless the caller passes the 108 tuned ones; it refuses an image under 8
px on its shorter side, which has no scale to score.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 99.0 if mse == 0 else 10 * np.log10(255**2 / mse)


def _gaussian_kernel(sigma: float = 1.5, radius: int = 5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution of [H, W] with the 1-D kernel k."""
    r = (len(k) - 1) // 2
    # rows
    out = np.zeros((img.shape[0] - 2 * r, img.shape[1]), np.float64)
    for i, kv in enumerate(k):
        out += kv * img[i : i + out.shape[0], :]
    out2 = np.zeros((out.shape[0], img.shape[1] - 2 * r), np.float64)
    for i, kv in enumerate(k):
        out2 += kv * out[:, i : i + out2.shape[1]]
    return out2


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM of two [H, W] planes (Gaussian 11x11, K1=.01, K2=.03)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2_sep(a, k)
    mu_b = _filter2_sep(b, k)
    saa = _filter2_sep(a * a, k) - mu_a**2
    sbb = _filter2_sep(b * b, k) - mu_b**2
    sab = _filter2_sep(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    return float((num / den).mean())


def _ssim_terms(a: np.ndarray, b: np.ndarray, data_range: float = 255.0):
    """Mean luminance and contrast-structure SSIM terms of [H, W] planes."""
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2_sep(a, k)
    mu_b = _filter2_sep(b, k)
    saa = _filter2_sep(a * a, k) - mu_a**2
    sbb = _filter2_sep(b * b, k) - mu_b**2
    sab = _filter2_sep(a * b, k) - mu_a * mu_b
    lum = (2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)
    cs = (2 * sab + c2) / (saa + sbb + c2)
    return float(lum.mean()), float(cs.mean())


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2(img: np.ndarray) -> np.ndarray:
    h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    c = img[:h, :w]
    return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]) / 4.0


def ms_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Multi-scale SSIM (Wang et al. 2003, standard 5-scale weights).

    Accepts [H, W] or [H, W, C] uint8/float; channels are averaged.  Scales
    whose filtered size would vanish are dropped with the weights
    renormalized, so small crops still score.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(
            np.mean([ms_ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[-1])])
        )
    vals = []
    for i, wgt in enumerate(_MSSSIM_WEIGHTS):
        if min(a.shape) < 11:
            break
        lum, cs = _ssim_terms(a, b, data_range)
        vals.append((max(lum, 1e-6), max(cs, 1e-6), wgt))
        if i + 1 < len(_MSSSIM_WEIGHTS):
            a, b = _downsample2(a), _downsample2(b)
    if not vals:
        # Image too small for even one 11-tap scale: fall back to single-scale
        # SSIM rather than returning a vacuous perfect score.
        return ssim(a, b, data_range)
    wsum = sum(w for _, _, w in vals)
    score = 1.0
    for j, (lum, cs, wgt) in enumerate(vals):
        term = lum * cs if j == len(vals) - 1 else cs  # luminance on last scale
        score *= term ** (wgt / wsum)
    return float(score)


def dssim(a: np.ndarray, b: np.ndarray) -> float:
    """Per-channel mean 1/ssim - 1 (0 = identical; lower is better)."""
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    scores = [ssim(a[..., c], b[..., c]) for c in range(a.shape[-1])]
    s = float(np.mean(scores))
    return 1.0 / max(s, 1e-9) - 1.0


# SSIMULACRA2-class perceptual metric: the 108 features of the released
# tool's pipeline, scale-major, then channel, then [1-ssim, artifact,
# detail] x [norm1, norm4].  Its tuned regression weights come from
# subjective scores and are not part of the package: without `weights` the
# features are weighted uniformly, so scores compare one codec's output
# with another's under the same instrument, not with the released tool's.

_OPSIN_M = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ]
)
_OPSIN_BIAS = 0.0037930732552754493


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = x / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _to_xyb(rgb: np.ndarray) -> np.ndarray:
    """Linear RGB [h,w,3] -> positive XYB (jxl opsin absorbance + cbrt)."""
    mixed = rgb @ _OPSIN_M.T + _OPSIN_BIAS
    mixed = np.cbrt(np.maximum(mixed, 1e-9)) - np.cbrt(_OPSIN_BIAS)
    L, M, S = mixed[..., 0], mixed[..., 1], mixed[..., 2]
    x = 0.5 * (L - M)
    y = 0.5 * (L + M)
    b = S
    # SSIMULACRA2's MakePositiveXYB: shift/scale so every plane is positive
    # and comparably ranged.
    return np.stack([x + 0.5, y, b + 0.05 - y], axis=-1)


def _blur(img: np.ndarray, sigma: float = 1.5) -> np.ndarray:
    """Same-size separable gaussian with mirror borders (the released tool
    uses a recursive gaussian; a windowed FIR at the same sigma differs
    negligibly at these feature scales)."""
    r = int(3 * sigma + 0.5)
    k = _gaussian_kernel(sigma, radius=r)
    pad = np.pad(img, ((r, r), (r, r)), mode="reflect")
    return _filter2_sep(pad, k)


def ssimulacra2(orig: np.ndarray, dist: np.ndarray, weights=None) -> float:
    """SSIMULACRA2-style perceptual score (higher is better, ~100 = same).

    orig/dist: [h, w, 3] uint8 sRGB, at least 8 px on each side (ValueError
    otherwise).  `weights`: 108 floats in the feature order above, or None
    for uniform weights.
    """
    if min(orig.shape[0], orig.shape[1]) < 8:
        raise ValueError(f"ssimulacra2 needs at least 8 px on each side, got "
                         f"{orig.shape[1]}x{orig.shape[0]}")
    if weights is not None:
        weights = np.asarray(weights, np.float64).reshape(-1)
        if weights.size != 108:
            raise ValueError(f"ssimulacra2 takes 108 weights, got {weights.size}")

    a = _to_xyb(_srgb_to_linear(orig.astype(np.float64)))
    b = _to_xyb(_srgb_to_linear(dist.astype(np.float64)))
    C2 = 0.0009
    feats = []
    for scale in range(6):
        if min(a.shape[0], a.shape[1]) < 8:
            # feature vector stays fixed-length: repeat the last scale
            feats.extend(feats[-18:])
            continue
        for c in range(3):
            p, q = a[..., c], b[..., c]
            mu1, mu2 = _blur(p), _blur(q)
            s11 = _blur(p * p) - mu1 * mu1
            s22 = _blur(q * q) - mu2 * mu2
            s12 = _blur(p * q) - mu1 * mu2
            num = (2 * mu1 * mu2 + C2) * (2 * s12 + C2)
            den = (mu1 * mu1 + mu2 * mu2 + C2) * (s11 + s22 + C2)
            ssim_map = num / den
            d = 1.0 - ssim_map
            # Asymmetric error maps: detail added by the distortion
            # ("artifact", ringing/blocking) vs detail removed ("detail
            # loss", blur/smoothing) — the released tool's edgediff maps.
            e1 = _blur(np.abs(p - mu1))  # local detail of the original
            e2 = _blur(np.abs(q - mu2))  # local detail of the distortion
            artifact = np.maximum(e2 - e1, 0.0)
            detail_loss = np.maximum(e1 - e2, 0.0)
            for m in (d, artifact, detail_loss):
                m = np.abs(m)
                feats.append(float(np.mean(m)))
                feats.append(float(np.mean(m**4) ** 0.25))
        a = _downsample2(a)
        b = _downsample2(b)
    feats = np.asarray(feats[:108], np.float64)
    if weights is None:
        # Uniform weighting calibrated so "identical" -> 100 and typical
        # Q50-Q90 webp distortion lands in the released tool's ~60-90 band.
        weights = np.full(108, 1.1)
    score = 100.0 - float(feats @ weights) * 100.0
    return score
