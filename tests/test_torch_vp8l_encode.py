"""The VP8L encoder on the host, against the JAX package.

The port's `webp_tpu_torch/encode/vp8l.py` (`encode_lossless`, its palette
route, `near_lossless_preprocess`, `encode_alpha_lossless`) against
`webp_tpu/encode/vp8l.py` on the same seeded RGBA: photo-like frames of
`synthetic_rgb.py` with seeded alpha, red and blue that follow green
(the colour transform), tiles of faint or strong noise (meta-Huffman
groups), images of at most 256, 2 and 1 colours, 1x1, 1xN, Nx1 and odd sizes, with the predictor on and off,
`alpha_used` False and implicit dimensions.  The JAX oracle must take its
native route (`webp_tpu.io.native.available()`), the one whose C++ helpers
the port binds.  The streams round-trip through the port's
`decode_lossless_batch_device(..., device="cpu")` and `WebPDecoder`; the
four C++ helpers the encoder binds are held to the JAX package's numpy
forms (`allow_native=False`; LZ77, which has none, to the pixels its
tokens rebuild).  Tolerance: byte-equal and bit-exact.
"""

import functools

import numpy as np
import pytest

import webp_tpu_torch
from webp_tpu.encode import vp8l as jvp8l
from webp_tpu.io import native as jax_native
from webp_tpu_torch.decode.vp8l_device import decode_lossless_batch_device
from webp_tpu_torch.encode import api
from webp_tpu_torch.encode import vp8l as tvp8l
from webp_tpu_torch.io import native

from synthetic_rgb import synthetic_frame


@pytest.fixture(autouse=True, scope="module")
def jax_native_route():
    assert jax_native.available(), "the JAX oracle would take its Python fallbacks"


def _photo(w, h, seed):
    rng = np.random.RandomState(seed)
    return np.dstack([synthetic_frame(w, h, seed), rng.randint(0, 256, (h, w)).astype(np.uint8)])


def _colours(w, h, n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 4)).astype(np.uint8)[rng.randint(0, n, (h, w))]


def _noise(w, h, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 4)).astype(np.uint8)


def _correlated(w, h, seed):
    """Red and blue that follow green: the colour transform pays."""
    rng = np.random.RandomState(seed)
    g = rng.randint(0, 120, (h, w))
    return np.dstack([np.clip(2 * g + rng.randint(0, 3, (h, w)), 0, 255), g, g // 2 + 60,
                      np.full((h, w), 255)]).astype(np.uint8)


def _two_regimes(w, h, seed):
    """16x16 tiles of faint or of strong noise: the meta-Huffman groups pay."""
    rng = np.random.RandomState(seed)
    amp = np.kron(np.where(rng.rand(h // 16, w // 16) < 0.5, 3, 200), np.ones((16, 16)))
    img = (rng.rand(h, w, 4) * amp[..., None]).astype(np.uint8)
    img[..., 3] = 255
    return img


CASES = {
    "photo_53x61": lambda: _photo(53, 61, 1),
    "photo_opaque_160x96": lambda: np.dstack([synthetic_frame(160, 96, 2),
                                              np.full((96, 160), 255, np.uint8)]),
    "colours_200_47x33": lambda: _colours(47, 33, 200, 3),
    "colours_12_40x24": lambda: _colours(40, 24, 12, 4),
    "colours_4_21x13": lambda: _colours(21, 13, 4, 5),
    "colours_2_17x9": lambda: _colours(17, 9, 2, 6),
    "colour_1_7x5": lambda: _colours(7, 5, 1, 7),
    "1x1": lambda: _noise(1, 1, 8),
    "1x37": lambda: _noise(37, 1, 9),
    "29x1": lambda: _photo(1, 29, 10),
    "odd_31x17": lambda: _photo(31, 17, 11),
    "noise_19x23": lambda: _noise(19, 23, 12),
    "correlated_48x40": lambda: _correlated(48, 40, 13),
    "two_regimes_192x192": lambda: _two_regimes(192, 192, 14),
}
OPTIONS = {
    "default": {},
    "no_predictor": dict(use_predictor=False),
    "alpha_unused": dict(alpha_used=False),
    "implicit_dims": dict(implicit_dims=True),
}


@functools.lru_cache(maxsize=None)
def _image(name):
    return np.ascontiguousarray(CASES[name]())


@functools.lru_cache(maxsize=None)
def _stream(name, option):
    return tvp8l.encode_lossless(_image(name), **OPTIONS[option])


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("name", CASES)
def test_encode_lossless_matches_jax(name, option):
    assert _stream(name, option) == jvp8l.encode_lossless(_image(name), **OPTIONS[option])


def test_cases_take_every_route(monkeypatch):
    """The cases above take the palette route, both transforms and the
    meta-Huffman groups, so the byte-equality covers them."""
    groups = []
    meta = tvp8l._meta_cluster
    monkeypatch.setattr(tvp8l, "_meta_cluster", lambda *a: groups.append(meta(*a)) or groups[-1])
    kinds = set()
    for name in CASES:
        img = _image(name)
        data = tvp8l.encode_lossless(img)
        h, w = img.shape[:2]
        kinds |= {t for t, *_ in native.vp8l_decode_entropy(data[5:], w, h, True)[1]}
    assert kinds == {0, 1, 2, 3}, kinds  # predictor, colour, subtract-green, palette
    assert any(g is not None for g in groups)


@pytest.mark.parametrize("name", ["photo_53x61", "colours_12_40x24", "1x37", "29x1"])
def test_streams_round_trip(name):
    img = _image(name)
    h, w = img.shape[:2]
    data = _stream(name, "default")
    np.testing.assert_array_equal(
        decode_lossless_batch_device([data], w, h, device="cpu")[0], img)
    riff = api._riff(api._chunk(b"VP8L", data))
    got, gw, gh = webp_tpu_torch.decode_rgba(riff, device="cpu")
    assert (gw, gh) == (w, h)
    np.testing.assert_array_equal(got, img)
    headerless = _stream(name, "implicit_dims")
    np.testing.assert_array_equal(
        decode_lossless_batch_device([headerless], w, h, implicit_dims=True, device="cpu")[0], img)


@pytest.mark.parametrize("quality", [0, 20, 40, 60, 80, 100])
@pytest.mark.parametrize("name", ["photo_53x61", "colours_12_40x24", "1x37"])
def test_near_lossless_matches_jax(name, quality):
    img = _image(name)
    got = tvp8l.near_lossless_preprocess(img, quality)
    np.testing.assert_array_equal(got, jvp8l.near_lossless_preprocess(img, quality))
    assert tvp8l.encode_lossless(got) == jvp8l.encode_lossless(got)


@pytest.mark.parametrize("name", ["photo_53x61", "colours_2_17x9", "1x1", "29x1"])
def test_alpha_payload_matches_jax(name):
    plane = np.ascontiguousarray(_image(name)[..., 3])
    data = tvp8l.encode_alpha_lossless(plane)
    assert data == jvp8l.encode_alpha_lossless(plane)
    assert data[0] == 1
    h, w = plane.shape
    np.testing.assert_array_equal(
        decode_lossless_batch_device([data[1:]], w, h, implicit_dims=True, device="cpu")[0][..., 1],
        plane)


def test_too_large_is_refused():
    with pytest.raises(webp_tpu_torch.InvalidDimensions):
        tvp8l.encode_lossless(np.zeros((1, 16385, 4), np.uint8))


# ---- the C++ helpers against their numpy forms -----------------------------


def _kraft_ok(lengths, limit):
    used = lengths[lengths > 0]
    assert used.max(initial=0) <= limit
    assert np.sum(2.0 ** -used.astype(np.float64)) <= 1.0


@pytest.mark.parametrize("seed", range(6))
def test_huffman_lengths_match_numpy(seed):
    rng = np.random.RandomState(seed)
    for _ in range(10):
        limit = int(rng.choice([4, 7, 15]))
        n = int(rng.randint(2, 300))
        freqs = rng.randint(0, 1000, size=n).astype(np.int64)
        freqs[rng.rand(n) < rng.rand()] = 0
        used = np.flatnonzero(freqs)
        freqs[used[1 << limit:]] = 0
        want = jvp8l.build_code_lengths(freqs, limit, allow_native=False)
        np.testing.assert_array_equal(tvp8l.build_code_lengths(freqs, limit), want)
        np.testing.assert_array_equal(jvp8l.build_code_lengths(freqs, limit), want)
        if (freqs > 0).sum() > 1:
            _kraft_ok(want, limit)


def test_huffman_lengths_limited_and_by_alphabet():
    """Exponential histograms force the length limit; the [K, A] form with
    side-by-side alphabets matches the numpy form alphabet by alphabet."""
    for n in (16, 24, 40):
        freqs = (2 ** np.arange(n, dtype=np.float64)).astype(np.int64)
        for limit in (7, 15):
            want = jvp8l.build_code_lengths(freqs, limit, allow_native=False)
            np.testing.assert_array_equal(tvp8l.build_code_lengths(freqs, limit), want)
            _kraft_ok(want, limit)
    rng = np.random.RandomState(7)
    offs = np.array([0, 280, 536, 792, 1048, 1088], np.int32)
    hist = rng.randint(0, 200, size=(3, 1088)).astype(np.int64)
    hist[rng.rand(*hist.shape) < 0.6] = 0
    got = native.vp8l_huffman_lengths(hist, offs, 15)
    for k in range(3):
        for s, e in zip(offs[:-1], offs[1:]):
            np.testing.assert_array_equal(
                got[k, s:e], jvp8l.build_code_lengths(hist[k, s:e], 15, allow_native=False))
    with pytest.raises(ValueError):
        tvp8l.build_code_lengths(np.ones(40, np.int64), 4)
    with pytest.raises(ValueError):
        native.vp8l_huffman_lengths(np.ones((1, 40), np.int64), np.array([0, 40]), 4)


@pytest.mark.parametrize("bits", [1, 4, 8, 11])
def test_cache_hits_match_numpy(bits):
    rng = np.random.RandomState(bits)
    vals = rng.randint(0, 50, size=2000).astype(np.int64)
    for packed in ((0xFF000000 | vals * 0x010101).astype(np.int64),
                   np.full(3, 0xFF102030, np.int64), np.full(1, 7, np.int64)):
        got = tvp8l._cache_hits(packed, bits)
        want = jvp8l._cache_hits(packed, bits, allow_native=False)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        native.vp8l_cache_hits(vals, 12)


@pytest.mark.parametrize("w,h", [(64, 48), (33, 17), (8, 8), (1, 16), (16, 1), (1, 1),
                                 (2, 2), (129, 3)])
def test_pick_predictors_match_numpy(w, h):
    rng = np.random.RandomState(w * 1000 + h)
    u = (rng.randint(0, 256, size=(h, w, 4)) + np.arange(w)[None, :, None] * 2) % 256
    for size_bits in (2, 4):
        sb, modes, res = tvp8l._pick_predictors(u, w, h, size_bits)
        sb_p, modes_p, res_p = jvp8l._pick_predictors(u, w, h, size_bits, allow_native=False)
        assert sb == sb_p == size_bits
        np.testing.assert_array_equal(modes, modes_p)
        np.testing.assert_array_equal(res & 0xFF, res_p & 0xFF)


def _replay(lens, dists, n):
    """The pixel positions the tokens rebuild: each copy's source index."""
    src = np.empty(n, np.int64)
    pos = 0
    for ln, d in zip(lens.tolist(), dists.tolist()):
        if ln == 1:
            assert d == 0
            src[pos] = pos
        else:
            assert 1 <= d <= pos and ln <= 4096
            for k in range(ln):
                src[pos + k] = src[pos + k - d]
        pos += ln
    assert pos == n
    return src


@pytest.mark.parametrize("name", ["photo_53x61", "colours_2_17x9", "colour_1_7x5", "1x1",
                                  "noise_19x23"])
def test_lz77_tokens_rebuild_the_pixels(name):
    img = _image(name)
    packed = np.ascontiguousarray(img.reshape(-1, 4)).view(np.uint32)[:, 0]
    lens, dists = native.vp8l_lz77(packed)
    src = _replay(lens, dists, len(packed))
    np.testing.assert_array_equal(packed[src], packed)
    jl, jd = jax_native.vp8l_lz77(packed)
    np.testing.assert_array_equal(lens, jl)
    np.testing.assert_array_equal(dists, jd)
