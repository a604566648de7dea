"""The VP8L (lossless) slice on the CPU.

The kernels' plain torch twins (`webp_tpu_torch/ops/vp8l_device.py`)
against the JAX package's `webp_tpu/ops/vp8l_device.py` at the shapes of
`tests/test_vp8l_device.py`; the port's `decode_lossless_batch_device` on
`device="cpu"` against the JAX package's (run on the CPU), its scalar
`decode_lossless` (the Python decoder) and the source images, on seeded
streams of `random_vp8l.py` (every transform, palette-packed predictor
input, implicit dimensions, mixed signatures, odd sizes) and of the JAX
package's own encoder; the stream writer against the C++ and Python
decoders.  Tolerance: bit-exact (integer arithmetic).
"""

import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import webp_tpu_torch
from webp_tpu.decode.vp8l import decode_lossless
from webp_tpu.decode.vp8l_device import decode_lossless_batch_device as jax_decode
from webp_tpu.encode.vp8l import encode_lossless
from webp_tpu.ops import vp8l_device as jops
from webp_tpu_torch.io import native
from webp_tpu_torch.ops import vp8l_device as K

from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor, quantize, vp8l_stream, with_alpha
from synthetic_rgb import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
W, H = 61, 37


def _rand(rng, *shape):
    return rng.randint(0, 256, shape).astype(np.uint8)


def _frame(seed: int, width: int = W, height: int = H) -> np.ndarray:
    return with_alpha(synthetic_frame(width, height, seed), seed)


def _many_colours(seed: int, n: int, width: int = W, height: int = H) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return _rand(rng, n, 4)[rng.randint(0, n, (height, width))]


def _scalar(stream: bytes, width: int, height: int, implicit: bool = False) -> np.ndarray:
    return decode_lossless(stream, width, height, implicit, allow_native=False)


# ---- the twins against the JAX package's device functions --------------------


def test_subtract_green_twin_matches_jax():
    px = _rand(np.random.RandomState(0), 3, 13, 17, 4)
    got = K.subtract_green_(torch.from_numpy(px.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.subtract_green(jnp.asarray(px))))


@pytest.mark.parametrize("size_bits", [2, 3, 5])
def test_color_transform_twin_matches_jax(size_bits):
    rng = np.random.RandomState(1)
    px = _rand(rng, 2, 21, 37, 4)
    tf = _rand(rng, 2, K.subsample(21, size_bits), K.subsample(37, size_bits), 4)
    got = K.color_transform_(torch.from_numpy(px.copy()), torch.from_numpy(tf), size_bits)
    want = jops.color_transform(jnp.asarray(px), jnp.asarray(tf), size_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("table_size", [2, 4, 11, 17, 250])
def test_color_indexing_twin_matches_jax(table_size):
    """Random indices: from 11 entries up, some lie at or past table_size."""
    rng = np.random.RandomState(2)
    w = 29
    px = _rand(rng, 2, 9, K.subsample(w, K.pack_bits(table_size)), 4)
    table = np.zeros((2, 256, 4), np.uint8)
    table[:, :table_size] = _rand(rng, 2, table_size, 4)
    got = K.color_indexing(torch.from_numpy(px), torch.from_numpy(table), table_size, w)
    want = jops.color_indexing(jnp.asarray(px), jnp.asarray(table), table_size, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size_bits,h,w,n_modes",
                         [(2, 8, 8, 14), (2, 13, 29, 14), (3, 17, 40, 14), (4, 31, 65, 14),
                          (2, 1, 7, 14), (2, 5, 1, 14), (3, 20, 33, 16)])
def test_predictor_twin_matches_jax(size_bits, h, w, n_modes):
    """All modes across blocks; n_modes 16 adds modes 14 and 15, which add
    zero in the JAX device path (its scalar decoder raises on them)."""
    rng = np.random.RandomState(4)
    px = _rand(rng, 2, h, w, 4)
    modes = rng.randint(0, n_modes, (2, K.subsample(h, size_bits), K.subsample(w, size_bits)))
    modes = modes.astype(np.uint8)
    got = K.inverse_predictor_(torch.from_numpy(px.copy()), torch.from_numpy(modes), size_bits)
    want = jops.inverse_predictor_batch(jnp.asarray(px), jnp.asarray(modes), size_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_reject_bad_shapes():
    px = torch.zeros((1, 4, 8, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        K.inverse_predictor_(px, torch.zeros((1, 1, 1), dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        K.color_transform_(px.transpose(1, 2), torch.zeros((1, 2, 1, 4), dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        K.color_indexing(px, torch.zeros((1, 256, 4), dtype=torch.uint8), 11, 8)


# ---- the stream writer -------------------------------------------------------

_ORDERS = [tuple(p) for p in itertools.permutations((SUBTRACT_GREEN, predictor(3), color(2)))]


@pytest.mark.parametrize("transforms", _ORDERS + [()], ids=lambda t: "-".join(x[0] for x in t) or "none")
def test_writer_orders_decode_to_source(transforms):
    src = _frame(5)
    stream = vp8l_stream(src, 6, transforms)
    np.testing.assert_array_equal(native.vp8l_decode(stream, W, H), src)
    np.testing.assert_array_equal(_scalar(stream, W, H), src)


@pytest.mark.parametrize("width,height,n_colours", [(1, 1, 1), (7, 1, 2), (1, 9, 4), (33, 5, 16),
                                                    (20, 6, 256)])
def test_writer_palettes_decode_to_source(width, height, n_colours):
    """Every packing (8, 4, 2, 1 index to a byte), then a predictor and a
    colour transform on the packed image."""
    src = _many_colours(7, n_colours, width, height)
    stream = vp8l_stream(src, 8, (PALETTE, SUBTRACT_GREEN, predictor(2), color(3)))
    np.testing.assert_array_equal(native.vp8l_decode(stream, width, height), src)
    np.testing.assert_array_equal(_scalar(stream, width, height), src)


# ---- the slice against the JAX package, the scalar decoder and the source ------

_SIGNATURES = {
    "sg_pred_ct": ((SUBTRACT_GREEN, predictor(2), color(3)), _frame),
    "ct_pred": ((color(2), predictor(3)), _frame),
    "pal11_pred": ((PALETTE, predictor(2)), lambda s: quantize(_frame(s), 11, s)),
    "pal200": ((PALETTE,), lambda s: _many_colours(s, 200)),
}


def _check_slice(streams, sources, implicit=False):
    got = webp_tpu_torch.decode_lossless_batch_device(streams, W, H, implicit, device="cpu")
    assert got.shape == (len(streams), H, W, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jax_decode(streams, W, H, implicit)))
    for g, s, src in zip(got, streams, sources):
        np.testing.assert_array_equal(g, src)
        np.testing.assert_array_equal(_scalar(s, W, H, implicit), src)


@pytest.mark.parametrize("name", list(_SIGNATURES))
def test_writer_streams_match_jax_scalar_and_source(name):
    transforms, make = _SIGNATURES[name]
    sources = [make(s) for s in (11, 12)]
    streams = [vp8l_stream(src, s, transforms) for s, src in zip((21, 22), sources)]
    _check_slice(streams, sources)


def test_implicit_dims_stream():
    sources = [_frame(13)]
    _check_slice([vp8l_stream(sources[0], 23, (SUBTRACT_GREEN, predictor(2)), implicit=True)],
                 sources, implicit=True)


@pytest.mark.parametrize("kind", ["photo", "palette"])
def test_jax_encoder_streams(kind):
    src = _frame(14) if kind == "photo" else quantize(_frame(15), 9, 15)
    stream = encode_lossless(src)
    kinds = {t for t, *_ in native.vp8l_decode_entropy(stream, W, H)[1]}
    assert (0 in kinds) if kind == "photo" else kinds == {3}, kinds
    _check_slice([stream, stream], [src, src])


def test_mixed_batch_two_signatures():
    """Two signatures in one call: two device groups, outputs in input order."""
    sources = [_frame(16), quantize(_frame(17), 11, 17), _frame(18)]
    streams = [vp8l_stream(sources[0], 1, (SUBTRACT_GREEN, predictor(2), color(3))),
               vp8l_stream(sources[1], 2, (PALETTE, predictor(2))),
               vp8l_stream(sources[2], 3, (SUBTRACT_GREEN, predictor(2), color(3)))]
    _check_slice(streams, sources)
    out = webp_tpu_torch.decode_lossless_batch_device(streams, W, H, device="cpu", device_out=True)
    assert isinstance(out, np.ndarray)  # two groups: delivered on the host


def test_device_out_returns_the_tensor():
    src = _frame(19)
    out = webp_tpu_torch.decode_lossless_batch_device(
        [vp8l_stream(src, 4, (SUBTRACT_GREEN,))], W, H, device="cpu", device_out=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out[0].numpy(), src)


@pytest.mark.parametrize("fault", ["truncated", "wrong_dims", "empty"])
def test_rejected_streams_raise(fault):
    stream = vp8l_stream(_frame(20), 5, (SUBTRACT_GREEN, predictor(2)))
    width = W
    if fault == "truncated":
        stream = stream[: len(stream) // 2]
    elif fault == "wrong_dims":
        width = W + 1
    else:
        stream = b""
    with pytest.raises(ValueError, match="vp8l_decode_entropy failed: -"):
        webp_tpu_torch.decode_lossless_batch_device([stream], width, H, device="cpu")


def test_slice_and_chip_smoke_inputs_on_cpu_without_jax(tmp_path):
    """The lossless path and chip_smoke's lossless inputs, at a small size,
    with jax and the JAX package unimportable; the outputs equal the
    sources and the C++ full decode."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        import chip_smoke
        from webp_tpu_torch.decode.vp8l_device import decode_lossless_batch_device
        from webp_tpu_torch.io import native
        sources, streams = chip_smoke.lossless_inputs(40, 24)
        assert len(sources) == len(streams) == 2
        kinds = [[t for t, *_ in native.vp8l_decode_entropy(s, 40, 24)[1]] for s in streams]
        assert kinds == [[2, 0, 1], [3, 0]], kinds
        got = decode_lossless_batch_device(streams + streams[::-1], 40, 24, device="cpu")
        for g, s, src in zip(got, streams + streams[::-1], sources + sources[::-1]):
            assert (g == src).all() and (native.vp8l_decode(s, 40, 24) == src).all()
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("ok")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
