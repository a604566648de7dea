"""The decoder API's host pieces on the CPU, against the JAX package.

The port's ALPH decode (`webp_tpu_torch/decode/alpha.py`: the four
filters' inverses, raw and VP8L-compressed planes through
`decode_lossless_batch_device(device="cpu")`), its compositing
(`container/composite.py`: the src-over blend, `composite_frame`) and its
simple upsampling (`ops/yuv.py` `simple_yuv420_to_rgb`) against the JAX
package's `webp_tpu/decode/alpha.py`, `container/composite.py` and
`ops/yuv.py` on seeded inputs; the ALPH writer of `random_webp.py` against
both decoders and its source planes.  Tolerance: bit-exact (integer
arithmetic).
"""

import numpy as np
import pytest

from webp_tpu.container import composite as jcomp
from webp_tpu.decode import alpha as jalpha
from webp_tpu.ops import yuv as jyuv
from webp_tpu_torch.container import composite as tcomp
from webp_tpu_torch.decode import alpha as talpha
from webp_tpu_torch.errors import BitstreamError
from webp_tpu_torch.io.native import StreamError
from webp_tpu_torch.ops.yuv import simple_yuv420_to_rgb

from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor
from random_webp import FILTERS, alph, alpha_plane, filter_alpha

SHAPES = [(1, 1), (1, 9), (9, 1), (13, 17), (48, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("filtering", FILTERS)
def test_defilter_matches_jax_and_inverts_the_writer(filtering, shape):
    rng = np.random.RandomState(filtering * 100 + shape[0])
    noise = rng.randint(0, 256, shape).astype(np.uint8)
    got = talpha.defilter_alpha(noise.copy(), filtering)
    np.testing.assert_array_equal(got, jalpha.defilter_alpha(noise.copy(), filtering))
    plane = alpha_plane(shape[1], shape[0], filtering)
    np.testing.assert_array_equal(
        talpha.defilter_alpha(filter_alpha(plane, filtering), filtering), plane)


ALPH_CASES = {
    "raw": dict(compressed=False),
    "raw_preprocessed": dict(compressed=False, preprocessing=1),
    "palette": dict(compressed=True, transforms=(PALETTE,)),
    "predictor": dict(compressed=True, transforms=(predictor(2),)),
    "all_four": dict(compressed=True, transforms=(PALETTE, SUBTRACT_GREEN, predictor(3),
                                                  color(2))),
    "literals_preprocessed": dict(compressed=True, preprocessing=1),
}


@pytest.mark.parametrize("shape", [(1, 1), (29, 37)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("filtering", FILTERS)
@pytest.mark.parametrize("case", list(ALPH_CASES))
def test_decode_alpha_plane_matches_jax(case, filtering, shape):
    h, w = shape
    plane = alpha_plane(w, h, 7 + filtering)
    payload = alph(plane, filtering, seed=filtering, **ALPH_CASES[case])
    got = talpha.decode_alpha_plane(payload, w, h, device="cpu")
    np.testing.assert_array_equal(got, plane)
    np.testing.assert_array_equal(got, jalpha.decode_alpha_plane(payload, w, h))


@pytest.mark.parametrize("payload,error", [
    (b"", BitstreamError),
    (bytes([0x20]) + b"\x00" * 12, BitstreamError),   # preprocessing 2
    (bytes([0x02]) + b"\x00" * 12, BitstreamError),   # compression 2
    (bytes([0x04]) + b"\x00" * 11, BitstreamError),   # raw, one byte short
    (bytes([0x01]), StreamError),                     # compressed, no stream
    (bytes([0x01, 0xFF, 0xFF]), StreamError),         # compressed, no end of transforms
], ids=["empty", "preprocessing", "compression", "raw_short", "no_stream", "garbage"])
def test_decode_alpha_plane_rejects(payload, error):
    with pytest.raises(error):
        talpha.decode_alpha_plane(payload, 4, 3, device="cpu")
    with pytest.raises((jalpha.BitstreamError, ValueError)):
        jalpha.decode_alpha_plane(payload, 4, 3)


def test_blend_matches_jax():
    rng = np.random.RandomState(3)
    src = rng.randint(0, 256, (37, 41, 4)).astype(np.uint8)
    dst = rng.randint(0, 256, (37, 41, 4)).astype(np.uint8)
    src[::3, :, 3] = 0
    src[1::5, :, 3] = 255
    dst[:, ::4, 3] = 0
    dst[:, 1::7, 3] = 255
    np.testing.assert_array_equal(tcomp.blend_nonpremult(src, dst),
                                  jcomp.blend_nonpremult(src, dst))
    v = np.arange(0, 255 * 255 + 1, dtype=np.uint32)
    np.testing.assert_array_equal(tcomp.div_by_255(v), jcomp.div_by_255(v))


# (frame h, w, channels, x, y, has_alpha, blend, clear colour, previous rect)
COMPOSITE_CASES = {
    "full_replace_rgb": (24, 32, 3, 0, 0, False, False, None, (0, 0, 0, 0)),
    "full_replace_rgba": (24, 32, 4, 0, 0, True, False, (1, 2, 3, 4), (0, 0, 32, 24)),
    "full_blend_cleared": (24, 32, 4, 0, 0, True, True, (9, 8, 7, 6), (0, 0, 32, 24)),
    "offset_blend": (10, 12, 4, 6, 4, True, True, None, (0, 0, 0, 0)),
    "offset_blend_dispose": (10, 12, 4, 6, 4, True, True, (200, 100, 50, 25), (2, 8, 20, 10)),
    "offset_no_blend": (10, 12, 4, 20, 14, True, False, None, (0, 0, 0, 0)),
    "offset_rgb": (9, 11, 3, 2, 2, False, True, (0, 0, 0, 0), (4, 4, 6, 6)),
    "clipped": (16, 16, 4, 24, 20, True, True, None, (0, 0, 0, 0)),
    "outside": (4, 4, 4, 32, 24, True, True, (5, 5, 5, 5), (0, 0, 32, 24)),
}


@pytest.mark.parametrize("case", list(COMPOSITE_CASES))
def test_composite_frame_matches_jax(case):
    fh, fw, ch, x, y, has_alpha, blend, clear, (px, py, pw, ph) = COMPOSITE_CASES[case]
    rng = np.random.RandomState(len(case))
    canvas = rng.randint(0, 256, (24, 32, 4)).astype(np.uint8)
    frame = rng.randint(0, 256, (fh, fw, ch)).astype(np.uint8)
    if ch == 4:
        frame[::2, :, 3] = 0
    got, want = canvas.copy(), canvas.copy()
    tcomp.composite_frame(got, clear, frame, x, y, has_alpha, blend, px, py, pw, ph)
    jcomp.composite_frame(want, clear, frame, x, y, has_alpha, blend, px, py, pw, ph)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width,height", [(1, 1), (17, 9), (64, 48), (33, 16)])
def test_simple_upsampling_matches_jax(width, height):
    rng = np.random.RandomState(width)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    y = rng.randint(0, 256, (mbh * 16, mbw * 16)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (mbh * 8, mbw * 8)).astype(np.uint8) for _ in range(2))
    np.testing.assert_array_equal(simple_yuv420_to_rgb(y, u, v, width, height),
                                  jyuv.simple_yuv420_to_rgb(y, u, v, width, height))
