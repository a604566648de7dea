"""The decoder API on the CPU, against the JAX package.

The port's `WebPDecoder`, `ImageInfo` and `decode_rgb[a][_into]`
(`webp_tpu_torch/container/demux.py`, `webp_tpu_torch/__init__.py`) with
device="cpu" against the JAX package's on the same files: the metadata
(sizes, alpha, lossy, frames, loop count and duration, the background
hint, ICCP / EXIF / XMP bytes), `read_image` with both upsamplings, every
`read_frame` and its duration (with and without `set_background_color`,
after `reset_animation`), `set_memory_limit`, and the four decode
functions.  The files are seeded: VP8 and VP8L stills, VP8X stills with
ALPH in all four filters, raw and VP8L-compressed, the preprocessing bit,
ICCP / EXIF / XMP and animations with offsets, blending, disposal and
VP8L frames from the jax-free writer `random_webp.py` (odd sizes and 1x1
among them), and a few from the JAX package's `Encoder`,
`encode_lossless_rgba` and `AnimationEncoder`.  Malformed input
(truncations, bit flips, random bytes, bogus headers) must raise a
`webp_tpu_torch.errors.WebPError` in the port, and give the same pixels
where the JAX package gives pixels.  Tolerance: bit-exact.
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import webp_tpu
import webp_tpu_torch
from webp_tpu_torch.errors import WebPError

import random_webp as rw
from random_vp8 import random_keyframe
from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor, vp8l_stream

REPO = Path(__file__).resolve().parent.parent


def _few_colours(width, height, seed, n=5):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 4)).astype(np.uint8)[rng.randint(0, n, (height, width))]


@functools.lru_cache(maxsize=None)
def _jax_files():
    img = rw.rgba_frame(40, 24, 3)
    lossy = webp_tpu.Encoder.new_rgba(img).with_quality(70).with_icc_profile(b"icc") \
        .with_exif_metadata(b"exif!").with_xmp_metadata(b"<x/>").encode()
    files = {"jax_lossy_rgba_meta": lossy,
             "jax_lossy_rgb": webp_tpu.encode_rgb(np.ascontiguousarray(img[..., :3]), 60),
             "jax_lossless": webp_tpu.encode_lossless_rgba(rw.rgba_frame(31, 17, 4))}
    for name, kw in (("jax_anim_lossless", dict(loop_count=2)),
                     ("jax_anim_lossy", dict(lossless=False, quality=80))):
        enc = webp_tpu.AnimationEncoder(40, 24, **kw)
        for i in range(3):
            enc.add_frame(rw.rgba_frame(40, 24, 10 + i), 30 + i)
        files[name] = enc.finish()
    return files


def _preprocessed_still():
    vp8, _ = random_keyframe(19, 23, 31)
    iccp, exif, xmp = rw.metadata(31)
    return rw.extended(19, 23, vp8, rw.alph(rw.alpha_plane(19, 23, 31), 2, True, 31, 1,
                                            (predictor(2),)), iccp, exif, xmp)


def _lossy_animation():
    frames = [rw.anmf(0, 0, 24, 16, 40, rw.chunk(b"VP8 ", random_keyframe(24, 16, 41)[0])),
              rw.anmf(4, 2, 11, 9, 50, rw.chunk(b"VP8 ", random_keyframe(11, 9, 42)[0]),
                      blend=False, dispose=True),
              rw.anmf(8, 6, 15, 9, 60, rw.chunk(b"VP8 ", random_keyframe(15, 9, 43)[0]))]
    return rw.animation(24, 16, frames, (1, 2, 3, 4), 0, alpha=False)


WRITER_FILES = {
    "vp8_37x29": lambda: rw.still_vp8(random_keyframe(37, 29, 1)[0]),
    "vp8_1x1": lambda: rw.still_vp8(random_keyframe(1, 1, 2)[0]),
    "vp8_simple_filter": lambda: rw.still_vp8(random_keyframe(40, 24, 3, simple=True)[0]),
    "vp8l_alpha": lambda: rw.still_vp8l(vp8l_stream(
        rw.rgba_frame(23, 17, 5), 5, (SUBTRACT_GREEN, predictor(2), color(3)))),
    "vp8l_palette_1x1": lambda: rw.still_vp8l(vp8l_stream(_few_colours(1, 1, 6), 6, (PALETTE,))),
    "vp8l_palette_opaque": lambda: rw.still_vp8l(vp8l_stream(
        np.dstack([_few_colours(33, 7, 7)[..., :3], np.full((7, 33), 255, np.uint8)]), 7,
        (PALETTE, predictor(2)))),
    **{f"vp8x_alph_f{f}_{'vp8l' if c else 'raw'}": functools.partial(
        lambda f, c: rw.demo_still(21 + 2 * f, 13 + f, 11 + f, f, c,
                                   (PALETTE,) if f % 2 else (predictor(2),)).data, f, c)
       for f in rw.FILTERS for c in (False, True)},
    "vp8x_alph_1x1": lambda: rw.demo_still(1, 1, 16, 3, True).data,
    "vp8x_alph_preprocessed": _preprocessed_still,
    "vp8x_no_alpha_meta": lambda: rw.extended(17, 15, random_keyframe(17, 15, 17)[0], None,
                                              *rw.metadata(17)),
    "vp8x_lossless": lambda: rw.extended(
        26, 14, vp8l_stream(rw.rgba_frame(26, 14, 18), 18, (predictor(3),)), None,
        *rw.metadata(18), lossless=True),
    "anim_gradient_vp8l": lambda: rw.demo_animation(48, 32, 21)[0],
    "anim_vertical_raw": lambda: rw.demo_animation(30, 22, 22, 2, False)[0],
    "anim_odd_canvas": lambda: rw.demo_animation(27, 19, 23, 1, True)[0],
    "anim_lossy_no_alpha": _lossy_animation,
}
JAX_FILES = ["jax_lossy_rgba_meta", "jax_lossy_rgb", "jax_lossless", "jax_anim_lossless",
             "jax_anim_lossy"]
FILES = list(WRITER_FILES) + JAX_FILES
ANIMATIONS = [n for n in FILES if "anim" in n]


@functools.lru_cache(maxsize=None)
def webp_file(name: str) -> bytes:
    if name in WRITER_FILES:
        return WRITER_FILES[name]()
    return _jax_files()[name]


def _pair(data, **kw):
    return webp_tpu.WebPDecoder(data, **kw), webp_tpu_torch.WebPDecoder(data, device="cpu", **kw)


def _metadata(d):
    return dict(dims=d.dimensions(), width=d.width, height=d.height, has_alpha=d.has_alpha,
                is_lossy=d.is_lossy, kind=d.kind, animated=d.is_animated(),
                num_frames=d.num_frames, loop_count=d.loop_count,
                loop_duration=d.loop_duration, hint=d.background_color_hint(),
                icc=d.icc_profile(), exif=d.exif_metadata(), xmp=d.xmp_metadata(),
                size=d.output_buffer_size(), chunks=d.chunks)


@pytest.mark.parametrize("name", FILES)
def test_metadata_matches_jax(name):
    data = webp_file(name)
    j, t = _pair(data)
    assert _metadata(t) == _metadata(j)
    info = webp_tpu_torch.ImageInfo.from_webp(data)
    assert vars(info) == vars(webp_tpu.ImageInfo.from_webp(data))
    if name.startswith("vp8x_alph_f"):
        assert t.has_alpha and t.icc_profile() and t.exif_metadata() and t.xmp_metadata()


@pytest.mark.parametrize("upsampling", ["bilinear", "simple"])
@pytest.mark.parametrize("name", FILES)
def test_read_image_matches_jax(name, upsampling):
    j, t = _pair(webp_file(name), upsampling=upsampling)
    got, want = t.read_image(), j.read_image()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ANIMATIONS)
def test_frames_match_jax(name):
    """Every frame and duration; then again from `reset_animation` with a
    background colour, which disposal clears to."""
    j, t = _pair(webp_file(name))
    for background in (None, (12, 34, 56, 78)):
        if background is not None:
            for d in (j, t):
                d.reset_animation()
                d.set_background_color(background)
        for i in range(j.num_frames):
            (got, got_ms), (want, want_ms) = t.read_frame(), j.read_frame()
            assert got_ms == want_ms and got.shape == want.shape, (background, i)
            np.testing.assert_array_equal(got, want, err_msg=f"frame {i}, {background}")
        with pytest.raises(webp_tpu_torch.DecodingError):
            t.read_frame()
    assert t.num_frames == j.num_frames >= 3


@pytest.mark.parametrize("name", ["vp8_37x29", "vp8l_alpha", "vp8x_alph_f3_vp8l",
                                  "vp8x_no_alpha_meta", "anim_gradient_vp8l", "jax_lossless"])
def test_decode_functions_match_jax(name):
    data = webp_file(name)
    for fn, ch in (("decode_rgba", 4), ("decode_rgb", 3)):
        got, gw, gh = getattr(webp_tpu_torch, fn)(data, device="cpu")
        want, ww, wh = getattr(webp_tpu, fn)(data)
        assert (gw, gh) == (ww, wh) and got.shape == (wh, ww, ch)
        np.testing.assert_array_equal(got, want)
        out = np.zeros_like(want)
        assert getattr(webp_tpu_torch, fn + "_into")(data, out, device="cpu") is out
        np.testing.assert_array_equal(out, want)
        for bad in (np.zeros((wh, ww, 7 - ch), np.uint8), np.zeros((wh + 1, ww, ch), np.uint8)):
            with pytest.raises(webp_tpu_torch.DecodingError):
                getattr(webp_tpu_torch, fn + "_into")(data, bad, device="cpu")
            with pytest.raises(webp_tpu.DecodingError):
                getattr(webp_tpu, fn + "_into")(data, bad)


@pytest.mark.parametrize("name", ["vp8_37x29", "vp8x_alph_f1_vp8l", "anim_gradient_vp8l"])
def test_memory_limit_matches_jax(name):
    data = webp_file(name)
    for limit in (16, 1 << 20):
        j, t = _pair(data)
        j.set_memory_limit(limit)
        t.set_memory_limit(limit)
        outcomes = []
        for d, errors in ((j, webp_tpu.WebPError), (t, webp_tpu_torch.WebPError)):
            try:
                outcomes.append(("ok", d.icc_profile(), d.read_image().tobytes()))
            except errors as e:
                outcomes.append(("error", type(e).__name__))
        assert outcomes[0] == outcomes[1], limit
        assert outcomes[1][0] == ("error" if limit == 16 else "ok")


def test_still_rejects_background_colour_and_frames():
    j, t = _pair(webp_file("vp8_37x29"))
    with pytest.raises(webp_tpu_torch.DecodingError):
        t.set_background_color((0, 0, 0, 0))
    with pytest.raises(webp_tpu.DecodingError):
        j.set_background_color((0, 0, 0, 0))
    with pytest.raises(webp_tpu_torch.DecodingError):
        t.read_frame()
    with pytest.raises(ValueError):
        webp_tpu_torch.WebPDecoder(webp_file("vp8_37x29"), upsampling="nearest")


# ---- malformed input --------------------------------------------------------


def _outcome(module, data, **kw):
    """("ok", pixels and durations) or ("error", ...): the JAX package's
    WebPError or ValueError (its native fast paths surface ValueError); the
    port's WebPError only, anything else propagates."""
    errors = (webp_tpu.WebPError, ValueError) if module is webp_tpu else WebPError
    try:
        d = module.WebPDecoder(data, **kw)
        if d.is_animated():
            return ("ok", [(f.shape, f.tobytes(), ms)
                           for f, ms in (d.read_frame() for _ in range(min(d.num_frames, 4)))])
        img = d.read_image()
        return ("ok", img.shape, img.tobytes())
    except errors:
        return ("error",)


def _same_outcome(data):
    want = _outcome(webp_tpu, data)
    got = _outcome(webp_tpu_torch, data, device="cpu")
    assert got == want, (got[0], want[0])


FUZZED = ["vp8_37x29", "vp8l_alpha", "vp8x_alph_f3_vp8l", "vp8x_alph_f1_raw",
          "anim_vertical_raw", "jax_anim_lossy"]


@pytest.mark.parametrize("name", FUZZED)
def test_truncated_files(name):
    data = webp_file(name)
    for cut in sorted({0, 4, 11, 12, 19, 20, 30, 40, len(data) // 4, len(data) // 2,
                       len(data) - 9, len(data) - 1}):
        _same_outcome(data[:cut])


@pytest.mark.parametrize("name", FUZZED)
def test_bitflipped_files(name):
    data = webp_file(name)
    rng = np.random.RandomState(len(name))
    for _ in range(10):
        corrupted = bytearray(data)
        for _ in range(rng.randint(1, 5)):
            corrupted[rng.randint(12, len(data))] ^= 1 << rng.randint(8)
        _same_outcome(bytes(corrupted))


def test_random_bytes():
    rng = np.random.RandomState(0)
    for n in (0, 1, 11, 20, 64, 512):
        for _ in range(6):
            _same_outcome(rng.bytes(n))
            _same_outcome(b"RIFF" + n.to_bytes(4, "little") + b"WEBP" + rng.bytes(n))


def test_header_variants():
    base = b"RIFF" + (1 << 30).to_bytes(4, "little") + b"WEBP"
    still = webp_file("vp8x_alph_f2_vp8l")
    for data in (base, base + b"XXXX" + (8).to_bytes(4, "little") + b"\x00" * 8,
                 base + b"VP8 " + (0).to_bytes(4, "little"),
                 base + b"VP8L" + (1).to_bytes(4, "little") + b"\x2f",
                 base + b"VP8X" + (10).to_bytes(4, "little") + b"\x00" * 10,
                 still[:20] + bytes([0x3E]) + still[21:],     # every VP8X flag
                 still[:20] + bytes([0x00]) + still[21:],     # alpha flag off: ALPH ignored
                 rw.riff(rw.vp8x(8, 8, rw.ANIMATION), rw.anim()),
                 rw.riff(rw.vp8x(8, 8, rw.ALPHA), rw.chunk(b"VP8 ", random_keyframe(8, 8, 1)[0])),
                 rw.riff(rw.vp8x(9, 8, 0), rw.chunk(b"VP8 ", random_keyframe(8, 8, 1)[0])),
                 rw.riff(rw.vp8x(8, 8, 0), rw.chunk(b"VP8 ", random_keyframe(8, 8, 1)[0]),
                         rw.chunk(b"VP8L", b"\x2f"))):
        _same_outcome(data)
    with pytest.raises(webp_tpu_torch.InconsistentImageSizes):
        webp_tpu_torch.WebPDecoder(rw.riff(rw.vp8x(9, 8, 0), rw.chunk(
            b"VP8 ", random_keyframe(8, 8, 1)[0])), device="cpu").read_image()


def test_stream_errors_are_bitstream_errors():
    """A C++ entropy pass's rejection surfaces as BitstreamError, caused by
    the binding's StreamError with the return code."""
    from webp_tpu_torch.io.native import StreamError

    stream = vp8l_stream(rw.rgba_frame(23, 17, 5), 5, (predictor(2),))
    payload, _ = random_keyframe(37, 29, 1)
    for bad in (rw.still_vp8l(stream[: len(stream) // 2]), rw.still_vp8(payload[:40])):
        with pytest.raises(webp_tpu_torch.BitstreamError) as e:
            webp_tpu_torch.WebPDecoder(bad, device="cpu").read_image()
        assert isinstance(e.value.__cause__, StreamError) and e.value.__cause__.code < 0


# ---- the device -------------------------------------------------------------


def test_default_device_is_the_card():
    """With no card the default device raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    data = webp_file("vp8_37x29")
    assert webp_tpu_torch.WebPDecoder(data).device == torch.device("cuda")
    for call in (lambda: webp_tpu_torch.decode_rgba(data),
                 lambda: webp_tpu_torch.WebPDecoder(webp_file("vp8l_alpha")).read_image(),
                 lambda: webp_tpu_torch.WebPDecoder(webp_file("anim_vertical_raw")).read_frame()):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_api_runs_without_jax(tmp_path):
    """A VP8X + ALPH still and an animation decode through the port with
    `jax` and `webp_tpu` blocked from import."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "webp_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]
        import numpy as np
        import random_webp as rw
        import webp_tpu_torch
        still = rw.demo_still(21, 13, 3, 3, True)
        img, w, h = webp_tpu_torch.decode_rgba(still.data, device="cpu")
        assert (w, h) == (21, 13) and (img[..., 3] == still.alpha).all()
        d = webp_tpu_torch.WebPDecoder(still.data, device="cpu")
        assert (d.icc_profile(), d.exif_metadata(), d.xmp_metadata()) == (
            still.iccp, still.exif, still.xmp)
        data, frames = rw.demo_animation(24, 16, 4)
        d = webp_tpu_torch.WebPDecoder(data, device="cpu")
        d.set_background_color((1, 2, 3, 4))
        got = [d.read_frame() for _ in frames]
        assert [ms for _, ms in got] == [f.duration for f in frames]
        assert all(f.shape == (16, 24, 4) for f, _ in got)
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
