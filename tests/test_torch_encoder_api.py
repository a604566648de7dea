"""The encoder API on the CPU, against the JAX package.

The port's `Encoder`, `WebPEncoder`, `encode_rgb[a]`,
`encode_lossless_rgba` and `AnimationEncoder` (`webp_tpu_torch/encode/api.py`)
with device="cpu" against the JAX package's on the same seeded images
(`synthetic_rgb.py` frames, seeded alpha and noise): RGB8 at methods 0, 2,
4 and 6, RGBA8, L8 and LA8, the DEFAULT, PHOTO / PICTURE (sharp YUV) and
ICON / TEXT (lossless) presets, `with_lossless`, `with_near_lossless`,
`alpha_quality` < 100, `target_size`, the predictor off, ICCP / EXIF / XMP,
one 256x256 frame (256 MBs: segments on), lossy and lossless animations
with an unchanged frame, and the inputs both packages refuse.  The port's
lossy route is the batched device encode at a batch of one (its plain
twins here); the JAX package's is its host `Vp8Encoder`.  The JAX oracle's
VP8L encoder must take its native route.  A few files decode back through
the port's `WebPDecoder` on the CPU.  Tolerance: byte-equal files,
bit-exact pixels.
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
from webp_tpu.io import native as jax_native
from webp_tpu_torch import metrics
from webp_tpu_torch.decode import device as tdev

import random_webp as rw
from synthetic_rgb import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def jax_native_route():
    assert jax_native.available(), "the JAX oracle would take its Python fallbacks"


@functools.lru_cache(maxsize=None)
def _rgb(w, h, seed):
    return synthetic_frame(w, h, seed)


@functools.lru_cache(maxsize=None)
def _rgba(w, h, seed):
    return rw.rgba_frame(w, h, seed)


def _gray(w, h, seed):
    return np.ascontiguousarray(_rgb(w, h, seed)[..., 1])


def _la(w, h, seed):
    return np.ascontiguousarray(_rgba(w, h, seed)[..., 2:])


def _meta(enc):
    return enc.with_icc_profile(b"icc-profile").with_exif_metadata(b"Exif\x00\x00odd") \
        .with_xmp_metadata(b"<x:xmpmeta/>")


def _webp_encoder(M, kw, lossless):
    e = M.WebPEncoder(**kw)
    e.set_quality(60)
    e.set_lossless(lossless)
    e.set_params(M.EncoderParams(use_predictor_transform=False))
    e.icc_profile = b"icc"
    return e.encode(_rgba(24, 16, 30))


def _animation(M, kw, lossless):
    rng = np.random.RandomState(40)
    w, h = (40, 24) if lossless else (24, 16)
    enc = M.AnimationEncoder(w, h, loop_count=3, background=(10, 20, 30, 255),
                             lossless=lossless, quality=70, **kw)
    first = _rgba(w, h, 41).copy()
    if not lossless:
        first[..., 3] = 255  # opaque: VP8 alone; the next frame has ALPH
    second = first.copy()
    second[5:11, 7:20] = rng.randint(0, 256, (6, 13, 4))
    for i, frame in enumerate((first, second, second, _rgba(w, h, 42))):
        enc.add_frame(frame, 40 + i)
    return enc.finish()


# name -> f(package, keyword arguments): the file's bytes.
FILES = {
    **{f"rgb_m{m}": (lambda m: lambda M, kw: M.Encoder.new_rgb(_rgb(48, 40, 1), **kw)
                     .with_method(m).encode())(m) for m in (0, 2, 4, 6)},
    "rgba_m4": lambda M, kw: M.Encoder.new_rgba(_rgba(32, 24, 2), **kw).encode(),
    "l8_m4": lambda M, kw: M.Encoder.new_l8(_gray(32, 24, 3), **kw).encode(),
    "la8_m2": lambda M, kw: M.Encoder.new_la8(_la(33, 17, 4), **kw).with_method(2).encode(),
    "gray_inferred_m0": lambda M, kw: M.Encoder(_gray(21, 19, 5), **kw).with_method(0).encode(),
    "photo_meta_m4": lambda M, kw: _meta(M.Encoder.new_rgb(_rgb(48, 40, 6), **kw)
                                         .with_preset(M.Preset.PHOTO)).encode(),
    "picture_rgba_m0": lambda M, kw: M.Encoder.new_rgba(_rgba(35, 29, 7), **kw)
        .with_preset(M.Preset.PICTURE).with_quality(90).with_method(0).encode(),
    "icon_rgba": lambda M, kw: M.Encoder.new_rgba(_rgba(40, 24, 8), **kw)
        .with_preset(M.Preset.ICON).encode(),
    "text_l8_meta": lambda M, kw: _meta(M.Encoder.new_l8(_gray(30, 20, 9), **kw)
                                        .with_preset(M.Preset.TEXT)).encode(),
    "lossless_rgb": lambda M, kw: M.Encoder.new_rgb(_rgb(48, 40, 10), **kw)
        .with_lossless().encode(),
    "lossless_la8": lambda M, kw: M.Encoder.new_la8(_la(31, 23, 11), **kw)
        .with_lossless().encode(),
    "near_lossless_40": lambda M, kw: M.Encoder.new_rgba(_rgba(40, 24, 12), **kw)
        .with_lossless().with_near_lossless(40).encode(),
    "lossless_no_predictor": lambda M, kw: M.Encoder.new_rgba(_rgba(40, 24, 13), **kw)
        .with_config(M.EncoderConfig(lossless=True, params=M.EncoderParams(False))).encode(),
    "config_lossy_q30_m0": lambda M, kw: M.Encoder.new_rgba(_rgba(40, 24, 14), **kw)
        .with_config(M.EncoderConfig.new_lossy(30.0)).with_method(0).encode(),
    "alpha_quality_50_m0": lambda M, kw: M.Encoder.new_rgba(
        _rgba(40, 24, 15), **kw).with_config(M.EncoderConfig(alpha_quality=50, method=0)).encode(),
    "target_size_m2": lambda M, kw: M.Encoder.new_rgb(_rgb(32, 32, 16), **kw)
        .with_method(2).with_target_size(420).encode(),
    "target_unreachable_m0": lambda M, kw: M.Encoder.new_rgb(_rgb(16, 16, 17), **kw)
        .with_method(0).with_target_size(10).encode(),
    "segments_256_m4": lambda M, kw: M.Encoder.new_rgb(_rgb(256, 256, 18), **kw).encode(),
    "webp_encoder_lossy": lambda M, kw: _webp_encoder(M, kw, False),
    "webp_encoder_lossless": lambda M, kw: _webp_encoder(M, kw, True),
    "encode_rgb": lambda M, kw: M.encode_rgb(_rgb(16, 16, 19), 50, **kw),
    "encode_rgba": lambda M, kw: M.encode_rgba(_rgba(17, 15, 20), 80, **kw),
    "encode_lossless_rgba": lambda M, kw: M.encode_lossless_rgba(_rgba(23, 9, 21), **kw),
    "anim_lossless": lambda M, kw: _animation(M, kw, True),
    "anim_lossy": lambda M, kw: _animation(M, kw, False),
}


@functools.lru_cache(maxsize=None)
def port_file(name):
    return FILES[name](webp_tpu_torch, CPU)


@pytest.mark.parametrize("name", FILES)
def test_files_match_jax(name):
    assert port_file(name) == FILES[name](webp_tpu, {})


def test_cases_take_their_routes():
    """The cases cover what they are named for: segments at 256x256, ALPH,
    VP8X metadata, lossless chunks, the unchanged animation frame's 2x2 patch."""
    def dec(name):
        return webp_tpu_torch.WebPDecoder(port_file(name), device="cpu")

    assert b"ALPH" in port_file("rgba_m4") and b"ALPH" in port_file("alpha_quality_50_m0")
    assert b"VP8L" in port_file("icon_rgba") and b"VP8 " not in port_file("icon_rgba")
    for name in ("photo_meta_m4", "text_l8_meta"):
        d = dec(name)
        assert (d.icc_profile(), d.exif_metadata(), d.xmp_metadata()) == (
            b"icc-profile", b"Exif\x00\x00odd", b"<x:xmpmeta/>")
    assert len(port_file("target_size_m2")) <= 420
    data = port_file("segments_256_m4")
    batch = tdev.parse_levels_batch([data[data.index(b"VP8 ") + 8:]])
    off, _ = tdev.u8_fields(256)[0]["segment_ids"]
    assert len(set(batch["u8buf"][0, off: off + 256].tolist())) >= 2
    d = dec("anim_lossless")
    assert d.num_frames == 4
    assert b"ALPH" in port_file("anim_lossy")


@pytest.mark.parametrize("name", ["icon_rgba", "lossless_rgb", "lossless_la8",
                                  "encode_lossless_rgba", "lossless_no_predictor"])
def test_lossless_files_decode_to_their_sources(name):
    src = {"icon_rgba": _rgba(40, 24, 8), "encode_lossless_rgba": _rgba(23, 9, 21),
           "lossless_no_predictor": _rgba(40, 24, 13)}.get(name)
    got, w, h = webp_tpu_torch.decode_rgba(port_file(name), device="cpu")
    if name == "lossless_rgb":
        np.testing.assert_array_equal(got[..., :3], _rgb(48, 40, 10))
    elif name == "lossless_la8":
        la = _la(31, 23, 11)
        np.testing.assert_array_equal(got[..., 1], la[..., 0])
        np.testing.assert_array_equal(got[..., 3], la[..., 1])
    else:
        np.testing.assert_array_equal(got, src)


@pytest.mark.parametrize("name", ["rgb_m4", "rgba_m4", "photo_meta_m4", "anim_lossy",
                                  "anim_lossless"])
def test_files_decode_as_in_jax(name):
    data = port_file(name)
    mine = webp_tpu_torch.WebPDecoder(data, device="cpu")
    ref = webp_tpu.WebPDecoder(data)
    if ref.is_animated():
        for _ in range(ref.num_frames):
            (got, got_ms), (want, want_ms) = mine.read_frame(), ref.read_frame()
            assert got_ms == want_ms
            np.testing.assert_array_equal(got, want)
        return
    img = mine.read_image()
    np.testing.assert_array_equal(img, ref.read_image())
    if name == "rgba_m4":
        np.testing.assert_array_equal(img[..., 3], _rgba(32, 24, 2)[..., 3])
    src = _rgb(48, 40, 1 if name == "rgb_m4" else 6)[:img.shape[0], :img.shape[1]]
    if name != "rgba_m4":
        assert metrics.psnr(img[..., :3], src) > 25


def test_animation_frames_compose_to_their_sources():
    d = webp_tpu_torch.WebPDecoder(port_file("anim_lossless"), device="cpu")
    frames = [d.read_frame()[0] for _ in range(d.num_frames)]
    assert np.array_equal(frames[1], frames[2])
    np.testing.assert_array_equal(frames[3], _rgba(40, 24, 42))


# ---- refusals ---------------------------------------------------------------


BAD = {
    "zero_width": lambda M, kw: M.Encoder.new_rgb(np.zeros((4, 0, 3), np.uint8), **kw).encode(),
    "too_tall": lambda M, kw: M.Encoder.new_l8(np.zeros((16384, 1), np.uint8), **kw)
        .with_lossless().encode(),
    "too_wide_lossy": lambda M, kw: M.Encoder.new_rgb(np.zeros((1, 16384, 3), np.uint8), **kw)
        .encode(),
    "five_channels": lambda M, kw: M.Encoder(np.zeros((4, 4, 5), np.uint8), **kw),
    "anim_zero": lambda M, kw: M.AnimationEncoder(0, 8, **kw),
    "anim_too_wide": lambda M, kw: M.AnimationEncoder(16385, 8, **kw),
    "anim_wrong_size": lambda M, kw: M.AnimationEncoder(8, 8, **kw)
        .add_frame(np.zeros((8, 9, 4), np.uint8), 10),
    "anim_rgb_frame": lambda M, kw: M.AnimationEncoder(8, 8, **kw)
        .add_frame(np.zeros((8, 8, 3), np.uint8), 10),
    "anim_no_frame": lambda M, kw: M.AnimationEncoder(8, 8, **kw).finish(),
}


@pytest.mark.parametrize("name", BAD)
def test_refusals_match_jax(name):
    with pytest.raises(webp_tpu.WebPError) as want:
        BAD[name](webp_tpu, {})
    with pytest.raises(webp_tpu_torch.WebPError) as got:
        BAD[name](webp_tpu_torch, CPU)
    assert type(got.value).__name__ == type(want.value).__name__


def test_default_device_is_the_card():
    """The lossy route runs on "cuda" by default; with no card it raises,
    and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    img = _rgb(16, 16, 19)
    for obj in (webp_tpu_torch.Encoder(img), webp_tpu_torch.WebPEncoder(),
                webp_tpu_torch.AnimationEncoder(16, 16)):
        assert obj.device == torch.device("cuda")
    for call in (lambda: webp_tpu_torch.encode_rgb(img),
                 lambda: webp_tpu_torch.Encoder.new_rgba(_rgba(16, 16, 1)).encode(),
                 lambda: webp_tpu_torch.AnimationEncoder(16, 16, lossless=False)
                 .add_frame(_rgba(16, 16, 1), 10)):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_encoder_api_runs_without_jax(tmp_path):
    """A lossy RGBA file, a lossless one and a lossy animation encode and
    decode through the port with `jax` and `webp_tpu` blocked from import."""
    script = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "webp_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tests')!r}]
        import numpy as np
        import random_webp as rw
        import webp_tpu_torch as P
        img = rw.rgba_frame(24, 16, 3)
        lossy = P.Encoder.new_rgba(img, device="cpu").with_method(0).encode()
        got, w, h = P.decode_rgba(lossy, device="cpu")
        assert (w, h) == (24, 16) and (got[..., 3] == img[..., 3]).all()
        assert P.metrics.psnr(got[..., :3], img[..., :3]) > 20
        lossless = P.encode_lossless_rgba(img, device="cpu")
        assert (P.decode_rgba(lossless, device="cpu")[0] == img).all()
        enc = P.AnimationEncoder(24, 16, lossless=False, method=0, device="cpu")
        enc.add_frame(img, 10).add_frame(img[::-1], 20)
        d = P.WebPDecoder(enc.finish(), device="cpu")
        assert [d.read_frame()[1] for _ in range(d.num_frames)] == [10, 20]
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
