"""The slice on seeded random VP8 keyframes (`random_vp8.py`): the port's
decode on the CPU against the JAX package's `dispatch_decode_batch` (run on
the CPU as its own tests run it) and the scalar `Vp8Decoder`.

Unlike the encoder's streams these carry the simple loop filter, absolute
segment values, filter deltas, several token partitions, updated token
probabilities and |level| > 127 escapes.  Also: the stream writer against
the host parse, and `chip_smoke.py`'s own phases on the CPU.  Tolerance:
bit-exact.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from webp_tpu.decode import device as jdev
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.decode import device as tdev

from random_vp8 import random_keyframe
from torch_fixtures import scalar_decode

REPO = Path(__file__).resolve().parent.parent
W, H = 72, 40


@pytest.fixture(scope="module")
def streams():
    """simple -> two payloads of one geometry, with escapes."""
    return {simple: [random_keyframe(W, H, seed=10 * simple + s, simple=simple, escapes=12)[0]
                     for s in (1, 2)]
            for simple in (False, True)}


@pytest.mark.parametrize("seed,width,height",
                         [(1, 72, 40), (2, 33, 17), (3, 16, 16), (4, 1, 1), (5, 100, 9),
                          (6, 48, 64)])
def test_writer_round_trips_through_host_parse(seed, width, height):
    payload, c = random_keyframe(width, height, seed)
    b = tdev.parse_levels_batch([payload])
    nmb = c["levels"].shape[0]
    raster = np.zeros_like(c["levels"])
    raster[..., T.ZIGZAG] = c["levels"]
    np.testing.assert_array_equal(b["i16buf"][0, : nmb * 400].reshape(nmb, 25, 16), raster)
    f = tdev.field_views(b["u8buf"], nmb)
    for key in ("luma_mode", "chroma_mode", "skipped"):
        np.testing.assert_array_equal(f[key][0], c[key], err_msg=key)
    i4 = c["luma_mode"] == 4
    np.testing.assert_array_equal(f["bpred"][0][i4], c["bpred"][i4])
    want_seg = c["segment_ids"] if b["headers"][0][10] else 0
    np.testing.assert_array_equal(f["segment_ids"][0], want_seg)
    assert tdev.geometry(b["headers"])[3:] == (width, height)


@pytest.mark.parametrize("out", ["rgb", "yuv"])
@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
def test_random_streams_match_jax_and_scalar(streams, simple, out):
    ps = streams[simple]
    batch = tdev.parse_levels_batch(ps)
    nmb = batch["u8buf"].shape[1] // 24
    assert batch["bitmap"] is not None and ((batch["esc_pos"] < nmb * 400).sum(1) > 0).all()
    assert tdev.geometry(batch["headers"])[2] == simple
    got = tdev.dispatch_decode_batch(ps, out=out, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdev.dispatch_decode_batch(ps, out=out)))
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0 if out == "rgb" else 1])


def test_random_dense_streams_match_jax_and_scalar():
    """An MB with 384 nonzero levels overflows the sparse form: the dense
    int16 upload carries the batch."""
    ps = [random_keyframe(40, 24, seed=s, dense=True)[0] for s in (5, 6)]
    assert tdev.parse_levels_batch(ps)["bitmap"] is None
    got = tdev.dispatch_decode_batch(ps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdev.dispatch_decode_batch(ps)))
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0])


def test_mixed_geometries_and_partitions_match_scalar():
    ps = [random_keyframe(w, h, seed=20 + k, log2_parts=k)[0]
          for k, (w, h) in enumerate([(24, 24), (40, 8), (24, 24), (17, 33)])]
    for g, p in zip(tdev.decode_vp8_batch_device_mixed(ps, device="cpu"), ps):
        np.testing.assert_array_equal(g, scalar_decode(p)[0])


def test_to_device_batch_rejects_unordered_escapes(streams):
    """Kernel K1 finds an MB's escapes by binary search, so the upload
    refuses an escape list that does not ascend."""
    b = tdev.parse_levels_batch(streams[False])
    b["esc_pos"] = np.ascontiguousarray(b["esc_pos"][:, ::-1])
    with pytest.raises(ValueError, match="ascend"):
        tdev.to_device_batch(b, "cpu")


def test_chip_smoke_phases_on_cpu_without_jax(tmp_path):
    """chip_smoke's input and reference phases, at a small size, with jax and
    the JAX package unimportable; the reference equals the scalar decoder."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path.insert(0, {str(REPO)!r})
        import numpy as np
        import chip_smoke
        made = chip_smoke.make_payloads(56, 40, simple=True)
        assert all(i4 > 0 and i16 > 0 for _, i4, i16 in made), made
        rgb, yuv = chip_smoke.cpu_reference([m[0] for m in made])
        for i, (p, _, _) in enumerate(made):
            open(f"p{{i}}.bin", "wb").write(p)
        np.save("rgb.npy", rgb)
        np.save("yuv.npy", yuv)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rgb, yuv = np.load(tmp_path / "rgb.npy"), np.load(tmp_path / "yuv.npy")
    for i in range(2):
        want_rgb, want_yuv = scalar_decode((tmp_path / f"p{i}.bin").read_bytes())
        np.testing.assert_array_equal(rgb[i], want_rgb)
        np.testing.assert_array_equal(yuv[i], want_yuv)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the exit without a GPU")
@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
