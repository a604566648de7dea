"""The ported slice as a whole: `webp_tpu_torch.decode.device` on the CPU
against the JAX package's `dispatch_decode_batch` (run on the CPU as its
own tests run it) and against the scalar `Vp8Decoder`, which is
independent of both.  Inputs are host-encoded mixed frames (I4 and I16
MBs), one geometry a whole number of MBs and one not.  Tolerance:
bit-exact.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from webp_tpu.decode import device as jdev
from webp_tpu.decode.vp8 import Vp8Decoder
from webp_tpu_torch import _build
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.io import native

from torch_fixtures import encode_frame, luma_mode_counts, mixed_payloads, scalar_decode

REPO = Path(__file__).resolve().parent.parent
GEOMETRIES = [(72, 40), (64, 48)]


@pytest.fixture(scope="module")
def payloads():
    out = {g: mixed_payloads(*g, seeds=(31, 32)) for g in GEOMETRIES}
    for g, ps in out.items():
        for p in ps:
            i4, i16 = luma_mode_counts(p)
            assert i4 > 0 and i16 > 0, (g, i4, i16)
    return out


@pytest.mark.parametrize("out", ["rgb", "yuv"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_dispatch_matches_jax_and_scalar(payloads, geometry, out):
    ps = payloads[geometry]
    got = tdev.dispatch_decode_batch(ps, out=out, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    want_jax = np.asarray(jdev.dispatch_decode_batch(ps, out=out))
    np.testing.assert_array_equal(got.numpy(), want_jax)
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0 if out == "rgb" else 1])


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_host_parse_matches_jax_package(payloads, geometry):
    """The jax-free rebuild of the host parse (entropy pass, dequant table,
    filter parameters, sparse pack, escape list) gives the JAX package's
    arrays exactly."""
    got = tdev.parse_levels_batch(payloads[geometry])
    want = jdev.parse_levels_batch(payloads[geometry])
    assert got["bitmap"] is not None and want["bitmap"] is not None
    for key in ("i16buf", "bitmap", "vals", "esc_pos", "esc_val", "qtab", "u8buf",
                "headers", "segs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert native.parse_dims(payloads[geometry][0]) == geometry


def test_mixed_geometry_batch(payloads):
    ps = [payloads[GEOMETRIES[0]][0], payloads[GEOMETRIES[1]][0],
          payloads[GEOMETRIES[0]][1], payloads[GEOMETRIES[1]][1]]
    got = tdev.decode_vp8_batch_device_mixed(ps, device="cpu")
    for g, p in zip(got, ps):
        np.testing.assert_array_equal(g, scalar_decode(p)[0])


def test_dense_int16_overflow_path():
    """Q100 noise puts more than CAP_MB_DEC nonzeros in an MB, so the parse
    drops the sparse form and the dense int16 levels are uploaded."""
    rng = np.random.RandomState(0)
    ps = [encode_frame(rng.randint(0, 256, (40, 72, 3)).astype(np.uint8), 100, 2)
          for _ in range(2)]
    batch = tdev.parse_levels_batch(ps)
    assert batch["bitmap"] is None and jdev.parse_levels_batch(ps)["bitmap"] is None
    assert set(tdev.to_device_batch(batch, "cpu")) == {"i16buf", "u8buf", "headers"}
    got = tdev.dispatch_decode_batch(ps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdev.dispatch_decode_batch(ps)))
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0])


def test_frame_api_and_host_delivery(payloads):
    p = payloads[GEOMETRIES[0]][0]
    frame, rgb = tdev.decode_vp8_frame_device(p, device="cpu")
    ref = Vp8Decoder(bytes(p)).decode()
    for name in ("ybuf", "ubuf", "vbuf"):
        np.testing.assert_array_equal(getattr(frame, name), getattr(ref, name))
    np.testing.assert_array_equal(rgb, ref.to_rgb())
    ps = payloads[GEOMETRIES[0]]
    packed = tdev.dispatch_decode_batch(ps, out="yuv", device="cpu").numpy()
    w, h = GEOMETRIES[0]
    rgb_host = tdev.yuv_packed_to_rgb(packed, (w + 15) // 16, (h + 15) // 16, w, h)
    np.testing.assert_array_equal(rgb_host, tdev.decode_vp8_batch_device(ps, device="cpu"))


def test_cpu_path_launches_no_kernel(payloads):
    _build.reset_launches()
    tdev.dispatch_decode_batch(payloads[GEOMETRIES[0]], device="cpu")
    assert set(_build.LAUNCHES.values()) == {0}


def test_port_runs_without_jax(tmp_path):
    """With jax and the JAX package both unimportable (as on a machine with
    only PyTorch), the port imports and decodes a seeded random keyframe;
    neither was loaded.  The result is held to the scalar decoder here."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
        import numpy as np
        import webp_tpu_torch
        from random_vp8 import random_keyframe
        p, _ = random_keyframe(64, 48, seed=1)
        open("payload.bin", "wb").write(p)
        np.save("rgb.npy", webp_tpu_torch.decode_vp8_batch_device([p], device="cpu")[0])
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("NOJAX_OK")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    payload = (tmp_path / "payload.bin").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "rgb.npy"), scalar_decode(payload)[0])


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|webp_tpu)(?:[.\s]|$)", re.M)


def test_package_imports_no_jax_module():
    """No module of the port, nor `chip_smoke.py`, the input generators it
    and the card tests use, or the statistics kernels' timing tool, imports
    jax or the JAX package `webp_tpu`."""
    paths = sorted((REPO / "webp_tpu_torch").rglob("*.py"))
    paths += [REPO / "chip_smoke.py", REPO / "tests" / "random_vp8.py",
              REPO / "tests" / "synthetic_rgb.py", REPO / "tests" / "stats_inputs.py",
              REPO / "tests" / "lane_inputs.py", REPO / "tools" / "stats_split.py"]
    for path in paths:
        found = _IMPORT.findall(path.read_text())
        assert not found, (path, found)
