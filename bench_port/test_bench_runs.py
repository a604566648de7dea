"""CPU rehearsals of whole runs: the result line's keys, the check that
decides `correct` against its control and the faults it has to catch, the
work count of the rooflines, and the modules a run loads."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_rehearsal import BENCH, SEED, outcome, rehearse
from harness import spec

WORKLOADS = [w["name"] for w in BENCH["workloads"]]
ENCODE = [w for w in WORKLOADS if w.endswith(".encode")]
DECODE = [w for w in WORKLOADS if w.endswith(".decode")]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_has_the_contract_keys(workload):
    res = rehearse(workload)
    line = json.loads(json.dumps(res))
    assert list(line) == KEYS + ["checks"]  # the numbers compared come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    traced = rehearse(workload, trace=True)
    assert set(traced) <= set(KEYS + ["breakdown", "checks"]) and traced["correct"] is True
    assert "setup_s" not in traced["metrics"]  # the per-layer metrics only


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_comes_out_not_correct(workload):
    res = rehearse(workload, control=True)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _stale():
    prev = {}

    def fault(i, out):  # a step that returns its state unchanged
        got = prev.get("out", out)
        prev["out"] = out
        return got
    return fault


def _half(i, out):  # half of the batch left out
    return out[:len(out) // 2]


def _altered(i, out):  # an answer altered where it is produced
    if isinstance(out, list):
        f = bytearray(out[0])
        f[len(f) // 2] ^= 0x10
        return [bytes(f)] + out[1:]
    out = out.clone()
    out[0, 0, 0, 0] ^= 1
    return out


FAULTS = {"stale": _stale, "half": lambda: _half, "altered": lambda: _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_comes_out_not_correct(workload, fault):
    res = rehearse(workload, fault=FAULTS[fault]())
    assert res["correct"] is False and res["failed"] > 0


def test_encode_work_count_is_the_inputs_and_settings_alone():
    """The two encode routes (host finish, device tokens) give each frame of
    a seed the same count, which the reference's own payloads give too."""
    from harness.encode_pipeline import frames_of
    from harness.roofline import encode_work
    from vp8ref.decoder import mb_modes
    from vp8ref.encoder import encode_frames

    host, tokens = (outcome(ENCODE[0], config={"device_tokens": t}).readings.work_per_input
                    for t in (False, True))
    assert host and host == tokens
    cell = spec.resolve(BENCH, ENCODE[0])
    frames = frames_of(SEED, 32, 32, 3, cell.config["assumed"]["rgb_noise"])
    ref = encode_frames([frames[k] for k in sorted(host)], cell.config["quality"],
                        cell.config["method"], True, cell.config["partitions"])
    for k, p in zip(sorted(host), ref):
        assert host[k] == encode_work(32, 32, cell.config["method"], mb_modes(p), len(p))


def test_decode_work_count_is_the_inputs_alone():
    a = outcome(DECODE[0]).readings.work_per_input
    b = outcome(DECODE[0]).readings.work_per_input
    assert a and a == b


JAX_ENCODE = """
import json, sys
sys.path[:0] = {paths!r}
import jax
jax.config.update("jax_platforms", "cpu")
from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops import yuv as jyuv
from harness.synthetic_rgb import synthetic_frame
frames = [synthetic_frame({size}, {size}, s, {noise}) for s in {seeds!r}]
planes = [jyuv.rgb_to_yuv420(r) for r in frames]
fetched = jvp8.analyze_frames_lossy_batch(planes, {quality}, {method}, {mbs}, {mbs}, True, True)()
segs = [bool(on and update) and len(set(m.tolist())) >= 2 for on, update, m, _, _ in fetched[3]]
print(json.dumps({{"segments": segs, "payloads": {{n: [p.hex() for p in jvp8.finish_frames_lossy_batch(
    planes, fetched, {quality}, {method}, {size}, {size}, True, n)] for n in {parts!r}}}}}))
"""


@pytest.mark.skipif(importlib.util.find_spec("jax") is None
                    or not (spec.ROOT / "webp_tpu").is_dir(),
                    reason="needs jax and the JAX package (the CPU tests' environment)")
def test_reference_encoder_matches_the_jax_package_on_the_cpu():
    """The encode reference (frozen copies of plain code, Python coders)
    against the JAX package's lossy batch encode, byte for byte: Q75 m4,
    two-pass with the trellis, segments on (256x256 is the least that turns
    them on), the configuration's partitions and 8, on the cells' content.
    The JAX package runs in a process of its own, never beside the harness."""
    from harness.synthetic_rgb import synthetic_frame
    from vp8ref.encoder import encode_frames

    cfg = spec.resolve(BENCH, ENCODE[0]).config
    size, seeds, noise = 256, [5, 6], cfg["assumed"]["rgb_noise"]
    parts = sorted({cfg["partitions"], 8})
    script = JAX_ENCODE.format(paths=[str(spec.BENCH_DIR), str(spec.ROOT)], size=size,
                               noise=noise, seeds=seeds, quality=cfg["quality"],
                               method=cfg["method"], mbs=size // 16, parts=parts)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(spec.ROOT), timeout=1200, env={**os.environ,
                                                                "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(want["segments"])  # the segment path is covered
    frames = [synthetic_frame(size, size, s, noise) for s in seeds]
    for n in parts:
        got = encode_frames(frames, cfg["quality"], cfg["method"], True, n)
        assert [p.hex() for p in got] == want["payloads"][str(n)], n


def test_reference_decoder_matches_the_port_on_the_cpu():
    from harness.random_vp8 import random_keyframe
    from vp8ref.decoder import decode_rgb
    from webp_tpu_torch.decode.device import decode_vp8_batch_device

    payloads = [random_keyframe(48, 32, s, False, 3)[0] for s in (7, 8)]
    got = np.asarray(decode_vp8_batch_device(payloads, device="cpu"))
    for g, p in zip(got, payloads):
        assert (g == decode_rgb(p)).all()
        assert (g != decode_rgb(p, "simple")).any()


LOADED = """
import json, sys
sys.argv = ["x"]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", LOADED.format(body=body)], capture_output=True,
                         text=True, cwd=str(spec.BENCH_DIR), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    mods = _top_modules("from bench_rehearsal import rehearse\n"
                        "if __name__ == '__main__':\n"
                        "    for w in %r: rehearse(w, trace=True)" % (WORKLOADS,))
    assert not mods & {"jax", "jaxlib", "flax", "webp_tpu"}
    assert "webp_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_modules(
        "sys.path.insert(0, '.')\n"
        "from harness.synthetic_rgb import synthetic_frame\n"
        "from harness.random_vp8 import random_keyframe\n"
        "from vp8ref.encoder import encode_frames\n"
        "from vp8ref.decoder import decode_rgb, mb_modes\n"
        "p = encode_frames([synthetic_frame(32, 32, 1)], 75, 4, True, 8)[0]\n"
        "decode_rgb(p); mb_modes(p); decode_rgb(random_keyframe(32, 32, 2, False, 3)[0])")
    assert not mods & {"jax", "jaxlib", "flax", "webp_tpu", "webp_tpu_torch"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_on_the_card(workload):
    """The control at the tiny size on a card (the cell's own size: `control.py`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    import run
    from bench_rehearsal import TINY

    res = run.run_cell(BENCH, workload, SEED, 2.0, False, device="cuda",
                       t_start=time.perf_counter(), overrides=TINY, control=True)
    assert res["correct"] is False
    sound = run.run_cell(BENCH, workload, SEED, 2.0, False, device="cuda",
                         t_start=time.perf_counter(), overrides=TINY)
    assert sound["correct"] is True
