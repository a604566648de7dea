"""The data-parallel factories of `webp_tpu_torch.parallel` across two
processes on the CPU: two gloo ranks, spawned as subprocesses that can
import neither jax nor the JAX package (the layout of
`tests/test_distributed.py`), each run every factory on its half of a
batch, and this process holds their outputs to:

- the JAX package's `make_decode_batch_sharded` on the same seeded random
  keyframes (`random_vp8.py`, 96x64, batch 4);
- the JAX package's `make_encode_analysis_sharded` (m3, no trellis, 96x64,
  batch 8, seeded synthetic frames), field by field;
- the JAX package's `make_encode_tokens_sharded` (4x4 MBs, batch 8, 2
  partitions) on every rank, on seeded levels, and again with levels
  dense enough on one rank's images that only that rank's lanes outgrow
  K13's first byte capacity;
- for `make_encode_twopass_sharded`, the ranks' int8 prepack (K18's
  5-tuple) against the unsharded port's, and the payloads finished from it
  (`ops.wire.unpack_analysis`) against the port's unsharded encode (Q75
  m4, segments on, 8 partitions; 64x48 frames, with the 256-MB floor of
  the segmentation lowered so that small frames are segmented), which the
  port's other tests hold to the JAX package.

Also the checks of the mesh against its process group and the per-rank
rows of the encoder's parameters.  Tolerance: bit-exact.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.decode import device as jdev
from webp_tpu.encode.quant import SegmentParams as JSegmentParams
from webp_tpu.encode.quant import quality_to_quant_index as jqi
from webp_tpu.ops.encode_wavefront import EncParams as JEncParams
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.yuv import rgb_to_yuv420
from webp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from webp_tpu.parallel.pipeline import (make_decode_batch_sharded, make_encode_analysis_sharded,
                                        make_encode_tokens_sharded)
from webp_tpu_torch import parallel
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.enc_params import EncParams, EncTables
from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch
from webp_tpu_torch.ops.wire import prepack

import webp_tpu_torch
from random_vp8 import random_keyframe
from synthetic_rgb import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
QUALITY = 75
RANKS = 2
TOKEN_GRID = (4, 4, 2)  # mbw, mbh, partitions

# Each rank: its half of every leg's batch through the port's factories.
_WORKER = r"""
import os, pickle, sys
sys.modules["jax"] = None
sys.modules["webp_tpu"] = None
sys.path[:0] = [os.environ["REPO"], os.path.join(os.environ["REPO"], "tests")]
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(2)
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], world_size=2, rank=rank)

from webp_tpu_torch import parallel
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.ops import token_ops, wire
from webp_tpu_torch.ops.enc_params import EncParams, EncTables

tmp = os.environ["CASE_DIR"]
with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
out = {}
mesh = parallel.make_mesh(device="cpu")
assert (mesh.n_data, mesh.rank) == (2, rank), mesh
try:
    parallel.make_mesh(device="cuda")
except ValueError as e:
    out["cuda_mesh"] = str(e)


def mine(a):
    half = len(a) // 2
    return a[rank * half:(rank + 1) * half]


# Decode: this rank's payloads, parsed and uploaded here.
batch = tdev.parse_levels_batch(mine(inp["payloads"]))
step = parallel.make_decode_batch_sharded(mesh, *tdev.geometry(batch["headers"]))
out["rgb"] = step(tdev.to_device_batch(batch, "cpu")).numpy()

# One-pass analysis: m3, no trellis, one parameter set for the batch.
y, u, v = edev.upload([mine(p) for p in inp["analysis_planes"]], "cpu")
mbw, mbh = y.shape[2] // 16, y.shape[1] // 16
step = parallel.make_encode_analysis_sharded(mesh, mbw, mbh, 3, False)
P = EncParams.from_segment(edev.SegmentParams(edev.quality_to_quant_index(75)))
got = step(y, u, v, P, EncTables.from_probs(T.COEFF_PROBS_DEFAULT))
out["analysis"] = {k: t.numpy() for k, t in got.items()}

# Tokens: K13's capacity runs recorded per call.
mbw, mbh, nparts = inp["token_grid"]
caps = []
plain = token_ops.encode_coeff_partitions_plain
token_ops.encode_coeff_partitions_plain = lambda *a: (caps.append(a[-1]), plain(*a))[1]
step = parallel.make_encode_tokens_sharded(mesh, mbw, mbh, nparts)
for case in ("tokens", "tokens_overflow"):
    caps.clear()
    arrays = [torch.from_numpy(mine(a)) for a in inp[case]]
    lanes = step(*arrays)
    out[case] = {k: getattr(lanes, k).numpy() for k in ("lead", "data", "n_bytes", "bottom",
                                                          "bit_num", "range", "n_ops")}
    out[case + "_caps"] = list(caps)
try:
    step(*(torch.from_numpy(a[: 3 if rank else 4]) for a in inp["tokens"]))
except ValueError as e:
    out["uneven"] = str(e)

# Two-pass flagship: segments on small frames, the whole batch's
# parameters (each rank takes its rows), this rank's planes and tables.
edev.MIN_MBS = 0
planes = inp["twopass_planes"]
height, width = inp["twopass_size"]
yg, ug, vg = edev.upload(planes, "cpu")
segs_all = edev.segment(yg, ug, vg, 75)
P_all, sid_all = edev.params_for(segs_all, 75, "cpu")
segs, sid = mine(segs_all), mine(sid_all)
y, u, v = (mine(p) for p in (yg, ug, vg))
mbw, mbh = y.shape[2] // 16, y.shape[1] // 16
stats_step, prepack_step = parallel.make_encode_twopass_sharded(mesh, mbw, mbh, 3, 4, True)
totals, ones = stats_step(y, u, v, P_all, EncTables.from_probs(T.COEFF_PROBS_DEFAULT), sid)
probs = edev.adapt_probs(totals.numpy(), ones.numpy())
pre = [t.numpy() for t in prepack_step(y, u, v, P_all, edev.tables_for(probs, "cpu"), sid)]
out["prepack"] = pre
arrays = [wire.unpack_analysis(*(a[i] for a in pre[:4])) for i in range(len(pre[0]))]
out["twopass"] = edev.finish_frames_lossy_batch(arrays, probs, 75, width, height, 8, segs)
out["segment_ids_used"] = [len(set(s.segment_map.tolist())) for s in segs]

with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(case_dir: Path):
    """The two worker processes, started; stdout and stderr to files."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, REPO=str(REPO), INIT=init, CASE_DIR=str(case_dir))
    env.pop("PYTHONPATH", None)
    procs = []
    for rank in range(RANKS):
        with open(case_dir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _WORKER],
                                          env=dict(env, RANK=str(rank)), stdout=log,
                                          stderr=subprocess.STDOUT, cwd=case_dir))
    return procs


def _join(procs, case_dir: Path, timeout: int = 240):
    """Each rank's outputs; fails with its log if a rank failed or timed out."""
    outs = []
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            p.wait()
        log = (case_dir / f"rank{rank}.log").read_text()
        assert p.returncode == 0 and f"RANK_OK {rank}" in log, f"rank {rank}:\n{log[-3000:]}"
        with open(case_dir / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _token_levels(seed: int, dense_half: bool):
    """tests/test_sharded.py's seeded levels for 4x4 MBs, batch 8; with
    `dense_half`, the second half's Y levels denser, so that their lanes
    outgrow the first capacity (2,048 bytes)."""
    rng = np.random.RandomState(seed)
    mbw, mbh, _ = TOKEN_GRID
    B, nmb = 8, mbw * mbh
    y2 = (rng.randint(-60, 61, (B, nmb, 16)) * (rng.rand(B, nmb, 16) < 0.3)).astype(np.int32)
    yl = (rng.randint(-25, 26, (B, nmb, 16, 16)) * (rng.rand(B, nmb, 16, 16) < 0.2)).astype(np.int32)
    uv = (rng.randint(-15, 16, (B, nmb, 8, 16)) * (rng.rand(B, nmb, 8, 16) < 0.15)).astype(np.int32)
    lm = rng.choice([0, 1, 2, 3, 4], (B, nmb)).astype(np.int32)
    if dense_half:
        yl[B // 2:] = rng.randint(-12, 13, (B // 2, nmb, 16, 16)) * (rng.rand(B // 2, nmb, 16, 16)
                                                                    < 0.7)
    y2[np.broadcast_to((lm == 4)[..., None], y2.shape)] = 0
    probs = rng.randint(1, 256, (B, 4 * 8 * 3 * 11)).astype(np.int32)
    return lm, y2, yl, uv, probs


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """(inputs, each rank's outputs, the references of this process).  The
    ranks start first and run while this process computes the references."""
    case_dir = tmp_path_factory.mktemp("ranks")
    payloads = [random_keyframe(96, 64, s)[0] for s in (41, 42, 43, 44)]
    frames = [synthetic_frame(96, 64, s) for s in range(1, 9)]
    analysis_planes = edev.rgb_to_planes(frames)
    twopass_frames = [synthetic_frame(64, 48, s) for s in (11, 12)]
    tokens = {case: _token_levels(4, case == "tokens_overflow")
              for case in ("tokens", "tokens_overflow")}
    inp = dict(payloads=payloads, analysis_planes=analysis_planes, token_grid=TOKEN_GRID,
               twopass_planes=edev.rgb_to_planes(twopass_frames), twopass_size=(48, 64),
               **{case: [lm.astype(np.uint8), y2.astype(np.int16), yl.astype(np.int16),
                         uv.astype(np.int16), probs.astype(np.uint8)]
                  for case, (lm, y2, yl, uv, probs) in tokens.items()})
    with open(case_dir / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    procs = _start_ranks(case_dir)
    try:
        ref = _references(payloads, frames, tokens, twopass_frames)
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return inp, _join(procs, case_dir), ref


def _references(payloads, frames, tokens, twopass_frames):
    """This process's side: the JAX package's sharded steps and the port's
    unsharded two-pass encode."""
    ref = {}
    pb = jdev.parse_levels_batch(payloads)
    h0 = pb["headers"][0]
    step = make_decode_batch_sharded(jax_make_mesh(n_data=RANKS, n_band=1), int(h0[2]),
                                     int(h0[3]), bool(h0[4]), int(h0[0]), int(h0[1]))
    ref["rgb"] = np.asarray(step(*(jnp.asarray(pb[k]) for k in
                                   ("i8buf", "esc_pos", "esc_val", "qtab", "u8buf"))))

    planes = [rgb_to_yuv420(im) for im in frames]
    Y, U, V = (jnp.asarray(np.stack([p[i] for p in planes])) for i in range(3))
    step = make_encode_analysis_sharded(jax_make_mesh(n_data=8, n_band=1), 6, 4, 3, False)
    got = step(Y, U, V, JEncParams(JSegmentParams(jqi(QUALITY))), JEncTables.default())
    ref["analysis"] = {k: np.asarray(a) for k, a in got.items()}

    mbw, mbh, nparts = TOKEN_GRID
    step = make_encode_tokens_sharded(jax_make_mesh(n_data=8, n_band=1), mbw, mbh, nparts,
                                      mbw * mbh * 1000, 8192)
    for case, (lm, y2, yl, uv, probs) in tokens.items():
        ref[case] = [np.asarray(a) for a in step(*(jnp.asarray(a) for a in (y2, yl, uv, lm,
                                                                           probs)))]

    floor = edev.MIN_MBS
    edev.MIN_MBS = 0
    try:
        ref["twopass"] = webp_tpu_torch.encode_frames_lossy_batch(
            twopass_frames, QUALITY, 4, True, True, num_partitions=8, device="cpu")
        y, u, v = edev.upload(edev.rgb_to_planes(twopass_frames), "cpu")
        P, sid = edev.params_for(edev.segment(y, u, v, QUALITY), QUALITY, "cpu")
        totals, ones = edev.encode_analysis_stats_batch(
            y, u, v, P, EncTables.from_probs(T.COEFF_PROBS_DEFAULT), 3, sid)
        tables = edev.tables_for(edev.adapt_probs(totals.numpy(), ones.numpy()), "cpu")
        ref["prepack"] = [t.numpy() for t in
                          prepack(encode_analysis_batch(y, u, v, P, tables, 4, True, sid))]
    finally:
        edev.MIN_MBS = floor
    return ref


def test_ranks_see_their_mesh(legs):
    _, outs, _ = legs
    for out in outs:
        assert "nccl" in out["cuda_mesh"] and "gloo" in out["cuda_mesh"]


def test_sharded_decode_matches_jax(legs):
    _, outs, ref = legs
    got = np.concatenate([out["rgb"] for out in outs])
    assert got.shape == (4, 64, 96, 3)
    np.testing.assert_array_equal(got, ref["rgb"])


def test_sharded_analysis_matches_jax(legs):
    _, outs, ref = legs
    assert set(outs[0]["analysis"]) == set(ref["analysis"])
    for k, want in ref["analysis"].items():
        got = np.concatenate([out["analysis"][k] for out in outs])
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (ref["analysis"]["luma_mode"] == 4).any() and (ref["analysis"]["luma_mode"] != 4).any()


@pytest.mark.parametrize("case", ["tokens", "tokens_overflow"])
def test_sharded_tokens_match_jax_on_every_rank(legs, case):
    """Every rank holds all 8 images' lanes, equal to the JAX package's
    gathered lanes; in the overflow case only rank 1 ran K13 again."""
    _, outs, ref = legs
    lead, tok, tok_n, bottom, bit_num = ref[case]
    for out in outs:
        got = out[case]
        for field, want in (("lead", lead), ("n_bytes", tok_n), ("bottom", bottom),
                            ("bit_num", bit_num)):
            np.testing.assert_array_equal(got[field], want.astype(np.int64), err_msg=field)
        width = got["data"].shape[-1]
        assert width == tok_n.max() and not tok[..., width:].any()
        np.testing.assert_array_equal(got["data"], tok[..., :width])
    caps = [out[case + "_caps"] for out in outs]
    if case == "tokens":
        assert caps == [[2048], [2048]]
    else:
        need = int(tok_n[4:].max())
        assert caps == [[2048], [2048, need]] and tok_n[:4].max() < 2048 < need


def test_sharded_tokens_need_an_even_batch(legs):
    _, outs, _ = legs
    for out in outs:
        assert "does not split evenly" in out["uneven"]


def test_sharded_prepack_matches_unsharded(legs):
    """prepack_step returns K18's 5-tuple, as the JAX package's returns
    `_prepack_batch_pertbl`'s: each rank's rows equal the unsharded port's."""
    _, outs, ref = legs
    names = ("lv8", "meta8", "esc_pos", "esc_val", "overflow")
    for j, name in enumerate(names):
        got = np.concatenate([out["prepack"][j] for out in outs])
        assert got.dtype == ref["prepack"][j].dtype, name
        np.testing.assert_array_equal(got, ref["prepack"][j], err_msg=name)
    assert not ref["prepack"][4].any()


def test_sharded_twopass_payloads_match_unsharded(legs):
    _, outs, ref = legs
    got = [p for out in outs for p in out["twopass"]]
    assert got == ref["twopass"]
    for out in outs:  # the small frames were segmented
        assert min(out["segment_ids_used"]) >= 2


def test_local_rows_of_batched_parameters():
    lists = [[SegmentParams(quality_to_quant_index(q))] * 4 for q in (30, 50, 75, 90)]
    P = EncParams.from_segments(lists)
    mesh = parallel.Mesh(None, 2, 1, 1, torch.device("cpu"))
    mine = parallel.pipeline.local_rows(P, mesh, 2)
    want = EncParams.from_segments(lists[2:])
    for name in EncParams.VECS + EncParams.LAMS:
        assert torch.equal(getattr(mine, name), getattr(want, name)), name
    assert parallel.pipeline.local_rows(P, mesh, 4) is P
    probs = np.random.RandomState(3).randint(1, 256, (4, 4, 8, 3, 11)).astype(np.uint8)
    tables = EncTables.from_probs(probs)
    rows = parallel.pipeline.local_rows(tables, mesh, 2)
    for f in EncTables.FIELDS:
        assert torch.equal(getattr(rows, f), getattr(EncTables.from_probs(probs[2:]), f))
    with pytest.raises(ValueError):
        parallel.pipeline.local_rows(tables, mesh, 3)
    with pytest.raises(ValueError):
        P.rows(3, 5)
