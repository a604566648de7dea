"""K2 + K3 fused (`ops/recon_filter.py`): the port's fused decode path on the
CPU against the JAX package's one-scan `decode_frames_fused_v2`, and the
fused kernel's row schedule (`recon_filter_rows_plain_`) against the
diagonal twins of K2 and K3.

Inputs: the K1 residuals and MB fields of host-encoded mixed frames at 5x3
MBs (`torch_fixtures.py`), and seeded random residuals, modes and filter
parameters with level-0 MBs (`recon_inputs.py`) at 5x3, 1x1, one MB column
(1x3) and one MB row (4x1).  Both filter kinds run on the same inputs.
Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.wavefront2 import decode_frames_fused_v2
from webp_tpu_torch import _build
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.ops.recon_filter import recon_filter_, recon_filter_rows_plain_
from webp_tpu_torch.ops.wavefront import recon_

from recon_inputs import random_inputs
from torch_fixtures import mixed_payloads, scalar_decode

GEOMETRIES = {"5x3": (5, 3), "1x1": (1, 1), "column_1x3": (1, 3), "row_4x1": (4, 1)}


@pytest.fixture(scope="module")
def encoded():
    """(mbw, mbh, inputs) of two host-encoded 72x40 mixed frames: K1's
    residuals and the frames' own modes and filter parameters."""
    batch = tdev.parse_levels_batch(mixed_payloads(72, 40, seeds=(61, 62)))
    mbw, mbh = tdev.geometry(batch["headers"])[:2]
    d = tdev.to_device_batch(batch, "cpu")
    res, lm, bp, cm, level, interior, hev, do_sub = tdev.wavefront_inputs(d)
    return mbw, mbh, (res, lm, bp, cm, level, interior, hev, do_sub)


def _inputs(name, encoded):
    if name == "encoded_5x3":
        return encoded
    mbw, mbh = GEOMETRIES[name]
    return mbw, mbh, random_inputs(mbw, mbh, seed=7 * mbw + mbh)


def _planes(mbw, mbh, batch):
    return [torch.zeros((batch, mbh * n, mbw * n), dtype=torch.uint8) for n in (16, 8, 8)]


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
@pytest.mark.parametrize("name", ["encoded_5x3", *GEOMETRIES])
def test_fused_path_matches_jax(encoded, name, simple):
    mbw, mbh, inputs = _inputs(name, encoded)
    got = _planes(mbw, mbh, inputs[0].shape[0])
    recon_filter_(*got, *inputs, simple)
    want = decode_frames_fused_v2(*(jnp.asarray(a.numpy()) for a in inputs), mbw, mbh, simple)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    unfiltered = _planes(mbw, mbh, inputs[0].shape[0])
    recon_(*unfiltered, *inputs[:4])
    if mbw * mbh > 1:  # a lone MB has no MB edge, and its inner edges may all stay
        assert not torch.equal(got[0], unfiltered[0])  # the filter did act
    if simple:  # chroma passes through the simple filter untouched
        for g, p in zip(got[1:], unfiltered[1:]):
            assert torch.equal(g, p)


@pytest.mark.parametrize("lag", [1, 0], ids=["kernel_lag1", "lag0"])
@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
@pytest.mark.parametrize("name", ["encoded_5x3", *GEOMETRIES, "tall_3x6"])
def test_row_schedule_matches_diagonal_twins(encoded, name, simple, lag):
    """Any order of row iterations that the progress rule allows (iteration
    i of row r once row r-1 has finished min(i + 2, mbw + lag) iterations),
    recon from the saved unfiltered edges and the filter of MB i - lag in
    iteration i (the kernel's lag 1, or each MB right after its recon),
    gives the diagonal twins' planes."""
    if name == "tall_3x6":
        mbw, mbh, inputs = 3, 6, random_inputs(3, 6, seed=36)
    else:
        mbw, mbh, inputs = _inputs(name, encoded)
    if name != "encoded_5x3":
        assert (inputs[4] == 0).any() and (inputs[4] > 0).any()  # level-0 MBs among others
    B = inputs[0].shape[0]
    want = _planes(mbw, mbh, B)
    recon_filter_(*want, *inputs, simple)
    for seed in range(2):
        got = _planes(mbw, mbh, B)
        recon_filter_rows_plain_(*got, *inputs, simple, seed, lag=lag)
        for g, w in zip(got, want):
            assert torch.equal(g, w), seed


def test_row_schedule_needs_the_wait():
    """A wait of one iteration (row r's iteration i once row r-1 has
    finished i + 1) breaks some orders: the top-right recon and the filter's
    last columns of the row above are not ready.  Shows that the
    row-schedule test can fail."""
    inputs = random_inputs(5, 3, seed=38)
    want = _planes(5, 3, 2)
    recon_filter_(*want, *inputs, False)
    differs = []
    for seed in range(4):
        got = _planes(5, 3, 2)
        recon_filter_rows_plain_(*got, *inputs, False, seed, wait=1)
        differs.append(not all(torch.equal(g, w) for g, w in zip(got, want)))
    assert any(differs)


def test_decode_core_on_cpu_launches_no_kernel():
    payloads = mixed_payloads(72, 40, seeds=(63,))
    _build.reset_launches()
    got = tdev.decode_core(tdev.to_device_batch(tdev.parse_levels_batch(payloads), "cpu"), "rgb")
    assert set(_build.LAUNCHES.values()) == {0}
    np.testing.assert_array_equal(got[0].numpy(), scalar_decode(payloads[0])[0])


def test_recon_filter_refuses_mixed_devices():
    inputs = random_inputs(2, 2, seed=4)
    with pytest.raises(ValueError):
        recon_filter_(*_planes(2, 2, 2), *inputs[:4], inputs[4].to("meta"), *inputs[5:], False)
