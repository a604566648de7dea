"""The banded kernels' schedule on the CPU (`ops/banded.py`
`recon_banded_rows_plain_`, `filter_banded_rows_plain_`, `band_schedule`):
a band's rows dealt to G row pipelines in turn, MBs run in seeded orders
that the progress counters allow inside a band and across bands, against
the diagonal twins of K2 and K3 (`recon_plain_`, `loop_filter_plain_`).

Inputs: `recon_inputs.py`'s seeded residuals, modes and filter parameters
(every mode, level-0 MBs among the others) at 5x8 MBs in 2 and 4 bands
and 3x12 MBs in 1 and 2 bands with fewer pipelines than band rows; both
filter kinds.  No JAX.  Tolerance: bit-exact (integer arithmetic).
"""

import pytest
import torch

from webp_tpu_torch.ops import banded
from webp_tpu_torch.ops.loopfilter import loop_filter_plain_
from webp_tpu_torch.ops.wavefront import recon_plain_

from recon_inputs import random_inputs

# name -> (mbw, mbh, n_band, pipelines a band)
CASES = {"5x8_bands2": (5, 8, 2, 4), "5x8_bands4": (5, 8, 4, 2),
         "3x12_bands1_g5": (3, 12, 1, 5), "3x12_bands2_g4": (3, 12, 2, 4)}
SEEDS = (0, 1)


def _planes(mbw, mbh, batch):
    return [torch.zeros((batch, mbh * n, mbw * n), dtype=torch.uint8) for n in (16, 8, 8)]


def _inputs(name):
    mbw, mbh, n_band, pipes = CASES[name]
    inputs = random_inputs(mbw, mbh, seed=11 * mbw + mbh)
    level = inputs[4]
    assert (level == 0).any() and (level > 0).any()  # level-0 MBs among the others
    return mbw, mbh, n_band, pipes, inputs


def _recon(mbw, mbh, inputs):
    planes = _planes(mbw, mbh, inputs[0].shape[0])
    recon_plain_(*planes, *inputs[:4])
    return planes


@pytest.mark.parametrize("name", list(CASES))
def test_recon_schedule_matches_diagonal_twin(name):
    mbw, mbh, n_band, pipes, inputs = _inputs(name)
    want = _recon(mbw, mbh, inputs)
    for seed in SEEDS:
        got = _planes(mbw, mbh, inputs[0].shape[0])
        banded.recon_banded_rows_plain_(*got, *inputs[:4], n_band, pipes, seed)
        for g, w in zip(got, want):
            assert torch.equal(g, w), seed


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
@pytest.mark.parametrize("name", list(CASES))
def test_filter_schedule_matches_diagonal_twin(name, simple):
    mbw, mbh, n_band, pipes, inputs = _inputs(name)
    unfiltered = _recon(mbw, mbh, inputs)
    want = [p.clone() for p in unfiltered]
    loop_filter_plain_(*want, *inputs[4:], simple)
    assert not torch.equal(want[0], unfiltered[0])  # the filter acts
    for seed in SEEDS:
        got = [p.clone() for p in unfiltered]
        banded.filter_banded_rows_plain_(*got, *inputs[4:], simple, n_band, pipes, seed)
        for g, w in zip(got, want):
            assert torch.equal(g, w), seed


@pytest.mark.parametrize("name", list(CASES))
def test_band_schedule_deals_rows_to_pipelines(name):
    """Every MB once; a row's MBs in order; row r's MB i after row r - 1's
    MB min(i + 1, mbw - 1), also across bands; a pipeline's next row only
    after its row's last MB, so at most min(G, r_loc) rows of a band are
    under way at once."""
    mbw, mbh, n_band, pipes, _ = _inputs(name)
    r_loc = mbh // n_band
    order = list(banded.band_schedule(mbh, mbw, n_band, pipes, seed=3))
    assert sorted(order) == [(r, i) for r in range(mbh) for i in range(mbw)]
    at = {step: t for t, step in enumerate(order)}
    for r, i in order:
        if i:
            assert at[(r, i - 1)] < at[(r, i)]
        if r:
            assert at[(r - 1, min(i + 1, mbw - 1))] < at[(r, i)]
        if r % r_loc >= pipes and i == 0:
            assert at[(r - pipes, mbw - 1)] < at[(r, 0)]
    for t in range(len(order)):
        for k in range(n_band):
            busy = [r for r in range(k * r_loc, (k + 1) * r_loc)
                    if at[(r, 0)] <= t <= at[(r, mbw - 1)]]
            assert len(busy) <= min(pipes, r_loc)


@pytest.mark.parametrize("kernel", ["recon", "filter"])
def test_band_schedule_needs_the_wait(kernel):
    """A wait of one iteration (row r's MB i once row r - 1 has finished
    i + 1) breaks some orders: the recon's top-right edge or the filter's
    last columns of the row above are not ready yet.  Shows that the
    schedule tests can fail."""
    mbw, mbh, n_band, pipes, inputs = _inputs("5x8_bands2")
    want = _recon(mbw, mbh, inputs)
    if kernel == "filter":
        unfiltered = [p.clone() for p in want]
        loop_filter_plain_(*want, *inputs[4:], False)
    differs = []
    for seed in range(4):
        if kernel == "recon":
            got = _planes(mbw, mbh, inputs[0].shape[0])
            banded.recon_banded_rows_plain_(*got, *inputs[:4], n_band, pipes, seed, wait=1)
        else:
            got = [p.clone() for p in unfiltered]
            banded.filter_banded_rows_plain_(*got, *inputs[4:], False, n_band, pipes, seed,
                                             wait=1)
        differs.append(not all(torch.equal(g, w) for g, w in zip(got, want)))
    assert any(differs)
