"""The schedules of kernels K8 (segment analysis) and K6 (token statistics)
on the CPU, against the JAX package.

K8's schedule twin (`webp_tpu_torch/ops/analysis.py`
`analyze_alphas_rows_plain`: CTAs of one MB row's run of MBs over staged
pixel tiles, MBs in pairs over three 32-lane rounds with per-lane counts
summed per bin, the images' chroma sums finished by each image's last
CTA) against `webp_tpu.ops.analysis2.analyze_alphas_batch`, on a flat
frame, noise, flat and noisy MBs mixed, a 1x1-MB frame and a 1-MB-wide
frame, with CTAs of 64 and of a few MBs run in seeded orders; one case
asserts a chroma sum that the floor division rounds.  K6's schedule twin
(`webp_tpu_torch/ops/token_stats.py` `token_stats_rows_plain`: the Y2
contexts from a chunked column scan and a row scan instead of walks, one
event code a (block, position) folded into nodes, per-image counters with
a ticket) against `webp_tpu.ops.token_stats.token_stats_device`, on
`tests/stats_inputs.py`'s arrays: every MB B-predicted, most MBs
B-predicted (Y2 blocks found rows and chunks away), one MB column, one
MB row, every MB skipped, and magnitudes 66/67/68, 2047 and 3000, with the
skip flags given and derived, and short runs and chunks.  Also the two
routes of the port's K6 wrapper (`token_stats` with the skip flags,
`token_stats_levels` without).  Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.analysis2 import analyze_alphas_batch as janalyze
from webp_tpu.ops.token_stats import token_stats_device
from webp_tpu_torch.ops.analysis import analyze_alphas_rows_plain
from webp_tpu_torch.ops.token_stats import (skip_flags, token_stats, token_stats_levels,
                                            token_stats_rows_plain)

from stats_inputs import level_arrays, planes

# K8 cases: (kind, mbw, mbh, MBs a CTA).  Each geometry compiles the JAX
# function once.
ANALYSIS_CASES = {
    "flat": ("flat", 5, 3, 64),
    "noise": ("noise", 5, 3, 2),
    "mixed_runs": ("mixed", 7, 4, 3),
    "one_mb": ("noise", 1, 1, 64),
    "one_mb_wide": ("mixed", 1, 5, 64),
}


@pytest.mark.parametrize("case", list(ANALYSIS_CASES))
def test_analysis_schedule_matches_jax(case):
    kind, mbw, mbh, seg = ANALYSIS_CASES[case]
    y, u, v = planes(kind, 3, mbw, mbh, seed=mbw * 10 + mbh)
    want = janalyze(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), mbw, mbh)
    n_cta = 3 * mbh * -(-mbw // seg)
    order = np.random.RandomState(n_cta).permutation(n_cta)
    sums = {}
    got = analyze_alphas_rows_plain(*(torch.from_numpy(p) for p in (y, u, v)), seg=seg,
                                    order=order, sums=sums)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sorted(sums) == [0, 1, 2]
    if kind == "flat":  # MBs off the frame's top and left predict exactly: alpha 255
        assert (got[0].reshape(3, mbh, mbw)[:, 1:, 1:] == 255).all()
    if case == "noise":  # a chroma sum that the floor division rounds
        assert any(sums[b] % (mbw * mbh) for b in sums)


# K6 cases: (mbw, mbh, level_arrays options, MBs a CTA, rows a scan chunk).
TOKEN_CASES = {
    "all_b": (6, 5, dict(all_b=True), 64, 8),
    "all_b_runs_chunks": (6, 5, dict(all_b=True), 4, 2),
    "mostly_b_chunks": (5, 9, dict(b_share=0.85), 2, 2),
    "one_mb_column": (1, 7, dict(), 64, 3),
    "one_mb_row": (7, 1, dict(), 3, 8),
    "all_skipped": (4, 3, dict(skip_all=True), 64, 8),
    "mags_unclipped": (5, 4, dict(clip=False), 2, 1),
}


@pytest.fixture(scope="module", params=list(TOKEN_CASES))
def token_case(request):
    mbw, mbh, opts, seg, chunk = TOKEN_CASES[request.param]
    a = level_arrays(3, mbw, mbh, seed=len(request.param), **opts)
    j = {k: jnp.asarray(v.astype(np.int32)) for k, v in a.items()}
    skipped = ((j["y_levels"] == 0).all(axis=(-1, -2)) & (j["uv_levels"] == 0).all(axis=(-1, -2))
               & (j["y2_levels"] == 0).all(axis=-1))
    want = token_stats_device(j["luma_mode"], j["y2_levels"], j["y_levels"], j["uv_levels"],
                              skipped, mbw, mbh)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    return request.param, t, (mbw, mbh, seg, chunk), tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("derive", [False, True], ids=["skip_given", "skip_derived"])
def test_token_stats_schedule_matches_jax(token_case, derive):
    name, t, (mbw, mbh, seg, chunk), want = token_case
    lv = (t["luma_mode"], t["y2_levels"], t["y_levels"], t["uv_levels"])
    skipped = None if derive else skip_flags(*lv[1:])
    n_cta = 3 * mbh * -(-mbw // seg)
    order = np.random.RandomState(n_cta).permutation(n_cta)
    got = token_stats_rows_plain(*lv, skipped, mbw, mbh, seg=seg, chunk_rows=chunk, order=order)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    if name == "all_skipped":
        assert not want[0].any()
    if name == "mags_unclipped":
        assert (t["uv_levels"].abs() == 3000).any() and (t["y_levels"].abs() == 67).any()


def test_token_stats_routes_agree(token_case):
    """`token_stats` with the levels' skip flags and `token_stats_levels`,
    which derives them, give the same counts as the JAX package."""
    _, t, (mbw, mbh, _, _), want = token_case
    lv = (t["luma_mode"], t["y2_levels"], t["y_levels"], t["uv_levels"])
    given = token_stats(*lv, skip_flags(*lv[1:]), mbw, mbh)
    derived = token_stats_levels(*lv, mbw, mbh)
    for g, d, w in zip(given, derived, want):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(d.numpy(), w)
