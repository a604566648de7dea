"""The CUDA kernels against their plain torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports no jax, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Decode inputs are small host-encoded mixed frames (I4 and I16 MBs, a size
that is not a whole number of MBs), seeded random keyframes
(`random_vp8.py`: both loop filter kinds, escapes, several partitions) and
`lane_inputs.py`'s K1 and K4 edge cases (escape runs at CTA edges, a full
escape list, MBs past cap; odd widths at batch 2; unaligned inputs).
Encode inputs are seeded synthetic frames (`synthetic_rgb.py`), seeded
level arrays, seeded token probabilities and seeded segment ids; the
encode kernels' twins run on CPU copies of the same inputs; K8 and K6 also
on `stats_inputs.py`'s seeded planes and level arrays (batch 64 at
768x512, one MB column, all B-predicted, all skipped, short CTA runs), with
the twins on the same card tensors.  Lossless
inputs are seeded pixels, modes, coefficients and palettes, and seeded
VP8L streams (`random_vp8l.py`) checked against the host C++ decode and
their sources.  The token coder's inputs (`token_inputs.py`) are seeded
level arrays, MB modes, host coders part-way through a stream and
adversarial carry streams.  The band-split wavefront (K16, K17) runs on
seeded random keyframes at every band count that divides their MB rows.
The encode wire (K18-K20) runs on the seeded pass-2 arrays of
`wire_inputs.py`, which set each of its flags, at 45,000 MBs for positions
past 2^24, and inside the encode of Q100 frames that take its sparse and
dense-row branches.  The decoder API (`WebPDecoder`, `decode_rgba`) runs
on `random_webp.py`'s VP8X stills (ALPH raw and VP8L-compressed) and
animations, held to its own device="cpu" run; the encoder API
(`Encoder`, `encode_rgb`, `encode_lossless_rgba`, `AnimationEncoder`) on
small seeded files, byte-equal to its device="cpu" run, with the encode
kernels' launches counted and the files decoded back on the card.
Tolerance: bit-exact (integer arithmetic).
"""

import numpy as np
import pytest
import torch

import webp_tpu_torch
from webp_tpu_torch import _build, parallel
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.analysis import analyze_alphas_batch, analyze_alphas_batch_plain
from webp_tpu_torch.ops.enc_params import EncParams, EncTables
from webp_tpu_torch.ops.enc_tables import enc_tables, enc_tables_plain
from webp_tpu_torch.ops import encode_wavefront as ew
from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch, encode_analysis_batch_plain
from webp_tpu_torch.ops.token_stats import token_stats, token_stats_plain
from webp_tpu_torch.io import native
from webp_tpu_torch.ops import banded, boolenc2, residual, token_ops, wire
from webp_tpu_torch.ops import sparse
from webp_tpu_torch.ops.sparse import pack_levels_mb, pack_levels_mb_plain
from webp_tpu_torch.ops import vp8l_device as L
from webp_tpu_torch.ops.loopfilter import loop_filter_, loop_filter_plain_
from webp_tpu_torch.ops.recon_filter import recon_filter_, recon_filter_plain_, resident_rows
from webp_tpu_torch.ops.wavefront import recon_, recon_plain_
from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb, fancy_yuv420_to_rgb_plain

from random_vp8 import random_keyframe
from recon_inputs import random_inputs
from sparse_inputs import flat_cases
from random_vp8l import PALETTE, SUBTRACT_GREEN, color, predictor, quantize, vp8l_stream, with_alpha
from synthetic_rgb import synthetic_frame
from lane_inputs import K1_CASES, K4_SIZES, k1_case, k4_planes
from token_inputs import (CARRY_PATTERNS, header_inputs, prefix_coders, steered_lanes,
                          token_arrays)
from torch_fixtures import encode_frame, force_escapes, mixed_payloads, scalar_decode
from wire_inputs import wire_arrays
import random_webp as rw

pytestmark = pytest.mark.cuda

W, H = 72, 40
MBW, MBH = 5, 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.load()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def payloads():
    return mixed_payloads(W, H, seeds=(41, 42))


@pytest.fixture(scope="module")
def uploaded(cuda, payloads):
    b = force_escapes(tdev.parse_levels_batch(payloads))
    d = tdev.to_device_batch(b, cuda)
    d["i16buf"] = torch.from_numpy(b["i16buf"]).to(cuda)
    return d


def _fields(d):
    return tdev.field_views(d["u8buf"], MBW * MBH)


def _mb(f):
    return f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"]


def _planes(device):
    return (torch.zeros((2, MBH * 16, MBW * 16), dtype=torch.uint8, device=device),
            torch.zeros((2, MBH * 8, MBW * 8), dtype=torch.uint8, device=device),
            torch.zeros((2, MBH * 8, MBW * 8), dtype=torch.uint8, device=device))


@pytest.mark.parametrize("form", ["sparse", "dense_int16"])
def test_residual_kernel_matches_plain(uploaded, form):
    d, f = uploaded, _fields(uploaded)
    before = _build.LAUNCHES["residual"]
    if form == "sparse":
        args = [d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")]
        got = residual.residuals_sparse(*args, *_mb(f))
        want = residual.residuals_sparse_plain(*args, *_mb(f))
    else:
        got = residual.residuals_dense(d["i16buf"], *_mb(f))
        want = residual.residuals_dense_plain(d["i16buf"], *_mb(f))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["residual"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
def test_recon_and_filter_kernels_match_plain(uploaded, cuda, simple):
    d, f = uploaded, _fields(uploaded)
    res, do_sub = residual.residuals_sparse_plain(
        *(d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")), *_mb(f))
    got, want = _planes(cuda), _planes(cuda)
    before = dict(_build.LAUNCHES)
    recon_(*got, res, f["luma_mode"], f["bpred"], f["chroma_mode"])
    recon_plain_(*want, res, f["luma_mode"], f["bpred"], f["chroma_mode"])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rng = np.random.RandomState(7)
    shape = (2, MBW * MBH)
    params = [torch.from_numpy(a).to(cuda) for a in (
        (rng.randint(0, 64, shape) * (rng.rand(*shape) > 0.15)).astype(np.uint8),
        rng.randint(1, 64, shape).astype(np.uint8),
        rng.randint(0, 3, shape).astype(np.uint8),
        rng.rand(*shape) < 0.6,
    )]
    fused = _planes(cuda)
    recon_filter_(*fused, res, f["luma_mode"], f["bpred"], f["chroma_mode"], *params, simple)
    loop_filter_(*got, *params, simple)
    loop_filter_plain_(*want, *params, simple)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["recon"] == before["recon"] + 1
    assert _build.LAUNCHES["loopfilter"] == before["loopfilter"] + 1
    assert _build.LAUNCHES["recon_filter"] == before["recon_filter"] + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(fused, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width,height", [(64, 48), (72, 40), (63, 47), (17, 1), (1, 1)])
def test_yuv2rgb_kernel_matches_plain(cuda, width, height):
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    g = torch.Generator().manual_seed(width * 31 + height)
    planes = [torch.randint(0, 256, (2, mbh * n, mbw * n), generator=g, dtype=torch.uint8).to(cuda)
              for n in (16, 8, 8)]
    before = _build.LAUNCHES["yuv2rgb"]
    got = fancy_yuv420_to_rgb(*planes, width, height)
    want = fancy_yuv420_to_rgb_plain(*planes, width, height)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["yuv2rgb"] == before + 1
    assert torch.equal(got, want)


def _offset(a: np.ndarray, device, by: int = 1):
    """A copy of `a` on `device` whose data starts `by` elements past an
    allocation's start (so off every 16-byte boundary)."""
    buf = torch.zeros(a.size + by, dtype=torch.from_numpy(a).dtype, device=device)
    view = buf[by:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.parametrize("name", list(K1_CASES))
@pytest.mark.parametrize("form", ["sparse", "dense_int16", "sparse_unaligned",
                                  "dense_unaligned"])
def test_residual_kernel_edge_cases(cuda, name, form):
    """lane_inputs.py's K1 cases (escape runs at the CTA edges and past a
    warp, a full escape list with no sentinel, MBs at and past cap; 15 MBs),
    also with the levels, bitmap and dequant rows off their vector
    alignment (the kernel's scalar loads)."""
    c = k1_case(name)
    unaligned = form.endswith("unaligned")
    d = {k: (_offset(v, cuda) if unaligned and k in ("bitmap", "qtab", "i16buf")
             else torch.from_numpy(v).to(cuda)) for k, v in c.items() if k != "nmb"}
    mb = [d[k] for k in ("segment_ids", "luma_mode", "skipped", "non_zero")]
    before = _build.LAUNCHES["residual"]
    if form.startswith("sparse"):
        args = [d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")]
        got = residual.residuals_sparse(*args, *mb)
        want = residual.residuals_sparse_plain(*args, *mb)
    else:
        got = residual.residuals_dense(d["i16buf"], *mb)
        want = residual.residuals_dense_plain(d["i16buf"], *mb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["residual"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("width,height", K4_SIZES)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_yuv2rgb_kernel_edge_sizes(cuda, width, height, aligned):
    """lane_inputs.py's K4 sizes at batch 2 (odd widths put rows and the
    second image on every byte alignment), also with the planes off their
    8- and 4-byte alignment (the kernel's byte loads)."""
    planes = [torch.from_numpy(p).to(cuda) if aligned else _offset(p, cuda)
              for p in k4_planes(width, height)]
    before = _build.LAUNCHES["yuv2rgb"]
    got = fancy_yuv420_to_rgb(*planes, width, height)
    want = fancy_yuv420_to_rgb_plain(*planes, width, height)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["yuv2rgb"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["residual", "subtract_green"])
def test_launch_goes_to_current_stream(cuda, kernel):
    """A wrapper called under `torch.cuda.stream(s)` launches on s and is
    ordered behind nothing else.  Its inputs are written on s behind a
    short sleep of s, so a launch that s does not order reads them before
    they land; another stream sleeps far longer, so a launch ordered
    behind other streams' work (as one on the legacy default stream is
    where s blocks) is not done while that stream sleeps.  Work on s alone
    (no device-wide sync) makes the right output ready, after one launch."""
    if kernel == "residual":
        c = k1_case("cta_edges")
        host = [torch.from_numpy(c[k]) for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab",
                                                 "segment_ids", "luma_mode", "skipped",
                                                 "non_zero")]
        want = residual.residuals_sparse_plain(*host)
        call = residual.residuals_sparse
    else:
        host = [_bytes(5, 2, 33, 47, 4)]
        want = (L.subtract_green_plain_(host[0].clone()),)
        call = L.subtract_green_
    src = [t.to(cuda) for t in host]
    s, other = torch.cuda.Stream(), torch.cuda.Stream()
    # A first call loads the kernel's module and fills s's allocator blocks:
    # either may synchronize the device, which would hide a wrong stream.
    with torch.cuda.stream(s):
        dst = [torch.zeros_like(t) for t in src]
        call(*(t.clone() for t in src))
    torch.cuda.synchronize()
    before = _build.LAUNCHES[kernel]
    with torch.cuda.stream(other):
        torch.cuda._sleep(1_000_000_000)  # about half a second at the card's clock
    with torch.cuda.stream(s):
        torch.cuda._sleep(20_000_000)
        for d, t in zip(dst, src):
            d.copy_(t)
        got = call(*dst)
        got = [g.cpu() for g in (got if isinstance(got, tuple) else (got,))]  # ordered on s
    other_busy = not other.query()
    torch.cuda.synchronize()
    assert other_busy, "the launch waited for another stream's work"
    assert _build.LAUNCHES[kernel] == before + 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("out", ["rgb", "yuv"])
def test_slice_on_card_matches_scalar(cuda, payloads, out):
    _build.reset_launches()
    got = tdev.dispatch_decode_batch(payloads, out=out, device=cuda).cpu()
    want = dict.fromkeys(_build.LAUNCHES, 0)  # every other kernel (K2, K3 alone): no launch
    want.update(residual=1, recon_filter=1, yuv2rgb=int(out == "rgb"))
    assert _build.LAUNCHES == want
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0 if out == "rgb" else 1])


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
def test_random_streams_on_card_match_scalar(cuda, simple):
    ps = [random_keyframe(W, H, seed=50 + s, simple=simple, escapes=12)[0] for s in (1, 2)]
    for out in ("rgb", "yuv"):
        got = tdev.dispatch_decode_batch(ps, out=out, device=cuda).cpu()
        for i, p in enumerate(ps):
            np.testing.assert_array_equal(got[i].numpy(), scalar_decode(p)[0 if out == "rgb" else 1])


def test_mixed_geometry_and_dense_overflow_on_card(cuda, payloads):
    rng = np.random.RandomState(0)
    noisy = encode_frame(rng.randint(0, 256, (40, 72, 3)).astype(np.uint8), 100, 2)
    assert tdev.parse_levels_batch([noisy])["bitmap"] is None
    ps = [payloads[0]] + mixed_payloads(64, 48, seeds=(43,)) + [noisy]
    got = tdev.decode_vp8_batch_device_mixed(ps, device=cuda)
    for g, p in zip(got, ps):
        np.testing.assert_array_equal(g, scalar_decode(p)[0])


def test_more_mb_rows_than_wavefront_warps(cuda):
    """66 MB rows (more than the 32 warps of a one-block-per-image
    wavefront): one row CTA each, in one fused recon + filter launch."""
    ps = mixed_payloads(40, 1050, seeds=(44,))
    before = _build.LAUNCHES["recon_filter"]
    got = tdev.decode_vp8_batch_device(ps, device=cuda)
    assert _build.LAUNCHES["recon_filter"] == before + 1
    np.testing.assert_array_equal(got[0], scalar_decode(ps[0])[0])


def _row_kernels_vs_twins(cuda, inputs, mbw, mbh, simple):
    """K2, K3 and the fused kernel against their twins on `inputs` (CPU
    tensors), one launch each; the twins run on the CPU."""
    B = inputs[0].shape[0]

    def planes(device):
        return [torch.zeros((B, mbh * n, mbw * n), dtype=torch.uint8, device=device)
                for n in (16, 8, 8)]

    dev_in = [a.to(cuda) for a in inputs]
    before = {k: _build.LAUNCHES[k] for k in ("recon", "loopfilter", "recon_filter")}
    rec, rec_p = planes(cuda), planes("cpu")
    recon_(*rec, *dev_in[:4])
    recon_plain_(*rec_p, *inputs[:4])
    filt = [p.to(cuda) for p in rec_p]
    loop_filter_(*filt, *dev_in[4:], simple)
    fused = planes(cuda)
    recon_filter_(*fused, *dev_in, simple)
    want = [p.clone() for p in rec_p]
    loop_filter_plain_(*want, *inputs[4:], simple)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - n for k, n in before.items()} == {
        "recon": 1, "loopfilter": 1, "recon_filter": 1}
    for g, w in zip(rec, rec_p):
        assert torch.equal(g.cpu(), w), "recon"
    for g, w in zip(filt, want):
        assert torch.equal(g.cpu(), w), "loopfilter"
    for g, w in zip(fused, want):
        assert torch.equal(g.cpu(), w), "recon_filter"


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
@pytest.mark.parametrize("mbw,mbh", [(1, 1), (1, 6), (6, 1), (5, 3), (3, 40)],
                         ids=["1x1", "column", "row", "5x3", "40_rows"])
def test_row_kernels_match_plain(cuda, mbw, mbh, simple):
    """K2, K3 and K2 + K3 fused, bit-exact to the twins, at one MB, one MB
    column, one MB row and more MB rows than a block has warps, on seeded
    modes, residues and filter parameters with level-0 MBs."""
    _row_kernels_vs_twins(cuda, random_inputs(mbw, mbh, seed=mbw * 100 + mbh), mbw, mbh, simple)


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
def test_row_kernels_with_more_row_ctas_than_resident(cuda, simple):
    """A batch whose row CTAs (images x MB rows) outnumber those the card
    keeps resident for each instance: the row ticket hands rows out in
    height order, so no CTA waits on one that is not running."""
    resident = max(resident_rows(cuda, *kind) for kind in ((True, False), (False, True),
                                                          (True, True)))
    mbw, mbh = 2, 40
    batch = resident // mbh + 1
    _row_kernels_vs_twins(cuda, random_inputs(mbw, mbh, seed=77, batch=batch), mbw, mbh, simple)


def test_row_kernels_are_resident_on_every_sm(cuda):
    """Each instance keeps at least one row CTA on each of the card's SMs."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kind in ((True, False), (False, True), (True, True)):
        assert resident_rows(cuda, *kind) >= sms, kind


def test_wrappers_reject_bad_layouts(cuda):
    y, u, v = _planes(cuda)
    with pytest.raises(ValueError):
        fancy_yuv420_to_rgb(y.transpose(1, 2), u, v, 8, 8)
    with pytest.raises(ValueError):
        fancy_yuv420_to_rgb(y, u.to(torch.int32), v, 8, 8)


# ---- encode: K5 enc, K6 token_stats, K7 enc_tables, K8 analysis -----------


def _random_probs(seed: int, batch: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 256, (batch, 4, 8, 3, 11)).astype(np.uint8)


@pytest.fixture(scope="module")
def enc_planes():
    return edev.rgb_to_planes([synthetic_frame(W, H, s) for s in (1, 2)])


@pytest.mark.parametrize("tables", ["default", "random"])
@pytest.mark.parametrize("n_try", [0, 3])
def test_enc_kernel_matches_plain(cuda, enc_planes, tables, n_try):
    probs = T.COEFF_PROBS_DEFAULT if tables == "default" else _random_probs(9, 2)
    P = EncParams.from_segment(SegmentParams(quality_to_quant_index(75)))
    want = encode_analysis_batch_plain(*edev.upload(enc_planes, "cpu"), P,
                                       EncTables.from_probs(probs), n_try)
    before = _build.LAUNCHES["enc"]
    got = encode_analysis_batch(*edev.upload(enc_planes, cuda),
                                EncParams.from_segment(SegmentParams(quality_to_quant_index(75)),
                                                       cuda),
                                EncTables.from_probs(probs, cuda), n_try)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["enc"] == before + 1
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


def test_token_stats_kernel_matches_plain(cuda):
    rng = np.random.RandomState(11)
    B, mbw, mbh = 3, 5, 4
    nmb = mbw * mbh
    mags = rng.choice([0, 0, 0, 0, 1, 1, 2, 3, 5, 9, 40, 66, 67, 68, 300, 2047, 2100],
                      size=(B, nmb, 25, 16))
    lv = (mags * rng.choice([-1, 1], size=mags.shape)).astype(np.int16)
    lv[rng.rand(B, nmb) < 0.2] = 0
    lm = rng.choice([0, 1, 2, 3, 4], size=(B, nmb)).astype(np.uint8)
    arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in (lm, lv[:, :, 0], lv[:, :, 1:17],
                                                                   lv[:, :, 17:])]
    arrays[1][torch.from_numpy(lm == 4)] = 0
    skipped = edev.skip_flags(dict(y2_levels=arrays[1], y_levels=arrays[2], uv_levels=arrays[3]))
    want = token_stats_plain(*arrays, skipped, mbw, mbh)
    before = _build.LAUNCHES["token_stats"]
    got = token_stats(*(a.to(cuda) for a in arrays), skipped.to(cuda), mbw, mbh)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["token_stats"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("batch", [3, 1, 8, 64])
def test_enc_tables_kernel_matches_plain(cuda, batch):
    """K7 (a CTA per (image, type)) against its twin, at the main path's
    batches 8 and 64 too."""
    probs = torch.from_numpy(_random_probs(5, batch))
    want = enc_tables_plain(probs)
    before = _build.LAUNCHES["enc_tables"]
    got = enc_tables(probs.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["enc_tables"] == before + 1
    for f in EncTables.FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("method,two_pass", [(1, True), (3, True), (3, False)])
def test_encode_slice_on_card_matches_cpu(cuda, method, two_pass):
    rgbs = [synthetic_frame(W, H, s) for s in (3, 4)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, method, two_pass,
                                                    num_partitions=8, device="cpu")
    _build.reset_launches()
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, method, two_pass,
                                                   num_partitions=8, device=cuda)
    assert (_build.LAUNCHES["enc"], _build.LAUNCHES["token_stats"],
            _build.LAUNCHES["enc_tables"]) == ((2, 1, 1) if two_pass else (1, 0, 0))
    assert got == want


def test_encode_more_mb_rows_than_wavefront_warps(cuda):
    """40 MB rows: each of the block's 32 warps walks several rows per step."""
    rgbs = [synthetic_frame(40, 630, 6)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 3, device="cpu")
    assert webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 3, device=cuda) == want


@pytest.mark.parametrize("width,height", [(72, 40), (256, 256), (40, 630)])
def test_analysis_kernel_matches_plain(cuda, width, height):
    planes = edev.rgb_to_planes([synthetic_frame(width, height, s) for s in (1, 2, 3)])
    want = analyze_alphas_batch_plain(*edev.upload(planes, "cpu"))
    before = _build.LAUNCHES["analysis"]
    got = analyze_alphas_batch(*edev.upload(planes, cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["analysis"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# K8 and K6 as row-run CTAs (tests/stats_inputs.py): (planes or level
# arrays, batch, mbw, mbh, MBs a CTA (None: the wrapper's)[, rows a scan
# chunk]).
ANALYSIS_ROWS = {"b64_768x512": ("synthetic", 64, 48, 32, None),
                 "one_mb_column": ("mixed", 8, 1, 32, None), "one_mb": ("noise", 8, 1, 1, None),
                 "flat_runs_64": ("flat", 8, 48, 32, 64), "noise_runs": ("noise", 3, 13, 3, 5),
                 "b8_768x512_runs": ("mixed", 8, 48, 32, 7)}


@pytest.mark.parametrize("case", list(ANALYSIS_ROWS))
def test_analysis_rows_kernel_matches_plain(cuda, case):
    from stats_inputs import planes

    kind, batch, mbw, mbh, seg = ANALYSIS_ROWS[case]
    if kind == "synthetic":
        frames = [synthetic_frame(mbw * 16, mbh * 16, s) for s in (11, 12)]
        yuv = edev.rgb_to_planes([frames[i % 2] for i in range(batch)])
    else:
        yuv = planes(kind, batch, mbw, mbh, seed=batch + mbw)
    y, u, v = edev.upload(yuv, cuda)
    want = analyze_alphas_batch_plain(y, u, v)
    before = _build.LAUNCHES["analysis"]
    from webp_tpu_torch.ops import analysis

    for _ in range(2):  # the kept-zeroed sums and tickets serve the next call too
        got = (analyze_alphas_batch(y, u, v) if seg is None
               else analysis._analysis_kernel(y, u, v, seg))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert _build.LAUNCHES["analysis"] == before + 2


TOKEN_ROWS = {"b64_768x512": (64, 48, 32, {}, None, None),
              "one_mb_column": (8, 1, 32, {}, None, None),
              "all_b_runs_64": (8, 48, 32, {"all_b": True}, 64, 8),
              "mostly_b_runs_chunks": (4, 48, 32, {"b_share": 0.9}, 5, 3),
              "all_skipped": (4, 48, 32, {"skip_all": True}, None, None),
              "unclipped_runs": (3, 13, 9, {"clip": False}, 4, 2)}


@pytest.mark.parametrize("case", list(TOKEN_ROWS))
def test_token_stats_rows_kernel_matches_plain(cuda, case):
    """K6 with the skip flags given and derived, twice (its kept-zeroed
    counters serve the next call), against the twin on the same card
    tensors; on one case also against the host C++ statistics."""
    from stats_inputs import level_arrays
    from webp_tpu_torch.ops import token_stats as K6

    batch, mbw, mbh, opts, seg, chunk = TOKEN_ROWS[case]
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in level_arrays(batch, mbw, mbh, seed=batch + mbh, **opts).items()}
    lv = (a["luma_mode"], a["y2_levels"], a["y_levels"], a["uv_levels"])
    skipped = K6.skip_flags(*lv[1:])
    want = token_stats_plain(*lv, skipped, mbw, mbh)
    before = _build.LAUNCHES["token_stats"]
    shape = () if seg is None else (seg, chunk)
    for given in (skipped, None, skipped):
        got = K6._token_stats_kernel(*lv, given, mbw, mbh, *shape)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if seg is None:
        for got in (token_stats(*lv, skipped, mbw, mbh), K6.token_stats_levels(*lv, mbw, mbh)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert _build.LAUNCHES["token_stats"] == before + 3 + 2 * (seg is None)
    if case == "b64_768x512":
        from webp_tpu_torch.encode.contexts import compute_contexts
        from webp_tpu_torch.encode import vp8 as tvp8

        for i in range(2):
            h = {k: t[i].cpu().numpy().astype(np.int32) for k, t in a.items()}
            ctx = compute_contexts(h["luma_mode"], h["y2_levels"], h["y_levels"], h["uv_levels"],
                                   mbw, mbh)
            levels, meta = tvp8.token_stream(h, ctx, tvp8.skip_flags(h), mbw)
            for g, host in zip(want, native.vp8_token_stats(levels, meta)):
                assert (g[i].cpu().numpy() == host).all()


@pytest.mark.parametrize("n_try,trellis,segments", [(3, False, True), (4, True, True),
                                                     (10, True, False), (0, True, True)])
def test_enc_kernel_trellis_segments_match_plain(cuda, enc_planes, n_try, trellis, segments):
    """K5 with per-MB segment parameters (seeded ids, four qualities per
    image) and the trellis, per-image random tables."""
    probs = _random_probs(13, 2)
    if segments:
        lists = [[SegmentParams(quality_to_quant_index(q)) for q in qs]
                 for qs in ((30, 50, 75, 90), (20, 60, 80, 95))]
        sid = torch.from_numpy(np.random.RandomState(7).randint(0, 4, (2, MBW * MBH)).astype(np.uint8))
    else:
        lists, sid = [[SegmentParams(quality_to_quant_index(75))] * 4], None
    want = encode_analysis_batch_plain(*edev.upload(enc_planes, "cpu"), EncParams.from_segments(lists),
                                       EncTables.from_probs(probs), n_try, trellis, sid)
    before = _build.LAUNCHES["enc"]
    got = encode_analysis_batch(*edev.upload(enc_planes, cuda), EncParams.from_segments(lists, cuda),
                                EncTables.from_probs(probs, cuda), n_try, trellis,
                                None if sid is None else sid.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["enc"] == before + 1
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_flagship_slice_on_card_matches_cpu(cuda, two_pass):
    """Q75 m4 with segments on (256 MBs), 8 partitions: K8, K5 (trellis and
    segment ids), K6, K7 on the card, byte-equal to the plain CPU encode."""
    rgbs = [synthetic_frame(256, 256, s) for s in (11, 12)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 4, two_pass, True,
                                                    num_partitions=8, device="cpu")
    _build.reset_launches()
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 4, two_pass, True,
                                                   num_partitions=8, device=cuda)
    assert (_build.LAUNCHES["analysis"], _build.LAUNCHES["enc"], _build.LAUNCHES["token_stats"],
            _build.LAUNCHES["enc_tables"]) == ((1, 2, 1, 1) if two_pass else (1, 1, 0, 0))
    assert got == want


def test_trellis_more_mb_rows_than_wavefront_warps(cuda):
    """40 MB rows at method 4: the trellis's cross-MB nnz contexts pass
    between warps that each walk several rows per step."""
    rgbs = [synthetic_frame(40, 630, 6)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 4, device="cpu")
    assert webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 4, device=cuda) == want


@pytest.mark.parametrize("geometry", ["more_rows_than_resident", "one_mb_column", "one_mb_row"])
@pytest.mark.parametrize("n_try,trellis", [(3, False), (4, True), (10, True)],
                         ids=["pass1", "pass2", "pass2_n_try10"])
def test_enc_kernel_geometries_match_plain(cuda, geometry, n_try, trellis):
    """K5's row CTAs where the card cannot hold them all at once (more
    images of 32 MB rows than the occupancy API's resident CTAs), at mbw = 1
    and at mbh = 1, against the twin; segment ids and per-image tables."""
    if geometry == "more_rows_than_resident":
        resident = ew.resident_rows(trellis, cuda)
        w, h, B = 32, 512, resident // 32 + 2
        assert B * (h // 16) > resident
    else:
        (w, h), B = ((16, 320) if geometry == "one_mb_column" else (320, 16)), 3
    rgbs = [synthetic_frame(w, h, 20 + i) for i in range(B)]
    planes = edev.rgb_to_planes(rgbs)
    nmb = (w // 16) * (h // 16)
    probs = _random_probs(17, B)
    lists = [[SegmentParams(quality_to_quant_index(q + 5 * i)) for q in (30, 50, 70, 85)]
             for i in range(B)]
    sid = torch.from_numpy(np.random.RandomState(5).randint(0, 4, (B, nmb)).astype(np.uint8))
    want = encode_analysis_batch_plain(*edev.upload(planes, "cpu"), EncParams.from_segments(lists),
                                       EncTables.from_probs(probs), n_try, trellis, sid)
    got = encode_analysis_batch(*edev.upload(planes, cuda), EncParams.from_segments(lists, cuda),
                                EncTables.from_probs(probs, cuda), n_try, trellis, sid.to(cuda))
    torch.cuda.synchronize()
    assert (want["luma_mode"] == 4).any() and (want["luma_mode"] != 4).any()
    for k, w_ in want.items():
        assert torch.equal(got[k].cpu(), w_), k


# ---- lossless: K9 subtract_green, K10 color_transform, K11 color_indexing, K12 predictor


def _bytes(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8))


@pytest.mark.parametrize("kernel,param", [("subtract_green", 0), ("color_transform", 2),
                                          ("color_transform", 3), ("color_transform", 5),
                                          ("color_indexing", 2), ("color_indexing", 4),
                                          ("color_indexing", 11), ("color_indexing", 17),
                                          ("color_indexing", 250)])
def test_vp8l_pointwise_kernels_match_plain(cuda, kernel, param):
    before = _build.LAUNCHES[kernel]
    if kernel == "subtract_green":
        px = _bytes(0, 3, 13, 17, 4)
        want = L.subtract_green_plain_(px.clone())
        got = L.subtract_green_(px.to(cuda))
    elif kernel == "color_transform":
        px = _bytes(1, 2, 21, 37, 4)
        tf = _bytes(2, 2, L.subsample(21, param), L.subsample(37, param), 4)
        want = L.color_transform_plain_(px.clone(), tf, param)
        got = L.color_transform_(px.to(cuda), tf.to(cuda), param)
    else:  # indices past table_size read the zero padding
        px = _bytes(3, 2, 9, L.subsample(29, L.pack_bits(param)), 4)
        table = torch.zeros((2, 256, 4), dtype=torch.uint8)
        table[:, :param] = _bytes(4, 2, param, 4)
        want = L.color_indexing_plain(px, table, param, 29)
        got = L.color_indexing(px.to(cuda), table.to(cuda), param, 29)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("width", [4, 8, 29, 767, 768])
@pytest.mark.parametrize("table_size", [2, 4, 11, 250])
def test_vp8l_color_indexing_widths(cuda, table_size, width, batch):
    """K11 at every packing: rows that start on 16 bytes (widths 4, 8, 768)
    and rows that do not (29, 767: heads and tails of 4-byte stores, packed
    words read 4 bytes at a time), 768 the main path's width, a run of rows
    a CTA (h = 37 is 4 runs at width 29, one run per row at 767-768 is 8
    rows); indices past the table read the zero padding."""
    h = 37
    px = _bytes(5, batch, h, L.subsample(width, L.pack_bits(table_size)), 4)
    table = torch.zeros((batch, 256, 4), dtype=torch.uint8)
    table[:, :table_size] = _bytes(6, batch, table_size, 4)
    before = _build.LAUNCHES["color_indexing"]
    got = L.color_indexing(px.to(cuda), table.to(cuda), table_size, width)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["color_indexing"] == before + 1
    assert torch.equal(got.cpu(), L.color_indexing_plain(px, table, table_size, width))


@pytest.mark.parametrize("size_bits,h,w,n_modes,batch",
                         [(2, 8, 8, 14, 2), (2, 13, 29, 14, 2), (3, 17, 40, 14, 2),
                          (4, 31, 65, 14, 2), (2, 1, 7, 14, 2), (2, 5, 1, 14, 2),
                          (3, 20, 33, 16, 2), (9, 40, 70, 14, 2), (2, 1500, 5, 14, 1),
                          (2, 300, 2100, 14, 1), (2, 512, 768, 14, 8), (2, 512, 768, 14, 1),
                          (2, 5, 16384, 16, 1), (2, 4096, 1, 14, 1), (2, 4096, 4, 14, 2),
                          (2, 512, 384, 14, 8)])
def test_vp8l_predictor_kernel_matches_plain(cuda, size_bits, h, w, n_modes, batch):
    """Modes 14 and 15 (n_modes 16) add zero; h = 1500 stacks 12 CTAs of 128
    rows and w = 2100 and 16,384 turn the shared rings many times; w = 1
    and 4 at h = 4096 make the chain almost all band hand-overs (32 CTAs an
    image); 768x512 at batch 8 and 1 is the main path's shape, 384 wide its
    packed palette width."""
    px = _bytes(5, batch, h, w, 4)
    modes = torch.from_numpy(np.random.RandomState(6).randint(
        0, n_modes, (batch, L.subsample(h, size_bits), L.subsample(w, size_bits))).astype(np.uint8))
    want = L.inverse_predictor_plain_(px.clone(), modes, size_bits)
    before = _build.LAUNCHES["predictor"]
    got = L.inverse_predictor_(px.to(cuda), modes.to(cuda), size_bits)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["predictor"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_vp8l_predictor_kernel_on_packed_palette_image(cuda):
    """K12 on the entropy pass's own residuals of a 12-colour 96x80 image
    coded as [palette, predictor 2]: the predictor runs on the packed width
    (two indices a byte, 48 pixels), 1 CTA an image; and on the same image
    at 200 rows (2 CTAs)."""
    from webp_tpu_torch.decode import vp8l_device as ldev

    for width, height in ((96, 80), (96, 200)):
        src = quantize(with_alpha(synthetic_frame(width, height, 7), 7), 12, 7)
        stream = vp8l_stream(src, 7, (PALETTE, predictor(2)))
        results = ldev.entropy_batch([stream, stream], width, height)
        sig = ldev.signature(results[0][1], results[0][0].shape[1])
        params = ldev.stack_params(results, [0, 1], sig, height)
        (ttype, size_bits, _), modes = sig[1], params[1]
        assert ttype == 0 and results[0][0].shape[1] == width // 2
        px = torch.from_numpy(np.stack([r[0] for r in results]))
        want = L.inverse_predictor_plain_(px.clone(), torch.from_numpy(modes), size_bits)
        got = L.inverse_predictor_(px.to(cuda), torch.from_numpy(modes).to(cuda), size_bits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


_LOSSLESS = {
    "sg_pred_ct": ((SUBTRACT_GREEN, predictor(2), color(3)), lambda s: with_alpha(
        synthetic_frame(61, 37, s), s), {"subtract_green": 1, "color_transform": 1,
                                         "predictor": 1}),
    "ct_pred": ((color(2), predictor(3)), lambda s: with_alpha(synthetic_frame(61, 37, s), s),
                {"color_transform": 1, "predictor": 1}),
    "pal11_pred": ((PALETTE, predictor(2)), lambda s: quantize(
        with_alpha(synthetic_frame(61, 37, s), s), 11, s), {"color_indexing": 1, "predictor": 1}),
    "pal200": ((PALETTE,), lambda s: _bytes(s, 200, 4)[torch.from_numpy(
        np.random.RandomState(s).randint(0, 200, (37, 61)))].numpy(), {"color_indexing": 1}),
}


@pytest.mark.parametrize("name", list(_LOSSLESS))
def test_vp8l_slice_on_card_matches_host(cuda, name):
    transforms, make, launched = _LOSSLESS[name]
    sources = [make(s) for s in (31, 32)]
    streams = [vp8l_stream(src, s, transforms) for s, src in zip((1, 2), sources)]
    _build.reset_launches()
    got = webp_tpu_torch.decode_lossless_batch_device(streams, 61, 37, device=cuda)
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == launched
    for g, stream, src in zip(got, streams, sources):
        np.testing.assert_array_equal(g, src)
        np.testing.assert_array_equal(native.vp8l_decode(stream, 61, 37), src)


def test_vp8l_mixed_batch_and_device_out_on_card(cuda):
    sources = [make(31) for _, make, _ in _LOSSLESS.values()]
    streams = [vp8l_stream(src, 3, t) for (t, _, _), src in zip(_LOSSLESS.values(), sources)]
    got = webp_tpu_torch.decode_lossless_batch_device(streams + streams[:1], 61, 37, device=cuda,
                                                      device_out=True)
    assert isinstance(got, np.ndarray)  # four signatures: delivered on the host
    for g, src in zip(got, sources + sources[:1]):
        np.testing.assert_array_equal(g, src)
    one = webp_tpu_torch.decode_lossless_batch_device(streams[:1] * 3, 61, 37, device=cuda,
                                                      device_out=True)
    assert one.device.type == "cuda" and one.shape == (3, 37, 61, 4)
    for g in one.cpu().numpy():
        np.testing.assert_array_equal(g, sources[0])


def test_vp8l_wrappers_reject_bad_layouts(cuda):
    buf = torch.zeros(4 * 8 * 4 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # not 4-byte aligned
        L.subtract_green_(buf[1:].view(1, 4, 8, 4))
    px = torch.zeros((1, 4, 8, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        L.inverse_predictor_(px, torch.zeros((1, 1, 1), dtype=torch.uint8, device=cuda), 2)
    with pytest.raises(ValueError):
        L.color_indexing(px, torch.zeros((1, 256, 4), dtype=torch.int32, device=cuda), 200, 8)


# ---- device token coder: K13 coeff_tokens, K14 mb_headers, K15 bool_lanes --


def _same_lanes(got, want):
    """Every field, and the bytes (both cut to the largest count, zero past
    each lane's)."""
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _coeff_inputs(B: int, mbw: int, mbh: int, seed: int):
    arrays = [torch.from_numpy(a) for a in token_arrays(B, mbw, mbh, seed)]
    probs = torch.from_numpy(np.random.RandomState(seed).randint(1, 256, (B, 1056))
                             .astype(np.uint8))
    return arrays + [probs]


@pytest.mark.parametrize("B,mbw,mbh,nparts", [(2, 6, 5, 8), (2, 6, 5, 1), (3, 5, 4, 2),
                                              (1, 16, 16, 8)])
def test_coeff_tokens_kernel_matches_plain(cuda, B, mbw, mbh, nparts):
    """At 6x5 MBs and 8 partitions, three lanes per image are empty.  The
    seeded levels are denser than an encode's: the capacity is ample."""
    inputs = _coeff_inputs(B, mbw, mbh, mbw + nparts)
    want = token_ops.encode_coeff_partitions(*inputs, mbw, mbh, nparts, capacity=1 << 16)
    before = _build.LAUNCHES["coeff_tokens"]
    got = token_ops.encode_coeff_partitions(*(a.to(cuda) for a in inputs), mbw, mbh, nparts,
                                            capacity=1 << 16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["coeff_tokens"] == before + 1
    _same_lanes(got, want)


def _header_args(B: int, mbw: int, mbh: int, write_segments: bool):
    lm, bp, cm, sid, sk, seg_probs, skip_prob = header_inputs(B, mbw, mbh, 17)
    encs = prefix_coders(B, 9)
    state = [[getattr(e, k) for e in encs] for k in ("bottom", "range", "bit_num")]
    params = token_ops.header_params([write_segments] * B, seg_probs, skip_prob, state, "cpu")
    return [torch.from_numpy(a) for a in (lm, bp, cm, sid, sk)] + [params], (mbw, mbh)


@pytest.mark.parametrize("case", ["segment_map", "no_map", "48x32_b1", "48x32_b8", "all_b"])
def test_mb_headers_kernel_matches_plain(cuda, case):
    """Three 7x5-MB images with the segment map written and not; K14's CTA
    (count, scan, write, then one coder warp) at the flagship's geometry,
    48x32 MBs, batch 1 and 8; and a frame whose every MB is in B mode at
    the longest paths with the segment map: 119 ops an MB, 182,784 in all.
    Where the default byte capacity overflows, the wrapper launches once
    more."""
    if case in ("segment_map", "no_map"):
        modes, args = _header_args(3, 7, 5, case == "segment_map")
    else:
        modes, args = _header_args(8 if case == "48x32_b8" else 1, 48, 32, case != "48x32_b8")
    if case == "all_b":
        lm, bp, cm = modes[:3]
        modes[:3] = [torch.full_like(lm, 4), 8 + bp % 2, 2 + cm % 2]
    want = token_ops.encode_mb_headers(*modes, *args)
    launches = 1 + int(int(want.n_bytes.max()) > token_ops.header_budget(args[0] * args[1]))
    before = _build.LAUNCHES["mb_headers"]
    got = token_ops.encode_mb_headers(*(a.to(cuda) for a in modes), *args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mb_headers"] == before + launches
    _same_lanes(got, want)
    if case == "all_b":
        assert int(want.n_ops[0]) == 48 * 32 * 119 >= 180_000


@pytest.mark.parametrize("init", ["fresh", "continued"])
@pytest.mark.parametrize("case", ["carries", "random", "steered"])
def test_bool_lanes_kernel_matches_plain(cuda, case, init):
    """"steered": streams that carry through 0xFF runs and, continued, past
    the lane's first byte (`token_inputs.carry_stream`)."""
    rng = np.random.RandomState(3)
    streams = CARRY_PATTERNS if case == "carries" else [
        (rng.randint(0, 2, n), rng.randint(1, 256, n)) for n in rng.randint(1, 4000, 9)]
    T, n_lanes = max(len(b) for b, _ in streams), len(streams)
    bits, probs, valid = (np.zeros((T, n_lanes), np.uint8) for _ in range(3))
    for lane, (b, p) in enumerate(streams):
        bits[:len(b), lane], probs[:len(p), lane], valid[:len(b), lane] = b, p, 1
    state = None
    if init == "continued":
        state = [torch.tensor([getattr(e, k) for e in prefix_coders(n_lanes, 5)])
                 for k in ("bottom", "range", "bit_num")]
    if case == "steered":
        bits, probs, valid, st = steered_lanes(6, 20, init == "continued")
        state = [torch.tensor(x) for x in st]
    host = [torch.from_numpy(a) for a in (bits, probs, valid)]
    want = boolenc2.bool_encode_lanes(*host, 4096, state)
    before = _build.LAUNCHES["bool_lanes"]
    got = boolenc2.bool_encode_lanes(*(a.to(cuda) for a in host), 4096, state)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bool_lanes"] == before + 1
    _same_lanes(got, want)


def _dense_levels(mbw: int, mbh: int, seed: int):
    """Every level at +-2048 (chroma +-2047), luma modes alternating B and
    whole-MB: the most ops an MB can take, about 7.3K."""
    rng = np.random.RandomState(seed)
    nmb = mbw * mbh
    lm = np.where(np.arange(nmb) % 2 == 0, 0, 4)[None].astype(np.uint8)
    y2 = (2048 * rng.choice([-1, 1], (1, nmb, 16))).astype(np.int16)
    y2[lm == 4] = 0
    y = (2048 * rng.choice([-1, 1], (1, nmb, 16, 16))).astype(np.int16)
    uv = (2047 * rng.choice([-1, 1], (1, nmb, 8, 16))).astype(np.int16)
    probs = rng.randint(1, 256, (1, 1056)).astype(np.uint8)
    return [torch.from_numpy(a) for a in (lm, y2, y, uv, probs)]


@pytest.mark.parametrize("case", ["48x32_b1", "48x32_b8", "fewer_rows_than_parts", "dense",
                                  "all_skipped"])
def test_coeff_tokens_ring_kernel_matches_plain(cuda, case):
    """K13's producer warps and coder warp at the flagship's geometry (48x32
    MBs, 8 partitions, batch 1 and 8), at mbh < P (empty lanes), on MBs
    with every level at +-2048 (more ops than K13's ring; the default
    capacity overflows, so the wrapper launches twice), and on an image
    with no nonzero level."""
    launches, capacity = 1, None
    if case.startswith("48x32"):  # denser than an encode's levels: an ample capacity
        B = int(case[-1])
        mbw, mbh, nparts = 48, 32, 8
        inputs = _coeff_inputs(B, mbw, mbh, 48 + B)
        capacity = 1 << 16
    elif case == "fewer_rows_than_parts":
        mbw, mbh, nparts = 5, 3, 8
        inputs = _coeff_inputs(2, mbw, mbh, 11)
    else:
        mbw, mbh, nparts = 2, 2, 1
        inputs = _dense_levels(mbw, mbh, 12)
        launches = 2
        if case == "all_skipped":
            inputs = [torch.zeros_like(a) for a in inputs[:4]] + inputs[4:]
            launches = 1
    want = token_ops.encode_coeff_partitions(*inputs, mbw, mbh, nparts, capacity)
    before = _build.LAUNCHES["coeff_tokens"]
    got = token_ops.encode_coeff_partitions(*(a.to(cuda) for a in inputs), mbw, mbh, nparts,
                                            capacity)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["coeff_tokens"] == before + launches
    _same_lanes(got, want)
    if case == "dense":
        assert int(want.n_ops.max()) > token_ops.RING
    if case == "all_skipped":
        assert int(want.n_ops.sum()) == 0


def test_coder_chain_matches_plain(cuda):
    """`webp_coder_chain`, the coder step's latency probe, codes two passes
    over its ring of seeded ops as the scalar twin does."""
    rng = np.random.RandomState(8)
    ops = (rng.randint(1, 256, token_ops.RING) | rng.randint(0, 2, token_ops.RING) << 8)
    lib = _build.load()
    assert lib.webp_coeff_tokens_ring() == token_ops.RING
    cap = 1 << 14
    data = torch.zeros(cap, dtype=torch.uint8, device=cuda)
    carries = torch.empty(boolenc2.carry_words(cap), dtype=torch.int32, device=cuda)
    info = torch.empty(6, dtype=torch.int64, device=cuda)
    dev_ops = torch.from_numpy(ops.astype(np.int16)).to(cuda)
    rc = lib.webp_coder_chain(dev_ops.data_ptr(), 2, cap, data.data_ptr(), carries.data_ptr(),
                              info.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    both = np.concatenate([ops, ops])
    want = boolenc2.lane_coder_plain(torch.from_numpy(both >> 8)[:, None],
                                     torch.from_numpy(both & 0xFF)[:, None],
                                     torch.ones((len(both), 1), dtype=torch.int64), cap)
    _same_lanes(boolenc2.Lanes.from_fields(info[None], data[None]), want)


def test_token_kernels_relaunch_on_overflow(cuda):
    """A 16-byte capacity: each wrapper launches twice, the second time at
    the largest reported count, and gives the plain twin's result."""
    inputs = _coeff_inputs(2, 6, 5, 3)
    modes, args = _header_args(2, 6, 5, True)
    before = dict(_build.LAUNCHES)
    got = token_ops.encode_coeff_partitions(*(a.to(cuda) for a in inputs), 6, 5, 2, capacity=16)
    got_h = token_ops.encode_mb_headers(*(a.to(cuda) for a in modes), *args, capacity=16)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["coeff_tokens"] == before["coeff_tokens"] + 2
    assert _build.LAUNCHES["mb_headers"] == before["mb_headers"] + 2
    _same_lanes(got, token_ops.encode_coeff_partitions(*inputs, 6, 5, 2))
    _same_lanes(got_h, token_ops.encode_mb_headers(*modes, *args))


@pytest.mark.parametrize("method,segments,size", [(3, False, (72, 40)), (4, True, (256, 256))],
                         ids=["m3", "m4_segments"])
def test_device_tokens_slice_on_card_matches_cpu(cuda, method, segments, size):
    """The device-token flow on the card (K13 and K14 once each) gives the
    payloads of the host finisher on the CPU."""
    rgbs = [synthetic_frame(*size, s) for s in (11, 12)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, method, True, segments,
                                                    num_partitions=8, device="cpu")
    _build.reset_launches()
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, method, True, segments,
                                                   num_partitions=8, device=cuda,
                                                   device_tokens=True)
    assert (_build.LAUNCHES["coeff_tokens"], _build.LAUNCHES["mb_headers"],
            _build.LAUNCHES["bool_lanes"]) == (1, 1, 0)
    assert got == want


# ---- scale-out: K16 recon_banded, K17 filter_banded


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
def test_banded_kernels_match_unbanded_and_plain(cuda, simple):
    """64x256 random keyframes (16 MB rows) at every band count that divides
    them, and 64x1280 ones (80 MB rows) at 1 and 2 bands, whose bands hold
    more rows than a CTA has row pipelines (`BandShape.pipelines`): planes
    byte-equal to the fused K2 + K3's, one K16 and one K17 launch per call;
    64x256 at 4 bands also equal to the twins on CPU copies."""
    for width, height, bands in ((64, 256, (1, 2, 4, 8)), (64, 1280, (1, 2))):
        payloads = [random_keyframe(width, height, s, simple=simple)[0] for s in (51, 52)]
        d = tdev.to_device_batch(tdev.parse_levels_batch(payloads), cuda)
        mbw, mbh = tdev.geometry(d["headers"])[:2]
        args = tdev.wavefront_inputs(d)
        want = tdev.split_planes(tdev.decode_core(d, "yuv"), mbw, mbh)
        for n_band in bands:
            if height == 1280:
                assert banded.max_active_clusters(n_band, mbh).pipelines < mbh // n_band
            before = (_build.LAUNCHES["recon_banded"], _build.LAUNCHES["filter_banded"])
            got = parallel.decode_wavefront_banded(
                *args, parallel.make_mesh(n_band=n_band, device=cuda), mbw, mbh, simple)
            torch.cuda.synchronize()
            assert (_build.LAUNCHES["recon_banded"], _build.LAUNCHES["filter_banded"]) == (
                before[0] + 1, before[1] + 1)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (height, n_band)
        if height == 256:
            twin = parallel.decode_wavefront_banded(*(a.cpu() for a in args),
                                                    parallel.make_mesh(n_band=4, device="cpu"),
                                                    mbw, mbh, simple)
            for g, w in zip(twin, want):
                assert torch.equal(g, w.cpu())


def test_banded_clusters_fit_on_the_card(cuda):
    """At 768x512 (32 MB rows) a band's CTA runs min(rows, 24) row pipelines
    of one warp, with their counters and tiles in shared memory, and the
    card holds clusters of every band count, 8 CTAs included."""
    for n_band in (1, 2, 4, 8):
        shape = banded.max_active_clusters(n_band, 32)
        assert shape.pipelines == min(32 // n_band, 24)
        assert shape.smem_bytes > 0
        assert min(shape.recon_clusters, shape.filter_clusters) >= 1


@pytest.mark.parametrize("B,nmb", [(5, 64), (5, 200), (1, 1), (3, 7), (1, 1536), (3, 1536),
                                   (3, 45_000)],
                         ids=["64x256", "200_mbs", "1_mb", "7_mbs", "1536_mbs", "3x1536_mbs",
                              "3x45000_mbs"])
def test_wire_kernels_match_plain(cuda, B, nmb):
    """K18, K19, the fused K18 + K19 and K20 against their twins on seeded
    pass-2 arrays (`wire_inputs.py`) that set every flag: an MB over CAP_MB
    nonzeros, over MED_CAP med entries, over N_ESC escapes, and (at 200
    MBs) an image over ESC_IMG; one launch each; K19 also at cap 100; K18
    and the fused kernel also on a bpred view that is not 16-byte aligned
    (the byte loads); `fetch_packed` returns the arrays exactly.  K20 (a
    CTA per 32 MBs and a list CTA an image) also with each MB's
    escape slots permuted (holes between live ones), at batch 1 and 3
    (rows that start off 16 bytes), and leaves its scratch zero."""
    arrays, lv, flags = wire_arrays(B, nmb, 12)
    cpu = {k: torch.from_numpy(a) for k, a in arrays.items()}
    dev = {k: t.to(cuda) for k, t in cpu.items()}
    names = ("prepack", "pack_levels", "prepack_pack", "wire")
    before = {k: _build.LAUNCHES[k] for k in names}
    pre = wire.prepack(dev)
    packed = pack_levels_mb(pre[0], wire.CAP_MB)
    fused = wire.prepack_pack(dev)
    rows = wire.wire(*packed, *pre[1:])
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - n for k, n in before.items()} == dict.fromkeys(names, 1)
    pre_p = wire.prepack_plain(cpu)
    packed_p = pack_levels_mb_plain(pre_p[0], wire.CAP_MB)
    for g, w in zip((*pre, *packed), (*pre_p, *packed_p)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for g, w in zip(fused, wire.prepack_pack_plain(cpu)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(rows.cpu(), wire.wire_plain(*packed_p, *pre_p[1:]))
    assert (rows[:, :2].cpu().numpy() == flags).all()
    for g, w in zip(pack_levels_mb(pre[0], 100), pack_levels_mb_plain(pre_p[0], 100)):
        assert torch.equal(g.cpu(), w)
    perm = torch.argsort(torch.rand(pre_p[2].shape, generator=torch.Generator().manual_seed(nmb)),
                         -1)
    holes = [t.gather(-1, perm) for t in pre_p[2:4]]
    rows_h = wire.wire(*packed, pre[1], *(t.to(cuda) for t in holes), pre[4])
    assert torch.equal(rows_h.cpu(), wire.wire_plain(*packed_p, pre_p[1], *holes, pre_p[4]))
    assert not _build.kept_zeroed("wire", B, torch.int64, cuda).any()
    buf = torch.zeros((B, nmb * 16 + 16), dtype=torch.uint8, device=cuda)
    bpred = buf[:, 3:3 + nmb * 16].view(B, nmb, 16)  # 3 bytes past an aligned start
    bpred.copy_(dev["bpred"])
    assert bpred.data_ptr() % 16 == 3
    unaligned = dict(dev, bpred=bpred)
    for g, w in zip((*wire.prepack(unaligned), *wire.prepack_pack(unaligned)),
                    (*pre_p, *wire.prepack_pack_plain(cpu))):
        assert torch.equal(g.cpu(), w)
    want = edev.fetch(dev)
    for got in (edev.fetch_packed(pre[0], rows, dev),
                edev.fetch_packed(pre[0][:3], rows[:3], {k: t[:3] for k, t in dev.items()})):
        for i, g in enumerate(got):
            for k in want[i]:
                assert (g[k] == want[i][k]).all(), k


def test_wire_kernel_escapes_past_2_24(cuda):
    """45,000 MBs (positions up to 18e6 > 2^24): K20's image list equals the
    twin's integer list, and the row unpacks to the levels on the host."""
    nmb = 45_000
    rng = np.random.RandomState(13)
    lv = np.zeros((1, nmb, 400), np.int16)
    for m in np.concatenate([rng.choice(nmb, 30, replace=False), np.arange(nmb - 9, nmb)]):
        lv[0, m, rng.choice(400, rng.randint(1, 5), replace=False)] = rng.choice([-1, 1]) * 999
    zeros = np.zeros((1, nmb), np.uint8)
    arrays = {"y_levels": lv[..., :256].reshape(1, nmb, 16, 16),
              "uv_levels": lv[..., 256:384].reshape(1, nmb, 8, 16), "y2_levels": lv[..., 384:],
              "bpred": np.zeros((1, nmb, 16), np.uint8), "luma_mode": zeros, "chroma_mode": zeros}
    cpu = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
    pre = wire.prepack({k: t.to(cuda) for k, t in cpu.items()})
    rows = wire.wire_stage(*pre).cpu()
    assert torch.equal(rows, wire.wire_stage(*wire.prepack_plain(cpu)))
    got = wire.unpack_wire(rows[0].numpy(), nmb)
    assert (np.concatenate([got["y_levels"].reshape(nmb, 256), got["uv_levels"].reshape(nmb, 128),
                            got["y2_levels"]], axis=1) == lv[0]).all()


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_encode_through_the_wire_on_card(cuda, two_pass):
    """Q100 frames whose rows take the sparse branch with escapes and the
    dense-row branch (sp_over): payloads equal the CPU encode's; the fused
    K18 + K19 and K20 launched once each, K18 and K19 alone not at all."""
    yy, xx = np.mgrid[0:48, 0:64]
    tiles = np.repeat(np.where(((yy // 16) + (xx // 16)) % 2 == 1, 255, 0)[..., None], 3, 2)
    noise = 128 + np.random.RandomState(8).randint(-40, 41, (48, 64, 3))
    rgbs = [tiles.astype(np.uint8), np.clip(noise, 0, 255).astype(np.uint8)]
    want = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 100, 3, two_pass, device="cpu")
    _build.reset_launches()
    before = dict(edev.WIRE_BRANCHES)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, 100, 3, two_pass, device=cuda)
    assert {k: _build.LAUNCHES[k] for k in ("prepack", "pack_levels", "prepack_pack", "wire")} == {
        "prepack": 0, "pack_levels": 0, "prepack_pack": 1, "wire": 1}
    assert {k: edev.WIRE_BRANCHES[k] - n for k, n in before.items()} == {
        "sparse": 1, "dense_row": 1, "dense_arrays": 0}
    assert got == want


# ---- the image-flat sparse format: K21 pack_flat, K22 expand_flat ----------


@pytest.mark.parametrize("B,nmb", [(3, 40), (2, 6000)], ids=["40_mbs", "6000_mbs"])
@pytest.mark.parametrize("name", list(flat_cases(1, 8, 0)))
def test_flat_sparse_kernels_match_plain(cuda, name, B, nmb):
    """K21 and K22 bit-exact to their twins on `sparse_inputs.py`'s arrays
    (at 6,000 MBs an image spans 1,172 tiles, more than one pass of the tile
    scan), the expansion over all bits and over the first n - 5; one launch
    each; the round trip returns the input within the cap."""
    flat, cap = flat_cases(B, nmb, nmb)[name]
    cpu = torch.from_numpy(flat)
    before = {k: _build.LAUNCHES[k] for k in ("pack_flat", "expand_flat")}
    got = sparse.pack_levels(cpu.to(cuda), cap)
    full = sparse.expand_levels(got[0], got[1], flat.shape[1])
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - n for k, n in before.items()} == {
        "pack_flat": 1, "expand_flat": 1}
    want = sparse.pack_levels_plain(cpu, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for n in (flat.shape[1], flat.shape[1] - 5):
        assert torch.equal(sparse.expand_levels(got[0], got[1], n).cpu(),
                           sparse.expand_levels_plain(want[0], want[1], n))
    within = (flat != 0).sum(1) <= cap
    assert torch.equal(full.cpu()[within], cpu[within])


@pytest.mark.parametrize("case", ["batch1_flagship", "batch3", "batch8", "n_mod16_8",
                                  "misaligned_input", "cap_0", "cap_at_count", "cap_over_count"])
def test_flat_pack_kernel_edges(cuda, case):
    """K21 (one launch, a decoupled look-back, the pad and the flag written
    by the kernel) bit-exact to its twin at batch 1 over 75 tiles, batch 3
    and 8, N % 16 = 8 (rows of levels and bitmap off 16 bytes), a levels
    view one byte off its allocation, cap 0, a cap of exactly the largest
    image's count and one less; on vals filled with garbage beforehand
    (every byte is the kernel's); twice, so that the state the kernel
    leaves zero is reused, and the state checked zero after."""
    nmb, B, seed = {"batch1_flagship": (1536, 1, 7), "batch8": (300, 8, 13)}.get(case, (40, 3, 12))
    flat, cap = flat_cases(B, nmb, seed)["density_0.23"]
    most = int((flat != 0).sum(1).max())
    cap = {"cap_0": 0, "cap_at_count": most, "cap_over_count": most - 1}.get(case, cap)
    if case == "n_mod16_8":
        flat = np.ascontiguousarray(flat[:, :-8])
    cpu = torch.from_numpy(flat)
    dev = cpu.to(cuda)
    if case == "misaligned_input":
        raw = torch.empty(flat.size + 1, dtype=torch.int8, device=cuda)
        dev = raw[1:].view(flat.shape)
        dev.copy_(cpu)
    want = sparse.pack_levels_plain(cpu, cap)
    assert int(want[2].sum()) == {"cap_0": B, "cap_at_count": 0, "cap_over_count": 1}.get(case, 0)
    for _ in range(2):
        garbage = [torch.empty(shape, dtype=torch.int8, device=cuda).fill_(-77)
                   for shape in ((B, flat.shape[1] // 8), (B, cap), (B,))]
        del garbage  # the outputs' blocks, reused by the allocator
        before = _build.LAUNCHES["pack_flat"]
        got = sparse.pack_levels(dev, cap)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["pack_flat"] == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), case
    state = _build.kept_zeroed("pack_flat", 1, torch.int64, cuda)
    assert not state.any()


@pytest.mark.parametrize("case", ["batch1_flagship", "single_tile", "span_over_cap",
                                  "ragged_rows", "odd_cap"])
def test_flat_expand_kernel_edges(cuda, case):
    """K22 (one launch, a decoupled look-back) at batch 1 over 75 tiles, an
    image of one tile, a tile whose value span crosses the cap, rows that
    neither start nor end on 16 bytes (n = N - 5, N - 13, and a bitmap
    wider than ceil(n / 8) with random bits past n), and rows of values
    that start off 16 bytes (an odd cap); twice, so that the state the
    kernel leaves zero is reused, and the state checked zero after."""
    rng = np.random.RandomState(len(case))
    if case == "batch1_flagship":  # 1536 MBs: 614,400 slots, 75 tiles
        flat, cap = flat_cases(1, 1536, 7)["density_0.23"]
        ns = [flat.shape[1]]
    elif case == "single_tile":
        flat, cap = flat_cases(3, 20, 8)["density_0.31"]
        ns = [flat.shape[1], 8]
    elif case == "span_over_cap":  # ranks past cap - 1 inside one tile
        flat, cap = flat_cases(2, 8, 9)["over_cap"]
        ns = [flat.shape[1]]
    elif case == "ragged_rows":
        flat, cap = flat_cases(3, 300, 10)["density_0.05"]
        ns = [flat.shape[1] - 5, flat.shape[1] - 13, 8193]
    else:
        flat, cap = flat_cases(2, 40, 11)["extremes"]
        cap += 7
        ns = [flat.shape[1], flat.shape[1] - 3]
    bitmap, vals, _ = sparse.pack_levels_plain(torch.from_numpy(flat), cap)
    bitmap = torch.cat([bitmap, torch.from_numpy(
        rng.randint(0, 256, (bitmap.shape[0], 9)).astype(np.uint8))], 1)
    for n in ns:
        want = sparse.expand_levels_plain(bitmap, vals, n)
        for _ in range(2):
            before = _build.LAUNCHES["expand_flat"]
            got = sparse.expand_levels(bitmap.to(cuda), vals.to(cuda), n)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["expand_flat"] == before + 1
            assert torch.equal(got.cpu(), want), n
        state = _build.kept_zeroed("expand_flat", 1, torch.int64, cuda)
        assert not state.any()


WEBP_FILES = {
    "still_gradient_vp8l": lambda: rw.demo_still(75, 41, 1, 3, True).data,
    "still_horizontal_raw": lambda: rw.demo_still(64, 48, 2, 1, False).data,
    "vp8l": lambda: rw.still_vp8l(vp8l_stream(rw.rgba_frame(61, 37, 3), 3,
                                              (SUBTRACT_GREEN, predictor(2), color(3)))),
    "animation": lambda: rw.demo_animation(96, 64, 4)[0],
}


@pytest.mark.parametrize("upsampling", ["bilinear", "simple"])
@pytest.mark.parametrize("name", list(WEBP_FILES))
def test_decoder_api_on_card_matches_cpu(cuda, name, upsampling):
    data = WEBP_FILES[name]()
    card = webp_tpu_torch.WebPDecoder(data, upsampling=upsampling)
    host = webp_tpu_torch.WebPDecoder(data, upsampling=upsampling, device="cpu")
    assert card.device.type == "cuda"
    if card.is_animated():
        for d in (card, host):
            d.set_background_color((9, 8, 7, 6))
        for _ in range(card.num_frames):
            (got, got_ms), (want, want_ms) = card.read_frame(), host.read_frame()
            assert got_ms == want_ms and np.array_equal(got, want)
    else:
        np.testing.assert_array_equal(card.read_image(), host.read_image())
    got, w, h = webp_tpu_torch.decode_rgba(data)
    np.testing.assert_array_equal(got, webp_tpu_torch.decode_rgba(data, device="cpu")[0])


def _api_animation(device, lossless):
    enc = webp_tpu_torch.AnimationEncoder(40, 24, lossless=lossless, quality=70, device=device)
    first = rw.rgba_frame(40, 24, 61)
    second = first.copy()
    second[3:9, 5:17] = 17
    for i, frame in enumerate((first, second, second)):
        enc.add_frame(frame, 30 + i)
    return enc.finish()


# name -> f(device): the file's bytes.  The lossy files take K5, K6, K7, K5
# with the trellis from method 4, the fused K18 + K19 and K20 (K8 too at 256
# MBs and more).
ENCODER_API_FILES = {
    "rgb_m4": lambda d: webp_tpu_torch.Encoder.new_rgb(synthetic_frame(48, 40, 1), device=d)
        .encode(),
    "rgb_m6_q90": lambda d: webp_tpu_torch.Encoder.new_rgb(synthetic_frame(37, 29, 2), device=d)
        .with_method(6).with_quality(90).encode(),
    "rgba_alpha_quality_50": lambda d: webp_tpu_torch.Encoder.new_rgba(
        rw.rgba_frame(40, 24, 3), device=d).with_config(
        webp_tpu_torch.EncoderConfig(alpha_quality=50)).encode(),
    "l8_m2": lambda d: webp_tpu_torch.Encoder.new_l8(synthetic_frame(33, 17, 4)[..., 1],
                                                     device=d).with_method(2).encode(),
    "photo_meta": lambda d: webp_tpu_torch.Encoder.new_rgb(synthetic_frame(48, 40, 5), device=d)
        .with_preset(webp_tpu_torch.Preset.PHOTO).with_icc_profile(b"icc")
        .with_exif_metadata(b"exif").with_xmp_metadata(b"<x/>").encode(),
    "segments_256": lambda d: webp_tpu_torch.encode_rgb(synthetic_frame(256, 256, 6), 75,
                                                        device=d),
    "target_size_m0": lambda d: webp_tpu_torch.Encoder.new_rgb(synthetic_frame(32, 32, 7),
                                                               device=d)
        .with_method(0).with_target_size(400).encode(),
    "lossless_rgba": lambda d: webp_tpu_torch.encode_lossless_rgba(rw.rgba_frame(41, 23, 8),
                                                                   device=d),
    "anim_lossy": lambda d: _api_animation(d, False),
    "anim_lossless": lambda d: _api_animation(d, True),
}


@pytest.mark.parametrize("name", list(ENCODER_API_FILES))
def test_encoder_api_on_card_matches_cpu(cuda, name):
    _build.reset_launches()
    got = ENCODER_API_FILES[name](cuda)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    assert got == ENCODER_API_FILES[name]("cpu")
    lossy = b"VP8 " in got
    for k in ("enc", "token_stats", "enc_tables", "prepack_pack", "wire"):
        assert (counts[k] > 0) == lossy, (k, counts)
    assert (counts["analysis"] > 0) == (name == "segments_256"), counts
    d = webp_tpu_torch.WebPDecoder(got)
    host = webp_tpu_torch.WebPDecoder(got, device="cpu")
    if d.is_animated():
        for _ in range(d.num_frames):
            (g, g_ms), (w, w_ms) = d.read_frame(), host.read_frame()
            assert g_ms == w_ms and np.array_equal(g, w)
    else:
        np.testing.assert_array_equal(d.read_image(), host.read_image())
    if name == "lossless_rgba":
        np.testing.assert_array_equal(d.read_image(), rw.rgba_frame(41, 23, 8))
