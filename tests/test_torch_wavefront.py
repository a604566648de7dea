"""K2 (recon) and K3 (loop filter): the port's plain paths against the JAX
package's lax.scan versions `reconstruct_frames_v2` and `loop_filter_frames_v2`.

The encoded streams carry only the normal filter, so the filter is also
run with parameters drawn from a seed, with simple=False and simple=True.
Tolerance: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.loopfilter2 import loop_filter_frames_v2
from webp_tpu.ops.wavefront2 import reconstruct_frames_v2
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.ops import residual
from webp_tpu_torch.ops.loopfilter import loop_filter_
from webp_tpu_torch.ops.wavefront import recon_

from torch_fixtures import luma_mode_counts, mixed_payloads

W, H = 72, 40
MBW, MBH = 5, 3


@pytest.fixture(scope="module")
def decoded():
    """Host parse, K1 residuals and the JAX reconstruction of a batch."""
    payloads = mixed_payloads(W, H, seeds=(21, 22))
    counts = [luma_mode_counts(p) for p in payloads]
    assert all(i4 > 0 and i16 > 0 for i4, i16 in counts), counts
    batch = tdev.parse_levels_batch(payloads)
    d = tdev.to_device_batch(batch, "cpu")
    f = tdev.field_views(d["u8buf"], MBW * MBH)
    res, do_sub = residual.residuals_sparse(
        *(d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")),
        f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"],
    )
    yuv = reconstruct_frames_v2(
        jnp.asarray(res.numpy()), jnp.asarray(f["luma_mode"].numpy()),
        jnp.asarray(f["bpred"].numpy()), jnp.asarray(f["chroma_mode"].numpy()), MBW, MBH,
    )
    return dict(res=res, do_sub=do_sub, f=f, yuv=[np.asarray(p) for p in yuv])


def _planes(B):
    return (torch.zeros((B, MBH * 16, MBW * 16), dtype=torch.uint8),
            torch.zeros((B, MBH * 8, MBW * 8), dtype=torch.uint8),
            torch.zeros((B, MBH * 8, MBW * 8), dtype=torch.uint8))


def test_recon_matches_jax(decoded):
    f = decoded["f"]
    y, u, v = _planes(2)
    recon_(y, u, v, decoded["res"], f["luma_mode"], f["bpred"], f["chroma_mode"])
    for got, want in zip((y, u, v), decoded["yuv"]):
        np.testing.assert_array_equal(got.numpy(), want)


def _filter_params(decoded, kind):
    if kind == "encoded":
        f = decoded["f"]
        return (f["level"].numpy(), f["interior"].numpy(), f["hev"].numpy(),
                decoded["do_sub"].numpy())
    rng = np.random.RandomState(7)
    shape = (2, MBW * MBH)
    level = rng.randint(0, 64, shape) * (rng.rand(*shape) > 0.15)
    return (level.astype(np.uint8), rng.randint(1, 64, shape).astype(np.uint8),
            rng.randint(0, 3, shape).astype(np.uint8), rng.rand(*shape) < 0.6)


def _blocky_planes(seed):
    """Planes with steps at 4-pixel edges and small noise, so that most
    edges pass the filter thresholds."""
    rng = np.random.RandomState(seed)
    out = []
    for n in (16, 8, 8):
        cells = rng.randint(90, 160, size=(2, MBH * n // 4, MBW * n // 4))
        p = np.kron(cells, np.ones((1, 4, 4), np.int64))
        out.append(np.clip(p + rng.randint(-3, 4, p.shape), 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("simple", [False, True], ids=["normal", "simple"])
@pytest.mark.parametrize("kind", ["encoded", "seeded"])
def test_loop_filter_matches_jax(decoded, kind, simple):
    params = _filter_params(decoded, kind)
    planes = decoded["yuv"] if kind == "encoded" else _blocky_planes(3)
    want = loop_filter_frames_v2(
        *(jnp.asarray(p) for p in planes), *(jnp.asarray(p) for p in params),
        MBW, MBH, simple,
    )
    got = [torch.from_numpy(p.copy()) for p in planes]
    loop_filter_(*got, *(torch.from_numpy(np.ascontiguousarray(p)) for p in params), simple)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[0].numpy(), planes[0])  # the filter did act
    if simple:  # chroma passes through the simple filter untouched
        for g, p in zip(got[1:], planes[1:]):
            np.testing.assert_array_equal(g.numpy(), p)
