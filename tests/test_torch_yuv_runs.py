"""K4 (fancy upsampling + YUV -> RGB): the kernel's partition on the CPU,
against the plain twin and the JAX package.

`fancy_yuv420_to_rgb_runs_plain` below walks the kernel's schedule (kept
here, beside its tests, since no caller of the package needs it): a
thread takes output rows 2k and 2k + 1 at a run of RUN = 8 columns (the
kernel's kRun), reads chroma rows k - 1, k, k + 1 at the run's window of 6
columns with the cropped plane's edge mirrors applied slot by slot, folds
the vertical taps, and stores each row's bytes at the kernel's address, the pixels past the
width and the row past the height masked.  It is held to
`fancy_yuv420_to_rgb_plain` (and the wrapper's CPU path) and to
`webp_tpu.ops.jax_ops.fancy_yuv420_to_rgb` at `test_torch_yuv.py`'s sizes
and at widths 7, 9, 15, 17, 33 and 767 against heights 1, 2, 3 and 511, at
batch 2 (`lane_inputs.K4_SIZES`).
Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import jax_ops
from webp_tpu_torch.ops import yuv
from webp_tpu_torch.ops.yuv import RUN, yuv_to_rgb

from lane_inputs import K4_SIZES, k4_planes


def _window(c: torch.Tensor, rows: torch.Tensor, c0: torch.Tensor, cw: int):
    """The kernel's chroma windows: plane c int32 [B, CH, CWpad] at chroma
    rows `rows` [K] and columns c0 - 1 .. c0 + RUN/2 of each run ([R]) ->
    [B, K, R, RUN/2 + 2], column -1 repeating column 0 and columns past
    cw - 1 repeating their left neighbour, slot by slot."""
    win = RUN // 2 + 2
    cols = c0[:, None] - 1 + torch.arange(win)
    s = c[:, rows][:, :, cols.clamp(0, c.shape[-1] - 1)]
    s[..., 0] = torch.where(c0 > 0, s[..., 0], s[..., 1])
    for i in range(2, win):
        s[..., i] = torch.where(cols[:, i] >= cw, s[..., i - 1], s[..., i])
    return s


def fancy_yuv420_to_rgb_runs_plain(y, u, v, width: int, height: int, trace=None):
    """Twin of the K4 kernel's partition (CPU): a thread (image, row pair k,
    run t) takes output rows 2k, 2k + 1 at columns RUN*t .. RUN*t + RUN - 1;
    it reads chroma rows k - 1, k, k + 1 (mirrored into the cropped plane)
    at the run's window, folds each column's vertical taps per row parity,
    forms each pixel's (3 * a[main] + a[far] + 8) >> 4, and stores the
    row's bytes at ((image * height + row) * width + RUN*t) * 3, the pixels
    past `width` and the row past `height` masked.  Where `trace` is a dict
    it counts the row stores by width (8 or 1 bytes; "tail" for a run that
    passes `width`)."""
    B = y.shape[0]
    ch, cw = (height + 1) // 2, (width + 1) // 2
    runs, half = -(-width // RUN), RUN // 2
    k = torch.arange(ch)
    c0 = torch.arange(runs) * half
    far = {0: (k - 1).clamp(min=0), 1: (k + 1).clamp(max=ch - 1)}
    q = torch.arange(RUN)
    main_slot, far_slot = 1 + (q >> 1), torch.where(q % 2 == 1, 2 + (q >> 1), q >> 1)
    yi = y.cpu().to(torch.int32)
    out = torch.full((B * height * width * 3,), 0, dtype=torch.uint8)
    written = torch.zeros_like(out, dtype=torch.bool)
    j0 = c0 * 2
    n = (width - j0).clamp(max=RUN)
    for p in (0, 1):
        chans = []
        for c in (u, v):
            ci = c.cpu().to(torch.int32)
            a = 3 * _window(ci, k, c0, cw) + _window(ci, far[p], c0, cw)
            chans.append((3 * a[..., main_slot] + a[..., far_slot] + 8) >> 4)  # [B, ch, R, RUN]
        rows = 2 * k + p
        luma = yi[:, rows.clamp(max=yi.shape[1] - 1)][:, :, j0[:, None] + q]
        rgb = yuv_to_rgb(luma, *chans)  # [B, ch, R, RUN, 3]
        byte = torch.arange(3 * RUN)
        base = ((torch.arange(B)[:, None] * height + rows) * (width * 3))[:, :, None] + j0 * 3
        idx = base[..., None] + byte  # [B, ch, R, 3 * RUN]
        mask = ((rows < height)[None, :, None, None] & (byte < 3 * n[:, None])).expand(idx.shape)
        out[idx[mask]] = rgb.reshape(idx.shape)[mask]
        written[idx[mask]] = True
        if trace is not None:
            addr = base.expand(B, ch, runs)
            live = (rows < height)[None, :, None].expand(addr.shape)
            full = (n == RUN).expand(addr.shape)
            for name, sel in (("tail", ~full), (8, full & (addr % 8 == 0)),
                              (1, full & (addr % 8 != 0))):
                trace[name] = trace.get(name, 0) + int((sel & live).sum())
    if not bool(written.all()):
        raise AssertionError("a pixel of the crop was stored by no thread")
    return out.reshape(B, height, width, 3)


@pytest.mark.parametrize("width,height", K4_SIZES)
def test_runs_match_plain_and_jax(width, height):
    planes = k4_planes(width, height)
    want = np.asarray(jax_ops.fancy_yuv420_to_rgb(*(jnp.asarray(p) for p in planes),
                                                  width, height))
    t = [torch.from_numpy(p) for p in planes]
    got = fancy_yuv420_to_rgb_runs_plain(*t, width, height)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, yuv.fancy_yuv420_to_rgb(*t, width, height))


def test_store_widths_follow_alignment():
    """At batch 2 an odd width puts rows (and the second image's base) on
    every byte alignment: both store widths are taken, a run that passes
    the width is masked; a width that is a multiple of 8 stores 8 bytes."""
    trace = {}
    t = [torch.from_numpy(p) for p in k4_planes(767, 3)]
    fancy_yuv420_to_rgb_runs_plain(*t, 767, 3, trace=trace)
    assert all(trace[k] > 0 for k in (8, 1, "tail"))
    trace = {}
    t = [torch.from_numpy(p) for p in k4_planes(64, 48)]
    fancy_yuv420_to_rgb_runs_plain(*t, 64, 48, trace=trace)
    assert trace == {8: 2 * 48 * 8, 1: 0, "tail": 0}
