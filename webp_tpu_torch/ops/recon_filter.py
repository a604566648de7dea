"""K2 + K3 fused: reconstruction and loop filter in one launch, the decode's
main path.

Replaces `webp_tpu/ops/wavefront2.py:274` `decode_frames_fused_v2`, which
runs `recon_step` (:152) and `loopfilter2.filter_step` (:192) in one
lax.scan.  The CUDA kernel is the `<recon, filter>` instance of
`csrc/wavefront_rows.cu`: one CTA per (image, MB row) over the card; its
iteration i reconstructs MB i from its neighbours' unfiltered edges (the
row above's bottom pixels saved in device memory, the left MB's right
column in shared memory) while one warp filters MB i - 1, and starts once
row r-1 has finished min(i + 2, mbw + 1) iterations.

Two torch twins: `recon_filter_plain_`, the diagonal twins of K2 and K3 one
after the other (what a CPU tensor runs), and `recon_filter_rows_plain_`,
the kernel's row schedule walked in a seeded order that the progress rule
allows, used by the tests to check the kernel's dependency claims on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .loopfilter import filter_mbs_, filter_params, loop_filter_plain_
from .wavefront import recon_mbs_, recon_plain_, row_scratch

# The fused kernel's schedule: iteration i of a row reconstructs MB i and
# filters MB i - LAG, once row r-1 has finished min(i + WAIT, mbw + LAG)
# iterations.
LAG, WAIT = 1, 2


def recon_filter_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode,
                        level, interior, hev, do_sub, simple: bool) -> None:
    """Torch twin of the fused kernel: K2's twin, then K3's."""
    recon_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode)
    loop_filter_plain_(y, u, v, level, interior, hev, do_sub, simple)


def _mb_workspaces(edge, left_y, left_c, r: int, x: int, mbw: int):
    """The bordered int32 workspaces ([B, 17, 21] luma, [B, 9, 9] U and V)
    of MB (x, r), from the saved unfiltered edges: edge [B, mbh, 32 mbw]
    (the rows' bottom pixels: luma, U, V), left_y [B, mbh, 16] and left_c
    [B, mbh, 2, 8] (each row's last MB's right columns)."""
    B, W = edge.shape[0], 16 * mbw
    x0, cx0 = 16 * x, 8 * x
    wy = torch.full((B, 17, 21), 127, dtype=torch.int32, device=edge.device)
    wc = [torch.full((B, 9, 9), 127, dtype=torch.int32, device=edge.device) for _ in range(2)]
    if r > 0:
        above = edge[:, r - 1]
        wy[:, 0, 0] = above[:, x0 - 1] if x > 0 else 129
        wy[:, 0, 1:17] = above[:, x0 : x0 + 16]
        wy[:, 0, 17:21] = (above[:, x0 + 16 : x0 + 20] if x < mbw - 1
                           else above[:, x0 + 15 : x0 + 16].expand(B, 4))
        for p in range(2):
            ac = above[:, W + p * (W // 2) :]
            wc[p][:, 0, 0] = ac[:, cx0 - 1] if x > 0 else 129
            wc[p][:, 0, 1:9] = ac[:, cx0 : cx0 + 8]
    wy[:, 1:, 0] = left_y[:, r] if x > 0 else 129
    for p in range(2):
        wc[p][:, 1:, 0] = left_c[:, r, p] if x > 0 else 129
    return wy, wc


class RowSteps:
    """The row kernels' MB work on the host, one MB at a time, as an
    iteration does it: `recon(r, x)` reconstructs MB (x, r) from the saved
    unfiltered edges (the rows' bottom pixels, each row's last right
    column) and saves its own; `filter(r, x)` loop-filters MB (x, r) in the
    planes.  The planes y/u/v [B, mbh*16, mbw*16] / [B, mbh*8, mbw*8] uint8
    are copied in (the filter's input) and `finish` writes them back.
    `recon_args` are `wavefront.recon_`'s (residuals, luma_mode, bpred,
    chroma_mode), `filter_args` `loopfilter.loop_filter_`'s (level,
    interior, hev, do_sub)."""

    def __init__(self, y, u, v, simple: bool, recon_args=None, filter_args=None):
        B, H, W = y.shape
        self.mbw, self.W = W // 16, W
        dev = y.device
        self.simple = simple
        if recon_args is not None:
            res, lm, bp, cm = recon_args
            self.args = (res.to(torch.int32), lm.long(), bp.long(), cm.long())
        if filter_args is not None:
            self.params = filter_params(*filter_args)
        self.work = [(F.pad(p.to(torch.int32), (4, 0, 4, 0)), n)
                     for p, n in ((y, 16), (u, 8), (v, 8))]
        self.filtered = self.work[:1] if simple else self.work
        mbh = H // 16
        self.edge = torch.zeros((B, mbh, 2 * W), dtype=torch.int32, device=dev)
        self.left_y = torch.zeros((B, mbh, 16), dtype=torch.int32, device=dev)
        self.left_c = torch.zeros((B, mbh, 2, 8), dtype=torch.int32, device=dev)
        self.one = torch.zeros(1, dtype=torch.long, device=dev)

    def recon(self, r: int, x: int) -> None:
        mbw, W, one = self.mbw, self.W, self.one
        m = r * mbw + x
        wy, (wu, wv) = _mb_workspaces(self.edge, self.left_y, self.left_c, r, x, mbw)
        recon_mbs_(wy, wu, wv, one, one, one + m, one + (r > 0), *self.args,
                   has_left=one + (x > 0) > 0)
        x0, cx0 = 16 * x, 8 * x
        self.edge[:, r, x0 : x0 + 16] = wy[:, 16, 1:17]
        self.left_y[:, r] = wy[:, 1:17, 16]
        for p, wc in enumerate((wu, wv)):
            self.edge[:, r, W + p * (W // 2) + cx0 : W + p * (W // 2) + cx0 + 8] = wc[:, 8, 1:9]
            self.left_c[:, r, p] = wc[:, 1:9, 8]
        for (pw, n), wb in zip(self.work, (wy, wu, wv)):
            pw[:, 4 + r * n : 4 + (r + 1) * n, 4 + x * n : 4 + (x + 1) * n] = wb[:, 1:, 1 : n + 1]

    def filter(self, r: int, x: int) -> None:
        one = self.one
        m = r * self.mbw + x
        filter_mbs_(self.filtered, one + r, one + x, one + (r > 0) > 0,
                    [p[:, [m]] for p in self.params], self.simple)

    def finish(self, y, u, v) -> None:
        for p, (pw, _) in zip((y, u, v), self.work):
            p.copy_(pw[:, 4:, 4:].to(torch.uint8))


def recon_filter_rows_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode,
                             level, interior, hev, do_sub, simple: bool, seed: int,
                             lag: int = LAG, wait: int = WAIT) -> None:
    """The fused kernel's row schedule on the host, one iteration at a time.
    Iteration i of a row reconstructs MB i (i < mbw) from the saved
    unfiltered edges, saves its unfiltered bottom row and right column, and
    filters MB i - lag in the planes (i >= lag), the two in a seeded order
    when lag > 0; a row has mbw + lag iterations.  At each step a row is drawn (numpy
    RandomState(seed)) among those whose next iteration i may start: row
    r-1 has finished min(i + wait, mbw + lag) iterations.  Equals
    `recon_filter_plain_` for every seed at wait 2, with lag 1 (the
    kernel's) or 0 (each MB filtered right after its recon)."""
    mbh, mbw = y.shape[1] // 16, y.shape[2] // 16
    rng = np.random.RandomState(seed)
    steps = RowSteps(y, u, v, simple, (residuals, luma_mode, bpred, chroma_mode),
                     (level, interior, hev, do_sub))
    n_iter = mbw + lag
    done = [0] * mbh
    for _ in range(n_iter * mbh):
        ready = [r for r in range(mbh) if done[r] < n_iter
                 and (r == 0 or done[r - 1] >= min(done[r] + wait, n_iter))]
        r = ready[rng.randint(len(ready))]
        i = done[r]
        work = ([lambda: steps.recon(r, i)] if i < mbw else []) + (
            [lambda: steps.filter(r, i - lag)] if i >= lag else [])
        for k in rng.permutation(len(work)) if lag else range(len(work)):
            work[k]()
        done[r] += 1
    steps.finish(y, u, v)


def recon_filter_(y, u, v, residuals, luma_mode, bpred, chroma_mode,
                  level, interior, hev, do_sub, simple: bool) -> None:
    """Reconstruct and loop-filter into the planes y [B, mbh*16, mbw*16],
    u/v [B, mbh*8, mbw*8] uint8 (rows packed, any batch stride): the
    arguments of `wavefront.recon_` followed by those of
    `loopfilter.loop_filter_`.  One kernel launch on a CUDA device; the
    twins of K2 and K3 on the CPU."""
    dev = _build.same_device(y, u, v, residuals, luma_mode, bpred, chroma_mode,
                             level, interior, hev, do_sub)
    if dev.type == "cpu":
        return recon_filter_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode,
                                   level, interior, hev, do_sub, simple)
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    nmb = mbw * mbh
    args = [_build.dense(residuals, torch.int32, (B, nmb, 24, 16)),
            *_build.mb_field(luma_mode, B, nmb), *_build.mb_field(bpred, B, nmb, 16),
            *_build.mb_field(chroma_mode, B, nmb)]
    for f in (level, interior, hev, do_sub):
        args += _build.mb_field(f, B, nmb)
    edge, prog = row_scratch(B, mbh, mbw, dev)
    _build.launch(
        "recon_filter", "webp_recon_filter", dev, *args, mbw, mbh, B, int(simple),
        *_build.plane(y, B, H, W), *_build.plane(u, B, mbh * 8, mbw * 8),
        *_build.plane(v, B, mbh * 8, mbw * 8), edge.data_ptr(), prog.data_ptr(),
    )


def resident_rows(device, recon: bool = True, filter: bool = True) -> int:
    """Row CTAs of one instance of the row-CTA kernel (K2: recon only, K3:
    filter only, the fused kernel: both) that `device` keeps resident at
    once."""
    lib = _build.load()
    with torch.cuda.device(device):
        n = lib.webp_recon_filter_resident(int(recon), int(filter))
    if n < 0:
        raise RuntimeError("webp_recon_filter_resident: occupancy query failed")
    return n
