"""Kernels K13 (coefficient partitions) and K14 (MB headers): the device
token coder, and their plain twins.

K13 replaces `webp_tpu/ops/token_ops.py:228` `encode_coeff_partitions` (with
`block_ops` :80, `_cls_of` :66 and `compute_contexts_dev` :169); K14 replaces
`:424` `encode_mb_headers` (with `header_ops` :340 and `_mode_tree_tables`
:311).  Both then code their ops with the lane coder of `ops/boolenc2.py`.

K13 codes each image's P coefficient partitions from the levels the encode
pass left on the card: partition p carries the MB rows r with r % P == p in
raster order, each MB that is not skipped (some level nonzero) as its Y2
block (when the luma mode is not B), 16 Y blocks and 8 UV blocks, each
block's tokens under the image's adapted probabilities, in the order and
with the contexts of the host writer (`encode/vp8.py`, the C++
`vp8_token_encode`).  K14 continues each image's frame-header coder state
with its MB headers: the segment id (when the frame writes the map), the
skip flag, the luma mode, the 16 B modes under their top and left mode
contexts, and the chroma mode.

In K13 (`csrc/tokens.cu`) three producer warps generate a lane's ops, one
block a warp lane, into a shared ring that one coder warp reads.  In K14
one CTA an image counts every MB's ops, scans the counts and writes the
image's whole op stream to global memory, then one warp codes it;
`header_stream_plain` is the twin of those count and write phases.  The
plain twins follow the JAX form: `block_ops` and `header_ops` lay out
every possible op slot with a valid mask, the valid ops of each lane are
compacted, and `ops/boolenc2.bool_encode_lanes_plain` codes all lanes at
once.  The
schedule twin `encode_coeff_partitions_ring_plain` walks K13's order
instead: its producers and its coder run as generators in seeded orders,
meet only through the ring and its counters, and code with the device
step (`ops/boolenc2.LaneCoderPlain`).  The wrappers take a byte capacity per lane (the JAX package's
budgets by default); a lane over it makes the wrapper run once more with
the capacity set to the largest count reported, and a second overflow
raises.  The JAX package falls back to its host coders there; the port
has no fallback.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..common import vp8_tables as T
from ..encode.boolenc import tree_paths
from .boolenc2 import (INIT_STATE, Lanes, LaneCoderPlain, bool_encode_lanes_plain, carry_words,
                       lane_coder_plain)
from .token_stats import compute_contexts, skip_flags

# ---- static tables --------------------------------------------------------

_TOKEN_PATHS = tree_paths(T.DCT_TOKEN_TREE)  # start 0: the full tree; 2: no EOB branch


def _token_tables():
    max_len = max(len(p) for start in (0, 2) for p in _TOKEN_PATHS[start].values())
    tp_len = np.zeros((2, 12), np.int32)
    tp_bit = np.zeros((2, 12, max_len), np.int32)
    tp_node = np.zeros((2, 12, max_len), np.int32)
    for s2, start in enumerate((0, 2)):
        for cls, path in _TOKEN_PATHS[start].items():
            tp_len[s2, cls] = len(path)
            for k, (bit, node) in enumerate(path):
                tp_bit[s2, cls, k] = bit
                tp_node[s2, cls, k] = node
    cat_nbits = np.zeros(12, np.int32)
    cat_probs = np.zeros((12, 11), np.int32)
    for c, probs in enumerate(T.PROB_DCT_CAT):
        cat_nbits[6 + c] = len(probs)
        cat_probs[6 + c, :len(probs)] = probs
    cat_base = np.zeros(12, np.int32)
    cat_base[6:12] = T.DCT_CAT_BASE
    return max_len, tp_len, tp_bit, tp_node, cat_nbits, cat_probs, cat_base


(_TP_MAX, _TP_LEN, _TP_BIT, _TP_NODE, _CAT_NBITS, _CAT_PROBS, _CAT_BASE) = _token_tables()
_BANDS = np.asarray(T.COEFF_BANDS, np.int32)
_PER_COEFF = _TP_MAX + 11 + 1  # tree path, extra bits, sign
SLOTS = 16 * _PER_COEFF + _TP_MAX  # then the EOB's path


def _mode_tree_tables(tree, nsym: int):
    paths = tree_paths(tree)[0]
    max_len = max(len(p) for p in paths.values())
    ln = np.zeros(nsym, np.int32)
    bit = np.zeros((nsym, max_len), np.int32)
    node = np.zeros((nsym, max_len), np.int32)
    for sym, path in paths.items():
        ln[sym] = len(path)
        for k, (b, nd) in enumerate(path):
            bit[sym, k] = b
            node[sym, k] = nd
    return ln, bit, node, max_len


_SEG_LN, _SEG_BIT, _SEG_NODE, _SEG_MAX = _mode_tree_tables(T.SEGMENT_ID_TREE, 4)
_YM_LN, _YM_BIT, _YM_NODE, _YM_MAX = _mode_tree_tables(T.KEYFRAME_YMODE_TREE, 5)
_UV_LN, _UV_BIT, _UV_NODE, _UV_MAX = _mode_tree_tables(T.KEYFRAME_UV_MODE_TREE, 4)
_BP_LN, _BP_BIT, _BP_NODE, _BP_MAX = _mode_tree_tables(T.KEYFRAME_BPRED_MODE_TREE, 10)
_BP_PROBS = np.asarray(T.KEYFRAME_BPRED_MODE_PROBS, np.int32)  # [10, 10, 9]
_YM_PROBS = np.asarray(T.KEYFRAME_YMODE_PROBS, np.int32)
_UV_PROBS = np.asarray(T.KEYFRAME_UV_MODE_PROBS, np.int32)
# Whole-MB luma modes DC, V, H, TM imply the B-mode context B_DC, B_VE, B_HE, B_TM.
_IMPLIED_BMODE = np.asarray([0, 2, 3, 1, 0], np.int32)

HEADER_SLOTS = _SEG_MAX + 1 + _YM_MAX + 16 * _BP_MAX + _UV_MAX

# The kernels' int32 tables, in the order `csrc/tokens.cu` reads them.
TOKEN_CONSTS_NP = np.concatenate([a.reshape(-1) for a in (
    _TP_LEN, _TP_BIT, _TP_NODE, _CAT_NBITS, _CAT_PROBS, _CAT_BASE, _BANDS)]).astype(np.int32)
HEADER_CONSTS_NP = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in (
    _SEG_LN, _SEG_BIT, _SEG_NODE, _YM_LN, _YM_BIT, _YM_NODE, _YM_PROBS, _UV_LN, _UV_BIT,
    _UV_NODE, _UV_PROBS, _BP_LN, _BP_BIT, _BP_NODE, _BP_PROBS, _IMPLIED_BMODE)])


def token_budget(nmb: int, nparts: int) -> int:
    """The JAX package's byte budget of a coefficient partition."""
    return max(2048, (nmb * 120) // nparts)


def header_budget(nmb: int) -> int:
    """The JAX package's byte budget of the MB headers."""
    return max(1024, nmb * 8)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=torch.int64)


# ---- coefficient tokens ---------------------------------------------------


def _cls_of(v):
    """Token class of |level| v (zero is class 1)."""
    cat = 6 + (v >= 7).long() + (v >= 11).long() + (v >= 19).long() + (v >= 35).long() \
        + (v >= 67).long()
    return torch.where(v <= 4, v.clamp(max=4) + 1, cat)


def block_ops(levels, plane, first, ctx0, probs_flat):
    """Op slots of [..., 16] zigzag level blocks coded from position `first`
    with initial context `ctx0` in plane `plane` ([...] each) under one
    image's probabilities `probs_flat` [1056]: (prob, bit) int32 and valid
    bool [..., SLOTS], in stream order."""
    dev = levels.device
    lead = levels.shape[:-1]
    levels = levels.to(torch.int64)
    plane, first, ctx0 = (x.to(torch.int64) for x in (plane, first, ctx0))
    pf = probs_flat.to(torch.int64).reshape(-1)
    v = levels.abs()
    n_idx = torch.arange(16, device=dev)
    last = torch.where(v != 0, n_idx, -1).amax(-1)  # -1 when empty
    end = last + 1
    cls = _cls_of(v)
    prev_v = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
    ci = torch.where(n_idx == first[..., None], ctx0[..., None], prev_v.clamp(max=2))
    skip2 = (n_idx > first[..., None]) & (prev_v == 0)
    active = (n_idx >= first[..., None]) & (n_idx < end[..., None])
    tp_len, tp_bit, tp_node = (_t(a, dev) for a in (_TP_LEN, _TP_BIT, _TP_NODE))
    cat_nbits, cat_probs, cat_base, bands = (_t(a, dev) for a in (_CAT_NBITS, _CAT_PROBS,
                                                                   _CAT_BASE, _BANDS))
    s2 = skip2.long()

    ks = torch.arange(_TP_MAX, device=dev)
    node = tp_node[s2[..., None], cls[..., None], ks]             # [..., 16, K]
    tbit = tp_bit[s2[..., None], cls[..., None], ks]
    tvalid = active[..., None] & (ks < tp_len[s2, cls][..., None])
    pidx = ((plane[..., None, None] * 8 + bands[:, None]) * 3 + ci[..., None]) * 11 + node
    tprob = pf[pidx]

    nb = cat_nbits[cls]
    extra = v - cat_base[cls]
    ke = torch.arange(11, device=dev)
    ebit = (extra[..., None] >> (nb[..., None] - 1 - ke).clamp(min=0)) & 1
    eprob = cat_probs[cls[..., None], ke]
    evalid = active[..., None] & (ke < nb[..., None])

    sbit = (levels < 0).long()[..., None]
    sprob = torch.full_like(sbit, 128)
    svalid = (active & (cls != 1))[..., None]                     # zeros carry no sign

    eb_pos = torch.maximum(first, end).clamp(max=15)
    last_v = v.gather(-1, last.clamp(min=0)[..., None])[..., 0]
    eb_ctx = torch.where(end > first, torch.where(last_v == 1, 1, 2), ctx0)
    eb_pidx = ((plane * 8 + bands[eb_pos]) * 3 + eb_ctx)[..., None] * 11 + tp_node[0, 0]
    eb_valid = (end < 16)[..., None] & (ks < tp_len[0, 0])

    def lay(per_coeff, eob):
        return torch.cat([torch.cat(per_coeff, dim=-1).reshape(*lead, -1), eob], dim=-1)

    prob = lay([tprob, eprob, sprob], pf[eb_pidx]).to(torch.int32)
    bit = lay([tbit, ebit, sbit], tp_bit[0, 0].expand(*lead, _TP_MAX)).to(torch.int32)
    valid = lay([tvalid, evalid, svalid], eb_valid)
    return prob, bit, valid


def _pad_lanes(streams, dev):
    """[T, L] bit, prob, valid of per-lane (bit, prob) streams, padded with no-ops."""
    T_max = max([len(b) for b, _ in streams] + [1])
    L = len(streams)
    bits = torch.zeros((T_max, L), dtype=torch.int64, device=dev)
    probs = torch.full((T_max, L), 128, dtype=torch.int64, device=dev)
    valid = torch.zeros((T_max, L), dtype=torch.bool, device=dev)
    for lane, (b, p) in enumerate(streams):
        bits[:len(b), lane] = b
        probs[:len(p), lane] = p
        valid[:len(b), lane] = True
    return bits, probs, valid


def encode_coeff_partitions_plain(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw: int,
                                  mbh: int, nparts: int, max_bytes: int) -> Lanes:
    """Torch twin of K13 (any device): lanes [B, P], data [B, P, max_bytes]."""
    B, nmb = luma_mode.shape
    dev = luma_mode.device
    lm = luma_mode.to(torch.int64)
    y2_ctx, y_ctx, uv_ctx = compute_contexts(lm, y2_levels, y_levels, uv_levels, mbw, mbh)
    skipped = skip_flags(y2_levels, y_levels, uv_levels)
    has_y2 = lm != 4
    pf = probs.reshape(B, -1)
    streams = []
    for b in range(B):
        levels = torch.cat([y2_levels[b][:, None], y_levels[b], uv_levels[b]], dim=1)
        plane = torch.full((nmb, 25), 2, dtype=torch.int64, device=dev)
        plane[:, 0] = 1
        plane[:, 1:17] = torch.where(has_y2[b], 0, 3)[:, None]
        first = torch.zeros((nmb, 25), dtype=torch.int64, device=dev)
        first[:, 1:17] = has_y2[b].long()[:, None]
        ctxs = torch.cat([y2_ctx[b][:, None], y_ctx[b], uv_ctx[b]], dim=1)
        blk_ok = torch.ones((nmb, 25), dtype=torch.bool, device=dev)
        blk_ok[:, 0] = has_y2[b]
        blk_ok &= ~skipped[b][:, None]
        prob, bit, valid = block_ops(levels, plane, first, ctxs, pf[b])
        valid &= blk_ok[..., None]
        rows = [x.reshape(mbh, -1) for x in (prob, bit, valid)]
        for p in range(nparts):  # rows r with r % nparts == p, raster order
            pr, bt, ok = (x[p::nparts].reshape(-1) for x in rows)
            streams.append((bt[ok], pr[ok]))
    lanes = bool_encode_lanes_plain(*_pad_lanes(streams, dev), max_bytes)
    return Lanes(*(x.reshape(B, nparts, *x.shape[1:]) for x in lanes))


class PendingLanes(NamedTuple):
    """A coder's lanes as launched at `capacity` bytes a lane, before the
    check of their byte counts; run(capacity) launches the coder again."""
    lanes: Lanes
    capacity: int
    run: Callable

    def result(self) -> Lanes:
        """The lanes with data cut to the largest byte count, after one more
        run at that count if a lane went over.  Reads the counts on the
        host, so it waits for the device."""
        lanes = self.lanes
        need = int(lanes.n_bytes.max()) if lanes.n_bytes.numel() else 0
        if need > self.capacity:
            lanes = self.run(need)
            again = int(lanes.n_bytes.max())
            if again > need:
                raise RuntimeError(f"lane coder overflow: {again} bytes after a relaunch at {need}")
        return lanes._replace(data=lanes.data[..., :need])


def _capacity_run(run, capacity: int) -> Lanes:
    """run(capacity), once more at the largest reported byte count if a lane
    went over; data cut to the largest count."""
    return PendingLanes(run(capacity), capacity, run).result()


def encode_coeff_partitions(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw: int,
                            mbh: int, nparts: int, capacity: int = None) -> Lanes:
    """The coefficient partitions of a batch: luma_mode [B, nmb] uint8,
    y2_levels [B, nmb, 16], y_levels [B, nmb, 16, 16], uv_levels [B, nmb, 8,
    16] int16 and the images' token probabilities probs [B, 1056] uint8 ->
    `Lanes` [B, P] (data [B, P, largest n_bytes]).  K13 for CUDA tensors,
    the plain twin for CPU ones; `capacity` bytes per partition first
    (default `token_budget`)."""
    return launch_coeff_partitions(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw, mbh,
                                   nparts, capacity).result()


def launch_coeff_partitions(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw: int,
                            mbh: int, nparts: int, capacity: int = None) -> PendingLanes:
    """`encode_coeff_partitions` up to its launch, which waits for nothing;
    `.result()` of the return checks the byte counts."""
    dev = _build.same_device(luma_mode, y2_levels, y_levels, uv_levels, probs)
    B, nmb = luma_mode.shape
    if nmb != mbw * mbh:
        raise ValueError(f"{nmb} MBs for a {mbw}x{mbh} grid")
    if capacity is None:
        capacity = token_budget(nmb, nparts)
    coder = encode_coeff_partitions_plain if dev.type == "cpu" else _coeff_tokens_kernel

    def run(cap):
        return coder(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw, mbh, nparts, cap)

    return PendingLanes(run(capacity), capacity, run)


def _coeff_tokens_kernel(luma_mode, y2_levels, y_levels, uv_levels, probs, mbw, mbh, nparts,
                         cap) -> Lanes:
    dev = luma_mode.device
    B, nmb = luma_mode.shape
    info = torch.empty((B, nparts, 6), dtype=torch.int64, device=dev)
    data = torch.zeros((B, nparts, cap), dtype=torch.uint8, device=dev)
    carries = torch.empty((B, nparts, carry_words(cap)), dtype=torch.int32, device=dev)
    consts = _build.device_constant("token_consts", TOKEN_CONSTS_NP, dev)
    _build.launch(
        "coeff_tokens", "webp_coeff_tokens", dev,
        *_build.mb_field(luma_mode, B, nmb),
        _build.dense(y2_levels, torch.int16, (B, nmb, 16)),
        _build.dense(y_levels, torch.int16, (B, nmb, 16, 16)),
        _build.dense(uv_levels, torch.int16, (B, nmb, 8, 16)),
        _build.dense(probs.reshape(B, -1), torch.uint8, (B, 1056)),
        _build.dense(consts, torch.int32, (consts.numel(),)), consts.numel(),
        mbw, mbh, B, nparts, cap, data.data_ptr(), carries.data_ptr(), info.data_ptr(),
    )
    return Lanes.from_fields(info, data)


# ---- K13's schedule -------------------------------------------------------

RING = 8192       # ops in K13's shared ring (`csrc/tokens.cu` kRing)
PRODUCERS = 3     # K13's producer warps (kProducers)
PUBLISH = 256     # the coder publishes its progress every this many ops (kPublish)
_POISON = 0x1FF   # an unwritten ring slot: bit 1 at probability 255


def _block_ops_scalar(lv, first: int, end: int, ctx: int, pp) -> list:
    """One block's ops as K13's producer lane writes them (`block_ops` of
    `csrc/tokens.cu`): prob | bit << 8, in stream order."""
    lv = [int(x) for x in lv]
    ops, ci, s2, lastv = [], ctx, 0, 0
    for n in range(first, end):
        level = lv[n]
        v = abs(level)
        cls = v + 1 if v <= 4 else 6 + (v >= 7) + (v >= 11) + (v >= 19) + (v >= 35) + (v >= 67)
        p = pp[(_BANDS[n] * 3 + ci) * 11:]
        for k in range(_TP_LEN[s2, cls]):
            ops.append(int(p[_TP_NODE[s2, cls, k]]) | int(_TP_BIT[s2, cls, k]) << 8)
        nb = int(_CAT_NBITS[cls])
        extra = v - int(_CAT_BASE[cls])
        for k in range(nb):
            ops.append(int(_CAT_PROBS[cls, k]) | ((extra >> (nb - 1 - k)) & 1) << 8)
        if cls != 1:
            ops.append(128 | (level < 0) << 8)
        s2, ci, lastv = int(v == 0), min(v, 2), v
    if end < 16:
        pos = min(max(first, end), 15)
        eob_ctx = (1 if lastv == 1 else 2) if end > first else ctx
        p = pp[(_BANDS[pos] * 3 + eob_ctx) * 11:]
        for k in range(_TP_LEN[0, 0]):
            ops.append(int(p[_TP_NODE[0, 0, k]]) | int(_TP_BIT[0, 0, k]) << 8)
    return ops


def _mb_block_ops(lm, y2, y, uv, pf, m: int, mx: int, my: int, mbw: int) -> list:
    """The 25 blocks' op lists of MB m as K13's producer warp makes them
    (lane 0 Y2, 1-16 Y, 17-24 UV): empty when the MB is skipped; the
    contexts from the blocks in the MB, the neighbour MBs' levels across
    its top and left edges, and the Y2 context's walk to the nearest MB
    above and to the left that has a Y2 block."""
    blocks = [y2[m]] + [y[m, s] for s in range(16)] + [uv[m, s] for s in range(8)]
    if not any(b.any() for b in blocks):
        return [[] for _ in blocks]
    has_y2 = lm[m] != 4
    first = [0] + [int(has_y2)] * 16 + [0] * 8

    def y_nz(n, s):
        return int(y[n, s, (1 if lm[n] != 4 else 0):].any())

    def uv_nz(n, s):
        return int(uv[n, s].any())

    def y2_walk(step, count):
        for k in range(1, count + 1):
            if lm[m - k * step] != 4:
                return int(y2[m - k * step].any())
        return 0

    out = [[] for _ in blocks]
    if has_y2:
        out[0] = _block_ops_scalar(blocks[0], 0, _end(blocks[0]), y2_walk(mbw, my) + y2_walk(1, mx),
                                   pf[264:])
    nz = [int(blocks[i][first[i]:].any()) for i in range(25)]
    for s in range(16):
        sy, sx = s >> 2, s & 3
        up = nz[1 + s - 4] if sy > 0 else (y_nz(m - mbw, 12 + sx) if my > 0 else 0)
        left = nz[s] if sx > 0 else (y_nz(m - 1, 4 * sy + 3) if mx > 0 else 0)
        out[1 + s] = _block_ops_scalar(blocks[1 + s], first[1 + s], _end(blocks[1 + s]), up + left,
                                       pf[(0 if has_y2 else 3) * 264:])
    for s in range(8):
        ch, q = s >> 2, s & 3
        qy, qx = q >> 1, q & 1
        up = nz[17 + s - 2] if qy > 0 else (uv_nz(m - mbw, ch * 4 + 2 + qx) if my > 0 else 0)
        left = nz[17 + s - 1] if qx > 0 else (uv_nz(m - 1, ch * 4 + 2 * qy + 1) if mx > 0 else 0)
        out[17 + s] = _block_ops_scalar(blocks[17 + s], 0, _end(blocks[17 + s]), up + left,
                                        pf[2 * 264:])
    return out


def _end(block) -> int:
    nz = np.flatnonzero(block)
    return int(nz[-1]) + 1 if len(nz) else 0


def _ring_lane(lm, y2, y, uv, pf, p: int, nparts: int, mbw: int, mbh: int, cap: int, rng,
               ring: int, slots: int, wait: bool):
    """One (image, partition) lane through K13's schedule: the fields and
    bytes of `LaneCoderPlain.finish`.  `slots` is the ring's real size
    (`ring` unless a test shrinks it); with wait=False the coder reads the
    ring without waiting for `avail`."""
    rows = (mbh - 1 - p) // nparts + 1 if p < mbh else 0
    n_mb = rows * mbw
    buf = [_POISON] * slots
    st = {"counted": 0, "next": 0, "avail": 0, "consumed": 0}
    coder = LaneCoderPlain(INIT_STATE, cap)
    total = [None]  # the stream's length, for a coder that does not wait

    def producer(w: int):
        for k in range(w, n_mb, PRODUCERS):
            mx, my = k % mbw, p + (k // mbw) * nparts
            blocks = _mb_block_ops(lm, y2, y, uv, pf, my * mbw + mx, mx, my, mbw)
            counts = [len(b) for b in blocks]
            offsets = np.concatenate([[0], np.cumsum(counts)])  # the warp scan
            yield lambda k=k: st["counted"] == k
            start = st["next"]
            st["next"] = start + int(offsets[-1])
            st["counted"] = k + 1
            for rs in range(start, st["next"], ring):  # rounds of at most a ring
                re = min(start + int(offsets[-1]), rs + ring)
                yield lambda re=re: st["consumed"] >= re - ring
                for ops, off in zip(blocks, offsets):
                    for i, op in enumerate(ops):
                        if rs <= start + off + i < re:
                            buf[(start + off + i) % slots] = op
                    yield lambda: True
                yield lambda rs=rs: st["avail"] == rs
                st["avail"] = re

    def consumer():
        pos = 0
        while True:
            if wait:
                yield lambda: (st["avail"] > pos
                               or (st["counted"] == n_mb and st["next"] == pos))
                if st["avail"] == pos:
                    return
                lim = st["avail"]
            else:
                yield lambda: True
                if pos == total[0]:
                    return
                lim = min(total[0], pos + 8)
            while pos < lim:
                for q in range(pos, min(lim, (pos // 8 + 1) * 8)):  # one 8-op vector
                    op = buf[q % slots]
                    coder.put(op >> 8, op & 0xFF)
                pos = min(lim, (pos // 8 + 1) * 8)
                if pos % PUBLISH == 0:
                    st["consumed"] = pos
                yield lambda: True
            st["consumed"] = pos

    if not wait:  # the count a coder that does not wait codes up to
        total[0] = sum(len(o) for k in range(n_mb) for o in _mb_block_ops(
            lm, y2, y, uv, pf, (p + (k // mbw) * nparts) * mbw + k % mbw, k % mbw,
            p + (k // mbw) * nparts, mbw))
    units = [producer(w) for w in range(PRODUCERS)] + [consumer()]
    ready = [next(u, None) for u in units]
    while any(r is not None for r in ready):
        live = [i for i, r in enumerate(ready) if r is not None and r()]
        if not live:
            raise RuntimeError("K13's schedule deadlocked")
        i = live[rng.randint(len(live))]
        ready[i] = next(units[i], None)
    return coder.finish()



def encode_coeff_partitions_ring_plain(luma_mode, y2_levels, y_levels, uv_levels, probs,
                                       mbw: int, mbh: int, nparts: int, max_bytes: int,
                                       seed: int = 0, ring: int = RING, slots: int = None,
                                       wait: bool = True) -> Lanes:
    """K13's schedule on the host (CPU tensors): each lane's producers and
    coder run as generators in an order drawn from numpy RandomState(seed),
    each waiting where the kernel waits; the coder reads its ops only from
    the ring, whose unwritten slots hold a poison op.  Equals
    `encode_coeff_partitions_plain` for every seed; a ring of `slots` <
    `ring` (the producers' rule one short), or a coder that does not wait,
    breaks it."""
    B, nmb = luma_mode.shape
    rng = np.random.RandomState(seed)
    lm = luma_mode.numpy().astype(np.int64)
    levels = [t.numpy().astype(np.int64) for t in (y2_levels, y_levels, uv_levels)]
    pf = probs.reshape(B, -1).numpy().astype(np.int64)
    fields, data = [], torch.zeros((B, nparts, max_bytes), dtype=torch.uint8)
    for b in range(B):
        for p in range(nparts):
            lead, out, *rest = _ring_lane(lm[b], *(a[b] for a in levels), pf[b], p, nparts, mbw,
                                          mbh, max_bytes, rng, ring,
                                          ring if slots is None else slots, wait)
            fields.append([lead, *rest])
            if max_bytes:
                data[b, p] = torch.frombuffer(bytearray(out), dtype=torch.uint8)
    info = torch.tensor(fields, dtype=torch.int64).reshape(B, nparts, 6)
    return Lanes.from_fields(info, data)


# ---- MB headers -----------------------------------------------------------


def header_ops(luma_mode, bpred, chroma_mode, segment_ids, skipped, seg_probs3, skip_prob,
               write_segments: bool, mbw: int, mbh: int):
    """Op slots of one image's MB headers in raster order: (prob, bit) int32
    and valid bool [nmb, HEADER_SLOTS]."""
    dev = luma_mode.device
    nmb = mbw * mbh
    lm = luma_mode.to(torch.int64)
    bp = bpred.to(torch.int64)
    implied = _t(_IMPLIED_BMODE, dev)[lm.clamp(max=3)]
    eff = torch.where((lm == 4)[:, None], bp, implied[:, None])
    grid = eff.reshape(mbh, mbw, 4, 4).transpose(1, 2).reshape(mbh * 4, mbw * 4)
    top = torch.cat([torch.zeros_like(grid[:1]), grid[:-1]], dim=0)
    left = torch.cat([torch.zeros_like(grid[:, :1]), grid[:, :-1]], dim=1)

    def unmb(g):
        return g.reshape(mbh, 4, mbw, 4).transpose(1, 2).reshape(nmb, 16)

    top_m, left_m = unmb(top), unmb(left)

    def path(ln, bit, node, max_len, sym):
        k = torch.arange(max_len, device=dev)
        return (_t(bit, dev)[sym[..., None], k], _t(node, dev)[sym[..., None], k],
                k < _t(ln, dev)[sym][..., None])

    sid = segment_ids.to(torch.int64)
    seg_bit, seg_node, seg_valid = path(_SEG_LN, _SEG_BIT, _SEG_NODE, _SEG_MAX, sid)
    seg_prob = torch.as_tensor(seg_probs3, device=dev).to(torch.int64)[seg_node]
    seg_valid = seg_valid & bool(write_segments)

    sk_bit = skipped.to(torch.int64)[:, None]
    sk_prob = torch.full_like(sk_bit, int(skip_prob))
    sk_valid = torch.ones_like(sk_bit, dtype=torch.bool)

    ym_bit, ym_node, ym_valid = path(_YM_LN, _YM_BIT, _YM_NODE, _YM_MAX, lm)
    ym_prob = _t(_YM_PROBS, dev)[ym_node]

    bp_bit, bp_node, bp_valid = path(_BP_LN, _BP_BIT, _BP_NODE, _BP_MAX, bp)  # [nmb, 16, K]
    bp_prob = _t(_BP_PROBS, dev)[top_m[..., None], left_m[..., None], bp_node]
    bp_valid = bp_valid & (lm == 4)[:, None, None]

    cm = chroma_mode.to(torch.int64)
    uv_bit, uv_node, uv_valid = path(_UV_LN, _UV_BIT, _UV_NODE, _UV_MAX, cm)
    uv_prob = _t(_UV_PROBS, dev)[uv_node]

    def lay(parts):
        return torch.cat([parts[0], parts[1], parts[2], parts[3].reshape(nmb, -1), parts[4]],
                         dim=-1)

    prob = lay([seg_prob, sk_prob, ym_prob, bp_prob, uv_prob]).to(torch.int32)
    bit = lay([seg_bit, sk_bit, ym_bit, bp_bit, uv_bit]).to(torch.int32)
    valid = lay([seg_valid, sk_valid, ym_valid, bp_valid, uv_valid])
    return prob, bit, valid


def header_op_capacity(nmb: int) -> int:
    """K14's op-stream slots an image: nmb * HEADER_SLOTS rounded up to whole
    16-byte vectors of eight ops, so that no MB's ops can overflow it."""
    return -(-nmb * HEADER_SLOTS // 8) * 8


def _path_ops(ln, bit, node, sym: int, probs) -> list:
    """Symbol `sym`'s tree path as ops prob | bit << 8, node k's probability
    probs[node]."""
    return [int(probs[node[sym, k]]) | int(bit[sym, k]) << 8 for k in range(ln[sym])]


def _mb_header_ops(lm, bp, cm, sid, sk, m: int, mbw: int, seg_probs, skip_prob: int,
                   write_segments: bool) -> list:
    """MB m's header ops as K14's thread writes them (`write_mb`): segment
    id, skip flag, luma mode, the 16 B modes in raster order under their
    (top, left) mode contexts, chroma mode."""
    mx, my = m % mbw, m // mbw

    def ctx(n, k):  # the B-mode context of sub-block k of MB n
        return bp[n, k] if lm[n] == 4 else _IMPLIED_BMODE[lm[n]]

    ops = _path_ops(_SEG_LN, _SEG_BIT, _SEG_NODE, sid[m], seg_probs) if write_segments else []
    ops.append(int(skip_prob) | int(sk[m] != 0) << 8)
    ops += _path_ops(_YM_LN, _YM_BIT, _YM_NODE, lm[m], _YM_PROBS)
    if lm[m] == 4:
        for s in range(16):
            sy, sx = s >> 2, s & 3
            top = bp[m, s - 4] if sy > 0 else (ctx(m - mbw, 12 + sx) if my > 0 else 0)
            left = bp[m, s - 1] if sx > 0 else (ctx(m - 1, 4 * sy + 3) if mx > 0 else 0)
            ops += _path_ops(_BP_LN, _BP_BIT, _BP_NODE, bp[m, s], _BP_PROBS[top, left])
    return ops + _path_ops(_UV_LN, _UV_BIT, _UV_NODE, cm[m], _UV_PROBS)


def header_stream_plain(luma_mode, bpred, chroma_mode, segment_ids, skipped, params, mbw: int,
                        mbh: int):
    """K14's count and write phases on the host (CPU tensors, as
    `encode_mb_headers` takes them): per image each MB's op count from the
    path lengths (`mb_op_count`) and their exclusive scan, int64 [B, nmb],
    and the op stream int64 [B, header_op_capacity(nmb)], prob | bit << 8,
    each MB's ops written at its start (zero past the last op)."""
    B, nmb = luma_mode.shape
    fields = [t.numpy().astype(np.int64) for t in (luma_mode, bpred, chroma_mode, segment_ids,
                                                   skipped)]
    counts = np.zeros((B, nmb), np.int64)
    stream = np.zeros((B, header_op_capacity(nmb)), np.int64)
    for b, (ws, p0, p1, p2, skip_prob) in enumerate(params[:, :5].tolist()):
        lm, bp, cm, sid, sk = (f[b] for f in fields)
        counts[b] = ((_SEG_LN[sid] if ws else 0) + 1 + _YM_LN[lm] + _UV_LN[cm]
                     + np.where(lm == 4, _BP_LN[bp].sum(-1), 0))
        starts = np.cumsum(counts[b]) - counts[b]
        for m in range(nmb):
            ops = _mb_header_ops(lm, bp, cm, sid, sk, m, mbw, [p0, p1, p2], skip_prob, bool(ws))
            stream[b, starts[m]:starts[m] + len(ops)] = ops
    starts = np.cumsum(counts, axis=1) - counts
    return torch.from_numpy(counts), torch.from_numpy(starts), torch.from_numpy(stream)


def encode_mb_headers_phases_plain(luma_mode, bpred, chroma_mode, segment_ids, skipped, params,
                                   mbw: int, mbh: int, max_bytes: int) -> Lanes:
    """K14's phases on the host (CPU tensors): `header_stream_plain`'s
    stream, coded with the device step (`boolenc2.lane_coder_plain`) from
    each image's frame-header state; equals `encode_mb_headers_plain`."""
    counts, _, stream = header_stream_plain(luma_mode, bpred, chroma_mode, segment_ids, skipped,
                                            params, mbw, mbh)
    ops = stream.T
    valid = torch.arange(ops.shape[0])[:, None] < counts.sum(1)[None]
    return lane_coder_plain(ops >> 8, ops & 0xFF, valid, max_bytes, params[:, 5:8].T)


def header_params(write_segments, seg_probs, skip_prob, init_state, device) -> torch.Tensor:
    """Per-image MB-header parameters int64 [B, 8] on `device` from host
    values: write_segments [B], the segment-tree probabilities [B, 3],
    skip_prob [B] and the frame-header coder's (bottom, range, bit_num), each
    [B]."""
    cols = [np.asarray(write_segments, np.int64)[:, None],
            np.asarray(seg_probs, np.int64).reshape(-1, 3),
            np.asarray(skip_prob, np.int64)[:, None],
            np.asarray(init_state, np.int64).reshape(3, -1).T]
    return _build.upload(np.concatenate(cols, axis=1), device)


def encode_mb_headers_plain(luma_mode, bpred, chroma_mode, segment_ids, skipped, params,
                            mbw: int, mbh: int, max_bytes: int) -> Lanes:
    """Torch twin of K14 (any device): one lane per image, [B]."""
    dev = luma_mode.device
    streams = []
    for b, (ws, p0, p1, p2, skip_prob) in enumerate(params[:, :5].tolist()):
        prob, bit, valid = header_ops(luma_mode[b], bpred[b], chroma_mode[b], segment_ids[b],
                                      skipped[b], [p0, p1, p2], skip_prob, bool(ws), mbw, mbh)
        ok = valid.reshape(-1)
        streams.append((bit.reshape(-1)[ok], prob.reshape(-1)[ok]))
    return bool_encode_lanes_plain(*_pad_lanes(streams, dev), max_bytes, params[:, 5:8].T)


def encode_mb_headers(luma_mode, bpred, chroma_mode, segment_ids, skipped, params, mbw: int,
                      mbh: int, capacity: int = None) -> Lanes:
    """Every image's MB headers, continuing its frame-header coder:
    luma_mode, chroma_mode [B, nmb] and bpred [B, nmb, 16] uint8, segment_ids
    [B, nmb] uint8 (None: all 0), skipped [B, nmb] bool and the images'
    `header_params` [B, 8], on one device.  Returns `Lanes` [B] (data [B,
    largest n_bytes]).  K14 for CUDA tensors, the plain twin for CPU ones;
    `capacity` bytes per image first (default `header_budget`)."""
    B, nmb = luma_mode.shape
    if nmb != mbw * mbh:
        raise ValueError(f"{nmb} MBs for a {mbw}x{mbh} grid")
    if segment_ids is None:
        if bool(params[:, 0].any()):
            raise ValueError("writing the segment map needs segment_ids")
        segment_ids = torch.zeros_like(luma_mode)
    dev = _build.same_device(luma_mode, bpred, chroma_mode, segment_ids, skipped, params)
    if capacity is None:
        capacity = header_budget(nmb)
    coder = encode_mb_headers_plain if dev.type == "cpu" else _mb_headers_kernel
    return _capacity_run(lambda cap: coder(luma_mode, bpred, chroma_mode, segment_ids, skipped,
                                           params, mbw, mbh, cap), capacity)


def _mb_headers_kernel(luma_mode, bpred, chroma_mode, segment_ids, skipped, params, mbw, mbh,
                       cap) -> Lanes:
    dev = luma_mode.device
    B, nmb = luma_mode.shape
    info = torch.empty((B, 6), dtype=torch.int64, device=dev)
    data = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    carries = torch.empty((B, carry_words(cap)), dtype=torch.int32, device=dev)
    op_cap = header_op_capacity(nmb)
    ops = torch.empty((B, op_cap), dtype=torch.int16, device=dev)
    consts = _build.device_constant("header_consts", HEADER_CONSTS_NP, dev)
    _build.launch(
        "mb_headers", "webp_mb_headers", dev,
        *_build.mb_field(luma_mode, B, nmb), *_build.mb_field(bpred, B, nmb, 16),
        *_build.mb_field(chroma_mode, B, nmb), *_build.mb_field(segment_ids, B, nmb),
        *_build.mb_field(skipped, B, nmb),
        _build.dense(params, torch.int64, (B, 8)),
        _build.dense(consts, torch.int32, (consts.numel(),)), consts.numel(),
        mbw, mbh, B, cap, data.data_ptr(), carries.data_ptr(), ops.data_ptr(), op_cap,
        info.data_ptr(),
    )
    return Lanes.from_fields(info, data)
