"""The encode wire: pass 2's per-MB arrays packed into one uint8 row per image
on the device, and unpacked on the host.

The counterpart of `webp_tpu/ops/encode_wavefront2.py:1024-1301` (the device
half) and `:1499-1600` (the host half).  Two kernels and the pack of
`ops/sparse.py` carry the device half:

- K18 `prepack` replaces `:1028` `_prepack_body` (jitted as `:1076`
  `_prepack_batch` and `:1087` `_prepack_batch_pertbl`): the levels of K5's
  output as [y 256 | uv 128 | y2 16] per MB, clipped to int8 (`lv8`), the
  first N_ESC positions of each MB with |level| > 127 and their values
  (padding -1 / 0; `overflow[b]` when an MB of image b has more), and
  `meta8` = [bpred 16, luma mode, chroma mode].
- K19 `pack_levels` (`ops/sparse.py`): each MB's nonzero bitmap and its
  first CAP_MB nonzeros in slot order (`:1113`, `sparse.py:73`).
- `prepack_pack`: K18 then K19 at CAP_MB in one launch, K19 taking K18's
  clipped levels from registers, as the JAX package runs both stages in
  one program (`:1286`); the main path's call.
- K20 `wire` replaces `:1200` `_wire_stage` with `:1178` `_rank_compact`
  and `:1149` `_i16_le_bytes`: the int4 nibbles of the packed values (low
  nibble for the even slot), the per-MB list of the |v| > 7 slots (slot
  u8, value i8, up to MED_CAP), the image's list of the per-MB escapes in
  (MB, k) order at their positions mb * 400 + pos (i32 LE, i16 LE, up to
  ESC_IMG, padding 0 / 0), and the flags [sp_over | a med list over its
  cap, overflow | the image list over its cap], all in one row of
  `wire_bytes(nmb)` bytes at `split_wire`'s offsets.

The JAX package compacts the lists with float32 one-hot matmuls, exact only
while a position stays below 2^24 (nmb <= 41,943); every compaction here
ranks in integers.  `encode_analysis_batch_packed` is K5 followed by the
fused K18 + K19 and K20, for `:1260` `encode_analysis_batch_v2_packed` and
`:1286` `encode_analysis_batch_v2_pertbl_packed` both: the port's K5 takes shared
or per-image tables alike.  The wrappers launch the CUDA kernels
(`csrc/wire.cu`) for CUDA tensors and run the `*_plain` torch twins for
CPU ones.

The host half is numpy: `split_wire`, `unpack_wire` (the C++
`wire_expand_levels` of `native/vp8_entropy.cpp`, then the image escape
list), `unpack_dense_wire` (an sp_over image: its dense lv8 row plus the
list), `unpack_analysis` (a prepack 5-tuple's row) and `split_levels`;
`numpy_wire_expand` is the C++ expansion's numpy twin, for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..io import native
from .encode_wavefront import encode_analysis_batch
from .sparse import compact, host_expand_levels_mb, pack_levels_mb, pack_levels_mb_plain

N_ESC = 4  # per-MB escapes (|level| > 127) the prepack keeps
CAP_MB = 256  # per-MB nonzeros the wire packs
MED_CAP = 32  # per-MB |v| > 7 entries the wire lists
ESC_IMG = 512  # escapes the wire lists per image
SLOTS = 400  # levels per MB: Y 256 | UV 128 | Y2 16
META = 18  # bpred 16, luma mode, chroma mode
WIRE_MBS = 32  # MBs a CTA of kernel K20 takes (`csrc/wire.cu` kWireMbs)


def wire_bytes(nmb: int) -> int:
    """Bytes of one image's wire row: flags 2, then per MB the bitmap (50),
    the int4 values (CAP_MB / 2), the med list (MED_CAP slots u8 + MED_CAP
    values i8) and meta8 (18), then the image escape list (ESC_IMG x (i32 +
    i16))."""
    return 2 + nmb * (SLOTS // 8 + CAP_MB // 2 + 2 * MED_CAP + META) + ESC_IMG * 6


def _levels400(arrays) -> torch.Tensor:
    """K5's levels as int32 [B, nmb, 400]: y 256 | uv 128 | y2 16."""
    B, nmb = arrays["luma_mode"].shape
    return torch.cat([arrays["y_levels"].reshape(B, nmb, 256),
                      arrays["uv_levels"].reshape(B, nmb, 128),
                      arrays["y2_levels"]], dim=-1).to(torch.int32)


def prepack_plain(arrays):
    """Torch twin of kernel K18 (any device)."""
    lv = _levels400(arrays)
    iota = torch.arange(1, SLOTS + 1, dtype=torch.int32, device=lv.device).expand_as(lv)
    (pos1, val), over = compact(lv.abs() > 127, N_ESC, iota, lv)
    meta8 = torch.cat([arrays["bpred"], arrays["luma_mode"][..., None],
                       arrays["chroma_mode"][..., None]], dim=-1).to(torch.uint8)
    return (lv.clamp(-128, 127).to(torch.int8), meta8, (pos1 - 1).to(torch.int16),
            val.to(torch.int16), over.any(-1))


def prepack(arrays):
    """K5's output dict (int16 levels, uint8 modes, [B, nmb, ...]) -> (lv8
    int8 [B, nmb, 400], meta8 uint8 [B, nmb, 18], esc_pos, esc_val int16
    [B, nmb, N_ESC], overflow bool [B]), on the arrays' device."""
    if _arrays_device(arrays).type == "cpu":
        return prepack_plain(arrays)
    pre, args = _prepack_args(arrays)
    _build.launch("prepack", "webp_prepack", pre[0].device, *args)
    return pre


def prepack_pack_plain(arrays):
    """Torch twin of the fused K18 + K19 kernel (any device)."""
    pre = prepack_plain(arrays)
    return (*pre, *pack_levels_mb_plain(pre[0], CAP_MB))


def prepack_pack(arrays):
    """K18 then K19 at CAP_MB in one launch: `prepack`'s 5-tuple, then
    `pack_levels_mb(lv8, CAP_MB)`'s (bitmap uint8 [B, nmb*50], vals int8
    [B, nmb, CAP_MB], sp_over bool [B])."""
    if _arrays_device(arrays).type == "cpu":
        return prepack_pack_plain(arrays)
    pre, args = _prepack_args(arrays)
    B, nmb = pre[0].shape[:2]
    dev = pre[0].device
    bitmap = torch.empty((B, nmb * SLOTS // 8), dtype=torch.uint8, device=dev)
    vals = torch.empty((B, nmb, CAP_MB), dtype=torch.int8, device=dev)
    sp_over = torch.zeros(B, dtype=torch.bool, device=dev)
    _build.launch("prepack_pack", "webp_prepack_pack", dev, *args, bitmap.data_ptr(),
                  vals.data_ptr(), sp_over.data_ptr())
    return (*pre, bitmap, vals, sp_over)


def _arrays_device(arrays):
    return _build.same_device(*(arrays[k] for k in ("luma_mode", "chroma_mode", "bpred",
                                                    "y_levels", "y2_levels", "uv_levels")))


def _prepack_args(arrays):
    """K18's outputs, allocated, and its C entry point's arguments before
    the stream: the levels 16-byte aligned, the per-MB fields as views."""
    lm = arrays["luma_mode"]
    dev = lm.device
    B, nmb = lm.shape
    lv8 = torch.empty((B, nmb, SLOTS), dtype=torch.int8, device=dev)
    meta8 = torch.empty((B, nmb, META), dtype=torch.uint8, device=dev)
    esc_pos = torch.empty((B, nmb, N_ESC), dtype=torch.int16, device=dev)
    esc_val = torch.empty((B, nmb, N_ESC), dtype=torch.int16, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    levels = [_build.aligned(_build.dense(arrays[k], torch.int16, (B, nmb, *shape)), 16, k)
              for k, shape in (("y_levels", (16, 16)), ("uv_levels", (8, 16)),
                               ("y2_levels", (16,)))]
    args = (*levels, *_build.mb_field(lm, B, nmb),
            *_build.mb_field(arrays["chroma_mode"], B, nmb),
            *_build.mb_field(arrays["bpred"], B, nmb, 16),
            nmb, B, lv8.data_ptr(), meta8.data_ptr(), esc_pos.data_ptr(), esc_val.data_ptr(),
            over.data_ptr())
    return (lv8, meta8, esc_pos, esc_val, over), args


def escape_list(esc_pos: torch.Tensor, esc_val: torch.Tensor):
    """The image escape list of the per-MB pairs esc_pos / esc_val [B, nmb,
    n] (position -1: none): (positions mb * 400 + pos int32 [B, ESC_IMG],
    values int16 [B, ESC_IMG], over bool [B]), in (MB, k) order, zero
    padded."""
    B, nmb, _ = esc_pos.shape
    p = esc_pos.to(torch.int32)
    mb = torch.arange(nmb, dtype=torch.int32, device=p.device)[None, :, None]
    (pos, val), over = compact((p >= 0).reshape(B, -1), ESC_IMG, (mb * SLOTS + p).reshape(B, -1),
                               esc_val.to(torch.int32).reshape(B, -1))
    return pos, val.to(torch.int16), over


def _le_bytes(x: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [B, k] -> uint8 [B, k*n], each value's n low bytes, little-endian."""
    return torch.stack([(x >> (8 * i)) & 0xFF for i in range(n)], dim=-1).to(
        torch.uint8).reshape(x.shape[0], -1)


def wire_plain(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow):
    """Torch twin of kernel K20 (any device)."""
    B, nmb, _ = vals.shape
    v = vals.to(torch.int32)
    nib = v & 0xF
    vals4 = (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)
    ks = torch.arange(CAP_MB, dtype=torch.int32, device=v.device).expand_as(v)
    (med_idx, med_val), med_over = compact(v.abs() > 7, MED_CAP, ks, v & 0xFF)
    eg_pos, eg_val, eg_over = escape_list(esc_pos, esc_val)
    flags = torch.stack([sp_over | med_over.any(-1), overflow | eg_over], dim=-1)
    return torch.cat([flags.to(torch.uint8), bitmap.reshape(B, -1), vals4.reshape(B, -1),
                      med_idx.to(torch.uint8).reshape(B, -1), med_val.to(torch.uint8).reshape(B, -1),
                      meta8.reshape(B, -1), _le_bytes(eg_pos, 4),
                      _le_bytes(eg_val.to(torch.int32), 2)], dim=-1)


def wire(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow):
    """K19's pack (bitmap uint8 [B, nmb*50], vals int8 [B, nmb, CAP_MB],
    sp_over bool [B]) and K18's meta8, esc_pos, esc_val and overflow ->
    the wire rows uint8 [B, wire_bytes(nmb)]."""
    B, nmb, cap = vals.shape
    if cap != CAP_MB:
        raise ValueError(f"the wire packs {CAP_MB} values per MB, got {cap}")
    dev = _build.same_device(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow)
    if dev.type == "cpu":
        return wire_plain(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow)
    return _wire_kernel(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow)


def _wire_kernel(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow):
    dev = vals.device
    B, nmb, _ = vals.shape
    for name, t in (("sp_over", sp_over), ("overflow", overflow)):
        if t.dtype != torch.bool or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be bool [{B}], got {t.dtype} {tuple(t.shape)}")
    out = torch.empty((B, wire_bytes(nmb)), dtype=torch.uint8, device=dev)
    # A ticket word an image: the image's last MB CTA writes its sp_over
    # flag byte.
    tickets = _build.kept_zeroed("wire", B, torch.int64, dev)
    _build.launch(
        "wire", "webp_wire", dev,
        _build.aligned(_build.dense(bitmap, torch.uint8, (B, nmb * SLOTS // 8)), 2, "bitmap"),
        _build.aligned(_build.dense(vals, torch.int8, (B, nmb, CAP_MB)), 8, "vals"),
        _build.aligned(_build.dense(meta8, torch.uint8, (B, nmb, META)), 2, "meta8"),
        _build.aligned(_build.dense(esc_pos, torch.int16, (B, nmb, N_ESC)), 8, "esc_pos"),
        _build.aligned(_build.dense(esc_val, torch.int16, (B, nmb, N_ESC)), 8, "esc_val"),
        sp_over.data_ptr(), overflow.data_ptr(), nmb, B, tickets.data_ptr(), out.data_ptr(),
    )
    return out


def wire_stage(lv8, meta8, esc_pos, esc_val, overflow):
    """K19 then K20: a prepack's 5-tuple -> the wire rows uint8 [B,
    wire_bytes(nmb)]."""
    bitmap, vals, sp_over = pack_levels_mb(lv8, CAP_MB)
    return wire(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow)


def encode_analysis_batch_packed(y, u, v, P, tbl, n_try: int, do_trellis: bool = False,
                                 sid=None):
    """K5 (`encode_analysis_batch`'s arguments), then the fused K18 + K19
    and K20: (lv8 int8 [B, nmb, 400], wire uint8 [B, wire_bytes(nmb)], K5's
    arrays), all on the planes' device."""
    arrays = encode_analysis_batch(y, u, v, P, tbl, n_try, do_trellis, sid)
    lv8, meta8, esc_pos, esc_val, overflow, bitmap, vals, sp_over = prepack_pack(arrays)
    return lv8, wire(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow), arrays


# ---------------------------------------------------------------------------
# host half (numpy, one image)
# ---------------------------------------------------------------------------


def split_wire(wire_row: np.ndarray, nmb: int):
    """Views of one image's wire row: (sp_over, overflow, bitmap [nmb*50],
    vals4 [nmb, CAP_MB/2] u8, med_idx [nmb, MED_CAP] u8, med_val [nmb,
    MED_CAP] i8, meta8 [nmb, 18], eg_pos [ESC_IMG] i32, eg_val [ESC_IMG] i16)."""
    o = 2
    sp_over, overflow = bool(wire_row[0]), bool(wire_row[1])
    bitmap = wire_row[o: o + nmb * 50]
    o += nmb * 50
    vals4 = wire_row[o: o + nmb * (CAP_MB // 2)].reshape(nmb, CAP_MB // 2)
    o += nmb * (CAP_MB // 2)
    med_idx = wire_row[o: o + nmb * MED_CAP].reshape(nmb, MED_CAP)
    o += nmb * MED_CAP
    med_val = wire_row[o: o + nmb * MED_CAP].view(np.int8).reshape(nmb, MED_CAP)
    o += nmb * MED_CAP
    meta8 = wire_row[o: o + nmb * META].reshape(nmb, META)
    o += nmb * META
    eg_pos = wire_row[o: o + ESC_IMG * 4].view("<i4")
    o += ESC_IMG * 4
    eg_val = wire_row[o: o + ESC_IMG * 2].view("<i2")
    return sp_over, overflow, bitmap, vals4, med_idx, med_val, meta8, eg_pos, eg_val


def split_levels(lv: np.ndarray, meta8: np.ndarray) -> dict:
    """[nmb, 400] int32 levels + meta8 -> the per-image arrays dict (int32)."""
    nmb = lv.shape[0]
    return dict(
        y_levels=lv[:, :256].reshape(nmb, 16, 16),
        uv_levels=lv[:, 256:384].reshape(nmb, 8, 16),
        y2_levels=lv[:, 384:],
        bpred=meta8[:, :16].astype(np.int32),
        luma_mode=meta8[:, 16].astype(np.int32),
        chroma_mode=meta8[:, 17].astype(np.int32),
    )


def _with_escapes(lv: np.ndarray, eg_pos: np.ndarray, eg_val: np.ndarray) -> np.ndarray:
    """Flat int32 levels with the image escape list applied (padding
    entries carry value 0; a real escape's |value| is above 127)."""
    live = eg_val != 0
    lv[eg_pos[live]] = eg_val[live]
    return lv


def unpack_wire(wire_row: np.ndarray, nmb: int) -> dict:
    """One image's wire row (not sp_over) -> its arrays dict: the C++
    expansion of the bitmap, nibbles and med list, then the escape list."""
    _, _, bitmap, vals4, med_idx, med_val, meta8, eg_pos, eg_val = split_wire(wire_row, nmb)
    lv = native.wire_expand_levels(bitmap, vals4, med_idx, med_val, nmb)
    lv = _with_escapes(lv.reshape(-1).astype(np.int32), eg_pos, eg_val)
    return split_levels(lv.reshape(nmb, SLOTS), meta8)


def unpack_dense_wire(lv8_row: np.ndarray, wire_row: np.ndarray, nmb: int) -> dict:
    """An sp_over image: its dense int8 levels row [nmb, 400] plus the wire
    row's escape list and meta8 -> its arrays dict."""
    *_, meta8, eg_pos, eg_val = split_wire(wire_row, nmb)
    lv = _with_escapes(lv8_row.reshape(-1).astype(np.int32), eg_pos, eg_val)
    return split_levels(lv.reshape(nmb, SLOTS), meta8)


def unpack_analysis(lv8, meta8, esc_pos, esc_val) -> dict:
    """One image's row of a prepack 5-tuple (numpy [nmb, ...]) -> its arrays
    dict."""
    lv = lv8.astype(np.int32)
    for k in range(esc_pos.shape[1]):
        sel = np.flatnonzero(esc_pos[:, k] >= 0)
        lv[sel, esc_pos[sel, k].astype(np.int64)] = esc_val[sel, k]
    return split_levels(lv, meta8)


def numpy_wire_expand(bitmap, vals4, med_idx, med_val, nmb: int) -> np.ndarray:
    """Numpy twin of the C++ `wire_expand_levels`: int16 levels [nmb, 400]."""
    nib = np.empty((nmb, CAP_MB), np.int32)
    nib[:, 0::2] = vals4 & 0xF
    nib[:, 1::2] = vals4 >> 4
    nib = np.where(nib >= 8, nib - 16, nib)  # two's complement int4
    rows, cols = np.nonzero(med_val != 0)  # padding entries carry value 0
    nib[rows, med_idx[rows, cols].astype(np.int64)] = med_val[rows, cols]
    return host_expand_levels_mb(bitmap, nib.astype(np.int8), nmb, SLOTS).astype(np.int16)
