"""Batched lossy VP8 decode on a torch device.

The host runs the serial entropy pass (the C++ levels-mode parser of
`native/vp8_entropy.cpp`, bound in `io/native.py`) into packed batch
buffers; `to_device_batch` uploads them, and `decode_core` runs three
launches: K1 levels -> residuals (`ops/residual.py`), K2 prediction +
residue fused with K3's loop filter (`ops/recon_filter.py`, as the JAX
package's `decode_frames_fused_v2`) and K4 fancy upsampling + YUV -> RGB
(`ops/yuv.py`).  Bit-exact with the scalar
`Vp8Decoder` of the JAX package and with its `webp_tpu/decode/device.py`,
whose host half is rebuilt here; nothing here imports that package.

Every entry point takes an explicit `device`.  On a CPU device the kernels'
plain torch twins run; on a CUDA device the kernels run, or the call raises.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, spans
from ..io import native
from ..ops.recon_filter import recon_filter_
from ..ops.residual import SLOTS, residuals_dense, residuals_sparse
from ..ops.sparse import host_pack_levels_mb
from ..ops.yuv import fancy_yuv420_to_rgb, simple_yuv420_to_rgb

N_ESC_DEC = 4096  # per-image escape budget of the sparse upload (|level| > 127)
CAP_MB_DEC = 256  # per-MB nonzero cap of the sparse upload

# Arrays uploaded for each level form.
SPARSE_KEYS = ("bitmap", "vals", "esc_pos", "esc_val", "qtab", "u8buf")
DENSE_KEYS = ("i16buf", "u8buf")


def filter_params_from_header(header, seg, segment_ids, luma_mode):
    """Per-MB (level, interior, hev) from levels-mode header arrays.

    Mirrors `Vp8Decoder.filter_params_arrays`.
    """
    filter_level = int(header[5])
    sharpness = int(header[6])
    lf_adjust = bool(header[7])
    ref_delta0, mode_delta0 = int(header[8]), int(header[9])
    segments_enabled = bool(header[10])
    seg_lf = seg[:, 1].astype(np.int32)
    seg_delta = np.array([bool(header[12] & (1 << i)) for i in range(4)])
    sid = segment_ids.astype(np.int32)
    nmb = len(segment_ids)
    level = np.full(nmb, filter_level, np.int32)
    if segments_enabled:
        level = np.where(seg_delta[sid], filter_level + seg_lf[sid], seg_lf[sid])
    level = np.clip(level, 0, 63)
    if lf_adjust:
        level = level + ref_delta0 + np.where(luma_mode == 4, mode_delta0, 0)
    level = np.clip(level, 0, 63)
    interior = level.copy()
    if sharpness > 0:
        interior >>= 2 if sharpness > 4 else 1
        interior = np.minimum(interior, 9 - sharpness)
    interior = np.maximum(interior, 1)
    hev = np.where(level >= 40, 2, np.where(level >= 15, 1, 0)).astype(np.int32)
    if filter_level == 0:
        level = np.zeros(nmb, np.int32)
    return level, interior, hev


def u8_fields(nmb):
    """Layout of an image's row of the packed per-MB uint8 buffer:
    name -> (offset, width), and the row length.  The same layout as the
    JAX package's, so one host parse feeds both."""
    names = [
        ("luma_mode", 1), ("chroma_mode", 1), ("segment_ids", 1),
        ("skipped", 1), ("non_zero", 1), ("level", 1), ("interior", 1),
        ("hev", 1), ("bpred", 16),
    ]
    out, off = {}, 0
    for name, width in names:
        out[name] = (off, width)
        off += nmb * width
    return out, off


def field_views(u8buf, nmb):
    """name -> view [B, nmb] (bpred [B, nmb, 16]) of a packed u8 buffer
    (numpy array or tensor)."""
    fields, _ = u8_fields(nmb)
    B = u8buf.shape[0]
    out = {}
    for name, (off, width) in fields.items():
        v = u8buf[:, off : off + nmb * width]
        out[name] = v if width == 1 else v.reshape(B, nmb, width)
    return out


class Frame(NamedTuple):
    """One decoded frame: its size and its filtered planes (uint8, MB-padded:
    ybuf [mbh*16, mbw*16], ubuf / vbuf [mbh*8, mbw*8])."""

    width: int
    height: int
    ybuf: np.ndarray
    ubuf: np.ndarray
    vbuf: np.ndarray


def narrow_levels(levels, nmb):
    """int16 levels [nmb*400] -> the sparse form of their int8 clip plus the
    escape list of |level| > 127: (bitmap, vals, esc_pos, esc_val).  bitmap
    and vals are None when an MB overflows CAP_MB_DEC, esc_pos and esc_val
    when the escapes overflow N_ESC_DEC.  Unused escape slots hold the
    sentinel nmb*400, after the used ones, which ascend."""
    i8 = np.clip(levels, -128, 127).astype(np.int8)
    bitmap, vals, ok = host_pack_levels_mb(i8, nmb, SLOTS, CAP_MB_DEC)
    if not ok:
        bitmap = vals = None
    big = np.flatnonzero(np.abs(levels) > 127)
    if len(big) > N_ESC_DEC:
        return bitmap, vals, None, None
    esc_pos = np.full(N_ESC_DEC, nmb * SLOTS, np.int32)
    esc_val = np.zeros(N_ESC_DEC, np.int16)
    esc_pos[: len(big)] = big
    esc_val[: len(big)] = levels[big]
    return bitmap, vals, esc_pos, esc_val


def _parse_levels(payloads):
    """The levels-mode entropy pass over payloads of one frame size, each
    image's frame header as it was coded (`parse_levels_batch`)."""
    B = len(payloads)
    dims = [native.parse_dims(p) for p in payloads]
    if len(set(dims)) > 1:  # the buffers below are sized for image 0
        raise ValueError(f"mixed frame sizes in decode batch: {sorted(set(dims))}")
    w, h = dims[0]
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    nmb = mbw * mbh

    i16buf = np.zeros((B, nmb * SLOTS + 4 * SLOTS), np.int16)
    bitmap = np.zeros((B, nmb * SLOTS // 8), np.uint8)
    vals = np.zeros((B, nmb, CAP_MB_DEC), np.int8)
    esc_pos = np.full((B, N_ESC_DEC), nmb * SLOTS, np.int32)
    esc_val = np.zeros((B, N_ESC_DEC), np.int16)
    sparse_ok = np.zeros(B, bool)
    _, u8_row = u8_fields(nmb)
    u8buf = np.zeros((B, u8_row), np.uint8)
    headers = np.zeros((B, 16), np.int32)
    segs = np.zeros((B, 4, 8), np.int32)
    fv = field_views(u8buf, nmb)

    def one(b):
        levels = i16buf[b, : nmb * SLOTS]
        with spans.span("dec.entropy"):
            native.entropy_decode16_into(
                payloads[b], headers[b], segs[b].reshape(-1),
                fv["luma_mode"][b], fv["chroma_mode"][b], fv["segment_ids"][b],
                fv["bpred"][b].reshape(-1), fv["skipped"][b], fv["non_zero"][b], levels,
            )
        if headers[b][2] != mbw or headers[b][3] != mbh:
            raise ValueError("mixed geometries in decode batch")
        # Per-(segment, block, position) dequant factors: blocks 0-15 luma
        # (ydc/yac), 16-23 chroma (uvdc/uvac), 24 Y2 (y2dc/y2ac).
        qtab = i16buf[b, nmb * SLOTS :].reshape(4, 25, 16)
        for s in range(4):
            ydc, yac, y2dc, y2ac, uvdc, uvac = segs[b, s, 2:8]
            qtab[s, :16, 0] = ydc
            qtab[s, :16, 1:] = yac
            qtab[s, 16:24, 0] = uvdc
            qtab[s, 16:24, 1:] = uvac
            qtab[s, 24, 0] = y2dc
            qtab[s, 24, 1:] = y2ac
        lv, it, hv = filter_params_from_header(
            headers[b], segs[b], fv["segment_ids"][b], fv["luma_mode"][b]
        )
        fv["level"][b] = lv
        fv["interior"][b] = it
        fv["hev"][b] = hv
        with spans.span("dec.narrow"):
            bm, vl, ep, ev = narrow_levels(levels, nmb)
        if bm is not None and ep is not None:
            bitmap[b], vals[b], esc_pos[b], esc_val[b] = bm, vl, ep, ev
            sparse_ok[b] = True

    with ThreadPoolExecutor(max_workers=max(1, min(B, os.cpu_count() or 1))) as pool:
        list(pool.map(spans.task(one), range(B)))
    return dict(i16buf=i16buf, bitmap=bitmap, vals=vals, esc_pos=esc_pos, esc_val=esc_val,
                u8buf=u8buf, headers=headers, segs=segs, sparse_ok=sparse_ok)


def _finish(parsed, idxs=None):
    """The batch of `parse_levels_batch` from `_parse_levels`'s arrays, of
    the images `idxs` (all when None)."""
    if idxs is not None:
        parsed = {k: v[idxs] for k, v in parsed.items()}
    geometry(parsed["headers"])
    sparse = bool(parsed["sparse_ok"].all())
    nmb = parsed["vals"].shape[1]
    return dict(
        i16buf=parsed["i16buf"],
        bitmap=parsed["bitmap"] if sparse else None,
        vals=parsed["vals"] if sparse else None,
        esc_pos=parsed["esc_pos"],
        esc_val=parsed["esc_val"],
        qtab=parsed["i16buf"][:, nmb * SLOTS :].copy(),
        u8buf=parsed["u8buf"],
        headers=parsed["headers"],
        segs=parsed["segs"],
    )


def parse_levels_batch(payloads):
    """Run the C++ levels-mode entropy pass over a batch of one frame: the
    same width, height and loop filter type in every image (ValueError
    otherwise, `geometry`).

    Returns numpy arrays: i16buf [B, nmb*400 + 1600] (levels, then the
    dequant table qtab [4 segments, 25 blocks, 16]), u8buf [B, nmb*24]
    (per-MB fields, `u8_fields`), headers [B, 16], segs [B, 4, 8], and the
    sparse form bitmap [B, nmb*50], vals [B, nmb, 256], esc_pos / esc_val
    [B, 4096], qtab [B, 1600].  bitmap and vals are None when any image
    overflows the sparse caps; the dense i16buf is then the upload.
    """
    return _finish(_parse_levels(payloads))


def to_device_batch(batch, device):
    """Upload the arrays of `parse_levels_batch` that the batch's level form
    needs (sparse when `bitmap` is set, else dense int16) to `device`.
    `headers` stays a host numpy array.

    Raises ValueError if a sparse batch's escape list does not ascend within
    each image (the order `narrow_levels` writes, which kernel K1 needs).
    On a CUDA device the copies do not block the host (`_build.upload`:
    pinned staging, queued on the current stream).
    """
    keys = SPARSE_KEYS if batch["bitmap"] is not None else DENSE_KEYS
    if keys is SPARSE_KEYS and (np.diff(batch["esc_pos"], axis=1) < 0).any():
        raise ValueError("esc_pos must ascend within each image")
    out = {k: _build.upload(batch[k], device) for k in keys}
    XFER["up"] += sum(int(batch[k].nbytes) for k in keys)
    out["headers"] = batch["headers"]
    return out


# Host <-> device bytes since the caller last reset them, as the JAX
# package's `webp_tpu/decode/device.py:145` XFER: "up" counts the arrays that
# `to_device_batch` uploads for the route the batch takes (the sparse levels,
# escapes, dequant table and per-MB fields, or the dense int16 levels and
# per-MB fields; `headers` stays on the host).  "down" is not counted here:
# the caller fetches the output.
XFER = {"up": 0, "down": 0}


# Header fields that one batch shares: width, height, mbw, mbh and the loop
# filter type (0 normal, 1 simple), the frame header's fields 0-4.
FRAME_FIELDS = slice(0, 5)


def geometry(headers):
    """(mbw, mbh, simple, width, height) of a batch whose headers [B, 16]
    agree on them; ValueError when an image's differ from image 0's."""
    h = np.asarray(headers)
    mixed = (h[:, FRAME_FIELDS] != h[:1, FRAME_FIELDS]).any(axis=1)
    if mixed.any():
        b = int(np.flatnonzero(mixed)[0])
        raise ValueError(f"decode batch mixes frames: image {b} has (width, height, mbw, mbh, "
                         f"simple) {tuple(h[b, FRAME_FIELDS])}, image 0 "
                         f"{tuple(h[0, FRAME_FIELDS])}")
    h0 = h[0]
    return int(h0[2]), int(h0[3]), bool(h0[4]), int(h0[0]), int(h0[1])


def split_planes(packed, mbw: int, mbh: int):
    """Views (y [B, mbh*16, mbw*16], u, v [B, mbh*8, mbw*8]) of packed planes
    [B, yh*yw + 2*ch*cw]."""
    B = packed.shape[0]
    ylen, clen = mbw * mbh * 256, mbw * mbh * 64
    y = packed[:, :ylen].reshape(B, mbh * 16, mbw * 16)
    u = packed[:, ylen : ylen + clen].reshape(B, mbh * 8, mbw * 8)
    v = packed[:, ylen + clen :].reshape(B, mbh * 8, mbw * 8)
    return y, u, v


def wavefront_inputs(dev_batch):
    """K1's residuals and the per-MB fields of an uploaded batch, the inputs
    of K2 and K3: (residuals int32 [B, nmb, 24, 16], luma_mode, bpred [B,
    nmb, 16], chroma_mode, level, interior, hev uint8 [B, nmb], do_sub bool
    [B, nmb])."""
    mbw, mbh = geometry(dev_batch["headers"])[:2]
    f = field_views(dev_batch["u8buf"], mbw * mbh)
    mb = (f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"])
    if "bitmap" in dev_batch:
        res, do_sub = residuals_sparse(
            *(dev_batch[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")), *mb
        )
    else:
        res, do_sub = residuals_dense(dev_batch["i16buf"], *mb)
    return (res, f["luma_mode"], f["bpred"], f["chroma_mode"], f["level"], f["interior"],
            f["hev"], do_sub)


def decode_core(dev_batch, out: str = "rgb"):
    """Uploaded batch -> RGB [B, h, w, 3] (out="rgb") or packed planes
    [B, yh*yw + 2*ch*cw] (out="yuv"), uint8 on the batch's device."""
    if out not in ("rgb", "yuv"):
        raise ValueError(f"out must be 'rgb' or 'yuv', not {out!r}")
    mbw, mbh, simple, width, height = geometry(dev_batch["headers"])
    res, lm, bp, cm, level, interior, hev, do_sub = wavefront_inputs(dev_batch)
    B = res.shape[0]
    packed = torch.empty((B, mbw * mbh * 384), dtype=torch.uint8, device=res.device)
    y, u, v = split_planes(packed, mbw, mbh)
    recon_filter_(y, u, v, res, lm, bp, cm, level, interior, hev, do_sub, simple)
    if out == "yuv":
        return packed
    return fancy_yuv420_to_rgb(y, u, v, width, height)


def dispatch_decode_batch(payloads, out: str = "rgb", device="cuda"):
    """Parse, upload and decode same-geometry VP8 payloads; returns the
    tensor on `device` (see `decode_core`).  The port of the JAX package's
    `webp_tpu/decode/device.py:166`: CUDA work is queued on the current
    stream and not awaited, and nothing here waits for the device, so a
    pipeline can parse and dispatch batch i+1 on one thread while another
    fetches batch i.  Spans (`spans.py`): `dec.parse` (with a
    `dec.parse.task` per image, holding `dec.entropy` and `dec.narrow`),
    `dec.upload` and `dec.launch`."""
    with spans.span("dec.parse"):
        batch = parse_levels_batch(payloads)
    with spans.span("dec.upload"):
        dev_batch = to_device_batch(batch, device)
    with spans.span("dec.launch"):
        return decode_core(dev_batch, out)


def decode_vp8_batch_device(payloads, device="cuda", device_out: bool = False):
    """Same-geometry VP8 payloads -> RGB [B, h, w, 3] (numpy, or the device
    tensor with device_out=True)."""
    rgb = dispatch_decode_batch(payloads, "rgb", device)
    return rgb if device_out else rgb.cpu().numpy()


def decode_vp8_batch_device_mixed(payloads, device="cuda", device_out: bool = False):
    """Payloads of mixed frames: one batched decode per (width, height,
    filter type), results in input order.  The filter type is coded in the
    first partition, so each frame size is parsed once and its batch then
    split by the parsed headers."""
    by_dims = {}
    for i, p in enumerate(payloads):
        by_dims.setdefault(native.parse_dims(p), []).append(i)
    out = [None] * len(payloads)
    for idxs in by_dims.values():
        parsed = _parse_levels([payloads[i] for i in idxs])
        by_filter = {}
        for j, simple in enumerate(parsed["headers"][:, 4]):
            by_filter.setdefault(int(simple), []).append(j)
        for js in by_filter.values():
            rgb = decode_core(to_device_batch(_finish(parsed, js), device), "rgb")
            rgb = rgb if device_out else rgb.cpu().numpy()
            for k, j in enumerate(js):
                out[idxs[j]] = rgb[k]
    return out


def decode_vp8_frame_device(data: bytes, device="cuda", upsampling: str = "bilinear"):
    """Decode one VP8 payload -> (Frame with the filtered planes, RGB
    [height, width, 3]), both on the host.  upsampling="bilinear" converts
    with K4 on `device`; "simple" fetches the planes and converts them on
    the host (`simple_yuv420_to_rgb`), launching no K4."""
    if upsampling not in ("bilinear", "simple"):
        raise ValueError(f"upsampling must be 'bilinear' or 'simple', not {upsampling!r}")
    batch = parse_levels_batch([data])
    mbw, mbh, _, width, height = geometry(batch["headers"])
    packed = decode_core(to_device_batch(batch, device), "yuv")
    y, u, v = split_planes(packed, mbw, mbh)
    rgb = fancy_yuv420_to_rgb(y, u, v, width, height) if upsampling == "bilinear" else None
    frame = Frame(width, height, *(p[0].cpu().numpy() for p in (y, u, v)))
    if rgb is None:
        return frame, simple_yuv420_to_rgb(frame.ybuf, frame.ubuf, frame.vbuf, width, height)
    return frame, rgb[0].cpu().numpy()


def yuv_packed_to_rgb(packed_np: np.ndarray, mbw: int, mbh: int,
                      width: int, height: int) -> np.ndarray:
    """Host half of the out="yuv" delivery: split fetched packed planes
    [B, yh*yw + 2*ch*cw] and convert each image with the native fancy
    upsampler -> RGB [B, height, width, 3]."""
    y, u, v = split_planes(packed_np, mbw, mbh)
    out = np.empty((packed_np.shape[0], height, width, 3), np.uint8)

    def one(i):
        out[i] = native.yuv420_to_rgb_fancy(y[i], u[i], v[i], width, height)

    with ThreadPoolExecutor(max_workers=max(1, min(len(out), os.cpu_count() or 1))) as pool:
        list(pool.map(one, range(len(out))))
    return out
