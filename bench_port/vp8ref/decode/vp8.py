"""Frozen copy of `webp_tpu/decode/vp8.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

VP8 (lossy WebP) keyframe decoder.

Structured TPU-first: a host entropy pass turns the boolean-coded bitstream
into dense per-macroblock mode/coefficient tensors (the serial tail), then
batched transform, raster reconstruction, loop filtering, and YUV conversion
run as array ops (`webp_tpu.ops.*`) that mirror onto the device pipeline.

Bitstream semantics per RFC 6386; behavioral parity reference:
`src/decoder/vp8.rs` (header :553-679, coefficients :872-963,
reconstruction :736-867, filtering :1172-1523).
"""

from __future__ import annotations

import numpy as np

from ..common import vp8_tables as T
from . import loopfilter as lf
from . import predict as pr
from . import transform as tx
from . import yuv as yuvops
from .booldec import BoolDecoder


class DecodeError(ValueError):
    """The payload is not a keyframe this decoder reads."""


BitstreamError = InvalidSignature = UnsupportedFeature = UnexpectedEof = DecodeError

MAX_SEGMENTS = 4

# Plane classes for token probabilities (RFC 6386 §13.3).
PLANE_Y_AFTER_Y2 = 0
PLANE_Y2 = 1
PLANE_CHROMA = 2
PLANE_Y_NO_Y2 = 3


class VP8Frame:
    def __init__(self, width, height, ybuf, ubuf, vbuf):
        self.width = width
        self.height = height
        self.ybuf = ybuf  # [mbh*16, mbw*16] uint8
        self.ubuf = ubuf  # [mbh*8, mbw*8]
        self.vbuf = vbuf

    def to_rgb(self, upsampling="bilinear"):
        if upsampling == "bilinear":
            return yuvops.fancy_yuv420_to_rgb(self.ybuf, self.ubuf, self.vbuf, self.width, self.height)
        return yuvops.simple_yuv420_to_rgb(self.ybuf, self.ubuf, self.vbuf, self.width, self.height)

    def to_rgba(self, upsampling="bilinear"):
        rgb = self.to_rgb(upsampling)
        rgba = np.empty((self.height, self.width, 4), np.uint8)
        rgba[:, :, :3] = rgb
        rgba[:, :, 3] = 255
        return rgba


class Segment:
    __slots__ = ("quantizer_level", "loopfilter_level", "delta_values",
                 "ydc", "yac", "y2dc", "y2ac", "uvdc", "uvac")

    def __init__(self):
        self.quantizer_level = 0
        self.loopfilter_level = 0
        self.delta_values = True
        self.ydc = self.yac = self.y2dc = self.y2ac = self.uvdc = self.uvac = 0


def decode_vp8_frame(data) -> VP8Frame:
    return Vp8Decoder(bytes(data)).decode()


class Vp8Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.segments = [Segment() for _ in range(MAX_SEGMENTS)]
        self.segment_tree_probs = [255, 255, 255]
        self.token_probs = T.COEFF_PROBS_DEFAULT.copy().astype(np.int32)
        self.prob_skip_false = None
        self.segments_enabled = False
        self.segments_update_map = False
        self.lf_adjust = False
        self.ref_delta = [0, 0, 0, 0]
        self.mode_delta = [0, 0, 0, 0]

    # ------------------------------------------------------------------ header

    def decode(self) -> VP8Frame:
        self.parse()
        residuals = self._transform_pass()
        frame = self._reconstruct(residuals)
        self._loop_filter(frame)
        return frame

    def parse(self, debug_levels: bool = False) -> None:
        """Header + entropy pass, in Python.

        debug_levels=True additionally records the RAW quantized levels in
        `self.levels` [nmb, 25, 16] int32 (blocks 0-15 Y, 16-19 U, 20-23 V,
        24 the Y2 block)."""
        self._debug_levels = debug_levels
        self._read_frame_header()
        self._entropy_pass()

    def _read_frame_header(self):
        data = self.data
        if len(data) < 10:
            raise UnexpectedEof("VP8 chunk too small")
        tag = data[0] | (data[1] << 8) | (data[2] << 16)
        if tag & 1 != 0:
            raise UnsupportedFeature("non-keyframe")
        self.version = (tag >> 1) & 7
        self.for_display = (tag >> 4) & 1
        first_part_size = tag >> 5
        if data[3:6] != b"\x9d\x01\x2a":
            raise InvalidSignature("bad VP8 start code")
        self.width = (data[6] | (data[7] << 8)) & 0x3FFF
        self.height = (data[8] | (data[9] << 8)) & 0x3FFF
        self.mbw = (self.width + 15) // 16
        self.mbh = (self.height + 15) // 16

        if 10 + first_part_size > len(data):
            raise UnexpectedEof("first partition overruns chunk")
        b = BoolDecoder(data[10 : 10 + first_part_size])
        self.b = b

        if b.get_literal(1) != 0:
            raise BitstreamError("invalid color space")
        self.pixel_type = b.get_literal(1)

        self.segments_enabled = b.get_flag()
        if self.segments_enabled:
            self._read_segment_updates(b)

        self.filter_type = b.get_flag()  # True => simple
        self.filter_level = b.get_literal(6)
        self.sharpness = b.get_literal(3)

        self.lf_adjust = b.get_flag()
        if self.lf_adjust:
            if b.get_flag():
                self.ref_delta = [b.get_optional_signed(6) for _ in range(4)]
                self.mode_delta = [b.get_optional_signed(6) for _ in range(4)]

        num_partitions = 1 << b.get_literal(2)
        self._init_partitions(num_partitions, 10 + first_part_size)
        self._read_quantizer_indices(b)
        b.get_literal(1)  # refresh entropy probs (keyframe: ignored)
        self._update_token_probabilities(b)

        self.prob_skip_false = b.get_literal(8) if b.get_literal(1) == 1 else None

    def _read_segment_updates(self, b):
        self.segments_update_map = b.get_flag()
        if b.get_flag():  # update segment feature data
            absolute = b.get_flag()
            for s in self.segments:
                s.delta_values = not absolute
            for s in self.segments:
                s.quantizer_level = b.get_optional_signed(7)
            for s in self.segments:
                s.loopfilter_level = b.get_optional_signed(6)
        if self.segments_update_map:
            for i in range(3):
                self.segment_tree_probs[i] = b.get_literal(8) if b.get_flag() else 255

    def _init_partitions(self, n, offset):
        sizes = []
        pos = offset
        for _ in range(n - 1):
            if pos + 3 > len(self.data):
                raise UnexpectedEof("partition size table truncated")
            sizes.append(self.data[pos] | (self.data[pos + 1] << 8) | (self.data[pos + 2] << 16))
            pos += 3
        self.partitions = []
        for s in sizes:
            if pos + s > len(self.data):
                raise UnexpectedEof("partition overruns chunk")
            self.partitions.append(BoolDecoder(self.data[pos : pos + s]))
            pos += s
        self.partitions.append(BoolDecoder(self.data[pos:]))
        self.num_partitions = n

    def _read_quantizer_indices(self, b):
        yac_abs = b.get_literal(7)
        ydc_d = b.get_optional_signed(4)
        y2dc_d = b.get_optional_signed(4)
        y2ac_d = b.get_optional_signed(4)
        uvdc_d = b.get_optional_signed(4)
        uvac_d = b.get_optional_signed(4)
        # exact header fields, kept for encoder-parity tooling
        self.yac_abs = yac_abs
        self.quant_deltas = dict(
            ydc=ydc_d, y2dc=y2dc_d, y2ac=y2ac_d, uvdc=uvdc_d, uvac=uvac_d
        )

        def dcq(i):
            return int(T.DC_QUANT[min(max(i, 0), 127)])

        def acq(i):
            return int(T.AC_QUANT[min(max(i, 0), 127)])

        n = MAX_SEGMENTS if self.segments_enabled else 1
        for s in self.segments[:n]:
            if self.segments_enabled:
                base = s.quantizer_level + yac_abs if s.delta_values else s.quantizer_level
            else:
                base = yac_abs
            s.ydc = dcq(base + ydc_d)
            s.yac = acq(base)
            s.y2dc = dcq(base + y2dc_d) * 2
            s.y2ac = max(acq(base + y2ac_d) * 155 // 100, 8)
            s.uvdc = min(dcq(base + uvdc_d), 132)
            s.uvac = acq(base + uvac_d)

    def _update_token_probabilities(self, b):
        probs = self.token_probs
        update = T.COEFF_UPDATE_PROBS
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    for t in range(11):
                        if b.get_bit(int(update[i, j, k, t])):
                            probs[i, j, k, t] = b.get_literal(8)

    # ----------------------------------------------------------------- entropy

    def _entropy_pass(self):
        """Decode MB headers + coefficients into dense arrays."""
        mbw, mbh = self.mbw, self.mbh
        nmb = mbw * mbh
        b = self.b

        self.luma_mode = np.zeros(nmb, np.int32)
        self.chroma_mode = np.zeros(nmb, np.int32)
        self.bpred = np.zeros((nmb, 16), np.int32)
        self.segment_ids = np.zeros(nmb, np.int32)
        self.skipped = np.zeros(nmb, bool)
        self.non_zero_dct = np.zeros(nmb, bool)
        # 24 blocks: 16 Y + 4 U + 4 V; Y2 folded into Y DCs during this pass.
        self.coeffs = np.zeros((nmb, 24, 16), np.int32)
        self.has_ac = np.zeros((nmb, 24), bool)
        if getattr(self, "_debug_levels", False):
            self.levels = np.zeros((nmb, 25, 16), np.int32)

        # Probability tables indexed [plane][position band][ctx] as flat lists
        # for the hot loop.
        self._probs_by_pos = [
            [
                [self.token_probs[p, T.COEFF_BANDS[n], c].tolist() for c in range(3)]
                for n in range(16)
            ]
            for p in range(4)
        ]

        top_bpred = np.full((mbw, 4), pr.B_DC, np.int32)
        top_complexity = np.zeros((mbw, 9), np.int32)

        ymode_tree = T.KEYFRAME_YMODE_TREE
        ymode_probs = T.KEYFRAME_YMODE_PROBS
        uv_tree = T.KEYFRAME_UV_MODE_TREE
        uv_probs = T.KEYFRAME_UV_MODE_PROBS
        bpred_tree = T.KEYFRAME_BPRED_MODE_TREE
        bpred_probs = T.KEYFRAME_BPRED_MODE_PROBS
        seg_tree = T.SEGMENT_ID_TREE

        for mby in range(mbh):
            part = self.partitions[mby % self.num_partitions]
            left_bpred = [pr.B_DC] * 4
            left_complexity = np.zeros(9, np.int32)
            for mbx in range(mbw):
                i = mby * mbw + mbx
                if self.segments_enabled and self.segments_update_map:
                    self.segment_ids[i] = b.read_with_tree(seg_tree, self.segment_tree_probs)
                if self.prob_skip_false is not None:
                    self.skipped[i] = b.get_bit(self.prob_skip_false) == 1

                luma = b.read_with_tree(ymode_tree, ymode_probs)
                self.luma_mode[i] = luma
                if luma == 4:  # B_PRED: 16 independent sub-modes
                    for sy in range(4):
                        for sx in range(4):
                            above = top_bpred[mbx, sx]
                            left = left_bpred[sy]
                            m = b.read_with_tree(
                                bpred_tree, bpred_probs[above, left]
                            )
                            self.bpred[i, sy * 4 + sx] = m
                            top_bpred[mbx, sx] = m
                            left_bpred[sy] = m
                else:
                    # Whole-MB modes map to the equivalent B mode for context.
                    bmode = (pr.B_DC, pr.B_VE, pr.B_HE, pr.B_TM)[luma]
                    self.bpred[i, 12:] = bmode
                    for sy in range(4):
                        left_bpred[sy] = bmode
                    top_bpred[mbx] = bmode

                self.chroma_mode[i] = b.read_with_tree(uv_tree, uv_probs)

                if not self.skipped[i]:
                    self._read_mb_residuals(i, mbx, part, top_complexity, left_complexity)
                else:
                    if luma != 4:
                        left_complexity[0] = 0
                        top_complexity[mbx, 0] = 0
                    left_complexity[1:] = 0
                    top_complexity[mbx, 1:] = 0

        if b.is_eof():
            # Mode data overran partition 0 — parsed zero padding (mirror of
            # the native decoder's post-loop check).
            raise BitstreamError("EOF in macroblock header data")

    def _read_mb_residuals(self, i, mbx, part, top_c, left_c):
        seg = self.segments[self.segment_ids[i]]
        coeffs = self.coeffs[i]
        has_y2 = self.luma_mode[i] != 4
        raw = self.levels[i] if getattr(self, "_debug_levels", False) else None

        if has_y2:
            ctx = int(top_c[mbx, 0] + left_c[0])
            y2 = np.zeros(16, np.int64)
            n = self._read_coeffs(y2, part, PLANE_Y2, ctx, seg.y2dc, seg.y2ac, 0,
                                  raw=None if raw is None else raw[24])
            left_c[0] = top_c[mbx, 0] = 1 if n else 0
            y2r = tx.iwht4x4(y2[None, :])[0]
            coeffs[:16, 0] = y2r
            plane = PLANE_Y_AFTER_Y2
            first = 1
        else:
            plane = PLANE_Y_NO_Y2
            first = 0

        nz = False
        for y in range(4):
            left = int(left_c[y + 1])
            for x in range(4):
                bi = x + y * 4
                ctx = int(top_c[mbx, x + 1]) + left
                blk = np.zeros(16, np.int64)
                n = self._read_coeffs(blk, part, plane, ctx, seg.ydc, seg.yac, first,
                                      raw=None if raw is None else raw[bi])
                if has_y2:
                    blk[0] = coeffs[bi, 0]
                coeffs[bi] = blk
                self.has_ac[i, bi] = n
                if blk[0] != 0 or n:
                    nz = True
                left = 1 if n else 0
                top_c[mbx, x + 1] = left
            left_c[y + 1] = left

        for j, base in ((5, 16), (7, 20)):
            for y in range(2):
                left = int(left_c[y + j])
                for x in range(2):
                    bi = base + x + y * 2
                    ctx = int(top_c[mbx, x + j]) + left
                    blk = np.zeros(16, np.int64)
                    n = self._read_coeffs(blk, part, PLANE_CHROMA, ctx, seg.uvdc, seg.uvac, 0,
                                          raw=None if raw is None else raw[bi])
                    coeffs[bi] = blk
                    self.has_ac[i, bi] = n
                    if blk[0] != 0 or n:
                        nz = True
                    left = 1 if n else 0
                    top_c[mbx, x + j] = left
                left_c[y + j] = left
        self.non_zero_dct[i] = nz

    def _read_coeffs(self, block, part, plane, ctx, dcq, acq, first, raw=None):
        """Token-tree coefficient read (RFC 6386 §13.3); returns AC-present.

        `raw` (debug_levels mode): 16-slot int32 view that additionally
        receives the pre-dequant signed levels in natural (un-zigzagged)
        slot order."""
        probs_plane = self._probs_by_pos[plane]
        get_bit = part.get_bit
        zigzag = T.ZIGZAG
        cat_probs = T.PROB_DCT_CAT
        n = first
        prob = probs_plane[n][ctx]
        while n < 16:
            if not get_bit(prob[0]):
                break
            while not get_bit(prob[1]):
                n += 1
                if n >= 16:
                    if part.is_eof():
                        raise BitstreamError("EOF in coefficients")
                    return True
                prob = probs_plane[n][0]
            if not get_bit(prob[2]):
                v = 1
                next_ctx = 1
            else:
                if not get_bit(prob[3]):
                    if not get_bit(prob[4]):
                        v = 2
                    else:
                        v = 3 + get_bit(prob[5])
                else:
                    if not get_bit(prob[6]):
                        if not get_bit(prob[7]):
                            v = 5 + get_bit(159)
                        else:
                            v = 7 + 2 * get_bit(165) + get_bit(145)
                    else:
                        bit1 = get_bit(prob[8])
                        bit0 = get_bit(prob[9 + bit1])
                        cat = 2 * bit1 + bit0
                        extra = 0
                        for p in cat_probs[2 + cat]:
                            extra = extra + extra + get_bit(p)
                        v = 3 + (8 << cat) + extra
                next_ctx = 2
            if get_bit(128):
                v = -v
            zz = int(zigzag[n])
            if raw is not None:
                raw[zz] = v
            block[zz] = v * (acq if zz > 0 else dcq)
            n += 1
            if n < 16:
                prob = probs_plane[n][next_ctx]
        if part.is_eof():
            raise BitstreamError("EOF in coefficients")
        return n > first

    # --------------------------------------------------------------- transform

    def _transform_pass(self):
        """Batched inverse DCT over every 4x4 block (device-shaped op)."""
        full = tx.idct4x4(self.coeffs)
        dc_only = tx.idct4x4_dc(self.coeffs)
        return np.where(self.has_ac[:, :, None], full, dc_only)

    # ----------------------------------------------------------- reconstruction

    def _reconstruct(self, residuals) -> VP8Frame:
        mbw, mbh = self.mbw, self.mbh
        ybuf = np.zeros((mbh * 16, mbw * 16), np.uint8)
        ubuf = np.zeros((mbh * 8, mbw * 8), np.uint8)
        vbuf = np.zeros((mbh * 8, mbw * 8), np.uint8)

        top_y = np.full(mbw * 16 + 16, 127, np.uint8)
        top_u = np.full(mbw * 8, 127, np.uint8)
        top_v = np.full(mbw * 8, 127, np.uint8)

        for mby in range(mbh):
            left_y = np.full(17, 129, np.uint8)
            left_u = np.full(9, 129, np.uint8)
            left_v = np.full(9, 129, np.uint8)
            for mbx in range(mbw):
                i = mby * mbw + mbx
                res = residuals[i]
                luma = self.luma_mode[i]

                ws = pr.create_border_luma(mbx, mby, mbw, top_y, left_y)
                if luma == 4:  # B
                    for sby in range(4):
                        for sbx in range(4):
                            bi = sbx + sby * 4
                            pr.predict_b(ws, int(self.bpred[i, bi]), sbx * 4 + 1, sby * 4 + 1)
                            pr.add_residue(ws, res[bi], sby * 4 + 1, sbx * 4 + 1)
                else:
                    if luma == 0:
                        pr.predict_dc(ws, 16, mby != 0, mbx != 0)
                    elif luma == 1:
                        pr.predict_v(ws, 16)
                    elif luma == 2:
                        pr.predict_h(ws, 16)
                    else:
                        pr.predict_tm(ws, 16)
                    for sby in range(4):
                        for sbx in range(4):
                            pr.add_residue(ws, res[sbx + sby * 4], sby * 4 + 1, sbx * 4 + 1)

                left_y[0] = ws[0, 16]
                left_y[1:17] = ws[1:17, 16]
                top_y[mbx * 16 : mbx * 16 + 16] = ws[16, 1:17]
                ybuf[mby * 16 : mby * 16 + 16, mbx * 16 : mbx * 16 + 16] = ws[1:17, 1:17]

                cmode = self.chroma_mode[i]
                uws = pr.create_border_chroma(mbx, mby, top_u, left_u)
                vws = pr.create_border_chroma(mbx, mby, top_v, left_v)
                for cws in (uws, vws):
                    if cmode == 0:
                        pr.predict_dc(cws, 8, mby != 0, mbx != 0)
                    elif cmode == 1:
                        pr.predict_v(cws, 8)
                    elif cmode == 2:
                        pr.predict_h(cws, 8)
                    else:
                        pr.predict_tm(cws, 8)
                for sy in range(2):
                    for sx in range(2):
                        pr.add_residue(uws, res[16 + sx + sy * 2], sy * 4 + 1, sx * 4 + 1)
                        pr.add_residue(vws, res[20 + sx + sy * 2], sy * 4 + 1, sx * 4 + 1)

                for (cws, leftb, topb, buf) in (
                    (uws, left_u, top_u, ubuf),
                    (vws, left_v, top_v, vbuf),
                ):
                    leftb[0] = cws[0, 8]
                    leftb[1:9] = cws[1:9, 8]
                    topb[mbx * 8 : mbx * 8 + 8] = cws[8, 1:9]
                    buf[mby * 8 : mby * 8 + 8, mbx * 8 : mbx * 8 + 8] = cws[1:9, 1:9]

        return VP8Frame(self.width, self.height, ybuf, ubuf, vbuf)

    # ------------------------------------------------------------- loop filter

    def _filter_params(self, i):
        seg = self.segments[self.segment_ids[i]]
        level = self.filter_level
        if self.segments_enabled:
            level = level + seg.loopfilter_level if seg.delta_values else seg.loopfilter_level
        level = min(max(level, 0), 63)
        if self.lf_adjust:
            level += self.ref_delta[0]
            if self.luma_mode[i] == 4:
                level += self.mode_delta[0]
        level = min(max(level, 0), 63)
        if level == 0:
            return 0, 0, 0
        interior = level
        if self.sharpness > 0:
            interior >>= 2 if self.sharpness > 4 else 1
            interior = min(interior, 9 - self.sharpness)
        interior = max(interior, 1)
        hev = 2 if level >= 40 else (1 if level >= 15 else 0)
        return level, interior, hev

    def filter_params_arrays(self):
        """Vectorized per-MB (level, interior, hev) filter parameters."""
        nmb = self.mbw * self.mbh
        seg_lf = np.array([s.loopfilter_level for s in self.segments], np.int32)
        seg_delta = np.array([s.delta_values for s in self.segments], bool)
        sid = self.segment_ids
        level = np.full(nmb, self.filter_level, np.int32)
        if self.segments_enabled:
            level = np.where(seg_delta[sid], self.filter_level + seg_lf[sid], seg_lf[sid])
        level = np.clip(level, 0, 63)
        if self.lf_adjust:
            level = level + self.ref_delta[0] + np.where(self.luma_mode == 4, self.mode_delta[0], 0)
        level = np.clip(level, 0, 63)
        interior = level.copy()
        if self.sharpness > 0:
            interior >>= 2 if self.sharpness > 4 else 1
            interior = np.minimum(interior, 9 - self.sharpness)
        interior = np.maximum(interior, 1)
        hev = np.where(level >= 40, 2, np.where(level >= 15, 1, 0)).astype(np.int32)
        if self.filter_level == 0:
            level = np.zeros(nmb, np.int32)
        return level, interior.astype(np.int32), hev

    def _loop_filter(self, frame):
        if self.filter_level == 0:
            return
        mbw, mbh = self.mbw, self.mbh
        y, u, v = frame.ybuf, frame.ubuf, frame.vbuf
        simple = self.filter_type
        for mby in range(mbh):
            for mbx in range(mbw):
                i = mby * mbw + mbx
                level, interior, hev = self._filter_params(i)
                if level == 0:
                    continue
                mb_lim = (level + 2) * 2 + interior
                sub_lim = level * 2 + interior
                do_sub = self.luma_mode[i] == 4 or (
                    not self.skipped[i] and self.non_zero_dct[i]
                )
                yy, yx = mby * 16, mbx * 16
                cy, cx = mby * 8, mbx * 8

                if mbx > 0:
                    if simple:
                        lf.filter_vertical_edge(y, yy, 16, yx, "simple", edge_limit=mb_lim)
                    else:
                        lf.filter_vertical_edge(y, yy, 16, yx, "mb", hev, interior, mb_lim)
                        lf.filter_vertical_edge(u, cy, 8, cx, "mb", hev, interior, mb_lim)
                        lf.filter_vertical_edge(v, cy, 8, cx, "mb", hev, interior, mb_lim)
                if do_sub:
                    if simple:
                        for dx in (4, 8, 12):
                            lf.filter_vertical_edge(y, yy, 16, yx + dx, "simple", edge_limit=sub_lim)
                    else:
                        for dx in (4, 8, 12):
                            lf.filter_vertical_edge(y, yy, 16, yx + dx, "sub", hev, interior, sub_lim)
                        lf.filter_vertical_edge(u, cy, 8, cx + 4, "sub", hev, interior, sub_lim)
                        lf.filter_vertical_edge(v, cy, 8, cx + 4, "sub", hev, interior, sub_lim)
                if mby > 0:
                    if simple:
                        lf.filter_horizontal_edge(y, yy, yx, 16, "simple", edge_limit=mb_lim)
                    else:
                        lf.filter_horizontal_edge(y, yy, yx, 16, "mb", hev, interior, mb_lim)
                        lf.filter_horizontal_edge(u, cy, cx, 8, "mb", hev, interior, mb_lim)
                        lf.filter_horizontal_edge(v, cy, cx, 8, "mb", hev, interior, mb_lim)
                if do_sub:
                    if simple:
                        for dy in (4, 8, 12):
                            lf.filter_horizontal_edge(y, yy + dy, yx, 16, "simple", edge_limit=sub_lim)
                    else:
                        for dy in (4, 8, 12):
                            lf.filter_horizontal_edge(y, yy + dy, yx, 16, "sub", hev, interior, sub_lim)
                        lf.filter_horizontal_edge(u, cy + 4, cx, 8, "sub", hev, interior, sub_lim)
                        lf.filter_horizontal_edge(v, cy + 4, cx, 8, "sub", hev, interior, sub_lim)
