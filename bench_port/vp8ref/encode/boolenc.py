"""Frozen copy of the plain code of `webp_tpu_torch/encode/boolenc.py`, the
benchmark's reference; it imports nothing of the port.

VP8 boolean (arithmetic) encoder, RFC 6386 section 7.3: the frame header's
writer.  The same carry-propagating coder as `webp_tpu/encode/boolenc.py`;
its state (bytes, bottom, range, bit_num) is what the MB-header coders
continue from (the C++ `io/native.py:vp8_mbheader_encode`, kernel K14).

Also the host epilogue of the device lane coders (`webp_tpu/ops/boolenc2.py`
:213-261): `assemble_lane` applies a lane's `lead` carries to its prefix,
appends its carry-resolved bytes and flushes its final registers.
"""

from __future__ import annotations

import numpy as np


def tree_paths(tree) -> dict:
    """Map each leaf value to its ((bit, prob_node) ...) path from a start
    index.  Returns {start_index: {value: path}} for all even start indices
    (start 2 of the DCT token tree skips the EOB branch)."""
    paths = {}

    def walk(i, prefix, out):
        for bit in (0, 1):
            t = tree[i + bit]
            path = prefix + ((bit, i >> 1),)
            if t <= 0:
                out[-t] = path
            else:
                walk(t, path, out)

    for start in range(0, len(tree), 2):
        out = {}
        walk(start, (), out)
        paths[start] = out
    return paths


def _carry_walk(out: bytearray) -> None:
    """Add one carry to the tail of `out`: 0xFF bytes turn 0x00, and a
    carry past the first byte prepends 0x01."""
    i = len(out) - 1
    while i >= 0:
        if out[i] < 255:
            out[i] += 1
            return
        out[i] = 0
        i -= 1
    out[0:0] = b"\x01"


class BoolEncoder:
    def __init__(self):
        self.out = bytearray()
        self.bottom = 0
        self.range = 255
        self.bit_num = 24

    def write_bool(self, bit, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                _carry_walk(self.out)
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_num -= 1
            if self.bit_num == 0:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_num = 8

    def write_flag(self, flag):
        self.write_bool(1 if flag else 0, 128)

    def write_literal(self, num_bits: int, value: int):
        for bit in range(num_bits - 1, -1, -1):
            self.write_bool((value >> bit) & 1, 128)

    def write_optional_signed(self, num_bits: int, value: int):
        """Flag, |value|, sign (1 = negative); just the flag when value is 0."""
        self.write_flag(value != 0)
        if value != 0:
            self.write_literal(num_bits, abs(value))
            self.write_flag(value < 0)


def flush_lane(bottom: int, bit_num: int, prefix: bytes) -> bytes:
    """`BoolEncoder.flush` on a lane's final registers: its last carry goes
    into the resolved `prefix`, then the four bytes of `bottom`."""
    out = bytearray(prefix)
    c = int(bit_num)
    v = int(bottom)
    if v & (1 << (32 - c)):
        _carry_walk(out)
    v = (v << (c & 7)) & 0xFFFFFFFF
    c = (c >> 3) - 1
    while c >= 0:
        v = (v << 8) & 0xFFFFFFFF
        c -= 1
    for _ in range(4):
        out.append((v >> 24) & 0xFF)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def assemble_lane(lead: int, data: np.ndarray, n: int, bottom: int, bit_num: int,
                  prefix: bytes = b"") -> bytes:
    """A lane's final byte stream: the host-written `prefix` (when the lane
    continued an encoder's state) with the lane's `lead` carries applied,
    the lane's first `n` resolved bytes, and the flush epilogue."""
    out = bytearray(prefix)
    for _ in range(int(lead)):
        _carry_walk(out)
    out += bytes(data[:int(n)])
    return flush_lane(bottom, bit_num, bytes(out))
