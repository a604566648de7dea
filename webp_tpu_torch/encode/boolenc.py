"""VP8 boolean (arithmetic) encoder, RFC 6386 section 7.3: the frame header's
writer.  The same carry-propagating coder as `webp_tpu/encode/boolenc.py`;
its state (bytes, bottom, range, bit_num) is what the C++ MB-header coder
continues from (`io/native.py:vp8_mbheader_encode`).
"""

from __future__ import annotations


class BoolEncoder:
    def __init__(self):
        self.out = bytearray()
        self.bottom = 0
        self.range = 255
        self.bit_num = 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0:
            if self.out[i] < 255:
                self.out[i] += 1
                return
            self.out[i] = 0
            i -= 1
        self.out[0:0] = b"\x01"

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
                self._carry()
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
