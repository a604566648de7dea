"""Frozen copy of `webp_tpu/io/booldec.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

VP8 boolean (arithmetic) decoder — RFC 6386 §7.

Canonical byte-at-a-time formulation; bit-exact with any refill width, so the
reference's 56-bit-buffer reader (`src/decoder/bit_reader.rs`)
and the C++ fast path both decode identically. Range is kept in [128, 255]
after renormalization; `split = 1 + ((range-1)*prob >> 8)`.
"""

from __future__ import annotations


class BoolDecoder:
    __slots__ = ("data", "pos", "value", "range", "bit_count", "overrun")

    def __init__(self, data):
        self.data = bytes(data)
        self.pos = 0
        self.overrun = 0  # set before the first read: a partition may be empty
        self.value = (self._next_byte() << 8) | self._next_byte()
        self.range = 255
        self.bit_count = 0

    def _next_byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.overrun += 1
        return 0

    def is_eof(self) -> bool:
        # One byte of zero-padding past the end is tolerated (matches the
        # reference's near-EOF behavior, decoder/arithmetic.rs:298-303).
        return self.overrun > 1

    def get_bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * int(prob)) >> 8)
        big_split = split << 8
        if self.value >= big_split:
            bit = 1
            self.range -= split
            self.value -= big_split
        else:
            bit = 0
            self.range = split
        while self.range < 128:
            self.value = (self.value << 1) & 0xFFFFFF
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self._next_byte()
        return bit

    def get_flag(self) -> bool:
        return self.get_bit(128) == 1

    def get_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit(128)
        return v

    def get_optional_signed(self, n: int) -> int:
        """flag, then magnitude+sign if present (bit_reader.rs read_optional_signed_value)."""
        if not self.get_flag():
            return 0
        magnitude = self.get_literal(n)
        return -magnitude if self.get_flag() else magnitude

    def read_with_tree(self, tree, probs, start: int = 0) -> int:
        """Walk a VP8 token tree: `tree` holds interleaved (left,right) where
        values <= 0 are leaves (-value) and positive values are indices."""
        i = start
        while True:
            t = tree[i + self.get_bit(probs[i >> 1])]
            if t <= 0:
                return -t
            i = t
