"""Byte cursor over an immutable buffer: little-endian integer reads,
seek, peek and take, bounds-checked (a copy of the JAX package's
`webp_tpu/io/cursor.py`).  Host-side only."""

from __future__ import annotations

from ..errors import UnexpectedEof


class Cursor:
    """A zero-copy reading cursor over ``bytes``/``memoryview``."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos: int = 0):
        self.data = memoryview(data)
        self.pos = pos

    def __len__(self) -> int:
        return len(self.data)

    @property
    def remaining(self) -> int:
        return len(self.data) - self.pos

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise UnexpectedEof(f"need {n} bytes at offset {self.pos}, have {self.remaining}")

    def read_u8(self) -> int:
        self._need(1)
        v = self.data[self.pos]
        self.pos += 1
        return v

    def read_u16_le(self) -> int:
        self._need(2)
        d, p = self.data, self.pos
        self.pos += 2
        return d[p] | (d[p + 1] << 8)

    def read_u24_le(self) -> int:
        self._need(3)
        d, p = self.data, self.pos
        self.pos += 3
        return d[p] | (d[p + 1] << 8) | (d[p + 2] << 16)

    def read_u32_le(self) -> int:
        self._need(4)
        d, p = self.data, self.pos
        self.pos += 4
        return d[p] | (d[p + 1] << 8) | (d[p + 2] << 16) | (d[p + 3] << 24)

    def read_bytes(self, n: int) -> memoryview:
        self._need(n)
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v

    def read_fourcc(self) -> bytes:
        return bytes(self.read_bytes(4))

    def skip(self, n: int) -> None:
        self._need(n)
        self.pos += n

    def seek(self, pos: int) -> None:
        if pos > len(self.data) or pos < 0:
            raise UnexpectedEof(f"seek to {pos} outside buffer of {len(self.data)}")
        self.pos = pos
