"""The deterministic codec that canonical sign-bytes and the light-client
records are built with: LEB128 uvarints, zig-zag svarints, little-endian
fixed64, length-prefixed bytes and strings, one-byte bools. Same wire
format and the same rejections as the reference package's pure-Python
writer and reader (a truncated input raises ``EOFError``; an overlong,
overflowing or non-minimal uvarint raises ``ValueError``)."""

from __future__ import annotations

import io
import struct


def encode_uvarint(n: int) -> bytes:
    if n < 0 or n >= 1 << 64:
        raise ValueError("uvarint must be in [0, 2^64)")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: io.BytesIO) -> int:
    """A wire uvarint is a uint64 in its minimal encoding: anything larger,
    longer or padded with zero continuation bytes is rejected, so that one
    value has one encoding and one hash."""
    shift = 0
    out = 0
    while True:
        ch = buf.read(1)
        if not ch:
            raise EOFError("truncated uvarint")
        b = ch[0]
        if shift == 63 and b > 1:
            raise ValueError("uvarint overflows uint64")
        if shift > 0 and b == 0:
            raise ValueError("non-minimal uvarint")
        out |= (b & 0x7F) << shift
        if not (b & 0x80):
            return out
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


class Writer:
    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def uvarint(self, n: int) -> "Writer":
        self._buf += encode_uvarint(n)
        return self

    def svarint(self, n: int) -> "Writer":
        return self.uvarint((n << 1) ^ (n >> 63) if n < 0 else n << 1)

    def fixed64(self, n: int) -> "Writer":
        self._buf += struct.pack("<q", n)
        return self

    def bytes(self, b: bytes) -> "Writer":
        self.uvarint(len(b))
        self._buf += b
        return self

    def string(self, s: str) -> "Writer":
        return self.bytes(s.encode("utf-8"))

    def bool(self, v: bool) -> "Writer":
        self._buf.append(1 if v else 0)
        return self

    def raw(self, b: bytes) -> "Writer":
        self._buf += b
        return self

    def build(self) -> bytes:
        return bytes(self._buf)


class Reader:
    __slots__ = ("_data", "_buf")

    def __init__(self, data: bytes) -> None:
        self._data = bytes(data)
        self._buf = io.BytesIO(self._data)

    def _take(self, n: int, what: str) -> bytes:
        data = self._buf.read(n)
        if len(data) != n:
            raise EOFError(f"truncated {what}")
        return data

    def uvarint(self) -> int:
        return read_uvarint(self._buf)

    def svarint(self) -> int:
        u = read_uvarint(self._buf)
        return (u >> 1) ^ -(u & 1)

    def fixed64(self) -> int:
        return struct.unpack("<q", self._take(8, "fixed64"))[0]

    def bytes(self) -> bytes:
        return self._take(self.uvarint(), "bytes")

    def string(self) -> str:
        return self.bytes().decode("utf-8")

    def bool(self) -> bool:
        return self._take(1, "bool")[0] != 0

    def raw(self, n: int) -> bytes:
        return self._take(n, "raw read")

    def remaining(self) -> int:
        return len(self._data) - self._buf.tell()

    def at_end(self) -> bool:
        return self.remaining() == 0

    def tell(self) -> int:
        return self._buf.tell()

    def span(self, start: int) -> bytes:
        """The bytes from an offset ``tell()`` gave to the current position."""
        pos = self._buf.tell()
        if start < 0 or start > pos:
            raise ValueError("span start out of range")
        return self._data[start:pos]
