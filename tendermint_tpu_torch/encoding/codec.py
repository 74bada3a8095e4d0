"""The deterministic struct writer that canonical sign-bytes are built with:
LEB128 uvarints, little-endian fixed64, length-prefixed bytes and strings.
Same wire format as the reference package's pure-Python writer."""

from __future__ import annotations

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


class Writer:
    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def uvarint(self, n: int) -> "Writer":
        self._buf += encode_uvarint(n)
        return self

    def fixed64(self, n: int) -> "Writer":
        self._buf += struct.pack("<q", n)
        return self

    def bytes(self, b: bytes) -> "Writer":
        self.uvarint(len(b))
        self._buf += b
        return self

    def string(self, s: str) -> "Writer":
        return self.bytes(s.encode("utf-8"))

    def build(self) -> bytes:
        return bytes(self._buf)
