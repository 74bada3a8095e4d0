"""BitArray: the vote and block-part bitmaps (ref libs/common/bit_array.go),
the port's copy of the reference package's ``libs/bit_array.py``.

Backed by a Python int: ``sub``, ``or_``, ``and_`` and ``pick_random`` are
integer operations instead of word loops.
"""

from __future__ import annotations

import random
from typing import List, Optional

from tendermint_tpu_torch.encoding.codec import Reader, Writer


class BitArray:
    def __init__(self, bits: int, value: int = 0):
        if bits < 0:
            raise ValueError("negative bits")
        self.bits = bits
        self._v = value & ((1 << bits) - 1)

    def get_index(self, i: int) -> bool:
        if i >= self.bits or i < 0:
            return False
        return bool((self._v >> i) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if i >= self.bits or i < 0:
            return False
        if v:
            self._v |= 1 << i
        else:
            self._v &= ~(1 << i)
        return True

    def copy(self) -> "BitArray":
        return BitArray(self.bits, self._v)

    def or_(self, other: "BitArray") -> "BitArray":
        return BitArray(max(self.bits, other.bits), self._v | other._v)

    def and_(self, other: "BitArray") -> "BitArray":
        return BitArray(min(self.bits, other.bits), self._v & other._v)

    def not_(self) -> "BitArray":
        return BitArray(self.bits, ~self._v)

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (ref bit_array.go Sub)."""
        return BitArray(self.bits, self._v & ~other._v)

    def is_empty(self) -> bool:
        return self._v == 0

    def is_full(self) -> bool:
        return self._v == (1 << self.bits) - 1

    def num_true(self) -> int:
        return bin(self._v).count("1")

    def pick_random(self) -> Optional[int]:
        """Index of a random set bit, or None (ref PickRandom)."""
        n = self.num_true()
        if n == 0:
            return None
        k = random.randrange(n)
        v = self._v
        for _ in range(k):
            v &= v - 1  # drop the lowest set bit
        return (v & -v).bit_length() - 1

    def true_indices(self) -> List[int]:
        out = []
        v = self._v
        while v:
            low = v & -v
            out.append(low.bit_length() - 1)
            v ^= low
        return out

    def update(self, other: "BitArray") -> None:
        """Copy other's contents into self (ref Update)."""
        self._v = other._v & ((1 << self.bits) - 1)

    def encode(self, w: Writer) -> None:
        w.uvarint(self.bits)
        w.bytes(self._v.to_bytes((self.bits + 7) // 8, "little"))

    def marshal(self) -> bytes:
        w = Writer()
        self.encode(w)
        return w.build()

    # bitmaps index validators or block parts, far below 16M: an unbounded
    # ``bits`` from a peer would materialize a giant int
    MAX_DECODE_BITS = 1 << 24

    @classmethod
    def decode(cls, r: Reader) -> "BitArray":
        bits = r.uvarint()
        if bits > cls.MAX_DECODE_BITS:
            raise ValueError(f"BitArray bits {bits} exceeds decode bound")
        return cls(bits, int.from_bytes(r.bytes(), "little"))

    @classmethod
    def unmarshal(cls, data: bytes) -> "BitArray":
        return cls.decode(Reader(data))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitArray)
            and self.bits == other.bits
            and self._v == other._v
        )

    def __str__(self) -> str:
        return "".join("x" if self.get_index(i) else "_" for i in range(self.bits))
