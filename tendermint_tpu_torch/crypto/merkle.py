"""Simple Merkle root over byte slices, in the reference package's own
layout (its ``crypto/merkle.py``), which is not Go's: RFC-6962 domain
separation (leaf = SHA-256(0x00 || leaf), inner = SHA-256(0x01 || left ||
right)), the empty tree is SHA-256(""), and a list splits at the largest
power of two below its length. ``Header.hash`` and ``ValidatorSet.hash``
are roots of this tree."""

from __future__ import annotations

import hashlib
from typing import Sequence

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _hash(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def leaf_hash(leaf: bytes) -> bytes:
    return _hash(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _hash(_INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """The largest power of two strictly below n (n >= 2)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return _hash(b"")
    if n == 1:
        return leaf_hash(items[0])
    k = _split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]),
                      hash_from_byte_slices(items[k:]))
